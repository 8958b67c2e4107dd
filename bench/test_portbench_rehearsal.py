"""Every cell end to end on the CPU at a small size (the program's plain
route), with the result line the benchmark's contract asks for."""
import json

import numpy as np
import torch

import pytest

from bench.harness.runner import cell_spec
from bench.harness.trace import summarize
from bench.harness.small import CELLS, run_small

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contract_line(cell):
    spec, _, _, _ = cell_spec(cell)
    result, lines = run_small(cell, seconds=1.0)
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    want = {m["name"] for m in spec["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == want
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert DEVICE_KEYS <= set(line["device"])
    assert line["checks"] and all(c["value"] <= c["limit"] for c in line["checks"].values())
    assert lines[-1].startswith("check:") and lines[0].startswith("run:")


@pytest.mark.parametrize("cell", ["imagenet.fit-resident", "covtype.predict-batch"])
def test_a_traced_run_reads_the_program_metrics(cell):
    result, _ = run_small(cell, trace=True)
    # the device trace and its metrics are the card's alone; off it, the
    # program's spans and counters are read and nothing else
    assert "breakdown" not in result and "busy_s" not in result["device"]
    if cell.endswith("fit-resident"):
        assert set(result["metrics"]) == {"phase1_s.fit", "lloyd_pass_s.fit"}
    else:
        assert result["metrics"] == {}


def _kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_the_trace_summary_reads_busy_time_kernels_and_named_gaps():
    # marks at 0 and 1,000 us (host 10.0 s and 10.001 s); a kernel, a copy
    # that overlaps it, a gap while the host was in "phase.host_view"
    events = [_kernel("spin_kernel(long)", 0.0, 1.0), _kernel("spin_kernel(long)", 1000.0, 1.0),
              _kernel("embed", 100.0, 200.0), _kernel("Memcpy HtoD", 250.0, 100.0, "gpu_memcpy"),
              _kernel("assign", 700.0, 100.0), {"ph": "X", "cat": "cpu_op", "name": "x",
                                               "ts": 0.0, "dur": 900.0}]
    spans = [("bench.call", 10.0, 10.001), ("phase.host_view", 10.0004, 10.00065)]
    s = summarize(events, [10.0, 10.001], spans)
    assert s.window_s == pytest.approx(1e-3)
    assert s.busy_s == pytest.approx(350e-6)  # 100..350 and 700..800
    assert s.kernel_s == pytest.approx(300e-6)
    assert [g[0] for g in s.gaps] == ["bench.call", "phase.host_view", "bench.call"]
    assert [g[1] for g in s.gaps] == pytest.approx([100e-6, 350e-6, 200e-6])
    with pytest.raises(RuntimeError):
        summarize(events, [10.0], spans)


def test_the_stream_mix_is_data_for_the_fit_kind():
    # X held on the host as a BlockStore and the stream backend, from the
    # mix's parameters alone, judged under the fit cell's limits
    from bench.harness.runner import ROOT, load_json, traffic_kind
    from bench.harness.small import SEED, SMALL
    from repro_torch.policy import ComputePolicy

    cfg = load_json(ROOT / "bench" / "configs" / "imagenet-nystrom.json")
    mix = load_json(ROOT / "bench" / "traffic" / "fit-stream.json")
    assert (mix["kind"], mix["backend"], mix["x_on"]) == ("fit", "stream", "host")
    cfg.update((k, v) for k, v in SMALL.items() if k in cfg)
    traffic = traffic_kind(mix["kind"])(cfg, mix, SEED, torch.device("cpu"), ComputePolicy())
    traffic.setup()
    calls = [traffic.call(i) for i in range(2)]
    numbers = traffic.check(calls, np.random.default_rng(0))
    limits = load_json(ROOT / "bench" / "limits" / "imagenet.fit-resident.json")["numbers"]
    assert all(numbers[name] <= lim["limit"] for name, lim in limits.items()), numbers
