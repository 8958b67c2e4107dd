"""One run of one cell: set-up, the timed window, the traced calls, the check
against the reference, and the result line.

Everything a cell is made of is found by name: the cell in BENCHMARK.json,
its configuration under ``bench/configs/``, its traffic mix under
``bench/traffic/<mix>.json``, whose ``kind`` names the module that drives
its calls (``bench/kinds/<kind>.py``), the limits of its numbers under
``bench/limits/<cell>.json``, and each per-layer metric's reader under
``bench/layer_metrics/<metric>.py``.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from bench.harness.trace import DeviceTrace, TraceSummary
from bench.reference import blobs

ROOT = Path(__file__).resolve().parents[2]
#: Entries of each list of the breakdown.
TOP = 10


@dataclasses.dataclass
class RunView:
    """What a per-layer metric's reader sees of a run."""

    cfg: dict
    mix: dict
    traffic: object  # the run's Traffic, of the mix's kind
    calls: list  # every call of the window
    traced: list  # the calls the device trace covers
    trace: TraceSummary | None  # None off the card
    on_card: bool


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the cell, its configuration, its traffic mix)."""
    spec = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = load_json(root / cfg_entry["file"])
    mix = load_json(root / "bench" / "traffic" / f"{cell['traffic']}.json")
    return spec, cell, cfg, mix


def applies(metric: dict, cell: str, end_to_end: dict) -> bool:
    """Whether ``metric`` is reported in ``cell``: its own ``workloads`` list,
    or else every cell that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    moved = end_to_end.get(metric.get("moves"))
    return moved is None or "workloads" not in moved or cell in moved["workloads"]


def traffic_kind(kind: str):
    """The ``Traffic`` class of a kind of traffic, ``bench/kinds/<kind>.py``."""
    return importlib.import_module(f"bench.kinds.{kind}").Traffic


def reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of a per-layer metric, by its file name."""
    path = root / "bench" / "layer_metrics" / f"{name}.py"
    mod_name = "bench.layer_metrics._" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def launch_counts() -> dict:
    from repro_torch.kernels import apnc_assign, apnc_embed, lloyd_step

    return {"apnc_embed": apnc_embed.launches, "apnc_assign": apnc_assign.launches,
            **lloyd_step.launches}


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device,
             t_start: float, policy=None, overrides: dict | None = None,
             root: Path = ROOT) -> tuple[dict, list[str]]:
    """Run the cell and return (the result object, the check's stderr lines).

    ``overrides`` replaces keys of the configuration and the mix (the CPU
    tests' small sizes); ``policy`` the program's ``ComputePolicy`` (the
    control runs)."""
    from repro_torch import obs
    from repro_torch.policy import ComputePolicy

    spec, _, cfg, mix = cell_spec(workload, root)
    for key, value in (overrides or {}).items():
        (mix if key in mix else cfg)[key] = value
    device = torch.device(device)
    on_card = device.type == "cuda"
    traffic = traffic_kind(mix["kind"])(cfg, mix, seed, device, policy or ComputePolicy())
    traffic.setup()
    if on_card:
        torch.cuda.synchronize(device)

    calls, spans = [], []
    tracer = DeviceTrace(device) if trace and on_card else None
    traced_n = mix["traced_calls"] if trace else 0
    setup_s = time.perf_counter() - t_start
    if trace:  # the profiler starts before the window and runs over its first calls
        obs.clear_trace()
        obs.enable_tracing()
        if tracer:
            tracer.start()
    before_launches = launch_counts()
    t_win = time.perf_counter()
    deadline = t_win + seconds
    i = 0
    while i < traced_n or time.perf_counter() < deadline:
        tracing = i < traced_n
        if tracing and tracer:
            tracer.mark()
        rec = traffic.call(i)
        calls.append(rec)
        if tracing:
            spans.append(("bench.call", rec.t0, rec.t1))
        i += 1
        if tracing and i == traced_n:
            if tracer:
                tracer.stop()
            obs.disable_tracing()
    window_s = calls[-1].t1 - t_win
    launches = {k: v - before_launches[k] for k, v in launch_counts().items()}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    summary = None
    if trace:
        spans += [(sp.name, sp.t0, sp.t0 + sp.dur) for sp in obs.TRACER.spans()]
        obs.clear_trace()
        if tracer:
            summary = tracer.summary(spans)
    view = RunView(cfg, mix, traffic, calls, calls[:traced_n], summary, on_card)

    e2e = {m["name"]: m for m in spec["end_to_end"]}
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            if applies(m, workload, e2e):
                value = reader(m["name"], root)(view)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = dict(traffic.end_to_end(calls, window_s), setup_s=setup_s)
        for m in spec["end_to_end"]:
            if applies(m, workload, e2e):
                metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}

    # The check runs once the window has closed and the peak is read, with the
    # program's state dropped.
    traffic.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = traffic.check(calls, np.random.default_rng(blobs.stream_seed(seed, 7)))
    check_s = time.perf_counter() - t_check
    limits = load_json(root / "bench" / "limits" / f"{workload}.json")["numbers"]
    checks, correct = {}, True
    lines = [f"{traffic.describe(calls)}; setup {setup_s:.3f} s, window {window_s:.3f} s"]
    lines += [f"note {name} = {value!r} (not compared)" for name, value in numbers.items()
              if name not in limits]
    for name, lim in limits.items():
        value = numbers.get(name, float("nan"))
        ok = _finite(value) is not None and value <= lim["limit"]
        correct &= ok
        checks[name] = {"value": _finite(value), "limit": lim["limit"]}
        lines.append(f"check {name} = {value!r} (limit {lim['limit']!r}) "
                     f"{'ok' if ok else 'FAILED'}")
    lines.append(f"check: {len(checks)} numbers, correct={correct}, reference {check_s:.1f} s")

    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else device.type,
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(calls), "failed": 0,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        gaps = defaultdict(float)
        for name, s in summary.gaps:
            gaps[name] += s
        result["breakdown"] = {
            "device_ops": sorted(summary.ops.items(), key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP],
            "launches": sorted(launches.items()),
        }
    result["checks"] = checks
    return result, lines
