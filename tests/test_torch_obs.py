"""The port's observability (repro_torch.obs) against the JAX package's.

Ports of tests/test_obs.py's tests that need no sharded backend, plus:

  * the port's exports are the JAX package's (`obs.__all__`);
  * the engine, plan, backend and checkpoint metrics carry the JAX
    package's names, and the older views (`engine.COUNTERS`,
    `engine.PASS_COUNTS`, `checkpoint.COUNTERS`) agree with them;
  * a traced stream fit has the driver's lane and one producer lane, one
    `h2d` span a block a pass, and the phase spans;
  * a fit's FitReport fields equal the JAX package's for the same data,
    params and inits (phases excepted: they are times).
"""
from __future__ import annotations

import dataclasses
import json
import sys
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.api import KernelKMeans as JKernelKMeans
from repro.core.kernels_fn import Kernel as JKernel
from repro.stream.blockstore import BlockStore as JBlockStore
from repro_torch import obs
from repro_torch.api import KernelKMeans
from repro_torch.convert import apnc_params_from_numpy
from repro_torch.core.kernels_fn import Kernel
from repro_torch.data.synthetic import gaussian_blobs_blocks
from repro_torch.stream import engine
from repro_torch.stream.blockstore import BlockStore

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _clean_obs():
    """Every test starts from disabled tracing and an empty span buffer
    (metrics are not wiped: production code holds instrument references, and
    the tests scope their reads by snapshot / delta)."""
    obs.disable_tracing()
    obs.clear_trace()
    yield
    obs.disable_tracing()
    obs.clear_trace()


def test_exports_are_the_references():
    assert sorted(obs.__all__) == sorted(jobs.__all__)
    for name in obs.__all__:
        assert getattr(obs, name) is not None


# ------------------------------------------------------------------- tracer


def test_disabled_span_is_the_null_singleton():
    assert not obs.tracing_enabled()
    s = obs.span("anything", cat="x", attr=1)
    assert s is obs.NULL_SPAN  # no per-call allocation on the disabled path
    with s as inner:
        inner.set(more="attrs ignored")
    assert obs.TRACER.spans() == []


def test_enabled_span_records_duration_and_lane():
    obs.enable_tracing()
    with obs.span("work", cat="test", block=3) as s:
        s.set(rows=100)
    (sp,) = obs.TRACER.spans()
    assert sp.name == "work" and sp.cat == "test"
    assert sp.dur >= 0.0 and sp.t0 > 0.0
    assert sp.attrs == {"block": 3, "rows": 100}
    assert sp.lane == "main"


def test_lanes_are_thread_local():
    obs.enable_tracing()

    def worker(lane):
        obs.set_lane(lane)
        with obs.span("w"):
            pass

    threads = [threading.Thread(target=worker, args=(f"producer:{i}",)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert sorted(s.lane for s in obs.TRACER.spans()) == [
        "producer:0", "producer:1", "producer:2"]


def test_chrome_trace_export_structure(tmp_path):
    obs.enable_tracing()
    with obs.span("outer", cat="pass"):
        with obs.span("inner", cat="ingest", block=0):
            pass
    path = obs.write_chrome_trace(tmp_path / "t.json")
    d = json.loads(path.read_text())
    events = d["traceEvents"]
    meta = [e for e in events if e["ph"] == "M" and e["name"] == "thread_name"]
    complete = [e for e in events if e["ph"] == "X"]
    assert len(complete) == 2
    named = {(e["pid"], e["tid"]): e["args"]["name"] for e in meta}
    for e in complete:
        assert named[(e["pid"], e["tid"])] == "main"
        assert e["ts"] >= 0 and e["dur"] >= 0
    inner = next(e for e in complete if e["name"] == "inner")
    assert inner["args"]["block"] == 0
    # the JAX package's trace checker accepts what the port writes
    sys.path.insert(0, str(REPO / "benchmarks"))
    try:
        import check_bench
        lanes = check_bench.check_trace(path, min_lanes=1)
    finally:
        sys.path.pop(0)
    assert lanes == {"main"}
    # and the same spans export to the JAX package's events
    assert obs.chrome_trace_events(obs.TRACER.spans()) == jobs.chrome_trace_events(
        obs.TRACER.spans())


def test_write_trace_jsonl_suffix(tmp_path):
    obs.enable_tracing()
    with obs.span("a", cat="c", x=1):
        pass
    path = obs.write_trace(tmp_path / "t.jsonl")
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(lines) == 1
    assert lines[0]["name"] == "a" and lines[0]["lane"] == "main"
    assert lines[0]["x"] == 1


# ------------------------------------------------------------------ metrics


def test_counter_gauge_histogram_basics():
    obs.reset_metrics("t0.")
    c = obs.counter("t0.c")
    c.inc()
    c.inc(2.5)
    assert c.value == 3.5
    g = obs.gauge("t0.g")
    g.set(7)
    g.set(3)
    assert g.value == 3 and g.hwm == 7
    h = obs.histogram("t0.h")
    for v in range(100):
        h.observe(float(v))
    assert h.count == 100
    assert h.percentile(50) == pytest.approx(49.5, abs=1.0)
    stats = h.stats()
    assert stats["min"] == 0.0 and stats["max"] == 99.0
    assert stats["p99"] >= stats["p90"] >= stats["p50"]
    jh = jobs.histogram("t0.h_ref")
    for v in range(100):
        jh.observe(float(v))
    assert stats == jh.stats()
    with pytest.raises(TypeError):
        obs.gauge("t0.c")  # a name keeps its kind


def test_snapshot_reset_and_delta_are_prefix_scoped():
    obs.reset_metrics("t1.")
    obs.counter("t1.a").inc(5)
    before = obs.snapshot("t1.")
    obs.counter("t1.a").inc(2)
    after = obs.snapshot("t1.")
    assert obs.delta(before, after)["t1.a"] == 2
    c = obs.counter("t1.a")
    obs.reset_metrics("t1.")
    assert obs.snapshot("t1.")["t1.a"] == 0
    c.inc()  # held references keep working across reset
    assert obs.counter("t1.a").value == 1


def test_scoped_metrics_context():
    obs.reset_metrics("t2.")
    obs.counter("t2.n").inc(10)
    with obs.scoped("t2.") as seen:
        obs.counter("t2.n").inc(4)
    assert seen["t2.n"] == 4


def test_counter_thread_safety():
    """More writers than cores and a short switch interval: a lost update
    under the read-modify-write would show in the total."""
    obs.reset_metrics("t3.")
    c = obs.counter("t3.hits")
    N, T = 5_000, 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [c.inc() for _ in range(N)])
                   for _ in range(T)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert c.value == N * T


# ---------------------------------------------------------------- the views


def test_pass_counts_shim_stays_in_lockstep():
    engine.reset_pass_counts()
    store = BlockStore.from_array(gaussian_blobs_blocks(0, 512, 4, 2, block_rows=128)[0], 128)
    engine.map_reduce(store, lambda x: x.sum(), lambda a, b: a + b, torch.zeros(()),
                      label="shim_probe", device="cpu")
    assert engine.pass_count("shim_probe") == 1
    assert engine.PASS_COUNTS["shim_probe"] == 1
    assert obs.counter("engine.passes.shim_probe").value == 1
    engine.reset_pass_counts()
    assert engine.pass_count("shim_probe") == 0
    assert engine.PASS_COUNTS["shim_probe"] == 0


@pytest.mark.parametrize("prefetch", [0, 2])
def test_engine_counters_view_the_registry(prefetch):
    engine.reset_counters()
    X = gaussian_blobs_blocks(1, 700, 6, 3, block_rows=128)[0]
    store = BlockStore.from_array(X, 128)
    engine.map_reduce(store, lambda x: x.sum(), lambda a, b: a + b, torch.zeros(()),
                      prefetch=prefetch, device="cpu")
    snap = obs.snapshot("engine.")
    assert dict(engine.COUNTERS) == dict(
        blocks_read=store.num_blocks, bytes_h2d=X.nbytes,
        prefetch_stall_s=engine.COUNTERS["prefetch_stall_s"],
        map_dispatches=store.num_blocks, bytes_staged=0, compression_ratio=0.0)
    assert snap["engine.blocks_read"] == engine.COUNTERS["blocks_read"]
    assert snap["engine.bytes_h2d"] == X.nbytes
    assert snap["engine.device_blocks.cpu"] == store.num_blocks
    assert engine.COUNTERS["prefetch_stall_s"] == snap["engine.prefetch_stall_s"] >= 0
    engine.reset_counters()
    assert not any(engine.COUNTERS.values()) and not engine.PASS_COUNTS


def test_cache_embedding_counts_staged_bytes_and_ratio():
    engine.reset_counters()
    X = gaussian_blobs_blocks(1, 700, 6, 3, block_rows=128)[0]
    out = engine.cache_embedding(BlockStore.from_array(X, 128), lambda x: x * 2.0, d_out=6,
                                 codec="int8", device="cpu")
    assert obs.counter("cache.bytes_staged").value == out.nbytes_staged
    assert obs.gauge("cache.compression_ratio").value == pytest.approx(
        X.nbytes / out.nbytes_staged)
    assert engine.COUNTERS["bytes_staged"] == out.nbytes_staged


def test_checkpoint_counters_view_the_registry(tmp_path):
    from repro_torch.distributed import checkpoint as ck
    from repro_torch.launch.elastic import resume_lloyd_state

    ck.reset_counters()
    assert ck.COUNTERS == dict(ckpt_saves=0, ckpt_resumes=0, elastic_resumes=0)
    fp = ck.lloyd_fingerprint(kind="ooc", n=4, d=2, k=2, m=2, init=torch.zeros((2, 2)))
    before = obs.snapshot("pool.")
    ck.save_lloyd_state(tmp_path, step=1, centroids=torch.zeros((2, 2)),
                        labels=np.zeros(4, np.int32), trajectory=[1.0], shifts=[0.0],
                        changed=True, fingerprint=fp, devices_used=2)
    assert resume_lloyd_state(tmp_path, fingerprint=fp, devices_used=1) is not None
    seen = obs.delta(before, obs.snapshot("pool."))
    assert seen["pool.ckpt_saves"] == 1 and seen["pool.ckpt_resumes"] == 1
    assert seen["pool.elastic_resumes"] == 1
    assert dict(ck.COUNTERS) == dict(ckpt_saves=1, ckpt_resumes=1, elastic_resumes=1)
    assert all(type(v) is int for v in ck.COUNTERS.values())


# ---------------------------------------------------------------- FitReport


def _data():
    return gaussian_blobs_blocks(0, 1024, 8, 3, block_rows=256)[0]


def _fit(backend, method="rff", **kw):
    est = KernelKMeans(3, kernel=Kernel("rbf", gamma=0.1), method=method, m=32,
                       backend=backend, iters=5, n_init=1, random_state=7, device="cpu", **kw)
    X = _data()
    est.fit(X if backend == "local" else BlockStore.from_array(X, 256), seed=7)
    return est


@pytest.mark.parametrize("backend", ["local", "stream", "minibatch"])
def test_every_backend_returns_populated_fit_report(backend):
    est = _fit(backend)
    r = est.fit_report_
    assert isinstance(r, obs.FitReport)
    assert r.backend == backend
    assert r.iters >= 1 and r.rows_seen > 0
    assert len(r.inertia_trajectory) == r.iters + 1
    assert r.inertia_trajectory[-1] == est.inertia_  # the trajectory ends at inertia_
    assert set(r.phases) >= {"reservoir", "embed_fit", "seed", "lloyd"}
    assert all(v >= 0 for v in r.phases.values())
    assert r.phases == est.phases_
    assert est.model_.report is r  # one object, two access paths
    if backend in ("stream", "minibatch"):
        assert r.blocks_read > 0 and r.bytes_h2d > 0
        assert sum(r.pass_counts.values()) > 0
        assert r.per_device_blocks == {"cpu": r.blocks_read}


def test_exact_backends_report_identical_trajectories():
    """local and stream run the same math from the same seed, so their
    reports agree on shape and trajectory."""
    ref = _fit("local").fit_report_
    r = _fit("stream").fit_report_
    assert ref.iters >= 1 and r.iters == ref.iters
    np.testing.assert_allclose(r.inertia_trajectory, ref.inertia_trajectory, rtol=1e-4)
    np.testing.assert_allclose(r.centroid_shifts, ref.centroid_shifts, rtol=1e-3, atol=1e-5)


def test_fit_report_serializes(tmp_path):
    est = _fit("stream")
    out = tmp_path / "report.json"
    est.fit_report_.to_json(out)
    d = json.loads(out.read_text())
    assert d["backend"] == "stream"
    assert d["inertia_trajectory"] == est.fit_report_.inertia_trajectory
    assert "lloyd" in d["phases"]
    assert "lloyd=" in est.fit_report_.summary()


def test_report_is_not_model_state(tmp_path):
    """A checkpoint does not carry the report; the loaded model has none."""
    est = _fit("local")
    est.save(tmp_path)
    assert KernelKMeans.load(tmp_path, device="cpu").model_.report is None


def test_sweep_attaches_report():
    est = KernelKMeans(3, kernel=Kernel("rbf", gamma=0.1), method="rff", m=32,
                       backend="stream", iters=4, random_state=7, device="cpu")
    result = est.sweep(BlockStore.from_array(_data(), 256), [2, 3], restarts=2, seed=7)
    r = result.report
    assert isinstance(r, obs.FitReport)
    assert r is est.fit_report_ and est.model_.report is r
    assert r.extra["sweep"] is True
    assert r.extra["k_grid"] == [2, 3] and r.extra["candidates"] == 4
    assert r.extra["resumed"] is False
    assert "embed_cache" in r.phases and "lloyd" in r.phases
    assert r.blocks_read > 0
    assert r.inertia_trajectory[-1] == est.inertia_
    assert r.pass_counts["cache_embedding"] == 1
    assert r.pass_counts["sweep_lloyd"] == r.extra["lloyd_passes"] + 1


def test_partial_fit_reports_each_call():
    est = KernelKMeans(3, kernel=Kernel("rbf", gamma=0.1), l=64, m=16, device="cpu")
    X = _data()
    for lo in range(0, 1024, 256):
        est.partial_fit(X[lo:lo + 256])
        r = est.fit_report_
        assert r.backend == "minibatch" and r.iters == 0
        assert r.inertia_trajectory == [est.inertia_]
        assert r.rows_seen == lo + 256 and est.model_.report is r
        assert list(r.phases) == ["partial_fit"] and r.phases == est.phases_


def test_embed_cache_hits_are_counted():
    from repro_torch.api.backends import ensure_embedding_cache, fit_stream

    est = KernelKMeans(3, kernel=Kernel("rbf", gamma=0.1), m=16, l=32, backend="stream",
                       iters=2, device="cpu")
    ctx = est._prepare(BlockStore.from_array(_data(), 256), 0, torch.device("cpu"), "stream")
    before = obs.counter("backend.embed_cache_hits").value
    ensure_embedding_cache(ctx)  # the first call fills it
    ensure_embedding_cache(ctx)  # idempotent re-entry
    fit_stream(ctx)  # the stream backend over the staged Y
    assert obs.counter("backend.embed_cache_hits").value - before == 2


def test_fused_step_is_counted_and_spanned():
    """The rff member's fused step (its plain version here): one
    `engine.fused_dispatches` and, traced, one `lloyd.fused_step` span a
    block of every pass, the final assign pass included."""
    obs.enable_tracing()
    before = obs.snapshot("engine.")
    est = _fit("stream")
    d = obs.delta(before, obs.snapshot("engine."))
    steps = 4 * (est.n_iter_ + 1)
    assert d["engine.fused_dispatches"] == steps
    spans = [s for s in obs.TRACER.spans() if s.name == "lloyd.fused_step"]
    assert len(spans) == steps and {s.attrs["member"] for s in spans} == {"rff"}
    iters = [s for s in obs.TRACER.spans() if s.name == "lloyd.iter"]
    assert [s.attrs["iter"] for s in iters] == list(range(est.n_iter_))
    assert iters[-1].attrs["inertia"] == est.fit_report_.inertia_trajectory[-2]


def test_traced_stream_fit_lanes_and_counts(tmp_path):
    obs.enable_tracing()
    est = _fit("stream", method="nystrom", l=64)
    r = est.fit_report_
    path = obs.write_trace(tmp_path / "fit.json")
    events = json.loads(path.read_text())["traceEvents"]
    lanes = {e["args"]["name"] for e in events if e["ph"] == "M"}
    assert lanes == {"main", "producer:cpu"}
    names = [e["name"] for e in events if e["ph"] == "X"]
    passes = sum(r.pass_counts.values())
    assert names.count("h2d") == names.count("block.get") == 4 * passes == r.blocks_read
    assert {f"phase.{p}" for p in ("reservoir", "embed_fit", "seed", "lloyd")} <= set(names)
    assert names.count("pass.map_reduce") == passes
    on_producer = {s.name for s in obs.TRACER.spans() if s.lane == "producer:cpu"}
    assert on_producer == {"block.get", "h2d"}


def test_untraced_fit_records_nothing():
    _fit("stream")
    assert obs.TRACER.spans() == []


def test_fit_report_fields_equal_the_references(monkeypatch):
    """The same data, params and k-means++ inits through both packages'
    stream fits: every FitReport field but the phases (times) and the
    per-device keys (the JAX package names its default device "default")."""
    X = _data()
    jest = JKernelKMeans(3, kernel=JKernel("rbf", gamma=0.1), method="nystrom", l=64, m=16,
                         backend="stream", iters=6, random_state=7)
    jctx = jest._prepare(JBlockStore.from_array(X, 256), jax.random.PRNGKey(7), "stream")
    jest.fit(JBlockStore.from_array(X, 256), key=jax.random.PRNGKey(7))
    want = jest.fit_report_

    params = apnc_params_from_numpy(
        np.asarray(jctx.params.landmarks), np.asarray(jctx.params.R),
        dataclasses.asdict(jctx.params.kernel), jctx.params.discrepancy, device="cpu")
    inits = [torch.from_numpy(np.array(i)) for i in jctx.inits]
    est = KernelKMeans(3, kernel=Kernel("rbf", gamma=0.1), method="nystrom", l=64, m=16,
                       backend="stream", iters=6, random_state=7, device="cpu")
    monkeypatch.setattr(est, "_fit_params_and_pool", lambda sample, s_fit: (params, None))
    monkeypatch.setattr(est, "_seed_inits", lambda *a: inits)
    est.fit(BlockStore.from_array(X, 256), seed=7)
    got = est.fit_report_
    for field in ("backend", "iters", "rows_seen", "pass_counts", "blocks_read",
                  "bytes_h2d", "extra"):
        assert getattr(got, field) == getattr(want, field), field
    assert set(got.phases) == set(want.phases) | {"host_view"}
    np.testing.assert_allclose(got.inertia_trajectory, want.inertia_trajectory, rtol=1e-5)
    np.testing.assert_allclose(got.centroid_shifts, want.centroid_shifts, rtol=1e-3, atol=1e-6)
    assert sum(got.per_device_blocks.values()) == sum(want.per_device_blocks.values())


# ------------------------------------------------------------ roofline join


def test_roofline_join_synthetic_record():
    from repro_torch.roofline.analysis import HBM_BW, PEAK_FLOPS

    # a pass that takes 1 ms at the f32 peak and is compute-bound, measured
    # at 2 ms: model_fraction 0.5
    rec = {"flops": PEAK_FLOPS * 1e-3, "hbm_bytes": HBM_BW * 1e-4, "collective_bytes": 0.0}
    out = obs.roofline_join(2e-3, rec)
    assert out["bottleneck"] == "compute"
    assert out["modeled_s"] == pytest.approx(1e-3)
    assert out["model_fraction"] == pytest.approx(0.5)

    report = obs.FitReport(backend="stream", phases={"lloyd": 8e-3},
                           pass_counts={"map_reduce": 4}, iters=3)
    joined = obs.join_fit_roofline(report, rec)
    assert joined["passes"] == 4
    assert joined["measured_s"] == pytest.approx(2e-3)  # 8 ms over 4 passes
    assert joined["model_fraction"] == pytest.approx(0.5)
    # no pass counts (the resident local backend): iters + 1 passes
    local = obs.join_fit_roofline(obs.FitReport(phases={"lloyd": 8e-3}, iters=3), rec)
    assert local["passes"] == 4


def test_report_from_metrics_delta_equals_the_references():
    d = {"engine.passes.map_reduce": 3.0, "engine.passes.idle": 0.0,
         "engine.device_blocks.cuda:0": 12.0, "engine.blocks_read": 12.0,
         "engine.bytes_h2d": 4096.0, "engine.map_dispatches": 12.0}
    assert obs.report_from_metrics_delta(d) == jobs.report_from_metrics_delta(d)
