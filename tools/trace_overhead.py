"""What tracing costs a stream fit, or a benchmark cell's calls, on the card (CUDA only).

    python3 tools/trace_overhead.py [--pairs 3] [--n N]
    python3 tools/trace_overhead.py --workload <cell> [--workload <cell> ...] [--pairs 3]

Without ``--workload``: builds the kernels, makes chip_smoke.py's
ImageNet-shaped blobs (n = 1,262,102 unless ``--n``, d = 900, k = 164) on the
card, copies them into a pinned host store of 4,096-row blocks, and fits the
stream backend (nystrom, l = 500, m = 256, 20 iterations) untraced and traced
in turns (U T T U U T for three pairs), printing one JSON line a fit: its
Lloyd seconds a pass and the spans it recorded.

With ``--workload``: sets each benchmark cell up as ``bench/run.py`` does
(its configuration, mix and data from ``SEED``, warm-up included, the same
thread caps) and makes its calls untraced and traced in the same turns,
``CALLS`` predict calls or one fit a turn, with the program's spans only (no
device profiler), printing one JSON line a turn (the mean seconds a call)
and one a cell: the cost of tracing a call, traced less untraced turn in
each pair, as its median and quartiles in microseconds and the median in %
of the untraced median; and for each span, its count a call, its mean
microseconds, and its mean own microseconds (under none of its child spans:
a ``predict``'s own time is the host work that no sub-span names). Last, one
traced turn of the mix's ``traced_calls`` as the harness's traced run makes
it, under the device profiler with a mark before each call, and the same
span figures for it.

Either way it then prints the host cost of one span (disabled, enabled, and
enabled with ``observe=True``) on the calling thread, a summary line, and
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path

for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "4")  # bench/run.py's caps

import torch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
#: A cell's calls a turn, and the seed its data is made from.
CALLS = 2000
SEED = 4100000001


def span_us(obs, enabled: bool, count: int = 100_000, observe: bool = False) -> float:
    """Host microseconds of one ``obs.span`` entered and left."""
    obs.clear_trace()
    if enabled:
        obs.enable_tracing()
    t0 = time.perf_counter()
    for i in range(count):
        with obs.span("x", cat="y", observe=observe, block=i):
            pass
    seconds = time.perf_counter() - t0
    obs.disable_tracing()
    obs.clear_trace()
    return seconds / count * 1e6


def turns(pairs: int) -> list[bool]:
    """Untraced (False) and traced (True) in turns: U T T U U T ..."""
    return [t for i in range(pairs) for t in ((False, True) if i % 2 == 0 else (True, False))]


def stream_fit_overhead(obs, pairs: int, n: int | None) -> dict:
    import chip_smoke as smoke
    from repro_torch.api import KernelKMeans

    cfg = dict(smoke.IMAGENET)
    dev = torch.device("cuda")
    X, _ = smoke.make_blobs(n or cfg["n"], cfg["d"], cfg["k"], cfg["separation"], 0, dev)
    store = smoke.pinned_store(X, cfg["block_rows"])
    del X
    per_pass = {False: [], True: []}
    for traced in turns(pairs):
        obs.clear_trace()
        if traced:
            obs.enable_tracing()
        try:
            est = KernelKMeans(cfg["k"], kernel="rbf", method="nystrom", l=cfg["l"],
                               m=cfg["m"], iters=cfg["iters"], backend="stream",
                               block_rows=cfg["block_rows"], random_state=0,
                               device=dev).fit(store)
        finally:
            obs.disable_tracing()
        report = est.fit_report_
        seconds = report.phases["lloyd"] / sum(report.pass_counts.values())
        per_pass[traced].append(seconds)
        print(json.dumps(dict(traced=traced, per_pass_s=seconds,
                              spans=len(obs.TRACER.spans()))), flush=True)
    obs.clear_trace()
    untraced, traced = statistics.median(per_pass[False]), statistics.median(per_pass[True])
    return dict(median_untraced_per_pass_s=untraced, median_traced_per_pass_s=traced,
                overhead=traced / untraced - 1.0)


def span_figures(spans, calls: int) -> dict:
    """Each span name's count a call, mean µs, and mean own µs: its time under
    none of the spans nested in it on its lane."""
    own = {id(sp): sp.dur for sp in spans}
    stack = []
    for sp in sorted(spans, key=lambda sp: (sp.lane, sp.t0, -sp.dur)):
        while stack and (stack[-1].lane != sp.lane or sp.t0 >= stack[-1].t0 + stack[-1].dur):
            stack.pop()
        if stack:
            own[id(stack[-1])] -= sp.dur
        stack.append(sp)
    by_name = defaultdict(list)
    for sp in spans:
        by_name[sp.name].append(sp)
    return {name: dict(a_call=len(group) / calls,
                       mean_us=1e6 * statistics.fmean(sp.dur for sp in group),
                       own_us=1e6 * statistics.fmean(own[id(sp)] for sp in group))
            for name, group in sorted(by_name.items())}


def cell_overhead(obs, workload: str, pairs: int) -> dict:
    """A benchmark cell's calls untraced and traced in turns, then one turn
    traced as the harness's traced run traces it."""
    from bench.harness.runner import cell_spec, traffic_kind
    from bench.harness.trace import DeviceTrace
    from repro_torch.policy import ComputePolicy

    _, _, cfg, mix = cell_spec(workload)
    dev = torch.device("cuda")
    traffic = traffic_kind(mix["kind"])(cfg, mix, SEED, dev, ComputePolicy())
    traffic.setup()
    torch.cuda.synchronize(dev)
    per_turn = 1 if mix["kind"] == "fit" else CALLS
    order = turns(pairs)
    call_s, spans = [], []
    i = 0
    for traced in order:
        obs.clear_trace()
        if traced:
            obs.enable_tracing()
        try:
            recs = [traffic.call(i + j) for j in range(per_turn)]
        finally:
            obs.disable_tracing()
        i += per_turn
        call_s.append(statistics.fmean(r.t1 - r.t0 for r in recs))
        spans += obs.TRACER.spans()
        print(json.dumps(dict(workload=workload, traced=traced, call_s=call_s[-1])), flush=True)

    # the harness's traced run: the device profiler on, a mark before each call
    obs.clear_trace()
    obs.enable_tracing()
    tracer = DeviceTrace(dev)
    tracer.start()
    try:
        for j in range(mix["traced_calls"]):
            tracer.mark()
            traffic.call(i + j)
        tracer.stop()
    finally:
        obs.disable_tracing()
    profiled = obs.TRACER.spans()
    obs.clear_trace()
    traffic.release()

    untraced = [s for s, t in zip(call_s, order) if not t]
    cost = [1e6 * (call_s[p + int(not order[p])] - call_s[p + int(order[p])])
            for p in range(0, len(order), 2)]
    return dict(workload=workload, calls_a_turn=per_turn,
                median_untraced_s=statistics.median(untraced),
                median_traced_s=statistics.median(s for s, t in zip(call_s, order) if t),
                pair_cost_us=cost, cost_us=statistics.median(cost),
                cost_quartiles_us=statistics.quantiles(cost, n=4) if len(cost) > 1 else None,
                cost_pct=statistics.median(cost) / 1e4 / statistics.median(untraced),
                spans=span_figures(spans, pairs * per_turn),
                profiled_spans=span_figures(profiled, mix["traced_calls"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--workload", action="append", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_overhead: needs a CUDA card", file=sys.stderr)
        return 2

    import chip_smoke as smoke
    from repro_torch import obs
    from repro_torch.kernels import build

    build.build_all()
    if args.workload:
        for workload in args.workload:
            print(json.dumps(cell_overhead(obs, workload, args.pairs)), flush=True)
            torch.cuda.empty_cache()
    else:
        print(json.dumps(stream_fit_overhead(obs, args.pairs, args.n)), flush=True)
    print(json.dumps(dict(
        span_us=span_us(obs, True), observed_span_us=span_us(obs, True, observe=True),
        null_span_us=span_us(obs, False))), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
