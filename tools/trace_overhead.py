"""What tracing costs a stream fit on the card (CUDA only).

    python3 tools/trace_overhead.py [--pairs 3] [--n N]

Builds the kernels, makes chip_smoke.py's ImageNet-shaped blobs (n =
1,262,102 unless ``--n``, d = 900, k = 164) on the card, copies them into a
pinned host store of 4,096-row blocks, and fits the stream backend (nystrom,
l = 500, m = 256, 20 iterations) untraced and traced in turns (U T T U U T
for three pairs), printing one JSON line a fit: its Lloyd seconds a pass and
the spans it recorded. It then prints the host cost of one span, enabled and
disabled, on the calling thread, a summary line with the medians, and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def span_us(obs, enabled: bool, count: int = 100_000) -> float:
    """Host microseconds of one ``obs.span`` entered and left."""
    obs.clear_trace()
    if enabled:
        obs.enable_tracing()
    t0 = time.perf_counter()
    for i in range(count):
        with obs.span("x", cat="y", block=i):
            pass
    seconds = time.perf_counter() - t0
    obs.disable_tracing()
    obs.clear_trace()
    return seconds / count * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--n", type=int, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_overhead: needs a CUDA card", file=sys.stderr)
        return 2

    import chip_smoke as smoke
    from repro_torch import obs
    from repro_torch.api import KernelKMeans
    from repro_torch.kernels import build

    build.build_all()
    cfg = dict(smoke.IMAGENET)
    dev = torch.device("cuda")
    X, _ = smoke.make_blobs(args.n or cfg["n"], cfg["d"], cfg["k"], cfg["separation"], 0, dev)
    store = smoke.pinned_store(X, cfg["block_rows"])
    del X
    order = [t for i in range(args.pairs) for t in ((False, True) if i % 2 == 0 else (True, False))]
    per_pass = {False: [], True: []}
    for traced in order:
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
    print(json.dumps(dict(
        median_untraced_per_pass_s=untraced, median_traced_per_pass_s=traced,
        overhead=traced / untraced - 1.0, span_us=span_us(obs, True),
        null_span_us=span_us(obs, False))), flush=True)
    print(smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
