"""What the CPU plain route's order-independent forms cost (CPU only).

    python3 tools/cpu_plain_cost.py [--n 4000] [--d 900] [--l 500] [--m 256] [--k 164]
                                    [--threads 1] [--repeats 5]

On CPU tensors the port sums Z with ``index_add_`` (not a one-hot GEMM),
takes the l2 cross term one ``torch.mv`` a centroid (not one (n, k) GEMM)
and computes an APNC block in f64, rounded once (not in f32), so that its
results do not depend on how a cluster is numbered or on the BLAS kernel
the thread count picks. This times each form beside the GEMM it replaced at
chip_smoke.py's card-vs-CPU size (phase baselines' ``small_n`` rows of the
ImageNet shape: d = 900, l = 500, m = 256, k = 164), on ``--threads``
threads (chip_smoke.py runs with one), and prints one JSON line: the median
ms of each, over ``--repeats`` calls after one warm-up call.
"""
from __future__ import annotations

import argparse
import json
import platform
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def median_ms(fn, repeats: int) -> float:
    fn()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv=None) -> dict:
    from repro_torch.core.apnc import embed_block, pairwise_discrepancy, sufficient_stats
    from repro_torch.core.kernels_fn import Kernel

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name, default in (("n", 4000), ("d", 900), ("l", 500), ("m", 256), ("k", 164),
                          ("threads", 1), ("repeats", 5)):
        ap.add_argument(f"--{name}", type=int, default=default)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    g = torch.Generator().manual_seed(0)
    X, L = torch.randn((args.n, args.d), generator=g), torch.randn((args.l, args.d), generator=g)
    R = torch.randn((args.m, args.l), generator=g)
    Y, C = torch.randn((args.n, args.m), generator=g), torch.randn((args.k, args.m), generator=g)
    labels = torch.randint(0, args.k, (args.n,), generator=g)
    kernel = Kernel("rbf", gamma=1.0 / args.d)
    onehot = torch.nn.functional.one_hot(labels, args.k).to(torch.float32)
    r = args.repeats
    out = dict(cpu=platform.processor() or platform.machine(), threads=args.threads,
               shape=dict(n=args.n, d=args.d, l=args.l, m=args.m, k=args.k),
               z_index_add_ms=median_ms(lambda: sufficient_stats(Y, labels, args.k), r),
               z_onehot_gemm_ms=median_ms(lambda: onehot.T @ Y, r),
               l2_cross_mv_ms=median_ms(
                   lambda: torch.stack([torch.mv(Y, c.clone()) for c in C], dim=1), r),
               l2_cross_gemm_ms=median_ms(lambda: Y @ C.T, r),
               l2_discrepancy_ms=median_ms(lambda: pairwise_discrepancy(Y, C, "l2"), r),
               embed_f64_ms=median_ms(lambda: embed_block(X, L, R, kernel), r),
               embed_f32_ms=median_ms(lambda: kernel.gram(X, L) @ R.T, r))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
