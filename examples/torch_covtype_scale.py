"""End-to-end driver of the paper's kind on the PyTorch port: a LARGE sharded clustering job.

    PYTHONPATH=src python examples/torch_covtype_scale.py [--n 200000] [--devices 2]
    PYTHONPATH=src python examples/torch_covtype_scale.py --smoke                # CI-sized
    PYTHONPATH=src python examples/torch_covtype_scale.py --smoke --device cpu   # plain path

The port's counterpart of examples/covtype_scale.py. CovType-scale synthetic
data (d=54, k=7, Table 1's dimensions) lives out of core in a BlockStore;
`KernelKMeans(backend="stream_shard")` shards the block stream over a mesh of
`--devices` logical shards of the one device (a `[device] * devices` list:
one producer thread and one fused embed+assign plan a shard, (Z, g)-only
reduces) where the reference forces XLA host devices. Model selection runs as
an embed-once `sweep` over a compressed staged-Y cache
(`ComputePolicy(cache_dtype="int8")`): on the card every candidate's Lloyd
step over a cached block is one `fused_dequant_step` launch. Reports NMI of
the selected model, phase timings from the FitReport, and the staged cache's
counters, then predicts a block with the adopted winner.
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.api import ComputePolicy, KernelKMeans  # noqa: E402
from repro_torch.core.metrics import nmi  # noqa: E402
from repro_torch.data.synthetic import gaussian_blobs_blocks  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--devices", type=int, default=2,
                    help="logical shards of the one device (the mesh's data axis)")
    ap.add_argument("--l", type=int, default=500)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--method", default="nystrom", choices=["nystrom", "sd"])
    ap.add_argument("--block-rows", type=int, default=16384)
    ap.add_argument("--restarts", type=int, default=2)
    ap.add_argument("--cache-dtype", default="int8", choices=["f32", "bf16", "int8"])
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: small n / l / m, 2 shards")
    ap.add_argument("--device", default=None,
                    help="the card by default; 'cpu' runs the plain path on the CPU")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n, args.devices = 16384, 2
        args.l, args.m, args.block_rows = 64, 32, 4096
    dev = resolve_device(args.device)

    k, d = 7, 54  # CovType dimensions (Table 1)
    mesh = make_host_mesh(args.devices, 1, dev)
    print(f"[covtype-scale] n={args.n} d={d} k={k} mesh={mesh.shape} of {dev}")

    t0 = time.time()
    store, y_store = gaussian_blobs_blocks(
        0, args.n, d, k, block_rows=args.block_rows, separation=1.8, warp=True)
    y = y_store.materialize().ravel()
    print(f"[covtype-scale] blocked store ready in {time.time()-t0:.1f}s "
          f"({store.num_blocks} blocks of {args.block_rows})")

    # Embed-once model selection around the true k, over a compressed cache:
    # ONE sharded embedding pass stages quantized Y blocks; every Lloyd pass
    # over the cache feeds every (k, restart) candidate.
    est = KernelKMeans(
        k, method=args.method, backend="stream_shard", mesh=mesh,
        l=args.l, m=args.m, iters=20, block_rows=args.block_rows,
        policy=ComputePolicy(cache_dtype=args.cache_dtype),
    )
    t1 = time.time()
    result = est.sweep(store, k_grid=[k - 1, k, k + 1], restarts=args.restarts, seed=0)
    t_sweep = time.time() - t1

    score = nmi(np.asarray(result.best_labels), y)
    cache = obs.snapshot("cache.")
    report = result.report
    print(f"[covtype-scale] sweep {len(result.k_grid)}k x {result.restarts}r "
          f"candidates in {t_sweep:6.1f}s (backend={est.backend_})")
    for name, secs in sorted(report.phases.items()):
        print(f"[covtype-scale]   phase {name:<12}: {secs:6.1f}s")
    print(f"[covtype-scale] staged Y cache     : "
          f"{cache.get('cache.bytes_staged', 0)/1e6:.1f} MB "
          f"({args.cache_dtype}, ratio "
          f"{cache.get('cache.compression_ratio', 1.0):.2f}x vs f32)")
    print(f"[covtype-scale] selected k         : {result.best_k} "
          f"(restart {result.best_restart}, inertia {result.best_inertia:.0f})")
    print(f"[covtype-scale] NMI vs ground truth: {score:.3f}")

    # The estimator adopted the winner: the normal lifecycle continues.
    sample = store.get(0)
    labels_new = est.predict(sample)
    if labels_new.shape[0] != sample.shape[0]:
        raise AssertionError(f"predict gave {labels_new.shape[0]} labels for "
                             f"{sample.shape[0]} rows")
    sizes = np.bincount(labels_new, minlength=result.best_k).tolist()
    print(f"[covtype-scale] predict on a fresh block: {sizes}")
    return dict(n=args.n, devices=args.devices, backend=est.backend_, sweep_s=t_sweep,
                phases_s=dict(report.phases), cache_bytes_staged=cache.get("cache.bytes_staged", 0),
                cache_compression_ratio=cache.get("cache.compression_ratio", 1.0),
                best_k=result.best_k, best_restart=result.best_restart,
                best_inertia=result.best_inertia, nmi=score, predict_sizes=sizes)


if __name__ == "__main__":
    main()
