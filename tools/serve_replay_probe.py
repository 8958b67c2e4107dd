"""Whether served labels depend on the micro-batch on the card (CUDA only).

    python3 tools/serve_replay_probe.py [--n N] [--rows R] [--batch B]

The serving path labels a micro-batch padded to ``--batch`` rows
(``ops.predict_block``); the replay check labels the whole request log at
once (``core.kkmeans.predict``). Both embed through the member's kernel,
whose rows do not depend on the launch. The plain ``core.apnc.assign`` then
takes ``Y @ Cᵀ`` as a cuBLAS GEMM, which may sum in another order at another
row count; ``ops.assign_labels``, which both paths take, uses the
``apnc_assign`` kernel's labels on the card instead. This fits
chip_smoke.py's local Nyström model (d = 900, l = 500, m = 256, k = 164) on
``--n`` blob rows and an rff model (m/2 = 128), then for two request logs of
``--rows`` rows (held-out rows of the fit's mixture, and the serving CLI's
own log, a mixture with other centers) prints one JSON line a (model, log):
for the plain assign, the rows whose labels and whose distance bits differ
between per-micro-batch and whole-log calls; the same label count for the
``apnc_assign`` kernel and for the served path against the replay; and the
rows where the kernel's labels differ from the plain assign's over the
whole log. The last line is the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def per_batch(fn, X, batch):
    """fn over X in ``batch``-row slices, each zero-padded to ``batch`` rows."""
    outs = []
    for lo in range(0, X.shape[0], batch):
        xb = X[lo:lo + batch]
        b = xb.shape[0]
        if b < batch:
            xb = torch.cat([xb, xb.new_zeros((batch - b, xb.shape[1]))])
        outs.append(fn(xb)[:b])
    return torch.cat(outs)


def probe(name, tag, model, X, batch) -> dict:
    from repro_torch import embed
    from repro_torch.core.apnc import assign, pairwise_discrepancy
    from repro_torch.core.kkmeans import predict
    from repro_torch.kernels import apnc_assign, ops

    params, C, disc = model.params, model.centroids, model.params.discrepancy
    Y = embed.transform(params, X)
    Y_batched = per_batch(lambda xb: embed.transform(params, xb), X, batch)
    plain_batched = per_batch(lambda yb: assign(yb, C, disc), Y, batch)
    plain_whole = assign(Y, C, disc)
    D_batched = per_batch(lambda yb: pairwise_discrepancy(yb, C, disc), Y, batch)
    D_whole = pairwise_discrepancy(Y, C, disc)
    kernel_labels = lambda y: apnc_assign.apnc_assign(y.contiguous(), C.contiguous(), disc)[2]
    kernel_batched = per_batch(kernel_labels, Y, batch)
    kernel_whole = kernel_labels(Y)
    served = per_batch(lambda xb: ops.predict_block(xb, params, C), X, batch)
    replay = predict(X, params, C, device=X.device)
    gap = torch.sort(D_whole, dim=1).values
    differ = lambda a, b: int((a.long() != b.long()).sum())
    return dict(
        model=name, log=tag, rows=X.shape[0], batch=batch,
        y_rows_differing=int((Y_batched != Y).any(dim=1).sum()),
        plain_label_diffs=differ(plain_batched, plain_whole),
        plain_distance_rows_differing=int((D_batched != D_whole).any(dim=1).sum()),
        plain_distance_max_abs_diff=float((D_batched - D_whole).abs().max()),
        apnc_assign_label_diffs=differ(kernel_batched, kernel_whole),
        served_vs_replay_label_diffs=differ(served, replay),
        apnc_assign_vs_plain_label_diffs=differ(kernel_whole, plain_whole),
        min_rel_gap_top2=float(((gap[:, 1] - gap[:, 0]) / gap[:, 1].clamp(min=1e-30)).min()),
        distinct_labels=int(torch.unique(replay).numel()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=200_000)
    ap.add_argument("--rows", type=int, default=20_000)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("serve_replay_probe: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from repro_torch.api import KernelKMeans
    from repro_torch.data.synthetic import gaussian_blobs_blocks
    from repro_torch.kernels import build

    build.build_all()
    cfg = chip_smoke.IMAGENET
    dev = torch.device("cuda")
    X_all, _ = chip_smoke.make_blobs(args.n + args.rows, cfg["d"], cfg["k"],
                                     cfg["separation"], args.seed, dev)
    X, Xq = X_all[:args.n], X_all[args.n:]
    nys = KernelKMeans(cfg["k"], kernel="rbf", method="nystrom", l=cfg["l"], m=cfg["m"],
                       iters=cfg["iters"], backend="local", random_state=args.seed,
                       device=dev).fit(X).model_
    rff = KernelKMeans(cfg["k"], kernel="rbf", method="rff", m=cfg["rff_m"],
                       iters=cfg["iters"], backend="local", random_state=args.seed,
                       device=dev).fit(X).model_
    cli = gaussian_blobs_blocks(args.seed + 7919, args.rows, cfg["d"], cfg["k"],
                                block_rows=args.rows, separation=4.0)[0]
    cli_log = cli.get(0) if hasattr(cli, "get") else cli
    logs = {"held_out": Xq.contiguous(),
            "cli_log": torch.from_numpy(np.ascontiguousarray(cli_log)).to(dev)}
    for name, model in (("nystrom", nys), ("rff", rff)):
        for tag, L in logs.items():
            print(json.dumps(probe(name, tag, model, L, args.batch)), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
