"""Online assignment service CLI: a thin launcher over `repro_torch.serving`.

    PYTHONPATH=src python -m repro_torch.launch.cluster_serve --requests 10000 \\
        --micro-batch 256 --rate 2000                          # on the card
    PYTHONPATH=src python -m repro_torch.launch.cluster_serve --device cpu   # plain path

Loads a fitted `ClusterModel` (training one first through
`repro_torch.api.KernelKMeans` on blocked synthetic data if no --ckpt is
given, then round-tripping it through the checkpoint layer, so that the
served model always comes off disk), registers it in a `ModelRegistry`, and
serves `predict` through the async `ServingTier`: concurrent intake,
admission control, per-model micro-batching, one embed launch and one
assignment per batch.

Two traffic modes: `--rate 0` (default) replays the request log closed-loop
with backpressure (`submit_wait`); `--rate Q` drives an open-loop Poisson
arrival process at Q req/s through the load generator, optionally hot-
swapping to `--swap-ckpt` after `--swap-after` requests. Either way the CLI
reports p50/p90/p99 end-to-end latency and throughput, then checks every
served label against `core.kkmeans.predict` over the whole request log,
exactly (a response tagged with a post-swap version is checked against the
swapped model). `main(argv)` returns the stats dict and raises
`SystemExit(1)` on any mismatch.

Differences from the JAX package's launcher:

- integer seeds: the fit takes ``seed=args.seed + 1`` where the JAX package
  passes ``key=PRNGKey(seed + 1)``;
- ``--kernels {auto,on,off}`` in place of ``--use-pallas``:
  ``ComputePolicy(kernels=None | True | False)``;
- ``--device``: the card by default, ``cpu`` for the plain path;
- ``--backend stream_shard`` raises NotImplementedError: the sharded stream
  is ROADMAP.md Queue 1 item 13.
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time

import numpy as np

from repro_torch import obs
from repro_torch.api import ComputePolicy, KernelKMeans
from repro_torch.core.kkmeans import predict
from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import load_any_model
from repro_torch.embed import DEFAULT_EMBEDDING, available_embeddings, get_embedding
from repro_torch.serving import ModelRegistry, ServingTier, run_open_loop
from repro_torch.serving.registry import make_process_fn  # noqa: F401  (re-export)

_KERNELS = {"auto": None, "on": True, "off": False}


def _policy_of(args) -> ComputePolicy:
    return ComputePolicy(kernels=_KERNELS[args.kernels])


def _fit_and_save(args, ckpt_dir: str) -> None:
    """Train a clustering model on a blocked synthetic stream and persist it.
    With --sweep-k-grid, run an embed-once sweep over the grid and persist the
    selected best model: the served model is the sweep's winner."""
    from repro_torch.data.synthetic import gaussian_blobs_blocks

    X_store, _ = gaussian_blobs_blocks(
        args.seed, args.n_fit, args.d, args.k,
        block_rows=args.block_rows, separation=4.0,
    )
    # a kernel family the chosen member declares it supports (rbf preferred;
    # registry-driven, so user-registered members pick up the right family)
    defaults = {"rbf": {"gamma": 1.0 / args.d}, "poly": {"degree": 2, "coef0": 1.0},
                "tanh": {}, "linear": {}}
    families = get_embedding(args.method).kernel_families
    kernel = "rbf" if families is None or "rbf" in families else families[0]
    est = KernelKMeans(
        args.k, kernel=kernel, kernel_params=defaults.get(kernel, {}),
        method=args.method, backend=args.backend, l=args.l, m=args.m,
        iters=args.iters, policy=_policy_of(args), device=args.device,
    )
    if args.sweep_k_grid:
        k_grid = [int(v) for v in args.sweep_k_grid.split(",")]
        result = est.sweep(X_store, k_grid, restarts=args.sweep_restarts,
                           seed=args.seed + 1)
        for k, r, _, inertia in result.candidates():
            tag = " <- selected" if (
                k == result.best_k and r == result.best_restart) else ""
            print(f"[cluster-serve] sweep candidate k={k} restart={r}: "
                  f"inertia {inertia:.1f}{tag}")
        print(f"[cluster-serve] sweep: {len(k_grid)}x{result.restarts} "
              f"candidates over ONE embedding pass (backend={est.backend_}); "
              f"serving best k={result.best_k}")
    else:
        est.fit(X_store, seed=args.seed + 1)
        print(f"[cluster-serve] fit: n={args.n_fit} blocks of {args.block_rows}, "
              f"backend={est.backend_}, {est.n_iter_} Lloyd iters, "
              f"inertia {est.inertia_:.1f}")
    est.save(ckpt_dir)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=10000)
    ap.add_argument("--micro-batch", type=int, default=256)
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate (req/s); "
                         "0 = closed-loop replay with backpressure")
    ap.add_argument("--max-inflight", type=int, default=4096,
                    help="admission bound: in-flight requests past this shed "
                         "with a typed rejection instead of queueing")
    ap.add_argument("--ckpt", default="", help="load model from here instead of fitting")
    ap.add_argument("--swap-ckpt", default="",
                    help="open-loop mode: hot-swap the served model to this "
                         "checkpoint (ClusterModel or SweepResult winner) "
                         "after --swap-after requests")
    ap.add_argument("--swap-after", type=int, default=0,
                    help="request index triggering --swap-ckpt "
                         "(default: half of --requests)")
    ap.add_argument("--n-fit", type=int, default=20000)
    ap.add_argument("--block-rows", type=int, default=4096)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--k", type=int, default=5)
    # choices/default/help all derive from the embedding registry: anything
    # register_embedding'd is servable without touching this launcher.
    ap.add_argument(
        "--method", default=DEFAULT_EMBEDDING,
        help="embedding family member used when fitting (registered: "
             f"{', '.join(available_embeddings())})",
    )
    ap.add_argument("--l", type=int, default=128)
    ap.add_argument("--m", type=int, default=128)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument(
        "--sweep-k-grid", default="",
        help="comma-separated k grid (e.g. \"4,5,7\"): fit via an embed-once "
             "sweep (KernelKMeans.sweep) and serve the selected best model "
             "instead of a single fit at --k",
    )
    ap.add_argument("--sweep-restarts", type=int, default=2,
                    help="k-means++ restarts per k-grid entry in --sweep-k-grid mode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", choices=sorted(_KERNELS), default="auto",
                    help="kernel routing: auto = the hand-written kernels on the "
                         "card, plain versions on the CPU; on = the kernels "
                         "(raises on the CPU); off = plain versions everywhere")
    ap.add_argument("--device", default=None,
                    help="where to fit and serve (default: the card; cpu for "
                         "the plain path)")
    ap.add_argument("--stats-json", default="",
                    help="write the end-of-run serve metrics snapshot here")
    ap.add_argument("--stats-every", type=int, default=2000,
                    help="print a rolling stats line every N requests (0 = off)")
    ap.add_argument(
        "--backend", default="stream",
        help="clustering backend used when fitting; \"stream_shard\" (the "
             "sharded stream) is not ported yet: ROADMAP.md Queue 1 item 13",
    )
    args = ap.parse_args(argv)
    get_embedding(args.method)  # unknown name -> fail with the registered list
    if args.backend == "stream_shard":
        raise NotImplementedError(
            "backend 'stream_shard' (the sharded stream) is not ported yet; "
            "see ROADMAP.md Queue 1 item 13")
    if args.backend != "auto":  # "auto" is estimator dispatch, not a registry key
        from repro_torch.api import get_backend

        get_backend(args.backend)  # likewise: reject typos before fitting
    dev = resolve_device(args.device)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt_dir = args.ckpt or tmp
        if not args.ckpt:
            _fit_and_save(args, ckpt_dir)
        model = load_any_model(ckpt_dir, device=dev)
    policy = _policy_of(args)

    # Request log: held-out rows from the fit distribution.
    from repro_torch.data.synthetic import gaussian_blobs_blocks

    req_store, _ = gaussian_blobs_blocks(
        args.seed + 7919, args.requests, model.params.d, args.k,
        block_rows=max(args.requests, 1), separation=4.0,
    )
    X_req = req_store.get(0)

    obs.reset_metrics("serve.")
    registry = ModelRegistry(max_batch=args.micro_batch, policy=policy, device=dev)
    registry.register("default", model)  # warm: the first launch, off the serve path
    swap_model = None
    swap_after = None
    if args.swap_ckpt:
        swap_model = load_any_model(args.swap_ckpt, device=dev)
        swap_after = args.swap_after or args.requests // 2
    tier = ServingTier(
        registry, max_delay_s=args.max_delay_ms / 1e3,
        max_inflight=args.max_inflight,
    )
    e2e = obs.histogram("serve.e2e_latency_ms")

    stats_state = {"n": 0, "t0": 0.0}

    def progress(_resp):
        stats_state["n"] += 1
        n = stats_state["n"]
        if args.stats_every and n % args.stats_every == 0:
            elapsed = time.perf_counter() - stats_state["t0"]
            print(f"[cluster-serve] {n}/{args.requests} served at "
                  f"{n / max(elapsed, 1e-9):.0f} req/s | "
                  f"rolling e2e p50 {e2e.percentile(50):.2f}ms "
                  f"p90 {e2e.percentile(90):.2f}ms "
                  f"p99 {e2e.percentile(99):.2f}ms | "
                  f"inflight {obs.gauge('serve.inflight').value:.0f}")

    tier.on_response = progress
    tier.start()
    stats_state["t0"] = time.perf_counter()
    t0 = stats_state["t0"]
    report = None
    if args.rate > 0:
        report = run_open_loop(
            tier, X_req, qps=args.rate, n_requests=args.requests,
            seed=args.seed, swap_after=swap_after, swap_source=swap_model,
        )
        responses = sorted(report.responses, key=lambda r: r.request_id)
        shed = report.shed
        if report.swap_s is not None:
            print(f"[cluster-serve] hot swap after request {swap_after}: "
                  f"{report.swap_s * 1e3:.1f}ms warm+flip, versions served "
                  f"{report.by_version}")
    else:
        futs = [tier.submit_wait(i, X_req[i]) for i in range(args.requests)]
        responses = [f.result() for f in futs]
        shed = 0
    tier.stop()
    wall = time.perf_counter() - t0

    served_ids = sorted(r.request_id for r in responses)
    n_served = len(responses)
    if report is not None:
        # open-loop sheds: completeness means every ADMITTED request answered
        assert len(set(served_ids)) == n_served, "duplicate responses"
        assert n_served == report.admitted, "an admitted request was lost"
    else:
        assert served_ids == list(range(args.requests)), \
            "duplicate or lost responses"

    # Replay the request log through the reference path, per model version,
    # so a mid-run swap is checked against the model that actually answered.
    def replay(m):
        return predict(X_req, m.params, m.centroids, policy=policy, device=dev).cpu().numpy()

    refs = {1: replay(model)}
    if swap_model is not None:
        refs[2] = replay(swap_model)
    mismatches = sum(
        1 for r in responses
        if not r.ok or r.label != int(refs[r.version][r.request_id % args.requests])
    )
    if n_served:  # every open-loop request may have been shed
        lat_ms = np.asarray([r.latency_s for r in responses]) * 1e3
        p50, p90, p99 = (np.percentile(lat_ms, p) for p in (50, 90, 99))
    else:
        p50 = p90 = p99 = 0.0
    print(f"[cluster-serve] {n_served}/{args.requests} served "
          f"(shed {shed}), micro-batch {args.micro_batch}, "
          f"{n_served / wall:.0f} req/s")
    print(f"[cluster-serve] e2e latency p50 {p50:.2f}ms p90 {p90:.2f}ms "
          f"p99 {p99:.2f}ms")
    print(f"[cluster-serve] replay check vs core.kkmeans.predict: "
          f"{n_served - mismatches}/{n_served} exact"
          + (" [OK]" if mismatches == 0 else " [MISMATCH]"))
    stats = {
        "requests": args.requests, "micro_batch": args.micro_batch,
        "served": n_served, "shed": shed,
        "wall_s": float(wall), "req_per_s": n_served / wall,
        "p50_ms": float(p50), "p90_ms": float(p90), "p99_ms": float(p99),
        "mismatches": mismatches,
        # full rolling-metric snapshot: latency/batch-size histograms,
        # admission + per-model counters, queue-depth gauge (+ hwm)
        "metrics": obs.snapshot("serve."),
    }
    if report is not None:
        stats.update(admitted=report.admitted, errors=report.errors,
                     by_version={str(v): c for v, c in report.by_version.items()},
                     swap_s=report.swap_s, swap_at=report.swap_at)
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=2, sort_keys=True)
        print(f"[cluster-serve] stats JSON -> {args.stats_json}")
    if mismatches:
        raise SystemExit(1)
    return stats


if __name__ == "__main__":
    main()
