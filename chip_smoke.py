"""Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py                    # the card: build, parity, main path, timing
    python3 chip_smoke.py --cpu-rehearsal    # the same path, tiny, plain versions, CPU

It builds the hand-written kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version, drives the main path
(``KernelKMeans(164, kernel="rbf", method="nystrom", l=500, m=256).fit(X)``
then ``predict``) at the paper's ImageNet shape (n = 1,262,102, d = 900,
k = 164) on blobs made from ``--seed``, and times each kernel beside its
bound, its plain version and a PyTorch library call chain. Every phase prints
one JSON line. The last lines are the kernel table, the card's name and power
limit, and ``{"ok": true, ...}``; any failure exits non-zero before them.
Without a card the script exits non-zero, unless ``--cpu-rehearsal`` is given,
which never prints the ok line. It imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data sheet).
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# The paper's ImageNet configuration (src/repro/configs/paper_datasets.py).
IMAGENET = dict(n=1_262_102, d=900, k=164, separation=1.5, l=500, m=256, iters=20)
REHEARSAL = dict(n=4_000, d=32, k=8, separation=3.0, l=64, m=16, iters=20)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def make_blobs(n, d, k, separation, seed, device, anisotropy=0.5, chunk=1 << 16):
    """Gaussian blobs made on ``device`` from a torch.Generator; labels int64."""
    g = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((k, d), generator=g, device=device) * separation
    scales = 1.0 + anisotropy * torch.rand((k, d), generator=g, device=device)
    labels = torch.randint(0, k, (n,), generator=g, device=device)
    X = torch.empty((n, d), device=device)
    for lo in range(0, n, chunk):
        lab = labels[lo:lo + chunk]
        X[lo:lo + chunk] = centers[lab] + torch.randn(
            (lab.shape[0], d), generator=g, device=device) * scales[lab]
    return X, labels


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def check_close(what, got, want, rtol, atol) -> float:
    """max |got - want|, raising unless |got - want| <= atol + rtol * |want|."""
    err = (got - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    if bad or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: {bad} elements beyond rtol={rtol} atol={atol}, "
                             f"max |d| = {float(err.max())}")
    return float(err.max())


# ----------------------------------------------------------------- phases


def phase_build() -> dict:
    from repro_torch.kernels import apnc_assign, apnc_embed, build

    t0 = time.perf_counter()
    build.build_all()
    entries = []
    for name in build.SOURCES:
        fn = None
        for line in build.ptxas_report(name).splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                short = re.search(r"(embed_kernel|assign_kernel|reduce_kernel)\w*?E", m.group(1))
                fn = dict(source=name, kernel=short.group(0) if short else m.group(1))
                entries.append(fn)
            elif fn is not None:
                for key, pat in (("registers", r"Used (\d+) registers"),
                                 ("spill_stores", r"(\d+) bytes spill stores"),
                                 ("spill_loads", r"(\d+) bytes spill loads"),
                                 ("static_smem", r"(\d+) bytes smem")):
                    m2 = re.search(pat, line)
                    if m2:
                        fn[key] = int(m2.group(1))
    spills = [e for e in entries if e.get("spill_stores") or e.get("spill_loads")]
    cfg = IMAGENET
    return dict(phase="build", seconds=time.perf_counter() - t0,
                nvcc_seconds=dict(build.BUILD_SECONDS), ptxas=entries,
                spilling_kernels=len(spills),
                dynamic_smem_bytes_main_shape=dict(
                    apnc_embed=apnc_embed.smem_bytes(cfg["m"]),
                    apnc_assign=apnc_assign.smem_bytes(cfg["m"], cfg["k"])))


def phase_parity(X, device) -> dict:
    """Each kernel against its plain version on the same inputs."""
    from repro_torch.core.kernels_fn import Kernel, self_tuned_rbf
    from repro_torch.embed.apnc import fit_nystrom
    from repro_torch.kernels import ops, ref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = dict(phase="parity", embed=[], assign=[])
    g = torch.Generator().manual_seed(17)
    Xr = torch.randn((1003, 77), generator=g).to(device)
    for kern in (Kernel("rbf", gamma=0.05), Kernel("poly", degree=3, coef0=1.0),
                 Kernel("tanh", scale=0.01, coef0=0.1), Kernel("linear")):
        for q, m in ((1, 33), (2, 21)):
            params = fit_nystrom(1, Xr, kern, l=100, m=m, q=q)
            got, want = ops.apnc_embed(Xr, params), ref.apnc_embed_ref(
                Xr, params.landmarks, params.R, kern)
            tol = 2e-3 if kern.name == "poly" else 2e-5  # poly amplifies roundoff
            err = check_close(f"embed {kern.name} q={q}", got, want, tol,
                              tol * float(want.abs().max()))
            out["embed"].append(dict(kernel=kern.name, q=q, n=1003, d=77, l=100, m=m * q,
                                     max_abs_err=err, rtol=tol))
    # The main path's shape on a row slice: rbf, l = 500, m = 256, d = 900.
    rows = X[: min(65_536, X.shape[0])]
    cfg = REHEARSAL if device.type == "cpu" else IMAGENET
    kern = self_tuned_rbf(rows[:4096])
    params = fit_nystrom(2, rows[:4096], kern, l=cfg["l"], m=cfg["m"])
    got, want = ops.apnc_embed(rows, params), ref.apnc_embed_ref(
        rows, params.landmarks, params.R, kern)
    err = check_close("embed main shape", got, want, 2e-5, 2e-5 * float(want.abs().max()))
    out["embed"].append(dict(kernel="rbf", q=1, n=rows.shape[0], d=rows.shape[1],
                             l=cfg["l"], m=cfg["m"], max_abs_err=err, rtol=2e-5))
    for n, k, m in ((5003, 67, 70), (20_011, 164, 256)):
        Y = torch.randn((n, m), generator=g).to(device)
        C = (torch.randn((k, m), generator=g) * 2).to(device)
        for disc in ("l2", "l1"):
            Z, gg, lab = ops.apnc_assign(Y, C, disc)
            Z2, g2, lab2 = ops.apnc_assign(Y, C, disc)
            Zr, gr, lr = ref.apnc_assign_ref(Y, C, disc)
            if not (torch.equal(lab, lr) and torch.equal(gg, gr)):
                raise AssertionError(f"assign {disc} n={n} k={k}: labels or g differ "
                                     f"({int((lab != lr).sum())} labels)")
            if not (torch.equal(Z, Z2) and torch.equal(gg, g2) and torch.equal(lab, lab2)):
                raise AssertionError(f"assign {disc} n={n} k={k}: two runs differ")
            err = check_close(f"assign Z {disc}", Z, Zr, 1e-4, 1e-4)
            out["assign"].append(dict(disc=disc, n=n, k=k, m=m, labels_equal=True,
                                      g_equal=True, deterministic=True, z_max_abs_err=err))
    sync(device)
    return out


def phase_main(X, truth, Xq, cfg, device, seed) -> tuple[dict, object]:
    """The port's main path through the public estimator, with the launch
    counters set to 0 just before and read just after."""
    from repro_torch.api import KernelKMeans
    from repro_torch.core.metrics import nmi
    from repro_torch.kernels import apnc_assign, apnc_embed

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    apnc_embed.launches = 0
    apnc_assign.launches = 0
    t0 = time.perf_counter()
    est = KernelKMeans(cfg["k"], kernel="rbf", method="nystrom", l=cfg["l"], m=cfg["m"],
                       iters=cfg["iters"], backend="local", random_state=seed,
                       device=device)
    est.fit(X)
    t_fit = time.perf_counter() - t0
    t1 = time.perf_counter()
    pred = est.predict(Xq)
    sync(device)
    t_predict = time.perf_counter() - t1
    launches = dict(apnc_embed=apnc_embed.launches, apnc_assign=apnc_assign.launches)
    if device.type == "cuda" and not all(launches.values()):
        raise AssertionError(f"the main path skipped a kernel: {launches}")
    labels = est.labels_
    if labels.shape != (X.shape[0],) or labels.min() < 0 or labels.max() >= cfg["k"]:
        raise AssertionError("fit labels out of range")
    if pred.shape != (Xq.shape[0],) or pred.min() < 0 or pred.max() >= cfg["k"]:
        raise AssertionError("predict labels out of range")
    if not np.isfinite(est.inertia_) or not bool(torch.isfinite(est.model_.centroids).all()):
        raise AssertionError("non-finite inertia or centroids")
    score = nmi(labels, truth)
    if score < 0.5:
        raise AssertionError(f"NMI against the truth is {score}")
    return dict(
        phase="main", n=X.shape[0], d=X.shape[1], k=cfg["k"], l=cfg["l"], m=cfg["m"],
        n_cut=IMAGENET["n"] - X.shape[0] if device.type == "cuda" else None,
        fit_s=t_fit, predict_s=t_predict, predict_rows=Xq.shape[0],
        phases_s=est.phases_, lloyd_iters=est.n_iter_, inertia=est.inertia_,
        gamma=est.kernel_.gamma, nmi=score,
        peak_device_bytes=(torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else None),
        launches=launches,
    ), est


def phase_agreement(X, truth, est, cfg, device, rows=200_000) -> dict:
    """Kernel path against the plain path from the same params and init, on a
    row subset. Three readings:

    * step: along the kernel path's own Lloyd trajectory (k-means++ init),
      each iteration's labels from the assign kernel against its plain version
      at the same Y and centroids. Gated at >= 0.9999 every iteration.
    * truth_init: the whole Lloyd run, kernel path on the card against the
      plain path (the same code on the CPU), both from the per-class means of
      Y. Gated: labels >= 0.9999, inertia within rtol 1e-4.
    * kmeanspp_init: the same comparison from a k-means++ init, the main
      path's own. Gated: inertia within rtol 1e-4, labels >= 0.995. The floor
      is below 0.9999 because a run that has not converged by the iteration
      cap moves its boundaries inside blobs that hold two centroids, and one
      near-tie row flipped early grows into a different boundary later; an
      H100 read 0.997255 (inertia 9.3e-7 apart).
    """
    from repro_torch import embed
    from repro_torch.core.lloyd import centroid_update, kmeanspp_init, lloyd
    from repro_torch.kernels import ops, ref

    k, iters = cfg["k"], cfg["iters"]
    cpu = torch.device("cpu")
    Xs = X[:rows]
    params = est.model_.params
    Yk = embed.transform(params, Xs)
    Yp = embed.transform(params.to(cpu), Xs.to(cpu))
    init_pp = kmeanspp_init(torch.Generator().manual_seed(1), Yk[:1024], k, "l2")
    lab_s = torch.as_tensor(truth[:rows], device=device).long()
    init_truth = torch.zeros((k, Yk.shape[1]), device=device).index_add_(0, lab_s, Yk)
    init_truth /= torch.bincount(lab_s, minlength=k).clamp(min=1).float()[:, None]

    step = []
    C = init_pp
    for _ in range(iters):
        Z, g, lk = ops.apnc_assign(Yk, C, "l2")
        _, _, lr = ref.apnc_assign_ref(Yk, C, "l2")
        step.append(float((lk == lr).float().mean()))
        C = centroid_update(Z, g, C)

    def whole(init):
        rk = lloyd(Yk, k, discrepancy="l2", iters=iters, init=init)
        rp = lloyd(Yp, k, discrepancy="l2", iters=iters, init=init.to(cpu))
        return dict(label_agreement=float((rk.labels.cpu() == rp.labels).float().mean()),
                    inertia_kernel=float(rk.inertia), inertia_plain=float(rp.inertia),
                    inertia_rel_diff=abs(float(rk.inertia) - float(rp.inertia))
                    / abs(float(rp.inertia)),
                    iters_kernel=rk.iters, iters_plain=rp.iters)

    truth_run, pp_run = whole(init_truth), whole(init_pp)
    if device.type == "cuda":
        if min(step) < 0.9999:
            raise AssertionError(f"kernel vs plain at the same centroids: {step}")
        if truth_run["label_agreement"] < 0.9999 or truth_run["inertia_rel_diff"] > 1e-4:
            raise AssertionError(f"kernel vs plain from the same init: {truth_run}")
        if pp_run["label_agreement"] < 0.995 or pp_run["inertia_rel_diff"] > 1e-4:
            raise AssertionError(f"kernel vs plain from the same k-means++ init: {pp_run}")
    return dict(phase="agreement", rows=Xs.shape[0], step_min_agreement=min(step),
                step_agreement=step, truth_init=truth_run, kmeanspp_init=pp_run)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def profile_lloyd(Y, k, iters=20) -> dict:
    """Device busy share of a Lloyd run over the resident Y, from a
    torch.profiler trace: kernel time on the card over the run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.lloyd import kmeanspp_init, lloyd

    init = kmeanspp_init(torch.Generator().manual_seed(3), Y[:1024], k, "l2")
    lloyd(Y, k, discrepancy="l2", iters=2, init=init)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = lloyd(Y, k, discrepancy="l2", iters=iters, init=init)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:  # kernels only: ops would count twice
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0:
            per_kernel[ev.key[:60]] = us / 1e3
    busy_ms = sum(per_kernel.values())
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:6]
    return dict(iters=res.iters, wall_ms=wall * 1e3,
                device_busy_ms=busy_ms if busy_ms else "not measured",
                device_busy_share=busy_ms / (wall * 1e3) if busy_ms else "not measured",
                top_device_ms=dict(top))


def check_assign_main_shape(Y, C, mismatch_share=1e-5, tie_rtol=1e-4) -> dict:
    """The assign kernel at the main path's shape (deep per-CTA row loops),
    gated; raises on any failure.

    * g equals the bincount of the kernel's own labels exactly;
    * Z equals the f64 sum of Y under the kernel's own labels within rtol
      1e-4 and atol 1e-4 * max|Z|, so near-tie rows do not mask its error;
    * labels that differ from the plain version's are at most
      ``mismatch_share`` of the rows (6 of 1,262,102 read on an H100), and
      each is a near tie: its two centroids' f64 squared distances differ by
      at most ``tie_rtol`` * (|y|^2 + max |c|^2), the scale of the f32
      roundoff in yy - 2 y.c + cc.
    """
    from repro_torch.kernels import apnc_assign, ref

    n, k = Y.shape[0], C.shape[0]
    Z, g, lab = apnc_assign.apnc_assign(Y, C, "l2")
    _, _, lr = ref.apnc_assign_ref(Y, C, "l2")
    lab_l = lab.long()
    if not torch.equal(g, torch.bincount(lab_l, minlength=k).float()):
        raise AssertionError("assign at the main shape: g is not the count of its labels")
    Z64 = torch.zeros((k, Y.shape[1]), dtype=torch.float64, device=Y.device)
    Z64.index_add_(0, lab_l, Y.double())
    z_err = check_close("assign Z at the main shape", Z.double(), Z64, 1e-4,
                        1e-4 * float(Z64.abs().max()))
    rows = torch.nonzero(lab != lr).flatten()
    if rows.numel() > mismatch_share * n:
        raise AssertionError(f"assign at the main shape: {rows.numel()} of {n} labels "
                             f"differ from the plain version")
    gap_rel = 0.0
    if rows.numel():
        y = Y[rows].double()
        C64 = C.double()
        d_kernel = (y - C64[lab_l[rows]]).square().sum(1)
        d_plain = (y - C64[lr[rows].long()]).square().sum(1)
        scale = y.square().sum(1) + C64.square().sum(1).max()
        gap_rel = float(((d_kernel - d_plain).abs() / scale).max())
        if gap_rel > tie_rtol:
            raise AssertionError(f"assign at the main shape: a label differs from the "
                                 f"plain version by more than a near tie ({gap_rel})")
    return dict(n=n, k=k, m=Y.shape[1], g_equal_bincount=True, z_max_abs_err=z_err,
                z_abs_max=float(Z64.abs().max()), label_mismatches_vs_plain=int(rows.numel()),
                mismatch_max_rel_gap=gap_rel)


def phase_timing(X, est, launches) -> tuple[dict, list]:
    """Each kernel at the main path's shapes: kernel, plain version, library
    call chain, and the bound computed from this run's shapes."""
    from repro_torch.kernels import apnc_assign, apnc_embed, ref

    params = est.model_.params
    L, R, kern = params.landmarks[0].contiguous(), params.R[0].contiguous(), params.kernel
    n, d = X.shape
    l, m = L.shape[0], R.shape[0]
    C = est.model_.centroids.contiguous()
    k = C.shape[0]

    Y = apnc_embed.apnc_embed_block(X, L, R, kern)
    Y_plain = ref.apnc_embed_ref(X, L[None], R[None], kern)
    embed_err = float((Y - Y_plain).abs().max())
    del Y_plain

    def embed_library():
        K = torch.exp(-kern.gamma * torch.cdist(X, L).square())
        return K @ R.T

    t_embed = cuda_ms(lambda: apnc_embed.apnc_embed_block(X, L, R, kern), 5)
    t_embed_plain = cuda_ms(lambda: ref.apnc_embed_ref(X, L[None], R[None], kern), 5)
    t_embed_lib = cuda_ms(embed_library, 5)
    b_embed, by_embed = bound(2.0 * n * l * (d + m), 4.0 * (n * d + l * d + m * l + n * m))

    assign_check = check_assign_main_shape(Y, C)
    assign_err = assign_check["z_max_abs_err"]

    def assign_library():
        lab = torch.cdist(Y, C).argmin(dim=1)
        Z = torch.zeros((k, m), device=Y.device).index_add_(0, lab, Y)
        return Z, torch.bincount(lab, minlength=k), lab

    t_assign = cuda_ms(lambda: apnc_assign.apnc_assign(Y, C, "l2"), 20)
    t_assign_plain = cuda_ms(lambda: ref.apnc_assign_ref(Y, C, "l2"), 20)
    t_assign_lib = cuda_ms(assign_library, 20)
    b_assign, by_assign = bound(2.0 * n * k * m, 4.0 * (n * m + 2 * k * m + k + n))

    rows = [
        dict(name="apnc_embed", route="cuda",
             source="src/repro_torch/kernels/csrc/apnc_embed.cu",
             replaces="src/repro/kernels/apnc_embed.py:88",
             launches=launches["apnc_embed"], max_abs_err=embed_err, ms=t_embed,
             plain_ms=t_embed_plain, bound_ms=b_embed, bound_by=by_embed,
             library_ms=t_embed_lib),
        dict(name="apnc_assign", route="cuda",
             source="src/repro_torch/kernels/csrc/apnc_assign.cu",
             replaces="src/repro/kernels/apnc_assign.py:91",
             launches=launches["apnc_assign"], max_abs_err=assign_err, ms=t_assign,
             plain_ms=t_assign_plain, bound_ms=b_assign, bound_by=by_assign,
             library_ms=t_assign_lib),
    ]
    # The TPU kernels still to port, bounded at the same shapes (RFF splits m
    # as 2 x m/2; flash attention has no clustering shape, so an example).
    mh, bh, s_len, dh = m // 2, 32, 4096, 64
    pending = {
        "fused_apnc_step": bound(2.0 * n * l * (d + m) + 2.0 * n * k * m,
                                 4.0 * (n * d + l * d + m * l + 2 * k * m + k + n + 1)),
        "fused_dequant_step": bound(2.0 * n * k * m,
                                    1.0 * n * m + 4.0 * (m + 2 * k * m + k + n + 1)),
        "fused_rff_step": bound(2.0 * n * d * mh + 2.0 * n * k * m,
                                4.0 * (n * d + d * mh + 2 * k * m + k + n + 1)),
        "rff_embed_block": bound(2.0 * n * d * mh, 4.0 * (n * d + d * mh + n * m)),
        "flash_attention_bhsd(BH=32,S=4096,Dh=64,causal)": bound(
            2.0 * bh * s_len * s_len * dh, 4.0 * 4 * bh * s_len * dh),
    }
    info = dict(phase="timing", shapes=dict(n=n, d=d, l=l, m=m, k=k),
                pending_kernel_bounds_ms={name: b for name, (b, _) in pending.items()},
                lloyd_profile=profile_lloyd(Y, k),
                assign_main_shape=assign_check,
                embed_max_rel_err=embed_err / float(Y.abs().max()),
                **{f"{r['name']}_roofline_share": r["bound_ms"] / r["ms"] for r in rows})
    return info, rows


# ------------------------------------------------------------------ driver


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu-rehearsal", action="store_true",
                    help="run the path tiny on the CPU with the plain versions; "
                         "never prints the ok line")
    ap.add_argument("--n", type=int, default=None,
                    help="cut the main path's rows (default: the full ImageNet n)")
    args = ap.parse_args(argv)

    rehearsal = args.cpu_rehearsal
    if not rehearsal and not torch.cuda.is_available():
        print("chip_smoke: no CUDA card is visible (pass --cpu-rehearsal to "
              "rehearse on the CPU)", file=sys.stderr)
        return 2
    device = torch.device("cpu" if rehearsal else "cuda")
    cfg = dict(REHEARSAL if rehearsal else IMAGENET)
    if args.n:
        cfg["n"] = args.n

    if rehearsal:
        emit(dict(phase="device", device="cpu", rehearsal=True))
    else:
        smi = nvidia_smi()
        emit(dict(phase="device", kind=torch.cuda.get_device_name(0),
                  count=torch.cuda.device_count(), nvidia_smi=smi,
                  torch=torch.__version__, cuda=torch.version.cuda))
        emit(phase_build())

    t0 = time.perf_counter()
    X_all, y_all = make_blobs(cfg["n"] + 10_000 if not rehearsal else cfg["n"] + 500,
                              cfg["d"], cfg["k"], cfg["separation"], args.seed, device)
    n = cfg["n"]
    X, truth, Xq = X_all[:n], y_all[:n].cpu().numpy(), X_all[n:]
    sync(device)
    emit(dict(phase="data", n=n, held_out=Xq.shape[0], d=cfg["d"], k=cfg["k"],
              separation=cfg["separation"], seed=args.seed,
              seconds=time.perf_counter() - t0))

    emit(phase_parity(X, device))
    main_info, est = phase_main(X, truth, Xq, cfg, device, args.seed)
    emit(main_info)
    emit(phase_agreement(X, truth, est, cfg, device,
                         rows=200_000 if not rehearsal else 2_000))

    if rehearsal:
        emit(dict(phase="timing", skipped="cpu rehearsal: no device times"))
    else:
        info, rows = phase_timing(X, est, main_info["launches"])
        emit(info)

    leaked = sorted(m for m in sys.modules
                    if m == "jax" or m.startswith("jax.") or m == "repro"
                    or m.startswith("repro."))
    if leaked:
        raise AssertionError(f"the port imported the JAX side: {leaked[:5]}")
    if rehearsal:
        emit(dict(phase="done", rehearsal=True))
        return 0
    emit(dict(kernels=rows))
    print(nvidia_smi(), flush=True)
    emit(dict(ok=True, device=dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                                   count=torch.cuda.device_count())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
