"""The comparison that decides ``correct``: the program's outputs read against
the float64 reference (`bench.reference.apnc`), number by number.

A fit is judged in three stages.

* Phase 1, by itself: the landmarks must be the rows that the seed selects
  (``landmarks_off``, exact), gamma the self-tuned value that the reference
  works out from those rows (``gamma_rel``), and R a top-m Nystrom factor of
  the gram that the reference builds from the landmarks and its own gamma:
  R must whiten that gram (``whiten_gap``) and capture its top-m
  eigenvalues (``spectrum_rel``). R itself is not compared: eigenvalues of
  the gram lie closer together at the cut than float32 rounding resolves,
  so the top-m basis differs from the reference's by a rotation that no
  precision fixes.
* Lloyd's first steps, from the program's landmarks, R and gamma, which the
  first stage has held to the reference: the reference embeds the seeding
  pool, seeds k-means++ with the same draws and runs the first three steps
  itself. The program's reported cost of each step (``cost_rel``, the worst
  of the three) and the norm of the first centroid update (``shift_rel``)
  are compared. The later updates' norms are printed (``shift_rel_2``,
  ``shift_rel_3``): they are a hundred times smaller than the first, so the
  few near-tied rows that flip at rounding move them by a share that swings
  from seed to seed. Later steps are not followed: the flips compound and
  the trajectories part.
* The answer: every returned label must be the nearest centroid of its row
  under the returned model (``label_gap``, the widest amount by which a
  label's distance exceeds the nearest one), the returned inertia the sum
  of the nearest distances (``inertia_rel``), and the returned centroids
  the means of the rows that the last pass labelled (``update_gap``). That
  pass's labels are known wherever they cannot have changed since: a fit
  need not have converged, but its last update moved the centroids by the
  norm it reports, and a row whose nearest centroid leads the others by
  more than twice that kept its label. This holds every update to the
  last one to its rule, which the three followed steps do not.

A batch prediction is judged by its labels (``label_gap``) under the model
the benchmark made and handed to the program.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bench.reference import apnc

F64 = torch.float64
#: Lloyd steps the reference follows from the seeding.
FOLLOWED_STEPS = 3


@dataclasses.dataclass
class FitOutput:
    """What one timed fit returned, copied off the estimator."""

    random_state: int
    landmarks: torch.Tensor  # (l, d)
    R: torch.Tensor  # (m, l)
    gamma: float
    centroids: torch.Tensor  # (k, m)
    labels: np.ndarray  # (n,) int32
    inertia: float
    trajectory: list  # each step's cost, then the final inertia
    shifts: list  # each update's Frobenius norm
    n_iter: int


def _rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want) if want else float("inf")


def judge_fit(X, X_host: np.ndarray, cfg: dict, out: FitOutput, device) -> dict:
    """The numbers of one fit; ``X`` the data as the fit got it (on the device
    or pinned on the host), ``X_host`` a host view of the same rows."""
    n, d = X_host.shape
    br, l, m, k = cfg["block_rows"], cfg["l"], cfg["m"], cfg["k"]
    s_sample, s_fit, s_seed = apnc.phase1_seeds(out.random_state)
    blocks = (X_host[lo:lo + br] for lo in range(0, n, br))
    sample = torch.from_numpy(
        apnc.reservoir_sample(blocks, n, d, cfg["landmark_sample"], s_sample)).to(device)
    gamma = apnc.self_tuned_gamma(sample, out.random_state)
    L = apnc.landmarks(sample, s_fit, l)
    Lp = out.landmarks.to(device)
    K = apnc.rbf(L, L, gamma)
    top = torch.linalg.eigvalsh(K)[-m:]
    Rp = out.R.to(device, F64)
    RK = Rp @ K
    whiten = RK @ Rp.T - torch.eye(m, dtype=F64, device=device)
    numbers = dict(
        landmarks_off=int((Lp.shape != L.shape) or int((Lp != L).any(1).sum())),
        gamma_rel=_rel(out.gamma, gamma),
        whiten_gap=float(whiten.abs().max()),
        spectrum_rel=_rel(float((RK * RK).sum()), float(top.sum())),
    )

    pool = apnc.embed(sample[:cfg["seed_sample"]], Lp, Rp, out.gamma)
    C0 = apnc.kmeanspp(pool, k, apnc.restart_generator(s_seed, 0))
    Y = apnc.embed(X, Lp, Rp, out.gamma, device)
    steps = min(FOLLOWED_STEPS, out.n_iter)
    costs, shifts, _ = apnc.lloyd_steps(Y, C0, steps)
    numbers["cost_rel"] = max(_rel(out.trajectory[t], costs[t]) for t in range(steps))
    numbers["shift_rel"] = _rel(out.shifts[0], shifts[0])
    for t in range(1, steps):
        numbers[f"shift_rel_{t + 1}"] = _rel(out.shifts[t], shifts[t])

    labels = torch.from_numpy(out.labels)
    gap, cost = apnc.label_gaps(Y, out.centroids, labels)
    numbers["label_gap"] = gap
    numbers["inertia_rel"] = _rel(out.inertia, cost)
    numbers["update_gap"] = apnc.update_gap(Y, out.centroids, out.shifts[-1])
    return numbers


def judge_predict(model, batches: torch.Tensor, batch_rows: int, answers) -> dict:
    """The widest label gap over ``answers``, (batch index, labels) pairs of
    predict calls on ``batches`` (one (pool * batch_rows, d) tensor) under the
    model (landmarks, R, gamma, centroids) that the benchmark made."""
    L, R, gamma, C = model
    widest = 0.0
    for b in sorted({b for b, _ in answers}):
        Y = apnc.embed(batches[b * batch_rows:(b + 1) * batch_rows], L, R, gamma)
        for bb, labels in answers:
            if bb == b:
                widest = max(widest, apnc.label_gaps(Y, C, torch.from_numpy(labels))[0])
    return dict(label_gap=widest)
