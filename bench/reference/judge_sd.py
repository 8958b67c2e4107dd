"""The comparison that decides ``correct`` for an APNC-SD fit: the program's
outputs read against the float64 SD reference (`bench.reference.apnc_sd`),
in the three stages of the Nystrom judge (`bench.reference.judge`), each
under SD's own rules.

* Phase 1: the landmarks must be the rows that the seed selects
  (``landmarks_off``, exact) and gamma the self-tuned value
  (``gamma_rel``), as for Nystrom. R must be S E H / sqrt(t) for the S
  that the fit generator's draws make (replayed here) and some E that
  whitens the centered gram G on the directions float32 resolves
  (``sd_whiten_gap``, `apnc_sd.whiten_gap`): a form that holds for every
  sign and rotation of the eigenvectors, since no precision fixes them.
  The centered gram's null direction (the constant vector) sits at
  float32 noise, where rounding may keep or drop it, so it is left out of
  the comparison.
* Lloyd's first steps under l1, from the program's landmarks, R and gamma:
  the reference embeds the seeding pool, seeds k-means++ with the same
  draws (weights the squared l1 distances) and follows three steps with
  the mean update (``cost_rel``, ``shift_rel``; the later updates'
  ``shift_rel_2``, ``shift_rel_3`` are printed).
* The answer: every label the l1-nearest centroid of its row
  (``label_gap``), the inertia the sum of the nearest l1 distances
  (``inertia_rel``), and the centroids the means of the rows that the last
  pass labelled (``update_gap``, where a row is certain past a lead of
  sqrt(2 m) times the last update's norm; the share of rows that are not
  is printed, ``update_unsure``).
"""
from __future__ import annotations

import numpy as np
import torch

from bench.reference import apnc, apnc_sd
from bench.reference.judge import FOLLOWED_STEPS, FitOutput

F64 = torch.float64


def _rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want) if want else float("inf")


def judge_fit(X, X_host: np.ndarray, cfg: dict, out: FitOutput, device) -> dict:
    """The numbers of one SD fit; ``X`` the data as the fit got it,
    ``X_host`` a host view of the same rows."""
    n, d = X_host.shape
    br, l, m, k, t = (cfg[key] for key in ("block_rows", "l", "m", "k", "t"))
    s_sample, s_fit, s_seed = apnc.phase1_seeds(out.random_state)
    blocks = (X_host[lo:lo + br] for lo in range(0, n, br))
    sample = torch.from_numpy(
        apnc.reservoir_sample(blocks, n, d, cfg["landmark_sample"], s_sample)).to(device)
    gamma = apnc.self_tuned_gamma(sample, out.random_state)
    L = apnc.landmarks(sample, s_fit, l)
    Lp = out.landmarks.to(device)
    Rp = out.R.to(device, F64)
    G, _ = apnc_sd.centered_gram(L, gamma)
    S = apnc_sd.directions(sample.shape[0], s_fit, l, m, t)
    numbers = dict(
        landmarks_off=int((Lp.shape != L.shape) or int((Lp != L).any(1).sum())),
        gamma_rel=_rel(out.gamma, gamma),
        sd_whiten_gap=apnc_sd.whiten_gap(Rp, G, S, t, apnc_sd.unresolved(G)),
    )

    pool = apnc.embed(sample[:cfg["seed_sample"]], Lp, Rp, out.gamma)
    C0 = apnc_sd.kmeanspp(pool, k, apnc.restart_generator(s_seed, 0))
    Y = apnc.embed(X, Lp, Rp, out.gamma, device)
    steps = min(FOLLOWED_STEPS, out.n_iter)
    costs, shifts, _ = apnc_sd.lloyd_steps(Y, C0, steps)
    numbers["cost_rel"] = max(_rel(out.trajectory[i], costs[i]) for i in range(steps))
    numbers["shift_rel"] = _rel(out.shifts[0], shifts[0])
    for i in range(1, steps):
        numbers[f"shift_rel_{i + 1}"] = _rel(out.shifts[i], shifts[i])

    gap, cost = apnc_sd.label_gaps(Y, out.centroids, torch.from_numpy(out.labels))
    numbers["label_gap"] = gap
    numbers["inertia_rel"] = _rel(out.inertia, cost)
    numbers["update_gap"], numbers["update_unsure"] = apnc_sd.update_gap(
        Y, out.centroids, out.shifts[-1])
    return numbers
