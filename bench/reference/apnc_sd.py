"""The plain reference of APNC-SD kernel k-means (the paper's Algorithm 4:
p-stable directions in the whitened space of the centered landmark gram,
with the l1 discrepancy of Eq. 13), in float64 PyTorch.

It imports nothing of the program. The conventions it shares with the
Nystrom member (the phase-1 seeds, the reservoir, the self-tuned gamma, the
landmarks, the embedding Y = kappa(X, L) R^T) are those of
``bench.reference.apnc``, used as they are. What SD adds is written out
here as the specification the benchmark holds the program to: which draws
make S, the centered whitening, and Lloyd under l1 with the mean update
(the program's (Z, g) sums), whose k-means++ weights are the squared l1
distances. Every product is float64, so TF32 never applies.
"""
from __future__ import annotations

import torch

from bench.reference import apnc

F64 = torch.float64
BLOCK = apnc.BLOCK
#: Eigenvalues of the centered gram at or below this share of its largest
#: are not resolved by float32: the centered gram's null direction (the
#: constant vector) sits at float32 noise there, and rounding decides
#: whether the program keeps or drops it.
UNRESOLVED = 1e-4


# --------------------------------------------------------------- conventions


def directions(sample_rows: int, fit_seed: int, l: int, m: int, t: int) -> torch.Tensor:
    """S (m, l), float64 on the host: the fit generator's draws after the
    landmarks' ``randperm(sample_rows)``, one ``randperm(l)[:t]`` a row, each
    marking t ones of its row."""
    gen = torch.Generator().manual_seed(int(fit_seed))
    torch.randperm(sample_rows, generator=gen)
    S = torch.zeros((m, l), dtype=F64)
    for r in range(m):
        S[r, torch.randperm(l, generator=gen)[:t]] = 1.0
    return S


# -------------------------------------------------------------------- maths


def centered_gram(L: torch.Tensor, gamma: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(G, H): G = H K H of the landmarks' RBF gram K, H = I - 11^T / l."""
    l = L.shape[0]
    H = torch.eye(l, dtype=F64, device=L.device) - 1.0 / l
    return H @ apnc.rbf(L, L, gamma) @ H, H


def unresolved(G: torch.Tensor) -> int:
    """How many of G's eigenvalues float32 does not resolve (``UNRESOLVED``):
    the lowest directions of the ascending spectrum, whose whitening rows
    the program may keep or zero."""
    lam = torch.linalg.eigvalsh(G)
    return int((lam <= UNRESOLVED * float(lam[-1])).sum())


def sd_factor(G: torch.Tensor, H: torch.Tensor, S: torch.Tensor, t: int) -> torch.Tensor:
    """R = S E H / sqrt(t), E = Lambda^{-1/2} V^T whitening G on its resolved
    directions (the unresolved rows zero)."""
    lam, V = torch.linalg.eigh(G)
    keep = lam > UNRESOLVED * float(lam[-1])
    E = torch.where(keep, lam.clamp(min=1e-300).rsqrt(), torch.zeros_like(lam))[:, None] * V.T
    return (S.to(G.device) @ E @ H) / float(t) ** 0.5


def whiten_gap(R: torch.Tensor, G: torch.Tensor, S: torch.Tensor, t: int, z: int) -> float:
    """How far R lies from S E H / sqrt(t), for any E that whitens G, read
    without E itself.

    Any whitening of G is E = Q Lambda^{-1/2} V^T for an orthogonal Q: the
    signs of eigenvectors and the rotations inside clusters of close
    eigenvalues, which no precision fixes. So R is held to what every such
    E gives: t R G' R^T = S D S^T, D one on the resolved directions, where
    G' = G + lambda_max 11^T / l also charges a constant left in R's rows
    (the last H). The z unresolved directions (``unresolved``), which the
    program may keep with any weight or drop, are the first z columns of
    S in the ascending order; the comparison is made in the complement of
    their span. The gap is the widest entry of the difference over t."""
    l = G.shape[0]
    Gc = G + float(torch.linalg.eigvalsh(G)[-1]) * torch.ones_like(G) / l
    S = S.to(R.device, F64)
    diff = t * (R @ Gc @ R.T) - S[:, z:] @ S[:, z:].T
    if z:
        Q, _ = torch.linalg.qr(S[:, :z])
        P = torch.eye(S.shape[0], dtype=F64, device=R.device) - Q @ Q.T
        diff = P @ diff @ P
    return float(diff.abs().max()) / t


def distances(Y: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """||y_i - c_j||_1, float64, (n, k)."""
    return torch.cdist(Y.to(F64), C.to(Y.device, F64), p=1.0)


def kmeanspp(pool: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++ under l1 on the host in float64, drawing as the estimator
    does: a first row uniformly, then each next row with probability D(x)^2,
    D the l1 distance to the nearest pick."""
    Y = pool.to("cpu", F64)
    first = int(torch.randint(0, Y.shape[0], (1,), generator=generator))
    picks = [first]
    mind = (Y - Y[first]).abs().sum(1)
    for _ in range(1, k):
        w = mind * mind
        nxt = int(torch.multinomial(w / max(float(w.sum()), 1e-30), 1, generator=generator))
        picks.append(nxt)
        mind = torch.minimum(mind, (Y - Y[nxt]).abs().sum(1))
    return pool.to(F64)[torch.tensor(picks, device=pool.device)]


def assign(Y: torch.Tensor, C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels, l1 distance to the nearest centroid) of every row, in blocks."""
    lab, near = [], []
    for lo in range(0, Y.shape[0], BLOCK):
        dmin, arg = distances(Y[lo:lo + BLOCK], C).min(1)
        lab.append(arg)
        near.append(dmin)
    return torch.cat(lab), torch.cat(near)


def lloyd_steps(Y: torch.Tensor, C0: torch.Tensor, steps: int):
    """``steps`` exact Lloyd steps under l1 from C0, each centroid the mean
    of its rows: each step's cost (the sum of the nearest l1 distances
    under its centroids), the Frobenius norm of each update, and the last
    centroids. An empty cluster keeps its centroid."""
    C = C0.to(Y.device, F64)
    k = C.shape[0]
    costs, shifts = [], []
    for _ in range(steps):
        lab, near = assign(Y, C)
        Z = torch.zeros_like(C).index_add_(0, lab, Y.to(F64))
        g = torch.bincount(lab, minlength=k).to(F64)
        C_next = torch.where((g > 0)[:, None], Z / g.clamp(min=1.0)[:, None], C)
        costs.append(float(near.sum()))
        shifts.append(float(torch.linalg.norm(C_next - C)))
        C = C_next
    return costs, shifts, C


def label_gaps(Y: torch.Tensor, C: torch.Tensor, labels: torch.Tensor) -> tuple[float, float]:
    """(widest gap, cost) under l1: the largest amount by which a given
    label's distance exceeds the row's nearest, and the sum of the nearest
    distances. A label outside [0, k) reads an infinite gap."""
    k = C.shape[0]
    labels = labels.to(Y.device).long()
    if labels.shape[0] != Y.shape[0] or int(labels.min()) < 0 or int(labels.max()) >= k:
        return float("inf"), float("nan")
    widest, cost = 0.0, 0.0
    for lo in range(0, Y.shape[0], BLOCK):
        D = distances(Y[lo:lo + BLOCK], C)
        dmin = D.min(1).values
        widest = max(widest, float((D.gather(1, labels[lo:lo + BLOCK, None])[:, 0] - dmin).max()))
        cost += float(dmin.sum())
    return widest, cost


def update_gap(Y: torch.Tensor, C: torch.Tensor, shift: float,
               slack: float = 1e-5) -> tuple[float, float]:
    """(gap, uncertain share): ``bench.reference.apnc.update_gap`` under l1.

    An update of Frobenius norm s moves centroid j by some s_j in l2, with
    the squares of the s_j summing to s^2 at most, so it moves a row's l1
    distance to j by at most sqrt(m) s_j. A row's lead of its nearest
    centroid b over another j changes by at most sqrt(m) (s_b + s_j) <=
    sqrt(2 m) s: a row whose nearest centroid under C leads every other by
    more than sqrt(2 m) s (plus ``slack`` of its distance) had the same
    label in the pass before, and is certain.
    The means are l2's whatever the discrepancy, so the rest is the l2
    bound of the Nystrom judge: a centroid lies within u / (n + u) of the
    farthest candidate row from the mean M of its n certain rows. The
    uncertain share is the rows that are not certain over all rows."""
    k, m = C.shape
    C = C.to(Y.device, F64)
    lead = (2.0 * m) ** 0.5 * shift
    S = torch.zeros((k, m), dtype=F64, device=Y.device)
    n = torch.zeros(k, dtype=F64, device=Y.device)
    unsure = []
    for lo in range(0, Y.shape[0], BLOCK):
        D = distances(Y[lo:lo + BLOCK], C)
        near, lab = D.min(1)
        cand = D <= (near * (1.0 + slack) + lead)[:, None]
        sure = cand.sum(1) == 1
        S.index_add_(0, lab[sure], Y[lo:lo + BLOCK][sure].to(F64))
        n += torch.bincount(lab[sure], minlength=k).to(F64)
        idx = torch.nonzero(~sure)[:, 0]
        unsure.append((idx + lo, cand[idx]))
    full = n > 0
    M = S / n.clamp(min=1.0)[:, None]
    rows = torch.cat([i for i, _ in unsure])
    cand = torch.cat([c for _, c in unsure])
    u = cand.sum(0).to(F64)
    reach = torch.zeros(k, dtype=F64, device=Y.device)
    for lo in range(0, rows.shape[0], BLOCK):
        Yu, cu = Y[rows[lo:lo + BLOCK]].to(F64), cand[lo:lo + BLOCK]
        far = torch.cdist(Yu, M).masked_fill_(~cu, 0.0).max(0).values
        reach = torch.maximum(reach, far)
    allowed = u / (n + u).clamp(min=1.0) * reach
    excess = ((C - M).norm(dim=1) - allowed).clamp(min=0.0)
    return (float(excess[full].max() / M[full].norm(dim=1).median()),
            rows.shape[0] / Y.shape[0])
