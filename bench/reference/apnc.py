"""The plain reference of APNC-Nystrom kernel k-means (the paper's Algorithms
1-3 under the self-tuned RBF kernel), in float64 PyTorch and NumPy.

It imports nothing of the program. What it needs of the program's
conventions is written out here as the specification that the benchmark
holds the program to: how one root seed splits into the phase-1 seeds, the
block form of the reservoir sample, which rows the self-tuned gamma and the
landmarks are drawn from, and the k-means++ draw sequence. Every
computation is float64, on whatever device its inputs are on, in blocks of
rows so that a whole data set fits.
"""
from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64
#: Rows a block of the reference's embedding or assignment holds.
BLOCK = 1 << 15


# --------------------------------------------------------------- conventions


def phase1_seeds(seed: int) -> tuple[int, int, int]:
    """One root seed -> (sample, fit, seed) seeds, as the estimator splits it."""
    children = np.random.SeedSequence(int(seed)).spawn(3)
    return tuple(int(c.generate_state(1)[0]) for c in children)


def restart_generator(seed_seed: int, r: int) -> torch.Generator:
    """The CPU generator of restart r's k-means++ draws."""
    state = np.random.SeedSequence(int(seed_seed), spawn_key=(r,)).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def reservoir_sample(blocks, n: int, d: int, size: int, seed: int) -> np.ndarray:
    """Vitter's Algorithm R over row blocks (host arrays, in order)."""
    rng = np.random.default_rng(seed)
    out = np.zeros((min(size, n), d), dtype=np.float32)
    seen = 0
    for blk in blocks:
        rows = blk.shape[0]
        take = min(max(size - seen, 0), rows)
        if take:
            out[seen:seen + take] = blk[:take]
        t = np.arange(seen + take, seen + rows)
        accept = rng.random(rows - take) < size / (t + 1)
        idx = np.nonzero(accept)[0]
        if idx.size:
            out[rng.integers(0, size, size=idx.size)] = blk[take + idx]
        seen += rows
    return out


def self_tuned_gamma(sample: torch.Tensor, seed: int, rows: int = 512) -> float:
    """gamma = 1 / (2 sigma^2), sigma^2 the mean off-diagonal squared distance
    over ``rows`` rows drawn without replacement by a CPU generator."""
    gen = torch.Generator().manual_seed(int(seed))
    idx = torch.randperm(sample.shape[0], generator=gen)[:min(rows, sample.shape[0])]
    S = sample[idx.to(sample.device)].to(F64)
    d2 = torch.cdist(S, S).square()
    m = S.shape[0]
    return 1.0 / (2.0 * max(float(d2.sum()) / (m * (m - 1)), 1e-12))


def landmarks(sample: torch.Tensor, fit_seed: int, l: int) -> torch.Tensor:
    """l rows of the sample, drawn without replacement by a CPU generator."""
    idx = torch.randperm(sample.shape[0], generator=torch.Generator().manual_seed(int(fit_seed)))
    return sample[idx[:l].to(sample.device)]


# -------------------------------------------------------------------- maths


def rbf(A: torch.Tensor, B: torch.Tensor, gamma: float) -> torch.Tensor:
    """exp(-gamma ||a - b||^2), float64."""
    A, B = A.to(F64), B.to(F64)
    d2 = (A * A).sum(1, keepdim=True) - 2.0 * (A @ B.T) + (B * B).sum(1)[None, :]
    return torch.exp(-gamma * d2.clamp_(min=0.0))


def nystrom(L: torch.Tensor, gamma: float, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(R, eigenvalues): R = Lambda_m^{-1/2} V_m^T of the landmarks' gram,
    float64, with its top-m eigenvalues."""
    lam, V = torch.linalg.eigh(rbf(L, L, gamma))
    top = lam[-m:]
    return top.clamp(min=1e-300).rsqrt()[:, None] * V[:, -m:].T, top


def embed(X, L: torch.Tensor, R: torch.Tensor, gamma: float, device=None) -> torch.Tensor:
    """Y = kappa(X, L) R^T, float64, block by block (X may be a host tensor;
    each block goes to ``device``, by default L's)."""
    device = L.device if device is None else device
    L, R = L.to(device, F64), R.to(device, F64)
    return torch.cat([rbf(X[lo:lo + BLOCK].to(device), L, gamma) @ R.T
                      for lo in range(0, X.shape[0], BLOCK)])


def distances(Y: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """||y_i - c_j||, float64, (n, k)."""
    C = C.to(Y.device, F64)
    d2 = (Y * Y).sum(1, keepdim=True) - 2.0 * (Y @ C.T) + (C * C).sum(1)[None, :]
    return d2.clamp_(min=0.0).sqrt_()


def kmeanspp(pool: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """k-means++ under l2 on the host in float64, drawing as the estimator does:
    a first row uniformly, then each next row with probability D(x)^2."""
    Y = pool.to("cpu", F64)
    first = int(torch.randint(0, Y.shape[0], (1,), generator=generator))
    picks = [first]
    mind = (Y - Y[first]).norm(dim=1)
    for _ in range(1, k):
        w = mind * mind
        nxt = int(torch.multinomial(w / max(float(w.sum()), 1e-30), 1, generator=generator))
        picks.append(nxt)
        mind = torch.minimum(mind, (Y - Y[nxt]).norm(dim=1))
    return pool.to(F64)[torch.tensor(picks, device=pool.device)]


def assign(Y: torch.Tensor, C: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels, distance to the nearest centroid) of every row, in blocks."""
    lab, near = [], []
    for lo in range(0, Y.shape[0], BLOCK):
        dmin, arg = distances(Y[lo:lo + BLOCK], C).min(1)
        lab.append(arg)
        near.append(dmin)
    return torch.cat(lab), torch.cat(near)


def lloyd_steps(Y: torch.Tensor, C0: torch.Tensor, steps: int):
    """``steps`` exact Lloyd steps from C0: each step's cost (the sum of the
    nearest distances under its centroids), the Frobenius norm of each
    update, and the last centroids. An empty cluster keeps its centroid."""
    C = C0.to(Y.device, F64)
    k = C.shape[0]
    costs, shifts = [], []
    for _ in range(steps):
        lab, near = assign(Y, C)
        Z = torch.zeros_like(C).index_add_(0, lab, Y)
        g = torch.bincount(lab, minlength=k).to(F64)
        C_next = torch.where((g > 0)[:, None], Z / g.clamp(min=1.0)[:, None], C)
        costs.append(float(near.sum()))
        shifts.append(float(torch.linalg.norm(C_next - C)))
        C = C_next
    return costs, shifts, C


def label_gaps(Y: torch.Tensor, C: torch.Tensor, labels: torch.Tensor) -> tuple[float, float]:
    """(widest gap, cost): the largest amount by which a given label's
    distance exceeds the row's nearest distance, and the sum of the nearest
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


def update_gap(Y: torch.Tensor, C: torch.Tensor, shift: float, slack: float = 1e-5) -> float:
    """How far the centroids C lie from being the means of the rows that the
    pass before them labelled, whose centroids lay within ``shift`` (the
    Frobenius norm of the last update) of C: the widest excess over what the
    rows that pass may have labelled otherwise allow, over the median
    mean's norm.

    A row whose nearest centroid under C leads every other by more than
    2 * shift (plus ``slack`` of its distance, for rounding) had the same
    label in that pass: these rows are certain, and their means M are known.
    A centroid whose rows in that pass included u uncertain rows among its
    candidates lies within u / (n + u) * max ||y - M|| of the mean M of its
    n certain rows; only the distance past that counts. Clusters without
    certain rows are left out."""
    k, m = C.shape
    C = C.to(Y.device, F64)
    S = torch.zeros((k, m), dtype=F64, device=Y.device)
    n = torch.zeros(k, dtype=F64, device=Y.device)
    unsure = []  # (row index, candidate mask) of the uncertain rows
    for lo in range(0, Y.shape[0], BLOCK):
        D = distances(Y[lo:lo + BLOCK], C)
        near, lab = D.min(1)
        cand = D <= (near * (1.0 + slack) + 2.0 * shift)[:, None]
        sure = cand.sum(1) == 1
        S.index_add_(0, lab[sure], Y[lo:lo + BLOCK][sure])
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
        Yu, cu = Y[rows[lo:lo + BLOCK]], cand[lo:lo + BLOCK]
        far = torch.cdist(Yu, M).masked_fill_(~cu, 0.0).max(0).values
        reach = torch.maximum(reach, far)
    allowed = u / (n + u).clamp(min=1.0) * reach
    excess = ((C - M).norm(dim=1) - allowed).clamp(min=0.0)
    return float(excess[full].max() / M[full].norm(dim=1).median())


def fit_model(sample: torch.Tensor, k: int, l: int, m: int, steps: int, seed: int):
    """A Nystrom model fitted by the reference on ``sample``: (landmarks, R,
    gamma, centroids), float64. The landmarks are the first l rows, gamma
    is self-tuned, and the centroids are ``steps`` Lloyd steps from a
    k-means++ seeding of the embedded sample."""
    gamma = self_tuned_gamma(sample, seed)
    L = sample[:l].to(F64)
    R, _ = nystrom(L, gamma, m)
    Y = embed(sample, L, R, gamma)
    C0 = kmeanspp(Y[:8192], k, torch.Generator().manual_seed(int(seed)))
    _, _, C = lloyd_steps(Y, C0, steps)
    return L, R, gamma, C
