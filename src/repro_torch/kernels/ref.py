"""Plain PyTorch versions of the two hand-written kernels.

They compute the same functions as ``apnc_embed`` and ``apnc_assign``, with the
same contracts as the JAX package's oracles. The wrappers use them for CPU
tensors; on the card they are only the yardstick the kernels are held against.
"""
from __future__ import annotations

import torch

from repro_torch.core.apnc import Discrepancy, pairwise_discrepancy
from repro_torch.core.kernels_fn import Kernel


def apnc_embed_ref(
    X: torch.Tensor, landmarks: torch.Tensor, R: torch.Tensor, kernel: Kernel
) -> torch.Tensor:
    """Y = kappa(X, L) @ R^T per block, concatenated, computed in f32.

    X: (n, d); landmarks: (q, l_b, d); R: (q, m_b, l_b)  ->  (n, q * m_b) f32.
    """
    Xf = X.to(torch.float32)
    parts = [
        kernel.gram(Xf, landmarks[b].to(torch.float32)) @ R[b].to(torch.float32).T
        for b in range(landmarks.shape[0])
    ]
    return torch.cat(parts, dim=-1)


def apnc_assign_ref(
    Y: torch.Tensor, C: torch.Tensor, discrepancy: Discrepancy
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distances -> argmin -> sufficient stats.

    Y: (n, m), C: (k, m)  ->  Z (k, m) f32, g (k,) f32, labels (n,) int32.
    """
    Yf = Y.to(torch.float32)
    Cf = C.to(torch.float32)
    labels = torch.argmin(pairwise_discrepancy(Yf, Cf, discrepancy), dim=-1)
    onehot = torch.nn.functional.one_hot(labels, C.shape[0]).to(torch.float32)
    return onehot.T @ Yf, torch.sum(onehot, dim=0), labels.to(torch.int32)
