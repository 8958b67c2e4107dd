"""Build the port's objects from plain arrays and dicts.

The JAX package's fitted state (landmarks, R, the RFF frequencies W,
centroids, inertia and the static fields) is handed over as numpy arrays plus plain dicts, so that both
packages compute from the same state. Nothing here imports the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.api.model import ClusterModel, FitMeta
from repro_torch.core.apnc import APNCCoefficients
from repro_torch.core.kernels_fn import Kernel
from repro_torch.embed.rff import RFFParams


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(device)


def _kernel(fields: dict) -> Kernel:
    known = {f.name for f in dataclasses.fields(Kernel)}
    unknown = set(fields) - known
    if unknown:
        raise ValueError(f"unknown kernel fields {sorted(unknown)}")
    return Kernel(**fields)


def apnc_params_from_numpy(
    landmarks, R, kernel: dict, discrepancy: str, *, device="cpu",
) -> APNCCoefficients:
    """APNC coefficients from landmarks (q, l_b, d), R (q, m_b, l_b) and the
    kernel's fields as a dict (name, gamma, degree, coef0, scale)."""
    return APNCCoefficients(
        landmarks=_tensor(landmarks, device), R=_tensor(R, device),
        kernel=_kernel(kernel), discrepancy=discrepancy,
    )


def rff_params_from_numpy(W, kernel: dict, *, device="cpu") -> RFFParams:
    """RFF params from the frequency matrix W (d, m_half) and the kernel's
    fields as a dict."""
    return RFFParams(W=_tensor(W, device), kernel=_kernel(kernel))


def cluster_model_from_numpy(
    params: APNCCoefficients | RFFParams, centroids, inertia, meta: dict,
) -> ClusterModel:
    """A ClusterModel from converted params, centroids (k, m), the inertia and
    the FitMeta fields as a dict (unknown keys are ignored)."""
    fields = {f.name for f in dataclasses.fields(FitMeta)}
    return ClusterModel(
        params=params,
        centroids=_tensor(centroids, params.device),
        inertia=torch.tensor(float(np.asarray(inertia)), dtype=torch.float32),
        meta=FitMeta(**{k: v for k, v in meta.items() if k in fields}),
    )
