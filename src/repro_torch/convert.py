"""Build the port's objects from plain arrays and dicts.

The JAX package's fitted state (landmarks, R, the RFF frequencies W,
centroids, inertia and the static fields) and its LM params tree are handed
over as numpy arrays plus plain dicts, so that both packages compute from
the same state. Nothing here imports the JAX package.
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


def _leaves(tree: dict, prefix: str = ""):
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            yield from _leaves(value, name + ".")
        else:
            yield name, value


def lm_params_from_numpy(tree: dict, cfg, *, device="cpu"):
    """The port's LM (``models.model.LM``, f32 params) from the reference's
    params tree as nested dicts of numpy arrays, its layer groups stacked on
    axis 0 (``tree["groups"]["layer0"]["mixer"]["wq"]`` is (G, d, H, Dh)).

    Every leaf lands on the parameter of the same dotted name, the groups
    unstacked (``groups.<g>.layer0.mixer.wq``). Raises ValueError on a leaf
    that is missing, extra, or of another shape.
    """
    from repro_torch.models import model as lm
    from repro_torch.models.common import Policy

    module = lm.build(cfg, Policy(), device)
    want = dict(module.named_parameters())
    got = {}
    for name, leaf in _leaves(tree):
        a = np.array(leaf, dtype=np.float32)  # a writable copy
        if name.startswith("groups."):
            if a.ndim == 0 or a.shape[0] != cfg.num_groups:
                raise ValueError(f"{name}: {a.shape} is not stacked over {cfg.num_groups} groups")
            for g in range(cfg.num_groups):
                got[f"groups.{g}.{name[len('groups.'):]}"] = a[g]
        else:
            got[name] = a
    missing, extra = sorted(set(want) - set(got)), sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"params tree does not match {cfg.name}: missing {missing}, "
                         f"extra {extra}")
    for name, param in want.items():
        if tuple(got[name].shape) != tuple(param.shape):
            raise ValueError(f"{name}: {tuple(got[name].shape)} != {tuple(param.shape)}")
        param.copy_(torch.from_numpy(np.ascontiguousarray(got[name])))
    return module
