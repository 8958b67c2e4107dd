"""The Embedding protocol: the paper's family definition (Section 4) as an API.

An ``Embedding`` is a registered object with ``fit(seed, data, kernel, ...)``
returning typed params and a plain ``transform(params, X) -> Y``.
``transform(params, X, policy)`` at module level is the one routed dispatch
point every consumer goes through: by default the member's hand-written
kernel for a CUDA tensor and its plain PyTorch version for a CPU tensor, as
``ComputePolicy.resolve_kernels`` decides.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any

import torch

from repro_torch.core.kernels_fn import Kernel
from repro_torch.policy import ComputePolicy, as_policy

#: Any dataclass with tensor fields plus ``m``, ``d`` and ``discrepancy``.
EmbeddingParams = Any


class Embedding(abc.ABC):
    """One member of the paper's embedding family.

    Subclasses set ``name`` and ``params_cls`` and implement ``fit`` and
    ``transform`` (the plain version). ``kernel_transform``
    returns the hand-written kernel's result for CUDA input, or None when the
    member has no kernel (``transform`` then takes the plain version).
    """

    name: str = ""
    params_cls: type = object

    @abc.abstractmethod
    def fit(
        self, seed: int, data: torch.Tensor, kernel: Kernel, *,
        l: int, m: int, t: int | None = None, q: int = 1,
    ) -> EmbeddingParams:
        """Fit the member on ``data``; ``seed`` drives its random draws."""

    @abc.abstractmethod
    def transform(self, params: EmbeddingParams, X: torch.Tensor) -> torch.Tensor:
        """Plain reference map: (n, d) -> (n, params.m), f32."""

    def kernel_transform(self, params: EmbeddingParams, X: torch.Tensor) -> torch.Tensor | None:
        """Hand-written kernel path for CUDA input, or None."""
        return None


# ------------------------------------------------------------------ registry

EMBEDDINGS: dict[str, Embedding] = {}
_BY_PARAMS: dict[type, Embedding] = {}


def register_embedding(embedding: Embedding | type) -> Embedding | type:
    """Register a family member (instance or class; usable as a decorator)."""
    emb = embedding() if isinstance(embedding, type) else embedding
    if not emb.name:
        raise ValueError(f"{type(emb).__name__} must set a non-empty .name")
    if emb.params_cls is object:
        raise ValueError(f"{type(emb).__name__} must set .params_cls")
    EMBEDDINGS[emb.name] = emb
    _BY_PARAMS[emb.params_cls] = emb
    return embedding


def available_embeddings() -> list[str]:
    return sorted(EMBEDDINGS)


def get_embedding(name: str) -> Embedding:
    try:
        return EMBEDDINGS[name]
    except KeyError:
        raise ValueError(
            f"unknown embedding {name!r}; registered: {available_embeddings()}"
        ) from None


def embedding_for(params: EmbeddingParams) -> Embedding:
    """Dispatch on the params type (nystrom and sd share one transform)."""
    try:
        return _BY_PARAMS[type(params)]
    except KeyError:
        raise TypeError(
            f"no registered embedding handles params of type "
            f"{type(params).__name__}; call register_embedding first"
        ) from None


# ------------------------------------------------------------ routed dispatch


def _cast_float_fields(params: EmbeddingParams, dtype: torch.dtype) -> EmbeddingParams:
    """The same params with every floating tensor field cast to ``dtype``."""
    return dataclasses.replace(params, **{
        f.name: getattr(params, f.name).to(dtype)
        for f in dataclasses.fields(params)
        if isinstance(getattr(params, f.name), torch.Tensor)
        and getattr(params, f.name).is_floating_point()
    })


def transform(
    params: EmbeddingParams, X: torch.Tensor, policy: ComputePolicy | None = None,
) -> torch.Tensor:
    """THE embedding dispatch point: Y = f(X) for any registered member.

    Routing per ``policy.resolve_kernels(X.device)``: the member's
    hand-written kernel when it resolves True and the member has one (the
    kernels compute in f32 whatever the policy's ``precision``, as the JAX
    package's Pallas route does on a TPU); otherwise the plain version on
    X's own device, in f32, or under ``precision="bf16"`` with the params'
    float fields and X cast to bf16, the result returned as f32. By default
    that is the kernel for a CUDA tensor and the plain version for a CPU
    tensor; ``kernels=False`` takes the plain version on the card too. A
    member without a kernel takes its plain version, as in the JAX package;
    a kernel that fails to build or launch raises."""
    emb = embedding_for(params)
    pol = as_policy(policy)
    if pol.resolve_kernels(X.device):
        y = emb.kernel_transform(params, X)
        if y is not None:
            return y
    if pol.precision == "bf16":
        p16 = _cast_float_fields(params, torch.bfloat16)
        return emb.transform(p16, X.to(torch.bfloat16)).to(torch.float32)
    return emb.transform(params, X.to(torch.float32))
