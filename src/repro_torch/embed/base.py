"""The Embedding protocol: the paper's family definition (Section 4) as an API.

An ``Embedding`` is a registered object with ``fit(seed, data, kernel, ...)``
returning typed params and a plain ``transform(params, X) -> Y``.
``transform(params, X, policy)`` at module level is the one routed dispatch
point every consumer goes through: the member's hand-written kernel for a
CUDA tensor, its plain PyTorch version for a CPU tensor.
"""
from __future__ import annotations

import abc
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
    member has no kernel.
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


def transform(
    params: EmbeddingParams, X: torch.Tensor, policy: ComputePolicy | None = None,
) -> torch.Tensor:
    """THE embedding dispatch point: Y = f(X) for any registered member.

    A CUDA tensor goes through the member's hand-written kernel (a member
    without one raises); a CPU tensor through the plain version."""
    emb = embedding_for(params)
    as_policy(policy)  # validates; f32 is the only precision of this slice
    if X.device.type == "cuda":
        y = emb.kernel_transform(params, X)
        if y is None:
            raise NotImplementedError(
                f"embedding {emb.name!r} has no CUDA kernel in this port yet"
            )
        return y
    return emb.transform(params, X.to(torch.float32))
