"""The Embedding protocol: the paper's family definition (Section 4) as an API.

An ``Embedding`` is a registered object with ``fit(seed, data, kernel, ...)``
returning typed params, a plain ``transform(params, X) -> Y`` and
``props(params)``, the family properties (`EmbeddingProps`) its consumers
rely on.
``transform(params, X, policy)`` at module level is the one routed dispatch
point every consumer goes through: by default the member's hand-written
kernel for a CUDA tensor and its plain PyTorch version for a CPU tensor, as
``ComputePolicy.resolve_kernels`` decides. ``params_state`` /
``params_restore`` give every member checkpoint serialization in the JAX
package's format: tensor fields as host arrays, the other fields as strict
JSON.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core.apnc import Discrepancy
from repro_torch.core.kernels_fn import Kernel
from repro_torch.device import resolve_device
from repro_torch.policy import ComputePolicy, as_policy

#: Any dataclass with tensor fields plus ``m``, ``d`` and ``discrepancy``.
EmbeddingParams = Any


@dataclasses.dataclass(frozen=True)
class EmbeddingProps:
    """Declared family properties of a *fitted* member (paper Section 4).

    linear:        P4.1 as an input-space statement: transform commutes with
                   row means (APNC under the linear kernel, degree-1
                   sketches).
    discrepancy:   the e(., .) of P4.4 under which embedded distances
                   concentrate: "l2" (Nystrom, RFF, sketches) or "l1"
                   (stable distributions).
    blockwise:     P4.3: supports q > 1 block-diagonal ensembles.
    landmark_free: the fit is a data-independent draw (no landmark gram);
                   mirrors the member's class attribute of the same name.
    """

    linear: bool
    discrepancy: Discrepancy
    blockwise: bool = False
    landmark_free: bool = False


class Embedding(abc.ABC):
    """One member of the paper's embedding family.

    Subclasses set ``name`` and ``params_cls`` and implement ``fit``,
    ``transform`` (the plain version) and ``props``. ``kernel_transform``
    returns the hand-written kernel's result for CUDA input, or None when the
    member has no kernel (``transform`` then takes the plain version).
    """

    name: str = ""
    params_cls: type = object
    #: The fit is a data-independent draw (no landmark gram): only the input
    #: dimensionality is read from the data. Readable before a fit exists.
    landmark_free: bool = False
    #: Kernel families the member can approximate, or None for any kernel
    #: (the kernelized APNC members).
    kernel_families: tuple[str, ...] | None = None

    @abc.abstractmethod
    def fit(
        self, seed: int, data: torch.Tensor, kernel: Kernel, *,
        l: int, m: int, t: int | None = None, q: int = 1,
    ) -> EmbeddingParams:
        """Fit the member on ``data``; ``seed`` drives its random draws."""

    @abc.abstractmethod
    def transform(self, params: EmbeddingParams, X: torch.Tensor) -> torch.Tensor:
        """Plain reference map: (n, d) -> (n, params.m), f32."""

    @abc.abstractmethod
    def props(self, params: EmbeddingParams) -> EmbeddingProps:
        """Family properties of this fitted member."""

    def kernel_transform(self, params: EmbeddingParams, X: torch.Tensor) -> torch.Tensor | None:
        """Hand-written kernel path for CUDA input, or None."""
        return None

    # ------------------------------------------------------- serialization

    def params_state(self, params: EmbeddingParams) -> tuple[dict[str, np.ndarray], dict]:
        """(arrays, config): the tensor fields as host arrays, every other
        field as a strict-JSON value; the JAX package's npz keys and config
        dict for the same params."""
        arrays: dict[str, np.ndarray] = {}
        config: dict = {}
        for f in dataclasses.fields(params):
            v = getattr(params, f.name)
            if isinstance(v, torch.Tensor):
                arrays[f.name] = v.detach().cpu().numpy()
            else:
                config[f.name] = _config_encode(v)
        return arrays, config

    def params_restore(self, arrays: dict[str, np.ndarray], config: dict, *,
                       device=None) -> EmbeddingParams:
        """Inverse of ``params_state``, its tensors on ``device`` (default:
        the card)."""
        dev = resolve_device(device)
        kw: dict = {k: _config_decode(v) for k, v in config.items()}
        kw.update({k: torch.from_numpy(np.array(v, copy=True)).to(dev)
                   for k, v in arrays.items()})
        return self.params_cls(**kw)


_KERNEL_TAG = "__kernel__"


def _config_encode(v):
    if isinstance(v, Kernel):
        return {_KERNEL_TAG: dataclasses.asdict(v)}
    if v is None or isinstance(v, (str, int, float, bool)):
        return v
    raise TypeError(
        f"embedding-params field of type {type(v).__name__} is not "
        "JSON-serializable; override params_state/params_restore"
    )


def _config_decode(v):
    if isinstance(v, dict) and _KERNEL_TAG in v:
        return Kernel(**v[_KERNEL_TAG])
    return v


# ------------------------------------------------------------------ registry

EMBEDDINGS: dict[str, Embedding] = {}
_BY_PARAMS: dict[type, Embedding] = {}

#: The registry's default member (what the CLIs fall back to).
DEFAULT_EMBEDDING = "nystrom"


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


def unregister_embedding(name: str) -> None:
    """Remove a registered member (tests, plugin teardown)."""
    emb = EMBEDDINGS.pop(name, None)
    if emb is not None and _BY_PARAMS.get(emb.params_cls) is emb:
        # Members may share a params type (nystrom and sd both use
        # APNCCoefficients): rebind the type's dispatch to a surviving member
        # instead of orphaning every other user of that params class.
        survivor = next(
            (e for e in EMBEDDINGS.values() if e.params_cls is emb.params_cls), None,
        )
        if survivor is not None:
            _BY_PARAMS[emb.params_cls] = survivor
        else:
            del _BY_PARAMS[emb.params_cls]


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


def props_of(params: EmbeddingParams) -> EmbeddingProps:
    """Family properties of fitted params (dispatched on their type)."""
    return embedding_for(params).props(params)
