"""String-keyed registries: backends and kernels (embeddings live in
``repro_torch.embed`` and are re-exported here)."""
from __future__ import annotations

from typing import Callable

from repro_torch.core.kernels_fn import Kernel
from repro_torch.embed import (  # noqa: F401  (re-exported registry surface)
    EMBEDDINGS,
    Embedding,
    available_embeddings,
    embedding_for,
    get_embedding,
    register_embedding,
)

# --------------------------------------------------------------- backends

#: A backend maps a FitContext (api/backends.py) to a BackendFit.
BACKENDS: dict[str, Callable] = {}


def register_backend(name: str):
    """Decorator: ``@register_backend("local")`` adds a clustering engine."""

    def _deco(fn):
        BACKENDS[name] = fn
        return fn

    return _deco


def available_backends() -> list[str]:
    """The registered backend names, sorted."""
    return sorted(BACKENDS)


def get_backend(name: str):
    """The registered backend callable for ``name`` (ValueError if unknown)."""
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; registered: {available_backends()}"
        ) from None


# ---------------------------------------------------------------- kernels

#: A kernel factory maps keyword params to a Kernel instance.
KERNELS: dict[str, Callable[..., Kernel]] = {
    "rbf": lambda **kw: Kernel("rbf", **kw),
    "poly": lambda **kw: Kernel("poly", **kw),
    "tanh": lambda **kw: Kernel("tanh", **kw),
    "linear": lambda **kw: Kernel("linear", **kw),
}


def register_kernel(name: str, factory: Callable[..., Kernel] | None = None):
    """Register a kernel factory; usable as decorator or plain call."""
    if factory is not None:
        KERNELS[name] = factory
        return factory

    def _deco(fn):
        KERNELS[name] = fn
        return fn

    return _deco


def resolve_kernel(kernel: str | Kernel, params: dict | None = None) -> Kernel:
    """A Kernel instance passes through; a string resolves via the registry."""
    if isinstance(kernel, Kernel):
        if params:
            raise ValueError("kernel_params= only applies to string kernel names")
        return kernel
    try:
        factory = KERNELS[kernel]
    except KeyError:
        raise ValueError(
            f"unknown kernel {kernel!r}; registered: {sorted(KERNELS)}"
        ) from None
    return factory(**(params or {}))
