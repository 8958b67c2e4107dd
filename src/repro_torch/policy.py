"""ComputePolicy: the "how should this math execute" knobs of the port.

The fields and their validation follow the JAX package's policy. ``kernels``
is its ``pallas`` field: by default a CUDA tensor goes through the
hand-written kernels and a CPU tensor through the plain PyTorch versions;
``kernels=False`` asks for the plain versions on the tensor's own device,
where ``precision="bf16"`` takes effect. ``resolve_kernels(device)`` is the
counterpart of the JAX package's ``resolve_pallas()``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import torch

Precision = Literal["f32", "bf16"]
CacheDtype = Literal["f32", "bf16", "int8"]


@dataclasses.dataclass(frozen=True)
class ComputePolicy:
    """Execution policy shared by every driver.

    Args:
        kernels: Kernel routing, ``repro.policy.ComputePolicy.pallas`` of the
            JAX package. ``None`` (the default): the hand-written kernels for
            CUDA tensors, the plain PyTorch versions for CPU tensors.
            ``False``: the plain versions on the tensor's own device (the card
            included). ``True``: the kernels, and a CPU tensor raises, since
            the kernels have no CPU mode.
        precision: Compute precision of the plain embedding path (``"f32"``
            | ``"bf16"``); outputs are always f32. The hand-written kernels
            compute in f32 whatever this says, as the JAX package's Pallas
            route does on a TPU; with ``kernels=False`` bf16 takes effect on
            the card too.
        prefetch: Block prefetch depth of the stream engine (0 = synchronous).
        sstep: s-step factor of the sharded stream scheduler (1 = exact).
        cache_dtype: Codec of the staged embedding cache (the host-resident
            Y blocks of ``stream_embed`` and the sweep): ``"f32"``
            passthrough, ``"bf16"`` or per-column-scaled symmetric
            ``"int8"``. Compressed blocks cross to the card in their wire
            form and are decoded inside the Lloyd step's kernel. The
            resident local path (``y_array``) stays f32.
    """

    kernels: bool | None = None
    precision: Precision = "f32"
    prefetch: int = 2
    sstep: int = 1
    cache_dtype: CacheDtype = "f32"

    def __post_init__(self):
        """Validate field values (ValueError on unknown settings)."""
        if self.kernels is not None and not isinstance(self.kernels, bool):
            raise ValueError(f"kernels must be None, True or False, got {self.kernels!r}")
        if self.precision not in ("f32", "bf16"):
            raise ValueError(f"unknown precision {self.precision!r}")
        if self.prefetch < 0:
            raise ValueError(f"prefetch must be >= 0, got {self.prefetch}")
        if not isinstance(self.sstep, int) or self.sstep < 1:
            raise ValueError(f"sstep must be an int >= 1, got {self.sstep!r}")
        if self.cache_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(
                f"unknown cache_dtype {self.cache_dtype!r}: "
                "expected 'f32', 'bf16' or 'int8'"
            )

    def resolve_kernels(self, device) -> bool:
        """Whether the hand-written kernels serve a tensor on ``device``.

        ``None``: yes on a CUDA device, no elsewhere. ``False``: no.
        ``True``: yes, and a device other than CUDA raises ValueError.
        """
        on_card = torch.device(device).type == "cuda"
        if self.kernels is None:
            return on_card
        if self.kernels and not on_card:
            raise ValueError(
                f"ComputePolicy(kernels=True) on a {torch.device(device).type} tensor: "
                "the hand-written kernels run only on a CUDA card"
            )
        return self.kernels


def as_policy(policy: "ComputePolicy | None") -> ComputePolicy:
    """``None`` -> the default policy; a ``ComputePolicy`` passes through."""
    if policy is None:
        return ComputePolicy()
    if isinstance(policy, ComputePolicy):
        return policy
    raise TypeError(f"expected ComputePolicy or None, got {type(policy)!r}")
