"""ComputePolicy: the "how should this math execute" knobs of the port.

The fields and their validation follow the JAX package's policy. Kernel
routing is not a field here: it follows the tensor. A CUDA tensor goes through
the hand-written kernel and a CPU tensor through the plain PyTorch version, so
there is no counterpart of the JAX package's ``resolve_pallas()``.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Precision = Literal["f32", "bf16"]
CacheDtype = Literal["f32", "bf16", "int8"]


@dataclasses.dataclass(frozen=True)
class ComputePolicy:
    """Execution policy shared by every driver.

    Args:
        precision: Compute precision of the plain embedding path (``"f32"``
            | ``"bf16"``); outputs are always f32. On a card the hand-written
            kernels serve the transform in f32 whatever this says, as the
            JAX package's Pallas route does on a TPU.
        prefetch: Block prefetch depth of the stream engine (0 = synchronous).
        sstep: s-step factor of the sharded stream scheduler (1 = exact).
        cache_dtype: Codec of the staged embedding cache (the host-resident
            Y blocks of ``stream_embed`` and the sweep): ``"f32"``
            passthrough, ``"bf16"`` or per-column-scaled symmetric
            ``"int8"``. Compressed blocks cross to the card in their wire
            form and are decoded inside the Lloyd step's kernel. The
            resident local path (``y_array``) stays f32.
    """

    precision: Precision = "f32"
    prefetch: int = 2
    sstep: int = 1
    cache_dtype: CacheDtype = "f32"

    def __post_init__(self):
        """Validate field values (ValueError on unknown settings)."""
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


def as_policy(policy: "ComputePolicy | None") -> ComputePolicy:
    """``None`` -> the default policy; a ``ComputePolicy`` passes through."""
    if policy is None:
        return ComputePolicy()
    if isinstance(policy, ComputePolicy):
        return policy
    raise TypeError(f"expected ComputePolicy or None, got {type(policy)!r}")
