"""The port's distributed layer: crash-safe checkpoints in the JAX package's
format (``checkpoint``), the LM's sharding rules and placement
(``sharding``), the LM over a device mesh (``parallel``), int8
error-feedback gradient compression (``compression``) and the GPipe
pipeline (``pipeline``)."""
from repro_torch.distributed import sharding  # noqa: F401
from repro_torch.distributed import checkpoint, compression, pipeline  # noqa: F401
