"""Persistence of the port: crash-safe checkpoints in the JAX package's
format (``checkpoint``). The sharding, compression and pipeline modules of
the JAX package's ``distributed`` arrive with the multi-device and LM
training slices (ROADMAP.md, Queue 1 items 13 and 15)."""
from repro_torch.distributed import checkpoint  # noqa: F401
