"""Persistence of the port: crash-safe checkpoints in the JAX package's
format (``checkpoint``). The sharding, compression and pipeline modules of
the JAX package's ``distributed`` arrive with the LM training and LM-mesh
slices (ROADMAP.md, Queue 1 items 15 and 20)."""
from repro_torch.distributed import checkpoint  # noqa: F401
