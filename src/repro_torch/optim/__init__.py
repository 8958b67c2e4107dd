"""The LM optimizer: AdamW on named parameters, and the learning-rate schedules."""
from repro_torch.optim import adamw, schedule  # noqa: F401
from repro_torch.optim.adamw import AdamWConfig, AdamWState  # noqa: F401
