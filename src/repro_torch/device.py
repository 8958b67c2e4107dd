"""Where the port's entry points run: the card unless the caller asks for the CPU.

One small helper decides it, at call time (never at import): ``device=None``
means ``cuda``, and without a card that is an error rather than a quiet run
on the CPU. ``device="cpu"`` is the explicit opt-in the tests use.
"""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The device an entry point runs on.

    Args:
        device: ``None`` for the default (the first CUDA card), or an explicit
            device such as ``"cpu"`` or ``"cuda:1"``.

    Returns:
        The resolved ``torch.device``.

    Raises:
        RuntimeError: No device was given and no CUDA card is present, or a
            CUDA device was asked for without one.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA card by default and none is present; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` for a card, a no-op context elsewhere: the
    guard a thread that launches on ``device`` runs under."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
