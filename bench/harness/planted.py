"""The program with a lower-precision route switched on or a fault planted
underneath, by name: what the control readings of ``correct`` run
(``bench/controls.py`` on the card, ``bench/test_portbench_faults.py`` on
the CPU). Each reading is (a ``ComputePolicy`` or None for the program's
own, a context manager that plants the rest for as long as it is open)."""
from __future__ import annotations

import contextlib
from unittest import mock

import torch


@contextlib.contextmanager
def _tf32():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def _gram_bf16():
    from repro_torch.embed import apnc

    def block(landmarks, kernel, m):
        gram = kernel.gram(landmarks, landmarks).to(torch.bfloat16).to(torch.float32)
        lam, V = torch.linalg.eigh(gram)
        return apnc._inv_sqrt_clamped(lam)[-m:][:, None] * V[:, -m:].T

    return mock.patch.object(apnc, "_nystrom_block", block)


def _gamma_bf16():
    from repro_torch.api import estimator

    original = estimator.self_tuned_rbf

    def tuned(X, sample=512, seed=0):
        return original(X.to(torch.bfloat16).to(X.dtype), sample=sample, seed=seed)

    return mock.patch.object(estimator, "self_tuned_rbf", tuned)


def _frozen_after(updates: int):
    """Each fit's centroid updates after the first ``updates`` return their
    input (``updates`` 0: every update)."""
    from repro_torch.api import backends
    from repro_torch.core import lloyd as core_lloyd

    count = [0]
    update, fit_lloyd = core_lloyd.centroid_update, backends.lloyd

    def frozen(Z, g, prev):
        count[0] += 1
        return update(Z, g, prev) if count[0] <= updates else prev

    def lloyd(*args, **kwargs):
        count[0] = 0
        return fit_lloyd(*args, **kwargs)

    @contextlib.contextmanager
    def planted():
        with mock.patch.object(core_lloyd, "centroid_update", frozen), \
                mock.patch.object(backends, "lloyd", lloyd):
            yield

    return planted()


def reading(name: str):
    """(the program's ComputePolicy or None, a context that plants the rest);
    the names are those of ``bench/controls.py``."""
    from repro_torch.policy import ComputePolicy

    plain = ComputePolicy(kernels=False)
    return {
        "program": lambda: (None, contextlib.nullcontext()),
        "tf32": lambda: (plain, _tf32()),
        "bf16": lambda: (ComputePolicy(kernels=False, precision="bf16"),
                         contextlib.nullcontext()),
        "gram-bf16": lambda: (None, _gram_bf16()),
        "gamma-bf16": lambda: (None, _gamma_bf16()),
        "frozen-after-3": lambda: (None, _frozen_after(3)),
        "state-unchanged": lambda: (None, _frozen_after(0)),
    }[name]()
