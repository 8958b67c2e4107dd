"""Faults planted under an APNC-SD fit, by name, beside the readings of
``bench/harness/planted.py``, which ``reading`` here also answers: what
``bench/controls_sd.py`` runs on the card and ``bench/test_portbench_sd.py``
on the CPU.

  labels-l2            Lloyd runs under l2, not the member's l1
  s-other-seed         S drawn from another seed than the fit generator's
  centered-gram-bf16   the centered landmark gram rounded to bfloat16 before eigh
"""
from __future__ import annotations

from unittest import mock

import torch

from bench.harness.planted import reading as _reading


def _labels_l2():
    from repro_torch.api import backends

    fit_lloyd = backends.lloyd

    def lloyd(*args, **kwargs):
        return fit_lloyd(*args, **dict(kwargs, discrepancy="l2"))

    return mock.patch.object(backends, "lloyd", lloyd)


def _s_other_seed():
    from repro_torch.embed import apnc

    draw = apnc._sd_directions

    def other(generator, m, l, t):
        return draw(torch.Generator().manual_seed(generator.initial_seed() + 1), m, l, t)

    return mock.patch.object(apnc, "_sd_directions", other)


def _centered_gram_bf16():
    from repro_torch.embed import apnc

    gram = apnc._centered_gram

    def rounded(landmarks, kernel):
        G, H = gram(landmarks, kernel)
        return G.to(torch.bfloat16).to(G.dtype), H

    return mock.patch.object(apnc, "_centered_gram", rounded)


FAULTS = {"labels-l2": _labels_l2, "s-other-seed": _s_other_seed,
          "centered-gram-bf16": _centered_gram_bf16}


def reading(name: str):
    """(the program's ComputePolicy or None, a context that plants the rest):
    the faults above, else ``planted.reading``'s."""
    if name in FAULTS:
        return None, FAULTS[name]()
    return _reading(name)
