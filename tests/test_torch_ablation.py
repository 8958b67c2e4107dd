"""tools/kernel_ablation.py against the CUDA sources it edits.

Each variant of the tool is a list of (file, text, replacement) edits to a
copy of ``src/repro_torch/kernels/csrc``; the tool raises on the card when a
text is missing. Here, on the CPU, every variant's every text must occur in
its file, so a kernel rewritten without its variants fails a test instead of
the tool failing on the card. The tool's module imports no JAX.
"""
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("kernel_ablation",
                                               ROOT / "tools" / "kernel_ablation.py")
ablation = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(ablation)

CASES = [(target, name) for target, (_, variants) in ablation.TARGETS.items()
         for name in variants]


@pytest.mark.parametrize("target,variant", CASES, ids=[f"{t}-{v}" for t, v in CASES])
def test_variant_texts_occur_in_their_sources(target, variant):
    source, variants = ablation.TARGETS[target]
    assert (ablation.CSRC / source).is_file()
    assert set(ablation.EXACT[target]) <= set(variants)
    for file, text, repl in variants[variant]:
        body = (ablation.CSRC / file).read_text()
        assert text in body, f"{target} variant {variant}: {text!r} is not in {file}"
        assert repl != text
    assert variant == "base" or variants[variant], "a variant other than base edits something"
