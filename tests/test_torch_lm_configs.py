"""The port's architecture registry against the JAX package's: every one of the
ten archs, full and reduced, equal field by field, with the derived
properties (head dim, physical heads, layer pattern) equal too."""
import dataclasses

import pytest

from repro.configs import get_arch as jget_arch
from repro.configs import list_archs as jlist_archs
from repro.configs import reduced as jreduced
from repro_torch.configs import get_arch, list_archs, reduced

ARCHS = jlist_archs()


def _fields(cfg) -> dict:
    return dataclasses.asdict(cfg)


def test_same_ten_archs():
    assert len(ARCHS) == 10
    assert list_archs() == ARCHS


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_equal_field_by_field(arch, size):
    ours, theirs = get_arch(arch), jget_arch(arch)
    if size == "reduced":
        ours, theirs = reduced(ours), jreduced(theirs)
    assert _fields(ours) == _fields(theirs)
    assert ours.resolved_head_dim == theirs.resolved_head_dim
    assert ours.phys_heads == theirs.phys_heads
    assert ours.num_groups == theirs.num_groups
    assert _fields_of(ours.layer_pattern()) == _fields_of(theirs.layer_pattern())
    assert ours.runnable_shapes() == theirs.runnable_shapes()


def _fields_of(pattern) -> list:
    return [dataclasses.asdict(spec) for spec in pattern]


def test_reduced_overrides_match():
    ours = reduced(get_arch("qwen3-4b"), sliding_window=4, num_layers=3)
    theirs = jreduced(jget_arch("qwen3-4b"), sliding_window=4, num_layers=3)
    assert _fields(ours) == _fields(theirs)


def test_unknown_arch_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("gpt-0")
