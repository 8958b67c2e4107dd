"""The port's sharding rules, input specs and placement against the JAX
package's, and its causal-skip flash attention.

The rules are compared spec for spec: the reference's ``param_pspecs`` on its
params tree (``jax.eval_shape`` of ``init``, allocation-free) against the
port's on its ``meta``-device LM, leaf by leaf through the name map (a group
leaf's reference spec loses its leading ``None``, the stacked axis); the batch
and cache specs for every arch and runnable shape on a (4, 2) and an (8, 1)
mesh, the reference called with a stand-in object that has ``axis_names``
and ``shape``. ``_flash_attention_triangle`` is held at the reference's own
bar (tests/test_models_smoke.py: rtol 2e-4, atol 2e-5).
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import list_archs
from repro.configs import reduced as jreduced
from repro.distributed import sharding as jshd
from repro.models import attention as jattention
from repro.models import model as jmodel
from repro.models.common import TEST_POLICY as JPOLICY
from repro_torch.configs import get_arch, reduced
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import attention
from repro_torch.models import model as lm
from repro_torch.models.common import TEST_POLICY

ARCHS = list_archs()
MESHES = {"4x2": (4, 2), "8x1": (8, 1)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this file: its tiny ops over many CPU shards
    run no slower on one, and under several test workers a team of threads
    each would crowd the machine's cores (measured: six copies of
    tests/test_torch_mesh_lm.py at once took 479 s on eight threads each,
    21 s on one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _norm(spec) -> tuple:
    """A spec as a plain tuple, a one-axis tuple entry as the axis name (the
    reference's PartitionSpec normalizes it so)."""
    out = []
    for e in tuple(spec):
        out.append(e[0] if isinstance(e, tuple) and len(e) == 1 else e)
    return tuple(out)


def _flat_with_path(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    return {".".join(str(getattr(k, "key", k)) for k in path): leaf for path, leaf in flat}


def test_ten_archs():
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_the_reference(arch):
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jcfg, JPOLICY))
    want = _flat_with_path(jshd.param_pspecs(jcfg, shapes))
    got = shd.param_pspecs(cfg, lm.build(cfg, TEST_POLICY, "meta"))
    assert len(got) == sum(cfg.num_groups if k.startswith("groups.") else 1 for k in want)
    for name, spec in got.items():
        assert isinstance(spec, shd.Spec)
        if name.startswith("groups."):
            _, g, rest = name.split(".", 2)
            ref = _norm(want[f"groups.{rest}"])
            assert ref[0] is None, name
            assert _norm(spec) == ref[1:], name
        else:
            assert _norm(spec) == _norm(want[name]), name
    # the stacked layout is the reference's tree, spec for spec
    stacked = _flat_with_path(shd.stacked(cfg, got))  # a Spec is a leaf to jax.tree
    assert {k: _norm(v) for k, v in stacked.items()} == {k: _norm(v) for k, v in want.items()}


def _stand_in(mesh):
    return SimpleNamespace(axis_names=mesh.axis_names, shape=mesh.shape)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_pspecs_equal_the_reference(arch, mesh_name):
    mesh = make_host_mesh(*MESHES[mesh_name])
    jcfg, cfg = jreduced(jget_arch(arch)), reduced(get_arch(arch))
    jcache = jax.eval_shape(lambda: jmodel.init_cache(jcfg, 1, 8))
    cache = lm.init_cache(cfg, 1, 8, device="cpu")
    for shape in get_arch(arch).runnable_shapes():
        want = jshd.batch_pspecs(jget_arch(arch), shape, _stand_in(mesh))
        got = shd.batch_pspecs(get_arch(arch), shape, mesh)
        assert {k: _norm(v) for k, v in got.items()} == {k: _norm(v) for k, v in want.items()}
        jc = _flat_with_path(jshd.cache_pspecs(jcfg, shape, _stand_in(mesh), jcache))
        tc = shd.cache_pspecs(cfg, shape, mesh, cache)
        assert len(tc) == cfg.num_groups
        for group in tc:
            for layer, state in group.items():
                for name, spec in state.items():
                    ref = _norm(jc[f"{layer}.{name}"])
                    assert ref[0] is None and _norm(spec) == ref[1:], (shape, layer, name)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_the_reference(arch):
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    for shape in cfg.runnable_shapes():
        for dt, jdt in ((torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)):
            want = jcfg.input_specs(shape, jdt)
            got = cfg.input_specs(shape, dt)
            assert list(got) == list(want), shape
            for k, v in got.items():
                assert v.device.type == "meta"
                assert tuple(v.shape) == tuple(want[k].shape), (shape, k)
                assert str(v.dtype).removeprefix("torch.") == str(want[k].dtype), (shape, k)


def test_opt_state_pspecs_mirror_the_params():
    from repro_torch.optim import adamw

    cfg = reduced(get_arch("qwen3-4b"))
    model = lm.build(cfg, TEST_POLICY, "meta")
    specs = shd.opt_state_pspecs(cfg, model, adamw.init(model, adamw.AdamWConfig()))
    assert specs.step == shd.Spec() and specs.mu == specs.nu == shd.param_pspecs(cfg, model)


def test_place_and_gather_round_trip_on_repeated_devices():
    """Every leaf cut by its spec over eight CPU entries (a (2, 2, 2) pod x
    data x model mesh and a (4, 2) one) and gathered back, bit for bit; a
    block lives once, on its first coordinate."""
    cfg = reduced(get_arch("qwen2-moe-a2.7b"))
    model = lm.init(torch.Generator().manual_seed(0), cfg, TEST_POLICY, "cpu")
    named = dict(model.named_parameters())
    for mesh in (make_host_mesh(4, 2),
                 make_mesh((2, 2, 2), ("pod", "data", "model"), devices=["cpu"] * 8)):
        placed = shd.place(mesh, named, shd.param_pspecs(cfg, named))
        back = shd.gather(placed, "cpu")
        for n, x in named.items():
            assert torch.equal(back[n], x), n
        wq = placed["groups.0.layer0.mixer.wq"]  # ("data", "model", None)
        assert len(wq.blocks) == mesh.shape["data"] * mesh.shape["model"]
        assert len(placed["final_norm"].blocks) == 1
        x = named["groups.1.layer0.ffn.wi"]  # (None, "data", "model") over (E, d, 2 f)
        sh = placed["groups.1.layer0.ffn.wi"]
        coord = (1, 1) if mesh.devices.ndim == 2 else (1, 0, 1)
        i, j = sh.index(coord)[1:]
        d, w = x.shape[1] // mesh.shape["data"], x.shape[2] // 2
        assert torch.equal(sh.block(coord), x[:, i * d:(i + 1) * d, j * w:(j + 1) * w])
        part = sh.take("cpu", (None, [(3, 40)], [(5, 9), (100, 120)]))
        assert torch.equal(part, torch.cat([x[:, 3:40, 5:9], x[:, 3:40, 100:120]], dim=-1))
    batch = {"tokens": torch.arange(24).reshape(4, 6), "loss_mask": torch.ones(4, 6)}
    mesh = make_host_mesh(4, 2)
    specs = {k: shd.batch_spec(mesh, 4, v.ndim) for k, v in batch.items()}
    placed = shd.place(mesh, batch, specs)
    assert torch.equal(placed["tokens"].block((2, 1)), batch["tokens"][2:3])
    assert torch.equal(shd.gather(placed)["tokens"], batch["tokens"])


def test_place_raises_on_a_dimension_that_does_not_divide():
    mesh = make_host_mesh(4, 2)
    with pytest.raises(ValueError, match=r"wq: dimension 1 of \(64, 3, 16\) does not divide"):
        shd.place(mesh, {"wq": torch.zeros(64, 3, 16)}, {"wq": shd.Spec("data", "model")})
    with pytest.raises(ValueError, match="axis 'pipe'"):
        shd.place_leaf(mesh, torch.zeros(8), shd.Spec("pipe"))


@pytest.mark.parametrize("window", [0, 50])
def test_flash_attention_triangle_matches_the_reference(window):
    """The causal-skip scan on the same numpy q, k, v as the reference's
    (multi-chunk, fully masked tiles, a window), and the direct softmax."""
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 256, 2, 16)).astype(np.float32) for _ in range(3))
    pos = np.arange(256)
    want = np.asarray(jattention._flash_attention_triangle(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), window, 64))
    got = attention._flash_attention_triangle(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(pos),
        window, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    from repro_torch.kernels.ref import flash_attention_ref

    direct = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), window=window)
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=2e-4, atol=2e-5)
