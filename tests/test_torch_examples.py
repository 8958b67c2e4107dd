"""The port's documented entry points, ``examples/torch_*.py``, on the CPU.

Each script's ``main(argv)`` runs in-process with ``--device cpu`` at its CI
size (``--smoke`` where the reference script has the flag; the quickstarts
are CI-sized as they are; ``torch_train_lm.py`` gets small explicit flags
and a temporary checkpoint directory) and the invariants it prints are held:
identical predictions after the save/load round trip, served labels equal to
the fit labels on the fitted rows, a falling loss in both training scripts,
and an NMI at or above the reference script's own CPU NMI less 0.02 (the
port's draws differ from ``jax.random``'s by construction; ROADMAP.md's
rule on the draws). The activation example's ``hidden_states`` is held
against the reference example's on parameters carried across by
``repro_torch.convert``, at test_torch_lm's tolerance.
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import model as jmodel
from repro.models.common import TEST_POLICY as JPOLICY
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.data.tokens import synthetic_batch

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = ("torch_quickstart", "torch_stream_quickstart", "torch_covtype_scale",
           "torch_activation_clustering", "torch_train_lm")
#: The reference scripts' NMI on the CPU, as they print it (three places):
#: ``python examples/quickstart.py``, ``python examples/stream_quickstart.py``,
#: ``python examples/covtype_scale.py --smoke`` and
#: ``python examples/activation_clustering.py --smoke``, PYTHONPATH=src.
REFERENCE_NMI = {"torch_quickstart": 1.000, "torch_stream_quickstart": 1.000,
                 "torch_covtype_scale": 0.975, "torch_activation_clustering": 0.124}
NMI_SLACK = 0.02
TOL = dict(rtol=1e-4, atol=1e-5)  # tests/test_torch_lm.py's


@pytest.fixture
def one_thread():
    """One intra-op thread: the scripts' ops are small, and a team of threads
    a test worker, beside the other workers, only slows them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    path = REPO / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    try:
        spec.loader.exec_module(module)
    finally:
        sys.modules.pop(spec.name, None)
    return module


@pytest.mark.parametrize("name,backend", [("torch_quickstart", "local"),
                                          ("torch_stream_quickstart", "stream")])
def test_quickstart_round_trip_and_serving(name, backend, one_thread, capsys):
    out = _script(name).main(["--device", "cpu"])
    assert out["backend"] == backend
    assert out["served"] == out["served_match_fit"] == out["replay_identical"] == 200
    assert out["nmi"] >= REFERENCE_NMI[name] - NMI_SLACK
    printed = capsys.readouterr().out
    assert "200/200 identical predictions" in printed and "200/200 match fit labels" in printed


def test_covtype_scale_sweeps_an_int8_cache_over_two_shards(one_thread):
    out = _script("torch_covtype_scale").main(["--smoke", "--device", "cpu"])
    assert out["backend"] == "stream_shard" and out["devices"] == 2
    assert out["cache_compression_ratio"] == pytest.approx(4.0, rel=1e-3)
    assert out["cache_bytes_staged"] > 0
    assert out["best_k"] in (6, 7, 8)
    assert out["nmi"] >= REFERENCE_NMI["torch_covtype_scale"] - NMI_SLACK
    assert sum(out["predict_sizes"]) == 4096


def test_activation_clustering_trains_and_clusters(one_thread):
    out = _script("torch_activation_clustering").main(["--smoke", "--device", "cpu"])
    assert out["steps"] == 8 and out["loss_last"] < out["loss_first"]
    assert all(np.isfinite(out["losses"]))
    assert out["backend"] == "local" and out["states"] == 16 * 64
    assert sum(out["cluster_sizes"]) == 16 * 64 and sum(out["assigned_sizes"]) == 4 * 64
    assert out["nmi"] >= REFERENCE_NMI["torch_activation_clustering"] - NMI_SLACK


def test_train_lm_trains_and_checkpoints(tmp_path, one_thread):
    ckpt = tmp_path / "ckpt"
    out = _script("torch_train_lm").main(["--device", "cpu", "--steps", "8", "--d-model", "64",
                                          "--layers", "2", "--batch", "2", "--seq", "32",
                                          "--ckpt", str(ckpt)])
    assert out["last_step"] == 7 and out["loss_last"] < out["loss_first"]
    assert (ckpt / "step_00000008").is_dir() and (ckpt / "metrics.jsonl").is_file()


@pytest.mark.parametrize("name", SCRIPTS)
def test_scripts_default_to_the_card(name, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    argv = ["--ckpt", str(tmp_path / "ckpt")] if name == "torch_train_lm" else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _script(name).main(argv)


def test_hidden_states_match_the_reference_example(one_thread):
    """The port's ``hidden_states`` (the groups' ``nn.ModuleList`` through
    ``apply_group_full``) against the reference example's (its private
    ``model._scan_groups_full``) on the same parameters and tokens."""
    ref = _script("activation_clustering")
    port = _script("torch_activation_clustering")
    jcfg, tcfg = jreduced(jget_arch("qwen3-4b")), reduced(get_arch("qwen3-4b"))
    jparams = jmodel.init(jax.random.PRNGKey(0), jcfg, JPOLICY)
    tparams = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    batch = synthetic_batch(tcfg, 999, 2, 32)
    want = ref.hidden_states(jparams, jcfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got = port.hidden_states(tparams, tcfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (2, 32, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
