"""The port's GPipe pipeline (``distributed.pipeline.pipelined_apply``) over a
``pipe`` axis of CPU shards against the unpipelined chain of stages, at the
reference's bars (tests/test_distributed_subprocess.py: output error
< 1e-5, gradient error < 1e-4); against the reference's own
``pipelined_apply`` in tests/test_torch_compression.py's subprocess."""
import numpy as np
import pytest
import torch

from repro_torch.distributed.pipeline import pipelined_apply
from repro_torch.launch.mesh import make_mesh


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


def _chain(stage_fn, Ws, x):
    for s in range(Ws.shape[0]):
        x = stage_fn(Ws[s], x)
    return x


def _setup(n_stages=4, M=6, mb=8, d=16):
    rng = np.random.default_rng(7)
    Ws = torch.from_numpy((rng.standard_normal((n_stages, d, d)) * 0.3).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((M, mb, d)).astype(np.float32))
    mesh = make_mesh((n_stages, 2), ("pipe", "model"), devices=["cpu"] * (2 * n_stages))
    return mesh, Ws, x


def test_pipeline_matches_unpipelined_output_and_gradient():
    mesh, Ws, x = _setup()

    def stage_fn(W, h):
        return torch.tanh(h @ W)

    got = pipelined_apply(mesh, stage_fn, Ws, x)
    assert float((got - _chain(stage_fn, Ws, x)).abs().max()) < 1e-5
    W1, W2 = Ws.clone().requires_grad_(True), Ws.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(torch.sum(pipelined_apply(mesh, stage_fn, W1, x) ** 2), W1)
    (g_ref,) = torch.autograd.grad(torch.sum(_chain(stage_fn, W2, x) ** 2), W2)
    assert float((g - g_ref).abs().max()) < 1e-4


def test_pipeline_schedule_fill_steady_drain():
    """Stage s takes microbatch m at tick t = s + m: M + P - 1 ticks (fill,
    steady, drain), a pytree of stage params."""
    mesh, Ws, x = _setup(n_stages=4, M=3)
    seen = []

    def stage_fn(p, h):
        seen.append(int(p["id"]))
        return torch.tanh(h @ p["W"])

    got = pipelined_apply(mesh, stage_fn, {"W": Ws, "id": torch.arange(4)}, x)
    # ticks 0..5 run stages (0), (0, 1), (0, 1, 2), (1, 2, 3), (2, 3), (3)
    assert seen == [0, 0, 1, 0, 1, 2, 1, 2, 3, 2, 3, 3]
    np.testing.assert_allclose(got.numpy(), _chain(lambda W, h: torch.tanh(h @ W), Ws, x).numpy(),
                               atol=1e-6)
