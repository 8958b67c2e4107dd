"""The port's int8 error-feedback gradient compression against the JAX
package's, and (in the same reference subprocess) its GPipe pipeline.

``_quantize`` is held bit for bit: the scale max|g| / 127, g divided by it,
rounded half to even, clipped to +-127. The DDP step meets the reference's
convergence bars (tests/test_distributed_subprocess.py: final loss < 1e-2,
parameter error < 0.05). ``compressed_psum`` and ``pipelined_apply`` are run
by the JAX package on eight forced host devices in one subprocess (so the
device flag never reaches this process) and by the port over eight CPU
entries of a mesh, on the same numpy inputs: each shard's int8 codes are
the same (the residuals agree to two ulps of max|g + e|: XLA fuses
g - q * scale into one rounding), the mean gradient within rtol 1e-6 (the
reference sums the scales in its own order), the pipeline's output within
1e-5 and its gradient within 1e-4.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.distributed.compression import _quantize as j_quantize
from repro_torch.distributed import compression, pipeline
from repro_torch.launch.mesh import make_host_mesh, make_mesh

REPO = Path(__file__).resolve().parents[1]


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


@pytest.mark.parametrize("case", ["normal", "ties", "zeros", "wide"])
def test_quantize_is_bit_for_bit_the_reference(case):
    rng = np.random.default_rng(3)
    g = {"normal": rng.standard_normal(4099).astype(np.float32) * 0.37,
         # max 127: g / scale lands exactly on .5 ties, rounded half to even
         "ties": np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5], np.float32),
         "zeros": np.zeros(16, np.float32),
         "wide": (rng.standard_normal(513) * np.logspace(-8, 8, 513)).astype(np.float32)}[case]
    jq, js = j_quantize(jnp.asarray(g))
    q, s = compression._quantize(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert s.numpy().tobytes() == np.asarray(js).tobytes()


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**31 - 1), st.floats(1e-3, 1e3))
def test_int8_quantizer_error_bound(seed, scale):
    """The port of tests/test_train_features.py::test_int8_quantizer_error_bound."""
    g = torch.randn(64, generator=torch.Generator().manual_seed(seed)) * scale
    q, s = compression._quantize(g)
    recon = q.to(torch.float32) * s
    # symmetric int8: |err| <= scale/2 per element (round-to-nearest)
    assert float(torch.max(torch.abs(recon - g))) <= float(s) / 2 + 1e-6
    assert q.dtype == torch.int8


def test_compressed_ddp_converges():
    """The reference's check_compressed_ddp_converges on an (8, 1) mesh of CPU
    shards: least squares towards arange(8), SGD at 0.05, 150 steps of
    64-row batches split eight ways, int8 gradients with error feedback."""
    mesh = make_host_mesh(8, 1)
    target = torch.arange(8.0)

    def loss_fn(params, batch):
        return torch.mean((batch @ params - batch @ target) ** 2)

    def opt_update(params, grads, opt_state):
        return params - 0.05 * grads, opt_state

    step = compression.make_ddp_compressed_step(mesh, loss_fn, opt_update, axes=("data",))
    params = torch.zeros(8)
    err = compression.init_error_state(params)
    rng = np.random.default_rng(0)
    for _ in range(150):
        batch = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
        params, _, err, loss = step(params, None, err, batch)
    assert len(err) == 8
    assert float(loss) < 1e-2
    assert float(torch.max(torch.abs(params - target))) < 0.05


_REFERENCE = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, sys.argv[1])
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.compat import shard_map
from repro.distributed.compression import compressed_psum
from repro.distributed.pipeline import pipelined_apply
from repro.launch.mesh import make_mesh

a = np.load(sys.argv[2])
mesh = make_mesh((8, 1), ("data", "model"))

def body(g, e):
    mean, err = compressed_psum({"a": g["a"][0], "b": g["b"][0]},
                                {"a": e["a"][0], "b": e["b"][0]}, ("data",))
    return jax.tree.map(lambda x: x[None], mean), jax.tree.map(lambda x: x[None], err)

g = {"a": jnp.asarray(a["ga"]), "b": jnp.asarray(a["gb"])}
e = {"a": jnp.asarray(a["ea"]), "b": jnp.asarray(a["eb"])}
with mesh:
    mean, err = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("data"), P("data")),
                                  out_specs=(P("data"), P("data")), check_vma=False))(g, e)
pmesh = make_mesh((4, 2), ("pipe", "model"))
stage = lambda W, x: jnp.tanh(x @ W)
Ws, x = jnp.asarray(a["Ws"]), jnp.asarray(a["x"])
with pmesh:
    out = pipelined_apply(pmesh, stage, Ws, x)
    grad = jax.grad(lambda W: jnp.sum(pipelined_apply(pmesh, stage, W, x) ** 2))(Ws)
np.savez(sys.argv[3], mean_a=np.asarray(mean["a"]), mean_b=np.asarray(mean["b"]),
         err_a=np.asarray(err["a"]), err_b=np.asarray(err["b"]), out=np.asarray(out),
         grad=np.asarray(grad), devices=np.int64(len(jax.devices())))
"""


def test_compressed_psum_and_pipeline_match_the_reference_on_8_devices(tmp_path):
    rng = np.random.default_rng(11)
    inputs = dict(ga=rng.standard_normal((8, 300)).astype(np.float32),
                  gb=(rng.standard_normal((8, 5, 7)) * 1e-3).astype(np.float32),
                  ea=(rng.standard_normal((8, 300)) * 1e-2).astype(np.float32),
                  eb=np.zeros((8, 5, 7), np.float32),
                  Ws=(rng.standard_normal((4, 16, 16)) * 0.3).astype(np.float32),
                  x=rng.standard_normal((6, 8, 16)).astype(np.float32))
    np.savez(tmp_path / "in.npz", **inputs)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, str(REPO / "src"),
                           str(tmp_path / "in.npz"), str(tmp_path / "out.npz")],
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    want = np.load(tmp_path / "out.npz")
    assert int(want["devices"]) == 8

    devices = [torch.device("cpu")] * 8
    grads = [{"a": torch.from_numpy(inputs["ga"][s]), "b": torch.from_numpy(inputs["gb"][s])}
             for s in range(8)]
    errs = [{"a": torch.from_numpy(inputs["ea"][s]), "b": torch.from_numpy(inputs["eb"][s])}
            for s in range(8)]
    means, new_err = compression.compressed_psum(grads, errs, devices)
    for s in range(8):
        for k in ("a", "b"):
            np.testing.assert_allclose(means[s][k].numpy(), want[f"mean_{k}"][s], rtol=1e-6,
                                       atol=0)
            g32 = inputs[f"g{k}"][s] + inputs[f"e{k}"][s]
            np.testing.assert_allclose(new_err[s][k].numpy(), want[f"err_{k}"][s], rtol=0,
                                       atol=2 * np.spacing(np.abs(g32).max()))

    mesh = make_mesh((4, 2), ("pipe", "model"), devices=["cpu"] * 8)
    Ws = torch.from_numpy(inputs["Ws"]).requires_grad_(True)
    x = torch.from_numpy(inputs["x"])
    out = pipeline.pipelined_apply(mesh, lambda W, h: torch.tanh(h @ W), Ws, x)
    (grad,) = torch.autograd.grad(torch.sum(out ** 2), Ws)
    np.testing.assert_allclose(out.detach().numpy(), want["out"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(grad.numpy(), want["grad"], rtol=0, atol=1e-4)
