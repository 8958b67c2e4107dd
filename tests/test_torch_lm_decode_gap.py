"""Decode against prefill, in the port and in the JAX package, on the same weights.

A prefill over the prompt's first S - 1 tokens and one decode step of the
last token give the last position's logits that a full prefill gives, up to
the bf16 rounding of the cached k, v (both packages store the cache in bf16
under an f32 policy). That gap grows with width and depth; the reference
bounds it at 2e-3 on its 2-layer reduced models. Here, at three sizes of
qwen1.5-0.5b cut in width, depth and vocabulary, the port's gap must equal
the reference's within the logits' tolerance (rtol 1e-4 / atol 1e-5 on each
side), so the gap is the reference's own and not the port's.

    PYTHONPATH=src python -m pytest -q -s tests/test_torch_lm_decode_gap.py   # prints the gaps
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import model as jmodel
from repro.models.common import TEST_POLICY as JPOLICY
from repro_torch.configs import get_arch, reduced
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import model as tmodel
from repro_torch.models.common import TEST_POLICY

SIZES = {
    "reduced": {},
    "d256-l8": dict(num_layers=8, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
                    d_ff=704, vocab_size=2048),
    "d512-l12": dict(num_layers=12, d_model=512, num_heads=8, num_kv_heads=8, head_dim=64,
                     d_ff=1408, vocab_size=4096),
}


@pytest.mark.parametrize("size", list(SIZES))
def test_decode_vs_prefill_gap_matches_jax(size):
    jcfg = dataclasses.replace(jreduced(jget_arch("qwen1.5-0.5b")), **SIZES[size])
    tcfg = dataclasses.replace(reduced(get_arch("qwen1.5-0.5b")), **SIZES[size])
    params = jmodel.init(jax.random.PRNGKey(0), jcfg, JPOLICY)
    tm = lm_params_from_numpy(jax.tree.map(np.asarray, params), tcfg, device="cpu")
    toks = np.random.default_rng(0).integers(1, jcfg.vocab_size, (2, 16)).astype(np.int32)

    full, _ = jmodel.forward_prefill(params, jcfg, JPOLICY, {"tokens": jnp.asarray(toks)})
    _, cache = jmodel.forward_prefill(params, jcfg, JPOLICY, {"tokens": jnp.asarray(toks[:, :-1])})
    cache = jax.tree.map(
        lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))) if x.ndim == 5 else x,
        cache)
    step, _ = jmodel.forward_decode(params, jcfg, JPOLICY, {"tokens": jnp.asarray(toks[:, -1:])},
                                    cache, jnp.asarray(15, jnp.int32))
    gap_ref = float(jnp.max(jnp.abs(full - step)))

    t = torch.from_numpy(toks)
    with torch.inference_mode():
        tfull, _ = tmodel.forward_prefill(tm, tcfg, TEST_POLICY, {"tokens": t})
        _, tcache = serve.prefill(tm, tcfg, TEST_POLICY, {"tokens": t[:, :-1]}, 16)
        tstep, _ = tmodel.forward_decode(tm, tcfg, TEST_POLICY, {"tokens": t[:, -1:]}, tcache, 15)
    gap_port = float((tfull - tstep).abs().max())

    scale = float(jnp.max(jnp.abs(full)))
    print(f"\n[{size}] decode-vs-prefill gap: reference {gap_ref:.3e}, port {gap_port:.3e}, "
          f"max|logit| {scale:.3f}")
    assert abs(gap_port - gap_ref) <= 2 * (1e-5 + 1e-4 * scale)
