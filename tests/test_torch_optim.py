"""The port's AdamW and schedules against the JAX package's.

The five cases of tests/test_optim.py run on the port; ``update`` is held
against the reference's over three steps from the same numpy params and
gradients, with f32 moments (params within rtol 1e-6; the moments within
rtol 1e-6 plus the bound ``_moment_bounds`` derives from the global norm's
summation order, in which the two frameworks differ) and with
bf16 moments (moments within one bf16 ulp, since an f32 difference in the
last place can round to the neighbouring bf16 value; params within rtol
1e-5); ``warmup_cosine`` matches the reference's at every step of a run and
past its end within rtol 1e-6 (both compute in f32; the cosine may differ in
the last place). Everything runs on the CPU.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.optim.schedule import constant, warmup_cosine


# ------------------------------------------- the cases of tests/test_optim.py


def test_adamw_minimizes_quadratic():
    cfg = AdamWConfig(lr=0.05, weight_decay=0.0, grad_clip=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    st = adamw.init(params, cfg)
    for _ in range(300):
        g = {"w": 2 * params["w"]}  # grad of sum(w^2)
        params, st, _ = adamw.update(params, g, st, cfg)
    assert float(params["w"].abs().max()) < 1e-2


def test_grad_clip_bounds_update():
    cfg = AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    params = {"w": torch.zeros(3)}
    st = adamw.init(params, cfg)
    _, _, metrics = adamw.update(params, {"w": torch.tensor([1e6, 0.0, 0.0])}, st, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(1e6)


def test_no_decay_for_1d_params():
    cfg = AdamWConfig(lr=0.1, weight_decay=1.0, grad_clip=0.0)
    params = {"scale": torch.ones(4), "w": torch.ones((4, 4))}
    st = adamw.init(params, cfg)
    zero_g = {k: torch.zeros_like(v) for k, v in params.items()}
    p2, _, _ = adamw.update(params, zero_g, st, cfg)
    np.testing.assert_allclose(p2["scale"].numpy(), np.ones(4))  # no decay
    assert float(p2["w"].max()) < 1.0  # decayed


def test_bf16_moments_mode_runs():
    cfg = AdamWConfig(lr=0.05, moments_dtype="bfloat16")
    params = {"w": torch.full((8,), 3.0)}
    st = adamw.init(params, cfg)
    assert st.mu["w"].dtype == torch.bfloat16
    p2, _, _ = adamw.update(params, {"w": 2 * params["w"]}, st, cfg)
    assert float(p2["w"].max()) < 3.0


def test_schedule_shape():
    assert warmup_cosine(0, warmup=10, total=100) == 0.0
    assert warmup_cosine(10, warmup=10, total=100) == pytest.approx(1.0, abs=0.01)
    assert warmup_cosine(100, warmup=10, total=100) == pytest.approx(0.1, abs=0.01)
    assert 0.1 < warmup_cosine(55, warmup=10, total=100) < 1.0
    assert constant(7, value=0.5) == 0.5


# ---------------------------------------------------- against the reference


def _draws(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "t": rng.standard_normal((2, 3, 4)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (0.5, 3.0, 0.01)]
    return params, grads


def _moment_bounds(grads, cfg):
    """Per step, the f32 moments' (mu, nu) difference that the global norm's
    summation order may carry, element by element.

    The two frameworks sum the N squared gradients in different orders; each
    sum is within gamma_{N-1} ~ (N - 1) u of the exact one (u = 2^-24), so
    the two norms, after the square root and the clip's division, differ by
    a relative delta <= (N + 3) u, and so do the clipped gradients c g. With
    the clip equal the update is the reference's bit for bit, so the rest
    propagates: |dmu_t| <= b1 |dmu_{t-1}| + (1 - b1) |c_t g_t| delta and
    |dnu_t| <= b2 |dnu_{t-1}| + (1 - b2) (c_t g_t)^2 2 delta (zero at a step
    whose norm stays under the clip).
    """
    n = sum(v.size for v in grads[0].values())
    delta = (n + 3) * 2.0 ** -24
    mu = {k: 0.0 for k in grads[0]}
    nu = {k: 0.0 for k in grads[0]}
    out = []
    for g in grads:
        norm = np.sqrt(sum(np.sum(np.square(v.astype(np.float64))) for v in g.values()))
        clipped = norm > cfg.grad_clip
        c = min(1.0, cfg.grad_clip / norm)
        for k, v in g.items():
            cg = np.abs(v.astype(np.float64)) * c
            mu[k] = cfg.b1 * mu[k] + (1 - cfg.b1) * cg * (delta if clipped else 0.0)
            nu[k] = cfg.b2 * nu[k] + (1 - cfg.b2) * cg * cg * (2 * delta if clipped else 0.0)
        out.append((dict(mu), dict(nu)))
    return out


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_update_matches_the_reference_over_three_steps(moments):
    """Clipping bites on step 2 (norm above grad_clip); decay skips ``b``;
    the schedule's multiplier changes each step."""
    cfg = AdamWConfig(lr=0.01, weight_decay=0.1, grad_clip=2.0, moments_dtype=moments)
    params, grads = _draws(0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jst, tst = jadamw.init(jp, cfg), adamw.init(tp, cfg)
    bounds = _moment_bounds(grads, cfg)
    for i, g in enumerate(grads):
        scale = [0.5, 1.0, 0.25][i]
        jp, jst, jm = jadamw.update(jp, {k: jnp.asarray(v) for k, v in g.items()}, jst, cfg,
                                    scale)
        tp, tst, tm = adamw.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, tst,
                                   cfg, scale)
        assert int(tst.step) == int(jst.step) == i + 1
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-7)
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6 if moments == "float32" else 1e-5, atol=1e-7)
            pairs = ((tst.mu[k], jst.mu[k]), (tst.nu[k], jst.nu[k]))
            for (mine, ref), bound in zip(pairs, (bounds[i][0][k], bounds[i][1][k])):
                assert mine.dtype == getattr(torch, moments)
                got = mine.float().numpy()
                want = np.asarray(ref.astype(jnp.float32))
                if moments == "float32":
                    err = np.abs(got - want)
                    assert (err <= 1e-6 * np.abs(want) + 1e-12 + bound).all(), err.max()
                else:  # one bf16 ulp (2^-8 relative)
                    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-30)


def test_global_norm_matches_the_reference():
    params, grads = _draws(1)
    g = grads[1]
    np.testing.assert_allclose(
        float(adamw.global_norm({k: torch.from_numpy(v) for k, v in g.items()})),
        float(jadamw.global_norm({k: jnp.asarray(v) for k, v in g.items()})), rtol=1e-6)


def test_update_works_in_place_on_a_module():
    model = torch.nn.Linear(3, 2)
    cfg = AdamWConfig(lr=0.1)
    st = adamw.init(model, cfg)
    assert set(st.mu) == {"weight", "bias"}
    before = model.weight.detach().clone()
    grads = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    out, st, _ = adamw.update(model, grads, st, cfg)
    assert out is model and not torch.equal(model.weight, before)
    assert int(st.step) == 1 and float(st.mu["bias"].abs().max()) > 0


@pytest.mark.parametrize("warmup,total,floor", [(10, 100, 0.1), (2, 20, 0.1), (0, 7, 0.0),
                                                (5, 5, 0.2)])
def test_warmup_cosine_matches_the_reference(warmup, total, floor):
    for step in range(total + 6):
        want = float(jschedule.warmup_cosine(step, warmup=warmup, total=total, floor=floor))
        got = warmup_cosine(step, warmup=warmup, total=total, floor=floor)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=f"step {step}")
    assert constant(3, value=0.3) == float(jschedule.constant(3, value=0.3))
