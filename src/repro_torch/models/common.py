"""Shared model substrate: dtype policy, norms, initializers, positional encodings.

The port's layers are ``nn.Module``s whose parameters carry the JAX
package's names and layouts; the functions that apply them take the module
where the reference takes a params dict. Every random draw comes from an
explicit ``torch.Generator``. The reference's ``constrain_batch`` is a
sharding hint for a device mesh and has no meaning on one card, so it is
not ported.
"""
from __future__ import annotations

import contextlib
import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Policy:
    """Mixed-precision policy: params stored in param_dtype, math in compute_dtype,
    norms/softmax/losses accumulated in f32."""

    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)


TEST_POLICY = Policy()


def normal_init(generator: torch.Generator, shape, dtype, scale: float = 0.02) -> torch.Tensor:
    """scale * N(0, 1) drawn in f32 on the generator's device, cast to dtype."""
    draw = torch.randn(tuple(shape), generator=generator, device=generator.device)
    return (scale * draw).to(dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32, output cast back to the input dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, num_groups: int,
               eps: float) -> torch.Tensor:
    """GroupNorm over the channel dim (RWKV6 wkv output norm). x: (..., C).
    Statistics in f32, the variance biased (jnp.var's), output in x's dtype."""
    *lead, C = x.shape
    xf = x.to(torch.float32).reshape(*lead, num_groups, C // num_groups)
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y.reshape(*lead, C)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor, dim: int,
                         max_scale: float = 10_000.0) -> torch.Tensor:
    """Classic transformer sin/cos table evaluated at `positions` (any int shape).
    Returns (..., dim) f32 (musicgen-style additive embedding)."""
    half = dim // 2
    log_scale = torch.log(torch.tensor(max_scale, dtype=torch.float32))
    steps = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = torch.exp(-log_scale.to(positions.device) * steps / half)
    ang = positions.to(torch.float32)[..., None] * freq  # (..., half)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ------------------------------------------------- loops on ``meta`` tensors

_TRIPS = [1]


def trip_factor() -> int:
    """How many runs the op executing now stands for: the product of the
    enclosing ``repeated`` counts, 1 outside them. A counting mode (the
    dry-run's, ``launch.dryrun``) multiplies each op's flops and bytes by it."""
    return _TRIPS[-1]


@contextlib.contextmanager
def _trips(n: int):
    _TRIPS.append(_TRIPS[-1] * n)
    try:
        yield
    finally:
        _TRIPS.pop()


class _Repeated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, fn, *inputs):
        ctx.n, ctx.fn = n, fn
        ctx.save_for_backward(*inputs)
        with _trips(n):
            return fn(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        xs = [x.detach().requires_grad_(need)
              for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad[2:])]
        want = [x for x in xs if x.requires_grad]
        with torch.enable_grad(), _trips(0):  # the graph again, not counted
            pairs = [(o, g) for o, g in zip(ctx.fn(*xs), grads)
                     if g is not None and o.requires_grad]
        with _trips(ctx.n):
            got = iter(torch.autograd.grad([o for o, _ in pairs], want,
                                           [g for _, g in pairs], allow_unused=True)
                       if pairs and want else [None] * len(want))
        return (None, None, *(next(got) if x.requires_grad else None for x in xs))


def repeated(n: int, fn, *inputs) -> tuple:
    """``fn(*inputs)`` (a tuple of tensors) run once and counted as ``n`` runs
    of a loop body by a mode that reads ``trip_factor``: the counterpart of
    an XLA while loop's known trip count, for the per-token loops of the
    SSM layers on ``meta`` tensors, which hold no values to loop over. Under
    autograd its vector-Jacobian product is counted ``n`` times too (the
    backward rebuilds ``fn``'s graph first, which counts nothing: the loop's
    own backward keeps its forward's graph)."""
    return _Repeated.apply(n, fn, *inputs)
