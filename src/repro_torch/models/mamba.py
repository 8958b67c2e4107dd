"""Mamba-1 selective SSM block (Jamba's mixer).

  * the selective scan is a loop over time (the reference's ``lax.scan``)
    whose step builds the discretization exp(dt_t * A) (B, d_inner, N) inside
    it: the (B, S, d_inner, N) tensor is never materialized (2 GB a layer per
    1,024 tokens at Jamba's width, batch 1, f32);
  * the depthwise causal conv is ``F.conv1d(groups=d_inner)`` on (B, di, S),
    padded on the left by conv_w - 1: a cross-correlation, as the
    reference's ``lax.conv_general_dilated``, so the taps are not flipped;
  * decode carries (conv window, ssm state h): O(1) per token.

State layout: h (B, d_inner, N) f32; conv window (B, conv_w - 1, d_inner)
in the cache dtype. ``mix_in`` / ``mix_out`` are the block's two halves
around its one sum over d_inner (``x_proj``), where a device mesh sums its
model shards' parts. On a card the loop runs as plain ``torch`` ops, a few
small launches a token (ROADMAP.md Queue 2 B14 holds the scan kernel).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Policy, normal_init, repeated, silu

#: The dtype prefill leaves the conv window in, as the reference's cache holds it.
CACHE_DTYPE = torch.bfloat16


class Mamba(nn.Module):
    """Parameters in the reference's layouts: ``in_proj`` (d, 2 di),
    ``conv_w`` (W, di), ``conv_b`` (di,), ``x_proj`` (di, r + 2 N),
    ``dt_proj`` (r, di), ``dt_bias`` (di,), ``A_log`` (di, N) f32, ``D``
    (di,), ``out_proj`` (di, d). Allocated empty; ``init`` draws them."""

    def __init__(self, cfg: ArchConfig, policy: Policy, device=None):
        super().__init__()
        d, di, N = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
        r = cfg.resolved_dt_rank
        shapes = {"in_proj": (d, 2 * di), "conv_w": (cfg.ssm_conv, di), "conv_b": (di,),
                  "x_proj": (di, r + 2 * N), "dt_proj": (r, di), "dt_bias": (di,),
                  "A_log": (di, N), "D": (di,), "out_proj": (di, d)}
        for name, shape in shapes.items():
            dtype = torch.float32 if name == "A_log" else policy.param_dtype
            setattr(self, name, nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                             requires_grad=False))


def init(generator: torch.Generator, cfg: ArchConfig, policy: Policy, device=None) -> Mamba:
    p = Mamba(cfg, policy, device)
    dt = policy.param_dtype
    W, r = cfg.ssm_conv, cfg.resolved_dt_rank
    p.in_proj.copy_(normal_init(generator, p.in_proj.shape, dt))
    p.conv_w.copy_(normal_init(generator, p.conv_w.shape, dt, scale=0.5 / W))
    p.conv_b.zero_()
    p.x_proj.copy_(normal_init(generator, p.x_proj.shape, dt))
    p.dt_proj.copy_(normal_init(generator, p.dt_proj.shape, dt, scale=r ** -0.5))
    # softplus^-1(0.01), computed in f32 as the reference computes it
    p.dt_bias.fill_(float(torch.log(torch.expm1(torch.tensor(0.01)))))
    # S4D-real initialization for A: A_n = -(n + 1)
    p.A_log.copy_(torch.log(torch.arange(1, cfg.ssm_state + 1, dtype=torch.float32)))
    p.D.fill_(1.0)
    p.out_proj.copy_(normal_init(generator, p.out_proj.shape, dt,
                                 scale=0.02 / (2 * cfg.num_layers) ** 0.5))
    return p


def _split_proj(p: Mamba, policy: Policy, x: torch.Tensor):
    """x (B, S, d) -> xb (B, S, di) pre-conv branch, z (B, S, di) gate branch."""
    return torch.chunk(x @ policy.cast(p.in_proj), 2, dim=-1)


def _conv_full(p: Mamba, cfg: ArchConfig, policy: Policy, xb: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the whole sequence. xb (B, S, di)."""
    w = policy.cast(p.conv_w)  # (W, di)
    di = xb.shape[-1]
    out = F.conv1d(F.pad(xb.transpose(1, 2), (cfg.ssm_conv - 1, 0)), w.T[:, None, :],
                   groups=di)  # (B, di, S)
    return out.transpose(1, 2) + policy.cast(p.conv_b)


def _ssm_inputs(p: Mamba, cfg: ArchConfig, policy: Policy, xc: torch.Tensor):
    """xc (B, S, di) post-conv -> dt (B, S, di) f32, Bm, Cm (B, S, N) f32."""
    return _dt_bc(p, cfg, policy, xc @ policy.cast(p.x_proj))


def _dt_bc(p: Mamba, cfg: ArchConfig, policy: Policy, proj: torch.Tensor):
    """``_ssm_inputs`` from the x_proj output proj (B, S, r + 2N)."""
    N, r = cfg.ssm_state, cfg.resolved_dt_rank
    dt_low, Bm, Cm = torch.split(proj, [r, N, N], dim=-1)
    dt = F.softplus((dt_low @ policy.cast(p.dt_proj)).to(torch.float32)
                    + p.dt_bias.to(torch.float32))
    return dt, Bm.to(torch.float32), Cm.to(torch.float32)


def _step(h, A, xt, dtt, Bt):
    """h (B, di, N) f32 one token on: exp(dt A) h + (dt x) B."""
    dA = torch.exp(dtt[..., None] * A)  # (B, di, N): built a step at a time
    return dA * h + (dtt * xt)[..., None] * Bt[:, None, :]


def _scan_step(h, A, xt, dtt, Bt, Ct):
    h = _step(h, A, xt, dtt, Bt)
    return torch.einsum("bdn,bn->bd", h, Ct), h


def _scan(cfg: ArchConfig, xc, dt, Bm, Cm, A) -> tuple[torch.Tensor, torch.Tensor]:
    """The selective scan from h = 0: ys (B, S, di) f32 and the final h. On
    ``meta`` (the dry-run) one step stands for all S, counted S times
    (``common.repeated``)."""
    B, S, di = xc.shape
    h = torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32, device=xc.device)
    xf = xc.to(torch.float32)
    if xc.device.type == "meta":
        y, h = repeated(S, _scan_step, h, A, xf[:, 0], dt[:, 0], Bm[:, 0], Cm[:, 0])
        return y[:, None].expand(B, S, di).contiguous(), h  # the layout of the loop's stack
    ys = []
    for t in range(S):
        y, h = _scan_step(h, A, xf[:, t], dt[:, t], Bm[:, t], Cm[:, t])
        ys.append(y)
    return torch.stack(ys, dim=1), h


def _finish(p: Mamba, policy: Policy, x, y, xc, z) -> torch.Tensor:
    y = y.to(x.dtype) + xc * policy.cast(p.D)
    return (y * silu(z)) @ policy.cast(p.out_proj)


def mix_in(p: Mamba, cfg: ArchConfig, policy: Policy, x: torch.Tensor, state: dict | None = None):
    """The block up to ``x_proj`` on x (B, S, d): (ctx, proj), proj (B, S,
    r + 2N) the x_proj output. It is a sum over d_inner, so a ``p`` holding a
    slice of d_inner (a model shard's, ``distributed.parallel``) gives a
    part of it, and the parts are summed before ``mix_out``. With ``state``
    one decode step: the conv over the carried window."""
    xb, z = _split_proj(p, policy, x)  # (B, S, di)
    if state is None:
        xc = silu(_conv_full(p, cfg, policy, xb))
        tail = xb
    else:
        tail = torch.cat([state["conv"].to(xb.dtype), xb], dim=1)  # (B, W, di)
        xc = torch.einsum("bwd,wd->bd", tail, policy.cast(p.conv_w)) + policy.cast(p.conv_b)
        xc = silu(xc)[:, None, :]  # (B, 1, di)
    return (x, tail, z, xc), xc @ policy.cast(p.x_proj)


def mix_out(p: Mamba, cfg: ArchConfig, policy: Policy, ctx: tuple, proj: torch.Tensor,
            state: dict | None = None) -> tuple[torch.Tensor, dict]:
    """The block from ``x_proj``'s output on: dt, the scan (one step with
    ``state``), the gate and ``out_proj``. Returns (out (B, S, d), the decode
    state after the last token): the final h and the last conv_w - 1
    pre-conv inputs, zero-padded on the left when the sequence is shorter."""
    x, tail, z, xc = ctx
    dt, Bm, Cm = _dt_bc(p, cfg, policy, proj)
    A = -torch.exp(p.A_log)
    if state is None:
        ys, h = _scan(cfg, xc, dt, Bm, Cm, A)
        W1 = cfg.ssm_conv - 1
        conv = F.pad(tail, (0, 0, max(0, W1 - tail.shape[1]), 0))[:, -W1:, :].to(CACHE_DTYPE)
    else:
        h = _step(state["h"], A, xc[:, 0].to(torch.float32), dt[:, 0], Bm[:, 0])
        ys = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None, :]
        conv = tail[:, 1:, :].to(state["conv"].dtype)
    return _finish(p, policy, x, ys, xc, z), {"h": h, "conv": conv}


def fwd_full(p: Mamba, cfg: ArchConfig, policy: Policy, x: torch.Tensor) -> torch.Tensor:
    """Training / prefill path: the scan over time. x (B, S, d)."""
    return mix_out(p, cfg, policy, *mix_in(p, cfg, policy, x))[0]


def fwd_prefill(p: Mamba, cfg: ArchConfig, policy: Policy,
                x: torch.Tensor) -> tuple[torch.Tensor, dict]:
    """``fwd_full`` and the decode state after the sequence: the final h of
    the same loop (the reference runs the scan a second time for it, the
    same step on the same inputs) and the last conv_w - 1 pre-conv inputs."""
    return mix_out(p, cfg, policy, *mix_in(p, cfg, policy, x))


def init_state(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    return {
        "h": torch.zeros((batch, cfg.ssm_d_inner, cfg.ssm_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.ssm_d_inner), dtype=dtype,
                            device=device),
    }


def fwd_decode(p: Mamba, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
               state: dict) -> tuple[torch.Tensor, dict]:
    """One decode step. x (B, 1, d); state = {h, conv}. Returns a new state."""
    return mix_out(p, cfg, policy, *mix_in(p, cfg, policy, x, state), state)
