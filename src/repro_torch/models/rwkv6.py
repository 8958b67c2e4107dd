"""RWKV-6 "Finch" block: data-dependent-decay linear attention (arXiv:2404.05892).

Time-mix (wkv6):
    ddlerp token-shift produces per-projection inputs x_r/k/v/w/g via a low-rank
    data-dependent mix; decay w_t = exp(-exp(w0 + lora_w(x_w))) is PER-TOKEN;
    per head of size hs:  y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),
                          S_t = diag(w_t) S_{t-1} + k_t v_t^T.
Channel-mix: token-shifted squared-relu gated FFN.

The wkv "attention dim" is Hp * hs, Hp = cfg.phys_heads the padded head count
of the reference's tensor-parallel layout (40 -> 48 for rwkv6-3b). Padded
heads are zero-initialized and masked after the group norm, so the function
is exact and the parameters convert one to one.

The recurrence is a loop over time carrying S (B, Hp, hs, hs) f32, the
reference's ``lax.scan``: on a card plain ``torch`` ops, a few small
launches a token (ROADMAP.md Queue 2 B14 holds the WKV kernel).
``WKV_CHUNK`` > 0 switches the full-sequence path to the chunkwise form
``_wkv_chunked``; it is off by default, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import Policy, group_norm, normal_init, repeated, silu

_LORA = 32  # low-rank dim of the ddlerp mixers
_LORA_W = 64  # low-rank dim of the decay lora
#: The dtype prefill leaves x_tmix and x_cmix in, as the reference's cache holds them.
CACHE_DTYPE = torch.bfloat16


def _att_dim(cfg: ArchConfig) -> int:
    return cfg.phys_heads * cfg.rwkv_head_size


def _rwkv_head_mask(cfg: ArchConfig, dtype, device=None) -> torch.Tensor | None:
    Hp, H = cfg.phys_heads, cfg.rwkv_num_heads
    if Hp == H:
        return None
    return (torch.arange(Hp, device=device) < H).to(dtype)


class TimeMix(nn.Module):
    """The reference's ``init_tmix`` tree: ``mu_x`` (1, 1, d), ``mu`` (5, 1,
    1, d), ``lora_A`` (d, 160), ``lora_B`` (5, 32, d), ``wr``/``wk``/``wv``/
    ``wg`` (d, a), ``wo`` (a, d), ``w0`` (a,) f32, ``wA`` (d, 64), ``wB``
    (64, a), ``u`` (Hp, hs) f32, ``ln_scale``/``ln_bias`` (a,); a = Hp hs.
    Allocated empty; ``init_tmix`` draws them."""

    def __init__(self, cfg: ArchConfig, policy: Policy, device=None):
        super().__init__()
        d, a = cfg.d_model, _att_dim(cfg)
        shapes = {"mu_x": (1, 1, d), "mu": (5, 1, 1, d), "lora_A": (d, 5 * _LORA),
                  "lora_B": (5, _LORA, d), "wr": (d, a), "wk": (d, a), "wv": (d, a),
                  "wg": (d, a), "wo": (a, d), "w0": (a,), "wA": (d, _LORA_W),
                  "wB": (_LORA_W, a), "u": (cfg.phys_heads, cfg.rwkv_head_size),
                  "ln_scale": (a,), "ln_bias": (a,)}
        for name, shape in shapes.items():
            dtype = torch.float32 if name in ("w0", "u") else policy.param_dtype
            setattr(self, name, nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                                             requires_grad=False))


class ChannelMix(nn.Module):
    """The reference's ``init_cmix`` tree: ``mu_k``/``mu_r`` (1, 1, d),
    ``wk`` (d, f), ``wv`` (f, d), ``wr`` (d, d). Allocated empty;
    ``init_cmix`` draws them."""

    def __init__(self, cfg: ArchConfig, policy: Policy, device=None):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff
        for name, shape in {"mu_k": (1, 1, d), "mu_r": (1, 1, d), "wk": (d, f), "wv": (f, d),
                            "wr": (d, d)}.items():
            setattr(self, name, nn.Parameter(
                torch.empty(shape, dtype=policy.param_dtype, device=device), requires_grad=False))


def init_tmix(generator: torch.Generator, cfg: ArchConfig, policy: Policy,
              device=None) -> TimeMix:
    p = TimeMix(cfg, policy, device)
    dt = policy.param_dtype
    mask = _rwkv_head_mask(cfg, torch.float32, p.wr.device)
    col_mask = None if mask is None else torch.repeat_interleave(mask, cfg.rwkv_head_size)

    def draw(param, scale=0.02, masked=False):
        w = normal_init(generator, param.shape, dt, scale=scale).to(param.device)
        if masked and col_mask is not None:  # zero-init the padded heads' columns
            w = (w * col_mask).to(dt)
        param.copy_(w)

    draw(p.mu_x, 0.1)
    draw(p.mu, 0.1)
    draw(p.lora_A)
    draw(p.lora_B, 0.01)
    for w in (p.wr, p.wk, p.wv, p.wg):
        draw(w, masked=True)
    draw(p.wo, 0.02 / (2 * cfg.num_layers) ** 0.5)
    p.w0.fill_(-6.0)
    draw(p.wA)
    draw(p.wB, 0.01)
    p.u.copy_(normal_init(generator, p.u.shape, torch.float32, scale=0.5))
    p.ln_scale.fill_(1.0)
    p.ln_bias.zero_()
    return p


def init_cmix(generator: torch.Generator, cfg: ArchConfig, policy: Policy,
              device=None) -> ChannelMix:
    p = ChannelMix(cfg, policy, device)
    dt = policy.param_dtype
    for name in ("mu_k", "mu_r"):
        getattr(p, name).copy_(normal_init(generator, getattr(p, name).shape, dt, scale=0.1))
    p.wk.copy_(normal_init(generator, p.wk.shape, dt))
    p.wv.copy_(normal_init(generator, p.wv.shape, dt, scale=0.02 / (2 * cfg.num_layers) ** 0.5))
    p.wr.copy_(normal_init(generator, p.wr.shape, dt))
    return p


def _shift(x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) shifted one token right, zeros at position 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def _ddlerp(p: TimeMix, policy: Policy, x: torch.Tensor, x_prev: torch.Tensor):
    """Data-dependent token-shift: returns (x_r, x_k, x_v, x_w, x_g)."""
    dx = x_prev - x  # (B, S, d)
    xxx = x + dx * policy.cast(p.mu_x)
    lora = torch.tanh(xxx @ policy.cast(p.lora_A))  # (B, S, 5 * LORA)
    B_, S_, _ = lora.shape
    lora = lora.reshape(B_, S_, 5, _LORA)
    mix = policy.cast(p.mu) + torch.einsum("bsfr,frd->fbsd", lora,
                                           policy.cast(p.lora_B))  # (5, B, S, d)
    return tuple(x + dx * mix[i] for i in range(5))


def _wkv_inputs(p: TimeMix, cfg: ArchConfig, policy: Policy, x, x_prev):
    """r, k, v, w (B, S, Hp, hs) (w the per-token decay in (0, 1), f32) and
    the gate g (B, S, a); Hp the heads ``p`` holds (all, or a model
    shard's)."""
    Hp, hs = p.u.shape[0], cfg.rwkv_head_size
    B, S, _ = x.shape
    x_r, x_k, x_v, x_w, x_g = _ddlerp(p, policy, x, x_prev)
    r = (x_r @ policy.cast(p.wr)).reshape(B, S, Hp, hs)
    k = (x_k @ policy.cast(p.wk)).reshape(B, S, Hp, hs)
    v = (x_v @ policy.cast(p.wv)).reshape(B, S, Hp, hs)
    g = silu(x_g @ policy.cast(p.wg))  # (B, S, a)
    wlog = p.w0.to(torch.float32) + (
        torch.tanh(x_w @ policy.cast(p.wA)) @ policy.cast(p.wB)).to(torch.float32)
    w = torch.exp(-torch.exp(wlog)).reshape(B, S, Hp, hs)
    return r, k, v, g, w


def _wkv_step(S_state, r_t, k_t, v_t, w_t, u):
    """One recurrence step. S_state (B, Hp, hs, hs) [key x value], all f32."""
    kv = k_t[..., :, None] * v_t[..., None, :]  # (B, Hp, hs, hs)
    y = torch.einsum("bhk,bhkv->bhv", r_t, S_state + u[None, :, :, None] * kv)
    S_new = w_t[..., :, None] * S_state + kv
    return S_new, y


def _finish_tmix(p: TimeMix, cfg: ArchConfig, policy: Policy, y, g, h0: int = 0) -> torch.Tensor:
    """group-norm + pad-mask + gate + out-projection. y (B, S, a), the heads
    [h0, h0 + Hs) that ``p`` holds; with a model shard's heads the output is
    its part of the out-projection's sum."""
    Hs = p.u.shape[0]
    y = group_norm(y, p.ln_scale, p.ln_bias, Hs, 64e-5)
    mask = _rwkv_head_mask(cfg, y.dtype, y.device)
    if mask is not None:
        mask = mask[h0:h0 + Hs]
        y = y * torch.repeat_interleave(mask, cfg.rwkv_head_size)[None, None, :]
    return (y * g) @ policy.cast(p.wo)


# Chunked WKV (flash-linear-attention style): 0 = the per-token loop (the
# paper-faithful recurrence); C > 0 = C tokens per state round-trip, at the
# cost of O(C^2 hs) intra-chunk compute.
WKV_CHUNK = 0


def _chunked(S: int) -> bool:
    return bool(WKV_CHUNK) and S % WKV_CHUNK == 0 and S > WKV_CHUNK


def _wkv_scan(r, k, v, w, u) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-token recurrence from S = 0 over r, k, v, w (B, S, Hp, hs):
    y (B, S, Hp, hs) f32 and the final state. On ``meta`` (the dry-run) one
    step stands for all S (``common.repeated``)."""
    B, S, Hp, hs = r.shape
    f32 = [a.to(torch.float32) for a in (r, k, v, w)]
    state = torch.zeros((B, Hp, hs, hs), dtype=torch.float32, device=r.device)
    if r.device.type == "meta":
        state, y = repeated(S, _wkv_step, state, *(a[:, 0] for a in f32), u)
        return y[:, None].expand(B, S, Hp, hs).contiguous(), state  # the loop's stack
    ys = []
    for t in range(S):
        state, y_t = _wkv_step(state, *(a[:, t] for a in f32), u)
        ys.append(y_t)
    return torch.stack(ys, dim=1), state


def _wkv_state(k, v, w) -> torch.Tensor:
    """The final state alone: S_t = diag(w_t) S_{t-1} + k_t v_t^T from 0."""
    B, S, Hp, hs = k.shape
    state = torch.zeros((B, Hp, hs, hs), dtype=torch.float32, device=k.device)
    if k.device.type == "meta":
        return repeated(S, _decay_step, state, *(a[:, 0] for a in (k, v, w)))[0]
    for t in range(S):
        state = _decay_step(state, k[:, t], v[:, t], w[:, t])[0]
    return state


def _decay_step(state, k_t, v_t, w_t) -> tuple[torch.Tensor]:
    k_t, v_t, w_t = (a.to(torch.float32) for a in (k_t, v_t, w_t))
    return (w_t[..., :, None] * state + k_t[..., :, None] * v_t[..., None, :],)


def _tmix_full(p: TimeMix, cfg: ArchConfig, policy: Policy, x: torch.Tensor, final: bool,
               h0: int = 0):
    """(out (B, S, d), the final state or None)."""
    B, S, _ = x.shape
    r, k, v, g, w = _wkv_inputs(p, cfg, policy, x, _shift(x))
    if _chunked(S):
        y = _wkv_chunked(r, k, v, w, p.u, WKV_CHUNK)
        state = _wkv_state(k, v, w) if final else None
    else:
        y, state = _wkv_scan(r, k, v, w, p.u)
    y = y.reshape(B, S, -1).to(x.dtype)
    return _finish_tmix(p, cfg, policy, y, g, h0), state


def fwd_tmix_full(p: TimeMix, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                  h0: int = 0) -> torch.Tensor:
    """Full-sequence time-mix. x (B, S, d). ``p`` may hold only the heads
    [h0, h0 + Hs) (a model shard's columns of wr, wk, wv, wg, w0, wB, the
    rows of u and wo, its slice of the group norm): the output is then that
    shard's part of the out-projection's sum."""
    return _tmix_full(p, cfg, policy, x, final=False, h0=h0)[0]


def fwd_tmix_prefill(p: TimeMix, cfg: ArchConfig, policy: Policy,
                     x: torch.Tensor, h0: int = 0) -> tuple[torch.Tensor, dict]:
    """``fwd_tmix_full`` and the decode state: the final wkv state of the same
    loop (the reference recovers it with a second, state-only recurrence of
    the same step; under ``WKV_CHUNK`` the port does too), the last token as
    ``x_tmix``, and a zero ``x_cmix`` that the caller sets."""
    out, state = _tmix_full(p, cfg, policy, x, final=True, h0=h0)
    return out, {"S": state, "x_tmix": x[:, -1:, :].to(CACHE_DTYPE),
                 "x_cmix": torch.zeros_like(x[:, -1:, :], dtype=CACHE_DTYPE)}


def _wkv_chunked(r, k, v, w, u, C: int) -> torch.Tensor:
    """Chunkwise-parallel WKV6. r/k/v/w: (B, S, Hp, hs); returns (B, S, Hp, hs).

    Per chunk (all f32, numerically safe: every exponent is <= 0):
      lw_t   = cumsum(log w)                 within-chunk log decay
      carry  y_t += (r_t . exp(lw_{t-1})) @ S0
      intra  A_ts = sum_h r_th k_sh exp(lw_{t-1,h} - lw_{s,h})   for s < t
      bonus  A_tt = (r_t . u) k_t
      state  S' = diag(exp(lw_C)) S0 + sum_s (k_s . exp(lw_C - lw_s)) v_s^T
    """
    B, S, H, hs = r.shape
    n = S // C

    def chunks(a):
        return a.reshape(B, n, C, H, hs).transpose(0, 1).to(torch.float32)

    rc, kc, vc, wc = chunks(r), chunks(k), chunks(v), chunks(w)
    uf = u.to(torch.float32)
    tri = torch.tril(torch.ones((C, C), dtype=torch.float32, device=r.device), diagonal=-1)
    S0 = torch.zeros((B, H, hs, hs), dtype=torch.float32, device=r.device)
    if r.device.type == "meta":  # one chunk stands for all n (``common.repeated``)
        y, _ = repeated(n, _chunk_step, S0, rc[0], kc[0], vc[0], wc[0], uf, tri)
        return y[:, None].expand(B, n, C, H, hs).reshape(B, S, H, hs)
    ys = []
    for rb, kb, vb, wb in zip(rc, kc, vc, wc):  # (B, C, H, hs) each
        y, S0 = _chunk_step(S0, rb, kb, vb, wb, uf, tri)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, H, hs)


def _chunk_step(S0, rb, kb, vb, wb, uf, tri):
    """One chunk of ``_wkv_chunked``: (y (B, C, H, hs), the chunk-end state)."""
    lw = torch.cumsum(torch.log(torch.clamp(wb, min=1e-38)), dim=1)
    lw_prev = F.pad(lw, (0, 0, 0, 0, 1, 0))[:, :-1]  # lw_{t-1}
    # carry-in term
    y = torch.einsum("bchk,bhkv->bchv", rb * torch.exp(lw_prev), S0)
    # intra-chunk: pairwise decay exponents are <= 0 for s < t (no overflow)
    E = torch.exp(lw_prev[:, :, None] - lw[:, None, :])  # (B, C_t, C_s, H, hs)
    A = torch.einsum("bchk,bshk,bcshk->bhcs", rb, kb, E) * tri[None, None]
    diag = torch.einsum("bchk,bchk->bch", rb * uf[None, None], kb)  # bonus term
    y = y + torch.einsum("bhcs,bshv->bchv", A, vb)
    y = y + diag[..., None] * vb  # bonus (current-token) contribution
    # chunk-end state
    kt = kb * torch.exp(lw[:, -1:] - lw)  # (B, C, H, hs), exponents <= 0
    S0 = torch.exp(lw[:, -1])[:, :, :, None] * S0 + torch.einsum("bshk,bshv->bhkv", kt, vb)
    return y, S0


def init_state(cfg: ArchConfig, batch: int, dtype=torch.float32, device=None) -> dict:
    Hp, hs = cfg.phys_heads, cfg.rwkv_head_size
    return {
        "S": torch.zeros((batch, Hp, hs, hs), dtype=torch.float32, device=device),
        "x_tmix": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
        "x_cmix": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
    }


def fwd_tmix_decode(p: TimeMix, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                    state: dict, h0: int = 0) -> tuple[torch.Tensor, dict]:
    """One decode step. x (B, 1, d); state carries S and the previous token x."""
    B = x.shape[0]
    r, k, v, g, w = _wkv_inputs(p, cfg, policy, x, state["x_tmix"].to(x.dtype))
    S_new, y = _wkv_step(state["S"], *(a[:, 0].to(torch.float32) for a in (r, k, v, w)), p.u)
    y = y.reshape(B, 1, -1).to(x.dtype)
    out = _finish_tmix(p, cfg, policy, y, g, h0)
    return out, {**state, "S": S_new, "x_tmix": x.to(state["x_tmix"].dtype)}


def _cmix(p: ChannelMix, policy: Policy, x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    dx = x_prev - x
    xk = x + dx * policy.cast(p.mu_k)
    xr = x + dx * policy.cast(p.mu_r)
    k = torch.square(torch.relu(xk @ policy.cast(p.wk)))
    return torch.sigmoid(xr @ policy.cast(p.wr)) * (k @ policy.cast(p.wv))


def fwd_cmix_full(p: ChannelMix, cfg: ArchConfig, policy: Policy,
                  x: torch.Tensor) -> torch.Tensor:
    return _cmix(p, policy, x, _shift(x))


def fwd_cmix_decode(p: ChannelMix, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                    state: dict) -> tuple[torch.Tensor, dict]:
    out = _cmix(p, policy, x, state["x_cmix"].to(x.dtype))
    return out, {**state, "x_cmix": x.to(state["x_cmix"].dtype)}
