"""GQA attention: qkv(+bias), qk-norm, RoPE/sinusoidal/none positions, sliding
window, flash full attention (prefill), KV-cache decode.

Query heads are flat (no (KV, G) grouping in the weights); K/V heads stay
compact, so the GQA cache stays small, and are repeated to the query-head
count before attention. Archs whose head count was padded for the
reference's tensor-parallel layout (llava 56 -> 64) set cfg.padded_heads:
padded heads are zero-init and masked, so the function is exact.

Full attention (prefill) runs in ``_flash_attention``: on a card the
hand-written CUDA kernel ``flash_attention_bhsd``, which never holds the
(S, S) score matrix; on the CPU its plain version, the direct masked
softmax. Decode computes one query row against the cache with ``torch``
ops, as the reference computes it outside any kernel.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops
from repro_torch.models.common import Policy, normal_init, rms_norm
from repro_torch.models.rope import apply_rope, rope_angles

_NEG = -1e30


def _head_mask(cfg: ArchConfig, dtype, device=None) -> torch.Tensor | None:
    """(Hp,) 1/0 mask; None when no padding. Physical head h = kv*Gp + g is real
    iff g < logical group size G."""
    Hp, H, KV = cfg.phys_heads, cfg.num_heads, cfg.num_kv_heads
    if Hp == H:
        return None
    Gp, G = Hp // KV, H // KV
    m = (torch.arange(Hp, device=device) % Gp) < G
    return m.to(dtype)


class Attention(nn.Module):
    """Parameters in the reference's layouts: ``wq`` (d, Hp, Dh), ``wk``/``wv``
    (d, KV, Dh), ``wo`` (Hp, Dh, d), with ``qkv_bias`` ``bq`` (Hp, Dh) and
    ``bk``/``bv`` (KV, Dh), with ``qk_norm`` ``q_scale``/``k_scale`` (Dh,).
    Allocated empty; ``init`` draws them."""

    def __init__(self, cfg: ArchConfig, policy: Policy, device=None):
        super().__init__()
        d, KV, Dh, Hp = cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim, cfg.phys_heads
        kw = dict(dtype=policy.param_dtype, device=device)
        shapes = {"wq": (d, Hp, Dh), "wk": (d, KV, Dh), "wv": (d, KV, Dh), "wo": (Hp, Dh, d)}
        if cfg.qkv_bias:
            shapes.update(bq=(Hp, Dh), bk=(KV, Dh), bv=(KV, Dh))
        if cfg.qk_norm:
            shapes.update(q_scale=(Dh,), k_scale=(Dh,))
        for name, shape in shapes.items():
            setattr(self, name, nn.Parameter(torch.empty(shape, **kw), requires_grad=False))


def init(generator: torch.Generator, cfg: ArchConfig, policy: Policy, device=None) -> Attention:
    p = Attention(cfg, policy, device)
    dt = policy.param_dtype
    mask = _head_mask(cfg, dt, p.wq.device)
    wq = normal_init(generator, p.wq.shape, dt).to(p.wq.device)
    wo = normal_init(generator, p.wo.shape, dt,
                     scale=0.02 / (2 * cfg.num_layers) ** 0.5).to(p.wo.device)
    if mask is not None:  # zero-init the padded heads
        wq = wq * mask[None, :, None]
        wo = wo * mask[:, None, None]
    p.wq.copy_(wq)
    p.wk.copy_(normal_init(generator, p.wk.shape, dt))
    p.wv.copy_(normal_init(generator, p.wv.shape, dt))
    p.wo.copy_(wo)
    if cfg.qkv_bias:
        for b in (p.bq, p.bk, p.bv):
            b.zero_()
    if cfg.qk_norm:
        p.q_scale.fill_(1.0)
        p.k_scale.fill_(1.0)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhe->bshe") as one matrix product."""
    d, h, e = w.shape
    return (x @ w.reshape(d, h * e)).unflatten(-1, (h, e))


def _project_qkv(p: Attention, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                 positions: torch.Tensor):
    """x (B, S, d) -> q (B, S, Hp, Dh), k, v (B, S, KV, Dh); RoPE applied."""
    q = _proj(x, policy.cast(p.wq))
    k = _proj(x, policy.cast(p.wk))
    v = _proj(x, policy.cast(p.wv))
    if cfg.qkv_bias:
        q = q + policy.cast(p.bq)
        k = k + policy.cast(p.bk)
        v = v + policy.cast(p.bv)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_scale, cfg.norm_eps)
        k = rms_norm(k, p.k_scale, cfg.norm_eps)
    if cfg.pos_emb == "rope":
        cos, sin = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def _out_proj(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshe,hed->bsd") as one matrix product."""
    h, e, d = wo.shape
    return out.flatten(-2) @ wo.reshape(h * e, d)


def _repeat_kv(x: torch.Tensor, reps: int) -> torch.Tensor:
    """(B, T, KV, Dh) -> (B, T, KV*reps, Dh)."""
    if reps == 1:
        return x
    B, T, KV, Dh = x.shape
    return x[:, :, :, None, :].expand(B, T, KV, reps, Dh).reshape(B, T, KV * reps, Dh)


def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     window: int) -> torch.Tensor:
    """Causal (+ sliding window) softmax(q k^T Dh^-0.5) v over flat heads.

    q: (B, S, H, Dh), k, v: (B, S, KV, Dh) with H a multiple of KV (query
    head h reads KV head h // (H // KV)) -> (B, S, H, Dh). The
    positions are the row indices 0..S-1, which is what every caller has
    (``forward_prefill`` uses arange(S)); the reference's scan takes them as
    arguments. Routed by device through ``ops.flash_attention``: the CUDA
    kernel on a card, the plain direct softmax on the CPU.
    """
    return ops.flash_attention(q, k, v, window=window)


def fwd_full(p: Attention, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
             positions: torch.Tensor) -> torch.Tensor:
    """Full causal (+window) attention. positions (B, S) = arange(S) per row."""
    q, k, v = _project_qkv(p, cfg, policy, x, positions)
    # Grouped KV heads are read in place by head index: no repeated copy.
    out = _flash_attention(q, k, v, cfg.sliding_window)
    mask = _head_mask(cfg, out.dtype, out.device)
    if mask is not None:
        out = out * mask[None, None, :, None]
    return _out_proj(out, policy.cast(p.wo))


# int8 KV cache: symmetric per-(token, kv-head) quantization, a quarter of an
# f32 cache's bytes and half of a bf16 one's.
def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, KV, Dh) -> (int8 codes, f32 scales (B, S, KV)). torch.round
    rounds half to even, as jnp.round does."""
    xf = x.to(torch.float32)
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.to(torch.float32) * scale[..., None].to(torch.float32)).to(dtype)


def quantize_cache(cache: dict) -> dict:
    """Convert a bf16 {k, v} cache (e.g. fresh from prefill) to int8+scales."""
    kq, ks = _quantize_kv(cache["k"])
    vq, vs = _quantize_kv(cache["v"])
    return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}


def init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    KV, Dh = cfg.num_kv_heads, cfg.resolved_head_dim
    if dtype == torch.int8:
        return {
            "k": torch.zeros((batch, max_len, KV, Dh), dtype=torch.int8, device=device),
            "v": torch.zeros((batch, max_len, KV, Dh), dtype=torch.int8, device=device),
            "k_scale": torch.zeros((batch, max_len, KV), dtype=torch.float32, device=device),
            "v_scale": torch.zeros((batch, max_len, KV), dtype=torch.float32, device=device),
        }
    return {
        "k": torch.zeros((batch, max_len, KV, Dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_len, KV, Dh), dtype=dtype, device=device),
    }


def fwd_decode(p: Attention, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
               cache: dict, cache_len: int) -> tuple[torch.Tensor, dict]:
    """One decode step. x (B, 1, d); cache k/v (B, T, KV, Dh); cache_len = number
    of valid cache entries (the new token is written at that index).

    The cache is updated in place (the reference returns a new one) and
    returned. Attention reads only the live entries: t <= cache_len and,
    with a window, t > cache_len - window, the reference's mask; the masked
    entries it computes weigh exactly 0 there.
    """
    B = x.shape[0]
    Hp, KV, Dh = cfg.phys_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    reps = Hp // KV
    positions = torch.full((B, 1), cache_len, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _project_qkv(p, cfg, policy, x, positions)
    lo = max(0, cache_len - cfg.sliding_window + 1) if cfg.sliding_window else 0
    live = slice(lo, cache_len + 1)
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        cache["k"][:, cache_len] = kq[:, 0]
        cache["v"][:, cache_len] = vq[:, 0]
        cache["k_scale"][:, cache_len] = ks[:, 0]
        cache["v_scale"][:, cache_len] = vs[:, 0]
        k_cache = _dequantize_kv(cache["k"][:, live], cache["k_scale"][:, live],
                                 policy.compute_dtype)
        v_cache = _dequantize_kv(cache["v"][:, live], cache["v_scale"][:, live],
                                 policy.compute_dtype)
    else:
        cache["k"][:, cache_len] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, cache_len] = v_new[:, 0].to(cache["v"].dtype)
        k_cache, v_cache = cache["k"][:, live], cache["v"][:, live]

    kk = _repeat_kv(policy.cast(k_cache), reps)  # (B, T_live, Hp, Dh)
    vv = _repeat_kv(policy.cast(v_cache), reps)
    # products and sums in f32, the reference's preferred_element_type
    s = torch.einsum("bhd,bthd->bht", q[:, 0].float(), kk.float())
    s = s * (Dh ** -0.5)  # (B, Hp, T_live)
    m = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=_NEG)
    w = torch.exp(s - m)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bht,bthd->bhd", w.to(vv.dtype).float(), vv.float())
    out = out[:, None, :, :].to(x.dtype)  # (B, 1, Hp, Dh)
    mask = _head_mask(cfg, out.dtype, out.device)
    if mask is not None:
        out = out * mask[None, None, :, None]
    return _out_proj(out, policy.cast(p.wo)), cache
