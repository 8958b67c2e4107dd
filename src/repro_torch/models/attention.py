"""GQA attention: qkv(+bias), qk-norm, RoPE/sinusoidal/none positions, sliding
window, flash full attention (prefill), KV-cache decode.

Query heads are flat (no (KV, G) grouping in the weights); K/V heads stay
compact, so the GQA cache stays small: the flash kernel reads grouped heads
in place, and decode repeats them to the query-head count. Archs whose head count was padded for the
reference's tensor-parallel layout (llava 56 -> 64) set cfg.padded_heads:
padded heads are zero-init and masked, so the function is exact.

Full attention (prefill) runs in ``_flash_attention``: on a card the
hand-written CUDA kernel ``flash_attention_bhsd``, which never holds the
(S, S) score matrix; on the CPU its plain version, the direct masked
softmax. Decode computes one query row against the cache with ``torch``
ops, as the reference computes it outside any kernel; ``decode_partial``
gives a shard of the cache's (max, sum, accumulator) for the
sequence-sharded decode of ``distributed.parallel``, which merges them.

``fwd_full``, ``fwd_prefill`` and ``fwd_decode`` take ``heads``, a `Heads`
slice of the query heads: a tensor-parallel shard's, whose ``p`` holds
only that slice's ``wq`` / ``bq`` / ``wo`` and the KV heads it reads, and
whose output is then its part of the out-projection's sum. None is every
head.
"""
from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass(frozen=True)
class Heads:
    """Query heads [h0, h1) and the KV heads [k0, k1) they read (head h
    reads KV head h // (Hp / KV)); ``kv_index``, the local KV head of each
    query head when the slice is not whole KV groups, else None."""

    h0: int
    h1: int
    k0: int
    k1: int
    kv_index: tuple | None


def head_shards(cfg: ArchConfig, M: int) -> list[Heads]:
    """The physical query heads cut into M equal slices, one a model shard."""
    Hp, KV = cfg.phys_heads, cfg.num_kv_heads
    if Hp % M:
        raise ValueError(f"{cfg.name}: {Hp} query heads do not split over {M} model shards")
    Hs, Gp = Hp // M, Hp // KV
    out = []
    for j in range(M):
        h0, h1 = j * Hs, (j + 1) * Hs
        k0, k1 = h0 // Gp, (h1 - 1) // Gp + 1
        local = [h // Gp - k0 for h in range(h0, h1)]
        n = k1 - k0
        regular = Hs % n == 0 and local == [t // (Hs // n) for t in range(Hs)]
        out.append(Heads(h0, h1, k0, k1, None if regular else tuple(local)))
    return out


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


def _flash_attention_triangle(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              pos: torch.Tensor, window: int, chunk: int) -> torch.Tensor:
    """Causal-skip flash attention for self-attention with monotone positions
    (the reference's ``CAUSAL_SKIP`` route). Nothing dispatches it yet: the
    flag comes with its one consumer, the dry-run (ROADMAP.md Queue 1 item
    15). On a card it would change nothing: ``flash_attention_bhsd`` already
    skips the tiles above the diagonal and outside the window.

    q, k, v (B, S, H, Dh), pos (S,). One loop over the static list of
    lower-triangle (q chunk, kv chunk) tile pairs (within the sliding
    window, when set): the masked-out upper triangle is never computed. Each
    row of tiles keeps a running max that only goes up (a fully masked tile
    would otherwise lower it and blow exp(m - m_new) up), a running sum and
    an f32 accumulator; the row's last tile writes its output.
    """
    B, S, H, Dh = q.shape
    c = min(chunk, S)
    if S % c:
        raise ValueError(f"sequence {S} is not a multiple of the chunk {c}")
    n = S // c
    scale = Dh ** -0.5
    wc = n if not window else min(n, -(-window // c) + 1)  # kv chunks per row
    out = torch.empty_like(q)
    acc = mm = ll = None
    for i in range(n):
        for j in range(max(0, i - wc + 1), i + 1):
            if j == max(0, i - wc + 1):
                acc = torch.zeros((B, H, c, Dh), dtype=torch.float32, device=q.device)
                mm = torch.full((B, H, c), _NEG, dtype=torch.float32, device=q.device)
                ll = torch.zeros((B, H, c), dtype=torch.float32, device=q.device)
            qc, kc, vc = q[:, i * c:(i + 1) * c], k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c]
            pq, pk = pos[i * c:(i + 1) * c], pos[j * c:(j + 1) * c]
            s = torch.einsum("bqhd,bthd->bhqt", qc.float(), kc.float()) * scale
            mask = pq[:, None] >= pk[None, :]
            if window:
                mask &= pq[:, None] - pk[None, :] < window
            s = torch.where(mask[None, None], s, -torch.inf)
            m_new = torch.maximum(mm, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(mm - m_new)
            ll = ll * alpha + torch.sum(p, dim=-1)
            pv = torch.einsum("bhqt,bthd->bhqd", p.to(vc.dtype).float(), vc.float())
            acc = acc * alpha[..., None] + pv
            mm = m_new
        row = acc / torch.clamp(ll, min=1e-30)[..., None]
        out[:, i * c:(i + 1) * c] = row.transpose(1, 2).to(q.dtype)
    return out


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


def _grouped_kv(x: torch.Tensor, heads: Heads | None) -> torch.Tensor:
    """k or v (B, T, KVs, Dh) as the flash kernel reads them: grouped heads
    in place when the query heads are whole KV groups, else one KV head a
    query head."""
    return x if heads is None or heads.kv_index is None else x[:, :, list(heads.kv_index)]


def _kv_per_head(x: torch.Tensor, cfg: ArchConfig, heads: Heads | None) -> torch.Tensor:
    """k or v (B, T, KVs, Dh) repeated to one KV head a query head, as
    decode reads them."""
    if heads is not None and heads.kv_index is not None:
        return x[:, :, list(heads.kv_index)]
    Hs = cfg.phys_heads if heads is None else heads.h1 - heads.h0
    return _repeat_kv(x, Hs // x.shape[2])


def attend_out(p: Attention, cfg: ArchConfig, policy: Policy, out: torch.Tensor,
               heads: Heads | None = None) -> torch.Tensor:
    """out (B, S, Hs, Dh) with its padded heads masked, through ``wo``."""
    mask = _head_mask(cfg, out.dtype, out.device)
    if mask is not None:
        if heads is not None:
            mask = mask[heads.h0:heads.h1]
        out = out * mask[None, None, :, None]
    return _out_proj(out, policy.cast(p.wo))


def _full(p: Attention, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
          positions: torch.Tensor, heads: Heads | None):
    q, k, v = _project_qkv(p, cfg, policy, x, positions)
    out = _flash_attention(q, _grouped_kv(k, heads), _grouped_kv(v, heads), cfg.sliding_window)
    return attend_out(p, cfg, policy, out, heads), k, v


def fwd_full(p: Attention, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
             positions: torch.Tensor, heads: Heads | None = None) -> torch.Tensor:
    """Full causal (+window) attention. positions (B, S) = arange(S) per row."""
    return _full(p, cfg, policy, x, positions, heads)[0]


def fwd_prefill(p: Attention, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
                positions: torch.Tensor, heads: Heads | None = None) -> tuple[torch.Tensor, dict]:
    """``fwd_full`` and the decode cache: k, v (B, S, KVs, Dh) in bf16
    whatever the policy, as the reference keeps them."""
    y, k, v = _full(p, cfg, policy, x, positions, heads)
    return y, {"k": k.to(torch.bfloat16), "v": v.to(torch.bfloat16)}


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


def decode_qkv(p: Attention, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
               cache_len: int):
    """q (B, 1, H, Dh), k_new, v_new (B, 1, KV, Dh) of the token at position
    ``cache_len``, the heads being those of ``p``'s weights."""
    positions = torch.full((x.shape[0], 1), cache_len, dtype=torch.int64, device=x.device)
    return _project_qkv(p, cfg, policy, x, positions)


def cache_write(cache: dict, index: int, k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """Write the new token's k, v (B, 1, KV, Dh) at ``index``, in place (as
    int8 codes and scales in an int8 cache)."""
    if "k_scale" in cache:
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        cache["k"][:, index] = kq[:, 0]
        cache["v"][:, index] = vq[:, 0]
        cache["k_scale"][:, index] = ks[:, 0]
        cache["v_scale"][:, index] = vs[:, 0]
    else:
        cache["k"][:, index] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, index] = v_new[:, 0].to(cache["v"].dtype)


def cache_read(cache: dict, live: slice, policy: Policy) -> tuple[torch.Tensor, torch.Tensor]:
    """The cache's k, v at the ``live`` positions, int8 dequantized to the
    compute dtype."""
    if "k_scale" in cache:
        return (_dequantize_kv(cache["k"][:, live], cache["k_scale"][:, live],
                               policy.compute_dtype),
                _dequantize_kv(cache["v"][:, live], cache["v_scale"][:, live],
                               policy.compute_dtype))
    return cache["k"][:, live], cache["v"][:, live]


def _scores(q: torch.Tensor, kk: torch.Tensor) -> torch.Tensor:
    """(B, H, T) scores of the one query row, products and sums in f32, the
    reference's preferred_element_type."""
    s = torch.einsum("bhd,bthd->bht", q[:, 0].float(), kk.float())
    return s * (q.shape[-1] ** -0.5)


def decode_attend(q: torch.Tensor, kk: torch.Tensor, vv: torch.Tensor) -> torch.Tensor:
    """softmax over the T cache positions of kk, vv (B, T, H, Dh), already
    one KV head a query head: out (B, 1, H, Dh) in f32."""
    s = _scores(q, kk)
    m = torch.clamp(torch.amax(s, dim=-1, keepdim=True), min=_NEG)
    w = torch.exp(s - m)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-30)
    out = torch.einsum("bht,bthd->bhd", w.to(vv.dtype).float(), vv.float())
    return out[:, None, :, :]


def decode_partial(q: torch.Tensor, kk: torch.Tensor, vv: torch.Tensor):
    """One shard of the cache's positions: (m (B, H), l (B, H), acc (B, H,
    Dh)) in f32, the max of the scores, the sum of exp(s - m) and the
    accumulator sum exp(s - m) v; T may be 0 (m = -1e30, l = acc = 0).
    Merged over shards as flash decoding does (``distributed.parallel``)."""
    s = _scores(q, kk)
    if s.shape[-1] == 0:
        B, H, Dh = q.shape[0], q.shape[2], vv.shape[-1]
        z = torch.zeros((B, H), dtype=torch.float32, device=q.device)
        return z + _NEG, z, torch.zeros((B, H, Dh), dtype=torch.float32, device=q.device)
    m = torch.clamp(torch.amax(s, dim=-1), min=_NEG)
    w = torch.exp(s - m[..., None])
    acc = torch.einsum("bht,bthd->bhd", w.to(vv.dtype).float(), vv.float())
    return m, torch.sum(w, dim=-1), acc


def live_range(cfg: ArchConfig, cache_len: int) -> tuple[int, int]:
    """[lo, hi) of the cache positions a decode at ``cache_len`` reads:
    t <= cache_len and, with a window, t > cache_len - window."""
    lo = max(0, cache_len - cfg.sliding_window + 1) if cfg.sliding_window else 0
    return lo, cache_len + 1


def fwd_decode(p: Attention, cfg: ArchConfig, policy: Policy, x: torch.Tensor,
               cache: dict, cache_len: int,
               heads: Heads | None = None) -> tuple[torch.Tensor, dict]:
    """One decode step. x (B, 1, d); cache k/v (B, T, KV, Dh); cache_len = number
    of valid cache entries (the new token is written at that index).

    The cache is updated in place (the reference returns a new one) and
    returned. Attention reads only the live entries: t <= cache_len and,
    with a window, t > cache_len - window, the reference's mask; the masked
    entries it computes weigh exactly 0 there.
    """
    q, k_new, v_new = decode_qkv(p, cfg, policy, x, cache_len)
    cache_write(cache, cache_len, k_new, v_new)
    k_cache, v_cache = cache_read(cache, slice(*live_range(cfg, cache_len)), policy)
    kk = _kv_per_head(policy.cast(k_cache), cfg, heads)  # (B, T_live, Hs, Dh)
    vv = _kv_per_head(policy.cast(v_cache), cfg, heads)
    out = decode_attend(q, kk, vv).to(x.dtype)  # (B, 1, Hs, Dh)
    return attend_out(p, cfg, policy, out, heads), cache
