"""Roofline terms of the port's work on one NVIDIA H100 SXM5.

Peaks, from NVIDIA's H100 Tensor Core GPU datasheet (SXM5 column, dense
rates, at the full 700 W power limit):

    67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s HBM3,
    NVLink 4: 18 links of 25 GB/s in each direction.

Every clustering kernel of the port runs f32 ``fmaf`` chains, so the one
compute peak is the f32 one. The LM analysis (bf16 matmuls on the tensor
cores, 989 TFLOP/s dense) passes ``PEAK_BF16_FLOPS`` under its own name.
The three terms of a record of per-device totals are

    t_compute    = flops_per_device / peak_flops
    t_memory     = bytes_per_device / 3.35e12
    t_collective = collective_bytes_per_device / (links * 25e9)

with ``links`` the NVLink links a collective engages (all 18 of a card
behind the NVSwitch of an HGX board).

MODEL_FLOPS (useful compute) is 6*N*D (dense) / 6*N_active*D (MoE) for
training, 2*N*D for inference; the ratio MODEL_FLOPS / record flops exposes
remat recompute, attention-causal waste, MoE dispatch overhead and head
padding.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.configs.base import SHAPES, ArchConfig

PEAK_FLOPS = 67e12  # f32 FMA outside the tensor cores, per card
PEAK_BF16_FLOPS = 989e12  # bf16 dense on the tensor cores (the LM analysis only)
HBM_BW = 3.35e12  # bytes/s, HBM3
NVLINK_BW = 25e9  # bytes/s per link in each direction
NVLINK_LINKS = 18  # links per card


def roofline_terms(*, flops: float, bytes_hbm: float, collective_bytes: float,
                   chips: int = 1, links: int = 1,
                   peak_flops: float = PEAK_FLOPS) -> dict:
    """Inputs are PER-DEVICE totals when chips == 1 (the dry-run convention);
    pass global totals with chips=N to average. ``peak_flops`` is the f32
    peak unless the work runs on the tensor cores (``PEAK_BF16_FLOPS``)."""
    t_c = flops / (chips * peak_flops)
    t_m = bytes_hbm / (chips * HBM_BW)
    t_n = collective_bytes / (chips * links * NVLINK_BW)
    terms = {"t_compute_s": t_c, "t_memory_s": t_m, "t_collective_s": t_n}
    bottleneck = max(terms, key=terms.get)
    terms["bottleneck"] = {"t_compute_s": "compute", "t_memory_s": "memory",
                           "t_collective_s": "collective"}[bottleneck]
    # roofline fraction: how much of the step the bound resource is busy if the
    # other two overlap perfectly behind it
    total = max(t_c, t_m, t_n)
    terms["roofline_fraction"] = (t_c / total) if total > 0 else 0.0
    return terms


def lloyd_step_record(*, n: int, d: int, l: int, m: int, k: int,
                      fused: bool = True) -> dict:
    """Analytic dry-run-convention record for ONE Lloyd block step of the
    APNC family: embed (gram + coefficient contraction) + assign + (Z, g)
    reduce over an (n, d) block against (k, m) centroids.

    flops: 2ndl (gram) + 2nlm (contraction) + 2nmk (distances) + 2nmk
    (one-hot Z matmul). The bound of PERF.md's kernel table counts the
    distances alone (2nmk): the one-hot product is a scatter-add in the
    port's kernels, not a matmul. hbm_bytes: the operands and outputs that
    MUST cross HBM — X, landmarks/R, centroids, (Z, g, labels). The un-fused chain
    additionally round-trips the embedded Y (n, m) f32 once (write after
    embed, read for assign): `fused=False` adds those 2*n*m*4 bytes, which is
    exactly the traffic kernels/lloyd_step.py exists to eliminate. Feed the
    result to `repro_torch.obs.roofline_join` with a measured per-block wall
    time to get the step's model_fraction."""
    flops = 2.0 * n * d * l + 2.0 * n * l * m + 4.0 * n * m * k
    bytes_hbm = 4.0 * (n * d + l * d + m * l + k * m  # block + operands in
                       + k * m + k + n)               # Z + g + labels out
    if not fused:
        bytes_hbm += 2.0 * 4.0 * n * m  # Y round-trip: write + read
    return {"flops": flops, "hbm_bytes": bytes_hbm, "bytes": bytes_hbm,
            "collective_bytes": 0.0}


# ---------------------------------------------------------------------------
# analytic useful flops (MODEL_FLOPS)
# ---------------------------------------------------------------------------

def param_counts(cfg: ArchConfig) -> dict:
    """Analytic parameter counts: total and active (MoE top-k + shared)."""
    d, V = cfg.d_model, cfg.vocab_size
    Dh, H, KV = cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads
    per_layer_total = 0.0
    per_layer_active = 0.0
    for spec in cfg.layer_pattern():
        if spec.mixer == "attn":
            mix = d * (H + 2 * KV) * Dh + H * Dh * d
        elif spec.mixer == "mamba":
            di, N, r = cfg.ssm_d_inner, cfg.ssm_state, cfg.resolved_dt_rank
            mix = d * 2 * di + di * (r + 2 * N) + r * di + di * d + cfg.ssm_conv * di
        else:  # rwkv6 tmix
            a = cfg.rwkv_num_heads * cfg.rwkv_head_size
            mix = 4 * d * a + a * d + d * 5 * 32 + 5 * 32 * d + d * 64 + 64 * a
        if spec.ffn == "dense":
            f = d * cfg.d_ff * (3 if cfg.act == "swiglu" else 2)
            fa = f
        elif spec.ffn == "moe":
            moe = cfg.moe
            fe = d * moe.d_ff_expert * 3
            f = moe.num_experts * fe + d * moe.num_experts
            fa = moe.top_k * fe
            if moe.num_shared:
                sh = 3 * d * moe.num_shared * moe.d_ff_shared
                f += sh
                fa += sh
        else:  # rwkv cmix
            f = 2 * d * cfg.d_ff if False else d * cfg.d_ff * 2 + d * d
            fa = f
        per_layer_total += mix + f
        per_layer_active += mix + fa
    n_pat = cfg.num_layers // len(cfg.layer_pattern())
    total = per_layer_total * n_pat
    active = per_layer_active * n_pat
    emb = V * d * (cfg.num_codebooks if cfg.frontend == "audio_codes" else 1)
    head = 0 if cfg.tie_embeddings else emb
    return {"backbone_total": total, "backbone_active": active,
            "embed": emb, "head": head,
            "total": total + emb + head, "active": active + emb + head}


def model_flops(cfg: ArchConfig, shape_name: str) -> float:
    """Useful (paper-formula) flops for the GLOBAL step: 6*N_active*D train,
    2*N_active*D inference, + exact-attention quadratic term where applicable."""
    s = SHAPES[shape_name]
    counts = param_counts(cfg)
    n_act = counts["backbone_active"] + counts["embed"] + counts["head"]
    if s.kind == "train":
        tokens = s.batch * s.seq_len
        mult = 6.0
    elif s.kind == "prefill":
        tokens = s.batch * s.seq_len
        mult = 2.0
    else:  # decode: one token per sequence
        tokens = s.batch
        mult = 2.0
    base = mult * n_act * tokens
    # causal attention quadratic term: 2*S_ctx*d per token per attn layer fwd
    n_attn = sum(1 for sp in cfg.layer_pattern() if sp.mixer == "attn")
    n_attn *= cfg.num_layers // len(cfg.layer_pattern())
    Dh = cfg.resolved_head_dim
    ctx = s.seq_len if s.kind != "train" else s.seq_len / 2  # causal average
    if cfg.sliding_window:
        ctx = min(ctx, cfg.sliding_window)
    attn = (mult / 1.5) * 2 * ctx * cfg.num_heads * Dh * n_attn * tokens
    return base + attn


def analyze_record(rec: dict, cfg: ArchConfig) -> dict:
    """Attach roofline terms + usefulness ratio to one dry-run JSONL record
    of the LM (bf16 matmuls: the tensor-core peak). The memory term uses the
    fusion-optimistic `hbm_bytes`; the raw per-instruction `bytes` upper
    bound is kept in the record for reference."""
    terms = roofline_terms(
        flops=rec["flops"], bytes_hbm=rec.get("hbm_bytes", rec["bytes"]),
        collective_bytes=rec.get("collective_bytes", 0.0),
        links=NVLINK_LINKS, peak_flops=PEAK_BF16_FLOPS,
    )
    chips = 1
    for v in rec.get("mesh", {}).values():
        chips *= v
    mf = model_flops(cfg, rec["shape"])
    terms["model_flops_global"] = mf
    terms["hlo_flops_global"] = rec["flops"] * chips
    terms["useful_ratio"] = mf / (rec["flops"] * chips) if rec["flops"] > 0 else 0.0
    return {**rec, **terms}


def load_results(path: str | Path) -> list[dict]:
    out = []
    p = Path(path)
    if not p.exists():
        return out
    # last record wins per (arch, shape, mesh, opts) key
    seen: dict = {}
    for ln in p.read_text().splitlines():
        if not ln.strip():
            continue
        rec = json.loads(ln)
        key = (rec.get("arch"), rec.get("shape"), rec.get("multi_pod"),
               tuple(rec.get("opts", ())))
        seen[key] = rec
    return list(seen.values())
