"""Architecture + shape configuration system (no JAX).

Every assigned architecture is a frozen ``ArchConfig`` registered under its id
(``--arch <id>``). A config fully determines the model: layer pattern (attention /
Mamba / RWKV6 mixers; dense / MoE FFNs), head layout, frontend stubs, and the
input specs for each assigned input shape. The fields are those of the JAX
package's configs, one for one; ``input_specs`` gives ``meta``-device tensors,
torch's allocation-free stand-in for ``jax.ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses

import torch

# ---------------------------------------------------------------------------
# Shapes (assigned set; identical across LM archs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0  # qwen2-moe: shared experts always active
    d_ff_shared: int = 0
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # "attn" | "mamba" | "rwkv6"
    ffn: str  # "dense" | "moe" | "rwkv_cmix"


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"  # "rope" | "sinusoidal" (musicgen) | "none" (rwkv/mamba)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 0  # 0 -> full attention (mixtral: 4096)
    act: str = "swiglu"  # "swiglu" | "gelu"
    moe: MoEConfig | None = None
    # Layer pattern: a repeating template of length p (p | num_layers). Entry i of
    # the template describes layer (g * p + i). Default: all ("attn", dense/moe).
    pattern: tuple[LayerSpec, ...] = ()
    # SSM (mamba) hyperparameters
    ssm_expand: int = 2
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    # RWKV6
    rwkv_head_size: int = 64
    # TP head padding: physical head count used for weights/compute so heads
    # shard evenly over the 16-way "model" axis (llava 56->64, rwkv 40->48).
    # Padded heads are zero-initialized AND masked in forward => mathematically
    # exact; the flop overhead is reported in the roofline "useful ratio".
    padded_heads: int = 0
    # Frontend stubs
    frontend: str = "none"  # "none" | "audio_codes" | "vision_prefix"
    num_codebooks: int = 1  # musicgen: K codebooks, embedded and summed
    num_prefix_tokens: int = 0  # llava: precomputed patch embeddings
    # Distribution hints
    zero_shard_params: bool = True  # FSDP-shard params/opt-state over "data"
    moments_dtype: str = "float32"  # "bfloat16" for >=100B models (fits HBM)
    remat: str = "full"  # "full" | "none"
    source: str = ""  # provenance note [source; tier]

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def phys_heads(self) -> int:
        """Physical (TP-padded) query-head count; == num_heads when unpadded."""
        return self.padded_heads or self.num_heads

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def resolved_dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def rwkv_num_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def layer_pattern(self) -> tuple[LayerSpec, ...]:
        if self.pattern:
            if self.num_layers % len(self.pattern):
                raise ValueError(
                    f"{self.name}: pattern length {len(self.pattern)} must divide "
                    f"num_layers {self.num_layers}"
                )
            return self.pattern
        ffn = "moe" if self.moe is not None else "dense"
        return (LayerSpec("attn", ffn),)

    @property
    def num_groups(self) -> int:
        return self.num_layers // len(self.layer_pattern())

    def is_subquadratic(self) -> bool:
        """True when long_500k applies (SSM / linear-attention / hybrid)."""
        mixers = {spec.mixer for spec in self.layer_pattern()}
        return bool(mixers - {"attn"})

    def runnable_shapes(self) -> list[str]:
        out = []
        for s in SHAPES.values():
            if s.name == "long_500k" and not self.is_subquadratic():
                continue  # full-attention arch: skip per assignment sheet
            out.append(s.name)
        return out

    # ------------------------------------------------------------------
    def input_specs(self, shape_name: str, dtype=torch.bfloat16) -> dict:
        """``meta``-device stand-ins for every model input of a given shape:
        the reference's keys, shapes and dtypes (tokens and codes int32,
        ``loss_mask`` and ``patch_embeds`` in ``dtype``), allocation-free."""
        s = SHAPES[shape_name]
        B, S = s.batch, s.seq_len

        def spec(*shape, dt=torch.int32):
            return torch.empty(shape, dtype=dt, device="meta")

        if s.kind == "train":
            specs: dict = {}
            if self.frontend == "audio_codes":
                specs["codes"] = spec(B, self.num_codebooks, S)
            elif self.frontend == "vision_prefix":
                P = self.num_prefix_tokens
                specs["tokens"] = spec(B, S - P)
                specs["patch_embeds"] = spec(B, P, self.d_model, dt=dtype)
            else:
                specs["tokens"] = spec(B, S)
            specs["loss_mask"] = spec(B, S, dt=dtype)
            return specs
        if s.kind == "prefill":
            if self.frontend == "audio_codes":
                return {"codes": spec(B, self.num_codebooks, S)}
            if self.frontend == "vision_prefix":
                P = self.num_prefix_tokens
                return {"tokens": spec(B, S - P),
                        "patch_embeds": spec(B, P, self.d_model, dt=dtype)}
            return {"tokens": spec(B, S)}
        if s.kind == "decode":
            # one new token against a cache of length seq_len (the cache is the
            # caller's, from model.init_cache); here only the per-step inputs
            if self.frontend == "audio_codes":
                return {"codes": spec(B, self.num_codebooks, 1)}
            return {"tokens": spec(B, 1)}
        raise ValueError(s.kind)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    if cfg.name in _REGISTRY:
        raise ValueError(f"duplicate arch {cfg.name}")
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    # import the config modules lazily so `import repro_torch.configs.base` stays cheap
    from repro_torch import configs as _pkg  # noqa: F401  (triggers registration)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    from repro_torch import configs as _pkg  # noqa: F401

    return sorted(_REGISTRY)


def reduced(cfg: ArchConfig, **overrides) -> ArchConfig:
    """A small same-family config for CPU smoke tests: shrink every width while
    preserving structure (pattern, GQA ratio, MoE top-k, frontends)."""
    p = len(cfg.layer_pattern())
    heads = max(2, cfg.num_heads // 8)
    kv = max(1, min(heads, cfg.num_kv_heads // 8 or 1))
    while heads % kv:
        kv -= 1
    moe = None
    if cfg.moe is not None:
        moe = dataclasses.replace(
            cfg.moe,
            num_experts=min(cfg.moe.num_experts, 4),
            top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=64,
            num_shared=min(cfg.moe.num_shared, 1),
            d_ff_shared=64 if cfg.moe.num_shared else 0,
        )
    defaults = dict(
        num_layers=2 * p,
        d_model=64,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        moe=moe,
        rwkv_head_size=16,
        padded_heads=0,
        num_prefix_tokens=8 if cfg.frontend == "vision_prefix" else 0,
        name=cfg.name + "-smoke",
    )
    defaults.update(overrides)
    # keep d_model divisible by rwkv_head_size and heads
    small = dataclasses.replace(cfg, **defaults)
    return small
