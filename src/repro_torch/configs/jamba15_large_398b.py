"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.
[arXiv:2403.19887; hf]

Repeating 8-layer template: attention at position 4, Mamba elsewhere; MoE FFN on
odd positions, dense on even (1:1 MoE period over the 8-block). 72 layers = 9
groups. Runs long_500k: attention-layer KV (only 9 layers) is sequence-sharded
over 'data'; Mamba state is O(1). 398B-class: bf16 moments + FSDP.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, MoEConfig, register

_PATTERN = tuple(
    LayerSpec("attn" if i == 4 else "mamba", "moe" if i % 2 == 1 else "dense")
    for i in range(8)
)

CONFIG = register(ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    pos_emb="none",  # Jamba uses no positional encoding (Mamba carries order)
    pattern=_PATTERN,
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24_576),
    ssm_expand=2,
    ssm_state=16,
    ssm_conv=4,
    moments_dtype="bfloat16",
    source="[arXiv:2403.19887; hf]",
))
