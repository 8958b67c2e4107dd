"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention. [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    rope_theta=1_000_000.0,
    sliding_window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=14_336),
    source="[arXiv:2401.04088; hf]",
))
