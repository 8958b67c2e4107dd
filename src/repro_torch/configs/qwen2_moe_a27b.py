"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]

Fine-grained experts (d_ff 1408 each); the 4 shared experts are always active
(equivalently HF's single 5632-wide shared expert).
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=151_936,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    moe=MoEConfig(num_experts=60, top_k=4, d_ff_expert=1408,
                  num_shared=4, d_ff_shared=1408),
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
))
