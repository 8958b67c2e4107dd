"""qwen3-4b [dense] — qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen3-4b",
    family="dense",
    num_layers=36,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151_936,
    qk_norm=True,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    source="[hf:Qwen/Qwen3-8B; hf]",
))
