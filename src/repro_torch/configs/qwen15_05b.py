"""qwen1.5-0.5b [dense] — QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151_936,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    norm_eps=1e-6,
    tie_embeddings=True,
    source="[hf:Qwen/Qwen1.5-0.5B; hf]",
))
