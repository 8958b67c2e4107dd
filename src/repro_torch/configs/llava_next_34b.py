"""llava-next-34b [vlm] — anyres tiling. [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

Backbone only: the vision tower + anyres tiler is a STUB — the model takes
2880 precomputed patch embeddings (576 base + 4x576 tiles) which the model
concatenates ahead of the token embeddings.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20_480,
    vocab_size=64_000,
    rope_theta=5_000_000.0,
    frontend="vision_prefix",
    num_prefix_tokens=2880,
    padded_heads=64,  # 56 q-heads padded to 64 for the 16-way model axis (masked, exact)
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]",
))
