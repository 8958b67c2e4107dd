"""rwkv6-3b [ssm] — Finch: attention-free, data-dependent decay. [arXiv:2404.05892; hf]

Runs long_500k (O(1) recurrent state). head_size 64 -> 40 wkv heads.
"""
from repro_torch.configs.base import ArchConfig, LayerSpec, register

CONFIG = register(ArchConfig(
    name="rwkv6-3b",
    family="ssm",
    num_layers=32,
    d_model=2560,
    num_heads=40,       # wkv heads = d_model / rwkv_head_size
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65_536,
    pos_emb="none",
    pattern=(LayerSpec("rwkv6", "rwkv_cmix"),),
    rwkv_head_size=64,
    padded_heads=48,  # 40 wkv heads padded to 48 for the 16-way model axis (masked, exact)
    source="[arXiv:2404.05892; hf]",
))
