"""command-r-plus-104b [dense] — GQA, no-bias. [hf:CohereForAI/c4ai-command-r-v01; unverified]

104B-class: the config asks for optimizer moments in bf16 and FSDP over 'data'
(fields the port's serving path does not read).
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12_288,
    num_heads=96,
    num_kv_heads=8,
    head_dim=128,
    d_ff=33_792,
    vocab_size=256_000,
    rope_theta=75_000_000.0,
    moments_dtype="bfloat16",
    source="[hf:CohereForAI/c4ai-command-r-v01; unverified]",
))
