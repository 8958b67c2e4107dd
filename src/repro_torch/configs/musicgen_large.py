"""musicgen-large [audio] — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a STUB — the model takes the 4
codebook token streams directly; embeddings are summed over codebooks and the
model carries one LM head per codebook.
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    pos_emb="sinusoidal",
    act="gelu",
    frontend="audio_codes",
    num_codebooks=4,
    source="[arXiv:2306.05284; hf]",
))
