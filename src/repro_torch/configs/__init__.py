"""Architecture registry: importing this package registers every assigned arch.

A copy of the JAX package's pure-data configs (field for field; its
``input_specs`` are not ported). The arch docstrings describe each model as
the JAX package runs it; the port builds, serves and trains all ten.
"""
from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ArchConfig, LayerSpec, MoEConfig, ShapeSpec, get_arch, list_archs,
    reduced, register,
)
from repro_torch.configs import (  # noqa: F401  (registration side effects)
    command_r_plus_104b,
    jamba15_large_398b,
    llama3_8b,
    llava_next_34b,
    mixtral_8x7b,
    musicgen_large,
    qwen15_05b,
    qwen2_moe_a27b,
    qwen3_4b,
    rwkv6_3b,
)

ALL_ARCHS = list_archs()
