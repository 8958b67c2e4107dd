"""The LM stack of the port, the attention archs (dense and MoE): config ->
``model.init`` -> batched prefill -> KV cache -> decode, and
``forward_train`` for training. Full attention runs in the hand-written CUDA
kernel ``flash_attention_bhsd`` on a card, under training through its
``autograd.Function``."""
from repro_torch.models.common import TEST_POLICY, Policy  # noqa: F401
