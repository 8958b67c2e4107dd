"""The LM stack of the port, all ten archs (attention, dense and MoE; the
Mamba hybrid; RWKV6; audio codes; a vision prefix): config -> ``model.init``
-> batched prefill -> cache (attention k / v, SSM states) -> decode, and
``forward_train`` for training. Full attention runs in the hand-written CUDA
kernel ``flash_attention_bhsd`` on a card, under training through its
``autograd.Function``; the Mamba and RWKV6 scans run as ``torch`` loops."""
from repro_torch.models.common import TEST_POLICY, Policy  # noqa: F401
