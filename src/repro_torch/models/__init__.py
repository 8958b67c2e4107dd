"""The LM stack of the port, the dense-attention serving subset: config ->
``model.init`` -> batched prefill -> KV cache -> decode. Prefill attention
runs in the hand-written CUDA kernel ``flash_attention_bhsd`` on a card."""
from repro_torch.models.common import TEST_POLICY, Policy  # noqa: F401
