"""The embedding family: registry, routed ``transform``, and the members
(nystrom, sd, rff, tensorsketch)."""
from repro_torch.embed.base import (  # noqa: F401
    EMBEDDINGS,
    Embedding,
    EmbeddingParams,
    available_embeddings,
    embedding_for,
    get_embedding,
    register_embedding,
    transform,
)
from repro_torch.embed import apnc  # noqa: F401,E402  (registers nystrom and sd)
from repro_torch.embed import rff  # noqa: F401,E402  (registers rff)
from repro_torch.embed import tensorsketch  # noqa: F401,E402  (registers tensorsketch)
