"""The embedding family: registry, routed ``transform``, and the members
(nystrom, sd, rff, tensorsketch)."""
from repro_torch.embed.base import (  # noqa: F401
    DEFAULT_EMBEDDING,
    EMBEDDINGS,
    Embedding,
    EmbeddingParams,
    EmbeddingProps,
    available_embeddings,
    embedding_for,
    get_embedding,
    props_of,
    register_embedding,
    transform,
    unregister_embedding,
)
from repro_torch.embed import apnc  # noqa: F401,E402  (registers nystrom and sd)
from repro_torch.embed import rff  # noqa: F401,E402  (registers rff)
from repro_torch.embed import tensorsketch  # noqa: F401,E402  (registers tensorsketch)
