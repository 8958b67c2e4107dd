"""repro_torch.stream: the out-of-core block engine of embed-and-conquer.

The paper's premise is data in blocks that never sit together on one
worker; this package is its single-host counterpart: host-resident row
blocks (`blockstore`), a MapReduce-style executor with a pipelined
host -> device copy (`engine`), the streaming Lloyd drivers (`lloyd`), the
sharded executor that streams one block shard a device of a device list
(`sharded`), reservoir sampling for landmark and seed selection over
streams (`reservoir`), and the request micro-batcher of the online
assignment service (`microbatch`).
"""
from repro_torch.stream.blockstore import BlockStore
from repro_torch.stream.engine import (
    BlockPrefetcher,
    cache_embedding,
    map_reduce,
    pass_count,
    reset_pass_counts,
)
from repro_torch.stream.sharded import (
    cross_device_sum,
    shard_devices,
    sharded_map_reduce,
    stream_embed_sharded,
)
from repro_torch.stream.lloyd import (
    StreamLloydResult,
    minibatch_lloyd,
    ooc_lloyd,
    stream_embed,
    stream_fit_predict,
)
from repro_torch.stream.microbatch import MicroBatcher
from repro_torch.stream.reservoir import reservoir_sample

__all__ = [
    "BlockPrefetcher",
    "BlockStore",
    "cache_embedding",
    "cross_device_sum",
    "map_reduce",
    "MicroBatcher",
    "pass_count",
    "reset_pass_counts",
    "shard_devices",
    "sharded_map_reduce",
    "StreamLloydResult",
    "minibatch_lloyd",
    "ooc_lloyd",
    "reservoir_sample",
    "stream_embed",
    "stream_embed_sharded",
    "stream_fit_predict",
]
