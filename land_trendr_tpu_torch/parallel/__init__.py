"""parallel subpackage: pixel-axis sharding over local devices and
multi-process (pod) runs."""

from land_trendr_tpu_torch.parallel.mesh import (
    PIXEL_AXIS,
    make_mesh,
    pad_to_multiple,
    segment_pixels_sharded,
    shard_pixels,
    summarize_sharded,
)
from land_trendr_tpu_torch.parallel.multihost import (
    LocalRows,
    feed_global,
    gather_local_rows,
    host_share,
    init_distributed,
    is_primary_host,
    merge_host_event_logs,
    process_count,
    process_index,
)

__all__ = [
    "PIXEL_AXIS",
    "make_mesh",
    "pad_to_multiple",
    "segment_pixels_sharded",
    "shard_pixels",
    "summarize_sharded",
    "LocalRows",
    "feed_global",
    "gather_local_rows",
    "host_share",
    "init_distributed",
    "is_primary_host",
    "merge_host_event_logs",
    "process_count",
    "process_index",
]
