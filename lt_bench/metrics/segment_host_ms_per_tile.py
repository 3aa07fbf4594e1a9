"""``segment_host_ms_per_tile`` (host clock, the program's span): the mean
host time a tile of the ``lt_tile_segment`` span in
``ops/tile.py:process_tile_dn`` (padding to the chunk, the kernel's
launches, the crop): the stage's enqueue, plus any block on a full
launch queue."""

from lt_bench.stages import ms_per_tile


def read(run):
    return ms_per_tile(run, "lt_tile_segment", "host")
