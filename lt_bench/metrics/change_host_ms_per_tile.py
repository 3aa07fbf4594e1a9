"""``change_host_ms_per_tile`` (host clock, the program's span): the mean
host time a tile of the ``lt_tile_change`` span in
``ops/tile.py:process_tile_dn`` (the sign flips and the change
selection): the stage's enqueue, plus any block on a full launch queue."""

from lt_bench.stages import ms_per_tile


def read(run):
    return ms_per_tile(run, "lt_tile_change", "host")
