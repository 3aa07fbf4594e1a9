"""``ensemble_host_ms_per_tile`` (host clock, the program's span): the
mean host time a tile of the ``lt_tile_ensemble`` span in
``ops/tile.py:process_tile_dn`` (each further index of the ensemble
computed, the K series and their masks stacked for the one segmentation
call): the stage's enqueue, plus any block on a full launch queue.
Nothing where the program opens no such span (one index a pixel, or a
program before the ensemble)."""

from lt_bench.stages import ms_per_tile


def read(run):
    return ms_per_tile(run, "lt_tile_ensemble", "host")
