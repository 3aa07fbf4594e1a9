"""``ensemble_device_ms_per_tile`` (device, from the program's span): the
mean time a tile on the tile's compute stream from the entry event to
the exit event of the ``lt_tile_ensemble`` span in
``ops/tile.py:process_tile_dn`` (each further index of the ensemble
computed, the K series and their masks stacked for the one segmentation
call), read from the CUDA events the span records in the traced run.
Nothing where the program opens no such span (one index a pixel, or a
program before the ensemble)."""

from lt_bench.stages import ms_per_tile


def read(run):
    return ms_per_tile(run, "lt_tile_ensemble", "device")
