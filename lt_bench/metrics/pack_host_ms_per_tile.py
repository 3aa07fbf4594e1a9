"""``pack_host_ms_per_tile`` (host clock, the program's span): the mean
host time a tile of the ``lt_fetch_pack`` span in
``runtime/fetch.py:TileFetcher.start`` (the products packed into one
device buffer on the compute stream): the stage's enqueue, plus any
block on a full launch queue."""

from lt_bench.stages import ms_per_tile


def read(run):
    return ms_per_tile(run, "lt_fetch_pack", "host")
