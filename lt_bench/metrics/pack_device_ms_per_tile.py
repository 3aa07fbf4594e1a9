"""``pack_device_ms_per_tile`` (device, from the program's span): the mean
time a tile on the tile's compute stream from the entry event to the
exit event of the ``lt_fetch_pack`` span in
``runtime/fetch.py:TileFetcher.start`` (the products packed into one
device buffer on the compute stream), read from the CUDA events the span
records in the traced run. Where the device paces, this is the stage's
device time; where the host paces, it also holds the device's wait for
the stage's own enqueue."""

from lt_bench.stages import ms_per_tile


def read(run):
    return ms_per_tile(run, "lt_fetch_pack", "device")
