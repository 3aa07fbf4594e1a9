"""The program's own stage spans, read for the per-layer metrics.

While a profiler session records (the traced run), the port opens one
span per stage of its per-tile step
(``land_trendr_tpu_torch/utils/profiling.py:span``): ``lt_tile_prep``,
``lt_tile_segment``, ``lt_tile_ftv`` and ``lt_tile_change`` in
``ops/tile.py:process_tile_dn``, ``lt_fetch_pack`` in
``runtime/fetch.py:TileFetcher.start``.  Each logs the host's
``perf_counter`` at entry and exit, the clock of the harness's
``TileRecord``, and on the card a CUDA event on the tile's compute
stream at each end.  A program without that log reads as nothing.
"""

from __future__ import annotations

__all__ = ["ms_per_tile"]


def ms_per_tile(run, name: str, side: str) -> "float | None":
    """Mean milliseconds a tile of span ``name`` over the window (records
    whose host entry lies between the first tile's call and the last
    tile's landing): ``side`` "host" by the host's clock, "device" from
    the span's events.  None for an untraced run, a stage whose record
    count in the window is not the window's tile count (the stage did not
    run, or the log dropped some), or the device side off the card."""
    if run.trace is None or not run.tiles or (side == "device" and run.device_kind == "cpu"):
        return None
    from land_trendr_tpu_torch.utils import profiling

    log = getattr(profiling, "SPAN_LOG", None)
    if log is None:
        return None
    t0 = min(t.t_call for t in run.tiles)
    t1 = max(t.t_landed for t in run.tiles)
    recs = [r for r in log.records() if r.name == name and t0 <= r.t_enter <= t1]
    if len(recs) != len(run.tiles):
        return None
    ms = [r.host_ms if side == "host" else r.device_ms() for r in recs]
    if None in ms:
        return None
    return sum(ms) / len(ms)
