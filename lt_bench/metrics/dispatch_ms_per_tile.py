"""``dispatch_ms_per_tile`` (host clock, the harness's span): the mean time
of the call into ``process_tile_dn`` per tile — the host's enqueue of the
tile program plus any block on a full launch queue."""


def read(run):
    if run.trace is None or not run.tiles:
        return None
    return 1e3 * sum(t.t_dispatched - t.t_call for t in run.tiles) / len(run.tiles)
