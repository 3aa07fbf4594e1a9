"""``tile_ops_ms_per_tile`` (device trace): device time of every kernel but
``segment_fused_kernel`` per tile of the window — the tile program's
plain-PyTorch ops (DN scaling, masks, indices, FTV, change selection,
padding) and the fetch's pack."""


def read(run):
    if run.trace is None or not run.tiles:
        return None
    s = sum(o.end - o.start for o in run.trace.ops
            if o.kind == "kernel" and "segment_fused_kernel" not in o.name)
    return 1e3 * s / len(run.tiles) if s > 0 else None
