"""``d2h_ms_per_tile`` (device trace): device time of device-to-host copies
per tile of the window — the fetch's packed copy into pinned memory."""


def read(run):
    if run.trace is None or not run.tiles:
        return None
    s = sum(o.end - o.start for o in run.trace.ops
            if o.kind == "memcpy" and "DtoH" in o.name)
    return 1e3 * s / len(run.tiles) if s > 0 else None
