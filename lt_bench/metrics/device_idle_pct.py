"""``device_idle_pct`` (device trace): the share of the traced window with
neither a kernel nor a copy nor a fill on the card."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
