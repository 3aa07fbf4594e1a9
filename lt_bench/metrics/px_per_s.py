"""``px_per_s`` (end to end, host clock): every real pixel whose products
landed in the window, over the window's whole time (first call into the
tile program to the last landing); padding rows are not counted."""


def read(run):
    if not run.tiles or run.window_s <= 0:
        return None
    return sum(t.px for t in run.tiles) / run.window_s
