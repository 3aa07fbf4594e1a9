"""``tile_p95_ms`` (end to end, host clock): the 95th percentile over every
tile of the window of the time from the call into ``process_tile_dn`` to
its fetch handle's ``wait()`` returning (linear interpolation)."""

import numpy as np


def read(run):
    if not run.tiles:
        return None
    return float(np.percentile([1e3 * (t.t_landed - t.t_call) for t in run.tiles], 95))
