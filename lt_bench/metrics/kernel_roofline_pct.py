"""``kernel_roofline_pct`` (device trace): the least time the window's
``segment_fused_kernel`` launches could take by bytes alone (the frozen
``lt_bench.yardstick.segment_kernel_bytes`` of the series they fit: the
real pixels the window landed times the cell's reference module's
``series_per_px``, at the cell's NY and max_segments, over the card's
published HBM peak), as a share of their summed device time.  Padding
rows of edge tiles count for nothing.  Nothing without such launches or
for a card the peaks table lacks."""

from lt_bench.spec import load_reference
from lt_bench.yardstick import peak, segment_kernel_bytes


def read(run):
    if run.trace is None or not run.launches:
        return None
    kernel_s = sum(o.end - o.start for o in run.trace.ops
                   if o.kind == "kernel" and "segment_fused_kernel" in o.name)
    bw = peak(run.device_kind, "hbm_bytes_per_s")
    if kernel_s <= 0 or bw is None:
        return None
    c = run.cell.config
    ny = c["scene"]["year_end"] - c["scene"]["year_start"] + 1
    series = load_reference(run.cell).series_per_px(c) * sum(t.px for t in run.tiles)
    nbytes = segment_kernel_bytes(series, ny, c["params"]["max_segments"],
                                  launches=run.launches)
    return 100.0 * (nbytes / bw) / kernel_s
