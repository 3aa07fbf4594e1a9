"""The benchmark's reference change selection (plain PyTorch).

A frozen copy of ``ChangeFilter`` and ``select_change`` from the port's
``land_trendr_tpu_torch/ops/change.py``: each pixel's "greatest
disturbance" (or recovery) segment with magnitude, duration, pre-change
value and p filters, in the index's natural orientation.  The spatial
minimum-mapping-unit sieve needs the assembled raster and is not part of
the tile path (the configurations list it under ``reduced``).
"""

from __future__ import annotations

import dataclasses
import math

import torch

CHANGE_PRODUCTS = ("mask", "yod", "mag", "dur", "rate", "preval", "dsnr")


@dataclasses.dataclass(frozen=True)
class ChangeFilter:
    """Which segments qualify as "the change", and how to pick among them.

    ``kind``: ``"disturbance"`` selects segments moving in the index's
    disturbance direction (fitted drop for NBR/NDVI/TCW),
    ``"recovery"`` the opposite direction.
    ``sort``: among qualifying segments — ``"greatest"`` picks max
    ``|mag|``, ``"newest"``/``"oldest"`` pick by year of detection.
    Ties break to the earliest segment slot, deterministically.
    ``min_mag``: minimum ``|mag|`` (natural index units).
    ``min_dur``/``max_dur``: bounds on segment duration in years (the
    classic "fast disturbance" filter is ``max_dur=4``).
    ``min_preval``: minimum fitted value at the segment's start vertex.
    ``max_p``: additional p-of-F cap on top of the run's own
    ``p_val_threshold`` (1.0 = off).
    ``year_min``/``year_max``: bounds on the year of detection.
    """

    kind: str = "disturbance"
    sort: str = "greatest"
    min_mag: float = 0.0
    min_dur: float = 0.0
    max_dur: float = math.inf
    min_preval: float = -math.inf
    max_p: float = 1.0
    year_min: float = -math.inf
    year_max: float = math.inf

    def __post_init__(self) -> None:
        if self.kind not in ("disturbance", "recovery"):
            raise ValueError(f"kind={self.kind!r} not 'disturbance'|'recovery'")
        if self.sort not in ("greatest", "newest", "oldest"):
            raise ValueError(
                f"sort={self.sort!r} not 'greatest'|'newest'|'oldest'"
            )


def select_change(
    vertex_years: torch.Tensor,     # (px, NV) natural years, 0 in dead slots
    vertex_fit_vals: torch.Tensor,  # (px, NV) fitted value at each vertex
    seg_magnitude: torch.Tensor,    # (px, NM) natural-orientation fit delta
    seg_duration: torch.Tensor,     # (px, NM) years, 0 in dead slots
    seg_rate: torch.Tensor,         # (px, NM)
    model_valid: torch.Tensor,      # (px,) bool
    p_of_f: torch.Tensor,           # (px,)
    rmse: torch.Tensor,             # (px,)
    *,
    sign: float,                    # idx.DISTURBANCE_SIGN[index]
    filt: ChangeFilter,
) -> dict[str, torch.Tensor]:
    """Pick each pixel's change segment; returns per-pixel product tensors
    (``mask`` bool, ``yod`` int32, the rest in the magnitudes' dtype).

    ``yod`` (year of detection) is the first year AFTER the segment's
    start vertex — the year the change first shows in the fitted
    trajectory.  0 where no segment qualifies.  The chosen segment's
    values are gathered, then ``+ 0.0`` turns a picked −0.0 into +0.0 —
    the JAX package picks with a one-hot sum, which does the same, and
    the change rasters are compared with its byte for byte.
    """
    dtype = seg_magnitude.dtype
    dev = seg_magnitude.device
    nm = seg_magnitude.shape[1]

    def c(v: float) -> torch.Tensor:
        return torch.tensor(v, dtype=dtype, device=dev)

    zero = c(0.0)
    live = seg_duration > zero
    dmag = c(sign) * seg_magnitude  # disturbance-positive size
    want = dmag > zero if filt.kind == "disturbance" else dmag < zero
    size = torch.abs(seg_magnitude)
    preval = vertex_fit_vals[:, :nm]
    yod = vertex_years[:, :nm] + c(1.0)
    ok = (
        live
        & want
        & model_valid[:, None]
        & (p_of_f[:, None] <= c(filt.max_p))
        & (size >= c(filt.min_mag))
        & (seg_duration >= c(filt.min_dur))
        & (seg_duration <= c(filt.max_dur))
        & (preval >= c(filt.min_preval))
        & (yod >= c(filt.year_min))
        & (yod <= c(filt.year_max))
    )
    if filt.sort == "greatest":
        key = size
    elif filt.sort == "newest":
        key = yod
    else:  # oldest: argmax of negated year
        key = -yod
    keyed = torch.where(ok, key, c(-math.inf))
    # first maximum (jnp.argmax's tie rule)
    top = keyed.max(dim=1, keepdim=True).values
    slot = torch.arange(nm, device=dev)
    chosen = torch.where(keyed == top, slot, nm).min(dim=1, keepdim=True).values
    chosen = chosen.clamp(max=nm - 1)
    changed = ok.any(dim=1)

    def pick(a: torch.Tensor) -> torch.Tensor:
        sel = a.gather(1, chosen).squeeze(1) + torch.zeros((), dtype=a.dtype, device=dev)
        return torch.where(changed, sel, torch.zeros((), dtype=a.dtype, device=dev))

    mag = pick(seg_magnitude)
    dur = pick(seg_duration)
    rmse_safe = torch.where(rmse > zero, rmse, c(1.0))
    return {
        "mask": changed,
        "yod": pick(yod).to(torch.int32),
        "mag": mag,
        "dur": dur,
        "rate": pick(seg_rate),
        "preval": pick(preval),
        # disturbance signal-to-noise: change size in units of model rmse
        "dsnr": torch.where(rmse > zero, torch.abs(mag) / rmse_safe, zero),
    }
