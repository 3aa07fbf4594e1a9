"""The comparison that decides ``correct``.

Every product the timed path landed is held against the reference's, on
the rows the check sampled.  One number is compared, ``worst_gap``: the
widest of :func:`product_gaps`, any product on any sampled pixel.  A
float product's gap is ``|program - reference| / max(1, |reference|)``
(its own units where the reference is under 1 in size, relative above: a
signal-to-noise ratio may run to hundreds); an integer or bool product's
gap is the absolute difference, so a vertex, a year of detection or a
validity that differs reads 1 or more.  Equal values, NaN against NaN
included, read 0; a NaN against a number, or a shape that differs, reads
infinity.
"""

from __future__ import annotations

import numpy as np

__all__ = ["product_gaps"]


def _gap(prog: np.ndarray, ref: np.ndarray) -> float:
    if prog.shape != ref.shape:
        return float("inf")
    if ref.size == 0:
        return 0.0
    if np.issubdtype(ref.dtype, np.floating):
        a = prog.astype(np.float64)
        b = ref.astype(np.float64)
        same = (a == b) | (np.isnan(a) & np.isnan(b))
        with np.errstate(invalid="ignore"):
            g = np.abs(a - b) / np.maximum(1.0, np.abs(b))
        g = np.where(same, 0.0, np.where(np.isnan(g), np.inf, g))
        return float(g.max())
    return float(np.abs(prog.astype(np.int64) - ref.astype(np.int64)).max())


def product_gaps(prog: dict[str, np.ndarray], ref: dict[str, np.ndarray]) -> dict[str, float]:
    """Each product's widest gap; a product on one side only reads
    infinity."""
    return {
        name: _gap(prog[name], ref[name]) if name in prog and name in ref else float("inf")
        for name in sorted(set(prog) | set(ref))
    }
