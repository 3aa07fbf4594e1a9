"""Synthetic pixel populations: the mixed-regime one of the stage probe
and the chip smoke — a copy of the JAX package's ``tools/_population.py``
(``make_population``) — and the headline bench's (``make_series``, for
``arch_speedup``), numpy only, with the same draw order, so a seed gives
the same population in both packages.

Five regimes — exp-recovery disturbance, step, linear trend, scaled random
walk, flat — plus spikes, noise and masking, in the disturbance-positive
convention the kernels take.
"""

from __future__ import annotations

import numpy as np


def make_population(
    rng: np.random.Generator,
    px: int,
    ny: int,
    *,
    base_lo: float = 0.45,
    base_hi: float = 0.75,
    noise: float = 0.012,
    d_margin_lo: int = 4,
    d_margin_hi: int = 4,
    mag_lo: float = 0.1,
    mag_hi: float = 0.5,
    rec_lo: float = 0.02,
    rec_hi: float = 0.15,
    spike: str = "rows",       # "rows": one spike col on a fraction of
    spike_frac: float = 0.2,   # pixels; "elementwise": per-cell probability
    spike_prob: float = 0.03,
    mask_drop: float = 0.08,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(years, disturbance-positive float64 series, validity mask)."""
    years = np.arange(1984, 1984 + ny, dtype=np.int32)
    t = np.arange(ny, dtype=np.float64)[None, :]
    kind = rng.integers(0, 5, size=(px, 1))

    base = rng.uniform(base_lo, base_hi, size=(px, 1))
    noise_arr = rng.normal(0.0, noise, size=(px, ny))

    d_year = rng.integers(d_margin_lo, ny - d_margin_hi, size=(px, 1))
    mag = rng.uniform(mag_lo, mag_hi, size=(px, 1))
    rec = rng.uniform(rec_lo, rec_hi, size=(px, 1))
    dt = np.maximum(t - d_year, 0.0)
    disturbance = np.where(t >= d_year, mag * np.exp(-rec * dt), 0.0)

    step = np.where(t >= d_year, mag, 0.0)
    trend = rng.uniform(-0.01, 0.01, size=(px, 1)) * t
    walk = np.cumsum(rng.normal(0, 0.03, size=(px, ny)), axis=1)

    traj = base - np.where(
        kind == 0, disturbance,
        np.where(kind == 1, step,
                 np.where(kind == 2, trend,
                          np.where(kind == 3, walk * 0.2, 0.0))),
    )
    if spike == "rows":
        spike_rows = rng.uniform(size=(px, 1)) < spike_frac
        spike_col = rng.integers(0, ny, size=(px,))
        spike_amp = rng.uniform(0.2, 0.8, size=(px,))
        traj[np.arange(px), spike_col] += np.where(
            spike_rows[:, 0], spike_amp, 0.0
        )
    elif spike == "elementwise":
        cells = rng.uniform(size=(px, ny)) < spike_prob
        traj = traj + np.where(cells, rng.uniform(0.2, 0.8, (px, ny)), 0.0)
    else:
        raise ValueError(f"spike={spike!r} not 'rows'|'elementwise'")
    traj = traj + noise_arr
    mask = rng.uniform(size=(px, ny)) > mask_drop
    return years, -traj, mask


def make_series(px: int, ny: int, seed: int = 7) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Disturbance-positive NBR-like series + mask, float32: a copy of the
    JAX package's ``bench.make_series`` (the same draws in the same order,
    so a ``(px, ny, seed)`` gives the same population in both packages)."""
    rng = np.random.default_rng(seed)
    years = np.arange(1984, 1984 + ny, dtype=np.int32)
    base = rng.uniform(0.55, 0.75, size=(px, 1)).astype(np.float32)
    t = np.arange(ny, dtype=np.float32)[None, :]
    disturbed = rng.uniform(size=(px, 1)) < 0.35
    d_year = rng.integers(5, ny - 5, size=(px, 1))
    mag = rng.uniform(0.15, 0.5, size=(px, 1)).astype(np.float32)
    rec = rng.uniform(0.03, 0.15, size=(px, 1)).astype(np.float32)
    dt = np.maximum(t - d_year, 0.0).astype(np.float32)
    traj = base - np.where(disturbed & (t >= d_year), mag * np.exp(-rec * dt), 0.0)
    traj += rng.normal(0.0, 0.012, size=(px, ny)).astype(np.float32)
    mask = rng.uniform(size=(px, ny)) > 0.08
    return years, (-traj).astype(np.float32), mask
