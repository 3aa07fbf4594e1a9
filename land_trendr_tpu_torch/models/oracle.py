"""``lt_ref`` — the CPU oracle: normative LandTrendr semantics in NumPy f64.

This module is the *behavioural specification* of the framework.  The
reference repo (vicchu/land_trendr) implements the LandTrendr temporal
segmentation pipeline inside a class named ``PixelSegmenter`` driven by a
``LandTrendrMapper`` (SURVEY.md §2, provenance ``[B]``); its mount was empty
during the survey (SURVEY.md §0), so this oracle — a faithful scalar
implementation of the published algorithm (Kennedy, Yang & Cohen 2010,
RSE 114(12):2897-2910; SURVEY.md §3.1) — substitutes as the
vertex-for-vertex parity target for the device kernels
(``land_trendr_tpu_torch.ops.segment.torch_segment_pixels`` and the CUDA kernel).

Every semantic decision the published description leaves open is pinned down
here, explicitly and testably (SURVEY.md §7 build-plan step 1):

* **Tie-breaking** — all argmax/argmin scans break ties toward the smallest
  index.
* **Sign convention** — the segmenter is sign-agnostic.  Index math upstream
  (``land_trendr_tpu_torch.ops.indices``) flips indices so *disturbance is an
  increase* (classic LandTrendr flips e.g. NBR × −1); under that convention
  a *recovery* segment is one whose fitted value decreases.
* **Despike** (Stage 1) — spike proportion for an interior valid point *i*
  with nearest valid neighbours *p*, *q*::

      interp   = y_p + (y_q - y_p) * (t_i - t_p) / (t_q - t_p)
      dev      = |y_i - interp|
      crossing = |y_q - y_p|
      prop_i   = 0 if dev == 0 else max(0, 1 - crossing / dev)

  ``prop == 1`` is a perfect symmetric spike; ``prop == 0`` is no spike.
  Iteratively dampen the *largest* spike (ties → smallest index) by moving
  it toward the interpolation proportionally to its severity
  (``y_i += (interp - y_i) * prop_i``) while ``prop > spike_threshold``;
  ``spike_threshold == 1.0`` therefore disables dampening.  At most
  ``n_valid`` iterations (each dampening strictly reduces that point's
  proportion, so this converges).
* **Vertex search** (Stage 2) — start from the two valid endpoints; grow to
  ``min(max_segments + 1 + vertex_count_overshoot, n_valid)`` vertices by
  repeatedly inserting the interior point with the maximum absolute
  deviation from its segment's OLS line (deviation computed per segment
  over the *closed* point range [v_a, v_b]; global argmax across segments,
  ties → smallest index; points that are already vertices are excluded).
  Insertion happens regardless of deviation magnitude (a zero-deviation
  insertion is harmless — later pruning removes it) so the loop has a fixed
  trip count.  Then cull back to ``min(max_segments + 1, n_candidates)``
  vertices by repeatedly dropping the interior vertex with the smallest
  *angle change*, computed on axis-scaled data: x and y each scaled to
  [0, 1] over the valid range (zero y-range → flat), chord slopes between
  consecutive vertices, ``angle_j = |atan(s_right) - atan(s_left)|``,
  ties → smallest index.
* **Anchored fit** (Stage 3) — segment 1 is an OLS fit over its closed
  point range; each later segment is a slope-only regression through the
  previous segment's fitted endpoint (anchor), over the half-open range
  (v_a, v_b].  Recovery constraints clamp the slope: with R = despiked
  valid range, a slope below ``-recovery_threshold * R`` per year is
  clamped to that limit, and if ``prevent_one_year_recovery`` a negative
  slope on a segment of duration ≤ 1 year is clamped to 0.  The first
  segment's slope is clamped the same way (its intercept is then re-fit as
  ``mean(y) - slope * mean(t)``).  A *point-to-point* fallback trajectory
  (observed despiked values at the vertices, linear in between) replaces
  the regression trajectory iff it violates no recovery constraint and has
  strictly smaller SSE.
* **Model pruning + F-stat selection** (Stage 4) — from the full vertex
  set, iteratively remove the weakest interior vertex (smallest angle
  change, same metric as the cull, ties → smallest index) and refit, down
  to one segment.  Each model with m segments is scored with
  ``df1 = 2m - 1`` and ``df2 = n_valid - 2m`` (each segment contributes a
  slope plus a chosen knot: 2m parameters total including intercept and
  interior knots)::

      F = ((SS0 - SSE) / df1) / (SSE / df2)
      p = F_sf(F; df1, df2)          # survival function

  Models with ``df2 < 1`` or ``SSE > SS0`` (worse than the mean) are
  invalid (p = 1).  Selection: with ``p_best`` the minimum p over valid
  models, choose the model with the *most* segments satisfying
  ``p <= p_best / best_model_proportion``; if the chosen model's p exceeds
  ``p_val_threshold`` return the flat mean model flagged no-fit.
* **Insufficient data** — fewer than ``min_observations_needed`` valid
  years → flat mean model (mean of the valid years, or 0 if none),
  flagged no-fit, with no vertices.

Outputs are fixed-size padded arrays (capacity ``max_segments + 1``
vertices / ``max_segments`` segments) so the batched device kernels can emit
the identical structure with static shapes (SURVEY.md §7 design stance).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from land_trendr_tpu_torch.config import LTParams

__all__ = [
    "SegmentationResult",
    "PixelSegmenter",
    "segment_series",
    "despike",
    "find_candidate_vertices",
    "cull_by_angle",
    "fit_model",
    "f_stat_p_value",
    "fit_to_vertices",
]


# ---------------------------------------------------------------------------
# Result container
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SegmentationResult:
    """Fixed-capacity per-pixel segmentation output (SURVEY.md §3.1 outputs).

    Arrays are padded to capacity ``NV = max_segments + 1`` vertices and
    ``NS = max_segments`` segments; ``n_vertices`` gives the live count and
    padded slots hold zeros.  ``vertex_years`` holds *year values* (not
    indices); ``vertex_indices`` holds positions into the input year axis.
    """

    n_vertices: int                 # 0 when no-fit
    vertex_indices: np.ndarray      # (NV,) int32, padded with -1
    vertex_years: np.ndarray        # (NV,) float64
    vertex_src_vals: np.ndarray     # (NV,) float64 — despiked observed values
    vertex_fit_vals: np.ndarray     # (NV,) float64 — fitted trajectory values
    seg_magnitude: np.ndarray       # (NS,) float64 — fit end − fit start
    seg_duration: np.ndarray        # (NS,) float64 — years
    seg_rate: np.ndarray            # (NS,) float64 — magnitude / duration
    rmse: float
    p_of_f: float
    model_valid: bool               # False → no-fit flat model
    fitted: np.ndarray              # (NY,) float64 — fitted value each year
    despiked: np.ndarray            # (NY,) float64 — despiked series (valid yrs)


# ---------------------------------------------------------------------------
# Stage 1 — despike
# ---------------------------------------------------------------------------


def _spike_props(t: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Spike proportion and neighbour interpolation for each interior point.

    ``t``/``y`` are the compacted valid series (no mask).  Endpoints get
    proportion 0.  Returns ``(prop, interp)`` arrays of len(y).
    """
    n = len(y)
    prop = np.zeros(n)
    interp = y.astype(np.float64).copy()
    for i in range(1, n - 1):
        tp, tq = t[i - 1], t[i + 1]
        yp, yq = y[i - 1], y[i + 1]
        itp = yp + (yq - yp) * (t[i] - tp) / (tq - tp)
        dev = abs(y[i] - itp)
        crossing = abs(yq - yp)
        interp[i] = itp
        if dev > 0.0:
            prop[i] = max(0.0, 1.0 - crossing / dev)
    return prop, interp


def despike(t: np.ndarray, y: np.ndarray, spike_threshold: float) -> np.ndarray:
    """Iteratively dampen spikes (Stage 1 spec in the module docstring)."""
    y = y.astype(np.float64).copy()
    n = len(y)
    if n < 3 or spike_threshold >= 1.0:
        return y
    for _ in range(n):
        prop, interp = _spike_props(t, y)
        i = int(np.argmax(prop))        # ties → smallest index
        if prop[i] <= spike_threshold:
            break
        y[i] += (interp[i] - y[i]) * prop[i]
    return y


# ---------------------------------------------------------------------------
# Stage 2 — candidate vertex search + angle cull
# ---------------------------------------------------------------------------


def _ols(t: np.ndarray, y: np.ndarray) -> tuple[float, float]:
    """Closed-form OLS ``y ≈ intercept + slope * t`` (n >= 1; flat if degenerate)."""
    n = len(y)
    tm, ym = float(np.mean(t)), float(np.mean(y))
    stt = float(np.sum((t - tm) ** 2))
    if n < 2 or stt == 0.0:
        return ym, 0.0
    slope = float(np.sum((t - tm) * (y - ym))) / stt
    return ym - slope * tm, slope


def find_candidate_vertices(t: np.ndarray, y: np.ndarray, n_target: int) -> list[int]:
    """Grow vertex set to ``n_target`` by max-deviation insertion (Stage 2)."""
    n = len(y)
    verts = [0, n - 1]
    n_target = min(n_target, n)
    while len(verts) < n_target:
        best_i, best_dev = -1, -1.0
        vs = sorted(verts)
        for a, b in zip(vs[:-1], vs[1:]):
            if b - a < 2:
                continue
            seg_t, seg_y = t[a : b + 1], y[a : b + 1]
            c0, c1 = _ols(seg_t, seg_y)
            for i in range(a + 1, b):
                dev = abs(y[i] - (c0 + c1 * t[i]))
                if dev > best_dev:
                    best_dev, best_i = dev, i
        if best_i < 0:
            break  # no interior points anywhere
        verts.append(best_i)
    return sorted(verts)


def _vertex_angles(t: np.ndarray, y: np.ndarray, verts: list[int]) -> np.ndarray:
    """Angle change at each interior vertex, on axis-scaled data (Stage 2)."""
    t_lo, t_hi = float(t[0]), float(t[-1])
    y_lo, y_hi = float(np.min(y)), float(np.max(y))
    t_rng = t_hi - t_lo if t_hi > t_lo else 1.0
    y_rng = y_hi - y_lo if y_hi > y_lo else 1.0
    xs = [(t[v] - t_lo) / t_rng for v in verts]
    ys = [(y[v] - y_lo) / y_rng for v in verts]
    angles = np.zeros(len(verts))
    for j in range(1, len(verts) - 1):
        s1 = (ys[j] - ys[j - 1]) / (xs[j] - xs[j - 1])
        s2 = (ys[j + 1] - ys[j]) / (xs[j + 1] - xs[j])
        angles[j] = abs(math.atan(s2) - math.atan(s1))
    return angles


def cull_by_angle(
    t: np.ndarray, y: np.ndarray, verts: list[int], n_keep: int
) -> list[int]:
    """Drop min-angle interior vertices until ``n_keep`` remain (Stage 2).

    Known sensitivity of the spec'd angle metric (SURVEY.md §3.1: "slope
    change across the vertex, computed on axis-scaled data"): with x
    scaled by the full time span, one year is dx ≈ 1/NY, so even small
    per-year noise produces near-vertical scaled slopes whose arctans
    saturate toward ±π/2 — a noise wiggle's angle can then rival a real
    disturbance corner's.  Measured (100 random noise seeds,
    0.01σ noise on a 0.45-magnitude step + slow recovery): 3/100 pixels
    lose the disturbance vertex to noise vertices at this stage and fall
    back to the 1-segment model.  This is a property of the published
    algorithm's angle formulation, reproduced faithfully here — not a
    kernel defect (the JAX/Pallas kernels match this oracle bit-for-bit);
    lower ``vertex_count_overshoot`` or stronger despike reduce the
    exposure.
    """
    verts = sorted(verts)
    n_keep = max(n_keep, 2)
    while len(verts) > n_keep:
        angles = _vertex_angles(t, y, verts)
        j = 1 + int(np.argmin(angles[1:-1]))  # interior only; ties → smallest
        verts.pop(j)
    return verts


# ---------------------------------------------------------------------------
# Stage 3 — anchored piecewise-linear fit with recovery constraints
# ---------------------------------------------------------------------------


def _clamp_slope(
    slope: float, duration: float, y_range: float, params: LTParams
) -> float:
    """Apply the recovery-rate constraints to a candidate segment slope.

    Disturbance-positive convention: recovery ⇔ negative slope.
    """
    if slope >= 0.0 or y_range <= 0.0:
        return slope
    if params.prevent_one_year_recovery and duration <= 1.0:
        return 0.0
    limit = -params.recovery_threshold * y_range
    return max(slope, limit)


def _segment_violates(
    dy: float, duration: float, y_range: float, params: LTParams
) -> bool:
    """True if a segment's total change violates the recovery constraints."""
    if dy >= 0.0 or y_range <= 0.0 or duration <= 0.0:
        return False
    if params.prevent_one_year_recovery and duration <= 1.0:
        return True
    return (-dy) / duration > params.recovery_threshold * y_range + 1e-12


def fit_model(
    t: np.ndarray,
    y: np.ndarray,
    verts: list[int],
    params: LTParams,
    y_range: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Anchored piecewise-linear LSQ fit through ``verts`` (Stage 3).

    Returns ``(fitted, vertex_fit_vals)`` where ``fitted`` has one value per
    (valid) year and ``vertex_fit_vals`` one per vertex.  Chooses the
    point-to-point fallback when it is constraint-clean and strictly better
    (module docstring).
    """
    n = len(y)
    verts = sorted(verts)
    lo, hi = verts[0], verts[-1]
    fitted = np.zeros(n)

    # --- anchored regression trajectory ---
    a, b = verts[0], verts[1]
    seg_t, seg_y = t[a : b + 1], y[a : b + 1]
    c0, c1 = _ols(seg_t, seg_y)
    c1c = _clamp_slope(c1, float(t[b] - t[a]), y_range, params)
    if c1c != c1:
        c0 = float(np.mean(seg_y)) - c1c * float(np.mean(seg_t))
        c1 = c1c
    fitted[a : b + 1] = c0 + c1 * seg_t
    anchor_t, anchor_y = float(t[b]), float(fitted[b])
    for a, b in zip(verts[1:-1], verts[2:]):
        seg_t, seg_y = t[a + 1 : b + 1], y[a + 1 : b + 1]
        dt = seg_t - anchor_t
        denom = float(np.sum(dt * dt))
        slope = float(np.sum(dt * (seg_y - anchor_y))) / denom if denom > 0 else 0.0
        slope = _clamp_slope(slope, float(t[b] - anchor_t), y_range, params)
        fitted[a + 1 : b + 1] = anchor_y + slope * dt
        anchor_t, anchor_y = float(t[b]), float(fitted[b])

    # --- point-to-point fallback ---
    # SSE comparisons use only the vertex span [lo, hi]; outside the span the
    # trajectory is extended flat (matches np.interp's edge behaviour).
    p2p = np.zeros(n)
    p2p_ok = True
    for a, b in zip(verts[:-1], verts[1:]):
        dur = float(t[b] - t[a])
        dy = float(y[b] - y[a])
        if _segment_violates(dy, dur, y_range, params):
            p2p_ok = False
            break
        seg_t = t[a : b + 1]
        p2p[a : b + 1] = y[a] + (dy / dur if dur > 0 else 0.0) * (seg_t - t[a])
    if p2p_ok:
        sse_reg = float(np.sum((y[lo : hi + 1] - fitted[lo : hi + 1]) ** 2))
        sse_p2p = float(np.sum((y[lo : hi + 1] - p2p[lo : hi + 1]) ** 2))
        if sse_p2p < sse_reg:
            fitted = p2p

    fitted[:lo] = fitted[lo]
    fitted[hi + 1 :] = fitted[hi]
    return fitted, fitted[np.asarray(verts, dtype=int)].copy()


# ---------------------------------------------------------------------------
# Stage 4 — F-statistic scoring, model pruning, selection
# ---------------------------------------------------------------------------


def f_stat_p_value(ss0: float, sse: float, n: int, n_segments: int) -> float:
    """p-of-F for a model (Stage 4 dof spec: df1 = 2m−1, df2 = n−2m)."""
    m = n_segments
    df1, df2 = 2 * m - 1, n - 2 * m
    if df2 < 1 or ss0 <= 0.0 or sse >= ss0:
        return 1.0
    if sse <= 0.0:
        return 0.0
    f = ((ss0 - sse) / df1) / (sse / df2)
    # survival function of F(df1, df2) via the regularised incomplete beta
    from scipy.special import betainc

    x = df2 / (df2 + df1 * f)
    return float(betainc(df2 / 2.0, df1 / 2.0, x))


# ---------------------------------------------------------------------------
# Top-level per-pixel pipeline
# ---------------------------------------------------------------------------


def _flat_result(
    params: LTParams,
    years: np.ndarray,
    values: np.ndarray,
    mask: np.ndarray,
    despiked_valid: np.ndarray | None = None,
) -> SegmentationResult:
    """No-fit flat model: mean of valid years (0 if none), no vertices.

    When despiking already ran, ``despiked_valid`` (the compacted despiked
    valid series) supplies the mean/rmse/despiked outputs so the flat model
    is consistent with the series the pipeline actually scored.
    """
    nv, ns, ny = params.max_vertices, params.max_segments, len(years)
    y_valid = despiked_valid if despiked_valid is not None else values[mask]
    mean = float(np.mean(y_valid)) if mask.any() else 0.0
    despiked_full = values.astype(np.float64).copy()
    despiked_full[~mask] = mean
    if despiked_valid is not None:
        despiked_full[mask] = despiked_valid
    return SegmentationResult(
        n_vertices=0,
        vertex_indices=np.full(nv, -1, dtype=np.int32),
        vertex_years=np.zeros(nv),
        vertex_src_vals=np.zeros(nv),
        vertex_fit_vals=np.zeros(nv),
        seg_magnitude=np.zeros(ns),
        seg_duration=np.zeros(ns),
        seg_rate=np.zeros(ns),
        rmse=float(np.sqrt(np.mean((y_valid - mean) ** 2))) if mask.any() else 0.0,
        p_of_f=1.0,
        model_valid=False,
        fitted=np.full(ny, mean),
        despiked=despiked_full,
    )


def segment_series(
    years: np.ndarray,
    values: np.ndarray,
    mask: np.ndarray,
    params: LTParams,
) -> SegmentationResult:
    """Run the full LandTrendr pipeline on one pixel's annual series.

    Parameters
    ----------
    years : (NY,) year values (monotonically increasing).
    values : (NY,) spectral-index values, disturbance-positive convention.
    mask : (NY,) bool — True where the observation is valid.
    params : algorithm parameters (static).
    """
    years = np.asarray(years, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    # non-finite observations are invalid regardless of the caller's mask
    # (the device kernels apply the identical guard)
    mask = np.asarray(mask, dtype=bool) & np.isfinite(values)
    ny = len(years)
    valid_idx = np.flatnonzero(mask)
    n = len(valid_idx)
    if n < params.min_observations_needed:
        return _flat_result(params, years, values, mask)

    t = years[valid_idx]
    y_raw = values[valid_idx]

    # Stage 1
    y = despike(t, y_raw, params.spike_threshold)
    y_range = float(np.max(y) - np.min(y))
    if y_range <= 0.0:
        # constant series: no structure to segment — no-change model
        return _flat_result(params, years, values, mask, despiked_valid=y)

    # Stage 2
    cand = find_candidate_vertices(t, y, params.max_candidates)
    verts_full = cull_by_angle(t, y, cand, min(params.max_vertices, len(cand)))

    # Stage 4 model family: prune weakest interior vertex, refit each time
    ss0 = float(np.sum((y - np.mean(y)) ** 2))
    models: list[tuple[list[int], np.ndarray, np.ndarray, float]] = []
    verts = list(verts_full)
    while True:
        fitted, vfit = fit_model(t, y, verts, params, y_range)
        sse = float(np.sum((y - fitted) ** 2))
        p = f_stat_p_value(ss0, sse, n, len(verts) - 1)
        models.append((list(verts), fitted, vfit, p))
        if len(verts) <= 2:
            break
        angles = _vertex_angles(t, y, verts)
        j = 1 + int(np.argmin(angles[1:-1]))
        verts.pop(j)

    # Selection
    p_best = min(p for *_x, p in models)
    chosen = None
    for verts_m, fitted_m, vfit_m, p_m in models:  # models ordered most→fewest segs
        if p_m <= p_best / params.best_model_proportion:
            chosen = (verts_m, fitted_m, vfit_m, p_m)
            break
    assert chosen is not None
    verts_c, fitted_c, vfit_c, p_c = chosen
    if p_c > params.p_val_threshold:
        return _flat_result(params, years, values, mask, despiked_valid=y)

    # Assemble fixed-capacity outputs
    nv_cap, ns_cap = params.max_vertices, params.max_segments
    k = len(verts_c)
    vertex_indices = np.full(nv_cap, -1, dtype=np.int32)
    vertex_years = np.zeros(nv_cap)
    vertex_src = np.zeros(nv_cap)
    vertex_fit = np.zeros(nv_cap)
    vertex_indices[:k] = valid_idx[verts_c]
    vertex_years[:k] = t[verts_c]
    vertex_src[:k] = y[verts_c]
    vertex_fit[:k] = vfit_c

    seg_mag = np.zeros(ns_cap)
    seg_dur = np.zeros(ns_cap)
    seg_rate = np.zeros(ns_cap)
    for s in range(k - 1):
        seg_mag[s] = vfit_c[s + 1] - vfit_c[s]
        seg_dur[s] = t[verts_c[s + 1]] - t[verts_c[s]]
        seg_rate[s] = seg_mag[s] / seg_dur[s] if seg_dur[s] > 0 else 0.0

    # Year-axis fitted values: interpolate the fitted trajectory across all
    # years (masked years get the trajectory value; outside the vertex span
    # the trajectory is extended flat).
    fitted_full = np.interp(years, t[verts_c], vfit_c)
    sse = float(np.sum((y - fitted_c) ** 2))
    despiked_full = values.astype(np.float64).copy()
    despiked_full[valid_idx] = y

    return SegmentationResult(
        n_vertices=k,
        vertex_indices=vertex_indices,
        vertex_years=vertex_years,
        vertex_src_vals=vertex_src,
        vertex_fit_vals=vertex_fit,
        seg_magnitude=seg_mag,
        seg_duration=seg_dur,
        seg_rate=seg_rate,
        rmse=float(np.sqrt(sse / n)),
        p_of_f=p_c,
        model_valid=True,
        fitted=fitted_full,
        despiked=despiked_full,
    )


def fit_to_vertices(
    years: np.ndarray,
    values: np.ndarray,
    mask: np.ndarray,
    vertex_indices: np.ndarray,
    n_vertices: int,
    params: LTParams,
) -> np.ndarray:
    """FTV: fit *another* index's series to an already-chosen vertex set.

    Classic LandTrendr "fitted trajectory values" (SURVEY.md §3.1 outputs):
    the vertex years come from the segmentation index; the target series is
    anchored-fit through those years.  Returns the full-year fitted series.
    """
    years = np.asarray(years, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    mask = np.asarray(mask, dtype=bool) & np.isfinite(values)
    valid_idx = np.flatnonzero(mask)
    if n_vertices < 2 or len(valid_idx) < 2:
        mean = float(np.mean(values[mask])) if mask.any() else 0.0
        return np.full(len(years), mean)
    t = years[valid_idx]
    y = values[valid_idx]
    # map stack-axis vertex indices → positions in the valid subsequence
    pos = np.searchsorted(valid_idx, vertex_indices[:n_vertices])
    pos = np.clip(pos, 0, len(valid_idx) - 1)
    verts = sorted(set(int(p) for p in pos))
    if len(verts) < 2:
        verts = [0, len(valid_idx) - 1]
    y_range = float(np.max(y) - np.min(y))
    fitted, vfit = fit_model(t, y, verts, params, y_range)
    return np.interp(years, t[verts], vfit)


class PixelSegmenter:
    """Seam-compatible facade over :func:`segment_series`.

    Mirrors the reference's ``PixelSegmenter`` class boundary (SURVEY.md §2,
    the ``LandTrendrMapper``/``PixelSegmenter`` plugin seam, provenance
    ``[B]``): construct with parameters, call :meth:`segment` per series.
    The device path replaces this with the batched
    ``torch_segment_pixels`` / CUDA kernel operator at the same seam.
    """

    def __init__(self, params: LTParams | None = None):
        self.params = params or LTParams()

    def segment(
        self,
        years: np.ndarray,
        values: np.ndarray,
        mask: np.ndarray | None = None,
    ) -> SegmentationResult:
        if mask is None:
            mask = np.isfinite(np.asarray(values, dtype=np.float64))
        return segment_series(years, values, mask, self.params)
