"""The benchmark's reference segmentation: plain PyTorch LandTrendr.

A frozen copy of the port's plain version (``land_trendr_tpu_torch/
ops/segment.py``, the batched ``(PX, NY)`` re-expression of the oracle
that the port's CPU tests hold against the JAX package and the oracle),
with its one import pointed at :mod:`lt_bench.reference.params`.  It
imports nothing of the program, so a later change to the program's
segmentation, kernel or plain version leaves this yardstick as it is.

Design (as in the original): each pixel's valid years are moved to the
front of its row and every stage runs on the compacted row; every
per-pixel sum is taken in year order, one year at a time
(:func:`_seqsum`); ties in every argmax/argmin go to the smallest
position; float32 scoring is the fixed-trip Lentz evaluation with the
fixed-step log-gamma, float64 scoring a regularised incomplete beta run
to convergence (:func:`betainc`).

Shape names: ``NY`` years, ``NC = max_segments + 1 + vertex_count_overshoot``
candidate capacity, ``NV = max_segments + 1`` vertex capacity,
``NM = max_segments`` model-family slots.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from lt_bench.reference.params import LTParams

__all__ = [
    "SegOutputs",
    "betainc",
    "lentz_iters",
    "torch_family_stats",
    "torch_segment_pixels",
]

_EPS_RATE = 1e-12  # oracle._segment_violates
#: sentinel log-p of a perfect (sse == 0) model; far below any series value
_LOGP_PERFECT = -1e30
_HALF_LOG_2PI = 0.9189385332046727  # 0.5 * log(2*pi)
#: float64 continued fraction: stop once a full step changes h by less
#: than this (relative), or after this many steps
_CF_EPS = 1e-15
_CF_MAXIT = 300
_CF_TINY = 1e-300


class SegOutputs(NamedTuple):
    """Per-pixel outputs, each with a leading pixel axis; the fields,
    shapes and dtypes of the JAX package's ``SegOutputs``."""

    n_vertices: torch.Tensor      # (PX,) int32
    vertex_indices: torch.Tensor  # (PX, NV) int32, padded -1
    vertex_years: torch.Tensor    # (PX, NV)
    vertex_src_vals: torch.Tensor # (PX, NV)
    vertex_fit_vals: torch.Tensor # (PX, NV)
    seg_magnitude: torch.Tensor   # (PX, NM)
    seg_duration: torch.Tensor    # (PX, NM)
    seg_rate: torch.Tensor        # (PX, NM)
    rmse: torch.Tensor            # (PX,)
    p_of_f: torch.Tensor          # (PX,)
    model_valid: torch.Tensor     # (PX,) bool
    fitted: torch.Tensor          # (PX, NY)
    despiked: torch.Tensor        # (PX, NY)


def lentz_iters(ny: int) -> int:
    """Float32 Lentz trip count for a year axis of ``ny`` entries — the JAX
    package's ``_lentz_iters``: 12 up to NY = 40, then the sqrt-of-dof rule."""
    return max(12, int(2.5 * math.sqrt((ny + 10) / 2.0)))


def result_dtype(dtype: torch.dtype) -> torch.dtype:
    """Working dtype for values of ``dtype``: float64 stays, all else float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _seqsum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, one element at a time in index order — the
    kernel's loop order, independent of the device's reduction order."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _first_max(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(max, first index of it)`` over the last axis."""
    mx = x.max(dim=-1).values
    iota = torch.arange(x.shape[-1], device=x.device)
    idx = torch.where(x == mx.unsqueeze(-1), iota, x.shape[-1]).min(dim=-1).values
    return mx, idx


def _first_min(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(min, first index of it)`` over the last axis."""
    mn = x.min(dim=-1).values
    iota = torch.arange(x.shape[-1], device=x.device)
    idx = torch.where(x == mn.unsqueeze(-1), iota, x.shape[-1]).min(dim=-1).values
    return mn, idx


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``a[p, idx[p, ...]]`` along the last axis; ``idx`` is clamped into
    range, so sentinel slots read a real (ignored) element."""
    idx = idx.clamp(0, a.shape[-1] - 1)
    if idx.dim() == 1:
        return a.gather(-1, idx.unsqueeze(-1)).squeeze(-1)
    return a.gather(-1, idx)


def _positions(vmask: torch.Tensor, size: int) -> torch.Tensor:
    """Sorted set positions of each row of ``vmask``, padded with NY."""
    ny = vmask.shape[-1]
    iota = torch.arange(ny, device=vmask.device)
    key = torch.where(vmask, iota, ny)
    pos = torch.sort(key, dim=-1).values
    if size <= ny:
        return pos[..., :size]
    pad = torch.full((*pos.shape[:-1], size - ny), ny, dtype=pos.dtype, device=pos.device)
    return torch.cat([pos, pad], dim=-1)


class _Ctx:
    """Per-call constants: dtype, device, parameters cast to the dtype."""

    def __init__(self, params: LTParams, dtype: torch.dtype, device, ny: int):
        self.params = params
        self.dtype = dtype
        self.device = device
        self.ny = ny
        self.iota = torch.arange(ny, device=device)

        def c(v: float) -> torch.Tensor:
            return torch.tensor(v, dtype=dtype, device=device)

        self.c = c
        self.zero = c(0.0)
        self.one = c(1.0)
        self.rt = c(params.recovery_threshold)
        self.eps_rate = c(_EPS_RATE)
        self.spike = c(params.spike_threshold)
        self.pval = c(params.p_val_threshold)


# ---------------------------------------------------------------------------
# Stage 1 — despike
# ---------------------------------------------------------------------------


def _shift_prev(a: torch.Tensor) -> torch.Tensor:
    """``a[i-1]`` at each position (0 at position 0)."""
    return torch.cat([torch.zeros_like(a[..., :1]), a[..., :-1]], dim=-1)


def _shift_next(a: torch.Tensor) -> torch.Tensor:
    """``a[i+1]`` at each position (0 at the last position)."""
    return torch.cat([a[..., 1:], torch.zeros_like(a[..., :1])], dim=-1)


def _despike(cx: _Ctx, t: torch.Tensor, y: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Iteratively damp the largest interior spike (oracle ``despike``).

    Each trip damps at most one position per pixel; a pixel whose largest
    spike proportion is not above the threshold is done (its later trips
    would be no-ops), and a pixel makes at most ``n`` trips.
    """
    if cx.params.spike_threshold >= 1.0:
        return y
    iota = cx.iota
    interior = (iota >= 1) & (iota <= (n - 2).unsqueeze(-1))
    tp, tq = _shift_prev(t), _shift_next(t)
    dtp = t - tp
    denom = torch.where(interior, tq - tp, cx.one)
    neg1 = -cx.one
    for it in range(cx.ny):
        yp, yq = _shift_prev(y), _shift_next(y)
        itp = yp + (yq - yp) * dtp / denom
        dev = torch.abs(y - itp)
        crossing = torch.abs(yq - yp)
        pos = dev > 0.0
        prop = torch.where(
            pos,
            torch.maximum(cx.zero, cx.one - crossing / torch.where(pos, dev, cx.one)),
            cx.zero,
        )
        prop = torch.where(interior, prop, neg1)
        mx, i = _first_max(prop)
        do = (mx > cx.spike) & (it < n)
        if not bool(do.any()):
            break
        y_i = _take(y, i)
        y_new = y_i + (_take(itp, i) - y_i) * mx
        hit = (iota == i.unsqueeze(-1)) & do.unsqueeze(-1)
        y = torch.where(hit, y_new.unsqueeze(-1), y)
    return y


# ---------------------------------------------------------------------------
# least squares and the anchored fit
# ---------------------------------------------------------------------------


def _masked_ols(cx: _Ctx, t, y, member):
    """``(slope, tm, ym)`` of the OLS line over ``member``: the line is
    ``ym + slope * (t - tm)``, in the frame centred on the member years (an
    intercept at year 0 would amplify the slope's last bit by ``tm``).

    ``t``/``y`` broadcast against ``member`` (``(..., NY)``); the sums run
    in year order — the kernel's two passes over the member years.
    """
    one = cx.one
    zero = cx.zero
    n, st, sy = _seqsum(
        torch.stack(
            [
                torch.where(member, one, zero),
                torch.where(member, t, zero),
                torch.where(member, y, zero),
            ],
            dim=-2,
        )
    ).unbind(-1)
    n_safe = torch.maximum(n, one)
    tm = st / n_safe
    ym = sy / n_safe
    d = t - tm.unsqueeze(-1)
    stt, sty = _seqsum(
        torch.stack(
            [
                torch.where(member, d * d, zero),
                torch.where(member, d * (y - ym.unsqueeze(-1)), zero),
            ],
            dim=-2,
        )
    ).unbind(-1)
    ok = (n >= 2.0) & (stt > 0.0)
    slope = torch.where(ok, sty / torch.where(ok, stt, one), zero)
    return slope, tm, ym


def _clamp_slope(cx: _Ctx, slope, duration, y_range):
    """Recovery-rate constraints on a candidate slope (disturbance-positive)."""
    limit = -cx.rt * y_range
    clamped = torch.maximum(slope, limit)
    if cx.params.prevent_one_year_recovery:
        clamped = torch.where(duration <= 1.0, cx.zero, clamped)
    active = (slope < 0.0) & (y_range > 0.0)
    return torch.where(active, clamped, slope)


def _fit_model(cx: _Ctx, t, y, valid, vmask, y_range):
    """Anchored fit + point-to-point fallback for one vertex set per pixel.

    Returns ``(fitted, sse)``: the fitted value at every compacted position
    inside the vertex span, and the SSE over that span (the JAX package's
    ``_fit_model``).
    """
    params = cx.params
    nv = params.max_vertices
    iota = cx.iota
    zero, one = cx.zero, cx.one
    vpos = _positions(vmask, nv)                      # (P, NV)
    n_verts = vmask.sum(-1)
    tv = _take(t, vpos)
    yv = _take(y, vpos)

    # --- segment 0: OLS over closed [v0, v1] ---
    member0 = (iota >= vpos[:, :1]) & (iota <= vpos[:, 1:2]) & valid
    c1, tm, ym = _masked_ols(cx, t, y, member0)
    c1c = _clamp_slope(cx, c1, tv[:, 1] - tv[:, 0], y_range)
    fitted = torch.where(
        member0, ym.unsqueeze(-1) + c1c.unsqueeze(-1) * (t - tm.unsqueeze(-1)), zero
    )
    anchor_t = tv[:, 1]
    anchor_y = ym + c1c * (anchor_t - tm)

    # --- segments 1..: slope-only regression through the anchor ---
    for k in range(1, nv - 1):
        active = (k + 1) < n_verts
        member = (
            (iota > vpos[:, k : k + 1])
            & (iota <= vpos[:, k + 1 : k + 2])
            & valid
            & active.unsqueeze(-1)
        )
        dt = t - anchor_t.unsqueeze(-1)
        denom, num = _seqsum(
            torch.stack(
                [
                    torch.where(member, dt * dt, zero),
                    torch.where(member, dt * (y - anchor_y.unsqueeze(-1)), zero),
                ],
                dim=-2,
            )
        ).unbind(-1)
        pos = denom > 0.0
        slope = torch.where(pos, num / torch.where(pos, denom, one), zero)
        slope = _clamp_slope(cx, slope, tv[:, k + 1] - anchor_t, y_range)
        fitted = torch.where(
            member, anchor_y.unsqueeze(-1) + slope.unsqueeze(-1) * dt, fitted
        )
        new_anchor_y = anchor_y + slope * (tv[:, k + 1] - anchor_t)
        anchor_t = torch.where(active, tv[:, k + 1], anchor_t)
        anchor_y = torch.where(active, new_anchor_y, anchor_y)

    # --- point-to-point fallback ---
    ks = torch.arange(nv - 1, device=cx.device)
    active_s = (ks + 1) < n_verts.unsqueeze(-1)        # (P, NV-1)
    dur_s = tv[:, 1:] - tv[:, :-1]
    dy_s = yv[:, 1:] - yv[:, :-1]
    yr = y_range.unsqueeze(-1)
    pos_dur = dur_s > 0.0
    viol = (dy_s < 0.0) & (yr > 0.0) & pos_dur
    too_fast = (-dy_s) / torch.where(pos_dur, dur_s, one) > cx.rt * yr + cx.eps_rate
    if params.prevent_one_year_recovery:
        too_fast = too_fast | (dur_s <= 1.0)
    viol = viol & too_fast
    p2p_ok = ~(viol & active_s).any(-1)
    rate_s = torch.where(pos_dur, dy_s / torch.where(pos_dur, dur_s, one), zero)
    # a vertex year belongs to the segment STARTING at it; the last vertex
    # to the segment ending at it
    seg_of = torch.minimum(
        torch.cumsum(vmask.to(torch.int64), -1) - 1, (n_verts - 2).unsqueeze(-1)
    ).clamp(0, nv - 2)
    first = vpos[:, :1]
    last = _take(vpos, (n_verts - 1).clamp(min=0)).unsqueeze(-1)
    span = valid & (iota >= first) & (iota <= last)
    member_y = span & _take(active_s, seg_of)
    p2p0 = torch.where((iota == first) & valid, y, zero)
    p2p = torch.where(
        member_y,
        _take(yv[:, :-1], seg_of) + _take(rate_s, seg_of) * (t - _take(tv[:, :-1], seg_of)),
        p2p0,
    )
    r_reg = y - fitted
    r_p2p = y - p2p
    sse_reg, sse_p2p = _seqsum(
        torch.stack(
            [torch.where(span, r_reg * r_reg, zero), torch.where(span, r_p2p * r_p2p, zero)],
            dim=-2,
        )
    ).unbind(-1)
    use_p2p = p2p_ok & (sse_p2p < sse_reg)
    fitted = torch.where(use_p2p.unsqueeze(-1), p2p, fitted)
    sse = torch.where(use_p2p, sse_p2p, sse_reg)
    return fitted, sse


# ---------------------------------------------------------------------------
# Stage 2 — candidate vertices + angle cull
# ---------------------------------------------------------------------------


def _find_candidates(cx: _Ctx, t, y, valid, vmask):
    """Grow each vertex set by max-deviation insertion (oracle
    ``find_candidate_vertices``): ``NC - 2`` trips, each inserting the
    interior non-vertex year of largest deviation from its segment's OLS
    line (first position on ties), or nothing where no such year exists."""
    nc = cx.params.max_candidates
    iota = cx.iota
    neg1 = -cx.one
    for _ in range(nc - 2):
        vpos = _positions(vmask, nc)                       # (P, NC)
        n_verts = vmask.sum(-1)
        k = torch.arange(nc - 1, device=cx.device)
        active = (k + 1) < n_verts.unsqueeze(-1)           # (P, NC-1)
        member = (
            (iota >= vpos[:, :-1].unsqueeze(-1))
            & (iota <= vpos[:, 1:].unsqueeze(-1))
            & active.unsqueeze(-1)
        )                                                  # (P, NC-1, NY)
        c1, tm, ym = _masked_ols(cx, t.unsqueeze(1), y.unsqueeze(1), member)
        seg = (torch.cumsum(vmask.to(torch.int64), -1) - 1).clamp(0, nc - 2)
        dev = torch.abs(y - (_take(ym, seg) + _take(c1, seg) * (t - _take(tm, seg))))
        last = _take(vpos, (n_verts - 1).clamp(min=0)).unsqueeze(-1)
        eligible = valid & ~vmask & (iota > vpos[:, :1]) & (iota < last)
        dev = torch.where(eligible, dev, neg1)
        mx, i = _first_max(dev)
        do = mx >= 0.0
        vmask = vmask | ((iota == i.unsqueeze(-1)) & do.unsqueeze(-1))
    return vmask


def _remove_weakest(cx: _Ctx, xs, ys, vmask, size: int, keep_above: int):
    """Drop each pixel's min-angle interior vertex while its count exceeds
    ``keep_above`` (one step).  Angles are taken on axis-scaled
    coordinates ``xs``/``ys``: ``|atan(s_right) - atan(s_left)|``."""
    vpos = _positions(vmask, size)
    n_verts = vmask.sum(-1)
    xv, yv = _take(xs, vpos), _take(ys, vpos)
    j = torch.arange(size, device=cx.device)
    interior = (j >= 1) & (j < (n_verts - 1).unsqueeze(-1))
    prev = (j - 1).clamp(min=0)
    nxt = (j + 1).clamp(max=size - 1)
    dx1 = torch.where(interior, xv - xv[:, prev], cx.one)
    dx2 = torch.where(interior, xv[:, nxt] - xv, cx.one)
    s1 = (yv - yv[:, prev]) / dx1
    s2 = (yv[:, nxt] - yv) / dx2
    inf = torch.tensor(math.inf, dtype=cx.dtype, device=cx.device)
    ang = torch.where(interior, torch.abs(torch.atan(s2) - torch.atan(s1)), inf)
    _, jmin = _first_min(ang)
    do = n_verts > keep_above
    pos = _take(vpos, jmin)
    return vmask & ~((cx.iota == pos.unsqueeze(-1)) & do.unsqueeze(-1))


# ---------------------------------------------------------------------------
# Stage 4 — F-statistic scoring
# ---------------------------------------------------------------------------


def betainc(a: torch.Tensor, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Regularised incomplete beta ``I_x(a, b)`` in float64 (elementwise).

    torch has no ``betainc``, so this is the float64 F-test's own: the
    continued fraction of Numerical Recipes' ``betacf`` (modified Lentz),
    run on the side of ``(a + 1) / (a + b + 2)`` where it converges fast,
    until a full step changes it by less than 1e-15 (each element stops on
    its own step, exactly as the kernel's per-thread loop breaks).  The
    front factor ``x^a (1-x)^b / (a B(a, b))`` takes its powers from
    ``pow`` (relative error ~1 ulp whatever ``a``) and ``1 / B(a, b)``
    from :func:`_gamma_ratio`.  The CUDA kernel evaluates the same
    expressions in the same order.
    """
    one = torch.ones((), dtype=x.dtype, device=x.device)
    tiny = torch.tensor(_CF_TINY, dtype=x.dtype, device=x.device)
    swap = x > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - x, x)
    xc = torch.where(swap, x, 1.0 - x)

    def guard(z):
        return torch.where(torch.abs(z) < tiny, tiny, z)

    qab = aa + bb
    qap = aa + 1.0
    qam = aa - 1.0
    c = torch.ones_like(xx)
    d = one / guard(1.0 - qab * xx / qap)
    h = d
    done = torch.zeros(xx.shape, dtype=torch.bool, device=xx.device)
    for m in range(1, _CF_MAXIT + 1):
        m2 = 2.0 * m
        num = m * (bb - m) * xx / ((qam + m2) * (aa + m2))
        d1 = one / guard(1.0 + num * d)
        c1 = guard(1.0 + num / c)
        h1 = h * d1 * c1
        num = -(aa + m) * (qab + m) * xx / ((aa + m2) * (qap + m2))
        d2 = one / guard(1.0 + num * d1)
        c2 = guard(1.0 + num / c1)
        delta = d2 * c2
        h2 = h1 * delta
        d = torch.where(done, d, d2)
        c = torch.where(done, c, c2)
        h = torch.where(done, h, h2)
        done = done | (torch.abs(delta - 1.0) < _CF_EPS)
        if bool(done.all()):
            break
    front = torch.pow(xx, aa) * torch.pow(xc, bb) * _gamma_ratio(aa, bb) / aa
    r = front * h
    return torch.where(swap, 1.0 - r, r)


def _rising(v: torch.Tensor, v0: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``Gamma(v) / Gamma(v0)`` as the product ``v0 (v0+1) ... (v-1)`` of
    ``k = v - v0`` exact terms, multiplied in order (the kernel's loop)."""
    p = torch.ones_like(v)
    kmax = int(k.max().item()) if k.numel() else 0
    for j in range(kmax):
        p = torch.where(j < k, p * (v0 + j), p)
    return p


def _gamma_ratio(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Gamma(a+b) / (Gamma(a) Gamma(b))``.

    The F test only ever asks for half-integer ``a`` and ``b`` (half the
    integer degrees of freedom).  There each gamma is an exact base value
    (``Gamma(1) = 1``, ``Gamma(1/2) = sqrt(pi)``) times a product of exact
    terms, so the ratio carries a few ulps of error instead of the
    ~|log Gamma| * eps of a log-gamma difference.  Other arguments (and
    ``a + b > 170``, where the products overflow) fall back to log-gammas.
    """
    z = a + b
    ia = a == torch.floor(a)
    ib = b == torch.floor(b)
    iz = z == torch.floor(z)
    half = (2.0 * a == torch.floor(2.0 * a)) & (2.0 * b == torch.floor(2.0 * b))
    half = half & (z <= 170.0)
    one = torch.ones_like(a)
    hv = torch.full_like(a, 0.5)
    safe = torch.where(half, z, one)  # loop bounds only where the product applies
    sa = torch.where(half, a, one)
    sb = torch.where(half, b, one)
    za0 = torch.where(ia, one, hv)
    zb0 = torch.where(ib, one, hv)
    zz0 = torch.where(iz, one, hv)
    ratio_h = _rising(safe, zz0, safe - zz0) / (
        _rising(sa, za0, sa - za0) * _rising(sb, zb0, sb - zb0)
    )
    ratio_h = torch.where(~ia & ~ib, ratio_h / math.pi, ratio_h)
    ratio_l = torch.exp(torch.lgamma(z) - torch.lgamma(a) - torch.lgamma(b))
    return torch.where(half, ratio_h, ratio_l)


def _f_stat_p(ss0, sse, n, m):
    """Float64 p-of-F with df1 = 2m-1, df2 = n-2m (linear p)."""
    df1 = 2.0 * m - 1.0
    df2 = n - 2.0 * m
    invalid = (df2 < 1.0) | (ss0 <= 0.0) | (sse >= ss0)
    perfect = (sse <= 0.0) & ~invalid
    df1s = torch.clamp(df1, min=1.0)
    df2s = torch.clamp(df2, min=1.0)
    sse_s = torch.where(perfect | invalid, torch.ones_like(sse), sse)
    f = ((ss0 - sse_s) / df1s) / (sse_s / df2s)
    f = torch.clamp(f, min=0.0)
    x = df2s / (df2s + df1s * f)
    p = betainc(df2s / 2.0, df1s / 2.0, x)
    return torch.where(invalid, 1.0, torch.where(perfect, 0.0, p))


def lgamma_fixed(x: torch.Tensor) -> torch.Tensor:
    """``log Gamma(x)`` for ``x >= 0.5`` — the JAX package's fixed 8-step
    shift + 3-term Stirling series (``segment._lgamma_fixed``), in ``x``'s
    dtype, so float32 scoring matches the JAX kernel's arithmetic."""
    dtype, dev = x.dtype, x.device

    def c(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    prod = x
    for j in range(1, 8):
        prod = prod * (x + c(float(j)))
    z = x + c(8.0)
    zi = c(1.0) / z
    zi2 = zi * zi
    series = zi * (c(1.0 / 12.0) + zi2 * (c(-1.0 / 360.0) + zi2 * c(1.0 / 1260.0)))
    lg = (z - c(0.5)) * torch.log(z) - z + c(_HALF_LOG_2PI) + series
    return lg - torch.log(prod)


def betainc_p_and_logp_lentz(a, b, x, iters: int = 12):
    """``(p, log p)`` of the regularised incomplete beta in one fixed-trip
    Lentz pass — the JAX package's float32 scorer
    (``segment._betainc_p_and_logp_lentz``), expression for expression."""
    dtype, dev = x.dtype, x.device

    def c(v):
        return torch.tensor(v, dtype=dtype, device=dev)

    one = c(1.0)
    tiny = c(1e-30)
    swap = x >= (a + 1.0) / (a + b + 2.0)
    aa = torch.where(swap, b, a)
    bb = torch.where(swap, a, b)
    xx = torch.where(swap, 1.0 - x, x)
    qab = aa + bb
    qap = aa + 1.0
    qam = aa - 1.0

    def guard(z):
        return torch.where(torch.abs(z) < tiny, tiny, z)

    cc = torch.ones_like(xx)
    d = one / guard(1.0 - qab * xx / qap)
    h = d
    for m in range(1, iters + 1):
        mt = c(float(m))
        m2 = c(2.0 * m)
        num = mt * (bb - mt) * xx / ((qam + m2) * (aa + m2))
        d = one / guard(1.0 + num * d)
        cc = guard(1.0 + num / cc)
        h = h * d * cc
        num = -(aa + mt) * (qab + mt) * xx / ((aa + m2) * (qap + m2))
        d = one / guard(1.0 + num * d)
        cc = guard(1.0 + num / cc)
        h = h * d * cc

    log_front = (
        aa * torch.log(torch.maximum(xx, tiny))
        + bb * torch.log1p(-xx)
        + lgamma_fixed(qab)
        - lgamma_fixed(aa)
        - lgamma_fixed(bb)
        - torch.log(aa)
    )
    p_small = torch.exp(log_front) * h
    lp_small = log_front + torch.log(torch.maximum(h, tiny))
    p = torch.where(swap, 1.0 - p_small, p_small)
    lp = torch.where(
        swap, torch.log1p(-torch.minimum(p_small, c(1.0 - 1e-7))), lp_small
    )
    return p, lp


def _f_stat_p_and_logp(ss0, sse, n, m, iters: int):
    """Float32 ``(p, log-p score)`` of the F test (underflow-proof)."""
    dtype, dev = sse.dtype, sse.device
    df1 = 2.0 * m - 1.0
    df2 = n - 2.0 * m
    invalid = (df2 < 1.0) | (ss0 <= 0.0) | (sse >= ss0)
    perfect = (sse <= 0.0) & ~invalid
    df1s = torch.clamp(df1, min=1.0)
    df2s = torch.clamp(df2, min=1.0)
    sse_s = torch.where(perfect | invalid, torch.ones_like(sse), sse)
    f = ((ss0 - sse_s) / df1s) / (sse_s / df2s)
    f = torch.clamp(f, min=0.0)
    x = df2s / (df2s + df1s * f)
    p_direct, lp = betainc_p_and_logp_lentz(df2s / 2.0, df1s / 2.0, x, iters=iters)
    lp = torch.where(
        invalid,
        torch.zeros((), dtype=dtype, device=dev),
        torch.where(perfect, torch.tensor(_LOGP_PERFECT, dtype=dtype, device=dev), lp),
    )
    p = torch.where(invalid, 1.0, torch.where(perfect, 0.0, p_direct))
    return p, lp


# ---------------------------------------------------------------------------
# the whole pipeline: stages 1–4a (the model family), then the tail
# ---------------------------------------------------------------------------


class _Series(NamedTuple):
    """One batch compacted per pixel: valid years first, in year order."""

    t_full: torch.Tensor  # (NY,) year axis in the working dtype
    raw: torch.Tensor     # (P, NY) values in the working dtype, year axis
    m: torch.Tensor       # (P, NY) cleaned validity mask, year axis
    n: torch.Tensor       # (P,) valid years, int64
    order: torch.Tensor   # (P, NY) compacted position -> year index
    valid: torch.Tensor   # (P, NY) compacted position < n
    t: torch.Tensor       # (P, NY) compacted years (0 past n)
    raw_c: torch.Tensor   # (P, NY) compacted values (0 past n)


def _compact(cx: _Ctx, years, values, mask) -> _Series:
    """Clean the mask (non-finite values are invalid) and move each row's
    valid years to the front of the row, in year order."""
    ny, zero, iota = cx.ny, cx.zero, cx.iota
    t_full = years.to(device=cx.device, dtype=cx.dtype)
    raw = values.to(cx.dtype)
    m = mask.to(device=cx.device, dtype=torch.bool) & torch.isfinite(raw)
    n = m.sum(-1)
    order = torch.sort(torch.where(m, iota, ny + iota), dim=-1).indices
    valid = iota < n.unsqueeze(-1)
    t = torch.where(valid, t_full[order], zero)
    raw_c = torch.where(valid, raw.gather(-1, order), zero)
    return _Series(t_full, raw, m, n, order, valid, t, raw_c)


def _ranges(cx: _Ctx, s: _Series, y: torch.Tensor):
    """``(y_lo, y_hi, y_range, t_lo, t_hi)`` of the (despiked) series."""
    big = torch.tensor(torch.finfo(cx.dtype).max, dtype=cx.dtype, device=cx.device)
    y_lo = torch.where(s.valid, y, big).min(-1).values
    y_hi = torch.where(s.valid, y, -big).max(-1).values
    y_range = torch.clamp(y_hi - y_lo, min=0.0)
    t_lo = s.t[:, 0]
    t_hi = _take(s.t, (s.n - 1).clamp(min=0))
    return y_lo, y_hi, y_range, t_lo, t_hi


def _check_batch(years, values, mask) -> None:
    if values.dim() != 2 or mask.shape != values.shape:
        raise ValueError(
            f"values/mask must be matching (PX, NY); got {tuple(values.shape)} "
            f"and {tuple(mask.shape)}"
        )
    ny = values.shape[1]
    if years.shape != (ny,):
        raise ValueError(f"years must be ({ny},); got {tuple(years.shape)}")


def torch_family_stats(
    years: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    params: LTParams = LTParams(),
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stages 1–4a of the pipeline — the plain version of the family kernel.

    Counterpart of the JAX package's ``family_stats_pallas``, with its
    layout: returns ``(despiked (PX, NY), vmasks (PX, NM, NY) bool,
    sses (PX, NM))`` — the despiked series on the year axis (0 at invalid
    years), each model-family member's vertex set on the year axis, and
    the SSE of its fit, in pruning order (most vertices first).  Every
    pixel is computed, whatever its valid-year count or range: the family
    of a pixel the tail will call flat is still returned.
    """
    _check_batch(years, values, mask)
    px, ny = values.shape
    cx = _Ctx(params, result_dtype(values.dtype), values.device, ny)
    nv, nm = params.max_vertices, params.max_segments
    iota, one = cx.iota, cx.one
    s = _compact(cx, years, values, mask)
    t, valid = s.t, s.valid

    # Stage 1 — despike
    y = _despike(cx, t, s.raw_c, s.n)
    y_lo, y_hi, y_range, t_lo, t_hi = _ranges(cx, s, y)

    # Stage 2 — candidates + angle cull
    ends = (iota == 0) | (iota == (s.n - 1).clamp(min=0).unsqueeze(-1))
    vmask = valid & ends
    vmask = _find_candidates(cx, t, y, valid, vmask)
    t_rng = torch.where(t_hi > t_lo, t_hi - t_lo, one)
    y_rng = torch.where(y_hi > y_lo, y_hi - y_lo, one)
    xs = (t - t_lo.unsqueeze(-1)) / t_rng.unsqueeze(-1)
    ys = (y - y_lo.unsqueeze(-1)) / y_rng.unsqueeze(-1)
    for _ in range(params.vertex_count_overshoot):
        vmask = _remove_weakest(cx, xs, ys, vmask, params.max_candidates, nv)

    # Stage 4a — model family: vertex set + SSE per member
    vmasks, sses = [], []
    for k in range(nm):
        vmasks.append(vmask)
        _, sse = _fit_model(cx, t, y, valid, vmask, y_range)
        sses.append(sse)
        if k + 1 < nm:
            vmask = _remove_weakest(cx, xs, ys, vmask, nv, 2)

    # back to the year axis: compacted position j is year order[j]; past
    # n both y and the vertex sets are 0 / False, so invalid years are too
    despiked = torch.empty_like(y).scatter_(-1, s.order, y)
    vm_c = torch.stack(vmasks, dim=1)                           # (P, NM, NY)
    vmasks_y = torch.empty_like(vm_c).scatter_(
        -1, s.order.unsqueeze(1).expand(px, nm, ny), vm_c
    )
    return despiked, vmasks_y, torch.stack(sses, dim=1)


def _interp_through_vertices(cx: _Ctx, t_full, tv, fv, k_live, pad_t):
    """Full-year trajectory through each row's ``k_live`` vertices
    (years ``tv``, fits ``fv``, both ``(P, NV)``) — the ``np.interp``
    replica of the JAX package: dead slots repeat ``(pad_t, last fit)``."""
    nv = tv.shape[-1]
    one = cx.one
    slot = torch.arange(nv, device=cx.device)
    live_v = slot < k_live.unsqueeze(-1)
    last_fit = _take(fv, (k_live - 1).clamp(min=0))
    xp = torch.where(live_v, tv, pad_t.unsqueeze(-1))
    fp = torch.where(live_v, fv, last_fit.unsqueeze(-1))
    tt = t_full.expand(tv.shape[0], cx.ny)
    cnt = (xp.unsqueeze(1) <= tt.unsqueeze(-1)).sum(-1)         # (P, NY)
    i = cnt.clamp(1, nv - 1)
    fp_i, fp_im1 = _take(fp, i), _take(fp, i - 1)
    xp_i, xp_im1 = _take(xp, i), _take(xp, i - 1)
    df = fp_i - fp_im1
    dx = xp_i - xp_im1
    delta = tt - xp_im1
    eps = torch.finfo(cx.dtype).eps
    eps_g = cx.c(math.ulp(eps) if cx.dtype == torch.float64 else _ulp32(eps))
    dx0 = torch.abs(dx) <= eps_g
    f = torch.where(dx0, fp_im1, fp_im1 + (delta / torch.where(dx0, one, dx)) * df)
    f = torch.where(tt < xp[:, :1], fp[:, :1], f)
    return torch.where(tt > xp[:, -1:], fp[:, -1:], f)


def _select_and_assemble(
    years: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    despiked: torch.Tensor,
    vmasks: torch.Tensor,
    sses: torch.Tensor,
    params: LTParams = LTParams(),
) -> SegOutputs:
    """Scoring, model selection, the chosen model's refit and output
    assembly over a model family — the counterpart of the JAX package's
    ``segment._select_and_assemble``.

    ``despiked``/``vmasks``/``sses`` are :func:`torch_family_stats`'s
    outputs (or the family kernel's); ``years``/``values``/``mask`` the
    inputs they came from (the raw series feeds the flat no-fit model).
    """
    _check_batch(years, values, mask)
    px, ny = values.shape
    nv, nm = params.max_vertices, params.max_segments
    if (
        despiked.shape != (px, ny)
        or vmasks.shape != (px, nm, ny)
        or vmasks.dtype != torch.bool
        or sses.shape != (px, nm)
    ):
        raise ValueError(
            f"family must be despiked ({px}, {ny}), vmasks ({px}, {nm}, {ny}) bool "
            f"and sses ({px}, {nm}); got {tuple(despiked.shape)}, "
            f"{tuple(vmasks.shape)} {vmasks.dtype} and {tuple(sses.shape)}"
        )
    dtype = result_dtype(values.dtype)
    dev = values.device
    cx = _Ctx(params, dtype, dev, ny)
    zero, one = cx.zero, cx.one
    s = _compact(cx, years, values, mask)
    n, order, valid, t, raw_c = s.n, s.order, s.valid, s.t, s.raw_c
    y = torch.where(valid, despiked.to(dtype).gather(-1, order), zero)
    vmasks_t = vmasks.gather(-1, order.unsqueeze(1).expand(px, nm, ny)) & valid.unsqueeze(1)
    sses_t = sses.to(dtype)
    _, _, y_range, _, t_hi = _ranges(cx, s, y)

    # scoring + selection
    n_f = n.to(dtype)
    n_safe = torch.clamp(n_f, min=1.0)
    sum_y = _seqsum(torch.where(valid, y, zero))
    mean0 = sum_y / n_safe
    dev0 = y - mean0.unsqueeze(-1)
    ss0 = _seqsum(torch.where(valid, dev0 * dev0, zero))
    ms = (vmasks_t.sum(-1) - 1).to(dtype)
    ss0_b = ss0.unsqueeze(-1).expand_as(sses_t)
    n_b = n_f.unsqueeze(-1).expand_as(sses_t)
    if dtype == torch.float64:
        ps = _f_stat_p(ss0_b, sses_t, n_b, ms)
        scores = ps
        best = scores.min(-1).values
        thresh = best / params.best_model_proportion
    else:
        ps, scores = _f_stat_p_and_logp(ss0_b, sses_t, n_b, ms, lentz_iters(ny))
        best = scores.min(-1).values
        thresh = best - torch.log(cx.c(params.best_model_proportion))
    qualify = scores <= thresh.unsqueeze(-1)
    chosen = torch.where(qualify, torch.arange(nm, device=dev), nm).min(-1).values
    chosen = chosen.clamp(max=nm - 1)
    vmask_c = vmasks_t[torch.arange(px, device=dev), chosen]    # (P, NY)
    fitted_c, sse_c = _fit_model(cx, t, y, valid, vmask_c, y_range)
    p_c = _take(ps, chosen)

    enough = n >= params.min_observations_needed
    mv = enough & (y_range > 0.0) & (p_c <= cx.pval)

    # --- assemble outputs (flat no-fit model when not model_valid) ---
    has_any = n > 0
    mean_desp = torch.where(has_any, mean0, zero)
    mean_raw = torch.where(has_any, _seqsum(torch.where(valid, raw_c, zero)) / n_safe, zero)
    mean = torch.where(enough, mean_desp, mean_raw)

    vpos = _positions(vmask_c, nv)                              # (P, NV)
    k_live = vmask_c.sum(-1)
    slot = torch.arange(nv, device=dev)
    live = (slot < k_live.unsqueeze(-1)) & mv.unsqueeze(-1)
    tvc = _take(t, vpos)
    vfit = _take(fitted_c, vpos)
    vertex_indices = torch.where(live, _take(order, vpos), -1).to(torch.int32)
    vertex_years = torch.where(live, tvc, zero)
    vertex_src = torch.where(live, _take(y, vpos), zero)
    vertex_fit = torch.where(live, vfit, zero)

    sidx = torch.arange(nm, device=dev)
    seg_live = (sidx < (k_live - 1).unsqueeze(-1)) & mv.unsqueeze(-1)
    mag = torch.where(seg_live, vfit[:, 1:] - vfit[:, :-1], zero)
    dur = torch.where(seg_live, tvc[:, 1:] - tvc[:, :-1], zero)
    pos_dur = dur > 0.0
    rate = torch.where(seg_live & pos_dur, mag / torch.where(pos_dur, dur, one), zero)

    # fitted trajectory over every year
    f = _interp_through_vertices(cx, s.t_full, tvc, vfit, k_live, t_hi)
    fitted_full = torch.where(mv.unsqueeze(-1), f, mean.unsqueeze(-1))

    rmse_fit = torch.sqrt(sse_c / n_safe)
    flat_src = torch.where(enough.unsqueeze(-1), y, raw_c)
    r_flat = flat_src - mean.unsqueeze(-1)
    rmse_flat = torch.sqrt(_seqsum(torch.where(valid, r_flat * r_flat, zero)) / n_safe)
    rmse = torch.where(mv, rmse_fit, torch.where(has_any, rmse_flat, zero))

    # despiked output on the year axis: valid years get the despiked
    # series; invalid years keep the raw input when a model fit, the flat
    # mean otherwise
    raw, m = s.raw, s.m
    y_full = torch.empty_like(raw).scatter_(-1, order, y)
    despiked_fit = torch.where(m, y_full, raw)
    flat_full = torch.where(enough.unsqueeze(-1), y_full, raw)
    despiked_flat = torch.where(m, flat_full, mean.unsqueeze(-1))
    despiked_out = torch.where(mv.unsqueeze(-1), despiked_fit, despiked_flat)

    return SegOutputs(
        n_vertices=torch.where(mv, k_live, 0).to(torch.int32),
        vertex_indices=vertex_indices,
        vertex_years=vertex_years,
        vertex_src_vals=vertex_src,
        vertex_fit_vals=vertex_fit,
        seg_magnitude=mag,
        seg_duration=dur,
        seg_rate=rate,
        rmse=rmse,
        p_of_f=torch.where(mv, p_c, one),
        model_valid=mv,
        fitted=fitted_full,
        despiked=despiked_out,
    )


def _ulp32(x: float) -> float:
    """Spacing of float32 at ``x`` (``np.spacing`` in float32)."""
    m, e = math.frexp(x)
    return math.ldexp(1.0, e - 24)


def torch_segment_pixels(
    years: torch.Tensor,
    values: torch.Tensor,
    mask: torch.Tensor,
    params: LTParams = LTParams(),
) -> SegOutputs:
    """Segment a ``(PX, NY)`` batch of series — the plain PyTorch version.

    ``years`` is the shared ``(NY,)`` year axis, ``values`` the
    disturbance-positive index series, ``mask`` the boolean validity mask
    (non-finite values are invalid regardless).  Runs on the tensors' own
    device, in float64 for float64 values and float32 otherwise.  Returns
    :class:`SegOutputs` with a leading PX axis on every field.  It is
    :func:`torch_family_stats` followed by :func:`_select_and_assemble`.
    """
    family = torch_family_stats(years, values, mask, params)
    return _select_and_assemble(years, values, mask, *family, params)

