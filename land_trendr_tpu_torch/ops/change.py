"""Change-map products derived from segmentation rasters (PyTorch + NumPy).

Counterpart of ``land_trendr_tpu/ops/change.py``: per-pixel "greatest
disturbance" / "greatest recovery" layers (year of detection, magnitude,
duration, rate, pre-change value, signal to noise) with magnitude,
duration and p filters, and a minimum-mapping-unit sieve — the standard
post-processing of LandTrendr segment rasters.

The per-pixel selection (:func:`select_change`) is elementwise masks and
one argmax over the segment axis on ``(px, NM)`` tensors; the JAX package
runs it as XLA, so here it is plain PyTorch on the tensors' own device.
The sieve is spatial (connected components over the assembled 2-D mask)
and runs on the host: the NumPy code below is a copy of the JAX
package's.

All values are in the index's **natural** orientation (the convention of
the written rasters): a disturbance is a fitted *drop* for NBR/NDVI/TCW,
and the reported magnitude keeps its natural sign.  Filters are expressed
on the positive "change size" ``|mag|``.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from land_trendr_tpu_torch.ops import indices as idx

__all__ = [
    "CHANGE_PRODUCTS",
    "ChangeFilter",
    "label4",
    "mmu_sieve",
    "select_change",
    "sieve_change_rasters",
    "write_change_maps",
]

CHANGE_PRODUCTS = ("mask", "yod", "mag", "dur", "rate", "preval", "dsnr")

#: rasters (from assemble_outputs) the selection needs
_REQUIRED = (
    "vertex_years",
    "vertex_fit_vals",
    "seg_magnitude",
    "seg_duration",
    "seg_rate",
    "model_valid",
    "p_of_f",
    "rmse",
)


@dataclasses.dataclass(frozen=True)
class ChangeFilter:
    """Which segments qualify as "the change", and how to pick among them.

    The JAX package's ``ChangeFilter``, field for field (the run
    fingerprint hashes its fields, so the two must not drift).

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


def _run_lengths_arange(lengths: np.ndarray) -> np.ndarray:
    """``[0..l0-1, 0..l1-1, ...]`` without a Python loop."""
    csum = np.cumsum(lengths)
    ids = np.arange(int(csum[-1]), dtype=np.int64)
    return ids - np.repeat(csum - lengths, lengths)


def _runs4(
    mask: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """4-connected components as horizontal runs, pure NumPy (no scipy
    dependency).

    Horizontal True-runs are found vectorized from row-wise sign changes
    (row-chunked, so temporaries stay O(chunk) even on a CONUS-scale
    mask); a union-find merges runs that overlap column-wise in adjacent
    rows (4-connectivity).  Python-side work is O(runs + overlaps) on run
    *endpoints* — never per pixel.

    Returns ``(rows, starts, ends, component_of_run, n_components)``;
    components are numbered 0..n-1 in first-run order.
    """
    h, w = mask.shape
    rows_l: list[np.ndarray] = []
    s_l: list[np.ndarray] = []
    e_l: list[np.ndarray] = []
    chunk_rows = max(1, (1 << 22) // max(w, 1))
    for r0 in range(0, h, chunk_rows):
        d = np.diff(
            np.pad(mask[r0 : r0 + chunk_rows].astype(np.int8), ((0, 0), (1, 1))),
            axis=1,
        )
        st = np.argwhere(d == 1)
        if len(st) == 0:
            continue
        rows_l.append((st[:, 0] + r0).astype(np.int64))
        s_l.append(st[:, 1].astype(np.int32))
        e_l.append(np.argwhere(d == -1)[:, 1].astype(np.int32))
    if not rows_l:
        z = np.zeros(0, np.int64)
        return z, z, z, z, 0
    rows = np.concatenate(rows_l)
    s = np.concatenate(s_l)
    e = np.concatenate(e_l)  # row-major ⇒ pairs with starts 1:1
    n = len(s)

    parent = np.arange(n, dtype=np.int64)

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]  # path halving
            i = parent[i]
        return i

    row_start = np.searchsorted(rows, np.arange(h + 1))
    for r in range(1, h):
        a0, a1 = row_start[r - 1], row_start[r]
        b0, b1 = row_start[r], row_start[r + 1]
        if a0 == a1 or b0 == b1:
            continue
        # runs within a row are sorted and disjoint: run a overlaps run b
        # iff  s_a < e_b  and  e_a > s_b  — a contiguous index range
        lo = np.searchsorted(e[a0:a1], s[b0:b1], side="right")
        hi = np.searchsorted(s[a0:a1], e[b0:b1], side="left")
        for j in range(b1 - b0):
            for ai in range(lo[j], hi[j]):
                ra, rb = find(a0 + ai), find(b0 + j)
                if ra != rb:
                    parent[max(ra, rb)] = min(ra, rb)

    roots = np.fromiter((find(i) for i in range(n)), np.int64, n)
    _, lab = np.unique(roots, return_inverse=True)
    return rows, s, e, lab, int(lab.max()) + 1


def _paint_runs(
    out_flat: np.ndarray,
    w: int,
    rows: np.ndarray,
    s: np.ndarray,
    e: np.ndarray,
    values: np.ndarray,
    budget_px: int = 1 << 24,
) -> None:
    """Scatter per-run ``values`` onto the flat image, in run groups of at
    most ``budget_px`` painted pixels — the index temporaries stay ~100 MB
    instead of scaling with the mask's total True count (at mosaic scale,
    77M True px would otherwise mean several 600 MB int64 repeats at
    once)."""
    lengths = (e - s).astype(np.int64)
    idx0 = rows * w + s
    csum = np.cumsum(lengths)
    n = len(lengths)
    start = 0
    while start < n:
        base = csum[start - 1] if start else 0
        stop = min(n, int(np.searchsorted(csum, base + budget_px)) + 1)
        ln = lengths[start:stop]
        fi = np.repeat(idx0[start:stop], ln) + _run_lengths_arange(ln)
        out_flat[fi] = np.repeat(values[start:stop], ln)
        start = stop


def label4(mask: np.ndarray) -> tuple[np.ndarray, int]:
    """4-connected component labeling via :func:`_runs4`.

    Returns ``(labels, n)`` with background 0 and components 1..n,
    matching ``scipy.ndimage.label`` with the 4-connected structure.
    """
    h, w = mask.shape
    rows, s, e, lab, n = _runs4(mask)
    out = np.zeros(h * w, np.int32)
    if n:
        _paint_runs(out, w, rows, s, e, lab.astype(np.int32) + 1)
    return out.reshape(h, w), n


def mmu_sieve(mask: np.ndarray, mmu: int) -> np.ndarray:
    """Drop 4-connected changed patches smaller than ``mmu`` pixels.

    Works entirely on the run representation — per-component pixel counts
    come from a bincount over runs and the kept runs paint a fresh boolean
    mask, so no full int32 label image (1 GB at 16k²) ever exists.
    """
    if mmu <= 1:
        return mask
    mask = np.asarray(mask)
    h, w = mask.shape
    rows, s, e, lab, n = _runs4(mask)
    if n == 0:
        return mask
    counts = np.bincount(lab, weights=(e - s).astype(np.float64))
    keep_run = counts[lab] >= mmu
    out = np.zeros(h * w, bool)
    if keep_run.any():
        k = keep_run.nonzero()[0]
        _paint_runs(out, w, rows[k], s[k], e[k], np.ones(len(k), bool))
    return out.reshape(h, w)


def write_change_maps(
    seg_dir: str,
    dest: str,
    index: str = "nbr",
    filt: ChangeFilter = ChangeFilter(),
    mmu: int = 1,
    band_px: int = 1 << 21,
    align_bands: bool = True,
    device: "str | torch.device" = "cuda",
) -> dict[str, str]:
    """Segment rasters (assemble_outputs' out_dir) → change-map rasters.

    STREAMING: the required products are window-read in row bands
    (``read_geotiff_window``), the selector runs per band on ``device``
    ("cuda" unless the caller asks for "cpu"), and each
    change product streams into a :class:`GeoTiffStreamWriter` — host
    memory is O(row band × products) plus ONE full-raster boolean mask
    (1 byte/px; 1.6 GB even at a 40k×40k CONUS mosaic), which the
    minimum-mapping-unit sieve needs whole because patch connectivity is
    global.  With ``mmu`` > 1, pixels the sieve removes are zeroed by a
    second windowed pass over the just-written products (window-read →
    zero → stream-rewrite → atomic replace), so peak memory never grows
    with raster size.  Writes one single-band GeoTIFF per product in
    ``dest`` (``change_yod.tif`` …), on the input grid.  Returns
    product → path.
    """
    from land_trendr_tpu_torch.io.geotiff import (
        GeoTiffStreamWriter,
        read_geotiff_info,
        read_geotiff_window,
    )

    index = index.lower()
    if index not in idx.DISTURBANCE_SIGN:
        raise ValueError(f"unknown index {index!r} (one of {idx.INDEX_NAMES})")

    src = {}
    for name in _REQUIRED:
        path = os.path.join(seg_dir, f"{name}.tif")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path} missing — run `segment` (assemble_outputs) first; "
                f"change maps need {_REQUIRED}"
            )
        src[name] = path
    geo, info = read_geotiff_info(src["model_valid"])
    h, w = info.height, info.width
    # Chunk the raster in TWO dimensions, aligned to the source rasters'
    # block grid (so no source block is decoded by more than one chunk):
    # row bands of the block height, split column-wise into ~band_px-pixel
    # chunks.  Memory is then bounded by band_px (inputs ~130 B/px plus
    # the selector's transients) INDEPENDENT of raster
    # width — a single full-width block row of a 40k-wide mosaic alone
    # would be 10M px.  Strip sources don't column-split (a column chunk
    # would re-decode the full-width strip it slices).
    blk_r = (info.block_rows or 1) if align_bands else 1
    blk_c = (info.block_cols or w) if align_bands else 1
    band_rows = _aligned_band_rows(h, w, band_px, blk_r)
    if info.tiled and band_rows * w > band_px:
        cw = max(1, band_px // max(band_rows, 1))
        cw = min(w, max(blk_c, cw // blk_c * blk_c))
    else:
        cw = w
    # every chunk has one shape: ragged edge chunks pad up with
    # model_valid=False rows (all outputs zero there)
    chunk_px = band_rows * cw

    out_dtypes = {
        k: np.dtype(np.uint8) if k == "mask"
        else np.dtype(np.int32) if k == "yod"
        else np.dtype(np.float32)
        for k in CHANGE_PRODUCTS
    }
    os.makedirs(dest, exist_ok=True)
    paths = {k: os.path.join(dest, f"change_{k}.tif") for k in CHANGE_PRODUCTS}
    writers = {
        k: GeoTiffStreamWriter(paths[k], h, w, 1, out_dtypes[k], geo=geo)
        for k in CHANGE_PRODUCTS
    }
    # the sieve needs global connectivity, so with mmu > 1 ONE full-raster
    # boolean (1 byte/px) is held; the default mmu=1 path stays O(row band)
    mask_full = np.zeros((h, w), bool) if mmu > 1 else None
    try:
        for y0 in range(0, h, band_rows):
            hb = min(band_rows, h - y0)
            for x0 in range(0, w, cw):
                wb = min(cw, w - x0)
                arrs = {
                    name: np.asarray(
                        read_geotiff_window(src[name], y0, x0, hb, wb)
                    )
                    for name in _REQUIRED
                }
                px = hb * wb

                def flat(a):
                    fl = np.moveaxis(a.reshape(-1, hb, wb), 0, -1)
                    fl = fl.reshape(px, -1)
                    if px < chunk_px:  # ragged edge → canonical shape
                        fl = np.pad(fl, ((0, chunk_px - px), (0, 0)))
                    return fl

                def dev(a):
                    return torch.from_numpy(np.ascontiguousarray(a)).to(device)

                out = select_change(
                    dev(flat(arrs["vertex_years"]).astype(np.float32)),
                    dev(flat(arrs["vertex_fit_vals"]).astype(np.float32)),
                    dev(flat(arrs["seg_magnitude"]).astype(np.float32)),
                    dev(flat(arrs["seg_duration"]).astype(np.float32)),
                    dev(flat(arrs["seg_rate"]).astype(np.float32)),
                    dev(flat(arrs["model_valid"]).astype(bool)[:, 0]),
                    dev(flat(arrs["p_of_f"]).astype(np.float32)[:, 0]),
                    dev(flat(arrs["rmse"]).astype(np.float32)[:, 0]),
                    sign=idx.DISTURBANCE_SIGN[index],
                    filt=filt,
                )
                out = {
                    k: v.cpu().numpy()[:px].reshape(hb, wb)
                    for k, v in out.items()
                }
                if mask_full is not None:
                    mask_full[y0 : y0 + hb, x0 : x0 + wb] = out["mask"]
                for k in CHANGE_PRODUCTS:
                    writers[k].write(
                        y0, x0, out[k].astype(out_dtypes[k], copy=False)
                    )
        for wr in writers.values():
            wr.close()
    except BaseException:
        for wr in writers.values():
            try:
                wr.abort()
            except Exception:
                pass
        raise

    if mmu > 1:
        removed = mask_full & ~mmu_sieve(mask_full, mmu)
        if removed.any():
            for k in CHANGE_PRODUCTS:
                _zero_removed_rewrite(
                    paths[k], h, w, out_dtypes[k], removed, geo, band_rows
                )
    return paths


def _aligned_band_rows(h: int, w: int, band_px: int, blk: int) -> int:
    """Row-band height targeting ~band_px pixels, rounded to the source
    block height so no block row is decoded by more than one band."""
    band_rows = max(1, min(h, band_px // max(w, 1)))
    return min(h, max(blk, band_rows // blk * blk))


def sieve_change_rasters(
    out_dir: str, mmu: int, band_px: int = 1 << 21
) -> None:
    """Apply the minimum-mapping-unit sieve to ALREADY-ASSEMBLED change
    rasters (``change_mask.tif`` + friends in ``out_dir``) — the spatial
    stage of the fused on-device change path (``RunConfig.change_filt``),
    which computes per-pixel selection on device but cannot see patch
    connectivity across tiles.  Windowed row-band reads keep memory at one
    full-raster boolean plus O(band); products rewrite atomically."""
    if mmu <= 1:
        return
    from land_trendr_tpu_torch.io.geotiff import read_geotiff_info, read_geotiff_window

    mask_path = os.path.join(out_dir, "change_mask.tif")
    if not os.path.exists(mask_path):
        raise FileNotFoundError(
            f"{mask_path} missing — sieve_change_rasters needs an assembled "
            "change_filt run (RunConfig.change_filt + assemble_outputs)"
        )
    geo, info = read_geotiff_info(mask_path)
    h, w = info.height, info.width
    band_rows = _aligned_band_rows(h, w, band_px, info.block_rows or 1)
    mask = np.zeros((h, w), bool)
    for y0 in range(0, h, band_rows):
        hb = min(band_rows, h - y0)
        mask[y0 : y0 + hb] = (
            np.asarray(read_geotiff_window(mask_path, y0, 0, hb, w)) > 0
        )
    removed = mask & ~mmu_sieve(mask, mmu)
    if not removed.any():
        return
    # mask LAST: a crash mid-pass must leave the mask still showing the
    # unsieved state, so a re-run recomputes the same `removed` and
    # self-heals — mask-first would make the retry a silent no-op while
    # the value products keep sieved-out pixels
    for k in sorted(CHANGE_PRODUCTS, key=lambda k: k == "mask"):
        path = os.path.join(out_dir, f"change_{k}.tif")
        p_info = read_geotiff_info(path)[1]
        _zero_removed_rewrite(
            path, h, w, p_info.dtype, removed, geo, band_rows,
            compress=p_info.compression_name(),
            overviews=p_info.overview_pages,
        )


def _zero_removed_rewrite(
    path: str,
    h: int,
    w: int,
    dtype: np.dtype,
    removed: np.ndarray,
    geo,
    band_rows: int,
    compress: str = "deflate",
    overviews: int = 0,
) -> None:
    """Zero sieve-removed pixels of one just-written product, windowed:
    read → mask → stream into a sibling tmp → atomic replace.  The
    rewrite reproduces the source's compression/overview layout so a
    sieved raster keeps whatever pyramid/codec the run configured."""
    from land_trendr_tpu_torch.io.geotiff import GeoTiffStreamWriter, read_geotiff_window

    tmp = f"{path}.{os.getpid()}.tmp"
    with GeoTiffStreamWriter(
        tmp, h, w, 1, dtype, geo=geo, compress=compress, overviews=overviews
    ) as wr:
        for y0 in range(0, h, band_rows):
            hb = min(band_rows, h - y0)
            a = np.asarray(read_geotiff_window(path, y0, 0, hb, w))
            a = np.where(removed[y0 : y0 + hb], 0, a).astype(dtype, copy=False)
            wr.write(y0, 0, a)
    os.replace(tmp, path)
