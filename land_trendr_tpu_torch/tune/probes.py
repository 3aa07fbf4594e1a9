"""Staged calibration probes, one per knob group.

Counterpart of ``land_trendr_tpu/tune/probes.py``.  Each probe measures a
short synthetic workload shaped like the real subsystem it tunes, on the
run's device — the threaded tile gather for ``feed_workers``, the windowed
deflate decode through the real :mod:`~land_trendr_tpu_torch.io.blockcache`
for ``decode_workers``/``feed_cache_mb``, this package's packed host↔device
pipelines (:mod:`~land_trendr_tpu_torch.runtime.feed`,
:mod:`~land_trendr_tpu_torch.runtime.fetch`) for ``upload_depth``/
``fetch_depth``, and the tile program
(:func:`~land_trendr_tpu_torch.ops.tile.process_tile_dn`, the CUDA kernel on
the card) for ``tile_size``, with the chunked kernel
(:func:`~land_trendr_tpu_torch.ops.segment_cuda.cuda_segment_pixels_chunked`)
for ``chunk_px`` in full mode — and returns the winning knob values plus a
report.  The search is **coordinate-wise** within a group (later knobs
sweep with earlier winners held), each candidate is timed
**median-of-reps**, and a candidate whose FIRST rep already exceeds
:data:`CUTOFF` × the best median so far is cut off early.

Contract with the autotuner:

* every candidate set CONTAINS the hardcoded default, and ``default_s``
  is that candidate's median — so ``best_s <= default_s`` holds by
  construction (a probe can only match or beat the default);
* probes never skew the run that follows: the decoded-block cache
  configuration they touch is snapshotted and restored in a ``finally``,
  and all probe inputs are synthetic temporaries;
* probes calibrate *balance points* (worker counts, depths, granularity),
  not absolute throughput.

Device timings end in a synchronisation (a host read of a device value),
so every timed workload includes the device work it enqueued.
"""

from __future__ import annotations

import os
import shutil
import statistics
import tempfile
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

import numpy as np
import torch

__all__ = ["CUTOFF", "PROBE_GROUPS", "probe_group"]

#: early-cutoff factor: a candidate whose first rep exceeds this multiple
#: of the best median so far skips its remaining reps
CUTOFF = 1.5


def _median_reps(
    fn: Callable[[], None], reps: int, best_so_far: "float | None"
) -> "tuple[float, int]":
    """(median seconds, reps actually run) with the early cutoff."""
    times: list[float] = []
    for i in range(max(1, reps)):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if i == 0 and best_so_far is not None and times[0] > CUTOFF * best_so_far:
            break
    return statistics.median(times), len(times)


def _sweep(
    candidates: list, make_fn: Callable, reps: int, default
) -> "tuple[object, dict]":
    """Time every candidate; return (winner, report).

    ``make_fn(candidate)`` returns the zero-arg workload to time.  The
    winner is the min median; ``default_s`` is the default candidate's
    median (always measured in full — the cutoff never skips it, since a
    skipped default would leave ``best_s <= default_s`` unprovable).
    """
    best_val, best_s, default_s = None, None, None
    probes = 0
    timings: dict[str, float] = {}
    order = [default] + [c for c in candidates if c != default]
    for cand in order:
        fn = make_fn(cand)
        cutoff_ref = None if cand == default else best_s
        med, n = _median_reps(fn, reps, cutoff_ref)
        probes += n
        timings[str(cand)] = round(med, 6)
        if cand == default:
            default_s = med
        if best_s is None or med < best_s:
            best_val, best_s = cand, med
    return best_val, {
        "probes": probes,
        "timings": timings,
        "default_s": round(default_s, 6),
        "best_s": round(best_s, 6),
        "speedup": round(default_s / best_s, 3) if best_s > 0 else 1.0,
    }


def _merge_reports(first: dict, second: dict, names: "tuple[str, str]") -> dict:
    """Two coordinate sweeps of one group as one report (timings prefixed
    with the knob they swept)."""
    default_s = first["default_s"] + second["default_s"]
    best_s = first["best_s"] + second["best_s"]
    return {
        "probes": first["probes"] + second["probes"],
        "timings": {
            **{f"{names[0]}={k}": v for k, v in first["timings"].items()},
            **{f"{names[1]}={k}": v for k, v in second["timings"].items()},
        },
        "default_s": round(default_s, 6),
        "best_s": round(best_s, 6),
        "speedup": round(default_s / max(best_s, 1e-9), 3),
    }


def _gather(cube: np.ndarray, y: int, x: int, t_sz: int) -> np.ndarray:
    """One tile's ``(t_sz², NY)`` slice, the feed path's gather."""
    from land_trendr_tpu_torch.io import native

    if native.available():
        try:
            return native.gather_tile(cube, y, x, t_sz, t_sz)
        except native.NativeCodecError:
            pass
    ny = cube.shape[0]
    win = cube[:, y : y + t_sz, x : x + t_sz]
    return np.ascontiguousarray(win.reshape(ny, t_sz * t_sz).T)


# -- feed group: the threaded tile gather ---------------------------------

def probe_feed(
    reps: int, smoke: bool, defaults: dict, device: torch.device
) -> "tuple[dict, dict]":
    """``feed_workers``: threaded native/NumPy tile gather throughput.

    The gather releases the GIL (threaded C++ codec; NumPy copies mostly
    do too), so the worker count tracks the host's real cores.
    """
    ny = 8 if smoke else 16
    size = 384 if smoke else 768
    t_sz = 128
    rng = np.random.default_rng(7)
    cube = rng.integers(0, 1000, (ny, size, size), dtype=np.int16)
    tiles = [(y, x) for y in range(0, size, t_sz) for x in range(0, size, t_sz)]

    cpus = os.cpu_count() or 1
    cands = sorted({1, 2, min(4, cpus + 1), defaults["feed_workers"]})

    def make_fn(workers: int):
        def run() -> None:
            with ThreadPoolExecutor(workers) as ex:
                deque(ex.map(lambda t: _gather(cube, t[0], t[1], t_sz), tiles), maxlen=0)
        return run

    make_fn(1)()  # warm: page the cube in before anything is timed
    best, report = _sweep(cands, make_fn, reps, defaults["feed_workers"])
    return {"feed_workers": int(best)}, report


# -- decode group: the real blockcache path -------------------------------

def probe_decode(
    reps: int, smoke: bool, defaults: dict, device: torch.device
) -> "tuple[dict, dict]":
    """``decode_workers`` + ``feed_cache_mb`` over the real windowed
    deflate decode (:func:`~land_trendr_tpu_torch.io.geotiff.
    read_geotiff_window` through the process blockcache).

    Coordinate-wise: the worker sweep runs cache-off (pure decode cost),
    then the cache sweep replays a revisit-heavy window pattern with the
    chosen workers.  The process cache configuration is snapshotted and
    restored whatever happens.
    """
    from land_trendr_tpu_torch.io import blockcache
    from land_trendr_tpu_torch.io.geotiff import read_geotiff_window
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack

    size = 128 if smoke else 256
    ny = 3 if smoke else 6
    tmp = tempfile.mkdtemp(prefix="lt_tune_decode_")
    snap = blockcache.config_snapshot()
    try:
        paths = write_stack(
            tmp,
            make_stack(SceneSpec(width=size, height=size, year_start=2000,
                                 year_end=2000 + ny - 1)),
            tile=64,
        )
        win = size - 96
        windows = [(0, 0), (32, 32), (win, 0), (0, win), (win, win)]

        def read_all() -> None:
            for p in paths:
                for y, x in windows:
                    read_geotiff_window(p, y, x, 96, 96)

        cpus = os.cpu_count() or 1
        w_cands = sorted({0, 1, min(2, cpus), defaults["decode_workers"]})

        def make_workers_fn(workers: int):
            def run() -> None:
                blockcache.configure(budget_bytes=0, workers=workers)
                read_all()
            return run

        make_workers_fn(0)()  # warm: the OS file cache, untimed
        best_w, w_report = _sweep(w_cands, make_workers_fn, reps, defaults["decode_workers"])

        c_cands = sorted({0, defaults["feed_cache_mb"]})

        def make_cache_fn(mb: int):
            def run() -> None:
                blockcache.configure(budget_bytes=mb << 20, workers=best_w)
                read_all()  # cold pass populates (or not)
                read_all()  # revisit pass: the cache's whole case
            return run

        best_c, c_report = _sweep(c_cands, make_cache_fn, reps, defaults["feed_cache_mb"])
        return (
            {"decode_workers": int(best_w), "feed_cache_mb": int(best_c)},
            _merge_reports(w_report, c_report, ("workers", "cache_mb")),
        )
    finally:
        blockcache.configure(**snap)
        blockcache.cache_clear()
        shutil.rmtree(tmp, ignore_errors=True)


# -- upload / fetch groups: this package's transfer pipelines -------------

def _transfer_tiles(smoke: bool) -> "tuple[dict, np.ndarray, int]":
    px = 64 * 64 if smoke else 128 * 128
    ny = 8 if smoke else 16
    rng = np.random.default_rng(11)
    dn = {
        "nir": rng.integers(0, 30000, (px, ny), dtype=np.int16),
        "swir2": rng.integers(0, 30000, (px, ny), dtype=np.int16),
    }
    qa = rng.integers(0, 2, (px, ny), dtype=np.uint16)
    return dn, qa, (4 if smoke else 8)


def probe_upload(
    reps: int, smoke: bool, defaults: dict, device: torch.device
) -> "tuple[dict, dict]":
    """``upload_depth``: :class:`~land_trendr_tpu_torch.runtime.feed.
    TileUploader` at each depth — one packed pinned copy per tile with up
    to ``depth`` in flight (the driver's double-buffering shape, minus the
    kernel); a reduction stands in for the overlapped compute.  On the CPU
    the uploads are not a real wire and every depth ties."""
    from land_trendr_tpu_torch.runtime import feed as feedmod

    dn, qa, k_tiles = _transfer_tiles(smoke)
    uploader = feedmod.TileUploader(device, packed=feedmod.resolve_packed("auto", device))

    def consume(handle) -> None:
        out_dn, _qa = handle.arrays()
        out_dn["nir"].sum().item()  # the stand-in compute, awaited

    def make_fn(depth: int):
        def run() -> None:
            inflight: deque = deque()
            for _ in range(k_tiles):
                inflight.append(uploader.start(dn, qa))
                while len(inflight) >= depth:
                    consume(inflight.popleft())
            while inflight:
                consume(inflight.popleft())
        return run

    cands = sorted({1, 2, 4, defaults["upload_depth"]})
    make_fn(cands[0])()  # warm the pinned pool and the allocator, untimed
    best, report = _sweep(cands, make_fn, reps, defaults["upload_depth"])
    return {"upload_depth": int(best)}, report


def probe_fetch(
    reps: int, smoke: bool, defaults: dict, device: torch.device
) -> "tuple[dict, dict]":
    """``fetch_depth``: :class:`~land_trendr_tpu_torch.runtime.fetch.
    TileFetcher` at each depth — one tile program's outputs packed and
    copied to pinned host memory per tile, up to ``depth`` in flight, each
    landed tile unpacked as the writer would."""
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.ops.tile import process_tile_dn
    from land_trendr_tpu_torch.runtime import fetch as fetchmod
    from land_trendr_tpu_torch.runtime.driver import RunConfig, TileSpec

    side = 64 if smoke else 128
    dn, qa, k_tiles = _transfer_tiles(smoke)
    ny = qa.shape[1]
    years = torch.arange(2000, 2000 + ny, dtype=torch.int32)
    params = LTParams(max_segments=4, vertex_count_overshoot=1)
    out = process_tile_dn(
        years.to(device),
        {k: torch.from_numpy(v).to(device) for k, v in dn.items()},
        torch.from_numpy(qa).to(device),
        params=params,
    )
    cfg = RunConfig(params=params, tile_size=side)
    fetcher = fetchmod.TileFetcher(cfg, device, packed=fetchmod.resolve_packed("auto", device))
    tile = TileSpec(tile_id=0, y0=0, x0=0, h=side, w=side)

    def land(handle) -> None:
        handle.wait()
        handle.tile_arrays(tile)

    def make_fn(depth: int):
        def run() -> None:
            inflight: deque = deque()
            for _ in range(k_tiles):
                inflight.append(fetcher.start(out))
                while len(inflight) >= depth:
                    land(inflight.popleft())
            while inflight:
                land(inflight.popleft())
        return run

    cands = sorted({1, 2, 4, defaults["fetch_depth"]})
    make_fn(cands[0])()  # warm outside the sweep, like probe_upload
    best, report = _sweep(cands, make_fn, reps, defaults["fetch_depth"])
    return {"fetch_depth": int(best)}, report


# -- dispatch group: tile granularity + chunking --------------------------

def probe_dispatch(
    reps: int, smoke: bool, defaults: dict, device: torch.device
) -> "tuple[dict, dict]":
    """``tile_size`` (+ ``chunk_px`` in full mode).

    ``tile_size`` is probed through the per-tile pipeline for a FIXED
    total pixel budget cut at each granularity: gather, upload and the
    tile program (:func:`process_tile_dn` on ``device`` — the CUDA kernel
    on the card), awaited per tile.  Smaller tiles pay per-tile overhead
    more often; larger ones amortise it.  ``chunk_px`` (full mode only)
    times the chunked kernel over candidate chunk sizes.
    """
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.ops.tile import process_tile_dn

    ny = 8 if smoke else 16
    total = 256 if smoke else 512  # total scene edge the budget covers
    rng = np.random.default_rng(13)
    nir = rng.integers(0, 30000, (ny, total, total), dtype=np.int16)
    swir2 = rng.integers(0, 30000, (ny, total, total), dtype=np.int16)
    qa_cube = rng.integers(0, 2, (ny, total, total), dtype=np.uint16)
    years = torch.arange(2000, 2000 + ny, dtype=torch.int32, device=device)
    params = LTParams(max_segments=4, vertex_count_overshoot=1)

    def make_fn(t_sz: int):
        def run() -> None:
            for y in range(0, total, t_sz):
                for x in range(0, total, t_sz):
                    dn = {
                        "nir": torch.from_numpy(_gather(nir, y, x, t_sz)).to(device),
                        "swir2": torch.from_numpy(_gather(swir2, y, x, t_sz)).to(device),
                    }
                    qa = torch.from_numpy(_gather(qa_cube, y, x, t_sz)).to(device)
                    out = process_tile_dn(years, dn, qa, params=params, chunk=None)
                    out.seg.n_vertices[0].item()  # await the tile's program
        return run

    cands = sorted({64, 128, 256, 512, defaults["tile_size"]})
    cands = [c for c in cands if c <= total]
    make_fn(cands[-1])()  # warm: the kernel library load and the allocator
    best_t, report = _sweep(cands, make_fn, reps, defaults["tile_size"])
    knobs = {"tile_size": int(best_t), "chunk_px": defaults["chunk_px"]}
    if not smoke:
        chunk_knob, chunk_report = _probe_chunk(reps, defaults, device)
        knobs["chunk_px"] = chunk_knob
        report = _merge_reports(report, chunk_report, ("tile_size", "chunk_px"))
    return knobs, report


def _probe_chunk(reps: int, defaults: dict, device: torch.device) -> "tuple[int, dict]":
    """Chunked-kernel sweep for ``chunk_px`` (full mode only).

    Times :func:`cuda_segment_pixels_chunked` over a fixed pixel batch cut
    into candidate-sized chunks (one launch per chunk on the card), at
    probe scale.  The winner maps back to the real knob domain, never
    above the default bound: the probe tunes the speed side of the knob,
    the operator owns its memory side.
    """
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.ops.segment_cuda import cuda_segment_pixels_chunked

    px, ny = 2048, 16
    rng = np.random.default_rng(17)
    years = torch.arange(2000, 2000 + ny, dtype=torch.int32, device=device)
    values = torch.from_numpy(rng.normal(0.4, 0.1, (px, ny)).astype(np.float32)).to(device)
    mask = torch.ones((px, ny), dtype=torch.bool, device=device)
    params = LTParams(max_segments=4, vertex_count_overshoot=1)
    # scaled chunk candidates as slice counts; 1 = one chunk (unchunked shape)
    slice_cands = [1, 2, 4]
    default_slices = 1  # the default bound never engages at probe scale

    def make_fn(n_slices: int):
        def run() -> None:
            out = cuda_segment_pixels_chunked(years, values, mask, params, px // n_slices)
            out.n_vertices[0].item()
        return run

    for n in slice_cands:  # warm outside the timed reps
        make_fn(n)()
    best, report = _sweep(slice_cands, make_fn, reps, default_slices)
    # slicing never helped -> keep the default bound; slicing helped ->
    # divide the bound (a finer chunk at real scale), floor 64k
    default_chunk = defaults["chunk_px"]
    if best == 1 or default_chunk is None:
        return default_chunk, report
    return max(65536, int(default_chunk) // int(best)), report


#: group name → (probe fn, knob names) — the autotuner's schedule.  Order
#: matters only for reporting; groups are independent by construction.
PROBE_GROUPS: dict = {
    "feed": (probe_feed, ("feed_workers",)),
    "decode": (probe_decode, ("decode_workers", "feed_cache_mb")),
    "upload": (probe_upload, ("upload_depth",)),
    "fetch": (probe_fetch, ("fetch_depth",)),
    "dispatch": (probe_dispatch, ("tile_size", "chunk_px")),
}


def probe_group(
    group: str, reps: int, smoke: bool, defaults: dict, device: "torch.device | str" = "cuda"
) -> "tuple[dict, dict]":
    """Run one group's probe on ``device``; returns ``(best knob values,
    report)``."""
    fn, _knobs = PROBE_GROUPS[group]
    return fn(reps=reps, smoke=smoke, defaults=defaults, device=torch.device(device))
