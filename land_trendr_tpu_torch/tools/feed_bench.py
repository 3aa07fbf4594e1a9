"""Feed-path decode bench: the decoded-block cache and parallel block decode.

Counterpart of the JAX package's ``tools/feed_bench.py`` over the port's
:mod:`~land_trendr_tpu_torch.io.blockcache`.  It builds a synthetic
**tiled-deflate** scene (one single-band uint16 GeoTIFF per year, the
shape the C2 lazy ingest feeds from) and measures the window-read feed
stage over the same row-major tile sweep:

* ``baseline`` — cache off, one decode worker: the serial uncached path;
* ``parallel`` — cache off, ``--workers`` decode threads;
* ``cached``   — cache + parallel decode (``RunConfig.feed_cache_mb`` /
  ``decode_workers``): the acceptance comparison;
* ``cached_readahead`` — cache + parallel + next-window hints (in this
  host-only loop there is no device wait to overlap; recorded for
  completeness).

The windows deliberately straddle the 256-px TIFF block grid, so adjacent
windows revisit compressed blocks.  Cached reads are checked byte for
byte against full reads on sampled windows every run.  This is host work:
``--device`` names the machine the record is kept for (the card's host by
default, whose ``nvidia-smi`` line the record carries).

Usage::

    python -m land_trendr_tpu_torch.tools.feed_bench [--out FEED.json]
        [--smoke] [--events-dir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

from land_trendr_tpu_torch.io import blockcache, native
from land_trendr_tpu_torch.io.geotiff import read_geotiff, read_geotiff_window, write_geotiff
from land_trendr_tpu_torch.runtime.driver import resolve_device
from land_trendr_tpu_torch.tools.measure import record_meta, write_json_atomic

__all__ = ["build_scene", "check_parity", "main", "plan_windows", "sweep"]


def build_scene(scene_dir: str, size: int, years: int, seed: int) -> "list[str]":
    """One tiled-deflate uint16 single-band file per year (256-px blocks,
    predictor on); smooth ramps + noise so deflate really compresses."""
    os.makedirs(scene_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    base = (yy * 3 + xx * 2) % 4096
    paths = []
    for k in range(years):
        arr = (base + k * 37 + rng.integers(0, 64, size=(size, size))).astype(np.uint16)
        p = os.path.join(scene_dir, f"band_{1984 + k}.tif")
        write_geotiff(p, arr, compress="deflate", tile=256, predictor=True)
        paths.append(p)
    return paths


def plan_windows(size: int, window: int) -> "list[tuple[int, int, int, int]]":
    return [(y0, x0, min(window, size - y0), min(window, size - x0))
            for y0 in range(0, size, window) for x0 in range(0, size, window)]


def sweep(paths: "list[str]", wins, readahead: bool) -> float:
    """One feed pass: every window of every year, row-major; with
    ``readahead`` the next window's blocks are hinted first."""
    t0 = time.perf_counter()
    for wi, win in enumerate(wins):
        if readahead and wi + 1 < len(wins):
            for p in paths:
                blockcache.prefetch_window(p, *wins[wi + 1])
        for p in paths:
            read_geotiff_window(p, *win)
    return time.perf_counter() - t0


def check_parity(paths: "list[str]", wins, n_sample: int = 4) -> int:
    """Cached window reads byte-match full reads on sampled windows."""
    full = {p: read_geotiff(p)[0] for p in paths[:2]}
    step = max(1, len(wins) // n_sample)
    checked = 0
    for win in wins[::step]:
        y0, x0, h, w = win
        for p, ref in full.items():
            if not np.array_equal(read_geotiff_window(p, *win), ref[y0 : y0 + h, x0 : x0 + w]):
                raise AssertionError(f"window {win} of {p} mismatches full read")
            checked += 1
    return checked


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=2048, help="scene edge (px)")
    ap.add_argument("--years", type=int, default=6, help="files in the stack")
    ap.add_argument("--window", type=int, default=192,
                    help="feed window edge; NOT a multiple of the 256-px block")
    ap.add_argument("--cache-mb", type=int, default=256)
    ap.add_argument("--workers", type=int, default=0, help="0 = auto")
    ap.add_argument("--seed", type=int, default=20260802)
    ap.add_argument("--reps", type=int, default=3, help="timed reps a mode; the median is kept")
    ap.add_argument("--out", default="FEED_cuda.json")
    ap.add_argument("--scene-dir", default=None, help="keep/reuse the scene here")
    ap.add_argument("--events-dir", default=None,
                    help="also emit a schema-valid events.jsonl with the feed_cache rollup")
    ap.add_argument("--smoke", action="store_true", help="tiny scene, seconds not minutes")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card's host) or cpu (tests)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.smoke:
        args.size = min(args.size, 512)
        args.years = min(args.years, 3)
        args.window = min(args.window, 160)
        args.reps = 1

    tmp = None
    scene_dir = args.scene_dir
    if scene_dir is None:
        tmp = scene_dir = tempfile.mkdtemp(prefix="lt_feed_bench_")
    try:
        paths = build_scene(scene_dir, args.size, args.years, args.seed)
        wins = plan_windows(args.size, args.window)
        px = args.size * args.size * args.years

        def run(cache_mb: int, workers: int, readahead: bool) -> dict:
            blockcache.configure(budget_bytes=cache_mb << 20, workers=workers)
            walls, stats = [], None
            for _ in range(max(1, args.reps)):
                blockcache.cache_clear()  # every rep decodes from cold
                base = blockcache.stats_snapshot()
                walls.append(sweep(paths, wins, readahead=readahead))
                stats = blockcache.stats_delta(base)
            wall = sorted(walls)[len(walls) // 2]
            return {"wall_s": round(wall, 4), "px_per_s": round(px / wall, 1),
                    "walls_s": [round(w, 4) for w in walls], "stats": stats}

        # untimed warmup: the scene into the page cache
        blockcache.configure(0, 1)
        sweep(paths, wins, readahead=False)
        baseline = run(0, 1, readahead=False)
        parallel = run(0, args.workers, readahead=False)
        cached = run(args.cache_mb, args.workers, readahead=False)
        cached_ra = run(args.cache_mb, args.workers, readahead=True)
        parity_checked = check_parity(paths, wins)

        def walls(r: dict) -> dict:
            return {k: r[k] for k in ("wall_s", "px_per_s")}

        result = {
            **record_meta("land_trendr_tpu_torch.tools.feed_bench", argv, device.type),
            "scene": {"size": args.size, "years": args.years, "window": args.window,
                      "layout": "tiled-256 deflate+predictor uint16", "windows": len(wins),
                      "pixels": px},
            "config": {"cache_mb": args.cache_mb, "decode_workers": args.workers,
                       "cpu_count": os.cpu_count(), "native": native.available()},
            "baseline_serial_uncached": walls(baseline),
            "parallel_uncached": walls(parallel),
            "cached_parallel": walls(cached),
            "cached_parallel_readahead": walls(cached_ra),
            "speedup_parallel": round(baseline["wall_s"] / parallel["wall_s"], 3),
            "speedup_cached": round(baseline["wall_s"] / cached["wall_s"], 3),
            "cache_stats": cached["stats"],
            "readahead_stats": {k: cached_ra["stats"][k] for k in (
                "readahead_blocks", "readahead_hits", "readahead_dropped", "hits", "misses")},
            "parity_windows_checked": parity_checked,
            "parity_ok": True,
            "smoke": bool(args.smoke),
        }
        write_json_atomic(args.out, result)
        if args.events_dir:
            from land_trendr_tpu_torch.obs import Telemetry

            tel = Telemetry(args.events_dir, fingerprint="feed_bench")
            try:
                tel.run_start(fingerprint="feed_bench", process_index=0, process_count=1,
                              tiles_total=len(wins), tiles_todo=len(wins),
                              tiles_skipped_resume=0, mesh_devices=1, impl="host-feed")
                tel.feed_cache(cached["stats"])
                tel.run_done("ok", tiles_done=len(wins), pixels=px, wall_s=cached["wall_s"],
                             px_per_s=cached["px_per_s"], fit_rate=0.0)
            finally:
                tel.close()
        print(json.dumps(result, indent=2))
        return 0
    finally:
        blockcache.configure(0, None)  # leave the process unconfigured
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
