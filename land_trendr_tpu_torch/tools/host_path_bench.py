"""Host feed and write throughput, against the kernel's rate on the card.

Counterpart of the JAX package's ``tools/host_path_bench.py``: the three
host stages of a tile, timed in isolation on a real-shaped tile (512² x
40 years, the NBR band set), each reported as single-core px/s and as
the cores it would take to keep up with the fused kernel on this card:

* ``feed.native`` / ``feed.numpy`` — the tile gather (``_feed_tile``;
  the threaded C++ gather when the host codec is built, else NumPy);
* ``write.none`` / ``write.deflate`` — the manifest artifact, stored or
  zlib-1 streamed (plus ``write.none_python_fallback`` when the native
  writer is built);
* ``write.zlib6`` — ``np.savez_compressed``.

The write payload is the real kernel's output on the synthetic tile
(:func:`~land_trendr_tpu_torch.ops.tile.process_tile_dn` on ``--device``),
so compression ratios reflect real segmentation outputs.  On the card
the kernel's own rate is measured in the same run (CUDA events around
:func:`~land_trendr_tpu_torch.ops.segment_cuda.cuda_segment_pixels` on
the tile's NBR series) and ``cores_for_kernel_rate`` divides it by each
stage's single-core px/s; on the CPU that column is ``None``.  The feed
pool's aggregate px/s at 1, 2 and 4 threads is recorded as well.

Usage::

    python -m land_trendr_tpu_torch.tools.host_path_bench [--out HOSTPATH.json]
        [--scene 2048] [--tile 512] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.io import native
from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
from land_trendr_tpu_torch.ops import indices as idx
from land_trendr_tpu_torch.ops import segment_cuda
from land_trendr_tpu_torch.ops.tile import process_tile_dn
from land_trendr_tpu_torch.runtime.driver import RunConfig, TileSpec, _feed_tile, resolve_device
from land_trendr_tpu_torch.runtime.fetch import TileFetcher
from land_trendr_tpu_torch.runtime.manifest import TileManifest
from land_trendr_tpu_torch.runtime.stack import stack_from_synthetic
from land_trendr_tpu_torch.tools.measure import record_meta, write_json_atomic

__all__ = ["NORTH_STAR_PX_S", "main", "time_fn"]

NY = 40
#: the repo's north star (SURVEY.md §7): 10M px/s a device
NORTH_STAR_PX_S = 10e6


def time_fn(fn, reps: int, warmup: int = 1) -> float:
    """Mean seconds of ``fn`` over ``reps`` calls after ``warmup``."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def kernel_px_per_s(stack, t: TileSpec, tile_px: int, device, reps: int = 10) -> float:
    """The fused kernel's px/s on the tile's NBR series (CUDA events)."""
    dn, qa = _feed_tile(stack, t, tile_px, idx.required_bands("nbr"))
    sr = {k: idx.scale_sr(torch.from_numpy(v).to(device)) for k, v in dn.items()}
    qa_t = torch.from_numpy(qa).to(device)
    mask = (idx.qa_valid_mask(qa_t) & idx.sr_valid_mask(sr)).contiguous()
    vals = idx.compute_index("nbr", sr).contiguous()
    years = torch.as_tensor(np.asarray(stack.years, np.int32), device=device)
    segment_cuda.cuda_segment_pixels(years, vals, mask, LTParams())
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        segment_cuda.cuda_segment_pixels(years, vals, mask, LTParams())
    end.record()
    end.synchronize()
    return tile_px / (start.elapsed_time(end) / reps / 1e3)


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="HOSTPATH_cuda.json")
    ap.add_argument("--scene", type=int, default=2048,
                    help="synthetic scene edge (>= 1.5 x the tile)")
    ap.add_argument("--tile", type=int, default=512)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    tile = args.tile
    if args.scene < tile + tile // 2:
        print(f"error: --scene {args.scene} < 1.5 x --tile {tile}", file=sys.stderr)
        return 2
    spec = SceneSpec(width=args.scene, height=args.scene, year_start=1984,
                     year_end=1984 + NY - 1, seed=7)
    stack = stack_from_synthetic(make_stack(spec))
    bands = idx.required_bands("nbr")
    t = TileSpec(tile_id=0, y0=tile // 2, x0=tile // 2, h=tile, w=tile)
    px = tile * tile
    feed_bytes = (len(bands) + 1) * 2 * px * NY  # DN bands + QA, 16-bit
    k_rate = kernel_px_per_s(stack, t, px, device) if device.type == "cuda" else None

    result: dict = {
        **record_meta("land_trendr_tpu_torch.tools.host_path_bench", argv, device.type),
        "nproc": os.cpu_count(),
        "tile": {"size": tile, "years": NY, "bands": sorted(bands) + ["qa"]},
        "north_star_px_s": NORTH_STAR_PX_S,
        "kernel_px_per_s": round(k_rate, 1) if k_rate else None,
        "stages": {},
    }

    def add(name: str, seconds: float, nbytes: int) -> None:
        px_s = px / seconds
        result["stages"][name] = {
            "s_per_tile": round(seconds, 4),
            "mb_per_s": round(nbytes / seconds / 1e6, 1),
            "px_per_s_per_core": round(px_s, 1),
            "cores_for_north_star": round(NORTH_STAR_PX_S / px_s, 2),
            "cores_for_kernel_rate": round(k_rate / px_s, 2) if k_rate else None,
        }

    # --- feed -------------------------------------------------------------
    sec = time_fn(lambda: _feed_tile(stack, t, px, bands), reps=10)
    add("feed.native" if native.available() else "feed.numpy", sec, feed_bytes)
    if native.available():
        orig = native._LIB
        native._LIB = None
        try:
            add("feed.numpy", time_fn(lambda: _feed_tile(stack, t, px, bands), reps=5), feed_bytes)
        finally:
            native._LIB = orig

    # --- the feed pool's aggregate rate at 1, 2, 4 threads ----------------
    grid = args.scene // tile
    feed_tiles = [TileSpec(tile_id=i, y0=(i // grid) * tile, x0=(i % grid) * tile, h=tile, w=tile)
                  for i in range(min(8, grid * grid))]
    scaling = {}
    for workers in (1, 2, 4):
        with ThreadPoolExecutor(max_workers=workers) as ex:
            list(ex.map(lambda tt: _feed_tile(stack, tt, px, bands), feed_tiles))
            t0 = time.perf_counter()
            list(ex.map(lambda tt: _feed_tile(stack, tt, px, bands), feed_tiles))
            scaling[str(workers)] = round(len(feed_tiles) * px / (time.perf_counter() - t0), 1)
    result["feed_scaling_px_s_aggregate"] = scaling

    # --- the real kernel payload for the write stage -----------------------
    dn, qa = _feed_tile(stack, t, px, bands)
    out = process_tile_dn(
        torch.as_tensor(np.asarray(stack.years, np.int32), device=device),
        {k: torch.from_numpy(v).to(device) for k, v in dn.items()},
        torch.from_numpy(qa).to(device), index="nbr", params=LTParams())
    cfg = RunConfig()
    arrays, _ = TileFetcher(cfg, device, packed=False).start(out).tile_arrays(t)
    payload = int(sum(a.nbytes for a in arrays.values()))
    result["tile"]["write_payload_mb"] = round(payload / 1e6, 1)

    workdir = tempfile.mkdtemp(prefix="lt_hostpath_")
    try:
        sizes = {}
        for mode in ("none", "deflate"):
            m = TileManifest(os.path.join(workdir, mode), "b" * 16)
            m.open(resume=False)
            add(f"write.{mode}", time_fn(lambda: m.record(0, arrays, {}, compress=mode), reps=3),
                payload)
            sizes[mode] = os.path.getsize(m.tile_path(0))
        if native.available():
            m = TileManifest(os.path.join(workdir, "none_py"), "b" * 16)
            m.open(resume=False)
            orig = native._LIB
            native._LIB = None
            try:
                sec = time_fn(lambda: m.record(0, arrays, {}, compress="none"), reps=3)
            finally:
                native._LIB = orig
            add("write.none_python_fallback", sec, payload)
        z6 = os.path.join(workdir, "z6.npz")
        add("write.zlib6", time_fn(lambda: np.savez_compressed(z6, **arrays), reps=3), payload)
        sizes["zlib6"] = os.path.getsize(z6)
        result["artifact_bytes"] = sizes
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    write_json_atomic(args.out, result)
    print(json.dumps(result["stages"], indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
