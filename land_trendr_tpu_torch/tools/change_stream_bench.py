"""Bounded-memory change maps at mosaic scale: the streamed change layer
with the mmu sieve, on the card.

Counterpart of the JAX package's ``tools/change_stream_bench.py``.  A
child process fabricates the full segment-product set (29 bands over 8
rasters; patchy disturbances with known years, as compressible as real
products) straight through ``GeoTiffStreamWriter`` in row bands, so its
transients stay out of this process's RSS; then this process runs the
port's :func:`~land_trendr_tpu_torch.ops.change.write_change_maps` (the
selector on ``--device``) with ``mmu`` > 1 (the full-raster sieve plus
the windowed zero-rewrite pass) and records wall seconds and its own
peak RSS, captured before any verification read.

Usage::

    python -m land_trendr_tpu_torch.tools.change_stream_bench [--size=16000]
        [--mmu=9] [--work-root .] [--device cuda|cpu] [--out CHANGESTREAM.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from land_trendr_tpu_torch.tools.measure import (
    child_env,
    disk_free,
    peak_rss_mib,
    record_meta,
    watch_rss,
    write_json_atomic,
)

__all__ = ["fabricate", "main", "measure"]


def fabricate(seg_dir: str, h: int, w: int, band_rows: int) -> None:
    """Segment products with a known disturbance structure: ~30% of pixels
    carry one big drop (magnitude -0.4 over 3 years) at a patch-dependent
    year, the rest only sub-threshold wiggle (the JAX tool's fields)."""
    from land_trendr_tpu_torch.io.geotiff import GeoMeta, GeoTiffStreamWriter

    geo = GeoMeta(pixel_scale=(30.0, 30.0, 0.0), tiepoint=(0, 0, 0, 5e5, 4e6, 0))
    nv, nm = 7, 6
    specs = {
        "vertex_years": (nv, np.float32),
        "vertex_fit_vals": (nv, np.float32),
        "seg_magnitude": (nm, np.float32),
        "seg_duration": (nm, np.float32),
        "seg_rate": (nm, np.float32),
        "model_valid": (1, np.uint8),
        "p_of_f": (1, np.float32),
        "rmse": (1, np.float32),
    }
    writers = {
        k: GeoTiffStreamWriter(os.path.join(seg_dir, f"{k}.tif"), h, w, depth, dt, geo=geo)
        for k, (depth, dt) in specs.items()
    }
    rng = np.random.default_rng(9)
    for y0 in range(0, h, band_rows):
        hb = min(band_rows, h - y0)
        # 64 x 64 patches share a disturbance year (or none)
        by = (y0 + np.arange(hb)[:, None]) // 64
        bx = np.arange(w)[None, :] // 64
        patch = (by * 131 + bx * 17) % 10  # 0..9; < 3 → disturbed
        disturbed = patch < 3
        d_year = 1990.0 + (patch * 3) % 20

        vy = np.empty((hb, w, nv), np.float32)
        vf = np.empty((hb, w, nv), np.float32)
        vy[..., 0] = 1984.0
        vy[..., 1] = np.where(disturbed, d_year, 1998.0)
        vy[..., 2] = np.where(disturbed, d_year + 3.0, 2012.0)
        vy[..., 3] = 2023.0
        vy[..., 4:] = 0.0
        vf[..., 0] = 0.6
        vf[..., 1] = np.where(disturbed, 0.62, 0.58)
        vf[..., 2] = np.where(disturbed, 0.22, 0.60)
        vf[..., 3] = np.where(disturbed, 0.45, 0.61)
        vf[..., 4:] = 0.0
        mag = np.zeros((hb, w, nm), np.float32)
        dur = np.zeros((hb, w, nm), np.float32)
        mag[..., :3] = vf[..., 1:4] - vf[..., :3]
        dur[..., :3] = vy[..., 1:4] - vy[..., :3]
        rate = np.where(dur > 0, mag / np.where(dur > 0, dur, 1.0), 0.0)
        arrays = {
            "vertex_years": vy,
            "vertex_fit_vals": vf,
            "seg_magnitude": mag,
            "seg_duration": dur,
            "seg_rate": rate.astype(np.float32),
            "model_valid": np.ones((hb, w, 1), np.uint8),
            "p_of_f": np.full((hb, w, 1), 0.01, np.float32),
            "rmse": rng.uniform(0.02, 0.06, (hb, w, 1)).astype(np.float32),
        }
        for k, a in arrays.items():
            writers[k].write(y0, 0, a)
    for wr in writers.values():
        wr.close()


def measure(size: int, mmu: int, work_root: str, device: str, keep: bool = False) -> dict:
    """Fabricate (child process), then the change maps here; the record
    (without :func:`record_meta`).  ``keep`` leaves the products and the
    maps in ``work_root`` (tests compare them)."""
    from land_trendr_tpu_torch.io.geotiff import read_geotiff_window
    from land_trendr_tpu_torch.ops.change import ChangeFilter, write_change_maps

    h = w = size
    seg_dir = os.path.join(work_root, ".changestream_seg")
    dest = os.path.join(work_root, ".changestream_out")
    shutil.rmtree(dest, ignore_errors=True)
    disk = disk_free(work_root)
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "land_trendr_tpu_torch.tools.change_stream_bench",
                    f"--size={size}", "--work-root", work_root, "--fabricate-only"],
                   check=True, env=child_env())
    fab_s = time.perf_counter() - t0
    rss_fab = peak_rss_mib()

    t0 = time.perf_counter()
    paths = write_change_maps(seg_dir, dest, index="nbr", filt=ChangeFilter(min_mag=0.1),
                              mmu=mmu, device=device)
    wall = time.perf_counter() - t0
    peak = peak_rss_mib()  # before any verification read

    rows = min(128, h)
    yod = np.asarray(read_geotiff_window(paths["yod"], 0, 0, rows, w))
    mask = np.asarray(read_geotiff_window(paths["mask"], 0, 0, rows, w))
    assert ((yod > 0) == (mask > 0)).all()
    assert set(np.unique(yod[yod > 0])).issubset(
        {1991.0 + (p * 3) % 20 for p in range(3)}), np.unique(yod[yod > 0])[:10]
    rec = {
        "height": h,
        "width": w,
        "pixels": h * w,
        "mmu": mmu,
        "fabricate_s": round(fab_s, 3),
        "change_wall_s": round(wall, 3),
        "peak_rss_mb": peak,
        "rss_after_fabricate_mb": rss_fab,
        "changed_frac_first_rows": round(float((mask > 0).mean()), 4),
        "out_bytes": {k: os.path.getsize(p) for k, p in paths.items()},
        "disk_before": disk,
        "note": (
            "full segment-product set fabricated via stream writers in a child process, "
            "then write_change_maps (selector on the run's device) with the mmu sieve + "
            "windowed zero-rewrite; peak_rss_mb is this process's high-water mark in MiB "
            "through the change mapping, captured before verification reads"
        ),
    }
    if not keep:
        shutil.rmtree(seg_dir, ignore_errors=True)
        shutil.rmtree(dest, ignore_errors=True)
    return rec


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=16000)
    ap.add_argument("--mmu", type=int, default=9)
    ap.add_argument("--work-root", default=".", help="where the products and maps are written")
    ap.add_argument("--fabricate-only", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    ap.add_argument("--out", default="CHANGESTREAM.json")
    args = ap.parse_args(argv)
    watch_rss()
    if args.fabricate_only:
        seg_dir = os.path.join(args.work_root, ".changestream_seg")
        shutil.rmtree(seg_dir, ignore_errors=True)
        os.makedirs(seg_dir)
        fabricate(seg_dir, args.size, args.size, band_rows=512)
        return 0
    from land_trendr_tpu_torch.runtime.driver import resolve_device

    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    rec = {f"change_{args.size}x{args.size}_mmu{args.mmu}":
           measure(args.size, args.mmu, args.work_root, dev)}
    rec.update(record_meta("land_trendr_tpu_torch.tools.change_stream_bench", argv, dev.type))
    write_json_atomic(args.out, rec, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
