"""Streaming raster assembly at scale: bounded RSS on a real scene's
workdir and on a fabricated mosaic.

Counterpart of the JAX package's ``tools/stream_assembly_bench.py`` over
the port's :func:`~land_trendr_tpu_torch.runtime.driver.assemble_outputs`
and ``GeoTiffStreamWriter``.  Two modes:

``scene``   re-assemble a finished run's workdir into a throwaway out dir:
            ``WORKDIR`` with the run's stack given by ``--stack-dir`` (the
            years from the file names, shape and grid from one header; no
            pixel is read) or by ``--years FIRST:LAST --shape H,W`` (no
            grid, as an in-memory synthetic stack has none), and the run's
            fingerprinted options (``--tile-size``, ``--ftv``,
            ``--change-max-dur``).  The record carries each raster's
            sha256, so a caller can hold it against the run's own rasters.
``mosaic``  fabricate manifest-format tile artifacts (deflate) for an
            H x W raster (default 40000², 3 products, one of them
            multi-band) through the port's ``TileManifest`` and
            ``plan_tiles``, then stream-assemble them.  The f32 product's
            worst-case encoded size passes u32 addressing at this size, so
            the auto layout takes BigTIFF.

Peak RSS is this process's (``tools/measure.py:peak_rss_mib``), taken
right after the assembly and before any verification read.  Each run adds
its entry (keyed by mode and size, with its own command and digest) to
the record at ``--out``, as the JAX tool merges into its one file.  Both
modes assemble on the host; ``--device`` names the machine the record is
kept for (the card's host by default, whose ``nvidia-smi`` line the
record carries).

Usage::

    python -m land_trendr_tpu_torch.tools.stream_assembly_bench scene WORKDIR
        (--stack-dir D | --years 1984:2023 --shape H,W) [--tile-size 512]
        [--ftv ndvi,tcw] [--change-max-dur 4] [--device cuda|cpu] [--out REC]
    python -m land_trendr_tpu_torch.tools.stream_assembly_bench mosaic [--size=40000]
        [--tile 2048] [--work-root .] [--device cuda|cpu] [--out REC]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import sys
import time

import numpy as np

from land_trendr_tpu_torch.tools.measure import (
    digest_files,
    disk_free,
    merge_record,
    peak_rss_mib,
    record_meta,
    watch_rss,
)

__all__ = ["assemble_mosaic", "fabricate_mosaic", "main", "mosaic", "scene", "stub_stack"]

#: the mosaic's tile edge: not a multiple of 256, so partial blocks buffer
TILE = 2048
#: the mosaic's stub years (its fingerprint hashes them)
MOSAIC_YEARS = np.arange(1984, 1990, dtype=np.int32)


def stub_stack(years, h: int, w: int, geo):
    """A RasterStack with the run's years, shape and grid but no pixel
    cube: assembly reads tile artifacts, the fingerprint hashes years and
    shape only, and a zero-strided QA broadcast gives the shape without
    allocating (NY, H, W)."""
    from land_trendr_tpu_torch.runtime.stack import RasterStack

    return RasterStack(
        years=np.asarray(years, np.int32),
        dn_bands={},
        qa=np.broadcast_to(np.uint16(0), (len(years), h, w)),
        geo=geo,
    )


def _stack_dir_stub(stack_dir: str):
    """The stub of a stack directory: years from the file names, shape and
    grid from the first file's header."""
    from land_trendr_tpu_torch.io.geotiff import read_geotiff_info

    names = sorted(n for n in os.listdir(stack_dir) if n.lower().endswith((".tif", ".tiff")))
    years = sorted({int(re.search(r"(\d{4})", n).group(1)) for n in names})
    geo, info = read_geotiff_info(os.path.join(stack_dir, names[0]))
    return stub_stack(years, info.height, info.width, geo)


def scene(workdir: str, stack, out_dir: str, tile_size: int = 512, ftv=(),
          change_max_dur: "float | None" = None, device: str = "cuda") -> dict:
    """Re-assemble ``workdir`` (a run over ``stack`` with these options)
    into ``out_dir``, then remove it; the record."""
    from land_trendr_tpu_torch.ops.change import ChangeFilter
    from land_trendr_tpu_torch.runtime.driver import RunConfig, assemble_outputs

    cfg = RunConfig(
        tile_size=tile_size, workdir=workdir, out_dir=out_dir, ftv_indices=tuple(ftv),
        change_filt=None if change_max_dur is None else ChangeFilter(max_dur=change_max_dur),
    )
    shutil.rmtree(out_dir, ignore_errors=True)
    disk = disk_free(out_dir)
    rss0 = peak_rss_mib()
    t0 = time.perf_counter()
    paths = assemble_outputs(stack, cfg, device=device)
    wall = time.perf_counter() - t0
    peak = peak_rss_mib()
    digests = digest_files(out_dir)
    rec = {
        "pixels": stack.shape[0] * stack.shape[1],
        "shape": list(stack.shape),
        "years": stack.n_years,
        "products": len(paths),
        "wall_s": round(wall, 3),
        "peak_rss_mb": peak,
        "rss_before_assemble_mb": rss0,
        "out_bytes_total": sum(os.path.getsize(p) for p in paths.values()),
        "out_sha256": digests,
        "disk_before": disk,
        "note": ("re-assembly of a finished run's workdir through the streaming writers; "
                 "peak_rss_mb is this process's high-water mark in MiB"),
    }
    shutil.rmtree(out_dir, ignore_errors=True)
    return rec


def fabricate_mosaic(work: str, h: int, w: int, tile: int) -> float:
    """Manifest-format deflate artifacts for every tile of an H x W run
    (the JAX tool's fields and draws); returns the seconds taken."""
    from land_trendr_tpu_torch.runtime.driver import RunConfig, plan_tiles
    from land_trendr_tpu_torch.runtime.manifest import TileManifest

    stack = stub_stack(MOSAIC_YEARS, h, w, _mosaic_geo())
    cfg = RunConfig(tile_size=tile, workdir=work, out_dir=work + "_unused")
    manifest = TileManifest(work, cfg.fingerprint(stack))
    manifest.open(resume=False)
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    for t in plan_tiles(h, w, tile):
        npx = t.h * t.w
        # smooth-ish fields: realistic deflate ratios without big RAM
        base = rng.normal(0.05, 0.01, size=(npx,)).astype(np.float32)
        arrays = {
            "rmse": base,
            "model_valid": (base > 0.05),
            "vertex_years": np.tile(np.array([1984, 1987, 1989, 0, 0, 0, 0], np.int16), (npx, 1)),
        }
        manifest.record(t.tile_id, arrays, {"y0": t.y0, "x0": t.x0, "h": t.h, "w": t.w},
                        compress="deflate")
    return time.perf_counter() - t0


def _mosaic_geo():
    from land_trendr_tpu_torch.io.geotiff import GeoMeta

    return GeoMeta(pixel_scale=(30.0, 30.0, 0.0), tiepoint=(0, 0, 0, 5e5, 4e6, 0))


def assemble_mosaic(work: str, out_dir: str, h: int, w: int, tile: int,
                    device: str = "cuda") -> "dict[str, str]":
    """Stream-assemble a fabricated mosaic's workdir into ``out_dir``."""
    from land_trendr_tpu_torch.runtime.driver import RunConfig, assemble_outputs

    stack = stub_stack(MOSAIC_YEARS, h, w, _mosaic_geo())
    return assemble_outputs(stack, RunConfig(tile_size=tile, workdir=work, out_dir=out_dir),
                            device=device)


def mosaic(size: int, tile: int, work_root: str, device: str = "cuda") -> dict:
    """Fabricate, assemble, verify and clean up; the record."""
    from land_trendr_tpu_torch.io.geotiff import read_geotiff

    h = w = int(size)
    work = os.path.join(work_root, ".streamasm_work")
    out_dir = os.path.join(work_root, ".streamasm_out")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    disk = disk_free(work_root)
    fab_s = fabricate_mosaic(work, h, w, tile)
    rss_after_fab = peak_rss_mib()
    t0 = time.perf_counter()
    paths = assemble_mosaic(work, out_dir, h, w, tile, device)
    wall = time.perf_counter() - t0
    # the high-water mark NOW: what follows is verification, and a full
    # read of the (7, H, W) product would put it on the measurement
    peak = peak_rss_mib()

    with open(paths["rmse"], "rb") as f:
        magic = f.read(4)
    assert magic[:2] == b"II", magic
    mv, _, mv_info = read_geotiff(paths["model_valid"])  # the small product
    assert mv.shape == (h, w), mv.shape
    rec = {
        "height": h,
        "width": w,
        "pixels": h * w,
        "products": sorted(paths),
        "tile_size": tile,
        "fabricate_s": round(fab_s, 3),
        "assemble_wall_s": round(wall, 3),
        "peak_rss_mb": peak,
        "rss_after_fabricate_mb": rss_after_fab,
        "rmse_bigtiff": magic[2] == 43,  # the BigTIFF version word
        "model_valid_bigtiff": bool(mv_info.big),
        "out_bytes": {k: os.path.getsize(p) for k, p in paths.items()},
        "disk_before": disk,
        "note": ("fabricated manifest artifacts (deflate) streamed into product writers; "
                 "peak_rss_mb is this process's high-water mark in MiB through fabrication "
                 "and assembly, captured before any verification read"),
    }
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(out_dir, ignore_errors=True)
    return rec


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=["scene", "mosaic"])
    ap.add_argument("workdir", nargs="?", help="scene: the finished run's workdir")
    ap.add_argument("--stack-dir", default=None, help="scene: the run's stack directory")
    ap.add_argument("--years", default=None, help="scene: FIRST:LAST, with --shape")
    ap.add_argument("--shape", default=None, help="scene: H,W, with --years")
    ap.add_argument("--tile-size", type=int, default=512, help="scene: the run's tile size")
    ap.add_argument("--ftv", default="", help="scene: the run's FTV indices")
    ap.add_argument("--change-max-dur", type=float, default=None,
                    help="scene: the run's ChangeFilter(max_dur=...), if it made change rasters")
    ap.add_argument("--out-dir", default=None, help="scene: the throwaway out dir")
    ap.add_argument("--size", type=int, default=40000, help="mosaic edge (px)")
    ap.add_argument("--tile", type=int, default=TILE, help="mosaic tile edge (px)")
    ap.add_argument("--work-root", default=".", help="mosaic: where its work and out dirs go")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card's host) or cpu (tests)")
    ap.add_argument("--out", default="STREAMASM.json")
    args = ap.parse_args(argv)
    watch_rss()
    from land_trendr_tpu_torch.runtime.driver import resolve_device

    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.mode == "scene":
        if not args.workdir or (args.stack_dir is None) == (args.years is None):
            ap.error("scene needs WORKDIR and one of --stack-dir or --years/--shape")
        if args.stack_dir is not None:
            stack = _stack_dir_stub(args.stack_dir)
        else:
            first, last = (int(y) for y in args.years.split(":"))
            h, w = (int(v) for v in args.shape.split(","))
            stack = stub_stack(np.arange(first, last + 1), h, w, None)
        out_dir = args.out_dir or os.path.join(os.path.dirname(os.path.abspath(args.workdir)),
                                               "out_stream")
        ftv = [x.strip() for x in args.ftv.split(",") if x.strip()]
        key = f"scene_{stack.shape[0]}x{stack.shape[1]}"
        body = scene(args.workdir, stack, out_dir, args.tile_size, ftv, args.change_max_dur, dev)
    else:
        key = f"mosaic_{args.size}x{args.size}"
        body = mosaic(args.size, args.tile, args.work_root, dev)
    body.update(record_meta("land_trendr_tpu_torch.tools.stream_assembly_bench", argv, dev.type))
    merge_record(args.out, key, body)
    print(json.dumps({key: {k: v for k, v in body.items() if k != "out_sha256"}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
