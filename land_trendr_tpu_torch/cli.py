"""Command-line driver for the PyTorch/CUDA package.

Counterpart of ``land_trendr_tpu/cli.py`` for the commands this package
ports so far:

``segment``   stack directory → segment rasters (the main pipeline), with
              optional FTV rasters (``--ftv``) and fused change maps
              (``--change``)
``change``    segment rasters → change maps (yod/mag/dur/rate/preval/dsnr)
``synth``     materialise a synthetic Landsat stack (fixtures / demos)
``params``    print the algorithm parameters as JSON (a template for
              ``--params-json``)

The top-level ``--device`` flag picks where the pipeline runs: ``cuda``
(the default, the hand-written kernel on the card) or ``cpu`` (the plain
PyTorch version; for tests and debugging only).  ``--device cuda`` on a
machine without a usable card fails with a clear error; it never carries
on on the CPU (``change`` runs its selector there too).  The device also
decides the segmentation implementation, so there is no ``--impl``.  Flags of the JAX package's ``segment`` that
this package does not implement yet are rejected as unknown arguments.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops.indices import DEFAULT_QA_REJECT, INDEX_NAMES
from land_trendr_tpu_torch.runtime.manifest import ARTIFACT_COMPRESS

__all__ = ["main", "build_parser", "run"]


def _add_param_flags(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("algorithm parameters (reference names)")
    g.add_argument("--params-json", type=str, default=None,
                   help="path to an LTParams JSON file (flags override it)")
    for f in dataclasses.fields(LTParams):
        flag = "--" + f.name.replace("_", "-")
        if f.type == "bool":
            g.add_argument(flag, type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=None, metavar="BOOL")
        else:
            g.add_argument(flag, type=int if f.type == "int" else float, default=None)


def _params_from_args(args: argparse.Namespace) -> LTParams:
    base = {}
    if args.params_json:
        with open(args.params_json) as f:
            base = json.load(f)
    for f in dataclasses.fields(LTParams):
        v = getattr(args, f.name, None)
        if v is not None:
            base[f.name] = v
    return LTParams.from_dict(base)


def _add_change_flags(p: argparse.ArgumentParser, prefix: str = "") -> None:
    """The ChangeFilter fields as flags: bare for ``change``, ``--change-``
    prefixed for ``segment --change`` (the JAX package's names)."""
    p.add_argument(f"--{prefix}kind", default="disturbance",
                   choices=("disturbance", "recovery"))
    p.add_argument(f"--{prefix}sort", default="greatest",
                   choices=("greatest", "newest", "oldest"),
                   help="which qualifying segment becomes the map")
    p.add_argument(f"--{prefix}min-mag", type=float, default=0.0,
                   help="minimum |magnitude| in index units")
    p.add_argument(f"--{prefix}min-dur", type=float, default=0.0)
    p.add_argument(f"--{prefix}max-dur", type=float, default=float("inf"),
                   help="maximum duration in years (classic fast-disturbance "
                   "filter: 4)")
    p.add_argument(f"--{prefix}min-preval", type=float, default=float("-inf"),
                   help="minimum fitted value at the segment start")
    p.add_argument(f"--{prefix}max-p", type=float, default=1.0,
                   help="extra p-of-F cap on top of the run's threshold")
    p.add_argument(f"--{prefix}year-min", type=float, default=float("-inf"))
    p.add_argument(f"--{prefix}year-max", type=float, default=float("inf"))
    p.add_argument(f"--{prefix}mmu", type=int, default=1,
                   help="minimum mapping unit: drop 4-connected changed patches "
                   "smaller than this many pixels (spatial, so it runs on the "
                   "assembled rasters)")


def _change_filter_from_args(args: argparse.Namespace, prefix: str = ""):
    """One ChangeFilter construction for ``change`` (bare names) and
    ``segment --change`` (``change_`` prefixed)."""
    from land_trendr_tpu_torch.ops.change import ChangeFilter

    def g(name):
        return getattr(args, prefix + name)

    return ChangeFilter(
        kind=g("kind"), sort=g("sort"), min_mag=g("min_mag"), min_dur=g("min_dur"),
        max_dur=g("max_dur"), min_preval=g("min_preval"), max_p=g("max_p"),
        year_min=g("year_min"), year_max=g("year_max"),
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="land_trendr_tpu_torch",
        description="LandTrendr temporal segmentation on PyTorch + CUDA",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the pipeline runs: 'cuda' (default; the fused kernel on "
        "the card) or 'cpu' (the plain PyTorch version — tests and "
        "debugging only)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    seg = sub.add_parser("segment", help="segment a Landsat stack directory")
    seg.add_argument("stack_dir", help="directory of per-year multi-band GeoTIFFs "
                     "or Collection-2 per-band files")
    seg.add_argument("--index", default="nbr", choices=INDEX_NAMES,
                     help="index driving the segmentation")
    seg.add_argument("--ftv", default="", help="comma-separated FTV indices")
    seg.add_argument("--tile-size", type=int, default=512, help="tile edge in pixels")
    seg.add_argument("--workdir", default="lt_work")
    seg.add_argument("--out-dir", default="lt_out")
    seg.add_argument("--no-resume", action="store_true",
                     help="discard any existing workdir manifest")
    seg.add_argument("--products", default=None, metavar="P1,P2,...",
                     help="subset of segmentation products to write")
    seg.add_argument("--write-fitted", action="store_true",
                     help="also write the fitted trajectory raster")
    seg.add_argument("--fetch-f16", action="store_true",
                     help="fetch float products from the device as float16 "
                     "(halves device→host bytes; lossy, ~5e-4 relative)")
    seg.add_argument("--no-packed-fetch", action="store_true",
                     help="fetch each product on its own (default: one packed "
                     "device→host copy per tile on a CUDA device)")
    seg.add_argument("--packed-fetch", action="store_true",
                     help="force the packed fetch")
    seg.add_argument("--fetch-depth", type=int, default=2,
                     help="packed fetches in flight")
    seg.add_argument("--no-packed-upload", action="store_true",
                     help="upload each fed array on its own (default: one "
                     "packed pinned host→device copy per tile on a CUDA device)")
    seg.add_argument("--packed-upload", action="store_true",
                     help="force the packed upload")
    seg.add_argument("--upload-depth", type=int, default=2,
                     help="packed uploads in flight")
    seg.add_argument("--out-compress", default="deflate",
                     choices=("deflate", "lzw", "none"))
    seg.add_argument("--manifest-compress", default="none", choices=ARTIFACT_COMPRESS)
    seg.add_argument("--write-workers", type=int, default=1,
                     help="background tile-writer threads")
    seg.add_argument("--feed-workers", type=int, default=1,
                     help="background feed threads")
    seg.add_argument("--reject-bits", type=lambda s: int(s, 0),
                     default=DEFAULT_QA_REJECT, metavar="MASK",
                     help="QA_PIXEL bitmask of rejected observation classes "
                     f"(decimal or 0x hex; default 0x{DEFAULT_QA_REJECT:x})")
    seg.add_argument("--chunk-px", default=262_144, metavar="N",
                     type=lambda s: None if s.lower() == "none" else int(s),
                     help="tiles with more pixels run the segmentation as "
                     "chunked launches; 'none' disables chunking")
    seg.add_argument("--scale", type=float, default=2.75e-5,
                     help="DN → reflectance scale (C2 default)")
    seg.add_argument("--offset", type=float, default=-0.2,
                     help="DN → reflectance offset (C2 default)")
    seg.add_argument("--change", action="store_true",
                     help="fuse change-map selection into every tile's program; "
                     "change_*.tif rasters assemble beside the segment products")
    _add_change_flags(seg, prefix="change-")
    _add_param_flags(seg)

    chg = sub.add_parser(
        "change",
        help="derive change maps (yod/mag/dur/rate/preval/dsnr) from segment rasters",
    )
    chg.add_argument("seg_dir", help="out-dir of a finished `segment` run")
    chg.add_argument("--dest", default="lt_change", help="output directory")
    chg.add_argument("--index", default="nbr", choices=INDEX_NAMES,
                     help="index the segmentation ran on (sets the disturbance "
                     "direction)")
    _add_change_flags(chg)

    par = sub.add_parser("params", help="print default LTParams JSON")
    _add_param_flags(par)

    syn = sub.add_parser("synth", help="write a synthetic Landsat stack")
    syn.add_argument("out_dir")
    syn.add_argument("--size", type=int, default=256)
    syn.add_argument("--year-start", type=int, default=1984)
    syn.add_argument("--year-end", type=int, default=2023)
    syn.add_argument("--seed", type=int, default=20260729)
    return p


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )

    if args.cmd == "params":
        print(_params_from_args(args).to_json())
        return 0

    if args.cmd == "synth":
        from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack

        spec = SceneSpec(
            width=args.size, height=args.size,
            year_start=args.year_start, year_end=args.year_end, seed=args.seed,
        )
        paths = write_stack(args.out_dir, make_stack(spec))
        print(json.dumps({"files": len(paths), "out_dir": args.out_dir}))
        return 0

    if args.cmd == "change":
        from land_trendr_tpu_torch.ops.change import write_change_maps
        from land_trendr_tpu_torch.runtime.driver import resolve_device

        try:
            device = resolve_device(args.device)
        except (ValueError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        paths = write_change_maps(
            args.seg_dir, args.dest, index=args.index, filt=_change_filter_from_args(args),
            mmu=args.mmu, device=device,
        )
        print(json.dumps({"outputs": paths}, indent=2))
        return 0

    # segment — deferred imports keep --help fast
    from land_trendr_tpu_torch.ops.change import ChangeFilter, sieve_change_rasters
    from land_trendr_tpu_torch.ops.indices import required_bands
    from land_trendr_tpu_torch.runtime.driver import (
        RunConfig,
        assemble_outputs,
        resolve_device,
        run_stack,
    )
    from land_trendr_tpu_torch.runtime.stack import load_stack_dir

    for flag in ("fetch", "upload"):
        if getattr(args, f"no_packed_{flag}") and getattr(args, f"packed_{flag}"):
            print(f"error: --packed-{flag} conflicts with --no-packed-{flag}",
                  file=sys.stderr)
            return 2
    ftv = tuple(x.strip() for x in args.ftv.split(",") if x.strip())
    change_filt = _change_filter_from_args(args, prefix="change_")
    if not args.change:
        if change_filt != ChangeFilter() or args.change_mmu != 1:
            print("error: --change-* options require --change (without it no "
                  "change rasters are produced)", file=sys.stderr)
            return 2
        change_filt = None
    try:
        device = resolve_device(args.device)
        cfg = RunConfig(
            index=args.index,
            ftv_indices=ftv,
            params=_params_from_args(args),
            tile_size=args.tile_size,
            workdir=args.workdir,
            out_dir=args.out_dir,
            resume=not args.no_resume,
            write_fitted=args.write_fitted,
            fetch_f16=args.fetch_f16,
            change_filt=change_filt,
            products=(
                tuple(x.strip() for x in args.products.split(","))
                if args.products else None
            ),
            fetch_packed=(
                False if args.no_packed_fetch else True if args.packed_fetch else "auto"
            ),
            fetch_depth=args.fetch_depth,
            upload_packed=(
                False if args.no_packed_upload else True if args.packed_upload else "auto"
            ),
            upload_depth=args.upload_depth,
            scale=args.scale,
            offset=args.offset,
            reject_bits=args.reject_bits,
            out_compress=args.out_compress,
            manifest_compress=args.manifest_compress,
            write_workers=args.write_workers,
            feed_workers=args.feed_workers,
            chunk_px=args.chunk_px,
        )
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    stack = load_stack_dir(
        args.stack_dir,
        bands=required_bands(args.index, ftv),
        reject_bits=cfg.reject_bits,
        scale=cfg.scale,
        offset=cfg.offset,
    )
    try:
        summary = run_stack(stack, cfg, device=device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    paths = assemble_outputs(stack, cfg)
    if change_filt is not None and args.change_mmu > 1:
        sieve_change_rasters(cfg.out_dir, args.change_mmu)
    print(json.dumps({"summary": summary, "outputs": paths}, indent=2))
    return 0


def run() -> int:
    """Console entry; exits quietly when stdout is a closed pipe."""
    try:
        return main()
    except BrokenPipeError:
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(run())
