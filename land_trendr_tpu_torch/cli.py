"""Command-line driver for the PyTorch/CUDA package.

Counterpart of ``land_trendr_tpu/cli.py`` for the commands this package
ports so far:

``segment``   stack directory → segment rasters (the main pipeline), with
              optional FTV rasters (``--ftv``) and fused change maps
              (``--change``); retries, quarantine, the stall watchdog,
              fault injection, the feed cache and ingest store, the medoid
              composite, overviews, telemetry, the flight recorder and a
              profiler trace (``--trace``)
``pixel``     segment ONE series through the NumPy oracle and/or this
              package's segmentation (the single-pixel debug/parity path)
``change``    segment rasters → change maps (yod/mag/dur/rate/preval/dsnr)
``info``      inspect rasters header-only, optionally one decoded window
``synth``     materialise a synthetic Landsat stack (fixtures / demos)
``params``    print the algorithm parameters as JSON (a template for
              ``--params-json``)

The top-level ``--device`` flag picks where the pipeline runs: ``cuda``
(the default, the hand-written kernel on the card) or ``cpu`` (the plain
PyTorch version; for tests and debugging only).  ``--device cuda`` on a
machine without a usable card fails with a clear error; it never carries
on on the CPU (``change`` runs its selector there too, ``--composite``
its selection).  The device also decides the segmentation implementation,
so there is no ``--impl``.  Flags of the JAX package's ``segment`` that
this package does not implement yet (leases, speculation, the multihost
merge, mesh sharding, tuning, fleet publish) are rejected as unknown
arguments.

Exit codes of ``segment``: 2 config/usage error, 3 a tile exhausted its
retries or was quarantined (a re-run resumes exactly the missing tiles),
4 stall-watchdog abort.
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
    seg.add_argument("--lazy", action="store_true",
                     help="windowed file-backed ingest (C2 per-band layout "
                     "only): no input cube in host RAM")
    seg.add_argument("--feed-cache-mb", type=int, default=256,
                     help="decoded-block cache budget (MiB) for the windowed "
                     "feed path; 0 disables the cache")
    seg.add_argument("--decode-workers", type=int, default=0,
                     help="feed-decode threads: 0 = auto, 1 = serial, N = N")
    seg.add_argument("--no-feed-readahead", action="store_true",
                     help="disable the next-tile block-decode hint (only "
                     "meaningful with --lazy and a non-zero --feed-cache-mb)")
    seg.add_argument("--ingest-store-mb", type=int, default=0,
                     help="persistent decoded-block store budget (MiB) under "
                     "the workdir: a rerun over the same stacks skips decode; "
                     "0 = off")
    seg.add_argument("--ingest-store-dir", default=None, metavar="DIR",
                     help="store directory override (default "
                     "WORKDIR/ingest_store)")
    seg.add_argument("--composite", default=None, choices=("medoid",),
                     help="collapse multi-acquisition years of a C2 per-band "
                     "archive to per-pixel QA-masked medoid composites, "
                     "selected on --device (default: one acquisition a year)")
    seg.add_argument("--out-overviews", type=int, default=0,
                     help="overview pyramid levels on output rasters "
                     "(N 2x reductions; default 0 = none)")
    seg.add_argument("--trace", default=None, metavar="LOGDIR",
                     help="capture a torch.profiler host + device trace of "
                     "the run as Chrome trace JSON under LOGDIR")
    seg.add_argument("--telemetry", action="store_true",
                     help="run-wide telemetry: events.jsonl and metrics.prom "
                     "under --workdir")
    seg.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                     help="with --telemetry: serve a live /metrics endpoint "
                     "on PORT (0 = ephemeral)")
    seg.add_argument("--metrics-host", default="", metavar="HOST",
                     help="bind address for --metrics-port (default: all "
                     "interfaces)")
    seg.add_argument("--metrics-interval-s", type=float, default=5.0,
                     metavar="SEC",
                     help="with --telemetry: metrics.prom refresh period")
    seg.add_argument("--flight", action="store_true",
                     help="with --telemetry: flight recorder, dumped to "
                     "WORKDIR/flight.jsonl at run end")
    seg.add_argument("--flight-ring-events", type=int, default=2048, metavar="N",
                     help="flight-ring capacity in events; 0 disables ring "
                     "and sampler")
    seg.add_argument("--sampler-interval-s", type=float, default=5.0,
                     metavar="SEC", help="flight resource-sampler period")
    seg.add_argument("--max-retries", type=int, default=2)
    seg.add_argument("--retry-backoff-s", type=float, default=0.5, metavar="SEC",
                     help="base of the exponential per-tile retry backoff "
                     "(attempt n sleeps ~SEC*2^(n-1), ±50%% jitter, capped "
                     "at 30s); 0 retries immediately")
    seg.add_argument("--quarantine-tiles", action="store_true",
                     help="a tile that exhausts --max-retries is recorded as "
                     "failed and the run continues; exit code 3, no assembly")
    seg.add_argument("--stall-timeout-s", type=float, default=None, metavar="SEC",
                     help="abort (exit 4) after SEC without tile progress "
                     "(default: no watchdog)")
    seg.add_argument("--straggler-k", type=float, default=4.0, metavar="K",
                     help="flag a tile in flight longer than K x the rolling "
                     "median tile duration (observability only)")
    seg.add_argument("--straggler-min-tiles", type=int, default=5, metavar="N",
                     help="no straggler verdicts until N tiles completed")
    seg.add_argument("--fault-schedule", default=None, metavar="SPEC",
                     help="deterministic fault injection for test runs, e.g. "
                     "'seed=7,dispatch@1,fetch.wait@0*2=io'")
    _add_param_flags(seg)

    pix = sub.add_parser("pixel", help="segment one series (single-pixel "
                         "debug/parity path)")
    pix.add_argument("series", nargs="?", default=None,
                     help="JSON file with {years: [...], values: [...], "
                     "mask?: [...]}; '-' reads stdin; values use the index's "
                     "natural sign with --index, or are taken as-is "
                     "(disturbance-positive) without it.  Omit with "
                     "--from-stack.")
    pix.add_argument("--from-stack", default=None, metavar="DIR",
                     help="pull the series from a stack directory: --index at "
                     "pixel (--x, --y) with the standard QA + range masking")
    pix.add_argument("--x", type=int, default=None, help="column (with --from-stack)")
    pix.add_argument("--y", type=int, default=None, help="row (with --from-stack)")
    pix.add_argument("--scale", type=float, default=2.75e-5,
                     help="DN → reflectance scale for --from-stack (C2 default)")
    pix.add_argument("--offset", type=float, default=-0.2,
                     help="DN → reflectance offset for --from-stack (C2 default)")
    pix.add_argument("--engine", choices=("oracle", "torch", "both"), default="both",
                     help="'torch' is this package's float64 segmentation on "
                     "--device (the CUDA kernel on the card)")
    pix.add_argument("--index", default=None, choices=INDEX_NAMES,
                     help="flip sign per this index's disturbance convention; "
                     "with --from-stack it also selects the index (default nbr)")
    _add_param_flags(pix)

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

    inf = sub.add_parser("info", help="inspect rasters header-only: shape, dtype, "
                         "layout, compression, georeferencing, overview pages")
    inf.add_argument("paths", nargs="+", help="GeoTIFF file(s)")
    inf.add_argument("--window", default=None, metavar="Y0,X0,H,W",
                     help="also decode this window and report value stats")
    return p


#: value-carrying fields that flip with the index's disturbance sign — the
#: raster convention of the segment pipeline
_SIGNED_FIELDS = (
    "vertex_src_vals", "vertex_fit_vals", "seg_magnitude", "seg_rate",
    "fitted", "despiked",
)


def _result_to_dict(res, sign: float = 1.0) -> dict:
    """Oracle result / one-pixel SegOutputs → plain-JSON dict, with
    ``sign`` undoing the disturbance-positive flip (natural orientation)."""
    import numpy as np

    out = {}
    for name in (
        "n_vertices", "vertex_indices", "vertex_years", "vertex_src_vals",
        "vertex_fit_vals", "seg_magnitude", "seg_duration", "seg_rate",
        "rmse", "p_of_f", "model_valid", "fitted", "despiked",
    ):
        v = getattr(res, name)
        v = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
        if name in _SIGNED_FIELDS:
            v = sign * v
        out[name] = v.item() if v.ndim == 0 else v.tolist()
    out["model_valid"] = bool(out["model_valid"])
    out["n_vertices"] = int(out["n_vertices"])
    return out


def _pixel_from_stack(args: argparse.Namespace):
    """(years, natural-orientation series, mask, index) for one stack pixel,
    through the index and masking the tile program applies."""
    import numpy as np
    import torch

    from land_trendr_tpu_torch.ops import indices as idx
    from land_trendr_tpu_torch.runtime.stack import load_stack_dir

    if args.x is None or args.y is None:
        raise SystemExit("--from-stack needs --x and --y")
    index = (args.index or "nbr").lower()
    stack = load_stack_dir(args.from_stack, bands=idx.required_bands(index))
    h, w = stack.shape
    if not (0 <= args.y < h and 0 <= args.x < w):
        raise SystemExit(f"pixel ({args.x}, {args.y}) outside raster {w}x{h}")
    dn = {b: torch.from_numpy(np.ascontiguousarray(a[:, args.y, args.x]))
          for b, a in stack.dn_bands.items()}
    sr = {b: idx.scale_sr(v, args.scale, args.offset) for b, v in dn.items()}
    qa = torch.from_numpy(np.ascontiguousarray(stack.qa[:, args.y, args.x]))
    mask = (idx.qa_valid_mask(qa) & idx.sr_valid_mask(sr)).numpy()
    # natural orientation: _run_pixel applies the disturbance flip once
    series = idx.compute_index(index, sr, disturbance_positive=False).numpy()
    return stack.years, series.astype(np.float64), mask, index


def _run_pixel(args: argparse.Namespace) -> int:
    """Single-pixel debug path: one series through oracle and/or segmentation."""
    import numpy as np

    if (args.series is None) == (args.from_stack is None):
        raise SystemExit("pass exactly one of SERIES or --from-stack DIR")
    device = None
    if args.engine in ("torch", "both"):
        from land_trendr_tpu_torch.runtime.driver import resolve_device

        try:
            device = resolve_device(args.device)
        except (ValueError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if args.from_stack:
        years, values, mask, index = _pixel_from_stack(args)
        args.index = index
    else:
        if args.series == "-":
            payload = json.load(sys.stdin)
        else:
            with open(args.series) as f:
                payload = json.load(f)
        years = np.asarray(payload["years"], dtype=np.int32)
        values = np.asarray(payload["values"], dtype=np.float64)
        mask = (
            np.asarray(payload["mask"], dtype=bool)
            if "mask" in payload
            else np.isfinite(values)
        )
    if years.shape != values.shape or years.shape != mask.shape:
        raise SystemExit("years/values/mask must have identical lengths")
    sign = 1.0
    if args.index:
        from land_trendr_tpu_torch.ops.indices import DISTURBANCE_SIGN

        sign = DISTURBANCE_SIGN[args.index.lower()]
        values = sign * values
    params = _params_from_args(args)

    result: dict = {"params": params.to_dict()}
    if args.engine in ("oracle", "both"):
        from land_trendr_tpu_torch.models.oracle import PixelSegmenter

        result["oracle"] = _result_to_dict(
            PixelSegmenter(params).segment(years, values, mask), sign
        )
    if args.engine in ("torch", "both"):
        import torch

        from land_trendr_tpu_torch.ops.segment import SegOutputs
        from land_trendr_tpu_torch.ops.segment_cuda import cuda_segment_pixels

        out = cuda_segment_pixels(
            torch.from_numpy(years).to(device),
            torch.from_numpy(np.ascontiguousarray(values[None, :])).to(device),
            torch.from_numpy(np.ascontiguousarray(mask[None, :])).to(device),
            params,
        )
        result["torch"] = _result_to_dict(SegOutputs(*(f[0] for f in out)), sign)
        result["torch"]["dtype"] = str(out.fitted.dtype).replace("torch.", "")
        result["torch"]["device"] = str(device)
    if args.engine == "both":
        o, k = result["oracle"], result["torch"]
        result["parity"] = {
            "vertex_indices_equal": o["vertex_indices"] == k["vertex_indices"],
            "vertex_years_equal": o["vertex_years"] == k["vertex_years"],
            "model_valid_equal": o["model_valid"] == k["model_valid"],
            "max_abs_fitted_delta": float(
                np.max(np.abs(np.asarray(o["fitted"]) - np.asarray(k["fitted"])))
            ),
            "kernel_dtype": k["dtype"],
        }
    print(json.dumps(result, indent=2))
    return 0


def _run_info(args) -> int:
    """Header-only raster inspection; one JSON document for all paths."""
    import os

    import numpy as np

    from land_trendr_tpu_torch.io.geotiff import read_geotiff_info, read_geotiff_window

    win = None
    if args.window:
        try:
            y0, x0, h, w = (int(v) for v in args.window.split(","))
        except ValueError:
            print(f"--window {args.window!r} is not Y0,X0,H,W", file=sys.stderr)
            return 2
        win = (y0, x0, h, w)

    out = {}
    for path in args.paths:
        geo, info = read_geotiff_info(path)
        rec = {
            "height": info.height,
            "width": info.width,
            "bands": info.bands,
            "dtype": str(info.dtype),
            "layout": "tiled" if info.tiled else "strips",
            "compression": info.compression_name(),
            "bigtiff": info.big,
            # reduced-resolution pages behind the full-resolution one (the
            # one key the JAX package's info does not print)
            "overview_pages": info.overview_pages,
            "file_bytes": os.path.getsize(path),
            "geotransform": geo.geotransform(),
            "nodata": geo.nodata,
        }
        if win is not None:
            a = np.asarray(read_geotiff_window(path, *win), dtype=np.float64)
            finite = a[np.isfinite(a)]
            rec["window"] = {
                "y0_x0_h_w": list(win),
                "min": float(finite.min()) if finite.size else None,
                "max": float(finite.max()) if finite.size else None,
                "mean": float(finite.mean()) if finite.size else None,
                "finite_frac": round(float(finite.size / a.size), 6) if a.size else None,
            }
        out[path] = rec
    print(json.dumps(out, indent=2))
    return 0


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

    if args.cmd == "pixel":
        return _run_pixel(args)

    if args.cmd == "info":
        return _run_info(args)

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
        Run,
        RunConfig,
        StallError,
        TileRetriesExhausted,
        assemble_outputs,
        resolve_device,
    )
    from land_trendr_tpu_torch.runtime.stack import load_stack_dir, open_stack_dir_c2_lazy

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
    if args.lazy and args.composite is not None:
        print("error: --lazy cannot composite (one acquisition per year); "
              "pre-composite or drop --lazy", file=sys.stderr)
        return 2
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
            max_retries=args.max_retries,
            retry_backoff_s=args.retry_backoff_s,
            quarantine_tiles=args.quarantine_tiles,
            stall_timeout_s=args.stall_timeout_s,
            straggler_k=args.straggler_k,
            straggler_min_tiles=args.straggler_min_tiles,
            fault_schedule=args.fault_schedule,
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
            ingest_store_mb=args.ingest_store_mb,
            ingest_store_dir=args.ingest_store_dir,
            scale=args.scale,
            offset=args.offset,
            reject_bits=args.reject_bits,
            out_compress=args.out_compress,
            manifest_compress=args.manifest_compress,
            write_workers=args.write_workers,
            feed_workers=args.feed_workers,
            feed_cache_mb=args.feed_cache_mb,
            decode_workers=args.decode_workers,
            feed_readahead=not args.no_feed_readahead,
            out_overviews=args.out_overviews,
            chunk_px=args.chunk_px,
            telemetry=args.telemetry,
            metrics_port=args.metrics_port,
            metrics_host=args.metrics_host,
            metrics_interval_s=args.metrics_interval_s,
            flight=args.flight,
            flight_ring_events=args.flight_ring_events,
            sampler_interval_s=args.sampler_interval_s,
        )
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if cfg.metrics_port is not None:
        # probe the scrape port now: the real bind happens deep in the run
        import socket

        try:
            with socket.socket() as sk:
                sk.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                sk.bind((cfg.metrics_host, cfg.metrics_port))
        except OSError as e:
            print(f"error: --metrics-port {cfg.metrics_port} unusable: {e}",
                  file=sys.stderr)
            return 2
    bands = required_bands(args.index, ftv)
    try:
        if args.lazy:
            stack = open_stack_dir_c2_lazy(args.stack_dir, bands=bands)
        else:
            stack = load_stack_dir(
                args.stack_dir,
                bands=bands,
                composite=args.composite,
                reject_bits=cfg.reject_bits,
                scale=cfg.scale,
                offset=cfg.offset,
                device=device,
            )
        run = Run(stack, cfg, device=device)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        if args.trace:
            from land_trendr_tpu_torch.utils.profiling import trace

            with trace(args.trace):
                summary = run.execute()
        else:
            summary = run.execute()
    except StallError as e:
        print(f"error: {e}", file=sys.stderr)
        return 4
    except TileRetriesExhausted as e:
        print(f"error: {e} (re-run to resume from the manifest)", file=sys.stderr)
        return 3
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if summary.get("tiles_quarantined"):
        print(json.dumps({"summary": summary, "outputs": None}, indent=2))
        print(
            f"error: {len(summary['tiles_quarantined'])} tile(s) quarantined "
            "after exhausting retries; outputs NOT assembled (re-run to "
            "resume the quarantined tiles)",
            file=sys.stderr,
        )
        return 3
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
