"""The multi-index configuration on the card: NBR segmentation with NDVI
and TCW fitted-trajectory rasters, spot-checked against the oracle.

Counterpart of the JAX package's ``tools/multiindex_bench.sh`` (its
configuration #4, record ``MULTIINDEX_r03.json``).  Three steps, each the
port's own process: ``synth --size N`` (a 40-year stack), ``segment STACK
--ftv ndvi,tcw --tile-size 512`` through :mod:`~land_trendr_tpu_torch.
tools.run_segment_measured` (so its peak RSS is the segment process's
own), then :mod:`~land_trendr_tpu_torch.tools.validate_ftv` with 64
samples over the FTV rasters.  One record merges them with the JAX
record's fields (``scene``, ``tile_size``, ``summary`` with ``stage_s``,
``outputs``, ``peak_rss_mib``, ``ftv_validation``), each step's seconds,
and the command, commit, source digest and card line of
:func:`~land_trendr_tpu_torch.tools.measure.record_meta`.  Exits 1 when
a step fails or the FTV check does not pass, 2 without the device.

Usage::

    python -m land_trendr_tpu_torch.tools.multiindex_bench [--size 1024]
        [--tile-size 512] [--work-root DIR] [--device cuda|cpu]
        [--out MULTIINDEX.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from land_trendr_tpu_torch.tools.measure import child_env, record_meta, write_json_atomic

__all__ = ["FTV", "SAMPLES", "main", "measure"]

#: the FTV indices of the configuration (the JAX script's)
FTV = ("ndvi", "tcw")
#: years of the stack ``synth`` writes (its default 1984-2023)
YEARS = 40
#: pixels ``validate_ftv`` re-derives from the DNs (the JAX script's)
SAMPLES = 64


def _step(argv: "list[str]", timeout: float) -> float:
    """``python -m argv`` in the port's environment; its wall seconds."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", *argv], capture_output=True, text=True,
                       timeout=timeout, env=child_env())
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(argv[:2])} exited {r.returncode}: {r.stderr[-2000:]}")
    return wall


def measure(size: int, tile_size: int, work: str, device: str,
            timeout: float = 3600.0) -> dict:
    """The three steps in ``work``; the merged record without its meta."""
    stack, out_dir = os.path.join(work, "stack"), os.path.join(work, "out")
    seg_rec = os.path.join(work, "segment.json")
    val_rec = os.path.join(work, "ftv_validation.json")
    dev = ["--device", device]
    synth_s = _step(["land_trendr_tpu_torch", *dev, "synth", stack, "--size", str(size)],
                       timeout)
    segment_s = _step(
        ["land_trendr_tpu_torch.tools.run_segment_measured", "--out", seg_rec, *dev, "segment",
         stack, "--ftv", ",".join(FTV), "--tile-size", str(tile_size),
         "--workdir", os.path.join(work, "work"), "--out-dir", out_dir], timeout)
    validate_s = _step(
        ["land_trendr_tpu_torch.tools.validate_ftv", stack, out_dir, "--indices", ",".join(FTV),
         f"--samples={SAMPLES}", f"--out={val_rec}", *dev], timeout)
    with open(seg_rec) as f:
        seg = json.load(f)
    with open(val_rec) as f:
        ftv_validation = json.load(f)
    summary = seg["summary"]
    worst = {k: v["max_abs_delta"] for k, v in ftv_validation["indices"].items()}
    return {
        "description": (f"Multi-index run: {size}x{size}x{YEARS}yr DN stack, NBR segmentation + "
                        f"{'/'.join(i.upper() for i in FTV)} FTV rasters, tile {tile_size}."),
        "platform": "gpu" if device == "cuda" else device,
        "nproc": os.cpu_count(),
        "scene": {"width": size, "height": size, "years": YEARS},
        "tile_size": tile_size,
        "summary": summary,
        "outputs": seg["outputs"],
        "peak_rss_mib": seg["peak_rss_mib"],
        "ftv_validation": ftv_validation,
        "step_s": {"synth": round(synth_s, 3), "segment": round(segment_s, 3),
                   "validate": round(validate_s, 3)},
        "notes": (f"FTV rasters spot-checked against oracle.fit_to_vertices re-derived from the "
                  f"input DNs on {SAMPLES} random pixels: max abs delta "
                  + " / ".join(f"{d:.1e} ({k})" for k, d in worst.items())
                  + f", tolerance {ftv_validation['indices'][FTV[0]]['tolerance']} "
                  "(tools/validate_ftv.py)."),
    }


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--tile-size", type=int, default=512)
    ap.add_argument("--work-root", default=None,
                    help="where the stack and the run go (default: a temporary directory)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    ap.add_argument("--out", default="MULTIINDEX.json")
    args = ap.parse_args(argv)
    from land_trendr_tpu_torch.runtime.driver import resolve_device

    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.work_root is not None:
        os.makedirs(args.work_root, exist_ok=True)
    work = tempfile.mkdtemp(prefix="lt_multiindex_", dir=args.work_root)
    try:
        rec = measure(args.size, args.tile_size, work, dev.type)
    except (RuntimeError, subprocess.TimeoutExpired) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(work, ignore_errors=True)
    rec.update(record_meta("land_trendr_tpu_torch.tools.multiindex_bench", argv, dev.type))
    write_json_atomic(args.out, rec, indent=1)
    print(json.dumps(rec))
    return 0 if rec["ftv_validation"]["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
