"""Spot-validate a finished run's FTV rasters against the float64 oracle.

Counterpart of the JAX package's ``tools/validate_ftv.py``.  A
multi-index run writes NBR segmentation plus NDVI/TCW fitted-trajectory
(FTV) rasters; this tool re-derives sampled pixels' FTV series from the
input DNs — DN → reflectance (:func:`~land_trendr_tpu_torch.ops.indices.
scale_sr`) → index series + QA/range mask (the port's own
``ops/indices``, on ``--device``) → :func:`~land_trendr_tpu_torch.models.
oracle.fit_to_vertices` in float64 through the run's own vertex rasters —
and compares them with what the run wrote.

The run computes FTV in float32 on the card and the oracle is float64, so
agreement is expected at float32 precision, not bitwise: the tolerance is
the JAX tool's, 1e-3 absolute on each sampled pixel's worst year.

Usage::

    python -m land_trendr_tpu_torch.tools.validate_ftv STACK_DIR OUT_DIR
        [--indices ndvi,tcw] [--samples 64] [--out FTV_VALIDATION.json]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.io.geotiff import read_geotiff
from land_trendr_tpu_torch.models.oracle import fit_to_vertices
from land_trendr_tpu_torch.ops import indices as idx
from land_trendr_tpu_torch.runtime.driver import resolve_device
from land_trendr_tpu_torch.tools.measure import write_json_atomic

__all__ = ["TOLERANCE", "main", "validate"]

#: max |FTV - oracle| on a sampled pixel's worst year (the JAX tool's)
TOLERANCE = 1e-3


def validate(stack, out_dir: str, indices=("ndvi", "tcw"), n_samples: int = 64,
             params: "LTParams | None" = None, device: "torch.device | str" = "cpu",
             index: str = "nbr", seed: int = 7) -> dict:
    """Compare ``n_samples`` pixels of ``out_dir``'s ``ftv_<index>.tif``
    rasters with the oracle re-derivation from ``stack``'s DNs; the report
    (per index: max / p99 / median |delta|, tolerance, pass)."""
    params = params or LTParams()
    h, w = stack.shape
    ny = stack.n_years
    years = np.asarray(stack.years, dtype=np.float64)
    vi_r, _, _ = read_geotiff(os.path.join(out_dir, "vertex_indices.tif"))
    nv_r, _, _ = read_geotiff(os.path.join(out_dir, "n_vertices.tif"))
    ftv_r = {}
    for name in indices:
        ftv_r[name], _, _ = read_geotiff(os.path.join(out_dir, f"ftv_{name}.tif"))
        assert ftv_r[name].shape == (ny, h, w), ftv_r[name].shape
    rng = np.random.default_rng(seed)
    ys = rng.integers(0, h, size=n_samples)
    xs = rng.integers(0, w, size=n_samples)
    # the mask the run used ANDs QA with range validity over the bands the
    # RUN loaded (the primary index + every FTV index)
    run_bands = idx.required_bands(index, tuple(indices))

    def column(cube, y, x) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(cube[:, y, x]), device=device)

    report: dict = {"out_dir": out_dir, "n_samples": n_samples, "device": str(device),
                    "indices": {}}
    ok = True
    for name in indices:
        sign = idx.DISTURBANCE_SIGN[name]
        deltas = []
        for y, x in zip(ys, xs):
            sr_all = {b: idx.scale_sr(column(stack.dn_bands[b], y, x)) for b in run_bands}
            mask = idx.qa_valid_mask(column(stack.qa, y, x)) & idx.sr_valid_mask(sr_all)
            # compute_index already applies the disturbance-positive flip
            series = idx.compute_index(name, {b: sr_all[b] for b in idx.required_bands(name)})
            vi = vi_r[:, y, x].astype(np.int64)
            nv = int(nv_r[y, x])
            ref = fit_to_vertices(years, series.cpu().numpy().astype(np.float64),
                                  mask.cpu().numpy(), vi, nv, params)
            got = sign * ftv_r[name][:, y, x].astype(np.float64)
            deltas.append(np.abs(got - ref).max())
        deltas = np.asarray(deltas)
        rec = {
            "max_abs_delta": float(deltas.max()),
            "p99_abs_delta": float(np.percentile(deltas, 99)),
            "median_abs_delta": float(np.median(deltas)),
            "tolerance": TOLERANCE,
            "pass": bool((deltas <= TOLERANCE).all()),
        }
        ok &= rec["pass"]
        report["indices"][name] = rec
    report["pass"] = bool(ok)
    return report


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("stack_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--indices", default="ndvi,tcw")
    ap.add_argument("--samples", type=int, default=64)
    ap.add_argument("--out", default="FTV_VALIDATION.json")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    from land_trendr_tpu_torch.runtime import load_stack_dir

    indices = tuple(args.indices.split(","))
    stack = load_stack_dir(args.stack_dir,
                           bands=idx.required_bands("nbr", indices), device="cpu")
    report = validate(stack, args.out_dir, indices, args.samples, device=device)
    report["stack_dir"] = args.stack_dir
    for name, rec in report["indices"].items():
        print(f"ftv_{name}: max|delta|={rec['max_abs_delta']:.2e} "
              f"p99={rec['p99_abs_delta']:.2e} pass={rec['pass']}", file=sys.stderr)
    write_json_atomic(args.out, report)
    print(json.dumps(report))
    return 0 if report["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
