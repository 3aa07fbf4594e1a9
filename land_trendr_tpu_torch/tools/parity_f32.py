"""Measure float32 vertex parity against float64 at scale, on the card.

Counterpart of the JAX package's ``tools/parity_f32.py``: the same
population (``tools/population.py`` with seeds 0, 1, 2, ... per chunk of
65,536 pixels, so the pixels are those behind ``PARITY_f32.json``), the
same taxonomy of float32 decisions against float64 ones:

* ``valid_flip``  — ``model_valid`` differs (a p-value crossed the threshold);
* ``count_diff``  — both valid, different number of vertices;
* ``placement``   — same count, at least one vertex index differs;
* ``exact``       — identical ``vertex_indices`` + ``n_vertices`` + ``model_valid``;

and the same ``rmse_abs_delta_max`` and ``fitted_abs_delta_p99_max``.

The float32 leg is :func:`~land_trendr_tpu_torch.ops.segment_cuda.
cuda_segment_pixels` on the card; the float64 leg is the kernel's float64
instantiation on the same card (the H100 has native float64).
``--f64-on-cpu`` runs the float64 leg through the plain PyTorch version
on the CPU instead; ``platform`` records which.  With ``--device cpu``
both legs run the plain version on the CPU (how the tests run it).  The
report carries the kernels' launch counts of the run.

Usage::

    python -m land_trendr_tpu_torch.tools.parity_f32 [n_pixels] [out.json]
        [--device cuda|cpu] [--f64-on-cpu]

(default 1,048,576 pixels into ``PARITY_f32_cuda.json``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops import segment_cuda
from land_trendr_tpu_torch.ops.segment import SegOutputs
from land_trendr_tpu_torch.runtime.driver import resolve_device
from land_trendr_tpu_torch.tools.measure import write_json_atomic
from land_trendr_tpu_torch.tools.population import make_population as _shared

__all__ = ["NY", "CHUNK", "make_population", "segment_leg", "measure", "main"]

NY = 40
#: pixels per population seed: the JAX tool's chunk, which fixes its pixels
CHUNK = 65_536


def make_population(px: int, ny: int, seed: int) -> "tuple[np.ndarray, np.ndarray, np.ndarray]":
    """The JAX tool's ``make_population``: the shared generator's defaults
    from ``default_rng(seed)`` (years, disturbance-positive float64
    series, validity mask)."""
    return _shared(np.random.default_rng(seed), px, ny)


def segment_leg(years, vals, mask, params: LTParams, device: torch.device,
                dtype: torch.dtype) -> SegOutputs:
    """One leg on ``device`` in ``dtype``: the kernel on a CUDA device,
    the plain version on the CPU; outputs copied back to the host."""
    out = segment_cuda.cuda_segment_pixels(
        torch.as_tensor(years, device=device),
        torch.as_tensor(vals, dtype=dtype, device=device).contiguous(),
        torch.as_tensor(mask, device=device).contiguous(),
        params,
    )
    return SegOutputs(*(f.cpu() for f in out))


def measure(px_total: int, device: torch.device, f64_on_cpu: bool = False,
            chunk: int = CHUNK, params: "LTParams | None" = None,
            verbose: bool = True) -> dict:
    """The parity record over ``px_total`` pixels (see the module doc)."""
    params = params or LTParams()
    dev64 = torch.device("cpu") if f64_on_cpu else device
    label = f"f32:{device.type}/f64:cpu" if f64_on_cpu and device.type != "cpu" else device.type
    counts = {"exact": 0, "valid_flip": 0, "count_diff": 0, "placement": 0}
    rmse_delta_max = 0.0
    fitted_delta_p99: "list[float]" = []
    launches0 = segment_cuda.launch_counts()
    t0 = time.time()
    done = 0
    seed = 0
    while done < px_total:
        n = min(chunk, px_total - done)
        years, vals, mask = make_population(n, NY, seed)
        seed += 1
        out64 = segment_leg(years, vals, mask, params, dev64, torch.float64)
        out32 = segment_leg(years, vals, mask, params, device, torch.float32)

        vi64, vi32 = out64.vertex_indices.numpy(), out32.vertex_indices.numpy()
        mv64, mv32 = out64.model_valid.numpy(), out32.model_valid.numpy()
        nv64, nv32 = out64.n_vertices.numpy(), out32.n_vertices.numpy()
        flip = mv64 != mv32
        cdiff = ~flip & (nv64 != nv32)
        same_shape = ~flip & ~cdiff
        placement = same_shape & (vi64 != vi32).any(axis=1)
        exact = same_shape & ~placement
        counts["valid_flip"] += int(flip.sum())
        counts["count_diff"] += int(cdiff.sum())
        counts["placement"] += int(placement.sum())
        counts["exact"] += int(exact.sum())

        r64 = out64.rmse.numpy()
        r32 = out32.rmse.numpy().astype(np.float64)
        rmse_delta_max = max(rmse_delta_max, float(np.abs(r64 - r32).max()))
        f_delta = np.abs(out64.fitted.numpy() - out32.fitted.numpy().astype(np.float64))
        fitted_delta_p99.append(float(np.percentile(f_delta, 99)))
        done += n
        if verbose:
            print(f"  {done}/{px_total} px  exact so far: {counts['exact'] / done:.4%}  "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)

    total = sum(counts.values())
    assert total == px_total
    launches1 = segment_cuda.launch_counts()
    return {
        "n_pixels": px_total,
        "n_years": NY,
        "platform": label,
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "impl": "cuda" if device.type == "cuda" else "torch",
        "chunk": chunk,
        "exact_vertex_agreement": counts["exact"] / total,
        "taxonomy": {k: {"count": v, "rate": v / total} for k, v in counts.items()},
        "rmse_abs_delta_max": rmse_delta_max,
        "fitted_abs_delta_p99_max": max(fitted_delta_p99),
        "launches": {k: launches1[k] - launches0[k] for k in launches1},
        "elapsed_s": round(time.time() - t0, 1),
    }


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_pixels", nargs="?", type=int, default=1_048_576)
    ap.add_argument("out", nargs="?", default="PARITY_f32_cuda.json")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: both legs on the card) or cpu (tests)")
    ap.add_argument("--f64-on-cpu", action="store_true",
                    help="run the float64 leg through the plain version on the CPU")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    record = measure(args.n_pixels, device, f64_on_cpu=args.f64_on_cpu)
    write_json_atomic(args.out, record)
    print(json.dumps(record, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
