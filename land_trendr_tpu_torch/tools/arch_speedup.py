"""Architecture speedup: reference-style per-pixel scalar segmentation
against the batched plain version on the same host CPU and the CUDA
kernel on the card.

Counterpart of the JAX package's ``tools/arch_speedup.py``.  The
reference runs LandTrendr as scalar per-pixel Python under Hadoop
streaming, one map task per pixel; the port's ``models/oracle.py`` is
that execution style minus Hadoop, so its rate is an upper bound on the
reference's.  Three rates over one population (the port's copy of
``bench.make_series``, 40 years, default ``LTParams``):

    oracle_px_s       per-pixel scalar float64 oracle, host CPU
    kernel_cpu_px_s   batched float32 plain PyTorch version
                      (``torch_segment_pixels``) on the same host CPU,
                      best of ``--reps`` after one warm-up
    card              the fused CUDA kernel (``cuda_segment_pixels``) on
                      device-resident float32 series, CUDA events over
                      ``--reps`` launches after one warm-up, at each of
                      ``--card-px`` (absent with ``--device cpu``)

``speedup_same_host`` is the plain version's rate over the oracle's;
``speedup_card_vs_oracle`` the kernel's rate at the largest ``--card-px``
over the oracle's (the card against the host that feeds it).

Usage::

    python -m land_trendr_tpu_torch.tools.arch_speedup [oracle_px] [kernel_px]
        [out.json] [--card-px 65536,262144] [--reps 3] [--device cuda|cpu]
        [--out ARCH_SPEEDUP.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.models.oracle import segment_series
from land_trendr_tpu_torch.ops.segment import torch_segment_pixels
from land_trendr_tpu_torch.runtime.driver import resolve_device
from land_trendr_tpu_torch.tools.measure import record_meta, write_json_atomic
from land_trendr_tpu_torch.tools.population import make_series

__all__ = ["main", "time_card", "time_oracle", "time_plain_cpu"]

NY = 40


def time_oracle(px: int, ny: int = NY) -> "tuple[float, float]":
    """(seconds, fit rate) of ``px`` pixels through the scalar oracle."""
    params = LTParams()
    years, vals, mask = make_series(px, ny)
    years64 = years.astype(np.float64)
    segment_series(years64, vals[0], mask[0], params)  # first-call setup untimed
    n_fit = 0
    t0 = time.perf_counter()
    for i in range(px):
        n_fit += bool(segment_series(years64, vals[i], mask[i], params).model_valid)
    return time.perf_counter() - t0, n_fit / px


def time_plain_cpu(px: int, ny: int = NY, reps: int = 3) -> "tuple[float, float]":
    """(best seconds, fit rate) of the batched float32 plain version on the
    host CPU, after one untimed warm-up call."""
    params = LTParams()
    years, vals, mask = (torch.from_numpy(a) for a in make_series(px, ny))
    out = torch_segment_pixels(years, vals, mask, params)
    fit_rate = float(out.model_valid.float().mean())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        torch_segment_pixels(years, vals, mask, params)
        best = min(best, time.perf_counter() - t0)
    return best, fit_rate


def time_card(px: int, dev: torch.device, ny: int = NY, reps: int = 3) -> dict:
    """The fused kernel on device-resident float32 series: mean ms of
    ``reps`` wrapper calls by CUDA events after one warm-up, its rate,
    fit rate and the launches those calls made."""
    from land_trendr_tpu_torch.ops import segment_cuda

    params = LTParams()
    years, vals, mask = (torch.from_numpy(a).to(dev) for a in make_series(px, ny))
    before = segment_cuda.LAUNCHES
    out = segment_cuda.cuda_segment_pixels(years, vals, mask, params)
    torch.cuda.synchronize(dev)
    fit_rate = float(out.model_valid.float().mean())
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        segment_cuda.cuda_segment_pixels(years, vals, mask, params)
    t1.record()
    torch.cuda.synchronize(dev)
    ms = t0.elapsed_time(t1) / reps
    return {"px": px, "ms": round(ms, 4), "px_s": round(px / ms * 1e3, 1),
            "fit_rate": round(fit_rate, 4), "launches": segment_cuda.LAUNCHES - before}


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("oracle_px", nargs="?", type=int, default=1024)
    ap.add_argument("kernel_px", nargs="?", type=int, default=65536,
                    help="pixels of the plain version on the host CPU")
    ap.add_argument("out_path", nargs="?", default=None, help="the record (as --out)")
    ap.add_argument("--card-px", default="65536,262144",
                    help="comma-separated pixel counts of the kernel on the card")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    ap.add_argument("--out", default=None, help="the record (default ARCH_SPEEDUP.json)")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    out_path = args.out or args.out_path or "ARCH_SPEEDUP.json"

    oracle_s, oracle_fit = time_oracle(args.oracle_px)
    oracle_px_s = args.oracle_px / oracle_s
    plain_s, plain_fit = time_plain_cpu(args.kernel_px, reps=args.reps)
    plain_px_s = args.kernel_px / plain_s
    rec = {
        "metric": "architecture_speedup_same_host",
        "oracle_px": args.oracle_px,
        "oracle_px_s": round(oracle_px_s, 1),
        "oracle_fit_rate": round(oracle_fit, 4),
        "kernel_px": args.kernel_px,
        "kernel_cpu_px_s": round(plain_px_s, 1),
        "kernel_fit_rate": round(plain_fit, 4),
        "speedup_same_host": round(plain_px_s / oracle_px_s, 1),
        "years": NY,
        "nproc": os.cpu_count(),
        "torch_threads": torch.get_num_threads(),
        "note": (
            "oracle = reference-style per-pixel scalar f64 Python (models/oracle.py: the "
            "reference's PixelSegmenter execution model minus Hadoop's spawn/serialize/"
            "shuffle, so an UPPER bound on the reference's rate); kernel_cpu = the batched "
            "f32 plain PyTorch version on the SAME host CPU (best of reps); card = the fused "
            "CUDA kernel on device-resident series (CUDA events, mean of reps after a "
            "warm-up). Populations identical (the port's copy of bench.make_series)."
        ),
    }
    if dev.type == "cuda":
        card = [time_card(int(px), dev, reps=args.reps) for px in args.card_px.split(",") if px]
        rec["card"] = card
        rec["speedup_card_vs_oracle"] = round(card[-1]["px_s"] / oracle_px_s, 1)
    rec.update(record_meta("land_trendr_tpu_torch.tools.arch_speedup", argv, dev.type))
    write_json_atomic(out_path, rec)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
