"""Joint parameter-space parity on the card: random LTParams x random series.

Counterpart of the JAX package's ``tools/parity_paramspace.py``, with the
same draw: trial ``k`` seeds ``default_rng(seed_base + k)``, picks NY from
{16, 24, 40}, draws a random JOINT parameter combination
(:func:`sample_params`: segments, despike, overshoot, recovery
constraints, selection thresholds, min-obs) and a fresh mixed-regime
pixel batch (:func:`make_batch`), so a seed gives the same ``LTParams``
and the same pixels in both packages.  Each trial runs three checks:

* **(a) oracle** — the float64 kernel against the port's float64 oracle
  (:func:`~land_trendr_tpu_torch.models.oracle.segment_series`):
  ``vertex_indices``, ``n_vertices`` and ``model_valid`` exact on every
  pixel (the north-star vertex-for-vertex contract);
* **(b) forms** — the same batch through every kernel instantiation that
  admits it (narrow, wide and global, forced with ``_Launch(cap=...)``),
  each bit for bit equal to the narrow result on every output, in float32
  and in float64;
* **(c) plain** — the float32 kernel bit for bit equal to the plain
  PyTorch version in float32.

The record holds every mismatch's repro (trial seed + params), the
sampled space, the kernels' launches by form and the card's name and
power limit.  With ``--device cpu`` (the tests) check (a) runs the plain
version and (b)/(c) are reported ``"n/a (no kernel on the CPU)"``.  The
oracle runs in ``--workers`` processes (it is the slow leg: ~9 ms a pixel
on one CPU core).

Usage::

    python -m land_trendr_tpu_torch.tools.parity_paramspace [trials] [out.json]
        [--seed-base 1000,2000] [--workers 8] [--device cuda|cpu]

(default 128 trials per seed base, base 1000, into ``PARITY_PARAMS_cuda.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops import segment_cuda
from land_trendr_tpu_torch.ops.segment import SegOutputs, torch_segment_pixels
from land_trendr_tpu_torch.runtime.driver import resolve_device
from land_trendr_tpu_torch.tools.measure import record_meta, write_json_atomic
from land_trendr_tpu_torch.tools.population import make_population

__all__ = ["PX", "SAMPLED_SPACE", "draw_trial", "make_batch", "main", "measure",
           "oracle_decisions", "sample_params"]

#: pixels a trial (the JAX tool's 64)
PX = 64
#: what the draw spans (the JAX record's ``sampled_space``)
SAMPLED_SPACE = {
    "max_segments": "1..6",
    "vertex_count_overshoot": "0..4 (capped by ny)",
    "spike_threshold": "[0.3, 1.0]",
    "recovery_threshold": "{0.1, 0.25, 1.0, 10.0}",
    "prevent_one_year_recovery": "{False, True}",
    "p_val_threshold": "{0.01, 0.05, 0.15, 1.0}",
    "best_model_proportion": "[0.3, 1.0]",
    "min_observations_needed": "3..10",
    "n_years": "{16, 24, 40}",
}
_NA = "n/a (no kernel on the CPU)"


def sample_params(rng: np.random.Generator, ny: int) -> LTParams:
    """A random valid LTParams whose candidate capacity fits the series
    (the JAX tool's draw, in its order)."""
    max_segments = int(rng.integers(1, 7))
    # keep candidate capacity comfortably under the year count
    max_overshoot = max(0, min(4, ny - (max_segments + 1) - 4))
    return LTParams(
        max_segments=max_segments,
        vertex_count_overshoot=int(rng.integers(0, max_overshoot + 1)),
        spike_threshold=float(rng.uniform(0.3, 1.0)),
        recovery_threshold=float(rng.choice([0.1, 0.25, 1.0, 10.0])),
        prevent_one_year_recovery=bool(rng.integers(0, 2)),
        p_val_threshold=float(rng.choice([0.01, 0.05, 0.15, 1.0])),
        best_model_proportion=float(rng.uniform(0.3, 1.0)),
        min_observations_needed=int(rng.integers(3, 11)),
    )


def make_batch(rng: np.random.Generator, px: int, ny: int):
    """Mixed-regime float64 series with the JAX tool's wider knobs:
    closer-to-edge disturbance years, smaller minimum magnitudes,
    elementwise spikes and a per-trial random masking rate."""
    return make_population(
        rng, px, ny,
        base_lo=0.4, base_hi=0.8, noise=0.01,
        d_margin_lo=2, d_margin_hi=2,
        mag_lo=0.05, rec_hi=0.2,
        spike="elementwise",
        mask_drop=float(rng.uniform(0.02, 0.35)),
    )


def draw_trial(seed: int, px: int = PX):
    """Trial ``seed``'s ``(ny, params, years, values, mask)``."""
    rng = np.random.default_rng(seed)
    ny = int(rng.choice([16, 24, 40]))
    params = sample_params(rng, ny)
    years, vals, mask = make_batch(rng, px, ny)
    return ny, params, years, vals, mask


def oracle_decisions(seed: int, px: int = PX):
    """The float64 oracle's ``(vertex_indices, n_vertices, model_valid)``
    for trial ``seed`` (pixel-major; ``vertex_indices`` padded with -1)."""
    from land_trendr_tpu_torch.models.oracle import PixelSegmenter

    _ny, params, years, vals, mask = draw_trial(seed, px)
    seg = PixelSegmenter(params)
    nvmax = params.max_vertices
    vi = np.full((px, nvmax), -1, np.int64)
    nv = np.zeros(px, np.int64)
    mv = np.zeros(px, bool)
    for i in range(px):
        ref = seg.segment(years, vals[i], mask[i])
        r = np.asarray(ref.vertex_indices)
        vi[i, : r.size] = r
        nv[i] = int(ref.n_vertices)
        mv[i] = bool(ref.model_valid)
    return vi, nv, mv


def _bits(a: torch.Tensor) -> torch.Tensor:
    """A tensor's raw bits (floats as same-width ints: NaNs compare by bit)."""
    if a.dtype == torch.float32:
        return a.contiguous().view(torch.int32)
    if a.dtype == torch.float64:
        return a.contiguous().view(torch.int64)
    return a


def _bit_identical(a: SegOutputs, b: SegOutputs) -> "list[str]":
    """Fields of two outputs that differ in any bit."""
    return [f for f in SegOutputs._fields
            if not torch.equal(_bits(getattr(a, f)), _bits(getattr(b, f)))]


def _form(years, vals, mask, params: LTParams, cap: str) -> SegOutputs:
    """One launch of instantiation ``cap`` (the tests' and the smoke's forcing)."""
    with torch.cuda.device(vals.device):
        job = segment_cuda._Launch(years, vals, mask, params, cap=cap)
        job.run(0, vals.shape[0])
        return job.result()


def measure(trials: int, device: torch.device, seed_bases=(1000,), px: int = PX,
            workers: int = 1, verbose: bool = True) -> dict:
    """The parity record over ``trials`` trials per seed base (module doc)."""
    cuda = device.type == "cuda"
    seeds = [b + k for b in seed_bases for k in range(trials)]
    t0 = time.time()
    if workers > 1:
        import multiprocessing as mp

        with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as ex:
            oracle = list(ex.map(oracle_decisions, seeds, [px] * len(seeds)))
    else:
        oracle = [oracle_decisions(s, px) for s in seeds]
    oracle_s = time.time() - t0
    launches0 = segment_cuda.launch_counts()
    mismatches: "list[dict]" = []
    counts = {"oracle_exact": 0, "forms_identical": 0, "plain_identical": 0}
    forms_run = {"narrow": 0, "wide": 0, "global": 0}
    per_base = {b: {"trials": 0, "pixels": 0, "exact": 0} for b in seed_bases}
    t1 = time.time()
    for n, (seed, (o_vi, o_nv, o_mv)) in enumerate(zip(seeds, oracle)):
        base = seed_bases[n // trials]
        ny, params, years, vals, mask = draw_trial(seed, px)
        y = torch.as_tensor(years, device=device)
        m = torch.as_tensor(mask, device=device).contiguous()
        v64 = torch.as_tensor(vals, device=device).contiguous()
        v32 = torch.as_tensor(vals.astype(np.float32), device=device).contiguous()
        out64 = segment_cuda.cuda_segment_pixels(y, v64, m, params)
        # both (px, max_vertices), -1-padded
        vi = out64.vertex_indices.cpu().numpy().astype(np.int64)
        ok = ((vi == o_vi).all(axis=1)
              & (out64.n_vertices.cpu().numpy() == o_nv)
              & (out64.model_valid.cpu().numpy() == o_mv))
        exact = int(ok.sum())
        counts["oracle_exact"] += exact
        per_base[base]["trials"] += 1
        per_base[base]["pixels"] += px
        per_base[base]["exact"] += exact
        repro = {"trial": n % trials, "seed": seed, "ny": ny, "params": params.to_dict()}
        if exact != px and len(mismatches) < 20:
            mismatches.append({**repro, "check": "oracle",
                               "pixels": np.flatnonzero(~ok)[:16].tolist()})
        if cuda:
            diff = []
            for dtype_name, vv in (("float32", v32), ("float64", v64)):
                ref = _form(y, vv, m, params, "narrow")
                forms_run["narrow"] += 1
                for cap in ("wide", "global"):
                    if segment_cuda._holds(cap, ny, params):
                        forms_run[cap] += 1
                        bad = _bit_identical(_form(y, vv, m, params, cap), ref)
                        if bad:
                            diff.append({"form": cap, "dtype": dtype_name, "fields": bad})
            counts["forms_identical"] += not diff
            if diff and len(mismatches) < 20:
                mismatches.append({**repro, "check": "forms", "differ": diff})
            bad = _bit_identical(segment_cuda.cuda_segment_pixels(y, v32, m, params),
                                 torch_segment_pixels(y, v32, m, params))
            counts["plain_identical"] += not bad
            if bad and len(mismatches) < 20:
                mismatches.append({**repro, "check": "plain", "fields": bad})
        if verbose and (n + 1) % 16 == 0:
            print(f"  {n + 1}/{len(seeds)} trials, {counts['oracle_exact']}/{(n + 1) * px} "
                  f"px exact ({time.time() - t0:.0f}s)", file=sys.stderr, flush=True)
    if cuda:
        torch.cuda.synchronize(device)
    launches1 = segment_cuda.launch_counts()
    total = len(seeds) * px
    n_trials = len(seeds)
    return {
        "description": (
            "Joint parameter-space parity on the card: random LTParams x mixed-regime "
            "series (the JAX tool's draw); (a) float64 kernel vs the port's float64 "
            "oracle, exact vertex_indices/n_vertices/model_valid per pixel; (b) every "
            "admitting instantiation bit-identical to narrow in f32 and f64; (c) the "
            "f32 kernel bit-identical to the plain version."
        ),
        "device": device.type,
        "device_name": torch.cuda.get_device_name(device) if cuda else "cpu",
        "trials": n_trials,
        "trials_per_seed_base": trials,
        "seed_bases": list(seed_bases),
        "pixels_per_trial": px,
        "pixels_total": total,
        "exact": counts["oracle_exact"],
        "exact_rate": counts["oracle_exact"] / total if total else None,
        "per_seed_base": {str(b): r for b, r in per_base.items()},
        "forms_bit_identical_trials": counts["forms_identical"] if cuda else _NA,
        "plain_bit_identical_trials": counts["plain_identical"] if cuda else _NA,
        "forms_run": forms_run if cuda else _NA,
        "sampled_space": SAMPLED_SPACE,
        "mismatches": mismatches,
        "launches": {k: launches1[k] - launches0[k] for k in launches1},
        "oracle_workers": workers,
        "oracle_s": round(oracle_s, 1),
        "kernel_s": round(time.time() - t1, 1),
        "elapsed_s": round(time.time() - t0, 1),
        "ok": (counts["oracle_exact"] == total and (not cuda or (
            counts["forms_identical"] == n_trials and counts["plain_identical"] == n_trials))),
    }


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trials", nargs="?", type=int, default=128, help="trials per seed base")
    ap.add_argument("out", nargs="?", default="PARITY_PARAMS_cuda.json")
    ap.add_argument("--seed-base", default="1000",
                    help="comma-separated seed bases (the JAX records: 1000 and 2000)")
    ap.add_argument("--workers", type=int, default=min(8, os.cpu_count() or 1),
                    help="oracle processes")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    bases = tuple(int(b) for b in args.seed_base.split(","))
    rec = measure(args.trials, device, bases, workers=args.workers)
    rec.update(record_meta("land_trendr_tpu_torch.tools.parity_paramspace", argv, device.type))
    write_json_atomic(args.out, rec)
    print(json.dumps({k: rec[k] for k in ("pixels_total", "exact", "exact_rate",
                                          "forms_bit_identical_trials",
                                          "plain_bit_identical_trials", "elapsed_s", "ok")}))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
