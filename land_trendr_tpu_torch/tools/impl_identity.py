"""Kernel-against-plain-version identity at scale, on the card.

Counterpart of the JAX package's ``tools/impl_identity.py``: both float32
implementations run over the parity-suite population (``tools/
population.py`` with seeds 0-15, ``px / 16`` pixels each) on the same
card, and the per-pixel decision overlap is measured directly.  Here the
two legs are the CUDA kernel (:func:`~land_trendr_tpu_torch.ops.
segment_cuda.cuda_segment_pixels_chunked`) and the plain PyTorch version
(:func:`~land_trendr_tpu_torch.ops.segment.torch_segment_pixels_chunked`),
both on the card.  Decisions and trajectories are compared bitwise;
``p_of_f`` is reported both as the JAX tool's relative delta and as a
bitwise count (the port's pair has been measured bit-identical).

``--ny`` and ``--params`` hold the wide form (NY = 72) and the global
form (NY = 160, or more than 32 candidates) at scale as well.  With
``--device cpu`` both legs are the plain version (a check of the tool).
The report carries the kernels' launch counts of the run.

Usage::

    python -m land_trendr_tpu_torch.tools.impl_identity [--px 1048576]
        [--chunk 262144] [--ny 40] [--params '{"max_segments": 14}']
        [--device cuda|cpu] [--out IMPL_IDENTITY.json]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops import segment_cuda
from land_trendr_tpu_torch.ops.segment import torch_segment_pixels_chunked
from land_trendr_tpu_torch.runtime.driver import resolve_device
from land_trendr_tpu_torch.tools.measure import write_json_atomic
from land_trendr_tpu_torch.tools.population import make_population

__all__ = ["N_SEEDS", "identity", "main"]

#: seeded sub-populations (the JAX tool's 16)
N_SEEDS = 16

_FLOATS = ("vertex_years", "vertex_src_vals", "vertex_fit_vals", "seg_magnitude",
           "seg_duration", "seg_rate", "rmse", "fitted", "despiked")


def _bits(a: torch.Tensor) -> np.ndarray:
    """Raw bits of a float tensor (NaNs compare by their bits)."""
    a = a.cpu().contiguous()
    return a.view(torch.int32 if a.dtype == torch.float32 else torch.int64).numpy()


def identity(px: int, device: torch.device, chunk: int = 262_144, ny: int = 40,
             params: "LTParams | None" = None, verbose: bool = True) -> dict:
    """Run both legs over ``px`` pixels and return the identity record."""
    params = params or LTParams()
    per = px // N_SEEDS
    chunk = min(chunk, per)
    stats = {
        "pixel_exact_vertex_indices": 0,
        "model_valid_equal": 0,
        "n_vertices_equal": 0,
        "fitted_abs_delta_max": 0.0,
        "p_of_f_rel_delta_max": 0.0,
        "p_of_f_bitwise_equal": 0,
        "float_fields_bitwise_equal": 0,
    }
    launches0 = segment_cuda.launch_counts()
    done = 0
    for seed in range(N_SEEDS):
        years, vals, mask = make_population(np.random.default_rng(seed), per, ny)
        y = torch.as_tensor(years, device=device)
        v = torch.as_tensor(vals.astype(np.float32), device=device).contiguous()
        m = torch.as_tensor(mask, device=device).contiguous()
        out_k = segment_cuda.cuda_segment_pixels_chunked(y, v, m, params, chunk)
        out_p = torch_segment_pixels_chunked(y, v, m, params, chunk)
        vi_eq = (out_k.vertex_indices == out_p.vertex_indices).all(dim=1)
        stats["pixel_exact_vertex_indices"] += int(vi_eq.sum())
        stats["model_valid_equal"] += int((out_k.model_valid == out_p.model_valid).sum())
        stats["n_vertices_equal"] += int((out_k.n_vertices == out_p.n_vertices).sum())
        fk, fp = out_k.fitted.double(), out_p.fitted.double()
        stats["fitted_abs_delta_max"] = max(
            stats["fitted_abs_delta_max"], float(torch.nan_to_num((fk - fp).abs()).max()))
        pk, pp = out_k.p_of_f.double(), out_p.p_of_f.double()
        rel = torch.nan_to_num((pk - pp).abs() / pp.abs().clamp_min(1e-30))
        stats["p_of_f_rel_delta_max"] = max(stats["p_of_f_rel_delta_max"], float(rel.max()))
        stats["p_of_f_bitwise_equal"] += int((_bits(out_k.p_of_f) == _bits(out_p.p_of_f)).sum())
        same = np.ones(per, dtype=bool)
        for name in _FLOATS:
            a, b = _bits(getattr(out_k, name)), _bits(getattr(out_p, name))
            same &= (a == b).reshape(per, -1).all(axis=1)
        stats["float_fields_bitwise_equal"] += int(same.sum())
        done += per
        if verbose:
            print(f"seed {seed}: cumulative exact "
                  f"{stats['pixel_exact_vertex_indices']}/{done}", flush=True)

    launches1 = segment_cuda.launch_counts()
    decisions = (stats["pixel_exact_vertex_indices"] == stats["model_valid_equal"]
                 == stats["n_vertices_equal"] == done)
    return {
        "n_pixels": done,
        "n_years": ny,
        "params": params.to_dict(),
        "instantiation": segment_cuda.instantiation(ny, params),
        "platform": f"{device.type} (both legs, same device)",
        "device_name": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "population": "tools/population.make_population seeds 0-15 "
                      "(the parity-suite population)",
        **{k: (round(v, 12) if isinstance(v, float) else v) for k, v in stats.items()},
        "pixel_exact_rate": stats["pixel_exact_vertex_indices"] / done,
        "decisions_identical": decisions,
        "launches": {k: launches1[k] - launches0[k] for k in launches1},
        "note": "CUDA kernel vs the plain PyTorch version, both float32 on the same "
                "device over identical inputs. Decisions and trajectories compared "
                "bitwise; p_of_f by relative delta and bitwise.",
    }


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--px", type=int, default=1_048_576)
    ap.add_argument("--chunk", type=int, default=262_144)
    ap.add_argument("--ny", type=int, default=40, help="years of the population")
    ap.add_argument("--params", default=None,
                    help="LTParams overrides as JSON (default: LTParams())")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (tests)")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    params = LTParams.from_dict(json.loads(args.params)) if args.params else LTParams()
    out = identity(args.px, device, args.chunk, args.ny, params)
    line = json.dumps(out, indent=1)
    print(line)
    if args.out:
        write_json_atomic(args.out, out, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
