"""Stage probe of the port: where a segmentation call's device time goes.

Counterpart of the JAX package's ``tools/tpu_probe.py`` (its ``stages``
and ``scaling`` subcommands)::

    python -m land_trendr_tpu_torch.tools.probe stages  [--px 262144] [--ny 40] [--device cuda]
    python -m land_trendr_tpu_torch.tools.probe scaling [--px-list 4096,65536,262144]
    python -m land_trendr_tpu_torch.tools.probe kernel  [--px 262144] [--reps 20]

``stages`` times four variants of one segmentation call on the same
float32 population (``tools/population.py``, seed 7, 40 years):

* ``fused``            — the fused kernel (:func:`cuda_segment_pixels`);
* ``family_only``      — the family kernel (:func:`cuda_family_stats`):
  stages 1–4a, the despiked series, vertex sets and SSEs;
* ``family_plus_tail`` — the family kernel, then the plain PyTorch tail
  (``_select_and_assemble``: scoring, selection, refit, assembly) on the
  same device — the split the fused kernel replaces;
* ``plain``            — the plain PyTorch version of the whole call
  (:func:`torch_segment_pixels`);

and derives ``tail_s`` (family + tail − family), ``in_kernel_tail_s``
(fused − family) and ``fusion_win_s`` (family + tail − fused).  On a CUDA
device each time is the mean over ``--reps`` calls between two CUDA
events after one warm-up call (which also builds the kernels); the card
has no dispatch constant to cancel, so the JAX probe's paired-chain method
is not needed.  With ``--device cpu`` the wrappers run the plain versions
and times come from the host clock (a check of the probe, not a device
measurement).  ``scaling`` times the fused kernel over a list of pixel
counts.  ``kernel`` (card only) reports where the time goes inside the
float32 kernels: each fused-kernel stage's share of the cycles, occupancy
and shared bytes per block, the block-size sweep, and kernel-alone and
wrapper milliseconds.  Each subcommand prints one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops.segment import _select_and_assemble, torch_segment_pixels
from land_trendr_tpu_torch.ops import segment_cuda as sc
from land_trendr_tpu_torch.ops.segment_cuda import cuda_family_stats, cuda_segment_pixels
from land_trendr_tpu_torch.runtime.driver import resolve_device
from land_trendr_tpu_torch.tools.population import make_population

__all__ = ["kernel", "kernel_report", "main", "scaling", "stages"]

NY = 40


def _inputs(px: int, dev: torch.device, ny: int = NY):
    years, vals, mask = make_population(np.random.default_rng(7), px, ny)
    return (
        torch.from_numpy(years).to(dev),
        torch.from_numpy(vals.astype(np.float32)).to(dev),
        torch.from_numpy(mask).to(dev),
    )


def _per_call_s(fn: Callable[[], object], reps: int, dev: torch.device) -> float:
    """Mean seconds of one ``fn()`` over ``reps`` calls after a warm-up:
    CUDA events on a card, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 1e3 / reps


def _variants(years, vals, mask, params: LTParams) -> dict[str, Callable[[], object]]:
    def family_plus_tail():
        family = cuda_family_stats(years, vals, mask, params)
        return _select_and_assemble(years, vals, mask, *family, params)

    return {
        "fused": lambda: cuda_segment_pixels(years, vals, mask, params),
        "family_only": lambda: cuda_family_stats(years, vals, mask, params),
        "family_plus_tail": family_plus_tail,
        "plain": lambda: torch_segment_pixels(years, vals, mask, params),
    }


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def stages(px: int = 262_144, device: str = "cuda", reps: int = 5, ny: int = NY) -> dict:
    """Time the four variants at ``px`` pixels of ``ny`` years (above 64 the
    kernels' wide instantiation, above 128 their global form); the probe's
    result dict."""
    dev = resolve_device(device)
    years, vals, mask = _inputs(px, dev, ny)
    out = {
        "probe": "stages",
        "px": px,
        "ny": ny,
        "reps": reps,
        "device": str(dev),
        "device_name": _device_name(dev),
        "timing": "cuda events" if dev.type == "cuda" else "host clock",
        "variants": {},
    }
    for name, fn in _variants(years, vals, mask, LTParams()).items():
        s = _per_call_s(fn, reps, dev)
        out["variants"][name] = {"per_step_s": s, "px_per_s": px / s}
        print(f"{name}: {s * 1e3:.4f} ms/call = {px / s / 1e6:.3f}M px/s", flush=True)
    v = {k: d["per_step_s"] for k, d in out["variants"].items()}
    out["derived"] = {
        "tail_s": v["family_plus_tail"] - v["family_only"],
        "in_kernel_tail_s": v["fused"] - v["family_only"],
        "fusion_win_s": v["family_plus_tail"] - v["fused"],
    }
    return out


def scaling(px_list: "list[int]", device: str = "cuda", reps: int = 5) -> dict:
    """Time the fused kernel at each pixel count."""
    dev = resolve_device(device)
    out = {
        "probe": "scaling",
        "device": str(dev),
        "device_name": _device_name(dev),
        "timing": "cuda events" if dev.type == "cuda" else "host clock",
        "points": [],
    }
    for px in px_list:
        years, vals, mask = _inputs(px, dev)
        s = _per_call_s(lambda: cuda_segment_pixels(years, vals, mask), reps, dev)
        out["points"].append({"px": px, "per_step_s": s, "px_per_s": px / s})
        print(f"px={px}: {s * 1e3:.4f} ms/call = {px / s / 1e6:.3f}M px/s", flush=True)
    return out


def kernel_report(years, vals, mask, reps: int = 20) -> dict:
    """Where the time goes inside the float32 kernels on these CUDA inputs.

    Each fused-kernel stage's share of the summed per-thread ``clock64()``
    cycles (:func:`cuda_segment_stage_cycles`), the mean cycles per pixel,
    each kernel's resident blocks and warps per SM and shared bytes per
    block, the kernel-alone and wrapper milliseconds of both kernels, and
    the fused kernel at each block size of the sweep (CUDA events, mean of
    ``reps`` calls after a warm-up)."""
    dev = vals.device
    params = LTParams()
    px = vals.shape[0]
    cyc = sc.cuda_segment_stage_cycles(years, vals, mask, params)
    if not torch.equal(cyc[:, : len(sc.STAGES)].sum(dim=1), cyc[:, -1]):
        raise RuntimeError("stage cycles do not sum to each thread's total")
    per_stage = cyc[:, : len(sc.STAGES)].double().sum(dim=0)
    total = float(per_stage.sum())
    job = sc._Launch(years, vals, mask, params)
    fjob = sc._FamilyLaunch(years, vals, mask, params)
    ny = vals.shape[1]
    sweep = [
        {**sc.occupancy("fused", torch.float32, ny, b),
         "ms": _per_call_s(lambda b=b: job.run(0, px, block=b), reps, dev) * 1e3}
        for b in sc.SWEEP
    ]
    return {
        "px": px,
        "ny": vals.shape[1],
        "device_name": _device_name(dev),
        "stage_share": {k: float(v) / total for k, v in zip(sc.STAGES, per_stage)},
        "cycles_per_px": {k: float(v) / px for k, v in zip(sc.STAGES, per_stage)},
        "occupancy": [sc.occupancy(k, d, ny)
                      for k in ("fused", "family") for d in (torch.float32, torch.float64)],
        "block_sweep": sweep,
        "fused_ms": _per_call_s(lambda: job.run(0, px), reps, dev) * 1e3,
        "fused_wrapper_ms": _per_call_s(
            lambda: cuda_segment_pixels(years, vals, mask, params), reps, dev) * 1e3,
        "family_ms": _per_call_s(fjob.run, reps, dev) * 1e3,
        "family_wrapper_ms": _per_call_s(
            lambda: cuda_family_stats(years, vals, mask, params), reps, dev) * 1e3,
    }


def kernel(px: int = 262_144, reps: int = 20) -> dict:
    """:func:`kernel_report` on the probe's population, on the card."""
    dev = resolve_device("cuda")
    out = {"probe": "kernel", "timing": "cuda events"}
    out.update(kernel_report(*_inputs(px, dev), reps=reps))
    for k, v in out["stage_share"].items():
        print(f"{k}: {100 * v:.1f}% of cycles ({out['cycles_per_px'][k]:.0f} per px)", flush=True)
    for row in out["block_sweep"]:
        print(f"block {row['block']}: {row['ms']:.4f} ms ({row['warps_per_sm']} warps/SM, "
              f"{row['smem_bytes']} B shared)", flush=True)
    return out


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("probe", choices=["stages", "scaling", "kernel"])
    ap.add_argument("--px", type=int, default=262_144)
    ap.add_argument("--ny", type=int, default=NY, help="years of the stages population")
    ap.add_argument("--px-list", type=lambda s: [int(x) for x in s.split(",")],
                    default=[4096, 65536, 262144])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=str, default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)
    if args.probe == "stages":
        res = stages(args.px, args.device, args.reps, args.ny)
    elif args.probe == "kernel":
        res = kernel(args.px, args.reps)
    else:
        res = scaling(args.px_list, args.device, args.reps)
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
