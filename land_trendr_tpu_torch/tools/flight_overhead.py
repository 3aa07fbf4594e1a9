"""Flight-recorder overhead: ring + sampler on against off, alternating reps.

Counterpart of the JAX package's ``tools/flight_overhead.py``.  BOTH sides
run a scene through :func:`~land_trendr_tpu_torch.runtime.driver.
run_stack` on ``--device`` with telemetry on; the "on" side also mirrors
every emit into the flight ring and runs the resource sampler at an
aggressive period (0.2 s, far faster than the production default, so it
fires many times inside a short run).  Reps alternate off / on; the
report carries the median overhead (the headline) and the min-of-reps
overhead (the gate's metric: scheduler jitter only adds wall time, a
real regression raises the floor itself) beside the documented noise
band.

Structural checks ride along on every device: the last on-run's
``flight.jsonl`` dump exists, passes the schema lint (plus the caller's
value lints, ``lint_extra``) and carries ``flight_sample`` events.

Usage::

    python -m land_trendr_tpu_torch.tools.flight_overhead [--smoke] [--out FLIGHT.json]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

from land_trendr_tpu_torch.runtime.driver import resolve_device
from land_trendr_tpu_torch.tools.measure import record_meta, write_json_atomic

__all__ = ["NOISE_BAND_PCT", "main", "run_bench"]

#: the documented noise band: run-to-run wall noise dwarfs the ring's
#: true cost, so the bound catches a real regression (a lock on the emit
#: path, an O(n) ring scan a emit), not the sub-noise cost itself
NOISE_BAND_PCT = 10.0


def run_bench(smoke: bool, out_path: "str | None", device: str = "cuda",
              lint_extra=None, argv: "list[str] | None" = None,
              reps: "int | None" = None) -> dict:
    """Alternating off/on reps (``reps``, else 2 smoke and 5 full); the
    report (module doc).  ``lint_extra`` is an optional factory of a
    per-record value lint."""
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack
    from land_trendr_tpu_torch.obs.events import validate_events_file
    from land_trendr_tpu_torch.ops.indices import required_bands
    from land_trendr_tpu_torch.runtime import RunConfig, load_stack_dir, run_stack

    reps = reps or (2 if smoke else 5)
    # the card's runs are short, so the card scene is larger (16 tiles of
    # 256²) to keep the fixed per-run noise a few percent of the wall; the
    # CPU takes the JAX tool's 4 tiles of 128²
    size, tile = (256, 128) if device == "cpu" else (1024, 256)
    sampler_interval_s = 0.2
    ring_events = 256
    root = tempfile.mkdtemp(prefix="lt_flight_overhead_")
    try:
        stack_dir = os.path.join(root, "stack")
        write_stack(stack_dir, make_stack(SceneSpec(width=size, height=size, year_start=1990,
                                                    year_end=2013, seed=7)))
        stack = load_stack_dir(stack_dir, bands=required_bands("nbr", ()), device="cpu")

        def one_run(tag: str, flight: bool) -> "tuple[float, dict]":
            gc.collect()  # collector garbage must not land in a timed rep
            wd = os.path.join(root, tag)
            cfg = RunConfig(params=LTParams(max_segments=4), tile_size=tile, workdir=wd,
                            out_dir=wd + "_o", telemetry=True, flight=flight,
                            flight_ring_events=ring_events,
                            sampler_interval_s=sampler_interval_s)
            t0 = time.perf_counter()
            summary = run_stack(stack, cfg, device=device)
            return time.perf_counter() - t0, summary

        one_run("warmup", flight=False)  # kernel load outside the medians
        off_s: "list[float]" = []
        on_s: "list[float]" = []
        flight_checks: dict = {}
        for rep in range(reps):
            dt_off, _ = one_run(f"off{rep}", flight=False)
            off_s.append(round(dt_off, 4))
            dt_on, summary = one_run(f"on{rep}", flight=True)
            on_s.append(round(dt_on, 4))
            if rep == reps - 1:
                dump = summary.get("telemetry", {}).get("flight")
                errs = (validate_events_file(dump, extra=lint_extra() if lint_extra else None)
                        if dump and os.path.exists(dump) else ["flight dump missing"])
                samples = events = 0
                if not errs:
                    with open(dump) as f:
                        for line in f:
                            events += 1
                            samples += '"ev":"flight_sample"' in line
                flight_checks = {"dump_valid": not errs, "dump_errors": errs[:5],
                                 "dump_events": events, "samples": samples}
        med_off, med_on = statistics.median(off_s), statistics.median(on_s)
        min_off, min_on = min(off_s), min(on_s)
        result = {
            **record_meta("land_trendr_tpu_torch.tools.flight_overhead", argv, device),
            "what": (f"flight recorder + sampler wall overhead: run_stack over a {size}x{size} "
                     f"synthetic scene ({(size // tile) ** 2} tiles of {tile}^2) on {device}, "
                     f"telemetry ON both sides, ring+sampler on vs off, sampler at "
                     f"{sampler_interval_s}s, {reps} alternating reps"),
            "scene_px": size * size,
            "tiles": (size // tile) ** 2,
            "reps": reps,
            "sampler_interval_s": sampler_interval_s,
            "flight_ring_events": ring_events,
            "off_s": off_s,
            "on_s": on_s,
            "median_off_s": round(med_off, 4),
            "median_on_s": round(med_on, 4),
            "overhead_pct": round(100.0 * (med_on - med_off) / med_off, 2),
            "min_off_s": round(min_off, 4),
            "min_on_s": round(min_on, 4),
            "overhead_min_pct": round(100.0 * (min_on - min_off) / min_off, 2),
            "noise_band_pct": NOISE_BAND_PCT,
            "flight": flight_checks,
            "smoke": smoke,
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if out_path:
        write_json_atomic(out_path, result, trailing_newline=False)
    return result


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="2 reps instead of 5")
    ap.add_argument("--out", default=None, metavar="FILE", help="write the result JSON here")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device).type
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    result = run_bench(args.smoke, args.out, device=device, argv=argv)
    print(json.dumps({k: result[k] for k in (
        "median_off_s", "median_on_s", "overhead_pct", "min_off_s", "min_on_s",
        "overhead_min_pct", "noise_band_pct", "flight")}, indent=2))
    fl = result["flight"]
    # the structural checks decide the exit; the overhead is the gate's band
    return 0 if fl.get("dump_valid") and fl.get("samples", 0) >= 1 else 1


if __name__ == "__main__":
    sys.exit(main())
