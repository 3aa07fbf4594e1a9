"""Capacity bench: scaling curves + the byte-identical replay proof.

Counterpart of the JAX package's ``tools/capacity_bench.py``.  One run
sweeps replica counts x offered QPS with the seeded load rig
(:mod:`land_trendr_tpu_torch.loadgen`) against live ``route`` fleets of
spawned ``serve`` replicas on ``--device`` (the card by default), then:

* assembles every sweep cell's latency truth through the request-trace
  store (:mod:`~land_trendr_tpu_torch.obs.reqtrace` — fleet event
  streams, not client clocks), folding p50/p99/goodput per cell;
* finds the knee of each replica count's offered-QPS-vs-p99 curve and
  names the dominant blame component there
  (:mod:`land_trendr_tpu_torch.fleet.capacity`);
* replays every leg's recorded decision log through fresh pure machines
  and byte-compares the outputs — plus a scripted autoscaler/dispatcher
  history for the clock-free speedup number.

The report is checked by ``validate_report`` and carries the replicas'
kernel launch counts (read over ``GET /debug/kernels`` before each fleet
stops).  Sizes: ``--smoke`` takes the JAX tool's (a 40² x 7-year scene at
tile 20, 2 replica counts, 3 QPS steps, 5 s windows); the full run takes
the card's real shape — a 512² x 40-year stack at tile 512, so each job
is one full-width launch — with 1-3 replicas and each cell's window long
enough for :data:`MIN_JOBS` (100) completed jobs, so the p99 means
something.  The explicit size flags override either.

Usage::

    python -m land_trendr_tpu_torch.tools.capacity_bench --smoke [--device cpu]
    python -m land_trendr_tpu_torch.tools.capacity_bench --out CAPACITY.json
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

from land_trendr_tpu_torch.fleet.capacity import (
    REPORT_SCHEMA,
    ReplayReport,
    assemble_sweep,
    dominant_blame,
    mark_knee,
    percentile,
    replay_decisions,
    validate_report,
    write_scripted_history,
)
from land_trendr_tpu_torch.fleet.scheduling import DECISIONS_NAME
from land_trendr_tpu_torch.loadgen import InProcClient, LoadConfig, LoadRunner
from land_trendr_tpu_torch.loadgen.trace import SHAPE_PARAMS
from land_trendr_tpu_torch.tools.measure import replica_launches, write_json_atomic

__all__ = ["MIN_JOBS", "main", "run_autoscale_leg", "run_bench", "run_curve_leg"]

#: completed jobs each cell of a full run holds, so its p99 means something
MIN_JOBS = 100


def _write_scene(root: Path, size: int, years: int) -> str:
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack

    d = str(root / "stack")
    write_stack(d, make_stack(SceneSpec(
        width=size, height=size, year_start=2000, year_end=2000 + years - 1, seed=13,
    )))
    return d


def _payload_fn(stack_dir: str, tile: int):
    def fn(req) -> dict:
        return {
            "stack_dir": stack_dir,
            "tile_size": tile,
            "tenant": req.tenant,
            "params": dict(SHAPE_PARAMS[req.shape]),
            "trace_id": req.trace_id,
            "run_overrides": {"retry_backoff_s": 0.0},
        }
    return fn


def _prune_jobs(workdir: str) -> None:
    """Delete the finished jobs' tile artifacts and rasters under a router
    workdir, keeping their event streams (all the sweep reads): a full run
    writes ~54 MB a job, over a thousand jobs."""
    for job in Path(workdir, "jobs").glob("*"):
        shutil.rmtree(job / "out", ignore_errors=True)
        for art in (job / "work").glob("tile_*.npz"):
            art.unlink(missing_ok=True)


def _start_router(workdir: str, n_replicas: int, device: str, autoscale: bool = False):
    from land_trendr_tpu_torch.fleet import FleetRouter, RouterConfig

    cfg = RouterConfig(
        workdir=workdir,
        spawn_replicas=n_replicas,
        health_interval_s=0.5,
        route_queue_depth=512,
        tenant_quota=256,
        route_retries=3,
        decision_log=True,
        replica_args=(*(() if device == "cuda" else ("--device", device)),
                      "--feed-cache-mb", "64"),
        **(
            {"autoscale": True, "min_replicas": n_replicas,
             "max_replicas": n_replicas + 2, "scale_hold_s": 0.5}
            if autoscale else {}
        ),
    )
    router = FleetRouter(cfg)
    thread = threading.Thread(target=router.serve_forever,
                              name=f"capacity-{Path(workdir).name}")
    thread.start()
    return router, thread


def _event_fields(point: dict) -> dict:
    """A curve point's ``sweep_point`` event fields (the event carries
    neither the blame breakdown nor the slowest job)."""
    return {k: v for k, v in point.items() if k not in ("blame", "max_s")}


def run_curve_leg(
    root: Path, stack_dir: str, tile: int, n_replicas: int,
    qps_steps: "list[float]", window_s: float, timeout_s: float,
    seed: int, device: str = "cuda", min_jobs: int = 0,
) -> "tuple[dict, ReplayReport]":
    """One replica count's curve: a fresh fleet, one open-loop phase per
    offered rate (the fleet drains between phases — the runner polls
    every request to terminal), every cell assembled through the trace
    store, then the leg's decision log replayed.  A cell's window is
    stretched to offer about ``1.2 x min_jobs`` requests at its rate."""
    workdir = str(root / f"rt_{n_replicas}r")
    router, thread = _start_router(workdir, n_replicas, device)
    points: "list[dict]" = []
    try:
        for step, qps in enumerate(qps_steps):
            window = max(window_s, math.ceil(1.2 * min_jobs / qps)) if min_jobs else window_s
            cfg = LoadConfig(
                mode="open", duration_s=window, qps=qps,
                workers=4, seed=seed + step, tenants=3,
                tenant_skew=1.0, wave_amp=0.3,
                wave_period_s=max(window, 1.0),
                timeout_s=timeout_s,
            )
            runner = LoadRunner(cfg, InProcClient(router), _payload_fn(stack_dir, tile),
                                telemetry=router.telemetry)
            report = runner.run(phase=f"r{n_replicas}_q{qps}")
            sweep = assemble_sweep(workdir, report.trace_ids)
            _prune_jobs(workdir)  # every request of the cell is terminal
            lat = sweep["latencies"]
            point = {
                "replicas": n_replicas,
                "offered_qps": qps,
                "achieved_qps": round(report.done / max(report.wall_s, 1e-6), 4),
                "p50_s": round(percentile(lat, 50.0), 4),
                "p99_s": round(percentile(lat, 99.0), 4),
                # a smoke cell's few jobs hold no p99: its slowest is read instead
                "max_s": round(max(lat), 4) if lat else None,
                "goodput_qps": round(report.done / max(report.wall_s, 1e-6), 4),
                "done": report.done,
                "failed": report.failed,
                "rejected": report.rejected,
                "assembled": sweep["assembled"],
                "window_s": round(report.wall_s, 3),
                "blame": sweep["blame"],
            }
            points.append(point)
            print(f"  cell r={n_replicas} qps={qps}: done {report.done}, p50 "
                  f"{point['p50_s']} s, p99 {point['p99_s']} s", flush=True)
            if router.telemetry is not None:
                router.telemetry.sweep_point(**_event_fields(point))
        knee_idx = mark_knee(points)
        if knee_idx is None and points:
            # no interior knee in the measured range: the saturation point
            # stands in (stamped so every curve names a blame)
            knee_idx = len(points) - 1
            points[knee_idx]["knee"] = True
            points[knee_idx]["knee_blame"] = dominant_blame(points[knee_idx].get("blame") or {})
        if knee_idx is not None and router.telemetry is not None:
            p = points[knee_idx]
            router.telemetry.sweep_point(**_event_fields(p))
        launches = replica_launches(router)
    finally:
        router.stop()
        thread.join(timeout=300)
    replay = replay_decisions(os.path.join(workdir, DECISIONS_NAME))
    curve = {
        "replicas": n_replicas,
        "points": points,
        "knee_index": knee_idx,
        "knee_offered_qps": points[knee_idx]["offered_qps"] if knee_idx is not None else None,
        "knee_blame": points[knee_idx].get("knee_blame") if knee_idx is not None else None,
        "replay": replay.to_json(),
        "replica_launches": launches,
    }
    return curve, replay


def run_autoscale_leg(
    root: Path, stack_dir: str, tile: int, timeout_s: float, seed: int,
    device: str = "cuda",
) -> "tuple[dict, ReplayReport]":
    """An autoscaled fleet under closed-loop load with a scripted burn
    history driven through ``scale_tick`` — the leg that puts real
    autoscale records (with real spawns/drains behind them) into the
    decision log the replay must reproduce."""
    workdir = str(root / "rt_autoscale")
    router, thread = _start_router(workdir, 1, device, autoscale=True)
    try:
        cfg = LoadConfig(mode="closed", duration_s=6.0, requests=8, workers=2,
                         seed=seed, tenants=2, timeout_s=timeout_s)
        runner = LoadRunner(cfg, InProcClient(router), _payload_fn(stack_dir, tile),
                            telemetry=router.telemetry)
        done = {}

        def _drive() -> None:
            done["report"] = runner.run(phase="autoscale")

        t = threading.Thread(target=_drive)
        t.start()
        # scripted burn history: pressure up, hold, release — recorded
        # decisions include real up/down actions between the bounds
        # (wall clock: the decision log's one time domain)
        now = time.time()
        script = [0.9, 0.9, 0.9, 0.7, 0.4, 0.02, 0.02, 0.02, 0.02]
        for i, burn in enumerate(script):
            router.scale_tick(burn, now + i * 0.7)
            time.sleep(0.7)
        t.join(timeout=timeout_s + 60)
        report = done.get("report")
        launches = replica_launches(router)
    finally:
        router.stop()
        thread.join(timeout=300)
    replay = replay_decisions(os.path.join(workdir, DECISIONS_NAME))
    leg = {
        "done": report.done if report else None,
        "failed": report.failed if report else None,
        "scripted_burns": len(script),
        "replay": replay.to_json(),
        "replica_launches": launches,
    }
    return leg, replay


def run_bench(smoke: bool, root: str, size: int, years: int, tile: int,
              device: str = "cuda") -> dict:
    rootp = Path(root)
    stack_dir = _write_scene(rootp, size, years)
    replica_counts = [1, 2] if smoke else [1, 2, 3]
    qps_steps = [0.5, 1.0, 2.0] if smoke else [0.5, 1.0, 2.0, 4.0]
    min_jobs = 0 if smoke else MIN_JOBS
    window_s = 5.0 if smoke else 15.0
    timeout_s = 120.0 if smoke else 600.0

    curves: "list[dict]" = []
    replays: "list[ReplayReport]" = []
    t0 = time.perf_counter()
    for i, n in enumerate(replica_counts):
        curve, replay = run_curve_leg(rootp, stack_dir, tile, n, qps_steps, window_s,
                                      timeout_s, seed=100 + 10 * i, device=device,
                                      min_jobs=min_jobs)
        curves.append(curve)
        replays.append(replay)
    curves_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    autoscale_leg, as_replay = run_autoscale_leg(rootp, stack_dir, tile, timeout_s, seed=7,
                                                 device=device)
    replays.append(as_replay)
    autoscale_s = time.perf_counter() - t1

    # the clock-free speedup proof: a scripted 2-minute-span history
    # replayed in milliseconds
    script_path = str(rootp / "scripted_decisions.jsonl")
    write_scripted_history(script_path, seed=23, events=2000)
    scripted = replay_decisions(script_path)

    live_decisions = sum(r.decisions for r in replays)
    live_matched = sum(r.matched for r in replays)
    replay_summary = {
        "decisions": live_decisions,
        "matched": live_matched,
        "match": bool(live_decisions > 0 and live_matched == live_decisions),
        "speedup_x": round(min((r.speedup_x for r in replays if r.decisions), default=0.0), 3),
        "legs": len(replays),
    }
    launches: "dict[str, int]" = {}
    for leg in [*curves, autoscale_leg]:
        for counts in leg["replica_launches"].values():
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    invariants = {
        "curves_all_counts": len(curves) == len(replica_counts),
        "points_per_curve": all(len(c["points"]) == len(qps_steps) for c in curves),
        "knee_named_per_curve": all(c["knee_blame"] is not None for c in curves),
        "live_replay_match": replay_summary["match"],
        "scripted_replay_match": scripted.match,
        "scripted_replay_100x": scripted.speedup_x >= 100.0,
        "every_cell_assembled": all(p["assembled"] > 0 for c in curves for p in c["points"]),
        "no_cell_lost_jobs": all(p["failed"] == 0 for c in curves for p in c["points"]),
    }
    if min_jobs:
        invariants["cells_hold_min_jobs"] = all(
            p["done"] >= min_jobs and p["assembled"] >= min_jobs
            for c in curves for p in c["points"])
    if device == "cuda":
        # the replicas ran the kernel, not the plain version
        invariants["replicas_launched_kernels"] = launches.get("LAUNCHES", 0) > 0
    report = {
        "schema": REPORT_SCHEMA,
        "smoke": smoke,
        "device": device,
        "workload": {
            "scene_px": size * size,
            "years": years,
            "tile_size": tile,
            "replica_counts": replica_counts,
            "qps_steps": qps_steps,
            "window_s": window_s,
            "min_jobs_per_cell": min_jobs,
            "mode": "open",
            "wave_amp": 0.3,
        },
        "curves": curves,
        "autoscale_leg": autoscale_leg,
        "replay": replay_summary,
        "scripted_replay": scripted.to_json(),
        "launches": launches,
        "seconds": {"curves": round(curves_s, 3), "autoscale": round(autoscale_s, 3)},
        "invariants": invariants,
        "ok": all(invariants.values()),
    }
    schema_errs = validate_report(report)
    report["invariants"]["schema_valid"] = not schema_errs
    if schema_errs:
        report["schema_errors"] = schema_errs
        report["ok"] = False
    return report


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="minutes-scale mode at the JAX tool's sizes (2 replica counts, "
                    "3 QPS steps, short windows)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    ap.add_argument("--size", type=int, default=None,
                    help="scene edge px (default: 40 smoke / 512 full)")
    ap.add_argument("--years", type=int, default=None,
                    help="stack years (default: 7 smoke / 40 full)")
    ap.add_argument("--tile", type=int, default=None,
                    help="tile size (default: 20 smoke / 512 full)")
    ap.add_argument("--keep", default=None, metavar="DIR", help="keep the bench workdirs under DIR")
    ap.add_argument("--out", default=None, metavar="FILE", help="write the JSON report here")
    args = ap.parse_args(argv)
    from land_trendr_tpu_torch.runtime.driver import resolve_device

    try:
        device = resolve_device(args.device).type
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    size = args.size or (40 if args.smoke else 512)
    years = args.years or (7 if args.smoke else 40)
    tile = args.tile or (20 if args.smoke else 512)

    root = args.keep or tempfile.mkdtemp(prefix="lt_capacity_bench_")
    Path(root).mkdir(parents=True, exist_ok=True)
    try:
        report = run_bench(args.smoke, root, size, years, tile, device=device)
    finally:
        if args.keep is None:
            shutil.rmtree(root, ignore_errors=True)

    if args.out:
        write_json_atomic(args.out, report, trailing_newline=False)
        print(f"wrote {args.out}")
    print(json.dumps({
        "ok": report["ok"],
        "knees": {
            str(c["replicas"]): {"offered_qps": c["knee_offered_qps"], "blame": c["knee_blame"]}
            for c in report["curves"]
        },
        "p99_s": {f"{p['replicas']}r@{p['offered_qps']}": p["p99_s"]
                  for c in report["curves"] for p in c["points"]},
        "replay_match": report["replay"]["match"],
        "scripted_speedup_x": report["scripted_replay"]["speedup_x"],
        "launches": report["launches"],
        "invariants": report["invariants"],
    }, indent=2))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
