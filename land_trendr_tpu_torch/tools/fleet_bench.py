"""Serving-fleet bench: a heavy-tailed multi-tenant trace, 1 vs N replicas.

Counterpart of the JAX package's ``tools/fleet_bench.py``.  It replays ONE
fixed multi-tenant job trace — three tenants with skewed demand, two
program shapes, a heavy tail of 4x-pixel jobs — through a real
:class:`~land_trendr_tpu_torch.fleet.router.FleetRouter` over spawned
``serve`` replica processes on ``--device`` (the card by default), in
four legs:

* **single** — one replica (the baseline a fleet must beat);
* **noaff** — N replicas, warm affinity OFF (pure least-loaded);
* **affinity** — N replicas, warm affinity ON: repeat shapes stick to the
  replica already holding the warm program;
* **kill** — the affinity configuration with one replica SIGKILLed
  mid-trace: the router re-routes its jobs and nothing is lost.

Per leg: client-side p50/p99 latency, the fleet-wide warm-hit ratio
(program-cache hits / lookups over every job's run), per-tenant
throughput and its spread, re-route and loss counts, and the replicas'
kernel launch counts (``GET /debug/kernels``).  Invariants:

* affinity's warm-hit ratio strictly above the no-affinity baseline;
* ZERO lost jobs across the replica kill (every job ``done``, at least
  one re-routed);
* artifacts byte-identical for the same job spec across ALL legs.

Sizes: ``--smoke`` takes the JAX tool's (40² x 7-year small scene, tile
20); the full run the card's real shape — 40-year scenes at tile 512,
``big`` at 4x the pixels of ``small`` (512² and 1024²).

    python -m land_trendr_tpu_torch.tools.fleet_bench --smoke [--device cpu]
    python -m land_trendr_tpu_torch.tools.fleet_bench --out FLEETSERVE.json
"""

from __future__ import annotations

import argparse
import json
import shutil
import signal
import sys
import tempfile
import threading
import time
from pathlib import Path

from land_trendr_tpu_torch.tools.measure import (
    digest_workdir,
    replica_launches,
    write_json_atomic,
)

__all__ = ["build_trace", "main", "run_bench", "run_leg"]

#: the two program shapes (different params → different warm programs →
#: different affinity keys)
_SHAPES = {
    "a": {"max_segments": 4, "vertex_count_overshoot": 2},
    "b": {"max_segments": 6, "vertex_count_overshoot": 2},
}


def _percentile(vals: list, q: float) -> "float | None":
    if not vals:
        return None
    s = sorted(vals)
    idx = min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))
    return round(s[idx], 4)


def build_trace(smoke: bool) -> list:
    """The FIXED multi-tenant trace: ``(tenant, shape, scene)`` tuples in
    submission order.  Tenant ``agency`` is the heavy tenant, ``alerts``
    and ``research`` are light; scene ``big`` (4x the pixels of
    ``small``) is the heavy tail.  Every leg replays the SAME list."""
    base = [
        ("agency", "a", "small"),
        ("agency", "a", "small"),
        ("alerts", "b", "small"),
        ("agency", "a", "small"),
        ("research", "b", "small"),
        ("agency", "a", "big"),
        ("agency", "a", "small"),
        ("alerts", "b", "small"),
        ("agency", "b", "small"),
        ("agency", "a", "small"),
        ("research", "b", "big"),
        ("agency", "a", "small"),
    ]
    if smoke:
        return base
    return base + [
        ("agency", "a", "small"),
        ("alerts", "b", "small"),
        ("agency", "b", "small"),
        ("agency", "a", "small"),
        ("research", "a", "small"),
        ("agency", "a", "big"),
        ("alerts", "b", "small"),
        ("agency", "a", "small"),
    ]


def _write_scenes(root: Path, size: int, years: int) -> dict:
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack

    scenes = {}
    for name, edge in (("small", size), ("big", size * 2)):
        d = str(root / f"stack_{name}")
        write_stack(d, make_stack(SceneSpec(
            width=edge, height=edge, year_start=2000, year_end=2000 + years - 1, seed=13,
        )))
        scenes[name] = d
    return scenes


def _job_payload(scenes: dict, tenant: str, shape: str, scene: str, tile: int) -> dict:
    return {
        "stack_dir": scenes[scene],
        "tile_size": tile,
        "tenant": tenant,
        "params": dict(_SHAPES[shape]),
        "run_overrides": {"retry_backoff_s": 0.0},
    }


def run_leg(
    name: str,
    root: Path,
    scenes: dict,
    trace: list,
    tile: int,
    n_replicas: int,
    affinity: bool,
    kill_one: bool = False,
    timeout_s: float = 900.0,
    device: str = "cuda",
) -> dict:
    """One leg: fresh router + fresh replica processes (honest warm-up
    counts), the trace replayed closed-loop, every job awaited to
    terminal.  ``kill_one`` SIGKILLs the busiest replica once the trace is
    in flight — the zero-lost-jobs leg."""
    from land_trendr_tpu_torch.fleet import FleetRouter, RouterConfig

    cfg = RouterConfig(
        workdir=str(root / f"rt_{name}"),
        spawn_replicas=n_replicas,
        affinity=affinity,
        health_interval_s=0.5,
        route_queue_depth=256,
        tenant_quota=64,
        route_retries=3,
        replica_args=(*(() if device == "cuda" else ("--device", device)),
                      "--feed-cache-mb", "64"),
    )
    router = FleetRouter(cfg)
    thread = threading.Thread(target=router.serve_forever, name=f"fleet-bench-{name}")
    thread.start()
    killed_rid = None
    # CLOSED-LOOP replay: at most ``max_out`` jobs outstanding — the
    # steady-arrival pattern a serving fleet sees (an unbounded burst
    # would measure the admission policy, not the affinity policy)
    max_out = n_replicas + 1
    kill_at = len(trace) // 3 if kill_one else None
    try:
        deadline = time.monotonic() + timeout_s
        # the leg measures an N-replica fleet: the trace starts once every
        # spawned replica is ready (a slow start-up on a loaded host would
        # otherwise send the first jobs all to one replica)
        while True:
            with router._lock:
                ready = sum(r.state == "ready" for r in router.pool)
            if ready >= n_replicas:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"leg {name}: {ready}/{n_replicas} replicas ready "
                                   f"in {timeout_s}s")
            time.sleep(0.05)
        t0 = time.perf_counter()
        submits: list = []
        results: dict = {}
        pending: set = set()

        def _drain(block_below: int) -> None:
            while len(pending) > block_below:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"leg {name}: {len(pending)} job(s) not terminal in {timeout_s}s"
                    )
                done_now = []
                for jid in sorted(pending):
                    s = router.job_status(jid)
                    if s and s["state"] not in ("queued", "routed"):
                        results[jid] = (s, time.perf_counter())
                        done_now.append(jid)
                pending.difference_update(done_now)
                if len(pending) > block_below:
                    time.sleep(0.05)

        for idx, (tenant, shape, scene) in enumerate(trace):
            _drain(max_out - 1)
            snap = router.submit(_job_payload(scenes, tenant, shape, scene, tile))
            submits.append((snap["job_id"], tenant, shape, scene, time.perf_counter()))
            pending.add(snap["job_id"])
            if kill_at is not None and idx == kill_at:
                # kill the replica holding in-flight work mid-trace
                victim = None
                while time.monotonic() < deadline and victim is None:
                    with router._lock:
                        busy = sorted(
                            (r for r in router.pool
                             if r.spawned and r.inflight and r.proc is not None
                             and r.proc.poll() is None),
                            key=lambda r: -len(r.inflight),
                        )
                        victim = busy[0] if busy else None
                    if victim is None:
                        time.sleep(0.05)
                if victim is None:
                    raise RuntimeError("kill leg: no replica ever held a job")
                killed_rid = victim.rid
                victim.proc.send_signal(signal.SIGKILL)
                kill_at = None
        _drain(0)
        wall_s = time.perf_counter() - t0
        launches = replica_launches(router)
    finally:
        router.stop()
        thread.join(timeout=300)

    latencies: list = []
    per_tenant: dict = {}
    hits = lookups = 0
    lost = rerouted = 0
    digests: dict = {}
    for jid, tenant, shape, scene, t_sub in submits:
        snap, t_done = results[jid]
        if snap["state"] != "done":
            lost += 1
            continue
        lat = t_done - t_sub
        latencies.append(lat)
        t = per_tenant.setdefault(
            tenant, {"jobs": 0, "latency_s": [], "first_t": t_sub, "last_t": t_done})
        t["jobs"] += 1
        t["latency_s"].append(lat)
        t["last_t"] = max(t["last_t"], t_done)
        if snap["attempts"] > 1:
            rerouted += 1
        pc = (snap.get("result") or {}).get("summary", {}).get("program_cache") or {}
        hits += pc.get("hits", 0)
        lookups += pc.get("hits", 0) + pc.get("misses", 0)
        digests.setdefault((shape, scene), []).append(digest_workdir(snap["workdir"]))
    tenants_out: dict = {}
    rates: list = []
    for tenant in sorted(per_tenant):
        t = per_tenant[tenant]
        rate = t["jobs"] / max(1e-6, t["last_t"] - t["first_t"])
        rates.append(rate)
        tenants_out[tenant] = {
            "jobs": t["jobs"],
            "mean_latency_s": round(sum(t["latency_s"]) / len(t["latency_s"]), 4),
            "jobs_per_s": round(rate, 4),
        }
    return {
        "replicas": n_replicas,
        "affinity": affinity,
        "jobs": len(submits),
        "lost_jobs": lost,
        "rerouted_jobs": rerouted,
        "killed_replica": killed_rid,
        "wall_s": round(wall_s, 3),
        "p50_latency_s": _percentile(latencies, 0.50),
        "p99_latency_s": _percentile(latencies, 0.99),
        "warm_hits": hits,
        "warm_lookups": lookups,
        "warm_hit_ratio": round(hits / lookups, 4) if lookups else None,
        "per_tenant": tenants_out,
        # max/min jobs-per-second over the tenants that ran — the fairness
        # number (1.0 = perfectly even service under the weights)
        "tenant_throughput_spread": (
            round(max(rates) / min(rates), 3) if rates and min(rates) > 0 else None
        ),
        # the live replicas' counts (a killed replica's are gone with it)
        "replica_launches": launches,
        "_digests": digests,
    }


def run_bench(smoke: bool, root: str, size: int, years: int, tile: int, n_replicas: int,
              device: str = "cuda") -> dict:
    rootp = Path(root)
    scenes = _write_scenes(rootp, size, years)
    trace = build_trace(smoke)
    legs: dict = {}
    seconds: dict = {}
    for name, n, aff, kill in (("single", 1, True, False), ("noaff", n_replicas, False, False),
                               ("affinity", n_replicas, True, False),
                               ("kill", n_replicas, True, True)):
        t0 = time.perf_counter()
        legs[name] = run_leg(name, rootp, scenes, trace, tile, n, affinity=aff,
                             kill_one=kill, device=device)
        seconds[name] = round(time.perf_counter() - t0, 3)
        print(f"  leg {name}: p50 {legs[name]['p50_latency_s']} s, p99 "
              f"{legs[name]['p99_latency_s']} s, warm {legs[name]['warm_hit_ratio']} "
              f"({seconds[name]} s)", flush=True)

    # cross-leg artifact parity: the same (shape, scene) spec must produce
    # byte-identical tile arrays in EVERY leg — kill included
    parity_ok = True
    ref: dict = {}
    for leg in legs.values():
        for spec, dlist in leg.pop("_digests").items():
            for d in dlist:
                if not d:
                    parity_ok = False
                elif spec not in ref:
                    ref[spec] = d
                elif ref[spec] != d:
                    parity_ok = False

    launches: "dict[str, int]" = {}
    for leg in legs.values():
        for counts in leg["replica_launches"].values():
            for k, v in counts.items():
                launches[k] = launches.get(k, 0) + v
    kill = legs["kill"]
    invariants = {
        "affinity_warm_above_noaff": bool(
            legs["affinity"]["warm_hit_ratio"] is not None
            and legs["noaff"]["warm_hit_ratio"] is not None
            and legs["affinity"]["warm_hit_ratio"] > legs["noaff"]["warm_hit_ratio"]
        ),
        "zero_lost_jobs_across_kill": bool(
            kill["lost_jobs"] == 0 and kill["rerouted_jobs"] >= 1
            and kill["killed_replica"] is not None
        ),
        "no_leg_lost_jobs": all(leg["lost_jobs"] == 0 for leg in legs.values()),
        "parity_across_legs": bool(parity_ok and ref),
    }
    if device == "cuda":
        # the replicas ran the kernel, not the plain version
        invariants["replicas_launched_kernels"] = launches.get("LAUNCHES", 0) > 0
    return {
        "workload": {
            "smoke": smoke,
            "device": device,
            "jobs": len(trace),
            "tenants": sorted({t for t, _, _ in trace}),
            "shapes": sorted({s for _, s, _ in trace}),
            "scene_small_px": size * size,
            "scene_big_px": (size * 2) ** 2,
            "years": years,
            "tile_size": tile,
            "replicas": n_replicas,
        },
        "legs": legs,
        "launches": launches,
        "seconds": seconds,
        "invariants": invariants,
        "ok": all(invariants.values()),
    }


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="minutes-scale mode at the JAX tool's sizes (short trace, tiny scenes)")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    ap.add_argument("--size", type=int, default=None,
                    help="small-scene edge px (default: 40 smoke / 512 full; big is 2x the edge)")
    ap.add_argument("--years", type=int, default=None,
                    help="stack years (default: 7 smoke / 40 full)")
    ap.add_argument("--tile", type=int, default=None,
                    help="tile size (default: 20 smoke / 512 full)")
    ap.add_argument("--replicas", type=int, default=2,
                    help="fleet size N for the multi-replica legs")
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

    root = args.keep or tempfile.mkdtemp(prefix="lt_fleet_bench_")
    Path(root).mkdir(parents=True, exist_ok=True)
    try:
        report = run_bench(args.smoke, root, size, years, tile, args.replicas, device=device)
    finally:
        if args.keep is None:
            shutil.rmtree(root, ignore_errors=True)

    if args.out:
        write_json_atomic(args.out, report, trailing_newline=False)
        print(f"wrote {args.out}")
    print(json.dumps({
        "ok": report["ok"],
        "p99_single_s": report["legs"]["single"]["p99_latency_s"],
        "p99_noaff_s": report["legs"]["noaff"]["p99_latency_s"],
        "p99_affinity_s": report["legs"]["affinity"]["p99_latency_s"],
        "warm_noaff": report["legs"]["noaff"]["warm_hit_ratio"],
        "warm_affinity": report["legs"]["affinity"]["warm_hit_ratio"],
        "kill_rerouted": report["legs"]["kill"]["rerouted_jobs"],
        "launches": report["launches"],
        "seconds": report["seconds"],
        "invariants": report["invariants"],
    }))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
