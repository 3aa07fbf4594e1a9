"""Request-tracing bench: a fleet replay with a mid-trace replica kill.

Counterpart of the JAX package's ``tools/reqtrace_bench.py``.  It replays
a short multi-tenant job trace through a real
:class:`~land_trendr_tpu_torch.fleet.router.FleetRouter` over two spawned
port ``serve`` replicas on ``--device``, SIGKILLs the replica holding
in-flight work once its job has durable tiles, and proves from the
streams alone that

* the killed job reconstructs as **one trace with two forward hops** (the
  killed replica's and the survivor's) under one ``trace_id``;
* every terminal request's **blame components sum to its router-observed
  latency** (checked against the ``request_done`` record and the full
  cross-layer assembly, :mod:`~land_trendr_tpu_torch.obs.reqtrace`);
* the **p99 exemplar** of ``lt_router_job_seconds`` names a trace that
  assembles complete;
* artifacts stay **byte-identical** across the kill, and no job is lost.

The replicas pace their dispatches (a ``dispatch`` slow fault) so the kill
lands mid-job; on the card their kernel launches are read over
``GET /debug/kernels`` before the router stops.

Usage::

    python -m land_trendr_tpu_torch.tools.reqtrace_bench [--out REQTRACE.json]
        [--size 40 --years 7 --tile 20] [--device cuda|cpu]
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
import urllib.request
from pathlib import Path

from land_trendr_tpu_torch.obs.reqtrace import assemble_request, discover_request_files
from land_trendr_tpu_torch.runtime.driver import resolve_device
from land_trendr_tpu_torch.tools.fleet_bench import _percentile
from land_trendr_tpu_torch.tools.measure import (
    digest_workdir,
    record_meta,
    replica_launches,
    write_json_atomic,
)

__all__ = ["TRACE", "main", "run_bench"]

#: the fixed replay: (tenant, big scene?) in submission order (the JAX tool's)
TRACE = [
    ("agency", False), ("agency", False), ("alerts", False),
    ("agency", True), ("research", False), ("agency", False),
    ("alerts", False), ("agency", False),
]


def _kill_victim(router, deadline: float):
    """The replica holding an in-flight job that already has durable tiles,
    and that job (the resume proof needs durable tiles)."""
    while time.monotonic() < deadline:
        with router._lock:
            for r in router.pool:
                if not (r.inflight and r.proc is not None and r.proc.poll() is None):
                    continue
                for jid in sorted(r.inflight):
                    j = router._jobs.get(jid)
                    if j is not None and list(Path(j.workdir).glob("tile_*.npz")):
                        return r, j
        time.sleep(0.05)
    raise RuntimeError("kill: no replica ever held a durable job")


def run_bench(root: Path, size: int, years: int, tile: int, device: str = "cuda") -> dict:
    from land_trendr_tpu_torch.fleet import FleetRouter, RouterConfig
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack

    scenes = {}
    for name, edge in (("small", size), ("big", size * 2)):
        d = str(root / f"stack_{name}")
        write_stack(d, make_stack(SceneSpec(width=edge, height=edge, year_start=2000,
                                            year_end=2000 + years - 1, seed=13)))
        scenes[name] = d
    rt_dir = str(root / "rt")
    router = FleetRouter(RouterConfig(
        workdir=rt_dir,
        spawn_replicas=2,
        health_interval_s=0.3,
        route_retries=3,
        # pace dispatches so the kill lands mid-job with durable tiles
        replica_args=(*(() if device == "cuda" else ("--device", device)),
                      "--feed-cache-mb", "64",
                      "--fault-schedule", "seed=5,dispatch%1.0=slow:0.3"),
    ))
    thread = threading.Thread(target=router.serve_forever, name="reqtrace-bench")
    thread.start()
    killed_rid = killed_trace = None
    submits: list = []
    try:
        deadline = time.monotonic() + 900
        for i, (tenant, big) in enumerate(TRACE):
            submits.append(router.submit({
                "stack_dir": scenes["big" if big else "small"],
                "tile_size": tile,
                "tenant": tenant,
                "params": {"max_segments": 4, "vertex_count_overshoot": 2},
                "run_overrides": {"retry_backoff_s": 0.0},
            }))
            if i == len(TRACE) // 3 and killed_rid is None:
                victim, vjob = _kill_victim(router, deadline)
                killed_rid, killed_trace = victim.rid, vjob.trace_id
                victim.proc.send_signal(signal.SIGKILL)
        pending = {s["job_id"] for s in submits}
        results: dict = {}
        while pending and time.monotonic() < deadline:
            for jid in sorted(pending):
                s = router.job_status(jid)
                if s and s["state"] not in ("queued", "routed"):
                    results[jid] = s
            pending -= set(results)
            if pending:
                time.sleep(0.1)
        if pending:
            raise TimeoutError(f"jobs never finished: {pending}")
        base = f"http://127.0.0.1:{router.port}"
        with urllib.request.urlopen(base + "/metrics/exemplars", timeout=10) as r:
            exemplars = json.loads(r.read())["exemplars"]
        with urllib.request.urlopen(base + "/debug/requests", timeout=10) as r:
            recent = json.loads(r.read())["requests"]
        launches = replica_launches(router)
    finally:
        router.stop()
        thread.join(timeout=600)

    streams = discover_request_files(rt_dir)
    states = [results[s["job_id"]] for s in submits]
    lost = [s for s in states if s["state"] != "done"]
    latencies = [r["latency_s"] for r in recent]
    killed_job = next(s for s in states if s["trace_id"] == killed_trace)
    killed_rec = assemble_request(streams, killed_trace)
    hop_replicas = [h["replica"] for h in killed_rec["hops"]]
    blame_sums_ok = all(abs(sum(r["blame"].values()) - r["latency_s"]) <= 5e-3 for r in recent)
    assembled = {s["trace_id"]: assemble_request(streams, s["trace_id"]) for s in states}
    assembly_sums_ok = all(abs(rec["blame_sum_s"] - rec["latency_s"]) <= 5e-3
                           for rec in assembled.values())
    complete_ok = all(rec["complete"] for rec in assembled.values())

    job_ex = next((e["exemplars"] for e in exemplars if e["name"] == "lt_router_job_seconds"), {})
    tail_le = max(job_ex, key=lambda le: float("inf") if le == "+Inf" else float(le),
                  default=None)
    p99_trace = job_ex[tail_le][-1]["trace_id"] if tail_le else None
    p99_rec = assembled.get(p99_trace) or (
        assemble_request(streams, p99_trace) if p99_trace else {})

    parity_ok = True
    ref: dict = {}
    for s in states:
        d = digest_workdir(s["workdir"])
        if not d:
            parity_ok = False
        elif s["key"] not in ref:
            ref[s["key"]] = d
        elif ref[s["key"]] != d:
            parity_ok = False

    totals: "dict[str, int]" = {}
    for counts in launches.values():
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    invariants = {
        "zero_lost_jobs": not lost,
        "killed_job_two_hops": (len(killed_rec["hops"]) >= 2 and hop_replicas[0] == killed_rid
                                and hop_replicas[-1] != killed_rid),
        "killed_job_one_trace": killed_job["attempts"] >= 2 and killed_rec["complete"] is True,
        "blame_sums_to_latency": bool(blame_sums_ok and assembly_sums_ok),
        "all_traces_assemble_complete": complete_ok,
        "p99_exemplar_assembles": p99_rec.get("complete") is True,
        "artifact_parity_across_kill": bool(parity_ok and ref),
    }
    if device == "cuda":
        invariants["survivor_launched_kernels"] = totals.get("LAUNCHES", 0) > 0
    return {
        "workload": {"jobs": len(TRACE), "tenants": sorted({t for t, _ in TRACE}),
                     "scene_small_px": size * size, "scene_big_px": (size * 2) ** 2,
                     "years": years, "tile_size": tile, "replicas": 2, "device": device},
        "killed_replica": killed_rid,
        "killed_trace": {
            "trace_id": killed_trace,
            "status": killed_job["state"],
            "route_attempts": killed_job["attempts"],
            "hops": killed_rec["hops"],
            "latency_s": killed_rec["latency_s"],
            "blame": killed_rec["blame"],
            "blame_sum_s": killed_rec["blame_sum_s"],
            "tiles_done": killed_rec["tiles_done"],
        },
        "p99_exemplar": {"bucket_le": tail_le, "trace_id": p99_trace,
                         "complete": p99_rec.get("complete"),
                         "latency_s": p99_rec.get("latency_s"), "blame": p99_rec.get("blame")},
        "latency": {"p50_s": _percentile(latencies, 0.50), "p99_s": _percentile(latencies, 0.99)},
        "requests_folded": len(recent),
        "streams": len(streams),
        "launches": totals,
        "invariants": invariants,
        "ok": all(invariants.values()),
    }


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=40, help="small-scene edge px (big is 2x)")
    ap.add_argument("--years", type=int, default=7)
    ap.add_argument("--tile", type=int, default=20)
    ap.add_argument("--keep", default=None, metavar="DIR", help="keep the workdirs under DIR")
    ap.add_argument("--out", default=None, metavar="FILE", help="write the JSON report here")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device).type
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    root = Path(args.keep or tempfile.mkdtemp(prefix="lt_reqtrace_"))
    root.mkdir(parents=True, exist_ok=True)
    try:
        report = run_bench(root, args.size, args.years, args.tile, device=device)
    finally:
        if args.keep is None:
            shutil.rmtree(root, ignore_errors=True)
    report = {**record_meta("land_trendr_tpu_torch.tools.reqtrace_bench", argv, device), **report}
    if args.out:
        write_json_atomic(args.out, report, trailing_newline=False)
        print(f"wrote {args.out}")
    print(json.dumps({
        "ok": report["ok"],
        "killed_replica": report["killed_replica"],
        "killed_trace_hops": [h["replica"] for h in report["killed_trace"]["hops"]],
        "p99_exemplar": report["p99_exemplar"]["trace_id"],
        "p99_s": report["latency"]["p99_s"],
        "invariants": report["invariants"],
    }))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
