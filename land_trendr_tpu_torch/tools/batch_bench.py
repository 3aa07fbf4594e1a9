"""Cross-job continuous-batching bench: a flood of small jobs, packed.

Counterpart of the JAX package's ``tools/batch_bench.py``.  It replays the
fleet's dominant workload — MANY identical small-AOI segmentation jobs —
through the port's :mod:`~land_trendr_tpu_torch.loadgen` rig (closed
loop, every virtual client submits at once) against two real
:class:`~land_trendr_tpu_torch.serve.server.SegmentationServer` instances
on ``--device`` over the same synthetic stack:

* **base** — ``batch=False``: one job = one run = one pipeline;
* **batched** — ``batch=True``: the dispatcher coalesces the queued
  same-affinity jobs behind ONE shared launch and demuxes each durable
  tile into every member's own manifest.

A discarded warm-up job runs first so both legs measure warm steady state.
Every job workdir of both legs is digest-compared against one reference
(all jobs are identical, so all artifacts must be byte-identical, batched
or not).  Packing quality comes from the batched server's
``batch_launch`` / ``batch_demux`` events (jobs per launch, padded-pixel
occupancy, demuxed tiles); on the card each leg's kernel launches are
counted as well.

The exact invariants (every job done, base never batches, the flood
coalesces) decide ``ok`` on every device.  The timing verdicts
(``batched_faster``, ``p99_lower``) are reported under ``timing``: the
port's perf gate bands the speedup against the card's own record.

``--reps N`` runs N base / batched pairs in turn (each leg a fresh server)
and reports the pair of the median speedup, with every pair's speedup
beside it (``speedup_reps``).

Usage::

    python -m land_trendr_tpu_torch.tools.batch_bench [--smoke] [--reps N]
        [--out BATCH.json] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

from land_trendr_tpu_torch.ops import segment_cuda
from land_trendr_tpu_torch.runtime.driver import resolve_device
from land_trendr_tpu_torch.tools.measure import digest_workdir, record_meta, write_json_atomic

__all__ = ["main", "run_bench", "run_leg"]


class _ServerClient:
    """Loadgen client driving one server in process: submissions go through
    its real admission control; every accepted job id is kept."""

    def __init__(self, server) -> None:
        self._server = server
        self.job_ids: "list[str]" = []
        self._lock = threading.Lock()

    def submit(self, payload: dict) -> "tuple[str | None, str | None]":
        from land_trendr_tpu_torch.serve.server import Rejection

        try:
            snap = self._server.submit(payload, source="loadgen")
        except Rejection as e:
            return None, e.reason
        with self._lock:
            self.job_ids.append(snap["job_id"])
        return snap["job_id"], None

    def status(self, job_id: str) -> "str | None":
        snap = self._server.job_status(job_id)
        return None if snap is None else snap.get("state")


def _batch_events(workdir: str) -> "tuple[list, list]":
    """(batch_launch records, batch_demux records) of the server's stream."""
    launches: list = []
    demuxes: list = []
    path = Path(workdir) / "events.jsonl"
    if not path.exists():
        return launches, demuxes
    with open(path) as f:
        for line in f:
            try:
                rec = json.loads(line)
            except ValueError:
                continue  # a torn tail line
            if rec.get("ev") == "batch_launch":
                launches.append(rec)
            elif rec.get("ev") == "batch_demux":
                demuxes.append(rec)
    return launches, demuxes


def _kernel_launches() -> int:
    c = segment_cuda.launch_counts()
    return c["LAUNCHES"] + c["WIDE_LAUNCHES"] + c["GLOBAL_LAUNCHES"]


def run_leg(name: str, root: str, stack_dir: str, *, tile: int, n_jobs: int, batch: bool,
            window_ms: float, device: str = "cuda") -> dict:
    """One flood: ``n_jobs`` identical small jobs, closed loop with
    ``n_jobs`` virtual clients, drained to terminal."""
    from land_trendr_tpu_torch.fleet.capacity import percentile
    from land_trendr_tpu_torch.loadgen import LoadConfig, LoadRunner
    from land_trendr_tpu_torch.serve import SegmentationServer, ServeConfig

    cfg = ServeConfig(
        workdir=str(Path(root) / name),
        serve_port=0,
        max_jobs=n_jobs,
        # the whole flood must queue at once for the dispatcher to see it
        tenant_max_inflight=n_jobs,
        feed_cache_mb=64,
        batch=batch,
        batch_window_ms=window_ms,
    )
    server = SegmentationServer(cfg, device=device)
    client = _ServerClient(server)

    def payload_fn(req) -> dict:
        # one small-AOI preset for the whole flood: identical affinity keys
        return {"stack_dir": stack_dir, "tile_size": tile,
                "params": {"max_segments": 4, "vertex_count_overshoot": 2},
                "tenant": req.tenant, "trace_id": req.trace_id}

    runner = LoadRunner(
        LoadConfig(mode="closed", duration_s=900.0, requests=n_jobs, workers=n_jobs, seed=18,
                   tenants=2, timeout_s=600.0),
        client, payload_fn)
    box: dict = {}
    errors: list = []

    def drive() -> None:
        try:
            box["report"] = runner.run(phase=name)
        except Exception as e:  # surfaces in the report, fails the bench
            errors.append(f"{type(e).__name__}: {e}")
            server.stop()

    k0 = _kernel_launches()
    t = threading.Thread(target=drive, name=f"batch-bench-{name}")
    t.start()
    # let the flood queue before the first pop (both legs pay the same beat)
    time.sleep(0.1)
    server.serve_forever()  # drains the flood, then shuts down
    t.join(timeout=60)
    if errors:
        raise RuntimeError(f"bench client failed: {errors[0]}")
    rep = box["report"]
    kernel_launches = _kernel_launches() - k0
    # a fresh server's first job of a key pays one warm-up launch
    program_misses = server.programs.stats()["misses"]

    workdirs = []
    for job_id in client.job_ids:
        snap = server.job_status(job_id)
        if snap is None or snap["state"] != "done":
            raise RuntimeError(f"{name}: job {job_id} ended "
                               f"{None if snap is None else snap.get('state')}: "
                               f"{None if snap is None else snap.get('error')}")
        workdirs.append(snap["workdir"])

    launches, demuxes = _batch_events(cfg.workdir)
    lat = sorted(o.latency_s for o in rep.outcomes if o.latency_s)
    coalesced = sum(r["jobs"] for r in launches)
    leg = {
        "batch": batch,
        "jobs": n_jobs,
        "done": rep.done,
        "failed": rep.failed,
        "rejected": rep.rejected,
        "wall_s": round(rep.wall_s, 4),
        "throughput_jobs_s": round(rep.done / rep.wall_s, 4) if rep.wall_s else None,
        "p50_s": round(percentile(lat, 50.0), 4) if lat else None,
        "p99_s": round(percentile(lat, 99.0), 4) if lat else None,
        # a flood of a dozen jobs holds no p99: its slowest job is read instead
        "max_s": round(lat[-1], 4) if lat else None,
        "launches": len(launches),
        "jobs_coalesced": coalesced,
        "jobs_per_launch": round(coalesced / len(launches), 2) if launches else None,
        "occupancy": round(sum(r["occupancy"] for r in launches) / len(launches), 4)
        if launches else None,
        "demuxed_tiles": sum(r["tiles"] for r in demuxes),
        "kernel_launches": kernel_launches,
        "program_misses": program_misses,
    }
    return {"leg": leg, "workdirs": workdirs}


def _speedup(b: dict, p: dict) -> "float | None":
    return (round(p["throughput_jobs_s"] / b["throughput_jobs_s"], 2)
            if b["throughput_jobs_s"] and p["throughput_jobs_s"] else None)


def run_bench(size: int, years: int, tile: int, n_jobs: int, window_ms: float, root: str,
              device: str = "cuda", reps: int = 1) -> dict:
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack_c2

    stack_dir = str(Path(root) / "stack")
    write_stack_c2(stack_dir, make_stack(SceneSpec(
        width=size, height=size, year_start=2000, year_end=2000 + years - 1, seed=18)))
    kw = dict(tile=tile, window_ms=window_ms, device=device)
    warmup = run_leg("warmup", root, stack_dir, n_jobs=1, batch=False, **kw)
    # ``reps`` base / batched pairs in turn, each leg a fresh server
    pairs = []
    for rep in range(reps):
        sfx = f"_{rep}" if reps > 1 else ""
        pairs.append((run_leg(f"base{sfx}", root, stack_dir, n_jobs=n_jobs, batch=False, **kw),
                      run_leg(f"batched{sfx}", root, stack_dir, n_jobs=n_jobs, batch=True, **kw)))

    # every job of every leg matches one non-empty reference
    reference = digest_workdir(pairs[0][0]["workdirs"][0])
    parity_ok = bool(reference) and all(
        digest_workdir(wd) == reference
        for pair in pairs for leg in pair for wd in leg["workdirs"])
    tiles_per_job = ((size + tile - 1) // tile) ** 2

    def pair_invariants(b: dict, p: dict) -> dict:
        inv = {
            "all_done": b["done"] == n_jobs and p["done"] == n_jobs
            and b["failed"] == p["failed"] == 0 and b["rejected"] == p["rejected"] == 0,
            "base_never_batches": b["launches"] == 0,
            "batched_coalesces": p["launches"] >= 1 and (p["jobs_per_launch"] or 0) > 1,
        }
        if device == "cuda":
            # base: one launch a tile a job, plus each program-cache miss's
            # warm-up launch; batched: fewer, shared ones
            inv["launch_arithmetic"] = (
                b["kernel_launches"] == n_jobs * tiles_per_job + b["program_misses"]
                and p["kernel_launches"] < b["kernel_launches"])
        return inv

    every = [pair_invariants(b["leg"], p["leg"]) for b, p in pairs]
    invariants = {k: all(inv[k] for inv in every) for k in every[0]}
    speedups = [_speedup(b["leg"], p["leg"]) for b, p in pairs]
    # the pair of the median speedup stands for the run; every pair's is kept
    mid = sorted(range(reps), key=lambda i: speedups[i] or 0.0)[reps // 2]
    b, p = pairs[mid][0]["leg"], pairs[mid][1]["leg"]
    speedup = speedups[mid]
    return {
        "schema": "lt-batch-bench-v1",
        "workload": {"scene_px": size * size, "years": years, "tile_size": tile,
                     "tiles_per_job": tiles_per_job, "jobs": n_jobs,
                     "batch_window_ms": window_ms, "mode": "closed",
                     "warmup_s": warmup["leg"]["wall_s"]},
        "base": b,
        "batched": p,
        "speedup_batched": speedup,
        "reps": reps,
        "speedup_reps": speedups,
        "capacity": {"base_knee_qps_est": b["throughput_jobs_s"],
                     "batched_knee_qps_est": p["throughput_jobs_s"], "knee_shift_x": speedup},
        "invariants": invariants,
        "timing": {
            "batched_faster": (speedup or 0) > 1.0,
            "p99_lower": b["p99_s"] is not None and p["p99_s"] is not None
            and p["p99_s"] < b["p99_s"],
        },
        "parity_ok": parity_ok,
    }


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="seconds-scale mode (tiny flood)")
    ap.add_argument("--size", type=int, default=None,
                    help="scene edge px (default: 96 smoke / 128 full)")
    ap.add_argument("--years", type=int, default=None,
                    help="stack years (default: 12 smoke / 16 full)")
    ap.add_argument("--tile", type=int, default=None, help="tile size (default: 32)")
    ap.add_argument("--jobs", type=int, default=None,
                    help="flood size (default: 8 smoke / 12 full)")
    ap.add_argument("--window-ms", type=float, default=None,
                    help="batch window (default: 150 smoke / 300 full)")
    ap.add_argument("--reps", type=int, default=1,
                    help="base / batched pairs; the median speedup's pair is reported")
    ap.add_argument("--keep", default=None, metavar="DIR", help="keep the workdirs under DIR")
    ap.add_argument("--out", default=None, metavar="FILE", help="write the JSON report here")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device).type
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    size = args.size or (96 if args.smoke else 128)
    years = args.years or (12 if args.smoke else 16)
    tile = args.tile or 32
    n_jobs = args.jobs or (8 if args.smoke else 12)
    window_ms = args.window_ms or (150.0 if args.smoke else 300.0)
    root = args.keep or tempfile.mkdtemp(prefix="lt_batch_bench_")
    Path(root).mkdir(parents=True, exist_ok=True)
    try:
        report = run_bench(size, years, tile, n_jobs, window_ms, root, device=device,
                           reps=max(1, args.reps))
    finally:
        if args.keep is None:
            shutil.rmtree(root, ignore_errors=True)
    report = {**record_meta("land_trendr_tpu_torch.tools.batch_bench", argv, device), **report}
    report["smoke"] = bool(args.smoke)
    report["ok"] = report["parity_ok"] and all(report["invariants"].values())
    if args.out:
        write_json_atomic(args.out, report, trailing_newline=False)
        print(f"wrote {args.out}")
    print(json.dumps({
        "ok": report["ok"],
        "base_jobs_s": report["base"]["throughput_jobs_s"],
        "batched_jobs_s": report["batched"]["throughput_jobs_s"],
        "speedup_batched": report["speedup_batched"],
        "speedup_reps": report["speedup_reps"],
        "slowest_job_s": [report["base"]["max_s"], report["batched"]["max_s"]],
        "jobs_per_launch": report["batched"]["jobs_per_launch"],
        "occupancy": report["batched"]["occupancy"],
        "invariants": report["invariants"],
        "timing": report["timing"],
        "parity_ok": report["parity_ok"],
    }))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
