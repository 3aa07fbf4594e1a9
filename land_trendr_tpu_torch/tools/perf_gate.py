"""The port's perf-regression gate: bench smokes against the card's records.

Counterpart of the JAX package's ``tools/perf_gate.py``, leg for leg.  It
runs the port's bench smokes on ``--device`` in a temp dir and checks each
result two ways:

* **exact** checks run on every device: parity flags true, one packed
  transfer a tile, the warm store's decode skipped, zero kernel loads and
  program-cache misses on a warm job, schema-valid dumps and streams,
  blame sums, byte-identical artifacts, launch arithmetic, zero lost
  jobs, and the committed records' own verdicts (the joint-parameter
  parity record exact on every pixel, the capacity curve's schema);
* **bands** — ratios and times — derive from the card's records of record
  under ``land_trendr_tpu_torch/tools/records/`` (``*_h100.json``, made by
  the full benches on an H100 and committed with the card's name, power
  limit and command) by the JAX gate's own rules: a smoke ratio must reach
  :data:`RATIO_BAND` of the recorded one and never less than
  :data:`SPEEDUP_FLOOR`; host-side throughput floors and overhead ceilings
  are the JAX gate's constants.  Bands are checked only with ``--device
  cuda``; with ``--device cpu`` each is listed as ``"n/a (bands are the
  H100's)"`` — stated, never silent — so the CPU gate carries no timing
  verdict.  Where the card's own record is under the JAX gate's speedup
  floor (packed fetch and upload, the batched flood on the H100) no band
  is derived: the row reads ``"finding": true`` with the record beside it
  (PERF.md §6, ROADMAP §2b), and only the exact checks stand.

Legs: feed, fetch, upload + ingest store, serve, batch, trace, reqtrace,
fleet telemetry, tune, capacity, recovery, the elastic scheduler and the
fleet router (both minutes-scale: ``--skip-scheduler`` / ``--skip-router``,
or ``--scheduler-report`` / ``--router-report`` / ``--capacity-report`` to
check the reports of ``elastic_soak`` / ``fleet_bench`` / ``capacity_bench``
runs already made instead of running them again), flight, and the
committed parity record.  The flight leg (ring + sampler overhead) runs
first of the timed legs, and on the card at :data:`FLIGHT_GATE_REPS`
alternating reps instead of the smoke's 2.  The serve leg runs its bench in
a process of its own, as its record was taken, so that the cold job is
the process's first and pays the kernel library's load.  The
JAX gate's lint leg runs the JAX package's ``tools/lt_lint.py``; this gate
does not run it — ``tests/test_torch_lint.py`` drives ``lintkit`` over
the port in tier-1 — and its report says so.
The caller may pass value lints for the event streams (``lint_extra``, a
factory of a per-record hook, as the tests do); the gate itself checks the
schema.

Exit 0 = every check met, 1 = a failed check (listed), 2 = usage/IO error.

Usage::

    python -m land_trendr_tpu_torch.tools.perf_gate [--device cuda|cpu] [--json]
        [--skip-scheduler] [--skip-router] [--keep DIR]
        [--scheduler-report ELASTIC.json] [--router-report FLEET.json]
        [--capacity-report CAPACITY_SMOKE.json]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

from land_trendr_tpu_torch.runtime.driver import resolve_device

__all__ = [
    "BAND_NA",
    "Gate",
    "RECORDS",
    "RECORD_FILES",
    "main",
    "run_capacity_leg",
    "run_fleet_leg",
    "run_gate",
    "run_recovery_leg",
    "run_reqtrace_leg",
    "run_trace_leg",
]

#: the card's records of record: the baselines the bands derive from
RECORDS = Path(__file__).resolve().parent / "records"
#: record key → file name under the records directory
RECORD_FILES = {
    "feed": "FEED_h100.json",
    "fetch": "FETCH_h100.json",
    "upload": "UPLOAD_h100.json",
    "serve": "SERVE_h100.json",
    "flight": "FLIGHT_h100.json",
    "batch": "BATCH_h100.json",
    "capacity": "CAPACITY_h100.json",
    "parity": "PARITY_PARAMS_h100.json",
}

#: a smoke ratio must reach this fraction of its recorded value
RATIO_BAND = 1 / 3
#: speedup floor even when the band would dip below it (1.0 = off)
SPEEDUP_FLOOR = 1.15
#: batched-launch padded-pixel occupancy floor (the flood tiles evenly)
BATCH_OCCUPANCY_FLOOR = 0.9
#: alternating off/on reps of the flight leg on the card: on an NVIDIA
#: H100 80GB HBM3 at 700 W with 8 host cores a rep's wall (~0.3 s) varies
#: 6-20%, so the min of 2 or even 10 reps crossed the 10% band from a
#: cost near 1%; the min of 40 (~26 s of runs) read -3.1 to 10.37% over
#: seven whole smokes, where other phases had shared the host before, so
#: the leg takes the min of 60 (~39 s; PERF.md §6)
FLIGHT_GATE_REPS = 60
#: admission-journal commit bound, min-of-reps milliseconds an append
JOURNAL_APPEND_MAX_MS = 5.0
#: what a band reads on a device without the card's records
BAND_NA = "n/a (bands are the H100's)"
#: the pixels of the committed joint-parameter record (both seed bases)
PARITY_PIXELS = 32_768
#: why the lint leg is not a leg here
LINT_NOTE = ("not run by this gate: tools/lt_lint.py is the JAX package's; "
             "tests/test_torch_lint.py drives lintkit over the port in tier-1")


class Gate:
    """The check rows of one gate run on ``device``."""

    def __init__(self, device: str, lint_extra=None) -> None:
        self.device = device
        self.lint_extra = lint_extra
        self.checks: "list[dict]" = []

    def record(self, key: str) -> dict:
        """The card's record ``key`` (:data:`RECORD_FILES`)."""
        return _load(RECORDS / RECORD_FILES[key])

    def exact(self, name: str, ok: bool, detail: str) -> None:
        """A structural check: decided on every device."""
        self.checks.append({"check": name, "kind": "exact", "ok": bool(ok), "detail": detail})

    def band(self, name: str, ok: bool, detail: str) -> None:
        """A ratio or time band: decided on the card only."""
        if self.device == "cuda":
            self.checks.append({"check": name, "kind": "band", "ok": bool(ok), "detail": detail})
        else:
            self.checks.append({"check": name, "kind": "band", "ok": None, "detail": BAND_NA,
                                "measured": detail})

    def ratio(self, name: str, got: "float | None", recorded: float, what: str) -> None:
        """A speedup band from the card's record: ``got`` must reach
        max(:data:`SPEEDUP_FLOOR`, :data:`RATIO_BAND` x ``recorded``).  Where
        the card's own record is under the floor there is no band to derive
        (none is invented): the row says so and is a finding, not a pass."""
        band = max(SPEEDUP_FLOOR, recorded * RATIO_BAND)
        detail = f"smoke {what} {got} vs band {band:.2f} (the card's record {recorded})"
        if self.device == "cuda" and recorded < SPEEDUP_FLOOR:
            self.checks.append({
                "check": name, "kind": "band", "ok": None, "finding": True,
                "detail": f"no band: the card's record {recorded} is under the JAX gate's "
                f"floor {SPEEDUP_FLOOR} (a finding: PERF.md §6, ROADMAP §2b); smoke {what} "
                f"{got}",
            })
            return
        self.band(name, got is not None and got >= band, detail)

    def lint(self, path: str) -> "list[str]":
        from land_trendr_tpu_torch.obs.events import validate_events_file

        return validate_events_file(path, extra=self.lint_extra() if self.lint_extra else None)

    @property
    def failed(self) -> "list[dict]":
        return [c for c in self.checks if c["ok"] is False]


def _hit_rate(stats: dict) -> "float | None":
    lookups = stats.get("hits", 0) + stats.get("misses", 0)
    return stats.get("hits", 0) / lookups if lookups else None


def _load(path: Path) -> dict:
    return json.loads(path.read_text())


def _smoke(gate: Gate, name: str, main_fn, out: str, *extra: str) -> "dict | None":
    """Run one bench's ``main([--smoke, --out, --device, *extra])``; its
    report, or None after a ``<name>.ran`` failure row."""
    try:
        # the benches print their own reports; the gate's stdout is its verdict
        with contextlib.redirect_stdout(io.StringIO()):
            rc = main_fn(["--smoke", "--out", out, "--device", gate.device, *extra])
    except Exception as e:  # a crashed bench is the gate's finding
        gate.exact(f"{name}.ran", False, f"{name} --smoke raised {type(e).__name__}: {e}")
        return None
    if rc not in (0, 1) or not Path(out).exists():
        gate.exact(f"{name}.ran", False, f"{name} --smoke exited {rc}")
        return None
    return json.loads(Path(out).read_text())


def _smoke_process(gate: Gate, name: str, module: str, out: str) -> "dict | None":
    """:func:`_smoke` for a bench whose cold leg must be its process's
    first work: ``python -m module --smoke --out --device`` in a child
    process; its report, or None after a ``<name>.ran`` failure row."""
    from land_trendr_tpu_torch.tools.measure import child_env

    try:
        r = subprocess.run([sys.executable, "-m", module, "--smoke", "--out", out,
                            "--device", gate.device],
                           env=child_env(), capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired:
        gate.exact(f"{name}.ran", False, f"{name} --smoke ran past 600 s")
        return None
    if r.returncode not in (0, 1) or not Path(out).exists():
        gate.exact(f"{name}.ran", False,
                   f"{name} --smoke exited {r.returncode}: {r.stderr.strip()[-500:]}")
        return None
    return json.loads(Path(out).read_text())


# -- trace leg ---------------------------------------------------------------
#: synthetic pod shape (~7 events a tile a host) and the assembler floor
#: (an order of magnitude under a cold measurement: it fails an
#: accidentally-quadratic fold, not a loaded host)
TRACE_TILES_PER_HOST = 400
TRACE_HOSTS = 2
TRACE_SKEW_S = 1800.5
TRACE_MIN_EVENTS_PER_S = 5_000


def _write_jsonl(path: str, recs: list) -> None:
    with open(path, "w") as f:
        for r in recs:
            f.write(json.dumps(r, separators=(",", ":")) + "\n")


def _synth_pod_stream(path: str, pidx: int, anchor_wall: float, anchor_mono: float,
                      tiles: range, straggle_last: bool) -> int:
    """One schema-valid host event stream (spans + lifecycle a tile, one
    straggler on the lagging host); returns the event count."""
    recs: list = []

    def ev(evname: str, dt: float, **fields) -> None:
        recs.append({"ev": evname, "t_wall": round(anchor_wall + dt, 6),
                     "t_mono": round(anchor_mono + dt, 6), **fields})

    ev("run_start", 0.0, schema=1, fingerprint="perfgate-trace", pid=1000 + pidx,
       host=f"gate-host-{pidx}", process_index=pidx, process_count=TRACE_HOSTS,
       tiles_total=len(tiles) * TRACE_HOSTS, tiles_todo=len(tiles), tiles_skipped_resume=0,
       mesh_devices=1, impl="cuda", run_id=f"gatetrace{pidx:03d}", anchor_wall=anchor_wall,
       anchor_mono=anchor_mono)
    t = 0.05
    for n, tile in enumerate(tiles):
        slow = straggle_last and n == len(tiles) - 1
        compute_s = 0.25 if slow else 0.01
        ev("span", t + 0.002, name="feed", tile_id=tile, start=round(anchor_mono + t, 6),
           end=round(anchor_mono + t + 0.002, 6))
        ev("tile_start", t + 0.003, tile_id=tile, attempt=1)
        ev("span", t + 0.004, name="upload", tile_id=tile,
           start=round(anchor_mono + t + 0.003, 6), end=round(anchor_mono + t + 0.004, 6),
           attempt=1)
        done = t + 0.004 + compute_s
        ev("tile_done", done, tile_id=tile, px=400, compute_s=compute_s,
           px_per_s=round(400 / compute_s, 1), feed_backlog=1, write_backlog=0)
        ev("span", done + 0.001, name="fetch", tile_id=tile, start=round(anchor_mono + done, 6),
           end=round(anchor_mono + done + 0.001, 6))
        ev("write_done", done + 0.004, tile_id=tile, bytes=1024, record_s=0.003)
        if slow:
            ev("tile_straggler", done + 0.004, tile_id=tile, duration_s=compute_s,
               threshold_s=0.05, median_s=0.01, in_flight=False)
        t = done + 0.005
    ev("run_done", t, status="ok", tiles_done=len(tiles), pixels=400 * len(tiles),
       wall_s=round(t, 4), px_per_s=round(400 * len(tiles) / t, 1), fit_rate=0.8)
    _write_jsonl(path, recs)
    return len(recs)


def run_trace_leg(workdir: str, gate: Gate) -> None:
    """Pod-trace assembly: two skewed-clock host streams lint clean,
    assemble into one offset-corrected monotone trace with the straggler and
    the critical path folded, and export a well-formed Chrome trace
    (``lt_trace``); the assembler's throughput is a band."""
    from land_trendr_tpu_torch.obs.spans import assemble_pod_trace
    from land_trendr_tpu_torch.tools import lt_trace

    paths: list = []
    n_events = 0
    for pidx in range(TRACE_HOSTS):
        p = str(Path(workdir) / f"gate_trace.p{pidx}.events.jsonl")
        n_events += _synth_pod_stream(
            p, pidx, anchor_wall=1.7e9 + pidx * TRACE_SKEW_S, anchor_mono=100.0 + pidx * 7000.0,
            tiles=range(pidx * TRACE_TILES_PER_HOST, (pidx + 1) * TRACE_TILES_PER_HOST),
            straggle_last=pidx == TRACE_HOSTS - 1)
        paths.append(p)
    errs = [e for p in paths for e in gate.lint(p)]
    gate.exact("trace.streams_schema_valid", not errs,
               f"{n_events} synthetic events lint clean ({errs[:2]})")
    t0 = time.perf_counter()
    trace = assemble_pod_trace(paths)
    assemble_s = time.perf_counter() - t0
    t0s = [s["t0"] for s in trace["spans"]]
    skew = trace["hosts"][-1].get("wall_skew_s")
    gate.exact("trace.assembled",
               len(trace["hosts"]) == TRACE_HOSTS and len(trace["spans"]) > 0
               and trace["malformed"] == 0,
               f"{len(trace['spans'])} spans from {TRACE_HOSTS} hosts")
    # causality against the generator's known timeline: every tile's stages
    # in pipeline order, every span inside the synthetic run's envelope
    order = ("feed", "upload", "compute", "fetch", "write")
    by_tile: dict = {}
    for s in trace["spans"]:
        if s["name"] in order:
            by_tile.setdefault((s["file"], s["tile"]), {})[s["name"]] = s["t0"]
    complete = [s for s in by_tile.values() if len(s) == len(order)]
    pipeline_ok = len(complete) == TRACE_HOSTS * TRACE_TILES_PER_HOST and all(
        tuple(sorted(st, key=st.get)) == order for st in complete)
    t_env = max((s["t0"] + s["dur"] for s in trace["spans"]), default=-1.0)
    gate.exact("trace.monotone", t0s == sorted(t0s) and pipeline_ok and 0.0 <= t_env < 60.0,
               f"per-tile stages in pipeline order across {len(by_tile)} tiles, all spans in "
               f"the run envelope (max end {t_env:.3f}s)")
    gate.exact("trace.skew_corrected",
               skew is not None and abs(skew - TRACE_SKEW_S) < 1.0
               and min(t0s, default=float("inf")) < 1.0,
               f"reported wall skew {skew}s (injected {TRACE_SKEW_S}s)")
    gate.exact("trace.straggler_folded",
               trace["pod"]["stragglers"] == 1 and trace["pod"].get("critical_path") is not None,
               f"pod stragglers={trace['pod']['stragglers']}, critical path bound="
               f"{(trace['pod'].get('critical_path') or {}).get('bound_stage')}")
    ev_per_s = n_events / assemble_s if assemble_s > 0 else float("inf")
    gate.band("trace.overhead", ev_per_s >= TRACE_MIN_EVENTS_PER_S,
              f"assembled {n_events} events in {assemble_s:.3f}s ({ev_per_s:,.0f} ev/s vs "
              f"floor {TRACE_MIN_EVENTS_PER_S:,})")
    chrome_out = str(Path(workdir) / "gate_pod_trace.json")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = lt_trace.main([*paths, "--trace", chrome_out])
    ok_chrome = False
    if rc == 0 and Path(chrome_out).exists():
        xs = [e for e in _load(Path(chrome_out)).get("traceEvents", []) if e.get("ph") == "X"]
        ok_chrome = bool(xs) and all(e["ts"] >= 0 for e in xs)
    gate.exact("trace.chrome_export", ok_chrome, f"lt_trace rc={rc}, slices well-formed")


# -- reqtrace leg ------------------------------------------------------------
REQTRACE_TRACES = 40
REQTRACE_TILES = 20
REQTRACE_MIN_EVENTS_PER_S = TRACE_MIN_EVENTS_PER_S


def _synth_reqtrace_streams(workdir: str) -> "tuple[list[str], str]":
    """A router + replica + run stream set: REQTRACE_TRACES requests, the
    LAST one re-routed (two forward hops, the first ok=false), every
    trace's run scope stamped with its id; ``(paths, re-routed trace_id)``."""
    aw, am = 1.75e9, 500.0
    rt, sv, rn = [], [], []

    def ev(recs, evname, dt, **fields):
        recs.append({"ev": evname, "t_wall": round(aw + dt, 6), "t_mono": round(am + dt, 6),
                     **fields})

    def rs(recs, fp, **extra):
        ev(recs, "run_start", extra.pop("dt", 0.0), schema=1, fingerprint=fp, pid=7000,
           host="gate-fleet", process_index=0, process_count=1, tiles_total=0, tiles_todo=0,
           tiles_skipped_resume=0, mesh_devices=1, impl=fp, run_id=f"gatereq{fp}",
           anchor_wall=aw, anchor_mono=am, **extra)

    def span(recs, tid, jid, name, t0, t1, at, **extra):
        ev(recs, "request_span", at, trace_id=tid, job_id=jid, name=name,
           start=round(am + t0, 6), end=round(am + t1, 6), **extra)

    rs(rt, "route")
    rs(sv, "serve")
    rerouted_id = ""
    t = 1.0
    for i in range(REQTRACE_TRACES):
        tid = f"gatetrace{i:04d}aaaa"
        jid = f"rt-7000-{i:05d}"
        sjid = f"job-7000-{i:05d}"
        two_hop = i == REQTRACE_TRACES - 1
        if two_hop:
            rerouted_id = tid
        ev(rt, "job_submitted", t, job_id=jid, trace_id=tid, tenant="agency", priority=0,
           queue_depth=1, source="http")
        span(rt, tid, jid, "route_queue", t, t + 0.01, t + 0.01)
        span(rt, tid, jid, "forward", t + 0.01, t + 0.02, t + 0.02, replica="r0", attempt=1,
             ok=not two_hop)
        fwd, rq = 0.01, 0.01
        if two_hop:
            span(rt, tid, jid, "route_queue", t + 0.02, t + 0.04, t + 0.04)
            span(rt, tid, jid, "forward", t + 0.04, t + 0.05, t + 0.05, replica="r1",
                 attempt=2, ok=True)
            fwd += 0.01
            rq += 0.02
        ev(rt, "route_decision", t + 0.05, job_id=jid, trace_id=tid, tenant="agency",
           replica="r1" if two_hop else "r0", warm=not two_hop, key="gatekey00000000",
           attempt=2 if two_hop else 1)
        ev(sv, "job_submitted", t + 0.06, job_id=sjid, trace_id=tid, tenant="agency",
           priority=0, queue_depth=1, source="http")
        ev(sv, "job_start", t + 0.08, job_id=sjid, trace_id=tid, tenant="agency", wait_s=0.02)
        ev(sv, "job_done", t + 0.48, job_id=sjid, trace_id=tid, status="done", wall_s=0.42)
        span(rt, tid, jid, "relay", t + 0.49, t + 0.5, t + 0.5,
             replica="r1" if two_hop else "r0")
        lat = 0.5
        blame = {"route_queue": round(rq, 6), "forward": round(fwd, 6), "relay": 0.01}
        blame["replica"] = round(lat - sum(blame.values()), 6)
        ev(rt, "request_done", t + lat, trace_id=tid, job_id=jid, status="done",
           latency_s=lat, tenant="agency", hops=2 if two_hop else 1, blame=blame)
        ev(rt, "job_done", t + lat, job_id=jid, trace_id=tid, status="done", wall_s=lat)
        # the pinned run scope: a fresh scope a trace in ONE file
        rs(rn, "cuda", dt=t + 0.1, job_id=sjid, trace_id=tid)
        tt = t + 0.1
        for tile in range(REQTRACE_TILES):
            stamp = {"job_id": sjid, "trace_id": tid}
            ev(rn, "span", tt + 0.002, name="feed", tile_id=tile, start=round(am + tt, 6),
               end=round(am + tt + 0.002, 6), **stamp)
            ev(rn, "tile_start", tt + 0.003, tile_id=tile, attempt=1, **stamp)
            ev(rn, "tile_done", tt + 0.015, tile_id=tile, px=400, compute_s=0.012,
               px_per_s=33333.3, feed_backlog=0, write_backlog=0, **stamp)
            ev(rn, "write_done", tt + 0.017, tile_id=tile, bytes=1024, record_s=0.002, **stamp)
            tt += 0.018
        ev(rn, "run_done", t + 0.47, status="ok", tiles_done=REQTRACE_TILES,
           pixels=400 * REQTRACE_TILES, wall_s=0.37, px_per_s=21621.6, fit_rate=0.8,
           job_id=sjid, trace_id=tid)
        t += 0.6
    paths = []
    for fname, recs in (("gate_req_router.events.jsonl", rt),
                        ("gate_req_serve.events.jsonl", sv),
                        ("gate_req_run.events.jsonl", rn)):
        p = str(Path(workdir) / fname)
        _write_jsonl(p, recs)
        paths.append(p)
    return paths, rerouted_id


def run_reqtrace_leg(workdir: str, gate: Gate, noise_band_pct: "float | None" = None) -> None:
    """Request tracing: the synthetic fleet streams lint clean, the
    re-routed request assembles as ONE trace with two forward hops, the
    blame partition sums to the router-observed latency exactly, and a
    histogram exemplar resolves to a complete trace.  Bands: the assembler's
    throughput, and trace stamping's emit cost inside the flight record's
    noise band (``noise_band_pct``)."""
    from land_trendr_tpu_torch.obs.events import EventLog
    from land_trendr_tpu_torch.obs.metrics import MetricsRegistry
    from land_trendr_tpu_torch.obs.reqtrace import assemble_request

    paths, rerouted_id = _synth_reqtrace_streams(workdir)
    n_events = sum(sum(1 for _ in open(p)) for p in paths)
    errs = [e for p in paths for e in gate.lint(p)]
    gate.exact("reqtrace.streams_schema_valid", not errs,
               f"{n_events} synthetic fleet events lint clean ({errs[:2]})")
    t0 = time.perf_counter()
    rec = assemble_request(paths, rerouted_id)
    assemble_s = time.perf_counter() - t0
    hops = rec.get("hops", [])
    gate.exact("reqtrace.two_hop_structure",
               rec.get("complete") is True and len(hops) == 2 and hops[0].get("ok") is False
               and hops[1].get("ok") is True and hops[0].get("replica") != hops[1].get("replica"),
               f"re-routed trace {rerouted_id}: {len(hops)} hop(s) "
               f"{[h.get('replica') for h in hops]}, complete={rec.get('complete')}")
    gate.exact("reqtrace.blame_sums_exact",
               rec.get("latency_s") is not None
               and abs(rec["blame_sum_s"] - rec["latency_s"]) <= 1e-3
               and all(v >= 0 for v in rec["blame"].values()),
               f"blame {rec.get('blame')} sums to {rec.get('blame_sum_s')} vs latency "
               f"{rec.get('latency_s')}")
    comps = set(rec.get("blame", {}))
    gate.exact("reqtrace.blame_components_cross_layer",
               {"forward", "route_queue", "replica_queue", "compute"} <= comps,
               f"components span router AND replica layers: {sorted(comps)}")
    ev_per_s = n_events / assemble_s if assemble_s > 0 else float("inf")
    gate.band("reqtrace.assembler_throughput", ev_per_s >= REQTRACE_MIN_EVENTS_PER_S,
              f"assembled across {n_events} events in {assemble_s:.3f}s ({ev_per_s:,.0f} ev/s "
              f"vs floor {REQTRACE_MIN_EVENTS_PER_S:,})")
    reg = MetricsRegistry()
    hist = reg.histogram("lt_gate_req_seconds", "g", buckets=(0.1, 1.0, 10.0))
    for i in range(REQTRACE_TRACES):
        hist.observe(0.5, exemplar=f"gatetrace{i:04d}aaaa")
    hist.observe(5.0, exemplar=rerouted_id)  # the tail bucket
    ex = {e["name"]: e["exemplars"] for e in reg.exemplars()}
    tail = (ex.get("lt_gate_req_seconds") or {}).get("10.0") or []
    resolved = assemble_request(paths, tail[-1]["trace_id"]) if tail else {}
    gate.exact("reqtrace.exemplar_resolves_to_trace",
               bool(tail) and resolved.get("complete") is True,
               f"tail-bucket exemplar {tail[-1]['trace_id'] if tail else None} assembles to a "
               "complete cross-layer trace")
    # stamp overhead: interleaved plain/stamped reps, min-of-reps cost
    reps, n_emit = 5, 3000
    stamp = {"job_id": "job-1-00001", "trace_id": "gatetrace0000aaaa"}
    costs: "dict[str, list[float]]" = {"plain": [], "stamped": []}
    for r in range(reps):
        for label, common in (("plain", None), ("stamped", stamp)):
            log = EventLog(str(Path(workdir) / f"stamp_{label}_{r}.jsonl"), common=common)
            t0 = time.perf_counter()
            for i in range(n_emit):
                log.emit("tile_done", tile_id=i, px=400, compute_s=0.012, px_per_s=33333.3,
                         feed_backlog=1, write_backlog=0)
            costs[label].append(time.perf_counter() - t0)
            log.close()
    delta_us = max(0.0, (min(costs["stamped"]) - min(costs["plain"])) / n_emit * 1e6)
    # the run-level claim: ~7 events a tile, judged against a fast 10 ms tile
    per_tile_pct = 100.0 * (delta_us * 1e-6 * 7) / 0.010
    band = noise_band_pct if noise_band_pct is not None else float("nan")
    gate.band("reqtrace.stamp_overhead", per_tile_pct <= band,
              f"trace stamping adds {delta_us:.1f}us/emit — {per_tile_pct:.2f}% of a 10 ms tile "
              f"at ~7 events/tile, vs the flight record's noise band {band}%")


# -- fleet telemetry leg -----------------------------------------------------
FLEET_HOSTS = 16
FLEET_MIN_FOLDS_PER_S = 20.0
FLEET_PUBLISH_MAX_MIN_S = 0.05


def _synth_fleet_snaps(directory: str, now: float) -> dict:
    """FLEET_HOSTS snapshots with known sums, one stale host, one torn
    file; the expected aggregates."""
    import os

    from land_trendr_tpu_torch.obs.publish import SNAP_SCHEMA

    tiles_sum = 0
    hist_count = 0
    for i in range(FLEET_HOSTS):
        tiles = 10 * (i + 1)
        tiles_sum += tiles
        hist_count += 3
        stale = i == FLEET_HOSTS - 1
        snap = {
            "schema": SNAP_SCHEMA, "kind": "run", "host": f"fleet-host-{i:02d}", "pid": 1000 + i,
            "generation": 1, "seq": 5, "t_wall": now - (3600.0 if stale else 1.0),
            "uptime_s": 60.0, "interval_s": 5.0,
            "metrics": [
                {"name": "lt_tiles_done_total", "kind": "counter", "help": "t", "labels": {},
                 "value": float(tiles)},
                {"name": "lt_feed_backlog", "kind": "gauge", "help": "b", "labels": {},
                 "value": 2.0},
                {"name": "lt_slo_burn_rate", "kind": "gauge", "help": "br", "labels": {},
                 "value": 0.01 * i},
                {"name": "lt_tile_compute_seconds", "kind": "histogram", "help": "c",
                 "labels": {}, "sum": 3.0, "count": 3, "bounds": [0.1, 1.0, 10.0],
                 "buckets": [1, 1, 1, 0]},
            ],
            "state": {"progress": {"phase": "pipeline", "tiles_done": tiles}},
        }
        p = os.path.join(directory, f"fleet-host-{i:02d}.1000.snap.json")
        # synthetic aggregator fixtures beside a deliberately torn sibling:
        # plain writes on purpose
        with open(p, "w") as f:  # lt: noqa[LT012]
            f.write(json.dumps(snap, separators=(",", ":")))
        # staleness is judged on the fresher of t_wall and the file's mtime
        os.utime(p, (snap["t_wall"], snap["t_wall"]))
    # lt: noqa[LT012] — the torn snapshot IS the fixture
    with open(os.path.join(directory, "torn-host.999.snap.json"), "w") as f:
        f.write('{"schema": 1, "host": "torn-host", "pid": 999, "t_wa')
    return {"tiles_sum": float(tiles_sum), "backlog_sum": 2.0 * FLEET_HOSTS,
            "burn_max": 0.01 * (FLEET_HOSTS - 1), "hist_count": hist_count}


def run_fleet_leg(workdir: str, gate: Gate) -> None:
    """Fleet telemetry: the pod fold's counters equal the per-host sums,
    gauges follow the merge policy, the stale host and the torn snapshot
    are flagged, two folds render byte-identical exposition, and a scripted
    history drives a firing → resolved alert deterministically.  Bands:
    fold throughput and the publisher's min-of-reps snapshot cost."""
    from land_trendr_tpu_torch.obs import aggregate
    from land_trendr_tpu_torch.obs.alerts import AlertEngine, AlertRule
    from land_trendr_tpu_torch.obs.metrics import MetricsRegistry
    from land_trendr_tpu_torch.obs.publish import TelemetryPublisher

    snap_dir = Path(workdir) / "fleet_snaps"
    snap_dir.mkdir(parents=True, exist_ok=True)
    now = 1.8e9
    expect = _synth_fleet_snaps(str(snap_dir), now)
    view = aggregate.fold_dir(str(snap_dir), now=now)
    by_name = {m["name"]: m for m in view["metrics"] if not m.get("labels")}
    tiles = by_name.get("lt_tiles_done_total", {}).get("value")
    gate.exact("fleet.counters_sum_exact", tiles == expect["tiles_sum"],
               f"pod lt_tiles_done_total {tiles} == per-host sum {expect['tiles_sum']}")
    gate.exact("fleet.gauge_policy",
               by_name.get("lt_feed_backlog", {}).get("value") == expect["backlog_sum"]
               and abs((by_name.get("lt_slo_burn_rate", {}).get("value") or 0)
                       - expect["burn_max"]) < 1e-9,
               f"backlog sums to {expect['backlog_sum']}, burn rate takes the pod max "
               f"{expect['burn_max']}")
    hist = by_name.get("lt_tile_compute_seconds", {})
    gate.exact("fleet.histogram_merge",
               hist.get("count") == expect["hist_count"]
               and hist.get("buckets") == [FLEET_HOSTS, FLEET_HOSTS, FLEET_HOSTS, 0],
               f"merged histogram count {hist.get('count')} buckets {hist.get('buckets')}")
    counts = view["counts"]
    gate.exact("fleet.staleness_flagged",
               counts["stale"] == 1 and counts["corrupt"] == 1 and counts["folded"] == FLEET_HOSTS
               and len(view["hosts"]) == FLEET_HOSTS + 1,
               f"{counts['stale']} stale + {counts['corrupt']} torn flagged, all "
               f"{FLEET_HOSTS + 1} files listed")
    prom_a = aggregate.render_prom(view)
    prom_b = aggregate.render_prom(aggregate.fold_dir(str(snap_dir), now=now))
    gate.exact("fleet.byte_stable", prom_a == prom_b and len(prom_a) > 0,
               f"two independent folds render identical exposition ({len(prom_a)} bytes)")
    reps = 20
    t0 = time.perf_counter()
    for _ in range(reps):
        aggregate.fold_dir(str(snap_dir), now=now)
    folds_per_s = reps / (time.perf_counter() - t0)
    gate.band("fleet.aggregator_throughput", folds_per_s >= FLEET_MIN_FOLDS_PER_S,
              f"{folds_per_s:,.0f} folds/s of a {FLEET_HOSTS}-host set vs floor "
              f"{FLEET_MIN_FOLDS_PER_S:,.0f}")
    rule = AlertRule(name="gate_queue", kind="threshold", metric="q", op=">", value=5.0,
                     for_s=2.0, hold_down_s=3.0)

    def script() -> list:
        eng = AlertEngine((rule,))
        out = []
        for t in range(20):
            q = 10.0 if 4 <= t < 9 else 0.0
            for tr in eng.evaluate([{"t": float(t), "metrics": {"q": q}}], float(t)):
                out.append((t, tr["state"], tr["duration_s"]))
        return out

    run1, run2 = script(), script()
    gate.exact("fleet.alert_deterministic",
               run1 == run2 and [(t, s) for t, s, _ in run1] == [(6, "firing"), (12, "resolved")]
               and all(d >= 0 for _, _, d in run1),
               f"scripted history replays to identical transitions: {run1}")
    reg = MetricsRegistry()
    for i in range(40):
        reg.counter(f"lt_gate_counter_{i}", "g").inc(i)
        reg.gauge(f"lt_gate_gauge_{i}", "g").set(i)
    for i in range(8):
        reg.histogram(f"lt_gate_hist_{i}", "g").observe(0.5)
    pub = TelemetryPublisher(str(Path(workdir) / "fleet_pub"), reg, interval_s=5.0,
                             host="gate-pub")
    costs = []
    for _ in range(10):
        t0 = time.perf_counter()
        pub.publish_now()
        costs.append(time.perf_counter() - t0)
    gate.band("fleet.publisher_overhead", min(costs) <= FLEET_PUBLISH_MAX_MIN_S,
              f"min-of-reps publish {min(costs) * 1e3:.2f}ms vs ceiling "
              f"{FLEET_PUBLISH_MAX_MIN_S * 1e3:.0f}ms")


# -- capacity leg ------------------------------------------------------------
CAPACITY_SCRIPT_SEED = 23
CAPACITY_SCRIPT_EVENTS = 1500
CAPACITY_MIN_SPEEDUP_X = 100.0


def run_capacity_leg(workdir: str, gate: Gate, record: dict,
                     smoke_report: "dict | None" = None) -> None:
    """Capacity planner: a seeded scripted decision history replays
    byte-identically through fresh pure machines, a tampered copy is
    caught, and the card's committed curve (``record``) passes the report
    schema with >= 3 replica counts, a named knee blame a curve and a
    matching live replay; ``smoke_report`` (a ``capacity_bench --smoke``
    run already made) must meet its own invariants.  Band: the replay's
    speedup over its recorded span."""
    from land_trendr_tpu_torch.fleet.capacity import (
        replay_decisions,
        validate_report,
        write_scripted_history,
    )
    from land_trendr_tpu_torch.obs.reqtrace import BLAME_PRIORITY

    hist = str(Path(workdir) / "capacity_scripted.decisions.jsonl")
    script = write_scripted_history(hist, seed=CAPACITY_SCRIPT_SEED,
                                    events=CAPACITY_SCRIPT_EVENTS)
    rep = replay_decisions(hist)
    gate.exact("capacity.scripted_replay_match", rep.match and rep.mismatch_seq is None,
               f"{rep.matched}/{rep.decisions} decisions replayed byte-identically over a "
               f"{script['span_s']:.1f}s span")
    gate.band("capacity.replay_throughput", rep.match and rep.speedup_x >= CAPACITY_MIN_SPEEDUP_X,
              f"replayed a {rep.recorded_span_s:.1f}s span in {rep.replay_wall_s * 1e3:.1f}ms "
              f"({rep.speedup_x:,.0f}x vs floor {CAPACITY_MIN_SPEEDUP_X:.0f}x)")
    tampered = str(Path(workdir) / "capacity_tampered.decisions.jsonl")
    lines = Path(hist).read_text().splitlines()
    flipped = False
    for i, line in enumerate(lines):
        rec = json.loads(line)
        if rec.get("kind") == "pick":
            rec["job_id"] = rec["job_id"] + "-tampered"
            lines[i] = json.dumps(rec, sort_keys=True)
            flipped = True
            break
    Path(tampered).write_text("\n".join(lines) + "\n")
    trep = replay_decisions(tampered) if flipped else None
    gate.exact("capacity.tamper_detected",
               flipped and trep is not None and not trep.match and trep.mismatch_seq is not None
               and trep.mismatch is not None and trep.mismatch["kind"] == "pick",
               f"one flipped pick caught at seq {trep.mismatch_seq if trep else None}")
    errs = validate_report(record)
    curves = record.get("curves") or []
    counts = sorted(c.get("replicas") for c in curves if isinstance(c, dict))
    gate.exact("capacity.curve_schema",
               not errs and len(counts) >= 3 and len(set(counts)) == len(counts)
               and record.get("device") == "cuda" and not record.get("smoke"),
               f"the card's curve ({RECORD_FILES['capacity']}) valid for replica counts {counts} "
               f"({errs[:2]})")
    vocab = (*BLAME_PRIORITY, "other")
    knees = [next((p.get("knee_blame") for p in c.get("points", []) if p.get("knee")), None)
             for c in curves]
    gate.exact("capacity.knees_named", bool(knees) and all(b in vocab for b in knees),
               f"every committed curve names its knee blame: {knees}")
    crep = record.get("replay") or {}
    srep = record.get("scripted_replay") or {}
    gate.exact("capacity.committed_replay_stands",
               crep.get("match") is True and srep.get("match") is True,
               f"committed live replay {crep.get('matched')}/{crep.get('decisions')} matched; "
               f"scripted match {srep.get('match')}")
    if smoke_report is not None:
        inv = smoke_report.get("invariants", {})
        gate.exact("capacity.smoke_invariants", smoke_report.get("ok") is True
                   and bool(inv) and all(inv.values()),
                   f"capacity_bench --smoke invariants {inv}")


# -- recovery leg ------------------------------------------------------------
def run_recovery_leg(workdir: str, gate: Gate) -> None:
    """Crash-safe control plane: the admission journal folds byte-stably
    across close/reopen, compaction never drops a live job, a torn tail is
    dropped without losing a committed record, and a router recovered from
    a fabricated crash journal requeues its in-flight job and finishes it
    byte-identical to a clean routed run (one in-process replica on
    ``gate.device``).  Band: the min-of-reps journal append."""
    from land_trendr_tpu_torch.fleet import FleetRouter, RouterConfig
    from land_trendr_tpu_torch.fleet.journal import AdmissionJournal
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack
    from land_trendr_tpu_torch.serve import SegmentationServer, ServeConfig
    from land_trendr_tpu_torch.tools.measure import digest_workdir

    jroot = str(Path(workdir) / "recovery_journal")
    j = AdmissionJournal(jroot, segment_bytes=64 * 1024)
    for i in range(300):
        jid = f"j{i:04d}"
        j.append("admitted", jid, payload={"n": i}, t=float(i))
        j.append("forwarded", jid, replica_base="http://127.0.0.1:9", replica_job_id=jid)
        if i < 250:
            j.append("terminal", jid, state="done", t=float(i))
    first = j.replay()
    j.close()
    j = AdmissionJournal(jroot, segment_bytes=64 * 1024)
    second = j.replay()
    gate.exact("recovery.replay_stable",
               json.dumps(first, sort_keys=True) == json.dumps(second, sort_keys=True),
               f"{len(second)} folded job(s) identical across close/reopen")
    live = {jid for jid, st in second.items() if st["status"] != "terminal"}
    dropped = j.compact()
    after = j.replay()
    gate.exact("recovery.compaction_safe",
               live <= set(after) and all(after[jid]["status"] != "terminal" for jid in live),
               f"{dropped} fully-terminal segment(s) dropped; all {len(live)} live job(s) kept")
    j.close()
    segs = sorted(Path(jroot).glob("seg-*.jsonl"))
    with open(segs[-1], "ab") as f:
        f.write(b'{"rec":"admitted","job_id":"torn-')  # a mid-crash tear
    j = AdmissionJournal(jroot, segment_bytes=64 * 1024)
    third = j.replay()
    gate.exact("recovery.torn_tail_dropped",
               json.dumps(after, sort_keys=True) == json.dumps(third, sort_keys=True)
               and "torn-" not in third,
               "half-written final line dropped at reopen, committed records untouched")
    reps = []
    for _ in range(5):
        t0 = time.perf_counter()
        for i in range(50):
            j.append("terminal", f"bench{i}", state="done", t=0.0)
        reps.append((time.perf_counter() - t0) / 50)
    j.close()
    per_ms = min(reps) * 1e3
    gate.band("recovery.append_overhead", per_ms < JOURNAL_APPEND_MAX_MS,
              f"min-of-reps journal append {per_ms:.3f}ms vs {JOURNAL_APPEND_MAX_MS}ms bound")

    stack_dir = str(Path(workdir) / "recovery_stack")
    write_stack(stack_dir, make_stack(SceneSpec(width=48, height=40, year_start=1990,
                                                year_end=2013, seed=11)))
    job = {"stack_dir": stack_dir, "tile_size": 20,
           "params": {"max_segments": 4, "vertex_count_overshoot": 2},
           "run_overrides": {"retry_backoff_s": 0.0}}
    server = SegmentationServer(ServeConfig(workdir=str(Path(workdir) / "recovery_replica"),
                                            feed_cache_mb=64), device=gate.device)
    srv_thread = threading.Thread(target=server.serve_forever, name="gate-recovery-replica")
    srv_thread.start()

    def routed(rt_dir: str, submit: "dict | None", jid: "str | None"):
        router = FleetRouter(RouterConfig(workdir=rt_dir,
                                          replicas=(f"http://127.0.0.1:{server.port}",),
                                          health_interval_s=0.2))
        rt_thread = threading.Thread(target=router.serve_forever, name="gate-recovery-router")
        rt_thread.start()
        try:
            if submit is not None:
                jid = router.submit(submit)["job_id"]
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline:
                s = router.job_status(jid)
                if s["state"] not in ("queued", "routed"):
                    break
                time.sleep(0.1)
            return s, router.recovery
        finally:
            router.stop()
            rt_thread.join(timeout=300)

    try:
        clean_s, _ = routed(str(Path(workdir) / "recovery_router_clean"), dict(job), None)
        rt_crash = Path(workdir) / "recovery_router_crash"
        jwd = str(Path(workdir) / "recovery_job_wd")
        jid = "rt-0-00001"
        payload = {**job, "workdir": jwd, "out_dir": jwd + "_o"}
        (rt_crash / "journal").mkdir(parents=True)
        (rt_crash / "journal" / "seg-00000001.jsonl").write_text(
            json.dumps({"rec": "admitted", "job_id": jid, "payload": payload, "tenant": "gate",
                        "priority": 0, "key": "gate-key", "trace_id": "gaterecover00001",
                        "workdir": jwd, "out_dir": jwd + "_o", "source": "http", "t": 0.0})
            + "\n" + json.dumps({"rec": "forwarded", "job_id": jid,
                                 "replica_base": "http://127.0.0.1:9",
                                 "replica_job_id": "gone-1", "t": 0.0}) + "\n")
        rec_s, recovery = routed(str(rt_crash), None, jid)
    finally:
        server.stop()
        srv_thread.join(timeout=120)
    gate.exact("recovery.replayed_job_completes",
               clean_s["state"] == "done" and rec_s["state"] == "done" and recovery is not None
               and recovery.get("replayed") == 1 and recovery.get("requeued") == 1,
               f"clean {clean_s['state']}, recovered {rec_s['state']} (recovery {recovery})")
    d_rec = digest_workdir(jwd)
    gate.exact("recovery.artifact_parity",
               clean_s["state"] == "done" and rec_s["state"] == "done"
               and digest_workdir(clean_s["workdir"]) == d_rec and len(d_rec) > 0,
               "recovered job's artifacts byte-identical to the clean routed run")


# -- scheduler and router legs ----------------------------------------------
def run_scheduler_leg(workdir: str, gate: Gate, report: "dict | None" = None) -> None:
    """Elastic scheduler: a slow-host two-process pod, static split against
    the lease queue with speculation (``elastic_soak``'s slow-host leg, or
    the ``slow_host`` part of a soak ``report`` already made).  Exact: no
    lost tile, no double-counted done id, a speculative win.  Bands: the
    idle gap and the host imbalance collapse against static."""
    if report is None:
        from land_trendr_tpu_torch.tools import elastic_soak

        try:
            res = elastic_soak.slow_host_leg(Path(workdir) / "scheduler", device=gate.device,
                                             verbose=False)
        except AssertionError as e:  # the leg's own invariants ARE findings
            gate.exact("scheduler.invariants", False, str(e))
            return
        except Exception as e:
            gate.exact("scheduler.ran", False, f"slow-host pod soak raised: {e}")
            return
    else:
        res = report["slow_host"]
    n_tiles = res["scene"]["tiles"]
    st, el = res["static"], res["elastic"]
    for mode, r in (("static", st), ("elastic", el)):
        gate.exact(f"scheduler.{mode}_no_lost_tiles", r["unique_done_tiles"] == n_tiles,
                   f"{r['unique_done_tiles']} unique done tiles of {n_tiles}")
    gate.exact("scheduler.no_double_count",
               el["duplicate_done_records"] <= el["tiles_speculated"] + el["tiles_stolen"],
               f"{el['duplicate_done_records']} duplicate done record(s) vs "
               f"{el['tiles_speculated']} speculated + {el['tiles_stolen']} stolen")
    gate.exact("scheduler.speculative_win", el["spec_wins"] >= 1,
               f"{el['spec_wins']} speculative win(s), {el['tiles_speculated']} speculated")
    gate.band("scheduler.idle_gap_collapse", el["idle_gap_pod_s"] < st["idle_gap_pod_s"],
              f"pod idle gap {el['idle_gap_pod_s']}s elastic vs {st['idle_gap_pod_s']}s static")
    gate.band("scheduler.imbalance_collapse",
              bool(st["host_imbalance"] and el["host_imbalance"]
                   and el["host_imbalance"] < st["host_imbalance"]),
              f"host_imbalance {el['host_imbalance']} elastic vs {st['host_imbalance']} static")


def run_router_leg(workdir: str, gate: Gate, report: "dict | None" = None) -> None:
    """Serving-fleet router (``fleet_bench --smoke``, or its ``report``
    already made): affinity's warm-hit ratio above no-affinity, zero lost
    jobs across a replica SIGKILL, byte-identical artifacts across legs."""
    if report is None:
        from land_trendr_tpu_torch.tools import fleet_bench

        report = _smoke(gate, "router", fleet_bench.main, str(Path(workdir) / "fleet.json"))
        if report is None:
            return
    legs = report.get("legs", {})
    inv = report.get("invariants", {})
    aff, noaff, kill = legs.get("affinity", {}), legs.get("noaff", {}), legs.get("kill", {})
    gate.exact("router.warm_affinity_above_baseline",
               inv.get("affinity_warm_above_noaff") is True,
               f"warm-hit ratio {aff.get('warm_hit_ratio')} (affinity) vs "
               f"{noaff.get('warm_hit_ratio')} (no-affinity)")
    gate.exact("router.zero_lost_jobs_across_kill", inv.get("zero_lost_jobs_across_kill") is True,
               f"replica {kill.get('killed_replica')} SIGKILLed: {kill.get('lost_jobs')} lost, "
               f"{kill.get('rerouted_jobs')} re-routed")
    gate.exact("router.parity_across_legs", inv.get("parity_across_legs") is True,
               "same-spec artifacts byte-identical across single/noaff/affinity/kill")
    gate.exact("router.no_leg_lost_jobs", inv.get("no_leg_lost_jobs") is True,
               f"p99 latency: single {legs.get('single', {}).get('p99_latency_s')}s, no-affinity "
               f"{noaff.get('p99_latency_s')}s, affinity {aff.get('p99_latency_s')}s")
    if gate.device == "cuda":
        gate.exact("router.replicas_launched_kernels",
                   inv.get("replicas_launched_kernels") is True,
                   f"replica launches {report.get('launches')}")


# -- the gate ----------------------------------------------------------------
def run_gate(workdir: str, gate: Gate, scheduler: bool = True, router: bool = True,
             scheduler_report: "dict | None" = None, router_report: "dict | None" = None,
             capacity_report: "dict | None" = None) -> None:
    """Every leg (module doc) into ``gate``'s rows."""
    from land_trendr_tpu_torch.tools import (
        batch_bench,
        feed_bench,
        fetch_bench,
        flight_overhead,
        tune_bench,
        upload_bench,
    )

    wd = Path(workdir)
    cuda = gate.device == "cuda"

    # -- the committed joint-parameter parity record --------------------
    par = gate.record("parity")
    gate.exact("parity.paramspace_record",
               par.get("device") == "cuda" and par.get("pixels_total") == PARITY_PIXELS
               and par.get("exact") == PARITY_PIXELS
               and sorted(par.get("seed_bases", [])) == [1000, 2000]
               and par.get("forms_bit_identical_trials") == par.get("trials")
               and par.get("plain_bit_identical_trials") == par.get("trials"),
               f"{RECORD_FILES['parity']}: {par.get('exact')}/{par.get('pixels_total')} px exact vs "
               f"the oracle, forms identical on {par.get('forms_bit_identical_trials')}/"
               f"{par.get('trials')} trials, f32 = plain on "
               f"{par.get('plain_bit_identical_trials')} ({par.get('nvidia_smi')})")

    # -- flight recorder (ring + sampler overhead) ------------------------
    # first of the timed legs: its band is a few percent of a ~0.3 s run,
    # so it runs before any later leg's replicas, servers or threads share
    # the host with it; on the card at FLIGHT_GATE_REPS alternating reps
    flight_base = gate.record("flight")
    try:
        got = flight_overhead.run_bench(smoke=True, out_path=str(wd / "flight.json"),
                                        device=gate.device, lint_extra=gate.lint_extra,
                                        reps=FLIGHT_GATE_REPS if cuda else None)
    except Exception as e:
        gate.exact("flight.ran", False, f"flight_overhead raised: {e}")
    else:
        fl = got.get("flight", {})
        gate.exact("flight.dump_valid", fl.get("dump_valid") is True,
                   f"flight.jsonl schema-valid ({fl.get('dump_errors')})")
        gate.exact("flight.sampler_fired", fl.get("samples", 0) >= 1,
                   f"{fl.get('samples', 0)} flight_sample events in the dump")
        band = float(flight_base["noise_band_pct"])
        gate.band("flight.overhead", got["overhead_min_pct"] <= band,
                  f"min-of-{got['reps']} overhead {got['overhead_min_pct']}% (median "
                  f"{got['overhead_pct']}%) vs the noise band {band}% (the card's record "
                  f"{flight_base['overhead_min_pct']}%, min-of-{flight_base['reps']})")

    # -- feed (RAM decode cache) ------------------------------------------
    got = _smoke(gate, "feed", feed_bench.main, str(wd / "feed.json"))
    if got is not None:
        base = gate.record("feed")
        gate.exact("feed.parity", got.get("parity_ok") is True, "cached reads byte-identical")
        gate.exact("feed.cache_hits", got["cache_stats"].get("hits", 0) > 0,
                   "the cache served at least one revisit")
        base_hr = _hit_rate(base["cache_stats"]) or 0.0
        got_hr = _hit_rate(got["cache_stats"]) or 0.0
        gate.band("feed.hit_rate", got_hr >= base_hr * 0.5,
                  f"smoke hit rate {got_hr:.3f} vs band {base_hr * 0.5:.3f} (the card's record "
                  f"{base_hr:.3f})")

    # -- fetch (packed device→host) ---------------------------------------
    got = _smoke(gate, "fetch", fetch_bench.main, str(wd / "fetch.json"))
    if got is not None:
        base = gate.record("fetch")
        gate.exact("fetch.parity", got["parity"]["ok"] is True, "packed ≡ per-product")
        gate.exact("fetch.transfers_per_tile", got["workload"]["transfers_per_tile_packed"] == 1,
                   f"packed fetch is one transfer a tile "
                   f"({got['workload']['transfers_per_tile_per_product']} per-product)")
        gate.ratio("fetch.speedup", max(got["speedup_packed_sync"], got["speedup_packed_async"]),
                   base["speedup_packed_sync"], "packed/per-product speedup")

    # -- upload (packed host→device) + ingest store -----------------------
    got = _smoke(gate, "upload", upload_bench.main, str(wd / "upload.json"))
    if got is not None:
        base = gate.record("upload")
        gate.exact("upload.parity", got["parity"]["ok"] is True, "unpacked ≡ fed arrays")
        gate.exact("upload.transfers_per_tile", got["workload"]["transfers_per_tile_packed"] == 1,
                   f"packed upload is one transfer a tile "
                   f"({got['workload']['transfers_per_tile_per_array']} per-array)")
        gate.ratio("upload.speedup", max(got["speedup_packed_sync"], got["speedup_packed_async"]),
                   base["speedup_packed_sync"], "packed/per-array speedup")
        store = got.get("ingest_store")
        if store is None:
            gate.exact("store.ran", False, "the smoke skipped the ingest-store phase")
        else:
            gate.exact("store.parity", store["parity_ok"] is True,
                       "store-served window reads byte-identical")
            for leg in ("store_warm", "store_restart"):
                gate.exact(f"store.{leg}_decode_skipped",
                           store[leg]["stats"]["misses"] == 0
                           and store[leg]["hit_rate"] is not None
                           and store[leg]["hit_rate"] >= 0.99,
                           f"{leg}: hit rate {store[leg]['hit_rate']} with "
                           f"{store[leg]['stats']['misses']} misses")

    # -- serve (warm program cache + shared ingest store) -----------------
    # its own process, as the record was taken: the flight leg has loaded the
    # kernel library here, and a cold job in a process that has served before
    # pays only its program-cache miss and decode, which at the smoke's
    # 64² x 7 years is within the jobs' noise (PERF.md §6)
    got = _smoke_process(gate, "serve", "land_trendr_tpu_torch.tools.serve_bench",
                         str(wd / "serve.json"))
    if got is not None:
        base = gate.record("serve")
        inv = got["invariants"]
        gate.exact("serve.parity", got["parity_ok"] is True, "warm job artifacts ≡ cold job's")
        gate.exact("serve.warm_zero_compiles", inv["warm_zero_compiles"] is True,
                   f"warm program_cache {got['warm']['program_cache']}, kernel library loads "
                   f"{got['warm']['library_loads']}")
        gate.exact("serve.warm_zero_decodes", inv["warm_zero_decodes"] is True,
                   f"warm ingest_store {got['warm']['ingest_store']}")
        if cuda:
            gate.exact("serve.launch_arithmetic", inv.get("launch_arithmetic") is True,
                       f"cold {got['cold']['launches']} launches, warm {got['warm']['launches']} "
                       f"for {got['workload']['tiles']} tiles")
            gate.exact("serve.cold_loads_the_library",
                       got["cold"]["library_loads"] == base["cold"]["library_loads"] == 1,
                       f"cold job's kernel library loads {got['cold']['library_loads']} "
                       f"(the record's {base['cold']['library_loads']})")
        gate.ratio("serve.warm_speedup", got["speedup_warm"], base["speedup_warm"],
                   "warm speedup")

    # -- cross-job continuous batching ------------------------------------
    got = _smoke(gate, "batch", batch_bench.main, str(wd / "batch.json"))
    if got is not None:
        base = gate.record("batch")
        inv = got["invariants"]
        gate.exact("batch.parity", got["parity_ok"] is True,
                   "every job's artifacts ≡ one reference, batched or not")
        gate.exact("batch.coalesced",
                   inv["batched_coalesces"] and inv["base_never_batches"] and inv["all_done"],
                   f"{got['batched']['launches']} shared launch(es), "
                   f"{got['batched']['jobs_per_launch']} jobs/launch over "
                   f"{got['workload']['jobs']} jobs")
        if cuda:
            gate.exact("batch.launch_arithmetic", inv.get("launch_arithmetic") is True,
                       f"kernel launches base {got['base']['kernel_launches']}, batched "
                       f"{got['batched']['kernel_launches']}")
        gate.exact("batch.occupancy",
                   (got["batched"]["occupancy"] or 0) >= BATCH_OCCUPANCY_FLOOR,
                   f"padded-px occupancy {got['batched']['occupancy']} vs floor "
                   f"{BATCH_OCCUPANCY_FLOOR}")
        gate.ratio("batch.speedup", got["speedup_batched"], base["speedup_batched"],
                   "batched speedup")

    run_trace_leg(workdir, gate)
    run_reqtrace_leg(workdir, gate, noise_band_pct=float(flight_base["noise_band_pct"]))
    run_fleet_leg(workdir, gate)

    # -- autotuner --------------------------------------------------------
    got = _smoke(gate, "tune", tune_bench.main, str(wd / "tune.json"))
    if got is not None:
        inv = got.get("invariants", {})
        gate.exact("tune.profile_roundtrip_stable", inv.get("profile_roundtrip_byte_stable") is True,
                   "store save -> load -> save is byte-identical")
        gate.exact("tune.warm_zero_probes",
                   inv.get("warm_zero_probes") is True and inv.get("warm_identical_knobs") is True,
                   "second autotune served from the store: zero probes, identical knobs")
        gate.exact("tune.resolution_deterministic", inv.get("resolution_deterministic") is True,
                   "two 'auto' resolutions of one key give identical RunConfigs")
        gate.exact("tune.parity",
                   inv.get("artifacts_byte_identical") is True
                   and inv.get("run_tune_profile_event") is True,
                   "tuned run's artifacts ≡ default run's; its stream carries probes=0")
        sp = got.get("max_group_speedup")
        gate.exact("tune.group_win",
                   inv.get("tuned_never_worse_than_default") is True
                   and inv.get("all_groups_probed") is True and sp is not None and sp >= 1.0,
                   f"tuned ≥ default on every probed group (best group speedup {sp})")

    run_capacity_leg(workdir, gate, gate.record("capacity"), capacity_report)
    run_recovery_leg(workdir, gate)
    if scheduler or scheduler_report is not None:
        run_scheduler_leg(workdir, gate, scheduler_report)
    if router or router_report is not None:
        run_router_leg(workdir, gate, router_report)


def run(device: str, workdir: "str | None" = None, scheduler: bool = True, router: bool = True,
        scheduler_report: "dict | None" = None, router_report: "dict | None" = None,
        capacity_report: "dict | None" = None, lint_extra=None) -> dict:
    """One gate run; the verdict ``{"ok", "device", "checks", "lint",
    "launches", "seconds"}`` (every band row ``n/a`` off the card)."""
    missing = [n for n in RECORD_FILES.values() if not (RECORDS / n).exists()]
    if missing:
        raise FileNotFoundError(f"the card's records are missing under {RECORDS}: {missing}")
    from land_trendr_tpu_torch.ops import segment_cuda

    t0 = time.perf_counter()
    launches0 = segment_cuda.launch_counts()
    root = workdir or tempfile.mkdtemp(prefix="lt_perf_gate_")
    Path(root).mkdir(parents=True, exist_ok=True)
    gate = Gate(device, lint_extra)
    try:
        run_gate(root, gate, scheduler=scheduler, router=router,
                 scheduler_report=scheduler_report, router_report=router_report,
                 capacity_report=capacity_report)
    finally:
        if workdir is None:
            shutil.rmtree(root, ignore_errors=True)
    launches1 = segment_cuda.launch_counts()
    return {"ok": not gate.failed, "device": device, "checks": gate.checks, "lint": LINT_NOTE,
            # this process's kernel launches (spawned replicas count their own)
            "launches": {k: launches1[k] - launches0[k] for k in launches1},
            "seconds": round(time.perf_counter() - t0, 3)}


def main(argv: "list[str] | None" = None, lint_extra=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: bands checked) or cpu (exact checks only)")
    ap.add_argument("--json", action="store_true", help="print the machine-readable verdict only")
    ap.add_argument("--keep", default=None, metavar="DIR", help="keep the smoke artifacts under DIR")
    ap.add_argument("--out", default=None, metavar="FILE", help="also write the verdict here")
    ap.add_argument("--skip-scheduler", action="store_true",
                    help="skip the elastic scheduler leg (two 2-process pods, minutes-scale)")
    ap.add_argument("--skip-router", action="store_true",
                    help="skip the fleet-router leg (spawned replicas, minutes-scale)")
    ap.add_argument("--scheduler-report", default=None, metavar="FILE",
                    help="check this elastic_soak report instead of running the leg")
    ap.add_argument("--router-report", default=None, metavar="FILE",
                    help="check this fleet_bench --smoke report instead of running the leg")
    ap.add_argument("--capacity-report", default=None, metavar="FILE",
                    help="also hold this capacity_bench --smoke report to its invariants")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device).type
        reports = {k: _load(Path(p)) if p else None for k, p in (
            ("scheduler_report", args.scheduler_report),
            ("router_report", args.router_report),
            ("capacity_report", args.capacity_report))}
        verdict = run(device, args.keep, scheduler=not args.skip_scheduler,
                      router=not args.skip_router, lint_extra=lint_extra, **reports)
    except (RuntimeError, ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.out:
        from land_trendr_tpu_torch.tools.measure import write_json_atomic

        write_json_atomic(args.out, verdict)
    failed = [c for c in verdict["checks"] if c["ok"] is False]
    if args.json:
        print(json.dumps(verdict, indent=2))
    else:
        for c in verdict["checks"]:
            mark = "find" if c.get("finding") else {True: "ok  ", False: "FAIL", None: "n/a "}[c["ok"]]
            print(f"  {mark} {c['check']}: {c['detail']}")
        print(f"  lint: {verdict['lint']}")
        print(json.dumps({"ok": verdict["ok"], "device": device,
                          "checks": len(verdict["checks"]), "failed": len(failed),
                          "bands_na": sum(c["ok"] is None and not c.get("finding")
                                          for c in verdict["checks"]),
                          "findings": [c["check"] for c in verdict["checks"]
                                       if c.get("finding")],
                          "seconds": verdict["seconds"]}))
        for c in failed:
            print(f"regression: {c['check']}: {c['detail']}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
