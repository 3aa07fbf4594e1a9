"""Fault-injection soak: every seam fired, artifacts byte-identical.

Counterpart of the JAX package's ``tools/fault_soak.py``, the robustness
acceptance gate: for every injection seam of
:mod:`land_trendr_tpu_torch.runtime.faults`, run a seeded schedule that
fires exactly there and assert the run recovers with **byte-identical
tile artifacts** to a clean run on the same device — either in-run (retry
ladder, feed retry, cache bypass, fetch demotion) or across an abort +
resume (manifest persist faults, quarantine).  The same schedule replays
the same faults at the same invocations, so a recovery regression fails
this gate.

Tracks (all run by default; :func:`soak` takes a subset):

* **eager** (in-RAM synthetic stack): the driver seams — ``feed``,
  ``dispatch``, ``compute.wait``, ``fetch.wait`` and ``upload.wait``,
  ``manifest.record`` (ENOSPC → abort → resume), ``manifest.torn``, a
  quarantine schedule, the lease seams, the straggler observation, the
  dead-peer merge, the tuner's probe fault and the fleet-publish and
  history faults.  On the card the stack is 512² × 40 years at tile 128
  (16 tiles, so faults hit distinct tiles) with default parameters; with
  ``--device cpu`` it is the JAX soak's 48 × 40 × 24 years at tile 20.
* **serve**: the server seams (``serve.submit``, ``serve.job``,
  ``debug.profile``, ``batch.pack``, ``batch.demux``) on the JAX soak's
  48 × 40 stack written to disk.
* **router**: the fleet seams (``router.forward``, ``replica.health``,
  ``router.journal``, ``router.recover``) in process, and the
  ``loadgen.tick`` churn case over two spawned replicas (run in smoke
  mode too, so every registered seam fires).
* **lazy** (windowed C2 per-band stack): ``feed.decode``,
  ``cache.corrupt`` and ``store.corrupt``.

Full mode adds the SIGKILL cases (lease steal, batch, replica, router
restart) and, on the card, probabilistic multi-seed storms (they force the
packed fetch, which the CPU lacks), and writes a report.  The
report names the seams each case armed and saw fire, and the kernels'
launch counts of this process (a spawned replica's are read over
``GET /debug/kernels``).  Everything runs on ``--device`` (the card by
default; ``--device cpu`` for the tests).

    python -m land_trendr_tpu_torch.tools.fault_soak --smoke
    python -m land_trendr_tpu_torch.tools.fault_soak --seeds 5 --out FAULTSOAK.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

#: Every registered seam a soak case exercises, as data — the coverage
#: half of lint rule LT011's three-way cross-check: the linter
#: literal-evals this table and flags any ``runtime/faults.py`` ``SEAMS``
#: entry missing here as an uncovered seam, and any entry here that is not
#: registered as stale.  ``tests/test_torch_fault_soak.py`` pins the table
#: against the schedules the cases actually arm.
SOAK_COVERED_SEAMS = (
    "feed",                # eager feed_transient
    "feed.decode",         # lazy decode_transient
    "cache.corrupt",       # lazy cache_corrupt
    "store.corrupt",       # lazy store_corrupt
    "upload.wait",         # eager upload_wait_fault / upload_demotion
    "dispatch",            # eager dispatch_fault / quarantine
    "compute.wait",        # eager compute_wait_fault / straggler_slow
    "fetch.wait",          # eager fetch_wait_fault / fetch_demotion
    "manifest.record",     # eager manifest_enospc (abort → resume)
    "manifest.torn",       # eager manifest_torn (abort → resume)
    "lease.acquire",       # eager lease_acquire_fault
    "lease.steal",         # eager lease_forced_steal
    "lease.expire",        # eager lease_forced_steal
    "merge.peer",          # merge_peer_partial (dead-peer bounded wait)
    "serve.submit",        # serve submit_reject_and_sibling_quarantine
    "serve.job",           # serve job_fault_then_resubmit
    "debug.profile",       # serve debug_stacks_under_hang_and_profile_fault
    "obs.publish",         # fleet telemetry case (swallowed STOP flush)
    "history.append",      # fleet telemetry case (lossy ring append)
    "router.forward",      # router forward-fault re-route case
    "replica.health",      # router health-flap case
    "tune.probe",          # tune_probe_fault (degraded-profile run)
    "loadgen.tick",        # loadgen churn case
    "batch.pack",          # batch pack/demux fault case
    "batch.demux",         # batch pack/demux fault case
    "router.journal",      # journal append fault → 503, resubmit lands
    "router.recover",      # recovery probe fault → requeue + resume
)

#: the soak's tracks, in the order they run
TRACKS = ("eager", "serve", "router", "lazy")

#: seams whose host path exists only on a CUDA device: the packed
#: host→device upload (``runtime/feed.py``).  On the CPU their cases run
#: with the packed knobs left to "auto" (per-array paths) and the seam is
#: armed but cannot fire; on the card every seam must fire.
CARD_ONLY_SEAMS = ("upload.wait",)

import torch  # noqa: E402

from land_trendr_tpu_torch.tools.measure import (  # noqa: E402
    digest_workdir,
    replica_launches,
    write_json_atomic,
)

#: the repository root (the spawned processes' PYTHONPATH)
REPO = Path(__file__).resolve().parents[2]

#: the JAX soak's small model, used by its serve, router and lazy tracks
#: and by the eager track on the CPU
SMALL_PARAMS = {"max_segments": 4, "vertex_count_overshoot": 2}


@dataclasses.dataclass(frozen=True)
class EagerScene:
    """The eager track's in-RAM synthetic stack and its run shape."""

    width: int
    height: int
    year_start: int
    year_end: int
    seed: int
    tile: int
    #: ``LTParams`` overrides (empty: the defaults)
    params: dict


#: the eager track on the card: phase 7's stack of ``chip_smoke.py``
CARD_EAGER = EagerScene(512, 512, 1984, 2023, 7, 128, {})
#: the eager track on the CPU: the JAX soak's 48 x 40 x 24-year stack
CPU_EAGER = EagerScene(48, 40, 1990, 2013, 11, 20, dict(SMALL_PARAMS))


def _assert_two_hop_trace(trace_id: str, roots: list, expect_failed_first: bool) -> dict:
    """Request-tracing assertions for a re-routed job: the streams under
    ``roots`` must assemble into ONE complete trace with two forward hops
    under ``trace_id`` — the first failed (forward fault) or succeeded
    (replica killed after accepting) per ``expect_failed_first`` — and a
    blame partition that sums to the router-observed latency with the
    re-route visible in it.  Returns the assembled record."""
    from land_trendr_tpu_torch.obs.reqtrace import assemble_request
    from land_trendr_tpu_torch.tools.lt_request import expand_paths

    # the CLI's expansion: the soak scans exactly the file set an
    # operator's lt_request invocation would
    files = expand_paths([str(r) for r in roots])
    rec = assemble_request(files, trace_id)
    if not rec["complete"]:
        raise AssertionError(
            f"reqtrace: trace {trace_id} did not assemble complete from "
            f"{len(files)} stream(s): {rec}"
        )
    hops = rec["hops"]
    if expect_failed_first:
        if len(hops) != 2:
            raise AssertionError(
                f"reqtrace: expected BOTH forward hops under one trace_id, got {hops}"
            )
        if hops[0]["ok"] is not False or hops[1]["ok"] is not True:
            raise AssertionError(f"reqtrace: expected failed-then-ok hops, got {hops}")
    else:
        if len(hops) < 2:
            raise AssertionError(
                f"reqtrace: expected a re-route hop under one trace_id, got {hops}"
            )
        if hops[0]["replica"] == hops[-1]["replica"]:
            raise AssertionError(f"reqtrace: re-route landed on the SAME replica: {hops}")
    if abs(rec["blame_sum_s"] - rec["latency_s"]) > 5e-3:
        raise AssertionError(
            f"reqtrace: blame {rec['blame']} sums to {rec['blame_sum_s']} vs latency "
            f"{rec['latency_s']}"
        )
    if rec["blame"].get("forward", 0.0) <= 0:
        raise AssertionError(f"reqtrace: no forward share in the blame: {rec['blame']}")
    return rec


@dataclasses.dataclass
class Case:
    name: str
    schedule: str
    cfg_kw: dict
    #: "inrun" = must complete without raising; "resume" = first run may
    #: abort, a clean resume must complete; "quarantine" = first run
    #: completes WITH quarantined tiles, the resume finishes them
    mode: str = "inrun"


def _eager_cases(retries: int) -> "list[Case]":
    packed = {"fetch_packed": True}
    return [
        Case("feed_transient", "seed=1,feed@1=io", {}),
        Case("dispatch_fault", "seed=1,dispatch@1", {}),
        Case("compute_wait_fault", "seed=1,compute.wait@1", {}),
        Case("fetch_wait_fault", "seed=1,fetch.wait@1=io", dict(packed)),
        Case(
            "fetch_demotion",
            "seed=1,fetch.wait@0*3=io",
            {**packed, "max_retries": 4},
        ),
        # the upload mirror: an error surfacing through the packed
        # host→device wait re-enters the same ladder; repeated failures
        # demote to the per-array copies — artifacts identical
        Case("upload_wait_fault", "seed=1,upload.wait@1", {"upload_packed": True}),
        Case(
            "upload_demotion",
            "seed=1,upload.wait@0*3",
            {"upload_packed": True, "max_retries": 4},
        ),
        # elastic lease queue: the first acquisition fails at the
        # lease.acquire seam — the host logs, backs off one cycle, and
        # retries; identical artifacts (the lease log is coordination only)
        Case(
            "lease_acquire_fault",
            "seed=1,lease.acquire@0=io",
            {"lease_batch": 2, "lease_ttl_s": 10.0},
        ),
        Case("manifest_enospc", "seed=1,manifest.record@1=enospc", {}, "resume"),
        Case("manifest_torn", "seed=1,manifest.torn@1", {}, "resume"),
        Case(
            "quarantine",
            f"seed=1,dispatch@1*{retries + 1}",
            {"quarantine_tiles": True},
            "quarantine",
        ),
    ]


_LAZY_CASES = [
    Case("decode_transient", "seed=1,feed.decode@2=value", {}),
    Case("cache_corrupt", "seed=1,cache.corrupt@1", {}),
    # persistent-store corruption: the RAM tier is OFF so store-served
    # blocks are demand traffic; a poisoned one is invalidated in BOTH
    # tiers and re-decoded — byte-identical artifacts like every seam
    Case(
        "store_corrupt",
        "seed=1,store.corrupt@1",
        {"feed_cache_mb": 0, "ingest_store_mb": 64},
    ),
]


def _armed(schedule: str) -> "list[str]":
    """The seams a schedule string arms (``seam@...`` / ``seam%...``)."""
    out = []
    for spec in schedule.split(","):
        for sep in ("@", "%"):
            if sep in spec:
                out.append(spec.split(sep, 1)[0])
                break
    return out


def _error_chain_text(exc: BaseException) -> str:
    """``exc``'s message and those of the errors it wraps."""
    parts = []
    seen: set = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        parts.append(str(exc))
        exc = exc.__cause__ or exc.__context__
    return " | ".join(parts)


def _make_eager(scene: EagerScene):
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
    from land_trendr_tpu_torch.runtime import stack_from_synthetic

    spec = SceneSpec(width=scene.width, height=scene.height, year_start=scene.year_start,
                     year_end=scene.year_end, seed=scene.seed)
    return stack_from_synthetic(make_stack(spec))


def _make_lazy(root: str, size: int):
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack_c2
    from land_trendr_tpu_torch.runtime.stack import open_stack_dir_c2_lazy

    spec = SceneSpec(width=size, height=size, year_start=2000, year_end=2006, seed=7)
    write_stack_c2(root, make_stack(spec))
    return open_stack_dir_c2_lazy(root, bands=("nir", "swir2"))


def _events(path) -> "list[dict]":
    return [json.loads(line) for line in Path(path).read_text().splitlines() if line.strip()]


def soak(
    smoke: bool = True,
    seeds: int = 3,
    keep: "str | None" = None,
    verbose: bool = True,
    device: str = "cuda",
    tracks: "tuple[str, ...]" = TRACKS,
    lint_extra=None,
) -> dict:
    """Run the soak matrix; returns the report (raises on the first broken
    recovery so failures carry a full traceback).

    ``tracks`` picks a subset of :data:`TRACKS` (the tests split them
    across files); ``lint_extra`` is an optional factory of a per-record value lint hook
    for ``validate_events_file`` (the tests pass the JAX package's
    ``tools/check_events_schema.value_lints``; the port itself checks the
    schema only).
    """
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.obs.events import validate_events_file
    from land_trendr_tpu_torch.ops import segment_cuda
    from land_trendr_tpu_torch.runtime import Run, RunConfig, run_stack
    from land_trendr_tpu_torch.runtime.driver import resolve_device

    dev = resolve_device(device)
    device = dev.type
    on_card = device == "cuda"
    eager_scene = CARD_EAGER if on_card else CPU_EAGER
    unknown = set(tracks) - set(TRACKS)
    if unknown:
        raise ValueError(f"unknown soak tracks {sorted(unknown)}; known: {TRACKS}")
    retries = 2
    base_kw = dict(
        params=LTParams.from_dict(SMALL_PARAMS),
        tile_size=20,
        max_retries=retries,
        retry_backoff_s=0.0,  # the soak pins recovery, not pacing
    )
    eager_kw = {**base_kw, "params": LTParams.from_dict(eager_scene.params),
                "tile_size": eager_scene.tile}
    #: the replicas' device flag (spawned ``serve`` processes)
    device_args = () if on_card else ("--device", "cpu")
    root = Path(keep or tempfile.mkdtemp(prefix="lt_fault_soak_"))
    root.mkdir(parents=True, exist_ok=True)
    report: dict = {"smoke": smoke, "device": device,
                    "device_name": torch.cuda.get_device_name(dev) if on_card else "cpu",
                    "tracks": list(tracks), "cases": [], "track_seconds": {}}
    armed: set = set()
    fired: set = set()
    launches0 = segment_cuda.launch_counts()
    spawned_launches: dict = {}

    def _run(stack, cfg):
        return run_stack(stack, cfg, device=device)

    def _lint(path) -> list:
        return validate_events_file(str(path), extra=lint_extra() if lint_extra else None)

    def note(rec: dict, schedule: str, seen) -> None:
        """Book a case: its armed seams and the ones it saw fire."""
        rec_armed = sorted(set(_armed(schedule)))
        rec_fired = sorted(set(seen))
        missing = set(rec_armed) - set(rec_fired) - (set() if on_card else set(CARD_ONLY_SEAMS))
        if missing:
            raise AssertionError(
                f"{rec['case']}: armed seam(s) {sorted(missing)} never fired "
                f"(schedule {schedule!r}; fired {rec_fired})"
            )
        rec["seams_armed"] = rec_armed
        rec["seams_fired"] = rec_fired
        armed.update(rec_armed)
        fired.update(rec_fired)
        report["cases"].append(rec)

    def summary_seams(summary) -> "list[str]":
        return [f["seam"] for f in (summary or {}).get("faults_injected", [])]

    def run_track(track: str, stack, cases: "list[Case]", kw: dict) -> None:
        clean_wd = str(root / f"{track}_clean")
        _run(stack, RunConfig(workdir=clean_wd, out_dir=clean_wd + "_o", **kw))
        clean = digest_workdir(clean_wd)
        for case in cases:
            wd = str(root / f"{track}_{case.name}")
            case_kw = dict(case.cfg_kw)
            if not on_card:
                # the packed transfer paths exist only on a CUDA device
                for knob in ("fetch_packed", "upload_packed"):
                    case_kw.pop(knob, None)
            cfg = RunConfig(
                workdir=wd, out_dir=wd + "_o", fault_schedule=case.schedule,
                **{**kw, **case_kw},
            )
            rec = {"track": track, "case": case.name, "schedule": case.schedule}
            aborted = False
            seen: list = []
            run = Run(stack, cfg, device=device)
            try:
                summary = run.execute()
                seen += summary_seams(summary)
            except Exception as e:
                if case.mode != "resume":
                    raise
                # the abort counts only as the armed seam firing: the plan
                # logged it and the error is an injected one; anything
                # else is a foreign crash and fails the case
                plan_seams = [s for s, _, _ in run.fault_plan.injected()] if run.fault_plan else []
                fired_armed = sorted(set(plan_seams) & set(_armed(case.schedule)))
                if not fired_armed or "injected" not in _error_chain_text(e):
                    raise
                aborted = True
                rec["abort_error"] = f"{type(e).__name__}: {e}"
                seen += fired_armed
                summary = _run(
                    stack, RunConfig(workdir=wd, out_dir=wd + "_o", **{**kw, **case_kw}),
                )
            if case.mode == "quarantine":
                if not summary["tiles_quarantined"]:
                    raise AssertionError(f"{case.name}: expected quarantined tiles, got none")
                rec["quarantined"] = summary["tiles_quarantined"]
                summary = _run(stack, RunConfig(workdir=wd, out_dir=wd + "_o", **kw))
                if summary["tiles_quarantined"]:
                    raise AssertionError(f"{case.name}: resume left tiles quarantined")
            if case.mode == "resume" and not aborted:
                raise AssertionError(
                    f"{case.name}: schedule {case.schedule!r} did not abort the first "
                    "run — the seam no longer fires there"
                )
            if digest_workdir(wd) != clean:
                raise AssertionError(
                    f"{case.name}: artifacts differ from the clean run "
                    f"(schedule {case.schedule!r})"
                )
            rec["artifacts_identical"] = True
            note(rec, case.schedule, seen)
            if verbose:
                print(f"  ok: {track}/{case.name} ({case.schedule})", flush=True)

    def run_straggler_case(stack) -> None:
        """A ``slow`` fault parked on one tile's compute wait (which the
        driver polls) must surface as a ``tile_straggler`` event with
        ``duration_s`` over its ``threshold_s``, while the run completes
        with artifacts byte-identical to the clean run (a straggler is an
        observation, never a behaviour change)."""
        wd = str(root / "eager_straggler")
        cfg = RunConfig(
            workdir=wd,
            out_dir=wd + "_o",
            # invocation 4 = the 5th tile's compute wait: enough
            # completions before it to seed the rolling median, and the
            # 1 s park dwarfs k x median
            fault_schedule="seed=1,compute.wait@4=slow:1.0",
            telemetry=True,
            straggler_k=2.0,
            straggler_min_tiles=2,
            **eager_kw,
        )
        summary = _run(stack, cfg)
        stragglers = [e for e in _events(Path(wd) / "events.jsonl")
                      if e.get("ev") == "tile_straggler"]
        if not stragglers:
            raise AssertionError(
                "slow fault on compute.wait@4 produced no tile_straggler event — the "
                "detector no longer sees the parked tile"
            )
        bad = [e for e in stragglers if not e["duration_s"] >= e["threshold_s"] > 0]
        if bad:
            raise AssertionError(
                f"tile_straggler events violate duration >= threshold > 0: {bad}"
            )
        if digest_workdir(wd) != digest_workdir(str(root / "eager_clean")):
            raise AssertionError(
                "straggler run artifacts differ from the clean run — the verdict "
                "changed behaviour"
            )
        note({
            "track": "eager",
            "case": "straggler_slow",
            "schedule": cfg.fault_schedule,
            "straggler_events": len(stragglers),
            "straggler_tiles": sorted({e["tile_id"] for e in stragglers}),
            "artifacts_identical": True,
        }, cfg.fault_schedule, summary_seams(summary))
        if verbose:
            print(f"  ok: eager/straggler_slow ({cfg.fault_schedule}; "
                  f"{len(stragglers)} tile_straggler event(s))", flush=True)

    def run_lease_steal_case(stack) -> None:
        """Deterministic steal under a living owner (the ``lease.expire``
        and ``lease.steal`` seams): the workdir is pre-seeded with a LIVE
        foreign lease — a ghost owner holding tile 0 on a 1-hour TTL under
        the run's own fingerprint — so the elastic runner starts blocked
        on that tile.  ``lease.expire%1.0`` makes every blocked probe read
        it expired; the first forced steal hits ``lease.steal@0=io`` (the
        acquire raises, the host backs off and retries), and the retry
        steals for real.  One process, no resume, byte-identical."""
        wd = str(root / "eager_lease_steal")
        cfg = RunConfig(
            workdir=wd,
            out_dir=wd + "_o",
            fault_schedule="seed=1,lease.expire%1.0,lease.steal@0=io",
            lease_batch=2,
            lease_ttl_s=10.0,
            **eager_kw,
        )
        Path(wd).mkdir(parents=True, exist_ok=True)
        header = {
            "kind": "header",
            "fingerprint": cfg.fingerprint(stack),
            # must match the resuming run's execution context exactly or
            # the manifest rejects the workdir as foreign
            "context": {"mesh_devices": 1, "impl": "cuda" if on_card else "torch"},
            "run_id": "ghost-run",
        }
        ghost = {
            "kind": "lease", "tile_id": 0, "gen": 0, "owner": "ghost:1:g",
            "host": "ghost", "pid": 1, "ttl_s": 3600.0, "t_wall": time.time(),
            "mode": "claim",
        }
        # a pre-seeded fixture, not a durable artifact: the run's own
        # manifest machinery takes over the file from here
        (Path(wd) / "manifest.jsonl").write_text(  # lt: noqa[LT012]
            json.dumps(header) + "\n" + json.dumps(ghost) + "\n"
        )
        summary = _run(stack, cfg)
        seams = set(summary_seams(summary))
        if not {"lease.expire", "lease.steal"} <= seams:
            raise AssertionError(
                "lease_forced_steal: expected both lease.expire and lease.steal to "
                f"fire, got {sorted(seams)}"
            )
        if digest_workdir(wd) != digest_workdir(str(root / "eager_clean")):
            raise AssertionError("lease_forced_steal: artifacts differ from the clean run")
        note({
            "track": "eager",
            "case": "lease_forced_steal",
            "schedule": cfg.fault_schedule,
            "artifacts_identical": True,
        }, cfg.fault_schedule, seams)
        if verbose:
            print(f"  ok: eager/lease_forced_steal ({cfg.fault_schedule})", flush=True)

    def run_merge_peer_case() -> None:
        """Dead-peer merge semantics (the ``merge.peer`` seam): armed at
        probability 1.0 every tail probe reads not-terminal, so the
        primary's bounded wait expires and it returns the PARTIAL merge of
        the streams that exist — never a hang, never a crash.  Disarmed,
        the same merge resolves at once with every host terminal."""
        from land_trendr_tpu_torch.obs.events import EventLog, events_path
        from land_trendr_tpu_torch.parallel.multihost import merge_host_event_logs
        from land_trendr_tpu_torch.runtime import faults

        wd = str(root / "merge_peer")
        Path(wd).mkdir(parents=True, exist_ok=True)
        for i in range(2):
            with EventLog(events_path(wd, i, 2)) as elog:
                elog.run_start(
                    fingerprint="f" * 16, process_index=i, process_count=2,
                    tiles_total=2, tiles_todo=2, tiles_skipped_resume=0,
                    mesh_devices=1, impl="cuda" if on_card else "torch",
                )
                elog.emit("run_done", status="ok", tiles_done=1, pixels=10,
                          wall_s=0.1, px_per_s=100.0, fit_rate=1.0)
        schedule = "seed=1,merge.peer%1.0"
        plan = faults.activate(faults.parse_schedule(schedule))
        try:
            t0 = time.monotonic()
            merged = merge_host_event_logs(wd, expect_hosts=2, timeout_s=0.4, poll_s=0.05)
            waited = time.monotonic() - t0
        finally:
            faults.deactivate()
        seen = [s for s, _i, _k in plan.injected()]
        if not 0.3 < waited < 30.0:
            raise AssertionError(
                f"merge_peer_partial: expected the bounded wait to expire (~0.4s), "
                f"waited {waited:.3f}s"
            )
        if len(merged) != 2:
            raise AssertionError(
                f"merge_peer_partial: partial merge should still fold what exists "
                f"(2 streams), got {len(merged)}"
            )
        merged = merge_host_event_logs(wd, expect_hosts=2, timeout_s=5.0, poll_s=0.05)
        if [m["status"] for m in merged] != ["ok", "ok"]:
            raise AssertionError(
                f"merge_peer_partial: clean merge did not resolve both hosts terminal: "
                f"{merged}"
            )
        note({
            "track": "merge",
            "case": "merge_peer_partial",
            "schedule": schedule,
            "waited_s": round(waited, 3),
            "artifacts_identical": True,
        }, schedule, seen)
        if verbose:
            print(f"  ok: merge/merge_peer_partial (bounded wait {waited:.2f}s, "
                  "partial merge folded)", flush=True)

    def run_fleet_case(stack) -> None:
        """Fleet-telemetry failure semantics: with ``obs.publish`` armed,
        the run's START snapshot lands, the terminal STOP flush faults and
        is swallowed — byte-identical artifacts, the host reads as a stale
        snapshot.  The aggregator over the telemetry dir, with a TORN
        snapshot planted beside the real one, flags the torn host corrupt
        and folds the real one.  Then ``history.append`` over a live ring:
        the faulted append loses ONE sample, the ring reads back
        consistent and reopens clean."""
        from land_trendr_tpu_torch.obs import aggregate
        from land_trendr_tpu_torch.obs.history import HistoryRing
        from land_trendr_tpu_torch.runtime import faults

        wd = str(root / "eager_fleet")
        cfg = RunConfig(
            workdir=wd,
            out_dir=wd + "_o",
            # the START snapshot publishes before the driver arms the plan;
            # with a 60 s interval no loop beat fires, so invocation 0 is
            # exactly the terminal STOP flush
            fault_schedule="seed=1,obs.publish@0=io",
            telemetry=True,
            publish=True,
            publish_interval_s=60.0,
            **eager_kw,
        )
        summary = _run(stack, cfg)
        seen = summary_seams(summary)
        tel_dir = Path(wd) / "telemetry"
        snaps = sorted(tel_dir.glob("*.snap.json"))
        if len(snaps) != 1:
            raise AssertionError(
                f"expected exactly the start snapshot, found {[s.name for s in snaps]}"
            )
        # a torn snapshot IS the fixture: the aggregator must flag it
        # corrupt without crashing the fold — atomicity would defeat it
        # lt: noqa[LT012]
        (tel_dir / "torn-host.4242.snap.json").write_text(
            '{"schema": 1, "host": "torn-host", "pid": 4242, "t_w'
        )
        view = aggregate.fold_dir(str(tel_dir))
        if view["counts"]["corrupt"] != 1 or view["counts"]["folded"] != 1:
            raise AssertionError(
                f"aggregate must flag the torn snap and fold the real host: {view['counts']}"
            )
        tiles = [m for m in view["metrics"] if m["name"] == "lt_tiles_done_total"]
        # the surviving snapshot is the start-of-run one: its counters fold
        # at their honest pre-run value of zero
        if not tiles or tiles[0]["value"] != 0:
            raise AssertionError(f"the surviving host's counters did not fold cleanly: {tiles}")
        if digest_workdir(wd) != digest_workdir(str(root / "eager_clean")):
            raise AssertionError(
                "fleet-publish run artifacts differ from the clean run — the publisher "
                "changed behaviour"
            )
        hist_dir = str(root / "fleet_history")
        hist_schedule = "seed=1,history.append@1=io"
        plan = faults.activate(faults.parse_schedule(hist_schedule))
        try:
            ring = HistoryRing(hist_dir, samples_per_segment=4)
            lost = 0
            for i in range(6):
                try:
                    ring.append({"t": float(i), "hosts": 1, "stale_hosts": 0})
                except OSError:
                    lost += 1
            ring.close()
        finally:
            faults.deactivate()
        seen += [s for s, _i, _k in plan.injected()]
        if lost != 1:
            raise AssertionError(f"history.append@1 should cost exactly one sample, lost {lost}")
        ring2 = HistoryRing(hist_dir)
        samples, malformed = ring2.read()
        ring2.close()
        if len(samples) != 5 or malformed:
            raise AssertionError(
                f"ring after a faulted append: {len(samples)} samples (want 5), "
                f"{malformed} malformed"
            )
        note({
            "track": "eager",
            "case": "fleet_publish_and_history_faults",
            "schedule": cfg.fault_schedule,
            "torn_snap_flagged": True,
            "history_samples_lost": lost,
            "artifacts_identical": True,
        }, f"{cfg.fault_schedule},{hist_schedule}", seen)
        if verbose:
            print("  ok: eager/fleet_publish_and_history_faults "
                  f"({cfg.fault_schedule} + {hist_schedule})", flush=True)

    def run_tune_case(stack) -> None:
        """Autotuner probe-failure semantics (the ``tune.probe`` seam): an
        injected probe failure skips THAT knob group — its knobs fall back
        to defaults and the ``tune_probe`` event carries ``ok=false`` —
        while the other groups probe normally, the stream stays
        schema-clean, and a run resolving its "auto" knobs through the
        resulting profile completes with byte-identical artifacts."""
        from land_trendr_tpu_torch.obs import Telemetry
        from land_trendr_tpu_torch.obs.events import iter_events
        from land_trendr_tpu_torch.runtime import faults
        from land_trendr_tpu_torch.tune import KNOB_DEFAULTS, autotune
        from land_trendr_tpu_torch.tune.probes import PROBE_GROUPS

        store_dir = str(root / "tune_store")
        tw = str(root / "tune_events")
        schedule = "seed=1,tune.probe@0"
        plan = faults.activate(faults.parse_schedule(schedule))
        try:
            telemetry = Telemetry(tw, fingerprint="tune")
            try:
                telemetry.run_start(
                    fingerprint="tune", process_index=0, process_count=1,
                    tiles_total=0, tiles_todo=0, tiles_skipped_resume=0,
                    mesh_devices=1, impl="tune",
                )
                h, w = stack.shape
                profile = autotune(
                    store_dir, height=h, width=w, n_years=stack.n_years, device=device,
                    smoke=True, reps=1, telemetry=telemetry,
                )
                telemetry.run_done("ok", tiles_done=0, pixels=0, wall_s=0.0,
                                   px_per_s=0.0, fit_rate=0.0)
            finally:
                telemetry.close()
        finally:
            faults.deactivate()
        seen = [s for s, _i, _k in plan.injected()]
        if seen != ["tune.probe"]:
            raise AssertionError(f"tune.probe seam did not fire exactly once: {plan.injected()}")
        skipped = [g for g, r in profile["groups"].items() if not r["ok"]]
        if len(skipped) != 1:
            raise AssertionError(
                f"expected exactly one skipped group, got {skipped}: "
                f"{ {g: profile['groups'][g].get('error') for g in skipped} }"
            )
        for knob in PROBE_GROUPS[skipped[0]][1]:
            if profile["knobs"][knob] != KNOB_DEFAULTS[knob]:
                raise AssertionError(
                    f"skipped group {skipped[0]}: knob {knob} drifted off its default "
                    f"({profile['knobs'][knob]})"
                )
        events = list(iter_events(str(Path(tw) / "events.jsonl")))
        failed_probes = [r for r in events if r["ev"] == "tune_probe" and r["ok"] is False]
        if len(failed_probes) != 1 or failed_probes[0]["group"] != skipped[0]:
            raise AssertionError(
                f"expected one tune_probe ok=false for {skipped[0]}, got {failed_probes}"
            )
        lint = _lint(Path(tw) / "events.jsonl")
        if lint:
            raise AssertionError(f"tune event stream lint-dirty: {lint[:3]}")
        wd = str(root / "eager_tune")
        cfg = RunConfig(
            workdir=wd,
            out_dir=wd + "_o",
            feed_workers="auto",
            decode_workers="auto",
            feed_cache_mb="auto",
            fetch_depth="auto",
            upload_depth="auto",
            tune_store_dir=store_dir,
            **eager_kw,
        )
        summary = _run(stack, cfg)
        if summary.get("tune", {}).get("source") != "store":
            raise AssertionError(
                f"auto knobs did not resolve from the store: {summary.get('tune')}"
            )
        if digest_workdir(wd) != digest_workdir(str(root / "eager_clean")):
            raise AssertionError("tuned-profile run artifacts differ from the clean run")
        note({
            "track": "eager",
            "case": "tune_probe_fault",
            "schedule": schedule,
            "skipped_group": skipped[0],
            "artifacts_identical": True,
        }, schedule, seen)
        if verbose:
            print(f"  ok: eager/tune_probe_fault (group {skipped[0]} skipped, run "
                  "byte-identical)", flush=True)

    def run_lease_kill_case() -> None:
        """Full mode: two independent worker processes share one workdir
        through the lease queue alone; the victim — slow, holding leases —
        is SIGKILLed mid-run.  The survivor steals the expired leases and
        finishes the whole scene without a resume, byte-identical.  The
        worker spawn / config / manifest audit reuse ``elastic_soak``'s
        helpers — one copy of the worker contract."""
        from land_trendr_tpu_torch.tools.elastic_soak import (
            _manifest_records,
            _spawn_worker,
            _write_worker_cfg,
        )

        wd = str(root / "eager_lease_kill")
        sc = eager_scene

        def cfg_file(name: str, run_kw: dict, start_when: "str | None" = None) -> str:
            # the eager track's scene, so the clean digest is shared
            return _write_worker_cfg(
                root / name, wd, sc.width, sc.tile,
                {"params": dict(sc.params), **run_kw}, device,
                height=sc.height, years=sc.year_end - sc.year_start + 1,
                seed=sc.seed, year_start=sc.year_start, start_when=start_when,
            )

        lease_kw = {"lease_batch": 2, "lease_ttl_s": 1.0}
        a = _spawn_worker(cfg_file("lease_kill_a.json", {
            **lease_kw,
            # slow per tile: the victim is mid-run, leases in hand, when
            # the kill lands
            "fault_schedule": "seed=5,compute.wait%1.0=slow:0.3",
        }))
        # the survivor waits, warm, at a gate until the victim holds leases:
        # a survivor that claimed every tile first would leave nothing to steal
        gate = root / "lease_kill_b.go"
        b = _spawn_worker(cfg_file("lease_kill_b.json", dict(lease_kw), start_when=str(gate)))
        try:
            def recs() -> list:
                try:
                    return _manifest_records(wd)
                except OSError:
                    return []

            deadline = time.monotonic() + 240
            while time.monotonic() < deadline:
                if a.poll() is not None:
                    raise AssertionError(
                        "lease-kill victim exited before the kill: " + a.stderr.read()[-2000:]
                    )
                rs = recs()
                holds = any(
                    r.get("kind") == "lease" and isinstance(r.get("owner"), str)
                    and f":{a.pid}:" in r["owner"]
                    for r in rs
                )
                if holds and not gate.exists():
                    gate.write_text("go")
                if holds and sum(1 for r in rs if r.get("kind") == "tile") >= 1:
                    break
                time.sleep(0.05)
            else:
                raise AssertionError("lease-kill victim never held a lease")
            gate.write_text("go")
            os.kill(a.pid, signal.SIGKILL)
            a.communicate()
            _, err_b = b.communicate(timeout=600)
        finally:
            for q in (a, b):
                if q.poll() is None:
                    q.kill()
                    q.communicate()
        if b.returncode != 0:
            raise AssertionError(f"lease-kill survivor failed:\n{err_b[-4000:]}")
        if digest_workdir(wd) != digest_workdir(str(root / "eager_clean")):
            raise AssertionError("lease-kill artifacts differ from the clean run")
        steals = [r for r in recs() if r.get("kind") == "lease" and r.get("mode") == "steal"]
        if not steals:
            raise AssertionError(
                "survivor never stole the dead victim's leases — the TTL/steal path "
                "silently changed"
            )
        note({
            "track": "eager",
            "case": "lease_kill_steal",
            "schedule": "SIGKILL victim mid-lease",
            "steals": len(steals),
            "artifacts_identical": True,
        }, "", [])
        if verbose:
            print(f"  ok: eager/lease_kill_steal ({len(steals)} steal claim(s) after "
                  "SIGKILL)", flush=True)

    # ---- serve and router tracks share one on-disk stack -------------
    serve_stack: dict = {}

    def ensure_serve_stack() -> "tuple[str, dict]":
        """The serve stack on disk and the clean digest of ``segment`` over
        it (the serve jobs must reproduce it byte for byte)."""
        if not serve_stack:
            from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack
            from land_trendr_tpu_torch.ops.indices import required_bands
            from land_trendr_tpu_torch.runtime import load_stack_dir

            sdir = str(root / "serve_stack")
            write_stack(sdir, make_stack(SceneSpec(
                width=48, height=40, year_start=1990, year_end=2013, seed=11)))
            clean_wd = str(root / "serve_clean")
            _run(load_stack_dir(sdir, bands=required_bands("nbr", ())),
                 RunConfig(workdir=clean_wd, out_dir=clean_wd + "_o", **base_kw))
            serve_stack.update(sdir=sdir, clean=digest_workdir(clean_wd))
        return serve_stack["sdir"], serve_stack["clean"]

    def serve_job(sdir: str, **extra) -> dict:
        return {
            "stack_dir": sdir,
            "tile_size": base_kw["tile_size"],
            "params": dict(SMALL_PARAMS),
            "max_retries": retries,
            "run_overrides": {"retry_backoff_s": 0.0},
            **extra,
        }

    def run_serve_track() -> None:
        """Serve-mode failure semantics: the server's ONE armed plan fires
        at ``serve.submit`` (the first submission rejected, the server
        lives) and at ``dispatch`` (job A's first tile exhausts its
        retries and is quarantined → ``retries_exhausted``); sibling job B
        still completes byte-identical to a clean run.  Then the debug
        surface: with a hang fault wedging the dispatcher,
        ``/debug/stacks`` still answers (showing the wedged frame) and a
        ``debug.profile`` fault fails the capture, never the job."""
        from land_trendr_tpu_torch.serve import Rejection, SegmentationServer, ServeConfig

        sdir, clean = ensure_serve_stack()
        # dispatch invocation 0 is job A's warm probe (program-cache miss);
        # its first real tile then burns attempts 1..retries+1
        schedule = f"seed=1,serve.submit@0=io,dispatch@1*{retries + 1}"
        server = SegmentationServer(ServeConfig(
            workdir=str(root / "serve_srv"), max_jobs=2, feed_cache_mb=64,
            fault_schedule=schedule,
        ), device=device)
        plan = server._fault_plan  # cleared at shutdown: keep the log
        job = serve_job(sdir)
        try:
            server.submit(dict(job))
        except Rejection as e:
            if e.reason != "submit_error":
                raise AssertionError(f"serve.submit seam: expected submit_error, got {e.reason}")
        else:
            raise AssertionError(
                "serve.submit@0 did not reject the first submission — the seam no "
                "longer fires there"
            )
        a = server.submit({**job, "quarantine_tiles": True})
        b = server.submit(dict(job))
        server.serve_forever()  # drains both jobs, then shuts down
        seen = [s for s, _i, _k in plan.injected()]
        sa = server.job_status(a["job_id"])
        sb = server.job_status(b["job_id"])
        if sa["state"] != "retries_exhausted" or not sa["summary"]["tiles_quarantined"]:
            raise AssertionError(
                f"job A: expected retries_exhausted with quarantined tiles, got "
                f"{sa['state']} ({sa.get('summary', {}).get('tiles_quarantined')})"
            )
        if sb["state"] != "done":
            raise AssertionError(
                f"job B: expected done beside the failing sibling, got {sb['state']} "
                f"({sb.get('error')})"
            )
        if digest_workdir(sb["workdir"]) != clean:
            raise AssertionError("serve job B artifacts differ from the clean run")
        note({
            "track": "serve",
            "case": "submit_reject_and_sibling_quarantine",
            "schedule": schedule,
            "job_a": sa["state"],
            "job_b": sb["state"],
            "artifacts_identical": True,
        }, schedule, seen)
        if verbose:
            print(f"  ok: serve/submit_reject_and_sibling_quarantine ({schedule})", flush=True)

        schedule2 = "seed=2,dispatch@0*2=hang:1.0,debug.profile@0"
        server2 = SegmentationServer(ServeConfig(
            workdir=str(root / "serve_dbg"), max_jobs=1, feed_cache_mb=64,
            sampler_interval_s=0.2, fault_schedule=schedule2,
        ), device=device)
        plan2 = server2._fault_plan
        c = server2.submit(dict(job))
        t = threading.Thread(target=server2.serve_forever)
        t.start()
        try:
            base = f"http://127.0.0.1:{server2.port}"

            def _get(path: str):
                with urllib.request.urlopen(base + path, timeout=30) as r:
                    return json.loads(r.read())

            deadline = time.monotonic() + 60
            wedged = False
            while time.monotonic() < deadline and not wedged:
                stacks = _get("/debug/stacks")["threads"]
                wedged = any(any("_hang" in line for line in frames)
                             for frames in stacks.values())
                if not wedged:
                    time.sleep(0.05)
            if not wedged:
                raise AssertionError(
                    "/debug/stacks never showed the dispatcher wedged in the armed hang fault"
                )
            req = urllib.request.Request(base + "/debug/profile",
                                         data=b'{"duration_s": 0.1}', method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                prof = json.loads(r.read())
            if prof["ok"] is not False:
                raise AssertionError(
                    "debug.profile@0 did not fail the capture — the seam no longer fires there"
                )
        finally:
            t.join(timeout=600)
        seen2 = [s for s, _i, _k in plan2.injected()]
        sc = server2.job_status(c["job_id"])
        if sc["state"] != "done":
            raise AssertionError(
                f"job beside the failed capture: expected done, got {sc['state']} "
                f"({sc.get('error')})"
            )
        if digest_workdir(sc["workdir"]) != clean:
            raise AssertionError("debug-soak job artifacts differ from the clean run")
        note({
            "track": "serve",
            "case": "debug_stacks_under_hang_and_profile_fault",
            "schedule": schedule2,
            "stacks_responsive_while_wedged": True,
            "profile_fault_ok_false": True,
            "job": sc["state"],
            "artifacts_identical": True,
        }, schedule2, seen2)
        if verbose:
            print(f"  ok: serve/debug_stacks_under_hang_and_profile_fault ({schedule2})",
                  flush=True)

    def run_serve_job_case() -> None:
        """Job-level failure isolation (the ``serve.job`` seam): the armed
        job fails at execution START and goes terminal ``error``; the
        SAME request resubmitted completes byte-identical to the clean
        run — a job-start failure burns the job, never the server."""
        from land_trendr_tpu_torch.serve import SegmentationServer, ServeConfig

        sdir, clean = ensure_serve_stack()
        schedule = "seed=1,serve.job@0"
        # the serve loop drains jobs serially, so invocation 0 is the first
        # submission's start; max_jobs=2 counts the errored job as one of
        # the two terminal states
        server = SegmentationServer(ServeConfig(
            workdir=str(root / "serve_jobfault"), max_jobs=2, feed_cache_mb=64,
            fault_schedule=schedule,
        ), device=device)
        plan = server._fault_plan
        job = serve_job(sdir)
        a = server.submit(dict(job))
        b = server.submit(dict(job))
        server.serve_forever()
        seen = [s for s, _i, _k in plan.injected()]
        sa = server.job_status(a["job_id"])
        sb = server.job_status(b["job_id"])
        if sa["state"] != "error":
            raise AssertionError(
                f"serve.job@0: expected the first job terminal 'error', got {sa['state']} "
                f"({sa.get('error')})"
            )
        if sb["state"] != "done":
            raise AssertionError(
                f"serve.job resubmit: expected done, got {sb['state']} ({sb.get('error')})"
            )
        if digest_workdir(sb["workdir"]) != clean:
            raise AssertionError("serve.job resubmit artifacts differ from the clean run")
        note({
            "track": "serve",
            "case": "job_fault_then_resubmit",
            "schedule": schedule,
            "job_a": sa["state"],
            "job_b": sb["state"],
            "artifacts_identical": True,
        }, schedule, seen)
        if verbose:
            print(f"  ok: serve/job_fault_then_resubmit ({schedule})", flush=True)

    def run_batch_track() -> None:
        """Cross-job batching failure semantics: ``batch.pack`` excludes
        the first candidate from the batch (it runs solo) and
        ``batch.demux`` stops one member's demux at tile 0 (its own run
        recomputes); every job of a 3-job same-shape flood still
        completes byte-identical, and the stream stays schema-clean."""
        from land_trendr_tpu_torch.serve import SegmentationServer, ServeConfig

        sdir, clean = ensure_serve_stack()
        schedule = "seed=3,batch.pack@0=io,batch.demux@0=io"
        srv_wd = str(root / "serve_batch")
        server = SegmentationServer(ServeConfig(
            workdir=srv_wd, max_jobs=3, feed_cache_mb=64, batch=True,
            batch_window_ms=150.0, fault_schedule=schedule,
        ), device=device)
        plan = server._fault_plan
        subs = [server.submit(serve_job(sdir)) for _ in range(3)]
        server.serve_forever()  # drains all three jobs, then shuts down
        seen = [s for s, _i, _k in plan.injected()]
        for snap in subs:
            s = server.job_status(snap["job_id"])
            if s["state"] != "done":
                raise AssertionError(
                    f"batch track: job {snap['job_id']} ended {s['state']} ({s.get('error')})"
                )
            if digest_workdir(s["workdir"]) != clean:
                raise AssertionError(
                    f"batch track: job {snap['job_id']} artifacts differ from the clean run"
                )
        evs = _events(Path(srv_wd) / "events.jsonl")
        launches = [e for e in evs if e["ev"] == "batch_launch"]
        demuxes = [e for e in evs if e["ev"] == "batch_demux"]
        if not launches:
            raise AssertionError(
                "batch track: no batch_launch — the window never coalesced the queued siblings"
            )
        if launches[0]["jobs"] != 2:
            raise AssertionError(
                f"batch.pack@0 should have excluded one candidate from the first launch, "
                f"got jobs={launches[0]['jobs']}"
            )
        if not any(d["tiles"] == 0 for d in demuxes):
            raise AssertionError(f"batch.demux@0 never stopped a member's demux at tile 0: "
                                 f"{demuxes}")
        if not any(d["tiles"] > 0 for d in demuxes):
            raise AssertionError(
                f"no member ever received demuxed tiles — batching is not demuxing: {demuxes}"
            )
        lint = _lint(Path(srv_wd) / "events.jsonl")
        if lint:
            raise AssertionError(f"batch track: server stream lint-dirty: {lint[:3]}")
        note({
            "track": "serve",
            "case": "batch_pack_and_demux_faults",
            "schedule": schedule,
            "launches": len(launches),
            "first_launch_jobs": launches[0]["jobs"],
            "demux_tiles": [d["tiles"] for d in demuxes],
            "artifacts_identical": True,
        }, schedule, seen)
        if verbose:
            print(f"  ok: serve/batch_pack_and_demux_faults ({schedule}; {len(launches)} "
                  f"launch(es), demux tiles {[d['tiles'] for d in demuxes]})", flush=True)

    def run_batch_kill_case() -> None:
        """Full mode: a batching server SIGKILLed MID-BATCH — leader still
        computing, members already holding demuxed tiles.  Each job's
        pinned workdir then resumes independently, skipping its durable
        tiles, and finishes byte-identical to the clean run."""
        from land_trendr_tpu_torch.ops.indices import required_bands
        from land_trendr_tpu_torch.runtime import load_stack_dir

        sdir, clean = ensure_serve_stack()
        n_tiles = len(clean)
        wds = [str(root / f"batch_kill_job{i}") for i in range(3)]
        payloads = [serve_job(sdir, workdir=wd, out_dir=wd + "_o") for wd in wds]
        cfg_path = root / "batch_kill_jobs.json"
        cfg_path.write_text(json.dumps(payloads))
        script = root / "batch_kill_server.py"
        # every dispatch paced slow so the kill lands with the leader
        # mid-scene and members partially demuxed
        script.write_text(
            "import json, sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "from land_trendr_tpu_torch.serve import SegmentationServer, ServeConfig\n"
            "server = SegmentationServer(ServeConfig(\n"
            f"    workdir={str(root / 'batch_kill_srv')!r}, max_jobs=3,\n"
            "    feed_cache_mb=64, batch=True, batch_window_ms=300.0,\n"
            "    fault_schedule='seed=5,dispatch%1.0=slow:0.3',\n"
            f"), device={device!r})\n"
            "for p in json.load(open(sys.argv[1])):\n"
            "    server.submit(p)\n"
            "server.serve_forever()\n"
        )
        proc = subprocess.Popen(
            [sys.executable, str(script), str(cfg_path)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        deadline = time.monotonic() + 300
        killed = False
        try:
            while time.monotonic() < deadline:
                if proc.poll() is not None:
                    _, err = proc.communicate()
                    raise AssertionError("batch-kill server exited before the kill:\n"
                                         + err[-4000:])
                lead = len(list(Path(wds[0]).glob("tile_*.npz")))
                mem = max(len(list(Path(w).glob("tile_*.npz"))) for w in wds[1:])
                if mem >= 1 and lead < n_tiles:
                    os.kill(proc.pid, signal.SIGKILL)
                    killed = True
                    break
                time.sleep(0.05)
        finally:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()
        if not killed:
            raise AssertionError(
                "batch-kill: the mid-batch window never opened — no member held a "
                "demuxed tile while the leader was short"
            )
        pre = [len(list(Path(w).glob("tile_*.npz"))) for w in wds]
        stack = load_stack_dir(sdir, bands=required_bands("nbr", ()))
        for wd, durable in zip(wds, pre):
            summary = _run(stack, RunConfig(workdir=wd, out_dir=wd + "_o", **base_kw))
            if summary["tiles_skipped_resume"] < max(durable - 1, 0):
                raise AssertionError(
                    f"batch-kill: {wd} resumed only {summary['tiles_skipped_resume']} of "
                    f"{durable} durable tile(s) — demuxed artifacts did not resume"
                )
            if digest_workdir(wd) != clean:
                raise AssertionError(
                    f"batch-kill: {wd} artifacts differ from the clean run after resume"
                )
        note({
            "track": "serve",
            "case": "batch_sigkill_mid_batch_resume",
            "schedule": "SIGKILL server mid-batch",
            "tiles_durable_before_kill": pre,
            "artifacts_identical": True,
        }, "", [])
        if verbose:
            print(f"  ok: serve/batch_sigkill_mid_batch_resume ({pre} tile(s) durable "
                  "pre-kill)", flush=True)

    def wait_terminal(get, deadline: float) -> dict:
        s = get()
        while time.monotonic() < deadline and s["state"] in ("queued", "routed"):
            time.sleep(0.1)
            s = get()
        return s

    def run_router_track() -> None:
        """Fleet-router failure semantics, in process: one real replica (a
        ``SegmentationServer`` on a thread) behind a ``FleetRouter`` whose
        armed plan fires at the two router seams.  ``router.forward@0``:
        the first forward fails, the job routes again (attempt 2),
        byte-identical.  ``replica.health@1*8``: consecutive probes read
        failed — the replica is marked unready without failing the
        accepted job, which completes byte-identically, and the replica
        recovers once the probes clear."""
        from land_trendr_tpu_torch.fleet import FleetRouter, RouterConfig
        from land_trendr_tpu_torch.serve import SegmentationServer, ServeConfig

        sdir, clean = ensure_serve_stack()
        job = serve_job(sdir)
        server = SegmentationServer(
            ServeConfig(workdir=str(root / "router_replica"), feed_cache_mb=64), device=device)
        srv_thread = threading.Thread(target=server.serve_forever)
        srv_thread.start()
        try:
            for case_name, schedule in (
                ("forward_fault_rerouted", "seed=1,router.forward@0=io"),
                # the plan is process-global, so the slow dispatch paces the
                # in-process replica's job long enough that three health
                # beats (0.2 s apart) fail while it runs — invocation 0 is
                # the adopt-time probe and must succeed
                ("health_fault_unready_job_survives",
                 "seed=2,replica.health@1*8,dispatch%1.0=slow:0.3"),
            ):
                rt_dir = str(root / f"router_{case_name}")
                router = FleetRouter(RouterConfig(
                    workdir=rt_dir,
                    replicas=(f"http://127.0.0.1:{server.port}",),
                    health_interval_s=0.2,
                    route_retries=2,
                    fault_schedule=schedule,
                ))
                plan = router._fault_plan
                rt_thread = threading.Thread(target=router.serve_forever)
                rt_thread.start()
                try:
                    snap = router.submit(dict(job))
                    deadline = time.monotonic() + 300
                    s = wait_terminal(lambda: router.job_status(snap["job_id"]), deadline)
                    if case_name.startswith("health"):
                        # wait out the recovery probe so the replica_up
                        # assertion is not a race against stop()
                        while time.monotonic() < deadline:
                            pool = router.stats()["replicas"]
                            if pool and pool[0]["state"] == "ready":
                                break
                            time.sleep(0.1)
                finally:
                    router.stop()
                    rt_thread.join(timeout=300)
                seen = [x for x, _i, _k in plan.injected()]
                if s["state"] != "done":
                    raise AssertionError(
                        f"router/{case_name}: job ended {s['state']} ({s.get('error')})"
                    )
                if digest_workdir(s["workdir"]) != clean:
                    raise AssertionError(f"router/{case_name}: artifacts differ from the "
                                         "clean run")
                evs = _events(Path(rt_dir) / "events.jsonl")
                kinds = [e["ev"] for e in evs]
                if case_name == "forward_fault_rerouted":
                    if s["attempts"] != 2:
                        raise AssertionError(
                            f"router/forward: expected 2 route attempts (fault then "
                            f"re-route), got {s['attempts']}"
                        )
                    decisions = [e for e in evs if e["ev"] == "route_decision"]
                    if len(decisions) != 1 or decisions[0]["attempt"] != 2:
                        raise AssertionError(
                            f"router/forward: expected exactly the attempt-2 route_decision, "
                            f"got {decisions}"
                        )
                    _assert_two_hop_trace(
                        s["trace_id"], [rt_dir, str(root / "router_replica"), s["workdir"]],
                        expect_failed_first=True,
                    )
                else:
                    downs = [e for e in evs if e["ev"] == "replica_down"]
                    if not downs or downs[0]["reason"] != "health":
                        raise AssertionError(
                            f"router/health: the probe faults never marked the replica "
                            f"unready ({downs})"
                        )
                    if kinds.count("replica_up") < 2:
                        raise AssertionError(
                            "router/health: the replica never recovered after the probes "
                            "cleared"
                        )
                note({
                    "track": "router",
                    "case": case_name,
                    "schedule": schedule,
                    "job": s["state"],
                    "route_attempts": s["attempts"],
                    "artifacts_identical": True,
                }, schedule, seen)
                if verbose:
                    print(f"  ok: router/{case_name} ({schedule})", flush=True)
        finally:
            server.stop()
            srv_thread.join(timeout=120)

    def run_journal_track() -> None:
        """Crash-safe control plane, in process: ``router.journal@0=io``
        refuses the first admission 503 ``journal_error`` (a job the
        journal cannot make durable is never accepted) and the
        resubmission completes byte-identically; ``router.recover@0=io``
        over a fabricated crash journal degrades the replayed job to the
        requeue path — it re-routes, resumes, and finishes
        byte-identically with ONE complete trace under the preserved id;
        an idempotent resubmission dedupes onto it."""
        from land_trendr_tpu_torch.fleet import FleetRouter, RouterConfig
        from land_trendr_tpu_torch.obs.reqtrace import assemble_request
        from land_trendr_tpu_torch.serve import SegmentationServer, ServeConfig
        from land_trendr_tpu_torch.serve.server import Rejection
        from land_trendr_tpu_torch.tools.lt_request import expand_paths

        sdir, clean = ensure_serve_stack()
        job = serve_job(sdir)
        server = SegmentationServer(
            ServeConfig(workdir=str(root / "journal_replica"), feed_cache_mb=64),
            device=device)
        srv_thread = threading.Thread(target=server.serve_forever)
        srv_thread.start()
        try:
            # -- case 1: append fault → 503, resubmission lands --------
            case_name = "journal_fault_503_then_resubmit"
            schedule = "seed=1,router.journal@0=io"
            rt_dir = str(root / "router_journal_fault")
            router = FleetRouter(RouterConfig(
                workdir=rt_dir, replicas=(f"http://127.0.0.1:{server.port}",),
                health_interval_s=0.2, fault_schedule=schedule,
            ))
            plan = router._fault_plan
            rt_thread = threading.Thread(target=router.serve_forever)
            rt_thread.start()
            try:
                try:
                    router.submit(dict(job))
                    raise AssertionError("journal fault: the un-durable submission was ACCEPTED")
                except Rejection as e:
                    if e.http_status != 503 or e.reason != "journal_error":
                        raise AssertionError(
                            f"journal fault: expected 503 journal_error, got "
                            f"{e.http_status} {e.reason}"
                        )
                snap = router.submit(dict(job))
                s = wait_terminal(lambda: router.job_status(snap["job_id"]),
                                  time.monotonic() + 300)
            finally:
                router.stop()
                rt_thread.join(timeout=300)
            seen = [x for x, _i, _k in plan.injected()]
            if s["state"] != "done":
                raise AssertionError(
                    f"journal fault: resubmitted job ended {s['state']} ({s.get('error')})"
                )
            if digest_workdir(s["workdir"]) != clean:
                raise AssertionError("journal fault: artifacts differ from the clean run")
            evs = _events(Path(rt_dir) / "events.jsonl")
            rejects = [e for e in evs
                       if e["ev"] == "job_rejected" and e.get("reason") == "journal_error"]
            if len(rejects) != 1:
                raise AssertionError(
                    f"journal fault: expected one journal_error rejection event, got {rejects}"
                )
            kinds = sorted({e["rec"] for e in evs if e["ev"] == "journal_append"})
            if kinds != ["admitted", "forwarded", "terminal"]:
                raise AssertionError(
                    f"journal fault: the resubmitted job should journal all three record "
                    f"kinds, got {kinds}"
                )
            note({
                "track": "router",
                "case": case_name,
                "schedule": schedule,
                "job": s["state"],
                "artifacts_identical": True,
            }, schedule, seen)
            if verbose:
                print(f"  ok: router/{case_name} ({schedule})", flush=True)

            # -- case 2: crash journal replays; probe fault → requeue --
            case_name = "recover_probe_fault_requeued_resume"
            schedule = "seed=1,router.recover@0=io"
            rt_dir = str(root / "router_recover")
            jid, trace_id = "rt-0-00001", "soakrecover00001"
            jwd = str(root / "router_recover_job")
            payload = dict(job)
            payload["workdir"] = jwd
            payload["out_dir"] = jwd + "_o"
            jdir = Path(rt_dir) / "journal"
            jdir.mkdir(parents=True)
            (jdir / "seg-00000001.jsonl").write_text(
                "\n".join(json.dumps(r) for r in (
                    {
                        "rec": "admitted", "job_id": jid, "payload": payload,
                        "tenant": "soak", "priority": 0, "key": "soak-key",
                        "trace_id": trace_id, "idempotency_key": "soak-recover-1",
                        "workdir": jwd, "out_dir": jwd + "_o", "source": "http",
                        "t": time.time(),
                    },
                    {
                        "rec": "forwarded", "job_id": jid,
                        # a base nothing listens on: the dead incarnation
                        "replica_base": "http://127.0.0.1:9",
                        "replica_job_id": "gone-1", "replica": "r0", "t": time.time(),
                    },
                )) + "\n"
            )
            router = FleetRouter(RouterConfig(
                workdir=rt_dir, replicas=(f"http://127.0.0.1:{server.port}",),
                health_interval_s=0.2, fault_schedule=schedule,
            ))
            plan = router._fault_plan
            rt_thread = threading.Thread(target=router.serve_forever)
            rt_thread.start()
            try:
                rec = router.recovery
                if not rec or rec["requeued"] != 1 or rec["replayed"] != 1:
                    raise AssertionError(
                        f"recover: expected the one forwarded job requeued, got {rec}"
                    )
                dedup = router.submit({**payload, "idempotency_key": "soak-recover-1"})
                if not dedup.get("deduped") or dedup["job_id"] != jid:
                    raise AssertionError(
                        f"recover: idempotent resubmission did not dedupe onto the "
                        f"recovered job: {dedup}"
                    )
                s = wait_terminal(lambda: router.job_status(jid), time.monotonic() + 300)
            finally:
                router.stop()
                rt_thread.join(timeout=300)
            seen = [x for x, _i, _k in plan.injected()]
            if s["state"] != "done":
                raise AssertionError(f"recover: replayed job ended {s['state']} "
                                     f"({s.get('error')})")
            if s["trace_id"] != trace_id:
                raise AssertionError(f"recover: trace id not preserved: {s['trace_id']}")
            if digest_workdir(jwd) != clean:
                raise AssertionError("recover: artifacts differ from the clean run")
            evs = _events(Path(rt_dir) / "events.jsonl")
            recovered = [e for e in evs if e["ev"] == "router_recovered"]
            if len(recovered) != 1 or recovered[0]["requeued"] != 1:
                raise AssertionError(
                    f"recover: expected one router_recovered with requeued=1, got {recovered}"
                )
            files = expand_paths([rt_dir, str(root / "journal_replica"), jwd])
            tr = assemble_request(files, trace_id)
            if not tr["complete"]:
                raise AssertionError(f"recover: trace {trace_id} did not assemble complete: "
                                     f"{tr}")
            if abs(tr["blame_sum_s"] - tr["latency_s"]) > 5e-3:
                raise AssertionError(
                    f"recover: blame {tr['blame']} sums to {tr['blame_sum_s']} vs latency "
                    f"{tr['latency_s']}"
                )
            note({
                "track": "router",
                "case": case_name,
                "schedule": schedule,
                "job": s["state"],
                "recovery": {k: recovered[0].get(k)
                             for k in ("replayed", "requeued", "relayed", "deduped")},
                "trace_id": trace_id,
                "artifacts_identical": True,
            }, schedule, seen)
            if verbose:
                print(f"  ok: router/{case_name} ({schedule})", flush=True)
        finally:
            server.stop()
            srv_thread.join(timeout=120)

    def spawned_router(rt_dir: str, n: int, **kw):
        """A ``FleetRouter`` over ``n`` spawned replicas on this device,
        every dispatch paced so a kill lands mid-job."""
        from land_trendr_tpu_torch.fleet import FleetRouter, RouterConfig

        return FleetRouter(RouterConfig(
            workdir=rt_dir,
            spawn_replicas=n,
            health_interval_s=0.3,
            route_retries=3,
            replica_args=(*device_args, "--feed-cache-mb", "64",
                          "--fault-schedule", "seed=5,dispatch%1.0=slow:0.3"),
            **kw,
        ))

    def run_router_kill_case() -> None:
        """Full mode: a SPAWNED replica SIGKILLed mid-job.  The router
        detects the dead process, re-routes the job (its router-pinned
        workdir resumes on the survivor), and the job completes
        byte-identical — zero accepted jobs lost."""
        sdir, clean = ensure_serve_stack()
        rt_dir = str(root / "router_kill")
        router = spawned_router(rt_dir, 2)
        rt_thread = threading.Thread(target=router.serve_forever)
        rt_thread.start()
        try:
            snap = router.submit({"stack_dir": sdir, "tile_size": base_kw["tile_size"],
                                  "params": dict(SMALL_PARAMS),
                                  "run_overrides": {"retry_backoff_s": 0.0}})
            wd = Path(snap["workdir"])
            deadline = time.monotonic() + 300
            victim = None
            while time.monotonic() < deadline and victim is None:
                with router._lock:
                    for r in router.pool:
                        if r.inflight and r.proc is not None and r.proc.poll() is None:
                            victim = r
                if victim is None:
                    time.sleep(0.05)
                elif not list(wd.glob("tile_*.npz")):
                    victim = None  # kill only once work is durable
                    time.sleep(0.05)
            if victim is None:
                raise AssertionError("router kill: no replica ever held the job")
            pre_kill = len(list(wd.glob("tile_*.npz")))
            os.kill(victim.proc.pid, signal.SIGKILL)
            s = wait_terminal(lambda: router.job_status(snap["job_id"]), deadline)
            spawned_launches["router_kill"] = replica_launches(router)
        finally:
            router.stop()
            rt_thread.join(timeout=600)
        if s["state"] != "done":
            raise AssertionError(f"router kill: job ended {s['state']} ({s.get('error')})")
        if s["attempts"] < 2:
            raise AssertionError("router kill: the job was never re-routed — the kill "
                                 "missed its window")
        if digest_workdir(str(wd)) != clean:
            raise AssertionError("router kill: artifacts differ from the clean run")
        trace = _assert_two_hop_trace(s["trace_id"], [rt_dir], expect_failed_first=False)
        note({
            "track": "router",
            "case": "replica_sigkill_rerouted",
            "schedule": "SIGKILL replica mid-job",
            "tiles_durable_before_kill": pre_kill,
            "route_attempts": s["attempts"],
            "artifacts_identical": True,
            "trace_id": s["trace_id"],
            "trace_hops": [h["replica"] for h in trace["hops"]],
            "trace_blame": trace["blame"],
        }, "", [])
        if verbose:
            print(f"  ok: router/replica_sigkill_rerouted ({pre_kill} tile(s) durable "
                  f"pre-kill, {s['attempts']} route attempts)", flush=True)

    def run_router_restart_kill_case() -> None:
        """Full mode: the ROUTER process SIGKILLed mid-trace, restarted on
        the same workdir: zero accepted jobs lost (the journal replays the
        in-flight job), the running replica re-adopted, the job completes
        byte-identical under its preserved trace id, an idempotent
        resubmission dedupes onto it, and a SIGTERM drain leaves the
        clean-shutdown marker."""
        from land_trendr_tpu_torch.obs.reqtrace import assemble_request
        from land_trendr_tpu_torch.tools.lt_request import expand_paths

        def _launch(rt_dir: str) -> "tuple[subprocess.Popen, int]":
            proc = subprocess.Popen(
                [sys.executable, "-m", "land_trendr_tpu_torch", *device_args, "route",
                 "--workdir", rt_dir, "--route-port", "0", "--spawn-replicas", "1",
                 "--health-interval-s", "0.3", "--replica-args",
                 " ".join((*device_args, "--feed-cache-mb", "64", "--fault-schedule",
                           "seed=5,dispatch%1.0=slow:0.3"))],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
                cwd=str(REPO),
            )
            line = proc.stdout.readline()
            startup = json.loads(line) if line.strip() else {}
            if not startup.get("routing"):
                proc.kill()
                raise AssertionError(f"router restart: startup line unreadable: {line!r}")
            return proc, int(startup["port"])

        def _http(method: str, url: str, payload=None) -> dict:
            data = json.dumps(payload).encode() if payload is not None else None
            req = urllib.request.Request(url, data=data, method=method)
            req.add_header("Content-Type", "application/json")
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read())

        sdir, clean = ensure_serve_stack()
        rt_dir = str(root / "router_restart")
        trace_id = "soakrestart00001"
        proc, port = _launch(rt_dir)
        try:
            snap = _http("POST", f"http://127.0.0.1:{port}/jobs", {
                "stack_dir": sdir, "tile_size": base_kw["tile_size"],
                "params": dict(SMALL_PARAMS), "run_overrides": {"retry_backoff_s": 0.0},
                "trace_id": trace_id, "idempotency_key": "soak-restart-1",
            })
            jid = snap["job_id"]
            wd = Path(snap["workdir"])
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline and not list(wd.glob("tile_*.npz")):
                time.sleep(0.05)
            pre_kill = len(list(wd.glob("tile_*.npz")))
            if not pre_kill:
                raise AssertionError("router restart: no tile ever became durable")
            os.kill(proc.pid, signal.SIGKILL)
            proc.wait(timeout=60)
        except BaseException:
            proc.kill()
            raise
        proc, port = _launch(rt_dir)
        try:
            s = wait_terminal(lambda: _http("GET", f"http://127.0.0.1:{port}/jobs/{jid}"),
                              time.monotonic() + 300)
            if s["state"] != "done":
                raise AssertionError(
                    f"router restart: job ended {s['state']} ({s.get('error')}) — an "
                    "accepted job was lost"
                )
            if s["trace_id"] != trace_id:
                raise AssertionError(f"router restart: trace id not preserved: {s['trace_id']}")
            dedup = _http("POST", f"http://127.0.0.1:{port}/jobs", {
                "stack_dir": sdir, "tile_size": base_kw["tile_size"],
                "idempotency_key": "soak-restart-1",
            })
            if not dedup.get("deduped") or dedup["job_id"] != jid:
                raise AssertionError(
                    f"router restart: resubmission did not dedupe onto the recovered job: "
                    f"{dedup}"
                )
            rec = _http("GET", f"http://127.0.0.1:{port}/healthz").get("recovery")
            if not rec or rec.get("replayed") != 1:
                raise AssertionError(f"router restart: no recovery summary: {rec}")
        finally:
            # SIGTERM is the documented drain — the clean marker must follow
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                raise
        if digest_workdir(str(wd)) != clean:
            raise AssertionError("router restart: artifacts differ from the clean run")
        if not (Path(rt_dir) / "journal" / "clean").exists():
            raise AssertionError("router restart: SIGTERM drain left no clean-shutdown marker")
        tr = assemble_request(expand_paths([rt_dir]), trace_id)
        if not tr["complete"]:
            raise AssertionError(f"router restart: trace {trace_id} did not assemble "
                                 f"complete: {tr}")
        if abs(tr["blame_sum_s"] - tr["latency_s"]) > 5e-3:
            raise AssertionError(
                f"router restart: blame {tr['blame']} sums to {tr['blame_sum_s']} vs "
                f"latency {tr['latency_s']}"
            )
        note({
            "track": "router",
            "case": "router_sigkill_restart_recovered",
            "schedule": "SIGKILL router mid-trace, restart same workdir",
            "tiles_durable_before_kill": pre_kill,
            "recovery": rec,
            "trace_id": trace_id,
            "artifacts_identical": True,
        }, "", [])
        if verbose:
            print(f"  ok: router/router_sigkill_restart_recovered ({pre_kill} tile(s) "
                  f"durable pre-kill, recovery {rec})", flush=True)

    def run_loadgen_churn_case() -> None:
        """Load-rig churn semantics (the ``loadgen.tick`` seam): a seeded
        closed-loop soak against a 2-replica spawned fleet whose churn
        hook SIGKILLs the busiest replica mid-soak, driven from the rig's
        own scheduler tick.  Zero offered jobs lost, every pinned trace id
        assembles into a sweep point, the artifacts stay byte-identical,
        and the leg's decision log replays byte-identically through the
        offline simulator.  Unlike the JAX soak's, this case runs in smoke
        mode too, so every registered seam fires in a smoke."""
        from land_trendr_tpu_torch.fleet.capacity import (
            assemble_sweep,
            percentile,
            replay_decisions,
        )
        from land_trendr_tpu_torch.loadgen import InProcClient, LoadConfig, LoadRunner
        from land_trendr_tpu_torch.runtime import faults

        sdir, clean = ensure_serve_stack()
        rt_dir = str(root / "router_loadgen_churn")
        router = spawned_router(rt_dir, 2, decision_log=True)
        rt_thread = threading.Thread(target=router.serve_forever)
        rt_thread.start()
        killed: list = []

        def churn() -> None:
            # the first firing tick with a busy live replica: SIGKILL it
            if killed:
                return
            with router._lock:
                for r in router.pool:
                    if r.inflight and r.proc is not None and r.proc.poll() is None:
                        r.proc.send_signal(signal.SIGKILL)
                        killed.append(r.rid)
                        return

        def payload_fn(req) -> dict:
            # one shape for every request: the identity check is against
            # ONE clean digest, so params must not vary
            return {
                "stack_dir": sdir,
                "tile_size": base_kw["tile_size"],
                "params": dict(SMALL_PARAMS),
                "trace_id": req.trace_id,
                "run_overrides": {"retry_backoff_s": 0.0},
            }

        schedule = "seed=9,loadgen.tick%1.0"
        plan = faults.activate(faults.parse_schedule(schedule))
        try:
            runner = LoadRunner(
                LoadConfig(mode="closed", duration_s=120.0, requests=6, workers=2,
                           seed=11, tenants=2, timeout_s=240.0),
                InProcClient(router), payload_fn, telemetry=router.telemetry, churn=churn,
            )
            rep = runner.run(phase="fault_soak")
            sweep = assemble_sweep(rt_dir, rep.trace_ids)
            if router.telemetry is not None:
                router.telemetry.sweep_point(
                    replicas=2, offered_qps=rep.offered / max(rep.wall_s, 1e-6),
                    achieved_qps=rep.done / max(rep.wall_s, 1e-6),
                    p50_s=percentile(sweep["latencies"], 50.0),
                    p99_s=percentile(sweep["latencies"], 99.0),
                    goodput_qps=rep.done / max(rep.wall_s, 1e-6),
                    done=rep.done, failed=rep.failed, rejected=rep.rejected,
                    assembled=sweep["assembled"], window_s=rep.wall_s,
                )
            spawned_launches["loadgen_churn"] = replica_launches(router)
        finally:
            faults.deactivate()
            router.stop()
            rt_thread.join(timeout=600)
        seen = [s for s, _i, _k in plan.injected()]
        if not killed:
            raise AssertionError("loadgen churn: the tick seam never found a busy replica "
                                 "to kill")
        if rep.churned < 1:
            raise AssertionError("loadgen churn: the loadgen.tick seam never fired")
        if not (rep.offered == rep.done == 6 and rep.failed == 0 and rep.rejected == 0):
            raise AssertionError(
                f"loadgen churn: lost jobs — offered {rep.offered}, done {rep.done}, failed "
                f"{rep.failed}, rejected {rep.rejected} "
                f"({[o for o in rep.outcomes if o.outcome != 'done']})"
            )
        if sweep["assembled"] != 6 or len(sweep["latencies"]) != 6:
            raise AssertionError(
                f"loadgen churn: sweep point incomplete after the kill — "
                f"{sweep['assembled']} assembled, {len(sweep['latencies'])} latencies of 6"
            )
        evs = _events(Path(rt_dir) / "events.jsonl")
        rerouted = [e for e in evs
                    if e["ev"] == "route_decision" and e.get("attempt", 1) >= 2]
        if not rerouted:
            raise AssertionError(
                "loadgen churn: no re-routed job — the SIGKILL missed every inflight window"
            )
        for jwd in sorted(Path(rt_dir).glob("jobs/*/work")):
            if digest_workdir(str(jwd)) != clean:
                raise AssertionError(f"loadgen churn: {jwd} artifacts differ from the clean run")
        lint = _lint(Path(rt_dir) / "events.jsonl")
        if lint:
            raise AssertionError(f"loadgen churn: router stream lint-dirty: {lint[:3]}")
        replay = replay_decisions(str(Path(rt_dir) / "decisions.jsonl"))
        if not replay.match:
            raise AssertionError(
                f"loadgen churn: decision replay diverged at seq {replay.mismatch_seq}: "
                f"{replay.mismatch}"
            )
        note({
            "track": "router",
            "case": "loadgen_tick_churn_sigkill",
            "schedule": schedule,
            "killed_replica": killed[0],
            "churn_ticks": rep.churned,
            "rerouted_jobs": len(rerouted),
            "done": rep.done,
            "sweep_assembled": sweep["assembled"],
            "artifacts_identical": True,
            "replay_decisions": replay.decisions,
            "replay_match": True,
            "survivor_launches": spawned_launches["loadgen_churn"],
        }, schedule, seen)
        if verbose:
            print(f"  ok: router/loadgen_tick_churn_sigkill (killed {killed[0]}, "
                  f"{len(rerouted)} re-route(s), {replay.decisions} decisions replayed)",
                  flush=True)

    def timed(track: str, fn) -> None:
        t0 = time.perf_counter()
        fn()
        report["track_seconds"][track] = round(time.perf_counter() - t0, 3)

    def eager_track() -> None:
        stack = _make_eager(eager_scene)
        run_track("eager", stack, _eager_cases(retries), eager_kw)
        run_straggler_case(stack)
        run_lease_steal_case(stack)
        run_merge_peer_case()
        run_tune_case(stack)
        run_fleet_case(stack)
        if not smoke:
            run_lease_kill_case()
        if not smoke and not on_card:
            # the storms force the packed fetch (one fetch.wait per tile);
            # the CPU's per-product fetch checks the seam once per array,
            # which makes fetch.wait%0.1 a far harsher schedule
            report["storms"] = "not run: the packed fetch exists only on a CUDA device"
        elif not smoke:
            # probabilistic rounds: every seed a different deterministic
            # storm across the raising driver seams, still byte-identical
            for seed in range(seeds):
                wd = str(root / f"storm_{seed}")
                sched = (f"seed={seed},dispatch%0.1,compute.wait%0.1,"
                         "fetch.wait%0.1=io,feed%0.05=io")
                cfg = RunConfig(
                    workdir=wd, out_dir=wd + "_o", fault_schedule=sched,
                    fetch_packed=True, max_retries=6,
                    **{k: v for k, v in eager_kw.items() if k != "max_retries"},
                )
                summary = _run(stack, cfg)
                if digest_workdir(wd) != digest_workdir(str(root / "eager_clean")):
                    raise AssertionError(f"storm seed={seed}: artifacts differ")
                report["cases"].append({
                    "track": "storm", "case": f"seed={seed}", "schedule": sched,
                    "faults_fired": len(summary.get("faults_injected", [])),
                    "artifacts_identical": True,
                })
                if verbose:
                    print(f"  ok: storm/seed={seed}", flush=True)

    def serve_track() -> None:
        run_serve_track()
        run_serve_job_case()
        run_batch_track()
        if not smoke:
            run_batch_kill_case()

    def router_track() -> None:
        run_router_track()
        run_journal_track()
        run_loadgen_churn_case()
        if not smoke:
            run_router_kill_case()
            run_router_restart_kill_case()

    def lazy_track() -> None:
        lazy = _make_lazy(str(root / "c2"), 96)
        # lazy windows revisit strips across tiles: give the decode seams a
        # real cache to poison (the store case pins its own feed_cache_mb —
        # the store seam needs the RAM tier OFF — and keeps it)
        lazy_cases = [dataclasses.replace(c, cfg_kw={"feed_cache_mb": 64, **c.cfg_kw})
                      for c in _LAZY_CASES]
        run_track("lazy", lazy, lazy_cases, {**base_kw, "tile_size": 48})

    bodies = {"eager": eager_track, "serve": serve_track, "router": router_track,
              "lazy": lazy_track}
    for track in TRACKS:
        if track in tracks:
            timed(track, bodies[track])

    launches1 = segment_cuda.launch_counts()
    report["launches"] = {k: launches1[k] - launches0[k] for k in launches1}
    report["replica_launches"] = spawned_launches
    report["seams_armed"] = sorted(armed)
    report["seams_fired"] = sorted(fired)
    if set(tracks) == set(TRACKS):
        uncovered = set(SOAK_COVERED_SEAMS) - fired - (set() if on_card else set(CARD_ONLY_SEAMS))
        if uncovered:
            raise AssertionError(f"registered seams no case fired: {sorted(uncovered)}")
    report["eager_scene"] = dataclasses.asdict(eager_scene)
    report["ok"] = True
    if keep is None:
        shutil.rmtree(root, ignore_errors=True)
    return report


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="deterministic cases only (no SIGKILL cases, no storms)")
    ap.add_argument("--seeds", type=int, default=3,
                    help="probabilistic storm rounds in full mode")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    ap.add_argument("--keep", default=None, metavar="DIR",
                    help="keep workdirs under DIR for post-mortem")
    ap.add_argument("--out", default=None, metavar="FILE", help="write the JSON report here")
    args = ap.parse_args(argv)
    from land_trendr_tpu_torch.runtime.driver import resolve_device

    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    report = soak(smoke=args.smoke, seeds=args.seeds, keep=args.keep, device=args.device)
    if args.out:
        write_json_atomic(args.out, report, trailing_newline=False)
        print(f"wrote {args.out}")
    print(json.dumps({"ok": report["ok"], "cases": len(report["cases"]),
                      "seams_fired": len(report["seams_fired"]),
                      "track_seconds": report["track_seconds"],
                      "launches": report["launches"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
