"""Structured run-event log: a schema-versioned JSONL stream per process.

The reference's observability is Hadoop job counters plus task logs; the
tile driver previously emitted free-form ``log.info`` lines and one
end-of-run summary dict — unusable for watching a gigapixel run in flight
or for regression-tracking a scaling PR.  This module is the event half of
the :mod:`land_trendr_tpu_torch.obs` subsystem: every run writes an append-only
``events.jsonl`` (one file *per process* in multihost runs —
``events.p<i>.jsonl`` — so no cross-process write coordination is ever
needed; the primary merges post-hoc via
:func:`land_trendr_tpu_torch.parallel.multihost.merge_host_event_logs`).

Design rules:

* **One JSON object per line**, schema-versioned via the ``schema`` field
  on every ``run_start`` event.  Consumers (``tools/obs_report.py``,
  ``tools/check_events_schema.py``) validate against
  :data:`EVENT_FIELDS` — required fields are a *minimum*; extra fields are
  always allowed, so instrumentation can grow without a schema bump.
* **Every event carries both clocks**: ``t_wall`` (``time.time()`` — joins
  across processes and with external logs) and ``t_mono``
  (``time.perf_counter()`` — duration-accurate within one process).  The
  trace exporter anchors each run scope's monotonic clock to its
  ``run_start`` wall time, so multihost timelines line up.
* **Atomic thread-safe append**: one ``os.write`` of the whole line to an
  ``O_APPEND`` descriptor under a lock, so the driver's ``write_workers``
  pool, the feed pool, and the main loop can all emit without interleaving
  bytes.  A resumed run appends a fresh ``run_start`` to the same file;
  each ``run_start`` opens a new *run scope* for consumers.
* **Never fail the run**: emitting into a full disk raises at the caller —
  deliberate (silently lost telemetry is worse) — but schema problems are
  a consumer-side concern; ``emit`` does not validate.
"""

from __future__ import annotations

import glob
import json
import os
import re
import socket
import threading
import time
import uuid
from typing import Any, Callable, Iterator

__all__ = [
    "SCHEMA_VERSION",
    "COMMON_OPTIONAL_FIELDS",
    "EVENT_FIELDS",
    "OPTIONAL_FIELDS",
    "REQUEST_SPAN_STAGES",
    "EventLog",
    "events_path",
    "discover_event_files",
    "expand_event_paths",
    "iter_events",
    "run_scope_reset",
    "summarize_events_file",
    "validate_event",
    "validate_events_file",
]

#: bump when a REQUIRED field is added/renamed/retyped; adding optional
#: fields is backward-compatible and does not bump the version
SCHEMA_VERSION = 1

_NUM = (int, float)

#: event type → required payload fields (beyond the common ``ev`` /
#: ``t_wall`` / ``t_mono`` every event carries) and their types.  This is
#: the normative schema ``tools/check_events_schema.py`` lints against.
EVENT_FIELDS: dict[str, dict[str, Any]] = {
    # run lifecycle — first event of every run scope
    "run_start": {
        "schema": int,
        "fingerprint": str,
        "pid": int,
        "host": str,
        "process_index": int,
        "process_count": int,
        "tiles_total": int,
        "tiles_todo": int,
        "tiles_skipped_resume": int,
        "mesh_devices": int,
        "impl": str,
    },
    # a tile's device program was dispatched (attempt 1) or re-dispatched
    "tile_start": {"tile_id": int, "attempt": int},
    # one per-tile pipeline-stage span (obs/spans.py): ``start``/``end``
    # are monotonic-clock values (the same clock as ``t_mono``), sampled
    # at the stage boundary and emitted as ONE event at span end — so a
    # span can never be torn across lines.  ``name`` is a stage from
    # spans.SPAN_STAGES (the vocabulary is open: unknown names still
    # validate, consumers group by name).  Emitted from the driver
    # thread only, so spans always precede their scope's run_done.
    # Additive event type, introduced without a schema bump.
    "span": {"name": str, "tile_id": int, "start": _NUM, "end": _NUM},
    # live straggler verdict (obs/spans.StragglerDetector): this tile's
    # in-flight duration exceeded k x the rolling median of recent tile
    # durations.  duration_s >= threshold_s by construction (the value
    # lint in tools/check_events_schema.py pins it); in_flight=true
    # means the tile was still running when flagged (sampler scan) vs
    # flagged at completion.  Additive event type.
    "tile_straggler": {
        "tile_id": int,
        "duration_s": _NUM,
        "threshold_s": _NUM,
        "median_s": _NUM,
    },
    # --- elastic pod scheduling (runtime/leases) -------------------------
    # this host claimed a never-leased (or cleanly released) tile from
    # the shared-manifest lease queue at generation ``gen``.  Additive
    # event type, introduced without a schema bump.
    "tile_leased": {"tile_id": int, "gen": int},
    # this host STOLE a tile whose lease expired (dead/wedged peer) —
    # gen is the successor generation the steal claimed (>= 1 by
    # construction; the value lint pins it).  Additive.
    "lease_stolen": {"tile_id": int, "gen": int},
    # this host speculatively re-leased a straggler-flagged tile still
    # in flight on its owner: first durable write wins, the loser's
    # write lands as an identical no-op.  gen >= 1 like a steal.
    # Additive.
    "tile_speculated": {"tile_id": int, "gen": int},
    # the tile's result is ready on host (dispatch + device wait)
    "tile_done": {
        "tile_id": int,
        "px": int,
        "compute_s": _NUM,
        "px_per_s": _NUM,
        "feed_backlog": int,
        "write_backlog": int,
    },
    "tile_retry": {"tile_id": int, "attempt": int, "error": str},
    "tile_failed": {"tile_id": int, "attempts": int, "error": str},
    # a tile exhausted its retry budget under --quarantine-tiles: the run
    # continues without it (the manifest records it kind="tile_failed";
    # resume re-attempts it).  Always follows a tile_failed for the tile.
    "tile_quarantined": {"tile_id": int, "attempts": int, "error": str},
    # the deterministic fault injector (runtime/faults) fired a scheduled
    # fault: seam name, per-seam invocation index, error kind.  Emitted
    # only on injection runs — production streams never carry it.
    "fault_injected": {"seam": str, "index": int, "error": str},
    # the stall watchdog saw no tile progress for stall_timeout_s and is
    # aborting the run (exit code 4 via the CLI); idle_s is the observed
    # progress gap at the moment the watchdog fired
    "stall": {"idle_s": _NUM, "timeout_s": _NUM},
    # graceful degradation: repeated packed-fetch failures demoted the
    # device→host path to per-product synchronous transfers for the rest
    # of the run (artifacts are byte-identical either way)
    "fetch_demoted": {"failures": int},
    # the tile's artifact + manifest line are durable (emitted by
    # TileManifest.record, i.e. from a writer-pool thread)
    "write_done": {"tile_id": int, "bytes": int, "record_s": _NUM},
    # feed-path decode subsystem rollup (io/blockcache): one terminal
    # event per run scope with the counters accumulated over that run —
    # cache effectiveness, decode wall seconds (summed across threads),
    # and readahead effectiveness.  Additive event type: introduced
    # without a schema bump (older consumers flag it unknown; required
    # fields of EXISTING types are unchanged).
    "feed_cache": {
        "hits": int,
        "misses": int,
        "evictions": int,
        "decode_s": _NUM,
    },
    # device→host fetch subsystem rollup (runtime/fetch): one terminal
    # event per run scope — transfer counts (packed = 1 per tile), wire
    # bytes, and the pack/wait/unpack second split.  Additive event type,
    # introduced without a schema bump (like feed_cache).
    "fetch": {
        "tiles": int,
        "transfers": int,
        "bytes": int,
        "pack_s": _NUM,
        "wait_s": _NUM,
        "unpack_s": _NUM,
    },
    # host→device upload subsystem rollup (runtime/feed): one terminal
    # event per run scope — transfer counts (packed = 1 per tile), wire
    # bytes, and the host-pack / landing-wait / device-unpack second
    # split.  Additive event type, introduced without a schema bump.
    "upload": {
        "tiles": int,
        "transfers": int,
        "bytes": int,
        "pack_s": _NUM,
        "wait_s": _NUM,
        "unpack_s": _NUM,
    },
    # graceful degradation: repeated packed-upload failures demoted the
    # host→device path to per-array sync dispatch for the rest of the
    # run (artifacts are byte-identical either way)
    "upload_demoted": {"failures": int},
    # persistent ingest-store rollup (io/blockstore): one terminal event
    # per run scope on store-enabled runs — store tier effectiveness
    # (hits avoid TIFF decode entirely) and ingest volume.  Additive.
    "ingest_store": {
        "hits": int,
        "misses": int,
        "put_blocks": int,
        "put_bytes": int,
    },
    "run_done": {
        "status": str,  # "ok" | "aborted"
        "tiles_done": int,
        "pixels": int,
        "wall_s": _NUM,
        "px_per_s": _NUM,
        "fit_rate": _NUM,
    },
    # --- segmentation-as-a-service events (land_trendr_tpu_torch/serve) -------
    # a job passed admission control and entered the queue (server scope)
    "job_submitted": {
        "job_id": str,
        "tenant": str,
        "priority": int,
        "queue_depth": int,
    },
    # the dispatcher picked the job up; wait_s is its queue wait
    "job_start": {"job_id": str, "tenant": str, "wait_s": _NUM},
    # terminal job state (done / config_error / retries_exhausted /
    # stalled / cancelled / error — README §Service mode maps these onto
    # the CLI exit-code contract); wall_s is submit→terminal
    "job_done": {"job_id": str, "status": str, "wall_s": _NUM},
    # admission control refused a submission (429-style: queue full,
    # tenant cap) or the submission itself failed validation
    "job_rejected": {"reason": str, "queue_depth": int},
    # warm program cache verdict: one per run scope in serve mode (a
    # MISS paid compile_s compiling the run's programs against a dummy
    # tile; a HIT ran zero compiles), plus a server-scope aggregate at
    # shutdown.  Additive event type, like the subsystem rollups above.
    "program_cache": {"hits": int, "misses": int, "compile_s": _NUM},
    # --- flight recorder / live debug surface (obs/flight) --------------
    # periodic resource sample from the flight sampler thread: process
    # vitals required, host-contributed gauges (queue depths, backlogs,
    # cache/store occupancy, HBM watermark) optional.  Emitted through
    # the normal event log, so it lands in the stream, the flight ring,
    # and the obs_report trace counter tracks alike.  Additive.
    "flight_sample": {"rss_bytes": int, "open_fds": int, "threads": int},
    # one on-demand profiler capture attempt (POST /debug/profile): a
    # FAILED capture carries ok=false + error — the capture fails, the
    # job and the server do not.  Additive.
    "profile_captured": {"ok": bool, "duration_s": _NUM, "path": str},
    # per-job SLO accounting (serve): the latency split (queue wait vs
    # execution) and the deadline verdict for one terminal job.  A
    # deadline miss is ACCOUNTING, never enforcement — the job ran to
    # its natural terminal state (job_timeout_s is the enforcement
    # knob).  Additive.
    "job_slo": {
        "job_id": str,
        "tenant": str,
        "queue_wait_s": _NUM,
        "exec_s": _NUM,
        "latency_s": _NUM,
        "met": bool,
    },
    # --- fleet telemetry plane (obs/publish + aggregate + history +
    # --- alerts) --------------------------------------------------------
    # one alert-rule lifecycle transition (obs/alerts.AlertEngine over
    # the aggregated history ring): state is "firing" | "resolved" (the
    # value lint pins the enum AND firing-before-resolved ordering per
    # rule within a run scope).  duration_s is how long the condition
    # held before firing / how long the alert was firing before it
    # resolved — >= 0 by construction.  Additive event type.
    "alert": {
        "rule": str,
        "state": str,
        "value": _NUM,
        "threshold": _NUM,
        "duration_s": _NUM,
    },
    # one fleet-loop beat: the pod fold's host-health counts (the same
    # numbers the lt_fleet_* meta-gauges and the history-ring sample
    # carry), emitted through the server's event log so the pod's
    # health timeline rides the normal stream.  Additive event type.
    "fleet_sample": {"hosts": int, "stale_hosts": int},
    # --- serving fleet router (land_trendr_tpu_torch/fleet) --------------------
    # the router forwarded one job to a replica: ``warm`` is true when
    # the choice was affinity-driven (the replica's warm/sticky key set
    # contained the job's affinity key), false for the least-loaded
    # fallback.  Emitted once per SUCCESSFUL forward; the optional
    # ``attempt`` (>= 1) counts every forward TRY, so a job whose first
    # forward failed lands with one route_decision carrying attempt=2.
    # Additive event type.
    "route_decision": {
        "job_id": str,
        "tenant": str,
        "replica": str,
        "warm": bool,
    },
    # a replica joined the routable pool (spawned or adopted, or
    # recovered from unready).  Additive.
    "replica_up": {"replica": str},
    # a replica left the routable pool: ``reason`` is "health" (probe
    # failures), "dead" (spawned process exited), "scale_down" (drained
    # by the autoscaler) or "shutdown".  Its accepted jobs are NOT
    # failed — they re-route or keep polling.  Additive.
    "replica_down": {"replica": str, "reason": str},
    # router admission refused a submission with 429 + Retry-After:
    # ``reason`` is "tenant_quota" (per-tenant queued+routed bound) or
    # "queue_full" (router-wide queue bound).  Additive.
    "tenant_throttled": {"tenant": str, "reason": str, "queue_depth": int},
    # one autoscaler action: ``direction`` is "up" | "down", ``burn``
    # the pod burn-rate that drove it, ``replicas`` the pool size AFTER
    # the action was initiated.  Additive.
    "scale_decision": {"direction": str, "burn": _NUM, "replicas": int},
    # --- autotuned execution profiles (land_trendr_tpu_torch/tune) -------------
    # one knob-group calibration probe: ``ok=false`` means the group's
    # probe failed (the tune.probe fault seam or a real error) and was
    # SKIPPED — its knobs fell back to defaults; ``probes`` counts the
    # timed candidate reps the group ran (0 on a skipped group; >= 1 on
    # a succeeded one — the value lint pins it).  Additive event type.
    "tune_probe": {"group": str, "ok": bool, "probes": int, "wall_s": _NUM},
    # one profile verdict: ``source`` is "store" (reloaded on sight —
    # probes is 0 BY DEFINITION, the value lint pins it), "probed" (a
    # key miss or --retune ran the probes) or "defaults" (no store / no
    # profile for the key: the hardcoded knobs, byte-identical
    # behavior).  ``key`` is the store key
    # "device_kind|backend|shape_class" ("" for defaults).  Emitted by
    # `lt tune` and by every Run whose config resolved "auto" knobs.
    # Additive event type.
    "tune_profile": {"key": str, "source": str, "probes": int},
    # --- end-to-end request tracing (obs/reqtrace) -----------------------
    # one router-side segment of a request's journey: ``name`` is a
    # stage from REQUEST_SPAN_STAGES (open vocabulary, like ``span``),
    # ``start``/``end`` are monotonic-clock values on the emitting
    # scope's anchor clock (the ``span`` convention), and ``trace_id``
    # is the request correlation id minted at router (or serve)
    # admission.  A ``forward`` span is ONE hop: it carries the target
    # ``replica``, the ``attempt`` ordinal, and ``ok`` (a failed
    # forward is a span too — the re-route story needs both hops).
    # Additive event type.
    "request_span": {"trace_id": str, "name": str, "start": _NUM, "end": _NUM},
    # the request's terminal record at the router: the router-observed
    # end-to-end ``latency_s`` (admission to terminal) and the
    # router-side ``blame`` split — a consecutive partition of that
    # latency (route_queue / throttle_backoff / forward / replica), so
    # the components SUM to ``latency_s`` by construction (the value
    # lint pins it).  ``hops`` counts forward attempts (>= 2 means the
    # request was re-routed).  Additive event type.
    "request_done": {"trace_id": str, "status": str, "latency_s": _NUM},
    # --- fleet-scale load harness + capacity planner (loadgen/,
    # --- fleet/capacity) -------------------------------------------------
    # one load-rig phase transition: ``phase`` names the schedule
    # segment (free-form — "warmup" / "steady" / "wave" / "drain" /
    # "sweep@<qps>"...), ``mode`` is the arrival process ("open" =
    # offered-rate Poisson, "closed" = fixed-concurrency).  The offered
    # rate rides as the OPTIONAL ``offered_qps`` (strictly positive
    # when present — the value lint pins it): a closed-loop phase has
    # no offered rate by definition, only achieved throughput.
    # Additive event type.
    "load_phase": {"phase": str, "mode": str},
    # one capacity sweep point: a fixed ``replicas`` count driven at
    # ``offered_qps`` for one window, folded to the achieved rate, the
    # latency quantiles (p99 >= p50 — the value lint pins it), and
    # ``goodput_qps`` (terminal ``done`` per second — rejected and
    # failed submissions are throughput, not goodput).  The OPTIONAL
    # ``knee`` marks the detected knee of this replica count's curve
    # and ``knee_blame`` names the dominant assembled blame component
    # there (∈ the blame vocabulary + "other").  Additive.
    "sweep_point": {
        "replicas": int,
        "offered_qps": _NUM,
        "achieved_qps": _NUM,
        "p50_s": _NUM,
        "p99_s": _NUM,
        "goodput_qps": _NUM,
        "done": int,
        "failed": int,
        "rejected": int,
    },
    # one offline replay of a recorded decision log
    # (fleet/capacity.replay_decisions): ``decisions`` recorded,
    # ``matched`` reproduced byte-identically (``match`` ⇔ all of them
    # — the value lint pins the implication), and ``speedup_x`` =
    # recorded wall span / replay wall.  Additive event type.
    "sim_replay": {
        "decisions": int,
        "matched": int,
        "match": bool,
        "speedup_x": _NUM,
    },
    # --- cross-job continuous batching (serve/batching) ------------------
    # one coalesced device launch: ``jobs`` same-affinity member jobs
    # (>= 1 — a degenerate batch of one is today's path) whose tile
    # union (``tiles`` >= ``jobs`` when every member has work — the
    # value lint pins tiles >= jobs >= 1) runs through ONE warm
    # pipeline.  Stamped with the LEADER's job_id/trace_id; the optional
    # occupancy (useful px / padded px, 0 < occupancy <= 1 — pinned) and
    # window_wait_s (time spent holding the batch window open) carry the
    # packing efficiency story.  Additive event type.
    "batch_launch": {"jobs": int, "tiles": int},
    # batched results demuxed back to ONE member's manifest: ``tiles``
    # durable tile artifacts this member received from the shared launch
    # (byte-identical to a solo run's writes).  Stamped with the
    # MEMBER's job_id/trace_id, so blame attribution still
    # partitions each request exactly.  Additive event type.
    "batch_demux": {"tiles": int},
    # --- crash-safe control plane (fleet/journal) ------------------------
    # one durably committed admission-journal record: ``rec`` is the
    # record kind (∈ journal.RECORD_KINDS — "admitted" / "forwarded" /
    # "terminal"), ``segment`` the 1-based segment it landed in and
    # ``bytes`` the committed line size (both >= 1 — the value lint
    # pins them).  Emitted AFTER the os.write returns: an append the
    # seam or the disk failed never produces this event (the 503
    # ``journal_error`` rejection does not either — the job was never
    # admitted).  Additive event type.
    "journal_append": {"rec": str, "segment": int, "bytes": int},
    # one router restart's recovery summary: ``replayed`` non-terminal
    # jobs rebuilt from the journal, split into ``relayed`` (replica
    # finished during the outage — result relayed from its terminal
    # snapshot), ``requeued`` (replica gone — re-enqueued front-of-line
    # with resume semantics) and the optional ``reattached`` (replica
    # still running the job — polling resumed); the split sums to
    # ``replayed`` (the value lint pins relayed + requeued [+
    # reattached] <= replayed).  ``deduped`` counts idempotency keys
    # restored to the dedupe table, ``clean`` whether the previous
    # process wrote the clean-shutdown marker (probes skipped).
    # Additive event type.
    "router_recovered": {
        "replayed": int,
        "relayed": int,
        "requeued": int,
        "deduped": int,
        "recovery_s": _NUM,
        "clean": bool,
    },
}

#: the request-span stage vocabulary, in journey order (open like
#: SPAN_STAGES — unknown names still validate; consumers group by name)
REQUEST_SPAN_STAGES = ("route_queue", "throttle_backoff", "forward", "relay")

#: well-known OPTIONAL fields: type-checked when present, never required
OPTIONAL_FIELDS: dict[str, dict[str, Any]] = {
    # run identity + the scope's clock anchor: ``run_id`` names the run
    # scope pod-wide (correlation ID on every assembled span), and the
    # ``(anchor_wall, anchor_mono)`` pair — sampled TOGETHER by
    # EventLog.run_start — is what the pod-trace assembler
    # (obs/spans.assemble_pod_trace) aligns cross-host clocks with.
    # Optional so pre-anchor streams keep validating (consumers fall
    # back to the record's own t_wall/t_mono).
    "run_start": {"run_id": str, "anchor_wall": _NUM, "anchor_mono": _NUM},
    "span": {"attempt": int},
    "tile_straggler": {"in_flight": bool, "attempt": int},
    "tile_done": {"device_bytes_in_use": _NUM, "fetch_backlog": int},
    # no px_per_s here: the manifest meta's rate is over PADDED tile
    # pixels; tile_done's real-pixel px_per_s is the stream's one
    # throughput number (extra fields still validate — see module doc)
    "write_done": {"no_fit_rate": _NUM},
    "feed_cache": {
        "inserted_bytes": int,
        "readahead_blocks": int,
        "readahead_hits": int,
        "readahead_dropped": int,
        "cache_bytes": int,
        "budget_bytes": int,
        "corrupt_dropped": int,
    },
    "fetch": {"packed": bool, "backlog_max": int, "demoted": bool},
    "upload": {"packed": bool, "backlog_max": int, "demoted": bool},
    "ingest_store": {
        "stale_dropped": int,
        "corrupt_dropped": int,
        "evicted_segments": int,
        "bytes": int,
        "budget_bytes": int,
        "segments": int,
    },
    "run_done": {
        "stage_s": dict,
        "tiles_quarantined": int,
        # elastic scheduling rollups (lease runs only): tiles this host
        # STOLE from expired leases / ran speculatively
        "tiles_stolen": int,
        "tiles_speculated": int,
    },
    "tile_leased": {"owner": str},
    "lease_stolen": {"owner": str, "from_owner": str},
    "tile_speculated": {"owner": str, "from_owner": str},
    "job_submitted": {"source": str},
    "job_done": {"tiles_quarantined": int, "error": str},
    "job_rejected": {"job_id": str, "tenant": str},
    "program_cache": {"keys": int},
    "flight_sample": {
        "feed_backlog": int,
        "write_backlog": int,
        "fetch_backlog": int,
        "upload_backlog": int,
        "queue_depth": int,
        "running": int,
        "jobs_total": int,
        "warm_program_count": int,
        "cache_bytes": int,
        "store_bytes": int,
        "device_bytes_in_use": _NUM,
        "stragglers": int,
        "tiles_stolen": int,
        "tiles_speculated": int,
        # cross-job batching live state (the running leader's progress)
        "batch_jobs": int,
        "batch_tiles": int,
        "batch_occupancy": _NUM,
    },
    "profile_captured": {"error": str, "bytes": int},
    "job_slo": {"deadline_s": _NUM},
    "alert": {"window_s": _NUM},
    "fleet_sample": {
        "corrupt_snaps": int,
        "alerts_firing": int,
        "history_samples": int,
    },
    "route_decision": {
        "key": str,
        "attempt": int,
        "queue_wait_s": _NUM,
        "queue_depth": int,
    },
    "replica_up": {"base": str, "spawned": bool},
    "replica_down": {"base": str, "inflight": int},
    "scale_decision": {"replica": str, "queue_depth": int},
    "tune_probe": {"speedup": _NUM, "error": str, "knobs": dict},
    "tune_profile": {"age_s": _NUM, "knobs": dict, "groups": int},
    "request_span": {"replica": str, "attempt": int, "tenant": str, "ok": bool},
    "request_done": {"tenant": str, "hops": int, "blame": dict},
    "load_phase": {
        "offered_qps": _NUM,
        "requests": int,
        "workers": int,
        "duration_s": _NUM,
        "seed": int,
    },
    "sweep_point": {
        "knee": bool,
        "knee_blame": str,
        "window_s": _NUM,
        "assembled": int,
    },
    "sim_replay": {
        "recorded_span_s": _NUM,
        "replay_wall_s": _NUM,
        "mismatch_seq": int,
    },
    "batch_launch": {
        "padded_px": int,
        "occupancy": _NUM,
        "window_wait_s": _NUM,
    },
    "batch_demux": {"member_jobs": int},
    "router_recovered": {"reattached": int},
}

#: fields optional on EVERY event type — request-scoped threading the
#: serve layer stamps onto a whole run scope (``EventLog`` common
#: fields), so any tile/write/rollup event can be attributed to the job
#: that caused it.  ``trace_id`` is ``job_id``'s cross-layer sibling:
#: minted once at router (or serve) admission and carried through the
#: forward payload into the job's run scope, so router spans, serve
#: lifecycle events, and per-tile run events all join on one id.
#: Type-checked when present, never required.
COMMON_OPTIONAL_FIELDS: dict[str, Any] = {"job_id": str, "trace_id": str}


def events_path(workdir: str, process_index: int = 0, process_count: int = 1) -> str:
    """Canonical per-process event-log path under a run's workdir.

    Single-process runs write ``events.jsonl``; multihost runs write one
    file per process (``events.p<i>.jsonl``) into the shared workdir so
    appends never cross processes — the same per-host-output pattern the
    tile manifest's artifact writes use.
    """
    if process_count <= 1:
        return os.path.join(workdir, "events.jsonl")
    return os.path.join(workdir, f"events.p{process_index}.jsonl")


def _declared_process_count(p0_path: str) -> int | None:
    """The pod shape the latest run scope of ``events.p0.jsonl`` declares.

    ``run_start`` lines are rare (one per scope), so a forward filter scan
    is cheap relative to the full read every post-hoc consumer does
    anyway; any parse problem returns ``None`` (caller keeps everything).
    """
    last = None
    try:
        with open(p0_path) as f:
            for line in f:
                if '"ev":"run_start"' in line:
                    last = line
        if last is None:
            return None
        n = json.loads(last).get("process_count")
        return n if isinstance(n, int) and n > 0 else None
    except (OSError, json.JSONDecodeError):
        return None


def discover_event_files(
    workdir: str, process_count: int | None = None
) -> list[str]:
    """The event files that constitute a workdir's (latest) run.

    The one file-discovery contract every consumer shares (the multihost
    merge, ``tools/obs_report.py``, ``tools/check_events_schema.py``):
    when per-process pod files (``events.p<i>.jsonl``) exist they ARE the
    run, in process order — a bare ``events.jsonl`` alongside them is a
    stale single-process leftover in a reused workdir, not a host.
    Raises ``FileNotFoundError`` when the workdir has no event files.

    With ``process_count`` (a caller that KNOWS the run shape, like the
    pod primary's merge), only that shape's files are returned: leftover
    ``events.p2.jsonl``/``events.p3.jsonl`` from a previous 4-host run of
    a workdir now reused by 2 hosts are dead streams, not hosts.
    Without it, the shape is recovered from the stream itself — process 0
    always exists, and its latest ``run_start`` declares the current
    pod's ``process_count``, so the same leftovers are excluded for the
    post-hoc consumers too (unparseable p0 = keep everything, best
    effort).  When BOTH namings exist the more recently written set
    wins — the reuse could have gone in either direction.
    """
    if process_count is not None:
        expected = [
            events_path(workdir, i, process_count)
            for i in range(process_count)
        ]
        found = [p for p in expected if os.path.exists(p)]
        if not found:
            raise FileNotFoundError(
                f"no events files for a {process_count}-process run "
                f"under {workdir}"
            )
        return found
    pod = glob.glob(os.path.join(workdir, "events.p*.jsonl"))
    if pod:
        def pidx(p: str) -> int:
            m = re.search(r"events\.p(\d+)\.jsonl$", p)
            return int(m.group(1)) if m else -1
        pod = sorted(pod, key=pidx)
        shape = _declared_process_count(os.path.join(workdir, "events.p0.jsonl"))
        if shape is not None:
            pod = [p for p in pod if 0 <= pidx(p) < shape]
    single = os.path.join(workdir, "events.jsonl")
    has_single = os.path.exists(single)
    if pod and has_single:
        newest_pod = max(os.path.getmtime(p) for p in pod)
        return pod if newest_pod >= os.path.getmtime(single) else [single]
    if pod:
        return pod
    if has_single:
        return [single]
    raise FileNotFoundError(f"no events*.jsonl under {workdir}")


def expand_event_paths(paths: list[str]) -> list[str]:
    """CLI arguments → event files: the expansion both tools share.

    Each path is an event file OR a workdir (expanded via
    :func:`discover_event_files`, so stale files in a reused/resized
    workdir are excluded identically everywhere).  Raises
    ``FileNotFoundError`` for a missing file or an event-less workdir —
    callers turn that into their clean exit-2 path.  Lives here so
    ``obs_report`` and ``check_events_schema`` cannot drift on which
    files constitute a run.
    """
    out: list[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(discover_event_files(p))
        elif os.path.exists(p):
            out.append(p)
        else:
            raise FileNotFoundError(f"{p} does not exist")
    return out


class EventLog:
    """Append-only JSONL event stream with atomic thread-safe writes.

    Each :meth:`emit` serialises one event to a single ``os.write`` on an
    ``O_APPEND`` descriptor (atomic for regular files) under a lock, so
    concurrent emitters — the driver loop, the feed pool, the writer pool —
    can never interleave partial lines.  Timestamps are stamped here, not
    by callers, so every event's two clocks are sampled together.
    """

    def __init__(
        self,
        path: str,
        common: "dict[str, Any] | None" = None,
        mirror: "Callable[[dict], None] | None" = None,
    ) -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fd: int | None = os.open(
            path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644
        )
        self._lock = threading.Lock()
        #: fields stamped onto EVERY event of this log (request-scoped
        #: threading — e.g. ``{"job_id": ...}`` in serve mode); explicit
        #: per-emit fields win on collision
        self._common = dict(common or {})
        #: optional per-record tap — the flight recorder's ring
        #: (:meth:`land_trendr_tpu_torch.obs.flight.FlightRecorder.record`):
        #: called with the full stamped record AFTER the durable write,
        #: outside the write lock (the ring has its own, cheaper one)
        self._mirror = mirror

    def emit(self, ev: str, **fields: Any) -> dict:
        """Append one event line; returns the record as written."""
        rec = {
            "ev": ev,
            "t_wall": time.time(),
            "t_mono": time.perf_counter(),
            **self._common,
            **fields,
        }
        data = (json.dumps(rec, separators=(",", ":"), default=str) + "\n").encode()
        with self._lock:
            if self._fd is None:
                raise ValueError(f"EventLog {self.path} is closed")
            # the lock serializes the one O_APPEND write: one whole line per
            # event is the stream's durability contract
            # lt: noqa[LT007]
            n = os.write(self._fd, data)
            if n != len(data):
                # a short write (ENOSPC reached mid-line) tears the line;
                # the contract is raise-at-caller, never silent loss
                raise OSError(
                    f"short write to {self.path}: {n}/{len(data)} bytes"
                )
        if self._mirror is not None:
            self._mirror(rec)
        return rec

    def run_start(self, **fields: Any) -> dict:
        """``run_start`` with the ambient process facts filled in.

        Beyond the process identity, this stamps the scope's tracing
        correlation facts: a fresh ``run_id`` (names the scope pod-wide)
        and the ``(anchor_wall, anchor_mono)`` clock-anchor pair,
        sampled back to back HERE so the pair is as atomic as two clock
        reads get — the pod-trace assembler maps every event's ``t_mono``
        through this anchor, so pairing skew would become trace skew.
        """
        fields.setdefault("schema", SCHEMA_VERSION)
        fields.setdefault("pid", os.getpid())
        fields.setdefault("host", socket.gethostname())
        fields.setdefault("run_id", uuid.uuid4().hex[:12])
        has_wall = "anchor_wall" in fields
        has_mono = "anchor_mono" in fields
        if has_wall != has_mono:
            # half a pair is worse than none: pairing an explicit anchor
            # with a clock read taken NOW would silently shift every
            # assembled span by the gap between the two instants
            raise ValueError(
                "run_start needs anchor_wall and anchor_mono together "
                "(they are one atomically-sampled pair) or neither — got "
                f"only anchor_{'wall' if has_wall else 'mono'}"
            )
        if not has_wall:
            fields["anchor_wall"] = time.time()
            fields["anchor_mono"] = time.perf_counter()
        return self.emit("run_start", **fields)

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None

    def __enter__(self) -> "EventLog":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def run_scope_reset(rec: Any, default_process_index: "int | None" = None) -> dict:
    """The per-file aggregate fields a ``run_start`` record resets.

    Every consumer that folds a per-process event file scope-by-scope —
    :func:`summarize_events_file` here and ``tools/obs_report.fold`` —
    must reset the same identity + terminal fields when a new run scope
    opens, or a resumed file's earlier scope leaks into the rollup
    (previous ``run_done`` status surviving a fresh ``run_start`` was the
    exact hand-rolled-copy drift this primitive removes).  Identity
    fields come from the ``run_start`` record; terminal fields reset to
    ``None`` until the scope's own ``run_done`` arrives.
    """
    get = rec.get if isinstance(rec, dict) else (lambda *_: None)
    return {
        "process_index": get("process_index", default_process_index),
        "host": get("host"),
        "pid": get("pid"),
        "run_id": get("run_id"),
        "status": None,
        "wall_s": None,
        "px_per_s": None,
    }


def summarize_events_file(path: str) -> dict:
    """Fold one per-process event file into its LAST run scope's aggregate.

    The per-host rollup the multihost primary folds into the run summary
    (:func:`land_trendr_tpu_torch.parallel.multihost.merge_host_event_logs`).
    A resumed run appends a fresh ``run_start`` to the same file, so
    counters reset at every ``run_start`` — the summary describes the most
    recent run, which is the one the merging driver is part of.  Malformed
    lines are counted, not fatal: a crashed peer's torn final line must
    not take down the primary's summary.  Lives here, next to
    :data:`EVENT_FIELDS`, so the schema knowledge stays in one module.
    """
    agg: dict = {
        "events_file": path,
        "process_index": None,
        "host": None,
        "pid": None,
        "run_id": None,
        "tiles_done": 0,
        "tile_retries": 0,
        "tiles_failed": 0,
        "tiles_quarantined": 0,
        "stragglers": 0,
        "pixels": 0,
        "wall_s": None,
        "px_per_s": None,
        "status": None,
        "malformed_lines": 0,
    }
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                agg["malformed_lines"] += 1
                continue
            ev = rec.get("ev")
            if ev == "run_start":
                agg.update(
                    run_scope_reset(rec),
                    tiles_done=0,
                    tile_retries=0,
                    tiles_failed=0,
                    tiles_quarantined=0,
                    stragglers=0,
                    pixels=0,
                    # the torn final line of a crashed PREVIOUS scope must
                    # not flag the healthy resumed scope as corrupt
                    malformed_lines=0,
                )
            elif ev == "tile_done":
                agg["tiles_done"] += 1
                agg["pixels"] += int(rec.get("px", 0))
            elif ev == "tile_retry":
                agg["tile_retries"] += 1
            elif ev == "tile_failed":
                agg["tiles_failed"] += 1
            elif ev == "tile_quarantined":
                agg["tiles_quarantined"] += 1
            elif ev == "tile_straggler":
                agg["stragglers"] += 1
            elif ev == "run_done":
                agg["status"] = rec.get("status")
                agg["wall_s"] = rec.get("wall_s")
                agg["px_per_s"] = rec.get("px_per_s")
    return agg


def iter_events(path: str) -> Iterator[dict]:
    """Yield parsed event records; skips blank lines, raises on bad JSON."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                yield json.loads(line)


def validate_event(rec: Any, lineno: int | None = None) -> list[str]:
    """Schema errors for one record (empty list = valid).

    Required fields are a minimum — unknown extra fields pass, so older
    validators accept newer (compatible) streams.
    """
    where = f"line {lineno}: " if lineno is not None else ""
    if not isinstance(rec, dict):
        return [f"{where}event is not a JSON object: {type(rec).__name__}"]
    errs: list[str] = []
    ev = rec.get("ev")
    if ev not in EVENT_FIELDS:
        return [f"{where}unknown event type {ev!r}"]
    for name in ("t_wall", "t_mono"):
        v = rec.get(name)
        if not isinstance(v, _NUM) or isinstance(v, bool):
            errs.append(f"{where}{ev}: {name} missing or non-numeric ({v!r})")
    for name, typ in EVENT_FIELDS[ev].items():
        if name not in rec:
            errs.append(f"{where}{ev}: missing required field {name!r}")
        elif not isinstance(rec[name], typ) or (
            typ is not bool and isinstance(rec[name], bool)
        ):
            errs.append(
                f"{where}{ev}: field {name!r} has type "
                f"{type(rec[name]).__name__}, expected {typ}"
            )
    optional = {**COMMON_OPTIONAL_FIELDS, **OPTIONAL_FIELDS.get(ev, {})}
    for name, typ in optional.items():
        if name in EVENT_FIELDS[ev]:
            continue  # required wins (e.g. job_submitted.job_id)
        # same bool guard as required fields: isinstance(True, int) holds,
        # but a bool in a numeric field is producer drift, not a number
        if name in rec and (
            not isinstance(rec[name], typ)
            or (typ is not bool and isinstance(rec[name], bool))
        ):
            errs.append(
                f"{where}{ev}: optional field {name!r} has type "
                f"{type(rec[name]).__name__}, expected {typ}"
            )
    if ev == "run_start" and rec.get("schema") not in (None, SCHEMA_VERSION):
        errs.append(
            f"{where}run_start: schema version {rec.get('schema')!r} != "
            f"{SCHEMA_VERSION} (this validator)"
        )
    return errs


def validate_events_file(
    path: str, extra: "Callable[[Any, int], list[str]] | None" = None
) -> list[str]:
    """All schema errors in one JSONL event file (empty list = valid).

    Beyond per-record checks: the first event of the file must be a
    ``run_start`` (every later run scope re-opens with its own), and
    malformed JSON is an error, not a crash.  ``extra`` is an optional
    per-record hook ``(record, lineno) -> errors`` run in the SAME pass —
    how ``tools/check_events_schema.py`` adds its value-level feed_cache
    lint without a second parse of the file, with errors in line order.
    """
    errs: list[str] = []
    first_seen = False
    with open(path) as f:
        for i, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                errs.append(f"line {i}: malformed JSON ({e})")
                continue
            if not first_seen:
                first_seen = True
                if isinstance(rec, dict) and rec.get("ev") != "run_start":
                    errs.append(
                        f"line {i}: first event is {rec.get('ev')!r}, "
                        "expected 'run_start'"
                    )
            errs.extend(validate_event(rec, lineno=i))
            if extra is not None:
                errs.extend(extra(rec, i))
    if not first_seen:
        errs.append("file contains no events")
    return errs
