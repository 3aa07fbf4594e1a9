"""Serving fleet: the warm-affinity router / front door over N replicas.

One :class:`FleetRouter` process owns a pool of ``lt serve`` replicas
(spawned through the CLI or adopted by base URL), health-checks them
through ``/healthz``, and shards submitted jobs across them:

* **warm-affinity routing** — every request hashes to its
  :meth:`~land_trendr_tpu_torch.serve.jobs.JobRequest.affinity_key`; the
  router keeps a per-replica warm-key table (seeded from ``/healthz``'s
  ``warm_keys`` list, confirmed by routing feedback, and extended
  *optimistically* at forward time so the very next same-shape job
  already sticks) and routes repeat shapes to the replica that holds
  the compiled programs.  Fallback is least-loaded.  Warm decodes need
  no affinity at all: the ingest store's ``(path, mtime_ns, ...)``
  keying makes them safely shareable across replicas on one FS.
* **tenant fair share + quotas** — jobs queue per tenant and drain
  through deficit round-robin (``tenant_weights``), so a heavy tenant
  cannot starve a light one; a tenant at its ``tenant_quota`` (or a
  full router queue) is throttled with HTTP 429 + ``Retry-After``
  (``tenant_throttled`` event) instead of building unbounded backlog.
* **retry-on-replica-death** — the router pins every job's
  ``workdir``/``out_dir`` under ITS workdir and submits with
  ``resume=true``, so when a replica dies mid-job the re-routed
  submission resumes the same manifest on a sibling and completes
  byte-identically (recorded tiles stay durable; duplicate execution
  resolves at the manifest's first-write-wins rename).  Zero accepted
  jobs are lost to a replica SIGKILL — the invariant
  ``tools/fleet_bench.py`` and the fault soak pin.
* **SLO-driven autoscaling** — the control loop folds the shared
  telemetry directory (``obs.aggregate.fold_dir`` over replica
  snapshots — the fleet telemetry plane) for the pod ``lt_slo_burn_rate`` and
  feeds :class:`~land_trendr_tpu_torch.fleet.autoscale.Autoscaler`
  (AlertEngine rules + bounds + hold-down); scale-up spawns a replica,
  scale-down **drains before killing**: the victim stops receiving
  routes, its in-flight jobs finish, then SIGINT gives the ``lt
  serve`` process its documented clean shutdown — manifests stay
  resumable throughout.
* **crash-safe admission** — every accepted job is appended to a
  write-ahead journal (:class:`~land_trendr_tpu_torch.fleet.journal.
  AdmissionJournal`) BEFORE the client sees 200, with ``forwarded`` and
  ``terminal`` records following.  A restart on the same workdir
  replays the journal (queues rebuilt in admission order, duplicate
  idempotency keys answered with the existing job), re-adopts live
  spawned replicas from ``replicas/*/replica.json`` + ``/healthz``,
  and reconciles each non-terminal job against its replica: terminal →
  relay the result, running → re-attach, unknown → requeue with the
  pinned workdir so the resumed run completes byte-identically under
  the preserved trace id.  Submissions during the reconciliation
  window answer 503 + Retry-After; an uninterrupted drain leaves a
  clean-shutdown marker so the next start skips the probes.

Failure semantics: a failed forward (``router.forward`` seam) or a
dead/unready replica re-enters the job into its tenant queue (bounded
by ``route_retries``); a health-probe failure (``replica.health``
seam) marks the replica unready WITHOUT failing any accepted job — its
jobs keep polling and finish wherever they run.  A journal append
failure at admission (``router.journal`` seam) fails THAT submission
loudly (503 ``journal_error``) rather than accept a job a crash would
orphan; a reconciliation probe failure (``router.recover`` seam)
requeues the replayed job — resume makes the fallback safe.  The
router's own telemetry (``route_decision`` / ``replica_up`` /
``replica_down`` / ``tenant_throttled`` / ``scale_decision`` /
``journal_append`` / ``router_recovered`` events, ``lt_router_*``
metrics) rides the normal schema/registry, so schema lint,
``obs_report``, ``lt top`` and ``lt_fleet`` cover the routing plane
like every other subsystem.
"""

from __future__ import annotations

import collections
import dataclasses
import http.server
import json
import logging
import os
import select
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Any

from land_trendr_tpu_torch.fleet.autoscale import Autoscaler
from land_trendr_tpu_torch.fleet.config import RouterConfig, parse_tenant_weights
from land_trendr_tpu_torch.fleet.journal import AdmissionJournal, JournalError
from land_trendr_tpu_torch.fleet.scheduling import (
    DECISIONS_NAME,
    DecisionLog,
    DrrQueue,
    choose_replica,
)
from land_trendr_tpu_torch.obs.events import EventLog
from land_trendr_tpu_torch.obs.metrics import MetricsRegistry, PromFileExporter
from land_trendr_tpu_torch.runtime import faults
from land_trendr_tpu_torch.serve.jobs import TERMINAL_STATES, JobRequest
from land_trendr_tpu_torch.serve.server import Rejection

__all__ = ["DOWN_REASONS", "FleetRouter", "RouterJob"]

log = logging.getLogger("land_trendr_tpu_torch.fleet")

#: replica_down reason vocabulary (value-linted by
#: ``tools/check_events_schema.py`` — the two tables are asserted equal
#: in tests/test_fleet_serve.py)
DOWN_REASONS = ("health", "dead", "scale_down", "shutdown")

#: router job-latency histogram buckets (the serve buckets)
_JOB_BUCKETS = (0.5, 1, 2, 5, 10, 30, 60, 300, 1800, 7200, 43200)

#: per-replica warm/sticky key table bound (recency-evicted)
_WARM_KEYS_MAX = 128

#: HTTP timeout for health probes and job polls, seconds
_PROBE_TIMEOUT_S = 10.0
#: HTTP timeout for job forwards (the replica answers from its
#: admission path — queueing, not execution)
_FORWARD_TIMEOUT_S = 30.0
#: how long a spawned replica may take to print its startup line (cold
#: torch import, the device's context + port bind)
_SPAWN_TIMEOUT_S = 180.0
#: clean-shutdown drain bound: in-flight jobs get this long to finish
#: before spawned replicas are stopped anyway
_DRAIN_TIMEOUT_S = 600.0


def _http_json(
    method: str, url: str, payload: "dict | None" = None,
    timeout: float = _PROBE_TIMEOUT_S,
) -> "tuple[int, Any]":
    """One JSON round-trip; returns ``(status, body)``.  4xx/5xx with a
    JSON body return normally (admission verdicts); transport errors
    (refused, reset, timeout) raise ``OSError``/``URLError``."""
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        try:
            return e.code, json.loads(e.read())
        except (ValueError, OSError):
            return e.code, {}


def _split_device(args: "tuple[str, ...]") -> "tuple[list[str], list[str]]":
    """``replica_args`` split into the CLI's top-level ``--device`` flag
    (``["--device", D]``, or nothing: the replica's default, the card) and
    the ``serve`` flags: the device flag precedes the subcommand."""
    device: "list[str]" = []
    rest: "list[str]" = []
    it = iter(args)
    for a in it:
        if a == "--device":
            device = [a, next(it, "")]
        elif a.startswith("--device="):
            device = ["--device", a.split("=", 1)[1]]
        else:
            rest.append(a)
    return device, rest


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


@dataclasses.dataclass
class RouterJob:
    """One accepted job's router-side record (mutated under the router
    lock; snapshots are JSON-safe copies)."""

    job_id: str
    payload: dict
    tenant: str
    priority: int
    key: str
    workdir: str
    out_dir: str
    source: str = "http"
    state: str = "queued"  # queued | routed | TERMINAL_STATES
    replica: "str | None" = None
    replica_job_id: "str | None" = None
    #: the request-tracing correlation id, minted at router admission
    #: and carried through every forward payload (re-routes keep it)
    trace_id: str = ""
    #: the client's resubmission token, remembered in the admission
    #: journal: a duplicate submission (before OR after a router
    #: restart) returns THIS job instead of double-running
    idempotency_key: "str | None" = None
    #: forward attempts so far (1 = first route; > 1 = re-routed).
    #: NOT the trace's hop count: a replica-side 429 deliberately
    #: refunds the attempt (saturation is not a route failure), so the
    #: retry-budget counter can move backwards — ``hops`` below is the
    #: monotone forward-try count the tracing plane reports
    attempts: int = 0
    #: forward tries EVER made (monotone): the ``request_span`` hop
    #: ordinal and ``request_done.hops`` — >= 2 means re-routed
    hops: int = 0
    submitted_t: float = dataclasses.field(default_factory=time.time)
    routed_t: "float | None" = None
    finished_t: "float | None" = None
    error: "str | None" = None
    #: the replica's last job snapshot (carries summary/outputs at
    #: terminal — the client's result body)
    snap: "dict | None" = None
    poll_fails: int = 0
    cancel_requested: bool = False
    # -- request-tracing bookkeeping (mutated under the router lock) ------
    #: when the CURRENT queue wait began (the t_mono clock — the same
    #: perf_counter the event log stamps, so spans anchor cleanly)
    queue_enter_mono: float = dataclasses.field(
        default_factory=time.perf_counter
    )
    #: the pending queue wait is a 429 backoff, not a plain queue wait
    backoff_pending: bool = False
    #: router-side blame accumulators (seconds) — the request_done
    #: split derives from these, replica time is the exact residual
    blame_acc: dict = dataclasses.field(
        default_factory=lambda: {
            "route_queue": 0.0, "throttle_backoff": 0.0,
            "forward": 0.0, "relay": 0.0,
        }
    )

    def status_locked(self) -> dict:
        out = {
            "job_id": self.job_id,
            "trace_id": self.trace_id,
            "state": self.state,
            "tenant": self.tenant,
            "priority": self.priority,
            "key": self.key,
            "replica": self.replica,
            "replica_job_id": self.replica_job_id,
            "attempts": self.attempts,
            "submitted_t": self.submitted_t,
            "routed_t": self.routed_t,
            "finished_t": self.finished_t,
            "workdir": self.workdir,
            "out_dir": self.out_dir,
        }
        if self.idempotency_key is not None:
            out["idempotency_key"] = self.idempotency_key
        if self.error is not None:
            out["error"] = self.error
        if self.snap is not None:
            out["result"] = self.snap
        return out


class _Replica:
    """One pool member (mutated under the router lock except where
    noted; the HTTP traffic to it happens outside the lock)."""

    def __init__(
        self, rid: str, base: str, spawned: bool,
        proc: "subprocess.Popen | None" = None,
        workdir: "str | None" = None,
    ) -> None:
        self.rid = rid
        self.base = base.rstrip("/")
        self.spawned = spawned
        self.proc = proc
        self.workdir = workdir
        #: starting → ready ⇄ unready, draining → stopped
        self.state = "starting"
        #: affinity keys warm (confirmed via /healthz or a completed
        #: job) or sticky (optimistically assigned at forward time) on
        #: this replica — recency-ordered, bounded
        self.warm: "collections.OrderedDict[str, float]" = (
            collections.OrderedDict()
        )
        #: router job ids currently routed here
        self.inflight: "set[str]" = set()
        #: a re-adopted replica's recorded pid (the previous router
        #: incarnation spawned it; this one owns no Popen handle)
        self.adopted_pid: "int | None" = None
        self.fails = 0
        self.last_health: "dict | None" = None
        self.last_health_t: "float | None" = None
        #: saturation cooldown (monotonic deadline): set when the
        #: replica answers 429 from its own admission — the router
        #: skips it until then instead of sleeping the dispatcher
        self.backoff_until = 0.0

    def note_key_locked(self, key: str) -> None:
        self.warm[key] = time.time()
        self.warm.move_to_end(key)
        while len(self.warm) > _WARM_KEYS_MAX:
            self.warm.popitem(last=False)

    def row_locked(self) -> dict:
        h = self.last_health or {}
        return {
            "replica": self.rid,
            "base": self.base,
            "state": self.state,
            "spawned": self.spawned,
            "inflight": len(self.inflight),
            "warm_keys": len(self.warm),
            "fails": self.fails,
            "queue_depth": h.get("queue_depth"),
            "running": h.get("running"),
            "warm_program_count": h.get("warm_program_count"),
            "health_age_s": (
                round(time.time() - self.last_health_t, 3)
                if self.last_health_t is not None else None
            ),
        }


class _RouterTelemetry:
    """The router's own events scope + ``lt_router_*`` instruments
    (the serve telemetry bundle's thin sibling: event log, registry,
    ``metrics.prom`` exporter, optional fleet publisher)."""

    def __init__(self, cfg: RouterConfig, publish_probes=None) -> None:
        os.makedirs(cfg.workdir, exist_ok=True)
        # every teardown-touched handle predeclared (the LT008 lesson):
        # _release() must be callable from any construction depth
        self._exporter: "PromFileExporter | None" = None
        self._publisher = None
        self.events = EventLog(os.path.join(cfg.workdir, "events.jsonl"))
        try:
            self.registry = MetricsRegistry()
            r = self.registry
            self._routed = r.counter(
                "lt_router_jobs_routed_total",
                "job forwards to a replica (re-routes included)",
            )
            self._warm_routed = r.counter(
                "lt_router_warm_routed_total",
                "forwards whose replica choice was warm-affinity-driven",
            )
            self._rerouted = r.counter(
                "lt_router_rerouted_total",
                "re-forwards after a failed forward or a dead/unready "
                "replica (attempt >= 2)",
            )
            self._throttled = r.counter(
                "lt_router_throttled_total",
                "submissions throttled 429 (tenant quota / queue full)",
            )
            self._queue_depth = r.gauge(
                "lt_router_queue_depth",
                "jobs queued at the router awaiting a replica",
            )
            self._replicas_ready = r.gauge(
                "lt_router_replicas_ready", "replicas currently routable"
            )
            self._replicas_total = r.gauge(
                "lt_router_replicas",
                "pool members not yet stopped (spawned + adopted)",
            )
            self._queue_wait_hist = r.histogram(
                "lt_router_queue_wait_seconds",
                "router queue wait, submit to first forward",
                buckets=_JOB_BUCKETS,
            )
            self._job_hist = r.histogram(
                "lt_router_job_seconds",
                "job latency through the router, submit to terminal",
                buckets=_JOB_BUCKETS,
            )
            self._jobs_done: "dict[str, Any]" = {}
            self._scales: "dict[str, Any]" = {}
            self.events.run_start(
                fingerprint="route",
                process_index=0,
                process_count=1,
                tiles_total=0,
                tiles_todo=0,
                tiles_skipped_resume=0,
                mesh_devices=0,
                impl="route",
            )
            self._exporter = PromFileExporter(
                self.registry,
                os.path.join(cfg.workdir, "metrics.prom"),
                interval_s=cfg.metrics_interval_s,
            ).start()
            if cfg.telemetry_dir is not None or cfg.spawn_replicas:
                from land_trendr_tpu_torch.obs.publish import (
                    TelemetryPublisher,
                    telemetry_dir,
                )

                self._publisher = TelemetryPublisher(
                    cfg.telemetry_dir or telemetry_dir(cfg.workdir),
                    self.registry,
                    probes=publish_probes,
                    interval_s=cfg.health_interval_s * 2,
                    kind="route",
                )
                self._publisher.start()
        except BaseException:
            self._release()
            raise

    def _release(self) -> None:
        try:
            if self._publisher is not None:
                self._publisher.stop()
                self._publisher = None
        finally:
            try:
                if self._exporter is not None:
                    self._exporter.stop()
                    self._exporter = None
            finally:
                self.events.close()

    def _done_counter(self, status: str):
        c = self._jobs_done.get(status)
        if c is None:
            c = self._jobs_done[status] = self.registry.counter(
                "lt_router_jobs_done_total",
                "router jobs reaching a terminal state, by status",
                labels={"status": status},
            )
        return c

    def _scale_counter(self, direction: str):
        c = self._scales.get(direction)
        if c is None:
            c = self._scales[direction] = self.registry.counter(
                "lt_router_scale_total",
                "autoscaler actions, by direction",
                labels={"direction": direction},
            )
        return c

    # -- router hooks ------------------------------------------------------
    def job_submitted(self, job: RouterJob, queue_depth: int) -> None:
        self.events.emit(
            "job_submitted",
            job_id=job.job_id,
            trace_id=job.trace_id,
            tenant=job.tenant,
            priority=job.priority,
            queue_depth=queue_depth,
            source=job.source,
        )
        self._queue_depth.set(queue_depth)

    def request_span(
        self,
        job: RouterJob,
        name: str,
        start: float,
        end: float,
        replica: "str | None" = None,
        attempt: "int | None" = None,
        ok: "bool | None" = None,
    ) -> None:
        """One router-side segment of the request's journey (``start``/
        ``end`` on the t_mono clock, the ``span`` convention): queue
        waits, throttle backoffs, each forward HOP (failed ones too —
        the re-route story needs both), the terminal result relay."""
        fields: dict = {}
        if replica is not None:
            fields["replica"] = replica
        if attempt is not None:
            fields["attempt"] = attempt
        if ok is not None:
            fields["ok"] = bool(ok)
        self.events.emit(
            "request_span",
            trace_id=job.trace_id,
            job_id=job.job_id,
            name=name,
            start=round(start, 6),
            end=round(end, 6),
            tenant=job.tenant,
            **fields,
        )

    def request_done(
        self, job: RouterJob, latency_s: float, blame: dict, hops: int
    ) -> None:
        """The request's terminal record: the router-observed latency
        and its router-side blame partition (components sum to
        ``latency_s`` by construction — the value lint pins it)."""
        self.events.emit(
            "request_done",
            trace_id=job.trace_id,
            job_id=job.job_id,
            status=job.state,
            latency_s=round(latency_s, 6),
            tenant=job.tenant,
            hops=hops,
            blame=blame,
        )

    def job_rejected(self, reason: str, queue_depth: int) -> None:
        self.events.emit(
            "job_rejected", reason=reason, queue_depth=queue_depth
        )

    def journal_append(
        self, rec: str, segment: int, nbytes: int,
        job_id: "str | None" = None, trace_id: "str | None" = None,
    ) -> None:
        """One durably-committed admission-journal record."""
        fields: dict = {}
        if job_id:
            fields["job_id"] = job_id
        if trace_id:
            fields["trace_id"] = trace_id
        self.events.emit(
            "journal_append",
            rec=rec,
            segment=segment,
            bytes=nbytes,
            **fields,
        )

    def router_recovered(
        self, replayed: int, relayed: int, requeued: int,
        reattached: int, deduped: int, recovery_s: float, clean: bool,
    ) -> None:
        """The restart-reconciliation summary: every replayed
        non-terminal job landed in exactly one of relay / re-attach /
        requeue (the value lint pins the arithmetic)."""
        self.events.emit(
            "router_recovered",
            replayed=replayed,
            relayed=relayed,
            requeued=requeued,
            reattached=reattached,
            deduped=deduped,
            recovery_s=round(max(0.0, recovery_s), 6),
            clean=bool(clean),
        )

    # the capacity rig's emitters, borrowed from the serve Telemetry
    # bundle (they only touch ``self.events``): the load runner and
    # sweep analyzer report through whichever plane drives them, and
    # the single emit-site definition stays under the LT005 producer
    # check in obs/telemetry.py
    from land_trendr_tpu_torch.obs.telemetry import Telemetry as _T

    load_phase = _T.load_phase
    sweep_point = _T.sweep_point
    sim_replay = _T.sim_replay
    del _T

    def tenant_throttled(
        self, tenant: str, reason: str, queue_depth: int
    ) -> None:
        self.events.emit(
            "tenant_throttled",
            tenant=tenant,
            reason=reason,
            queue_depth=queue_depth,
        )
        self._throttled.inc()

    def route_decision(
        self, job: RouterJob, replica: str, warm: bool,
        queue_depth: int, wait_s: float,
    ) -> None:
        self.events.emit(
            "route_decision",
            job_id=job.job_id,
            trace_id=job.trace_id,
            tenant=job.tenant,
            replica=replica,
            warm=bool(warm),
            key=job.key,
            attempt=job.attempts,
            queue_wait_s=round(max(0.0, wait_s), 6),
            queue_depth=queue_depth,
        )
        self._routed.inc()
        if warm:
            self._warm_routed.inc()
        if job.attempts > 1:
            self._rerouted.inc()
        else:
            self._queue_wait_hist.observe(
                max(0.0, wait_s), exemplar=job.trace_id or None
            )
        self._queue_depth.set(queue_depth)

    def replica_up(self, replica: _Replica) -> None:
        self.events.emit(
            "replica_up",
            replica=replica.rid,
            base=replica.base,
            spawned=replica.spawned,
        )

    def replica_down(self, replica: _Replica, reason: str) -> None:
        self.events.emit(
            "replica_down",
            replica=replica.rid,
            reason=reason,
            base=replica.base,
            inflight=len(replica.inflight),
        )

    def scale_decision(
        self, direction: str, burn: float, replicas: int,
        queue_depth: int, replica: "str | None" = None,
    ) -> None:
        fields: dict = {}
        if replica is not None:
            fields["replica"] = replica
        self.events.emit(
            "scale_decision",
            direction=direction,
            burn=round(max(0.0, float(burn)), 6),
            replicas=replicas,
            queue_depth=queue_depth,
            **fields,
        )
        self._scale_counter(direction).inc()

    def job_done(self, job: RouterJob, wall_s: float) -> None:
        fields: dict = {}
        if job.error:
            fields["error"] = job.error
        self.events.emit(
            "job_done",
            job_id=job.job_id,
            trace_id=job.trace_id,
            status=job.state,
            wall_s=round(wall_s, 6),
            **fields,
        )
        # the exemplar closes the metrics→traces loop: the bucket this
        # request landed in remembers its trace_id, so the p99 bucket
        # names requests lt_request can assemble
        self._job_hist.observe(wall_s, exemplar=job.trace_id or None)
        self._done_counter(job.state).inc()

    def pool_gauges(self, ready: int, total: int) -> None:
        self._replicas_ready.set(ready)
        self._replicas_total.set(total)

    def close(self, status: str, wall_s: float) -> None:
        try:
            self.events.emit(
                "run_done",
                status=status,
                tiles_done=0,
                pixels=0,
                wall_s=round(wall_s, 3),
                px_per_s=0.0,
                fit_rate=0.0,
            )
        finally:
            self._release()


class FleetRouter:
    """The serving fleet's front door (see the module docstring)."""

    def __init__(self, cfg: RouterConfig) -> None:
        self.cfg = cfg
        os.makedirs(cfg.workdir, exist_ok=True)
        self._lock = threading.Lock()
        # the condition WRAPS self._lock (the serve-server discipline)
        self._cond = threading.Condition(self._lock)
        self._jobs: "dict[str, RouterJob]" = {}
        #: tenant fair-share scheduling: the shared pure DRR core
        #: (fleet/scheduling.py — the capacity simulator replays the
        #: SAME class from the recorded decision log)
        self._weights = parse_tenant_weights(cfg.tenant_weights)
        self._drr = DrrQueue(self._weights)
        self._terminal = 0
        self._seq = 0
        self._rid_seq = 0
        self._stopping = False
        #: recovery-window gate: while a restarted router reconciles
        #: its journal, submissions answer 503 + Retry-After
        self._recovering = False
        #: idempotency-key → job_id (journal-replayed: survives restarts)
        self._idempotency: "dict[str, str]" = {}
        #: replayed non-terminal jobs awaiting reconciliation, in
        #: admission order: (job, folded journal record)
        self._pending_recovery: "list[tuple[RouterJob, dict]]" = []
        #: set by _replay_journal when the journal held any state —
        #: {"replayed": n, "deduped": keys_restored}
        self._replay_stats: "dict | None" = None
        #: the last recovery's summary (stats() serves it; lt top
        #: renders the RECOVERY line from it)
        self.recovery: "dict | None" = None
        self.pool: "list[_Replica]" = []
        #: recent TERMINAL requests (trace id, router blame split,
        #: hops) — the /debug/requests window, newest last, bounded
        #: (mutated under the router lock; 0 = an always-empty ring)
        self._recent_requests: "collections.deque" = collections.deque(
            maxlen=cfg.request_ring
        )

        from land_trendr_tpu_torch.obs.publish import telemetry_dir

        self._telemetry_dir = cfg.telemetry_dir or telemetry_dir(cfg.workdir)
        self.scaler = (
            Autoscaler(
                min_replicas=cfg.min_replicas,
                max_replicas=cfg.max_replicas,
                up_burn=cfg.scale_up_burn,
                down_burn=cfg.scale_down_burn,
                for_s=cfg.scale_for_s,
                hold_s=cfg.scale_hold_s,
            )
            if cfg.autoscale else None
        )

        # every teardown-touched handle predeclared, so _shutdown is
        # callable from any depth of a failed construction (LT008)
        self.telemetry: "_RouterTelemetry | None" = None
        self._decisions: "DecisionLog | None" = None
        self._journal: "AdmissionJournal | None" = None
        self._fault_plan = None
        self._httpd = None
        self._http_thread = None
        self._control_stop = threading.Event()
        self._control_thread: "threading.Thread | None" = None
        self._t0 = time.time()

        try:
            if cfg.telemetry:
                self.telemetry = _RouterTelemetry(
                    cfg, publish_probes=self._fleet_probes
                )
            if cfg.decision_log:
                # recorded decision inputs+outputs — what the capacity
                # replay simulator re-executes byte-identically
                self._decisions = DecisionLog(
                    os.path.join(cfg.workdir, DECISIONS_NAME)
                )
                self._decisions.record(
                    "config",
                    weights=self._weights,
                    affinity=cfg.affinity,
                    autoscale=(
                        {
                            "min_replicas": cfg.min_replicas,
                            "max_replicas": cfg.max_replicas,
                            "up_burn": cfg.scale_up_burn,
                            "down_burn": cfg.scale_down_burn,
                            "for_s": cfg.scale_for_s,
                            "hold_s": cfg.scale_hold_s,
                        }
                        if cfg.autoscale else None
                    ),
                )
            if cfg.fault_schedule:
                self._fault_plan = faults.activate(
                    faults.parse_schedule(cfg.fault_schedule)
                )
                log.warning(
                    "router fault injection ACTIVE (%s) — this is a "
                    "soak run", cfg.fault_schedule,
                )
            if cfg.journal:
                # the journal opens AFTER the fault plan activates (its
                # appends fire the router.journal seam) and replays
                # BEFORE any admission can land
                self._journal = AdmissionJournal(
                    os.path.join(cfg.workdir, "journal"),
                    segment_bytes=cfg.journal_segment_mb * 2 ** 20,
                )
                self._replay_journal()
            self._readopt_replicas()
            for base in cfg.replicas:
                self._adopt_replica(base)
            if cfg.spawn_replicas:
                self._spawn_replicas(cfg.spawn_replicas)

            self._httpd = _RouterAPIServer(
                (cfg.route_host, cfg.route_port), self
            )
            self.port = int(self._httpd.server_address[1])
            http_thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="lt-route-http",
                daemon=True,
            )
            # bound only AFTER a successful start: shutdown() keys on it
            http_thread.start()
            self._http_thread = http_thread

            self._control_thread = threading.Thread(
                target=self._control_loop,
                name="lt-route-control",
                daemon=True,
            )
            self._control_thread.start()
            # reconciliation runs with the front door ALREADY serving
            # (503 + Retry-After during the window): by the time the
            # constructor returns, replayed jobs are relayed,
            # re-attached, or requeued-with-resume
            self._recover()
        except BaseException:
            self._shutdown(status="aborted")
            raise
        log.info(
            "routing on %s:%d over %d replica(s)%s",
            cfg.route_host, self.port, len(self.pool),
            " (autoscale on)" if self.scaler is not None else "",
        )

    # -- pool construction -------------------------------------------------
    def _next_rid_locked(self) -> str:
        self._rid_seq += 1
        return f"r{self._rid_seq - 1}"

    def _adopt_replica(self, base: str) -> None:
        with self._lock:
            rid = self._next_rid_locked()
            replica = _Replica(rid, base, spawned=False)
            self.pool.append(replica)
        # first health probe promotes it to ready (and emits replica_up)
        self._probe_replica(replica)

    def _spawn_replicas(self, n: int) -> None:
        """Spawn ``n`` replicas via the ``lt serve`` CLI: launch every
        process first (their cold imports and device set-up overlap), then read each
        startup line for the bound port."""
        started = [self._launch_replica_proc() for _ in range(n)]
        for replica in started:
            self._await_replica_start(replica)

    def _launch_replica_proc(self) -> _Replica:
        with self._lock:
            rid = self._next_rid_locked()
        rdir = os.path.join(self.cfg.workdir, "replicas", rid)
        os.makedirs(rdir, exist_ok=True)
        device, serve_args = _split_device(self.cfg.replica_args)
        cmd = [
            sys.executable, "-m", "land_trendr_tpu_torch", *device, "serve",
            "--workdir", rdir, "--serve-port", "0",
            "--publish", "--telemetry-dir", self._telemetry_dir,
            "--publish-interval-s", str(max(1.0, self.cfg.health_interval_s)),
            *serve_args,
        ]
        logf = open(os.path.join(rdir, "serve.log"), "ab")
        try:
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=logf, text=True,
            )
        finally:
            # the child inherited the fd; the parent's handle is done
            logf.close()
        replica = _Replica(
            rid, base="pending", spawned=True, proc=proc, workdir=rdir
        )
        with self._lock:
            self.pool.append(replica)
        return replica

    def _await_replica_start(self, replica: _Replica) -> None:
        """Read the spawned replica's startup line (``{"serving": true,
        "port": N, ...}``) and point its base URL at the bound port."""
        proc = replica.proc
        assert proc is not None and proc.stdout is not None
        deadline = time.monotonic() + _SPAWN_TIMEOUT_S
        line = ""
        while time.monotonic() < deadline:
            if proc.poll() is not None:
                break
            ready, _, _ = select.select(
                [proc.stdout], [], [], min(1.0, deadline - time.monotonic())
            )
            if ready:
                line = proc.stdout.readline()
                break
        try:
            startup = json.loads(line) if line else None
        except json.JSONDecodeError:
            startup = None
        if not startup or not startup.get("serving"):
            tail = self._replica_log_tail(replica)
            raise RuntimeError(
                f"spawned replica {replica.rid} never reported its port "
                f"(exit={proc.poll()}); serve.log tail:\n{tail}"
            )
        with self._lock:
            replica.base = f"http://127.0.0.1:{int(startup['port'])}"
        self._persist_replica_meta(replica)
        self._probe_replica(replica)

    def _replica_log_tail(self, replica: _Replica, n: int = 2000) -> str:
        if not replica.workdir:
            return ""
        try:
            with open(os.path.join(replica.workdir, "serve.log"), "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - n))
                return f.read().decode(errors="replace")
        except OSError:
            return ""

    def _persist_replica_meta(self, replica: _Replica) -> None:
        """Record the spawned replica's base URL + pid (tmp + rename) so
        a restarted router can re-adopt the still-running process."""
        if not replica.workdir:
            return
        path = os.path.join(replica.workdir, "replica.json")
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(
                    {
                        "base": replica.base,
                        "pid": (
                            replica.proc.pid if replica.proc is not None
                            else replica.adopted_pid
                        ),
                    },
                    f,
                )
            os.replace(tmp, path)
        except OSError as e:
            log.warning(
                "replica meta persist failed for %s: %s", replica.rid, e
            )

    def _readopt_replicas(self) -> None:
        """Re-adopt live spawned replicas a crashed router left behind:
        scan ``replicas/*/replica.json``, keep the members whose
        recorded pid is alive AND whose ``/healthz`` answers, under
        their original rids.  The rid sequence advances past every
        existing dir first, so fresh spawns never collide with a
        re-adopted member's workdir."""
        root = os.path.join(self.cfg.workdir, "replicas")
        try:
            names = sorted(os.listdir(root))
        except OSError:
            return
        with self._lock:
            for name in names:
                if name.startswith("r") and name[1:].isdigit():
                    self._rid_seq = max(self._rid_seq, int(name[1:]) + 1)
        for name in names:
            rdir = os.path.join(root, name)
            try:
                with open(
                    os.path.join(rdir, "replica.json"), encoding="utf-8"
                ) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                continue
            base, pid = meta.get("base"), meta.get("pid")
            if not isinstance(base, str) or not isinstance(pid, int):
                continue
            if not _pid_alive(pid):
                continue
            try:
                status, _body = _http_json("GET", base + "/healthz")
            except Exception:
                continue
            if status != 200:
                continue
            replica = _Replica(
                name, base, spawned=True, proc=None, workdir=rdir
            )
            replica.adopted_pid = pid
            with self._lock:
                self.pool.append(replica)
            self._probe_replica(replica)
            log.info(
                "re-adopted replica %s at %s (pid %d)", name, base, pid
            )

    # -- crash recovery (journal replay + reconciliation) ------------------
    def _replay_journal(self) -> None:
        """Fold the journal into the job table: terminal jobs
        re-register (status GETs and idempotency dedupe keep answering
        across the restart), non-terminal ones queue for reconciliation
        in admission order."""
        folded = self._journal.replay()
        if not folded:
            return
        pending: "list[tuple[RouterJob, dict]]" = []
        keys = 0
        with self._lock:
            for jid, rec in folded.items():
                payload = rec.get("payload")
                if not isinstance(payload, dict):
                    continue
                job = RouterJob(
                    job_id=jid,
                    payload=payload,
                    tenant=str(rec.get("tenant") or "default"),
                    priority=int(rec.get("priority") or 0),
                    key=str(rec.get("key") or ""),
                    workdir=str(rec.get("workdir") or ""),
                    out_dir=str(rec.get("out_dir") or ""),
                    source=str(rec.get("source") or "journal"),
                    trace_id=str(rec.get("trace_id") or jid),
                )
                ikey = rec.get("idempotency_key")
                if isinstance(ikey, str) and ikey:
                    job.idempotency_key = ikey
                    self._idempotency[ikey] = jid
                    keys += 1
                t = rec.get("t")
                if isinstance(t, (int, float)):
                    job.submitted_t = float(t)
                if rec["status"] == "terminal":
                    job.state = str(rec.get("state") or "error")
                    job.error = rec.get("error")
                    self._terminal += 1
                else:
                    job.replica_job_id = rec.get("replica_job_id")
                    if rec["status"] == "forwarded":
                        # one forward happened in the previous life —
                        # the trace's hop ordinal continues from it
                        job.attempts = job.hops = 1
                    pending.append((job, rec))
                self._jobs[jid] = job
            self._pending_recovery = pending
            self._replay_stats = {"replayed": len(pending), "deduped": keys}
            self._recovering = bool(pending)
        log.info(
            "journal replay: %d job(s), %d non-terminal to reconcile",
            len(folded), len(pending),
        )

    def _recover(self) -> None:
        """Reconcile every replayed non-terminal job against the pool;
        the recovery-window 503 lifts when this returns.  Per job:
        terminal at its replica (status poll, or the durable
        ``jobs/<id>/result.json`` of a dead spawned replica) → relay
        the result; still running → re-attach (the poll loop takes
        over); unknown/unreachable (or an injected ``router.recover``
        fault) → requeue with the pinned workdir, so the resumed run
        completes byte-identically under the preserved trace id."""
        with self._lock:
            pending = self._pending_recovery
            self._pending_recovery = []
        if self._journal is None or self._replay_stats is None:
            with self._lock:
                self._recovering = False
            return
        t0 = time.perf_counter()
        counts = {"relayed": 0, "requeued": 0, "reattached": 0}
        try:
            for job, rec in pending:
                if self.telemetry is not None:
                    # re-introduce the trace id in THIS run's stream
                    # before any span can land under it
                    with self._lock:
                        depth = self._drr.depth
                    self.telemetry.job_submitted(job, depth)
                try:
                    outcome = self._reconcile_job(job, rec)
                except Exception as e:
                    log.warning(
                        "reconciliation of %s failed (%s); requeue+resume",
                        job.job_id, e,
                    )
                    outcome = self._requeue_recovered(job)
                counts[outcome] += 1
        finally:
            with self._lock:
                self._recovering = False
                self._cond.notify_all()
            summary = {
                "replayed": self._replay_stats["replayed"],
                "deduped": self._replay_stats["deduped"],
                "recovery_s": round(time.perf_counter() - t0, 6),
                "clean": bool(self._journal.was_clean),
                **counts,
            }
            self.recovery = summary
            if self.telemetry is not None:
                self.telemetry.router_recovered(**summary)
            log.info("recovery complete: %s", summary)
        try:
            # compaction now bounds the NEXT restart's replay
            self._journal.compact()
        except (OSError, JournalError) as e:
            log.warning("journal compaction failed: %s", e)

    def _reconcile_job(self, job: RouterJob, rec: dict) -> str:
        """One job's reconciliation; returns its outcome bucket
        (``relayed`` | ``reattached`` | ``requeued``)."""
        if self._journal.was_clean:
            # an uninterrupted drain left nothing running: route without
            # probing (a drained restart normally has no pending jobs at
            # all — this is the belt under that suspender)
            return self._requeue_recovered(job)
        try:
            faults.check("router.recover")
            replica, snap, p0, p1 = self._probe_recovered(rec)
        except Exception as e:
            log.warning(
                "recovery probe for %s failed (%s); requeue+resume",
                job.job_id, e,
            )
            return self._requeue_recovered(job)
        if snap is None:
            return self._requeue_recovered(job)
        terminal = snap.get("state") in TERMINAL_STATES
        if not terminal and replica is None:
            return self._requeue_recovered(job)
        with self._lock:
            job.snap = snap
            job.state = "routed"
            job.routed_t = time.time()
            if replica is not None:
                job.replica = replica.rid
            if terminal:
                # the probe that answered IS the result relay
                job.blame_acc["relay"] += max(0.0, p1 - p0)
            else:
                replica.inflight.add(job.job_id)
        if terminal:
            if self.telemetry is not None and replica is not None:
                self.telemetry.request_span(
                    job, "relay", p0, p1, replica=replica.rid,
                )
            self._finish_job(
                job, snap["state"], snap.get("error"),
                from_replica=replica, snap=snap,
            )
            return "relayed"
        log.info(
            "re-attached %s to %s (replica job %s)",
            job.job_id, job.replica, job.replica_job_id,
        )
        return "reattached"

    def _probe_recovered(
        self, rec: dict
    ) -> "tuple[_Replica | None, dict | None, float, float]":
        """Ask the journal's recorded replica what became of a job;
        falls back to the dead spawned replica's durable
        ``jobs/<id>/result.json``.  Returns ``(replica, snap, p0, p1)``
        with ``snap=None`` for unknown."""
        base = rec.get("replica_base")
        rjid = rec.get("replica_job_id")
        p0 = p1 = time.perf_counter()
        if not base or not rjid:
            return None, None, p0, p1  # never forwarded: plain requeue
        with self._lock:
            replica = next(
                (
                    r for r in self.pool
                    if r.base == base and r.state != "stopped"
                ),
                None,
            )
        if replica is not None:
            status, snap = _http_json("GET", f"{replica.base}/jobs/{rjid}")
            p1 = time.perf_counter()
            if status == 200 and isinstance(snap, dict):
                return replica, snap, p0, p1
            return replica, None, p0, p1
        snap = self._result_from_disk(rjid)
        p1 = time.perf_counter()
        return None, snap, p0, p1

    def _result_from_disk(self, rjid: str) -> "dict | None":
        """A dead spawned replica's terminal verdict, if it got as far
        as the atomic ``result.json`` write before dying."""
        root = os.path.join(self.cfg.workdir, "replicas")
        try:
            names = sorted(os.listdir(root))
        except OSError:
            return None
        for name in names:
            path = os.path.join(root, name, "jobs", rjid, "result.json")
            try:
                with open(path, encoding="utf-8") as f:
                    snap = json.load(f)
            except (OSError, ValueError):
                continue
            if (
                isinstance(snap, dict)
                and snap.get("state") in TERMINAL_STATES
            ):
                return snap
        return None

    def _requeue_recovered(self, job: RouterJob) -> str:
        """Queue a replayed job for (re-)routing with a fresh retry
        budget.  Back-enqueue ON PURPOSE: recovery iterates in admission
        order into queues no new submission can reach (the 503 window),
        so FIFO here IS front-of-line relative to post-recovery traffic
        — a front-enqueue would reverse the replayed order instead."""
        with self._lock:
            job.state = "queued"
            job.replica = None
            job.replica_job_id = None
            job.attempts = 0
            job.poll_fails = 0
            job.queue_enter_mono = time.perf_counter()
            job.backoff_pending = False
            self._enqueue_locked(job)
            self._cond.notify_all()
        return "requeued"

    def _journal_record(self, kind: str, job: RouterJob, **fields) -> None:
        """Append one journal record + its ``journal_append`` event.
        ``admitted`` failures propagate (the admission must fail
        loudly); ``forwarded``/``terminal`` failures degrade to a log
        line — the job is already durable, and recovery treats a
        missing record as unknown → requeue + resume."""
        if self._journal is None:
            return
        try:
            seg, nbytes = self._journal.append(kind, job.job_id, **fields)
        except JournalError:
            if kind == "admitted":
                raise
            log.warning(
                "journal %s append failed for %s (recovery degrades to "
                "requeue+resume)", kind, job.job_id,
            )
            return
        if self.telemetry is not None:
            self.telemetry.journal_append(
                kind, seg, nbytes,
                job_id=job.job_id, trace_id=job.trace_id,
            )

    # -- admission ---------------------------------------------------------
    def submit(self, payload: dict, source: str = "http") -> dict:
        """One submission through router admission; returns the queued
        job's snapshot or raises :class:`~land_trendr_tpu_torch.serve.server.
        Rejection` (429 carries Retry-After at the HTTP layer)."""
        try:
            if not isinstance(payload, dict):
                raise ValueError(
                    f"job request must be a JSON object, got "
                    f"{type(payload).__name__}"
                )
            req = JobRequest.from_payload(payload)
        except ValueError as e:
            if self.telemetry is not None:
                with self._lock:
                    depth = self._drr.depth
                self.telemetry.job_rejected("bad_request", depth)
            raise Rejection(400, "bad_request", str(e)) from None
        key = req.affinity_key()
        throttle = None
        snap = depth = job = None
        dedup = False
        with self._lock:
            depth = self._drr.depth
            prior = (
                self._jobs.get(self._idempotency.get(req.idempotency_key))
                if req.idempotency_key else None
            )
            if prior is not None:
                # idempotent resubmission: the journal remembered the
                # key (across restarts too) — answer with the EXISTING
                # job instead of double-running, whatever else is going
                # on (dedupe costs no queue slot, so no ladder applies)
                snap = prior.status_locked()
                snap["deduped"] = True
                dedup = True
            elif self._recovering:
                throttle = (
                    503, "recovering",
                    "router is reconciling its admission journal after "
                    "a restart; retry shortly",
                )
            elif self._stopping:
                throttle = (503, "shutting_down", "router is draining")
            elif depth >= self.cfg.route_queue_depth:
                throttle = (
                    429, "queue_full",
                    f"router queue depth {depth} at the configured "
                    f"bound {self.cfg.route_queue_depth}; retry later",
                )
            else:
                held = sum(
                    1 for j in self._jobs.values()
                    if j.tenant == req.tenant
                    and j.state in ("queued", "routed")
                )
                if held >= self.cfg.tenant_quota:
                    throttle = (
                        429, "tenant_quota",
                        f"tenant {req.tenant!r} holds {held} job(s) at "
                        f"the configured quota {self.cfg.tenant_quota}; "
                        "retry later",
                    )
            if throttle is None and not dedup:
                self._seq += 1
                job_id = f"rt-{os.getpid()}-{self._seq:05d}"
                job_root = os.path.join(self.cfg.workdir, "jobs", job_id)
                job = RouterJob(
                    job_id=job_id,
                    payload=dict(payload),
                    tenant=req.tenant,
                    priority=req.priority,
                    key=key,
                    # the request-tracing id is minted HERE, at the
                    # fleet's admission edge; the client may also pin
                    # its own (a proxy threading an upstream id)
                    trace_id=req.trace_id or uuid.uuid4().hex[:16],
                    # the router pins the dirs (unless the client pinned
                    # its own — the explicit-resume path), so a re-route
                    # RESUMES the same manifest on the next replica
                    workdir=req.workdir
                    or os.path.join(job_root, "work"),
                    out_dir=req.out_dir or os.path.join(job_root, "out"),
                    source=source,
                )
                job.idempotency_key = req.idempotency_key
                # the WRITE-AHEAD contract: the admitted record commits
                # BEFORE the job is registered or the client sees 200 —
                # a job the journal cannot make durable is never
                # admitted (503 journal_error), and a crash after this
                # line replays the job instead of orphaning it
                try:
                    # write-ahead: the admission record is durable before the job is
                    # registered or the client sees 200, in the order this lock defines
                    # (replay rebuilds the queues in admission order); one small line
                    # lt: noqa[LT007]
                    self._journal_record(
                        "admitted", job,
                        payload=job.payload,
                        tenant=job.tenant,
                        priority=job.priority,
                        key=job.key,
                        trace_id=job.trace_id,
                        idempotency_key=job.idempotency_key,
                        workdir=job.workdir,
                        out_dir=job.out_dir,
                        source=job.source,
                        t=job.submitted_t,
                    )
                except JournalError as e:
                    throttle = (
                        503, "journal_error",
                        f"admission journal append failed ({e}); the "
                        "job was NOT accepted — retry later",
                    )
                    job = None
            if job is not None and throttle is None and not dedup:
                if job.idempotency_key:
                    self._idempotency[job.idempotency_key] = job.job_id
                # registered but NOT yet enqueued: the job becomes
                # routable only after job_submitted is durably in the
                # stream, or the dispatcher's first request_span could
                # land ahead of the trace's introduction (the orphan
                # the referential lint flags)
                self._jobs[job.job_id] = job
                depth = self._drr.depth + 1  # the enqueue below joins it
                snap = job.status_locked()
        if dedup:
            log.info(
                "idempotent resubmission answered with %s (key=%s)",
                snap["job_id"], req.idempotency_key,
            )
            return snap
        if throttle is not None:
            status, reason, detail = throttle
            log.warning(
                "submission throttled (%s, tenant=%s)", reason, req.tenant
            )
            if self.telemetry is not None:
                if status == 429:
                    self.telemetry.tenant_throttled(req.tenant, reason, depth)
                else:
                    self.telemetry.job_rejected(reason, depth)
            raise Rejection(status, reason, detail)
        try:
            if self.telemetry is not None:
                self.telemetry.job_submitted(job, depth)
        finally:
            # enqueue even when the emit raised (full disk): an
            # accepted job must never be orphaned un-routable.  A
            # cancel that landed in the gap already marked the job
            # terminal — the pick loop skips non-queued entries.
            with self._lock:
                # decisions are recorded inside the router's critical section: their
                # order must equal the order this lock defines, or the offline replay
                # diverges from the live dispatcher; each is one small O_APPEND line
                # lt: noqa[LT007]
                self._enqueue_locked(job)
                self._cond.notify_all()
        return snap

    def _enqueue_locked(self, job: RouterJob, front: bool = False) -> None:
        self._drr.enqueue(job.tenant, job.job_id, front=front)
        if self._decisions is not None:
            # decision records stamp WALL time: the autoscale loop's
            # convention, so one log's nows share a clock domain and the
            # replay's recorded-span/speedup math is meaningful
            # decisions are recorded inside the router's critical section: their
            # order must equal the order this lock defines, or the offline replay
            # diverges from the live dispatcher; each is one small O_APPEND line
            # lt: noqa[LT007]
            self._decisions.record(
                "enqueue", tenant=job.tenant, job_id=job.job_id,
                front=front, now=time.time(),
            )

    # -- fair-share scheduling (deficit round-robin) -----------------------
    def _pick_job_locked(self) -> "RouterJob | None":
        """Deficit round-robin over the non-empty tenant queues —
        delegated to the shared pure core
        (:class:`~land_trendr_tpu_torch.fleet.scheduling.DrrQueue`, the one
        copy the capacity replay simulator also runs).  Entries whose
        job is no longer ``queued`` (cancelled in the submit gap) are
        skipped; the skip consumes the queue slot."""
        picked = self._drr.pick(
            live=lambda jid: self._jobs[jid].state == "queued"
        )
        if picked is None:
            return None
        tenant, job_id = picked
        if self._decisions is not None:
            # decisions are recorded inside the router's critical section: their
            # order must equal the order this lock defines, or the offline replay
            # diverges from the live dispatcher; each is one small O_APPEND line
            # lt: noqa[LT007]
            self._decisions.record(
                "pick", tenant=tenant, job_id=job_id, now=time.time()
            )
        return self._jobs[job_id]

    # -- replica choice ----------------------------------------------------
    def _routable_locked(self, r: _Replica, now: float) -> bool:
        return (
            r.state == "ready"
            and len(r.inflight) < self.cfg.replica_inflight
            and r.backoff_until <= now
        )

    def _choose_replica_locked(
        self, key: str
    ) -> "tuple[_Replica | None, bool]":
        now = time.monotonic()
        ready = [r for r in self.pool if self._routable_locked(r, now)]
        # the choice itself is the shared pure function over the
        # routable-candidate snapshot (fleet/scheduling.py) — the
        # capacity simulator replays the SAME function on the recorded
        # candidates
        cands = [(r.rid, len(r.inflight), key in r.warm) for r in ready]
        rid, warm = choose_replica(cands, self.cfg.affinity)
        if self._decisions is not None and cands:
            # decisions are recorded inside the router's critical section: their
            # order must equal the order this lock defines, or the offline replay
            # diverges from the live dispatcher; each is one small O_APPEND line
            # lt: noqa[LT007]
            self._decisions.record(
                "choose", key=key, affinity=self.cfg.affinity,
                candidates=[list(c) for c in cands],
                chosen=rid, warm=warm, now=time.time(),
            )
        if rid is None:
            return None, False
        return next(r for r in ready if r.rid == rid), warm

    # -- the dispatcher ----------------------------------------------------
    def serve_forever(self) -> None:
        """Route jobs on THIS thread until stopped, then shut the pool
        and telemetry down (drain first on a clean stop)."""
        status = "ok"
        try:
            while True:
                picked = self._next_route()
                if picked is None:
                    break
                self._route_job(*picked)
        except KeyboardInterrupt:
            # Ctrl-C — and SIGTERM, which ``lt route`` maps here — IS
            # the orchestrator's clean stop: keep status "ok" so
            # _shutdown drains routed jobs and the journal earns its
            # clean marker (a second interrupt aborts the drain itself)
            pass
        except BaseException:
            status = "aborted"
            raise
        finally:
            self._shutdown(status=status)

    def _next_route(self) -> "tuple[RouterJob, _Replica, bool] | None":
        with self._lock:
            while True:
                if self._stopping:
                    return None
                job = None
                if self._drr.pending:
                    # peek capacity BEFORE consuming a queue entry: a
                    # popped job with no replica to take it would lose
                    # its DRR slot
                    now = time.monotonic()
                    head_ready = any(
                        self._routable_locked(r, now) for r in self.pool
                    )
                    if head_ready:
                        # decisions are recorded inside the router's critical section: their
                        # order must equal the order this lock defines, or the offline replay
                        # diverges from the live dispatcher; each is one small O_APPEND line
                        # lt: noqa[LT007]
                        job = self._pick_job_locked()
                if job is not None:
                    # decisions are recorded inside the router's critical section: their
                    # order must equal the order this lock defines, or the offline replay
                    # diverges from the live dispatcher; each is one small O_APPEND line
                    # lt: noqa[LT007]
                    replica, warm = self._choose_replica_locked(job.key)
                    if replica is None:
                        # capacity vanished between peek and pick: put
                        # the job back at its queue front and wait
                        # decisions are recorded inside the router's critical section: their
                        # order must equal the order this lock defines, or the offline replay
                        # diverges from the live dispatcher; each is one small O_APPEND line
                        # lt: noqa[LT007]
                        self._enqueue_locked(job, front=True)
                    else:
                        job.attempts += 1
                        job.state = "routed"
                        job.replica = replica.rid
                        # optimistic stickiness: the NEXT same-shape job
                        # must prefer this replica even while this one
                        # is still compiling there
                        replica.note_key_locked(job.key)
                        replica.inflight.add(job.job_id)
                        return job, replica, warm
                self._cond.wait(timeout=0.2)

    def _close_queue_span(self, job: RouterJob, now_m: float) -> None:
        """Close the job's pending queue wait (route_queue, or
        throttle_backoff when a replica 429 re-queued it): fold the
        seconds into the blame accumulator under the lock, emit the
        ``request_span`` outside it."""
        with self._lock:
            q0 = job.queue_enter_mono
            comp = (
                "throttle_backoff" if job.backoff_pending else "route_queue"
            )
            job.backoff_pending = False
            job.blame_acc[comp] += max(0.0, now_m - q0)
        if self.telemetry is not None:
            self.telemetry.request_span(job, comp, q0, now_m)

    def _route_job(self, job: RouterJob, replica: _Replica, warm: bool) -> None:
        """One forward (no lock held during HTTP).  Failure paths:
        transport error / injected ``router.forward`` fault → the job
        re-enters its tenant queue (front) bounded by ``route_retries``;
        a replica-side 429 → requeue without burning a retry (the
        replica is saturated, not broken); a replica-side 400 → the
        job is terminally ``config_error`` (no replica will take it)."""
        self._close_queue_span(job, time.perf_counter())
        payload = dict(job.payload)
        payload["workdir"] = job.workdir
        payload["out_dir"] = job.out_dir
        payload["resume"] = True
        # the trace context crosses the wire IN the job payload: the
        # replica's admission validates it into JobRequest.trace_id and
        # the job's whole run scope carries it — re-route hops forward
        # the SAME id, so both hops assemble under one trace
        payload["trace_id"] = job.trace_id
        err: "str | None" = None
        body = None
        status = None
        f0 = time.perf_counter()
        try:
            faults.check("router.forward")
            status, body = _http_json(
                "POST", replica.base + "/jobs", payload,
                timeout=_FORWARD_TIMEOUT_S,
            )
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
        f1 = time.perf_counter()
        forward_ok = err is None and status == 200
        with self._lock:
            job.blame_acc["forward"] += max(0.0, f1 - f0)
            # the monotone hop ordinal — job.attempts moves backwards
            # on a 429 refund, so it cannot number the trace's hops
            job.hops += 1
            hop = job.hops
        if self.telemetry is not None:
            # every forward TRY is a hop span — a failed first hop plus
            # a succeeded second is exactly the re-route story
            self.telemetry.request_span(
                job, "forward", f0, f1,
                replica=replica.rid, attempt=hop, ok=forward_ok,
            )
        now = time.time()
        if err is None and status == 200 and isinstance(body, dict):
            with self._lock:
                job.replica_job_id = body.get("job_id")
                job.routed_t = now
                job.snap = body
                depth = self._drr.depth
                # a cancel that landed while the forward was in flight
                # (replica_job_id still None) had nowhere to go — honor
                # it now that the replica id exists
                relay_cancel = job.cancel_requested
            # durable AFTER the replica accepted, BEFORE anything else:
            # a crash past this line reconciles by asking THIS replica
            self._journal_record(
                "forwarded", job,
                replica_base=replica.base,
                replica_job_id=job.replica_job_id,
                replica=replica.rid,
                t=now,
            )
            if relay_cancel:
                try:
                    _http_json(
                        "POST",
                        f"{replica.base}/jobs/{job.replica_job_id}/cancel",
                        {},
                    )
                except Exception as e:
                    log.warning("deferred cancel forward failed: %s", e)
            if self.telemetry is not None:
                self.telemetry.route_decision(
                    job, replica.rid, warm, depth,
                    wait_s=now - job.submitted_t,
                )
            log.info(
                "job %s → %s (%s, tenant=%s, attempt %d)",
                job.job_id, replica.rid, "warm" if warm else "cold",
                job.tenant, job.attempts,
            )
            return
        if err is None and status == 429:
            # saturated replica (its own admission): not a route retry —
            # the job returns to its queue front and the REPLICA gets a
            # cooldown the choosers skip (never a dispatcher sleep: one
            # saturated replica must not head-of-line-block routing for
            # every other tenant and replica)
            with self._lock:
                replica.inflight.discard(job.job_id)
                replica.backoff_until = time.monotonic() + min(
                    0.5, self.cfg.health_interval_s
                )
                if job.state == "routed":  # vs a racing death sweep
                    job.state = "queued"
                    job.replica = None
                    job.attempts -= 1
                    # the wait until the next forward is a THROTTLE
                    # backoff, not a plain queue wait — blame it as such
                    job.queue_enter_mono = time.perf_counter()
                    job.backoff_pending = True
                    # decisions are recorded inside the router's critical section: their
                    # order must equal the order this lock defines, or the offline replay
                    # diverges from the live dispatcher; each is one small O_APPEND line
                    # lt: noqa[LT007]
                    self._enqueue_locked(job, front=True)
                self._cond.notify_all()
            return
        if err is None and status is not None and 400 <= status < 500:
            detail = (body or {}).get("detail") or (body or {}).get("error")
            self._finish_job(
                job, "config_error",
                f"replica {replica.rid} refused the request "
                f"({status}): {detail}",
                from_replica=replica,
            )
            return
        # transport failure / 5xx / injected fault: the replica is
        # suspect, the job is NOT lost — re-route it
        reason = err or f"HTTP {status}"
        log.warning(
            "forward of %s to %s failed (%s)", job.job_id, replica.rid,
            reason,
        )
        self._note_replica_failure(replica)
        self._requeue_job(job, replica, reason)

    def _requeue_job(
        self, job: RouterJob, replica: "_Replica | None", reason: str
    ) -> None:
        """Return a routed job to its tenant queue (front), or finish
        it ``error`` when its route retries are exhausted."""
        exhausted = False
        with self._lock:
            if replica is not None:
                replica.inflight.discard(job.job_id)
            if job.state != "routed":
                # terminal, or ALREADY requeued by a racing path (the
                # dispatcher's forward failure vs the control thread's
                # replica-death sweep): a second enqueue would route the
                # job twice
                return
            if job.attempts >= 1 + self.cfg.route_retries:
                exhausted = True
            else:
                job.state = "queued"
                job.replica = None
                job.replica_job_id = None
                job.poll_fails = 0
                # a fresh queue wait opens for the re-route hop
                job.queue_enter_mono = time.perf_counter()
                job.backoff_pending = False
                # decisions are recorded inside the router's critical section: their
                # order must equal the order this lock defines, or the offline replay
                # diverges from the live dispatcher; each is one small O_APPEND line
                # lt: noqa[LT007]
                self._enqueue_locked(job, front=True)
                self._cond.notify_all()
        if exhausted:
            self._finish_job(
                job, "error",
                f"route retries exhausted after {job.attempts} "
                f"attempt(s); last: {reason} — resubmit with "
                f"\"workdir\": {job.workdir!r} to resume",
                from_replica=None,
            )

    @staticmethod
    def _blame_split(acc: dict, latency_s: float) -> dict:
        """The router-observed blame partition: the accumulated
        router-side components (queue waits, backoffs, forward hops,
        the result relay), with the REPLICA's share the exact residual
        — so the components sum to ``latency_s`` by construction (the
        ``request_done`` value lint pins it).  A wall-clock step that
        leaves the monotonic accumulators over the wall latency scales
        them down proportionally rather than emitting a negative
        residual."""
        comps = {k: v for k, v in acc.items() if v > 1e-9}
        used = sum(comps.values())
        latency_s = max(0.0, latency_s)
        if used > latency_s:
            scale = latency_s / used if used > 0 else 0.0
            comps = {k: v * scale for k, v in comps.items()}
            used = latency_s
        comps["replica"] = latency_s - used
        return {k: round(v, 6) for k, v in sorted(comps.items())}

    def _finish_job(
        self,
        job: RouterJob,
        state: str,
        error: "str | None",
        from_replica: "_Replica | None",
        snap: "dict | None" = None,
    ) -> None:
        open_queue: "tuple[float, float, str] | None" = None
        with self._lock:
            if job.state in TERMINAL_STATES:
                return
            if job.state == "queued":
                # terminal while still queued (cancel / shutdown): the
                # open queue wait closes into the blame here — nothing
                # else ever will
                now_m = time.perf_counter()
                comp = (
                    "throttle_backoff" if job.backoff_pending
                    else "route_queue"
                )
                job.blame_acc[comp] += max(
                    0.0, now_m - job.queue_enter_mono
                )
                open_queue = (job.queue_enter_mono, now_m, comp)
            job.state = state
            job.error = error if error is not None else job.error
            if snap is not None:
                job.snap = snap
            job.finished_t = time.time()
            self._terminal += 1
            if from_replica is not None:
                from_replica.inflight.discard(job.job_id)
            wall_s = job.finished_t - job.submitted_t
            blame = self._blame_split(job.blame_acc, wall_s)
            hops = job.hops
            self._recent_requests.append({
                "trace_id": job.trace_id,
                "job_id": job.job_id,
                "tenant": job.tenant,
                "status": state,
                "latency_s": round(wall_s, 6),
                "blame": blame,
                "hops": hops,
                "replica": job.replica,
                "finished_t": job.finished_t,
            })
            self._cond.notify_all()
        self._journal_record(
            "terminal", job, state=state, error=job.error,
            t=job.finished_t,
        )
        log.info(
            "job %s %s in %.2fs%s",
            job.job_id, state, wall_s,
            f" ({job.error})" if job.error else "",
        )
        if self.telemetry is not None:
            if open_queue is not None:
                self.telemetry.request_span(job, open_queue[2],
                                            open_queue[0], open_queue[1])
            self.telemetry.request_done(job, wall_s, blame, hops)
            self.telemetry.job_done(job, wall_s)

    # -- the control loop (health, polls, autoscale) -----------------------
    def _control_loop(self) -> None:
        while not self._control_stop.wait(self.cfg.health_interval_s):
            try:
                self.control_beat()
            except Exception:
                # the control plane must never take down the router
                log.debug("control beat failed", exc_info=True)

    def control_beat(self, now: "float | None" = None) -> None:
        """One control beat: probe every replica, poll every routed
        job, feed the autoscaler.  Called from the control thread (and
        directly by tests, with a pinned ``now``)."""
        if now is None:
            now = time.time()
        with self._lock:
            replicas = list(self.pool)
        for replica in replicas:
            self._probe_replica(replica)
        with self._lock:
            routed = [
                j for j in self._jobs.values() if j.state == "routed"
            ]
            ready = sum(1 for r in self.pool if r.state == "ready")
            total = sum(1 for r in self.pool if r.state != "stopped")
        for job in routed:
            self._poll_job(job)
        if self.telemetry is not None:
            self.telemetry.pool_gauges(ready, total)
        if self.scaler is not None:
            self.scale_tick(self._pod_burn(now), now)
        self._reap_draining()

    def _note_replica_failure(self, replica: _Replica) -> None:
        emit = None
        with self._lock:
            replica.fails += 1
            if (
                replica.fails >= self.cfg.unhealthy_after
                and replica.state == "ready"
            ):
                # unready ≠ failed jobs: accepted jobs keep polling and
                # finish wherever they actually run
                replica.state = "unready"
                emit = replica
        if emit is not None and self.telemetry is not None:
            self.telemetry.replica_down(emit, "health")

    def _probe_replica(self, replica: _Replica) -> None:
        if replica.state == "stopped":
            return
        proc = replica.proc
        if proc is not None and proc.poll() is not None:
            self._replica_died(replica, f"process exited {proc.poll()}")
            return
        if (
            proc is None
            and replica.adopted_pid is not None
            and not _pid_alive(replica.adopted_pid)
        ):
            self._replica_died(replica, "re-adopted process exited")
            return
        failed = False
        health: "dict | None" = None
        try:
            if faults.fired("replica.health"):
                failed = True
            else:
                status, health = _http_json(
                    "GET", replica.base + "/healthz"
                )
                failed = status != 200 or not isinstance(health, dict)
        except Exception:
            failed = True
        if failed:
            self._note_replica_failure(replica)
            return
        emit_up = None
        with self._lock:
            replica.fails = 0
            replica.last_health = health
            replica.last_health_t = time.time()
            for key in health.get("warm_keys") or []:
                if isinstance(key, str):
                    replica.note_key_locked(key)
            if replica.state in ("starting", "unready"):
                replica.state = "ready"
                emit_up = replica
                self._cond.notify_all()
        if emit_up is not None and self.telemetry is not None:
            self.telemetry.replica_up(emit_up)

    def _replica_died(self, replica: _Replica, reason: str) -> None:
        """A spawned replica's process is gone: mark it stopped and
        re-route every job it held — recorded tiles are durable in the
        router-pinned workdirs, so the re-routed submissions resume."""
        orphans: "list[RouterJob]" = []
        emit = None
        with self._lock:
            if replica.state == "stopped":
                return
            was_draining = replica.state == "draining"
            replica.state = "stopped"
            emit = replica
            for job_id in sorted(replica.inflight):
                job = self._jobs.get(job_id)
                if job is not None and job.state == "routed":
                    orphans.append(job)
        if self.telemetry is not None and emit is not None:
            self.telemetry.replica_down(
                emit, "scale_down" if was_draining else "dead"
            )
        log.warning(
            "replica %s down (%s); re-routing %d job(s)",
            replica.rid, reason, len(orphans),
        )
        for job in orphans:
            self._requeue_job(job, replica, f"replica {replica.rid} died")

    def _poll_job(self, job: RouterJob) -> None:
        with self._lock:
            if job.state != "routed" or job.replica_job_id is None:
                return
            replica = self._replica_locked(job.replica)
        if replica is None:
            self._requeue_job(job, None, "replica record vanished")
            return
        p0 = time.perf_counter()
        try:
            status, snap = _http_json(
                "GET", f"{replica.base}/jobs/{job.replica_job_id}"
            )
        except Exception as e:
            dead = replica.proc is not None and replica.proc.poll() is not None
            with self._lock:
                job.poll_fails += 1
                fails = job.poll_fails
                state = replica.state
            if dead:
                self._replica_died(replica, f"poll failed: {e}")
            elif (
                state in ("unready", "stopped")
                and fails >= self.cfg.unhealthy_after
            ):
                self._requeue_job(
                    job, replica,
                    f"replica {replica.rid} unreachable ({e})",
                )
            return
        if status == 404:
            # the replica restarted (or never accepted it): re-route
            self._requeue_job(
                job, replica, f"replica {replica.rid} lost the job"
            )
            return
        if status != 200 or not isinstance(snap, dict):
            return
        p1 = time.perf_counter()
        terminal = snap.get("state") in TERMINAL_STATES
        relayed = False
        with self._lock:
            job.poll_fails = 0
            job.snap = snap
            if terminal and job.state == "routed":
                # routing FEEDBACK: the shape ran here, its programs
                # are resident — confirm the sticky key as warm
                replica.note_key_locked(job.key)
                # the poll that DISCOVERED the terminal state is the
                # result relay — the last router-side hop of the journey
                job.blame_acc["relay"] += max(0.0, p1 - p0)
                relayed = True
        if terminal:
            if relayed and self.telemetry is not None:
                self.telemetry.request_span(
                    job, "relay", p0, p1, replica=replica.rid,
                )
            self._finish_job(
                job, snap["state"], snap.get("error"),
                from_replica=replica, snap=snap,
            )

    def _replica_locked(self, rid: "str | None") -> "_Replica | None":
        for r in self.pool:
            if r.rid == rid:
                return r
        return None

    # -- autoscaling -------------------------------------------------------
    def _pod_burn(self, now: float) -> "float | None":
        """The pod ``lt_slo_burn_rate`` from the shared telemetry
        directory (the fleet telemetry plane: replicas publish snapshots,
        ``fold_dir`` merges them, gauges default to the pod-max policy
        — the alerting-relevant fold)."""
        from land_trendr_tpu_torch.obs import aggregate

        try:
            view = aggregate.fold_dir(
                self._telemetry_dir, now=now, newer_than=now - 600.0
            )
        except Exception:
            return None
        for inst in view.get("metrics", []):
            if inst["name"] == "lt_slo_burn_rate" and not inst.get("labels"):
                v = inst.get("value")
                return None if v is None else float(v)
        return None

    def scale_tick(self, burn: "float | None", now: float) -> "str | None":
        """Feed one burn observation to the autoscaler and ACT on the
        decision (spawn / begin a drain).  Split from the control loop
        so tests and the soak can drive a scripted burn history
        deterministically; returns the action taken."""
        if self.scaler is None:
            return None
        with self._lock:
            queue_depth = self._drr.depth
            spawned_live = [
                r for r in self.pool
                if r.spawned and r.state in ("starting", "ready", "unready")
            ]
            decision = self.scaler.decide(
                burn, queue_depth, len(spawned_live), now
            )
            if self._decisions is not None:
                # decisions are recorded inside the router's critical section: their
                # order must equal the order this lock defines, or the offline replay
                # diverges from the live dispatcher; each is one small O_APPEND line
                # lt: noqa[LT007]
                self._decisions.record(
                    "autoscale", burn=burn, queue_depth=queue_depth,
                    replicas=len(spawned_live), now=now,
                    decision=decision,
                )
        if decision == "up":
            replica = self._launch_replica_proc()
            if self.telemetry is not None:
                with self._lock:
                    n = len([
                        r for r in self.pool
                        if r.spawned and r.state != "stopped"
                    ])
                self.telemetry.scale_decision(
                    "up", burn or 0.0, n, queue_depth, replica=replica.rid
                )
            # await the startup line OFF the control thread: a cold
            # replica start takes tens of seconds, and blocking here
            # would stall every health probe, job poll and drain reap
            # for the duration
            threading.Thread(
                target=self._await_scale_up,
                args=(replica,),
                name=f"lt-route-spawn-{replica.rid}",
                daemon=True,
            ).start()
            return "up"
        if decision == "down":
            victim = None
            with self._lock:
                candidates = sorted(
                    (r for r in spawned_live if r.state == "ready"),
                    key=lambda r: (len(r.inflight), len(r.warm), r.rid),
                )
                if candidates:
                    victim = candidates[0]
                    # drain-before-kill: no new routes land here; the
                    # reaper stops the process once inflight hits zero
                    victim.state = "draining"
                    n = len([
                        r for r in self.pool
                        if r.spawned and r.state != "stopped"
                    ])
            if victim is not None and self.telemetry is not None:
                self.telemetry.scale_decision(
                    "down", burn or 0.0, n - 1, queue_depth,
                    replica=victim.rid,
                )
            return "down" if victim is not None else None
        return None

    def _await_scale_up(self, replica: _Replica) -> None:
        try:
            self._await_replica_start(replica)
        except RuntimeError as e:
            log.error("scale-up replica failed to start: %s", e)
            self._replica_died(replica, str(e))

    def _reap_draining(self) -> None:
        """Stop drained replicas: a ``draining`` member with zero
        in-flight jobs gets the ``lt serve`` process's documented clean
        shutdown (SIGINT — its dispatcher finishes teardown, manifests
        stay resumable)."""
        with self._lock:
            drained = [
                r for r in self.pool
                if r.state == "draining" and not r.inflight
            ]
        for replica in drained:
            self._stop_replica_proc(replica)
            with self._lock:
                replica.state = "stopped"
            if self.telemetry is not None:
                self.telemetry.replica_down(replica, "scale_down")

    @staticmethod
    def _stop_replica_proc(replica: _Replica) -> None:
        proc = replica.proc
        if proc is None:
            # re-adopted after a restart: not our child — send the
            # recorded pid the same documented clean shutdown
            if replica.adopted_pid is not None:
                try:
                    os.kill(replica.adopted_pid, signal.SIGINT)
                except OSError:
                    pass
            return
        if proc.poll() is not None:
            return
        try:
            proc.send_signal(signal.SIGINT)
            proc.wait(timeout=60)
        except (ProcessLookupError, subprocess.TimeoutExpired):
            try:
                proc.kill()
                proc.wait(timeout=10)
            except (ProcessLookupError, subprocess.TimeoutExpired):
                pass

    # -- status / cancel ---------------------------------------------------
    def job_status(self, job_id: str) -> "dict | None":
        with self._lock:
            job = self._jobs.get(job_id)
            return job.status_locked() if job is not None else None

    def jobs(self) -> list:
        with self._lock:
            return [j.status_locked() for j in self._jobs.values()]

    def cancel(self, job_id: str) -> "dict | None":
        """Cancel one router job: a queued job goes terminal here; a
        routed one has the cancel forwarded to its replica (the poll
        picks up the terminal state)."""
        forward_to = None
        finished = None
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            job.cancel_requested = True
            if job.state == "queued":
                removed = self._drr.remove(job.tenant, job_id)
                if self._decisions is not None:
                    # decisions are recorded inside the router's critical section: their
                    # order must equal the order this lock defines, or the offline replay
                    # diverges from the live dispatcher; each is one small O_APPEND line
                    # lt: noqa[LT007]
                    self._decisions.record(
                        "remove", tenant=job.tenant, job_id=job_id,
                        removed=removed, now=time.time(),
                    )
                finished = job
            elif job.state == "routed" and job.replica_job_id is not None:
                replica = self._replica_locked(job.replica)
                if replica is not None:
                    forward_to = (replica, job.replica_job_id)
            snap = job.status_locked()
        if finished is not None:
            self._finish_job(
                finished, "cancelled", "cancelled while queued",
                from_replica=None,
            )
            snap = self.job_status(job_id)
        if forward_to is not None:
            replica, rjid = forward_to
            try:
                _http_json("POST", f"{replica.base}/jobs/{rjid}/cancel", {})
            except Exception as e:
                log.warning("cancel forward failed: %s", e)
        return snap

    def debug_requests(self) -> list:
        """Recent terminal requests, slowest first: each row's
        ``trace_id`` + router blame split is assemblable into the full
        cross-layer trace via ``tools/lt_request.py``."""
        with self._lock:
            recent = list(self._recent_requests)
        recent.sort(
            key=lambda r: -(
                r["latency_s"]
                if isinstance(r["latency_s"], (int, float)) else 0.0
            )
        )
        return recent

    def stats(self) -> dict:
        """The router ``/healthz`` body (``"router": true`` marks it so
        ``lt top`` renders the router view)."""
        with self._lock:
            tenants = {
                t: {
                    "queued": self._drr.queued(t),
                    "routed": sum(
                        1 for j in self._jobs.values()
                        if j.tenant == t and j.state == "routed"
                    ),
                    "weight": self._drr.weight(t),
                    "deficit": round(self._drr.deficit(t), 3),
                }
                for t in self._drr.known_tenants()
            }
            for j in self._jobs.values():
                if j.state == "routed" and j.tenant not in tenants:
                    tenants[j.tenant] = {
                        "queued": 0,
                        "routed": sum(
                            1 for x in self._jobs.values()
                            if x.tenant == j.tenant and x.state == "routed"
                        ),
                        "weight": self._drr.weight(j.tenant),
                        "deficit": round(self._drr.deficit(j.tenant), 3),
                    }
            snap = {
                "ok": True,
                "router": True,
                "queue_depth": self._drr.depth,
                "routed": sum(
                    1 for j in self._jobs.values() if j.state == "routed"
                ),
                "jobs_total": len(self._jobs),
                "jobs_terminal": self._terminal,
                "tenants": tenants,
                "replicas": [r.row_locked() for r in self.pool],
                "recovering": self._recovering,
                "recovery": self.recovery,
                # under the lock: scale_tick mutates the engine's alert
                # state under this same lock, and the Autoscaler's
                # single-owner contract is exactly that serialization
                "scaler": self.scaler.state() if self.scaler else None,
            }
        snap["uptime_s"] = round(time.time() - self._t0, 3)
        # the journal keeps its own (leaf) lock — read it outside ours
        journal = self._journal
        snap["journal"] = journal.stats() if journal is not None else None
        return snap

    def _fleet_probes(self) -> dict:
        """The ``state`` block of the router's own fleet snapshot
        (kind="route"): ``lt_fleet`` / ``lt top --dir`` render the
        router aggregate straight from the shared directory."""
        s = self.stats()
        return {
            "progress": {
                "queue_depth": s["queue_depth"],
                "routed": s["routed"],
                "jobs_total": s["jobs_total"],
                "jobs_terminal": s["jobs_terminal"],
            },
            "router": {
                "tenants": s["tenants"],
                "replicas": s["replicas"],
                "scaler": s["scaler"],
            },
        }

    def stop(self) -> None:
        """Ask the dispatcher to shut down (clean drain)."""
        with self._lock:
            self._stopping = True
            self._cond.notify_all()

    # -- shutdown ----------------------------------------------------------
    def _drain_routed(self, deadline_s: float) -> None:
        """Quiesce: poll routed jobs until none remain (or the bound
        expires) — replicas finish what they accepted, so a clean stop
        loses nothing."""
        deadline = time.monotonic() + deadline_s
        while time.monotonic() < deadline:
            with self._lock:
                routed = [
                    j for j in self._jobs.values() if j.state == "routed"
                ]
            if not routed:
                return
            for job in routed:
                self._poll_job(job)
            time.sleep(min(0.5, self.cfg.health_interval_s))

    def _shutdown(self, status: str) -> None:
        """Idempotent reverse-of-construction teardown."""
        with self._lock:
            self._stopping = True
            self._cond.notify_all()
            queued = [
                j for j in self._jobs.values() if j.state == "queued"
            ]
        self._control_stop.set()
        if self._control_thread is not None:
            self._control_thread.join(timeout=30)
            self._control_thread = None
        httpd = getattr(self, "_httpd", None)
        thread = getattr(self, "_http_thread", None)
        if httpd is not None:
            if thread is not None:
                httpd.shutdown()
            httpd.server_close()
            self._httpd = None
        if thread is not None:
            thread.join(timeout=10)
            self._http_thread = None
        for job in queued:
            self._finish_job(
                job, "cancelled", "router shut down before routing",
                from_replica=None,
            )
        if status == "ok":
            # the drain contract: in-flight jobs finish on their
            # replicas before anything is stopped (an abort skips this
            # — manifests are resumable either way)
            self._drain_routed(_DRAIN_TIMEOUT_S)
        with self._lock:
            spawned = [r for r in self.pool if r.spawned]
        for replica in spawned:
            alive = (
                replica.proc is not None and replica.proc.poll() is None
            ) or (
                replica.proc is None
                and replica.adopted_pid is not None
                and _pid_alive(replica.adopted_pid)
            )
            self._stop_replica_proc(replica)
            with self._lock:
                was_stopped = replica.state == "stopped"
                replica.state = "stopped"
            if alive and not was_stopped and self.telemetry is not None:
                self.telemetry.replica_down(replica, "shutdown")
        if self._journal is not None:
            with self._lock:
                all_terminal = all(
                    j.state in TERMINAL_STATES
                    for j in self._jobs.values()
                ) and not self._pending_recovery
            if status == "ok" and all_terminal:
                # the clean-shutdown marker: the next start on this
                # workdir skips reconciliation probes.  Only a FULLY
                # drained stop earns it — anything non-terminal means
                # the restart must reconcile.
                try:
                    self._journal.mark_clean()
                except OSError as e:
                    log.warning("clean-shutdown marker failed: %s", e)
            self._journal.close()
            self._journal = None
        if self._fault_plan is not None:
            faults.deactivate()
            self._fault_plan = None
        if self._decisions is not None:
            self._decisions.close()
            self._decisions = None
        if self.telemetry is not None:
            try:
                self.telemetry.close(status, time.time() - self._t0)
            except Exception as exc:
                log.error("router telemetry close failed: %s", exc)
            self.telemetry = None


class _RouterAPIServer(http.server.ThreadingHTTPServer):
    """The loopback front door: thin JSON routing over the router."""

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, router: FleetRouter) -> None:
        self.lt_router = router
        super().__init__(addr, _RouterAPIHandler)

    def handle_error(self, request, client_address) -> None:
        exc = sys.exc_info()[1]
        if isinstance(exc, (BrokenPipeError, ConnectionResetError)):
            return
        super().handle_error(request, client_address)


class _RouterAPIHandler(http.server.BaseHTTPRequestHandler):
    """Routes::

        POST /jobs              submit (JSON body → job snapshot |
                                429 + Retry-After / 400)
        GET  /jobs              every router job's snapshot
        GET  /jobs/<id>         one job (includes the replica's last
                                snapshot under "result")
        POST /jobs/<id>/cancel  cancel (queued → terminal; routed →
                                forwarded to the replica)
        GET  /healthz           router state: tenant queues, replica
                                table, scaler state ("router": true)
        GET  /metrics           the lt_router_* exposition
        GET  /metrics/exemplars histogram bucket → recent trace_id rings
        GET  /debug/requests    recent terminal requests, slowest first
                                (trace_id, router blame split, hops)
    """

    server: _RouterAPIServer

    def _send_json(self, status: int, payload) -> None:
        body = json.dumps(payload, default=str).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if status in (429, 503):
            # 503s are transient here too: recovery window, drain,
            # journal hiccup — the client should come back
            self.send_header("Retry-After", "1")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 - stdlib API name
        rt = self.server.lt_router
        path = self.path.split("?")[0].rstrip("/")
        if path == "/healthz":
            self._send_json(200, rt.stats())
        elif path == "/metrics/exemplars":
            if rt.telemetry is None:
                self.send_error(404)
                return
            self._send_json(
                200, {"exemplars": rt.telemetry.registry.exemplars()}
            )
        elif path == "/debug/requests":
            self._send_json(200, {"requests": rt.debug_requests()})
        elif path == "/metrics":
            if rt.telemetry is None:
                self.send_error(404)
                return
            body = rt.telemetry.registry.render().encode()
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/jobs":
            self._send_json(200, {"jobs": rt.jobs()})
        elif path.startswith("/jobs/"):
            snap = rt.job_status(path[len("/jobs/"):])
            if snap is None:
                self._send_json(404, {"error": "no such job"})
            else:
                self._send_json(200, snap)
        else:
            self.send_error(404)

    def do_POST(self) -> None:  # noqa: N802 - stdlib API name
        rt = self.server.lt_router
        path = self.path.split("?")[0].rstrip("/")
        if path == "/jobs":
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._send_json(
                    400, {"error": "bad_request", "detail": f"bad JSON: {e}"}
                )
                return
            try:
                snap = rt.submit(payload, source="http")
            except Rejection as e:
                self._send_json(
                    e.http_status, {"error": e.reason, "detail": e.detail}
                )
                return
            self._send_json(200, snap)
        elif path.startswith("/jobs/") and path.endswith("/cancel"):
            job_id = path[len("/jobs/"):-len("/cancel")]
            snap = rt.cancel(job_id)
            if snap is None:
                self._send_json(404, {"error": "no such job"})
            else:
                self._send_json(200, snap)
        else:
            self.send_error(404)

    def log_message(self, *a) -> None:  # quiet: no per-request stderr
        pass
