"""Segmentation-as-a-service: the long-lived server runtime.

Counterpart of ``land_trendr_tpu/serve/server.py``.  One
:class:`SegmentationServer` process keeps everything a ``segment``
invocation pays for *resident across requests* — the loaded kernel
library and each tile program's first launch (via the
:class:`~land_trendr_tpu_torch.serve.programs.ProgramCache` admission
index), the process-wide decoded-block cache, and the shared persistent
ingest store ("ingest once, serve many") — and drains a bounded job
queue through warm :class:`~land_trendr_tpu_torch.runtime.driver.Run`
objects on one device (the card unless the caller asks for the CPU).  A
warm job (same request shape, same stacks) pays **no** warm-up launch and
**zero** TIFF decodes.  Admission accepts every stack length and
candidate count the JAX package does, on the card as on the CPU.

Layout:

* **submission** — a loopback-only HTTP JSON API (stdlib
  ``http.server``; the bind address is validated by
  :class:`~land_trendr_tpu_torch.serve.config.ServeConfig` — the job API is an
  unauthenticated control surface) plus a filesystem drop-box for batch
  use, both funneling through ONE admission path;
* **admission control** — bounded queue depth and a per-tenant in-flight
  cap, each rejected with HTTP 429 (``job_rejected`` event,
  ``lt_serve_rejections_total``) so backlog is the client's problem, not
  the server's memory;
* **scheduling** — a priority queue (higher ``priority`` first, FIFO
  within a priority) drained by ONE dispatcher on the thread that called
  :meth:`SegmentationServer.serve_forever`; tiles inside a job already
  pipeline across feed/upload/compute/fetch/write, so job-level
  parallelism would only thrash the device;
* **failure semantics** — per-job timeout and cancel ride the run's
  cancel event (the manifest stays resumable; a resubmitted job resumes
  it), tile-level faults keep their retry/quarantine contract, and a
  job that exhausts retries is reported failed WITHOUT taking down the
  server or sibling jobs (the ``serve.submit`` / ``serve.job`` fault
  seams soak exactly this).  Job states map onto the CLI exit-code
  contract (:data:`~land_trendr_tpu_torch.serve.jobs.EXIT_CODE_FOR_STATE`).

Observability: the server writes its own ``events.jsonl`` scope (job
lifecycle + admission + the program-cache aggregate) and ``lt_serve_*``
instruments under its workdir; every job's run writes its own scope
under the job workdir with the ``job_id`` threaded onto every event.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import http.server
import json
import logging
import os
import threading
import time
import uuid
from typing import Any

from land_trendr_tpu_torch.io import blockcache
from land_trendr_tpu_torch.obs.events import EventLog
from land_trendr_tpu_torch.obs.flight import (
    FlightRecorder,
    ResourceSampler,
    flight_path,
)
from land_trendr_tpu_torch.obs.metrics import (
    MetricsHTTPServer,
    MetricsRegistry,
    PromFileExporter,
)
from land_trendr_tpu_torch.runtime import faults
from land_trendr_tpu_torch.serve.config import ServeConfig
from land_trendr_tpu_torch.serve.jobs import Job, JobRequest
from land_trendr_tpu_torch.serve.programs import ProgramCache

__all__ = ["Rejection", "SegmentationServer"]

log = logging.getLogger("land_trendr_tpu_torch.serve")

#: job-latency histogram buckets: sub-second warm smokes through
#: multi-hour scene jobs
_JOB_BUCKETS = (0.5, 1, 2, 5, 10, 30, 60, 300, 1800, 7200, 43200)

#: ``lt_slo_burn_rate`` window, terminal jobs
_SLO_WINDOW_JOBS = 100

#: bound on the request-level warm-affinity keys ``/healthz`` exposes
#: (recency-ordered; the full program residency count stays
#: ``warm_program_count`` — this list only has to cover the shapes a
#: router would still route here)
_WARM_KEYS_MAX = 32


class Rejection(Exception):
    """A submission refused at admission: carries the HTTP status and a
    machine-readable reason (``queue_full`` / ``tenant_cap`` /
    ``bad_request`` / ``submit_error`` / ``shutting_down``)."""

    def __init__(self, http_status: int, reason: str, detail: str = "") -> None:
        super().__init__(detail or reason)
        self.http_status = int(http_status)
        self.reason = reason
        self.detail = detail


class _ServeTelemetry:
    """The server's own events scope + ``lt_serve_*`` instruments.

    Job lifecycle, admission verdicts and the warm-cache aggregate live
    HERE (one scope for the server's whole life); per-job tile traffic
    lives in each job's own run scope under the job workdir.  The stream
    opens with a ``run_start`` (fingerprint ``"serve"``, zero tiles) and
    closes with a ``run_done`` so every existing consumer — schema lint,
    ``obs_report`` — folds it without special cases.
    """

    def __init__(
        self,
        cfg: ServeConfig,
        probes: "Any | None" = None,
        publish_probes: "Any | None" = None,
    ) -> None:
        os.makedirs(cfg.workdir, exist_ok=True)
        # fleet telemetry plane handles: predeclared so _release() is
        # callable from any depth of a partially finished construction
        # (the LT008 lesson the rest of this class already carries)
        self._publisher = None
        self.history = None
        self.engine = None
        self._fleet_thread: "threading.Thread | None" = None
        self._fleet_stop = threading.Event()
        self._fleet_lock = threading.Lock()
        self._active_alerts: list = []
        self._fleet_counts = {"folded": 0, "stale": 0, "corrupt": 0}
        #: the flight ring behind /debug/flight: mirrors every SERVER
        #: event here plus every JOB run's events (the server threads
        #: this recorder into each Run's telemetry), so the ring shows
        #: the process's whole recent story in one window
        self.flight = (
            FlightRecorder(cfg.flight_ring_events)
            if cfg.flight_ring_events
            else None
        )
        self.events = EventLog(
            os.path.join(cfg.workdir, "events.jsonl"),
            mirror=self.flight.record if self.flight is not None else None,
        )
        self._server: "MetricsHTTPServer | None" = None
        self._exporter: "PromFileExporter | None" = None
        self._sampler: "ResourceSampler | None" = None
        try:
            self._init_instruments(cfg, probes)
            if cfg.publish:
                self._init_fleet(cfg, publish_probes)
        except BaseException:
            # a half-built telemetry bundle must not leak the event fd /
            # exporter thread / metrics port into the caller's process
            self._release()
            raise

    def _release(self) -> None:
        """Tear the bundle down in reverse acquisition order — ONE copy
        shared by the construction guard and :meth:`close`.  The event-fd
        close rides the innermost finally so a server/exporter/sampler
        stop that ALSO fails cannot skip it (LT008)."""
        try:
            # fleet loop first: it emits into the event log and reads
            # the registry, both of which the later steps tear down
            self._stop_fleet()
        finally:
            try:
                if self._sampler is not None:
                    self._sampler.stop()
                    self._sampler = None
            finally:
                try:
                    if self._server is not None:
                        self._server.stop()
                        self._server = None
                finally:
                    try:
                        if self._exporter is not None:
                            self._exporter.stop()
                            self._exporter = None
                    finally:
                        self.events.close()

    def _init_instruments(self, cfg: ServeConfig, probes=None) -> None:
        self.registry = MetricsRegistry()
        r = self.registry
        self._queue_depth = r.gauge(
            "lt_serve_queue_depth", "jobs queued awaiting the dispatcher"
        )
        self._running = r.gauge(
            "lt_serve_running", "1 while a job is executing, else 0"
        )
        self._submitted = r.counter(
            "lt_serve_jobs_submitted_total", "jobs admitted into the queue"
        )
        self._rejections = r.counter(
            "lt_serve_rejections_total",
            "submissions refused by admission control (429-style)",
        )
        self._job_hist = r.histogram(
            "lt_serve_job_seconds",
            "job latency, submit to terminal state",
            buckets=_JOB_BUCKETS,
        )
        self._prog_hits = r.counter(
            "lt_serve_program_hits_total",
            "runs admitted warm (no warm-up launch)",
        )
        self._prog_misses = r.counter(
            "lt_serve_program_misses_total",
            "runs that paid their warm-up launch (cold)",
        )
        self._prog_compile_s = r.counter(
            "lt_serve_compile_seconds_total",
            "seconds spent warming tile programs on cache misses",
        )
        self._warm_ratio = r.gauge(
            "lt_serve_warm_hit_ratio",
            "program-cache hits / (hits + misses) over the server's life",
        )
        # per-job SLO accounting: the latency split and the deadline
        # verdict (job_slo events carry the same numbers per job)
        self._queue_wait_hist = r.histogram(
            "lt_serve_queue_wait_seconds",
            "job queue wait, submit to dispatch",
            buckets=_JOB_BUCKETS,
        )
        self._exec_hist = r.histogram(
            "lt_serve_exec_seconds",
            "job execution, dispatch to terminal state",
            buckets=_JOB_BUCKETS,
        )
        self._slo_met = r.counter(
            "lt_slo_met_total",
            "terminal jobs inside their deadline_s (or with none set)",
        )
        self._slo_missed = r.counter(
            "lt_slo_missed_total",
            "terminal jobs past their deadline_s (accounting, not "
            "enforcement — the job still ran to its terminal state)",
        )
        self._slo_burn = r.gauge(
            "lt_slo_burn_rate",
            f"fraction of the last {_SLO_WINDOW_JOBS} DEADLINED "
            "terminal jobs that missed their deadline (jobs without a "
            "deadline_s never enter the window)",
        )
        # cross-job continuous batching (serve/batching): how often the
        # dispatcher coalesces, how much it coalesces, and how full the
        # shared launches run (batch_launch/batch_demux events carry the
        # same numbers per batch)
        self._batch_launches = r.counter(
            "lt_batch_launches_total",
            "shared launches coalescing >= 2 same-affinity jobs",
        )
        self._batch_jobs_coalesced = r.counter(
            "lt_batch_jobs_coalesced_total",
            "jobs that shared a launch (leader + members, per batch)",
        )
        self._batch_demux_tiles = r.counter(
            "lt_batch_demux_tiles_total",
            "durable tile artifacts demuxed to batch members' manifests",
        )
        self._batch_occupancy = r.gauge(
            "lt_batch_occupancy",
            "useful px / padded px of the most recent shared launch",
        )
        #: burn-rate window: the last N deadlined terminal jobs' met
        #: verdicts.  A dedicated deque, NOT the flight ring — one busy
        #: job's tile events would evict every prior ``job_slo`` record
        #: from the ring, collapsing the burn denominator to the job
        #: just ended.  Deadline-scoped, like obs_report's hit_rate: a
        #: no-deadline job is ``met`` by definition, and 99 of those
        #: must not dilute one missed deadline into burn 0.01.
        self._slo_window: collections.deque = collections.deque(
            maxlen=_SLO_WINDOW_JOBS
        )
        self._jobs_done: dict[str, Any] = {}
        self._prog_lock = threading.Lock()
        self._last_prog = {"hits": 0, "misses": 0, "compile_s": 0.0}
        self.events.run_start(
            fingerprint="serve",
            process_index=0,
            process_count=1,
            tiles_total=0,
            tiles_todo=0,
            tiles_skipped_resume=0,
            mesh_devices=0,
            impl="serve",
        )
        self._server = (
            MetricsHTTPServer(
                self.registry, cfg.metrics_port, host=cfg.metrics_host
            )
            if cfg.metrics_port is not None
            else None
        )
        try:
            self._exporter = PromFileExporter(
                self.registry,
                os.path.join(cfg.workdir, "metrics.prom"),
                interval_s=cfg.metrics_interval_s,
            ).start()
        except BaseException:
            # exporter construction/first-write failing after the port
            # bound: release the server HERE (locality) and mark it
            # released so __init__'s guard only owns the event fd
            if self._server is not None:
                self._server.stop()
                self._server = None
            raise
        if self.flight is not None:
            # started LAST (after run_start, so the stream still opens
            # its scope) — flight_sample events ride the normal event
            # log into the file AND the ring
            try:
                self._sampler = ResourceSampler(
                    self.events.emit, cfg.sampler_interval_s, probes=probes
                ).start()
            except BaseException:
                # sampler-thread start failing after the exporter/server
                # exist: release them HERE (locality, like the exporter
                # guard above) so __init__'s guard only owns the event
                # fd; telescoped so an exporter-stop failure cannot skip
                # the server release
                try:
                    if self._exporter is not None:
                        self._exporter.stop()
                        self._exporter = None
                finally:
                    if self._server is not None:
                        self._server.stop()
                        self._server = None
                raise

    def _stop_fleet(self) -> None:
        """Stop the fleet loop, flush the terminal snapshot, close the
        history ring.  Idempotent; called from :meth:`close` BEFORE the
        terminal events (so ``run_done`` stays the scope's tail — the
        sampler convention) and again from :meth:`_release` for the
        construction-guard path."""
        self._fleet_stop.set()
        if self._fleet_thread is not None:
            self._fleet_thread.join(timeout=10)
            self._fleet_thread = None
        if self._publisher is not None:
            self._publisher.stop()
            self._publisher = None
        if self.history is not None:
            self.history.close()
            self.history = None

    # -- the fleet telemetry plane (obs publish/aggregate/history/alerts) --
    #: history read window for alert evaluation, seconds — comfortably
    #: above any sane rule window so rate()/absence rules always see
    #: their full span
    _FLEET_HISTORY_S = 600.0

    def _init_fleet(self, cfg: ServeConfig, publish_probes) -> None:
        from land_trendr_tpu_torch.obs.alerts import (
            DEFAULT_RULES,
            AlertEngine,
            load_rules,
        )
        from land_trendr_tpu_torch.obs.history import HistoryRing
        from land_trendr_tpu_torch.obs.publish import (
            TelemetryPublisher,
            telemetry_dir,
        )

        r = self.registry
        self._alerts_fired = r.counter(
            "lt_alerts_fired_total",
            "alert-rule firing transitions (obs/alerts over the fleet "
            "history)",
        )
        self._alerts_resolved = r.counter(
            "lt_alerts_resolved_total", "alert-rule resolved transitions"
        )
        self._alerts_firing = r.gauge(
            "lt_alerts_firing", "alert rules currently firing"
        )
        self._fleet_hosts = r.gauge(
            "lt_fleet_hosts", "snapshots folded into the latest pod view"
        )
        self._fleet_stale = r.gauge(
            "lt_fleet_stale_hosts", "hosts past their staleness bound"
        )
        self._telemetry_dir = cfg.telemetry_dir or telemetry_dir(cfg.workdir)
        self._publisher = TelemetryPublisher(
            self._telemetry_dir,
            self.registry,
            probes=publish_probes,
            interval_s=cfg.publish_interval_s,
            kind="serve",
        )
        try:
            self.history = HistoryRing(os.path.join(cfg.workdir, "history"))
            self.engine = AlertEngine(
                load_rules(cfg.alert_rules)
                if cfg.alert_rules
                else DEFAULT_RULES
            )
            self._fleet_interval_s = cfg.publish_interval_s
            self._fleet_thread = threading.Thread(
                target=self._fleet_loop, name="lt-fleet-loop", daemon=True
            )
            self._fleet_thread.start()
        except BaseException:
            # a later step raising (unwritable history dir, a rules file
            # deleted since config validation, thread-start failure) must
            # not leak the publisher/ring — released HERE (locality, the
            # exporter-guard pattern) so __init__'s guard stays a backstop
            self._stop_fleet()
            raise

    def _fleet_loop(self) -> None:
        # first beat right away (a short-lived server still folds once),
        # then every publish_interval_s until _release sets the stop
        while True:
            try:
                self.fleet_beat()
            except Exception:
                # a sick beat (full disk on the emit, FS churn mid-fold)
                # skips — the fleet plane must never take down the
                # server it watches
                log.debug("fleet beat failed", exc_info=True)
            if self._fleet_stop.wait(self._fleet_interval_s):
                return

    def fleet_beat(self, now: "float | None" = None) -> dict:
        """One fleet beat: publish own snapshot → fold the shared dir →
        append the pod sample to the history ring → evaluate alert
        rules → emit ``alert`` transitions + one ``fleet_sample``.
        Called from the loop thread (and directly by tests, with a
        pinned ``now`` for determinism); returns the pod view."""
        from land_trendr_tpu_torch.obs import aggregate

        if now is None:
            now = time.time()
        try:
            self._publisher.publish_now()
        except Exception:
            pass  # a skipped beat is staleness, never a failed server
        # newer_than bounds how long a departed host haunts the fold: a
        # restarted replica's dead predecessor (same workdir, new pid)
        # reads STALE — and alerts — for the history window, then drops
        # to listed-but-excluded instead of double-counting its counters
        # and paging forever after every routine restart
        view = aggregate.fold_dir(
            self._telemetry_dir,
            now=now,
            newer_than=now - self._FLEET_HISTORY_S,
        )
        sample = aggregate.pod_sample(view)
        try:
            self.history.append(sample)
        except Exception:
            pass  # one lost sample (history.append seam, FS pressure)
        samples, _ = self.history.read(newer_than=now - self._FLEET_HISTORY_S)
        transitions = self.engine.evaluate(samples, now)
        for tr in transitions:
            self.events.emit("alert", **tr)
            if tr["state"] == "firing":
                self._alerts_fired.inc()
            else:
                self._alerts_resolved.inc()
        active = self.engine.active()
        counts = view["counts"]
        with self._fleet_lock:
            self._active_alerts = active
            self._fleet_counts = {
                "folded": counts["folded"],
                "stale": counts["stale"],
                "corrupt": counts["corrupt"],
            }
        self._alerts_firing.set(len(active))
        self._fleet_hosts.set(counts["folded"])
        self._fleet_stale.set(counts["stale"])
        self.events.emit(
            "fleet_sample",
            hosts=counts["folded"],
            stale_hosts=counts["stale"],
            corrupt_snaps=counts["corrupt"],
            alerts_firing=len(active),
            history_samples=len(samples),
        )
        return view

    def active_alerts(self) -> list:
        """Currently-firing alerts (JSON-safe; ``/healthz``, the
        publisher's ``state.alerts`` block, ``lt top``)."""
        with self._fleet_lock:
            return list(self._active_alerts)

    def fleet_counts(self) -> dict:
        with self._fleet_lock:
            return dict(self._fleet_counts)

    def _done_counter(self, status: str):
        c = self._jobs_done.get(status)
        if c is None:
            c = self._jobs_done[status] = self.registry.counter(
                "lt_serve_jobs_done_total",
                "jobs reaching a terminal state, by status",
                labels={"status": status},
            )
        return c

    # -- server hooks ------------------------------------------------------
    def job_submitted(self, job: Job, queue_depth: int) -> None:
        self.events.emit(
            "job_submitted",
            job_id=job.job_id,
            trace_id=job.trace_id,
            tenant=job.request.tenant,
            priority=job.request.priority,
            queue_depth=queue_depth,
            source=job.source,
        )
        self._submitted.inc()
        self._queue_depth.set(queue_depth)

    def job_rejected(
        self,
        reason: str,
        queue_depth: int,
        tenant: "str | None" = None,
    ) -> None:
        fields: dict = {}
        if tenant:
            fields["tenant"] = tenant
        self.events.emit(
            "job_rejected", reason=reason, queue_depth=queue_depth, **fields
        )
        self._rejections.inc()

    def job_start(self, job: Job, wait_s: float, queue_depth: int) -> None:
        self.events.emit(
            "job_start",
            job_id=job.job_id,
            trace_id=job.trace_id,
            tenant=job.request.tenant,
            wait_s=round(wait_s, 6),
        )
        self._running.set(1)
        self._queue_depth.set(queue_depth)

    def job_done(self, job: Job, wall_s: float) -> None:
        fields: dict = {}
        if job.error:
            fields["error"] = job.error
        quarantined = (job.summary or {}).get("tiles_quarantined")
        if quarantined:
            fields["tiles_quarantined"] = len(quarantined)
        self.events.emit(
            "job_done",
            job_id=job.job_id,
            trace_id=job.trace_id,
            status=job.state,
            wall_s=round(wall_s, 6),
            **fields,
        )
        self._running.set(0)
        # the exemplar closes the metrics→traces loop: the latency
        # bucket this job landed in remembers its trace_id, so "the
        # p99 bucket" resolves to requests lt_request can assemble
        self._job_hist.observe(wall_s, exemplar=job.trace_id or None)
        self._done_counter(job.state).inc()

    def job_slo(self, job: Job, slo: dict) -> None:
        """One terminal job's SLO accounting: the ``job_slo`` event plus
        the latency-split histograms, met/missed counters, and the burn
        rate over the last ``_SLO_WINDOW_JOBS`` deadlined terminal
        jobs."""
        self.events.emit(
            "job_slo",
            job_id=job.job_id,
            trace_id=job.trace_id,
            tenant=job.request.tenant,
            **slo,
        )
        ex = job.trace_id or None
        self._queue_wait_hist.observe(slo["queue_wait_s"], exemplar=ex)
        self._exec_hist.observe(slo["exec_s"], exemplar=ex)
        (self._slo_met if slo["met"] else self._slo_missed).inc()
        if "deadline_s" in slo:
            self._slo_window.append(bool(slo["met"]))
            window = list(self._slo_window)
            self._slo_burn.set(window.count(False) / len(window))

    def batch_launch(self, job: Job, stats: dict) -> None:
        """One coalesced launch: stamped with the LEADER's identity so
        blame attribution keeps partitioning each request exactly —
        members get their own ``batch_demux`` on the same scope."""
        self.events.emit(
            "batch_launch",
            job_id=job.job_id,
            trace_id=job.trace_id,
            jobs=int(stats["jobs"]),
            tiles=int(stats["tiles"]),
            padded_px=int(stats["padded_px"]),
            occupancy=float(stats["occupancy"]),
            window_wait_s=float(stats["window_wait_s"]),
        )
        self._batch_launches.inc()
        self._batch_jobs_coalesced.inc(int(stats["jobs"]))
        self._batch_occupancy.set(float(stats["occupancy"]))

    def batch_demux(self, job: Job, tiles: int) -> None:
        """One member's share of a shared launch, stamped with the
        MEMBER's identity (its run scope then resumes over the demuxed
        manifest with near-zero device work)."""
        self.events.emit(
            "batch_demux",
            job_id=job.job_id,
            trace_id=job.trace_id,
            tiles=int(tiles),
        )
        self._batch_demux_tiles.inc(int(tiles))

    def profile_captured(
        self,
        ok: bool,
        duration_s: float,
        path: str,
        error: "str | None" = None,
        nbytes: "int | None" = None,
    ) -> None:
        """One on-demand profiler capture attempt (POST /debug/profile);
        a failed capture is an event with ``ok=false``, never a failed
        job or server."""
        fields: dict = {}
        if error:
            fields["error"] = str(error)
        if nbytes is not None:
            fields["bytes"] = int(nbytes)
        self.events.emit(
            "profile_captured",
            ok=bool(ok),
            duration_s=round(float(duration_s), 6),
            path=path,
            **fields,
        )

    def program_cache(self, stats: dict) -> None:
        """Refresh the warm-ratio instruments from the server-wide
        totals (called after every job; the terminal aggregate event is
        emitted once at :meth:`close`).  Counters advance by delta —
        ``stats`` is cumulative."""
        with self._prog_lock:
            last = self._last_prog
            self._prog_hits.inc(stats.get("hits", 0) - last["hits"])
            self._prog_misses.inc(
                stats.get("misses", 0) - last["misses"]
            )
            self._prog_compile_s.inc(
                max(0.0, stats.get("compile_s", 0.0) - last["compile_s"])
            )
            self._last_prog = {
                "hits": stats.get("hits", 0),
                "misses": stats.get("misses", 0),
                "compile_s": stats.get("compile_s", 0.0),
            }
        hits, misses = stats.get("hits", 0), stats.get("misses", 0)
        if hits + misses:
            self._warm_ratio.set(hits / (hits + misses))

    def close(self, status: str, wall_s: float, stats: dict) -> None:
        try:
            # fleet loop down FIRST: a beat landing between the terminal
            # events below and _release would append fleet_sample/alert
            # lines behind the scope's run_done
            self._stop_fleet()
        except Exception as exc:
            log.error("fleet-loop stop failed: %s", exc)
        try:
            self.events.emit(
                "program_cache",
                hits=int(stats.get("hits", 0)),
                misses=int(stats.get("misses", 0)),
                compile_s=round(float(stats.get("compile_s", 0.0)), 6),
                keys=int(stats.get("keys", 0)),
            )
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


class SegmentationServer:
    """Long-lived segmentation server over one process's warm state;
    every job runs on ``device`` ("cuda" unless the caller asks for the
    CPU)."""

    def __init__(self, cfg: ServeConfig, device: "str | torch.device" = "cuda") -> None:
        from land_trendr_tpu_torch.runtime.driver import resolve_device

        self.cfg = cfg
        #: the device every job runs on (a CUDA request without a card
        #: raises here, before anything is written)
        self.device = resolve_device(device)
        os.makedirs(cfg.workdir, exist_ok=True)
        self._lock = threading.Lock()
        # the condition WRAPS self._lock (same lock object): guarded
        # state is always mutated under `with self._lock`, and the
        # condition is only used for wait/notify while holding it
        self._cond = threading.Condition(self._lock)
        self._jobs: dict[str, Job] = {}
        self._queue: list = []  # heap of (-priority, seq, job_id)
        self._seq = 0
        self._queued = 0
        self._terminal = 0
        self._stopping = False
        #: shutdown has BEGUN (vs _stopping = drain requested): new
        #: profiler captures are refused past this point, and the
        #: teardown waits out the ones already in flight
        self._closing = False
        self._captures = 0
        self._running_id: "str | None" = None
        self.programs = ProgramCache()
        #: request-level affinity keys of jobs whose Run actually
        #: executed here (their tile programs are warm in this process) — recency-ordered, bounded, exposed on /healthz so
        #: a warm-affinity router can rebuild its table from health
        #: probes alone (adoption, router restart)
        self._warm_keys: "collections.OrderedDict[str, float]" = (
            collections.OrderedDict()
        )
        #: recent TERMINAL requests (trace id, latency split, status) —
        #: the /debug/requests window, newest last, bounded by
        #: ``request_ring`` (mutated under the server lock)
        self._recent_requests: collections.deque = collections.deque(
            maxlen=cfg.request_ring  # 0 = an always-empty ring
        )

        # every teardown-touched handle exists BEFORE anything that can
        # fail: _shutdown_shared must be callable from any depth of a
        # partially finished construction.  (Previously a busy
        # --serve-port died in the cleanup path on the not-yet-bound
        # self._dropbox_stop — an AttributeError MASKING the bind error —
        # and a telemetry/fault-arming failure leaked the store's mmaps
        # plus its process-global cache attachment; LT008 found both.)
        self.store = None
        self.telemetry = None
        self._fault_plan = None
        #: the tuning-profile resolution of the most recent job whose
        #: config carried "auto" knobs (key + age + source) — the
        #: /healthz + fleet-snapshot fact satellite tooling renders
        self._tune_info: "dict | None" = None
        self._httpd = None
        self._http_thread = None
        self._dropbox_stop = threading.Event()
        self._dropbox_thread = None
        self._t0 = time.time()

        try:
            # the shared warm state every job rides: ONE process-wide
            # cache configuration (the server owns it; Run skips
            # reconfiguring when handed a shared store) and ONE
            # persistent ingest store
            if cfg.ingest_store_mb:
                from land_trendr_tpu_torch.io.blockstore import BlockStore

                self.store = BlockStore(
                    cfg.ingest_store_dir
                    or os.path.join(cfg.workdir, "ingest_store"),
                    budget_bytes=cfg.ingest_store_mb << 20,
                )
            blockcache.configure(
                budget_bytes=cfg.feed_cache_mb << 20,
                workers=cfg.decode_workers,
                store=self.store,
            )

            self.telemetry = (
                _ServeTelemetry(
                    cfg,
                    probes=self._sampler_probes,
                    publish_probes=self._fleet_probes,
                )
                if cfg.telemetry
                else None
            )

            # one process-wide fault plan shared by every job (soak
            # mode); jobs carrying their own schedule are rejected by
            # the Run
            if cfg.fault_schedule:
                self._fault_plan = faults.activate(
                    faults.parse_schedule(cfg.fault_schedule)
                )
                log.warning(
                    "serve fault injection ACTIVE (%s) — this is a "
                    "soak run", cfg.fault_schedule,
                )

            self._httpd = _JobAPIServer(
                (cfg.serve_host, cfg.serve_port), self
            )
            self.port = int(self._httpd.server_address[1])
            http_thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="lt-serve-http",
                daemon=True,
            )
            # bound only AFTER a successful start: _shutdown_shared keys
            # httpd.shutdown() on it, and socketserver's shutdown()
            # deadlocks forever unless serve_forever is actually running
            http_thread.start()
            self._http_thread = http_thread

            if cfg.dropbox_dir:
                os.makedirs(cfg.dropbox_dir, exist_ok=True)
                self._dropbox_thread = threading.Thread(
                    target=self._dropbox_loop,
                    name="lt-serve-dropbox",
                    daemon=True,
                )
                self._dropbox_thread.start()
        except BaseException:
            # construction failed partway: tear down exactly what exists
            # — store close + cache detach, armed fault plan, telemetry,
            # API socket — so nothing outlives the failed server
            self._shutdown_shared(status="aborted")
            raise
        log.info(
            "serving on %s:%d (queue depth %d, %s)",
            cfg.serve_host, self.port, cfg.serve_queue_depth,
            f"max_jobs={cfg.max_jobs}" if cfg.max_jobs else "unbounded",
        )

    def _sampler_probes(self) -> dict:
        """Host gauges for the flight sampler's ``flight_sample``
        events: queue/admission state, warm-program residency, cache
        occupancy, and — while a job runs — its pipeline backlogs."""
        with self._lock:
            out = {
                "queue_depth": self._queued,
                "running": 1 if self._running_id is not None else 0,
                "jobs_total": len(self._jobs),
            }
            running = (
                self._jobs.get(self._running_id)
                if self._running_id is not None
                else None
            )
            run = running.run if running is not None else None
        out["warm_program_count"] = int(
            self.programs.stats().get("keys", 0)
        )
        out.update(blockcache.occupancy_probe())
        if run is not None:
            # liveness half of straggler detection for serve jobs: the
            # SERVER's sampler thread sweeps the running job's in-flight
            # tiles, so a tile wedging the job's own device wait is
            # flagged while it runs (the detector flags each tile once).
            # Only while the run is live — its phase flips to
            # done/aborted at the top of teardown, BEFORE the terminal
            # run_done, so scanning a finishing run here would append
            # verdicts behind the scope's terminal event
            detector = getattr(run, "straggler", None)
            p = getattr(run, "progress", None)
            if detector is not None and p is not None and p.get(
                "phase"
            ) not in ("done", "aborted"):
                detector.scan()
            if p is not None:
                for k in (
                    "feed_backlog", "write_backlog", "fetch_backlog",
                    "upload_backlog", "stragglers", "tiles_stolen",
                    "tiles_speculated", "batch_jobs", "batch_tiles",
                ):
                    out[k] = int(p.get(k, 0))
                out["batch_occupancy"] = float(
                    p.get("batch_occupancy", 0.0)
                )
        return out

    def _fleet_probes(self) -> dict:
        """The ``state`` block of this replica's fleet snapshot
        (obs/publish): queue/job facts plus the currently-firing alerts
        — so ``lt_fleet`` and ``lt top --dir`` surface a replica's
        alerts straight from the shared directory, no HTTP needed."""
        with self._lock:
            progress = {
                "queue_depth": self._queued,
                "running": 1 if self._running_id is not None else 0,
                "jobs_total": len(self._jobs),
                "jobs_terminal": self._terminal,
            }
            tune_info = self._tune_info
        out: dict = {"progress": progress}
        if tune_info is not None:
            out["tune"] = tune_info
        tel = self.telemetry
        if tel is not None:
            out["alerts"] = tel.active_alerts()
        return out

    # -- admission ---------------------------------------------------------
    def submit(self, payload: dict, source: str = "http") -> dict:
        """One submission through admission control; returns the queued
        job's status snapshot or raises :class:`Rejection`.

        The ``serve.submit`` fault seam fires here: an injected
        submission fault is a rejected request and a live server, never
        a dead one.
        """
        tenant = (
            payload.get("tenant", "default")
            if isinstance(payload, dict)
            else None
        )
        if not isinstance(tenant, str):
            # an adversarial non-string tenant must not leak into the
            # job_rejected event (its tenant field is schema-typed str)
            tenant = None
        req = None
        rejection: "tuple[int, str, str] | None" = None
        try:
            faults.check("serve.submit")
            req = JobRequest.from_payload(payload)
        except ValueError as e:
            rejection = (400, "bad_request", str(e))
        except Exception as e:  # the injected-fault shape
            rejection = (503, "submit_error", str(e))
        snap = depth = job = None
        if rejection is None:
            with self._lock:
                depth = self._queued
                if self._stopping:
                    rejection = (503, "shutting_down", "server is draining")
                elif depth >= self.cfg.serve_queue_depth:
                    rejection = (
                        429,
                        "queue_full",
                        f"queue depth {depth} at the configured bound "
                        f"{self.cfg.serve_queue_depth}; retry later",
                    )
                else:
                    inflight = sum(
                        1
                        for j in self._jobs.values()
                        if j.request.tenant == req.tenant
                        and j.state in ("queued", "running")
                    )
                    if inflight >= self.cfg.tenant_max_inflight:
                        rejection = (
                            429,
                            "tenant_cap",
                            f"tenant {req.tenant!r} has {inflight} job(s) "
                            f"in flight at the configured bound "
                            f"{self.cfg.tenant_max_inflight}; retry later",
                        )
                if rejection is None:
                    self._seq += 1
                    job_id = f"job-{os.getpid()}-{self._seq:05d}"
                    job = Job(
                        job_id=job_id,
                        request=req,
                        source=source,
                        # the fleet router minted one at ITS admission
                        # (the forward payload carries it, re-routes
                        # included); a direct job mints here — either
                        # way every event of the job's journey carries
                        # ONE correlation id
                        trace_id=req.trace_id or uuid.uuid4().hex[:16],
                    )
                    job_root = os.path.join(
                        self.cfg.workdir, "jobs", job_id
                    )
                    job.workdir = req.workdir or os.path.join(
                        job_root, "work"
                    )
                    job.out_dir = req.out_dir or os.path.join(
                        job_root, "out"
                    )
                    self._jobs[job_id] = job
                    heapq.heappush(
                        self._queue, (-req.priority, self._seq, job_id)
                    )
                    self._queued += 1
                    depth = self._queued
                    snap = job.status_locked()
                    self._cond.notify_all()
        # telemetry emits happen OUTSIDE the server lock (the event log
        # has its own) — the admission path never holds both
        if rejection is not None:
            status, reason, detail = rejection
            if depth is None:
                with self._lock:
                    depth = self._queued
            log.warning(
                "submission rejected (%s, tenant=%s)", reason,
                req.tenant if req is not None else tenant,
            )
            if self.telemetry is not None:
                self.telemetry.job_rejected(
                    reason, depth,
                    req.tenant if req is not None else tenant,
                )
            raise Rejection(status, reason, detail)
        if self.telemetry is not None:
            self.telemetry.job_submitted(job, depth)
        return snap

    def _note_warm_key_locked(self, key: str) -> None:
        """Record one executed shape's affinity key (caller holds the
        lock); recency-ordered and bounded at ``_WARM_KEYS_MAX``."""
        self._warm_keys[key] = time.time()
        self._warm_keys.move_to_end(key)
        while len(self._warm_keys) > _WARM_KEYS_MAX:
            self._warm_keys.popitem(last=False)

    # -- status / cancel ---------------------------------------------------
    def job_status(self, job_id: str) -> "dict | None":
        with self._lock:
            job = self._jobs.get(job_id)
            return job.status_locked() if job is not None else None

    def jobs(self) -> list:
        with self._lock:
            return [j.status_locked() for j in self._jobs.values()]

    def stats(self) -> dict:
        with self._lock:
            snap = {
                "queue_depth": self._queued,
                "running": self._running_id,
                "jobs_terminal": self._terminal,
                "jobs_total": len(self._jobs),
                # the request-level warm-affinity keys (newest last,
                # bounded): what a warm-affinity router joins its own
                # JobRequest.affinity_key() against — warm_program_count
                # alone names no shapes, so a router could not rebuild
                # its table from it
                "warm_keys": list(self._warm_keys),
                # which tuning profile (key/age/source) the last
                # auto-knob job resolved through; None = no tuned job
                # yet (or no store configured — the untuned half of a
                # mixed fleet shows as exactly that)
                "tune": self._tune_info,
            }
        snap["program_cache"] = self.programs.stats()
        # load-balancer-grade health facts ride /healthz directly so an
        # LB check need not scrape (and parse) the Prometheus exposition
        snap["warm_program_count"] = int(
            snap["program_cache"].get("keys", 0)
        )
        snap["uptime_s"] = round(time.time() - self._t0, 3)
        tel = self.telemetry
        if tel is not None and self.cfg.publish:
            # fleet facts ride /healthz directly (like the warm-program
            # count): an LB/operator check sees firing alerts and stale
            # hosts without scraping the exposition
            snap["alerts"] = tel.active_alerts()
            snap["fleet"] = tel.fleet_counts()
        return snap

    # -- the /debug surface ------------------------------------------------
    def flight_snapshot(
        self, n: "int | None" = None, trace_id: "str | None" = None
    ) -> "dict | None":
        """The flight ring's recent window (None when telemetry or the
        ring is off): ring stats plus the newest ``n`` (default: all
        held) mirrored event records, oldest first.  ``held`` preserves
        the ring's occupancy (stats' integer ``events``), which the
        record list — possibly truncated to ``n`` — replaces.  With
        ``trace_id``, only records stamped with that id are kept (the
        ring mirrors every emit, so a job's whole recent story filters
        out of the shared window) — the filter applies BEFORE the ``n``
        truncation, so "the last 50 events of THIS trace" means what it
        says."""
        flight = self.telemetry.flight if self.telemetry is not None else None
        if flight is None:
            return None
        stats = flight.stats()
        stats["held"] = stats["events"]
        recs = flight.snapshot()
        if trace_id is not None:
            recs = [
                r for r in recs
                if isinstance(r, dict) and r.get("trace_id") == trace_id
            ]
            stats["trace_id"] = trace_id
            stats["matched"] = len(recs)
        if n is not None and n > 0:
            recs = recs[-n:]
        stats["events"] = recs
        return stats

    def _note_request_locked(self, job: Job, slo: dict) -> None:
        """Fold one terminal job into the /debug/requests ring (caller
        holds the server lock): the trace id, the replica-side latency
        split (this server IS the replica — queue wait + exec is its
        whole view), and the terminal status."""
        self._recent_requests.append({
            "trace_id": job.trace_id,
            "job_id": job.job_id,
            "tenant": job.request.tenant,
            "status": job.state,
            "latency_s": slo["latency_s"],
            "blame": {
                "replica_queue": slo["queue_wait_s"],
                "exec": slo["exec_s"],
            },
            "finished_t": job.finished_t,
        })

    def debug_requests(self) -> list:
        """Recent terminal requests, slowest first — the human half of
        the exemplar loop (each row's ``trace_id`` is assemblable via
        ``tools/lt_request.py``)."""
        with self._lock:
            recent = list(self._recent_requests)
        recent.sort(
            key=lambda r: -(
                r["latency_s"]
                if isinstance(r["latency_s"], (int, float)) else 0.0
            )
        )
        return recent

    def debug_jobs(self) -> list:
        """Per-job live state: the status snapshot plus — for a running
        job — the Run's progress (phase, tiles done/total, retry count,
        pipeline backlog depths)."""
        with self._lock:
            pairs = [(j, j.status_locked()) for j in self._jobs.values()]
        for job, snap in pairs:
            run = job.run
            if run is not None and snap["state"] == "running":
                # point-in-time copy: progress keys are fixed at Run
                # construction, so the copy can never race a dict resize
                snap["progress"] = dict(run.progress)
        return [snap for _, snap in pairs]

    def capture_profile(self, duration_s: float) -> dict:
        """On-demand, duration-bounded profiler capture of the LIVE
        process (POST /debug/profile): whatever the dispatcher and its
        job do during the window is what the trace shows.  Never raises:
        a failed capture — the ``debug.profile`` fault seam, a
        concurrent capture, a profiler error mid-job — is an
        ``ok=false`` verdict (and a ``profile_captured`` event), not a
        failed job or server."""
        t0 = time.perf_counter()
        logdir = os.path.join(
            self.cfg.workdir, "profiles",
            f"profile-{int(time.time() * 1000)}-{os.getpid()}",
        )
        with self._lock:
            if self._closing:
                # shutdown in progress: a capture started now could not
                # flush before the process (and the native profiler
                # session) tears down under it
                return {
                    "ok": False,
                    "path": logdir,
                    "duration_s": 0.0,
                    "error": "shutting_down: server is tearing down",
                }
            self._captures += 1
        try:
            try:
                faults.check("debug.profile")
                from land_trendr_tpu_torch.utils.profiling import capture_profile

                snap = {"ok": True, **capture_profile(logdir, duration_s)}
            except Exception as e:
                snap = {
                    "ok": False,
                    "path": logdir,
                    "duration_s": round(time.perf_counter() - t0, 6),
                    "error": f"{type(e).__name__}: {e}",
                }
            # the event emit happens BEFORE the _captures release: the
            # shutdown drain cannot close telemetry while we still hold
            # a capture slot, so the emit can never race the teardown.
            # Best-effort beyond that (a full disk must not turn the
            # capture verdict into a lost HTTP response).
            telemetry = self.telemetry
            if telemetry is not None:
                try:
                    telemetry.profile_captured(
                        snap["ok"],
                        snap["duration_s"],
                        snap["path"],
                        error=snap.get("error"),
                        nbytes=snap.get("bytes"),
                    )
                except Exception as exc:
                    log.error("profile_captured emit failed: %s", exc)
        finally:
            with self._lock:
                self._captures -= 1
                self._cond.notify_all()
        return snap

    def cancel(self, job_id: str) -> "dict | None":
        """Cancel one job: a queued job goes terminal immediately; a
        running job's cancel event unwinds its Run through the abort
        path (manifest resumable)."""
        finished = None
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                return None
            if job.state == "queued":
                job.state = "cancelled"
                job.finished_t = time.time()
                self._queued -= 1
                self._terminal += 1
                finished = job
            elif job.state == "running":
                job.cancel.set()
            snap = job.status_locked()
        if finished is not None:
            with self._lock:
                slo = finished.slo_locked()
                self._note_request_locked(finished, slo)
            if self.telemetry is not None:
                self.telemetry.job_done(
                    finished, finished.finished_t - finished.submitted_t
                )
                self.telemetry.job_slo(finished, slo)
            self._write_result(finished)
        with self._lock:
            self._cond.notify_all()
        return snap

    def stop(self) -> None:
        """Ask the dispatcher to shut down after the current job."""
        with self._lock:
            self._stopping = True
            self._cond.notify_all()

    # -- the dispatcher ----------------------------------------------------
    def serve_forever(self) -> None:
        """Drain jobs on THIS thread until stopped (or ``max_jobs``
        terminal states), then shut everything down."""
        status = "ok"
        try:
            while True:
                job = self._next_job()
                if job is None:
                    break
                self._run_job(job, batch=self._collect_batch(job))
        except BaseException:
            status = "aborted"
            raise
        finally:
            self._shutdown_shared(status=status)

    def _drained_locked(self) -> bool:
        """Caller holds the lock: the bounded mode's exit condition."""
        return (
            self.cfg.max_jobs is not None
            and self._terminal >= self.cfg.max_jobs
        )

    def _next_job(self) -> "Job | None":
        with self._lock:
            while True:
                if self._stopping or self._drained_locked():
                    return None
                while self._queue:
                    _, _, job_id = heapq.heappop(self._queue)
                    job = self._jobs[job_id]
                    if job.state != "queued":
                        continue  # cancelled while queued
                    job.state = "running"
                    job.started_t = time.time()
                    self._queued -= 1
                    self._running_id = job_id
                    return job
                self._cond.wait(timeout=0.2)

    def _batch_front_locked(self, key: str) -> "tuple[list, bool]":
        """The contiguous same-affinity front of the fairness-ordered
        queue (caller holds the lock): member candidates in pop order,
        plus whether a NON-matching job blocks the front.  Batching
        takes exactly the next jobs the scheduler would have run anyway
        — it changes packing, never fairness ordering."""
        members: list = []
        blocked = False
        for _, _, job_id in sorted(self._queue):
            job = self._jobs.get(job_id)
            if job is None or job.state != "queued":
                continue  # cancelled while queued (stale heap entry)
            req = job.request
            # a member must resume its manifest to see its demuxed
            # tiles; resume=False opts the job out of co-batching
            if req.affinity_key() == key and req.resume:
                if job.batch_demuxed:
                    # an earlier batch already filled its manifest:
                    # nothing left to demux into it — skip it (it pops
                    # before the members anyway and resumes solo)
                    continue
                members.append(job)
            else:
                blocked = True
                break
        return members, blocked

    def _collect_batch(self, leader: Job):
        """Collect the leader's batch (cross-job continuous batching):
        hold the window open up to ``batch_window_ms`` for
        same-affinity stragglers, closing EARLY when a non-matching job
        reaches the queue front (fairness must never wait on packing)
        or the queue is empty (a single-job fleet keeps today's path
        and today's latency).  Returns a
        :class:`~land_trendr_tpu_torch.serve.batching.CrossJobBatch` or
        ``None`` (solo — the stock path)."""
        cfg = self.cfg
        if cfg.batch is False:
            return None
        if leader.batch_demuxed:
            # an earlier batch fully demuxed this job: its run is a
            # pure resume (every tile already durable), so a window
            # could only delay it — and a batch behind a no-work
            # leader demuxes nothing.  Solo, stock path.
            return None
        key = leader.request.affinity_key()
        deadline = time.monotonic() + cfg.batch_window_ms / 1000.0
        t0 = time.monotonic()
        with self._lock:
            while True:
                members, blocked = self._batch_front_locked(key)
                now = time.monotonic()
                if (
                    self._stopping
                    or blocked
                    or not members
                    or now >= deadline
                    or leader.cancel.is_set()
                ):
                    break
                self._cond.wait(timeout=min(deadline - now, 0.05))
        if not members:
            return None
        window_wait_s = time.monotonic() - t0
        # the batch.pack seam: an injected pack failure excludes THAT
        # candidate from the batch — it runs solo in its normal queue
        # turn; the batch and its other members live
        packed = []
        for m in members:
            try:
                faults.check("batch.pack")
                packed.append(m)
            except Exception as e:
                log.warning(
                    "batch pack excluded job %s: %s (it runs solo)",
                    m.job_id, e,
                )
        if not packed:
            return None
        from land_trendr_tpu_torch.serve.batching import CrossJobBatch

        batch = CrossJobBatch(leader, packed)
        batch.window_wait_s = window_wait_s
        return batch

    def _open_stack(self, req: JobRequest):
        from land_trendr_tpu_torch.ops.indices import required_bands

        bands = required_bands(req.index, tuple(req.ftv))
        if req.lazy:
            from land_trendr_tpu_torch.runtime.stack import open_stack_dir_c2_lazy

            return open_stack_dir_c2_lazy(req.stack_dir, bands=bands)
        from land_trendr_tpu_torch.runtime import load_stack_dir

        return load_stack_dir(req.stack_dir, bands=bands, device=self.device)

    def _run_job(self, job: Job, batch=None) -> None:
        from land_trendr_tpu_torch.runtime import (
            Run,
            RunCancelled,
            StallError,
            TileRetriesExhausted,
            assemble_outputs,
        )

        req = job.request
        wait_s = job.started_t - job.submitted_t
        if self.telemetry is not None:
            with self._lock:
                depth = self._queued
            self.telemetry.job_start(job, wait_s, depth)
        log.info(
            "job %s start (tenant=%s, waited %.2fs)",
            job.job_id, req.tenant, wait_s,
        )

        timeout_s = (
            req.timeout_s
            if req.timeout_s is not None
            else self.cfg.job_timeout_s
        )
        timer = None
        if timeout_s is not None:
            timer = threading.Timer(timeout_s, self._timeout_job, [job])
            timer.daemon = True
            timer.start()

        state, error, summary, outputs = "error", None, None, None
        try:
            faults.check("serve.job")
            cfg = req.to_run_config(
                job.workdir, job.out_dir, telemetry=self.cfg.telemetry
            )
            if self.cfg.tune_store_dir and cfg.tune_store_dir is None:
                # the replica's shared tuning store: "auto" knobs in the
                # job's config resolve through it (a job naming its OWN
                # store keeps it — explicit wins, like the knobs)
                cfg = dataclasses.replace(
                    cfg, tune_store_dir=self.cfg.tune_store_dir
                )
            stack = self._open_stack(req)
            run = Run(
                stack,
                cfg,
                device=self.device,
                job_id=job.job_id,
                trace_id=job.trace_id,
                cancel=job.cancel,
                programs=self.programs,
                shared_store=self.store,
                # the server configured the process-wide cache once at
                # startup; per-job cache knobs must not clobber it
                shared_cache=True,
                # job events mirror into the SERVER's flight ring, so
                # /debug/flight shows live tile traffic; the run's
                # progress dict feeds /debug/jobs and the sampler
                flight=(
                    self.telemetry.flight
                    if self.telemetry is not None
                    else None
                ),
                # cross-job batching: every durable tile of this leader
                # run demuxes into its batch-mates' manifests (None on
                # the stock solo path)
                on_tile_durable=(
                    batch.demux_tile if batch is not None else None
                ),
            )
            job.run = run
            if batch is not None:
                from land_trendr_tpu_torch.serve.batching import resolve_batch

                # "auto" resolves through the replica's tuning store
                # now that the scene shape is known; an explicit True
                # skips the store (the knob contract)
                if resolve_batch(
                    self.cfg.batch,
                    self.cfg.tune_store_dir,
                    (*stack.shape, stack.n_years),
                    device=self.device,
                ):
                    stats = batch.open(
                        run,
                        max_tiles=self.cfg.batch_max_tiles,
                        window_wait_s=getattr(batch, "window_wait_s", 0.0),
                    )
                    if batch.members and self.telemetry is not None:
                        self.telemetry.batch_launch(job, stats)
                    if not batch.members:
                        # batch_max_tiles trimmed everyone: stock path
                        run.on_tile_durable = None
                        batch = None
                else:
                    run.on_tile_durable = None
                    batch = None
            if run.tune_info is not None:
                # which profile this replica's jobs resolve through —
                # surfaced on /healthz and the fleet snapshot so a mixed
                # tuned/untuned fleet is visible instead of silent
                with self._lock:
                    self._tune_info = dict(run.tune_info)
            summary = run.execute()
            # resuming needs the SAME manifest: fresh submissions get
            # fresh jobs/<id>/work dirs, so every retryable error spells
            # out the workdir the resubmission must pin
            resume_hint = (
                f"resubmit with \"workdir\": {job.workdir!r} to resume"
            )
            if summary.get("tiles_quarantined"):
                state = "retries_exhausted"
                error = (
                    f"{len(summary['tiles_quarantined'])} tile(s) "
                    f"quarantined after exhausting retries; {resume_hint}"
                )
            else:
                if req.assemble:
                    # the Run's RESOLVED config, not the submitted one: a
                    # store re-probed mid-job must not re-resolve "auto"
                    # knobs to different values at assembly time
                    outputs = assemble_outputs(stack, run.cfg, device=self.device)
                state = "done"
        except RunCancelled as e:
            state = "stalled" if job.timed_out else "cancelled"
            error = (
                f"job timeout after {timeout_s}s; manifest resumable — "
                f"resubmit with \"workdir\": {job.workdir!r} to resume"
                if job.timed_out
                else f"{e}; resubmit with \"workdir\": {job.workdir!r} "
                "to resume"
            )
        except StallError as e:
            state, error = "stalled", str(e)
        except TileRetriesExhausted as e:
            state, error = (
                "retries_exhausted",
                f"{e}; resubmit with \"workdir\": {job.workdir!r} to resume",
            )
        except (ValueError, TypeError, FileNotFoundError, NotADirectoryError) as e:
            state, error = "config_error", str(e)
        except Exception as e:
            # the residual class (and the serve.job fault seam's shape):
            # the JOB is terminal, the server and sibling jobs live on
            state, error = "error", f"{type(e).__name__}: {e}"
            log.exception("job %s failed", job.job_id)
        finally:
            if timer is not None:
                timer.cancel()

        if batch is not None:
            # per-member demux accounting, stamped with EACH member's
            # identity (blame attribution still partitions each request
            # exactly); emitted even after a leader failure — whatever
            # demuxed before the abort is durable, and each member's
            # own queued run completes the rest byte-identically
            for mjob, tiles, merr, complete in batch.finalize():
                if self.telemetry is not None:
                    self.telemetry.batch_demux(mjob, tiles)
                # a fully-demuxed member's queue turn is a pure resume:
                # flag it so the dispatcher never holds a batch window
                # for it (a batch behind a no-work leader demuxes
                # nothing — the window could only delay the flood)
                mjob.batch_demuxed = complete
                if merr:
                    log.info(
                        "batch member %s fell back to solo after %d "
                        "demuxed tile(s): %s", mjob.job_id, tiles, merr,
                    )

        with self._lock:
            job.state = state
            job.error = error
            job.summary = summary
            job.outputs = outputs
            job.finished_t = time.time()
            if summary is not None:
                # the Run executed here, so this shape's tile program is
                # warm in this process: the key is warm for
                # any router reading /healthz
                self._note_warm_key_locked(req.affinity_key())
            # release the Run: it pins the job's whole decoded stack
            # (plus manifest/fetcher/uploader) — retained across
            # terminal jobs it would grow the long-lived server by a
            # full scene per job.  /debug/jobs only reads progress for
            # RUNNING jobs, so nothing observes it past this point.
            job.run = None
            self._terminal += 1
            self._running_id = None
            wall_s = job.finished_t - job.submitted_t
        log.info(
            "job %s %s in %.2fs%s",
            job.job_id, state, wall_s, f" ({error})" if error else "",
        )
        with self._lock:
            slo = job.slo_locked()
            self._note_request_locked(job, slo)
        if self.telemetry is not None:
            self.telemetry.job_done(job, wall_s)
            self.telemetry.job_slo(job, slo)
            self.telemetry.program_cache(self.programs.stats())
        self._write_result(job)
        with self._lock:
            self._cond.notify_all()

    def _timeout_job(self, job: Job) -> None:
        with self._lock:
            if job.state != "running":
                return
            job.timed_out = True
        log.warning(
            "job %s exceeded its timeout; cancelling (manifest stays "
            "resumable)", job.job_id,
        )
        job.cancel.set()

    # -- drop-box ----------------------------------------------------------
    def _dropbox_loop(self) -> None:
        cfg = self.cfg
        while not self._dropbox_stop.wait(cfg.dropbox_poll_s):
            try:
                names = sorted(os.listdir(cfg.dropbox_dir))
            except OSError:
                continue
            for name in names:
                if not name.endswith(".json") or name.endswith(
                    (".rejected.json", ".result.json")
                ):
                    continue
                path = os.path.join(cfg.dropbox_dir, name)
                claimed = path + ".claimed"
                try:
                    os.rename(path, claimed)  # atomic claim
                except OSError:
                    continue  # a sibling scanner (or the client) won
                self._submit_dropbox(path, claimed)

    def _submit_dropbox(self, orig: str, claimed: str) -> None:
        try:
            with open(claimed) as f:
                payload = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            self._write_json(
                orig + ".rejected.json",
                {"reason": "bad_request", "detail": f"unreadable: {e}"},
            )
            return
        try:
            snap = self.submit(payload, source="dropbox")
        except Rejection as e:
            self._write_json(
                orig + ".rejected.json",
                {"reason": e.reason, "detail": e.detail},
            )
            return
        with self._lock:
            self._jobs[snap["job_id"]].dropbox_path = orig

    def _write_result(self, job: Job) -> None:
        """Durable terminal-state snapshot for EVERY job:
        ``<workdir>/jobs/<job_id>/result.json`` (plus the drop-box
        sidecar for drop-box jobs).  A ``max_jobs`` server closes its
        API right after the last job goes terminal, so an HTTP client
        can lose the race to one final GET — the result file is the
        durable answer (and the crash-forensics record)."""
        with self._lock:
            snap = job.status_locked()
        job_root = os.path.join(self.cfg.workdir, "jobs", job.job_id)
        os.makedirs(job_root, exist_ok=True)
        self._write_json(os.path.join(job_root, "result.json"), snap)
        if job.dropbox_path:
            self._write_json(job.dropbox_path + ".result.json", snap)

    @staticmethod
    def _write_json(path: str, payload: dict) -> None:
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=2, default=str)
            os.replace(tmp, path)
        except OSError as e:
            log.error("drop-box sidecar write failed (%s): %s", path, e)

    # -- shutdown ----------------------------------------------------------
    def _shutdown_shared(self, status: str) -> None:
        """Tear down the shared warm state (idempotent; the reverse of
        construction).  Jobs already terminal keep their durable
        manifests/outputs whatever happens here."""
        with self._lock:
            self._stopping = True
            self._closing = True
            self._cond.notify_all()
            # drain in-flight profiler captures BEFORE closing anything:
            # a drain-mode (--max-jobs) server otherwise exits while a
            # handler thread is inside the native profiler session —
            # observed as a SIGSEGV at interpreter teardown, and a lost
            # response for the client.  Bounded by the capture's own
            # duration ceiling plus flush slack; new captures are
            # refused once _closing is set, so this converges.
            deadline = time.monotonic() + _JobAPIHandler.MAX_PROFILE_S + 60
            while self._captures and time.monotonic() < deadline:
                self._cond.wait(timeout=1.0)
        self._dropbox_stop.set()
        httpd = getattr(self, "_httpd", None)
        thread = getattr(self, "_http_thread", None)
        if httpd is not None:
            if thread is not None:
                # shutdown() handshakes with a RUNNING serve_forever;
                # called before the loop thread ever started it waits
                # forever — a failed construction closes the socket only
                httpd.shutdown()
            httpd.server_close()
            self._httpd = None
        if thread is not None:
            thread.join(timeout=10)
            self._http_thread = None
        if self._dropbox_thread is not None:
            self._dropbox_thread.join(timeout=10)
            self._dropbox_thread = None
        if self.store is not None:
            try:
                self.store.close()
            except Exception as exc:
                log.error("ingest-store flush/close failed: %s", exc)
            blockcache.detach_store(self.store)
            self.store = None
        if self._fault_plan is not None:
            faults.set_observer(None)
            faults.deactivate()
            self._fault_plan = None
        if self.telemetry is not None:
            try:
                self.telemetry.close(
                    status, time.time() - self._t0, self.programs.stats()
                )
            except Exception as exc:
                log.error("serve telemetry close failed: %s", exc)
            # final flight dump AFTER close, so the terminal
            # program_cache/run_done events are in the ring too — the
            # "how did the end look" slice beside the full stream
            flight = self.telemetry.flight
            if flight is not None:
                try:
                    flight.dump(flight_path(self.cfg.workdir))
                except Exception as exc:
                    log.error("flight-ring dump failed: %s", exc)
            self.telemetry = None


class _JobAPIServer(http.server.ThreadingHTTPServer):
    """The loopback job API: thin JSON routing over the server object.

    Handler threads only ever call the server's locked methods; the
    dispatcher never runs here, so a slow client cannot stall a job.
    """

    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, server: SegmentationServer) -> None:
        self.lt_server = server
        super().__init__(addr, _JobAPIHandler)

    def handle_error(self, request, client_address) -> None:
        import sys

        if isinstance(
            sys.exc_info()[1], (BrokenPipeError, ConnectionResetError)
        ):
            return
        super().handle_error(request, client_address)


class _JobAPIHandler(http.server.BaseHTTPRequestHandler):
    """Routes::

        POST /jobs              submit (JSON body → job snapshot | 429/400)
        GET  /jobs              every job's snapshot
        GET  /jobs/<id>         one job's snapshot
        POST /jobs/<id>/cancel  cancel (queued → terminal; running → event)
        GET  /healthz           liveness + queue/uptime/warm-program stats
        GET  /metrics           the lt_serve_* exposition
        GET  /metrics/exemplars histogram bucket → recent trace_id rings
        GET  /debug/flight      the flight ring's recent events
                                (?n=100, ?trace=<trace_id> filter)
        GET  /debug/stacks      all-thread tracebacks (sys._current_frames)
        GET  /debug/jobs        per-job live state incl. run progress
        GET  /debug/requests    recent terminal requests, slowest first
                                (trace_id + replica-side latency split)
        GET  /debug/kernels     this process's kernel launch counts
        POST /debug/profile     on-demand bounded torch.profiler capture

    The ``/debug`` surface shares the job API's loopback-only bind (it
    reads process internals and triggers profiler captures) and is a
    404 wall when ``ServeConfig.debug_endpoints`` is off.  Handler
    threads only ever read locked snapshots; ``/debug/stacks`` in
    particular takes NO locks, so it answers even while the dispatcher
    is wedged — the question it exists for.
    """

    server: _JobAPIServer

    #: POST /debug/profile duration bound, seconds: long enough for any
    #: useful window, short enough that a typo'd duration cannot pin the
    #: process-global profiler for an hour
    MAX_PROFILE_S = 300.0

    def _send_json(self, status: int, payload) -> None:
        body = json.dumps(payload, default=str).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if status == 429:
            self.send_header("Retry-After", "1")
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 - stdlib API name
        srv = self.server.lt_server
        path, _, query = self.path.partition("?")
        path = path.rstrip("/")
        if path.startswith("/debug"):
            if not srv.cfg.debug_endpoints:
                self.send_error(404)
                return
            if path == "/debug/flight":
                n = trace = None
                try:
                    from urllib.parse import parse_qs

                    params = parse_qs(query)
                    raw = params.get("n")
                    if raw:
                        n = max(1, int(raw[0]))
                    rawt = params.get("trace")
                    if rawt:
                        trace = rawt[0]
                except ValueError:
                    self._send_json(
                        400, {"error": "bad_request", "detail": "n must be int"}
                    )
                    return
                snap = srv.flight_snapshot(n, trace_id=trace)
                if snap is None:
                    self._send_json(
                        404,
                        {"error": "no flight ring (telemetry off or "
                                  "flight_ring_events=0)"},
                    )
                else:
                    self._send_json(200, snap)
            elif path == "/debug/stacks":
                from land_trendr_tpu_torch.obs.flight import thread_stacks

                self._send_json(200, {"threads": thread_stacks()})
            elif path == "/debug/jobs":
                self._send_json(200, {"jobs": srv.debug_jobs()})
            elif path == "/debug/requests":
                self._send_json(200, {"requests": srv.debug_requests()})
            elif path == "/debug/kernels":
                from land_trendr_tpu_torch.ops.segment_cuda import launch_counts

                self._send_json(200, {"launches": launch_counts()})
            else:
                self.send_error(404)
            return
        if path == "/metrics/exemplars":
            if srv.telemetry is None:
                self.send_error(404)
                return
            self._send_json(
                200, {"exemplars": srv.telemetry.registry.exemplars()}
            )
            return
        if path == "/healthz":
            self._send_json(200, {"ok": True, **srv.stats()})
        elif path == "/metrics":
            if srv.telemetry is None:
                self.send_error(404)
                return
            body = srv.telemetry.registry.render().encode()
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif path == "/jobs":
            self._send_json(200, {"jobs": srv.jobs()})
        elif path.startswith("/jobs/"):
            snap = srv.job_status(path[len("/jobs/"):])
            if snap is None:
                self._send_json(404, {"error": "no such job"})
            else:
                self._send_json(200, snap)
        else:
            self.send_error(404)

    def do_POST(self) -> None:  # noqa: N802 - stdlib API name
        srv = self.server.lt_server
        path = self.path.split("?")[0].rstrip("/")
        if path == "/debug/profile":
            if not srv.cfg.debug_endpoints:
                self.send_error(404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._send_json(
                    400, {"error": "bad_request", "detail": str(e)}
                )
                return
            if not isinstance(payload, dict):
                self._send_json(
                    400,
                    {"error": "bad_request",
                     "detail": "body must be a JSON object"},
                )
                return
            duration_s = payload.get("duration_s", 1.0)
            # bool is an int subclass; `true` as a duration is a typo
            if isinstance(duration_s, bool) or not isinstance(
                duration_s, (int, float)
            ):
                self._send_json(
                    400,
                    {"error": "bad_request",
                     "detail": "duration_s must be a number"},
                )
                return
            duration_s = float(duration_s)
            if not (0 < duration_s <= self.MAX_PROFILE_S):
                self._send_json(
                    400,
                    {"error": "bad_request",
                     "detail": f"duration_s must be in (0, "
                               f"{self.MAX_PROFILE_S}]"},
                )
                return
            # synchronous by design: the capture is duration-bounded and
            # runs on THIS handler thread — the dispatcher (and its job)
            # keep running, which is exactly what the trace captures
            self._send_json(200, srv.capture_profile(duration_s))
            return
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
                snap = srv.submit(payload, source="http")
            except Rejection as e:
                self._send_json(
                    e.http_status,
                    {"error": e.reason, "detail": e.detail},
                )
                return
            self._send_json(200, snap)
        elif path.startswith("/jobs/") and path.endswith("/cancel"):
            job_id = path[len("/jobs/"):-len("/cancel")]
            snap = srv.cancel(job_id)
            if snap is None:
                self._send_json(404, {"error": "no such job"})
            else:
                self._send_json(200, snap)
        else:
            self.send_error(404)

    def log_message(self, *a) -> None:  # quiet: no per-request stderr
        pass
