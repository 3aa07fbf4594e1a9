"""Service-mode configuration: everything that defines one server process.

:class:`ServeConfig` is the serve-layer sibling of
:class:`~land_trendr_tpu_torch.runtime.driver.RunConfig`: the one configuration
surface of ``lt serve``, projected to the ``serve`` CLI subcommand and to
README's ``## Serve configuration`` table (the LT004 coupling rule checks
all three, exactly like the RunConfig triangle).

Security posture: the job API is an **unauthenticated local control
surface** (submit arbitrary segmentation work, read job state, cancel),
so unlike the scrape-only ``/metrics`` endpoint it is loopback-ONLY —
``serve_host`` must name a loopback address and the config refuses
anything else at construction time.  Remote access goes through an
authenticated proxy or the filesystem drop-box, never a raw bind.
"""

from __future__ import annotations

import dataclasses

__all__ = ["LOOPBACK_HOSTS", "ServeConfig"]

#: the bind addresses the job API accepts — loopback spellings only (the
#: API is unauthenticated job submission; see the module docstring)
LOOPBACK_HOSTS = ("127.0.0.1", "localhost", "::1")


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Everything that defines one ``lt serve`` server process."""

    #: server root: the server's own events/metrics stream, the default
    #: per-job ``jobs/<job_id>/{work,out}`` directories, and (with
    #: ``ingest_store_mb``) the shared persistent ingest store live here
    workdir: str = "lt_serve"
    #: loopback HTTP JSON API port (0 = ephemeral, reported at startup)
    serve_port: int = 0
    #: bind address for the job API — loopback only (``127.0.0.1``,
    #: ``localhost`` or ``::1``); see the module docstring
    serve_host: str = "127.0.0.1"
    #: admission control: a submission that would grow the queue past
    #: this depth is rejected with HTTP 429 (``job_rejected`` event,
    #: ``lt_serve_rejections_total``) instead of building unbounded
    #: backlog — the client owns the retry policy
    serve_queue_depth: int = 16
    #: admission control: per-tenant in-flight bound (queued + running
    #: jobs); a tenant at its cap gets 429 while other tenants' traffic
    #: proceeds — one hot tenant cannot monopolise the queue
    tenant_max_inflight: int = 4
    #: default per-job wall-clock bound, submit-accepted → terminal; a
    #: job that exceeds it is cancelled through the run's cancel event
    #: and reported ``stalled`` (the exit-4 analog — the stall
    #: watchdog's job-level mirror).  Jobs may override per request.
    #: ``None`` disables the default bound.
    job_timeout_s: float | None = None
    #: filesystem drop-box for batch submission: job-request JSON files
    #: appearing under this directory are claimed atomically (rename),
    #: submitted through the SAME admission control as HTTP, and answered
    #: with ``<name>.rejected.json`` / terminal ``<name>.result.json``
    #: sidecars.  ``None`` disables the scanner.
    dropbox_dir: str | None = None
    #: drop-box scan period, seconds
    dropbox_poll_s: float = 1.0
    #: drain this many jobs to a terminal state, then shut down cleanly —
    #: the bounded mode benches and tests drive; ``None`` serves forever
    max_jobs: int | None = None
    #: process-wide decoded-block cache budget (MiB) shared by every job
    #: (the server owns the :mod:`land_trendr_tpu_torch.io.blockcache`
    #: configuration; per-job RunConfig cache knobs are overridden)
    feed_cache_mb: int = 256
    #: shared feed-decode threads (the blockcache knob): 0 = auto
    decode_workers: int = 0
    #: shared persistent ingest store budget (MiB): decoded blocks from
    #: EVERY job spill to one store under the server workdir, so a warm
    #: job over already-ingested stacks skips TIFF decode entirely —
    #: "ingest once, serve many" across requests.  0 = off.
    ingest_store_mb: int = 0
    #: store directory override (default ``<workdir>/ingest_store``)
    ingest_store_dir: str | None = None
    #: shared tuning store (:mod:`land_trendr_tpu_torch.tune`, ``lt tune``'s
    #: output): every job whose RunConfig carries ``"auto"`` knob
    #: sentinels (and no store of its own) resolves them through this
    #: store, so the whole replica — and a fleet of replicas pointed at
    #: one directory — runs tuned.  Per-job explicit knobs always win;
    #: ``None`` leaves ``"auto"`` resolving to the hardcoded defaults.
    tune_store_dir: str | None = None
    #: server + per-job telemetry: the server writes its own
    #: ``events.jsonl`` scope (job lifecycle, admission, program-cache
    #: aggregate) and ``lt_serve_*`` metrics under ``workdir``; each
    #: job's run writes its own scope under the job workdir with the
    #: job_id threaded onto every event
    telemetry: bool = True
    #: with ``telemetry``: serve the server registry's live ``/metrics``
    #: on this port (0 = ephemeral).  ``None`` = no standalone metrics
    #: server (the job API serves GET /metrics regardless).
    metrics_port: int | None = None
    #: bind address for ``metrics_port`` (the scrape endpoint may be
    #: non-loopback — it is read-only, unlike the job API)
    metrics_host: str = ""
    #: ``metrics.prom`` refresh period, seconds
    metrics_interval_s: float = 5.0
    #: deterministic fault injection for soak runs: the server arms ONE
    #: process-wide plan shared by every job (``serve.submit`` /
    #: ``serve.job`` seams plus all the pipeline seams); production
    #: servers leave this unset
    fault_schedule: str | None = None
    #: the live ``/debug`` surface on the job API (``/debug/flight``,
    #: ``/debug/stacks``, ``/debug/jobs``, ``POST /debug/profile``) —
    #: loopback-only like the rest of the API (it reads process
    #: internals and triggers profiler captures).  ``False`` turns every
    #: ``/debug`` route into a 404.
    debug_endpoints: bool = True
    #: flight-recorder ring capacity, events: with ``telemetry``, a
    #: bounded in-memory ring mirrors every server AND job event (the
    #: ``/debug/flight`` window, dumped to ``<workdir>/flight.jsonl`` at
    #: shutdown) and a sampler thread emits periodic ``flight_sample``
    #: resource events.  ``0`` disables the ring + sampler.
    flight_ring_events: int = 2048
    #: flight resource-sampler period, seconds
    sampler_interval_s: float = 5.0
    #: request-tracing recency bound: how many recent TERMINAL requests
    #: (trace id, latency split, status) ``GET /debug/requests`` serves,
    #: slowest-first — the human half of the exemplar loop (the
    #: ``/metrics/exemplars`` JSON is the machine half).  0 disables
    #: the ring (the endpoint then answers an empty list).
    request_ring: int = 64
    #: fleet telemetry plane (:mod:`land_trendr_tpu_torch.obs` publish /
    #: aggregate / history / alerts): with ``telemetry``, the server
    #: periodically (1) snapshots its registry + queue/SLO state into
    #: an atomic ``<telemetry_dir>/<host>.<pid>.snap.json``, (2) folds
    #: EVERY snapshot under that shared directory into one pod view —
    #: sibling replicas and standalone runs pointed at the same dir
    #: included — (3) appends the fold to the on-disk history ring
    #: under ``<workdir>/history``, and (4) evaluates the alert rules
    #: over that history (``alert`` events, ``lt_alerts_*`` metrics,
    #: active alerts on ``/healthz`` and ``lt top``).
    publish: bool = False
    #: fleet beat period, seconds (snapshot refresh + fold + alert
    #: evaluation)
    publish_interval_s: float = 5.0
    #: shared telemetry directory override (default
    #: ``<workdir>/telemetry``) — point N replicas at one directory to
    #: aggregate the fleet
    telemetry_dir: str | None = None
    #: alert-rules file (JSON, :func:`land_trendr_tpu_torch.obs.alerts.
    #: load_rules`) — ``None`` uses the built-in defaults (host
    #: staleness/absence + SLO burn).  Parsed at config time: a typo'd
    #: rule is a startup error, not a dead rule discovered after the
    #: incident.
    alert_rules: str | None = None
    #: cross-job continuous batching (:mod:`land_trendr_tpu_torch.serve.
    #: batching`): coalesce queued same-affinity jobs behind one shared
    #: device launch — compute once, demux byte-identical artifacts to
    #: every member.  ``True``/``False`` force it; ``"auto"`` resolves
    #: through the replica's tuning store (``tune_store_dir``) at batch
    #: time, defaulting ON (batching changes packing, never bytes or
    #: fairness ordering).
    batch: bool | str = "auto"
    #: how long the dispatcher holds the batch window open (milliseconds)
    #: for same-affinity stragglers to join the popped leader before
    #: launching — the window closes EARLY the moment a non-matching job
    #: reaches the queue front (batching must never delay the fairness
    #: order).  0 batches only what is already queued.
    batch_window_ms: float = 50.0
    #: batch size bound, total coalesced tiles (member jobs × tiles per
    #: job); members past the bound run solo in their normal queue turn.
    #: 0 = unbounded.
    batch_max_tiles: int = 0

    def __post_init__(self) -> None:
        if not (0 <= self.serve_port <= 65535):
            raise ValueError(
                f"serve_port={self.serve_port} outside 0..65535"
            )
        if self.serve_host not in LOOPBACK_HOSTS:
            raise ValueError(
                f"serve_host={self.serve_host!r} is not a loopback "
                f"address {LOOPBACK_HOSTS}: the job API is an "
                "unauthenticated control surface and never binds a "
                "routable interface (front it with an authenticated "
                "proxy, or use the drop-box)"
            )
        if self.serve_queue_depth < 1:
            raise ValueError(
                f"serve_queue_depth={self.serve_queue_depth} must be >= 1"
            )
        if self.tenant_max_inflight < 1:
            raise ValueError(
                f"tenant_max_inflight={self.tenant_max_inflight} must be "
                ">= 1"
            )
        if self.job_timeout_s is not None and self.job_timeout_s <= 0:
            raise ValueError(
                f"job_timeout_s={self.job_timeout_s} must be > 0 (or "
                "None for no default bound)"
            )
        if self.dropbox_poll_s <= 0:
            raise ValueError(
                f"dropbox_poll_s={self.dropbox_poll_s} must be > 0"
            )
        if self.max_jobs is not None and self.max_jobs < 1:
            raise ValueError(
                f"max_jobs={self.max_jobs} must be >= 1 (or None to "
                "serve forever)"
            )
        if self.feed_cache_mb < 0:
            raise ValueError(
                f"feed_cache_mb={self.feed_cache_mb} must be >= 0 (0 = off)"
            )
        if self.decode_workers < 0:
            raise ValueError(
                f"decode_workers={self.decode_workers} must be >= 0 "
                "(0 = auto)"
            )
        if self.ingest_store_mb < 0:
            raise ValueError(
                f"ingest_store_mb={self.ingest_store_mb} must be >= 0 "
                "(0 = off)"
            )
        if self.ingest_store_dir is not None and not self.ingest_store_mb:
            raise ValueError(
                "ingest_store_dir requires ingest_store_mb > 0 (there is "
                "no store to place without a budget)"
            )
        if self.metrics_port is not None:
            if not self.telemetry:
                raise ValueError(
                    "metrics_port requires telemetry=True (the registry "
                    "the endpoint serves only exists on telemetry runs)"
                )
            if not (0 <= self.metrics_port <= 65535):
                raise ValueError(
                    f"metrics_port={self.metrics_port} outside 0..65535"
                )
        elif self.metrics_host:
            raise ValueError(
                "metrics_host requires metrics_port (there is no server "
                "to bind without a port)"
            )
        if self.metrics_interval_s <= 0:
            raise ValueError(
                f"metrics_interval_s={self.metrics_interval_s} must be > 0"
            )
        if self.flight_ring_events < 0 or self.flight_ring_events == 1:
            raise ValueError(
                f"flight_ring_events={self.flight_ring_events} must be 0 "
                "(off) or >= 2 (a useful ring holds at least a run_start "
                "and one event)"
            )
        if self.sampler_interval_s <= 0:
            raise ValueError(
                f"sampler_interval_s={self.sampler_interval_s} must be > 0"
            )
        if self.request_ring < 0:
            raise ValueError(
                f"request_ring={self.request_ring} must be >= 0 (0 = off)"
            )
        if self.publish and not self.telemetry:
            raise ValueError(
                "publish requires telemetry=True (the fleet snapshot is "
                "a dump of the telemetry registry; there is nothing to "
                "publish without one)"
            )
        if self.publish_interval_s <= 0:
            raise ValueError(
                f"publish_interval_s={self.publish_interval_s} must be > 0"
            )
        if self.telemetry_dir is not None and not self.publish:
            raise ValueError(
                "telemetry_dir requires publish=True (there is no "
                "snapshot to place without a publisher)"
            )
        if self.alert_rules is not None:
            if not self.publish:
                raise ValueError(
                    "alert_rules requires publish=True (rules are "
                    "evaluated by the fleet loop)"
                )
            # parse NOW: a typo'd rule is a startup error, like
            # fault_schedule below
            from land_trendr_tpu_torch.obs.alerts import load_rules

            try:
                load_rules(self.alert_rules)
            except OSError as e:
                raise ValueError(
                    f"alert_rules file unreadable: {e}"
                ) from None
        if not (
            self.batch is True or self.batch is False or self.batch == "auto"
        ):
            raise ValueError(
                f"batch={self.batch!r} must be True, False or 'auto' "
                "(tuning-store resolution)"
            )
        if self.batch_window_ms < 0:
            raise ValueError(
                f"batch_window_ms={self.batch_window_ms} must be >= 0 "
                "(0 = batch only what is already queued)"
            )
        if self.batch_max_tiles < 0:
            raise ValueError(
                f"batch_max_tiles={self.batch_max_tiles} must be >= 0 "
                "(0 = unbounded)"
            )
        if self.fault_schedule is not None:
            # parse NOW: a typo'd seam is a config error at startup, not
            # a dead injection discovered after the soak run (the same
            # contract as RunConfig.fault_schedule)
            from land_trendr_tpu_torch.runtime import faults

            faults.parse_schedule(self.fault_schedule)
