"""The run-wide telemetry bundle the runtime driver reports through.

Copy of ``land_trendr_tpu/obs/telemetry.py``: the event names, fields and
``lt_*`` metric names are the JAX package's, so its consumers
(``tools/check_events_schema.py``, ``tools/lt_top.py``,
``tools/obs_report.py``) read this package's ``events.jsonl`` and
``metrics.prom`` unchanged.

One :class:`Telemetry` per ``run_stack`` call ties the two halves of
:mod:`land_trendr_tpu_torch.obs` together and owns their lifecycles:

* the per-process :class:`~land_trendr_tpu_torch.obs.events.EventLog`
  (``<workdir>/events.jsonl``, ``events.p<i>.jsonl`` under multihost);
* a :class:`~land_trendr_tpu_torch.obs.metrics.MetricsRegistry` pre-populated
  with the driver instrument set (the ``lt_*`` names documented in
  README.md §Observability), its :class:`PromFileExporter` refreshing
  ``<workdir>/metrics.prom``, and — when ``metrics_port`` is set — the
  in-flight ``/metrics`` HTTP endpoint.

The driver calls the ``tile_*`` / ``run_*`` hooks; the tile manifest calls
:meth:`write_done` from inside :meth:`TileManifest.record` (writer-pool
threads — every path here is thread-safe).  Deliberately **jax-free**:
device facts (mesh size, resolved impl, HBM live bytes) are plain values
passed in by the driver, so the subsystem tests run without a backend and
the import cost is stdlib-only.
"""

from __future__ import annotations

import os
from typing import Any, Mapping

from land_trendr_tpu_torch.obs.events import EventLog, events_path
from land_trendr_tpu_torch.obs.metrics import (
    DEFAULT_LATENCY_BUCKETS,
    MetricsHTTPServer,
    MetricsRegistry,
    PromFileExporter,
)

__all__ = ["Telemetry", "metrics_path"]

#: px/s histogram buckets: log-spaced from one-core-CPU (~2e4) past the
#: 10M px/s north star
_PXS_BUCKETS = (1e4, 3e4, 1e5, 3e5, 1e6, 3e6, 1e7, 3e7, 1e8)


def metrics_path(workdir: str, process_index: int = 0, process_count: int = 1) -> str:
    """Per-process ``.prom`` path (mirrors :func:`events_path` naming)."""
    if process_count <= 1:
        return os.path.join(workdir, "metrics.prom")
    return os.path.join(workdir, f"metrics.p{process_index}.prom")


class Telemetry:
    """Event log + metrics registry + exporters for one driver run."""

    def __init__(
        self,
        workdir: str,
        *,
        fingerprint: str = "",
        process_index: int = 0,
        process_count: int = 1,
        metrics_port: int | None = None,
        metrics_host: str = "",
        metrics_interval_s: float = 5.0,
        job_id: str | None = None,
        trace_id: str | None = None,
        flight=None,
        publish_dir: str | None = None,
        publish_interval_s: float = 5.0,
        publish_probes=None,
    ) -> None:
        os.makedirs(workdir, exist_ok=True)
        # fleet publish (obs/publish): with ``publish_dir``, a daemon
        # thread snapshots this registry + the host's ``publish_probes``
        # state into <publish_dir>/<host>.<pid>.snap.json every
        # ``publish_interval_s`` — the per-process feed the pod
        # aggregate (obs/aggregate, tools/lt_fleet.py) folds
        self._publish_dir = publish_dir
        self._publish_interval_s = publish_interval_s
        self._publish_probes = publish_probes
        self._publisher = None
        # serve mode threads the job id — and the fleet-wide trace id
        # minted at router/serve admission — onto EVERY event of this
        # run's scope (EventLog common fields, schema-optional
        # everywhere), so a cross-job fold attributes tile traffic per
        # request and tools/lt_request.py joins the run scope to the
        # router's request spans.  ``flight`` (an
        # obs.flight.FlightRecorder) mirrors every emit into the
        # in-memory ring behind the /debug surface — the run's own ring
        # on --flight runs, the SERVER's shared ring in serve mode (so
        # job tile traffic shows up in /debug/flight live).
        self.flight = flight
        common: dict | None = {}
        if job_id:
            common["job_id"] = job_id
        if trace_id:
            common["trace_id"] = trace_id
        self.events = EventLog(
            events_path(workdir, process_index, process_count),
            common=common or None,
            mirror=flight.record if flight is not None else None,
        )
        try:
            self._init_metrics(
                workdir, fingerprint, process_index, process_count,
                metrics_port, metrics_host, metrics_interval_s,
            )
        except BaseException:
            # a half-built Telemetry (e.g. --metrics-port already bound)
            # must not leak the event fd, the exporter thread, or the
            # server — the caller only gets the exception, never a handle.
            # The event-fd close rides a finally: a server stop that
            # ALSO fails must not leak the fd too
            try:
                srv = getattr(self, "_server", None)
                if srv is not None:
                    srv.stop()
            finally:
                self.events.close()
            raise

    def _init_metrics(
        self,
        workdir: str,
        fingerprint: str,
        process_index: int,
        process_count: int,
        metrics_port: int | None,
        metrics_host: str,
        metrics_interval_s: float,
    ) -> None:
        self.registry = MetricsRegistry()
        r = self.registry
        self._tiles_done = r.counter(
            "lt_tiles_done_total", "tiles whose device result completed"
        )
        self._tile_retries = r.counter(
            "lt_tile_retries_total", "tile attempt failures that were retried"
        )
        self._tiles_failed = r.counter(
            "lt_tiles_failed_total", "tiles that exhausted their retry budget"
        )
        self._pixels = r.counter(
            "lt_pixels_total", "real (unpadded) pixels whose tile completed"
        )
        self._bytes_written = r.counter(
            "lt_artifact_bytes_written_total",
            "bytes of tile checkpoint artifacts persisted",
        )
        self._compute_hist = r.histogram(
            "lt_tile_compute_seconds",
            "per-tile dispatch + device-wait wall seconds",
            buckets=DEFAULT_LATENCY_BUCKETS,
        )
        self._record_hist = r.histogram(
            "lt_tile_record_seconds",
            "per-tile artifact + manifest persist seconds",
            buckets=DEFAULT_LATENCY_BUCKETS,
        )
        self._pxs_hist = r.histogram(
            "lt_tile_px_per_s", "per-tile pixel throughput", buckets=_PXS_BUCKETS
        )
        self._pxs_gauge = r.gauge("lt_px_per_s", "last tile's pixel throughput")
        self._no_fit = r.gauge("lt_no_fit_rate", "last written tile's no-fit rate")
        self._feed_backlog = r.gauge(
            "lt_feed_backlog", "fed tiles waiting for dispatch"
        )
        self._write_backlog = r.gauge(
            "lt_write_backlog", "finished tiles waiting in the writer pool"
        )
        self._fetch_backlog = r.gauge(
            "lt_fetch_backlog", "in-flight async device->host fetches"
        )
        self._dev_bytes = r.gauge(
            "lt_device_bytes_in_use", "device allocator live bytes (all local devices)"
        )
        self._dev_peak = r.gauge(
            "lt_device_bytes_peak", "high watermark of lt_device_bytes_in_use"
        )
        # feed-path decode subsystem (io/blockcache): run-scoped counters
        # folded in once per run by Telemetry.feed_cache
        self._fc_hits = r.counter(
            "lt_feed_cache_hits_total", "decoded-block cache hits (feed path)"
        )
        self._fc_misses = r.counter(
            "lt_feed_cache_misses_total", "decoded-block cache misses (feed path)"
        )
        self._fc_evictions = r.counter(
            "lt_feed_cache_evictions_total",
            "decoded blocks evicted by the cache byte budget",
        )
        self._fc_decode_s = r.counter(
            "lt_feed_decode_seconds_total",
            "block-decode wall seconds, summed across decode threads",
        )
        self._fc_ra_blocks = r.counter(
            "lt_feed_readahead_blocks_total",
            "blocks decoded into the cache by readahead hints",
        )
        self._fc_ra_hits = r.counter(
            "lt_feed_readahead_hits_total",
            "readahead-decoded blocks later served to a real read",
        )
        self._fc_bytes = r.gauge(
            "lt_feed_cache_bytes", "decoded-block cache occupancy (bytes)"
        )
        self._fc_corrupt = r.counter(
            "lt_feed_corrupt_dropped_total",
            "corrupt cached blocks invalidated and re-decoded from file",
        )
        # robustness subsystem (runtime/faults + the driver hardening)
        self._faults = r.counter(
            "lt_faults_injected_total",
            "scheduled faults fired by the deterministic injector",
        )
        self._quarantined = r.counter(
            "lt_tiles_quarantined_total",
            "tiles that exhausted retries and were quarantined",
        )
        self._stalls = r.counter(
            "lt_stalls_total", "stall-watchdog aborts (no tile progress)"
        )
        self._stragglers = r.counter(
            "lt_stragglers_total",
            "tiles whose in-flight duration exceeded k x the rolling "
            "median (obs/spans.StragglerDetector)",
        )
        # elastic pod scheduling (runtime/leases): per-acquisition
        # counters advanced by the tile_leased / lease_stolen /
        # tile_speculated emits, plus the run-end lease rollup
        self._lease_acquired = r.counter(
            "lt_lease_acquired_total",
            "tile leases this process won from the shared-manifest queue "
            "(claims + steals + speculative re-leases)",
        )
        self._lease_stolen = r.counter(
            "lt_lease_stolen_total",
            "expired tile leases this process stole from dead/wedged peers",
        )
        self._lease_renewals = r.counter(
            "lt_lease_renewals_total",
            "lease renewal records appended for held in-flight tiles",
        )
        self._spec_tiles = r.counter(
            "lt_speculative_tiles_total",
            "straggler-flagged tiles this process re-leased speculatively",
        )
        self._spec_wins = r.counter(
            "lt_speculative_wins_total",
            "speculative tiles whose first durable done record was this "
            "process's (the straggler's owner lost the race)",
        )
        self._demoted = r.gauge(
            "lt_fetch_demoted",
            "1 once repeated packed-fetch failures demoted the run to the "
            "per-product sync path",
        )
        # device→host fetch subsystem (runtime/fetch): run-scoped counters
        # folded in once per run by Telemetry.fetch
        self._fx_tiles = r.counter(
            "lt_fetch_tiles_total", "tiles whose outputs were fetched to host"
        )
        self._fx_transfers = r.counter(
            "lt_fetch_transfers_total",
            "device->host transfers issued (packed fetch = 1 per tile)",
        )
        self._fx_bytes = r.counter(
            "lt_fetch_bytes_total", "device->host wire bytes fetched"
        )
        self._fx_pack_s = r.counter(
            "lt_fetch_pack_seconds_total",
            "host seconds dispatching the device-side pack program",
        )
        self._fx_wait_s = r.counter(
            "lt_fetch_wait_seconds_total",
            "host seconds blocked waiting for fetched bytes to land",
        )
        self._fx_unpack_s = r.counter(
            "lt_fetch_unpack_seconds_total",
            "host seconds unpacking landed bytes into artifact arrays",
        )
        self._fx_backlog = r.gauge(
            "lt_fetch_backlog_max", "high watermark of in-flight async fetches"
        )
        # host→device upload subsystem (runtime/feed): run-scoped
        # counters folded in once per run by Telemetry.upload
        self._up_tiles = r.counter(
            "lt_upload_tiles_total", "tiles whose fed inputs were uploaded"
        )
        self._up_transfers = r.counter(
            "lt_upload_transfers_total",
            "host->device transfers issued (packed upload = 1 per tile)",
        )
        self._up_bytes = r.counter(
            "lt_upload_bytes_total", "host->device wire bytes uploaded"
        )
        self._up_pack_s = r.counter(
            "lt_upload_pack_seconds_total",
            "host seconds packing fed arrays + issuing device_put",
        )
        self._up_wait_s = r.counter(
            "lt_upload_wait_seconds_total",
            "host seconds blocked waiting for uploaded bytes to land",
        )
        self._up_unpack_s = r.counter(
            "lt_upload_unpack_seconds_total",
            "host seconds dispatching the device-side unpack program",
        )
        self._up_backlog = r.gauge(
            "lt_upload_backlog_max", "high watermark of in-flight async uploads"
        )
        self._up_demoted = r.gauge(
            "lt_upload_demoted",
            "1 once repeated packed-upload failures demoted the run to the "
            "per-array sync dispatch",
        )
        # persistent ingest store (io/blockstore): run-scoped counters
        # folded in once per run by Telemetry.ingest_store
        self._is_hits = r.counter(
            "lt_ingest_store_hits_total",
            "decoded blocks served from the persistent store (decode skipped)",
        )
        self._is_misses = r.counter(
            "lt_ingest_store_misses_total",
            "store lookups that fell through to a TIFF decode",
        )
        self._is_put_blocks = r.counter(
            "lt_ingest_store_put_blocks_total",
            "decoded blocks persisted into the store",
        )
        self._is_put_bytes = r.counter(
            "lt_ingest_store_put_bytes_total",
            "bytes of decoded blocks persisted into the store",
        )
        self._is_stale = r.counter(
            "lt_ingest_store_stale_dropped_total",
            "stale-generation entries dropped (input file rewritten)",
        )
        self._is_corrupt = r.counter(
            "lt_ingest_store_corrupt_dropped_total",
            "corrupt store entries/segments dropped and re-decoded",
        )
        self._is_bytes = r.gauge(
            "lt_ingest_store_bytes", "persistent store occupancy (bytes)"
        )
        # autotuned execution profiles (land_trendr_tpu_torch/tune): probe
        # counts advanced per tune_probe emit, store verdicts per
        # tune_profile emit
        self._tn_probes = r.counter(
            "lt_tune_probes_total",
            "calibration probe reps run by the autotuner",
        )
        self._tn_failures = r.counter(
            "lt_tune_probe_failures_total",
            "knob-group probes that failed and were skipped (defaults kept)",
        )
        self._tn_store_hits = r.counter(
            "lt_tune_store_hits_total",
            "tuning-store profile reloads (zero probes run)",
        )
        self._tn_store_misses = r.counter(
            "lt_tune_store_misses_total",
            "tuning-store key misses (probed or fell back to defaults)",
        )
        self._tn_age = r.gauge(
            "lt_tune_profile_age_seconds",
            "age of the resolved tuning profile (0 = freshly probed)",
        )
        if fingerprint:
            r.gauge(
                "lt_run_info",
                "constant 1; labels carry run identity",
                labels={"fingerprint": fingerprint},
            ).set(1)

        # bind the port BEFORE starting the exporter thread: a bind
        # failure is the common construction error, and nothing should be
        # running yet when it raises
        self._server = (
            MetricsHTTPServer(self.registry, metrics_port, host=metrics_host)
            if metrics_port is not None
            else None
        )
        try:
            self._exporter = PromFileExporter(
                self.registry,
                metrics_path(workdir, process_index, process_count),
                interval_s=metrics_interval_s,
            ).start()
        except BaseException:
            # exporter construction/first-write failing after the port
            # bound: release the server HERE (locality — the __init__
            # guard then only owns the event fd) and mark it released
            if self._server is not None:
                self._server.stop()
                self._server = None
            raise
        if self._publish_dir:
            from land_trendr_tpu_torch.obs.publish import TelemetryPublisher

            try:
                self._publisher = TelemetryPublisher(
                    self._publish_dir,
                    self.registry,
                    probes=self._publish_probes,
                    interval_s=self._publish_interval_s,
                    kind="run",
                ).start()
            except BaseException:
                # publisher construction failing (unwritable telemetry
                # dir) after the exporter/server exist: release them
                # HERE (locality, like the exporter guard) so __init__'s
                # guard only owns the event fd; telescoped so an
                # exporter-stop failure cannot skip the server release
                try:
                    self._exporter.stop()
                finally:
                    if self._server is not None:
                        self._server.stop()
                        self._server = None
                raise

    # -- paths the run summary reports -------------------------------------
    @property
    def events_file(self) -> str:
        return self.events.path

    @property
    def metrics_file(self) -> str:
        return self._exporter.path

    @property
    def metrics_port(self) -> int | None:
        return self._server.port if self._server is not None else None

    @property
    def publish_file(self) -> str | None:
        """The fleet snapshot this process refreshes (None = publish off)."""
        return self._publisher.path if self._publisher is not None else None

    # -- driver hooks ------------------------------------------------------
    def run_start(self, **fields: Any) -> dict:
        """Open the run scope; returns the emitted record — the caller
        reads the stamped ``run_id`` / clock-anchor pair back (the
        driver mirrors them into the manifest for pod-trace assembly)."""
        return self.events.run_start(**fields)

    def tile_start(self, tile_id: int, attempt: int = 1) -> None:
        self.events.emit("tile_start", tile_id=tile_id, attempt=attempt)

    def tile_done(
        self,
        tile_id: int,
        px: int,
        compute_s: float,
        feed_backlog: int,
        write_backlog: int,
        device_bytes_in_use: int | None = None,
        fetch_backlog: int | None = None,
    ) -> None:
        pxs = px / compute_s if compute_s > 0 else 0.0
        fields: dict[str, Any] = {}
        if device_bytes_in_use is not None:
            self._dev_bytes.set(device_bytes_in_use)
            self._dev_peak.set_max(device_bytes_in_use)
            fields["device_bytes_in_use"] = device_bytes_in_use
        if fetch_backlog is not None:
            self._fetch_backlog.set(fetch_backlog)
            fields["fetch_backlog"] = fetch_backlog
        self.events.emit(
            "tile_done",
            tile_id=tile_id,
            px=px,
            compute_s=round(compute_s, 6),
            px_per_s=round(pxs, 1),
            feed_backlog=feed_backlog,
            write_backlog=write_backlog,
            **fields,
        )
        self._tiles_done.inc()
        self._pixels.inc(px)
        self._compute_hist.observe(compute_s)
        self._pxs_hist.observe(pxs)
        self._pxs_gauge.set(pxs)
        self._feed_backlog.set(feed_backlog)
        self._write_backlog.set(write_backlog)

    def tile_retry(self, tile_id: int, attempt: int, error: BaseException | str) -> None:
        self.events.emit(
            "tile_retry", tile_id=tile_id, attempt=attempt, error=str(error)
        )
        self._tile_retries.inc()

    def tile_failed(self, tile_id: int, attempts: int, error: BaseException | str) -> None:
        self.events.emit(
            "tile_failed", tile_id=tile_id, attempts=attempts, error=str(error)
        )
        self._tiles_failed.inc()

    def tile_quarantined(
        self, tile_id: int, attempts: int, error: BaseException | str
    ) -> None:
        """The tile exhausted its retries under quarantine mode: the run
        goes on without it (resume re-attempts it)."""
        self.events.emit(
            "tile_quarantined",
            tile_id=tile_id,
            attempts=attempts,
            error=str(error),
        )
        self._quarantined.inc()

    def span(
        self,
        name: str,
        tile_id: int,
        start: float,
        end: float,
        attempt: "int | None" = None,
    ) -> None:
        """One per-tile stage span (``start``/``end`` on the monotonic
        clock — the same clock as ``t_mono``, so consumers anchor them
        through the scope's ``run_start`` anchor pair).  Emitted at span
        END from the driver thread, so spans always precede their
        scope's ``run_done``.  Events only — span volume would swamp a
        counter registry; the per-stage instruments stay the run-scoped
        ``lt_stage_seconds`` gauges."""
        self.events.emit(
            "span",
            name=name,
            tile_id=tile_id,
            start=round(start, 6),
            end=round(end, 6),
            **({"attempt": attempt} if attempt is not None else {}),
        )

    def tile_straggler(
        self,
        tile_id: int,
        duration_s: float,
        threshold_s: float,
        median_s: float,
        in_flight: bool = False,
        attempt: "int | None" = None,
    ) -> None:
        """This tile's in-flight duration exceeded the straggler
        threshold (``k x`` rolling median — obs/spans).  May fire from
        the flight-sampler thread (``in_flight=True``) while the driver
        is blocked inside the straggler's own wait."""
        self.events.emit(
            "tile_straggler",
            tile_id=tile_id,
            duration_s=round(duration_s, 6),
            threshold_s=round(threshold_s, 6),
            median_s=round(median_s, 6),
            in_flight=in_flight,
            **({"attempt": attempt} if attempt is not None else {}),
        )
        self._stragglers.inc()

    def tile_leased(
        self, tile_id: int, gen: int, owner: "str | None" = None
    ) -> None:
        """This process claimed a never-leased (or released) tile from
        the shared-manifest lease queue (runtime/leases)."""
        self.events.emit(
            "tile_leased",
            tile_id=tile_id,
            gen=gen,
            **({"owner": owner} if owner is not None else {}),
        )
        self._lease_acquired.inc()

    def lease_stolen(
        self,
        tile_id: int,
        gen: int,
        owner: "str | None" = None,
        from_owner: "str | None" = None,
    ) -> None:
        """This process stole a tile whose lease expired (dead or wedged
        peer); ``gen`` is the successor generation the steal claimed."""
        self.events.emit(
            "lease_stolen",
            tile_id=tile_id,
            gen=gen,
            **({"owner": owner} if owner is not None else {}),
            **({"from_owner": from_owner} if from_owner is not None else {}),
        )
        self._lease_acquired.inc()
        self._lease_stolen.inc()

    def tile_speculated(
        self,
        tile_id: int,
        gen: int,
        owner: "str | None" = None,
        from_owner: "str | None" = None,
    ) -> None:
        """This process speculatively re-leased a straggler-flagged tile
        still in flight on its owner (first durable write wins)."""
        self.events.emit(
            "tile_speculated",
            tile_id=tile_id,
            gen=gen,
            **({"owner": owner} if owner is not None else {}),
            **({"from_owner": from_owner} if from_owner is not None else {}),
        )
        self._lease_acquired.inc()
        self._spec_tiles.inc()

    def lease_summary(self, stats: Mapping[str, Any]) -> None:
        """Fold one run's terminal lease-queue counters into the metrics
        registry (``stats`` is :meth:`runtime.leases.LeaseQueue.stats`).
        Metrics only — the per-acquisition events above already carry
        the stream's story, and ``run_done`` carries the rollup fields."""
        self._lease_renewals.inc(int(stats.get("renewals", 0)))
        self._spec_wins.inc(int(stats.get("spec_wins", 0)))

    def fault_injected(self, seam: str, index: int, error: str) -> None:
        """One scheduled fault fired (the runtime.faults observer hook)."""
        self.events.emit("fault_injected", seam=seam, index=index, error=error)
        self._faults.inc()

    def stall(self, idle_s: float, timeout_s: float) -> None:
        """The stall watchdog is aborting: no tile progress for idle_s.
        Emitted from the watchdog thread, BEFORE the abort unwinds —
        a hung run's stream must say why it died even if the unwind
        itself never completes."""
        self.events.emit(
            "stall", idle_s=round(idle_s, 3), timeout_s=timeout_s
        )
        self._stalls.inc()

    def fetch_demoted(self, failures: int) -> None:
        """Packed fetch demoted to the per-product sync path for the rest
        of the run after repeated fetch failures."""
        self.events.emit("fetch_demoted", failures=failures)
        self._demoted.set(1)

    def write_done(
        self, tile_id: int, nbytes: int, record_s: float, meta: Mapping[str, Any]
    ) -> None:
        """Called by ``TileManifest.record`` once a tile is durable."""
        fields: dict[str, Any] = {}
        # only no_fit_rate rides along from the manifest meta: its
        # px_per_s is computed over PADDED tile pixels, which would
        # contradict tile_done's real-pixel px_per_s for the same tile —
        # tile_done is the one throughput source of truth in the stream
        if "no_fit_rate" in meta:
            fields["no_fit_rate"] = meta["no_fit_rate"]
        self.events.emit(
            "write_done",
            tile_id=tile_id,
            bytes=nbytes,
            record_s=round(record_s, 6),
            **fields,
        )
        self._bytes_written.inc(nbytes)
        self._record_hist.observe(record_s)
        if "no_fit_rate" in meta:
            self._no_fit.set(float(meta["no_fit_rate"]))

    def feed_cache(self, stats: Mapping[str, Any]) -> None:
        """Fold one run's feed-decode subsystem counters into the stream.

        ``stats`` is a :func:`land_trendr_tpu_torch.io.blockcache.stats_delta`
        dict (run-scoped counter deltas + cache occupancy gauges); the
        driver calls this once, right before ``run_done``.  Emits the
        ``feed_cache`` event and advances the ``lt_feed_*`` instruments.
        """
        fields = {
            k: stats[k]
            for k in (
                "hits", "misses", "evictions", "decode_s", "inserted_bytes",
                "readahead_blocks", "readahead_hits", "readahead_dropped",
                "cache_bytes", "budget_bytes", "corrupt_dropped",
            )
            if k in stats
        }
        fields["decode_s"] = round(float(fields.get("decode_s", 0.0)), 6)
        for req in ("hits", "misses", "evictions"):
            fields.setdefault(req, 0)
        self.events.emit("feed_cache", **fields)
        self._fc_hits.inc(fields["hits"])
        self._fc_misses.inc(fields["misses"])
        self._fc_evictions.inc(fields["evictions"])
        self._fc_decode_s.inc(fields["decode_s"])
        self._fc_ra_blocks.inc(fields.get("readahead_blocks", 0))
        self._fc_ra_hits.inc(fields.get("readahead_hits", 0))
        self._fc_corrupt.inc(fields.get("corrupt_dropped", 0))
        if "cache_bytes" in fields:
            self._fc_bytes.set(fields["cache_bytes"])

    def fetch(self, stats: Mapping[str, Any]) -> None:
        """Fold one run's device→host fetch counters into the stream.

        ``stats`` is a :meth:`land_trendr_tpu_torch.runtime.fetch.TileFetcher.
        summary` dict; the driver calls this once, right before
        ``run_done`` (success and abort paths alike).  Emits the
        ``fetch`` event and advances the ``lt_fetch_*`` instruments.
        """
        fields: dict[str, Any] = {
            "tiles": int(stats.get("tiles", 0)),
            "transfers": int(stats.get("transfers", 0)),
            "bytes": int(stats.get("bytes", 0)),
            "pack_s": round(float(stats.get("pack_s", 0.0)), 6),
            "wait_s": round(float(stats.get("wait_s", 0.0)), 6),
            "unpack_s": round(float(stats.get("unpack_s", 0.0)), 6),
        }
        if "backlog_max" in stats:
            fields["backlog_max"] = int(stats["backlog_max"])
        if "packed" in stats:
            fields["packed"] = bool(stats["packed"])
        if "demoted" in stats:
            fields["demoted"] = bool(stats["demoted"])
        self.events.emit("fetch", **fields)
        self._fx_tiles.inc(fields["tiles"])
        self._fx_transfers.inc(fields["transfers"])
        self._fx_bytes.inc(fields["bytes"])
        self._fx_pack_s.inc(fields["pack_s"])
        self._fx_wait_s.inc(fields["wait_s"])
        self._fx_unpack_s.inc(fields["unpack_s"])
        if "backlog_max" in fields:
            self._fx_backlog.set_max(fields["backlog_max"])

    def upload_demoted(self, failures: int) -> None:
        """Packed upload demoted to the per-array sync dispatch for the
        rest of the run after repeated upload failures."""
        self.events.emit("upload_demoted", failures=failures)
        self._up_demoted.set(1)

    def upload(self, stats: Mapping[str, Any]) -> None:
        """Fold one run's host→device upload counters into the stream.

        ``stats`` is a :meth:`land_trendr_tpu_torch.runtime.feed.TileUploader.
        summary` dict; the driver calls this once, right before
        ``run_done`` (success and abort paths alike).  Emits the
        ``upload`` event and advances the ``lt_upload_*`` instruments.
        """
        fields: dict[str, Any] = {
            "tiles": int(stats.get("tiles", 0)),
            "transfers": int(stats.get("transfers", 0)),
            "bytes": int(stats.get("bytes", 0)),
            "pack_s": round(float(stats.get("pack_s", 0.0)), 6),
            "wait_s": round(float(stats.get("wait_s", 0.0)), 6),
            "unpack_s": round(float(stats.get("unpack_s", 0.0)), 6),
        }
        if "backlog_max" in stats:
            fields["backlog_max"] = int(stats["backlog_max"])
        if "packed" in stats:
            fields["packed"] = bool(stats["packed"])
        if "demoted" in stats:
            fields["demoted"] = bool(stats["demoted"])
        self.events.emit("upload", **fields)
        self._up_tiles.inc(fields["tiles"])
        self._up_transfers.inc(fields["transfers"])
        self._up_bytes.inc(fields["bytes"])
        self._up_pack_s.inc(fields["pack_s"])
        self._up_wait_s.inc(fields["wait_s"])
        self._up_unpack_s.inc(fields["unpack_s"])
        if "backlog_max" in fields:
            self._up_backlog.set_max(fields["backlog_max"])

    def ingest_store(self, stats: Mapping[str, Any]) -> None:
        """Fold one run's persistent ingest-store counters into the stream.

        ``stats`` is a :meth:`land_trendr_tpu_torch.io.blockstore.BlockStore.
        stats_delta` dict; the driver calls this once per store-enabled
        run, right before ``run_done``.  Emits the ``ingest_store``
        event and advances the ``lt_ingest_*`` instruments.
        """
        fields: dict[str, Any] = {
            "hits": int(stats.get("hits", 0)),
            "misses": int(stats.get("misses", 0)),
            "put_blocks": int(stats.get("put_blocks", 0)),
            "put_bytes": int(stats.get("put_bytes", 0)),
        }
        for opt in (
            "stale_dropped", "corrupt_dropped", "evicted_segments",
            "bytes", "budget_bytes", "segments",
        ):
            if opt in stats:
                fields[opt] = int(stats[opt])
        self.events.emit("ingest_store", **fields)
        self._is_hits.inc(fields["hits"])
        self._is_misses.inc(fields["misses"])
        self._is_put_blocks.inc(fields["put_blocks"])
        self._is_put_bytes.inc(fields["put_bytes"])
        self._is_stale.inc(fields.get("stale_dropped", 0))
        self._is_corrupt.inc(fields.get("corrupt_dropped", 0))
        if "bytes" in fields:
            self._is_bytes.set(fields["bytes"])

    def tune_probe(
        self,
        group: str,
        ok: bool,
        probes: int,
        wall_s: float,
        speedup: "float | None" = None,
        error: "str | None" = None,
        knobs: "dict | None" = None,
    ) -> None:
        """One autotuner knob-group probe verdict (tune/autotune).

        ``ok=False`` means the group's probe failed — the tune.probe
        fault seam or a real error — and its knobs fell back to
        defaults; the tuner and any run behind it live on.
        """
        self.events.emit(
            "tune_probe",
            group=group,
            ok=bool(ok),
            probes=int(probes),
            wall_s=round(float(wall_s), 6),
            **({"speedup": round(float(speedup), 3)} if speedup is not None else {}),
            **({"error": error} if error is not None else {}),
            **({"knobs": dict(knobs)} if knobs is not None else {}),
        )
        self._tn_probes.inc(int(probes))
        if not ok:
            self._tn_failures.inc()

    def tune_profile(
        self,
        key: str,
        source: str,
        probes: int,
        age_s: "float | None" = None,
        knobs: "dict | None" = None,
        groups: "int | None" = None,
    ) -> None:
        """One tuning-profile verdict: reloaded from the store (zero
        probes), freshly probed, or hardcoded defaults (no profile).
        Emitted by ``lt tune`` and by every Run whose config resolved
        ``"auto"`` knobs."""
        self.events.emit(
            "tune_profile",
            key=key,
            source=source,
            probes=int(probes),
            **({"age_s": round(float(age_s), 3)} if age_s is not None else {}),
            **({"knobs": dict(knobs)} if knobs is not None else {}),
            **({"groups": int(groups)} if groups is not None else {}),
        )
        if source == "store":
            self._tn_store_hits.inc()
        else:
            self._tn_store_misses.inc()
        if age_s is not None:
            self._tn_age.set(float(age_s))

    def program_cache(self, stats: Mapping[str, Any]) -> None:
        """Fold one run's warm-program-cache verdict into the stream.

        ``stats`` is the driver's per-run accounting over the serve
        layer's :class:`~land_trendr_tpu_torch.serve.programs.ProgramCache`
        (one hit or one miss per run scope, plus the compile seconds a
        miss paid); emitted right before ``run_done`` like the other
        subsystem rollups.  The ``lt_serve_*`` warm-ratio instruments
        live in the SERVER's registry, not here — a single run only
        knows its own verdict.
        """
        self.events.emit(
            "program_cache",
            hits=int(stats.get("hits", 0)),
            misses=int(stats.get("misses", 0)),
            compile_s=round(float(stats.get("compile_s", 0.0)), 6),
            **({"keys": int(stats["keys"])} if "keys" in stats else {}),
        )

    def run_done(
        self,
        status: str,
        tiles_done: int,
        pixels: int,
        wall_s: float,
        px_per_s: float,
        fit_rate: float,
        stage_s: Mapping[str, float] | None = None,
        tiles_quarantined: int | None = None,
        tiles_stolen: int | None = None,
        tiles_speculated: int | None = None,
    ) -> None:
        self.events.emit(
            "run_done",
            status=status,
            tiles_done=tiles_done,
            pixels=pixels,
            wall_s=wall_s,
            px_per_s=px_per_s,
            fit_rate=fit_rate,
            **({"stage_s": dict(stage_s)} if stage_s else {}),
            **(
                {"tiles_quarantined": tiles_quarantined}
                if tiles_quarantined
                else {}
            ),
            # lease runs only (None = static split; 0 is a real value on
            # an elastic run that stole/speculated nothing)
            **(
                {"tiles_stolen": tiles_stolen}
                if tiles_stolen is not None
                else {}
            ),
            **(
                {"tiles_speculated": tiles_speculated}
                if tiles_speculated is not None
                else {}
            ),
        )
        for name, secs in (stage_s or {}).items():
            # "feed_s" -> stage="feed"; totals only meaningful at run end
            self.registry.gauge(
                "lt_stage_seconds",
                "accumulated host seconds per driver stage",
                labels={"stage": name.removesuffix("_s")},
            ).set(secs)

    def load_phase(
        self,
        phase: str,
        mode: str,
        offered_qps: "float | None" = None,
        requests: "int | None" = None,
        workers: "int | None" = None,
        duration_s: "float | None" = None,
        seed: "int | None" = None,
    ) -> None:
        """One load-rig phase boundary (``start``/``done``/a schedule
        segment).  ``offered_qps`` only exists for open-loop phases — a
        closed loop has no offered rate, its arrival rate IS the
        completion rate."""
        self.events.emit(
            "load_phase",
            phase=phase,
            mode=mode,
            **(
                {"offered_qps": round(float(offered_qps), 6)}
                if offered_qps is not None
                else {}
            ),
            **({"requests": int(requests)} if requests is not None else {}),
            **({"workers": int(workers)} if workers is not None else {}),
            **(
                {"duration_s": round(float(duration_s), 6)}
                if duration_s is not None
                else {}
            ),
            **({"seed": int(seed)} if seed is not None else {}),
        )

    def sweep_point(
        self,
        replicas: int,
        offered_qps: float,
        achieved_qps: float,
        p50_s: float,
        p99_s: float,
        goodput_qps: float,
        done: int,
        failed: int,
        rejected: int,
        knee: "bool | None" = None,
        knee_blame: "str | None" = None,
        window_s: "float | None" = None,
        assembled: "int | None" = None,
    ) -> None:
        """One point of a capacity scaling curve: a (replica count,
        offered rate) cell measured by the load rig and assembled
        through the request-trace store.  ``knee``/``knee_blame`` are
        stamped by the analyzer on the point where the latency curve
        bends, naming the dominant blame component there."""
        self.events.emit(
            "sweep_point",
            replicas=int(replicas),
            offered_qps=round(float(offered_qps), 6),
            achieved_qps=round(float(achieved_qps), 6),
            p50_s=round(float(p50_s), 6),
            p99_s=round(float(p99_s), 6),
            goodput_qps=round(float(goodput_qps), 6),
            done=int(done),
            failed=int(failed),
            rejected=int(rejected),
            **({"knee": bool(knee)} if knee is not None else {}),
            **({"knee_blame": knee_blame} if knee_blame is not None else {}),
            **(
                {"window_s": round(float(window_s), 6)}
                if window_s is not None
                else {}
            ),
            **({"assembled": int(assembled)} if assembled is not None else {}),
        )

    def sim_replay(
        self,
        decisions: int,
        matched: int,
        match: bool,
        speedup_x: float,
        recorded_span_s: "float | None" = None,
        replay_wall_s: "float | None" = None,
        mismatch_seq: "int | None" = None,
    ) -> None:
        """One offline-replay verdict: a recorded dispatcher/autoscaler
        decision log re-driven through the same pure functions.
        ``match`` means every recorded decision was reproduced
        byte-identically; ``mismatch_seq`` pins the first divergence."""
        self.events.emit(
            "sim_replay",
            decisions=int(decisions),
            matched=int(matched),
            match=bool(match),
            speedup_x=round(float(speedup_x), 3),
            **(
                {"recorded_span_s": round(float(recorded_span_s), 6)}
                if recorded_span_s is not None
                else {}
            ),
            **(
                {"replay_wall_s": round(float(replay_wall_s), 6)}
                if replay_wall_s is not None
                else {}
            ),
            **(
                {"mismatch_seq": int(mismatch_seq)}
                if mismatch_seq is not None
                else {}
            ),
        )

    def close(self) -> None:
        """Flush the final exposition, stop the exporters, close the log.

        Idempotent and exception-tolerant in the ways that matter on the
        driver's abort path: the event log closes even when the final
        metrics flush raises.
        """
        try:
            # the publisher stops FIRST (its final snapshot reads the
            # registry, which outlives it; a publisher-stop failure must
            # not skip the exporter/server/event-fd releases below)
            if self._publisher is not None:
                self._publisher.stop()
                self._publisher = None
        finally:
            try:
                if self._server is not None:
                    self._server.stop()
                    self._server = None
            finally:
                try:
                    self._exporter.stop()
                finally:
                    self.events.close()
