"""Fleet telemetry publish: periodic per-process snapshots on a shared FS.

A pod of N hosts (or a fleet of N serve replicas) has N event streams, N
``metrics.prom`` files and N loopback ``/debug`` surfaces — useful per
process, useless as a single pane of glass.  This module is the
**publish** quarter of the fleet telemetry plane (publish → aggregate →
history → alerts): every participating process periodically snapshots
its whole observable state — the Prometheus registry, the live
``Run.progress`` / serve stats the host contributes via ``probes``, and
its identity — into ONE atomic JSON file under a shared telemetry
directory::

    <workdir>/telemetry/<host>.<pid>.snap.json

Design rules (the aggregate side depends on every one of them):

* **Atomic tmp + rename** per snapshot (the manifest/blockstore
  first-write-wins discipline): a reader never sees a torn file from a
  healthy publisher; a torn file therefore MEANS a fault (kill mid-write,
  injected) and the aggregator flags it corrupt instead of crashing.
* **Per-process files, zero coordination**: the filename is the
  ``(host, pid)`` identity, so publishers never contend; a restarted
  process overwrites its predecessor's file, and the snapshot's
  ``generation`` (publisher start, ns) lets the aggregator supersede a
  reused pid's stale snap instead of double-counting it.
* **Staleness is the failure signal**: a publisher that dies, wedges, or
  hits an injected ``obs.publish`` fault simply stops refreshing its
  file — the beat is skipped, never the run.  The snapshot carries its
  own ``interval_s`` so the aggregator can derive a per-host staleness
  bound without out-of-band config.
* **Never fail the run**: after the constructor (where an unwritable
  telemetry dir is a config error), no publish attempt ever raises out
  of :meth:`TelemetryPublisher.start`, the loop, or :meth:`stop` —
  failed beats are counted in :meth:`stats` and show up as staleness.

Like the rest of :mod:`land_trendr_tpu_torch.obs` this is stdlib-only and
jax-free; the fault seams reach the active plan through the same
registered-hook pattern as ``io.blockcache`` (``runtime/faults``
registers itself here via :func:`set_fault_plan`, so ``obs/`` never
imports ``runtime/``).
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Any, Callable

__all__ = [
    "SNAP_SCHEMA",
    "TelemetryPublisher",
    "fault_check",
    "set_fault_plan",
    "snap_path",
    "telemetry_dir",
]

#: bump when a REQUIRED snapshot field is added/renamed/retyped (the
#: aggregate layer validates it, like the event stream's SCHEMA_VERSION)
SNAP_SCHEMA = 1

# -- fault-seam hook (registered by runtime.faults.activate, like the
# -- io.blockcache hook — obs/ never imports runtime/) --------------------
_fault_plan: "Any | None" = None


def set_fault_plan(plan: "Any | None") -> None:
    """Install/clear the active fault plan for the ``obs.publish`` and
    ``history.append`` seams (called by ``runtime.faults.activate`` /
    ``deactivate``)."""
    global _fault_plan
    _fault_plan = plan


def fault_check(seam: str) -> None:
    """Raising seam against the registered plan (no-op when none is
    active) — shared by this module and :mod:`~land_trendr_tpu_torch.obs.
    history`."""
    plan = _fault_plan
    if plan is not None:
        plan.check(seam)


def telemetry_dir(workdir: str) -> str:
    """Canonical shared telemetry directory under a run/serve workdir."""
    return os.path.join(workdir, "telemetry")


def snap_path(directory: str, host: "str | None" = None, pid: "int | None" = None) -> str:
    """Canonical per-process snapshot path (``<host>.<pid>.snap.json``)."""
    return os.path.join(
        directory,
        f"{host or socket.gethostname()}.{pid or os.getpid()}.snap.json",
    )


class TelemetryPublisher:
    """Daemon thread refreshing one process's fleet snapshot.

    ``registry`` is the process's :class:`~land_trendr_tpu_torch.obs.metrics.
    MetricsRegistry` (dumped via :meth:`~land_trendr_tpu_torch.obs.metrics.
    MetricsRegistry.snapshot`); ``probes`` is an optional host callback
    returning the live JSON-safe state block (``Run.progress``, serve
    queue/SLO facts, active alerts) merged into each snapshot under
    ``"state"`` — a probe failure degrades the snapshot to metrics-only,
    never the run (the flight sampler's contract).

    Publishes once at :meth:`start` (a sub-interval run still leaves a
    snapshot), every ``interval_s`` in between, and once at
    :meth:`stop` (the terminal state is on disk for post-mortem folds).
    Each write goes to a per-``(pid, seq)`` tmp name then ``os.replace``
    — concurrent writers (a wedged loop thread racing the final stop()
    flush) cannot tear each other; last rename wins, which for a
    monotonically-refreshed snapshot is the right answer.
    """

    def __init__(
        self,
        directory: str,
        registry,
        *,
        probes: "Callable[[], dict] | None" = None,
        interval_s: float = 5.0,
        kind: str = "run",
        host: "str | None" = None,
    ) -> None:
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s} must be > 0")
        # an unwritable telemetry dir is a CONFIG error surfaced now;
        # everything past construction is best-effort by contract
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.registry = registry
        self.kind = kind
        self.host = host or socket.gethostname()
        self.pid = os.getpid()
        #: supersedes a reused pid: the aggregator keeps the highest
        #: generation per (host, pid), so a restarted process's counters
        #: are never summed with its dead predecessor's
        self.generation = time.time_ns()
        self.path = snap_path(directory, self.host, self.pid)
        self.interval_s = float(interval_s)
        self._probes = probes
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None
        self._lock = threading.Lock()
        self._seq = 0
        self._published = 0
        self._failed = 0
        self._t0 = time.time()

    # -- snapshot assembly -------------------------------------------------
    def snapshot_fields(self) -> dict:
        """One snapshot's payload (probe failures degrade, never raise)."""
        state: dict = {}
        if self._probes is not None:
            try:
                probed = self._probes()
                if isinstance(probed, dict):
                    state = probed
            except Exception:
                pass  # a sick probe degrades the snapshot, not the run
        now = time.time()
        with self._lock:
            self._seq += 1
            seq = self._seq
        return {
            "schema": SNAP_SCHEMA,
            "kind": self.kind,
            "host": self.host,
            "pid": self.pid,
            "generation": self.generation,
            "seq": seq,
            "t_wall": now,
            "uptime_s": round(now - self._t0, 3),
            "interval_s": self.interval_s,
            "metrics": self.registry.snapshot(),
            "state": state,
        }

    def publish_now(self) -> dict:
        """Write one snapshot NOW (atomic tmp + rename); returns the
        record written.  Raises on I/O failure or an armed
        ``obs.publish`` fault — loop/stop callers swallow (a skipped
        beat is staleness, the aggregate-side contract), while tests
        and the perf gate call this directly."""
        fault_check("obs.publish")
        rec = self.snapshot_fields()
        data = json.dumps(rec, separators=(",", ":"), default=str)
        # per-(pid, seq) tmp name: the loop thread and a final stop()
        # flush can never share (and tear) one tmp file — no lock spans
        # the write, the rename race resolves last-writer-wins
        tmp = f"{self.path}.{self.pid}.{rec['seq']}.tmp"
        try:
            with open(tmp, "w") as f:
                f.write(data)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        with self._lock:
            self._published += 1
        return rec

    def _publish_best_effort(self) -> None:
        try:
            self.publish_now()
        except Exception:
            # injected obs.publish fault, transient FS pressure, full
            # disk: the beat is skipped and the host ages toward stale —
            # the publisher must never take down the run it describes
            with self._lock:
                self._failed += 1

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "TelemetryPublisher":
        self._publish_best_effort()
        self._thread = threading.Thread(
            target=self._loop, name="lt-fleet-publisher", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._publish_best_effort()

    def stop(self) -> None:
        """Stop the loop and flush the terminal snapshot (best-effort —
        the final state matters most on the abort path, where a publish
        error must not mask the propagating failure)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self._publish_best_effort()

    def stats(self) -> dict:
        with self._lock:
            return {
                "seq": self._seq,
                "published": self._published,
                "failed": self._failed,
                "path": self.path,
            }
