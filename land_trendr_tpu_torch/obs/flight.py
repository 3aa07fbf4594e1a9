"""Flight recorder: a bounded in-memory ring over the live event stream.

``events.jsonl`` answers "what happened" after the fact; ``metrics.prom``
answers "what is the counter now".  Neither answers the question an
operator asks a live, possibly-wedged gigapixel run: *what are you doing
right now, and how did the last 60 seconds look?*  This module is that
answer — the in-process half of the ``/debug`` surface:

* :class:`FlightRecorder` — a bounded ring that **mirrors every
  telemetry emit** (an :class:`~land_trendr_tpu_torch.obs.events.EventLog`
  ``mirror`` hook, so schema v1 stays the single vocabulary; nothing is
  re-modelled here) and is dumpable at any moment as a schema-valid
  ``events.jsonl`` slice: the latest ``run_start`` is kept sticky
  outside the ring, so a dump always opens a valid run scope even after
  the ring has evicted it.
* :class:`ResourceSampler` — a daemon thread emitting periodic
  ``flight_sample`` events (RSS, open fds, thread count, plus whatever
  gauges the host's ``probes`` callable contributes: queue depths,
  backlogs, cache/store occupancy, HBM watermark) through the normal
  event log, so the samples land in the stream, the ring, and the
  ``obs_report --trace`` counter tracks alike.
* :func:`thread_stacks` — all-thread tracebacks via
  ``sys._current_frames`` — the "is the dispatcher wedged behind a
  writer join?" question, servable over HTTP even while the main loop
  is stuck in a lock.

Lock discipline: the recorder's one lock guards only the ring deque and
two scalars — no I/O, no emit, no allocation beyond a list copy ever
happens under it, so mirroring an emit costs an append.  Everything
here is stdlib-only and jax-free, like the rest of :mod:`~land_trendr_tpu_torch.obs`.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import traceback
from typing import Any, Callable

__all__ = [
    "FlightRecorder",
    "ResourceSampler",
    "flight_path",
    "thread_stacks",
]


def flight_path(workdir: str, process_index: int = 0, process_count: int = 1) -> str:
    """Canonical flight-dump path under a run's workdir (mirrors the
    ``events_path`` per-process naming; never matched by
    ``discover_event_files``'s ``events*.jsonl`` globs, so a dump can
    live beside the stream without polluting workdir discovery)."""
    if process_count <= 1:
        return os.path.join(workdir, "flight.jsonl")
    return os.path.join(workdir, f"flight.p{process_index}.jsonl")


class FlightRecorder:
    """Bounded ring of the most recent telemetry events.

    Wire it as the :class:`~land_trendr_tpu_torch.obs.events.EventLog`
    ``mirror`` hook: every emitted record (timestamps and common fields
    already stamped) lands here too.  The ring holds the last
    ``capacity`` records; the latest ``run_start`` is additionally kept
    sticky so :meth:`dump` always produces a stream that opens with a
    run scope — the property that makes a dump pass
    ``tools/check_events_schema.py`` unmodified.
    """

    def __init__(self, capacity: int = 2048) -> None:
        if capacity < 2:
            raise ValueError(
                f"capacity={capacity} must be >= 2 (a useful ring holds at "
                "least a run_start and one event)"
            )
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=self.capacity)
        self._run_start: "dict | None" = None
        self._total = 0

    # -- the mirror hook ---------------------------------------------------
    def record(self, rec: dict) -> None:
        """Append one emitted record (called from EventLog.emit — must
        stay cheap and must never raise into the emit path)."""
        with self._lock:
            if rec.get("ev") == "run_start":
                self._run_start = rec
            self._ring.append(rec)
            self._total += 1

    # -- introspection -----------------------------------------------------
    def snapshot(self, n: "int | None" = None) -> list:
        """The most recent ``n`` records (all, when ``n`` is None) —
        oldest first, a point-in-time copy."""
        with self._lock:
            recs = list(self._ring)
        if n is not None and n > 0:
            recs = recs[-n:]
        return recs

    def stats(self) -> dict:
        with self._lock:
            held = len(self._ring)
            return {
                "capacity": self.capacity,
                "events": held,
                "recorded_total": self._total,
                "dropped": max(0, self._total - held),
            }

    # -- dumping -----------------------------------------------------------
    def dump_records(self) -> list:
        """The ring as a schema-valid event slice.

        When a ``run_start`` is still IN the ring, the slice is trimmed
        to open at the first one — the records ahead of it are the torn
        tail of an already-evicted scope, and prepending the sticky
        (latest) ``run_start`` above them would both duplicate it and
        re-anchor that tail under the wrong scope's clocks.  Only when
        eviction has pushed every ``run_start`` out (the ring then holds
        a single scope's tail by construction — scopes open WITH their
        ``run_start``) is the sticky copy prepended, restoring the
        correct scope header for exactly those events.
        """
        with self._lock:
            recs = list(self._ring)
            rs = self._run_start
        for i, rec in enumerate(recs):
            if isinstance(rec, dict) and rec.get("ev") == "run_start":
                return recs[i:]
        if rs is not None:
            return [rs, *recs]
        return recs

    def dump(self, path: str) -> int:
        """Write the current slice as JSONL (atomic tmp + rename — a
        dump taken mid-crash must never be a torn file); returns the
        number of records written."""
        recs = self.dump_records()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec, separators=(",", ":"), default=str) + "\n")
        os.replace(tmp, path)
        return len(recs)


def _rss_bytes() -> int:
    """Resident set size, bytes (``/proc/self/statm``; ``getrusage``
    peak-RSS fallback off Linux; 0 when neither exists — the schema
    wants a non-negative int, not a missing field)."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    try:
        import resource

        peak = int(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
        # ru_maxrss is kilobytes on Linux/BSD but BYTES on Darwin
        return peak if sys.platform == "darwin" else peak * 1024
    except Exception:
        return 0


def _open_fds() -> int:
    """Open file-descriptor count (``/proc/self/fd``; 0 where /proc is
    absent)."""
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:
        return 0


class ResourceSampler:
    """Daemon thread emitting periodic ``flight_sample`` events.

    ``emit`` is the event log's emit callable (``telemetry.events.emit``),
    so samples ride the normal pipeline: stamped timestamps, common
    fields, the file, AND the mirror ring.  ``probes`` is an optional
    host callback returning extra schema-optional gauges (queue depths,
    backlogs, cache occupancy, HBM watermark) merged into each sample; a
    probe failure degrades to the base sample — the sampler must never
    take down the run it watches, and neither may a sample emitted into
    a log that is closing under it (the stop() race on the abort path).
    """

    def __init__(
        self,
        emit: Callable[..., Any],
        interval_s: float = 5.0,
        probes: "Callable[[], dict] | None" = None,
    ) -> None:
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s} must be > 0")
        self._emit = emit
        self.interval_s = float(interval_s)
        self._probes = probes
        self._stop = threading.Event()
        self._thread: "threading.Thread | None" = None

    def sample_fields(self) -> dict:
        """One sample's payload (probe gauges merged; never raises)."""
        fields: dict = {
            "rss_bytes": _rss_bytes(),
            "open_fds": _open_fds(),
            "threads": threading.active_count(),
        }
        if self._probes is not None:
            try:
                for k, v in self._probes().items():
                    if v is not None:
                        fields[k] = v
            except Exception:
                pass  # a sick probe degrades the sample, not the run
        return fields

    def sample(self) -> dict:
        """Emit one ``flight_sample`` NOW (also used by tests); returns
        the emitted fields."""
        fields = self.sample_fields()
        self._emit("flight_sample", **fields)
        return fields

    def start(self) -> "ResourceSampler":
        self._thread = threading.Thread(
            target=self._loop, name="lt-flight-sampler", daemon=True
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        # first sample right away: a short run still carries one
        while True:
            try:
                self.sample()
            except Exception:
                # emit into a log closing under us (abort-path stop race)
                # or transient /proc weirdness: skip the beat, keep going
                pass
            if self._stop.wait(self.interval_s):
                return

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None


def thread_stacks() -> dict:
    """Every live thread's current traceback, newest frame last.

    Keyed ``"<name> (<ident>[, daemon])"``; frames are
    ``traceback.format_stack`` strings.  Built from
    ``sys._current_frames`` so it works from ANY thread — including an
    HTTP handler answering ``/debug/stacks`` while the dispatcher is
    wedged in a lock or a native call (the exact situation it exists
    for).  Pure read: no locks taken, no threads interrupted.
    """
    names = {t.ident: t for t in threading.enumerate()}
    out: dict = {}
    for ident, frame in sys._current_frames().items():
        t = names.get(ident)
        label = f"{t.name if t else '?'} ({ident}"
        if t is not None and t.daemon:
            label += ", daemon"
        label += ")"
        out[label] = [
            line.rstrip("\n") for line in traceback.format_stack(frame)
        ]
    return out
