"""Tracing and profiling harness.

Counterpart of ``land_trendr_tpu/utils/profiling.py``:

* :func:`trace` captures a ``torch.profiler`` trace (CPU activity, plus
  CUDA activity where a card is present) and exports it as a Chrome trace
  JSON under ``logdir`` — open it in Perfetto or ``chrome://tracing``.
  CUDA activity comes from CUPTI, which sees every kernel the process
  launches, the ctypes-launched ``segment_fused_kernel`` included;
* :func:`profile_op` is the one-call version: warm up, then trace N
  steady-state iterations;
* :func:`capture_profile` holds a trace open for a duration over a live
  process, one capture at a time;
* :func:`span` marks a host range where the JAX package has a
  ``jax.named_scope`` stage scope.  With no profiler session recording
  it only reads the profiler's flag; under one it is a
  ``record_function`` range (a user annotation in :func:`trace`'s output,
  on the device kernels' clock), and a span given a device also appends
  one :class:`SpanRecord` to :data:`SPAN_LOG`, with a CUDA event pair on
  a card.  The tile program opens one per stage (``lt_tile_prep``,
  ``lt_tile_segment``, ``lt_tile_ftv``, ``lt_tile_change``), the fetch
  one around its pack (``lt_fetch_pack``), :class:`StageTimer` one per
  host stage (``lt_feed`` … ``lt_write``) and the kernel wrappers one
  around each launch (``lt_segment_fused``, ``lt_family_stats``);
* :class:`StageTimer` is the host-side complement for driver-loop phases.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Any, Callable, Iterator, NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = [
    "trace",
    "profile_op",
    "capture_profile",
    "span",
    "SpanLog",
    "SpanRecord",
    "SPAN_LOG",
    "StageTimer",
]


class SpanRecord(NamedTuple):
    """One span logged while a profiler session recorded: host
    ``perf_counter`` seconds at entry and exit, and on a card the CUDA
    events recorded on the device's current stream there."""

    name: str
    t_enter: float
    t_exit: float
    events: "tuple[torch.cuda.Event, torch.cuda.Event] | None" = None

    @property
    def host_ms(self) -> float:
        return 1e3 * (self.t_exit - self.t_enter)

    def device_ms(self) -> "float | None":
        """Milliseconds on the stream from the entry event to the exit
        event (waits for the exit event); None off a card."""
        if self.events is None:
            return None
        start, end = self.events
        end.synchronize()
        return start.elapsed_time(end)


class SpanLog:
    """Bounded log of :class:`SpanRecord`, oldest dropped first.  The
    events of a dropped record go back to a per-device pool, so a long
    traced run creates at most ``2 * size`` events a device."""

    def __init__(self, size: int) -> None:
        self.size = size
        self._records: collections.deque = collections.deque()
        self._pool: dict[int, list] = collections.defaultdict(list)
        self._lock = threading.Lock()

    def event(self, device_index: int) -> torch.cuda.Event:
        """A timing event for ``device_index`` from the pool, or a new one."""
        with self._lock:
            pool = self._pool[device_index]
            if pool:
                return pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def _recycle(self, rec: SpanRecord, device_index: int) -> None:
        if rec.events is not None:
            self._pool[device_index].extend(rec.events)

    def append(self, rec: SpanRecord, device_index: int = -1) -> None:
        with self._lock:
            if len(self._records) >= self.size:
                self._recycle(*self._records.popleft())
            self._records.append((rec, device_index))

    def records(self) -> list[SpanRecord]:
        """The logged records, oldest first (a copy; a record's events
        stay valid until the record is dropped or the log cleared)."""
        with self._lock:
            return [rec for rec, _ in self._records]

    def clear(self) -> None:
        with self._lock:
            while self._records:
                self._recycle(*self._records.popleft())


#: the process's span log (65,536 records)
SPAN_LOG = SpanLog(1 << 16)


class _Span:
    """A recording span: a ``record_function`` range, plus a log record
    (and an event pair on the device's current stream, on a card) where a
    device is given."""

    __slots__ = ("name", "logged", "_stream", "_range", "_t0", "_start")

    def __init__(self, name: str, device: "torch.device | None") -> None:
        self.name = name
        self.logged = device is not None
        self._stream = (
            torch.cuda.current_stream(device) if self.logged and device.type == "cuda" else None
        )

    def __enter__(self) -> None:
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        if self._stream is not None:
            self._start = SPAN_LOG.event(self._stream.device_index)
            self._start.record(self._stream)
        self._t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        try:
            if self.logged:
                t1 = time.perf_counter()
                events, index = None, -1
                if self._stream is not None:
                    index = self._stream.device_index
                    end = SPAN_LOG.event(index)
                    end.record(self._stream)
                    events = (self._start, end)
                SPAN_LOG.append(SpanRecord(self.name, self._t0, t1, events), index)
        finally:
            self._range.__exit__(*exc)


_IDLE = contextlib.nullcontext()


def span(name: str, device: "torch.device | None" = None):
    """A host range named ``name`` around the block, while a profiler
    session records (else nothing but the flag's read): a
    ``record_function`` range in the session's trace, and, where
    ``device`` is given, one :class:`SpanRecord` in :data:`SPAN_LOG`, with
    events on the device's current stream at entry and exit on a card.
    Ranges are per thread, so writer and feeder threads nest their own."""
    if not _autograd_profiler._is_profiler_enabled:
        return _IDLE
    return _Span(name, device)


def _activities() -> list:
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[str]:
    """Capture a host + device profiler trace under ``logdir``.

    The trace is written on exit as ``trace.<pid>.<n>.json`` (Chrome trace
    format) with one event per CPU op, CUDA runtime call, ``lt_*`` host
    range (:func:`span`) and device kernel; yields ``logdir``.
    """
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.__enter__()
    try:
        yield logdir
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        n = sum(1 for f in os.listdir(logdir) if f.startswith(f"trace.{os.getpid()}."))
        prof.export_chrome_trace(os.path.join(logdir, f"trace.{os.getpid()}.{n}.json"))


def _tree_bytes(logdir: str) -> int:
    return sum(
        os.path.getsize(os.path.join(root, f))
        for root, _, files in os.walk(logdir)
        for f in files
    )


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def profile_op(
    fn: Callable[..., Any],
    *args: Any,
    logdir: str,
    iters: int = 3,
    **kwargs: Any,
) -> dict[str, float]:
    """Warm up ``fn`` (one untraced call — builds and first launches stay
    out of the trace), then trace ``iters`` steady-state calls.

    Returns ``{"wall_s_per_iter": ..., "logdir_bytes": ...}``;
    ``logdir_bytes`` counts only bytes written by this trace.
    """
    fn(*args, **kwargs)
    _sync()
    before = _tree_bytes(logdir) if os.path.isdir(logdir) else 0
    with trace(logdir):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args, **kwargs)
        _sync()
        dt = time.perf_counter() - t0
    return {
        "wall_s_per_iter": dt / iters,
        "logdir_bytes": float(_tree_bytes(logdir) - before),
    }


# one capture at a time: the profiler session is process-global — a
# second concurrent start raises deep inside it.  The flag flips under a
# lock; the capture itself (a multi-second sleep) runs outside any lock.
_capture_active = False
_capture_flag_lock = threading.Lock()


def _capture_begin() -> None:
    global _capture_active
    with _capture_flag_lock:
        if _capture_active:
            raise RuntimeError(
                "a profiler capture is already in flight (the profiler "
                "is process-global; retry when it finishes)"
            )
        _capture_active = True


def _capture_end() -> None:
    global _capture_active
    with _capture_flag_lock:
        _capture_active = False


def capture_profile(logdir: str, duration_s: float) -> dict:
    """On-demand, duration-bounded host + device capture of a live process.

    Opens a :func:`trace` under ``logdir`` and holds it for ``duration_s``;
    whatever the process's other threads do in that window is what the
    trace shows.  Returns ``{"path", "duration_s", "bytes"}`` (``bytes``
    counts only this capture's output).  Raises ``RuntimeError`` when a
    capture is already in flight, and ``ValueError`` on a non-positive
    duration.
    """
    if duration_s <= 0:
        raise ValueError(f"duration_s={duration_s} must be > 0")
    _capture_begin()
    try:
        t0 = time.perf_counter()
        before = _tree_bytes(logdir) if os.path.isdir(logdir) else 0
        with trace(logdir):
            time.sleep(duration_s)
        return {
            "path": logdir,
            "duration_s": round(time.perf_counter() - t0, 6),
            "bytes": int(_tree_bytes(logdir) - before),
        }
    finally:
        _capture_end()


class StageTimer:
    """Accumulating wall-clock timer for host-side driver phases.

    The runtime driver wraps its feed / upload / dispatch / compute /
    fetch / write phases so the run summary reports where host time went;
    each stage is also a :func:`span` ``lt_<stage>`` (in a trace only).
    Thread-safe: accumulation holds a lock, so concurrent writers (the
    driver's ``write_workers`` pool) may share one stage name; their
    accumulated seconds then sum ACROSS threads and can exceed wall time.

    >>> timer = StageTimer()
    >>> with timer.stage("feed"):
    ...     pass
    >>> timer.totals()["feed"] >= 0.0
    True
    """

    def __init__(self) -> None:
        self._acc: dict[str, float] = {}
        self._n: dict[str, int] = {}
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            with span(f"lt_{name}"):
                yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._acc[name] = self._acc.get(name, 0.0) + dt
                self._n[name] = self._n.get(name, 0) + 1

    def totals(self) -> dict[str, float]:
        """Stage → accumulated seconds (a locked copy)."""
        with self._lock:
            return dict(self._acc)

    def counts(self) -> dict[str, int]:
        with self._lock:
            return dict(self._n)

    def summary(self) -> dict[str, float]:
        """Flat ``{stage}_s`` dict, rounded — ready to merge into run logs."""
        with self._lock:
            return {f"{k}_s": round(v, 4) for k, v in self._acc.items()}
