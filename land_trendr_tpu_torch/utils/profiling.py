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
* :func:`nvtx_range` marks a host range where the JAX package has a
  ``jax.named_scope`` stage scope — an NVTX range on the card (for
  external tools) and a ``record_function`` range (a user annotation in
  :func:`trace`'s output): :class:`StageTimer` opens one per host stage
  (``lt_feed``, ``lt_upload``, ``lt_dispatch``, ``lt_compute``,
  ``lt_fetch``, ``lt_write``) and the kernel wrappers one around each
  launch (``lt_segment_fused``, ``lt_family_stats``);
* :class:`StageTimer` is the host-side complement for driver-loop phases.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Callable, Iterator

import torch

__all__ = [
    "trace",
    "profile_op",
    "capture_profile",
    "nvtx_range",
    "StageTimer",
]

_nvtx_on: "bool | None" = None


def _nvtx_enabled() -> bool:
    global _nvtx_on
    if _nvtx_on is None:
        _nvtx_on = torch.cuda.is_available()
    return _nvtx_on


@contextlib.contextmanager
def nvtx_range(name: str) -> Iterator[None]:
    """A host range named ``name`` around the block: a profiler
    annotation, plus an NVTX range where a card is present.  Ranges are
    per thread, so writer and feeder threads nest their own."""
    with torch.profiler.record_function(name):
        if not _nvtx_enabled():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


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
    range (:func:`nvtx_range`) and device kernel; yields ``logdir``.
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
    each stage is also an NVTX range ``lt_<stage>`` on the device
    timeline.  Thread-safe: accumulation holds a lock, so concurrent
    writers (the driver's ``write_workers`` pool) may share one stage
    name; their accumulated seconds then sum ACROSS threads and can exceed
    wall time.

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
            with nvtx_range(f"lt_{name}"):
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
