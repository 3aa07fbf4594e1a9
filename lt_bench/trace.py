"""The device trace of a measured window, reduced in memory.

``torch.profiler`` (CUPTI) records every kernel, copy and fill the
process puts on the card, and the host ranges the harness opens with
``record_function`` (``lt_bench.window`` around the window,
``lt_bench.dispatch`` / ``lt_bench.fetch`` / ``lt_bench.wait`` around
its calls into the program).  :func:`digest` keeps, in seconds from the
window's start and clipped to it, each device operation and each idle
gap of the device labelled by what the host was doing; no trace file is
written.
"""

from __future__ import annotations

import bisect
import dataclasses

__all__ = ["DeviceOp", "Gap", "TraceDigest", "WINDOW", "digest"]

#: the harness's host range around the measured window
WINDOW = "lt_bench.window"
#: the harness's host ranges around its calls into the program
SPANS = ("lt_bench.dispatch", "lt_bench.fetch", "lt_bench.wait")

_DEVICE_KINDS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    kind: str      # "kernel" | "memcpy" | "memset"
    start: float   # seconds from the window's start
    end: float


@dataclasses.dataclass(frozen=True)
class Gap:
    start: float
    end: float
    label: str     # "<harness span>/<host op>" at the gap's middle


@dataclasses.dataclass(frozen=True)
class TraceDigest:
    window_s: float
    ops: tuple[DeviceOp, ...]
    busy_s: float
    gaps: tuple[Gap, ...]


def _covered(intervals: "list[tuple[float, float]]") -> "list[tuple[float, float]]":
    """The union of ``intervals`` as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _top_level(spans: "list[tuple[float, float, str]]") -> "list[tuple[float, float, str]]":
    """The outermost of nested host ranges: disjoint and sorted."""
    out: list[tuple[float, float, str]] = []
    for s, e, name in sorted(spans):
        if not out or s >= out[-1][1]:
            out.append((s, e, name))
    return out


def _at(spans: "list[tuple[float, float, str]]", t: float) -> "str | None":
    """The name of the disjoint sorted span holding ``t``, if any."""
    i = bisect.bisect_right(spans, (t, float("inf"), "")) - 1
    if i >= 0 and spans[i][0] <= t < spans[i][1]:
        return spans[i][2]
    return None


def _kinds(events) -> "list[tuple[str, object]]":
    """``(activity, event)`` pairs.  Where the event has no
    ``activity_type`` (older torch), a device event whose name a host
    event also has is the device side of a ``record_function`` range,
    ``Memcpy*`` / ``Memset*`` are copies and fills, and the rest kernels."""
    events = list(events)
    if events and hasattr(events[0], "activity_type"):
        return [(e.activity_type(), e) for e in events]
    on_cuda = [str(e.device_type()).endswith("CUDA") for e in events]
    host_names = {e.name() for e, dev in zip(events, on_cuda) if not dev}
    out = []
    for e, dev in zip(events, on_cuda):
        name = e.name()
        if not dev:
            kind = "cpu_op"
        elif name in host_names:
            kind = "gpu_user_annotation"
        elif name.startswith("Memcpy"):
            kind = "gpu_memcpy"
        elif name.startswith("Memset"):
            kind = "gpu_memset"
        else:
            kind = "kernel"
        out.append((kind, e))
    return out


def digest(events) -> "TraceDigest | None":
    """Reduce a profiler's kineto events to the window's digest; None
    when the trace holds no ``lt_bench.window`` range."""
    win = None
    device: list[tuple[str, str, int, int]] = []
    harness: list[tuple[float, float, str]] = []
    host: list[tuple[float, float, str]] = []
    for kind, e in _kinds(events):
        name = e.name()
        s = e.start_ns()
        end = s + e.duration_ns()
        if kind in _DEVICE_KINDS:
            device.append((name, _DEVICE_KINDS[kind], s, end))
        elif kind in ("cpu_op", "user_annotation"):
            if name == WINDOW:
                win = (s, end)
            elif name in SPANS:
                harness.append((s, end, name))
            else:
                host.append((s, end, name))
    if win is None:
        return None
    w0, w1 = win

    def sec(ns: int) -> float:
        return (min(max(ns, w0), w1) - w0) / 1e9

    ops = tuple(
        DeviceOp(name, kind, sec(s), sec(e))
        for name, kind, s, e in device
        if e > w0 and s < w1
    )
    window_s = (w1 - w0) / 1e9
    busy = _covered([(o.start, o.end) for o in ops])
    harness_s = _top_level([(sec(s), sec(e), n) for s, e, n in harness])
    host_s = _top_level([(sec(s), sec(e), n) for s, e, n in host])
    gaps = []
    prev = 0.0
    for s, e in [*busy, (window_s, window_s)]:
        if s > prev:
            mid = (prev + s) / 2
            label = f"{_at(harness_s, mid) or 'lt_bench.loop'}/{_at(host_s, mid) or 'python'}"
            gaps.append(Gap(prev, s, label))
        prev = max(prev, e)
    return TraceDigest(
        window_s=window_s,
        ops=ops,
        busy_s=sum(e - s for s, e in busy),
        gaps=tuple(gaps),
    )
