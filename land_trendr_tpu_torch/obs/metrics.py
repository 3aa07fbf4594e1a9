"""Metrics registry + Prometheus text exposition for tile runs.

The counters/gauges/histograms half of :mod:`land_trendr_tpu_torch.obs` — the
Stand-in for the reference's Hadoop job counters, in the format
the rest of the monitoring world scrapes.  Pure stdlib (no
``prometheus_client`` dependency — the container must not grow one): the
exposition writer emits the node-exporter text format 0.0.4 directly.

Three consumption paths, least- to most-infrastructure:

* :meth:`MetricsRegistry.render` — the exposition text, for tests and ad
  hoc inspection;
* :class:`PromFileExporter` — a daemon thread atomically refreshing
  ``<workdir>/metrics.prom`` every ``interval_s`` (tmp + ``os.replace``, so
  a scraper-side ``cat`` never sees a torn file; node_exporter's textfile
  collector ingests it as-is);
* :class:`MetricsHTTPServer` — an optional stdlib ``http.server``
  ``/metrics`` endpoint (CLI ``--metrics-port``; default off) so an
  in-flight gigapixel run is scrapeable directly.

All instruments are thread-safe (one registry lock — observation cost is a
dict update, far below the driver's per-tile work) and support optional
constant labels, e.g. ``registry.gauge("lt_stage_seconds", labels={"stage":
"feed"})``; instruments sharing a name must share a type and help string.
"""

from __future__ import annotations

import http.server
import math
import os
import re
import threading
from typing import Iterable, Mapping

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "PromFileExporter",
    "MetricsHTTPServer",
    "DEFAULT_LATENCY_BUCKETS",
    "EXEMPLAR_RING",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: tile-latency histogram buckets (seconds): spans sub-100ms device tiles to
#: multi-minute CPU-backend tiles
DEFAULT_LATENCY_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


def _fmt(v: float) -> str:
    """A Prometheus-parseable number (repr floats, bare ints, +Inf/NaN)."""
    if isinstance(v, bool):  # pragma: no cover - guarded upstream
        v = int(v)
    if isinstance(v, int):
        return str(v)
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    return repr(float(v))


def _fmt_labels(labels: Mapping[str, str] | None, extra: str = "") -> str:
    parts = []
    for k, v in sorted((labels or {}).items()):
        # exposition-format label-value escapes: backslash, quote, AND
        # line-feed — a raw newline inside the quoted value makes the
        # whole scrape unparseable
        escaped = (
            str(v)
            .replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
        )
        parts.append(f'{k}="{escaped}"')
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    kind = "untyped"

    def __init__(
        self, name: str, help: str, labels: Mapping[str, str] | None, lock: threading.Lock
    ) -> None:
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._lock = lock


class Counter(_Metric):
    """Monotonically non-decreasing count (Prometheus ``counter``)."""

    kind = "counter"

    def __init__(self, *a) -> None:
        super().__init__(*a)
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {v})")
        with self._lock:
            self._value += v

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _render(self) -> list[str]:
        # lt: noqa[LT001] — only called from MetricsRegistry.render, which
        # already holds this same shared (non-reentrant) lock
        return [f"{self.name}{_fmt_labels(self.labels)} {_fmt(self._value)}"]


class Gauge(_Metric):
    """Settable instantaneous value (Prometheus ``gauge``)."""

    kind = "gauge"

    def __init__(self, *a) -> None:
        super().__init__(*a)
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def set_max(self, v: float) -> None:
        """Watermark update: keep the maximum ever seen (e.g. HBM peak)."""
        with self._lock:
            self._value = max(self._value, float(v))

    def inc(self, v: float = 1.0) -> None:
        with self._lock:
            self._value += v

    def dec(self, v: float = 1.0) -> None:
        self.inc(-v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _render(self) -> list[str]:
        # lt: noqa[LT001] — only called from MetricsRegistry.render, which
        # already holds this same shared (non-reentrant) lock
        return [f"{self.name}{_fmt_labels(self.labels)} {_fmt(self._value)}"]


#: per-bucket exemplar-ring bound: enough recent trace ids to resolve
#: "the p99 bucket" to concrete requests, small enough that exemplar
#: state stays O(buckets) per histogram
EXEMPLAR_RING = 4


class Histogram(_Metric):
    """Fixed-bucket histogram (Prometheus ``histogram``).

    Buckets are chosen at construction (no dynamic rebinning — exposition
    must stay append-consistent across scrapes); observations above the
    last bound land in ``+Inf`` only, per the exposition contract.

    Observations may carry an **exemplar** (a trace id): each bucket
    keeps a bounded ring of the most recent ``(exemplar, value)`` pairs
    it absorbed, so a tail bucket names concrete requests an operator
    can go assemble (``tools/lt_request.py``) instead of an anonymous
    count.  Exemplar state is created lazily on the first exemplar'd
    observation — plain ``observe(v)`` paths pay nothing.
    """

    kind = "histogram"

    def __init__(self, name, help, labels, lock, buckets: Iterable[float]) -> None:
        super().__init__(name, help, labels, lock)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError(f"histogram {name} needs at least one bucket")
        if any(b != b or math.isinf(b) for b in bounds):
            raise ValueError(f"histogram {name}: finite bucket bounds only")
        self.bounds = tuple(bounds)
        self._counts = [0] * (len(bounds) + 1)  # +Inf last
        self._sum = 0.0
        self._count = 0
        #: lazily-created per-bucket exemplar rings (newest last)
        self._ex: "list[list] | None" = None

    def observe(self, v: float, exemplar: "str | None" = None) -> None:
        v = float(v)
        with self._lock:
            self._sum += v
            self._count += 1
            idx = len(self.bounds)
            for i, b in enumerate(self.bounds):
                if v <= b:
                    idx = i
                    break
            self._counts[idx] += 1
            if exemplar is not None:
                if self._ex is None:
                    self._ex = [[] for _ in range(len(self.bounds) + 1)]
                ring = self._ex[idx]
                ring.append((str(exemplar), v))
                if len(ring) > EXEMPLAR_RING:
                    del ring[0]

    def _exemplars_locked(self) -> "dict[str, list] | None":
        """The ring→JSON shaping (caller holds the shared lock) — ONE
        copy serving both the per-metric accessor and the registry dump
        (which cannot re-take the shared non-reentrant lock)."""
        if self._ex is None:
            return None
        out: "dict[str, list]" = {}
        for i, ring in enumerate(self._ex):
            if not ring:
                continue
            le = _fmt(self.bounds[i]) if i < len(self.bounds) else "+Inf"
            out[le] = [{"trace_id": t, "value": v} for t, v in ring]
        return out or None

    def exemplars(self) -> "dict[str, list] | None":
        """Per-bucket exemplar rings, ``le`` string → newest-last
        ``[{"trace_id", "value"}, ...]`` (buckets with none omitted;
        None when no observation ever carried an exemplar)."""
        with self._lock:
            return self._exemplars_locked()

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def _render(self) -> list[str]:
        lines = []
        cum = 0
        for b, c in zip(self.bounds, self._counts):
            cum += c
            le = 'le="%s"' % _fmt(b)
            lines.append(f"{self.name}_bucket{_fmt_labels(self.labels, le)} {cum}")
        inf = 'le="+Inf"'
        lines.append(
            f"{self.name}_bucket{_fmt_labels(self.labels, inf)} {self._count}"
        )
        lines.append(f"{self.name}_sum{_fmt_labels(self.labels)} {_fmt(self._sum)}")
        lines.append(f"{self.name}_count{_fmt_labels(self.labels)} {self._count}")
        return lines


class MetricsRegistry:
    """Instrument factory + exposition renderer.

    ``counter``/``gauge``/``histogram`` are get-or-create on the full
    ``(name, labels)`` identity, so instrumentation sites can re-request an
    instrument instead of threading references around; a name re-used with
    a different metric type (or different histogram buckets) raises.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> (kind, help); insertion-ordered for stable exposition
        self._families: dict[str, tuple[str, str]] = {}
        self._metrics: dict[tuple[str, tuple], _Metric] = {}

    def _get(self, cls, name, help, labels, *args) -> _Metric:
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for k in labels or {}:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r} on {name}")
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            fam = self._families.get(name)
            if fam is not None and fam[0] != cls.kind:
                raise ValueError(
                    f"metric {name} already registered as {fam[0]}, not {cls.kind}"
                )
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, help or (fam[1] if fam else ""), labels, self._lock, *args)
                self._metrics[key] = m
                if fam is None:
                    self._families[name] = (cls.kind, help)
            elif args and getattr(m, "bounds", None) != tuple(sorted(float(b) for b in args[0])):
                raise ValueError(f"histogram {name} re-registered with different buckets")
        return m

    def counter(self, name: str, help: str = "", labels: Mapping[str, str] | None = None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Mapping[str, str] | None = None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(
        self,
        name: str,
        help: str = "",
        labels: Mapping[str, str] | None = None,
        buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS,
    ) -> Histogram:
        return self._get(Histogram, name, help, labels, tuple(buckets))

    def render(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every instrument."""
        with self._lock:
            by_name: dict[str, list[_Metric]] = {}
            for (name, _), m in self._metrics.items():
                by_name.setdefault(name, []).append(m)
            lines: list[str] = []
            for name, (kind, help) in self._families.items():
                if help:
                    lines.append(f"# HELP {name} {help}")
                lines.append(f"# TYPE {name} {kind}")
                for m in by_name.get(name, []):
                    lines.extend(m._render())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> list:
        """JSON-able dump of every instrument — the fleet-publish wire
        format (:mod:`land_trendr_tpu_torch.obs.publish`).

        One dict per instrument: ``name`` / ``kind`` / ``help`` /
        ``labels`` plus ``value`` (counter, gauge) or ``sum`` /
        ``count`` / ``bounds`` / ``buckets`` (histogram — per-bucket
        RAW counts, last entry the ``+Inf`` overflow, so a cross-host
        merge is a plain elementwise sum).  Sorted by ``(name,
        labels)`` so two snapshots of identical state are byte-identical
        once serialised — the aggregate layer's determinism contract
        starts here.
        """
        out: list = []
        with self._lock:
            for (name, lkey), m in self._metrics.items():
                kind, help = self._families[name]
                d: dict = {
                    "name": name,
                    "kind": kind,
                    "help": help,
                    "labels": dict(m.labels),
                }
                if kind == "histogram":
                    d["sum"] = m._sum
                    d["count"] = m._count
                    d["bounds"] = list(m.bounds)
                    d["buckets"] = list(m._counts)
                else:
                    d["value"] = m._value
                out.append(d)
        out.sort(key=lambda d: (d["name"], sorted(d["labels"].items())))
        return out

    def exemplars(self) -> list:
        """The ``/metrics``-adjacent exemplar JSON: one entry per
        histogram that ever absorbed an exemplar'd observation —
        ``name`` / ``labels`` / ``exemplars`` (``le`` → newest-last
        ``[{"trace_id", "value"}, ...]``).  Uses the histograms'
        ``_exemplars_locked`` under the shared lock, like
        :meth:`snapshot` (the per-metric accessor would re-take the
        same non-reentrant lock)."""
        out: list = []
        with self._lock:
            for (name, _), m in self._metrics.items():
                locked = getattr(m, "_exemplars_locked", None)
                rings = locked() if locked is not None else None
                if rings:
                    out.append({
                        "name": name,
                        "labels": dict(m.labels),
                        "exemplars": rings,
                    })
        out.sort(key=lambda d: (d["name"], sorted(d["labels"].items())))
        return out


class PromFileExporter:
    """Daemon thread atomically refreshing a ``.prom`` exposition file.

    ``write_now`` runs once at :meth:`start` (so even a sub-interval run
    leaves a file) and once at :meth:`stop` (the final state is always on
    disk); in between, the thread refreshes every ``interval_s``.  Atomic
    tmp + ``os.replace`` — a scrape never reads a torn file; the pid in
    the tmp name keeps shared-workdir pod processes from racing.
    """

    def __init__(self, registry: MetricsRegistry, path: str, interval_s: float = 5.0) -> None:
        if interval_s <= 0:
            raise ValueError(f"interval_s={interval_s} must be > 0")
        self.registry = registry
        self.path = path
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # serializes the loop thread and stop()'s final flush: they share
        # the pid-based tmp path, so unserialized they can tear it
        self._write_lock = threading.Lock()

    def write_now(self) -> None:
        # _write_lock orders the tmp+replace of the loop thread and stop()'s
        # final flush, which share one tmp path; the payload is one page
        with self._write_lock:
            self._write_locked()  # lt: noqa[LT007]

    def _write_locked(self) -> None:
        tmp = f"{self.path}.{os.getpid()}.tmp"
        # lt: noqa[LT007]
        with open(tmp, "w") as f:
            f.write(self.registry.render())  # lt: noqa[LT007]
        os.replace(tmp, self.path)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.write_now()
            except OSError:  # pragma: no cover - transient FS pressure
                pass  # keep trying; the final stop() write will surface it

    def start(self) -> "PromFileExporter":
        self.write_now()
        self._thread = threading.Thread(
            target=self._loop, name="lt-metrics-exporter", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        # after a join timeout the loop thread may still be wedged INSIDE
        # write_now on a hung shared filesystem: take the lock with a
        # bound and skip the final flush rather than race its tmp file or
        # hang (and possibly crash) a run whose artifacts are already
        # durable — the wedged writer holds the freshest state anyway
        if self._write_lock.acquire(timeout=5.0):
            try:
                self._write_locked()
            finally:
                self._write_lock.release()


class _QuietHTTPServer(http.server.ThreadingHTTPServer):
    """ThreadingHTTPServer that does not traceback on dropped scrapes.

    A scraper that disconnects mid-response (timeout, health-check
    half-open, port scan) raises BrokenPipeError/ConnectionResetError in
    the handler, which the stdlib ``handle_error`` dumps as a multi-line
    traceback to stderr — routine noise on a multi-hour run's log, not an
    error.  Anything else still gets the default report.
    """

    daemon_threads = True

    def handle_error(self, request, client_address) -> None:
        import sys

        if isinstance(sys.exc_info()[1], (BrokenPipeError, ConnectionResetError)):
            return
        super().handle_error(request, client_address)


class MetricsHTTPServer:
    """Optional in-flight scrape endpoint: stdlib ``/metrics`` server.

    ``port=0`` binds an ephemeral port (tests); the bound port is exposed
    as :attr:`port`.  Serves only GET ``/metrics`` (404 otherwise) on a
    daemon thread — nothing here can outlive or block the run.
    """

    def __init__(self, registry: MetricsRegistry, port: int, host: str = "") -> None:
        reg = registry

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 - stdlib API name
                if self.path.split("?")[0] != "/metrics":
                    self.send_error(404)
                    return
                body = reg.render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a) -> None:  # quiet: no per-scrape stderr
                pass

        self._server = _QuietHTTPServer((host, port), Handler)
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="lt-metrics-http", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)
