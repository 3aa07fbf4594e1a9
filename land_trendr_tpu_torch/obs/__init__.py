"""obs subpackage: run-wide telemetry — structured events, metrics, traces.

Copies of the JAX package's ``obs`` modules this package's driver reports
through (stdlib only): the schema-versioned JSONL event stream, the
Prometheus metrics registry with file and HTTP exporters, the flight
recorder and resource sampler, the straggler detector and span helpers,
and the :class:`Telemetry` bundle.  Event names, fields and metric names
are the JAX package's, so its tools read this package's streams.  The
fleet telemetry plane (``publish`` → ``aggregate`` → ``history`` →
``alerts``) is here too, and ``reqtrace``, which assembles a request's
spans across the fleet router and its replicas.
"""

from land_trendr_tpu_torch.obs.events import (
    EVENT_FIELDS,
    SCHEMA_VERSION,
    EventLog,
    discover_event_files,
    events_path,
    expand_event_paths,
    iter_events,
    validate_event,
    validate_events_file,
)
from land_trendr_tpu_torch.obs.flight import (
    FlightRecorder,
    ResourceSampler,
    flight_path,
    thread_stacks,
)
from land_trendr_tpu_torch.obs.spans import (
    SPAN_STAGES,
    StragglerDetector,
    assemble_pod_trace,
    critical_path,
)
from land_trendr_tpu_torch.obs.metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsHTTPServer,
    MetricsRegistry,
    PromFileExporter,
)
from land_trendr_tpu_torch.obs.aggregate import (
    fold_dir,
    merge_instruments,
    pod_sample,
    render_prom,
)
from land_trendr_tpu_torch.obs.alerts import AlertEngine, AlertRule, load_rules
from land_trendr_tpu_torch.obs.history import HistoryRing, counter_rate
from land_trendr_tpu_torch.obs.publish import TelemetryPublisher, telemetry_dir
from land_trendr_tpu_torch.obs.telemetry import Telemetry, metrics_path

__all__ = [
    "EVENT_FIELDS",
    "SCHEMA_VERSION",
    "EventLog",
    "discover_event_files",
    "events_path",
    "expand_event_paths",
    "iter_events",
    "validate_event",
    "validate_events_file",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "ResourceSampler",
    "flight_path",
    "thread_stacks",
    "MetricsHTTPServer",
    "MetricsRegistry",
    "PromFileExporter",
    "SPAN_STAGES",
    "StragglerDetector",
    "Telemetry",
    "AlertEngine",
    "AlertRule",
    "HistoryRing",
    "TelemetryPublisher",
    "assemble_pod_trace",
    "counter_rate",
    "critical_path",
    "fold_dir",
    "load_rules",
    "merge_instruments",
    "metrics_path",
    "pod_sample",
    "render_prom",
    "telemetry_dir",
]
