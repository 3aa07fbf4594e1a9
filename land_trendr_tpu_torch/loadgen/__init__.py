"""Fleet-scale load harness: seeded traces driving a live router.

The rig splits in two along the determinism line.  The TRACE
(:mod:`~land_trendr_tpu_torch.loadgen.trace`) is pure: a
:class:`~land_trendr_tpu_torch.loadgen.config.LoadConfig` maps to one
arrival/tenant/shape/trace-id schedule, byte-stable run over run.  The
RUNNER (:mod:`~land_trendr_tpu_torch.loadgen.runner`) is the wall-clock
half: it executes the trace against a live fleet — open- or
closed-loop — and records every request's pinned trace id so the
capacity planner (:mod:`land_trendr_tpu_torch.fleet.capacity`) can assemble
latency truth from the request-trace store instead of client clocks.
"""

from land_trendr_tpu_torch.loadgen.config import LOAD_MODES, LoadConfig
from land_trendr_tpu_torch.loadgen.runner import (
    HttpClient,
    InProcClient,
    LoadReport,
    LoadRunner,
    RequestOutcome,
)
from land_trendr_tpu_torch.loadgen.trace import TraceRequest, build_trace, rate_at

__all__ = [
    "LOAD_MODES",
    "HttpClient",
    "InProcClient",
    "LoadConfig",
    "LoadReport",
    "LoadRunner",
    "RequestOutcome",
    "TraceRequest",
    "build_trace",
    "rate_at",
]
