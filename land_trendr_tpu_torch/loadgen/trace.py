"""Seeded load traces: the deterministic half of the load rig.

A trace is a tuple of :class:`TraceRequest` — WHO (tenant), WHAT
(payload shape key), WHEN (arrival offset, open loop only) and WHICH
(the pinned trace id) — computed purely from a :class:`LoadConfig`.
The same config regenerates the same trace byte for byte, which is
what lets a sweep re-run a cell, a soak re-run a failure, and the
offline replay (:mod:`land_trendr_tpu_torch.fleet.capacity`) line recorded
decisions up against the traffic that caused them.

Open-loop arrivals are a non-homogeneous Poisson process under the
diurnal rate schedule :func:`rate_at`, generated by Lewis–Shedler
thinning: exponential gaps at the PEAK rate, each candidate kept with
probability ``rate_at(t)/peak``.  Thinning keeps determinism trivial
(one ``random.Random(seed)`` stream, no numerical integration) and is
exact for any bounded rate function.
"""

from __future__ import annotations

import dataclasses
import math
import random

from land_trendr_tpu_torch.loadgen.config import LoadConfig

__all__ = ["TraceRequest", "build_trace", "rate_at", "tenant_weights"]


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One scheduled request of a load trace."""

    #: arrival offset from the phase start, seconds (0.0 for every
    #: closed-loop entry: a closed loop arrives when a worker is free)
    at_s: float
    #: submitting tenant (``t0``..)
    tenant: str
    #: payload-shape key — the driver maps it to an actual job payload
    #: (distinct shapes → distinct affinity keys → warm-cache churn)
    shape: str
    #: the request-tracing id pinned at SUBMISSION, so the rig can
    #: assemble exactly its own requests from the trace store
    trace_id: str


def rate_at(cfg: LoadConfig, t_s: float) -> float:
    """Offered rate of the diurnal schedule at offset ``t_s``."""
    return cfg.qps * (
        1.0 + cfg.wave_amp * math.sin(2.0 * math.pi * t_s / cfg.wave_period_s)
    )


def tenant_weights(cfg: LoadConfig) -> "list[float]":
    """Heavy-tailed tenant mix: weight of the k-th most popular tenant
    is ``1/k**tenant_skew`` (``skew=0`` → uniform)."""
    return [
        1.0 / float(k) ** cfg.tenant_skew
        for k in range(1, cfg.tenants + 1)
    ]


def _trace_id(cfg: LoadConfig, index: int) -> str:
    # seed + ordinal, hex on both sides: unique within a run, stable
    # across re-runs, and visibly a load-rig id in trace listings
    return f"lg{cfg.seed & 0xFFFFFFFF:08x}{index:06x}"


#: payload-shape keys a trace cycles through; the driver maps each to a
#: concrete params variant (distinct affinity keys exercise the warm
#: router path the way a mixed production workload would)
SHAPES = ("a", "b")

#: the canonical params variant per shape key — two compiled-program
#: shapes, the fleet_bench convention (``lt load`` and the capacity
#: bench both submit these, so their affinity-key churn is comparable)
SHAPE_PARAMS = {
    "a": {"max_segments": 4, "vertex_count_overshoot": 2},
    "b": {"max_segments": 6, "vertex_count_overshoot": 2},
}


def build_trace(cfg: LoadConfig) -> "tuple[TraceRequest, ...]":
    """The full deterministic trace for ``cfg``.

    Open loop: Poisson arrivals under the diurnal schedule across
    ``[0, duration_s)``, truncated to ``requests`` when set.  Closed
    loop: a request pool with ``at_s=0`` — ``requests`` entries when
    set, else enough for ``workers`` clients to chew through the window
    (the runner stops at ``duration_s`` regardless; a longer pool only
    costs bytes).
    """
    rng = random.Random(cfg.seed)
    weights = tenant_weights(cfg)
    tenants = [f"t{i}" for i in range(cfg.tenants)]

    def draw_req(index: int, at_s: float) -> TraceRequest:
        return TraceRequest(
            at_s=round(at_s, 6),
            tenant=rng.choices(tenants, weights=weights)[0],
            shape=SHAPES[rng.randrange(len(SHAPES))],
            trace_id=_trace_id(cfg, index),
        )

    out: "list[TraceRequest]" = []
    if cfg.mode == "open":
        peak = cfg.qps * (1.0 + cfg.wave_amp)
        t = 0.0
        while True:
            t += rng.expovariate(peak)
            if t >= cfg.duration_s:
                break
            if rng.random() >= rate_at(cfg, t) / peak:
                continue  # thinned: below the schedule at this offset
            out.append(draw_req(len(out), t))
            if cfg.requests and len(out) >= cfg.requests:
                break
    else:
        # a worker needs ~duration/think requests at minimum; pad so a
        # fast fleet never drains the pool before the window closes
        n = cfg.requests or max(
            64, cfg.workers * (int(cfg.duration_s / max(cfg.think_s, 0.05)) + 8)
        )
        for i in range(n):
            out.append(draw_req(i, 0.0))
    return tuple(out)
