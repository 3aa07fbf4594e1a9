"""Load-rig configuration: everything that defines one ``lt load`` run.

:class:`LoadConfig` is the load harness's one configuration surface,
projected to the ``load`` CLI subcommand and to README's ``## Load
configuration`` table (the LT004 coupling rule checks all three — the
fourth triangle, after RunConfig, ServeConfig and RouterConfig).

The config describes the SHAPE of offered load only — arrival process,
tenant mix, rate schedule, concurrency, seed.  What each request *does*
(the job payload) and where it goes (an in-process router or a base
URL) are the driver's arguments, not load shape, so they live on
:class:`~land_trendr_tpu_torch.loadgen.runner.LoadRunner`.
"""

from __future__ import annotations

import dataclasses

__all__ = ["LOAD_MODES", "LoadConfig"]

#: the arrival-process vocabulary.  ``open``: arrivals follow the
#: seeded schedule regardless of completions (offered rate is a fact
#: about the world — the regime where queues actually grow).
#: ``closed``: each of ``workers`` virtual clients submits, waits for
#: the terminal state, thinks, repeats (arrival rate = completion
#: rate; the regime every naive bench accidentally measures).
LOAD_MODES = ("open", "closed")


@dataclasses.dataclass(frozen=True)
class LoadConfig:
    """Everything that defines one load-rig run's offered traffic."""

    #: arrival process: ``open`` (seeded Poisson schedule, offered rate
    #: independent of completions) or ``closed`` (each worker submits →
    #: awaits terminal → thinks → repeats)
    mode: str = "closed"
    #: run length, seconds — the open-loop schedule spans exactly this
    #: window; a closed-loop run stops issuing new requests after it
    duration_s: float = 10.0
    #: open-loop mean offered rate, requests/second (the diurnal wave
    #: modulates around this mean); unused by closed loops
    qps: float = 2.0
    #: total request budget; 0 = unbounded (open loops stop at
    #: ``duration_s``, closed loops issue until the window closes)
    requests: int = 0
    #: concurrency: closed-loop virtual clients, and the dispatch-pool
    #: width an open loop uses so a slow fleet cannot stall arrivals
    workers: int = 2
    #: trace seed: the same (seed, config) pair regenerates the same
    #: arrival times, tenant sequence and trace ids, byte for byte
    seed: int = 0
    #: tenant population size (tenants are named ``t0``..``tN-1``)
    tenants: int = 3
    #: heavy-tail exponent of the tenant mix: tenant ``k`` (1-based by
    #: popularity) is drawn with weight ``1/k**tenant_skew`` (0 =
    #: uniform; ~1 = the classic Zipf skew where t0 dominates)
    tenant_skew: float = 1.0
    #: diurnal-wave amplitude in [0, 1): the open-loop rate schedule is
    #: ``qps * (1 + wave_amp * sin(2*pi*t/wave_period_s))`` (0 = flat)
    wave_amp: float = 0.0
    #: diurnal-wave period, seconds
    wave_period_s: float = 60.0
    #: closed-loop think time between a completion and the worker's
    #: next submission, seconds
    think_s: float = 0.0
    #: per-request patience: a submitted job not terminal after this
    #: long is counted ``failed`` (the rig stops polling it)
    timeout_s: float = 120.0

    def __post_init__(self) -> None:
        if self.mode not in LOAD_MODES:
            raise ValueError(
                f"mode={self.mode!r} not one of {LOAD_MODES}"
            )
        if self.duration_s <= 0:
            raise ValueError(
                f"duration_s={self.duration_s} must be > 0"
            )
        if self.qps <= 0:
            raise ValueError(f"qps={self.qps} must be > 0")
        if self.requests < 0:
            raise ValueError(
                f"requests={self.requests} must be >= 0 (0 = unbounded)"
            )
        if self.workers < 1:
            raise ValueError(f"workers={self.workers} must be >= 1")
        if self.tenants < 1:
            raise ValueError(f"tenants={self.tenants} must be >= 1")
        if self.tenant_skew < 0:
            raise ValueError(
                f"tenant_skew={self.tenant_skew} must be >= 0"
            )
        if not (0.0 <= self.wave_amp < 1.0):
            # amp >= 1 would schedule a negative offered rate at the
            # trough — not a wave, a config typo
            raise ValueError(
                f"wave_amp={self.wave_amp} outside [0, 1)"
            )
        if self.wave_period_s <= 0:
            raise ValueError(
                f"wave_period_s={self.wave_period_s} must be > 0"
            )
        if self.think_s < 0:
            raise ValueError(f"think_s={self.think_s} must be >= 0")
        if self.timeout_s <= 0:
            raise ValueError(f"timeout_s={self.timeout_s} must be > 0")
