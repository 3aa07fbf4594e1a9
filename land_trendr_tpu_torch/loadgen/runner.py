"""The soak runner: drive a live fleet with a seeded trace.

:class:`LoadRunner` executes one :func:`~land_trendr_tpu_torch.loadgen.
trace.build_trace` trace against a router — in-process
(:class:`InProcClient` around a :class:`~land_trendr_tpu_torch.fleet.router.
FleetRouter`) or over HTTP (:class:`HttpClient`) — and returns a
:class:`LoadReport` with every request's trace id and outcome.  The
report is deliberately raw: the capacity analyzer
(:mod:`land_trendr_tpu_torch.fleet.capacity`) re-derives latency from the
request-trace store, not from client-side clocks, so the rig only has
to know WHICH requests were its own.

Closed vs open loop is the whole point of having both: a closed loop's
arrival rate collapses to the fleet's completion rate (coordinated
omission — the bench can never overload what it measures), while an
open loop keeps offering the scheduled rate as queues grow, which is
where knees live.

Churn rides the ``loadgen.tick`` fault seam: every scheduler tick asks
:func:`land_trendr_tpu_torch.runtime.faults.fired` and, on a firing tick,
invokes the host's ``churn`` hook (SIGKILL a replica, flip a health
probe, ...).  The seam keeps soak churn on the same seeded,
deterministic schedule as every other injected fault.
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request
from typing import Callable

from land_trendr_tpu_torch.loadgen.config import LoadConfig
from land_trendr_tpu_torch.loadgen.trace import TraceRequest, build_trace
from land_trendr_tpu_torch.runtime import faults
from land_trendr_tpu_torch.serve.jobs import TERMINAL_STATES
from land_trendr_tpu_torch.serve.server import Rejection

__all__ = [
    "HttpClient",
    "InProcClient",
    "LoadReport",
    "LoadRunner",
    "RequestOutcome",
]


class InProcClient:
    """Submit/poll against a :class:`FleetRouter` in this process."""

    def __init__(self, router) -> None:
        self._router = router

    def submit(self, payload: dict) -> "tuple[str | None, str | None]":
        """→ (job_id, None) accepted, (None, reason) rejected."""
        try:
            snap = self._router.submit(payload, source="loadgen")
        except Rejection as e:
            return None, e.reason
        return snap["job_id"], None

    def status(self, job_id: str) -> "str | None":
        snap = self._router.job_status(job_id)
        return None if snap is None else snap.get("state")


class HttpClient:
    """Submit/poll a router (or a bare ``lt serve``) over its JSON API."""

    def __init__(self, base_url: str, timeout_s: float = 10.0) -> None:
        self._base = base_url.rstrip("/")
        self._timeout = timeout_s

    def submit(self, payload: dict) -> "tuple[str | None, str | None]":
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            self._base + "/jobs", data=body,
            headers={"Content-Type": "application/json"},
        )
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as r:
                return json.loads(r.read())["job_id"], None
        except urllib.error.HTTPError as e:
            try:
                reason = json.loads(e.read()).get("error", "http_error")
            except Exception:
                reason = "http_error"
            return None, reason
        except (urllib.error.URLError, OSError):
            return None, "unreachable"

    def status(self, job_id: str) -> "str | None":
        try:
            with urllib.request.urlopen(
                self._base + "/jobs/" + job_id, timeout=self._timeout
            ) as r:
                return json.loads(r.read()).get("state")
        except Exception:
            return None


@dataclasses.dataclass
class RequestOutcome:
    """One trace request's fate, as the client saw it."""

    trace_id: str
    tenant: str
    shape: str
    #: terminal verdict: ``done`` / any non-done terminal state /
    #: ``rejected`` (admission refused) / ``timeout`` (patience ran
    #: out) / ``lost`` (status polling found no such job)
    outcome: str
    #: admission rejection reason, when ``outcome == "rejected"``
    reason: "str | None" = None
    #: client-observed submit→terminal wall seconds (None unless the
    #: job reached a terminal state) — a sanity cross-check only; the
    #: analyzer's latency truth is the request-trace store
    latency_s: "float | None" = None


@dataclasses.dataclass
class LoadReport:
    """One load phase, summarized.  ``offered`` counts scheduled
    arrivals (open loop) or issued submissions (closed loop)."""

    mode: str
    offered: int
    done: int
    failed: int
    rejected: int
    wall_s: float
    outcomes: "list[RequestOutcome]"
    #: loadgen.tick churn firings during the phase
    churned: int = 0

    @property
    def trace_ids(self) -> "list[str]":
        return [o.trace_id for o in self.outcomes]


#: scheduler/poll granularity, seconds — also the loadgen.tick cadence
_TICK_S = 0.05


class LoadRunner:
    """Drive one seeded trace against one client.

    ``payload_fn(req)`` maps a :class:`TraceRequest` to the job payload
    to submit; it MUST pass ``req.trace_id`` through as the payload's
    ``trace_id`` (the runner asserts this) — the pinned id is how the
    analyzer finds the rig's requests in the trace store afterwards.
    ``churn`` is invoked on each firing ``loadgen.tick``.
    """

    def __init__(
        self,
        cfg: LoadConfig,
        client,
        payload_fn: "Callable[[TraceRequest], dict]",
        telemetry=None,
        churn: "Callable[[], None] | None" = None,
    ) -> None:
        self.cfg = cfg
        self.client = client
        self.payload_fn = payload_fn
        self.telemetry = telemetry
        self.churn = churn
        self._lock = threading.Lock()
        self._outcomes: "list[RequestOutcome]" = []
        self._churned = 0

    # -- plumbing ----------------------------------------------------------
    def _payload(self, req: TraceRequest) -> dict:
        payload = self.payload_fn(req)
        if payload.get("trace_id") != req.trace_id:
            raise ValueError(
                "payload_fn must pin the trace id: payload trace_id "
                f"{payload.get('trace_id')!r} != {req.trace_id!r}"
            )
        return payload

    def _tick(self) -> None:
        """One scheduler heartbeat: the churn seam's invocation point."""
        if faults.fired("loadgen.tick"):
            with self._lock:
                self._churned += 1
            if self.churn is not None:
                self.churn()

    def _record(self, out: RequestOutcome) -> None:
        with self._lock:
            self._outcomes.append(out)

    def _run_one(self, req: TraceRequest) -> None:
        """Submit one request and poll it to a terminal state."""
        payload = self._payload(req)
        t0 = time.monotonic()
        job_id, reason = self.client.submit(payload)
        if job_id is None:
            self._record(RequestOutcome(
                req.trace_id, req.tenant, req.shape, "rejected",
                reason=reason,
            ))
            return
        deadline = t0 + self.cfg.timeout_s
        while True:
            state = self.client.status(job_id)
            if state in TERMINAL_STATES:
                self._record(RequestOutcome(
                    req.trace_id, req.tenant, req.shape, state,
                    latency_s=time.monotonic() - t0,
                ))
                return
            if state is None:
                self._record(RequestOutcome(
                    req.trace_id, req.tenant, req.shape, "lost",
                ))
                return
            if time.monotonic() >= deadline:
                self._record(RequestOutcome(
                    req.trace_id, req.tenant, req.shape, "timeout",
                ))
                return
            time.sleep(_TICK_S)

    # -- the two loops -----------------------------------------------------
    def _run_open(self, trace: "tuple[TraceRequest, ...]") -> int:
        """Offered arrivals on the schedule's clock: each request fires
        at its ``at_s`` on its own thread (bounded by joining at the
        end, not by a pool — an overloaded fleet must not push back on
        arrivals, that is the whole open-loop point)."""
        start = time.monotonic()
        threads: "list[threading.Thread]" = []
        offered = 0
        for req in trace:
            while True:
                now = time.monotonic() - start
                if now >= req.at_s:
                    break
                self._tick()
                time.sleep(min(_TICK_S, req.at_s - now))
            t = threading.Thread(
                target=self._run_one, args=(req,), daemon=True
            )
            t.start()
            threads.append(t)
            offered += 1
        # drain: patience per request already bounds each thread
        for t in threads:
            t.join(timeout=self.cfg.timeout_s + 5.0)
        return offered

    def _run_closed(self, trace: "tuple[TraceRequest, ...]") -> int:
        """``workers`` virtual clients chewing through the shared pool
        until the window closes or the pool drains."""
        start = time.monotonic()
        cursor = {"i": 0}
        offered = {"n": 0}

        def next_req() -> "TraceRequest | None":
            with self._lock:
                if cursor["i"] >= len(trace):
                    return None
                req = trace[cursor["i"]]
                cursor["i"] += 1
                offered["n"] += 1
                return req

        def worker() -> None:
            while time.monotonic() - start < self.cfg.duration_s:
                self._tick()
                req = next_req()
                if req is None:
                    return
                self._run_one(req)
                if self.cfg.think_s:
                    time.sleep(self.cfg.think_s)

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(self.cfg.workers)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=self.cfg.duration_s + self.cfg.timeout_s + 5.0)
        return offered["n"]

    def run(self, phase: str = "load") -> LoadReport:
        """Execute the trace; returns the phase report."""
        cfg = self.cfg
        trace = build_trace(cfg)
        if self.telemetry is not None:
            self.telemetry.load_phase(
                phase=f"{phase}_start", mode=cfg.mode,
                offered_qps=cfg.qps if cfg.mode == "open" else None,
                requests=len(trace), workers=cfg.workers,
                duration_s=cfg.duration_s, seed=cfg.seed,
            )
        t0 = time.monotonic()
        offered = (
            self._run_open(trace) if cfg.mode == "open"
            else self._run_closed(trace)
        )
        wall = time.monotonic() - t0
        with self._lock:
            outcomes = list(self._outcomes)
            churned = self._churned
            self._outcomes = []
            self._churned = 0
        done = sum(1 for o in outcomes if o.outcome == "done")
        rejected = sum(1 for o in outcomes if o.outcome == "rejected")
        failed = len(outcomes) - done - rejected
        if self.telemetry is not None:
            self.telemetry.load_phase(
                phase=f"{phase}_done", mode=cfg.mode,
                offered_qps=cfg.qps if cfg.mode == "open" else None,
                requests=offered, workers=cfg.workers,
                duration_s=wall, seed=cfg.seed,
            )
        return LoadReport(
            mode=cfg.mode, offered=offered, done=done, failed=failed,
            rejected=rejected, wall_s=wall, outcomes=outcomes,
            churned=churned,
        )
