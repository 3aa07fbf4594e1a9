"""Serving-fleet configuration: everything that defines one router process.

:class:`RouterConfig` is the fleet-layer sibling of
:class:`~land_trendr_tpu_torch.serve.config.ServeConfig`: the one configuration
surface of ``lt route``, projected to the ``route`` CLI subcommand and to
README's ``## Fleet configuration`` table (the LT004 coupling rule checks
all three — the third triangle, after RunConfig and ServeConfig).

Security posture mirrors the job API's: the router front door accepts
arbitrary segmentation work for the whole fleet, so it is loopback-ONLY
(``route_host`` must name a loopback address).  The replicas it talks to
are loopback servers on the same machine — a multi-machine fleet fronts
each machine's router with an authenticated proxy, exactly like a single
server.
"""

from __future__ import annotations

import dataclasses

from land_trendr_tpu_torch.serve.config import LOOPBACK_HOSTS

__all__ = ["RouterConfig", "parse_tenant_weights"]


def parse_tenant_weights(spec: "str | None") -> "dict[str, float]":
    """``"a=3,b=1.5"`` → ``{"a": 3.0, "b": 1.5}`` (fair-share weights;
    tenants not named weigh 1).  Raises ``ValueError`` on any typo — a
    misspelled weight is a config error at startup, not a silently
    unweighted tenant discovered after the starvation incident."""
    out: "dict[str, float]" = {}
    if not spec:
        return out
    for raw in spec.split(","):
        item = raw.strip()
        if not item:
            continue
        name, sep, val = item.partition("=")
        if not sep or not name:
            raise ValueError(
                f"tenant weight {raw!r} is not NAME=WEIGHT"
            )
        try:
            w = float(val)
        except ValueError:
            raise ValueError(
                f"tenant weight {raw!r}: {val!r} is not a number"
            ) from None
        if w <= 0:
            raise ValueError(
                f"tenant weight {raw!r}: weight must be > 0"
            )
        if name in out:
            raise ValueError(f"duplicate tenant weight for {name!r}")
        out[name] = w
    return out


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Everything that defines one ``lt route`` router process."""

    #: router root: the router's own events/metrics stream, the pinned
    #: per-job ``jobs/<id>/{work,out}`` directories every replica
    #: resumes from, and spawned replicas' workdirs live here
    workdir: str = "lt_route"
    #: loopback HTTP JSON API port of the front door (0 = ephemeral,
    #: reported in the startup line)
    route_port: int = 0
    #: bind address for the front door — loopback only (the router
    #: submits arbitrary work to the whole fleet; see the module
    #: docstring)
    route_host: str = "127.0.0.1"
    #: replicas to ADOPT: base URLs of already-running ``lt serve``
    #: processes (``http://127.0.0.1:PORT``).  Adopted replicas are
    #: health-checked and routed to but never spawned, drained, or
    #: killed by the autoscaler.
    replicas: "tuple[str, ...]" = ()
    #: replicas to SPAWN at startup via the ``lt serve`` CLI (workdirs
    #: under ``<workdir>/replicas/``, ephemeral ports read from the
    #: startup line); spawned replicas are the autoscaler's pool
    spawn_replicas: int = 0
    #: extra ``lt serve`` flags passed through to every spawned replica
    #: (e.g. ``--ingest-store-mb 256``); the router always pins
    #: ``--workdir``/``--serve-port`` and, with a telemetry dir, the
    #: ``--publish`` trio.  A ``--device`` flag here is the replica's
    #: top-level device flag (default: the card)
    replica_args: "tuple[str, ...]" = ()
    #: per-replica in-flight bound at the ROUTER: how many routed jobs
    #: may be queued+running on one replica before the router looks
    #: elsewhere (small keeps fair-share responsive; 2 lets a warm
    #: replica pipeline the next same-shape job behind the current one)
    replica_inflight: int = 2
    #: router-wide queue bound: a submission that would grow the unsent
    #: queue past this is throttled with HTTP 429 + Retry-After
    route_queue_depth: int = 64
    #: per-tenant quota: queued + routed (not yet terminal) jobs one
    #: tenant may hold; at the quota the submission is throttled with
    #: HTTP 429 + Retry-After while other tenants' traffic proceeds
    tenant_quota: int = 16
    #: weighted fair share, ``"tenant=weight,..."`` — the deficit
    #: round-robin scheduler gives each tenant queue bandwidth
    #: proportional to its weight (unnamed tenants weigh 1)
    tenant_weights: "str | None" = None
    #: warm-affinity routing: route a job to a replica whose warm/sticky
    #: key set contains its affinity key (least-loaded fallback).
    #: ``False`` routes purely least-loaded — the bench baseline
    #: ``tools/fleet_bench.py`` measures against
    affinity: bool = True
    #: re-routes per job: a job whose replica died (or whose forward
    #: failed) re-enters the queue and routes to another replica at
    #: most this many extra times before going terminal ``error``
    route_retries: int = 2
    #: health-probe + job-poll period, seconds
    health_interval_s: float = 1.0
    #: consecutive failed health probes before a replica is marked
    #: unready (``replica_down`` reason="health"); its accepted jobs
    #: keep polling — they are never failed by a probe
    unhealthy_after: int = 3
    #: SLO-driven autoscaling over the SPAWNED pool: consume the pod
    #: ``lt_slo_burn_rate`` from the shared telemetry directory
    #: (``obs.aggregate.fold_dir`` over replica snapshots) through the
    #: alert engine, and scale between ``min_replicas`` and
    #: ``max_replicas`` with hold-down timers and drain-before-kill
    autoscale: bool = False
    #: autoscaler floor (spawned replicas)
    min_replicas: int = 1
    #: autoscaler ceiling (spawned replicas)
    max_replicas: int = 4
    #: scale UP when the pod burn rate holds at or above this
    scale_up_burn: float = 0.5
    #: scale DOWN when the pod burn rate holds at or below this AND the
    #: router queue is empty
    scale_down_burn: float = 0.05
    #: the burn condition must hold this long before a scale action
    scale_for_s: float = 0.0
    #: hold-down between scale actions, seconds (no flapping)
    scale_hold_s: float = 30.0
    #: router telemetry: its own ``events.jsonl`` scope
    #: (``route_decision`` / ``replica_up`` / ``replica_down`` /
    #: ``tenant_throttled`` / ``scale_decision``) and ``lt_router_*``
    #: metrics under ``workdir``
    telemetry: bool = True
    #: shared fleet telemetry directory (default
    #: ``<workdir>/telemetry``): spawned replicas publish their
    #: snapshots here, the autoscaler folds it for the burn signal, and
    #: the router publishes its own ``kind="route"`` snapshot so
    #: ``lt_fleet`` / ``lt top --dir`` render the router state
    telemetry_dir: "str | None" = None
    #: router ``metrics.prom`` refresh period, seconds
    metrics_interval_s: float = 5.0
    #: request-tracing recency bound: how many recent TERMINAL requests
    #: (trace id, router blame split, hops) ``GET /debug/requests``
    #: serves, slowest-first; the ``/metrics/exemplars`` JSON is the
    #: machine half of the same loop.  0 disables the ring.
    request_ring: int = 64
    #: write-ahead admission journal under ``<workdir>/journal/``: every
    #: accepted job is durably recorded BEFORE the client sees 200, and
    #: a restart on the same workdir replays it — queues rebuilt in
    #: admission order, non-terminal jobs reconciled against their
    #: replicas, duplicates deduplicated by idempotency key.  Off trades
    #: crash-safety for zero admission-path I/O (bench baselines only).
    journal: bool = True
    #: journal segment rotation size, MiB; at rotation (and restart) the
    #: fully-terminal segment prefix is compacted away, bounding replay
    #: cost by the live working set
    journal_segment_mb: int = 4
    #: record every dispatcher/autoscaler decision (inputs AND outputs)
    #: to ``<workdir>/decisions.jsonl`` — the capacity planner's replay
    #: source (``land_trendr_tpu_torch.fleet.capacity``); off by default: the
    #: log grows with traffic and exists for soak/bench runs
    decision_log: bool = False
    #: deterministic fault injection for soak runs (``router.forward``
    #: / ``replica.health`` seams plus everything in-process);
    #: production routers leave this unset
    fault_schedule: "str | None" = None

    def __post_init__(self) -> None:
        if not (0 <= self.route_port <= 65535):
            raise ValueError(
                f"route_port={self.route_port} outside 0..65535"
            )
        if self.route_host not in LOOPBACK_HOSTS:
            raise ValueError(
                f"route_host={self.route_host!r} is not a loopback "
                f"address {LOOPBACK_HOSTS}: the router front door is an "
                "unauthenticated control surface for the whole fleet "
                "and never binds a routable interface"
            )
        for base in self.replicas:
            if not isinstance(base, str) or not base.startswith("http"):
                raise ValueError(
                    f"replica {base!r} is not a base URL "
                    "(http://127.0.0.1:PORT)"
                )
        if self.spawn_replicas < 0:
            raise ValueError(
                f"spawn_replicas={self.spawn_replicas} must be >= 0"
            )
        if not self.replicas and not self.spawn_replicas:
            raise ValueError(
                "a router needs replicas: pass --replica URLs to adopt "
                "and/or --spawn-replicas N to spawn"
            )
        if self.replica_inflight < 1:
            raise ValueError(
                f"replica_inflight={self.replica_inflight} must be >= 1"
            )
        if self.route_queue_depth < 1:
            raise ValueError(
                f"route_queue_depth={self.route_queue_depth} must be >= 1"
            )
        if self.tenant_quota < 1:
            raise ValueError(
                f"tenant_quota={self.tenant_quota} must be >= 1"
            )
        parse_tenant_weights(self.tenant_weights)  # typo = startup error
        if self.route_retries < 0:
            raise ValueError(
                f"route_retries={self.route_retries} must be >= 0"
            )
        if self.health_interval_s <= 0:
            raise ValueError(
                f"health_interval_s={self.health_interval_s} must be > 0"
            )
        if self.unhealthy_after < 1:
            raise ValueError(
                f"unhealthy_after={self.unhealthy_after} must be >= 1"
            )
        if self.autoscale:
            if not self.spawn_replicas:
                raise ValueError(
                    "autoscale manages SPAWNED replicas only (it must "
                    "own the process to drain and stop it): pass "
                    "--spawn-replicas >= 1"
                )
            if not (1 <= self.min_replicas <= self.max_replicas):
                raise ValueError(
                    f"need 1 <= min_replicas({self.min_replicas}) <= "
                    f"max_replicas({self.max_replicas})"
                )
            if not (self.min_replicas <= self.spawn_replicas
                    <= self.max_replicas):
                raise ValueError(
                    f"spawn_replicas={self.spawn_replicas} outside the "
                    f"autoscale bounds [{self.min_replicas}, "
                    f"{self.max_replicas}]"
                )
            if self.scale_down_burn >= self.scale_up_burn:
                raise ValueError(
                    f"scale_down_burn={self.scale_down_burn} must be "
                    f"below scale_up_burn={self.scale_up_burn} (a "
                    "hysteresis band, or the scaler flaps)"
                )
        if self.scale_for_s < 0 or self.scale_hold_s < 0:
            raise ValueError("scale_for_s/scale_hold_s must be >= 0")
        if self.metrics_interval_s <= 0:
            raise ValueError(
                f"metrics_interval_s={self.metrics_interval_s} must be > 0"
            )
        if self.request_ring < 0:
            raise ValueError(
                f"request_ring={self.request_ring} must be >= 0 (0 = off)"
            )
        if self.journal_segment_mb < 1:
            raise ValueError(
                f"journal_segment_mb={self.journal_segment_mb} must be >= 1"
            )
        if self.fault_schedule is not None:
            # parse NOW: a typo'd seam is a config error at startup (the
            # RunConfig/ServeConfig contract)
            from land_trendr_tpu_torch.runtime import faults

            faults.parse_schedule(self.fault_schedule)
