"""Trace-driven capacity planner: scaling curves + offline replay.

Two consumers of the same recorded truth live here.

**The scaling-curve analyzer** takes the load rig's pinned trace ids
(:mod:`land_trendr_tpu_torch.loadgen`) and assembles each request through
the request-trace store (:mod:`land_trendr_tpu_torch.obs.reqtrace`) —
latency truth comes from the fleet's own event streams, not client
clocks.  A sweep over replica counts × offered rates becomes a
replicas-vs-QPS-vs-{p50, p99, goodput} curve; :func:`find_knee` marks
where each curve bends (max perpendicular distance to the chord — the
Kneedle construction on a normalized curve) and :func:`dominant_blame`
names the blame component that owns the knee, in the blame vocabulary
of :mod:`land_trendr_tpu_torch.obs.reqtrace`.

**The offline replay simulator** re-drives a recorded decision log
(:class:`~land_trendr_tpu_torch.fleet.scheduling.DecisionLog`) through fresh
instances of the SAME pure machines the router used live —
:class:`~land_trendr_tpu_torch.fleet.scheduling.DrrQueue`,
:func:`~land_trendr_tpu_torch.fleet.scheduling.choose_replica`,
:class:`~land_trendr_tpu_torch.fleet.autoscale.Autoscaler` — and
byte-compares every recorded output.  Because the machines take all
timing from the recorded ``now``, replay runs as fast as the CPU can
iterate records, far faster than real time.

Stdlib-only: capacity planning must run on the laptop that holds
yesterday's workdir.
"""

from __future__ import annotations

import dataclasses
import json
import random
import time

from land_trendr_tpu_torch.fleet.autoscale import Autoscaler
from land_trendr_tpu_torch.fleet.scheduling import (
    DecisionLog,
    DrrQueue,
    choose_replica,
    read_decisions,
)
from land_trendr_tpu_torch.obs.reqtrace import (
    BLAME_PRIORITY,
    assemble_request,
    discover_request_files,
)

__all__ = [
    "ReplayReport",
    "assemble_sweep",
    "dominant_blame",
    "find_knee",
    "mark_knee",
    "percentile",
    "replay_decisions",
    "validate_report",
    "write_scripted_history",
]

#: the CAPACITY_r*.json report schema this module emits and validates
REPORT_SCHEMA = "lt-capacity-v1"


def percentile(values: "list[float]", q: float) -> float:
    """Linear-interpolated percentile (``q`` in [0, 100]) — the
    fleet-bench convention, shared so curve points and bench reports
    can never disagree on what "p99" means."""
    if not values:
        return 0.0
    xs = sorted(values)
    if len(xs) == 1:
        return float(xs[0])
    pos = (len(xs) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    frac = pos - lo
    return float(xs[lo] * (1.0 - frac) + xs[hi] * frac)


# -- offline replay --------------------------------------------------------
@dataclasses.dataclass
class ReplayReport:
    """One decision-log replay verdict."""

    #: recorded OUTPUT records compared (pick/choose/remove/autoscale)
    decisions: int
    #: how many replayed byte-identically
    matched: int
    #: seq of the first divergence (None when everything matched)
    mismatch_seq: "int | None" = None
    #: ``{"kind", "recorded", "replayed"}`` of the first divergence
    mismatch: "dict | None" = None
    #: recorded wall span (max ``now`` − min ``now`` across records)
    recorded_span_s: float = 0.0
    #: replay CPU wall
    replay_wall_s: float = 0.0

    @property
    def match(self) -> bool:
        return self.decisions > 0 and self.matched == self.decisions

    @property
    def speedup_x(self) -> float:
        """Recorded span over replay wall — how much faster than real
        time the simulator re-derived the decisions."""
        return self.recorded_span_s / max(self.replay_wall_s, 1e-9)

    def to_json(self) -> dict:
        return {
            "decisions": self.decisions,
            "matched": self.matched,
            "match": self.match,
            "mismatch_seq": self.mismatch_seq,
            "mismatch": self.mismatch,
            "recorded_span_s": round(self.recorded_span_s, 6),
            "replay_wall_s": round(self.replay_wall_s, 6),
            "speedup_x": round(self.speedup_x, 3),
        }


def _canon(obj) -> str:
    return json.dumps(obj, sort_keys=True)


def replay_decisions(path: str, telemetry=None) -> ReplayReport:
    """Replay one recorded decision log through fresh pure machines.

    Input records (``enqueue``) advance state; output records
    (``pick`` / ``choose`` / ``remove`` / ``autoscale``) are re-derived
    and byte-compared against what the live router recorded.  A
    ``remove`` is both: its ``removed`` verdict is compared AND the
    entry joins the dead set the replayed pick loop skips — the same
    cancel-races-enqueue discipline the live dispatcher gets from job
    state.
    """
    config, records = read_decisions(path)
    drr = DrrQueue(config.get("weights") or {})
    scaler = None
    asc = config.get("autoscale")
    if asc:
        scaler = Autoscaler(
            min_replicas=asc["min_replicas"],
            max_replicas=asc["max_replicas"],
            up_burn=asc["up_burn"],
            down_burn=asc["down_burn"],
            for_s=asc.get("for_s", 0.0),
            hold_s=asc.get("hold_s", 30.0),
        )
    dead: set = set()
    nows = [r["now"] for r in records if isinstance(r.get("now"), (int, float))]
    rep = ReplayReport(decisions=0, matched=0)
    t0 = time.monotonic()
    for rec in records:
        kind = rec.get("kind")
        recorded = replayed = None
        if kind == "enqueue":
            drr.enqueue(
                rec["tenant"], rec["job_id"], front=bool(rec.get("front"))
            )
            continue
        if kind == "pick":
            out = drr.pick(live=lambda jid: jid not in dead)
            recorded = {"tenant": rec["tenant"], "job_id": rec["job_id"]}
            replayed = (
                None if out is None
                else {"tenant": out[0], "job_id": out[1]}
            )
        elif kind == "choose":
            rid, warm = choose_replica(
                [tuple(c) for c in rec.get("candidates", [])],
                bool(rec.get("affinity")),
            )
            recorded = {"chosen": rec["chosen"], "warm": rec["warm"]}
            replayed = {"chosen": rid, "warm": warm}
        elif kind == "remove":
            removed = drr.remove(rec["tenant"], rec["job_id"])
            dead.add(rec["job_id"])
            recorded = {"removed": rec["removed"]}
            replayed = {"removed": removed}
        elif kind == "autoscale":
            if scaler is None:
                recorded = {"decision": rec.get("decision")}
                replayed = {"decision": "<no autoscale config>"}
            else:
                decision = scaler.decide(
                    rec["burn"], rec["queue_depth"], rec["replicas"],
                    rec["now"],
                )
                recorded = {"decision": rec.get("decision")}
                replayed = {"decision": decision}
        else:
            continue  # unknown kinds are forward-compatible no-ops
        rep.decisions += 1
        if _canon(recorded) == _canon(replayed):
            rep.matched += 1
        elif rep.mismatch_seq is None:
            rep.mismatch_seq = rec.get("seq")
            rep.mismatch = {
                "kind": kind, "recorded": recorded, "replayed": replayed,
            }
    rep.replay_wall_s = time.monotonic() - t0
    rep.recorded_span_s = (max(nows) - min(nows)) if len(nows) > 1 else 0.0
    if telemetry is not None:
        telemetry.sim_replay(
            decisions=rep.decisions, matched=rep.matched, match=rep.match,
            speedup_x=rep.speedup_x, recorded_span_s=rep.recorded_span_s,
            replay_wall_s=rep.replay_wall_s,
            mismatch_seq=rep.mismatch_seq,
        )
    return rep


def write_scripted_history(
    path: str, seed: int = 0, events: int = 400
) -> dict:
    """Write a seeded synthetic decision log by DRIVING the live pure
    machines — the no-fleet-required fixture the perf gate and tests
    replay.  The writer uses exactly the state discipline
    :func:`replay_decisions` assumes (dead-set pick skipping), so a
    matching replay is a real equivalence check of the machines, not a
    tautology over the generator.  Returns ``{"records", "span_s"}``.
    """
    rng = random.Random(seed)
    weights = {"t0": 3.0, "t1": 1.5}
    asc = {
        "min_replicas": 1, "max_replicas": 4, "up_burn": 0.5,
        "down_burn": 0.05, "for_s": 0.0, "hold_s": 2.0,
    }
    drr = DrrQueue(weights)
    scaler = Autoscaler(**asc)
    dead: set = set()
    owner: "dict[str, str]" = {}  # job_id -> tenant (for removes)
    tenants = ("t0", "t1", "t2")
    log = DecisionLog(path)
    try:
        return _drive_script(
            log, rng, drr, scaler, dead, owner, tenants, weights, asc,
            events,
        )
    finally:
        log.close()


def _drive_script(
    log, rng, drr, scaler, dead, owner, tenants, weights, asc, events
) -> dict:
    replicas, now, jid, written = 1, 0.0, 0, 0
    log.record("config", weights=weights, affinity=True, autoscale=asc)
    for _ in range(events):
        now = round(now + rng.uniform(0.05, 0.5), 6)
        r = rng.random()
        if r < 0.40:
            jid += 1
            job = f"sj-{jid:05d}"
            tenant = rng.choice(tenants)
            front = rng.random() < 0.1
            owner[job] = tenant
            drr.enqueue(tenant, job, front=front)
            log.record(
                "enqueue", tenant=tenant, job_id=job, front=front, now=now
            )
        elif r < 0.65:
            out = drr.pick(live=lambda j: j not in dead)
            if out is not None:
                log.record(
                    "pick", tenant=out[0], job_id=out[1], now=now
                )
        elif r < 0.78:
            cands = [
                [f"r{k}", rng.randrange(3), rng.random() < 0.4]
                for k in range(rng.randrange(1, 5))
            ]
            rid, warm = choose_replica([tuple(c) for c in cands], True)
            log.record(
                "choose", key=f"k{rng.randrange(3)}", affinity=True,
                candidates=cands, chosen=rid, warm=warm, now=now,
            )
        elif r < 0.88 and owner:
            job = rng.choice(sorted(owner))
            removed = drr.remove(owner[job], job)
            dead.add(job)
            log.record(
                "remove", tenant=owner.pop(job), job_id=job,
                removed=removed, now=now,
            )
        else:
            burn = round(rng.uniform(0.0, 1.0), 3)
            decision = scaler.decide(burn, drr.depth, replicas, now)
            log.record(
                "autoscale", burn=burn, queue_depth=drr.depth,
                replicas=replicas, now=now, decision=decision,
            )
            if decision == "up":
                replicas += 1
            elif decision == "down":
                replicas -= 1
        written += 1
    return {"records": written, "span_s": now}


# -- curve assembly --------------------------------------------------------
def assemble_sweep(workdir: str, trace_ids: "list[str]") -> dict:
    """Fold one sweep cell's requests through the request-trace store.

    Returns ``{"assembled", "latencies", "blame"}`` — only requests
    whose ``request_done`` landed (``status == "done"``) contribute a
    latency; ``blame`` sums the per-component seconds across them, the
    input :func:`dominant_blame` ranks.
    """
    paths = discover_request_files(workdir)
    latencies: "list[float]" = []
    blame: "dict[str, float]" = {}
    assembled = 0
    for tid in trace_ids:
        rec = assemble_request(paths, tid)
        if not rec.get("found"):
            continue
        assembled += 1
        if rec.get("status") != "done":
            continue
        lat = rec.get("latency_s")
        if isinstance(lat, (int, float)) and not isinstance(lat, bool):
            latencies.append(float(lat))
        for comp, secs in (rec.get("blame") or {}).items():
            blame[comp] = blame.get(comp, 0.0) + float(secs)
    return {
        "assembled": assembled,
        "latencies": latencies,
        "blame": {k: round(v, 6) for k, v in sorted(blame.items())},
    }


def dominant_blame(blame: "dict[str, float]") -> str:
    """The component owning the most seconds; ties break by the blame
    priority order (the same earlier-wins rule the partition uses).
    An empty split names ``other`` — no evidence, no blame."""
    order = {c: i for i, c in enumerate((*BLAME_PRIORITY, "other"))}
    best, best_s = "other", 0.0
    for comp, secs in blame.items():
        if secs > best_s or (secs == best_s and best_s > 0.0
                             and order.get(comp, 99) < order.get(best, 99)):
            best, best_s = comp, float(secs)
    return best


def find_knee(points: "list[tuple[float, float]]") -> "int | None":
    """Index of the knee of an (x, y) curve — max perpendicular
    distance to the first→last chord after normalizing both axes to
    [0, 1] (the Kneedle construction).  Needs >= 3 points and a
    non-degenerate span; returns None otherwise, and None again when
    no interior point rises above the chord (a straight line has no
    knee — stamping one would be blame theater)."""
    if len(points) < 3:
        return None
    xs = [float(p[0]) for p in points]
    ys = [float(p[1]) for p in points]
    dx, dy = max(xs) - min(xs), max(ys) - min(ys)
    if dx <= 0 or dy <= 0:
        return None
    nx = [(x - min(xs)) / dx for x in xs]
    ny = [(y - min(ys)) / dy for y in ys]
    best_i, best_d = None, 1e-9
    for i in range(1, len(points) - 1):
        # distance from (nx, ny) to the chord (0-index -> last index)
        t = (
            (nx[i] - nx[0]) * (nx[-1] - nx[0])
            + (ny[i] - ny[0]) * (ny[-1] - ny[0])
        ) / ((nx[-1] - nx[0]) ** 2 + (ny[-1] - ny[0]) ** 2)
        px = nx[0] + t * (nx[-1] - nx[0])
        py = ny[0] + t * (ny[-1] - ny[0])
        d = ((nx[i] - px) ** 2 + (ny[i] - py) ** 2) ** 0.5
        if d > best_d:
            best_i, best_d = i, d
    return best_i


def mark_knee(points: "list[dict]") -> "int | None":
    """Annotate one replica count's curve in place: find the knee over
    ``(offered_qps, p99_s)`` and stamp ``knee=True`` plus the
    ``knee_blame`` naming that point's dominant component.  Returns
    the knee index."""
    idx = find_knee([
        (p["offered_qps"], p["p99_s"]) for p in points
    ])
    if idx is None:
        return None
    points[idx]["knee"] = True
    points[idx]["knee_blame"] = dominant_blame(points[idx].get("blame") or {})
    return idx


# -- report schema ---------------------------------------------------------
_POINT_NUM = (
    "offered_qps", "achieved_qps", "p50_s", "p99_s", "goodput_qps",
)
_POINT_INT = ("replicas", "done", "failed", "rejected")


def validate_report(report: dict) -> "list[str]":
    """Exact-schema check of a ``CAPACITY_r*.json`` — the perf gate's
    curve-JSON leg.  Returns human-readable problems (empty = valid)."""
    errs: "list[str]" = []
    if not isinstance(report, dict):
        return ["report is not an object"]
    if report.get("schema") != REPORT_SCHEMA:
        errs.append(
            f"schema {report.get('schema')!r} != {REPORT_SCHEMA!r}"
        )
    curves = report.get("curves")
    if not isinstance(curves, list) or not curves:
        return errs + ["curves missing or empty"]
    for ci, curve in enumerate(curves):
        where = f"curves[{ci}]"
        if not isinstance(curve, dict):
            errs.append(f"{where}: not an object")
            continue
        if not isinstance(curve.get("replicas"), int):
            errs.append(f"{where}: replicas missing")
        pts = curve.get("points")
        if not isinstance(pts, list) or not pts:
            errs.append(f"{where}: points missing or empty")
            continue
        for pi, p in enumerate(pts):
            pw = f"{where}.points[{pi}]"
            if not isinstance(p, dict):
                errs.append(f"{pw}: not an object")
                continue
            for k in _POINT_NUM:
                v = p.get(k)
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    errs.append(f"{pw}: {k} missing or non-numeric")
            for k in _POINT_INT:
                if not isinstance(p.get(k), int):
                    errs.append(f"{pw}: {k} missing or non-int")
            if isinstance(p.get("p50_s"), (int, float)) and isinstance(
                p.get("p99_s"), (int, float)
            ) and p["p99_s"] < p["p50_s"]:
                errs.append(f"{pw}: p99_s below p50_s")
            blame = p.get("knee_blame")
            if blame is not None and blame not in (*BLAME_PRIORITY, "other"):
                errs.append(f"{pw}: knee_blame {blame!r} not in vocabulary")
    rep = report.get("replay")
    if not isinstance(rep, dict):
        errs.append("replay missing")
    else:
        for k in ("decisions", "matched", "match", "speedup_x"):
            if k not in rep:
                errs.append(f"replay.{k} missing")
    return errs
