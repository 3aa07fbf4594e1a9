"""Pure scheduling cores + the recorded decision log they replay from.

The router's two decision mechanisms — deficit-round-robin tenant
scheduling and warm-affinity replica choice — are deliberately pure
functions of their visible state: no wall clock, no I/O, no randomness.
This module is the ONE copy of each, used live by
:class:`~land_trendr_tpu_torch.fleet.router.FleetRouter` and offline by the
capacity replay simulator (:mod:`land_trendr_tpu_torch.fleet.capacity`), so
"the simulator models the dispatcher" is enforced by construction
rather than by keeping two implementations in sync.

:class:`DecisionLog` is the recording half of that contract: a router
started with ``decision_log=True`` appends one JSONL record per
decision *input* and *output* (autoscaler ticks, DRR enqueues/picks,
replica choices) to ``<workdir>/decisions.jsonl``.  The simulator
replays the inputs through fresh instances of the SAME classes below
and byte-compares the outputs — the live-vs-replay equivalence proof
``CAPACITY_r17.json`` carries.
"""

from __future__ import annotations

import collections
import json
import os
import threading

__all__ = [
    "DECISIONS_NAME",
    "PURE_MACHINES",
    "DecisionLog",
    "DrrQueue",
    "choose_replica",
    "read_decisions",
]

#: the decision-log file name under the router workdir
DECISIONS_NAME = "decisions.jsonl"

#: The pure decision machines of the fleet replay contract, as
#: ``(file, symbol)`` data — lt-lint LT009's single source (the
#: ``NONNEG_FIELDS`` shared-table pattern): everything listed here must
#: stay a pure function of its arguments (``now`` and seeds included),
#: transitively — no clock reads, no randomness, no environment, no
#: file IO, no global mutation — or the byte-identity replay proof
#: (``CAPACITY_r17.json``) silently stops meaning anything.  A class
#: name covers every method; ``obs/alerts.py`` exports the
#: observability-side half of the registry in the same shape.
#: ``tests/test_lint.py`` pins this table against the symbols
#: ``fleet/capacity.py::replay_decisions`` actually dispatches to.
#: NOTE: :class:`DecisionLog` is deliberately absent — it is the
#: *recording* half (O_APPEND file IO by design), never replayed — and
#: so is ``replay_decisions`` itself: it is the replay *shell* (reads
#: the log file, stamps the replay's own wall time, emits telemetry);
#: the machines it re-derives decisions THROUGH are what must stay pure.
PURE_MACHINES = (
    ("land_trendr_tpu_torch/fleet/scheduling.py", "DrrQueue"),
    ("land_trendr_tpu_torch/fleet/scheduling.py", "choose_replica"),
    ("land_trendr_tpu_torch/fleet/autoscale.py", "Autoscaler.decide"),
    ("land_trendr_tpu_torch/fleet/capacity.py", "find_knee"),
)


class DrrQueue:
    """Deficit round-robin over per-tenant FIFO queues.

    Each ring visit banks the tenant's weight; a banked deficit >= 1
    buys one entry (cost 1).  Bandwidth is therefore proportional to
    weight, and any non-empty queue is served within a bounded number
    of rotations — a heavy tenant cannot starve a light one.  An
    emptied queue leaves the ring and forfeits its bank (DRR's
    anti-burst rule).

    Pure state machine: no clocks, no locks (the caller serializes),
    no randomness — the same enqueue/pick/remove call sequence always
    yields the same pick sequence, which is what makes the recorded
    dispatcher history offline-replayable.
    """

    def __init__(self, weights: "dict[str, float] | None" = None) -> None:
        self._tq: "dict[str, collections.deque]" = {}
        self._deficit: "dict[str, float]" = {}
        self._ring: "collections.deque[str]" = collections.deque()
        self._weights = dict(weights or {})
        self._depth = 0

    @property
    def depth(self) -> int:
        """Entries currently queued (all tenants)."""
        return self._depth

    @property
    def pending(self) -> bool:
        """Any tenant with a non-empty queue?"""
        return bool(self._ring)

    def weight(self, tenant: str) -> float:
        return self._weights.get(tenant, 1.0)

    def deficit(self, tenant: str) -> float:
        return self._deficit.get(tenant, 0.0)

    def queued(self, tenant: str) -> int:
        q = self._tq.get(tenant)
        return len(q) if q else 0

    def tenants(self) -> "list[str]":
        return sorted(t for t, q in self._tq.items() if q)

    def known_tenants(self) -> "list[str]":
        """Every tenant that ever enqueued (empty queues included) —
        the stats-view domain."""
        return sorted(self._tq)

    def remove(self, tenant: str, entry: str) -> bool:
        """Drop one queued entry (cancel-while-queued).  Returns False
        when the entry is not in the tenant's queue — the cancel raced
        the enqueue; the caller treats the entry as dead so a later
        enqueue of it is skipped at pick time."""
        q = self._tq.get(tenant)
        if q is None:
            return False
        try:
            q.remove(entry)
        except ValueError:
            return False
        self._depth -= 1
        return True

    def enqueue(self, tenant: str, entry: str, front: bool = False) -> None:
        q = self._tq.get(tenant)
        if q is None:
            q = self._tq[tenant] = collections.deque()
        if not q and tenant not in self._ring:
            self._ring.append(tenant)
        (q.appendleft if front else q.append)(entry)
        self._depth += 1

    def pick(self, live=None) -> "tuple[str, str] | None":
        """Next ``(tenant, entry)`` under DRR, or None when everything
        is drained.  ``live`` (optional predicate) skips dead entries —
        a job cancelled while queued keeps its queue slot but must not
        be picked; the skip still consumes the slot, exactly like the
        live dispatcher."""
        guard = 0
        while self._ring:
            guard += 1
            if guard > 100_000:  # pure defense; unreachable for w > 0
                break
            tenant = self._ring[0]
            q = self._tq.get(tenant)
            if not q:
                self._ring.popleft()
                self._deficit[tenant] = 0.0
                continue
            if self._deficit.get(tenant, 0.0) < 1.0:
                # bank one quantum per ring visit; a sub-1 balance
                # means this visit buys nothing yet — move on (a
                # low-weight tenant is served every ceil(1/w) rotations)
                self._deficit[tenant] = (
                    self._deficit.get(tenant, 0.0) + self.weight(tenant)
                )
                if self._deficit[tenant] < 1.0:
                    self._ring.rotate(-1)
                    continue
            self._deficit[tenant] -= 1.0
            entry = q.popleft()
            self._depth -= 1
            if not q:
                # an emptied queue leaves the ring (and forfeits its
                # bank — DRR's anti-burst rule)
                self._ring.popleft()
                self._deficit[tenant] = 0.0
            elif self._deficit[tenant] < 1.0:
                # the visit's bank is spent: rotate so the NEXT pick
                # serves the next tenant (without this, a weight-1
                # tenant would re-bank on the same visit and be served
                # continuously — the exact starvation DRR prevents)
                self._ring.rotate(-1)
            if live is not None and not live(entry):
                continue
            return tenant, entry
        return None


def choose_replica(
    candidates: "list[tuple[str, int, bool]]", affinity: bool
) -> "tuple[str | None, bool]":
    """Warm-affinity replica choice over routable candidates.

    ``candidates`` is ``[(rid, inflight, warm), ...]`` — the already
    health/backoff/inflight-filtered routable set, with ``warm`` true
    when the replica holds the job's affinity key.  Returns
    ``(rid, warm)``: the least-loaded warm candidate when affinity is
    on and any is warm, else the least-loaded overall; ties break on
    rid, so the choice is a pure function of its arguments (the replay
    simulator's requirement).
    """
    if not candidates:
        return None, False
    if affinity:
        warm = [c for c in candidates if c[2]]
        if warm:
            warm.sort(key=lambda c: (c[1], c[0]))
            return warm[0][0], True
    ranked = sorted(candidates, key=lambda c: (c[1], c[0]))
    return ranked[0][0], False


class DecisionLog:
    """Append-only JSONL recorder for router decision inputs+outputs.

    One record per line, each carrying ``seq`` (a per-log monotone
    ordinal — the replay compares streams in seq order) and ``kind``:

    * ``config`` — the first record: the autoscaler parameters, tenant
      weights and affinity flag a replay needs to rebuild the pure
      state machines;
    * ``autoscale`` — one ``scale_tick``: the ``(burn, queue_depth,
      replicas, now)`` inputs and the ``decision`` output;
    * ``enqueue`` / ``remove`` — DRR input stream (``remove`` marks a
      cancel-while-queued: the entry stays in its queue and the replay
      must skip it exactly like the live pick loop);
    * ``pick`` — one DRR output: the ``(tenant, job_id)`` served;
    * ``choose`` — one replica choice: the routable ``candidates``
      snapshot, the ``affinity`` flag and the ``chosen`` rid.

    Writes are line-atomic (single ``write`` on an O_APPEND handle,
    the EventLog discipline) and serialized by a lock.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fd = os.open(
            path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644
        )
        self._lock = threading.Lock()
        self._seq = 0

    def record(self, kind: str, **fields) -> None:
        with self._lock:
            rec = {"seq": self._seq, "kind": kind, **fields}
            self._seq += 1
            # the lock serializes the one O_APPEND write: one atomic JSON line per
            # record is the log's durability contract (tens of bytes a line)
            # lt: noqa[LT007]
            os.write(
                self._fd,
                (json.dumps(rec, sort_keys=True) + "\n").encode(),
            )

    def close(self) -> None:
        with self._lock:
            if self._fd >= 0:
                os.close(self._fd)
                self._fd = -1


def read_decisions(path: str) -> "tuple[dict, list[dict]]":
    """Load one decision log → ``(config, records)`` in seq order.
    Torn tail lines (a SIGKILLed router) are dropped, mid-stream torn
    lines are an error — the log is append-only, so only the last line
    can legitimately be incomplete."""
    recs: "list[dict]" = []
    config: dict = {}
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            if i == len(lines) - 1:
                break  # torn tail: the crash-consistency contract
            raise ValueError(f"{path}:{i + 1}: torn mid-stream record")
        if rec.get("kind") == "config":
            config = rec
        else:
            recs.append(rec)
    recs.sort(key=lambda r: r.get("seq", 0))
    return config, recs
