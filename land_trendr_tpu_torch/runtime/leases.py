"""Elastic tile lease queue over the shared-filesystem manifest.

Counterpart of ``land_trendr_tpu/runtime/leases.py``, kept identical in
protocol: the same record kinds and keys, the same ``host:pid:token``
owner identity and the same first-writer-wins rule, so processes of both
packages can share one manifest and agree on every claim.

A static split hands each process its
:func:`~land_trendr_tpu_torch.parallel.host_share` of the tile list, so one
slow or dead host strands its whole share.  This module replaces the split
with a **lease queue** coordinated through the one piece of shared state
the pod already trusts: the append-only tile manifest on the shared
filesystem.

Protocol (append-only records in ``manifest.jsonl``; every append is one
``os.write`` on an ``O_APPEND`` descriptor, atomic per line like the
event log, so all readers agree on ONE record order):

* ``kind="lease"`` — a claim on ``tile_id`` at generation ``gen`` by
  ``owner`` (a ``host:pid:token`` identity — a restarted process is a
  NEW generation of the same host, never a resumed owner), carrying
  ``ttl_s`` and ``t_wall``.  **Log order is the arbiter**: for each
  ``(tile, gen)`` the FIRST lease record in the file wins; later records
  at the same generation lost the race and their writers observe that on
  re-read.  A further record from the *winning* owner at the same
  generation is a **renewal** — it pushes the expiry to its own
  ``t_wall + ttl_s``.
* ``kind="lease_release"`` — the owner relinquishes an unfinished claim
  (abort/cancel unwind), making the tile immediately claimable at the
  next generation instead of after a TTL.
* ``kind="lease_flag"`` — the owner's live
  :class:`~land_trendr_tpu_torch.obs.spans.StragglerDetector` flagged the tile
  while in flight: an advertisement that idle peers may *speculatively*
  re-lease it (generation + 1) even though the lease has not expired.
* ``kind="tile"`` (the existing done record) stays the ONE durability
  signal: it supersedes every lease.  ``kind="tile_failed"`` appended
  DURING this run marks the tile quarantined run-wide (a resume
  re-attempts it, exactly as before — historical failure records from a
  previous scope do not block claims).

Safety does **not** depend on the lease: a lost/duplicated lease record
at worst re-executes a tile, and the tile artifact path is already
idempotent — deterministic bytes through an atomic tmp+rename, with the
done-record set deduplicated at :meth:`TileManifest.open`.  So an
expired-lease steal racing an owner that was merely slow (not dead), or
a speculative duplicate of a straggler, both resolve to byte-identical
artifacts; the first durable done record is the winner for accounting
(``spec_wins``) and the loser's write lands as an identical no-op.
Clocks: expiry compares the reader's ``time.time()`` against the
record's ``t_wall + ttl_s``, so the TTL must comfortably exceed both the
slowest tile and the pod's worst wall-clock skew (the default 30s does,
for NTP-disciplined fleets; it is a throughput knob, never a correctness
one).

Thread-safety: driver thread (acquire/renew/release) plus the flight
sampler thread (:meth:`flag`, via the straggler callback).  The internal
lock guards pure state only — file reads and appends happen outside it,
so a slow shared filesystem never blocks a lock holder (LT007).
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
import time
import uuid
from typing import Iterable

from land_trendr_tpu_torch.runtime import faults

__all__ = ["Lease", "LeaseQueue"]

log = logging.getLogger("land_trendr_tpu_torch.runtime.leases")

#: acquisition modes, as recorded in the lease record's ``mode`` field
#: and returned by :meth:`LeaseQueue.acquire`
MODES = ("claim", "steal", "spec", "renew")


class Lease:
    """The current (highest-generation, first-writer) lease of one tile.

    ``prev_owner`` is the owner a successor generation displaced (None at
    generation 0) — the ``from_owner`` attribution steal/speculation
    events carry.
    """

    __slots__ = (
        "gen", "owner", "expiry", "mode", "flagged", "released",
        "prev_owner",
    )

    def __init__(
        self,
        gen: int,
        owner: str,
        expiry: float,
        mode: str,
        prev_owner: "str | None" = None,
    ) -> None:
        self.gen = gen
        self.owner = owner
        self.expiry = expiry
        self.mode = mode
        self.flagged = False
        self.released = False
        self.prev_owner = prev_owner


class LeaseQueue:
    """One process's view of (and hand in) the shared tile lease log.

    ``done0`` is the artifact-verified done set from
    :meth:`TileManifest.open` — historical ``kind="tile"`` records (those
    already in the file at construction) are trusted only when their
    artifact verified, so a torn-artifact resume recomputes exactly what
    the manifest's own readability check said to recompute.  Records
    appended after construction are this run's live traffic and are
    trusted as written.
    """

    def __init__(
        self,
        path: str,
        tile_ids: Iterable[int],
        *,
        ttl_s: float = 30.0,
        done0: "set[int] | None" = None,
        owner: "str | None" = None,
    ) -> None:
        if ttl_s <= 0:
            raise ValueError(f"ttl_s={ttl_s} must be > 0")
        self.path = path
        self.ttl_s = float(ttl_s)
        #: (host, pid, generation) identity: the uuid token IS the
        #: process generation — a restarted pid can never impersonate
        #: its predecessor's leases
        self.owner = (
            owner
            if owner is not None
            else f"{socket.gethostname()}:{os.getpid()}:{uuid.uuid4().hex[:8]}"
        )
        self._all = set(int(t) for t in tile_ids)
        self._lock = threading.Lock()
        self._leases: "dict[int, Lease]" = {}
        self._done: "set[int]" = set(done0 or ())
        self._failed: "set[int]" = set()
        self._held: "set[int]" = set()
        self._my_spec: "set[int]" = set()
        self._first_done_owner: "dict[int, str | None]" = {}
        self._offset = 0
        self._partial = b""
        self._bootstrapped = False
        self._boot_done0 = set(done0 or ())
        self._last_renew = 0.0
        self._malformed = 0
        self._stats = {
            "acquired": 0, "stolen": 0, "speculated": 0,
            "renewals": 0, "released": 0, "flags": 0,
        }
        # bootstrap NOW, not at the first acquire: the historical/live
        # trust boundary must sit at construction (as documented above),
        # or sibling done records appended during this process's warmup
        # would be misread as unverified history and re-executed
        self.refresh()

    # -- log I/O (always OUTSIDE the state lock) ---------------------------
    def _append(self, records: "list[dict]") -> None:
        """Append records, one atomic ``os.write`` per line (the same
        per-line atomicity contract the event log and the manifest's own
        appends rely on)."""
        if not records:
            return
        fd = os.open(self.path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
        try:
            for rec in records:
                os.write(
                    fd, (json.dumps(rec, separators=(",", ":")) + "\n").encode()
                )
        finally:
            os.close(fd)

    def _read_new(self) -> "list[dict]":
        """Read and parse every COMPLETE line appended since the last
        read.  A trailing fragment (a peer's append in progress) is
        carried to the next read; a complete line that does not parse —
        a torn tail later buried by further appends — is skipped and
        counted, never fatal (the blockstore GC's tolerant-reader
        posture; a lost done record at worst re-executes an idempotent
        tile)."""
        try:
            size = os.path.getsize(self.path)
        except OSError:
            return []
        if size < self._offset:
            # the manifest was rewritten under us (resume=False races are
            # documented single-process; be safe, re-read from scratch)
            self._offset = 0
            self._partial = b""
        if size <= self._offset:
            return []
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            data = f.read()
        self._offset += len(data)
        buf = self._partial + data
        lines = buf.split(b"\n")
        self._partial = lines.pop()
        out: "list[dict]" = []
        for ln in lines:
            ln = ln.strip()
            if not ln:
                continue
            try:
                rec = json.loads(ln)
            except ValueError:
                self._malformed += 1
                continue
            if isinstance(rec, dict):
                out.append(rec)
            else:
                self._malformed += 1
        return out

    # -- state fold (under the lock; pure) ---------------------------------
    def _apply_locked(self, records: "list[dict]", bootstrap: bool) -> None:
        for rec in records:
            kind = rec.get("kind")
            try:
                if kind == "tile":
                    tid = int(rec["tile_id"])
                    if bootstrap and tid not in self._boot_done0:
                        # historical record whose artifact did NOT verify
                        # (torn-artifact resume): the tile recomputes
                        continue
                    if tid not in self._first_done_owner:
                        self._first_done_owner[tid] = rec.get("owner")
                    self._done.add(tid)
                    self._held.discard(tid)
                elif kind == "lease":
                    tid, gen = int(rec["tile_id"]), int(rec["gen"])
                    owner = str(rec.get("owner", ""))
                    expiry = float(rec.get("t_wall", 0.0)) + float(
                        rec.get("ttl_s", self.ttl_s)
                    )
                    cur = self._leases.get(tid)
                    if cur is None or gen > cur.gen:
                        self._leases[tid] = Lease(
                            gen, owner, expiry, str(rec.get("mode", "claim")),
                            prev_owner=cur.owner if cur is not None else None,
                        )
                    elif gen == cur.gen and owner == cur.owner:
                        # renewal from the winning owner
                        cur.expiry = max(cur.expiry, expiry)
                    # same-gen different-owner: a lost race, ignored
                elif kind == "lease_release":
                    tid, gen = int(rec["tile_id"]), int(rec["gen"])
                    cur = self._leases.get(tid)
                    if (
                        cur is not None
                        and cur.gen == gen
                        and cur.owner == rec.get("owner")
                    ):
                        cur.released = True
                elif kind == "lease_flag":
                    tid, gen = int(rec["tile_id"]), int(rec["gen"])
                    cur = self._leases.get(tid)
                    if cur is not None and cur.gen == gen:
                        cur.flagged = True
                elif kind == "tile_failed":
                    if not bootstrap:
                        # quarantined DURING this run: terminal run-wide
                        # (a resume re-attempts it — historical failures
                        # never block a fresh scope's claims)
                        tid = int(rec["tile_id"])
                        self._failed.add(tid)
                        self._held.discard(tid)
            except (KeyError, TypeError, ValueError):
                self._malformed += 1

    def refresh(self) -> None:
        """Fold newly-appended records into this process's view."""
        bootstrap = not self._bootstrapped
        records = self._read_new()
        with self._lock:
            self._apply_locked(records, bootstrap)
        self._bootstrapped = True

    # -- claims ------------------------------------------------------------
    def _claimable_locked(
        self, now: float, speculate: bool
    ) -> "tuple[list[tuple[int, str, int]], list[tuple[int, int]]]":
        """Candidates ``(tile, mode, next_gen)`` in priority order —
        never-leased first, then released/expired (steals), then (only
        when asked) flagged unexpired foreign leases (speculation) —
        plus the ``blocked`` list of live foreign leases, which the
        caller runs past the ``lease.expire`` fault seam (a firing
        invocation forces that lease to read as expired, so soaks drive
        the steal-while-owner-lives double-execution race on demand)."""
        fresh: "list[tuple[int, str, int]]" = []
        steals: "list[tuple[int, str, int]]" = []
        specs: "list[tuple[int, str, int]]" = []
        blocked: "list[tuple[int, int]]" = []
        for tid in sorted(self._all - self._done - self._failed - self._held):
            cur = self._leases.get(tid)
            if cur is None:
                fresh.append((tid, "claim", 0))
            elif cur.owner == self.owner:
                # our own lease outside _held: a claim we lost track of
                # (e.g. after an abort); reclaimable once released/expired
                if cur.released or now > cur.expiry:
                    steals.append((tid, "steal", cur.gen + 1))
            elif cur.released:
                fresh.append((tid, "claim", cur.gen + 1))
            elif now > cur.expiry:
                steals.append((tid, "steal", cur.gen + 1))
            else:
                if speculate and cur.flagged:
                    specs.append((tid, "spec", cur.gen + 1))
                blocked.append((tid, cur.gen))
        return fresh + steals + specs, blocked

    def acquire(
        self, n: int, speculate: bool = False
    ) -> "list[tuple[int, str, Lease]]":
        """Claim up to ``n`` tiles; returns the claims WON as
        ``(tile_id, mode, lease)`` — mode ``"claim"`` (never leased, or
        cleanly released), ``"steal"`` (TTL-expired lease of a dead or
        wedged peer), or ``"spec"`` (speculative duplicate of a flagged
        straggler; at most one per call, and only when nothing else was
        claimable).  Raises ``OSError``/``RuntimeError`` on the
        ``lease.acquire`` / ``lease.steal`` fault seams or a genuinely
        failing shared filesystem — callers back off and retry, the run
        does not die with the filesystem blip."""
        faults.check("lease.acquire")
        self.refresh()
        now = time.time()
        with self._lock:
            candidates, blocked = self._claimable_locked(now, speculate)
        # the lease.expire behavioral seam: a firing invocation forces a
        # live foreign lease to read as expired — the deterministic
        # steal-under-a-living-owner soak (first durable write wins,
        # artifacts byte-identical).  Checked OUTSIDE the state lock, in
        # tile order, so invocation indices replay across runs.
        forced = [
            (tid, "steal", gen + 1)
            for tid, gen in blocked
            if faults.fired("lease.expire")
        ]
        if forced:
            # forced steals outrank speculation, exactly like real expiries
            forced_ids = {t for t, _, _ in forced}
            regular = [
                c for c in candidates
                if c[1] != "spec" and c[0] not in forced_ids
            ]
            specs = [
                c for c in candidates
                if c[1] == "spec" and c[0] not in forced_ids
            ]
            candidates = regular + forced + specs
        picked: "list[tuple[int, str, int]]" = []
        for tid, mode, gen in candidates:
            if mode == "spec":
                # duplicate work is a targeted tool, not a firehose: one
                # speculative claim per acquisition, and only for an
                # otherwise-idle host (nothing regular was claimable)
                if picked:
                    continue
            picked.append((tid, mode, gen))
            if len(picked) >= max(n, 1):
                break
        if not picked:
            return []
        if any(mode == "steal" for _, mode, _ in picked):
            faults.check("lease.steal")
        t_wall = time.time()
        self._append(
            [
                {
                    "kind": "lease",
                    "tile_id": tid,
                    "gen": gen,
                    "owner": self.owner,
                    "host": socket.gethostname(),
                    "pid": os.getpid(),
                    "ttl_s": self.ttl_s,
                    "t_wall": t_wall,
                    "mode": mode,
                }
                for tid, mode, gen in picked
            ]
        )
        self.refresh()
        won: "list[tuple[int, str, Lease]]" = []
        with self._lock:
            for tid, mode, gen in picked:
                cur = self._leases.get(tid)
                if (
                    cur is not None
                    and cur.gen == gen
                    and cur.owner == self.owner
                    and tid not in self._done
                    and tid not in self._failed
                ):
                    self._held.add(tid)
                    if mode == "spec":
                        self._my_spec.add(tid)
                    won.append((tid, mode, cur))
            self._stats["acquired"] += len(won)
            self._stats["stolen"] += sum(1 for _, m, _ in won if m == "steal")
            self._stats["speculated"] += sum(
                1 for _, m, _ in won if m == "spec"
            )
        return won

    def renew(self, min_interval: "float | None" = None) -> int:
        """Extend held, unfinished leases (rate-limited to ``ttl/3`` by
        default).  Returns the number of renewal records appended.  A
        failed renewal is logged and retried next tick — the worst case
        is a sibling stealing a tile we then both finish, byte-identically."""
        interval = self.ttl_s / 3.0 if min_interval is None else min_interval
        now = time.monotonic()
        if now - self._last_renew < interval:
            return 0
        self._last_renew = now
        with self._lock:
            held = sorted(self._held - self._done - self._failed)
            gens = {
                t: self._leases[t].gen for t in held if t in self._leases
            }
        if not held:
            return 0
        t_wall = time.time()
        try:
            self._append(
                [
                    {
                        "kind": "lease",
                        "tile_id": t,
                        "gen": gens.get(t, 0),
                        "owner": self.owner,
                        "ttl_s": self.ttl_s,
                        "t_wall": t_wall,
                        "mode": "renew",
                    }
                    for t in held
                ]
            )
        except OSError as e:
            log.warning("lease renewal append failed (%s); will retry", e)
            return 0
        with self._lock:
            for t in held:
                cur = self._leases.get(t)
                if cur is not None and cur.owner == self.owner:
                    cur.expiry = max(cur.expiry, t_wall + self.ttl_s)
            self._stats["renewals"] += len(held)
        return len(held)

    def flag(self, tile_id: int) -> bool:
        """Advertise a held tile as a straggler (the StragglerDetector
        verdict hook): idle peers may then speculatively re-lease it.
        Safe from any thread; returns True when the flag was appended."""
        with self._lock:
            if tile_id not in self._held or tile_id in self._done:
                return False
            cur = self._leases.get(tile_id)
            gen = cur.gen if cur is not None and cur.owner == self.owner else 0
        self._append(
            [
                {
                    "kind": "lease_flag",
                    "tile_id": int(tile_id),
                    "gen": gen,
                    "owner": self.owner,
                    "t_wall": time.time(),
                }
            ]
        )
        with self._lock:
            cur = self._leases.get(tile_id)
            if cur is not None and cur.gen == gen:
                cur.flagged = True
            self._stats["flags"] += 1
        return True

    def release_held(self, reason: str = "released") -> int:
        """Relinquish every held, unfinished lease (abort/cancel unwind):
        siblings may claim immediately instead of waiting out the TTL.
        Best-effort — a failed release just means TTL-paced stealing."""
        with self._lock:
            held = sorted(self._held - self._done)
            gens = {
                t: self._leases[t].gen for t in held if t in self._leases
            }
            self._held.clear()
        if not held:
            return 0
        try:
            self._append(
                [
                    {
                        "kind": "lease_release",
                        "tile_id": t,
                        "gen": gens.get(t, 0),
                        "owner": self.owner,
                        "t_wall": time.time(),
                        "reason": reason,
                    }
                    for t in held
                ]
            )
        except OSError as e:
            log.warning(
                "lease release append failed (%s); peers steal after TTL", e
            )
            return 0
        with self._lock:
            self._stats["released"] += len(held)
        return len(held)

    # -- run state ---------------------------------------------------------
    def run_complete(self) -> bool:
        """True once every tile is durably done (or quarantined this
        run) — the elastic loop's exit condition."""
        self.refresh()
        with self._lock:
            return not (self._all - self._done - self._failed)

    def undone(self) -> "set[int]":
        with self._lock:
            return set(self._all - self._done - self._failed)

    def held(self) -> "set[int]":
        with self._lock:
            return set(self._held)

    def stats(self) -> dict:
        """Point-in-time lease counters (plus the speculative-win count:
        tiles WE speculated whose first durable done record is ours)."""
        with self._lock:
            wins = sum(
                1
                for t in self._my_spec
                if self._first_done_owner.get(t) == self.owner
            )
            return {
                **self._stats,
                "spec_wins": wins,
                "held": len(self._held),
                "done": len(self._done),
                "failed": len(self._failed),
                "malformed_lines": self._malformed,
            }
