"""Write-ahead admission journal: the router's crash-durable job table.

The ``FleetRouter`` keeps its tenant queues and in-flight job table in
memory; this module makes the *admission contract* survive control-plane
death.  Every accepted job appends an ``admitted`` record (full request
payload, trace id, idempotency key) BEFORE the client sees 200, with
``forwarded`` (replica base + replica job id) and ``terminal`` records
following as the job moves.  On restart the router replays the journal to
rebuild its queues in admission order and reconciles every non-terminal
job against its replica (see ``fleet/router.py``).

Durability discipline (the DecisionLog / manifest idiom):

- append-only JSONL segments (``seg-%08d.jsonl``), each record committed
  as ONE ``os.write`` on an ``O_APPEND`` fd — a crash can tear only the
  final line, never interleave two records;
- torn-tail GC at reopen: a half-written LAST line of the LAST segment is
  dropped (tmp + ``os.replace`` rewrite); garbage anywhere else is real
  corruption and raises ``JournalError`` instead of silently losing jobs;
- rotation at ``segment_bytes`` with prefix-only compaction: the oldest
  segments whose every referenced job has a ``terminal`` record anywhere
  in the journal are unlinked — replay cost stays bounded by the live
  working set, not by router uptime;
- a clean-shutdown marker (tmp + ``os.replace``) written after a full
  drain lets the next start skip reconciliation probes; it is consumed
  (removed) at reopen so only an *uninterrupted* drain counts.

Fault seam: every append fires ``router.journal`` first, so the soak can
pin the failure-semantics decision — an append failure must fail that
admission loudly (503 ``journal_error``) rather than accept an un-durable
job.
"""

from __future__ import annotations

import json
import os
import threading
import time

from land_trendr_tpu_torch.runtime import faults as _faults

__all__ = ["AdmissionJournal", "JournalError", "RECORD_KINDS"]

#: the record vocabulary; unknown kinds replay as no-ops (forward compat)
RECORD_KINDS = ("admitted", "forwarded", "terminal")

_SEG_PREFIX = "seg-"
_SEG_SUFFIX = ".jsonl"
_CLEAN_MARKER = "clean"


class JournalError(Exception):
    """An append could not be committed (or the journal is corrupt).

    The router maps this to a 503 ``journal_error`` rejection: a job the
    journal cannot make durable is never admitted.
    """


def _seg_name(index: int) -> str:
    return f"{_SEG_PREFIX}{index:08d}{_SEG_SUFFIX}"


def _seg_index(name: str) -> "int | None":
    if not (name.startswith(_SEG_PREFIX) and name.endswith(_SEG_SUFFIX)):
        return None
    body = name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)]
    return int(body) if body.isdigit() else None


class AdmissionJournal:
    """Append-only, segment-rotated, crash-tolerant admission journal.

    Thread-safe: appends serialise on an internal lock (the commit is a
    single ``os.write`` regardless).  ``replay()`` folds the full journal
    into per-job state in admission order; ``compact()`` drops the
    fully-terminal segment prefix.
    """

    def __init__(self, root: str, segment_bytes: int = 4 * 2 ** 20):
        self.root = root
        self._segment_bytes = max(int(segment_bytes), 64 * 1024)
        self._lock = threading.Lock()
        self._faults = _faults
        self._fd: "int | None" = None
        self._seg = 0          # active segment index
        self._seg_size = 0     # bytes in the active segment
        self.appends = 0
        os.makedirs(root, exist_ok=True)
        marker = os.path.join(root, _CLEAN_MARKER)
        #: True iff the previous process drained fully and wrote the
        #: marker; consumed here so only an uninterrupted drain counts
        self.was_clean = os.path.exists(marker)
        if self.was_clean:
            os.remove(marker)
        segs = self._segments()
        if segs:
            self._gc_torn_tail(segs[-1])
        self._seg = segs[-1] if segs else 1
        with self._lock:
            self._open_segment_locked()

    # -- segment bookkeeping ---------------------------------------------

    def _segments(self) -> "list[int]":
        out = []
        for name in os.listdir(self.root):
            idx = _seg_index(name)
            if idx is not None:
                out.append(idx)
        return sorted(out)

    def _seg_path(self, index: int) -> str:
        return os.path.join(self.root, _seg_name(index))

    def _open_segment_locked(self) -> None:
        path = self._seg_path(self._seg)
        self._fd = os.open(
            path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644
        )
        self._seg_size = os.fstat(self._fd).st_size

    def _gc_torn_tail(self, index: int) -> None:
        """Drop a half-written final line of the last segment (the only
        damage a crash can inflict on an O_APPEND line-commit journal).
        Garbage anywhere earlier is NOT crash residue — raise."""
        path = self._seg_path(index)
        with open(path, "rb") as f:
            raw = f.read()
        if not raw:
            return
        lines = raw.split(b"\n")
        torn = lines.pop()  # b"" when the file ends with a newline
        good = len(raw) - len(torn)
        for i, line in enumerate(lines):
            if not line:
                continue
            try:
                json.loads(line)
            except ValueError:
                if i == len(lines) - 1 and not torn:
                    # invalid FINAL committed line: a torn write that
                    # happened to end at a newline boundary — droppable
                    good -= len(line) + 1
                    torn = line
                else:
                    raise JournalError(
                        f"corrupt journal segment {_seg_name(index)} "
                        f"line {i + 1}: not crash residue"
                    )
        if not torn:
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(raw[:good])
        os.replace(tmp, path)

    def _read_segment(self, index: int) -> "list[dict]":
        """Parse one segment; only the LAST segment tolerates a torn
        tail (rotated segments ended on a committed line by
        construction)."""
        last = index == self._seg
        out: "list[dict]" = []
        with open(self._seg_path(index), "rb") as f:
            lines = f.read().split(b"\n")
        for i, line in enumerate(lines):
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                if last and i == len(lines) - 1:
                    break  # torn tail: drop the half-written record
                raise JournalError(
                    f"corrupt journal segment {_seg_name(index)} "
                    f"line {i + 1}"
                )
        return out

    # -- append path ------------------------------------------------------

    def append(self, rec: str, job_id: str, **fields) -> "tuple[int, int]":
        """Durably commit one record; returns ``(segment, bytes)``.

        Fires the ``router.journal`` seam first.  Any failure — seam, fd,
        ENOSPC — surfaces as ``JournalError``: the caller must NOT treat
        the record as written.
        """
        payload = {"rec": rec, "job_id": job_id}
        payload.update(fields)
        line = (json.dumps(payload, separators=(",", ":")) + "\n").encode()
        try:
            with self._lock:
                self._faults.check("router.journal")
                if self._fd is None:
                    raise JournalError("journal is closed")
                if self._seg_size >= self._segment_bytes:
                    # replay and compaction need a quiescent segment set: an interleaved
                    # append could land in a segment being removed and lose an admission;
                    # both run off the dispatch path (startup, rotation, recovery)
                    # lt: noqa[LT007]
                    self._rotate_locked()
                # the lock serializes the one O_APPEND write: one atomic JSON line per
                # record is the log's durability contract (tens of bytes a line)
                # lt: noqa[LT007]
                n = os.write(self._fd, line)
                if n != len(line):
                    raise JournalError(
                        f"short journal write ({n}/{len(line)} bytes)"
                    )
                self._seg_size += n
                self.appends += 1
                return self._seg, n
        except JournalError:
            raise
        except Exception as e:
            raise JournalError(f"journal append failed: {e}") from e

    def _rotate_locked(self) -> None:
        os.close(self._fd)
        self._seg += 1
        self._open_segment_locked()
        # replay and compaction need a quiescent segment set: an interleaved
        # append could land in a segment being removed and lose an admission;
        # both run off the dispatch path (startup, rotation, recovery)
        # lt: noqa[LT007]
        self._compact_locked()

    # -- replay / compaction ---------------------------------------------

    def replay(self) -> "dict[str, dict]":
        """Fold the journal into per-job state, in admission order.

        Returns ``{job_id: state}`` where ``state`` carries the original
        ``admitted`` fields plus ``status`` (``admitted`` | ``forwarded``
        | ``terminal``) and, when present, ``replica_base`` /
        ``replica_job_id`` / ``state`` / ``error``.  Records for jobs
        whose ``admitted`` segment was compacted away fold as no-ops.
        """
        with self._lock:
            # replay and compaction need a quiescent segment set: an interleaved
            # append could land in a segment being removed and lose an admission;
            # both run off the dispatch path (startup, rotation, recovery)
            # lt: noqa[LT007]
            return self._replay_locked()

    def _replay_locked(self) -> "dict[str, dict]":
        jobs: "dict[str, dict]" = {}
        for index in self._segments():
            # replay and compaction need a quiescent segment set: an interleaved
            # append could land in a segment being removed and lose an admission;
            # both run off the dispatch path (startup, rotation, recovery)
            # lt: noqa[LT007]
            for rec in self._read_segment(index):
                kind = rec.get("rec")
                jid = rec.get("job_id")
                if not isinstance(jid, str):
                    continue
                if kind == "admitted":
                    state = dict(rec)
                    state["status"] = "admitted"
                    jobs[jid] = state
                elif kind == "forwarded":
                    j = jobs.get(jid)
                    if j is not None and j["status"] != "terminal":
                        j["status"] = "forwarded"
                        j["replica_base"] = rec.get("replica_base")
                        j["replica_job_id"] = rec.get("replica_job_id")
                elif kind == "terminal":
                    j = jobs.get(jid)
                    if j is not None:
                        j["status"] = "terminal"
                        j["state"] = rec.get("state")
                        j["error"] = rec.get("error")
        return jobs

    def compact(self) -> int:
        """Unlink the longest prefix of segments whose every referenced
        job is terminal somewhere in the journal; returns the count
        dropped.  Prefix-only: a surviving older segment keeps every
        newer one too, so replay order is never reordered."""
        with self._lock:
            # compaction needs a quiescent segment set: an interleaved
            # append could land in a segment being removed
            # lt: noqa[LT007]
            return self._compact_locked()

    def _compact_locked(self) -> int:
        # replay and compaction need a quiescent segment set: an interleaved
        # append could land in a segment being removed and lose an admission;
        # both run off the dispatch path (startup, rotation, recovery)
        # lt: noqa[LT007]
        folded = self._replay_locked()
        terminal = {
            jid for jid, j in folded.items() if j["status"] == "terminal"
        }
        dropped = 0
        for index in self._segments():
            if index == self._seg:
                break  # never the active segment
            refs = {
                rec.get("job_id")
                # replay and compaction need a quiescent segment set: an interleaved
                # append could land in a segment being removed and lose an admission;
                # both run off the dispatch path (startup, rotation, recovery)
                # lt: noqa[LT007]
                for rec in self._read_segment(index)
                if isinstance(rec.get("job_id"), str)
            }
            # jobs admitted in an already-dropped segment fold to nothing;
            # their trailing records are equally dead
            live = {j for j in refs if j in folded and j not in terminal}
            if live:
                break
            os.remove(self._seg_path(index))
            dropped += 1
        return dropped

    # -- lifecycle ---------------------------------------------------------

    def mark_clean(self) -> None:
        """Record a fully-drained shutdown so the next start can skip
        reconciliation probes.  tmp + rename: the marker either exists
        completely or not at all."""
        path = os.path.join(self.root, _CLEAN_MARKER)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump({"t": time.time()}, f)
        os.replace(tmp, path)

    def stats(self) -> dict:
        with self._lock:
            segs = self._segments()
            return {
                "segments": len(segs),
                "segment": self._seg,
                "bytes": self._seg_size,
                "appends": self.appends,
            }

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                os.close(self._fd)
                self._fd = None
