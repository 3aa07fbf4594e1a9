"""Fleet telemetry history: a bounded on-disk time-series ring.

The **history** quarter of the fleet telemetry plane: the aggregate
layer produces an instantaneous pod view, but ``rate()``, queue-wait
trends and SLO burn rates need values **over a window** — so the fleet
loop appends one flattened :func:`~land_trendr_tpu_torch.obs.aggregate.
pod_sample` per beat into this ring, and the alert engine / ``lt_fleet``
read windows back out.

Storage follows the blockstore discipline, scaled down to JSONL:

* **append-only segments** — samples append as single ``os.write``
  JSONL lines (atomic ``O_APPEND``, the event-log contract) to one live
  ``*.open.jsonl`` file;
* **tmp-free rename commit** — at ``samples_per_segment`` the live file
  is atomically renamed to its committed ``hist-*.jsonl`` name (the
  rename IS the commit point; an ``.open`` file is by definition the
  possibly-torn tail of a live or crashed writer);
* **whole-oldest-segment eviction** — when committed bytes exceed the
  budget the oldest segment is unlinked whole, never rewritten;
* **reopen-after-crash GC** — opening a ring adopts a STALE ``.open``
  leftover (a crashed writer's tail: parseable lines are committed, a
  torn final line is dropped and counted) and removes stale tmps, while
  a FRESH ``.open`` from another live pid in a shared dir is left
  alone, exactly like the blockstore's orphan rules.

Single-owner by contract: one fleet loop owns :meth:`append` /
:meth:`close` (the serve loop stops its thread before closing), so the
hot path carries no lock; readers — other processes included — only
ever see committed segments plus an append-only live file, both safe to
read concurrently.  The ``history.append`` fault seam fires at the top
of :meth:`append` (via the same registered-plan hook as
``obs.publish``), and callers treat a raised append as one lost sample,
never a corrupted ring.  Stdlib-only, jax-free.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any

from land_trendr_tpu_torch.obs.publish import fault_check

__all__ = ["HistoryRing", "counter_rate", "latest_value"]

#: an ``.open`` segment untouched this long belongs to a dead writer
#: (live loops beat every few seconds) — adopt it at open
_STALE_OPEN_S = 60.0


class HistoryRing:
    """Bounded on-disk ring of JSON samples (see the module docstring)."""

    def __init__(
        self,
        directory: str,
        budget_bytes: int = 4 << 20,
        samples_per_segment: int = 256,
    ) -> None:
        if budget_bytes < 1:
            raise ValueError(f"budget_bytes={budget_bytes} must be >= 1")
        if samples_per_segment < 1:
            raise ValueError(
                f"samples_per_segment={samples_per_segment} must be >= 1"
            )
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.budget_bytes = int(budget_bytes)
        self.samples_per_segment = int(samples_per_segment)
        self.adopted_segments = 0
        self.dropped_torn_lines = 0
        self._gc_open()
        self._fd: "int | None" = None
        self._open_path: "str | None" = None
        self._open_count = 0
        self._closed = False

    # -- open-time GC ------------------------------------------------------
    def _gc_open(self) -> None:
        now = time.time()
        for tmp in glob.glob(os.path.join(self.directory, "*.tmp")):
            try:
                if now - os.path.getmtime(tmp) > _STALE_OPEN_S:
                    os.unlink(tmp)
            except OSError:
                pass
        for left in glob.glob(os.path.join(self.directory, "*.open.jsonl")):
            try:
                age = now - os.path.getmtime(left)
            except OSError:
                continue
            if age <= _STALE_OPEN_S:
                continue  # a live sibling's tail in a shared dir: not ours
            self._adopt(left)

    def _adopt(self, open_path: str) -> None:
        """Commit a crashed writer's ``.open`` tail: keep every parseable
        line, drop (and count) a torn final line, rename to the committed
        name — or remove an empty/unreadable leftover."""
        good: list = []
        torn = 0
        try:
            with open(open_path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        json.loads(line)
                        good.append(line)
                    except json.JSONDecodeError:
                        torn += 1
        except OSError:
            return
        self.dropped_torn_lines += torn
        try:
            if not good:
                os.unlink(open_path)
                return
            if torn:
                # rewrite without the torn tail, atomically (tmp + rename
                # — the commit protocol, even for the salvage path)
                tmp = f"{open_path}.{os.getpid()}.tmp"
                with open(tmp, "w") as f:
                    f.write("\n".join(good) + "\n")
                os.replace(tmp, open_path)
            committed = open_path[: -len(".open.jsonl")] + ".jsonl"
            os.replace(open_path, committed)
            self.adopted_segments += 1
        except OSError:
            pass  # best-effort salvage: a failed adopt stays an orphan

    # -- the write path ----------------------------------------------------
    def append(self, sample: "dict[str, Any]") -> None:
        """Append one sample (single atomic ``O_APPEND`` write).

        Raises on an armed ``history.append`` fault or real I/O failure
        — the caller drops THAT sample; the ring itself stays
        consistent (committed segments are immutable, and a torn live
        tail is exactly what the reopen GC repairs).
        """
        if self._closed:
            raise ValueError(f"HistoryRing {self.directory} is closed")
        fault_check("history.append")
        line = (json.dumps(sample, separators=(",", ":"), default=str) + "\n").encode()
        if self._fd is None:
            self._open_path = os.path.join(
                self.directory, f"hist-{time.time_ns()}-{os.getpid()}.open.jsonl"
            )
            self._fd = os.open(
                self._open_path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644
            )
            self._open_count = 0
        n = os.write(self._fd, line)
        if n != len(line):
            raise OSError(
                f"short write to {self._open_path}: {n}/{len(line)} bytes"
            )
        self._open_count += 1
        if self._open_count >= self.samples_per_segment:
            self._commit()

    def _commit(self) -> None:
        """Rename the live segment to its committed name (the commit
        point) and evict whole oldest segments past the byte budget."""
        if self._fd is None:
            return
        os.close(self._fd)
        self._fd = None
        committed = self._open_path[: -len(".open.jsonl")] + ".jsonl"
        os.replace(self._open_path, committed)
        self._open_path = None
        self._open_count = 0
        self._evict()

    def _evict(self) -> None:
        segs = self.segments()
        sizes = []
        for p in segs:
            try:
                sizes.append((p, os.path.getsize(p)))
            except OSError:
                pass
        total = sum(s for _, s in sizes)
        # never evict the newest segment: a budget smaller than one
        # segment must not empty the ring entirely
        for p, s in sizes[:-1]:
            if total <= self.budget_bytes:
                break
            try:
                os.unlink(p)
                total -= s
            except OSError:
                pass

    # -- the read path -----------------------------------------------------
    def segments(self) -> list:
        """Committed segment paths, oldest first (the ``hist-<ns>-<pid>``
        naming sorts chronologically)."""
        return sorted(
            p
            for p in glob.glob(os.path.join(self.directory, "hist-*.jsonl"))
            if not p.endswith(".open.jsonl")
        )

    def read(self, newer_than: "float | None" = None) -> "tuple[list, int]":
        """``(samples, malformed)`` across committed segments plus the
        live tail, oldest first; malformed lines (a torn live tail, bit
        rot) are counted, never fatal.  ``newer_than`` filters on each
        sample's own ``t`` stamp."""
        paths = self.segments()
        live = sorted(glob.glob(os.path.join(self.directory, "*.open.jsonl")))
        samples: list = []
        malformed = 0
        for p in [*paths, *live]:
            try:
                with open(p) as f:
                    lines = f.read().splitlines()
            except OSError:
                continue  # evicted between glob and read
            for line in lines:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    malformed += 1
                    continue
                if not isinstance(rec, dict):
                    malformed += 1
                    continue
                t = rec.get("t")
                if newer_than is not None and (
                    not isinstance(t, (int, float)) or t < newer_than
                ):
                    continue
                samples.append(rec)
        samples.sort(key=lambda r: r.get("t") or 0.0)
        return samples, malformed

    def close(self) -> None:
        """Commit the live tail (even short — reopen must see it) and
        release the fd.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._fd is not None:
            if self._open_count:
                self._commit()
            else:
                os.close(self._fd)
                self._fd = None
                try:
                    os.unlink(self._open_path)
                except OSError:
                    pass
                self._open_path = None


def _metric_value(sample: dict, key: str) -> "float | None":
    """A sample's scalar: top-level health fields (``hosts``,
    ``stale_hosts``, ...) or a flattened metric key."""
    v = sample.get(key)
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    m = sample.get("metrics")
    if isinstance(m, dict):
        v = m.get(key)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return float(v)
    return None


def latest_value(samples: list, key: str) -> "float | None":
    """The most recent sample's value for ``key`` (None when the window
    never carried it)."""
    for sample in reversed(samples):
        v = _metric_value(sample, key)
        if v is not None:
            return v
    return None


def counter_rate(
    samples: list, key: str, window_s: float, now: "float | None" = None
) -> "float | None":
    """Reset-aware counter rate (per second) over the trailing window.

    A counter that DROPS between samples is a process restart, not a
    negative increase: the post-reset value counts as the increase from
    zero (the Prometheus ``rate()`` convention), so the result can
    never go negative — the aggregate-must-not-go-negative contract
    under restart churn.  Returns ``None`` with fewer than two samples
    in the window (a rate needs an interval).
    """
    if now is None:
        now = samples[-1].get("t", 0.0) if samples else 0.0
    window = [
        s for s in samples
        if isinstance(s.get("t"), (int, float)) and s["t"] >= now - window_s
    ]
    prev_v = prev_t = first_t = None
    increase = 0.0
    points = 0
    for s in window:
        v = _metric_value(s, key)
        if v is None:
            continue
        points += 1
        if first_t is None:
            first_t = s["t"]
        if prev_v is not None:
            increase += (v - prev_v) if v >= prev_v else v
        prev_v, prev_t = v, s["t"]
    if points < 2 or prev_t == first_t:
        return None
    return max(0.0, increase) / (prev_t - first_t)
