"""Persistent decoded-block store: ingest once, serve many.

The decoded-block cache (:mod:`land_trendr_tpu_torch.io.blockcache`) dies
with the process — the second run over the same stacks pays full TIFF
inflate again, and the service-mode workload
(many requests over the same scene archive) pays it per request.  This
module spills decoded blocks to a **memory-mapped on-disk column store**
under the run's workdir, keyed by the SAME
``(path, mtime_ns, size, page, block_index)`` fingerprint the in-memory
cache uses, so a warm rerun skips TIFF decode entirely (the TorchGeo
tutorial's "ingest once, serve many" pattern, arXiv:2603.02386).

Layout — append-only **segments** with sidecar indexes::

    <root>/seg-<pid>-<n>.bin    raw concatenated block bytes
    <root>/seg-<pid>-<n>.json   {"entries": [{key, off, nbytes, dtype,
                                 shape}, ...], "bytes": N}

* Blocks buffer in memory and flush as one segment once
  ``segment_bytes`` accumulate (or at :meth:`BlockStore.flush`); both
  files are written **tmp + atomic rename**, data before index — the
  index is the commit point, so a crash mid-flush leaves at most an
  orphaned ``.bin`` that a later open garbage-collects (once STALE:
  fresh orphans/tmps in a shared directory may be a live sibling
  process mid-commit).  Concurrent processes sharing a store directory
  (a pod's shared workdir) write disjoint pid-named segments; a sibling
  evicting a segment this process has indexed degrades to one whole-
  segment drop and re-decode on the next read of it.
* Reads are **zero-copy**: a hit is a read-only NumPy view into the
  segment's ``mmap`` — no inflate, no unpredict, no allocation beyond
  the view (the stored array IS the fully decoded block the in-memory
  cache would hold).
* The **byte budget** bounds on-disk bytes: whole oldest segments are
  evicted (files deleted, live entries dropped) — eviction is coarse by
  design; the store is a spill tier, not an LRU.
* **Stale generations**: a key whose ``(path, page, block)`` matches a
  stored entry but whose ``(mtime_ns, size)`` differs means the file was
  rewritten — the stale entry is dropped (``stale_dropped``) and the
  caller re-decodes, exactly like the in-memory cache's mtime guard.
* **Corruption** reuses the ``drop_corrupt`` contract: a segment
  whose data file is missing/short at open, or an entry whose bytes no
  longer fit its segment, is dropped and counted (``corrupt_dropped``)
  and the block re-decodes from the TIFF; consumer-side shape/dtype
  validation (``io/geotiff.py``) catches value-level damage the same
  way it does for poisoned cache entries — via
  :func:`blockcache.drop_corrupt`, which forwards the drop here.  The
  ``store.corrupt`` fault seam (:mod:`land_trendr_tpu_torch.runtime.faults`)
  exercises that path deterministically.

Thread-safety: one instance lock guards the index maps, the pending
buffer, the counters, and the mmap table; returned views are immutable
by convention (every consumer only reads slices) — the same contract as
the in-memory cache.  The store never imports ``runtime/``; fault hooks
arrive through :mod:`blockcache`'s registered plan like every io seam.
"""

from __future__ import annotations

import glob
import json
import mmap
import os
import re
import threading
import time
from typing import TYPE_CHECKING

import numpy as np

if TYPE_CHECKING:  # pragma: no cover - typing only
    pass

__all__ = ["BlockStore"]

#: flush threshold: blocks buffer in memory until a segment's worth
#: accumulated (big enough to amortize the rename/fsync, small enough
#: that a crash loses little ingest work)
_SEGMENT_BYTES = 16 << 20

#: orphan/tmp files younger than this are left alone at open: in a
#: shared store directory (pod processes) a fresh sibling-owned ``.bin``
#: may be mid-commit (data renamed, index not yet) and a fresh ``.tmp``
#: mid-write — only stale leftovers are crash debris safe to collect
_GC_STALE_S = 60.0

_SEG_RE = re.compile(r"seg-(\d+)-(\d+)\.json$")


def _key_list(key: tuple) -> list:
    """JSON form of a block key (tuples don't survive JSON round trips)."""
    return list(key)


class BlockStore:
    """One persistent block-store directory (see module docstring)."""

    def __init__(
        self,
        root: str,
        budget_bytes: int,
        segment_bytes: int = _SEGMENT_BYTES,
    ) -> None:
        if budget_bytes <= 0:
            raise ValueError(f"budget_bytes={budget_bytes} must be > 0")
        self.root = root
        self.budget_bytes = int(budget_bytes)
        self.segment_bytes = int(segment_bytes)
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        # committed entries: key -> (seg_name, off, nbytes, dtype, shape)
        self._index: dict[tuple, tuple] = {}
        # generation guard: (path, page, block) -> full key
        self._by_block: dict[tuple, tuple] = {}
        # seg_name -> {"bytes": int, "keys": set, "mtime": float}
        self._segments: dict[str, dict] = {}
        self._mmaps: dict[str, mmap.mmap] = {}
        # pending (unflushed) blocks: key -> np.ndarray; _flushing holds
        # the batch a flush has detached and is writing OUTSIDE the lock
        # (still served by get(), still idempotence-checked by put())
        self._pending: dict[tuple, np.ndarray] = {}
        self._flushing: dict[tuple, np.ndarray] = {}
        self._pending_bytes = 0
        self._flush_lock = threading.Lock()  # one segment write at a time
        self._closed = False
        self._seq = 0
        self._stats = {
            "hits": 0,
            "misses": 0,
            "put_blocks": 0,
            "put_bytes": 0,
            "stale_dropped": 0,
            "corrupt_dropped": 0,
            "evicted_segments": 0,
        }
        self._load()

    # -- open / recovery ---------------------------------------------------
    def _load(self) -> None:
        """Index every committed segment; GC orphans and corrupt pairs."""
        with self._lock:
            sidecars = sorted(
                glob.glob(os.path.join(self.root, "seg-*-*.json")),
                key=lambda p: (os.path.getmtime(p), p),
            )
            indexed_bins = set()
            for sc in sidecars:
                name = os.path.basename(sc)[: -len(".json")]
                bin_path = os.path.join(self.root, name + ".bin")
                try:
                    with open(sc) as f:
                        meta = json.load(f)
                    entries = meta["entries"]
                    nbytes = int(meta["bytes"])
                    if os.path.getsize(bin_path) < nbytes:
                        raise ValueError("short segment data file")
                except (OSError, ValueError, KeyError, json.JSONDecodeError):
                    # torn flush / bit rot: the segment is unusable as a
                    # whole — drop both files, count it, move on (the
                    # blocks just re-decode on demand)
                    self._stats["corrupt_dropped"] += 1
                    for p in (sc, bin_path):
                        try:
                            os.unlink(p)
                        except OSError:
                            pass
                    continue
                keys = set()
                for e in entries:
                    key = tuple(e["key"])
                    self._index[key] = (
                        name,
                        int(e["off"]),
                        int(e["nbytes"]),
                        str(e["dtype"]),
                        tuple(e["shape"]),
                    )
                    self._by_block[self._block_id(key)] = key
                    keys.add(key)
                self._segments[name] = {
                    "bytes": nbytes,
                    "keys": keys,
                    "mtime": os.path.getmtime(sc),
                }
                indexed_bins.add(bin_path)
                m = _SEG_RE.search(sc)
                if m and int(m.group(1)) == os.getpid():
                    self._seq = max(self._seq, int(m.group(2)) + 1)
            # orphans: a .bin with no committed index (crash between the
            # data rename and the index rename), or leftover tmp files.
            # STALE ones only: in a shared store dir a sibling process's
            # fresh .bin may be mid-commit and its fresh .tmp mid-write —
            # unlinking those would destroy its in-flight ingest
            now = time.time()
            for pattern in ("seg-*-*.bin", "*.tmp"):
                for p in glob.glob(os.path.join(self.root, pattern)):
                    if p in indexed_bins:
                        continue
                    try:
                        if now - os.path.getmtime(p) > _GC_STALE_S:
                            os.unlink(p)
                    except OSError:
                        pass
            self._evict_to_budget_locked()

    @staticmethod
    def _block_id(key: tuple) -> tuple:
        """(path, page, block): the generation-blind block identity."""
        return (key[0], key[3], key[4])

    # -- read path ---------------------------------------------------------
    def get(self, key: tuple, count: bool = True) -> "np.ndarray | None":
        """The stored decoded block for ``key``, or ``None``.

        A hit is a read-only mmap-backed view (pending blocks return the
        buffered array).  A generation mismatch — same ``(path, page,
        block)``, different ``(mtime_ns, size)`` — drops the stale entry
        so a rewritten file can never serve its predecessor's bytes.
        ``count=False`` makes the lookup invisible to the hit/miss
        counters (readahead probing, like the in-memory cache's).

        A COLD segment's ``open``/``mmap`` runs OUTSIDE the instance
        lock (the flush bug's read-path twin — a cold open
        on a tiered filesystem stalled every concurrent ``get``/``put``
        behind disk latency), then registers under the lock and retries
        the lookup; a segment evicted during the unlocked window simply
        misses, exactly as if the eviction had won the race under one
        big lock.
        """
        while True:
            with self._lock:
                arr = self._pending.get(key)
                if arr is None:
                    arr = self._flushing.get(key)
                if arr is not None:
                    if count:
                        self._stats["hits"] += 1
                    return arr
                ent = self._index.get(key)
                if ent is None:
                    stale = self._by_block.get(self._block_id(key))
                    if stale is not None and stale != key:
                        self._drop_locked(stale, "stale_dropped")
                    if count:
                        self._stats["misses"] += 1
                    return None
                name, off, nbytes, dtype, shape = ent
                mm = self._mmaps.get(name)
                if mm is not None:
                    return self._read_view_locked(
                        key, mm, off, nbytes, dtype, shape, count
                    )
            # cold segment: open + map with the lock RELEASED, then loop
            # to re-validate — the entry may be gone by the time the map
            # is ready (sibling eviction), in which case the next pass
            # resolves it like any other miss
            try:
                with open(
                    os.path.join(self.root, name + ".bin"), "rb"
                ) as f:
                    mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
            except OSError:
                # unopenable segment (deleted by a sibling's eviction,
                # bit rot): EVERY entry of it is gone — drop the whole
                # segment once instead of paying a failed open (and a
                # corruption count) per sibling entry
                with self._lock:
                    if name in self._segments:
                        self._drop_segment_locked(name)
                        self._stats["corrupt_dropped"] += 1
                    if count:
                        self._stats["misses"] += 1
                return None
            registered = closed = False
            with self._lock:
                if self._closed:
                    # close() tore the mmap table down while we were in
                    # the unlocked open: registering now would leak a map
                    # nothing ever closes — refuse and miss
                    closed = True
                    if count:
                        self._stats["misses"] += 1
                elif name in self._segments and name not in self._mmaps:
                    self._mmaps[name] = mm
                    registered = True
            if not registered:
                # lost the race (another reader mapped it, or the
                # segment was dropped meanwhile): this map is surplus
                mm.close()
                if closed:
                    return None

    def _read_view_locked(
        self, key, mm, off, nbytes, dtype, shape, count: bool
    ) -> "np.ndarray | None":
        """Zero-copy view over an already-mapped segment (lock held)."""
        try:
            if off + nbytes > len(mm):
                raise ValueError("entry outside segment")
            arr = np.frombuffer(
                mm, dtype=np.dtype(dtype), count=int(
                    nbytes // np.dtype(dtype).itemsize
                ), offset=off,
            ).reshape(shape)
        except ValueError:
            # entry-level inconsistency: drop just it — the caller
            # re-decodes
            self._drop_locked(key, "corrupt_dropped")
            if count:
                self._stats["misses"] += 1
            return None
        if count:
            self._stats["hits"] += 1
        return arr

    # -- write path --------------------------------------------------------
    def put(self, key: tuple, arr: "np.ndarray") -> None:
        """Persist one decoded block (idempotent; no-op when oversized).

        A stale generation of the same block is dropped first; the block
        buffers in the pending segment and commits at the next flush.
        """
        nbytes = int(arr.nbytes)
        if nbytes > self.budget_bytes:
            return
        flush_now = False
        with self._lock:
            if (
                key in self._pending
                or key in self._flushing
                or key in self._index
            ):
                return
            stale = self._by_block.get(self._block_id(key))
            if stale is not None and stale != key:
                self._drop_locked(stale, "stale_dropped")
            self._pending[key] = np.ascontiguousarray(arr)
            self._by_block[self._block_id(key)] = key
            self._pending_bytes += nbytes
            self._stats["put_blocks"] += 1
            self._stats["put_bytes"] += nbytes
            flush_now = self._pending_bytes >= self.segment_bytes
        if flush_now:
            self.flush()

    def flush(self) -> None:
        """Commit the pending blocks as one segment (tmp + rename, data
        before index — the index rename is the commit point).

        The multi-MiB disk write runs OUTSIDE the instance lock (decode
        threads' get/put must not stall behind a segment rollover): the
        batch is detached into ``_flushing`` — still served by reads,
        still idempotence-checked by puts — written, then committed
        under the lock.  A key dropped mid-flush (corruption, stale
        generation) is simply not indexed; its bytes stay as dead space.
        """
        with self._flush_lock:
            with self._lock:
                if not self._pending:
                    return
                self._flushing = self._pending
                self._pending = {}
                self._pending_bytes = 0
                name = f"seg-{os.getpid()}-{self._seq:06d}"
                self._seq += 1
                batch = list(self._flushing.items())

            entries = []
            off = 0
            chunks = []
            for key, arr in batch:
                raw = arr.tobytes()
                chunks.append(raw)
                entries.append(
                    {
                        "key": _key_list(key),
                        "off": off,
                        "nbytes": len(raw),
                        "dtype": np.dtype(arr.dtype).name,
                        "shape": list(arr.shape),
                    }
                )
                off += len(raw)
            bin_path = os.path.join(self.root, name + ".bin")
            sc_path = os.path.join(self.root, name + ".json")
            # _flush_lock is a dedicated one-segment-write-at-a-time lock,
            # never taken on the get/put path: it exists so two flushes
            # cannot interleave their tmp+rename commits
            try:
                tmp = bin_path + ".tmp"
                # lt: noqa[LT007]
                with open(tmp, "wb") as f:
                    for raw in chunks:
                        f.write(raw)  # lt: noqa[LT007]
                os.replace(tmp, bin_path)
                tmp = sc_path + ".tmp"
                # lt: noqa[LT007]
                with open(tmp, "w") as f:
                    json.dump({"entries": entries, "bytes": off}, f)  # lt: noqa[LT007]
                os.replace(tmp, sc_path)
            except OSError:
                # a failed flush (full disk) degrades to "not persisted":
                # the blocks re-decode next run — never fail the read
                # path for it
                with self._lock:
                    for key, _arr in batch:
                        if self._by_block.get(self._block_id(key)) == key:
                            del self._by_block[self._block_id(key)]
                    self._flushing = {}
                for p in (bin_path, sc_path, bin_path + ".tmp", sc_path + ".tmp"):
                    try:
                        os.unlink(p)
                    except OSError:
                        pass
                return
            with self._lock:
                keys = set()
                for e in entries:
                    key = tuple(e["key"])
                    if key not in self._flushing:
                        continue  # dropped mid-flush: leave unindexed
                    self._index[key] = (
                        name, e["off"], e["nbytes"], e["dtype"],
                        tuple(e["shape"]),
                    )
                    keys.add(key)
                self._segments[name] = {
                    "bytes": off,
                    "keys": keys,
                    "mtime": os.path.getmtime(sc_path),
                }
                self._flushing = {}
                self._evict_to_budget_locked()

    # -- drop / evict ------------------------------------------------------
    def drop(self, key: tuple, corrupt: bool = True) -> None:
        """Invalidate one entry (the ``drop_corrupt`` forward from the
        in-memory cache: a consumer found the served block damaged)."""
        with self._lock:
            self._drop_locked(key, "corrupt_dropped" if corrupt else None)

    def _drop_locked(self, key: tuple, stat: "str | None") -> None:
        dropped = False
        if self._pending.pop(key, None) is not None:
            dropped = True
        if self._flushing.pop(key, None) is not None:
            dropped = True  # the in-flight flush will skip indexing it
        ent = self._index.pop(key, None)
        if ent is not None:
            seg = self._segments.get(ent[0])
            if seg is not None:
                seg["keys"].discard(key)
            dropped = True
        if dropped:
            bid = self._block_id(key)
            if self._by_block.get(bid) == key:
                del self._by_block[bid]
            if stat is not None:
                self._stats[stat] += 1

    def _drop_segment_locked(self, name: str) -> None:
        """Forget one whole segment: index entries, mmap, files."""
        seg = self._segments.pop(name, None)
        if seg is not None:
            for key in seg["keys"]:
                self._index.pop(key, None)
                bid = self._block_id(key)
                if self._by_block.get(bid) == key:
                    del self._by_block[bid]
        mm = self._mmaps.pop(name, None)
        if mm is not None:
            try:
                mm.close()
            except BufferError:
                pass  # live views pin it; freed with the last view
        for suffix in (".bin", ".json"):
            try:
                os.unlink(os.path.join(self.root, name + suffix))
            except OSError:
                pass

    def _evict_to_budget_locked(self) -> None:
        while (
            sum(s["bytes"] for s in self._segments.values())
            > self.budget_bytes
            and self._segments
        ):
            name = min(
                self._segments, key=lambda n: (self._segments[n]["mtime"], n)
            )
            self._drop_segment_locked(name)
            self._stats["evicted_segments"] += 1

    # -- lifecycle / stats -------------------------------------------------
    def close(self) -> None:
        """Flush pending blocks and release the mmaps (views stay valid —
        they hold their own buffer references).  Marks the store closed
        so a reader mid-cold-open cannot register a fresh mmap into the
        torn-down table (it misses instead); index/stats reads keep
        working on a closed store."""
        self.flush()
        with self._lock:
            self._closed = True
            for mm in self._mmaps.values():
                try:
                    mm.close()
                except BufferError:
                    pass
            self._mmaps.clear()

    def stats_snapshot(self) -> dict:
        """Cumulative counters plus current occupancy gauges."""
        with self._lock:
            out = dict(self._stats)
            out["bytes"] = (
                sum(s["bytes"] for s in self._segments.values())
                + self._pending_bytes
                + sum(a.nbytes for a in self._flushing.values())
            )
            out["budget_bytes"] = self.budget_bytes
            out["segments"] = len(self._segments)
            return out

    def stats_delta(self, base: dict) -> dict:
        """Counters accumulated since ``base``; occupancy gauges
        (``bytes``/``budget_bytes``/``segments``) are reported as-is."""
        now = self.stats_snapshot()
        out = {}
        for k, v in now.items():
            if k in ("bytes", "budget_bytes", "segments"):
                out[k] = v
            else:
                out[k] = v - base.get(k, 0)
        return out
