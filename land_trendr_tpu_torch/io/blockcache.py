"""Decoded-block cache + shared decode pool for the GeoTIFF feed path.

On the r05 gigapixel resume run the host feed stage was the dominant
non-compute cost (measured on the JAX package's gigapixel run):
every tile window re-decoded the compressed TIFF blocks straddling tile
boundaries — once per band, serially, under a single feed worker.  The
massively-parallel break-detection literature (arXiv:1807.01751) names
exactly this host decode/feed stage as the scaling limiter once the
fitting kernel is fast.  This module is the process-wide answer, used by
:mod:`land_trendr_tpu_torch.io.geotiff` window reads:

* a **decoded-block LRU cache** keyed by
  ``(path, mtime_ns, size, page, block_index)`` with a configurable byte
  budget — a block revisited by an overlapping window, a
  ``LazyBandCube`` re-read, or a resume pass decodes once;
* a **shared decode thread pool**: zlib releases the GIL, so the blocks
  of one window decode concurrently (the native codec threads in C++
  instead — the same ``decode_workers`` knob governs both paths);
* **readahead**: the driver's feed pool hints the next planned tile's
  windows (:func:`prefetch_window`), so their blocks decode into the
  cache while the current tile waits on the device;
* **stats** (:func:`stats_snapshot` / :func:`stats_delta`): hits,
  misses, evictions, decode seconds, readahead effectiveness — exported
  through the run telemetry (``feed_cache`` event + ``lt_feed_*``
  Prometheus metrics) and surfaced by ``tools/obs_report.py``.

Unconfigured (the import-time default: budget 0, workers ``None``) the
module is inert and the codec behaves exactly as before — no cache, the
native path auto-threads, the NumPy path decodes serially.  The driver
configures it from ``RunConfig.feed_cache_mb`` / ``decode_workers``;
``feed_cache_mb=0`` reproduces the uncached behavior byte for byte
(cached and uncached reads are byte-identical either way — the cache
stores fully decoded, un-predicted blocks, so it is pure memoization).

A configured **persistent store**
(:class:`land_trendr_tpu_torch.io.blockstore.BlockStore`, driven by
``RunConfig.ingest_store_mb``) adds a second tier under the RAM cache:
a RAM miss consults the store before decoding, a decoded block is
persisted alongside its RAM insert, and a store-served block is
promoted back into the RAM tier.  The ``hits``/``misses`` counters here
keep describing the RAM tier (a store hit still counts a RAM miss —
store effectiveness is the ``ingest_store`` rollup's story), and
:func:`drop_corrupt` invalidates BOTH tiers, so a poisoned block —
wherever it came from — degrades to one extra decode.

Thread-safety: one module lock guards the cache map and the counters;
entries are immutable by convention (every consumer only reads slices).
A decode task spawned by :func:`prefetch_window` runs ON the shared
pool, so window reads inside a readahead task decode serially
(:func:`decode_pool` returns ``None`` there) — submitting pool work
from a pool task and waiting on it would deadlock a saturated pool.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING

if TYPE_CHECKING:  # pragma: no cover - typing only
    import numpy as np

__all__ = [
    "config_snapshot",
    "configure",
    "detach_store",
    "store_bytes_snapshot",
    "cache_enabled",
    "cache_get",
    "cache_put",
    "cache_clear",
    "decode_threads",
    "decode_pool",
    "drop_corrupt",
    "fault_check",
    "fault_corrupt",
    "file_key",
    "note_decode_seconds",
    "prefetch_window",
    "set_fault_plan",
    "stats_snapshot",
    "stats_delta",
]

#: cap for ``decode_workers=0`` (auto): feed decode shares the host with
#: the feed/writer pools and the JAX dispatch thread — more than a few
#: zlib threads per window hits diminishing returns long before this
_AUTO_WORKERS_MAX = 8

_lock = threading.Lock()
_tl = threading.local()  # .readahead: True inside a prefetch pool task

# -- configuration state (module-wide: the cache is process-wide by design,
#    like the reference's GDAL block cache) --------------------------------
_budget_bytes: int = 0
_workers: int | None = None  # None = never configured (legacy behavior)
_pool: ThreadPoolExecutor | None = None
_pool_size: int = 0

# -- cache map: key -> [array, nbytes, readahead_pending] ------------------
_entries: "OrderedDict[tuple, list]" = OrderedDict()
_cache_bytes: int = 0

# -- persistent second tier (io.blockstore.BlockStore or None) -------------
_store = None

# -- counters (guarded by _lock) -------------------------------------------
_stats = {
    "hits": 0,
    "misses": 0,
    "evictions": 0,
    "inserted_bytes": 0,
    "decode_s": 0.0,
    "readahead_blocks": 0,
    "readahead_hits": 0,
    "readahead_dropped": 0,
    "corrupt_dropped": 0,
}
_inflight_prefetch = 0

# -- fault-injection hook (land_trendr_tpu_torch.runtime.faults) -----------------
# The io layer must not import runtime/ (driver imports geotiff — a
# module-level back-import would cycle), so the active FaultPlan is
# REGISTERED here by faults.activate()/deactivate().  None = inert.
_fault_plan = None


def set_fault_plan(plan) -> None:
    """Install/clear the active fault plan for the io-layer seams
    (``feed.decode``, ``cache.corrupt``); called by ``runtime.faults``."""
    global _fault_plan
    _fault_plan = plan


def fault_check(seam: str) -> None:
    """Raising io-layer seam; no-op (one attribute read) when inert.

    Readahead tasks are invisible to the seams (like they are to the
    hit/miss counters): their errors are swallowed by design, so letting
    them consume per-seam invocation indices would both waste scheduled
    faults on a path that cannot surface them AND make the demand path's
    indices race the prefetch pool — breaking the injector's determinism
    contract."""
    plan = _fault_plan
    if plan is not None and not getattr(_tl, "readahead", False):
        plan.check(seam)


def fault_corrupt(seam: str, arr: "np.ndarray") -> "np.ndarray":
    """Corruption io-layer seam: damaged stand-in on a firing invocation
    (demand reads only — see :func:`fault_check` on readahead)."""
    plan = _fault_plan
    if plan is None or getattr(_tl, "readahead", False):
        return arr
    return plan.corrupt(seam, arr)


def drop_corrupt(key: tuple) -> None:
    """Invalidate one cache entry whose consumer found it corrupt (wrong
    shape/dtype for its slot): the entry is removed and counted, and the
    caller re-decodes from the file — a poisoned block degrades to one
    extra decode instead of failing the tile.  With a persistent store
    tier the drop propagates there too (the damaged block may have been
    served from — or promoted out of — disk)."""
    with _lock:
        global _cache_bytes
        ent = _entries.pop(key, None)
        if ent is not None:
            # count actual removals only: a concurrent reader that found
            # the same poisoned block (or an eviction racing this call)
            # must not double-count one corruption
            _cache_bytes -= ent[1]
            _stats["corrupt_dropped"] += 1
        store = _store
    if store is not None:
        store.drop(key)


def configure(
    budget_bytes: int = 0, workers: int | None = 0, store=None
) -> None:
    """Set the cache byte budget, decode worker count, and store tier.

    ``budget_bytes=0`` disables the cache (and clears it).  ``workers``:
    ``0`` = auto (``min(8, cpu)`` for the NumPy path, the native codec's
    own auto-threading), ``1`` = serial everywhere, ``N`` = that many
    threads in both paths, ``None`` = the unconfigured import-time
    default (serial NumPy, auto native — exactly the pre-cache codec).
    ``store`` is a :class:`land_trendr_tpu_torch.io.blockstore.BlockStore` (or
    ``None`` = no persistent tier); its lifecycle — flush/close — stays
    with the caller that built it (the driver).
    Counters are NOT reset — callers diff :func:`stats_snapshot`.
    """
    global _budget_bytes, _workers, _store
    if budget_bytes < 0:
        raise ValueError(f"budget_bytes={budget_bytes} must be >= 0")
    if workers is not None and workers < 0:
        raise ValueError(f"workers={workers} must be >= 0 (or None)")
    with _lock:
        _budget_bytes = int(budget_bytes)
        _workers = workers
        _store = store
        _evict_to_budget_locked()
        if _budget_bytes == 0:
            _entries.clear()
            _reset_bytes_locked()


def config_snapshot() -> dict:
    """The current process-cache configuration, in :func:`configure`'s
    keyword shape — ``configure(**config_snapshot())`` restores it.  How
    a transient reconfigurer (the autotuner's decode probe) guarantees it
    never skews the run behind it."""
    with _lock:
        return {
            "budget_bytes": _budget_bytes,
            "workers": _workers,
            "store": _store,
        }


def _reset_bytes_locked() -> None:
    global _cache_bytes
    _cache_bytes = 0


def _evict_to_budget_locked() -> None:
    global _cache_bytes
    while _cache_bytes > _budget_bytes and _entries:
        _, (arr, nbytes, _ra) = _entries.popitem(last=False)
        _cache_bytes -= nbytes
        _stats["evictions"] += 1


def detach_store(store) -> None:
    """Drop the persistent tier iff it is still ``store`` — called by the
    run that built it when it ends, so a later configure (or nothing at
    all) cannot keep writing into a closed store.  The RAM tier persists
    process-wide as before."""
    global _store
    with _lock:
        if _store is store:
            _store = None


def store_bytes_snapshot() -> "int | None":
    """Current persistent-store occupancy in bytes — the flight
    sampler's ``store_bytes`` gauge (None without an attached store).
    The store's own snapshot runs OUTSIDE the cache lock (it takes the
    store lock; nesting the two here would add a lock-order edge)."""
    with _lock:
        store = _store
    if store is None:
        return None
    try:
        return int(store.stats_snapshot().get("bytes", 0))
    except Exception:
        return None


def occupancy_probe() -> dict:
    """The flight sampler's cache/store occupancy gauges in one place:
    ``cache_bytes`` always, ``store_bytes`` only with an attached store
    (a missing gauge is "no store", not "empty store")."""
    out = {"cache_bytes": int(stats_snapshot()["cache_bytes"])}
    store_bytes = store_bytes_snapshot()
    if store_bytes is not None:
        out["store_bytes"] = store_bytes
    return out


def cache_enabled() -> bool:
    with _lock:
        return _budget_bytes > 0 or _store is not None


def cache_get(key: tuple) -> "np.ndarray | None":
    """Cached decoded block for ``key``, or None (counts a hit/miss).

    Lookups made FROM a readahead task are invisible to the counters:
    prefetch probing its own (or a sibling hint's) blocks is not demand
    traffic — counting it would floor-inflate the hit rate and consume
    the readahead-pending flag on lookups that never served a real read.

    A RAM miss falls through to the persistent store tier when one is
    configured: a store hit still counts a RAM ``miss`` here (the
    counters describe the RAM tier; the store keeps its own), passes
    the ``store.corrupt`` fault seam, and is promoted into the RAM
    cache so revisits inside this run stay memory-speed.
    """
    demand = not getattr(_tl, "readahead", False)
    with _lock:
        ent = _entries.get(key)
        if ent is not None:
            _entries.move_to_end(key)
            if demand:
                _stats["hits"] += 1
                if ent[2]:  # first real hit on a readahead-inserted block
                    ent[2] = False
                    _stats["readahead_hits"] += 1
            return ent[0]
        if demand:
            _stats["misses"] += 1
        store = _store
    if store is None:
        return None
    arr = store.get(key, count=demand)
    if arr is None:
        return None
    if demand:
        # fault seam "store.corrupt" (demand reads only, like the cache
        # seam): a damaged stand-in here flows through the SAME
        # consumer-side shape/dtype validation as a poisoned RAM entry,
        # whose drop_corrupt then invalidates both tiers
        plan = _fault_plan
        if plan is not None:
            arr = plan.corrupt("store.corrupt", arr)
    cache_put(key, arr)
    return arr


def cache_put(key: tuple, arr: "np.ndarray") -> None:
    """Insert a decoded block (RAM tier no-op when disabled/oversized;
    a configured store tier persists it alongside — idempotently, so
    store-promoted blocks are never re-written)."""
    nbytes = int(arr.nbytes)
    readahead = bool(getattr(_tl, "readahead", False))
    with _lock:
        store = _store
        if _budget_bytes > 0 and nbytes <= _budget_bytes:
            global _cache_bytes
            old = _entries.pop(key, None)
            if old is not None:
                _cache_bytes -= old[1]
            _entries[key] = [arr, nbytes, readahead]
            _cache_bytes += nbytes
            _stats["inserted_bytes"] += nbytes
            if readahead:
                _stats["readahead_blocks"] += 1
            _evict_to_budget_locked()
    if store is not None:
        store.put(key, arr)


def cache_clear() -> None:
    """Drop every entry (budget/config unchanged; counters kept)."""
    with _lock:
        _entries.clear()
        _reset_bytes_locked()


def cache_bytes() -> int:
    with _lock:
        return _cache_bytes


def budget_bytes() -> int:
    with _lock:
        return _budget_bytes


def file_key(f, path: str) -> "tuple | None":
    """Cache identity of an open raster: ``(path, mtime_ns, size)``.

    mtime + size guard rewritten files — a regenerated scene under the
    same path must not serve the previous contents' blocks.  ``None``
    (no caching) for non-statable streams.
    """
    try:
        st = os.fstat(f.fileno())
    except (OSError, AttributeError, ValueError):
        return None
    return (path, st.st_mtime_ns, st.st_size)


def decode_threads() -> int:
    """``n_threads`` for the native codec: 0 = its own auto-threading."""
    with _lock:
        workers = _workers
    if workers is None:
        return 0
    return workers


def _effective_pool_size() -> int:
    with _lock:
        workers = _workers
    if workers is None or workers == 1:
        return 1
    if workers == 0:
        return min(_AUTO_WORKERS_MAX, os.cpu_count() or 1)
    return workers


def decode_pool() -> "ThreadPoolExecutor | None":
    """The shared pool for NumPy-path block decode, or ``None`` when the
    decode must run serially (unconfigured, ``workers=1``, or already on
    a pool thread via :func:`prefetch_window` — see the module note on
    pool-in-pool deadlock)."""
    if getattr(_tl, "readahead", False):
        return None
    size = _effective_pool_size()
    if size <= 1:
        return None
    return _get_pool(size)


def _get_pool(size: int) -> ThreadPoolExecutor:
    global _pool, _pool_size
    with _lock:
        if _pool is None or _pool_size != size:
            old = _pool
            _pool = ThreadPoolExecutor(
                max_workers=size, thread_name_prefix="lt-decode"
            )
            _pool_size = size
            if old is not None:
                old.shutdown(wait=False)
        return _pool


def note_decode_seconds(dt: float) -> None:
    """Accumulate block-decode wall seconds (summed across threads, so
    the total can exceed wall time — like the driver's stage timers)."""
    with _lock:
        _stats["decode_s"] += dt


def prefetch_window(path: str, y0: int, x0: int, h: int, w: int) -> bool:
    """Hint a future window: decode its blocks into the cache off-thread.

    Fire-and-forget — returns True when the hint was queued, False when
    readahead is off (cache disabled / serial config) or the pool is
    already saturated with hints (bounded backlog; dropped hints are
    counted, the blocks just decode on demand later).  Errors inside the
    prefetch task are swallowed: the on-demand read will surface them.
    """
    global _inflight_prefetch
    size = _effective_pool_size()
    if not cache_enabled() or size <= 1:
        return False
    with _lock:
        if _inflight_prefetch >= 2 * size:
            _stats["readahead_dropped"] += 1
            return False
        _inflight_prefetch += 1
    _get_pool(size).submit(_prefetch_task, path, y0, x0, h, w)
    return True


def _prefetch_task(path: str, y0: int, x0: int, h: int, w: int) -> None:
    global _inflight_prefetch
    from land_trendr_tpu_torch.io.geotiff import read_geotiff_window

    _tl.readahead = True
    try:
        read_geotiff_window(path, y0, x0, h, w)
    except Exception:
        pass  # the on-demand read reports the real error with context
    finally:
        _tl.readahead = False
        with _lock:
            _inflight_prefetch -= 1


def stats_snapshot() -> dict:
    """Cumulative process-wide counters (plus current cache occupancy)."""
    with _lock:
        out = dict(_stats)
        out["cache_bytes"] = _cache_bytes
        out["budget_bytes"] = _budget_bytes
        return out


def stats_delta(base: dict) -> dict:
    """Counters accumulated since ``base`` (a prior snapshot); occupancy
    fields (``cache_bytes``/``budget_bytes``) are reported as-is, not
    differenced — they are gauges, not counters."""
    now = stats_snapshot()
    out = {}
    for k, v in now.items():
        if k in ("cache_bytes", "budget_bytes"):
            out[k] = v
        else:
            out[k] = round(v - base.get(k, 0), 6) if isinstance(v, float) else v - base.get(k, 0)
    return out
