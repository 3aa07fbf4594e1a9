"""The tile-run driver: stacks in, segment rasters out (PyTorch).

Counterpart of ``land_trendr_tpu/runtime/driver.py``: :class:`RunConfig`,
:class:`TileSpec` / :func:`plan_tiles`, :func:`_feed_tile`, the
:class:`Run` class with manifest resume, the per-tile retry ladder,
quarantine, the stall watchdog, cancellation, straggler verdicts,
telemetry and the flight recorder, the decoded-block cache and the ingest
store, the elastic lease queue with speculation
(:mod:`~land_trendr_tpu_torch.runtime.leases`), pods (a process group's
:func:`~land_trendr_tpu_torch.parallel.host_share` and the primary's
event-log merge), mesh sharding over local devices and the ``"auto"``
knobs (:mod:`~land_trendr_tpu_torch.tune`); :func:`run_stack` (its
one-shot wrapper) and :func:`assemble_outputs`.

The scene is cut into fixed-size tiles; every tile — edge tiles included —
is padded to ``tile_size²`` pixels with fully-masked rows (the QA fill
bit), so every tile has one shape.  The tile loop is a depth-1 software
pipeline over the host, the link and the device:

* a pool of ``feed_workers`` threads slices upcoming tiles (feed);
* each fed tile is packed into pinned memory and copied to the device on
  a side stream as soon as it is fed (upload, ``upload_depth`` in flight);
* the tile program is enqueued on the device (dispatch) together with its
  packed fetch, and the host moves on: tile ``i``'s compute is awaited
  only after tile ``i+1`` has been enqueued behind it (compute);
* a finished tile's products land in pinned host memory while later
  tiles compute (fetch, ``fetch_depth`` in flight);
* a pool of ``write_workers`` threads persists tile artifacts to the
  manifest (write) — the manifest *is* the checkpoint.

Host waits on the device poll a CUDA event (:func:`~land_trendr_tpu_torch.
runtime.fetch.wait_event`) rather than block in the CUDA runtime, so the
stall watchdog's interrupt lands while the device is busy.

With a mesh, each fed tile is padded to a multiple of the mesh size and
split into one contiguous pixel block per mesh device before the upload;
each block is uploaded to, computed on and fetched from its own device,
and the blocks are joined on the host in pixel order before the manifest
write.

On a CUDA device every NY and candidate count runs:
:func:`~land_trendr_tpu_torch.ops.segment_cuda.instantiation` picks the
narrow, wide or global form of the kernel.  A serving layer passes its :class:`~land_trendr_tpu_torch.serve.programs.
ProgramCache` (``programs``): a miss pays one fully masked dummy tile
through the upload → dispatch → fetch chain before tile 0 (the kernel
library's load and the tile program's first launch), a hit skips it.
"""

from __future__ import annotations

import _thread
import dataclasses
import logging
import os
import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.io import blockcache, native
from land_trendr_tpu_torch.io.geotiff import GeoTiffStreamWriter
from land_trendr_tpu_torch.obs.spans import StragglerDetector
from land_trendr_tpu_torch.ops import indices as idx
from land_trendr_tpu_torch.ops.change import ChangeFilter
from land_trendr_tpu_torch.ops.segment_cuda import CUDA_BLOCK, instantiation
from land_trendr_tpu_torch.ops.tile import process_tile_dn, resolve_impl
from land_trendr_tpu_torch.parallel.mesh import make_mesh
from land_trendr_tpu_torch.parallel.multihost import host_share, process_count, process_index
from land_trendr_tpu_torch.runtime import faults
from land_trendr_tpu_torch.runtime import feed as feedmod
from land_trendr_tpu_torch.runtime import fetch as fetchmod
from land_trendr_tpu_torch.runtime.manifest import (
    ARTIFACT_COMPRESS,
    TileManifest,
    run_fingerprint,
)
from land_trendr_tpu_torch.runtime.leases import LeaseQueue
from land_trendr_tpu_torch.runtime.stack import RasterStack
from land_trendr_tpu_torch.tune import AUTO, resolve_config
from land_trendr_tpu_torch.utils.profiling import StageTimer

__all__ = [
    "Run",
    "RunCancelled",
    "RunConfig",
    "StallError",
    "TileRetriesExhausted",
    "TileSpec",
    "assemble_outputs",
    "plan_tiles",
    "resolve_device",
    "run_stack",
]

log = logging.getLogger("land_trendr_tpu_torch.runtime")

_SEG_PRODUCTS = fetchmod.SEG_PRODUCTS

#: demote the packed fetch path to per-product transfers after this many
#: consecutive fetch-wait failures in one run
_FETCH_DEMOTE_AFTER = 3

#: the upload mirror: demote the packed host→device path to the per-array
#: path after this many consecutive upload failures
_UPLOAD_DEMOTE_AFTER = 3

#: retry backoff ceiling: the exponential ladder never sleeps longer than
#: this between attempts, whatever max_retries is set to
_BACKOFF_CAP_S = 30.0


class TileRetriesExhausted(RuntimeError):
    """One tile failed ``attempts`` times (dispatch, device wait, fetch,
    or feed).  Without ``RunConfig.quarantine_tiles`` it aborts the run
    (CLI exit code 3); with it, the tile is recorded as failed in the
    manifest and the run continues."""

    def __init__(self, tile_id: int, attempts: int, cause: BaseException) -> None:
        super().__init__(f"tile {tile_id} failed after {attempts} attempts")
        self.tile_id = tile_id
        self.attempts = attempts
        self.cause = cause


class StallError(RuntimeError):
    """The stall watchdog aborted the run: no tile progress for
    ``RunConfig.stall_timeout_s`` (CLI exit code 4)."""


class RunCancelled(RuntimeError):
    """The run's cancel event was set: the run unwound through the normal
    abort path — every tile recorded before the cancel stays durable, so
    the manifest is resumable and a re-run completes exactly the remaining
    tiles."""


class _StallWatchdog:
    """Abort a run whose device wait hangs instead of hanging with it.

    A daemon thread watches a progress timestamp the driver ticks at every
    pipeline step (feed result, dispatch, compute wait, fetch landing,
    write collection, retry attempts).  When the gap exceeds ``timeout_s``
    it calls ``on_stall`` (the telemetry ``stall`` event), then interrupts
    the main thread; the driver converts that into :class:`StallError`, so
    the normal abort path still runs.  The driver's device waits poll
    their event from Python, so the interrupt lands while the device is
    busy.  If the main thread is stuck in an uninterruptible native call
    and the run has not unwound within the grace period, the watchdog
    hard-exits the process with the documented stall code (4).
    """

    def __init__(
        self,
        timeout_s: float,
        on_stall: "Callable[[float], None]",
        grace_s: "float | None" = None,
    ) -> None:
        self._timeout = float(timeout_s)
        self._grace = float(grace_s) if grace_s is not None else max(30.0, self._timeout)
        self._on_stall = on_stall
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._done = threading.Event()
        self.stalled = False
        self._thread = threading.Thread(
            target=self._run, name="lt-stall-watchdog", daemon=True
        )

    def start(self) -> "_StallWatchdog":
        self._thread.start()
        return self

    def tick(self) -> None:
        """Note pipeline progress (any step counts)."""
        with self._lock:
            self._last = time.monotonic()

    def stop(self) -> None:
        self._done.set()
        self._thread.join(timeout=5.0)

    def _run(self) -> None:
        poll = min(1.0, self._timeout / 4.0)
        while not self._done.wait(poll):
            with self._lock:
                idle = time.monotonic() - self._last
            if idle < self._timeout:
                continue
            with self._lock:
                self.stalled = True
            log.critical(
                "stall watchdog: no tile progress for %.1fs "
                "(stall_timeout_s=%.1f); aborting the run", idle, self._timeout,
            )
            try:
                self._on_stall(idle)
            except Exception:
                log.exception("stall watchdog: stall-event emit failed")
            _thread.interrupt_main()
            if not self._done.wait(self._grace):
                log.critical(
                    "stall watchdog: run did not unwind within %.0fs grace; "
                    "hard abort (exit 4)", self._grace,
                )
                os._exit(4)
            return


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything that defines a segmentation run over one stack.

    The JAX package's fields, with the same names, defaults and meanings;
    see ``land_trendr_tpu/runtime/driver.py`` for the full discussion of
    each.  Only the run-defining fields enter
    :meth:`fingerprint`; the rest are execution facts.  The tunable knobs
    (``tile_size``, ``chunk_px``, ``fetch_depth``, ``upload_depth``,
    ``feed_workers``, ``decode_workers``, ``feed_cache_mb``) also take
    ``"auto"``: :class:`Run` resolves them through ``tune_store_dir``'s
    profile for the run's device and scene class, or to these defaults
    without one; explicit values always win.
    """

    index: str = "nbr"
    #: secondary indices fitted to the chosen vertices (``ftv_<index>``
    #: products); fingerprinted
    ftv_indices: tuple[str, ...] = ()
    #: further indices each segmented on its own in the same kernel call
    #: as ``index`` (the LandTrendr multispectral ensemble;
    #: ``ens_<index>_<product>`` products for every product of
    #: ``products``); the port's own field, fingerprinted when not empty
    ensemble_indices: tuple[str, ...] = ()
    params: LTParams = LTParams()
    #: scene tiling granularity (pixels per side), or "auto"; fingerprinted
    #: (the resolved value)
    tile_size: "int | str" = 256
    workdir: str = "lt_work"
    out_dir: str = "lt_out"
    resume: bool = True
    #: a failed tile is re-dispatched this many times before it counts as
    #: exhausted
    max_retries: int = 2
    #: base of the exponential retry backoff: attempt ``n`` sleeps about
    #: ``retry_backoff_s * 2**(n-1)`` (±50% jitter, capped at 30s); ``0``
    #: retries immediately
    retry_backoff_s: float = 0.5
    #: after ``max_retries`` a tile is recorded as FAILED in the manifest
    #: and the run continues; the summary lists ``tiles_quarantined``, the
    #: CLI exits 3 and skips assembly, a resume re-attempts the tiles
    quarantine_tiles: bool = False
    #: abort the run after this many seconds without tile progress
    #: (:class:`StallError`, CLI exit 4); ``None`` disables the watchdog
    stall_timeout_s: "float | None" = None
    #: bound on the pod primary's wait for peers' ``run_done`` during the
    #: event-log merge; ``None`` derives it from this run's wall time
    #: (``max(60, min(2 * wall, 900))``)
    merge_timeout_s: "float | None" = None
    #: live straggler threshold: a tile in flight longer than
    #: ``straggler_k`` x the rolling median of recent tile durations is
    #: flagged (``tile_straggler`` event) — observability only
    straggler_k: float = 4.0
    #: no straggler verdicts until this many tiles have completed
    straggler_min_tiles: int = 5
    #: elastic scheduling (:mod:`land_trendr_tpu_torch.runtime.leases`):
    #: ``0`` keeps the static ``host_share`` split; ``N > 0`` claims tiles
    #: ``N`` at a time from the shared manifest's lease queue, renews on
    #: progress and steals expired or unclaimed tiles, so processes may
    #: join or leave mid-run.  The done record stays the one durability
    #: signal; never fingerprinted
    lease_batch: int = 0
    #: lease time-to-live, seconds: a lease not renewed within it is
    #: stealable.  Size it above the slowest tile and the pod's clock skew
    lease_ttl_s: float = 30.0
    #: with ``lease_batch``: an idle process speculatively re-leases a
    #: tile its owner's straggler detector flagged; first durable write
    #: wins, the loser's write lands as an identical no-op
    speculate: bool = False
    #: deterministic fault-injection schedule
    #: (:func:`land_trendr_tpu_torch.runtime.faults.parse_schedule`);
    #: ``None`` keeps every seam inert.  Never fingerprinted
    fault_schedule: "str | None" = None
    write_fitted: bool = False  # include the (NY,) fitted trajectory raster
    #: segmentation products to checkpoint + assemble; ``None`` = all
    #: (change products follow ``change_filt``, FTV products
    #: ``ftv_indices``)
    products: "tuple[str, ...] | None" = None
    #: fetch float products from the device as float16 (cast on the
    #: device, restored to float32 on the host): halves device→host bytes
    #: of every float product, lossy (~5e-4 relative), so opt-in.  It
    #: changes written values, so it is fingerprinted
    fetch_f16: bool = False
    #: device→host strategy: "auto" (packed on a CUDA device), True, False;
    #: a pure execution strategy — never fingerprinted
    fetch_packed: "bool | str" = "auto"
    #: bound on in-flight packed fetches, or "auto"
    fetch_depth: "int | str" = 2
    #: host→device strategy: "auto" (packed on a CUDA device), True, False
    upload_packed: "bool | str" = "auto"
    #: bound on in-flight packed uploads, or "auto"
    upload_depth: "int | str" = 2
    #: persistent decoded-block store budget (MiB) under the workdir
    #: (:mod:`land_trendr_tpu_torch.io.blockstore`): a rerun over the same
    #: stacks skips TIFF decode.  ``0`` disables.  Never fingerprinted
    ingest_store_mb: int = 0
    #: store directory override (default ``<workdir>/ingest_store``)
    ingest_store_dir: "str | None" = None
    #: fuse change-map selection into every tile's program; the per-tile
    #: change products ride the manifest and assemble into change_*.tif.
    #: The mmu sieve needs the whole raster: apply
    #: ``ops.change.sieve_change_rasters`` to the assembled out_dir (the
    #: CLI's ``--change-mmu`` does).  Fingerprinted
    change_filt: "ChangeFilter | None" = None
    scale: float = 2.75e-5
    offset: float = -0.2
    reject_bits: int = idx.DEFAULT_QA_REJECT
    #: output raster compression: "deflate", "lzw" or "none"
    out_compress: str = "deflate"
    #: per-tile checkpoint artifact compression: "none" or "deflate"
    manifest_compress: str = "none"
    #: background tile-writer threads
    write_workers: int = 1
    #: background feed threads, or "auto"
    feed_workers: "int | str" = 1
    #: decoded-block cache budget (MiB) for the windowed feed path
    #: (:mod:`land_trendr_tpu_torch.io.blockcache`); process-wide, and
    #: (re)configured per run.  ``0`` disables; "auto" resolves through
    #: the tuning store.  Never fingerprinted
    feed_cache_mb: "int | str" = 256
    #: feed-decode threads: 0 = the codec's own choice, 1 = serial, N = N
    #: threads; "auto" resolves through the tuning store
    decode_workers: "int | str" = 0
    #: hint the next planned tile's block set to the decode pool (lazy
    #: file-backed stacks with ``feed_cache_mb > 0`` only)
    feed_readahead: bool = True
    #: overview pyramid levels on output rasters (0 = none, N = that many
    #: 2× nearest-neighbour reductions, "auto" = reduce until the smaller
    #: side is under 256)
    out_overviews: "int | str" = 0
    #: tiles with more pixels than this run the segmentation chunked;
    #: ``None`` disables chunking, "auto" resolves through the tuning
    #: store.  Fingerprinted (the resolved value).
    chunk_px: "int | str | None" = 262_144
    #: segmentation implementation: "auto" (the kernel on a CUDA device,
    #: the plain version on the CPU); "cuda" or "torch" must name the one
    #: the run's device gives, else the run raises
    impl: str = "auto"
    #: run-wide telemetry (:mod:`land_trendr_tpu_torch.obs`): the
    #: ``events.jsonl`` stream and the ``metrics.prom`` exposition under
    #: ``workdir``.  Never fingerprinted
    telemetry: bool = False
    #: with ``telemetry``: serve a live ``/metrics`` endpoint on this port
    #: (0 = ephemeral, reported in the run summary); ``None`` = no server
    metrics_port: "int | None" = None
    #: bind address for the ``/metrics`` server ("" = all interfaces)
    metrics_host: str = ""
    #: ``metrics.prom`` refresh period, seconds
    metrics_interval_s: float = 5.0
    #: with ``telemetry``: the flight recorder — a bounded ring mirroring
    #: every telemetry emit plus a resource sampler (RSS, fds, threads,
    #: backlogs, cache occupancy, device memory), dumped to
    #: ``<workdir>/flight.jsonl`` at run end, success and abort alike
    flight: bool = False
    #: flight-ring capacity, events (0 disables ring and sampler)
    flight_ring_events: int = 2048
    #: flight resource-sampler period, seconds
    sampler_interval_s: float = 5.0
    #: with ``telemetry``: fleet telemetry publish (:mod:`land_trendr_tpu_torch.
    #: obs.publish`) — periodically snapshot this process's metrics registry
    #: and live progress/straggler/quarantine state into an atomic
    #: ``<telemetry_dir>/<host>.<pid>.snap.json``, the per-process feed the
    #: pod aggregate folds.  An execution fact, never fingerprinted; a failed
    #: beat is a skipped beat, never a failed run.
    publish: bool = False
    #: fleet snapshot refresh period, seconds
    publish_interval_s: float = 5.0
    #: shared telemetry directory override (default ``<workdir>/telemetry``)
    telemetry_dir: "str | None" = None
    #: tuning store (:mod:`land_trendr_tpu_torch.tune`, written by ``lt
    #: tune``) the "auto" knobs resolve through at Run construction; a key
    #: miss or ``None`` gives the defaults above
    tune_store_dir: "str | None" = None

    def __post_init__(self) -> None:
        for name in (
            "tile_size", "chunk_px", "fetch_depth", "upload_depth",
            "feed_workers", "decode_workers", "feed_cache_mb", "out_overviews",
        ):
            v = getattr(self, name)
            if isinstance(v, str) and v != AUTO:
                raise ValueError(f"{name}={v!r} must be an integer or 'auto'")
        if self.tile_size != AUTO and (not isinstance(self.tile_size, int) or self.tile_size < 1):
            raise ValueError(f"tile_size={self.tile_size!r} must be an integer >= 1")
        if self.index.lower() not in idx.INDEX_NAMES:
            raise ValueError(f"unknown index {self.index!r}; expected one of {idx.INDEX_NAMES}")
        if self.out_compress not in ("deflate", "lzw", "none"):
            raise ValueError(
                f"out_compress={self.out_compress!r} not one of 'deflate', 'lzw', 'none'"
            )
        if self.manifest_compress not in ARTIFACT_COMPRESS:
            raise ValueError(
                f"manifest_compress={self.manifest_compress!r} not one of "
                f"{ARTIFACT_COMPRESS}"
            )
        if self.products is not None:
            bad = [p for p in self.products if p not in _SEG_PRODUCTS]
            if bad:
                raise ValueError(f"unknown products {bad}; choose from {_SEG_PRODUCTS}")
            if not self.products:
                raise ValueError("products subset must not be empty (use None)")
        if not isinstance(self.ftv_indices, tuple):
            raise ValueError(f"ftv_indices={self.ftv_indices!r} must be a tuple of index names")
        bad = [i for i in self.ftv_indices if str(i).lower() not in idx.INDEX_NAMES]
        if bad:
            raise ValueError(f"unknown ftv_indices {bad}; expected some of {idx.INDEX_NAMES}")
        if not isinstance(self.ensemble_indices, tuple):
            raise ValueError(
                f"ensemble_indices={self.ensemble_indices!r} must be a tuple of index names")
        bad = [i for i in self.ensemble_indices if str(i).lower() not in idx.INDEX_NAMES]
        if bad:
            raise ValueError(
                f"unknown ensemble_indices {bad}; expected some of {idx.INDEX_NAMES}")
        ens = [str(i).lower() for i in self.ensemble_indices]
        if len(set(ens)) != len(ens) or self.index.lower() in ens:
            raise ValueError(
                f"ensemble_indices={self.ensemble_indices!r} must name each index once "
                f"and not the primary index {self.index!r}")
        if self.change_filt is not None and not isinstance(self.change_filt, ChangeFilter):
            raise ValueError(f"change_filt={self.change_filt!r} is not a ChangeFilter")
        if self.impl not in ("auto", "cuda", "torch"):
            raise ValueError(f"impl={self.impl!r} not one of 'auto', 'cuda', 'torch'")
        if self.chunk_px is not None and self.chunk_px != AUTO:
            if not isinstance(self.chunk_px, int) or self.chunk_px < 1:
                raise ValueError(
                    f"chunk_px={self.chunk_px!r} must be an integer >= 1 (or None)"
                )
            if (
                self.impl == "cuda"
                and self.chunk_px > CUDA_BLOCK
                and self.chunk_px % CUDA_BLOCK
            ):
                raise ValueError(
                    f"chunk_px={self.chunk_px} must be a multiple of {CUDA_BLOCK} "
                    "(the CUDA block) when impl='cuda'"
                )
        for name in ("fetch_packed", "upload_packed"):
            if getattr(self, name) not in (True, False, "auto"):
                raise ValueError(f"{name}={getattr(self, name)!r} not one of True, False, 'auto'")
        for name in ("fetch_depth", "upload_depth", "write_workers", "feed_workers"):
            v = getattr(self, name)
            if v != AUTO and (not isinstance(v, int) or v < 1):
                raise ValueError(f"{name}={v!r} must be an integer >= 1")
        for name, what in (
            ("feed_cache_mb", "0 = off"),
            ("decode_workers", "0 = auto"),
            ("ingest_store_mb", "0 = off"),
        ):
            v = getattr(self, name)
            if v != AUTO and (not isinstance(v, int) or v < 0):
                raise ValueError(f"{name}={v!r} must be an integer >= 0 ({what})")
        if self.ingest_store_dir is not None and not self.ingest_store_mb:
            raise ValueError(
                "ingest_store_dir requires ingest_store_mb > 0 (there is "
                "no store to place without a budget)"
            )
        if self.out_overviews != AUTO and (
            not isinstance(self.out_overviews, int) or self.out_overviews < 0
        ):
            raise ValueError(f"out_overviews={self.out_overviews!r} must be >= 0 or 'auto'")
        if self.metrics_port is not None:
            if not self.telemetry:
                raise ValueError(
                    "metrics_port requires telemetry=True (the registry the "
                    "endpoint serves only exists on telemetry runs)"
                )
            if not (0 <= self.metrics_port <= 65535):
                raise ValueError(f"metrics_port={self.metrics_port} outside 0..65535")
        elif self.metrics_host:
            raise ValueError(
                "metrics_host requires metrics_port (there is no server "
                "to bind without a port)"
            )
        if self.telemetry and self.metrics_interval_s <= 0:
            raise ValueError(f"metrics_interval_s={self.metrics_interval_s} must be > 0")
        if self.flight and not self.telemetry:
            raise ValueError(
                "flight requires telemetry=True (the ring mirrors the "
                "telemetry event stream; there is nothing to record "
                "without one)"
            )
        if self.flight_ring_events < 2 and self.flight_ring_events != 0:
            raise ValueError(
                f"flight_ring_events={self.flight_ring_events} must be "
                ">= 2 (a useful ring holds at least a run_start and one "
                "event) or 0 (ring + sampler disabled)"
            )
        if self.sampler_interval_s <= 0:
            raise ValueError(f"sampler_interval_s={self.sampler_interval_s} must be > 0")
        if self.publish and not self.telemetry:
            raise ValueError(
                "publish requires telemetry=True (the fleet snapshot is "
                "a dump of the telemetry registry; there is nothing to "
                "publish without one)"
            )
        if self.publish_interval_s <= 0:
            raise ValueError(f"publish_interval_s={self.publish_interval_s} must be > 0")
        if self.telemetry_dir is not None and not self.publish:
            raise ValueError(
                "telemetry_dir requires publish=True (there is no "
                "snapshot to place without a publisher)"
            )
        if not isinstance(self.max_retries, int) or self.max_retries < 0:
            raise ValueError(f"max_retries={self.max_retries!r} must be an integer >= 0")
        if self.retry_backoff_s < 0:
            raise ValueError(f"retry_backoff_s={self.retry_backoff_s} must be >= 0")
        if self.stall_timeout_s is not None and self.stall_timeout_s <= 0:
            raise ValueError(
                f"stall_timeout_s={self.stall_timeout_s} must be > 0 "
                "(or None to disable the watchdog)"
            )
        if self.straggler_k < 1.0:
            raise ValueError(
                f"straggler_k={self.straggler_k} must be >= 1.0 (a "
                "threshold below the rolling median would flag typical "
                "tiles as stragglers)"
            )
        if self.straggler_min_tiles < 1:
            raise ValueError(f"straggler_min_tiles={self.straggler_min_tiles} must be >= 1")
        if self.merge_timeout_s is not None and self.merge_timeout_s <= 0:
            raise ValueError(
                f"merge_timeout_s={self.merge_timeout_s} must be > 0 "
                "(or None for the wall-time-derived bound)"
            )
        if self.lease_batch < 0:
            raise ValueError(
                f"lease_batch={self.lease_batch} must be >= 0 (0 = static "
                "host_share split, N = elastic lease queue)"
            )
        if self.lease_ttl_s <= 0:
            raise ValueError(f"lease_ttl_s={self.lease_ttl_s} must be > 0")
        if self.speculate and not self.lease_batch:
            raise ValueError(
                "speculate requires lease_batch > 0 (speculative execution "
                "is a lease-queue path; there is no queue to re-lease from)"
            )
        if self.fault_schedule is not None:
            # parse NOW: a typo'd seam is a config error, not a dead injection
            faults.parse_schedule(self.fault_schedule)

    def fingerprint(self, stack: RasterStack) -> str:
        """The run-defining configuration's hash (the JAX package's payload,
        and ``ensemble_indices`` when not empty; the resolved impl is an
        execution fact, kept out of it)."""
        ensemble = {"ensemble": list(self.ensemble_indices)} if self.ensemble_indices else {}
        return run_fingerprint(
            {
                **ensemble,
                "index": self.index,
                "ftv": list(self.ftv_indices),
                "params": self.params.to_dict(),
                "tile": self.tile_size,
                "years": stack.years.tolist(),
                "shape": list(stack.shape),
                "scale": self.scale,
                "offset": self.offset,
                "reject_bits": self.reject_bits,
                "write_fitted": self.write_fitted,
                "products": list(self.products) if self.products is not None else None,
                "fetch_f16": self.fetch_f16,
                "change": (
                    dataclasses.asdict(self.change_filt)
                    if self.change_filt is not None else None
                ),
                "chunk_px": self.chunk_px,
            }
        )


def _device_live_bytes(dev: torch.device) -> "int | None":
    """Allocator live bytes summed over the local CUDA devices, or None on
    the CPU — the device-memory watermark feed of the telemetry gauges."""
    if dev.type != "cuda":
        return None
    return sum(torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count()))


@dataclasses.dataclass(frozen=True)
class TileSpec:
    """One tile's window in the scene grid."""

    tile_id: int
    y0: int
    x0: int
    h: int
    w: int


def plan_tiles(height: int, width: int, tile_size: int) -> list[TileSpec]:
    """Row-major fixed-grid tiling; edge tiles are smaller windows but are
    padded to the full tile pixel count at feed time."""
    tiles = []
    tid = 0
    for y0 in range(0, height, tile_size):
        for x0 in range(0, width, tile_size):
            tiles.append(
                TileSpec(
                    tile_id=tid,
                    y0=y0,
                    x0=x0,
                    h=min(tile_size, height - y0),
                    w=min(tile_size, width - x0),
                )
            )
            tid += 1
    return tiles


def _feed_tile(
    stack: RasterStack, t: TileSpec, tile_px: int, bands: tuple[str, ...]
) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Slice one tile into ``(tile_px, NY)`` arrays, padding with QA=fill.

    Only ``bands`` (what the index and the FTV indices need) are cut and
    shipped.  The transpose puts the year axis innermost; padded rows
    carry the QA fill bit so the device mask logic (not host special
    cases) voids them.  Lazy file-backed cubes take the slicing path,
    which window-reads just this tile.
    """
    ny = stack.n_years
    px = t.h * t.w

    def cut(a: np.ndarray) -> np.ndarray:
        if native.available() and isinstance(a, np.ndarray):
            try:
                return native.gather_tile(a, t.y0, t.x0, t.h, t.w)
            except native.NativeCodecError as e:
                log.debug("native gather_tile unavailable (%s); NumPy path", e)
        win = a[:, t.y0 : t.y0 + t.h, t.x0 : t.x0 + t.w]
        return np.ascontiguousarray(win.reshape(ny, px).T)

    dn = {name: cut(stack.dn_bands[name]) for name in bands}
    qa = cut(stack.qa)
    if px < tile_px:
        pad = tile_px - px
        dn = {
            name: np.concatenate([a, np.zeros((pad, ny), a.dtype)]) for name, a in dn.items()
        }
        qa_pad = np.full((pad, ny), 1, dtype=qa.dtype)  # QA fill bit set
        qa = np.concatenate([qa, qa_pad])
    return dn, qa


def _prefetch_tile(stack: RasterStack, t: TileSpec, bands: tuple[str, ...]) -> None:
    """Readahead hint for one planned tile: every lazy file-backed cube
    this run feeds queues its window's block decode into the shared cache.
    No-op for in-RAM cubes."""
    for name in (*bands, "qa"):
        cube = stack.qa if name == "qa" else stack.dn_bands.get(name)
        pf = getattr(cube, "prefetch_window", None)
        if pf is not None:
            pf(t.y0, t.x0, t.h, t.w)


def resolve_device(device: "str | torch.device") -> torch.device:
    """The run's device: "cuda" (default for entry points) or "cpu".

    A CUDA request on a machine without a usable card raises — a run never
    carries on on the CPU in its place.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is False "
                "(no usable CUDA card); pass device 'cpu' (--device cpu) only for "
                "tests and debugging"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"device {device!r} is neither 'cuda' nor 'cpu'")
    return dev


def run_stack(
    stack: RasterStack,
    cfg: RunConfig,
    tiles: "Sequence[TileSpec] | None" = None,
    device: "str | torch.device" = "cuda",
    mesh: "Sequence[torch.device | str] | None" = None,
) -> dict:
    """Segment a whole stack tile by tile on ``device`` (or over ``mesh``);
    returns the run summary.  The one-shot wrapper: ``Run(...).execute()``.

    Raster outputs are not written here — call :func:`assemble_outputs`
    after (assembly only needs the workdir).
    """
    return Run(stack, cfg, tiles=tiles, device=device, mesh=mesh).execute()


class Run:
    """One segmentation run's explicit, per-run state.

    * **per-run** — manifest, telemetry (with an optional ``job_id`` and
      ``trace_id`` on every event), fetcher/uploader, stall watchdog,
      stage timer, quarantine ledger, straggler detector, progress dict;
    * **explicitly shared** — the process-wide decoded-block cache (left
      to its owner with ``shared_cache=True``), an optional ``flight``
      ring (a serving layer's; mirrored into, never sampled or dumped
      here), and the process-global fault plan (a run arms one only when
      none is active);
    * **cancellable** — ``cancel`` (a ``threading.Event``) is polled at
      every pipeline step boundary; once set the run raises
      :class:`RunCancelled` and unwinds through the normal abort path.

    ``on_tile_durable(tile, arrays, meta)`` is called on the writer thread
    once a tile's artifact is durable; its errors are logged, never the
    tile's.  ``programs`` (a :class:`~land_trendr_tpu_torch.serve.programs.
    ProgramCache`) admits warm programs across runs; ``shared_store`` is a
    serving layer's long-lived ingest store (used, never closed; implies
    ``shared_cache``).

    ``mesh`` (a list of devices of ``device``'s type, see
    :func:`~land_trendr_tpu_torch.parallel.make_mesh`) shards every tile's
    pixels over those devices, one launch per shard.  In a pod (a
    process group from :func:`~land_trendr_tpu_torch.parallel.
    init_distributed`) each process takes its ``host_share`` of the tiles
    unless ``cfg.lease_batch`` makes them claim from the lease queue, and
    the primary folds every process's event stream into its summary.
    ``"auto"`` knobs of ``cfg`` are resolved here, once, for the run's
    device (``self.cfg`` is the resolved config; ``self.tune_info`` says
    which profile, None when nothing was "auto").
    """

    def __init__(
        self,
        stack: RasterStack,
        cfg: RunConfig,
        tiles: "Sequence[TileSpec] | None" = None,
        device: "str | torch.device" = "cuda",
        mesh: "Sequence[torch.device | str] | None" = None,
        *,
        job_id: "str | None" = None,
        trace_id: "str | None" = None,
        cancel: "threading.Event | None" = None,
        programs=None,
        shared_store=None,
        shared_cache: bool = False,
        flight=None,
        on_tile_durable=None,
    ) -> None:
        self.device = resolve_device(device)
        self.mesh = make_mesh(mesh) if mesh is not None else None
        if self.mesh is not None and self.mesh[0].type != self.device.type:
            raise ValueError(
                f"mesh devices {[str(d) for d in self.mesh]} are not of the "
                f"run's device type {self.device.type!r}"
            )
        # "auto" knobs resolve HERE, before anything reads a knob: a
        # deterministic store read for this device and scene class, never a
        # probe; tune_info is the tune_profile event execute() emits
        cfg, self.tune_info = resolve_config(
            cfg, scene_shape=(*stack.shape, stack.n_years), device=self.device
        )
        self.stack = stack
        self.cfg = cfg
        self.tiles = (
            list(tiles) if tiles is not None else plan_tiles(*stack.shape, cfg.tile_size)
        )
        self.job_id = job_id
        self.trace_id = trace_id
        self.cancel = cancel
        self.programs = programs
        self.shared_store = shared_store
        self.shared_cache = bool(shared_cache or shared_store is not None)
        if self.shared_cache and shared_store is None and cfg.ingest_store_mb:
            raise ValueError(
                "ingest_store_mb is set but the process cache is caller-"
                "owned (shared_cache=True): pass the caller's store via "
                "shared_store, or drop ingest_store_mb from this run's "
                "config"
            )
        self.flight = flight
        self.owns_flight = False
        self.sampler = None
        #: live progress snapshot; keys are fixed at construction (values
        #: overwrite in place), so a copy from another thread never races
        #: a resize.  The JAX package's key set.
        self.progress: dict = {
            "phase": "init",
            "tiles_total": 0,
            "tiles_todo": 0,
            "tiles_done": 0,
            "tiles_quarantined": 0,
            "retries": 0,
            "stragglers": 0,
            "tiles_leased": 0,
            "tiles_stolen": 0,
            "tiles_speculated": 0,
            "feed_backlog": 0,
            "write_backlog": 0,
            "fetch_backlog": 0,
            "upload_backlog": 0,
            "batch_jobs": 0,
            "batch_tiles": 0,
            "batch_occupancy": 0.0,
        }
        self.on_tile_durable = on_tile_durable
        self.straggler = StragglerDetector(
            k=cfg.straggler_k,
            min_tiles=cfg.straggler_min_tiles,
            on_straggler=self._note_straggler,
        )
        self.lease_q: "LeaseQueue | None" = None
        self.manifest: "TileManifest | None" = None
        self.telemetry = None
        self.fetcher = None
        self.uploader = None
        self.watchdog: "_StallWatchdog | None" = None
        self.store = None
        self.timer: "StageTimer | None" = None
        self.quarantined: "list[int]" = []
        self.fault_plan = None
        self.summary: "dict | None" = None
        #: this run's warm-program verdict (``programs`` runs only)
        self.program_stats: "dict | None" = None
        #: high watermark of the device allocator's live bytes at tile
        #: completions — the ``lt_device_bytes_peak`` gauge's value on
        #: telemetry runs (None on the CPU)
        self.device_bytes_peak: "int | None" = None

    def _note_straggler(
        self,
        tile_id: int,
        duration_s: float,
        threshold_s: float,
        median_s: float,
        in_flight: bool,
        attempt: int,
    ) -> None:
        """Detector verdict → progress + telemetry (``tile_straggler``)."""
        self.progress["stragglers"] = self.straggler.stats()["stragglers"]
        log.warning(
            "tile %d is a straggler: in-flight %.3fs > %.3fs "
            "(%.1fx rolling median %.3fs%s)",
            tile_id, duration_s, threshold_s, self.cfg.straggler_k,
            median_s, ", still running" if in_flight else "",
        )
        tel = self.telemetry
        if tel is not None:
            tel.tile_straggler(
                tile_id, duration_s, threshold_s, median_s,
                in_flight=in_flight, attempt=attempt,
            )
        # elastic runs: the verdict steers — flag the held lease so an idle
        # peer may speculatively re-lease the tile; best-effort, a failed
        # append must never kill the sampler thread or the run
        lq = self.lease_q
        if lq is not None and in_flight:
            try:
                lq.flag(tile_id)
            except Exception as exc:
                log.warning("straggler flag append failed for tile %d: %s", tile_id, exc)

    def _note_device_bytes(self) -> "int | None":
        b = _device_live_bytes(self.device)
        if b is not None and (self.device_bytes_peak is None or b > self.device_bytes_peak):
            self.device_bytes_peak = b
        return b

    def _sampler_probes(self) -> dict:
        """Host gauges for the flight sampler's ``flight_sample`` events:
        pipeline backlogs, decode-cache occupancy and the device allocator
        watermark on a CUDA device; also scans in-flight tiles for
        stragglers while the run is live."""
        if self.progress.get("phase") not in ("done", "aborted"):
            self.straggler.scan()
        p = self.progress
        out = {
            k: int(p[k])
            for k in (
                "feed_backlog", "write_backlog", "fetch_backlog",
                "upload_backlog", "stragglers", "tiles_stolen",
                "tiles_speculated",
            )
        }
        out.update(blockcache.occupancy_probe())
        dev = _device_live_bytes(self.device)
        if dev is not None:
            out["device_bytes_in_use"] = dev
        return out

    def _publish_probes(self) -> dict:
        """The ``state`` block of this run's fleet snapshot: the live
        progress dict plus the straggler/quarantine verdicts (read-only:
        the snapshot observes, the sampler judges)."""
        return {
            "progress": dict(self.progress),
            "stragglers": self.straggler.stats()["stragglers"],
            "tiles_quarantined": len(self.quarantined),
            "job_id": self.job_id,
            **({"tune": self.tune_info} if self.tune_info else {}),
        }

    def _dump_flight(self) -> "str | None":
        """Dump an OWNED ring to ``<workdir>/flight.jsonl``, best-effort."""
        if self.flight is None or not self.owns_flight:
            return None
        from land_trendr_tpu_torch.obs.flight import flight_path

        path = flight_path(self.cfg.workdir, process_index(), process_count())
        try:
            self.flight.dump(path)
        except Exception as exc:
            log.error("flight-ring dump failed (%s): %s", path, exc)
            return None
        return path

    def _check_cancel(self) -> None:
        """Raise :class:`RunCancelled` once the cancel event is set (polled
        at pipeline step boundaries: tile loop, retry ladder)."""
        if self.cancel is not None and self.cancel.is_set():
            raise RunCancelled(
                "run cancelled" + (f" (job {self.job_id})" if self.job_id else "")
            )

    def execute(self) -> dict:
        """Run the tile pipeline; returns (and stores) the run summary."""
        stack, cfg, dev, mesh = self.stack, self.cfg, self.device, self.mesh
        tiles = self.tiles
        tile_px = cfg.tile_size * cfg.tile_size
        n_mesh = len(mesh) if mesh is not None else 1
        p_index, p_count = process_index(), process_count()

        # validated BEFORE the workdir is touched, so a rejected run cannot
        # stamp a fresh manifest with a bad context
        if cfg.metrics_port and cfg.metrics_port + p_count - 1 > 65535:
            raise ValueError(
                f"metrics_port={cfg.metrics_port}: port + process_index "
                f"exceeds 65535 for a {p_count}-process run"
            )
        if mesh is not None:
            # chunking a sharded tile would re-split it, so the per-device
            # slice itself must satisfy the memory bound
            if cfg.chunk_px is not None and tile_px / n_mesh > cfg.chunk_px:
                raise ValueError(
                    f"per-device pixel slice {tile_px // n_mesh} exceeds "
                    f"chunk_px={cfg.chunk_px}: reduce tile_size (or raise "
                    "chunk_px if the devices' memory allows it) — chunking "
                    "cannot be combined with a sharded pixel axis"
                )
            # the fed tile is padded (QA fill bit) to a multiple of the mesh
            feed_px = tile_px + (-tile_px) % n_mesh
            chunk = None
        else:
            feed_px = tile_px
            chunk = cfg.chunk_px
        # each process takes its share of the FULL deterministic tile list
        # (identical everywhere), then filters resume-done tiles; elastic
        # mode instead claims from the whole list through the lease queue
        share = list(tiles) if cfg.lease_batch else host_share(tiles)
        impl_resolved = resolve_impl(cfg.impl, dev)
        if (
            impl_resolved == "cuda"
            and chunk is not None
            and chunk > CUDA_BLOCK
            and chunk % CUDA_BLOCK
        ):
            raise ValueError(
                f"chunk_px={chunk} must be a multiple of {CUDA_BLOCK} (the "
                "CUDA block) when the resolved impl is 'cuda'"
            )
        fetch_packed = fetchmod.resolve_packed(cfg.fetch_packed, dev)
        upload_packed = feedmod.resolve_packed(cfg.upload_packed, dev)
        if mesh is not None and upload_packed:
            if cfg.upload_packed is True:
                # the packed upload places ONE buffer on one device; a mesh
                # uploads per shard
                raise ValueError(
                    "upload_packed=True cannot be combined with a mesh "
                    "(sharded placement is per-shard); use upload_packed="
                    "'auto' or False"
                )
            upload_packed = False
        if cfg.telemetry and self.flight is None and cfg.flight and cfg.flight_ring_events:
            # standalone flight run: this run owns its ring (and the
            # sampler + run-end dump); created before any leakable resource
            from land_trendr_tpu_torch.obs.flight import FlightRecorder

            self.flight = FlightRecorder(cfg.flight_ring_events)
            self.owns_flight = True

        manifest = self.manifest = TileManifest(
            cfg.workdir,
            cfg.fingerprint(stack),
            context={"mesh_devices": n_mesh, "impl": impl_resolved},
        )
        done = manifest.open(cfg.resume)
        years_host = torch.from_numpy(stack.years.astype(np.int32))
        years = years_host.to(dev)
        years_on = {d: years_host.to(d) for d in mesh} if mesh is not None else {}
        bands = idx.required_bands(cfg.index, (*cfg.ftv_indices, *cfg.ensemble_indices))
        lease_q: "LeaseQueue | None" = None
        if cfg.lease_batch:
            # the elastic work source: tiles are claimed from the shared
            # manifest in lease_batch batches — ``todo`` starts empty and
            # grows as claims win
            lease_q = self.lease_q = LeaseQueue(
                manifest.path, [t.tile_id for t in share], ttl_s=cfg.lease_ttl_s, done0=done
            )
            spec_by_id = {t.tile_id: t for t in share}
            todo: "list[TileSpec]" = []
            n_todo_start = sum(1 for t in share if t.tile_id not in done)
            n_resume_skipped = len(share) - n_todo_start
        else:
            todo = [t for t in share if t.tile_id not in done]
            n_todo_start = len(todo)
            n_resume_skipped = len(share) - len(todo)
        self.progress.update(phase="setup", tiles_total=len(tiles), tiles_todo=n_todo_start)

        t_run = time.perf_counter()
        timer = self.timer = StageTimer()

        quarantined = self.quarantined
        fetch_failures = 0
        upload_failures = 0
        watchdog: "_StallWatchdog | None" = None
        telemetry = None

        def _backoff(attempt: int) -> None:
            """Exponential backoff + jitter before re-dispatching a failed
            tile; the 30s cap applies after the jitter."""
            if cfg.retry_backoff_s <= 0:
                return
            delay = cfg.retry_backoff_s * 2 ** (attempt - 1) * (0.5 + random.random())
            time.sleep(min(delay, _BACKOFF_CAP_S))

        def _note_fetch_failure() -> None:
            """Count one fetch-wait failure; demote the packed path after
            ``_FETCH_DEMOTE_AFTER`` consecutive ones."""
            nonlocal fetch_failures
            fetch_failures += 1
            if fetch_failures >= _FETCH_DEMOTE_AFTER and fetcher.packed:
                fetcher.demote()
                log.warning(
                    "packed fetch demoted to per-product transfers after "
                    "%d consecutive fetch failures (artifacts unaffected)",
                    fetch_failures,
                )
                if telemetry is not None:
                    telemetry.fetch_demoted(fetch_failures)

        def _note_fetch_ok() -> None:
            nonlocal fetch_failures
            fetch_failures = 0

        def _note_upload_failure() -> None:
            """The upload mirror of :func:`_note_fetch_failure`."""
            nonlocal upload_failures
            upload_failures += 1
            if upload_failures >= _UPLOAD_DEMOTE_AFTER and uploader.packed:
                uploader.demote()
                log.warning(
                    "packed upload demoted to per-array copies after "
                    "%d consecutive upload failures (artifacts unaffected)",
                    upload_failures,
                )
                if telemetry is not None:
                    telemetry.upload_demoted(upload_failures)

        def _note_upload_ok() -> None:
            nonlocal upload_failures
            upload_failures = 0

        def _retry_step(t: TileSpec, attempt: int, err, what: str = "") -> int:
            """One failed attempt's shared bookkeeping (the ladder, the feed
            retry and the writer-path fetch retry): log, exhaustion check
            (``tile_failed`` + :class:`TileRetriesExhausted`), ``tile_retry``,
            watchdog tick, backoff.  Returns the next attempt number."""
            self._check_cancel()
            log.warning(
                "tile %d %sattempt %d/%d failed: %s",
                t.tile_id, what, attempt, cfg.max_retries + 1, err,
            )
            if attempt > cfg.max_retries:
                if telemetry is not None:
                    telemetry.tile_failed(t.tile_id, attempt, err)
                exc = TileRetriesExhausted(t.tile_id, attempt, err)
                exc.__cause__ = err
                raise exc
            self.progress["retries"] += 1
            if telemetry is not None:
                telemetry.tile_retry(t.tile_id, attempt, err)
            if watchdog is not None:
                watchdog.tick()
            _backoff(attempt)
            return attempt + 1

        def _quarantine(t: TileSpec, exc: TileRetriesExhausted) -> None:
            """Record an exhausted tile and keep going — or re-raise when
            quarantine mode is off."""
            if not cfg.quarantine_tiles:
                raise exc
            quarantined.append(t.tile_id)
            self.straggler.drop(t.tile_id)
            self.progress["tiles_quarantined"] = len(quarantined)
            manifest.record_failed(t.tile_id, exc.attempts, str(exc.cause))
            if telemetry is not None:
                telemetry.tile_quarantined(t.tile_id, exc.attempts, str(exc.cause))
            log.error(
                "tile %d quarantined after %d attempts (%s); run continues — "
                "resume will re-attempt it", t.tile_id, exc.attempts, exc.cause,
            )

        def _dispatch(dn, qa):
            """Enqueue one tile's program and its fetch.

            ``dn``/``qa`` are device tensors (from the upload handle; on a
            mesh, lists of per-shard tensors) or the retained host arrays
            (the retry ladder, which uploads them afresh).  Returns
            ``((fetch_handle, done_events), None)`` or ``(None, exc)``;
            there is one event per launch on a CUDA device and none on the
            CPU, where the program has run by the time this returns.
            """
            try:
                with timer.stage("dispatch"):
                    faults.check("dispatch")
                    if isinstance(qa, np.ndarray):
                        if mesh is not None:
                            dn, qa = feedmod.to_mesh(dn, qa, mesh)
                        else:
                            dn, qa = feedmod.to_device(dn, qa, dev)
                    if mesh is None:
                        placed = [(dev, years, dn, qa)]
                    else:
                        placed = [(d, years_on[d], s_dn, s_qa)
                                  for d, s_dn, s_qa in zip(mesh, dn, qa)]
                    outs = []
                    done_evs = []
                    for d, y, t_dn, t_qa in placed:
                        # one launch per shard: the tile program runs on the
                        # device its tensors live on, on that device's stream
                        outs.append(process_tile_dn(
                            y, t_dn, t_qa,
                            index=cfg.index, params=cfg.params, scale=cfg.scale,
                            offset=cfg.offset, reject_bits=cfg.reject_bits,
                            chunk=chunk, impl=impl_resolved,
                            ftv_indices=cfg.ftv_indices, change_filt=cfg.change_filt,
                            ensemble_indices=cfg.ensemble_indices,
                        ))
                        if d.type == "cuda":
                            ev = torch.cuda.Event()
                            ev.record(torch.cuda.current_stream(d))
                            done_evs.append(ev)
                    out = outs if mesh is not None else outs[0]
                with timer.stage("fetch"):
                    # packed: the pack is enqueued right behind the tile's
                    # compute and its copy lands while the next tiles compute
                    handle = fetcher.start(out)
                return (handle, done_evs), None
            except Exception as e:
                return None, e

        def _compute_wait(done_evs) -> None:
            """The tile's compute-wait (fault seam ``compute.wait``): polls
            every launch's event (each shard's on a mesh), so a stall
            interrupt lands mid-wait."""
            with timer.stage("compute"):
                faults.check("compute.wait")
                for ev in done_evs:
                    fetchmod.wait_event(ev)

        fetcher = self.fetcher = fetchmod.TileFetcher(cfg, dev, packed=fetch_packed, mesh=mesh)
        uploader = self.uploader = feedmod.TileUploader(dev, packed=upload_packed, mesh=mesh)

        def _write_job(t: TileSpec, handle, dt: float) -> tuple[int, int]:
            with timer.stage("write"):
                # the per-product handle re-reads its retained device
                # outputs, so a transient fetch fault here gets the same
                # retry budget as the ladder
                attempt = 1
                while True:
                    try:
                        arrays, fit = handle.tile_arrays(t)
                        break
                    except Exception as e:
                        try:
                            attempt = _retry_step(t, attempt, e, what="writer-fetch ")
                        except TileRetriesExhausted as exc:
                            _quarantine(t, exc)
                            return 0, 0
                px = t.h * t.w
                meta = {
                    "y0": t.y0,
                    "x0": t.x0,
                    "h": t.h,
                    "w": t.w,
                    # elastic runs stamp the done record with its writer: the
                    # FIRST done record's owner is the race winner (how
                    # speculative wins are attributed)
                    **({"owner": lease_q.owner} if lease_q is not None else {}),
                    "px_per_s": round(tile_px / dt, 1),
                    "no_fit_rate": round(1.0 - fit / px, 4),
                }
                manifest.record(t.tile_id, arrays, meta, compress=cfg.manifest_compress)
            if self.on_tile_durable is not None:
                try:
                    self.on_tile_durable(t, arrays, meta)
                except Exception:
                    log.warning(
                        "on_tile_durable callback failed for tile %d", t.tile_id,
                        exc_info=True,
                    )
            log.info(
                "tile %d (%d,%d %dx%d): %.2fM px/s, no-fit %.1f%%",
                t.tile_id, t.y0, t.x0, t.h, t.w,
                meta["px_per_s"] / 1e6, 100 * meta["no_fit_rate"],
            )
            return px, fit

        writer = ThreadPoolExecutor(max_workers=cfg.write_workers, thread_name_prefix="lt-writer")
        pending_writes: deque = deque()
        pending_fetches: deque = deque()
        n_px = 0
        n_fit = 0
        n_done = 0

        def _collect_write(fut) -> None:
            """Backpressure + fail-fast: re-raises writer errors at the next tile."""
            nonlocal n_px, n_fit
            px, fit = fut.result()
            if watchdog is not None:
                watchdog.tick()
            n_px += px
            n_fit += fit

        def _drain_writes(limit: int) -> None:
            while len(pending_writes) > limit:
                _collect_write(pending_writes.popleft())

        def _submit_write(t: TileSpec, handle, dt: float) -> None:
            _drain_writes(cfg.write_workers - 1)
            pending_writes.append(writer.submit(_write_job, t, handle, dt))

        def _retry_ladder(t: TileSpec, dn, qa, attempt: int, err):
            """Synchronous tile retry from the retained HOST inputs: each
            attempt uploads them afresh, re-dispatches, awaits the compute
            and lands a fresh fetch before pipelining resumes.  Returns
            ``(handle, dt, attempt)`` or raises :class:`TileRetriesExhausted`
            after ``max_retries``."""
            while True:
                attempt = _retry_step(t, attempt, err)
                if telemetry is not None:
                    telemetry.tile_start(t.tile_id, attempt=attempt)
                self.straggler.start(t.tile_id, attempt)
                t0 = time.perf_counter()
                work, err = _dispatch(dn, qa)
                if err is not None:
                    continue
                handle, done_ev = work
                try:
                    _compute_wait(done_ev)
                    dt = time.perf_counter() - t0
                except Exception as e:
                    err = e
                    continue
                try:
                    t0_fx = time.perf_counter()
                    with timer.stage("fetch"):
                        handle.wait()
                    _note_fetch_ok()
                    if telemetry is not None:
                        telemetry.span(
                            "fetch", t.tile_id, t0_fx, time.perf_counter(), attempt=attempt
                        )
                    return handle, dt, attempt
                except Exception as e:
                    _note_fetch_failure()
                    err = e

        def _tile_completed(t: TileSpec, dt: float) -> None:
            """Emit tile_done and count the tile (on the packed path only
            once its fetch has landed)."""
            nonlocal n_done
            n_done += 1
            self.progress.update(
                tiles_done=n_done,
                feed_backlog=len(pending_feeds),
                write_backlog=len(pending_writes),
                fetch_backlog=len(pending_fetches),
                upload_backlog=len(pending_uploads),
            )
            self.straggler.finish(t.tile_id)
            self.straggler.scan()
            if watchdog is not None:
                watchdog.tick()
            dev_bytes = self._note_device_bytes()
            if telemetry is not None:
                telemetry.tile_done(
                    t.tile_id,
                    t.h * t.w,
                    dt,
                    feed_backlog=len(pending_feeds),
                    write_backlog=len(pending_writes),
                    device_bytes_in_use=dev_bytes,
                    fetch_backlog=len(pending_fetches),
                )

        def _drain_fetches(limit: int) -> None:
            """Collect the oldest in-flight fetches until at most ``limit``
            remain; a failure surfacing through a fetch re-enters the retry
            ladder from the tile's retained host inputs."""
            while len(pending_fetches) > limit:
                t, handle, dn, qa, dt, attempt = pending_fetches.popleft()
                try:
                    t0_fx = time.perf_counter()
                    with timer.stage("fetch"):
                        handle.wait()
                    _note_fetch_ok()
                    if telemetry is not None:
                        telemetry.span(
                            "fetch", t.tile_id, t0_fx, time.perf_counter(), attempt=attempt
                        )
                except Exception as err:
                    _note_fetch_failure()
                    try:
                        handle, dt, attempt = _retry_ladder(t, dn, qa, attempt, err)
                    except TileRetriesExhausted as e:
                        _quarantine(t, e)
                        continue
                _tile_completed(t, dt)
                _submit_write(t, handle, dt)

        def _finish(pending) -> None:
            """Await one in-flight tile (retrying on failure) and queue its
            write as the bounded fetch backlog drains.  The pending tuple's
            attempt is > 1 when the tile's feed already spent retries — one
            budget per tile across phases."""
            t, work, err, dn, qa, dt_dispatch, attempt = pending
            handle = None
            if err is None:
                handle, done_ev = work
                try:
                    t0 = time.perf_counter()
                    _compute_wait(done_ev)
                    dt = dt_dispatch + (time.perf_counter() - t0)
                    if watchdog is not None:
                        watchdog.tick()
                except Exception as e:
                    err = e
            if err is not None:
                try:
                    handle, dt, attempt = _retry_ladder(t, dn, qa, attempt, err)
                except TileRetriesExhausted as e:
                    _quarantine(t, e)
                    return
            if not handle.packed:
                # per-product path: the write job runs the transfers itself
                _tile_completed(t, dt)
                _submit_write(t, handle, dt)
                return
            pending_fetches.append((t, handle, dn, qa, dt, attempt))
            fetcher.note_backlog(len(pending_fetches))
            _drain_fetches(cfg.fetch_depth - 1)

        try:
            feeder = ThreadPoolExecutor(
                max_workers=cfg.feed_workers, thread_name_prefix="lt-feeder"
            )
        except BaseException:
            writer.shutdown(wait=False, cancel_futures=True)
            raise
        pending_feeds: deque = deque()

        def _feed_job(t: TileSpec, readahead: "TileSpec | None" = None):
            """Returns ``(dn, qa, (t0, t1))``: the fed arrays and the feed
            span's bounds (emitted by the consumer on the driver thread)."""
            t0_span = time.perf_counter()
            with timer.stage("feed"):
                faults.check("feed")
                fed = _feed_tile(stack, t, feed_px, bands)
            t1_span = time.perf_counter()
            if readahead is not None:
                _prefetch_tile(stack, readahead, bands)
            return (*fed, (t0_span, t1_span))

        def _refeed(t: TileSpec, err: BaseException):
            """Synchronous feed retry in the tile's retry budget.  Returns
            ``(dn, qa, feed_span, attempt)`` or ``None`` when the tile was
            quarantined; an exhausted budget raises
            :class:`TileRetriesExhausted`."""
            attempt = 1
            while True:
                try:
                    attempt = _retry_step(t, attempt, err, what="feed ")
                except TileRetriesExhausted as exc:
                    _quarantine(t, exc)
                    return None
                try:
                    return (*_feed_job(t), attempt)
                except Exception as e:
                    err = e

        # the feed-path decode subsystem (process-wide): decoded-block LRU +
        # shared decode pool + readahead, and with ingest_store_mb the
        # persistent store behind it — acceleration only, byte-identical
        store = self.shared_store
        owns_store = store is None and bool(cfg.ingest_store_mb)

        def _release_setup() -> None:
            feeder.shutdown(wait=False, cancel_futures=True)
            writer.shutdown(wait=False, cancel_futures=True)
            if store is not None and owns_store:
                try:
                    store.close()
                except Exception as exc:
                    log.error("ingest-store close failed during setup unwind: %s", exc)
                blockcache.detach_store(store)

        try:
            if owns_store:
                from land_trendr_tpu_torch.io.blockstore import BlockStore

                store = BlockStore(
                    cfg.ingest_store_dir or os.path.join(cfg.workdir, "ingest_store"),
                    budget_bytes=cfg.ingest_store_mb << 20,
                )
            if not self.shared_cache:
                blockcache.configure(
                    budget_bytes=cfg.feed_cache_mb << 20,
                    workers=cfg.decode_workers,
                    store=store,
                )
            feed_cache_base = blockcache.stats_snapshot()
            store_base = store.stats_snapshot() if store is not None else None
        except BaseException:
            _release_setup()
            raise
        self.store = store

        if cfg.telemetry:
            from land_trendr_tpu_torch.obs import Telemetry
            from land_trendr_tpu_torch.obs import publish as obs_publish

            try:
                # per-process port fan-out (port + process_index), like the
                # per-process event and metrics file names
                metrics_port = cfg.metrics_port
                if metrics_port:
                    metrics_port += p_index
                telemetry = self.telemetry = Telemetry(
                    cfg.workdir,
                    fingerprint=manifest.fingerprint,
                    process_index=p_index,
                    process_count=p_count,
                    metrics_port=metrics_port,
                    metrics_host=cfg.metrics_host,
                    metrics_interval_s=cfg.metrics_interval_s,
                    job_id=self.job_id,
                    trace_id=self.trace_id,
                    flight=self.flight,
                    # the per-process snapshot feed the pod aggregate folds
                    # (stopped in close(), success and abort alike)
                    publish_dir=(
                        (cfg.telemetry_dir or obs_publish.telemetry_dir(cfg.workdir))
                        if cfg.publish else None
                    ),
                    publish_interval_s=cfg.publish_interval_s,
                    publish_probes=self._publish_probes,
                )
            except BaseException:
                _release_setup()
                raise
            try:
                manifest.telemetry = telemetry
                rs_rec = telemetry.run_start(
                    fingerprint=manifest.fingerprint,
                    process_index=p_index,
                    process_count=p_count,
                    tiles_total=len(tiles),
                    tiles_todo=n_todo_start,
                    tiles_skipped_resume=n_resume_skipped,
                    mesh_devices=n_mesh,
                    impl=impl_resolved,
                    **({"run_id": manifest.run_id} if manifest.run_id is not None else {}),
                )
                try:
                    manifest.record_clock_anchor(
                        run_id=rs_rec.get("run_id", ""),
                        host=rs_rec.get("host", ""),
                        process_index=p_index,
                        anchor_wall=rs_rec.get("anchor_wall", rs_rec["t_wall"]),
                        anchor_mono=rs_rec.get("anchor_mono", rs_rec["t_mono"]),
                    )
                except OSError as exc:
                    log.warning("manifest clock-anchor append failed: %s", exc)
                if self.tune_info is not None:
                    # which profile this run's "auto" knobs resolved through
                    telemetry.tune_profile(**self.tune_info)
            except BaseException:
                manifest.telemetry = None
                try:
                    telemetry.close()
                finally:
                    _release_setup()
                raise

        # fault injection + stall watchdog + flight sampler are armed after
        # telemetry exists (their events need somewhere to go)
        fault_plan = None
        sampler = None
        try:
            if cfg.fault_schedule:
                if faults.active() is not None:
                    raise ValueError(
                        "fault_schedule set while another fault plan is "
                        "already active in this process"
                    )
                fault_plan = self.fault_plan = faults.activate(
                    faults.parse_schedule(cfg.fault_schedule)
                )
                if telemetry is not None:
                    faults.set_observer(telemetry.fault_injected)
                log.warning(
                    "fault injection ACTIVE (%s) — this is a test/soak run",
                    cfg.fault_schedule,
                )
            if cfg.stall_timeout_s is not None:
                if threading.current_thread() is not threading.main_thread():
                    raise ValueError(
                        "stall_timeout_s requires the run on the process main "
                        "thread (the watchdog aborts via interrupt_main)"
                    )

                def _on_stall(idle_s: float) -> None:
                    if telemetry is not None:
                        telemetry.stall(idle_s, cfg.stall_timeout_s)

                watchdog = self.watchdog = _StallWatchdog(cfg.stall_timeout_s, _on_stall).start()
            if self.owns_flight:
                from land_trendr_tpu_torch.obs.flight import ResourceSampler

                sampler = self.sampler = ResourceSampler(
                    telemetry.events.emit,
                    cfg.sampler_interval_s,
                    probes=self._sampler_probes,
                ).start()
        except BaseException:
            try:
                if sampler is not None:
                    sampler.stop()
            finally:
                try:
                    if watchdog is not None:
                        watchdog.stop()
                finally:
                    try:
                        if fault_plan is not None:
                            faults.set_observer(None)
                            faults.deactivate()
                    finally:
                        try:
                            if telemetry is not None:
                                manifest.telemetry = None
                                telemetry.close()
                        finally:
                            _release_setup()
            raise

        # readahead rides the feed submissions: the tile fed at index i
        # hints the tile at i + feed_workers + 1, the first past the queue
        ra_depth = cfg.feed_workers + 1
        readahead_on = cfg.feed_readahead and cfg.feed_cache_mb > 0

        def _submit_feed(i: int) -> None:
            ra = todo[i + ra_depth] if readahead_on and i + ra_depth < len(todo) else None
            pending_feeds.append((todo[i], feeder.submit(_feed_job, todo[i], ra)))

        pending_uploads: deque = deque()

        def _pump_uploads() -> None:
            """Resolve fed tiles and issue their uploads until the bounded
            in-flight window is full (or the feed queue is empty).  A feed
            failure re-enters the tile's retry budget (``_refeed``); a
            quarantined feed never enters the queue.  The fed host arrays
            ride the queue to the end of the tile (the retry ladder's
            inputs)."""
            nonlocal next_i
            depth = cfg.upload_depth if uploader.packed else 1
            while pending_feeds and len(pending_uploads) < depth:
                t, fut = pending_feeds.popleft()
                if next_i < len(todo):
                    _submit_feed(next_i)
                    next_i += 1
                attempt0 = 1
                try:
                    dn, qa, feed_span = fut.result()
                except Exception as e:
                    fed = _refeed(t, e)
                    if fed is None:
                        continue
                    dn, qa, feed_span, attempt0 = fed
                if telemetry is not None:
                    telemetry.span("feed", t.tile_id, *feed_span, attempt=attempt0)
                if watchdog is not None:
                    watchdog.tick()
                with timer.stage("upload"):
                    try:
                        handle = uploader.start(dn, qa)
                    except Exception as e:
                        # an issue-time upload failure counts toward demotion;
                        # this tile takes the per-array path
                        _note_upload_failure()
                        log.warning(
                            "tile %d packed-upload issue failed (%s); "
                            "per-array copies for this tile", t.tile_id, e,
                        )
                        handle = feedmod.SyncUpload(uploader, dn, qa)
                pending_uploads.append((t, handle, dn, qa, attempt0))
                uploader.note_backlog(len(pending_uploads))

        def _prime_feeds() -> None:
            """Fill the bounded feed queue from ``todo`` (run start, and
            elastic refills after the pipeline ran dry)."""
            nonlocal next_i
            while next_i < len(todo) and len(pending_feeds) < ra_depth:
                _submit_feed(next_i)
                next_i += 1

        def _refill_work() -> int:
            """Elastic mode: claim another lease batch and feed the won
            tiles; returns the number won.  A failed claim (the
            ``lease.acquire``/``lease.steal`` seams, a shared-filesystem
            blip) is logged and retried next cycle."""
            try:
                won = lease_q.acquire(cfg.lease_batch, speculate=cfg.speculate)
            except Exception as e:
                log.warning("lease acquisition failed (%s); retrying next cycle", e)
                if watchdog is not None:
                    watchdog.tick()  # a failed claim is still liveness
                return 0
            for tile_id, mode, lease in won:
                todo.append(spec_by_id[tile_id])
                self.progress["tiles_leased"] += 1
                if mode == "steal":
                    self.progress["tiles_stolen"] += 1
                    log.info("stole tile %d (lease expired; claimed gen %d)", tile_id, lease.gen)
                    if telemetry is not None:
                        telemetry.lease_stolen(
                            tile_id, lease.gen, owner=lease_q.owner, from_owner=lease.prev_owner
                        )
                elif mode == "spec":
                    self.progress["tiles_speculated"] += 1
                    log.info(
                        "speculatively re-leased straggler tile %d (gen %d; first "
                        "durable write wins)", tile_id, lease.gen,
                    )
                    if telemetry is not None:
                        telemetry.tile_speculated(
                            tile_id, lease.gen, owner=lease_q.owner, from_owner=lease.prev_owner
                        )
                elif telemetry is not None:
                    telemetry.tile_leased(tile_id, lease.gen, owner=lease_q.owner)
            if won:
                _prime_feeds()
            return len(won)

        def _lease_idle_wait() -> None:
            """Nothing claimable while peers hold the undone tiles: wait one
            bounded beat.  Waiting out a live peer's lease is not a stall,
            so the watchdog is ticked; cancel still lands within a beat."""
            if watchdog is not None:
                watchdog.tick()
            time.sleep(min(0.5, max(cfg.lease_ttl_s / 8.0, 0.05)))

        def _warm_programs() -> dict:
            # serve-mode warm program cache: on a MISS the run pays the
            # kernel library's load and the tile program's first launch NOW,
            # on one fully masked dummy tile pushed through the upload ->
            # dispatch -> fetch chain; on a HIT the dummy is skipped.  The
            # key names the card and the kernel instantiation.
            ny = int(stack.n_years)
            key = self.programs.key_for(
                fingerprint=manifest.fingerprint,
                device=(torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
                impl=impl_resolved,
                kernel=instantiation(ny, cfg.params) if impl_resolved == "cuda" else None,
                mesh_devices=n_mesh,
                feed_px=int(feed_px),
                ny=ny,
                chunk=chunk,
                fetch_packed=bool(fetcher.packed),
                upload_packed=bool(uploader.packed),
                dtypes={
                    name: str(np.dtype(stack.dn_bands[name].dtype)) for name in bands
                } | {"qa": str(np.dtype(stack.qa.dtype))},
            )
            t0_warm = time.perf_counter()
            hit = self.programs.admit(key)
            probe_ok = True
            if not hit:
                try:
                    dummy_dn = {
                        name: np.zeros((feed_px, ny), dtype=stack.dn_bands[name].dtype)
                        for name in bands
                    }
                    # QA fill bit everywhere: every pixel is masked
                    dummy_qa = np.full((feed_px, ny), 1, dtype=stack.qa.dtype)
                    w_dn, w_qa = uploader.start(dummy_dn, dummy_qa).arrays()
                    work, w_err = _dispatch(w_dn, w_qa)
                    if w_err is not None:
                        raise w_err
                    w_handle, w_evs = work
                    for ev in w_evs:
                        fetchmod.wait_event(ev)
                    w_handle.wait()
                    _note_fetch_ok()
                except Exception as e:
                    # a failed probe is not a failed run: tile 0 pays the
                    # first launch inline, and the key stays unregistered
                    probe_ok = False
                    log.warning("program warm probe failed (%s); first tile warms inline", e)
            if watchdog is not None:
                watchdog.tick()  # the probe was progress
            compile_s = 0.0 if hit else time.perf_counter() - t0_warm
            self.programs.record(key, hit=hit, compile_s=compile_s, ok=probe_ok)
            return {"hits": int(hit), "misses": int(not hit), "compile_s": round(compile_s, 6)}

        program_stats = None
        run_ok = False
        try:
            if self.programs is not None:
                # inside the guarded try: an interrupt mid-probe unwinds
                # through the normal abort path
                self.progress["phase"] = "warmup"
                program_stats = self.program_stats = _warm_programs()
            self.progress["phase"] = "pipeline"
            next_i = 0
            if lease_q is not None:
                _refill_work()
            _prime_feeds()
            pending = None
            while True:
                self._check_cancel()
                if lease_q is not None:
                    lease_q.renew()
                    if len(todo) - next_i <= ra_depth:
                        _refill_work()
                _pump_uploads()
                if not pending_uploads:
                    if lease_q is None:
                        break  # feeds exhausted (or the remainder quarantined)
                    # elastic: the local pipeline ran dry — resolve the
                    # in-flight tail first (its done records retire our held
                    # leases), then claim / steal / speculate, and only then
                    # wait on live peers
                    if pending is not None:
                        _finish(pending)
                        pending = None
                        continue
                    if pending_fetches:
                        _drain_fetches(0)
                        continue
                    if pending_writes:
                        _drain_writes(0)
                        continue
                    if _refill_work():
                        continue
                    try:
                        complete = lease_q.run_complete()
                    except Exception as e:
                        log.warning("lease completion poll failed (%s); retrying next cycle", e)
                        complete = False
                    if complete:
                        break
                    _lease_idle_wait()
                    continue
                t, handle, dn, qa, attempt0 = pending_uploads.popleft()
                if telemetry is not None:
                    telemetry.tile_start(t.tile_id, attempt=attempt0)
                self.straggler.start(t.tile_id, attempt0)
                t0 = time.perf_counter()
                work = err = None
                try:
                    with timer.stage("upload"):
                        u_dn, u_qa = handle.arrays()
                    if handle.packed:
                        _note_upload_ok()
                    if telemetry is not None:
                        telemetry.span(
                            "upload", t.tile_id, t0, time.perf_counter(), attempt=attempt0
                        )
                except Exception as e:
                    # an upload error enters the same retry ladder as a
                    # dispatch fault: it re-uploads from the retained host
                    # inputs
                    if handle.packed:
                        _note_upload_failure()
                    err = e
                if err is None:
                    work, err = _dispatch(u_dn, u_qa)
                dt_dispatch = time.perf_counter() - t0
                if pending is not None:
                    _finish(pending)
                    pending = None
                if err is not None:
                    # a synchronous failure is resolved now rather than
                    # dispatching further tiles behind a known fault
                    _finish((t, work, err, dn, qa, dt_dispatch, attempt0))
                else:
                    pending = (t, work, err, dn, qa, dt_dispatch, attempt0)
            if pending is not None:
                _finish(pending)
            self.progress["phase"] = "drain"
            _drain_fetches(0)
            _drain_writes(0)
            run_ok = True
        except KeyboardInterrupt:
            if watchdog is not None and watchdog.stalled:
                raise StallError(
                    f"run stalled: no tile progress for over "
                    f"{cfg.stall_timeout_s}s (stall watchdog abort)"
                ) from None
            raise
        finally:
            try:
                self.progress["phase"] = "done" if run_ok else "aborted"
                if sampler is not None:
                    sampler.stop()
                # the watchdog stays armed through this unwind: a writer
                # thread hung in a transfer would otherwise block the
                # shutdown below forever
                feeder.shutdown(wait=False, cancel_futures=True)
                writer.shutdown(wait=True)
                for fut in pending_writes:
                    if (exc := fut.exception()):
                        log.error("tile write also failed during abort: %s", exc)
                    else:
                        px, fit = fut.result()
                        n_px += px
                        n_fit += fit
                if store is not None and owns_store:
                    try:
                        store.close()
                    except Exception as exc:
                        log.error("ingest-store flush/close failed: %s", exc)
                    blockcache.detach_store(store)
                if lease_q is not None and not run_ok:
                    # relinquish unfinished claims so peers may claim NOW
                    # instead of after the TTL; after the writer drain (its
                    # tiles are done, not released); best-effort
                    try:
                        n_rel = lease_q.release_held("aborted")
                        if n_rel:
                            log.warning(
                                "released %d unfinished tile lease(s) on abort; "
                                "peers may claim them immediately", n_rel,
                            )
                    except Exception as exc:
                        log.error("abort-path lease release failed: %s", exc)
                if fault_plan is not None and not run_ok:
                    faults.set_observer(None)
                    faults.deactivate()
                if telemetry is not None and not run_ok:
                    # abort visibility: the stream must say the run died
                    abort_wall = time.perf_counter() - t_run
                    try:
                        if cfg.feed_cache_mb:
                            telemetry.feed_cache(blockcache.stats_delta(feed_cache_base))
                        telemetry.fetch(fetcher.summary())
                        telemetry.upload(uploader.summary())
                        if store is not None:
                            telemetry.ingest_store(store.stats_delta(store_base))
                        if program_stats is not None:
                            telemetry.program_cache(program_stats)
                        lease_stats = lease_q.stats() if lease_q is not None else None
                        if lease_stats is not None:
                            telemetry.lease_summary(lease_stats)
                        telemetry.run_done(
                            "aborted",
                            tiles_done=n_done,
                            pixels=n_px,
                            wall_s=round(abort_wall, 3),
                            px_per_s=round(n_px / abort_wall, 1) if n_px else 0.0,
                            fit_rate=(n_fit / n_px) if n_px else 0.0,
                            stage_s=timer.summary(),
                            tiles_quarantined=len(quarantined),
                            tiles_stolen=lease_stats["stolen"] if lease_stats else None,
                            tiles_speculated=(
                                lease_stats["speculated"] if lease_stats else None
                            ),
                        )
                    except Exception as exc:
                        log.error("abort-path telemetry run_done failed: %s", exc)
                    finally:
                        try:
                            telemetry.close()
                        except Exception as exc:
                            log.error("abort-path telemetry close failed: %s", exc)
                        self._dump_flight()
                if watchdog is not None:
                    watchdog.stop()
            except KeyboardInterrupt:
                if watchdog is not None and watchdog.stalled:
                    log.critical("stall during abort unwind; hard abort (exit 4)")
                    if telemetry is not None:
                        try:
                            telemetry.close()
                        except Exception:
                            pass
                    os._exit(4)
                raise

        wall = time.perf_counter() - t_run
        summary = {
            "tiles": len(tiles),
            "tiles_done": n_done,
            "tiles_skipped_resume": n_resume_skipped,
            "pixels": n_px,
            "fit_rate": (n_fit / n_px) if n_px else 0.0,
            "wall_s": round(wall, 3),
            "px_per_s": round(n_px / wall, 1) if n_px else 0.0,
            "stage_s": timer.summary(),
            "fingerprint": manifest.fingerprint,
            "mesh_devices": n_mesh,
            "device": str(dev),
            "impl": impl_resolved,
            # always present (empty on healthy runs): the CLI maps
            # non-empty to exit code 3
            "tiles_quarantined": sorted(quarantined),
            "retries": self.progress["retries"],
            "stragglers": self.straggler.stats()["stragglers"],
            "device_bytes_peak": self.device_bytes_peak,
        }
        if self.tune_info is not None:
            # which tuning profile resolved this run's "auto" knobs
            summary["tune"] = self.tune_info
        if lease_q is not None:
            # elastic rollup: acquisitions, steals, speculative re-leases and
            # their wins, renewals, torn lease-log lines skipped
            summary["lease"] = lease_q.stats()
            summary["tiles_stolen"] = summary["lease"]["stolen"]
            summary["tiles_speculated"] = summary["lease"]["speculated"]
        feed_cache_stats = blockcache.stats_delta(feed_cache_base)
        if cfg.feed_cache_mb:
            summary["feed_cache"] = feed_cache_stats
        summary["fetch"] = fetcher.summary()
        summary["upload"] = uploader.summary()
        if store is not None:
            summary["ingest_store"] = store.stats_delta(store_base)
        if program_stats is not None:
            summary["program_cache"] = program_stats
        try:
            if telemetry is not None:
                if cfg.feed_cache_mb:
                    telemetry.feed_cache(feed_cache_stats)
                telemetry.fetch(summary["fetch"])
                telemetry.upload(summary["upload"])
                if store is not None:
                    telemetry.ingest_store(summary["ingest_store"])
                if program_stats is not None:
                    telemetry.program_cache(program_stats)
                if lease_q is not None:
                    telemetry.lease_summary(summary["lease"])
                try:
                    telemetry.run_done(
                        "ok",
                        tiles_done=n_done,
                        pixels=n_px,
                        wall_s=summary["wall_s"],
                        px_per_s=summary["px_per_s"],
                        fit_rate=summary["fit_rate"],
                        stage_s=timer.summary(),
                        tiles_quarantined=len(quarantined),
                        tiles_stolen=summary.get("tiles_stolen"),
                        tiles_speculated=summary.get("tiles_speculated"),
                    )
                finally:
                    summary["telemetry"] = {
                        "events": telemetry.events_file,
                        "metrics": telemetry.metrics_file,
                    }
                    if telemetry.metrics_port is not None:
                        summary["telemetry"]["metrics_port"] = telemetry.metrics_port
                    if telemetry.publish_file is not None:
                        summary["telemetry"]["snapshot"] = telemetry.publish_file
                    telemetry.close()
                    faults.set_observer(None)
                    flight_file = self._dump_flight()
                    if flight_file is not None:
                        summary["telemetry"]["flight"] = flight_file
                if p_count > 1 and p_index == 0:
                    # the primary's fold: per-process event files live in the
                    # shared workdir, so the merge is a bounded wait for every
                    # peer's run_done — no collective, usable when a peer died.
                    # The bound scales with this run (peers started together
                    # on similar shares) but is capped, so a peer killed
                    # without its run_done cannot hold the primary for hours
                    from land_trendr_tpu_torch.parallel.multihost import merge_host_event_logs

                    merge_timeout_s = (
                        cfg.merge_timeout_s
                        if cfg.merge_timeout_s is not None
                        else max(60.0, min(2.0 * wall, 900.0))
                    )
                    summary["telemetry"]["hosts"] = merge_host_event_logs(
                        cfg.workdir,
                        expect_hosts=p_count,
                        timeout_s=merge_timeout_s,
                        poll_s=max(0.1, min(2.0, merge_timeout_s / 600.0)),
                        # wall-clock domain: a peer file untouched since this
                        # run began (60 s skew slack) holds a previous scope
                        newer_than=time.time() - wall - 60.0,
                    )
        finally:
            if fault_plan is not None:
                summary["faults_injected"] = [
                    {"seam": s, "index": i, "error": k} for s, i, k in fault_plan.injected()
                ]
                faults.set_observer(None)
                faults.deactivate()
        log.info("run complete: %s", summary)
        self.summary = summary
        return summary


def assemble_outputs(
    stack: RasterStack, cfg: RunConfig, device: "str | torch.device" = "cuda"
) -> dict[str, str]:
    """Mosaic per-tile artifacts into segment rasters.

    One multi-band GeoTIFF per product; the band axis is the per-pixel
    vector axis (vertex slot / segment slot / year).  Streaming: each tile
    artifact is read once and its windows pushed into one writer per
    product, so host memory stays O(tile × products).  ``cfg.out_overviews``
    adds that many 2× overview pages to each raster.  Returns product →
    path.

    A config with ``"auto"`` knobs is resolved here for ``device`` (the
    run's device), as :class:`Run` resolved it; in-process callers pass
    the run's already-resolved ``Run.cfg`` instead, so a store re-probed
    between run and assembly cannot change the tile size.
    """
    cfg, _ = resolve_config(cfg, scene_shape=(*stack.shape, stack.n_years), device=device)
    tiles = plan_tiles(*stack.shape, cfg.tile_size)
    manifest = TileManifest(cfg.workdir, cfg.fingerprint(stack))
    done = manifest.open(resume=True)
    missing = [t.tile_id for t in tiles if t.tile_id not in done]
    if missing:
        raise RuntimeError(
            f"cannot assemble: {len(missing)} tiles missing from manifest "
            f"(first few: {missing[:5]}); run run_stack first"
        )

    h, w = stack.shape
    os.makedirs(cfg.out_dir, exist_ok=True)
    with np.load(manifest.tile_path(tiles[0].tile_id)) as z:
        first = {name: z[name] for name in z.files}

    def out_dtype(dt: np.dtype) -> np.dtype:
        if dt == np.bool_:
            return np.dtype(np.uint8)
        if dt == np.float64:
            return np.dtype(np.float32)
        return dt

    writers: dict[str, GeoTiffStreamWriter] = {}
    paths: dict[str, str] = {}
    try:
        for name, a in sorted(first.items()):
            depth = 1 if a.ndim == 1 else a.shape[1]
            paths[name] = os.path.join(cfg.out_dir, f"{name}.tif")
            writers[name] = GeoTiffStreamWriter(
                paths[name], h, w, depth, out_dtype(a.dtype),
                geo=stack.geo, compress=cfg.out_compress, overviews=cfg.out_overviews,
            )
        for t in tiles:
            if first is not None and t is tiles[0]:
                arrays, first = first, None
            else:
                with np.load(manifest.tile_path(t.tile_id)) as z:
                    arrays = {name: z[name] for name in z.files}
            for name, wr in writers.items():
                a = arrays[name]
                wr.write(t.y0, t.x0, a.reshape(t.h, t.w, -1).astype(wr.dtype, copy=False))
        for wr in writers.values():
            wr.close()
    except BaseException:
        for wr in writers.values():  # release handles; leave no half files
            try:
                wr.abort()
            except Exception:
                pass
        for p in paths.values():
            if os.path.exists(p):
                os.unlink(p)
        raise
    return paths
