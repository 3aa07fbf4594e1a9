"""The tile-run driver: stacks in, segment rasters out (PyTorch).

Counterpart of ``land_trendr_tpu/runtime/driver.py``, holding the parts
this package ports so far: :class:`RunConfig` (a subset of the JAX
package's fields), :class:`TileSpec` / :func:`plan_tiles`,
:func:`_feed_tile`, :func:`run_stack` with manifest resume, and
:func:`assemble_outputs`.

The scene is cut into fixed-size tiles; every tile — edge tiles included —
is padded to ``tile_size²`` pixels with fully-masked rows (the QA fill
bit), so every tile has one shape.  The tile loop is a depth-1 software
pipeline over the host, the link and the device:

* a pool of ``feed_workers`` threads slices upcoming tiles (feed);
* each fed tile is packed into pinned memory and copied to the device on
  a side stream as soon as it is fed (upload, ``upload_depth`` in flight);
* the tile program is enqueued on the device (compute) and the host moves
  on: tile ``i``'s compute is awaited only after tile ``i+1`` has been
  enqueued behind it;
* a finished tile's products leave as one packed copy that lands while
  later tiles compute (fetch, ``fetch_depth`` in flight);
* a pool of ``write_workers`` threads persists tile artifacts to the
  manifest (write) — the manifest *is* the checkpoint.

Not ported yet (each waits for a later slice): telemetry / flight /
spans, retries, quarantine and the stall watchdog, leases and multihost,
the ingest store, ``"auto"`` tuning, mesh sharding.
A failed tile aborts the run; the tiles already recorded stay durable and
a rerun resumes after them.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.io import native
from land_trendr_tpu_torch.io.geotiff import GeoTiffStreamWriter
from land_trendr_tpu_torch.ops import indices as idx
from land_trendr_tpu_torch.ops.change import ChangeFilter
from land_trendr_tpu_torch.ops.segment_cuda import CUDA_BLOCK
from land_trendr_tpu_torch.ops.tile import process_tile_dn, resolve_impl
from land_trendr_tpu_torch.runtime import feed as feedmod
from land_trendr_tpu_torch.runtime import fetch as fetchmod
from land_trendr_tpu_torch.runtime.manifest import (
    ARTIFACT_COMPRESS,
    TileManifest,
    run_fingerprint,
)
from land_trendr_tpu_torch.runtime.stack import RasterStack
from land_trendr_tpu_torch.utils.profiling import StageTimer

__all__ = [
    "RunConfig",
    "TileSpec",
    "assemble_outputs",
    "plan_tiles",
    "resolve_device",
    "run_stack",
]

log = logging.getLogger("land_trendr_tpu_torch.runtime")

_SEG_PRODUCTS = fetchmod.SEG_PRODUCTS


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Everything that defines a segmentation run over one stack.

    The subset of the JAX package's ``RunConfig`` this package implements;
    the field names, defaults and meanings are the same.
    """

    index: str = "nbr"
    #: secondary indices fitted to the chosen vertices (``ftv_<index>``
    #: products); fingerprinted
    ftv_indices: tuple[str, ...] = ()
    params: LTParams = LTParams()
    #: scene tiling granularity (pixels per side); fingerprinted
    tile_size: int = 256
    workdir: str = "lt_work"
    out_dir: str = "lt_out"
    resume: bool = True
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
    #: bound on in-flight packed fetches
    fetch_depth: int = 2
    #: host→device strategy: "auto" (packed on a CUDA device), True, False
    upload_packed: "bool | str" = "auto"
    #: bound on in-flight packed uploads
    upload_depth: int = 2
    scale: float = 2.75e-5
    offset: float = -0.2
    reject_bits: int = idx.DEFAULT_QA_REJECT
    #: output raster compression: "deflate", "lzw" or "none"
    out_compress: str = "deflate"
    #: per-tile checkpoint artifact compression: "none" or "deflate"
    manifest_compress: str = "none"
    #: background tile-writer threads
    write_workers: int = 1
    #: background feed threads
    feed_workers: int = 1
    #: fuse change-map selection into every tile's program; the per-tile
    #: change products ride the manifest and assemble into change_*.tif.
    #: The mmu sieve needs the whole raster: apply
    #: ``ops.change.sieve_change_rasters`` to the assembled out_dir (the
    #: CLI's ``--change-mmu`` does).  Fingerprinted
    change_filt: "ChangeFilter | None" = None
    #: tiles with more pixels than this run the segmentation chunked;
    #: ``None`` disables chunking.  Fingerprinted.
    chunk_px: "int | None" = 262_144
    #: segmentation implementation: "auto" (the kernel on a CUDA device,
    #: the plain version on the CPU); "cuda" or "torch" must name the one
    #: the run's device gives, else the run raises
    impl: str = "auto"

    def __post_init__(self) -> None:
        if not isinstance(self.tile_size, int) or self.tile_size < 1:
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
        if self.change_filt is not None and not isinstance(self.change_filt, ChangeFilter):
            raise ValueError(f"change_filt={self.change_filt!r} is not a ChangeFilter")
        if self.impl not in ("auto", "cuda", "torch"):
            raise ValueError(f"impl={self.impl!r} not one of 'auto', 'cuda', 'torch'")
        if self.chunk_px is not None:
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
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"{name}={v!r} must be an integer >= 1")

    def fingerprint(self, stack: RasterStack) -> str:
        """The run-defining configuration's hash (the JAX package's payload;
        the resolved impl is an execution fact, kept out of it)."""
        return run_fingerprint(
            {
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
    cases) voids them.
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
) -> dict:
    """Segment a whole stack tile by tile on ``device``; returns the run
    summary (pixels, fit rate, wall time, px/s, per-stage host seconds,
    the resolved impl, upload and fetch counters).

    Raster outputs are not written here — call :func:`assemble_outputs`
    after (assembly only needs the workdir).
    """
    dev = resolve_device(device)
    tiles = list(tiles) if tiles is not None else plan_tiles(*stack.shape, cfg.tile_size)
    tile_px = cfg.tile_size * cfg.tile_size
    impl = resolve_impl(cfg.impl, dev)
    if (
        impl == "cuda"
        and cfg.chunk_px is not None
        and cfg.chunk_px > CUDA_BLOCK
        and cfg.chunk_px % CUDA_BLOCK
    ):
        raise ValueError(
            f"chunk_px={cfg.chunk_px} must be a multiple of {CUDA_BLOCK} (the "
            "CUDA block) when the resolved impl is 'cuda'"
        )
    fetch_packed = fetchmod.resolve_packed(cfg.fetch_packed, dev)
    upload_packed = feedmod.resolve_packed(cfg.upload_packed, dev)

    manifest = TileManifest(
        cfg.workdir, cfg.fingerprint(stack), context={"mesh_devices": 1, "impl": impl}
    )
    done = manifest.open(cfg.resume)
    todo = [t for t in tiles if t.tile_id not in done]
    years = torch.from_numpy(stack.years.astype(np.int32)).to(dev)
    bands = idx.required_bands(cfg.index, cfg.ftv_indices)
    timer = StageTimer()
    fetcher = fetchmod.TileFetcher(cfg, dev, packed=fetch_packed)
    uploader = feedmod.TileUploader(dev, packed=upload_packed)
    t_run = time.perf_counter()
    totals = {"px": 0, "fit": 0, "tiles": 0}

    def write_job(t: TileSpec, handle, dt: float) -> tuple[int, int]:
        with timer.stage("write"):
            arrays, fit = handle.tile_arrays(t)
            px = t.h * t.w
            meta = {
                "y0": t.y0,
                "x0": t.x0,
                "h": t.h,
                "w": t.w,
                "px_per_s": round(tile_px / dt, 1),
                "no_fit_rate": round(1.0 - fit / px, 4),
            }
            manifest.record(t.tile_id, arrays, meta, compress=cfg.manifest_compress)
        return px, fit

    def feed_job(t: TileSpec):
        with timer.stage("feed"):
            return _feed_tile(stack, t, tile_px, bands)

    def dispatch(dn, qa):
        with timer.stage("dispatch"):
            out = process_tile_dn(
                years, dn, qa,
                index=cfg.index, params=cfg.params, scale=cfg.scale,
                offset=cfg.offset, reject_bits=cfg.reject_bits,
                chunk=cfg.chunk_px, impl=impl, ftv_indices=cfg.ftv_indices,
                change_filt=cfg.change_filt,
            )
            done_ev = None
            if dev.type == "cuda":
                done_ev = torch.cuda.Event()
                done_ev.record(torch.cuda.current_stream(dev))
        with timer.stage("fetch"):
            # packed: the pack is enqueued right behind the tile's compute
            # and its copy lands while the next tiles compute
            handle = fetcher.start(out)
        return handle, done_ev

    pending_writes: deque = deque()
    pending_fetches: deque = deque()
    pending_uploads: deque = deque()
    pending_feeds: deque = deque()

    def collect_write(fut) -> None:
        px, fit = fut.result()
        totals["px"] += px
        totals["fit"] += fit

    with ThreadPoolExecutor(cfg.write_workers, thread_name_prefix="lt-writer") as writer, \
            ThreadPoolExecutor(cfg.feed_workers, thread_name_prefix="lt-feeder") as feeder:

        def submit_write(t, handle, dt) -> None:
            while len(pending_writes) >= cfg.write_workers:
                collect_write(pending_writes.popleft())
            pending_writes.append(writer.submit(write_job, t, handle, dt))

        def drain_fetches(limit: int) -> None:
            while len(pending_fetches) > limit:
                t, handle, dt = pending_fetches.popleft()
                with timer.stage("fetch"):
                    handle.wait()
                totals["tiles"] += 1
                submit_write(t, handle, dt)

        def finish(pending) -> None:
            """Await one enqueued tile's compute; queue its landing fetch."""
            t, handle, done_ev, t0 = pending
            with timer.stage("compute"):
                if done_ev is not None:
                    done_ev.synchronize()
            dt = time.perf_counter() - t0
            pending_fetches.append((t, handle, dt))
            fetcher.note_backlog(len(pending_fetches))
            drain_fetches(cfg.fetch_depth - 1 if fetcher.packed else 0)

        next_i = 0

        def top_up_feeds() -> None:
            nonlocal next_i
            while next_i < len(todo) and len(pending_feeds) < cfg.feed_workers + 1:
                pending_feeds.append((todo[next_i], feeder.submit(feed_job, todo[next_i])))
                next_i += 1

        def pump_uploads() -> None:
            depth = cfg.upload_depth if uploader.packed else 1
            while pending_feeds and len(pending_uploads) < depth:
                t, fut = pending_feeds.popleft()
                top_up_feeds()
                dn, qa = fut.result()
                with timer.stage("upload"):
                    handle = uploader.start(dn, qa)
                pending_uploads.append((t, handle))
                uploader.note_backlog(len(pending_uploads))

        top_up_feeds()
        pending = None
        while True:
            pump_uploads()
            if not pending_uploads:
                break
            t, handle = pending_uploads.popleft()
            t0 = time.perf_counter()
            with timer.stage("upload"):
                u_dn, u_qa = handle.arrays()
            f_handle, done_ev = dispatch(u_dn, u_qa)
            if pending is not None:
                finish(pending)
            pending = (t, f_handle, done_ev, t0)
        if pending is not None:
            finish(pending)
        drain_fetches(0)
        while pending_writes:
            collect_write(pending_writes.popleft())

    wall = time.perf_counter() - t_run
    n_px = totals["px"]
    summary = {
        "tiles": len(tiles),
        "tiles_done": totals["tiles"],
        "tiles_skipped_resume": len(tiles) - len(todo),
        "pixels": n_px,
        "fit_rate": (totals["fit"] / n_px) if n_px else 0.0,
        "wall_s": round(wall, 3),
        "px_per_s": round(n_px / wall, 1) if n_px else 0.0,
        "stage_s": timer.summary(),
        "fingerprint": manifest.fingerprint,
        "device": str(dev),
        "impl": impl,
        "fetch": fetcher.summary(),
        "upload": uploader.summary(),
    }
    log.info("run complete: %s", summary)
    return summary


def assemble_outputs(stack: RasterStack, cfg: RunConfig) -> dict[str, str]:
    """Mosaic per-tile artifacts into segment rasters.

    One multi-band GeoTIFF per product; the band axis is the per-pixel
    vector axis (vertex slot / segment slot / year).  Streaming: each tile
    artifact is read once and its windows pushed into one writer per
    product, so host memory stays O(tile × products).  Returns
    product → path.
    """
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
                geo=stack.geo, compress=cfg.out_compress,
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
