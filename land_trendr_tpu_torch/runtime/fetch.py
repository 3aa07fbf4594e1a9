"""Packed async device→host fetch: one transfer per tile, overlapped.

Counterpart of ``land_trendr_tpu/runtime/fetch.py``.  Three pieces:

* **Device-side pack** (:func:`pack_tile`): every selected product —
  seg products, fitted, fused-change and FTV products, and the
  always-needed ``model_valid`` byte — is reinterpreted as bytes and
  concatenated into ONE word-aligned device buffer (``fetch_f16`` casts
  float products to float16 on the device first).
* **Async overlap**: the buffer leaves with one ``non_blocking``
  device→host copy into **pinned** memory on a side stream, ordered after
  the tile's compute; a CUDA event marks when it has landed, and
  :meth:`PackedHandle.wait` waits only for that event (polling it, see
  :func:`wait_event`), while later tiles compute.
* **Host-side unpack** (:func:`unpack_tile`): crop to the tile's real
  pixels first, then float16 upcast, sign flip and dtype conversion —
  byte for byte the per-product path's output.

Packed and per-product runs produce byte-identical artifacts: both follow
one :class:`FetchPlan`.  ``fetch_packed="auto"`` packs only on a CUDA
device; on the CPU the per-product path reads the tensors in place.
"""

from __future__ import annotations

import functools
import math
import sys
import threading
import time
from typing import TYPE_CHECKING, NamedTuple

import numpy as np
import torch

from land_trendr_tpu_torch.ops import indices as idx
from land_trendr_tpu_torch.runtime import faults

if TYPE_CHECKING:  # pragma: no cover - type-only imports (cycle with driver)
    from land_trendr_tpu_torch.ops.tile import TileOutputs
    from land_trendr_tpu_torch.runtime.driver import RunConfig, TileSpec

__all__ = [
    "SEG_PRODUCTS",
    "SIGNED_PRODUCTS",
    "FetchPlan",
    "PlanEntry",
    "ShardedHandle",
    "TileFetcher",
    "build_plan",
    "pack_tile",
    "plan_wire_bytes",
    "resolve_packed",
    "unpack_tile",
    "wait_event",
]

#: the full per-pixel segmentation product set (``RunConfig.products``
#: domain); "fitted" is governed by ``write_fitted``, change_*/ftv_* by
#: their own knobs
SEG_PRODUCTS = (
    "n_vertices", "vertex_indices", "vertex_years", "vertex_src_vals",
    "vertex_fit_vals", "seg_magnitude", "seg_duration", "seg_rate",
    "rmse", "p_of_f", "model_valid",
)

#: value-carrying products that flip with the index's disturbance sign
SIGNED_PRODUCTS = frozenset(
    {"vertex_src_vals", "vertex_fit_vals", "seg_magnitude", "seg_rate"}
)

_NP_OF = {
    torch.float16: "float16",
    torch.float32: "float32",
    torch.float64: "float64",
    torch.int32: "int32",
    torch.bool: "bool",
}


class PlanEntry(NamedTuple):
    """One product's place in the packed wire format.

    ``key`` is the artifact name (``""`` for the ``model_valid`` rider that
    travels only for the fit-rate metadata); ``src``/``field`` resolve the
    device tensor inside a :class:`TileOutputs`; ``suffix`` is the
    per-pixel shape; ``dtype`` the device dtype and ``wire`` the dtype
    that crosses the link (float16 under ``fetch_f16``, uint8 for bool);
    ``signed``/``sign`` apply the disturbance-orientation flip on host;
    ``conv`` is the host conversion of the JAX package's plan (change
    yod → int32, change floats → float32, the byte → bool view).
    """

    key: str
    src: str            # "seg" | "change" | "ftv"
    field: str
    suffix: tuple[int, ...]
    dtype: str
    wire: str
    signed: bool
    sign: float
    conv: str


class FetchPlan(NamedTuple):
    """Hashable description of one run's tile fetch."""

    entries: tuple[PlanEntry, ...]
    px: int  # PADDED device pixel count every tile shares


def _resolve(out: "TileOutputs", e: PlanEntry) -> torch.Tensor:
    if e.src == "seg":
        return getattr(out.seg, e.field)
    if e.src == "change":
        return out.change[e.field]
    return out.ftv[e.field]


def build_plan(out: "TileOutputs", cfg: "RunConfig") -> FetchPlan:
    """The run's fetch plan, from the first tile's (shared) output shapes.

    The JAX package's entry order: seg products in :data:`SEG_PRODUCTS`
    order filtered by ``cfg.products``, fitted, change products, FTV
    products, then the ``model_valid`` rider when the subset excludes it.
    """
    sign = idx.DISTURBANCE_SIGN[cfg.index.lower()]
    want = SEG_PRODUCTS if cfg.products is None else cfg.products
    entries: list[PlanEntry] = []

    def add(key, src, field, arr, signed=False, sgn=1.0, conv=""):
        dt = _NP_OF[arr.dtype]
        if dt == "bool":
            wire, conv = "uint8", conv or "bool"
        elif cfg.fetch_f16 and dt.startswith("float"):
            wire = "float16"
        else:
            wire = dt
        entries.append(
            PlanEntry(
                key, src, field, tuple(int(s) for s in arr.shape[1:]), dt, wire,
                bool(signed), float(sgn), conv,
            )
        )

    for name in SEG_PRODUCTS:
        if name in want:
            add(name, "seg", name, getattr(out.seg, name),
                signed=name in SIGNED_PRODUCTS, sgn=sign)
    if cfg.write_fitted:
        add("fitted", "seg", "fitted", out.seg.fitted, signed=True, sgn=sign)
    if out.change is not None:
        for name, arr in out.change.items():
            conv = "int32" if name == "yod" else ("" if name == "mask" else "float32")
            add(f"change_{name}", "change", name, arr, conv=conv)
    for name, arr in out.ftv.items():
        add(f"ftv_{name}", "ftv", name, arr, signed=True,
            sgn=idx.DISTURBANCE_SIGN[name.lower()])
    if "model_valid" not in want:
        add("", "seg", "model_valid", out.seg.model_valid)
    return FetchPlan(entries=tuple(entries), px=int(out.seg.model_valid.shape[0]))


@functools.lru_cache(maxsize=None)
def _layout(plan: FetchPlan) -> tuple[tuple[tuple[int, int], ...], int]:
    """Per-entry ``(byte_offset, real_bytes)`` and the total wire bytes;
    every entry starts on a word boundary."""
    offs: list[tuple[int, int]] = []
    off = 0
    for e in plan.entries:
        n = plan.px * math.prod(e.suffix) * np.dtype(e.wire).itemsize
        offs.append((off, n))
        off += 4 * ((n + 3) // 4)
    return tuple(offs), off


def plan_wire_bytes(plan: FetchPlan) -> int:
    """Bytes one packed tile transfer moves (word padding included)."""
    return _layout(plan)[1]


def pack_tile(out: "TileOutputs", plan: FetchPlan) -> torch.Tensor:
    """Every planned product → one word-aligned ``uint8`` device buffer
    (``fetch_f16`` casts happen here, on the device)."""
    offs, total = _layout(plan)
    dev = out.seg.model_valid.device
    buf = torch.zeros(total, dtype=torch.uint8, device=dev)
    for e, (off, n) in zip(plan.entries, offs):
        a = _wire(_resolve(out, e), e)
        if a.dtype == torch.bool:
            a = a.view(torch.uint8)
        buf[off : off + n] = a.reshape(-1).view(torch.uint8)
    return buf


def _wire(a: torch.Tensor, e: PlanEntry) -> torch.Tensor:
    """The device tensor in its wire dtype (float16 under ``fetch_f16``)."""
    if e.wire == "float16" and e.dtype != "float16":
        a = a.to(torch.float16)
    return a.contiguous()


def _post(e: PlanEntry, a: np.ndarray) -> np.ndarray:
    """Shared host-side restore: float16 upcast → sign flip (the
    orientation contract) → the plan's conversion."""
    if a.dtype == np.float16:
        a = a.astype(np.float32)
    if e.signed:
        a = e.sign * a
    if e.conv == "int32":
        a = a.astype(np.int32)
    elif e.conv == "float32":
        a = a.astype(np.float32)
    return a


def unpack_tile(
    plan: FetchPlan, buf: np.ndarray, px: int
) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Landed host bytes → (artifact arrays, cropped ``model_valid``)."""
    buf = buf.view(np.uint8)
    offs, _total = _layout(plan)
    arrays: dict[str, np.ndarray] = {}
    model_valid: np.ndarray | None = None
    for e, (off, nbytes) in zip(plan.entries, offs):
        a = buf[off : off + nbytes].view(e.wire).reshape(plan.px, *e.suffix)
        a = a[:px]
        if e.conv == "bool":
            a = a.view(np.bool_)
        a = _post(e, a)
        if e.key:
            arrays[e.key] = a
        if e.src == "seg" and e.field == "model_valid":
            model_valid = a
    if model_valid is None:
        raise ValueError("fetch plan carries no model_valid entry")
    return arrays, model_valid


#: host sleep between polls of a CUDA event
POLL_S = 1e-4


def wait_event(ev) -> None:
    """Wait for a CUDA event by polling ``query()`` with a short sleep
    (:data:`POLL_S`) instead of ``synchronize()``: the waiting thread runs
    Python between polls, so the stall watchdog's interrupt lands while
    the device is still busy (a native ``synchronize`` would hold the
    thread inside the CUDA runtime until the device finishes)."""
    while not ev.query():
        time.sleep(POLL_S)


def _to_host(arr: torch.Tensor) -> np.ndarray:
    """Per-product device→host read (fault seam ``fetch.wait``)."""
    faults.check("fetch.wait")
    return arr.detach().cpu().numpy()


def resolve_packed(fetch_packed: "bool | str", device: torch.device) -> bool:
    """``fetch_packed`` ("auto"/True/False) → bool: "auto" packs only on a
    CUDA device; the wire format is little-endian."""
    if fetch_packed == "auto":
        return device.type == "cuda" and sys.byteorder == "little"
    if fetch_packed and (device.type != "cuda" or sys.byteorder != "little"):
        raise ValueError(
            "fetch_packed=True needs a CUDA device and a little-endian host"
        )
    return bool(fetch_packed)


class _Stats:
    """Thread-safe fetch counters (unpack runs in writer-pool threads)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.tiles = 0
        self.transfers = 0
        self.bytes = 0
        self.pack_s = 0.0
        self.wait_s = 0.0
        self.unpack_s = 0.0
        self.backlog_max = 0

    def add(self, **deltas) -> None:
        with self._lock:
            for k, v in deltas.items():
                setattr(self, k, getattr(self, k) + v)

    def note_backlog(self, depth: int) -> None:
        with self._lock:
            self.backlog_max = max(self.backlog_max, depth)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "tiles": self.tiles,
                "transfers": self.transfers,
                "bytes": self.bytes,
                "pack_s": round(self.pack_s, 6),
                "wait_s": round(self.wait_s, 6),
                "unpack_s": round(self.unpack_s, 6),
                "backlog_max": self.backlog_max,
            }


class _Handle:
    """A tile's fetch: :meth:`rows` gives the first ``px`` pixels' artifact
    arrays and ``model_valid``; :meth:`tile_arrays` crops to the tile."""

    def rows(self, px: int) -> tuple[dict[str, np.ndarray], np.ndarray]:
        raise NotImplementedError

    def tile_arrays(self, t: "TileSpec") -> tuple[dict[str, np.ndarray], int]:
        """The tile's artifact arrays (cropped to its real pixels) and its
        count of fitted pixels."""
        arrays, model_valid = self.rows(t.h * t.w)
        self._fetcher.stats.add(tiles=1)
        return arrays, int(model_valid.sum())


class PackedHandle(_Handle):
    """One tile's in-flight packed copy into pinned host memory.

    ``wait`` is idempotent and thread-safe: the driver's bounded drain
    calls it on the loop thread; ``tile_arrays`` (writer threads) reuses
    the landed buffer.  The pinned buffer is read only after its event.
    """

    packed = True

    def __init__(self, fetcher: "TileFetcher", host: torch.Tensor, landed) -> None:
        self._fetcher = fetcher
        self._host = host
        self._landed = landed
        self._lock = threading.Lock()
        self._ready = False

    def wait(self) -> None:
        """Block until the packed buffer has landed on host."""
        with self._lock:
            if not self._ready:
                faults.check("fetch.wait")
                t0 = time.perf_counter()
                # the lock makes the wait idempotent across the driver and
                # writer threads: a second caller must wait for the landing
                # lt: noqa[LT007]
                wait_event(self._landed)
                self._fetcher.stats.add(wait_s=time.perf_counter() - t0)
                self._ready = True

    def rows(self, px: int) -> tuple[dict[str, np.ndarray], np.ndarray]:
        self.wait()
        t0 = time.perf_counter()
        arrays, model_valid = unpack_tile(self._fetcher.plan, self._host.numpy(), px)
        # the artifact arrays are views of the pinned buffer: copy them out
        # so the buffer can go back to the pinned-memory cache
        arrays = {k: np.array(v) for k, v in arrays.items()}
        model_valid = np.array(model_valid)
        self._host = None
        self._fetcher.stats.add(unpack_s=time.perf_counter() - t0)
        return arrays, model_valid


class UnpackedHandle(_Handle):
    """The per-product path: each product read synchronously in
    ``tile_arrays`` (in the writer pool)."""

    packed = False

    def __init__(self, fetcher: "TileFetcher", out: "TileOutputs") -> None:
        self._fetcher = fetcher
        self._out = out

    def wait(self) -> None:  # transfers happen in tile_arrays
        return None

    def rows(self, px: int) -> tuple[dict[str, np.ndarray], np.ndarray]:
        stats = self._fetcher.stats
        arrays: dict[str, np.ndarray] = {}
        model_valid: np.ndarray | None = None
        for e in self._fetcher.plan.entries:
            t0 = time.perf_counter()
            host = _to_host(_wire(_resolve(self._out, e), e))
            stats.add(wait_s=time.perf_counter() - t0, transfers=1, bytes=host.nbytes)
            a = _post(e, host[:px])
            if e.key:
                arrays[e.key] = a
            if e.src == "seg" and e.field == "model_valid":
                model_valid = a
        if model_valid is None:
            raise ValueError("fetch plan carries no model_valid entry")
        return arrays, model_valid


class ShardedHandle(_Handle):
    """A mesh tile's fetch: one handle per shard, in pixel order.  Each
    shard lands from its own device; the rows are joined on the host, so
    nothing crosses devices."""

    def __init__(self, fetcher: "TileFetcher", handles: list, shard_px: int) -> None:
        self._fetcher = fetcher
        self._handles = handles
        self._shard_px = shard_px
        self.packed = all(h.packed for h in handles)

    def wait(self) -> None:
        for h in self._handles:
            h.wait()

    def rows(self, px: int) -> tuple[dict[str, np.ndarray], np.ndarray]:
        parts = [h.rows(self._shard_px) for h in self._handles]
        arrays = {k: np.concatenate([p[0][k] for p in parts])[:px] for k in parts[0][0]}
        return arrays, np.concatenate([p[1] for p in parts])[:px]


def _indexed(device: "torch.device | str") -> torch.device:
    """``device`` with its index: plain ``cuda`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class TileFetcher:
    """Per-run fetch strategy: plan once, then one handle per tile (one per
    shard of a mesh tile, each copied on its own device's side stream)."""

    def __init__(
        self,
        cfg: "RunConfig",
        device: torch.device,
        packed: bool,
        mesh: "list[torch.device] | None" = None,
    ) -> None:
        self.cfg = cfg
        self.device = _indexed(device)
        self.packed = packed
        self.demoted = False
        self.plan: FetchPlan | None = None
        self.stats = _Stats()
        # keyed by indexed devices: a tile's outputs report ``cuda:N``
        # even when the caller named the device plain ``cuda``
        self._streams = (
            {_indexed(d): torch.cuda.Stream(device=d) for d in (mesh or [self.device])}
            if packed else {}
        )

    def demote(self) -> None:
        """Drop to the per-product path for the rest of the run (after
        repeated packed-fetch failures); artifacts are byte-identical
        either way and in-flight packed handles still drain."""
        self.packed = False
        self.demoted = True

    def start(
        self, out: "TileOutputs | list[TileOutputs]"
    ) -> "PackedHandle | UnpackedHandle | ShardedHandle":
        """Issue one tile's fetch; a packed copy starts landing NOW.  A list
        is a mesh tile's per-shard outputs, in pixel order."""
        if isinstance(out, list):
            handles = [self.start(o) for o in out]
            return ShardedHandle(self, handles, int(out[0].seg.model_valid.shape[0]))
        if self.plan is None:
            self.plan = build_plan(out, self.cfg)
        if not self.packed:
            return UnpackedHandle(self, out)
        t0 = time.perf_counter()
        dev = out.seg.model_valid.device
        words = pack_tile(out, self.plan)
        host = torch.empty(words.numel(), dtype=torch.uint8, pin_memory=True)
        side = self._streams[dev]
        side.wait_stream(torch.cuda.current_stream(dev))
        words.record_stream(side)
        landed = torch.cuda.Event()
        with torch.cuda.stream(side):
            host.copy_(words, non_blocking=True)
            landed.record(side)
        self.stats.add(
            pack_s=time.perf_counter() - t0,
            transfers=1,
            bytes=plan_wire_bytes(self.plan),
        )
        return PackedHandle(self, host, landed)

    def note_backlog(self, depth: int) -> None:
        self.stats.note_backlog(depth)

    def summary(self) -> dict:
        """Run-scoped counters for the run summary."""
        return {"packed": self.packed, "demoted": self.demoted, **self.stats.snapshot()}
