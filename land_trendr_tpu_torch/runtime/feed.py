"""Packed async host→device upload: one transfer per tile, overlapped.

Counterpart of ``land_trendr_tpu/runtime/feed.py``.  Three pieces:

* **Host-side pack** (:func:`pack_inputs`): every fed array — the selected
  DN bands and QA, all ``(feed_px, NY)`` and 2-byte on C2 stacks — is
  copied into ONE word buffer in **pinned** host memory (each entry
  word-aligned), so a tile costs one transfer instead of
  ``len(bands) + 1``.
* **Async overlap**: the pinned buffer leaves with one ``non_blocking``
  host→device copy on a side stream as soon as the tile's feed completes;
  a CUDA event marks its landing, and the compute stream waits on that
  event (a device-side wait — the host never blocks on the upload).
  PyTorch's pinned-memory cache holds the host buffer until the copy that
  reads it has finished, so a buffer is never reused mid-flight.
* **Device-side unpack** (:func:`unpack_inputs`): the landed words are
  re-read as the per-band arrays with ``Tensor.view(dtype)`` on word
  slices — views, no copy, no kernel.

Packed and per-array runs produce byte-identical artifacts: the wire
format is a pure reinterpretation of the fed bytes.  ``upload_packed=
"auto"`` packs only on a CUDA device; on the CPU the fed arrays are used
as they are.

Every packed upload gets a fresh pinned buffer, and the driver keeps each
tile's fed host arrays until the tile is done: a retried tile is uploaded
again from those (:func:`to_device`), never re-dispatched from a buffer
that may have gone back to the pinned cache.  An upload error surfacing
at the landing (fault seam ``upload.wait``) enters the driver's retry
ladder; repeated consecutive failures :meth:`TileUploader.demote` the run
to the per-array path, as in the JAX package.
"""

from __future__ import annotations

import functools
import sys
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from land_trendr_tpu_torch.runtime import faults

__all__ = [
    "UploadEntry",
    "UploadPlan",
    "TileUploader",
    "build_plan",
    "pack_inputs",
    "plan_wire_bytes",
    "resolve_packed",
    "to_device",
    "unpack_inputs",
]

#: the 16-bit DN / QA dtypes a stack carries (``runtime/stack.py``)
_TORCH = {"int16": torch.int16, "uint16": torch.uint16}


class UploadEntry(NamedTuple):
    """One fed array's place in the packed wire format (``"qa"`` = QA)."""

    name: str
    dtype: str


class UploadPlan(NamedTuple):
    """Hashable description of one run's tile upload."""

    entries: tuple[UploadEntry, ...]
    px: int  # PADDED feed pixel count every tile shares
    ny: int


def build_plan(dn: dict, qa: np.ndarray) -> UploadPlan:
    """The run's upload plan from the first fed tile: bands in the feed
    dict's order, QA last."""
    entries = [UploadEntry(k, np.dtype(v.dtype).name) for k, v in dn.items()]
    entries.append(UploadEntry("qa", np.dtype(qa.dtype).name))
    px, ny = (int(s) for s in qa.shape)
    return UploadPlan(entries=tuple(entries), px=px, ny=ny)


@functools.lru_cache(maxsize=None)
def _layout(plan: UploadPlan) -> tuple[tuple[tuple[int, int], ...], int]:
    """Per-entry ``(word_offset, word_count)`` and the total wire words;
    every entry starts on a word boundary (odd tails zero-padded)."""
    offs: list[tuple[int, int]] = []
    off_w = 0
    for e in plan.entries:
        nbytes = plan.px * plan.ny * np.dtype(e.dtype).itemsize
        nw = (nbytes + 3) // 4
        offs.append((off_w, nw))
        off_w += nw
    return tuple(offs), off_w


def plan_wire_bytes(plan: UploadPlan) -> int:
    """Bytes one packed tile transfer moves (word padding included)."""
    return _layout(plan)[1] * 4


def pack_inputs(
    dn: dict, qa: np.ndarray, plan: UploadPlan, out: "np.ndarray | None" = None
) -> np.ndarray:
    """Host-side pack: every planned array → one ``uint32`` word buffer.

    Pure memcpy (one per entry); ``out`` (``uint32``, the plan's word
    count — in practice a view of a pinned buffer) receives the words when
    given.  The words are the fed arrays' raw little-endian bytes.
    """
    offs, total_w = _layout(plan)
    buf = np.zeros(total_w, dtype=np.uint32) if out is None else out
    u8 = buf.view(np.uint8)
    for e, (off_w, nw) in zip(plan.entries, offs):
        a = qa if e.name == "qa" else dn[e.name]
        raw = np.ascontiguousarray(a).view(np.uint8).reshape(-1)
        lo = off_w * 4
        u8[lo : lo + raw.size] = raw
        u8[lo + raw.size : (off_w + nw) * 4] = 0
    return buf


def unpack_inputs(
    words: torch.Tensor, plan: UploadPlan
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Landed words (int32, any device) → per-band arrays + QA, as views."""
    offs, _total = _layout(plan)
    n = plan.px * plan.ny
    dn: dict[str, torch.Tensor] = {}
    qa = None
    for e, (off_w, nw) in zip(plan.entries, offs):
        a = words[off_w : off_w + nw].view(_TORCH[e.dtype])[:n]
        a = a.view(plan.px, plan.ny)
        if e.name == "qa":
            qa = a
        else:
            dn[e.name] = a
    if qa is None:
        raise ValueError("upload plan has no QA entry")
    return dn, qa


def resolve_packed(upload_packed: "bool | str", device: torch.device) -> bool:
    """``upload_packed`` ("auto"/True/False) → bool: "auto" packs only on a
    CUDA device (on the CPU the fed arrays are already where the program
    runs).  The wire format is little-endian, so a big-endian host never
    packs."""
    if upload_packed == "auto":
        return device.type == "cuda" and sys.byteorder == "little"
    if upload_packed and (device.type != "cuda" or sys.byteorder != "little"):
        raise ValueError(
            "upload_packed=True needs a CUDA device and a little-endian host"
        )
    return bool(upload_packed)


class _Stats:
    """Thread-safe upload counters."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.tiles = 0
        self.transfers = 0
        self.bytes = 0
        self.pack_s = 0.0
        self.wait_s = 0.0
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
                "backlog_max": self.backlog_max,
            }


class PackedUpload:
    """One tile's in-flight packed host→device copy."""

    packed = True

    def __init__(self, uploader: "TileUploader", words: torch.Tensor, landed) -> None:
        self._uploader = uploader
        self._words = words
        self._landed = landed

    def arrays(self) -> tuple[dict, torch.Tensor]:
        """The device arrays; the current stream waits for the landing."""
        faults.check("upload.wait")
        t0 = time.perf_counter()
        cur = torch.cuda.current_stream(self._words.device)
        cur.wait_event(self._landed)
        # the words were allocated on the side stream: tell the caching
        # allocator the compute stream uses them too
        self._words.record_stream(cur)
        dn, qa = unpack_inputs(self._words, self._uploader.plan)
        self._uploader.stats.add(wait_s=time.perf_counter() - t0, tiles=1)
        return dn, qa


class SyncUpload:
    """The per-array path: the fed host arrays as tensors on ``device``."""

    packed = False

    def __init__(self, uploader: "TileUploader", dn: dict, qa: np.ndarray) -> None:
        self._uploader = uploader
        self._dn = dn
        self._qa = qa
        uploader.stats.add(
            transfers=len(dn) + 1,
            bytes=sum(a.nbytes for a in dn.values()) + qa.nbytes,
        )

    def arrays(self) -> tuple[dict, torch.Tensor]:
        self._uploader.stats.add(tiles=1)
        return to_device(self._dn, self._qa, self._uploader.device)


def to_device(dn: dict, qa: np.ndarray, device: torch.device) -> tuple[dict, torch.Tensor]:
    """Fed host arrays → tensors on ``device``, one copy per array (the
    per-array path, and the retry ladder's re-upload)."""
    return (
        {k: torch.from_numpy(v).to(device) for k, v in dn.items()},
        torch.from_numpy(qa).to(device),
    )


class TileUploader:
    """Per-run upload strategy: plan once, then one handle per tile."""

    def __init__(self, device: torch.device, packed: bool) -> None:
        self.device = torch.device(device)
        self.packed = packed
        self.demoted = False
        self.plan: UploadPlan | None = None
        self.stats = _Stats()
        self._stream = None
        if packed:
            self._stream = torch.cuda.Stream(device=self.device)

    def demote(self) -> None:
        """Drop to the per-array path for the rest of the run (after
        repeated upload failures); artifacts are byte-identical either way
        and in-flight packed handles still resolve."""
        self.packed = False
        self.demoted = True

    def start(self, dn: dict, qa: np.ndarray) -> "PackedUpload | SyncUpload":
        """Issue one tile's upload; a packed copy starts crossing NOW."""
        if self.plan is None:
            self.plan = build_plan(dn, qa)
        if not self.packed:
            return SyncUpload(self, dn, qa)
        t0 = time.perf_counter()
        _offs, total_w = _layout(self.plan)
        host = torch.empty(total_w, dtype=torch.int32, pin_memory=True)
        pack_inputs(dn, qa, self.plan, out=host.numpy().view(np.uint32))
        landed = torch.cuda.Event()
        with torch.cuda.stream(self._stream):
            words = host.to(self.device, non_blocking=True)
            landed.record(self._stream)
        self.stats.add(
            pack_s=time.perf_counter() - t0,
            transfers=1,
            bytes=plan_wire_bytes(self.plan),
        )
        return PackedUpload(self, words, landed)

    def note_backlog(self, depth: int) -> None:
        self.stats.note_backlog(depth)

    def summary(self) -> dict:
        """Run-scoped counters for the run summary."""
        return {"packed": self.packed, "demoted": self.demoted, **self.stats.snapshot()}
