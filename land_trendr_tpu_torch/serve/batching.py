"""Cross-job continuous batching: one shared launch, per-job artifacts.

At fleet scale the dominant workload is a flood of small-AOI requests,
and one job = one run = one pipeline: every tiny job pays its own
dispatch, padding, and pipeline-drain overhead while the device idles
between jobs.  This module closes that per-launch waste (ROADMAP item
1's raw-speed story at high QPS) by coalescing the tiles of MANY queued
**same-affinity** jobs behind ONE warm pipeline launch:

* :meth:`JobRequest.affinity_key` already proves shape-compatibility
  without executing — two requests with the same key run the SAME
  compiled programs over the SAME decoded blocks, differing only in
  identity (tenant, priority, deadline, directories, trace id).  The
  ``ProgramCache`` key pins the one compiled program they share.
* The dispatcher therefore runs the **leader** job's Run exactly once
  and, as each tile becomes durable (the driver's ``on_tile_durable``
  hook, AFTER ``manifest.record``), **demuxes** the same arrays into
  every member job's own manifest — same fingerprint, same execution
  context, same deterministic ``.npz`` writer — so every member's
  artifacts are **byte-identical** to a one-run-per-job execution.
* Members are never claimed out of the queue: they drain through the
  normal priority/DRR order and their Runs simply *resume* over the
  demuxed manifests (tiles already done, near-zero device work), so
  first-write-wins durability, resume, quarantine, cancel and SLO
  semantics are the stock per-job semantics, untouched.  Batching
  changes packing, never fairness ordering.

Failure isolation is structural: a ``batch.pack`` fault excludes one
candidate (it runs solo later); a ``batch.demux`` fault — or a member
cancelled mid-batch — stops THAT member's demux only, and its own run
recomputes whatever is missing, byte-identically.  A leader dying
mid-batch leaves every member a partially-demuxed manifest its normal
resume completes.  A SIGKILL mid-batch is just the crash story the
manifest already tells.

The **shared batch buffer** is pre-touched per launch: the batch-shaped
float32 scratch block is allocated on the run's device, summed and
released into PyTorch's caching allocator (never returned to the
driver: no ``empty_cache()``), so the allocator serves the launch's real
uploads from pages it already holds instead of growing under the first
tile.  The counterpart of the JAX package's donated ``jax.jit`` consume
program.  Best-effort, as there: a failed warm-up is logged and the
launch pays first-tile allocation instead; it never wraps a kernel
launch.
"""

from __future__ import annotations

import logging
import threading

import torch

from land_trendr_tpu_torch.runtime import faults
from land_trendr_tpu_torch.runtime.manifest import TileManifest

__all__ = ["CrossJobBatch", "resolve_batch", "warm_batch_buffer"]

log = logging.getLogger("land_trendr_tpu_torch.serve.batching")


def warm_batch_buffer(n_px: int, n_years: int, device: "torch.device | str" = "cpu") -> float:
    """Pre-touch the batch-shaped scratch allocation for one shared
    launch: allocate the ``(n_px, n_years)`` float32 block the batch's
    tiles will stream through on ``device``, sum it, and release it into
    the caching allocator.  Best-effort — a warm-up failure must never
    fail the batch (the launch just pays first-tile allocation instead)."""
    try:
        buf = torch.zeros((int(n_px), int(n_years)), dtype=torch.float32, device=device)
        out = float(buf.sum())
        del buf  # back to the caching allocator, which keeps the pages
        return out
    except Exception:
        log.warning("batch buffer warm-up failed", exc_info=True)
        return 0.0


def resolve_batch(
    batch: "bool | str",
    tune_store_dir: "str | None" = None,
    scene_shape: "tuple[int, int, int] | None" = None,
    device: "torch.device | str | None" = None,
) -> bool:
    """Resolve the ``ServeConfig.batch`` knob ("auto"/True/False) to a bool.

    Explicit values ALWAYS win (the autotuner contract).  ``"auto"``
    consults the replica's tuning store
    (:class:`~land_trendr_tpu_torch.tune.store.TuningStore`) for ``device``'s
    profile (default: the current CUDA device) over the scene's shape class: a profile carrying a
    ``"batch"`` knob pins the verdict; no store, no profile, or no such
    knob defaults **ON** — batching is byte-identical packing with no
    numeric trade, so only a measured regression (the window wait
    dominating tiny scenes) should ever turn it off.
    """
    if batch is True or batch is False:
        return batch
    if batch != "auto":
        raise ValueError(
            f"batch={batch!r} must be True, False or 'auto'"
        )
    if tune_store_dir and scene_shape is not None:
        from land_trendr_tpu_torch.tune.autotune import device_identity
        from land_trendr_tpu_torch.tune.store import TuningStore, shape_class

        try:
            device_kind, backend = device_identity(device)
            profile = TuningStore(tune_store_dir).load(
                device_kind, backend, shape_class(*scene_shape)
            )
        except Exception:
            log.debug("batch tuning-store resolution failed", exc_info=True)
            profile = None
        if profile is not None:
            return bool(profile.get("knobs", {}).get("batch", True))
    return True


class _Member:
    """One batch member's demux state: its lazily-opened manifest, the
    demuxed-tile ledger, and the active flag a fault/cancel clears."""

    def __init__(self, job) -> None:
        self.job = job
        self.manifest: "TileManifest | None" = None
        self.done: "set[int]" = set()
        self.tiles = 0
        self.active = True
        self.error: "str | None" = None


class CrossJobBatch:
    """One coalesced launch: a leader Run plus the member jobs its
    durable tiles demux into.

    Lifecycle (driven by the server's dispatcher):

    1. construct with the popped leader job and the same-affinity
       members collected from the contiguous front of the queue;
    2. :meth:`open` once the leader's Run exists (knobs resolved, tiles
       planned) — trims members to ``batch_max_tiles``, stamps the
       run's ``batch_*`` progress keys, warms the shared buffer, and
       returns the ``batch_launch`` stats;
    3. the Run's ``on_tile_durable`` hook calls :meth:`demux_tile` per
       durable tile (writer threads — internally locked);
    4. :meth:`finalize` after the leader's execute returns the
       per-member ``batch_demux`` stats.

    Never raises into the driver: a demux failure deactivates that one
    member (its own run recomputes, byte-identically) and batch-mates
    proceed.
    """

    def __init__(self, leader, members, *, compress: str = "none") -> None:
        self.leader = leader
        self.members = [_Member(j) for j in members]
        self.compress = compress
        self.run = None
        self._lock = threading.Lock()
        self._stats: "dict | None" = None

    @property
    def jobs(self) -> int:
        """Jobs sharing the launch (leader + still-packed members)."""
        return 1 + len(self.members)

    def open(self, run, *, max_tiles: int = 0, window_wait_s: float = 0.0) -> dict:
        """Bind the leader's constructed Run and settle the batch shape.

        ``max_tiles`` (``ServeConfig.batch_max_tiles``) bounds the
        TOTAL coalesced tiles — jobs × tiles-per-job; members past the
        bound are dropped here and simply run solo in their normal
        queue turn.  Returns the ``batch_launch`` event stats.
        """
        self.run = run
        # demuxed artifacts must be the bytes the member's own run
        # would have written — same compression knob included
        self.compress = run.cfg.manifest_compress
        per_job = max(1, len(run.tiles))
        if max_tiles:
            keep = max(0, max_tiles // per_job - 1)
            if keep < len(self.members):
                dropped = self.members[keep:]
                self.members = self.members[:keep]
                log.info(
                    "batch bounded at %d tiles: %d member(s) run solo",
                    max_tiles, len(dropped),
                )
        ts = int(run.cfg.tile_size)
        useful_px = sum(t.h * t.w for t in run.tiles)
        padded_per_job = per_job * ts * ts
        n_jobs = self.jobs
        occupancy = (
            useful_px / padded_per_job if padded_per_job else 1.0
        )
        run.progress.update(
            batch_jobs=n_jobs,
            batch_tiles=n_jobs * per_job,
            batch_occupancy=round(occupancy, 4),
        )
        if self.members:
            warm_batch_buffer(ts * ts, run.stack.n_years, run.device)
        self._stats = {
            "jobs": n_jobs,
            "tiles": n_jobs * per_job,
            "padded_px": n_jobs * padded_per_job,
            "occupancy": round(min(1.0, max(occupancy, 1e-9)), 6),
            "window_wait_s": round(window_wait_s, 6),
        }
        return dict(self._stats)

    def _member_manifest(self, m: _Member) -> TileManifest:
        """The member's own manifest, opened on first demux with the
        LEADER's fingerprint + execution context (same affinity ⇒ same
        fingerprint; same process ⇒ same context), so the member's own
        resumed Run validates and skips every demuxed tile."""
        if m.manifest is None:
            lead = self.run.manifest
            m.manifest = TileManifest(
                m.job.workdir,
                lead.fingerprint,
                context=(
                    dict(lead.context) if lead.context is not None else None
                ),
            )
            # first-write-wins across batches too: a member demuxed by
            # an earlier batch (or resuming a pinned workdir) keeps its
            # durable tiles — demux never overwrites a done artifact
            m.done = m.manifest.open(resume=True)
        return m.manifest

    def demux_tile(self, t, arrays: dict, meta: dict) -> None:
        """The leader Run's ``on_tile_durable`` hook: fan one durable
        tile out to every still-active member's manifest.

        Runs on the leader's writer threads (locked — member manifests
        append sequentially).  Per-member isolation: a ``batch.demux``
        fault or any real write error deactivates THAT member only —
        its own run recomputes the missing tiles byte-identically —
        and a member cancelled while queued stops receiving tiles."""
        with self._lock:
            for m in self.members:
                if not m.active:
                    continue
                if m.job.cancel.is_set() or m.job.state not in (
                    "queued", "running"
                ):
                    m.active = False
                    continue
                try:
                    faults.check("batch.demux")
                    man = self._member_manifest(m)
                    if t.tile_id in m.done:
                        continue  # first write won already
                    # the leader's meta minus lease attribution: the
                    # arrays (the byte-identity surface) are shared; the
                    # manifest line is informational either way
                    man.record(
                        t.tile_id,
                        arrays,
                        {k: v for k, v in meta.items() if k != "owner"},
                        compress=self.compress,
                    )
                    m.tiles += 1
                except Exception as e:
                    m.active = False
                    m.error = f"{type(e).__name__}: {e}"
                    log.warning(
                        "batch demux to job %s stopped after %d tile(s): "
                        "%s (its own run recomputes the rest)",
                        m.job.job_id, m.tiles, m.error,
                    )

    def finalize(self) -> list:
        """Per-member ``batch_demux`` stats after the leader's execute:
        ``(job, tiles_demuxed, error, complete)`` tuples in pack order.
        ``complete`` means the member's manifest now covers every tile
        the leader planned (pre-existing durable tiles included) — its
        queue turn is a pure resume, so the dispatcher skips the batch
        window for it entirely."""
        n_tiles = len(self.run.tiles) if self.run is not None else 0
        with self._lock:
            return [
                (
                    m.job,
                    m.tiles,
                    m.error,
                    n_tiles > 0 and len(m.done) + m.tiles >= n_tiles,
                )
                for m in self.members
            ]
