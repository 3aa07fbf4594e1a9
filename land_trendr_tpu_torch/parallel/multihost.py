"""Multi-process (pod) runs: process group, host shares, event-log merge.

Counterpart of ``land_trendr_tpu/parallel/multihost.py``.  A pod is N
processes — one per host, or several on one host — that share a workdir
on a shared filesystem.  Tiles are the cross-process work unit: each
process either takes its contiguous :func:`host_share` of the tile list
(the static split) or claims tiles from the manifest's lease queue
(``RunConfig.lease_batch``, :mod:`land_trendr_tpu_torch.runtime.leases`).
The shared manifest is the pod's job state; no tensor crosses processes
and no collective runs.

:func:`init_distributed` joins a ``torch.distributed`` process group on
the ``gloo`` backend, which gives each process its
:func:`process_index` / :func:`process_count`.  The group carries no data:
the per-process event files are merged by the primary process through the
shared filesystem (:func:`merge_host_event_logs`).

PyTorch has no global array, so :func:`feed_global` and
:func:`gather_local_rows` handle **this process's** rows only: they place
them on the local mesh and gather them back, with the rows' global offset
alongside — the local half of the JAX package's global-array pair.

Everything degrades to one process: without a process group
``process_index() == 0`` and ``process_count() == 1``.
"""

from __future__ import annotations

import datetime
import logging
import os
import time
from typing import NamedTuple, Sequence, TypeVar

import numpy as np
import torch

from land_trendr_tpu_torch.parallel.mesh import shard_pixels

__all__ = [
    "LocalRows",
    "feed_global",
    "gather_local_rows",
    "host_share",
    "init_distributed",
    "is_primary_host",
    "merge_host_event_logs",
    "process_count",
    "process_index",
]

_T = TypeVar("_T")

_log = logging.getLogger(__name__)


def _cluster_env_detected() -> bool:
    """True when the environment says this process is one of several: a
    failed :func:`init_distributed` there must raise, not fall back to one
    process — N processes silently each computing the whole scene would
    race on the same outputs.

    The markers: torchrun's ``WORLD_SIZE > 1`` or ``MASTER_ADDR``, and a
    SLURM job with more than one task (one task is just a batch wrapper).
    """
    try:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            return True
    except ValueError:
        pass
    if os.environ.get("MASTER_ADDR"):
        return True
    if os.environ.get("SLURM_JOB_ID"):
        ntasks = os.environ.get("SLURM_NTASKS") or os.environ.get("SLURM_NPROCS", "1")
        try:
            if int(ntasks) > 1:
                return True
        except ValueError:
            pass
    return False


def _env_rendezvous() -> "tuple[str, int, int]":
    """``(init_method, world_size, rank)`` from torchrun or SLURM variables."""
    addr = os.environ.get("MASTER_ADDR")
    port = os.environ.get("MASTER_PORT")
    if not addr or not port:
        raise RuntimeError(
            "cluster markers found but MASTER_ADDR/MASTER_PORT are not both "
            "set; pass coordinator_address, num_processes and process_id"
        )
    world = os.environ.get("WORLD_SIZE") or os.environ.get("SLURM_NTASKS")
    rank = os.environ.get("RANK") or os.environ.get("SLURM_PROCID")
    if world is None or rank is None:
        raise RuntimeError(
            "cluster markers found but no WORLD_SIZE/RANK (or SLURM_NTASKS/"
            "SLURM_PROCID); pass num_processes and process_id"
        )
    return f"tcp://{addr}:{port}", int(world), int(rank)


def init_distributed(
    coordinator_address: "str | None" = None,
    num_processes: "int | None" = None,
    process_id: "int | None" = None,
    timeout_s: float = 300.0,
) -> bool:
    """Join the pod's ``torch.distributed`` process group (``gloo``).

    Call once per process before the run.  ``coordinator_address`` is
    ``host:port`` (process 0 listens there; ``tcp://`` may prefix it).
    Explicit arguments win; with none, torchrun's or SLURM's variables are
    used when they mark a multi-process job.  Returns True when the group
    came up and False — the single-process no-op — when nothing was asked
    for and no cluster marker is set.  An explicit request that fails
    (unreachable coordinator, ``timeout_s`` exceeded) raises, as does a
    failure where cluster markers are set.
    """
    import torch.distributed as dist

    explicit = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
    )
    if not explicit and not _cluster_env_detected():
        return False
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError(
                "init_distributed needs coordinator_address, num_processes "
                "and process_id together"
            )
        addr = coordinator_address
        init = addr if addr.startswith("tcp://") else f"tcp://{addr}"
        world, rank = int(num_processes), int(process_id)
    else:
        init, world, rank = _env_rendezvous()
    if not 0 <= rank < world:
        raise ValueError(f"process_id={rank} outside 0..{world - 1}")
    if dist.is_initialized():
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise RuntimeError(
                f"a process group (rank {dist.get_rank()} of "
                f"{dist.get_world_size()}) is already up in this process"
            )
        return True
    dist.init_process_group(
        "gloo",
        init_method=init,
        world_size=world,
        rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


def process_index() -> int:
    """This process's rank in the pod (0 without a process group)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    """The pod's process count (1 without a process group)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_primary_host() -> bool:
    """True on the process that merges the pod's event logs."""
    return process_index() == 0


def host_share(items: Sequence[_T]) -> list[_T]:
    """The contiguous slice of ``items`` (e.g. tile specs) this process takes.

    Near-equal contiguous blocks in process order, the remainder one per
    process from process 0 (``np.array_split`` order, computed with plain
    slicing so items pass through untouched) — the JAX package's split.
    The static split strands a slow or dead process's whole share; the
    lease queue (``RunConfig.lease_batch > 0``) replaces it.
    """
    n, i = process_count(), process_index()
    q, r = divmod(len(items), n)
    start = i * q + min(i, r)
    stop = start + q + (1 if i < r else 0)
    return list(items[start:stop])


class LocalRows(NamedTuple):
    """This process's rows of a pixel batch, placed on its local mesh."""

    #: one contiguous ``(rows / len(mesh), NY)`` block per mesh device
    values: "list[torch.Tensor]"
    mask: "list[torch.Tensor]"
    #: global index of this process's first row (``process_index x rows``)
    offset: int
    #: rows of the whole pod's batch (``rows x process_count``)
    n_global: int


def feed_global(mesh: Sequence[torch.device], local_values, local_mask) -> LocalRows:
    """Place this process's ``(rows, NY)`` values and mask on its local mesh.

    Every process passes the same row count (pad with fully-masked rows
    first, ``pad_to_multiple``), a multiple of the mesh size.  PyTorch has
    no global array: what comes back is this process's blocks, one per
    mesh device, with their global row offset — the local part of the JAX
    package's globally sharded array.  Nothing crosses processes.
    """
    shards = shard_pixels(mesh, local_values, local_mask)
    rows = int(local_values.shape[0])
    return LocalRows(
        values=[v for v, _ in shards],
        mask=[m for _, m in shards],
        offset=process_index() * rows,
        n_global=rows * process_count(),
    )


def gather_local_rows(shards: Sequence[torch.Tensor]) -> np.ndarray:
    """This process's rows of a pixel-sharded output, as one NumPy block.

    The inverse of :func:`feed_global`: ``shards`` are the per-device
    outputs in mesh order; they are concatenated in pixel order on the
    host.  Each process persists its own rows; no process materialises
    the pod's whole output.
    """
    # the host copy is this function's purpose: the caller persists rows
    # lt: noqa[LT002]
    return np.concatenate([s.detach().cpu().numpy() for s in shards], axis=0)


def merge_host_event_logs(
    workdir: str,
    expect_hosts: "int | None" = None,
    timeout_s: float = 60.0,
    poll_s: float = 0.1,
    newer_than: "float | None" = None,
) -> list[dict]:
    """Merge every per-process ``events*.jsonl`` in a shared workdir into
    per-host run aggregates — the primary process's fold for the run
    summary.

    Each process keeps its telemetry in its own file
    (:func:`land_trendr_tpu_torch.obs.events_path`), so merging is a plain
    shared-filesystem read.  With ``expect_hosts`` the merge WAITS
    (bounded by ``timeout_s``) until that many files end their last run
    scope with ``run_done``; on timeout the partial merge is returned with
    a warning, so a crashed peer cannot hang the primary's summary.
    While waiting, terminal state is probed from each file's tail only;
    the full parse happens once, after the wait.

    ``newer_than`` (a wall-clock time — the caller's run start minus a
    clock-skew slack) guards a reused workdir: a file not modified since
    then holds only a previous scope, is never counted terminal, and its
    summary carries ``"stale": True``.
    """
    from land_trendr_tpu_torch.obs.events import discover_event_files, summarize_events_file
    from land_trendr_tpu_torch.runtime import faults

    def _files() -> list[str]:
        try:
            return discover_event_files(workdir, process_count=expect_hosts)
        except FileNotFoundError:
            return []

    def _stale(path: str) -> bool:
        if newer_than is None:
            return False
        try:
            return os.path.getmtime(path) < newer_than
        except OSError:
            return True

    def _tail_terminal(path: str, tail_bytes: int = 8192) -> bool:
        # terminal = the LAST run scope has its run_done: a run_done with a
        # run_start after it belongs to a finished previous scope
        if faults.fired("merge.peer"):
            # behavioral fault seam: the probed peer reads as not terminal
            # (slow or dead), driving the bounded wait and partial merge
            return False
        if _stale(path):
            return False
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - tail_bytes))
                tail = f.read()
        except OSError:
            return False
        done = tail.rfind(b'"ev":"run_done"')
        return done >= 0 and done > tail.rfind(b'"ev":"run_start"')

    # wall-clock domain: the deadline is this process's own monotonic clock
    deadline = time.monotonic() + timeout_s
    terminal: set[str] = set()
    while True:
        files = _files()
        terminal.update(p for p in files if p not in terminal and _tail_terminal(p))
        n_terminal = sum(1 for p in files if p in terminal)
        if expect_hosts is None or n_terminal >= expect_hosts:
            break
        if time.monotonic() > deadline:
            _log.warning(
                "merge_host_event_logs: only %d/%d hosts reached run_done "
                "within %.0fs; returning the partial merge",
                n_terminal, expect_hosts, timeout_s,
            )
            break
        time.sleep(poll_s)
    merged = []
    for p in files:
        s = summarize_events_file(p)
        if p not in terminal and _stale(p):
            s["stale"] = True
        merged.append(s)
    return merged
