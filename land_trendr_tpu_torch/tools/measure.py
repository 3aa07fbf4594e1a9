"""Shared helpers of the port's report-writing tools.

Counterpart of the JAX package's ``tools/_measure.py``: the one durable
write idiom (a sibling ``.tmp``, then ``os.replace`` onto the final name,
so a SIGKILL mid-write leaves the old report intact), plus the artifact
digest the soaks and benches compare runs by and the launch counts of a
fleet's replicas.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path
from typing import Callable

import numpy as np

__all__ = [
    "child_env",
    "digest_files",
    "digest_workdir",
    "disk_free",
    "merge_record",
    "record_meta",
    "replica_launches",
    "rss_mib",
    "smi_line",
    "source_digest",
    "peak_rss_mib",
    "write_json_atomic",
    "watch_rss",
    "write_text_atomic",
]


def write_text_atomic(path: str, text: str) -> None:
    """Commit ``text`` to ``path``: write ``path.tmp``, then rename it."""
    path = os.fspath(path)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def write_json_atomic(
    path: str,
    obj,
    indent: "int | None" = 2,
    trailing_newline: bool = True,
) -> None:
    """JSON flavour of :func:`write_text_atomic`; ``indent`` and
    ``trailing_newline`` keep each tool's output bytes."""
    text = json.dumps(obj, indent=indent)
    if trailing_newline:
        text += "\n"
    write_text_atomic(path, text)


def merge_record(path: str, key: str, entry: dict, indent: int = 1) -> None:
    """Add ``entry`` under ``key`` to the JSON object at ``path`` (made if
    absent), durably: a record that holds one entry per run, as the JAX
    tools' merged records do."""
    rec = {}
    if os.path.isfile(path):
        with open(path) as f:
            rec = json.load(f)
    rec[key] = entry
    write_json_atomic(path, rec, indent=indent)


def replica_launches(router) -> "dict[str, dict]":
    """replica id → its kernel launch counts (``GET /debug/kernels``) for
    every replica of a live :class:`~land_trendr_tpu_torch.fleet.
    FleetRouter` whose process still answers; launches are counted in the
    process that makes them, never in the router's."""
    with router._lock:
        bases = [(r.rid, r.base) for r in router.pool]
    out: "dict[str, dict]" = {}
    for rid, base in bases:
        try:
            with urllib.request.urlopen(base + "/debug/kernels", timeout=10) as r:
                out[rid] = json.loads(r.read())["launches"]
        except (OSError, ValueError, KeyError):
            continue  # a dead or draining replica has no counts to give
    return out


def digest_workdir(workdir: str) -> dict:
    """tile artifact name → {array name → sha256 of its raw bytes}.

    Array-content identity, not file identity: the ``.npz`` container
    embeds zip metadata (mtimes) that differs run to run, while the
    contract is about the data a resume or an assembly reads.
    """
    out: dict = {}
    for p in sorted(Path(workdir).glob("tile_*.npz")):
        with np.load(p) as z:
            out[p.name] = {
                name: hashlib.sha256(np.ascontiguousarray(z[name]).tobytes()).hexdigest()
                for name in sorted(z.files)
            }
    return out


def digest_files(directory: str) -> dict:
    """file name → sha256 of its bytes, for every file in ``directory``
    (byte equality of large rasters, read in 16 MiB pieces)."""
    out = {}
    for p in sorted(Path(directory).iterdir()):
        if p.is_file():
            h = hashlib.sha256()
            with open(p, "rb") as f:
                for piece in iter(lambda: f.read(1 << 24), b""):
                    h.update(piece)
            out[p.name] = h.hexdigest()
    return out


def _status_kib(field: str) -> "int | None":
    """A ``kB`` field of ``/proc/self/status`` (None where it has none)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except OSError:
        pass
    return None


#: the largest ``VmRSS`` the sampler of :func:`watch_rss` has read (KiB)
_SAMPLED_PEAK_KIB: "list[int]" = []


def watch_rss(interval_s: float = 0.02) -> "Callable[[], None]":
    """Where the kernel keeps no ``VmHWM`` (a gVisor sandbox, such as the
    card machine's), sample ``VmRSS`` on a daemon thread for
    :func:`peak_rss_mib`.  Call once, first thing in a tool's ``main``.
    Returns what stops the sampler and waits for it (a no-op where none
    was started); a tool may let it run to its exit."""
    if _SAMPLED_PEAK_KIB or _status_kib("VmHWM") is not None or _status_kib("VmRSS") is None:
        return lambda: None
    peak = _SAMPLED_PEAK_KIB
    peak.append(_status_kib("VmRSS") or 0)
    stop = threading.Event()

    def sample() -> None:
        while not stop.wait(interval_s):
            peak[0] = max(peak[0], _status_kib("VmRSS") or 0)

    sampler = threading.Thread(target=sample, name="rss-sampler", daemon=True)
    sampler.start()

    def stop_sampler() -> None:
        stop.set()
        sampler.join()

    return stop_sampler


def rss_mib() -> "float | None":
    """This process's resident set now (``VmRSS``), in MiB."""
    cur = _status_kib("VmRSS")
    return None if cur is None else round(cur / 1024, 1)


def peak_rss_mib() -> float:
    """This process's peak resident set in MiB: ``VmHWM`` of
    ``/proc/self/status``, the high-water mark of the address space this
    process's program has run in since its ``exec``; where there is none,
    the largest ``VmRSS`` sampled since :func:`watch_rss` (or the current
    one, where nothing has sampled).  Not ``ru_maxrss``: Linux and gVisor
    carry it across fork and exec, so a child started by a large parent
    reports at least the parent's resident set.  Raises where ``/proc``
    gives neither."""
    hwm = _status_kib("VmHWM")
    if hwm is not None:
        return round(hwm / 1024, 1)
    cur = _status_kib("VmRSS")
    if cur is None:
        raise RuntimeError("/proc/self/status gives neither VmHWM nor VmRSS")
    return round(max(_SAMPLED_PEAK_KIB + [cur]) / 1024, 1)


def disk_free(path: str) -> dict:
    """Free and total bytes of the file system that holds ``path`` (the
    nearest existing parent): scale runs record where they wrote."""
    p = Path(path).resolve()
    while not p.exists():
        p = p.parent
    usage = shutil.disk_usage(p)
    return {"path": str(p), "free_bytes": usage.free, "total_bytes": usage.total}


def smi_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` of card 0 (or why there
    is none): every time kept from the card stands beside it."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines else f"nvidia-smi rc {r.returncode}"


#: the package whose sources :func:`source_digest` covers
PACKAGE = Path(__file__).resolve().parent.parent
#: what the digest leaves out: build outputs, bytecode, the records themselves
_NOT_SOURCE = {"_build", "__pycache__", "records"}


def child_env(**extra: str) -> dict:
    """This process's environment with the package's checkout first on
    ``PYTHONPATH``: a tool's child process (``python -m
    land_trendr_tpu_torch...``) imports the same package from any cwd."""
    root = str(PACKAGE.parent)
    path = os.environ.get("PYTHONPATH", "")
    return {**os.environ, "PYTHONPATH": root + (os.pathsep + path if path else ""), **extra}


def source_digest() -> str:
    """sha256 over the package's source files (relative path and bytes of
    each, in path order; build outputs, bytecode and the records left
    out): the code a record was made with, checkable on any checkout,
    with or without ``.git``."""
    h = hashlib.sha256()
    for path in sorted(PACKAGE.rglob("*")):
        rel = path.relative_to(PACKAGE)
        if path.is_dir() or _NOT_SOURCE & set(rel.parts[:-1]) or path.suffix == ".pyc":
            continue
        h.update(rel.as_posix().encode() + b"\0")
        h.update(hashlib.sha256(path.read_bytes()).digest())
    return h.hexdigest()


def record_meta(module: str, argv: "list[str] | None", device: str) -> dict:
    """What a record of record carries besides its numbers, all as the run
    finds them: the exact command, the commit (``git rev-parse HEAD`` with
    ``-dirty`` for uncommitted changes; null where the checkout has no
    ``.git``), the :func:`source_digest` of the code that ran and, on the
    card, its ``nvidia-smi`` name and power limit."""
    args = sys.argv[1:] if argv is None else argv
    commit = None
    try:
        head = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True, text=True,
                              timeout=10, cwd=PACKAGE)
        if head.returncode == 0:
            dirty = subprocess.run(["git", "status", "--porcelain", "--", "."],
                                   capture_output=True, text=True, timeout=30, cwd=PACKAGE)
            commit = head.stdout.strip() + ("-dirty" if dirty.stdout.strip() else "")
    except (OSError, subprocess.SubprocessError):
        commit = None
    return {
        "command": " ".join(["python -m", module, *args]),
        "commit": commit,
        "source_sha256": source_digest(),
        "device": device,
        "nvidia_smi": smi_line() if device == "cuda" else None,
    }
