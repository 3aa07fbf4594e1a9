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
import urllib.request
from pathlib import Path

import numpy as np

__all__ = ["digest_workdir", "replica_launches", "write_json_atomic", "write_text_atomic"]


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
