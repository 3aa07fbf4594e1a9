"""On-disk tuning store: calibration profiles keyed per device + scene class.

Counterpart of ``land_trendr_tpu/tune/store.py``, with the same schema,
file naming and key layout.  The autotuner
(:mod:`land_trendr_tpu_torch.tune.autotune`) spends seconds of probe time
discovering the right host-pipeline knob values for one ``(device kind,
backend, scene shape class)`` — spending them once per *fleet* instead of
once per run is the whole point.  This module is the persistence quarter:
one JSON profile file per key under a store directory, written **tmp +
atomic rename** (a reader never sees a torn file from a healthy writer, so
a torn file MEANS a crash and is dropped + re-probed), and reloaded on
sight by every consumer (``lt tune`` and ``Run`` construction's ``"auto"``
resolution).

Key semantics (the cache-correctness contract):

* ``device_kind`` + ``backend`` — knob values tuned on one device class do
  not transfer to another; each probes its own.  This package's backend is
  ``"cuda"`` on the card and ``"torch-cpu"`` on the CPU — never the JAX
  package's ``"cpu"`` — so a store shared by both packages never hands one
  package's profile to the other.
* ``shape_class`` — the balance points depend on scene shape (tile
  granularity vs per-tile overhead, cache budget vs working set), but
  only coarsely: pixels are bucketed by powers of four and years to the
  next multiple of eight, so a 1024² and a 1400² scene share a profile
  while a 256² thumbnail and a gigapixel mosaic do not.
* ``schema`` (:data:`TUNE_SCHEMA`) — a profile written by an older schema
  describes knobs/probes that may no longer exist; it is dropped
  (``stale_dropped``) and the key re-probes.

Unparseable or key-mismatched files are deleted (best-effort) and counted
(``corrupt_dropped``), never crashed on — the caller re-probes.
Standard library only.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import threading
import time

__all__ = [
    "TUNE_SCHEMA",
    "TuningStore",
    "profile_key",
    "shape_class",
]

#: bump when a profile's REQUIRED fields or a knob's meaning changes —
#: older profiles are then stale by definition and re-probe on sight
TUNE_SCHEMA = 1

#: fields every stored profile must carry to be loadable
_REQUIRED = ("schema", "device_kind", "backend", "shape_class", "knobs", "created_t")


def shape_class(height: int, width: int, n_years: int) -> str:
    """Coarse scene-shape bucket (see module docstring).

    Pixels bucket by powers of FOUR (``log4`` of the pixel count) and
    years to the next multiple of 8 — wide enough that jittered AOIs
    share a profile, narrow enough that a thumbnail and a gigapixel
    mosaic never do.
    """
    px = max(1, int(height) * int(width))
    ny = max(1, int(n_years))
    return f"px4e{int(math.log2(px)) // 2}_ny{((ny + 7) // 8) * 8}"


def profile_key(device_kind: str, backend: str, shape_cls: str) -> str:
    """The store key string (also what ``tune_profile`` events carry)."""
    return f"{device_kind}|{backend}|{shape_cls}"


def _fname(key: str) -> str:
    """Stable per-key filename (device names carry spaces)."""
    return f"profile-{hashlib.sha1(key.encode()).hexdigest()[:16]}.json"


class TuningStore:
    """One tuning-store directory (see module docstring).

    Thread-safe: one lock guards the counters; file operations rely on
    atomic rename (writers) and whole-file reads (readers), so concurrent
    processes sharing a store directory — a serving fleet's replicas —
    never see torn state and last-probe-wins is the (correct) answer for
    a re-probed key.
    """

    def __init__(self, root: str) -> None:
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lock = threading.Lock()
        self._stats = {
            "hits": 0,
            "misses": 0,
            "stale_dropped": 0,
            "corrupt_dropped": 0,
            "saves": 0,
        }

    # -- internals ---------------------------------------------------------
    def path_for(self, key: str) -> str:
        return os.path.join(self.root, _fname(key))

    def _count(self, name: str) -> None:
        with self._lock:
            self._stats[name] += 1

    def _drop(self, path: str, counter: str) -> None:
        """Delete a bad profile file (best-effort) and count why."""
        try:
            os.unlink(path)
        except OSError:
            pass  # a racing sibling already dropped it — same outcome
        self._count(counter)

    # -- the public contract ----------------------------------------------
    def load(self, device_kind: str, backend: str, shape_cls: str) -> "dict | None":
        """The profile for this key, or ``None`` (= probe).

        ``None`` covers: no file (miss), torn/unparseable file (dropped,
        ``corrupt_dropped``), a file whose embedded key does not match
        its name's key (dropped — hash collision or a copied-in foreign
        file), and a stale ``schema`` (dropped, ``stale_dropped``).
        """
        key = profile_key(device_kind, backend, shape_cls)
        path = self.path_for(key)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except FileNotFoundError:
            self._count("misses")
            return None
        except OSError:
            self._drop(path, "corrupt_dropped")
            return None
        try:
            profile = json.loads(raw)
        except (json.JSONDecodeError, UnicodeDecodeError):
            self._drop(path, "corrupt_dropped")
            return None
        if not isinstance(profile, dict) or any(
            k not in profile for k in _REQUIRED
        ) or not isinstance(profile.get("knobs"), dict):
            self._drop(path, "corrupt_dropped")
            return None
        if profile["schema"] != TUNE_SCHEMA:
            self._drop(path, "stale_dropped")
            return None
        if (
            profile["device_kind"] != device_kind
            or profile["backend"] != backend
            or profile["shape_class"] != shape_cls
        ):
            self._drop(path, "corrupt_dropped")
            return None
        self._count("hits")
        return profile

    def save(self, profile: dict) -> str:
        """Persist one profile (tmp + atomic rename); returns the path.

        The serialisation is canonical (sorted keys, fixed separators),
        so save → load → save round-trips byte-identically — the
        perf-gate's byte-stability invariant.
        """
        missing = [k for k in _REQUIRED if k not in profile]
        if missing:
            raise ValueError(f"profile missing required fields {missing}")
        key = profile_key(
            profile["device_kind"], profile["backend"], profile["shape_class"]
        )
        path = self.path_for(key)
        data = json.dumps(profile, sort_keys=True, separators=(",", ":"))
        tmp = f"{path}.{os.getpid()}.{time.monotonic_ns()}.tmp"
        with open(tmp, "w") as f:
            f.write(data)
        os.replace(tmp, path)
        self._count("saves")
        return path

    def profiles(self) -> list[dict]:
        """Every loadable profile in the store (for reports / ``lt tune``
        listings / the serve ``/healthz`` surface).  Bad files are left
        for their own keyed :meth:`load` to drop — a listing is a
        read-only observer."""
        out = []
        try:
            names = sorted(os.listdir(self.root))
        except OSError:
            return out
        for name in names:
            if not (name.startswith("profile-") and name.endswith(".json")):
                continue
            try:
                with open(os.path.join(self.root, name)) as f:
                    p = json.load(f)
            except (OSError, json.JSONDecodeError, UnicodeDecodeError):
                continue
            if isinstance(p, dict) and all(k in p for k in _REQUIRED):
                out.append(p)
        return out

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)
