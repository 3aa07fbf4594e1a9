"""Warm program cache: tile-program admission across jobs.

Counterpart of ``land_trendr_tpu/serve/programs.py``.  In the JAX package
"warm" means the jit executables are resident; here it means the kernel
library is loaded (built from ``csrc/segment_fused.cu`` at first use) and
the tile program's first launch has been paid for this key.  A long-lived
server needs the *contract* and the *accounting* on top:

* an explicit **cache key** over everything that selects a distinct
  program — the run fingerprint (index, params, tile/chunk geometry,
  products, years shape), the card's name, the resolved impl, the kernel
  instantiation (narrow or wide), the mesh width, the packed-path
  choices and the fed dtypes — so "warm" is a checkable property;
* **admission**: the driver's serve path
  (:class:`land_trendr_tpu_torch.runtime.driver.Run` with ``programs=``)
  asks this cache before the first tile.  A **miss** pays one launch on a
  fully masked dummy tile pushed through the exact upload → dispatch →
  fetch chain (so a cold job launches tiles + 1 times); a **hit** skips it
  (a warm job launches once per tile);
* **observability**: per-run hit/miss/compile_s (the ``program_cache``
  event; ``compile_s`` is the miss's warm-up seconds) and server-wide
  totals for the ``lt_serve_*`` warm-ratio instruments.

The process is the residency boundary: the loaded library lives as long
as the process, so there is nothing to pin and nothing to evict.
"""

from __future__ import annotations

import hashlib
import json
import threading

__all__ = ["ProgramCache"]


class ProgramCache:
    """Thread-safe admission index + accounting over the process's warm
    tile programs."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: key → compile seconds its miss paid
        self._compiled: dict[str, float] = {}
        self._hits = 0
        self._misses = 0
        self._compile_s = 0.0

    @staticmethod
    def key_for(**facts) -> str:
        """Deterministic key over the compile-relevant run facts.

        Callers pass plain JSON-able values (the driver passes the run
        fingerprint, card name, impl, kernel instantiation, mesh width,
        padded pixel count, years count, chunking, packed-path flags, and
        fed dtypes); the
        key is the sorted-JSON digest, so fact ordering never matters
        and new facts can ride along without a format change.
        """
        blob = json.dumps(facts, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()

    def admit(self, key: str) -> bool:
        """True when ``key``'s programs are already resident (a warm
        run); False when the caller must compile (and then
        :meth:`record` the miss)."""
        with self._lock:
            return key in self._compiled

    def record(
        self, key: str, hit: bool, compile_s: float = 0.0, ok: bool = True
    ) -> None:
        """Account one run's verdict; a SUCCESSFUL miss registers the
        key as resident for every later run.  ``ok=False`` (the warm
        probe failed — nothing was compiled) counts the miss but leaves
        the key unregistered, so the next same-key run probes again
        instead of being falsely admitted warm."""
        with self._lock:
            if hit:
                self._hits += 1
            else:
                self._misses += 1
                self._compile_s += float(compile_s)
                if ok:
                    self._compiled.setdefault(key, float(compile_s))

    def stats(self) -> dict:
        """Server-wide totals: hits/misses/compile_s plus the resident
        key count (the ``program_cache`` server-scope aggregate and the
        ``lt_serve_*`` warm-ratio feed)."""
        with self._lock:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "compile_s": round(self._compile_s, 6),
                "keys": len(self._compiled),
            }
