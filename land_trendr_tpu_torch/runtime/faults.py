"""Deterministic fault injection for the tile pipeline.

Counterpart of ``land_trendr_tpu/runtime/faults.py``, kept identical: the
same :data:`SEAMS`, default kinds, schedule grammar and firing rule, so a
``--fault-schedule`` string parses and fires the same way in both
packages.  Every brittle seam carries a **named injection point**, and a
seeded :class:`FaultPlan` decides — reproducibly, from ``(seed, seam,
invocation index)`` alone — which invocation of which seam raises which
error class.  Tiles are independent work units, so one bad tile must
never cost the other 10k; the plans below are how every "must never"
becomes a unit test.

Seams (the public contract — hosts call :func:`check` / :func:`fired` /
:func:`corrupt` with these names).  Every seam is declared so schedules
stay interchangeable; those of subsystems this package does not have yet
(router, replica, loadgen, journal, recover) never fire:

=================== =======================================================
``feed``            driver feed job (any stack; ``runtime/driver.py``)
``feed.decode``     windowed GeoTIFF block decode (``io/geotiff.py``)
``cache.corrupt``   decoded-block cache consumption — corruption, not an
                    exception (``io/geotiff.py`` via the blockcache hook)
``store.corrupt``   persistent block-store consumption — corruption of a
                    store-served block (``io/blockcache.py`` store tier)
``upload.wait``     packed host→device upload landing
                    (``runtime/feed.PackedUpload.arrays``)
``dispatch``        device dispatch of one tile's program (driver)
``compute.wait``    the sanctioned compute-waits (driver)
``fetch.wait``      device→host fetch landing (``runtime/fetch._to_host``)
``manifest.record`` tile artifact + manifest-line persist (entry)
``manifest.torn``   post-rename artifact truncation (behavioral: the
                    manifest truncates its own artifact, then raises)
``lease.acquire``   elastic lease-batch claim (``runtime/leases.py``):
                    the whole acquisition fails; the host backs off and
                    retries next cycle
``lease.steal``     an expired-lease steal claim: the steal write fails
                    (the tile stays stealable; a sibling or the next
                    cycle takes it)
``lease.expire``    behavioral: a live foreign lease reads as EXPIRED to
                    the probing host — forces the steal-while-the-owner-
                    still-runs double-execution race deterministically
                    (first durable write wins, artifacts byte-identical)
``merge.peer``      multihost event merge — a probed peer reads as
                    not-terminal (slow/dead peer; behavioral)
``serve.submit``    serve-mode job admission (``serve/server.py``): the
                    submission fails and is rejected; the server lives
``serve.job``       serve-mode job execution start: the job fails
                    terminally; sibling jobs and the server live
``debug.profile``   on-demand profiler capture (``POST /debug/profile``):
                    the capture fails (``profile_captured`` carries
                    ``ok=false``); the job and the server live
``obs.publish``     fleet snapshot publish (``obs/publish.py``): the
                    beat is skipped, the host ages toward stale; the
                    run lives
``history.append``  fleet history-ring append (``obs/history.py``):
                    one sample is lost; the ring stays consistent
``router.forward``  fleet-router job forward (``fleet/router.py``): the
                    POST to the chosen replica fails; the job re-enters
                    the router queue and routes again (bounded by
                    ``route_retries``) — never a lost job
``replica.health``  fleet-router health probe (behavioral): a live
                    replica's probe reads as FAILED — enough
                    consecutive fires mark the replica unready without
                    failing any accepted job
``tune.probe``      autotuner calibration probe (``tune/autotune.py``):
                    the knob group's probe fails and is SKIPPED — its
                    knobs fall back to defaults (``tune_probe`` event
                    ``ok=false``); the tuner and the run behind it live
``batch.pack``      cross-job batch membership claim (``serve/batching``):
                    the candidate job is EXCLUDED from the batch and runs
                    solo later; the batch and its other members live
``batch.demux``     batched-result demux to one member's manifest
                    (``serve/batching``): that member stops receiving
                    demuxed tiles and recomputes them in its own run
                    (byte-identical); batch-mates are untouched
``router.journal``  admission-journal append (``fleet/journal.py``): the
                    record cannot be made durable, so THAT admission
                    fails loudly (503 ``journal_error``) instead of
                    accepting a job a crash would orphan; a resubmit
                    after the fault clears completes normally
``router.recover``  post-restart reconciliation probe (``fleet/router``):
                    the replica answer is unavailable, so the replayed
                    job is requeued front with ``resume=true`` — the
                    pinned workdir resumes byte-identically under the
                    preserved trace id; never a lost or doubled job
=================== =======================================================

Schedules are strings (CLI ``--fault-schedule``) or :class:`FaultSpec`
lists (tests)::

    seed=7,dispatch@1               # 2nd dispatch invocation raises
    seed=7,fetch.wait@0*3=io        # invocations 0,1,2 raise OSError
    seed=3,feed.decode%0.25         # each invocation fires with p=0.25
    seed=1,compute.wait@1=hang:30   # sliced 30s hang (watchdog food)

Error kinds: ``runtime`` (RuntimeError — the device-fault shape), ``io``
(OSError), ``enospc`` (OSError errno.ENOSPC), ``value`` (ValueError — the
corrupt-stream shape), ``hang:SECS`` (interruptible sliced sleep, for the
stall watchdog), ``slow:SECS`` (sleep then proceed — stragglers/crash
windows), ``corrupt`` (only meaningful at ``cache.corrupt``) and ``fire``
(behavioral seams).  Probability draws hash ``(seed, seam, index)``
through :func:`zlib.crc32` — no interpreter hash salt, no shared RNG
stream — so a schedule reproduces across processes and thread schedules.
Invocation INDICES are deterministic when each seam's consumers run in a
deterministic order (the shipped soak/tests use single feed/writer
workers); readahead prefetch tasks never consume io-seam indices (see
``blockcache.fault_check``), so demand reads keep their ordering even
with a busy prefetch pool.

Everything here is stdlib-only and import-light: io-layer hosts reach the
active plan through :func:`land_trendr_tpu_torch.io.blockcache.fault_check`
(registered by :func:`activate`) so ``io/`` never imports ``runtime/``.
The stall watchdog's food (``hang``) is sliced so its interrupt lands
between slices.
"""

from __future__ import annotations

import errno
import threading
import time
import zlib
from typing import Callable, NamedTuple

__all__ = [
    "SEAMS",
    "FaultSpec",
    "FaultPlan",
    "parse_schedule",
    "activate",
    "deactivate",
    "active",
    "check",
    "fired",
    "corrupt",
    "set_observer",
]

#: every seam a host module declares (misspelled schedule specs are
#: config errors, not silently-dead injections)
SEAMS = (
    "feed",
    "feed.decode",
    "cache.corrupt",
    "store.corrupt",
    "upload.wait",
    "dispatch",
    "compute.wait",
    "fetch.wait",
    "manifest.record",
    "manifest.torn",
    "lease.acquire",
    "lease.steal",
    "lease.expire",
    "merge.peer",
    "serve.submit",
    "serve.job",
    "debug.profile",
    "obs.publish",
    "history.append",
    "router.forward",
    "replica.health",
    "tune.probe",
    "loadgen.tick",
    "batch.pack",
    "batch.demux",
    "router.journal",
    "router.recover",
)

#: error kinds that RAISE at the seam (vs behavioral kinds)
_RAISING_KINDS = ("runtime", "io", "enospc", "value")

_DEFAULT_KIND = {
    "feed": "io",
    "feed.decode": "value",
    "cache.corrupt": "corrupt",
    "store.corrupt": "corrupt",
    "upload.wait": "runtime",
    "dispatch": "runtime",
    "compute.wait": "runtime",
    "fetch.wait": "runtime",
    "manifest.record": "io",
    "manifest.torn": "fire",
    "lease.acquire": "io",
    "lease.steal": "io",
    "lease.expire": "fire",
    "merge.peer": "fire",
    "serve.submit": "io",
    "serve.job": "runtime",
    "debug.profile": "runtime",
    "obs.publish": "io",
    "history.append": "io",
    "router.forward": "io",
    "replica.health": "fire",
    "tune.probe": "runtime",
    "loadgen.tick": "fire",
    "batch.pack": "io",
    "batch.demux": "io",
    "router.journal": "io",
    "router.recover": "io",
}


class FaultSpec(NamedTuple):
    """One scheduled fault: WHERE (seam), WHEN (``at``+``times`` exact
    invocations, or ``prob`` per invocation), WHAT (error kind + numeric
    ``arg`` for ``hang``/``slow`` seconds)."""

    seam: str
    at: "int | None" = None
    times: int = 1
    prob: "float | None" = None
    error: str = ""      # "" = the seam's default kind
    arg: "float | None" = None


class FaultInjected(RuntimeError):
    """Marker mixin-free base so consumers can tell injected faults in
    logs; raising seams still raise realistic classes (OSError etc.) —
    this type is only used for the generic ``runtime`` kind."""


def _make_error(kind: str, seam: str, index: int) -> BaseException:
    msg = f"injected fault at {seam}#{index}"
    if kind == "io":
        return OSError(msg)
    if kind == "enospc":
        return OSError(errno.ENOSPC, f"No space left on device ({msg})")
    if kind == "value":
        return ValueError(msg)
    return FaultInjected(msg)


def _hang(seconds: float) -> None:
    """Sliced sleep: a hung-device stand-in the stall watchdog's
    ``interrupt_main`` CAN preempt (a pending ``KeyboardInterrupt`` is
    delivered between slices, unlike one long C-level sleep)."""
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        time.sleep(0.05)


class FaultPlan:
    """A seeded, deterministic schedule over the named seams.

    Thread-safe: seams fire from the driver loop, the feed/writer pools
    and the watchdog alike.  Each seam keeps its own invocation counter;
    firing decisions depend only on ``(seed, seam, index)`` and the
    specs, so a plan replays identically run over run.
    """

    def __init__(self, seed: int = 0, specs: "tuple[FaultSpec, ...]" = ()) -> None:
        for s in specs:
            if s.seam not in SEAMS:
                raise ValueError(
                    f"unknown fault seam {s.seam!r}; choose from {SEAMS}"
                )
            if (s.at is None) == (s.prob is None):
                raise ValueError(
                    f"spec for {s.seam!r} needs exactly one of @index or "
                    "%probability"
                )
            if s.at is not None and s.at < 0:
                raise ValueError(
                    f"spec for {s.seam!r}: @index {s.at} must be >= 0"
                )
            if s.times < 1:
                raise ValueError(
                    f"spec for {s.seam!r}: *times {s.times} must be >= 1"
                )
            if s.prob is not None and not (0.0 < s.prob <= 1.0):
                # "%25" meaning 25% would otherwise fire on EVERY
                # invocation — a config typo, not a schedule
                raise ValueError(
                    f"spec for {s.seam!r}: probability {s.prob} outside "
                    "(0, 1] — write 25% as %0.25"
                )
            if s.error and s.error not in (
                *_RAISING_KINDS, "hang", "slow", "corrupt", "fire"
            ):
                raise ValueError(f"unknown error kind {s.error!r}")
        self.seed = int(seed)
        self.specs = tuple(specs)
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._injected: list[tuple[str, int, str]] = []
        self._observer: "Callable[[str, int, str], None] | None" = None

    # -- scheduling --------------------------------------------------------
    def _draw(self, seam: str, index: int, prob: float) -> bool:
        h = zlib.crc32(f"{self.seed}:{seam}:{index}".encode())
        return (h / 2**32) < prob

    def _next(self, seam: str) -> "tuple[int, FaultSpec | None]":
        """Advance ``seam``'s counter; return (index, firing spec or None)."""
        with self._lock:
            index = self._counts.get(seam, 0)
            self._counts[seam] = index + 1
        for s in self.specs:
            if s.seam != seam:
                continue
            if s.at is not None and s.at <= index < s.at + s.times:
                return index, s
            if s.prob is not None and self._draw(seam, index, s.prob):
                return index, s
        return index, None

    def _note(self, seam: str, index: int, kind: str) -> None:
        with self._lock:
            self._injected.append((seam, index, kind))
        obs = self._observer
        if obs is not None:
            try:
                obs(seam, index, kind)
            except Exception:
                pass  # observation must never change injection behavior

    # -- seam APIs ---------------------------------------------------------
    def check(self, seam: str) -> None:
        """Raising seam: raise the scheduled error on a firing invocation
        (``slow`` sleeps then proceeds; ``hang`` sleeps interruptibly)."""
        index, spec = self._next(seam)
        if spec is None:
            return
        kind = spec.error or _DEFAULT_KIND[seam]
        self._note(seam, index, kind)
        if kind == "slow":
            time.sleep(spec.arg if spec.arg is not None else 0.5)
            return
        if kind == "hang":
            _hang(spec.arg if spec.arg is not None else 30.0)
            return
        raise _make_error(kind, seam, index)

    def fired(self, seam: str) -> bool:
        """Behavioral seam: True when this invocation is scheduled (the
        host implements the fault itself — e.g. the manifest truncating
        its artifact, the merge treating a peer as not-terminal)."""
        index, spec = self._next(seam)
        if spec is None:
            return False
        self._note(seam, index, spec.error or _DEFAULT_KIND[seam])
        return True

    def corrupt(self, seam: str, arr):
        """Corruption seam: return a damaged stand-in for ``arr`` on a
        firing invocation (a truncated view — the wrong-shape damage the
        consumer-side validation must catch), else ``arr`` unchanged."""
        index, spec = self._next(seam)
        if spec is None:
            return arr
        self._note(seam, index, spec.error or "corrupt")
        return arr.reshape(-1)[: max(1, arr.size // 2)]

    def injected(self) -> "list[tuple[str, int, str]]":
        """(seam, index, kind) log of every fault this plan fired."""
        with self._lock:
            return list(self._injected)

    def counts(self) -> "dict[str, int]":
        with self._lock:
            return dict(self._counts)


def parse_schedule(text: str) -> FaultPlan:
    """``--fault-schedule`` string → :class:`FaultPlan`.

    Grammar: comma-separated items.  ``seed=N`` (anywhere, default 0)
    seeds the probability draws; every other item is
    ``SEAM@INDEX[*TIMES]`` or ``SEAM%PROB``, optionally suffixed
    ``=KIND`` or ``=KIND:ARG``.  Raises ``ValueError`` on any typo —
    a misspelled seam is a dead injection, which is a config error.
    """
    seed = 0
    specs: list[FaultSpec] = []
    for raw in text.split(","):
        item = raw.strip()
        if not item:
            continue
        if item.startswith("seed="):
            seed = int(item[5:])
            continue
        kind, arg = "", None
        if "=" in item:
            item, _, err = item.partition("=")
            if ":" in err:
                kind, _, a = err.partition(":")
                arg = float(a)
            else:
                kind = err
        if "@" in item:
            seam, _, where = item.partition("@")
            times = 1
            if "*" in where:
                where, _, n = where.partition("*")
                times = int(n)
            specs.append(
                FaultSpec(seam, at=int(where), times=times, error=kind, arg=arg)
            )
        elif "%" in item:
            seam, _, p = item.partition("%")
            specs.append(FaultSpec(seam, prob=float(p), error=kind, arg=arg))
        else:
            raise ValueError(
                f"fault spec {raw!r} has no @index or %probability"
            )
    return FaultPlan(seed=seed, specs=tuple(specs))


# -- process-wide activation (one plan at a time, like the blockcache) ----
_active: "FaultPlan | None" = None


def activate(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` as the process's active schedule and register
    the layer hooks (:func:`land_trendr_tpu_torch.io.blockcache.
    set_fault_plan` for the decode-path seams, :func:`land_trendr_tpu_torch.
    obs.publish.set_fault_plan` for the fleet-telemetry seams) so those
    layers see it without importing ``runtime/``."""
    global _active
    _active = plan
    from land_trendr_tpu_torch.io import blockcache
    from land_trendr_tpu_torch.obs import publish as obs_publish

    blockcache.set_fault_plan(plan)
    obs_publish.set_fault_plan(plan)
    return plan


def deactivate() -> None:
    global _active
    _active = None
    from land_trendr_tpu_torch.io import blockcache
    from land_trendr_tpu_torch.obs import publish as obs_publish

    blockcache.set_fault_plan(None)
    obs_publish.set_fault_plan(None)


def active() -> "FaultPlan | None":
    return _active


def set_observer(fn: "Callable[[str, int, str], None] | None") -> None:
    """Register a per-fire callback ``(seam, index, kind)`` on the active
    plan — how the driver turns injections into ``fault_injected``
    telemetry events without this module knowing telemetry exists."""
    plan = _active
    if plan is not None:
        plan._observer = fn


def check(seam: str) -> None:
    """Module-level raising seam (no-op when no plan is active)."""
    plan = _active
    if plan is not None:
        plan.check(seam)


def fired(seam: str) -> bool:
    plan = _active
    return plan.fired(seam) if plan is not None else False


def corrupt(seam: str, arr):
    plan = _active
    return plan.corrupt(seam, arr) if plan is not None else arr
