"""Pod-wide span model: per-tile spans, cross-host trace assembly,
critical-path attribution, and live straggler detection.

The event stream (:mod:`land_trendr_tpu_torch.obs.events`) answers "what
happened on this host"; nothing so far answered the questions the
*Massively-Parallel Break Detection* paper (PAPERS.md, arXiv:1807.01751)
says dominate continent-scale runs — *which host is behind, which stage
bounds the wall clock, and which tiles are the stragglers*.  This module
is the span half of the obs subsystem:

* **Span model** — every tile's pipeline passage decomposes into named
  stages (:data:`SPAN_STAGES`).  Three are *explicit* ``span`` events
  the driver emits (``feed``, ``upload``, ``fetch`` — host-blocking
  work no existing event pair covers); the rest are *derived* from the
  lifecycle events already in the stream (``compute`` from
  ``tile_done.compute_s``, ``write`` from ``write_done.record_s``,
  ``attempt`` from ``tile_start``/``tile_retry``/``tile_done`` pairs).
  Every span carries the correlation IDs of its scope: ``run_id`` /
  ``job_id`` (serve mode) / ``host`` / ``tile`` / ``attempt``.  The
  ``decode`` stage has no per-tile span of its own — block decode runs
  in a shared pool where per-tile attribution would be a lie; it rides
  inside ``feed`` and the ``feed_cache`` rollup carries its split.

* **Cross-host clock alignment** — each host's ``run_start`` records a
  ``(anchor_wall, anchor_mono)`` pair sampled together (see
  :meth:`~land_trendr_tpu_torch.obs.events.EventLog.run_start`).  The pod
  assembler (:func:`assemble_pod_trace`) maps every host's monotonic
  clock onto ONE pod timeline whose origin is each scope's
  ``run_start`` — the distributed-init barrier means hosts enter
  ``run_stack`` together, so aligning on ``run_start`` removes wall
  skew between hosts *by construction* (a host whose NTP is an hour off
  assembles exactly like a synchronized one).  The apparent wall skew
  the alignment removed is reported per host (``wall_skew_s``), never
  trusted.  Caveat: genuine start stagger beyond the barrier (sub-second
  in practice) is folded into the alignment.

* **Critical-path attribution** (:func:`critical_path`) — a
  pipeline-aware wall decomposition: per host, stage totals from the
  assembled spans bound the wall two ways (removing stage X saves at
  most its own seconds — the serial view — and the wall cannot drop
  below the next-binding stage's total — the pipeline view), so
  ``est_wall_without[X] = max(wall - stage_s[X], max(other stage_s))``
  and ``faster_pct`` answers "if stage X were free, the run would be Y%
  faster".  Pod-wide the run ends with its last host, so the pod
  estimate is the max of the per-host estimates.

* **Live straggler detection** (:class:`StragglerDetector`) — the
  driver registers every dispatched tile and checks completions (and,
  from the sampler thread, in-flight tiles) against ``k ×`` the rolling
  median of recent tile durations.  A flagged tile emits
  ``tile_straggler``, bumps ``lt_stragglers_total``, and shows in
  ``/debug/jobs`` / ``lt top``.  No verdicts until ``min_tiles`` tiles
  completed (the first tile carries the compile and must never
  false-positive); each tile flags at most once.

Everything here is stdlib-only and jax-free, like the rest of
:mod:`land_trendr_tpu_torch.obs`.  Consumers: ``tools/lt_trace.py`` (pod
Chrome trace + imbalance report), ``tools/obs_report.py`` (per-host
rollups), the runtime driver (detector + span emits).
"""

from __future__ import annotations

import json
import statistics
import threading
import time
from typing import Any, Callable

__all__ = [
    "SPAN_STAGES",
    "StragglerDetector",
    "assemble_pod_trace",
    "busy_union_s",
    "critical_path",
    "scope_anchor",
    "tail_ratio",
]

#: the span vocabulary — stage names of one tile's pipeline passage, in
#: pipeline order.  ``feed``/``upload``/``fetch`` are explicit ``span``
#: events; ``compute``/``write``/``attempt`` are derived from lifecycle
#: events; ``decode`` rides inside ``feed`` (see module doc).
SPAN_STAGES = (
    "feed", "decode", "upload", "compute", "fetch", "write", "attempt",
)

#: stages that enter critical-path stage totals.  ``attempt`` spans
#: OVERLAP the others (an attempt contains its compute), so counting
#: them would double-book the wall.
_PATH_STAGES = ("feed", "upload", "compute", "fetch", "write")


def scope_anchor(run_start: dict) -> "tuple[float, float]":
    """One scope's ``(wall, monotonic)`` clock anchor.

    Prefers the explicit ``anchor_wall``/``anchor_mono`` pair (sampled
    together by :meth:`EventLog.run_start`); streams from before the
    anchors existed fall back to the record's own ``t_wall``/``t_mono``
    (also sampled together, by ``emit``).
    """
    w = run_start.get("anchor_wall", run_start.get("t_wall", 0.0))
    m = run_start.get("anchor_mono", run_start.get("t_mono", 0.0))
    return float(w), float(m)


def busy_union_s(intervals: "list[tuple[float, float]]") -> float:
    """Total covered seconds of a set of (start, end) intervals.

    The host-busy measure behind the idle-gap report: spans from
    overlapped pipeline stages double-cover time, so the UNION (not the
    sum) is what "the host was doing something" means.
    """
    if not intervals:
        return 0.0
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if e < s:
            s, e = e, s
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            total += cur_e - cur_s
            cur_s, cur_e = s, e
    total += cur_e - cur_s
    return total


def _quantile(sorted_vals: "list[float]", p: float) -> float:
    """The same nearest-rank convention as ``obs_report._stats``."""
    return sorted_vals[min(len(sorted_vals) - 1, int(p * len(sorted_vals)))]


def tail_ratio(durations: "list[float]") -> "float | None":
    """p95 / p50 of a duration population — the per-host tail-imbalance
    number ("how much worse is a bad tile than a typical one").  None
    when fewer than 2 samples or the median is 0."""
    if len(durations) < 2:
        return None
    v = sorted(durations)
    p50 = _quantile(v, 0.50)
    if p50 <= 0:
        return None
    return round(_quantile(v, 0.95) / p50, 3)


def critical_path(stage_s: "dict[str, float]", wall_s: float) -> "dict | None":
    """Pipeline-aware "which stage bounds this wall" attribution.

    ``stage_s`` maps stage name → total seconds (span sums); ``wall_s``
    is the observed wall.  For each stage X the estimated wall with X
    free is ``max(wall_s - stage_s[X], max(stage_s[Y] for Y != X))`` —
    removing X can save at most its own seconds, and a pipelined run
    cannot finish faster than its next-binding stage's total.
    ``bound_stage`` is the stage whose removal saves the most (ties
    break lexicographically, deterministically).
    """
    stages = {
        k: float(v) for k, v in stage_s.items()
        if k not in ("attempt", "decode") and v is not None
    }
    if not stages or not wall_s or wall_s <= 0:
        return None
    out: dict = {"wall_s": round(wall_s, 4), "if_free": {}}
    best: "tuple[float, str] | None" = None
    for x in sorted(stages):
        rest = max((v for k, v in stages.items() if k != x), default=0.0)
        est = max(wall_s - stages[x], rest, 0.0)
        est = min(est, wall_s)
        saved = wall_s - est
        out["if_free"][x] = {
            "stage_s": round(stages[x], 4),
            "est_wall_s": round(est, 4),
            "saved_s": round(saved, 4),
            "faster_pct": round(100.0 * saved / wall_s, 2),
        }
        if best is None or saved > best[0]:
            best = (saved, x)
    out["bound_stage"] = best[1]
    return out


# ---------------------------------------------------------------------------
# pod-trace assembly
# ---------------------------------------------------------------------------


def _num(v: Any) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _last_scope(path: str) -> "tuple[list[dict], int]":
    """The LAST run scope of one per-process event file (records after
    its final ``run_start``, inclusive) plus a malformed-line count.

    The pod trace describes the run the workdir currently holds — a
    resumed file's aborted earlier scope belongs to a different wall
    clock and must not fold in (the same "most recent run" semantics as
    ``summarize_events_file``).
    """
    scope: "list[dict]" = []
    opened = False
    malformed = 0
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                malformed += 1
                continue
            if not isinstance(rec, dict) or not isinstance(rec.get("ev"), str):
                malformed += 1
                continue
            if rec["ev"] == "run_start":
                scope = [rec]
                opened = True
            elif opened:
                scope.append(rec)
            else:
                # events before any run_start: a torn/foreign stream head
                malformed += 1
    return scope, malformed


def _fold_host_scope(
    scope: "list[dict]", fileno: int, path: str
) -> "tuple[dict, list[dict], list[dict]]":
    """One host's last scope → (host summary, spans, markers).

    Span/marker times are POD-RELATIVE seconds: 0 at this host's
    ``run_start`` (its scope anchor).  The caller owns cross-host
    concerns (skew report, ordering, pod rollups).
    """
    host: dict = {
        "events_file": path,
        "file": fileno,
        "host": None,
        "process_index": fileno,
        "pid": None,
        "run_id": None,
        "status": None,
        "wall_s": None,
        "px_per_s": None,
        "pixels": 0,
        "tiles_done": 0,
        "stragglers": 0,
        "retries": 0,
        # elastic pod scheduling (runtime/leases): acquisitions this
        # host won, split by kind — the steal/speculation imbalance view
        "tiles_leased": 0,
        "tiles_stolen": 0,
        "tiles_speculated": 0,
    }
    spans: "list[dict]" = []
    markers: "list[dict]" = []
    if not scope:
        return host, spans, markers
    rs = scope[0]
    aw, am = scope_anchor(rs)
    host.update(
        host=rs.get("host"),
        process_index=(
            rs["process_index"]
            if isinstance(rs.get("process_index"), int)
            else fileno
        ),
        pid=rs.get("pid"),
        run_id=rs.get("run_id"),
        anchor_wall=aw,
        anchor_mono=am,
    )
    compute_durs: "list[float]" = []
    #: tile -> (pod start, attempt) for the open attempt span
    open_attempt: "dict[int, tuple[float, int]]" = {}
    t_max = 0.0

    def _pod(rec: dict) -> "float | None":
        m = rec.get("t_mono")
        return (m - am) if _num(m) else None

    def _add(
        name: str, tile: Any, t0: float, dur: float, rec: dict,
        attempt: "int | None" = None,
    ) -> None:
        nonlocal t_max
        dur = max(float(dur), 0.0)
        t0 = float(t0)
        span = {
            "name": name,
            "tile": tile,
            "t0": round(t0, 6),
            "dur": round(dur, 6),
            "file": fileno,
            "process_index": host["process_index"],
            "host": host["host"],
            "run_id": host["run_id"],
        }
        if attempt is not None:
            span["attempt"] = attempt
        if rec.get("job_id") is not None:
            span["job_id"] = rec["job_id"]
        spans.append(span)
        t_max = max(t_max, t0 + dur)

    for rec in scope[1:]:
        ev = rec.get("ev")
        t = _pod(rec)
        if t is None:
            continue
        t_max = max(t_max, t)
        try:
            if ev == "span":
                name, tile = rec["name"], rec["tile_id"]
                s0, s1 = rec["start"], rec["end"]
                if not (_num(s0) and _num(s1)):
                    continue
                _add(
                    str(name), tile, s0 - am, s1 - s0, rec,
                    attempt=rec.get("attempt"),
                )
            elif ev == "tile_start":
                tile = rec["tile_id"]
                open_attempt[tile] = (t, int(rec.get("attempt", 1)))
            elif ev == "tile_retry":
                tile = rec["tile_id"]
                host["retries"] += 1
                if tile in open_attempt:
                    t0, att = open_attempt.pop(tile)
                    _add("attempt", tile, t0, t - t0, rec, attempt=att)
            elif ev == "tile_done":
                tile, c_s = rec["tile_id"], rec["compute_s"]
                if not _num(c_s):
                    continue
                host["tiles_done"] += 1
                host["pixels"] += int(rec.get("px", 0) or 0)
                compute_durs.append(float(c_s))
                _add("compute", tile, t - c_s, c_s, rec)
                if tile in open_attempt:
                    t0, att = open_attempt.pop(tile)
                    _add("attempt", tile, t0, t - t0, rec, attempt=att)
            elif ev == "write_done":
                tile, r_s = rec["tile_id"], rec["record_s"]
                if not _num(r_s):
                    continue
                _add("write", tile, t - r_s, r_s, rec)
            elif ev == "tile_straggler":
                host["stragglers"] += 1
                markers.append({
                    "name": "straggler",
                    "tile": rec["tile_id"],
                    "t0": round(t, 6),
                    "file": fileno,
                    "host": host["host"],
                    "duration_s": rec.get("duration_s"),
                    "threshold_s": rec.get("threshold_s"),
                })
            elif ev == "tile_leased":
                host["tiles_leased"] += 1
            elif ev in ("lease_stolen", "tile_speculated"):
                # steals and speculative re-leases are the elastic
                # scheduler ACTING — instants on the trace, like the
                # straggler verdicts that steered them
                host["tiles_leased"] += 1
                key = (
                    "tiles_stolen" if ev == "lease_stolen"
                    else "tiles_speculated"
                )
                host[key] += 1
                markers.append({
                    "name": "steal" if ev == "lease_stolen" else "speculate",
                    "tile": rec["tile_id"],
                    "t0": round(t, 6),
                    "file": fileno,
                    "host": host["host"],
                    "gen": rec.get("gen"),
                })
            elif ev == "run_done":
                host["status"] = rec.get("status")
                if _num(rec.get("wall_s")):
                    host["wall_s"] = float(rec["wall_s"])
                if _num(rec.get("px_per_s")):
                    host["px_per_s"] = rec["px_per_s"]
        except (KeyError, TypeError):
            continue

    # host facts derived from the folded spans
    if host["wall_s"] is None and t_max > 0:
        host["wall_s"] = round(t_max, 4)
    intervals = [(s["t0"], s["t0"] + s["dur"]) for s in spans]
    busy = busy_union_s(intervals)
    host["busy_s"] = round(busy, 4)
    if host["wall_s"] is not None:
        host["idle_gap_s"] = round(max(host["wall_s"] - busy, 0.0), 4)
    host["tail_ratio"] = tail_ratio(compute_durs)
    stage_sums: "dict[str, float]" = {}
    for s in spans:
        stage_sums[s["name"]] = stage_sums.get(s["name"], 0.0) + s["dur"]
    host["stage_s"] = {k: round(v, 4) for k, v in sorted(stage_sums.items())}
    host["critical_path"] = critical_path(stage_sums, host["wall_s"] or 0.0)
    return host, spans, markers


def assemble_pod_trace(paths: "list[str]") -> dict:
    """Fold N per-host event files into one offset-corrected pod trace.

    Each file contributes its LAST run scope, aligned on the pod
    timeline (``t=0`` at every host's ``run_start`` — the clock-skew
    removal documented in the module header).  Returns::

        {
          "files": N, "malformed": n,
          "hosts":  [per-host summary: wall/busy/idle/tail/stragglers,
                     stage seconds, per-host critical path, wall_skew_s],
          "spans":  [{name, tile, t0, dur, file, process_index, host,
                      run_id, attempt?, job_id?}, ...]  # sorted, stable
          "markers": [straggler instants],
          "pod":    {wall_s, stage_s, critical_path, host_imbalance,
                     tail_ratio, stragglers, pixels, px_per_s},
        }

    Deterministic and byte-stable: the same input files produce the
    identical structure (and identical ``json.dumps``) on every fold —
    spans sort by ``(t0, file, name, tile, attempt)`` with rounding
    applied before the sort.
    """
    hosts: "list[dict]" = []
    all_spans: "list[dict]" = []
    all_markers: "list[dict]" = []
    malformed = 0
    for fileno, path in enumerate(paths):
        scope, bad = _last_scope(path)
        malformed += bad
        host, spans, markers = _fold_host_scope(scope, fileno, path)
        hosts.append(host)
        all_spans.extend(spans)
        all_markers.extend(markers)

    # apparent wall skew the run_start alignment removed, per host
    anchors = [h.get("anchor_wall") for h in hosts if h.get("anchor_wall")]
    origin = min(anchors) if anchors else 0.0
    for h in hosts:
        if h.get("anchor_wall") is not None:
            h["wall_skew_s"] = round(h["anchor_wall"] - origin, 6)

    all_spans.sort(
        key=lambda s: (
            s["t0"], s["file"], s["name"],
            s["tile"] if isinstance(s["tile"], int) else -1,
            s.get("attempt") or 0,
        )
    )
    all_markers.sort(key=lambda m: (m["t0"], m["file"]))

    pod_stage: "dict[str, float]" = {}
    for h in hosts:
        for k, v in (h.get("stage_s") or {}).items():
            pod_stage[k] = pod_stage.get(k, 0.0) + v
    walls = [h["wall_s"] for h in hosts if h.get("wall_s")]
    pod_wall = max(walls) if walls else 0.0
    pod: dict = {
        "wall_s": round(pod_wall, 4),
        "stage_s": {k: round(v, 4) for k, v in sorted(pod_stage.items())},
        "stragglers": sum(h["stragglers"] for h in hosts),
        "tiles_leased": sum(h["tiles_leased"] for h in hosts),
        "tiles_stolen": sum(h["tiles_stolen"] for h in hosts),
        "tiles_speculated": sum(h["tiles_speculated"] for h in hosts),
        "pixels": sum(h["pixels"] for h in hosts),
        "px_per_s": (
            round(sum(h["pixels"] for h in hosts) / pod_wall, 1)
            if pod_wall else None
        ),
        "host_imbalance": (
            round(max(walls) / (sum(walls) / len(walls)), 3)
            if walls and sum(walls) else None
        ),
        "tail_ratio": tail_ratio(
            [s["dur"] for s in all_spans if s["name"] == "compute"]
        ),
    }
    # pod critical path: the run ends with its last host, so the pod
    # estimate for "stage X free" is the max of the per-host estimates
    if pod_wall:
        if_free: dict = {}
        stages = sorted(
            {
                k
                for h in hosts
                for k in (h.get("stage_s") or {})
                if k not in ("attempt", "decode")
            }
        )
        for x in stages:
            ests = []
            for h in hosts:
                cp = h.get("critical_path")
                if cp is None:
                    continue
                fx = cp["if_free"].get(x)
                ests.append(
                    fx["est_wall_s"] if fx is not None else cp["wall_s"]
                )
            if not ests:
                continue
            est = max(ests)
            est = min(est, pod_wall)
            if_free[x] = {
                "stage_s": round(pod_stage.get(x, 0.0), 4),
                "est_wall_s": round(est, 4),
                "saved_s": round(pod_wall - est, 4),
                "faster_pct": round(100.0 * (pod_wall - est) / pod_wall, 2),
            }
        if if_free:
            bound = max(
                sorted(if_free), key=lambda k: if_free[k]["saved_s"]
            )
            pod["critical_path"] = {
                "wall_s": round(pod_wall, 4),
                "bound_stage": bound,
                "if_free": if_free,
            }
    return {
        "files": len(paths),
        "malformed": malformed,
        "hosts": hosts,
        "spans": all_spans,
        "markers": all_markers,
        "pod": pod,
    }


# ---------------------------------------------------------------------------
# live straggler detection
# ---------------------------------------------------------------------------


class StragglerDetector:
    """Rolling-median straggler verdicts over in-flight tile durations.

    The driver calls :meth:`start` when a tile's attempt dispatches and
    :meth:`finish` when the tile completes (fetch landed); the finish
    checks the completed duration against ``k × median`` of the last
    ``window`` completions *before* folding it into the window, so a
    straggler never dilutes the very median that judges it.
    :meth:`scan` applies the same verdict to still-in-flight tiles — the
    liveness half, callable from the flight sampler thread while the
    driver is blocked inside the straggler's own device wait.

    Rules, pinned by ``tests/test_spans.py``:

    * no verdicts until ``min_tiles`` tiles have completed (the first
      tile carries the jit compile; it must never false-positive);
    * each tile flags at most once (finish after a scan-flag is silent);
    * a retried attempt restarts the tile's in-flight clock;
    * ``drop`` forgets a quarantined/failed tile without a verdict.

    ``on_straggler(tile_id, duration_s, threshold_s, median_s,
    in_flight, attempt)`` fires OUTSIDE the lock; exceptions propagate
    to the caller (the driver treats telemetry-emit failures the same
    everywhere).  Thread-safe; the lock guards pure bookkeeping only.
    """

    def __init__(
        self,
        k: float = 4.0,
        min_tiles: int = 5,
        window: int = 64,
        on_straggler: "Callable[..., None] | None" = None,
        clock: "Callable[[], float]" = time.monotonic,
    ) -> None:
        if k < 1.0:
            raise ValueError(
                f"k={k} must be >= 1.0 (a threshold below the median "
                "would flag typical tiles)"
            )
        if min_tiles < 1:
            raise ValueError(f"min_tiles={min_tiles} must be >= 1")
        if window < 1:
            raise ValueError(f"window={window} must be >= 1")
        self.k = float(k)
        self.min_tiles = int(min_tiles)
        self.window = int(window)
        self.on_straggler = on_straggler
        self._clock = clock
        self._lock = threading.Lock()
        self._inflight: "dict[int, tuple[float, int]]" = {}
        self._done: "list[float]" = []  # bounded at window, FIFO
        self._completed = 0
        self._flagged: "set[int]" = set()

    # -- internal (callers hold the lock) ----------------------------------
    def _threshold_locked(self) -> "tuple[float | None, float | None]":
        if self._completed < self.min_tiles or not self._done:
            return None, None
        med = float(statistics.median(self._done))
        if med <= 0:
            return med, None
        return med, self.k * med

    def _flag_locked(
        self, tile_id: int, dur: float, in_flight: bool
    ) -> "tuple | None":
        med, thr = self._threshold_locked()
        if thr is None or dur <= thr or tile_id in self._flagged:
            return None
        self._flagged.add(tile_id)
        att = self._inflight.get(tile_id, (0.0, 1))[1]
        return (tile_id, dur, thr, med, in_flight, att)

    def _fire(self, verdict: "tuple | None") -> None:
        if verdict is None or self.on_straggler is None:
            return
        try:
            self.on_straggler(*verdict)
        except BaseException:
            # the verdict never landed (telemetry emit failed): un-flag so
            # a still-in-flight tile gets retried by a later scan instead
            # of being silently verdict-less forever — the sampler thread
            # swallows probe exceptions, so this is the only retry path
            with self._lock:
                self._flagged.discard(verdict[0])
            raise

    # -- driver hooks ------------------------------------------------------
    def start(self, tile_id: int, attempt: int = 1) -> None:
        """Register a dispatched attempt (re-registering restarts the
        tile's in-flight clock — a retry is a fresh attempt)."""
        with self._lock:
            self._inflight[tile_id] = (self._clock(), int(attempt))

    def drop(self, tile_id: int) -> None:
        """Forget a tile without a verdict (quarantine/failure path —
        the failure events already tell that story)."""
        with self._lock:
            self._inflight.pop(tile_id, None)

    def finish(self, tile_id: int) -> "float | None":
        """Complete a tile: returns its in-flight duration (None for an
        unregistered tile) after checking it against the threshold and
        folding it into the rolling window."""
        now = self._clock()
        with self._lock:
            ent = self._inflight.get(tile_id)
            if ent is None:
                return None
            dur = now - ent[0]
            verdict = self._flag_locked(tile_id, dur, in_flight=False)
            self._inflight.pop(tile_id, None)
            self._done.append(dur)
            if len(self._done) > self.window:
                del self._done[0]
            self._completed += 1
        self._fire(verdict)
        return dur

    def scan(self, now: "float | None" = None) -> "list[int]":
        """Flag in-flight tiles already over the threshold; returns the
        tile ids flagged by THIS scan.  Safe from any thread."""
        now = self._clock() if now is None else now
        verdicts = []
        with self._lock:
            _, thr = self._threshold_locked()
            if thr is not None:
                for tid, (t0, _att) in list(self._inflight.items()):
                    v = self._flag_locked(tid, now - t0, in_flight=True)
                    if v is not None:
                        verdicts.append(v)
        for v in verdicts:
            self._fire(v)
        return [v[0] for v in verdicts]

    def stats(self) -> dict:
        """Point-in-time counters for progress dicts / sampler probes."""
        with self._lock:
            med, thr = self._threshold_locked()
            return {
                "stragglers": len(self._flagged),
                "completed": self._completed,
                "in_flight": len(self._inflight),
                "median_s": med,
                "threshold_s": thr,
            }
