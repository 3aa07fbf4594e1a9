"""Cross-layer request assembly: one ``trace_id`` → one blamed timeline.

The fourth observability layer (after events, pod traces, fleet
metrics): events answer "how is this host doing", pod traces "which
stage bounds this run", fleet metrics "how is the pod doing" — this
module answers **"what happened to THIS request"**.  A request entering
``lt route`` crosses tenant DRR queue → route decision → forward
(possibly a re-route hop after a replica death) → replica admission
queue → job exec → run → tile spans; the ``trace_id`` minted at router
(or serve) admission rides every one of those events
(:data:`~land_trendr_tpu_torch.obs.events.COMMON_OPTIONAL_FIELDS`), and this
module folds the router + replica + run streams back into one
wall-aligned timeline with a **blame decomposition** whose components
provably sum to the router-observed latency.

* **Clock alignment** — each stream scope's ``(anchor_wall,
  anchor_mono)`` pair (sampled together at ``run_start`` — the pod-trace
  assembler's contract) maps every event's monotonic clock onto the
  shared wall axis drift-free.  Unlike :func:`~land_trendr_tpu_torch.obs.
  spans.assemble_pod_trace` (which zeroes every host at its barrier'd
  ``run_start``), request assembly keeps absolute wall times: router
  and replicas start at different moments and the journey spans them.
  A fleet is same-machine by construction (loopback replicas), so wall
  clocks agree; multi-machine joins inherit NTP skew — reported, not
  corrected.

* **Blame decomposition** (:func:`blame_partition`) — the
  router-observed interval ``[submit, terminal]`` is PARTITIONED by a
  priority sweep over every interval the trace's streams contribute:
  router ``request_span`` segments (``forward`` hops, queue waits,
  throttle backoffs, the result relay), the replica's admission wait
  (``job_start.wait_s``), the run's compile verdict and pipeline spans
  (``feed``/``upload``/``fetch`` explicit, ``compute``/``write``
  derived).  Each instant is assigned to exactly ONE component (highest
  priority covering interval; uncovered instants are ``other`` — poll
  lag, inter-tile gaps), so the components sum to the interval length
  *by construction* — the property ``tools/perf_gate.py``'s reqtrace
  leg and the ``request_done`` value lint pin.

Stdlib-only like the rest of :mod:`land_trendr_tpu_torch.obs`.
Consumers: ``tools/lt_request.py`` (CLI + Chrome export),
``tools/fault_soak.py`` (two-hop re-route assertions),
``tools/perf_gate.py`` (reqtrace leg), ``tools/reqtrace_bench.py``.
"""

from __future__ import annotations

import glob
import json
import os

__all__ = [
    "BLAME_PRIORITY",
    "assemble_request",
    "blame_partition",
    "discover_request_files",
    "list_requests",
]

#: blame components in sweep priority order (earlier wins on overlap):
#: router-observed segments first (they are exact partitions of the
#: router's own clock), then the replica admission wait, then the run's
#: pipeline stages with ``compute`` outranking the overlappable
#: host-side stages (a pipelined instant doing compute AND feed is
#: compute-bound), ``write`` last.  Uncovered time is ``other``.
BLAME_PRIORITY = (
    "forward",
    "relay",
    "throttle_backoff",
    "route_queue",
    "replica_queue",
    "compile",
    "compute",
    "fetch",
    "upload",
    "feed",
    "write",
)


def discover_request_files(root: str) -> "list[str]":
    """Every event stream a router (or serve) workdir tree holds.

    The fleet layout is fixed: the root's own ``events*.jsonl`` (router
    or server scope), ``replicas/<rid>/events*.jsonl`` (spawned replica
    server scopes), and ``jobs/<id>/work/events*.jsonl`` (the pinned
    per-job run scopes every replica resumes).  Sorted for a
    deterministic fold; missing levels are simply absent (a standalone
    serve root has no ``replicas/``).
    """
    out: "list[str]" = []
    for pattern in (
        "events*.jsonl",
        os.path.join("replicas", "*", "events*.jsonl"),
        os.path.join("jobs", "*", "work", "events*.jsonl"),
    ):
        out.extend(glob.glob(os.path.join(root, pattern)))
    return sorted(out)


def _num(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def _iter_anchored(path: str):
    """Yield ``(record, wall_t)`` for every parseable event of EVERY
    scope of one stream, with ``wall_t`` the record's monotonic clock
    mapped through its scope's anchor (drift-free wall placement).

    All scopes, not just the last: a re-routed request's run stream
    holds the killed first attempt's scope AND the resumed second one,
    and the journey needs both.  Malformed lines are skipped (the
    post-mortem fold discipline).
    """
    aw = am = None
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if not isinstance(rec, dict):
                continue
            if rec.get("ev") == "run_start":
                w = rec.get("anchor_wall", rec.get("t_wall"))
                m = rec.get("anchor_mono", rec.get("t_mono"))
                if _num(w) and _num(m):
                    aw, am = float(w), float(m)
            t = rec.get("t_mono")
            if aw is not None and _num(t):
                wall = aw + (float(t) - am)
            else:
                wall = rec.get("t_wall") if _num(rec.get("t_wall")) else None
            yield rec, wall, (aw, am)


def _mono_to_wall(anchor, mono) -> "float | None":
    aw, am = anchor
    if aw is None or not _num(mono):
        return None
    return aw + (float(mono) - am)


def blame_partition(
    intervals: "list[tuple[str, float, float]]",
    t0: float,
    t1: float,
    priority: "tuple[str, ...]" = BLAME_PRIORITY,
) -> "dict[str, float]":
    """Partition ``[t0, t1]`` over prioritised components (seconds each).

    ``intervals`` is ``[(component, start, end), ...]`` on one shared
    axis; every instant of ``[t0, t1]`` is assigned to the
    highest-priority component covering it (``other`` when none does),
    so ``sum(result.values()) == t1 - t0`` exactly — the decomposition
    is a partition, not a sum of overlapping stage totals.  Components
    that claimed no time are omitted.
    """
    rank = {name: i for i, name in enumerate(priority)}
    out: "dict[str, float]" = {}
    if t1 <= t0:
        return out
    # clip to the window, drop the unrankable/empty, build sweep points
    events: "list[tuple[float, int, int]]" = []  # (t, +1/-1, rank)
    for name, s, e in intervals:
        r = rank.get(name)
        if r is None:
            continue
        s, e = max(float(s), t0), min(float(e), t1)
        if e <= s:
            continue
        events.append((s, 1, r))
        events.append((e, -1, r))
    events.sort(key=lambda x: (x[0], -x[1]))
    active = [0] * len(priority)
    cur = t0
    i = 0
    n = len(events)
    while i <= n:
        nxt = events[i][0] if i < n else t1
        nxt = min(max(nxt, t0), t1)
        if nxt > cur:
            comp = "other"
            for r, cnt in enumerate(active):
                if cnt > 0:
                    comp = priority[r]
                    break
            out[comp] = out.get(comp, 0.0) + (nxt - cur)
            cur = nxt
        if i == n:
            break
        t, delta, r = events[i]
        active[r] += delta
        i += 1
    if cur < t1:
        out["other"] = out.get("other", 0.0) + (t1 - cur)
    return out


def list_requests(paths: "list[str]") -> "list[dict]":
    """Every ``request_done`` across the streams, slowest first —
    the "which trace do I assemble" index (``lt_request --list``)."""
    out: "list[dict]" = []
    for path in paths:
        for rec, wall, _anchor in _iter_anchored(path):
            if rec.get("ev") != "request_done":
                continue
            out.append({
                "trace_id": rec.get("trace_id"),
                "status": rec.get("status"),
                "latency_s": rec.get("latency_s"),
                "hops": rec.get("hops"),
                "tenant": rec.get("tenant"),
                "job_id": rec.get("job_id"),
                "events_file": path,
            })
    out.sort(
        key=lambda r: -(r["latency_s"] if _num(r["latency_s"]) else -1.0)
    )
    return out


def assemble_request(paths: "list[str]", trace_id: str) -> dict:
    """Fold N event streams into one request's cross-layer record.

    Returns::

        {
          "trace_id": ..., "files": N, "events_scanned": n,
          "found": bool,                # any event carried the id
          "status": ..., "latency_s": ...,   # from request_done (router)
          "submitted_t": wall, "hops": [{replica, attempt, ok, t0, dur}],
          "timeline": [{component, t0, dur, file, detail?}, ...],
          "blame": {component: seconds},     # partition of latency_s
          "blame_sum_s": ...,                # == latency_s by construction
          "router_blame": {...},             # request_done's own split
          "replica_jobs": [...], "tiles_done": n,
          "complete": bool,             # request_done + >=1 hop + run events
        }

    Without a ``request_done`` (a direct serve job, or a still-running
    request) the record still assembles — ``latency_s`` then derives
    from the observed event envelope and ``complete`` is False.
    """
    events_scanned = 0
    submit_wall = None        # router job_submitted (or earliest seen)
    done_rec = None
    hops: "list[dict]" = []
    #: (component, start_wall, end_wall) for the sweep
    intervals: "list[tuple[str, float, float]]" = []
    timeline: "list[dict]" = []
    replica_jobs: "list[dict]" = []
    tiles_done = 0
    run_events = 0
    t_min = t_max = None

    def _note(component: str, s: float, e: float, fileno: int, **detail):
        nonlocal t_min, t_max
        if e < s:
            s, e = e, s
        intervals.append((component, s, e))
        entry = {
            "component": component,
            "t0": round(s, 6),
            "dur": round(e - s, 6),
            "file": fileno,
        }
        entry.update({k: v for k, v in detail.items() if v is not None})
        timeline.append(entry)
        t_min = s if t_min is None else min(t_min, s)
        t_max = e if t_max is None else max(t_max, e)

    for fileno, path in enumerate(paths):
        for rec, wall, anchor in _iter_anchored(path):
            events_scanned += 1
            ev = rec.get("ev")
            if rec.get("trace_id") != trace_id:
                continue
            if wall is None:
                continue
            if ev == "job_submitted":
                # router admission opens the window; a replica's own
                # job_submitted (re-admission per hop) only bounds it
                if submit_wall is None or wall < submit_wall:
                    submit_wall = wall
            elif ev == "request_span":
                name = rec.get("name")
                s = _mono_to_wall(anchor, rec.get("start"))
                e = _mono_to_wall(anchor, rec.get("end"))
                if not isinstance(name, str) or s is None or e is None:
                    continue
                _note(
                    name, s, e, fileno,
                    replica=rec.get("replica"),
                    attempt=rec.get("attempt"),
                    ok=rec.get("ok"),
                )
                if name == "forward":
                    hops.append({
                        "replica": rec.get("replica"),
                        "attempt": rec.get("attempt"),
                        "ok": rec.get("ok"),
                        "t0": round(s, 6),
                        "dur": round(max(e - s, 0.0), 6),
                    })
            elif ev == "request_done":
                done_rec = {**rec, "_wall": wall}
            elif ev == "job_start":
                w_s = rec.get("wait_s")
                if _num(w_s):
                    _note(
                        "replica_queue", wall - float(w_s), wall, fileno,
                        job_id=rec.get("job_id"),
                    )
                replica_jobs.append({
                    "job_id": rec.get("job_id"),
                    "tenant": rec.get("tenant"),
                    "events_file": path,
                })
            elif ev == "program_cache":
                c_s = rec.get("compile_s")
                aw = anchor[0]
                if _num(c_s) and c_s > 0 and aw is not None:
                    # the dummy-tile compile runs at scope start, before
                    # the first tile — anchor the interval there
                    _note("compile", aw, aw + float(c_s), fileno)
            elif ev == "span":
                name = rec.get("name")
                s = _mono_to_wall(anchor, rec.get("start"))
                e = _mono_to_wall(anchor, rec.get("end"))
                if name in ("feed", "upload", "fetch") and s is not None \
                        and e is not None:
                    _note(str(name), s, e, fileno, tile=rec.get("tile_id"))
                    run_events += 1
            elif ev == "tile_done":
                c_s = rec.get("compute_s")
                if _num(c_s):
                    _note(
                        "compute", wall - float(c_s), wall, fileno,
                        tile=rec.get("tile_id"),
                    )
                tiles_done += 1
                run_events += 1
            elif ev == "write_done":
                r_s = rec.get("record_s")
                if _num(r_s):
                    _note(
                        "write", wall - float(r_s), wall, fileno,
                        tile=rec.get("tile_id"),
                    )
                run_events += 1
            elif ev in ("run_start", "run_done", "tile_start"):
                run_events += 1

    hops.sort(key=lambda h: h["t0"])
    timeline.sort(key=lambda s: (s["t0"], s["component"]))
    found = bool(
        submit_wall is not None or done_rec is not None or timeline
    )
    out: dict = {
        "trace_id": trace_id,
        "files": len(paths),
        "events_scanned": events_scanned,
        "found": found,
        "hops": hops,
        "replica_jobs": replica_jobs,
        "tiles_done": tiles_done,
        "timeline": timeline,
    }
    if not found:
        out.update(complete=False, blame={}, blame_sum_s=0.0)
        return out

    # the router-observed window: admission → terminal.  request_done
    # is authoritative for the LENGTH (its latency_s is the router's
    # own submit→terminal measurement); the start anchors at the
    # router's job_submitted.  Fallbacks keep a partial trace useful.
    if submit_wall is None:
        submit_wall = t_min if t_min is not None else (
            done_rec["_wall"] if done_rec else 0.0
        )
    if done_rec is not None and _num(done_rec.get("latency_s")):
        latency = float(done_rec["latency_s"])
        out["status"] = done_rec.get("status")
        out["router_blame"] = done_rec.get("blame")
        if "hops" in done_rec:
            out["router_hops"] = done_rec["hops"]
    else:
        end = t_max if t_max is not None else submit_wall
        latency = max(0.0, end - submit_wall)
        out["status"] = None
        out["router_blame"] = None
    blame = blame_partition(
        intervals, submit_wall, submit_wall + latency
    )
    blame = {k: round(v, 6) for k, v in sorted(blame.items())}
    out.update(
        submitted_t=round(submit_wall, 6),
        latency_s=round(latency, 6),
        blame=blame,
        blame_sum_s=round(sum(blame.values()), 6),
        complete=bool(done_rec is not None and hops and run_events),
    )
    return out
