"""Fleet telemetry aggregate: N per-process snapshots → one pod view.

The **aggregate** quarter of the fleet telemetry plane: fold the
snapshot files :mod:`land_trendr_tpu_torch.obs.publish` writes under a shared
telemetry directory into one pod-level view — exposed as merged
instrument dicts, aggregated Prometheus exposition text, and the
flattened scalar samples the history ring retains.

Merge semantics are a **per-instrument policy table**, not a guess:

* **counters** always sum — the pod total is the per-host sum by
  definition (the acceptance invariant ``tools/perf_gate.py`` pins
  exactly);
* **histograms** merge bucket-wise — same bounds sum elementwise
  (``sum``/``count`` too); a bounds mismatch across hosts is flagged in
  ``conflicts`` and the divergent host's histogram is skipped rather
  than silently mis-binned;
* **gauges** follow :data:`GAUGE_SUM` / :data:`GAUGE_LAST` with ``max``
  as the default: backlogs and occupancy sum to meaningful pod totals,
  per-host "last observed" gauges take the freshest host's value, and
  everything else (burn rates, watermarks, demotion flags) takes the
  pod-worst ``max`` — the alerting-relevant fold.

Staleness is **flagged, never silently dropped**: every discovered
snapshot appears in the ``hosts`` list with its age — judged on the
FRESHER of the snapshot's own ``t_wall`` and the file's shared-FS mtime
(the multihost merge's mtime pattern: a publisher whose wall clock lags
the aggregator still refreshes its file on the filesystem's one clock,
and must not read permanently stale).  Hosts beyond their staleness
bound fold with ``stale: true``, torn/unparseable files fold as
``corrupt`` (excluded from the metric merge — a half-written JSON has
no trustworthy counters), and snapshots older than ``newer_than`` (a
reused telemetry dir's dead leftovers, e.g. a restarted replica's
predecessor) are listed ``excluded`` without contributing values or
feeding the staleness count.  Pid
reuse is superseded by ``generation``: of two snapshots claiming the
same ``(host, pid)``, only the highest ``(generation, seq)`` folds, so
a restarted process is never summed with its dead predecessor.

Everything is deterministic and byte-stable: instruments sort on
``(name, labels)``, hosts on ``(host, pid)``, and two folds of the same
files render identical exposition bytes — the property the history ring
and the alert engine's replayability stand on.  Stdlib-only, jax-free.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Iterable

from land_trendr_tpu_torch.obs.metrics import _fmt, _fmt_labels
from land_trendr_tpu_torch.obs.publish import SNAP_SCHEMA

__all__ = [
    "GAUGE_SUM",
    "GAUGE_LAST",
    "discover_snapshots",
    "flatten_scalars",
    "fold",
    "fold_dir",
    "gauge_policy",
    "histogram_quantile",
    "load_snapshots",
    "merge_instruments",
    "pod_sample",
    "render_prom",
]

#: gauges whose pod fold is the per-host SUM (backlogs, occupancy,
#: throughput — quantities that physically add across processes)
GAUGE_SUM = frozenset({
    "lt_feed_backlog",
    "lt_write_backlog",
    "lt_fetch_backlog",
    "lt_upload_backlog",
    "lt_feed_cache_bytes",
    "lt_ingest_store_bytes",
    "lt_device_bytes_in_use",
    "lt_device_bytes_peak",
    "lt_px_per_s",
    "lt_serve_queue_depth",
    "lt_serve_running",
    "lt_alerts_firing",
})

#: gauges where the FRESHEST host's value is the pod answer (per-host
#: "last observed" facts that neither sum nor max meaningfully)
GAUGE_LAST = frozenset({
    "lt_no_fit_rate",
    "lt_run_info",
})


def gauge_policy(name: str) -> str:
    """``sum`` / ``last`` / ``max`` for one gauge family — ``max`` (the
    pod-worst fold: burn rates, watermarks, demotion flags) unless the
    tables above say otherwise."""
    if name in GAUGE_SUM:
        return "sum"
    if name in GAUGE_LAST:
        return "last"
    return "max"


def discover_snapshots(directory: str) -> list:
    """Sorted ``*.snap.json`` paths under a telemetry directory (tmp
    files never match — publishers write ``*.tmp`` then rename)."""
    return sorted(glob.glob(os.path.join(directory, "*.snap.json")))


def load_snapshots(directory: str) -> list:
    """Parse every discovered snapshot into fold entries.

    Each entry: ``{"path", "mtime", "snap" | None, "corrupt"}`` — a
    torn/unparseable/mis-shaped file is an entry with ``corrupt: true``
    and no ``snap``, NOT an exception: one killed-mid-write publisher
    must never blind the pod view to its healthy peers.
    """
    entries: list = []
    for path in discover_snapshots(directory):
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            continue  # unlinked between glob and stat — a publisher churn
        entry: dict = {"path": path, "mtime": mtime, "snap": None, "corrupt": False}
        try:
            with open(path) as f:
                snap = json.load(f)
            if (
                not isinstance(snap, dict)
                or not isinstance(snap.get("host"), str)
                or not isinstance(snap.get("pid"), int)
                or not isinstance(snap.get("t_wall"), (int, float))
                or snap.get("schema") != SNAP_SCHEMA
            ):
                raise ValueError("snapshot missing identity fields")
            entry["snap"] = snap
        except (OSError, ValueError, json.JSONDecodeError):
            entry["corrupt"] = True
        entries.append(entry)
    return entries


def _dedupe_generations(entries: list) -> None:
    """Mark all but the highest ``(generation, seq)`` per ``(host,
    pid)`` as superseded (pid reuse after restart: the dead process's
    counters must not sum with its successor's)."""
    best: dict = {}
    for e in entries:
        snap = e["snap"]
        if snap is None:
            continue
        key = (snap["host"], snap["pid"])
        rank = (snap.get("generation", 0), snap.get("seq", 0))
        cur = best.get(key)
        if cur is None or rank > cur[0]:
            best[key] = (rank, e)
    for e in entries:
        snap = e["snap"]
        if snap is None:
            continue
        e["superseded"] = best[(snap["host"], snap["pid"])][1] is not e


def merge_instruments(per_host: "Iterable[tuple[float, list]]") -> "tuple[list, list]":
    """Fold per-host instrument lists into one merged, sorted list.

    ``per_host`` yields ``(t_wall, instruments)`` pairs — the timestamp
    orders the ``last`` gauge policy (freshest host wins).  Returns
    ``(merged, conflicts)``; conflicts are human-readable strings (kind
    clashes, histogram-bound mismatches) and the conflicting host's
    instrument is skipped, never silently coerced.
    """
    merged: dict = {}
    conflicts: list = []
    for t_wall, instruments in sorted(per_host, key=lambda p: p[0]):
        for inst in instruments:
            name = inst.get("name")
            labels = inst.get("labels") or {}
            kind = inst.get("kind")
            key = (name, tuple(sorted(labels.items())))
            cur = merged.get(key)
            if cur is None:
                cur = merged[key] = {
                    "name": name,
                    "kind": kind,
                    "help": inst.get("help", ""),
                    "labels": dict(labels),
                }
                if kind == "histogram":
                    cur["sum"] = 0.0
                    cur["count"] = 0
                    cur["bounds"] = list(inst.get("bounds", []))
                    cur["buckets"] = [0] * len(inst.get("buckets", []))
                else:
                    cur["value"] = 0.0 if kind == "counter" else None
                cur.setdefault("hosts", 0)
            if cur["kind"] != kind:
                conflicts.append(
                    f"{name}: kind {kind} clashes with {cur['kind']}"
                )
                continue
            cur["hosts"] += 1
            if kind == "counter":
                cur["value"] += float(inst.get("value", 0.0))
            elif kind == "histogram":
                if list(inst.get("bounds", [])) != cur["bounds"] or len(
                    inst.get("buckets", [])
                ) != len(cur["buckets"]):
                    conflicts.append(
                        f"{name}: histogram bounds differ across hosts"
                    )
                    cur["hosts"] -= 1
                    continue
                cur["sum"] += float(inst.get("sum", 0.0))
                cur["count"] += int(inst.get("count", 0))
                cur["buckets"] = [
                    a + int(b) for a, b in zip(cur["buckets"], inst["buckets"])
                ]
            else:  # gauge
                v = float(inst.get("value", 0.0))
                policy = gauge_policy(name)
                if cur["value"] is None:
                    cur["value"] = v
                elif policy == "sum":
                    cur["value"] += v
                elif policy == "last":
                    cur["value"] = v  # per_host iterates oldest → freshest
                else:
                    cur["value"] = max(cur["value"], v)
    out = sorted(
        merged.values(),
        key=lambda d: (d["name"], sorted(d["labels"].items())),
    )
    return out, sorted(set(conflicts))


def histogram_quantile(inst: dict, q: float) -> "float | None":
    """Estimate the ``q``-quantile (``0 < q <= 1``) of one histogram
    instrument dict (the :func:`merge_instruments` shape: ``bounds`` and
    per-bucket NON-cumulative ``buckets``, ``+Inf`` last).

    Prometheus ``histogram_quantile`` semantics: linear interpolation
    inside the target bucket between its lower and upper bound (the
    first bucket interpolates from 0); a quantile landing in the
    ``+Inf`` bucket answers the highest finite bound — the honest cap
    of what bucketed data can say.  ``None`` when the histogram is
    empty or shapeless.
    """
    bounds = list(inst.get("bounds") or [])
    buckets = list(inst.get("buckets") or [])
    count = int(inst.get("count", 0))
    if not bounds or len(buckets) != len(bounds) + 1 or count <= 0:
        return None
    rank = q * count
    cum = 0.0
    for i, c in enumerate(buckets):
        prev = cum
        cum += c
        if cum >= rank and c > 0:
            if i >= len(bounds):  # +Inf bucket: cap at the last bound
                return float(bounds[-1])
            lo = float(bounds[i - 1]) if i > 0 else 0.0
            hi = float(bounds[i])
            return lo + (hi - lo) * (rank - prev) / c
    return float(bounds[-1])


def fold(
    entries: list,
    now: "float | None" = None,
    stale_after_s: "float | None" = None,
    newer_than: "float | None" = None,
) -> dict:
    """Fold loaded snapshot entries into the pod view.

    ``stale_after_s`` overrides the per-host default of ``3 x`` the
    snapshot's own ``interval_s`` (a publisher that missed two
    consecutive beats is stale); ``newer_than`` (absolute wall time)
    excludes dead leftovers in a reused telemetry dir from the value
    fold — they stay LISTED with ``excluded: true``, per the
    never-silently-dropped contract.  Pass ``now`` explicitly for a
    deterministic (replayable, byte-stable) fold.
    """
    if now is None:
        now = time.time()
    _dedupe_generations(entries)
    hosts: list = []
    foldable: list = []
    alerts: list = []
    n_stale = n_corrupt = n_excluded = 0
    for e in entries:
        snap = e["snap"]
        if snap is None:
            n_corrupt += 1
            hosts.append({
                "path": os.path.basename(e["path"]),
                "host": None,
                "pid": None,
                "corrupt": True,
                "stale": True,
                "excluded": True,
                "age_s": round(max(0.0, now - e["mtime"]), 3),
            })
            continue
        # freshness is judged on the FRESHER of the snapshot's own stamp
        # and the file's shared-FS mtime: the publisher's wall clock is
        # never trusted alone (the PR-10 principle) — a host whose clock
        # lags the aggregator still refreshes its file on the shared
        # FS's one clock, and must not read permanently stale
        fresh_t = max(snap["t_wall"], e["mtime"])
        if e.get("superseded"):
            n_excluded += 1
            hosts.append({
                "path": os.path.basename(e["path"]),
                "host": snap["host"],
                "pid": snap["pid"],
                "generation": snap.get("generation"),
                "corrupt": False,
                "stale": True,
                "excluded": True,
                "superseded": True,
                "age_s": round(max(0.0, now - fresh_t), 3),
            })
            continue
        age = max(0.0, now - fresh_t)
        bound = (
            stale_after_s
            if stale_after_s is not None
            else 3.0 * float(snap.get("interval_s") or 5.0)
        )
        stale = age > bound
        excluded = newer_than is not None and fresh_t < newer_than
        row = {
            "path": os.path.basename(e["path"]),
            "host": snap["host"],
            "pid": snap["pid"],
            "kind": snap.get("kind", "run"),
            "generation": snap.get("generation"),
            "seq": snap.get("seq"),
            "age_s": round(age, 3),
            "uptime_s": snap.get("uptime_s"),
            "interval_s": snap.get("interval_s"),
            "corrupt": False,
            "stale": bool(stale),
            "excluded": bool(excluded),
        }
        state = snap.get("state")
        if isinstance(state, dict) and state:
            row["state"] = state
        hosts.append(row)
        if excluded:
            # a departed host (beyond newer_than) is excluded, not
            # stale: it must stop feeding the staleness alert — the
            # alert covers the in-between window where the host is
            # late but not yet written off
            n_excluded += 1
            continue
        if stale:
            n_stale += 1
        foldable.append((snap["t_wall"], snap.get("metrics") or []))
        if isinstance(state, dict):
            for a in state.get("alerts") or []:
                if isinstance(a, dict):
                    alerts.append({**a, "host": snap["host"]})
    hosts.sort(key=lambda h: (h.get("host") or "", h.get("pid") or 0, h["path"]))
    metrics, conflicts = merge_instruments(foldable)
    alerts.sort(key=lambda a: (str(a.get("rule")), str(a.get("host"))))
    return {
        "schema": SNAP_SCHEMA,
        "generated_t": now,
        "hosts": hosts,
        "metrics": metrics,
        "conflicts": conflicts,
        "alerts": alerts,
        "counts": {
            "snapshots": len(entries),
            "folded": len(foldable),
            "stale": n_stale,
            "corrupt": n_corrupt,
            "excluded": n_excluded,
        },
    }


def fold_dir(
    directory: str,
    now: "float | None" = None,
    stale_after_s: "float | None" = None,
    newer_than: "float | None" = None,
) -> dict:
    """``load_snapshots`` + :func:`fold` in one call — the consumer
    entrypoint (``tools/lt_fleet.py``, ``lt top --dir``, the serve
    fleet loop)."""
    return fold(
        load_snapshots(directory),
        now=now,
        stale_after_s=stale_after_s,
        newer_than=newer_than,
    )


def render_prom(view: dict) -> str:
    """Pod view → aggregated Prometheus exposition (format 0.0.4).

    The merged instruments plus the fleet meta-gauges
    (``lt_fleet_hosts`` / ``lt_fleet_stale_hosts`` /
    ``lt_fleet_corrupt_snaps``).  Deterministic: identical views render
    identical bytes (the perf gate's byte-stability check).
    """
    lines: list = []
    counts = view.get("counts", {})
    for name, help_, val in (
        ("lt_fleet_hosts", "snapshots folded into this pod view",
         counts.get("folded", 0)),
        ("lt_fleet_stale_hosts", "hosts past their staleness bound",
         counts.get("stale", 0)),
        ("lt_fleet_corrupt_snaps", "torn/unparseable snapshot files",
         counts.get("corrupt", 0)),
    ):
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} gauge")
        lines.append(f"{name} {_fmt(val)}")
    seen_family: set = set()
    for inst in view.get("metrics", []):
        name, kind = inst["name"], inst["kind"]
        if name not in seen_family:
            seen_family.add(name)
            if inst.get("help"):
                lines.append(f"# HELP {name} {inst['help']}")
            lines.append(f"# TYPE {name} {kind}")
        labels = inst.get("labels") or {}
        if kind == "histogram":
            cum = 0
            for b, c in zip(inst["bounds"], inst["buckets"]):
                cum += c
                le = 'le="%s"' % _fmt(float(b))
                lines.append(f"{name}_bucket{_fmt_labels(labels, le)} {cum}")
            inf = 'le="+Inf"'
            lines.append(
                f"{name}_bucket{_fmt_labels(labels, inf)} {inst['count']}"
            )
            lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt(inst['sum'])}")
            lines.append(f"{name}_count{_fmt_labels(labels)} {inst['count']}")
        else:
            v = inst.get("value")
            lines.append(
                f"{name}{_fmt_labels(labels)} {_fmt(0.0 if v is None else v)}"
            )
    return "\n".join(lines) + "\n"


def _scalar_key(name: str, labels: "dict | None") -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
    return name + "{" + inner + "}"


def flatten_scalars(metrics: list) -> dict:
    """Merged instruments → flat ``{key: value}`` scalars for history
    samples: counters/gauges by ``name{labels}``, histograms as their
    ``_sum`` / ``_count`` pair (enough for every rate/burn rule — the
    ring stays compact)."""
    out: dict = {}
    for inst in metrics:
        key = _scalar_key(inst["name"], inst.get("labels"))
        if inst["kind"] == "histogram":
            out[key + "_sum"] = inst["sum"]
            out[key + "_count"] = inst["count"]
        else:
            v = inst.get("value")
            out[key] = 0.0 if v is None else v
    return out


def pod_sample(view: dict, t: "float | None" = None) -> dict:
    """One history-ring sample from a pod view: the timestamp, the host
    health counts, and the flattened scalar metrics the alert engine
    evaluates over."""
    counts = view.get("counts", {})
    return {
        "t": view.get("generated_t", time.time()) if t is None else t,
        "hosts": int(counts.get("folded", 0)),
        "stale_hosts": int(counts.get("stale", 0)),
        "corrupt_snaps": int(counts.get("corrupt", 0)),
        "alerts_firing": len(view.get("alerts", [])),
        "metrics": flatten_scalars(view.get("metrics", [])),
    }
