"""Assemble N per-host event streams into one pod trace + imbalance report.

Counterpart of the JAX package's ``tools/lt_trace.py``, over the port's
:func:`~land_trendr_tpu_torch.obs.spans.assemble_pod_trace`.  Give it a
shared workdir (or the per-host ``events.p<i>.jsonl`` files) and it emits

* a JSON **report** on stdout — per-host wall/busy/idle-gap seconds, tail
  ratio, straggler and retry counts, span-derived stage seconds with a
  per-host critical path, the pod rollup (host imbalance, pod-wide
  critical-path attribution) and the wall skew removed per host;
* with ``--trace OUT.json``, a **Chrome trace-event file** of the whole pod
  on ONE offset-corrected timeline — one trace process per host, one
  thread per pipeline stage, straggler / steal / speculate verdicts as
  instants (the port's copy of the Chrome exporter,
  :func:`~land_trendr_tpu_torch.tools.lt_request.export_trace`).

Each host's ``t=0`` is its ``run_start`` clock anchor, so wall skew between
hosts never shifts the trace; the skew removed is reported, never trusted.
Exit codes: 0 ok, 2 usage/IO error.  It reads files only, so it takes no
``--device``.

Usage::

    python -m land_trendr_tpu_torch.tools.lt_trace WORKDIR | EVENTS.jsonl ... [--trace out.json]
"""

from __future__ import annotations

import argparse
import json
import sys

from land_trendr_tpu_torch.obs.events import expand_event_paths
from land_trendr_tpu_torch.obs.spans import assemble_pod_trace
from land_trendr_tpu_torch.tools.lt_request import export_trace

__all__ = ["main", "report_from_trace", "trace_events"]

#: report keys a host, in display order
_HOST_KEYS = (
    "host", "process_index", "run_id", "status", "wall_skew_s", "wall_s",
    "busy_s", "idle_gap_s", "tail_ratio", "tiles_done", "pixels",
    "px_per_s", "retries", "stragglers", "tiles_leased", "tiles_stolen",
    "tiles_speculated", "stage_s", "critical_path",
)


def _markers(trace: dict, name: str, keys: tuple) -> "list[dict]":
    return [{k: m.get(k) for k in keys} for m in trace["markers"] if m.get("name") == name]


def report_from_trace(trace: dict) -> dict:
    """The imbalance / critical-path view of an assembled trace."""
    return {
        "files": trace["files"],
        "malformed": trace["malformed"],
        "spans": len(trace["spans"]),
        "stragglers": _markers(trace, "straggler", ("tile", "t0", "duration_s", "threshold_s")),
        "steals": _markers(trace, "steal", ("tile", "t0", "host", "gen")),
        "speculations": _markers(trace, "speculate", ("tile", "t0", "host", "gen")),
        "hosts": [{k: h.get(k) for k in _HOST_KEYS} for h in trace["hosts"]],
        "pod": trace["pod"],
    }


def trace_events(trace: dict) -> "tuple[list[dict], list[dict]]":
    """Assembled spans/markers → the Chrome exporter's source shape
    (slices keyed by host ordinal; the stage name is the trace thread)."""
    src: "list[dict]" = []
    for s in trace["spans"]:
        src.append({
            "kind": "slice", "file": s["file"], "tid": s["name"], "name": f"tile {s['tile']}",
            "t0": s["t0"], "dur": s["dur"],
            "args": {k: s[k] for k in ("attempt", "run_id", "job_id") if s.get(k) is not None},
        })
    for m in trace["markers"]:
        src.append({
            "kind": "instant", "file": m["file"], "tid": "compute",
            "name": f"{str(m.get('name', '?')).upper()} tile {m['tile']}", "t0": m["t0"],
            "args": {k: m[k] for k in ("duration_s", "threshold_s", "gen")
                     if m.get(k) is not None},
        })
    return src, trace["hosts"]


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="+",
                    help="events.jsonl files, or workdirs holding them (a pod workdir "
                    "expands to its events.p<i>.jsonl set)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="also export the pod-wide chrome://tracing / Perfetto trace")
    args = ap.parse_args(argv)
    try:
        paths = expand_event_paths(args.paths)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    trace = assemble_pod_trace(paths)
    report = report_from_trace(trace)
    if args.trace:
        src, hosts = trace_events(trace)
        report["trace"] = {"path": args.trace, "events": export_trace(src, hosts, args.trace)}
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
