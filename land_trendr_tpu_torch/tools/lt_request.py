"""Assemble ONE request's cross-layer trace: router → replica → tiles.

Counterpart of the JAX package's ``tools/lt_request.py``, over the port's
:mod:`land_trendr_tpu_torch.obs.reqtrace`.  Give it a ``trace_id`` and the
event streams it crossed — a router workdir expands to its own stream
plus every spawned replica's and every pinned job workdir's — and it
emits

* a JSON **record** on stdout: the journey timeline (router queue wait →
  route decision → each forward hop with its target replica → replica
  admission queue → compile → per-tile feed/upload/compute/fetch/write),
  the hop list (a re-routed request shows both forwards under the one
  id), and the **blame decomposition** — a priority-sweep partition of
  the router-observed latency whose components sum to it by construction
  (``blame_sum_s == latency_s``);
* with ``--trace OUT.json``, a **Chrome trace-event file** of the journey
  on one wall-aligned timeline (one trace process per stream, one thread
  per blame component; :func:`export_trace`);
* with ``--list``, the ``request_done`` index (slowest first) instead.

Exit codes: 0 ok, 1 trace not found in the given streams, 2 usage/IO.
It reads files only, so it takes no ``--device``.

Usage::

    python -m land_trendr_tpu_torch.tools.lt_request TRACE_ID ROUTER_WORKDIR [PATHS...]
    python -m land_trendr_tpu_torch.tools.lt_request --list ROUTER_WORKDIR
    python -m land_trendr_tpu_torch.tools.lt_request --slowest ROUTER_WORKDIR --trace out.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from land_trendr_tpu_torch.obs.reqtrace import (
    assemble_request,
    discover_request_files,
    list_requests,
)
from land_trendr_tpu_torch.tools.measure import write_json_atomic

__all__ = ["expand_paths", "export_trace", "main", "trace_events"]

_US = 1e6  # trace-event timestamps are microseconds


def expand_paths(paths: "list[str]") -> "list[str]":
    """CLI arguments → event streams: files pass through, a directory
    expands to the fleet layout's streams (its own ``events*.jsonl``,
    ``replicas/*/``, ``jobs/*/work/``).  Raises ``FileNotFoundError``
    for a missing path or a stream-less directory."""
    out: "list[str]" = []
    for p in paths:
        if os.path.isdir(p):
            found = discover_request_files(p)
            if not found:
                raise FileNotFoundError(f"no events*.jsonl under {p}")
            out.extend(found)
        elif os.path.exists(p):
            out.append(p)
        else:
            raise FileNotFoundError(f"{p} does not exist")
    # dedupe, keep order (a workdir given twice must not double-fold)
    return list(dict.fromkeys(out))


def trace_events(record: dict) -> "tuple[list[dict], list[dict]]":
    """An assembled request → :func:`export_trace`'s source shape: one
    slice per timeline entry, keyed by source stream, with the blame
    component as the trace thread."""
    src: "list[dict]" = []
    files = sorted({e["file"] for e in record.get("timeline", [])})
    index = {f: i for i, f in enumerate(files)}
    for e in record.get("timeline", []):
        name = e["component"]
        if e.get("tile") is not None:
            name = f"{e['component']} tile {e['tile']}"
        elif e.get("replica") is not None:
            name = f"{e['component']} → {e['replica']}"
        src.append({
            "kind": "slice",
            "file": index[e["file"]],
            "tid": e["component"],
            "name": name,
            "t0": e["t0"],
            "dur": e["dur"],
            "args": {
                k: e[k]
                for k in ("replica", "attempt", "ok", "tile", "job_id")
                if e.get(k) is not None
            },
        })
    hosts = [{"process_index": f, "host": None} for f in files]
    return src, hosts


def export_trace(spans: "list[dict]", hosts: "list[dict]", out_path: str) -> int:
    """Write the chrome://tracing JSON of ``spans`` (slices, instants and
    counters keyed by file ordinal); returns the number of trace events.
    The port's copy of the JAX package's ``tools/obs_report.export_trace``."""
    t_base = min(s["t0"] for s in spans) if spans else 0.0
    events: "list[dict]" = []
    tids: "dict[tuple[int, str], int]" = {}

    def tid_of(fileno: int, name: str) -> int:
        key = (fileno, name)
        if key not in tids:
            tids[key] = len([k for k in tids if k[0] == fileno]) + 1
            events.append({
                "ph": "M", "pid": fileno, "tid": tids[key],
                "name": "thread_name", "args": {"name": name},
            })
        return tids[key]

    for fileno, h in enumerate(hosts):
        label = f"proc {h.get('process_index', fileno)}"
        if h.get("host"):
            label += f" @ {h['host']}"
        events.append({
            "ph": "M", "pid": fileno, "tid": 0,
            "name": "process_name", "args": {"name": label},
        })
    for s in spans:
        ts = (s["t0"] - t_base) * _US
        if s["kind"] == "slice":
            events.append({
                "ph": "X", "pid": s["file"], "tid": tid_of(s["file"], s["tid"]),
                "name": s["name"], "cat": s["tid"], "ts": ts,
                "dur": max(s["dur"], 0.0) * _US, "args": s.get("args", {}),
            })
        elif s["kind"] == "instant":
            events.append({
                "ph": "i", "pid": s["file"], "tid": tid_of(s["file"], s["tid"]),
                "name": s["name"], "cat": "retry", "ts": ts, "s": "t",
                "args": s.get("args", {}),
            })
        elif s["kind"] == "counter":
            events.append({
                "ph": "C", "pid": s["file"], "tid": 0, "name": s["name"],
                "ts": ts, "args": s.get("args", {}),
            })
    write_json_atomic(out_path, {"traceEvents": events, "displayTimeUnit": "ms"},
                      indent=None, trailing_newline=False)
    return len(events)


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_id", nargs="?", default=None,
                    help="the request correlation id to assemble (from "
                    "/debug/requests, /metrics/exemplars or a job status snapshot)")
    ap.add_argument("paths", nargs="+",
                    help="event streams: events*.jsonl files, or a router/serve "
                    "workdir (expands to its own stream + replicas/*/ + jobs/*/work/)")
    ap.add_argument("--list", action="store_true",
                    help="list every request_done in the streams, slowest first")
    ap.add_argument("--slowest", action="store_true",
                    help="assemble the slowest request_done found (no trace_id needed)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="also export the journey as a chrome://tracing / Perfetto trace")
    args = ap.parse_args(argv)

    if args.list or args.slowest:
        # no trace_id needed: the first positional (if any) is a path
        raw = [p for p in (args.trace_id, *args.paths) if p is not None]
        try:
            files = expand_paths(raw)
        except FileNotFoundError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        index = list_requests(files)
        if args.list:
            print(json.dumps({"requests": index}, indent=2))
            return 0
        if not index:
            print("error: no request_done in the given streams", file=sys.stderr)
            return 1
        trace_id = index[0]["trace_id"]
    else:
        if args.trace_id is None:
            print("error: a TRACE_ID is required (or --list/--slowest)", file=sys.stderr)
            return 2
        trace_id = args.trace_id
        try:
            files = expand_paths(args.paths)
        except FileNotFoundError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

    record = assemble_request(files, trace_id)
    if not record["found"]:
        print(f"error: trace {trace_id!r} not found in {len(files)} stream(s)",
              file=sys.stderr)
        return 1
    if args.trace:
        src, hosts = trace_events(record)
        record["trace"] = {"path": args.trace,
                           "events": export_trace(src, hosts, args.trace)}
    record["files_scanned"] = files
    print(json.dumps(record, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
