"""Command-line driver for the PyTorch/CUDA package.

Counterpart of ``land_trendr_tpu/cli.py``:

``segment``   stack directory → segment rasters (the main pipeline), with
              optional FTV rasters (``--ftv``), fused change maps
              (``--change``) and further indices segmented beside the
              primary one (``--ensemble``); retries, quarantine, the
              stall watchdog, fault injection, the feed cache and ingest
              store, the medoid composite, overviews, telemetry, the
              flight recorder, a profiler trace (``--trace``), elastic
              runs (``--lease-batch``: any number of ``segment``
              processes over one workdir), mesh sharding over the local
              cards (``--mesh``) and ``auto`` knobs resolved through a
              tuning store (``--tune-store-dir``)
``serve``     the long-lived segmentation server: warm tile programs, a
              bounded job queue over a loopback HTTP JSON API and a
              filesystem drop-box, admission control, cancel and
              timeouts, cross-job batching and the fleet telemetry loop
``route``     the serving-fleet router: one loopback front door over N
              ``serve`` replicas (spawned or adopted), warm-affinity
              routing, tenant quotas and fair share, re-routing on a
              replica's death, a write-ahead admission journal and
              SLO-driven autoscaling
``load``      drive a running router with a seeded trace (open- or
              closed-loop) and report every request's trace id
``tune``      probe the execution knobs on the device and persist the
              winning profile to a tuning store (a stored key reloads with
              zero probes)
``pixel``     segment ONE series through the NumPy oracle and/or this
              package's segmentation (the single-pixel debug/parity path)
``change``    segment rasters → change maps (yod/mag/dur/rate/preval/dsnr)
``info``      inspect rasters header-only, optionally one decoded window
``synth``     materialise a synthetic Landsat stack (fixtures / demos)
``params``    print the algorithm parameters as JSON (a template for
              ``--params-json``)

The top-level ``--device`` flag picks where the pipeline runs: ``cuda``
(the default, the hand-written kernel on the card) or ``cpu`` (the plain
PyTorch version; for tests and debugging only).  ``--device cuda`` on a
machine without a usable card fails with a clear error; it never carries
on on the CPU (``change`` runs its selector there too, ``--composite``
its selection).  The device also decides the segmentation implementation,
so there is no ``--impl``.  ``route`` spawns its replicas with the
card as their device unless ``--replica-args`` passes ``--device cpu``.

Exit codes of ``segment``: 2 config/usage error, 3 a tile exhausted its
retries or was quarantined (a re-run resumes exactly the missing tiles),
4 stall-watchdog abort.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops.indices import DEFAULT_QA_REJECT, INDEX_NAMES
from land_trendr_tpu_torch.runtime.manifest import ARTIFACT_COMPRESS

__all__ = ["main", "build_parser", "run"]


def _sigterm_to_interrupt(signum, frame):
    """SIGTERM → KeyboardInterrupt: the long-running servers drain on
    an orchestrator stop exactly like Ctrl-C (``route`` writes its
    journal clean-shutdown marker on this path)."""
    raise KeyboardInterrupt


def _auto_int(s: str):
    """Tunable-knob flag values: an integer or the 'auto' sentinel (the
    tuning-store resolution)."""
    return s if s == "auto" else int(s)


def _add_param_flags(p: argparse.ArgumentParser) -> None:
    g = p.add_argument_group("algorithm parameters (reference names)")
    g.add_argument("--params-json", type=str, default=None,
                   help="path to an LTParams JSON file (flags override it)")
    for f in dataclasses.fields(LTParams):
        flag = "--" + f.name.replace("_", "-")
        if f.type == "bool":
            g.add_argument(flag, type=lambda s: s.lower() in ("1", "true", "yes"),
                           default=None, metavar="BOOL")
        else:
            g.add_argument(flag, type=int if f.type == "int" else float, default=None)


def _params_from_args(args: argparse.Namespace) -> LTParams:
    base = {}
    if args.params_json:
        with open(args.params_json) as f:
            base = json.load(f)
    for f in dataclasses.fields(LTParams):
        v = getattr(args, f.name, None)
        if v is not None:
            base[f.name] = v
    return LTParams.from_dict(base)


def _add_change_flags(p: argparse.ArgumentParser, prefix: str = "") -> None:
    """The ChangeFilter fields as flags: bare for ``change``, ``--change-``
    prefixed for ``segment --change`` (the JAX package's names)."""
    p.add_argument(f"--{prefix}kind", default="disturbance",
                   choices=("disturbance", "recovery"))
    p.add_argument(f"--{prefix}sort", default="greatest",
                   choices=("greatest", "newest", "oldest"),
                   help="which qualifying segment becomes the map")
    p.add_argument(f"--{prefix}min-mag", type=float, default=0.0,
                   help="minimum |magnitude| in index units")
    p.add_argument(f"--{prefix}min-dur", type=float, default=0.0)
    p.add_argument(f"--{prefix}max-dur", type=float, default=float("inf"),
                   help="maximum duration in years (classic fast-disturbance "
                   "filter: 4)")
    p.add_argument(f"--{prefix}min-preval", type=float, default=float("-inf"),
                   help="minimum fitted value at the segment start")
    p.add_argument(f"--{prefix}max-p", type=float, default=1.0,
                   help="extra p-of-F cap on top of the run's threshold")
    p.add_argument(f"--{prefix}year-min", type=float, default=float("-inf"))
    p.add_argument(f"--{prefix}year-max", type=float, default=float("inf"))
    p.add_argument(f"--{prefix}mmu", type=int, default=1,
                   help="minimum mapping unit: drop 4-connected changed patches "
                   "smaller than this many pixels (spatial, so it runs on the "
                   "assembled rasters)")


def _change_filter_from_args(args: argparse.Namespace, prefix: str = ""):
    """One ChangeFilter construction for ``change`` (bare names) and
    ``segment --change`` (``change_`` prefixed)."""
    from land_trendr_tpu_torch.ops.change import ChangeFilter

    def g(name):
        return getattr(args, prefix + name)

    return ChangeFilter(
        kind=g("kind"), sort=g("sort"), min_mag=g("min_mag"), min_dur=g("min_dur"),
        max_dur=g("max_dur"), min_preval=g("min_preval"), max_p=g("max_p"),
        year_min=g("year_min"), year_max=g("year_max"),
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="land_trendr_tpu_torch",
        description="LandTrendr temporal segmentation on PyTorch + CUDA",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="where the pipeline runs: 'cuda' (default; the fused kernel on "
        "the card) or 'cpu' (the plain PyTorch version — tests and "
        "debugging only)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    seg = sub.add_parser("segment", help="segment a Landsat stack directory")
    seg.add_argument("stack_dir", help="directory of per-year multi-band GeoTIFFs "
                     "or Collection-2 per-band files")
    seg.add_argument("--index", default="nbr", choices=INDEX_NAMES,
                     help="index driving the segmentation")
    seg.add_argument("--ftv", default="", help="comma-separated FTV indices")
    seg.add_argument("--ensemble", "--ensemble-indices", dest="ensemble", default="",
                     help="comma-separated further indices, each segmented on its own "
                          "beside --index (ens_<index>_<product> rasters)")
    seg.add_argument("--tile-size", type=_auto_int, default=512,
                     help="tile edge in pixels, or 'auto' (resolve through "
                     "--tune-store-dir's profile; with no profile, 'auto' falls "
                     "back to the LIBRARY default 256, not this flag's 512)")
    seg.add_argument("--workdir", default="lt_work")
    seg.add_argument("--out-dir", default="lt_out")
    seg.add_argument("--no-resume", action="store_true",
                     help="discard any existing workdir manifest")
    seg.add_argument("--products", default=None, metavar="P1,P2,...",
                     help="subset of segmentation products to write")
    seg.add_argument("--write-fitted", action="store_true",
                     help="also write the fitted trajectory raster")
    seg.add_argument("--fetch-f16", action="store_true",
                     help="fetch float products from the device as float16 "
                     "(halves device→host bytes; lossy, ~5e-4 relative)")
    seg.add_argument("--no-packed-fetch", action="store_true",
                     help="fetch each product on its own (default: one packed "
                     "device→host copy per tile on a CUDA device)")
    seg.add_argument("--packed-fetch", action="store_true",
                     help="force the packed fetch")
    seg.add_argument("--fetch-depth", type=_auto_int, default=2,
                     help="packed fetches in flight, or 'auto'")
    seg.add_argument("--no-packed-upload", action="store_true",
                     help="upload each fed array on its own (default: one "
                     "packed pinned host→device copy per tile on a CUDA device)")
    seg.add_argument("--packed-upload", action="store_true",
                     help="force the packed upload")
    seg.add_argument("--upload-depth", type=_auto_int, default=2,
                     help="packed uploads in flight, or 'auto'")
    seg.add_argument("--out-compress", default="deflate",
                     choices=("deflate", "lzw", "none"))
    seg.add_argument("--manifest-compress", default="none", choices=ARTIFACT_COMPRESS)
    seg.add_argument("--write-workers", type=int, default=1,
                     help="background tile-writer threads")
    seg.add_argument("--feed-workers", type=_auto_int, default=1,
                     help="background feed threads, or 'auto'")
    seg.add_argument("--reject-bits", type=lambda s: int(s, 0),
                     default=DEFAULT_QA_REJECT, metavar="MASK",
                     help="QA_PIXEL bitmask of rejected observation classes "
                     f"(decimal or 0x hex; default 0x{DEFAULT_QA_REJECT:x})")
    seg.add_argument("--chunk-px", default=262_144, metavar="N",
                     type=lambda s: (
                         None if s.lower() == "none" else s if s == "auto" else int(s)
                     ),
                     help="tiles with more pixels run the segmentation as "
                     "chunked launches; 'none' disables chunking; 'auto' "
                     "resolves through the tuning store")
    seg.add_argument("--tune-store-dir", default=None, metavar="DIR",
                     help="on-disk tuning store (lt tune's output) the 'auto' "
                     "knob values resolve through at run start; key miss or "
                     "no DIR = hardcoded defaults")
    seg.add_argument("--mesh", action="store_true",
                     help="shard every tile's pixel axis over ALL local CUDA "
                     "devices (one launch per device, no cross-device "
                     "traffic); default runs on the single --device.  Needs "
                     "a card")
    seg.add_argument("--scale", type=float, default=2.75e-5,
                     help="DN → reflectance scale (C2 default)")
    seg.add_argument("--offset", type=float, default=-0.2,
                     help="DN → reflectance offset (C2 default)")
    seg.add_argument("--change", action="store_true",
                     help="fuse change-map selection into every tile's program; "
                     "change_*.tif rasters assemble beside the segment products")
    _add_change_flags(seg, prefix="change-")
    seg.add_argument("--lazy", action="store_true",
                     help="windowed file-backed ingest (C2 per-band layout "
                     "only): no input cube in host RAM")
    seg.add_argument("--feed-cache-mb", type=_auto_int, default=256,
                     help="decoded-block cache budget (MiB) for the windowed "
                     "feed path; 0 disables the cache; 'auto' resolves "
                     "through the tuning store")
    seg.add_argument("--decode-workers", type=_auto_int, default=0,
                     help="feed-decode threads: 0 = codec auto-threading, "
                     "1 = serial, N = N threads, 'auto' = tuning-store "
                     "resolution")
    seg.add_argument("--no-feed-readahead", action="store_true",
                     help="disable the next-tile block-decode hint (only "
                     "meaningful with --lazy and a non-zero --feed-cache-mb)")
    seg.add_argument("--ingest-store-mb", type=int, default=0,
                     help="persistent decoded-block store budget (MiB) under "
                     "the workdir: a rerun over the same stacks skips decode; "
                     "0 = off")
    seg.add_argument("--ingest-store-dir", default=None, metavar="DIR",
                     help="store directory override (default "
                     "WORKDIR/ingest_store)")
    seg.add_argument("--composite", default=None, choices=("medoid",),
                     help="collapse multi-acquisition years of a C2 per-band "
                     "archive to per-pixel QA-masked medoid composites, "
                     "selected on --device (default: one acquisition a year)")
    seg.add_argument("--out-overviews", type=_auto_int, default=0,
                     help="overview pyramid levels on output rasters: an "
                     "integer or 'auto' (until the smaller dimension drops "
                     "under 256); default 0 = none")
    seg.add_argument("--trace", default=None, metavar="LOGDIR",
                     help="capture a torch.profiler host + device trace of "
                     "the run as Chrome trace JSON under LOGDIR")
    seg.add_argument("--telemetry", action="store_true",
                     help="run-wide telemetry: events.jsonl and metrics.prom "
                     "under --workdir")
    seg.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                     help="with --telemetry: serve a live /metrics endpoint "
                     "on PORT (0 = ephemeral)")
    seg.add_argument("--metrics-host", default="", metavar="HOST",
                     help="bind address for --metrics-port (default: all "
                     "interfaces)")
    seg.add_argument("--metrics-interval-s", type=float, default=5.0,
                     metavar="SEC",
                     help="with --telemetry: metrics.prom refresh period")
    seg.add_argument("--flight", action="store_true",
                     help="with --telemetry: flight recorder, dumped to "
                     "WORKDIR/flight.jsonl at run end")
    seg.add_argument("--flight-ring-events", type=int, default=2048, metavar="N",
                     help="flight-ring capacity in events; 0 disables ring "
                     "and sampler")
    seg.add_argument("--sampler-interval-s", type=float, default=5.0,
                     metavar="SEC", help="flight resource-sampler period")
    seg.add_argument("--publish", action="store_true",
                     help="with --telemetry: fleet telemetry publish — "
                     "periodically snapshot this process's metrics + "
                     "live progress into an atomic "
                     "TELEMETRY_DIR/<host>.<pid>.snap.json, the "
                     "per-process feed obs.aggregate folds into one pod view")
    seg.add_argument("--publish-interval-s", type=float, default=5.0,
                     metavar="SEC",
                     help="fleet snapshot refresh period in seconds")
    seg.add_argument("--telemetry-dir", default=None, metavar="DIR",
                     help="shared telemetry directory for --publish "
                     "(default WORKDIR/telemetry); point a pod's "
                     "processes at one DIR to aggregate them")
    seg.add_argument("--max-retries", type=int, default=2)
    seg.add_argument("--retry-backoff-s", type=float, default=0.5, metavar="SEC",
                     help="base of the exponential per-tile retry backoff "
                     "(attempt n sleeps ~SEC*2^(n-1), ±50%% jitter, capped "
                     "at 30s); 0 retries immediately")
    seg.add_argument("--quarantine-tiles", action="store_true",
                     help="a tile that exhausts --max-retries is recorded as "
                     "failed and the run continues; exit code 3, no assembly")
    seg.add_argument("--stall-timeout-s", type=float, default=None, metavar="SEC",
                     help="abort (exit 4) after SEC without tile progress "
                     "(default: no watchdog)")
    seg.add_argument("--merge-timeout-s", type=float, default=None,
                     metavar="SEC",
                     help="multihost only: bound on the primary's wait for "
                     "straggler peers' run_done during the event-log merge "
                     "(default: derived from this run's wall time)")
    seg.add_argument("--straggler-k", type=float, default=4.0, metavar="K",
                     help="flag a tile in flight longer than K x the rolling "
                     "median tile duration (observability only)")
    seg.add_argument("--straggler-min-tiles", type=int, default=5, metavar="N",
                     help="no straggler verdicts until N tiles completed")
    seg.add_argument("--lease-batch", type=int, default=0, metavar="N",
                     help="elastic scheduling: replace the static host_share "
                     "tile split with the shared-manifest lease queue — this "
                     "process claims N tiles at a time, renews leases on "
                     "progress, and steals tiles whose leases expired "
                     "(dead/slow peer) or were never claimed, so processes "
                     "may join/leave mid-run; 0 (default) keeps the static "
                     "split.  Artifacts are byte-identical either way")
    seg.add_argument("--lease-ttl-s", type=float, default=30.0, metavar="SEC",
                     help="lease time-to-live: a lease not renewed within SEC "
                     "is stealable by peers.  Size it above the slowest tile "
                     "and the pod's clock skew (a short TTL only costs benign "
                     "duplicate work, never correctness)")
    seg.add_argument("--speculate", action="store_true",
                     help="with --lease-batch: straggler-steered speculative "
                     "execution — an idle process re-leases a tile the "
                     "owner's live straggler detector flagged; first durable "
                     "write wins, the loser lands as an identical no-op")
    seg.add_argument("--fault-schedule", default=None, metavar="SPEC",
                     help="deterministic fault injection for test runs, e.g. "
                     "'seed=7,dispatch@1,fetch.wait@0*2=io'")
    _add_param_flags(seg)

    srv = sub.add_parser(
        "serve",
        help="long-lived segmentation server on --device: warm tile programs, a "
        "bounded job queue over a loopback HTTP JSON API + filesystem "
        "drop-box, admission control with per-tenant caps, and "
        "request-scoped telemetry (README §Service mode)",
    )
    srv.add_argument("--workdir", default="lt_serve",
                     help="server root: the server's events/metrics "
                     "stream, default per-job jobs/<id>/{work,out} "
                     "directories, and the shared ingest store")
    srv.add_argument("--serve-port", type=int, default=0, metavar="PORT",
                     help="loopback HTTP JSON API port (0 = ephemeral, "
                     "reported in the startup line)")
    srv.add_argument("--serve-host", default="127.0.0.1", metavar="HOST",
                     help="bind address for the job API — loopback ONLY "
                     "(127.0.0.1, localhost or ::1): the API is an "
                     "unauthenticated control surface; front it with an "
                     "authenticated proxy or use --dropbox-dir for "
                     "remote batch submission")
    srv.add_argument("--serve-queue-depth", type=int, default=16,
                     help="admission control: submissions past this "
                     "queue depth are rejected with HTTP 429 instead of "
                     "building unbounded backlog")
    srv.add_argument("--tenant-max-inflight", type=int, default=4,
                     help="admission control: per-tenant bound on "
                     "queued+running jobs (429 at the cap; other "
                     "tenants' traffic proceeds)")
    srv.add_argument("--job-timeout-s", type=float, default=None,
                     metavar="SEC",
                     help="default per-job wall bound, submit to "
                     "terminal: an over-budget job is cancelled through "
                     "the run's cancel event and reported 'stalled' "
                     "(the exit-4 analog; manifest stays resumable). "
                     "Jobs may override per request")
    srv.add_argument("--dropbox-dir", default=None, metavar="DIR",
                     help="filesystem drop-box: job-request JSON files "
                     "under DIR are claimed atomically, run through the "
                     "same admission control as HTTP, and answered with "
                     ".rejected.json/.result.json sidecars")
    srv.add_argument("--dropbox-poll-s", type=float, default=1.0,
                     metavar="SEC", help="drop-box scan period")
    srv.add_argument("--max-jobs", type=int, default=None, metavar="N",
                     help="drain N jobs to a terminal state then shut "
                     "down cleanly (bench/CI mode; default: serve "
                     "forever)")
    srv.add_argument("--feed-cache-mb", type=int, default=256,
                     help="process-wide decoded-block cache budget "
                     "(MiB) shared by every job — the server owns the "
                     "cache configuration")
    srv.add_argument("--decode-workers", type=int, default=0,
                     help="shared feed-decode threads: 0 = auto, "
                     "1 = serial, N = N threads")
    srv.add_argument("--ingest-store-mb", type=int, default=0,
                     help="shared persistent ingest store budget (MiB): "
                     "decoded blocks from every job spill to one store "
                     "under the server workdir, so a warm job over "
                     "already-ingested stacks skips TIFF decode "
                     "entirely; 0 = off")
    srv.add_argument("--ingest-store-dir", default=None, metavar="DIR",
                     help="store directory override (default "
                     "WORKDIR/ingest_store)")
    srv.add_argument("--tune-store-dir", default=None, metavar="DIR",
                     help="shared tuning store (lt tune's output): every "
                     "job's 'auto' knobs resolve through it, so the "
                     "whole replica runs tuned; per-job explicit knobs "
                     "still win (README §Autotuning)")
    srv.add_argument("--no-telemetry", action="store_true",
                     help="disable the server events/metrics stream AND "
                     "per-job run telemetry (on by default in serve "
                     "mode — the observability is the point)")
    srv.add_argument("--metrics-port", type=int, default=None,
                     metavar="PORT",
                     help="serve the lt_serve_* registry's live "
                     "/metrics on PORT (0 = ephemeral); the job API "
                     "serves GET /metrics regardless")
    srv.add_argument("--metrics-host", default="", metavar="HOST",
                     help="bind address for --metrics-port (the scrape "
                     "endpoint is read-only and may be non-loopback)")
    srv.add_argument("--metrics-interval-s", type=float, default=5.0,
                     metavar="SEC", help="metrics.prom refresh period")
    srv.add_argument("--fault-schedule", default=None, metavar="SPEC",
                     help="deterministic fault injection for soak runs "
                     "(one process-wide plan shared by every job, incl. "
                     "the serve.submit/serve.job seams); production "
                     "servers leave this unset")
    srv.add_argument("--no-debug-endpoints", action="store_true",
                     help="disable the live /debug surface "
                     "(/debug/flight, /debug/stacks, /debug/jobs, POST "
                     "/debug/profile — loopback-only like the job API; "
                     "on by default)")
    srv.add_argument("--flight-ring-events", type=int, default=2048,
                     metavar="N",
                     help="flight-recorder ring capacity in events: the "
                     "/debug/flight window over server AND job events, "
                     "dumped to WORKDIR/flight.jsonl at shutdown; 0 "
                     "disables the ring and the resource sampler")
    srv.add_argument("--sampler-interval-s", type=float, default=5.0,
                     metavar="SEC",
                     help="flight resource-sampler period (flight_sample "
                     "events: RSS, fds, threads, queue depth, backlogs, "
                     "cache occupancy)")
    srv.add_argument("--request-ring", type=int, default=64, metavar="N",
                     help="request-tracing recency bound: how many "
                     "recent terminal requests (trace id + latency "
                     "split) GET /debug/requests serves slowest-first; "
                     "0 disables the ring")
    srv.add_argument("--publish", action="store_true",
                     help="fleet telemetry plane: publish this replica's "
                     "snapshot under TELEMETRY_DIR, fold every snapshot "
                     "there into one pod view each beat, retain the "
                     "timeline in the on-disk history ring, and evaluate "
                     "the alert rules over it (alert events, lt_alerts_* "
                     "metrics, active alerts on /healthz and lt top)")
    srv.add_argument("--publish-interval-s", type=float, default=5.0,
                     metavar="SEC",
                     help="fleet beat period (snapshot + fold + alert "
                     "evaluation)")
    srv.add_argument("--telemetry-dir", default=None, metavar="DIR",
                     help="shared telemetry directory for --publish "
                     "(default WORKDIR/telemetry); point N replicas at "
                     "one DIR to aggregate the fleet")
    srv.add_argument("--alert-rules", default=None, metavar="FILE",
                     help="alert-rules JSON for the fleet loop "
                     "(land_trendr_tpu_torch.obs.alerts); default: built-in "
                     "host-staleness + SLO-burn rules")
    srv.add_argument("--batch", default="auto",
                     choices=("auto", "on", "off"),
                     help="cross-job continuous batching: coalesce "
                     "queued same-affinity jobs behind one shared "
                     "launch and demux byte-identical artifacts to "
                     "each (README §Continuous batching); 'auto' "
                     "resolves through --tune-store-dir, defaulting on")
    srv.add_argument("--batch-window-ms", type=float, default=50.0,
                     metavar="MS",
                     help="how long the dispatcher holds a batch window "
                     "open for same-affinity stragglers; closes early "
                     "when a non-matching job reaches the queue front "
                     "or the queue is empty (0 = batch only what is "
                     "already queued)")
    srv.add_argument("--batch-max-tiles", type=int, default=0,
                     metavar="N",
                     help="batch size bound in total coalesced tiles "
                     "(jobs x tiles per job); members past the bound "
                     "run solo in their normal queue turn (0 = "
                     "unbounded)")

    rte = sub.add_parser(
        "route",
        help="serving-fleet router: one loopback front door over N "
        "serve replicas of this package (spawned or adopted) with "
        "warm-affinity routing, per-tenant quotas + weighted fair share, "
        "retry-on-replica-death re-routing, and SLO-burn-driven "
        "autoscaling",
    )
    rte.add_argument("--workdir", default="lt_route",
                     help="router root: its events/metrics stream, the "
                     "pinned per-job jobs/<id>/{work,out} dirs every "
                     "replica resumes from, and spawned replica workdirs")
    rte.add_argument("--route-port", type=int, default=0, metavar="PORT",
                     help="loopback HTTP JSON API port of the front door "
                     "(0 = ephemeral, reported in the startup line)")
    rte.add_argument("--route-host", default="127.0.0.1", metavar="HOST",
                     help="bind address — loopback ONLY (the router "
                     "submits arbitrary work to the whole fleet; front "
                     "it with an authenticated proxy)")
    rte.add_argument("--replica", action="append", default=[],
                     metavar="BASE", dest="replicas",
                     help="ADOPT an already-running replica by base URL "
                     "(http://127.0.0.1:PORT; repeatable) — "
                     "health-checked and routed to, never spawned or "
                     "killed")
    rte.add_argument("--spawn-replicas", type=int, default=0, metavar="N",
                     help="SPAWN N replicas via the lt-serve CLI under "
                     "WORKDIR/replicas (ephemeral ports; the "
                     "autoscaler's pool)")
    rte.add_argument("--replica-args", default="", metavar="FLAGS",
                     help="extra lt-serve flags for every spawned "
                     "replica, space-separated (e.g. "
                     "'--ingest-store-mb 256'); '--device cpu' runs "
                     "them on the CPU (default: the card)")
    rte.add_argument("--replica-inflight", type=int, default=2,
                     help="per-replica in-flight bound at the router "
                     "(queued+running routed jobs one replica holds "
                     "before the router looks elsewhere)")
    rte.add_argument("--route-queue-depth", type=int, default=64,
                     help="router-wide queue bound: submissions past it "
                     "are throttled 429 + Retry-After")
    rte.add_argument("--tenant-quota", type=int, default=16,
                     help="per-tenant bound on queued+routed jobs; at "
                     "the quota the tenant is throttled 429 + "
                     "Retry-After while others' traffic proceeds")
    rte.add_argument("--tenant-weights", default=None, metavar="SPEC",
                     help="weighted fair share, 'tenant=weight,...' — "
                     "deficit round-robin gives each tenant bandwidth "
                     "proportional to its weight (unnamed tenants "
                     "weigh 1)")
    rte.add_argument("--no-affinity", action="store_true",
                     help="disable warm-affinity routing (pure "
                     "least-loaded — the fleet_bench baseline)")
    rte.add_argument("--route-retries", type=int, default=2,
                     help="re-routes per job after a dead replica or "
                     "failed forward before the job goes terminal")
    rte.add_argument("--health-interval-s", type=float, default=1.0,
                     metavar="SEC",
                     help="health-probe + job-poll period")
    rte.add_argument("--unhealthy-after", type=int, default=3,
                     help="consecutive failed health probes before a "
                     "replica is marked unready (its accepted jobs are "
                     "never failed by a probe)")
    rte.add_argument("--autoscale", action="store_true",
                     help="SLO-driven autoscaling of the SPAWNED pool: "
                     "fold the shared telemetry dir for the pod "
                     "lt_slo_burn_rate and scale between "
                     "--min-replicas/--max-replicas with hold-down and "
                     "drain-before-kill")
    rte.add_argument("--min-replicas", type=int, default=1,
                     help="autoscaler floor (spawned replicas)")
    rte.add_argument("--max-replicas", type=int, default=4,
                     help="autoscaler ceiling (spawned replicas)")
    rte.add_argument("--scale-up-burn", type=float, default=0.5,
                     metavar="RATE",
                     help="scale up when the pod burn rate holds at or "
                     "above RATE")
    rte.add_argument("--scale-down-burn", type=float, default=0.05,
                     metavar="RATE",
                     help="scale down when the pod burn rate holds at "
                     "or below RATE and the router queue is empty")
    rte.add_argument("--scale-for-s", type=float, default=0.0,
                     metavar="SEC",
                     help="the burn condition must hold SEC before a "
                     "scale action (transients don't scale)")
    rte.add_argument("--scale-hold-s", type=float, default=30.0,
                     metavar="SEC",
                     help="hold-down between scale actions (no "
                     "flapping)")
    rte.add_argument("--no-telemetry", action="store_true",
                     help="disable the router events/metrics stream "
                     "(on by default)")
    rte.add_argument("--telemetry-dir", default=None, metavar="DIR",
                     help="shared fleet telemetry directory (default "
                     "WORKDIR/telemetry): spawned replicas publish "
                     "here, the autoscaler folds it, lt_fleet/lt top "
                     "--dir render it")
    rte.add_argument("--metrics-interval-s", type=float, default=5.0,
                     metavar="SEC",
                     help="router metrics.prom refresh period")
    rte.add_argument("--request-ring", type=int, default=64, metavar="N",
                     help="request-tracing recency bound: how many "
                     "recent terminal requests (trace id, router blame "
                     "split, hops) GET /debug/requests serves "
                     "slowest-first; 0 disables the ring")
    rte.add_argument("--no-journal", action="store_true",
                     help="disable the write-ahead admission journal "
                     "(WORKDIR/journal/): no crash recovery, no "
                     "idempotent resubmission — bench baselines only")
    rte.add_argument("--journal-segment-mb", type=int, default=4,
                     metavar="MB",
                     help="journal segment rotation size; rotation "
                     "compacts the fully-terminal segment prefix so "
                     "replay cost stays bounded by the live working set")
    rte.add_argument("--decision-log", action="store_true",
                     help="record every dispatcher/autoscaler decision "
                     "to WORKDIR/decisions.jsonl — the capacity "
                     "planner's offline-replay source (soak/bench runs; "
                     "grows with traffic)")
    rte.add_argument("--fault-schedule", default=None, metavar="SPEC",
                     help="deterministic fault injection for soak runs "
                     "(router.forward / replica.health seams); "
                     "production routers leave this unset")

    lod = sub.add_parser(
        "load",
        help="load-generation rig: drive a running lt-route front door "
        "with a seeded deterministic trace — open- or closed-loop "
        "arrivals, heavy-tailed tenant mix, diurnal rate schedule — "
        "and report every request's pinned trace id",
    )
    lod.add_argument("--router-url", required=True, metavar="BASE",
                     help="front-door base URL of the running router "
                     "(http://127.0.0.1:PORT)")
    lod.add_argument("--stack-dir", required=True, metavar="DIR",
                     help="Landsat stack directory every submitted job "
                     "segments (lt synth writes one)")
    lod.add_argument("--tile-size", type=int, default=32,
                     help="tile size of the submitted jobs")
    lod.add_argument("--mode", default="closed",
                     choices=["open", "closed"],
                     help="arrival process: open (seeded Poisson "
                     "schedule, offered rate independent of "
                     "completions) or closed (submit → await terminal "
                     "→ think → repeat)")
    lod.add_argument("--duration-s", type=float, default=10.0,
                     metavar="SEC", help="run length")
    lod.add_argument("--qps", type=float, default=2.0, metavar="RATE",
                     help="open-loop mean offered rate, requests/s "
                     "(the diurnal wave modulates around it)")
    lod.add_argument("--requests", type=int, default=0, metavar="N",
                     help="total request budget; 0 = unbounded within "
                     "--duration-s")
    lod.add_argument("--workers", type=int, default=2, metavar="N",
                     help="closed-loop virtual clients / open-loop "
                     "dispatch width")
    lod.add_argument("--seed", type=int, default=0,
                     help="trace seed: the same seed+config "
                     "regenerates the same arrivals, tenants and "
                     "trace ids byte for byte")
    lod.add_argument("--tenants", type=int, default=3, metavar="N",
                     help="tenant population size (t0..tN-1)")
    lod.add_argument("--tenant-skew", type=float, default=1.0,
                     metavar="EXP",
                     help="heavy-tail exponent of the tenant mix "
                     "(weight of the k-th tenant is 1/k**EXP; 0 = "
                     "uniform)")
    lod.add_argument("--wave-amp", type=float, default=0.0,
                     metavar="AMP",
                     help="diurnal-wave amplitude in [0,1): rate is "
                     "qps*(1+AMP*sin(2*pi*t/period)); 0 = flat")
    lod.add_argument("--wave-period-s", type=float, default=60.0,
                     metavar="SEC", help="diurnal-wave period")
    lod.add_argument("--think-s", type=float, default=0.0, metavar="SEC",
                     help="closed-loop think time between a completion "
                     "and the next submission")
    lod.add_argument("--timeout-s", type=float, default=120.0,
                     metavar="SEC",
                     help="per-request patience: a job not terminal "
                     "after SEC counts failed")
    lod.add_argument("--out", default=None, metavar="PATH",
                     help="also write the full per-request outcome "
                     "report JSON here")

    tun = sub.add_parser(
        "tune",
        help="autotune the execution knobs: run short calibration probes "
        "(feed/decode/upload/fetch/dispatch groups) on --device, persist the "
        "winning profile to the on-disk tuning store keyed by (device kind, "
        "backend, scene shape class), and report it; a key already in the "
        "store reloads with ZERO probes",
    )
    tun.add_argument("--store-dir", default="lt_tune_store", metavar="DIR",
                     help="tuning-store directory the profile persists to / "
                     "reloads from (point runs at it via --tune-store-dir)")
    tun.add_argument("--shape", default="512,512,40", metavar="H,W,NY",
                     help="scene shape class to tune for (height, width, "
                     "years — bucketed coarsely, so a representative scene "
                     "stands in for the workload)")
    tun.add_argument("--groups", default=None, metavar="G1,G2,...",
                     help="probe only these knob groups (feed, decode, upload, "
                     "fetch, dispatch); unnamed groups keep their default knobs")
    tun.add_argument("--reps", type=int, default=3,
                     help="timing reps per candidate (median taken; a "
                     "clearly-losing candidate is cut off after one)")
    tun.add_argument("--smoke", action="store_true",
                     help="seconds-scale probe workloads")
    tun.add_argument("--retune", action="store_true",
                     help="probe even when the store already holds this key's "
                     "profile (and overwrite it)")
    tun.add_argument("--dry-run", action="store_true",
                     help="probe and report, write NOTHING to the store")
    tun.add_argument("--workdir", default=None, metavar="DIR",
                     help="also write tune telemetry (events.jsonl with "
                     "tune_probe/tune_profile, lt_tune_* metrics) under DIR")

    pix = sub.add_parser("pixel", help="segment one series (single-pixel "
                         "debug/parity path)")
    pix.add_argument("series", nargs="?", default=None,
                     help="JSON file with {years: [...], values: [...], "
                     "mask?: [...]}; '-' reads stdin; values use the index's "
                     "natural sign with --index, or are taken as-is "
                     "(disturbance-positive) without it.  Omit with "
                     "--from-stack.")
    pix.add_argument("--from-stack", default=None, metavar="DIR",
                     help="pull the series from a stack directory: --index at "
                     "pixel (--x, --y) with the standard QA + range masking")
    pix.add_argument("--x", type=int, default=None, help="column (with --from-stack)")
    pix.add_argument("--y", type=int, default=None, help="row (with --from-stack)")
    pix.add_argument("--scale", type=float, default=2.75e-5,
                     help="DN → reflectance scale for --from-stack (C2 default)")
    pix.add_argument("--offset", type=float, default=-0.2,
                     help="DN → reflectance offset for --from-stack (C2 default)")
    pix.add_argument("--engine", choices=("oracle", "torch", "both"), default="both",
                     help="'torch' is this package's float64 segmentation on "
                     "--device (the CUDA kernel on the card)")
    pix.add_argument("--index", default=None, choices=INDEX_NAMES,
                     help="flip sign per this index's disturbance convention; "
                     "with --from-stack it also selects the index (default nbr)")
    _add_param_flags(pix)

    chg = sub.add_parser(
        "change",
        help="derive change maps (yod/mag/dur/rate/preval/dsnr) from segment rasters",
    )
    chg.add_argument("seg_dir", help="out-dir of a finished `segment` run")
    chg.add_argument("--dest", default="lt_change", help="output directory")
    chg.add_argument("--index", default="nbr", choices=INDEX_NAMES,
                     help="index the segmentation ran on (sets the disturbance "
                     "direction)")
    _add_change_flags(chg)

    par = sub.add_parser("params", help="print default LTParams JSON")
    _add_param_flags(par)

    syn = sub.add_parser("synth", help="write a synthetic Landsat stack")
    syn.add_argument("out_dir")
    syn.add_argument("--size", type=int, default=256)
    syn.add_argument("--year-start", type=int, default=1984)
    syn.add_argument("--year-end", type=int, default=2023)
    syn.add_argument("--seed", type=int, default=20260729)

    inf = sub.add_parser("info", help="inspect rasters header-only: shape, dtype, "
                         "layout, compression, georeferencing, overview pages")
    inf.add_argument("paths", nargs="+", help="GeoTIFF file(s)")
    inf.add_argument("--window", default=None, metavar="Y0,X0,H,W",
                     help="also decode this window and report value stats")
    return p


#: value-carrying fields that flip with the index's disturbance sign — the
#: raster convention of the segment pipeline
_SIGNED_FIELDS = (
    "vertex_src_vals", "vertex_fit_vals", "seg_magnitude", "seg_rate",
    "fitted", "despiked",
)


def _result_to_dict(res, sign: float = 1.0) -> dict:
    """Oracle result / one-pixel SegOutputs → plain-JSON dict, with
    ``sign`` undoing the disturbance-positive flip (natural orientation)."""
    import numpy as np

    out = {}
    for name in (
        "n_vertices", "vertex_indices", "vertex_years", "vertex_src_vals",
        "vertex_fit_vals", "seg_magnitude", "seg_duration", "seg_rate",
        "rmse", "p_of_f", "model_valid", "fitted", "despiked",
    ):
        v = getattr(res, name)
        v = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
        if name in _SIGNED_FIELDS:
            v = sign * v
        out[name] = v.item() if v.ndim == 0 else v.tolist()
    out["model_valid"] = bool(out["model_valid"])
    out["n_vertices"] = int(out["n_vertices"])
    return out


def _pixel_from_stack(args: argparse.Namespace):
    """(years, natural-orientation series, mask, index) for one stack pixel,
    through the index and masking the tile program applies."""
    import numpy as np
    import torch

    from land_trendr_tpu_torch.ops import indices as idx
    from land_trendr_tpu_torch.runtime.stack import load_stack_dir

    if args.x is None or args.y is None:
        raise SystemExit("--from-stack needs --x and --y")
    index = (args.index or "nbr").lower()
    stack = load_stack_dir(args.from_stack, bands=idx.required_bands(index))
    h, w = stack.shape
    if not (0 <= args.y < h and 0 <= args.x < w):
        raise SystemExit(f"pixel ({args.x}, {args.y}) outside raster {w}x{h}")
    dn = {b: torch.from_numpy(np.ascontiguousarray(a[:, args.y, args.x]))
          for b, a in stack.dn_bands.items()}
    sr = {b: idx.scale_sr(v, args.scale, args.offset) for b, v in dn.items()}
    qa = torch.from_numpy(np.ascontiguousarray(stack.qa[:, args.y, args.x]))
    mask = (idx.qa_valid_mask(qa) & idx.sr_valid_mask(sr)).numpy()
    # natural orientation: _run_pixel applies the disturbance flip once
    series = idx.compute_index(index, sr, disturbance_positive=False).numpy()
    return stack.years, series.astype(np.float64), mask, index


def _run_pixel(args: argparse.Namespace) -> int:
    """Single-pixel debug path: one series through oracle and/or segmentation."""
    import numpy as np

    if (args.series is None) == (args.from_stack is None):
        raise SystemExit("pass exactly one of SERIES or --from-stack DIR")
    device = None
    if args.engine in ("torch", "both"):
        from land_trendr_tpu_torch.runtime.driver import resolve_device

        try:
            device = resolve_device(args.device)
        except (ValueError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
    if args.from_stack:
        years, values, mask, index = _pixel_from_stack(args)
        args.index = index
    else:
        if args.series == "-":
            payload = json.load(sys.stdin)
        else:
            with open(args.series) as f:
                payload = json.load(f)
        years = np.asarray(payload["years"], dtype=np.int32)
        values = np.asarray(payload["values"], dtype=np.float64)
        mask = (
            np.asarray(payload["mask"], dtype=bool)
            if "mask" in payload
            else np.isfinite(values)
        )
    if years.shape != values.shape or years.shape != mask.shape:
        raise SystemExit("years/values/mask must have identical lengths")
    sign = 1.0
    if args.index:
        from land_trendr_tpu_torch.ops.indices import DISTURBANCE_SIGN

        sign = DISTURBANCE_SIGN[args.index.lower()]
        values = sign * values
    params = _params_from_args(args)

    result: dict = {"params": params.to_dict()}
    if args.engine in ("oracle", "both"):
        from land_trendr_tpu_torch.models.oracle import PixelSegmenter

        result["oracle"] = _result_to_dict(
            PixelSegmenter(params).segment(years, values, mask), sign
        )
    if args.engine in ("torch", "both"):
        import torch

        from land_trendr_tpu_torch.ops.segment import SegOutputs
        from land_trendr_tpu_torch.ops.segment_cuda import cuda_segment_pixels

        out = cuda_segment_pixels(
            torch.from_numpy(years).to(device),
            torch.from_numpy(np.ascontiguousarray(values[None, :])).to(device),
            torch.from_numpy(np.ascontiguousarray(mask[None, :])).to(device),
            params,
        )
        result["torch"] = _result_to_dict(SegOutputs(*(f[0] for f in out)), sign)
        result["torch"]["dtype"] = str(out.fitted.dtype).replace("torch.", "")
        result["torch"]["device"] = str(device)
    if args.engine == "both":
        o, k = result["oracle"], result["torch"]
        result["parity"] = {
            "vertex_indices_equal": o["vertex_indices"] == k["vertex_indices"],
            "vertex_years_equal": o["vertex_years"] == k["vertex_years"],
            "model_valid_equal": o["model_valid"] == k["model_valid"],
            "max_abs_fitted_delta": float(
                np.max(np.abs(np.asarray(o["fitted"]) - np.asarray(k["fitted"])))
            ),
            "kernel_dtype": k["dtype"],
        }
    print(json.dumps(result, indent=2))
    return 0


def _run_info(args) -> int:
    """Header-only raster inspection; one JSON document for all paths."""
    import numpy as np

    from land_trendr_tpu_torch.io.geotiff import read_geotiff_info, read_geotiff_window

    win = None
    if args.window:
        try:
            y0, x0, h, w = (int(v) for v in args.window.split(","))
        except ValueError:
            print(f"--window {args.window!r} is not Y0,X0,H,W", file=sys.stderr)
            return 2
        win = (y0, x0, h, w)

    out = {}
    for path in args.paths:
        geo, info = read_geotiff_info(path)
        rec = {
            "height": info.height,
            "width": info.width,
            "bands": info.bands,
            "dtype": str(info.dtype),
            "layout": "tiled" if info.tiled else "strips",
            "compression": info.compression_name(),
            "bigtiff": info.big,
            # reduced-resolution pages behind the full-resolution one (the
            # one key the JAX package's info does not print)
            "overview_pages": info.overview_pages,
            "file_bytes": os.path.getsize(path),
            "geotransform": geo.geotransform(),
            "nodata": geo.nodata,
        }
        if win is not None:
            a = np.asarray(read_geotiff_window(path, *win), dtype=np.float64)
            finite = a[np.isfinite(a)]
            rec["window"] = {
                "y0_x0_h_w": list(win),
                "min": float(finite.min()) if finite.size else None,
                "max": float(finite.max()) if finite.size else None,
                "mean": float(finite.mean()) if finite.size else None,
                "finite_frac": round(float(finite.size / a.size), 6) if a.size else None,
            }
        out[path] = rec
    print(json.dumps(out, indent=2))
    return 0


def _run_tune(args) -> int:
    """``tune``: probe (or reload) on ``--device``, persist unless
    ``--dry-run``, report (the JAX package's report keys)."""
    import time

    from land_trendr_tpu_torch.runtime.driver import resolve_device
    from land_trendr_tpu_torch.tune import TuningStore, autotune

    try:
        h, w, ny = (int(v) for v in args.shape.split(","))
    except ValueError:
        print(f"error: --shape {args.shape!r} is not H,W,NY", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    groups = (
        tuple(g.strip() for g in args.groups.split(",") if g.strip())
        if args.groups else None
    )
    telemetry = None
    if args.workdir:
        from land_trendr_tpu_torch.obs import Telemetry

        telemetry = Telemetry(args.workdir, fingerprint="tune")
    t0 = time.perf_counter()
    status = "aborted"
    try:
        if telemetry is not None:
            # every stream scope opens with run_start: a tune scope is a
            # zero-tile run (impl "tune" names it)
            telemetry.run_start(
                fingerprint="tune", process_index=0, process_count=1,
                tiles_total=0, tiles_todo=0, tiles_skipped_resume=0,
                mesh_devices=1, impl="tune",
            )
        try:
            profile = autotune(
                args.store_dir,
                height=h, width=w, n_years=ny,
                device=device,
                groups=groups,
                reps=args.reps,
                smoke=args.smoke,
                retune=args.retune,
                persist=not args.dry_run,
                telemetry=telemetry,
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        status = "ok"
    finally:
        if telemetry is not None:
            wall = time.perf_counter() - t0
            try:
                telemetry.run_done(
                    status, tiles_done=0, pixels=0,
                    wall_s=round(wall, 3), px_per_s=0.0, fit_rate=0.0,
                )
            finally:
                telemetry.close()
    probed = profile["source"] == "probed"
    report = {
        "key": profile["key"],
        "source": profile["source"],
        "probes": profile["probes"] if probed else 0,
        "knobs": profile["knobs"],
        "groups": {
            g: {
                k: r[k]
                for k in ("ok", "probes", "default_s", "best_s", "speedup", "error", "knobs")
                if k in r
            }
            for g, r in profile.get("groups", {}).items()
        },
        "store_dir": args.store_dir,
        "persisted": not args.dry_run and probed,
    }
    if not args.dry_run and probed:
        report["profile_path"] = TuningStore(args.store_dir).path_for(profile["key"])
    print(json.dumps(report, indent=2))
    return 0


def main(argv: "list[str] | None" = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )

    if args.cmd == "params":
        print(_params_from_args(args).to_json())
        return 0

    if args.cmd == "pixel":
        return _run_pixel(args)

    if args.cmd == "info":
        return _run_info(args)

    if args.cmd == "tune":
        return _run_tune(args)

    if args.cmd == "serve":
        from land_trendr_tpu_torch.serve import SegmentationServer, ServeConfig

        try:
            scfg = ServeConfig(
                workdir=args.workdir,
                serve_port=args.serve_port,
                serve_host=args.serve_host,
                serve_queue_depth=args.serve_queue_depth,
                tenant_max_inflight=args.tenant_max_inflight,
                job_timeout_s=args.job_timeout_s,
                dropbox_dir=args.dropbox_dir,
                dropbox_poll_s=args.dropbox_poll_s,
                max_jobs=args.max_jobs,
                feed_cache_mb=args.feed_cache_mb,
                decode_workers=args.decode_workers,
                ingest_store_mb=args.ingest_store_mb,
                ingest_store_dir=args.ingest_store_dir,
                tune_store_dir=args.tune_store_dir,
                telemetry=not args.no_telemetry,
                metrics_port=args.metrics_port,
                metrics_host=args.metrics_host,
                metrics_interval_s=args.metrics_interval_s,
                fault_schedule=args.fault_schedule,
                debug_endpoints=not args.no_debug_endpoints,
                flight_ring_events=args.flight_ring_events,
                sampler_interval_s=args.sampler_interval_s,
                request_ring=args.request_ring,
                publish=args.publish,
                publish_interval_s=args.publish_interval_s,
                telemetry_dir=args.telemetry_dir,
                alert_rules=args.alert_rules,
                batch=(
                    "auto" if args.batch == "auto"
                    else args.batch == "on"
                ),
                batch_window_ms=args.batch_window_ms,
                batch_max_tiles=args.batch_max_tiles,
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        # probe the API port NOW (REUSEADDR-matched, like the
        # --metrics-port preflight): the real bind happens inside the
        # server constructor, where a busy port is a raw OSError
        if scfg.serve_port:
            import socket

            try:
                with socket.socket() as s:
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                    s.bind((scfg.serve_host, scfg.serve_port))
            except OSError as e:
                print(
                    f"error: --serve-port {scfg.serve_port} unusable: {e}",
                    file=sys.stderr,
                )
                return 2
        try:
            # the server owns its whole teardown: serve_forever's finally
            # runs _shutdown_shared on every exit path (Ctrl-C included)
            # and a failed constructor unwinds itself, so no stop() call
            # exists at this layer by design
            # lt: noqa[LT008]
            server = SegmentationServer(scfg, device=args.device)
        except (OSError, RuntimeError, ValueError) as e:
            print(f"error: server startup failed: {e}", file=sys.stderr)
            return 2
        # machine-readable startup line (the ephemeral-port contract):
        # clients read the bound port from here
        print(
            json.dumps(
                {"serving": True, "port": server.port,
                 "workdir": scfg.workdir}
            ),
            flush=True,
        )
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            # Ctrl-C is the documented way to stop an unbounded server:
            # drain state is already durable, exit clean
            pass
        return 0

    if args.cmd == "route":
        from land_trendr_tpu_torch.fleet import FleetRouter, RouterConfig

        try:
            rcfg = RouterConfig(
                workdir=args.workdir,
                route_port=args.route_port,
                route_host=args.route_host,
                replicas=tuple(args.replicas),
                spawn_replicas=args.spawn_replicas,
                replica_args=tuple(args.replica_args.split()),
                replica_inflight=args.replica_inflight,
                route_queue_depth=args.route_queue_depth,
                tenant_quota=args.tenant_quota,
                tenant_weights=args.tenant_weights,
                affinity=not args.no_affinity,
                route_retries=args.route_retries,
                health_interval_s=args.health_interval_s,
                unhealthy_after=args.unhealthy_after,
                autoscale=args.autoscale,
                min_replicas=args.min_replicas,
                max_replicas=args.max_replicas,
                scale_up_burn=args.scale_up_burn,
                scale_down_burn=args.scale_down_burn,
                scale_for_s=args.scale_for_s,
                scale_hold_s=args.scale_hold_s,
                telemetry=not args.no_telemetry,
                telemetry_dir=args.telemetry_dir,
                metrics_interval_s=args.metrics_interval_s,
                request_ring=args.request_ring,
                journal=not args.no_journal,
                journal_segment_mb=args.journal_segment_mb,
                decision_log=args.decision_log,
                fault_schedule=args.fault_schedule,
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        # probe the front-door port NOW (the serve-port preflight)
        if rcfg.route_port:
            import socket

            try:
                with socket.socket() as s:
                    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                    s.bind((rcfg.route_host, rcfg.route_port))
            except OSError as e:
                print(
                    f"error: --route-port {rcfg.route_port} unusable: {e}",
                    file=sys.stderr,
                )
                return 2
        try:
            # the router owns its whole teardown: serve_forever's
            # finally runs _shutdown on every exit path (Ctrl-C
            # included) and a failed constructor unwinds itself
            # lt: noqa[LT008]
            router = FleetRouter(rcfg)
        except (OSError, RuntimeError) as e:
            print(f"error: router startup failed: {e}", file=sys.stderr)
            return 2
        print(
            json.dumps(
                {"routing": True, "port": router.port,
                 "workdir": rcfg.workdir,
                 "replicas": len(router.pool)}
            ),
            flush=True,
        )
        # SIGTERM (the orchestrator's stop signal) drains exactly like
        # Ctrl-C: serve_forever's finally runs _shutdown, which writes
        # the journal's clean marker after a full drain — a SIGTERM'd
        # router restarts without reconciliation probes
        import signal as _signal

        _signal.signal(_signal.SIGTERM, _sigterm_to_interrupt)
        try:
            router.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0

    if args.cmd == "load":
        from land_trendr_tpu_torch.loadgen import (
            HttpClient,
            LoadConfig,
            LoadRunner,
        )
        from land_trendr_tpu_torch.loadgen.trace import SHAPE_PARAMS

        try:
            lcfg = LoadConfig(
                mode=args.mode,
                duration_s=args.duration_s,
                qps=args.qps,
                requests=args.requests,
                workers=args.workers,
                seed=args.seed,
                tenants=args.tenants,
                tenant_skew=args.tenant_skew,
                wave_amp=args.wave_amp,
                wave_period_s=args.wave_period_s,
                think_s=args.think_s,
                timeout_s=args.timeout_s,
            )
        except ValueError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2

        def _load_payload(req) -> dict:
            return {
                "stack_dir": args.stack_dir,
                "tile_size": args.tile_size,
                "tenant": req.tenant,
                "params": dict(SHAPE_PARAMS[req.shape]),
                "trace_id": req.trace_id,
                "run_overrides": {"retry_backoff_s": 0.0},
            }

        runner = LoadRunner(
            lcfg, HttpClient(args.router_url), _load_payload
        )
        report = runner.run(phase="load")
        summary = {
            "mode": report.mode,
            "offered": report.offered,
            "done": report.done,
            "failed": report.failed,
            "rejected": report.rejected,
            "wall_s": round(report.wall_s, 3),
            "trace_ids": report.trace_ids,
        }
        if args.out:
            payload = {
                **summary,
                "outcomes": [
                    {
                        "trace_id": o.trace_id,
                        "tenant": o.tenant,
                        "shape": o.shape,
                        "outcome": o.outcome,
                        "reason": o.reason,
                        "latency_s": o.latency_s,
                    }
                    for o in report.outcomes
                ],
            }
            # tmp + os.replace: a SIGKILL mid-dump must not tear the
            # report an operator's tooling then reads
            tmp = args.out + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=2)
            os.replace(tmp, args.out)
        print(json.dumps(summary))
        return 0 if report.failed == 0 else 1

    if args.cmd == "synth":
        from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack

        spec = SceneSpec(
            width=args.size, height=args.size,
            year_start=args.year_start, year_end=args.year_end, seed=args.seed,
        )
        paths = write_stack(args.out_dir, make_stack(spec))
        print(json.dumps({"files": len(paths), "out_dir": args.out_dir}))
        return 0

    if args.cmd == "change":
        from land_trendr_tpu_torch.ops.change import write_change_maps
        from land_trendr_tpu_torch.runtime.driver import resolve_device

        try:
            device = resolve_device(args.device)
        except (ValueError, RuntimeError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        paths = write_change_maps(
            args.seg_dir, args.dest, index=args.index, filt=_change_filter_from_args(args),
            mmu=args.mmu, device=device,
        )
        print(json.dumps({"outputs": paths}, indent=2))
        return 0

    # segment — deferred imports keep --help fast
    from land_trendr_tpu_torch.ops.change import ChangeFilter, sieve_change_rasters
    from land_trendr_tpu_torch.ops.indices import required_bands
    from land_trendr_tpu_torch.runtime.driver import (
        Run,
        RunConfig,
        StallError,
        TileRetriesExhausted,
        assemble_outputs,
        resolve_device,
    )
    from land_trendr_tpu_torch.runtime.stack import load_stack_dir, open_stack_dir_c2_lazy

    for flag in ("fetch", "upload"):
        if getattr(args, f"no_packed_{flag}") and getattr(args, f"packed_{flag}"):
            print(f"error: --packed-{flag} conflicts with --no-packed-{flag}",
                  file=sys.stderr)
            return 2
    ftv = tuple(x.strip() for x in args.ftv.split(",") if x.strip())
    ensemble = tuple(x.strip() for x in args.ensemble.split(",") if x.strip())
    change_filt = _change_filter_from_args(args, prefix="change_")
    if not args.change:
        if change_filt != ChangeFilter() or args.change_mmu != 1:
            print("error: --change-* options require --change (without it no "
                  "change rasters are produced)", file=sys.stderr)
            return 2
        change_filt = None
    if args.lazy and args.composite is not None:
        print("error: --lazy cannot composite (one acquisition per year); "
              "pre-composite or drop --lazy", file=sys.stderr)
        return 2
    try:
        device = resolve_device(args.device)
        cfg = RunConfig(
            index=args.index,
            ftv_indices=ftv,
            ensemble_indices=ensemble,
            params=_params_from_args(args),
            tile_size=args.tile_size,
            workdir=args.workdir,
            out_dir=args.out_dir,
            resume=not args.no_resume,
            max_retries=args.max_retries,
            retry_backoff_s=args.retry_backoff_s,
            quarantine_tiles=args.quarantine_tiles,
            stall_timeout_s=args.stall_timeout_s,
            merge_timeout_s=args.merge_timeout_s,
            straggler_k=args.straggler_k,
            straggler_min_tiles=args.straggler_min_tiles,
            lease_batch=args.lease_batch,
            lease_ttl_s=args.lease_ttl_s,
            speculate=args.speculate,
            fault_schedule=args.fault_schedule,
            write_fitted=args.write_fitted,
            fetch_f16=args.fetch_f16,
            change_filt=change_filt,
            products=(
                tuple(x.strip() for x in args.products.split(","))
                if args.products else None
            ),
            fetch_packed=(
                False if args.no_packed_fetch else True if args.packed_fetch else "auto"
            ),
            fetch_depth=args.fetch_depth,
            upload_packed=(
                False if args.no_packed_upload else True if args.packed_upload else "auto"
            ),
            upload_depth=args.upload_depth,
            ingest_store_mb=args.ingest_store_mb,
            ingest_store_dir=args.ingest_store_dir,
            scale=args.scale,
            offset=args.offset,
            reject_bits=args.reject_bits,
            out_compress=args.out_compress,
            manifest_compress=args.manifest_compress,
            write_workers=args.write_workers,
            feed_workers=args.feed_workers,
            feed_cache_mb=args.feed_cache_mb,
            decode_workers=args.decode_workers,
            feed_readahead=not args.no_feed_readahead,
            out_overviews=args.out_overviews,
            chunk_px=args.chunk_px,
            telemetry=args.telemetry,
            metrics_port=args.metrics_port,
            metrics_host=args.metrics_host,
            metrics_interval_s=args.metrics_interval_s,
            flight=args.flight,
            flight_ring_events=args.flight_ring_events,
            sampler_interval_s=args.sampler_interval_s,
            publish=args.publish,
            publish_interval_s=args.publish_interval_s,
            telemetry_dir=args.telemetry_dir,
            tune_store_dir=args.tune_store_dir,
        )
        mesh = None
        if args.mesh:
            from land_trendr_tpu_torch.parallel import make_mesh

            # every local CUDA device; raises without one (no CPU fallback)
            mesh = make_mesh()
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if cfg.metrics_port is not None:
        # probe the scrape port now: the real bind happens deep in the run
        import socket

        try:
            with socket.socket() as sk:
                sk.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                sk.bind((cfg.metrics_host, cfg.metrics_port))
        except OSError as e:
            print(f"error: --metrics-port {cfg.metrics_port} unusable: {e}",
                  file=sys.stderr)
            return 2
    bands = required_bands(args.index, (*ftv, *ensemble))
    try:
        if args.lazy:
            stack = open_stack_dir_c2_lazy(args.stack_dir, bands=bands)
        else:
            stack = load_stack_dir(
                args.stack_dir,
                bands=bands,
                composite=args.composite,
                reject_bits=cfg.reject_bits,
                scale=cfg.scale,
                offset=cfg.offset,
                device=device,
            )
        # an explicit Run: its RESOLVED config ("auto" knobs read from the
        # tuning store once, at construction) is what assembly reuses
        run = Run(stack, cfg, device=device, mesh=mesh)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        if args.trace:
            from land_trendr_tpu_torch.utils.profiling import trace

            with trace(args.trace):
                summary = run.execute()
        else:
            summary = run.execute()
    except StallError as e:
        print(f"error: {e}", file=sys.stderr)
        return 4
    except TileRetriesExhausted as e:
        print(f"error: {e} (re-run to resume from the manifest)", file=sys.stderr)
        return 3
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if summary.get("tiles_quarantined"):
        print(json.dumps({"summary": summary, "outputs": None}, indent=2))
        print(
            f"error: {len(summary['tiles_quarantined'])} tile(s) quarantined "
            "after exhausting retries; outputs NOT assembled (re-run to "
            "resume the quarantined tiles)",
            file=sys.stderr,
        )
        return 3
    paths = assemble_outputs(stack, run.cfg, device=device)
    if change_filt is not None and args.change_mmu > 1:
        sieve_change_rasters(cfg.out_dir, args.change_mmu)
    print(json.dumps({"summary": summary, "outputs": paths}, indent=2))
    return 0


def run() -> int:
    """Console entry; exits quietly when stdout is a closed pipe."""
    try:
        return main()
    except BrokenPipeError:
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(run())
