"""Serve-mode cold-against-warm bench: the headline number of service mode.

Counterpart of the JAX package's ``tools/serve_bench.py``.  It starts a
real :class:`~land_trendr_tpu_torch.serve.server.SegmentationServer` on
``--device`` (loopback HTTP, shared ingest store, RAM cache tier OFF so
every demand read consults the store), submits the SAME lazy-ingest job
twice over the API, and measures client-side latency submit → terminal:

* the **cold** job pays the kernel library's load (built from
  ``csrc/segment_fused.cu`` when ``_build/`` has none) and the program
  cache's miss (one warm-up launch through the upload → dispatch → fetch
  chain), and TIFF decode (the store ingests every block it decodes);
* the **warm** job must run **zero kernel builds or loads and zero
  program-cache misses** (the counterpart of the JAX package's "zero jit
  compiles") and **zero TIFF decodes** (every block served from the
  ingest store): the structural invariants the port's perf gate checks.

Artifacts are digest-compared across the two job workdirs (warm ≡ cold,
byte-identical), and on the card the kernel launches of each job are
reported (cold = tiles + 1, warm = tiles).

Usage::

    python -m land_trendr_tpu_torch.tools.serve_bench [--smoke] [--out SERVE.json]
        [--size PX --years N --tile PX] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

from land_trendr_tpu_torch.ops import segment_cuda
from land_trendr_tpu_torch.runtime.driver import resolve_device
from land_trendr_tpu_torch.tools.measure import digest_workdir, record_meta, write_json_atomic

__all__ = ["main", "run_bench"]


def _post(port: int, path: str, payload: dict) -> "tuple[int, dict]":
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port: int, path: str) -> dict:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def _await_terminal(server, job_id: str, timeout_s: float) -> dict:
    """Poll over HTTP; fall back to the in-process job table once the
    bounded server has closed its socket after the last job."""
    from land_trendr_tpu_torch.serve import TERMINAL_STATES

    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        try:
            snap = _get(server.port, f"/jobs/{job_id}")
        except (urllib.error.URLError, ConnectionError, OSError):
            snap = server.job_status(job_id)
        if snap is not None and snap["state"] in TERMINAL_STATES:
            return snap
        time.sleep(0.05)
    raise TimeoutError(f"job {job_id} not terminal within {timeout_s}s")


def _counters() -> dict:
    """The kernel library's loads (``_built`` runs once a process: a build
    or a reuse of ``_build/``) and the kernels' launch counts."""
    return {"library_loads": segment_cuda._built.cache_info().misses,
            **segment_cuda.launch_counts()}


def run_bench(size: int, years: int, tile: int, root: str, device: str = "cuda") -> dict:
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack_c2
    from land_trendr_tpu_torch.serve import SegmentationServer, ServeConfig

    stack_dir = str(Path(root) / "stack")
    write_stack_c2(stack_dir, make_stack(SceneSpec(
        width=size, height=size, year_start=2000, year_end=2000 + years - 1, seed=11)))
    cfg = ServeConfig(
        workdir=str(Path(root) / "serve"),
        serve_port=0,
        max_jobs=2,
        # RAM tier OFF: every demand read consults the persistent store, so
        # the warm leg's zero-decode claim is structural
        feed_cache_mb=0,
        ingest_store_mb=256,
    )
    server = SegmentationServer(cfg, device=device)
    request = {"stack_dir": stack_dir, "tile_size": tile, "lazy": True,
               "params": {"max_segments": 4, "vertex_count_overshoot": 2}}
    legs: dict = {}
    errors: list = []

    def drive() -> None:
        try:
            for leg in ("cold", "warm"):
                before = _counters()
                t0 = time.perf_counter()
                status, snap = _post(server.port, "/jobs", request)
                if status != 200:
                    raise RuntimeError(f"submission failed ({status}): {snap}")
                snap = _await_terminal(server, snap["job_id"], 600.0)
                latency = time.perf_counter() - t0
                if snap["state"] != "done":
                    raise RuntimeError(f"job {snap['job_id']} ended {snap['state']}: "
                                       f"{snap.get('error')}")
                after = _counters()
                legs[leg] = {"snap": snap, "latency_s": latency,
                             "counters": {k: after[k] - before[k] for k in after}}
        except Exception as e:  # surfaces in the report, fails the bench
            errors.append(f"{type(e).__name__}: {e}")
            server.stop()

    t = threading.Thread(target=drive, name="serve-bench-client")
    t.start()
    server.serve_forever()  # drains both jobs, then shuts down
    t.join(timeout=30)
    if errors:
        raise RuntimeError(f"bench client failed: {errors[0]}")

    def leg_report(leg: str) -> dict:
        snap = legs[leg]["snap"]
        summary = snap["summary"]
        c = legs[leg]["counters"]
        return {
            "latency_s": round(legs[leg]["latency_s"], 4),
            "job_wall_s": round(snap["finished_t"] - snap["submitted_t"], 4),
            "run_wall_s": summary["wall_s"],
            "program_cache": summary["program_cache"],
            "ingest_store": summary.get("ingest_store"),
            "library_loads": c["library_loads"],
            "launches": c["LAUNCHES"] + c["WIDE_LAUNCHES"] + c["GLOBAL_LAUNCHES"],
        }

    cold, warm = leg_report("cold"), leg_report("warm")
    d_cold = digest_workdir(legs["cold"]["snap"]["workdir"])
    parity_ok = bool(d_cold) and d_cold == digest_workdir(legs["warm"]["snap"]["workdir"])
    warm_store = warm["ingest_store"] or {}
    tiles = ((size + tile - 1) // tile) ** 2
    invariants = {
        "warm_zero_compiles": warm["program_cache"]["misses"] == 0
        and warm["library_loads"] == 0,
        "warm_zero_decodes": warm_store.get("misses", -1) == 0 and warm_store.get("hits", 0) > 0,
        "cold_compiled": cold["program_cache"]["misses"] == 1,
    }
    if device == "cuda":
        # a miss pays one warm-up launch; a hit launches once a tile
        invariants["launch_arithmetic"] = (cold["launches"] == tiles + 1
                                           and warm["launches"] == tiles)
    return {
        "workload": {"scene_px": size * size, "years": years, "tile_size": tile,
                     "tiles": tiles, "lazy": True, "ingest_store_mb": cfg.ingest_store_mb,
                     "feed_cache_mb": cfg.feed_cache_mb},
        "cold": cold,
        "warm": warm,
        "speedup_warm": round(cold["latency_s"] / warm["latency_s"], 2)
        if warm["latency_s"] else None,
        "invariants": invariants,
        "parity_ok": parity_ok,
    }


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="seconds-scale mode (tiny scene)")
    ap.add_argument("--size", type=int, default=None,
                    help="scene edge px (default: 64 smoke / 1024 full)")
    ap.add_argument("--years", type=int, default=None,
                    help="stack years (default: 7 smoke / 40 full)")
    ap.add_argument("--tile", type=int, default=None,
                    help="tile size (default: 32 smoke / 512 full)")
    ap.add_argument("--keep", default=None, metavar="DIR", help="keep the workdirs under DIR")
    ap.add_argument("--out", default=None, metavar="FILE", help="write the JSON report here")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    args = ap.parse_args(argv)
    try:
        device = resolve_device(args.device).type
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    size = args.size or (64 if args.smoke else 1024)
    years = args.years or (7 if args.smoke else 40)
    tile = args.tile or (32 if args.smoke else 512)
    root = args.keep or tempfile.mkdtemp(prefix="lt_serve_bench_")
    Path(root).mkdir(parents=True, exist_ok=True)
    try:
        report = run_bench(size, years, tile, root, device=device)
    finally:
        if args.keep is None:
            shutil.rmtree(root, ignore_errors=True)
    report = {**record_meta("land_trendr_tpu_torch.tools.serve_bench", argv, device), **report}
    report["smoke"] = bool(args.smoke)
    report["ok"] = report["parity_ok"] and all(report["invariants"].values())
    if args.out:
        write_json_atomic(args.out, report, trailing_newline=False)
        print(f"wrote {args.out}")
    print(json.dumps({"ok": report["ok"], "cold_s": report["cold"]["latency_s"],
                      "warm_s": report["warm"]["latency_s"],
                      "speedup_warm": report["speedup_warm"],
                      "invariants": report["invariants"], "parity_ok": report["parity_ok"]}))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
