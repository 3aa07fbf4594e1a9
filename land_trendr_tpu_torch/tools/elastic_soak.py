"""Elastic pod-scheduling soak: churn (SIGKILL + late join) and slow-host legs.

Counterpart of the JAX package's ``tools/elastic_soak.py``, the acceptance
gate of the shared-manifest lease queue
(:mod:`land_trendr_tpu_torch.runtime.leases`), in two legs:

* **churn** — independent worker processes (``tools/elastic_worker.py``)
  share one workdir through the lease queue alone (no process group).
  The victim is SIGKILLed mid-run while holding leases; a second worker
  runs start to finish; a third joins late, after the run is under way
  (it starts with the others and waits, warm, at a gate the soak opens).
  The run completes **without any resume**: survivors steal the victim's
  expired leases, every tile lands durably exactly once, and the
  artifacts are byte-identical to a clean single-host run.
* **slow-host** — a real two-process pod (``gloo`` through
  :func:`~land_trendr_tpu_torch.parallel.multihost.init_distributed`; both
  processes on the one card) with an injected slow host (``slow`` faults
  on its compute waits, which the driver polls, including one long park),
  run twice: static ``host_share`` split against the elastic lease queue
  with speculation (the JAX soak's 120² scene at tile 20 on the CPU, 896²
  at tile 128 on the card: :data:`SLOW_SCENE`).
  :func:`~land_trendr_tpu_torch.obs.spans.assemble_pod_trace` proves the
  collapse: the pod's idle gap and ``host_imbalance`` both drop, and at
  least one speculation wins (the first durable done record belongs to
  the speculating host).

Every worker runs on ``--device`` (the card by default).  Full mode
writes the report::

    python -m land_trendr_tpu_torch.tools.elastic_soak --out ELASTIC.json
    python -m land_trendr_tpu_torch.tools.elastic_soak --smoke [--device cpu]

The pod processes are this module re-run with ``--pod-worker``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from land_trendr_tpu_torch.tools.measure import digest_workdir, write_json_atomic

__all__ = ["SLOW_SCENE", "SLOW_SCHEDULE", "churn_leg", "main", "slow_host_leg", "soak"]

#: the repository root (the workers' PYTHONPATH)
REPO = Path(__file__).resolve().parents[2]


def _manifest_records(workdir: str) -> list:
    out = []
    with open(os.path.join(workdir, "manifest.jsonl")) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def _lease_audit(workdir: str) -> dict:
    """Post-hoc audit of a run's lease log: done coverage, duplicate done
    records, steal/spec claims, and speculative wins (the first done
    record's owner is the spec claimer)."""
    first_done: dict = {}
    done_counts: dict = {}
    steals: list = []
    specs: dict = {}
    for rec in _manifest_records(workdir):
        kind = rec.get("kind")
        if kind == "tile":
            tid = rec.get("tile_id")
            done_counts[tid] = done_counts.get(tid, 0) + 1
            first_done.setdefault(tid, rec.get("owner"))
        elif kind == "lease":
            if rec.get("mode") == "steal":
                steals.append((rec.get("tile_id"), rec.get("owner")))
            elif rec.get("mode") == "spec":
                specs[rec.get("tile_id")] = rec.get("owner")
    return {
        "tiles_done": len(done_counts),
        "duplicate_done_records": sum(v - 1 for v in done_counts.values() if v > 1),
        "steals": len(steals),
        "speculations": len(specs),
        "spec_wins": sum(1 for tid, owner in specs.items() if first_done.get(tid) == owner),
        "done_owners": sorted({o for o in first_done.values() if o is not None}),
    }


def torch_device_type(device: str) -> str:
    """``cuda``/``cuda:N``/``cpu`` → ``cuda`` or ``cpu``."""
    return device.split(":", 1)[0]


def _worker_env(device: str) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    if torch_device_type(device) == "cpu":
        # several workers share the host's cores: one intra-op thread each
        # keeps a tile's time steady (the legs' verdicts are timing-driven)
        env.setdefault("OMP_NUM_THREADS", "1")
    return env


def _spawn_worker(cfg_path: str) -> subprocess.Popen:
    device = json.loads(Path(cfg_path).read_text())["device"]
    return subprocess.Popen(
        [sys.executable, "-m", "land_trendr_tpu_torch.tools.elastic_worker", cfg_path],
        env=_worker_env(device), cwd=str(REPO),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    )


def _write_worker_cfg(
    path: Path, workdir: str, size: int, tile: int, run_kw: dict, device: str,
    summary_path: "str | None" = None, height: "int | None" = None, years: int = 24,
    seed: int = 11, year_start: int = 1990, start_when: "str | None" = None,
) -> str:
    """Write one ``elastic_worker`` config (shared with ``fault_soak``'s
    lease-kill case — one copy of the worker contract)."""
    cfg = {
        "workdir": workdir,
        "out_dir": workdir + "_o",
        "width": size,
        "height": size if height is None else height,
        "tile_size": tile,
        "seed": seed,
        "years": years,
        "year_start": year_start,
        "device": device,
        "summary_path": summary_path,
        "start_when": start_when,
        "run": run_kw,
    }
    path.write_text(json.dumps(cfg))
    return str(path)


def churn_leg(root: Path, size: int = 80, tile: int = 20, device: str = "cuda",
              verbose: bool = True) -> dict:
    """SIGKILL one host mid-lease, join one host late; no resume."""
    root.mkdir(parents=True, exist_ok=True)
    n_tiles = ((size + tile - 1) // tile) ** 2
    ttl = 1.0

    # clean single-host elastic reference (also proves 1-host lease mode)
    clean_wd = str(root / "churn_clean")
    p = _spawn_worker(_write_worker_cfg(
        root / "churn_clean.json", clean_wd, size, tile,
        {"lease_batch": 2, "lease_ttl_s": ttl}, device,
    ))
    _, err = p.communicate(timeout=600)
    if p.returncode != 0:
        raise RuntimeError(f"clean elastic run failed:\n{err[-4000:]}")
    clean = digest_workdir(clean_wd)

    wd = str(root / "churn_pod")
    # victim A: slow per tile so it is mid-run (holding leases) when
    # killed; batch 2 so it dies holding more than its in-flight tile
    a_cfg = _write_worker_cfg(
        root / "churn_a.json", wd, size, tile,
        {"lease_batch": 2, "lease_ttl_s": ttl,
         "fault_schedule": "seed=5,compute.wait%1.0=slow:0.3"}, device,
    )
    # modestly slow so real work remains when the late joiner's cold
    # start completes — C must get to claim tiles
    b_cfg = _write_worker_cfg(
        root / "churn_b.json", wd, size, tile,
        {"lease_batch": 2, "lease_ttl_s": ttl,
         "fault_schedule": "seed=6,compute.wait%1.0=slow:0.4"}, device,
        summary_path=str(root / "churn_b_summary.json"),
    )
    # C starts with the others but waits at its gate, warm, until the run
    # is under way: on the card a cold start (~8 s) outlasts the run
    gate = root / "churn_c.go"
    c_cfg = _write_worker_cfg(
        root / "churn_c.json", wd, size, tile,
        {"lease_batch": 2, "lease_ttl_s": ttl}, device,
        summary_path=str(root / "churn_c_summary.json"), start_when=str(gate),
    )
    a = _spawn_worker(a_cfg)
    b = _spawn_worker(b_cfg)
    c = _spawn_worker(c_cfg)
    try:
        def _done_records() -> int:
            try:
                return sum(1 for r in _manifest_records(wd) if r.get("kind") == "tile")
            except OSError:
                return 0

        def _a_holds_lease() -> bool:
            try:
                recs = _manifest_records(wd)
            except OSError:
                return False
            return any(
                r.get("kind") == "lease" and isinstance(r.get("owner"), str)
                and f":{a.pid}:" in r["owner"]
                for r in recs
            )

        # kill A once it demonstrably holds leases and the run is clearly
        # mid-flight — a kill at the starting line would not prove
        # steal-on-death
        deadline = time.monotonic() + 300
        while time.monotonic() < deadline:
            if a.poll() is not None:
                raise RuntimeError(
                    f"victim worker exited before the kill (rc={a.returncode}): "
                    f"{a.stderr.read()[-2000:]}"
                )
            if _done_records() >= 2 and _a_holds_lease():
                break
            time.sleep(0.05)
        else:
            raise RuntimeError("victim never claimed a lease mid-run")
        os.kill(a.pid, signal.SIGKILL)
        a.communicate()
        t_kill = time.time()

        # late joiner C: enters once the run is demonstrably under way
        while _done_records() < 1:
            if b.poll() is not None:
                break
            time.sleep(0.05)
        gate.write_text("go")
        _, err_b = b.communicate(timeout=600)
        _, err_c = c.communicate(timeout=600)
    finally:
        for q in (a, b, c):
            if q.poll() is None:
                q.kill()
                q.communicate()
    if b.returncode != 0:
        raise RuntimeError(f"survivor worker failed:\n{err_b[-4000:]}")
    if c.returncode != 0:
        raise RuntimeError(f"late joiner failed:\n{err_c[-4000:]}")

    if digest_workdir(wd) != clean:
        raise AssertionError(
            "churn artifacts differ from the clean run (kill/steal/late-join changed bytes)"
        )
    audit = _lease_audit(wd)
    artifacts = len(list(Path(wd).glob("tile_*.npz")))
    if artifacts != n_tiles or audit["tiles_done"] != n_tiles:
        raise AssertionError(
            f"lost tiles: {artifacts} artifacts / {audit['tiles_done']} done ids of {n_tiles}"
        )
    if audit["steals"] < 1:
        raise AssertionError(
            "no lease was stolen — the victim's death left nothing to steal "
            "(kill timing regression?)"
        )
    # the late joiner must have contributed durable work (any done record
    # of its own — under a tight TTL it may lose first-write races on
    # stolen tiles and still be a real participant)
    c_tiles = sum(
        1 for r in _manifest_records(wd)
        if r.get("kind") == "tile" and isinstance(r.get("owner"), str)
        and f":{c.pid}:" in r["owner"]
    )
    if c_tiles < 1:
        raise AssertionError("late joiner completed no tiles")
    summaries = [json.loads(Path(root / f"churn_{w}_summary.json").read_text())
                 for w in ("b", "c")]
    leg = {
        "tiles": n_tiles,
        "victim_killed_at": t_kill,
        "artifacts": artifacts,
        "artifacts_identical": True,
        "completed_without_resume": True,
        **{k: v for k, v in audit.items() if k != "done_owners"},
        "late_joiner_tiles": c_tiles,
        "survivor_launches": [s.get("launches") for s in summaries],
    }
    if verbose:
        print(f"  ok: churn leg ({json.dumps(leg, default=str)})")
    return leg


#: the injected slow host's schedule: most compute waits +0.2s, with a
#: 2.5s park on invocations 3-4 — the flagged stragglers speculation
#: must rescue.  The park spec comes first (the plan picks the first
#: matching spec per invocation).
SLOW_SCHEDULE = "seed=3,compute.wait@3*2=slow:2.5,compute.wait%0.9=slow:0.2"


def _launch_pod(cfgs: "list[str]", timeout: float, attempts: int = 3) -> None:
    """Run one ``--pod-worker`` process per config against a coordinator on
    a free localhost port; a lost port race retries on a fresh port."""
    for attempt in range(attempts):
        for c in cfgs:
            shutil.rmtree(json.loads(Path(c).read_text())["workdir"], ignore_errors=True)
        device = json.loads(Path(cfgs[0]).read_text())["device"]
        with socket.socket() as sk:
            sk.bind(("localhost", 0))
            coordinator = f"localhost:{sk.getsockname()[1]}"
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "land_trendr_tpu_torch.tools.elastic_soak",
                 "--pod-worker", coordinator, str(len(cfgs)), str(i), c],
                env=_worker_env(device), cwd=str(REPO),
                stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            )
            for i, c in enumerate(cfgs)
        ]
        errs = []
        try:
            for p in procs:
                _, err = p.communicate(timeout=timeout)
                errs.append((p.returncode, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        bad = [(rc, err) for rc, err in errs if rc != 0]
        if not bad:
            return
        text = "\n".join(err[-3000:] for _rc, err in bad)
        if "address already in use" not in text.lower() or attempt == attempts - 1:
            raise RuntimeError(f"pod worker failed:\n{text}")


def pod_worker(argv: "list[str]") -> int:
    """One process of the slow-host pod: join the ``gloo`` group, run its
    share of the synthetic scene over the shared workdir, write its
    summary."""
    coordinator, world, rank, cfg_path = argv
    with open(cfg_path) as f:
        cfg_json = json.load(f)
    import torch.distributed as dist

    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.ops import segment_cuda
    from land_trendr_tpu_torch.parallel import init_distributed
    from land_trendr_tpu_torch.runtime import RunConfig, run_stack
    from land_trendr_tpu_torch.tools.elastic_worker import DEFAULT_PARAMS, scene_of

    init_distributed(coordinator, int(world), int(rank), timeout_s=120.0)
    cfg = RunConfig(
        params=LTParams.from_dict(DEFAULT_PARAMS),
        tile_size=int(cfg_json["tile_size"]),
        workdir=cfg_json["workdir"],
        out_dir=cfg_json["out_dir"],
        telemetry=True,
        **cfg_json.get("run", {}),
    )
    launches0 = segment_cuda.LAUNCHES
    summary = run_stack(scene_of(cfg_json), cfg, device=cfg_json["device"])
    summary["launches"] = segment_cuda.LAUNCHES - launches0
    write_json_atomic(cfg_json["summary_path"], summary, indent=None, trailing_newline=False)
    dist.destroy_process_group()
    return 0


#: the slow-host leg's scene per device, (edge px, tile): the JAX soak's
#: 120 / 20 (36 tiles) on the CPU; on the card 896 / 128 (49 tiles), whose
#: tiles take the card about as long as the JAX scene's take a CPU worker
#: (~40 ms), so the slow host reaches its parks before the fast one has
#: claimed every tile (at 400 px a tile the fast host clears the scene
#: first and nothing is left to speculate)
SLOW_SCENE = {"cpu": (120, 20), "cuda": (896, 128)}


def slow_host_leg(root: Path, size: "int | None" = None, tile: "int | None" = None,
                  device: str = "cuda", verbose: bool = True) -> dict:
    """Static split against the elastic lease queue under one injected
    slow host (a two-process pod), proven with the pod trace."""
    from land_trendr_tpu_torch.obs.events import discover_event_files
    from land_trendr_tpu_torch.obs.spans import assemble_pod_trace

    root.mkdir(parents=True, exist_ok=True)
    d_size, d_tile = SLOW_SCENE[torch_device_type(device)]
    size, tile = size or d_size, tile or d_tile
    n_tiles = ((size + tile - 1) // tile) ** 2
    results: dict = {"scene": {"size": size, "tile": tile, "tiles": n_tiles}}
    for mode in ("static", "elastic"):
        wd = str(root / f"slow_{mode}")
        common = {"retry_backoff_s": 0.0, "straggler_k": 2.0, "straggler_min_tiles": 3}
        if mode == "elastic":
            common.update(
                lease_batch=1,
                lease_ttl_s=20.0,
                speculate=True,
                # the sampler thread is the in-flight straggler scanner —
                # the verdict must fire while the slow host is parked
                flight=True,
                sampler_interval_s=0.1,
            )
        cfgs, summaries = [], []
        for i in range(2):
            ov = dict(common)
            if i == 1:
                ov["fault_schedule"] = SLOW_SCHEDULE
            summaries.append(str(root / f"slow_{mode}_s{i}.json"))
            cfgs.append(_write_worker_cfg(root / f"slow_{mode}_{i}.json", wd, size, tile,
                                          ov, device, summary_path=summaries[i]))
        _launch_pod(cfgs, timeout=900.0)
        trace = assemble_pod_trace(discover_event_files(wd, process_count=2))
        pod_wall = trace["pod"]["wall_s"] or 0.0
        idle_gap = sum(max(pod_wall - (h.get("busy_s") or 0.0), 0.0) for h in trace["hosts"])
        audit = _lease_audit(wd)
        per = [json.loads(Path(s).read_text()) for s in summaries]
        results[mode] = {
            "pod_wall_s": round(pod_wall, 3),
            "host_walls_s": [h.get("wall_s") for h in trace["hosts"]],
            "busy_s": [h.get("busy_s") for h in trace["hosts"]],
            "idle_gap_pod_s": round(idle_gap, 3),
            "host_imbalance": trace["pod"].get("host_imbalance"),
            "stragglers": trace["pod"].get("stragglers"),
            "tiles_stolen": trace["pod"].get("tiles_stolen"),
            "tiles_speculated": trace["pod"].get("tiles_speculated"),
            "tiles_done_per_host": [h.get("tiles_done") for h in trace["hosts"]],
            "spec_wins": audit["spec_wins"],
            "duplicate_done_records": audit["duplicate_done_records"],
            "unique_done_tiles": audit["tiles_done"],
            "pixels_per_host": [s.get("pixels") for s in per],
            "launches_per_host": [s.get("launches") for s in per],
        }
        if audit["tiles_done"] != n_tiles:
            raise AssertionError(f"{mode}: {audit['tiles_done']} unique done tiles of {n_tiles}")
        artifacts = len(list(Path(wd).glob("tile_*.npz")))
        if artifacts != n_tiles:
            raise AssertionError(
                f"{mode}: {artifacts} artifacts of {n_tiles} (lost or double-written tiles)"
            )
        if verbose:
            print(f"  ok: slow-host {mode} ({json.dumps(results[mode])})")

    st, el = results["static"], results["elastic"]
    if not el["idle_gap_pod_s"] < st["idle_gap_pod_s"]:
        raise AssertionError(
            f"elastic idle gap {el['idle_gap_pod_s']}s did not collapse vs static "
            f"{st['idle_gap_pod_s']}s"
        )
    if not (st["host_imbalance"] and el["host_imbalance"]
            and el["host_imbalance"] < st["host_imbalance"]):
        raise AssertionError(
            f"elastic host_imbalance {el['host_imbalance']} did not drop vs static "
            f"{st['host_imbalance']}"
        )
    if el["spec_wins"] < 1:
        raise AssertionError(
            "no speculative win: the straggler-steered path never beat the parked owner"
        )
    results["deltas"] = {
        "idle_gap_collapse": round(st["idle_gap_pod_s"] / el["idle_gap_pod_s"], 3)
        if el["idle_gap_pod_s"] else None,
        "imbalance_drop": round(st["host_imbalance"] - el["host_imbalance"], 3),
        "pod_wall_speedup": round(st["pod_wall_s"] / el["pod_wall_s"], 3)
        if el["pod_wall_s"] else None,
    }
    if verbose:
        print(f"  ok: slow-host deltas {json.dumps(results['deltas'])}")
    return results


def soak(smoke: bool = False, keep: "str | None" = None, device: str = "cuda",
         verbose: bool = True) -> dict:
    """Run both legs; returns the report (raises on the first broken
    invariant)."""
    root = Path(keep or tempfile.mkdtemp(prefix="lt_elastic_soak_"))
    root.mkdir(parents=True, exist_ok=True)
    # sizes are the same in both modes — each leg's scene is already the
    # smallest that exercises it reliably on its device (the late joiner
    # needs the run to outlive its gate; the slow host must run enough
    # tiles to reach SLOW_SCHEDULE's park with its straggler median
    # seeded); smoke only skips the report file
    report: dict = {"smoke": smoke, "device": device}
    t0 = time.perf_counter()
    report["churn"] = churn_leg(root, size=80, device=device, verbose=verbose)
    report["churn_s"] = round(time.perf_counter() - t0, 3)
    t1 = time.perf_counter()
    report["slow_host"] = slow_host_leg(root, device=device, verbose=verbose)
    report["slow_host_s"] = round(time.perf_counter() - t1, 3)
    report["ok"] = True
    if keep is None:
        shutil.rmtree(root, ignore_errors=True)
    return report


def main(argv: "list[str] | None" = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--pod-worker"]:
        return pod_worker(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true", help="no report file")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu (tests)")
    ap.add_argument("--keep", default=None, metavar="DIR",
                    help="keep workdirs under DIR for post-mortem")
    ap.add_argument("--out", default=None, metavar="FILE",
                    help="write the JSON report here")
    args = ap.parse_args(argv)
    from land_trendr_tpu_torch.runtime.driver import resolve_device

    try:
        resolve_device(args.device)
    except (RuntimeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    report = soak(smoke=args.smoke, keep=args.keep, device=args.device)
    if args.out:
        write_json_atomic(args.out, report, trailing_newline=False)
        print(f"wrote {args.out}")
    print(json.dumps({"ok": report["ok"], "churn_s": report.get("churn_s"),
                      "slow_host_s": report.get("slow_host_s")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
