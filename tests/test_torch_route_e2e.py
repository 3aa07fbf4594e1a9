"""The port's ``route`` and ``load`` end to end on the CPU: the router
spawns two port replicas (``--replica-args "--device cpu"``), a seeded
trace drives it, and every job ends ``done`` with artifacts byte-equal
to the port's own ``segment`` of the same request; a replica SIGKILLed
mid-job is re-routed and its job still ends byte-equal (the JAX
package's ``tests/test_fleet_serve.py`` replica-death case).
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import select
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from land_trendr_tpu.io.synthetic import SceneSpec, make_stack, write_stack
from land_trendr_tpu_torch.cli import main as cli_main
from land_trendr_tpu_torch.fleet import FleetRouter, RouterConfig
from land_trendr_tpu_torch.loadgen.trace import SHAPE_PARAMS

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
_TILE = 20


@pytest.fixture(scope="module")
def stack_dir(tmp_path_factory) -> str:
    d = str(tmp_path_factory.mktemp("route_e2e_stack") / "stack")
    write_stack(d, make_stack(SceneSpec(width=40, height=40, year_start=2000,
                                        year_end=2008, seed=3)))
    return d


def _digest_workdir(workdir) -> dict:
    out: dict = {}
    for p in sorted(Path(workdir).glob("tile_*.npz")):
        with np.load(p) as z:
            out[p.name] = {
                name: hashlib.sha256(np.ascontiguousarray(z[name]).tobytes()).hexdigest()
                for name in sorted(z.files)
            }
    return out


@pytest.fixture(scope="module")
def reference(stack_dir, tmp_path_factory) -> dict:
    """The port's ``segment`` of each load shape's request: tile digests."""
    root = tmp_path_factory.mktemp("route_e2e_ref")
    out = {}
    for shape, params in SHAPE_PARAMS.items():
        flags = [f for k, v in params.items() for f in (f"--{k.replace('_', '-')}", str(v))]
        assert cli_main(["--device", "cpu", "segment", stack_dir, "--tile-size", str(_TILE),
                         "--workdir", str(root / shape), "--out-dir", str(root / f"{shape}_o"),
                         *flags]) == 0
        out[shape] = _digest_workdir(root / shape)
        assert out[shape]
    return out


def _env() -> dict:
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")


def test_route_and_load_commands_over_two_replicas(stack_dir, reference, tmp_path):
    """``route`` as a process spawning two CPU replicas, ``load`` driving
    a seeded closed-loop trace of 6 jobs from 2 tenants over HTTP."""
    rt_dir = tmp_path / "rt"
    proc = subprocess.Popen(
        [sys.executable, "-m", "land_trendr_tpu_torch", "route", "--workdir", str(rt_dir),
         "--spawn-replicas", "2", "--replica-args", "--device cpu --feed-cache-mb 32",
         "--health-interval-s", "0.2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env(), cwd=str(tmp_path),
    )
    try:
        ready, _, _ = select.select([proc.stdout], [], [], 180)
        assert ready, "route never printed its startup line"
        startup = json.loads(proc.stdout.readline())
        assert startup["routing"] is True and startup["replicas"] == 2
        report = tmp_path / "load.json"
        assert cli_main(["load", "--router-url", f"http://127.0.0.1:{startup['port']}",
                         "--stack-dir", stack_dir, "--tile-size", str(_TILE), "--mode", "closed",
                         "--requests", "6", "--workers", "2", "--tenants", "2", "--seed", "7",
                         "--duration-s", "120", "--timeout-s", "120",
                         "--out", str(report)]) == 0
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            _, err = proc.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    rep = json.loads(report.read_text())
    assert (rep["offered"], rep["done"], rep["failed"], rep["rejected"]) == (6, 6, 0, 0)
    assert {o["tenant"] for o in rep["outcomes"]} == {"t0", "t1"}
    # every routed job's tiles are byte-equal to segment of its shape
    by_digest = {json.dumps(d, sort_keys=True): s for s, d in reference.items()}
    got = collections.Counter(
        by_digest.get(json.dumps(_digest_workdir(wd), sort_keys=True), "mismatch")
        for wd in sorted((rt_dir / "jobs").glob("*/work"))
    )
    assert got == collections.Counter(o["shape"] for o in rep["outcomes"])
    # both replicas were spawned on the CPU, under the router's workdir
    metas = [json.loads(p.read_text()) for p in sorted((rt_dir / "replicas").glob("*/replica.json"))]
    assert len(metas) == 2
    assert (rt_dir / "journal" / "clean").exists(), "SIGTERM drains and marks the journal clean"


def test_replica_sigkill_reroutes_and_completes_byte_identical(stack_dir, reference, tmp_path):
    """SIGKILL the replica holding a job after its first durable tile:
    the router re-routes it, the survivor resumes the pinned manifest,
    and the tiles are byte-equal to ``segment``'s."""
    router = FleetRouter(RouterConfig(
        workdir=str(tmp_path / "rt"), spawn_replicas=2, health_interval_s=0.3,
        route_retries=3,
        # pace the dispatches so the kill lands mid-job with durable tiles
        replica_args=("--device", "cpu", "--feed-cache-mb", "32",
                      "--fault-schedule", "seed=5,dispatch%1.0=slow:0.3"),
    ))
    rt_thread = threading.Thread(target=router.serve_forever)
    rt_thread.start()
    try:
        snap = router.submit({"stack_dir": stack_dir, "tile_size": _TILE,
                              "params": dict(SHAPE_PARAMS["a"]),
                              "run_overrides": {"retry_backoff_s": 0.0}})
        wd = Path(snap["workdir"])
        deadline = time.monotonic() + 240
        victim = None
        while time.monotonic() < deadline and victim is None:
            if list(wd.glob("tile_*.npz")):
                with router._lock:
                    for r in router.pool:
                        if (snap["job_id"] in r.inflight and r.proc is not None
                                and r.proc.poll() is None):
                            victim = r
            if victim is None:
                time.sleep(0.05)
        assert victim is not None, "no replica ever held the job"
        pre_kill = _digest_workdir(wd)
        assert pre_kill, "the kill must land after durable work"
        os.kill(victim.proc.pid, signal.SIGKILL)
        deadline = time.monotonic() + 240
        while True:
            s = router.job_status(snap["job_id"])
            if s["state"] not in ("queued", "routed") or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        router.stop()
        rt_thread.join(timeout=600)
    assert s["state"] == "done", s.get("error")
    assert s["attempts"] >= 2 and s["replica"] != victim.rid
    resumed = _digest_workdir(wd)
    assert resumed == reference["a"]
    assert all(resumed[k] == v for k, v in pre_kill.items())
