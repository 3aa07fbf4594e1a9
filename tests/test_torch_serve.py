"""The port's serving layer (``serve/``: programs, jobs, config, batching,
server) and the ``serve`` command on the CPU, held against the JAX
package's ``tests/test_serve.py`` and ``tests/test_batching.py``.

Config and request validation give the JAX package's verdicts and
messages; jobs run through the port's server at ``device="cpu"`` (the
plain version), their artifacts byte-equal to the port's own ``segment``
runs of the same request, and their rasters held against the JAX
package's server output for the same request: decisions on >= 99.9% of
pixels, every integer raster equal on the agreeing pixels, and the float
rasters that do not come from the anchored fits (``rmse``,
``vertex_src_vals``, ``vertex_years``, ``seg_duration``) within the port's
stated float32 tolerance (p99.9 <= 1e-5, max <= 5e-5;
``tests/test_torch_runtime.py``).  The fit-derived floats
(``vertex_fit_vals``, ``seg_magnitude``, ``seg_rate``, ``p_of_f``) are
held to a bound derived from both packages' float32 errors against the
float64 truth (``_FIT_DERIVED_BOUND``).
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from land_trendr_tpu.io.synthetic import SceneSpec, make_stack, write_stack
from land_trendr_tpu.serve import JobRequest as JaxJobRequest
from land_trendr_tpu.serve import SegmentationServer as JaxServer
from land_trendr_tpu.serve import ServeConfig as JaxServeConfig
from land_trendr_tpu_torch.cli import main as cli_main
from land_trendr_tpu_torch.io.geotiff import read_geotiff
from land_trendr_tpu_torch.serve import (
    EXIT_CODE_FOR_STATE,
    TERMINAL_STATES,
    JobRequest,
    ProgramCache,
    Rejection,
    SegmentationServer,
    ServeConfig,
)
from land_trendr_tpu_torch.serve.batching import resolve_batch, warm_batch_buffer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

torch.set_num_threads(1)

_PARAM_FLAGS = ["--max-segments", "4", "--vertex-count-overshoot", "2"]
_PARAMS = {"max_segments": 4, "vertex_count_overshoot": 2}
_TILE = 20


@pytest.fixture(scope="module")
def stack_dir(tmp_path_factory) -> str:
    d = str(tmp_path_factory.mktemp("serve_stack") / "stack")
    write_stack(d, make_stack(SceneSpec(width=40, height=40, year_start=2000,
                                        year_end=2008, seed=3)))
    return d


def _server(cfg: ServeConfig) -> SegmentationServer:
    return SegmentationServer(cfg, device="cpu")


def _digest_workdir(workdir: str) -> dict:
    out: dict = {}
    for p in sorted(Path(workdir).glob("tile_*.npz")):
        with np.load(p) as z:
            out[p.name] = {
                name: hashlib.sha256(np.ascontiguousarray(z[name]).tobytes()).hexdigest()
                for name in sorted(z.files)
            }
    return out


def _job(stack_dir: str, **kw) -> dict:
    return {"stack_dir": stack_dir, "tile_size": _TILE, "params": dict(_PARAMS), **kw}


def _post(port: int, path: str, payload) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port: int, path: str) -> tuple[int, dict]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _cli_segment(stack_dir: str, wd: str, od: str) -> None:
    assert cli_main(["--device", "cpu", "segment", stack_dir, "--tile-size", str(_TILE),
                     "--workdir", wd, "--out-dir", od, *_PARAM_FLAGS]) == 0


def _rasters(outputs: dict) -> dict:
    out = {}
    for name, path in outputs.items():
        a = read_geotiff(path)[0]
        out[name] = a[None] if a.ndim == 2 else a  # (depth, H, W)
    return out


@pytest.fixture(scope="module")
def jax_served(stack_dir, tmp_path_factory) -> dict:
    """The JAX package's server output (assembled rasters) for the
    canonical job: what every port job's rasters are held against."""
    srv = str(tmp_path_factory.mktemp("jax_serve") / "srv")
    server = JaxServer(JaxServeConfig(workdir=srv, max_jobs=1, feed_cache_mb=32, batch=False))
    snap = server.submit(_job(stack_dir))
    server.serve_forever()
    s = server.job_status(snap["job_id"])
    assert s["state"] == "done", s.get("error")
    return _rasters(s["outputs"])


#: float rasters computed from the anchored fits (see the module docstring)
_FIT_DERIVED = ("vertex_fit_vals", "seg_magnitude", "seg_rate", "p_of_f")
#: (p99.9, max) of |port float32 - JAX float32| on the fit-derived rasters.
#: Each package's float32 differs from the float64 truth by at most the
#: sum below, so their difference is bounded by the sum of both errors.
#: On this job (``tests/test_torch_f32.py``'s ``serve_9yr`` scene) each
#: package holds p99.9 <= 1e-5 against float64 (its contract), so p99.9
#: <= 1e-5 + 1e-5; the max against float64 over the four rasters is
#: 6.6e-6 for the port and 1.43e-5 for the JAX package, so max <= 1e-5 +
#: 1.5e-5.
_FIT_DERIVED_BOUND = (2e-5, 2.5e-5)


def _match_jax(outputs: dict, theirs: dict) -> None:
    """Decisions, integer rasters and every float raster against the JAX
    package: the fit-derived ones at ``_FIT_DERIVED_BOUND``, the others at
    the port's stated float32 tolerance."""
    ours = _rasters(outputs)
    assert sorted(ours) == sorted(theirs)
    agree = (
        (ours["model_valid"] == theirs["model_valid"]).all(axis=0)
        & (ours["n_vertices"] == theirs["n_vertices"]).all(axis=0)
        & (ours["vertex_indices"] == theirs["vertex_indices"]).all(axis=0)
    )
    assert agree.mean() >= 0.999, agree.mean()
    for name, a in ours.items():
        b = theirs[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.dtype.kind == "f":
            assert np.array_equal(np.isfinite(a), np.isfinite(b)), name
            p999, top = _FIT_DERIVED_BOUND if name in _FIT_DERIVED else (1e-5, 5e-5)
            d = np.abs(a[:, agree].astype(np.float64) - b[:, agree])
            d = d[np.isfinite(d)]
            if d.size:
                assert np.quantile(d, 0.999) <= p999, name
                assert d.max() <= top, name
        else:
            assert np.array_equal(a[:, agree], b[:, agree]), name


# ---------------------------------------------------------------------------
# config / request validation: the JAX package's verdicts and messages


@pytest.mark.parametrize(
    "kw",
    [
        {"serve_host": "0.0.0.0"},
        {"serve_queue_depth": 0},
        {"job_timeout_s": 0},
        {"ingest_store_dir": "IDIR"},
        {"fault_schedule": "serve.submitt@0"},
        {"telemetry": False, "metrics_port": 0},
        {"publish": True, "telemetry": False},
        {"alert_rules": "/nonexistent/rules.json"},
        {"publish": True, "alert_rules": "/nonexistent/rules.json"},
        {"batch": "yes"},
        {"batch_window_ms": -1.0},
        {"tenant_max_inflight": 0},
    ],
)
def test_serve_config_validation_matches_jax(kw):
    msgs = []
    for cls in (ServeConfig, JaxServeConfig):
        with pytest.raises(ValueError) as e:
            cls(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_serve_config_fields_match_jax():
    assert set(ServeConfig.__dataclass_fields__) == set(JaxServeConfig.__dataclass_fields__)
    assert ServeConfig().__dict__ == JaxServeConfig().__dict__


def test_serve_cli_config_error_exits_2(tmp_path):
    assert cli_main(["--device", "cpu", "serve", "--serve-host", "0.0.0.0",
                     "--workdir", str(tmp_path / "srv")]) == 2


@pytest.mark.parametrize(
    "payload",
    [
        {},
        {"stack_dir": "s", "nope": 1},
        {"stack_dir": "s", "run_overrides": {"telemetry": False}},
        {"stack_dir": "s", "priority": 1000},
        {"stack_dir": "s", "timeout_s": 0},
        {"stack_dir": "s", "deadline_s": -1},
        {"stack_dir": "s", "tile_size": "big"},
        {"stack_dir": "s", "tile_size": 0},
        {"stack_dir": "s", "max_retries": -1},
        {"stack_dir": "s", "tenant": ""},
        {"stack_dir": "s", "trace_id": ""},
        {"stack_dir": 3},
    ],
)
def test_job_request_rejections_match_jax(payload):
    msgs = []
    for cls in (JobRequest, JaxJobRequest):
        with pytest.raises(ValueError) as e:
            cls.from_payload(payload)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize(
    "payload",
    [
        {"stack_dir": "s", "ftv": "ndvi,tcw", "priority": 3},
        {"stack_dir": "s", "tile_size": "auto", "params": {"max_segments": 5}},
        {"stack_dir": "s", "products": ["rmse"], "tenant": "t", "deadline_s": 4.5},
    ],
)
def test_job_request_accepts_and_keys_like_jax(payload):
    ours, theirs = JobRequest.from_payload(payload), JaxJobRequest.from_payload(payload)
    assert ours.__dict__ == theirs.__dict__
    assert ours.affinity_key() == theirs.affinity_key()
    assert set(EXIT_CODE_FOR_STATE) == set(TERMINAL_STATES)


def test_program_cache_failed_probe_is_not_resident():
    pc = ProgramCache()
    key = pc.key_for(fingerprint="f", device="cpu", kernel=None)
    assert key == ProgramCache.key_for(kernel=None, device="cpu", fingerprint="f")
    assert not pc.admit(key)
    pc.record(key, hit=False, compile_s=1.0, ok=False)
    assert not pc.admit(key)
    pc.record(key, hit=False, compile_s=2.0)
    assert pc.admit(key)
    assert pc.stats() == {"hits": 0, "misses": 2, "compile_s": 3.0, "keys": 1}
    # the key names the card and the kernel instantiation
    assert pc.key_for(fingerprint="f", device="cpu", kernel="wide") != key


# ---------------------------------------------------------------------------
# the headline contract: concurrent jobs = the CLI, the second warm


def test_concurrent_jobs_match_cli_and_second_is_warm(stack_dir, jax_served, tmp_path):
    srv_dir = str(tmp_path / "srv")
    server = _server(ServeConfig(workdir=srv_dir, max_jobs=2, feed_cache_mb=32))
    st1, j1 = _post(server.port, "/jobs", _job(stack_dir))
    st2, j2 = _post(server.port, "/jobs", _job(stack_dir, tenant="b"))
    assert st1 == st2 == 200
    server.serve_forever()
    s1, s2 = server.job_status(j1["job_id"]), server.job_status(j2["job_id"])
    assert s1["state"] == s2["state"] == "done" and s1["exit_code"] == 0
    assert s1["summary"]["device"] == "cpu" and s1["summary"]["impl"] == "torch"
    assert s1["summary"]["program_cache"]["misses"] in (0, 1)
    assert s2["summary"]["program_cache"] == {"hits": 1, "misses": 0, "compile_s": 0.0}

    cli = []
    for i in (1, 2):
        wd, od = str(tmp_path / f"cli{i}_w"), str(tmp_path / f"cli{i}_o")
        _cli_segment(stack_dir, wd, od)
        cli.append((wd, od))
    ref = _digest_workdir(cli[0][0])
    assert _digest_workdir(cli[1][0]) == ref
    assert _digest_workdir(s1["workdir"]) == ref == _digest_workdir(s2["workdir"])
    for snap in (s1, s2):
        for name, path in snap["outputs"].items():
            assert Path(path).read_bytes() == Path(cli[0][1], Path(path).name).read_bytes(), name
        _match_jax(snap["outputs"], jax_served)

    from check_events_schema import main as lint_main

    assert lint_main([srv_dir]) == 0
    for snap in (s1, s2):
        assert lint_main([snap["workdir"]]) == 0
        evs = [json.loads(line) for line in open(os.path.join(snap["workdir"], "events.jsonl"))]
        assert evs and all(e["job_id"] == snap["job_id"] for e in evs)
        assert [e for e in evs if e["ev"] == "program_cache"]
    kinds = [json.loads(line)["ev"] for line in open(os.path.join(srv_dir, "events.jsonl"))]
    assert kinds.count("job_submitted") == 2 and kinds.count("job_done") == 2
    assert kinds[-1] == "run_done" and "program_cache" in kinds

    import obs_report

    report, _spans = obs_report.fold([os.path.join(srv_dir, "events.jsonl")])
    assert report["serve"]["submitted"] == 2
    assert report["serve"]["by_status"] == {"done": 2}
    assert report["program_cache"]["keys"] == 1


def test_serve_command_over_http(stack_dir, tmp_path):
    """``--device cpu serve --serve-port 0``: the startup line, POST /jobs,
    /healthz, /metrics, and a resumed job."""
    import subprocess

    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.Popen(
        [sys.executable, "-m", "land_trendr_tpu_torch", "--device", "cpu", "serve",
         "--workdir", str(tmp_path / "W"), "--serve-port", "0", "--publish",
         "--publish-interval-s", "0.5"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, env=env,
    )
    try:
        start = json.loads(proc.stdout.readline())
        assert start["serving"] is True and start["workdir"] == str(tmp_path / "W")
        port = start["port"]
        st, snap = _post(port, "/jobs", _job(stack_dir))
        assert st == 200
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            st, s = _get(port, f"/jobs/{snap['job_id']}")
            if s["state"] not in ("queued", "running"):
                break
            time.sleep(0.1)
        assert s["state"] == "done", s.get("error")
        st, h = _get(port, "/healthz")
        assert st == 200 and h["warm_program_count"] == 1
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
            prom = r.read().decode()
        assert "lt_serve_warm_hit_ratio" in prom
    finally:
        proc.terminate()
        proc.wait(timeout=60)


# ---------------------------------------------------------------------------
# admission control


def test_admission_rejections(stack_dir, tmp_path):
    srv_dir = str(tmp_path / "srv")
    server = _server(ServeConfig(workdir=srv_dir, serve_queue_depth=2, tenant_max_inflight=1))
    try:
        assert _post(server.port, "/jobs", _job(stack_dir, tenant="a"))[0] == 200
        st, body = _post(server.port, "/jobs", _job(stack_dir, tenant="a"))
        assert st == 429 and body["error"] == "tenant_cap"
        assert _post(server.port, "/jobs", _job(stack_dir, tenant="b"))[0] == 200
        st, body = _post(server.port, "/jobs", _job(stack_dir, tenant="c"))
        assert st == 429 and body["error"] == "queue_full"
        st, body = _post(server.port, "/jobs", {"nope": 1})
        assert st == 400 and body["error"] == "bad_request"
        st, h = _get(server.port, "/healthz")
        assert st == 200 and h["queue_depth"] == 2 and h["ok"] is True
        assert h["running"] is None and h["jobs_total"] == 2
        assert isinstance(h["warm_program_count"], int) and h["uptime_s"] >= 0
    finally:
        server.stop()
        server.serve_forever()
    evs = [json.loads(line) for line in open(os.path.join(srv_dir, "events.jsonl"))]
    assert sorted(e["reason"] for e in evs if e["ev"] == "job_rejected") == [
        "bad_request", "queue_full", "tenant_cap"]


def test_direct_submit_rejection_raises(stack_dir, tmp_path):
    server = _server(ServeConfig(workdir=str(tmp_path / "srv"), serve_queue_depth=1))
    try:
        server.submit(_job(stack_dir))
        with pytest.raises(Rejection) as exc:
            server.submit(_job(stack_dir, tenant="b"))
        assert exc.value.reason == "queue_full" and exc.value.http_status == 429
    finally:
        server.stop()
        server.serve_forever()


def test_candidates_beyond_the_kernel_refused_at_admission_on_cuda(stack_dir, tmp_path):
    # a server whose device is a card admits every candidate count the JAX
    # package does: 33 candidates (the global form) as well as 32 (wide);
    # the name dates from when the card refused 33
    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.ops.segment_cuda import instantiation

    srv_dir = tmp_path / "srv"
    server = _server(ServeConfig(workdir=str(srv_dir)))
    server.device = torch.device("cuda", 0)
    try:
        for over, form in (({"max_segments": 26, "vertex_count_overshoot": 6}, "global"),
                           ({"max_segments": 25, "vertex_count_overshoot": 6}, "wide")):
            assert instantiation(9, LTParams(**over)) == form
            st, body = _post(server.port, "/jobs", _job(stack_dir, params=over))
            assert st == 200, body
            assert body["state"] == "queued"
    finally:
        server.stop()
        server.serve_forever()


def test_cuda_server_without_a_card_fails_before_the_workdir(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        SegmentationServer(ServeConfig(workdir=str(tmp_path / "srv")))
    assert not (tmp_path / "srv").exists()


# ---------------------------------------------------------------------------
# cancel / timeout


def test_cancel_mid_job_leaves_resumable_manifest(stack_dir, tmp_path):
    server = _server(ServeConfig(workdir=str(tmp_path / "srv"), max_jobs=1,
                                 fault_schedule="seed=1,dispatch%1.0=slow:0.4"))
    snap = server.submit(_job(stack_dir))
    job_id = snap["job_id"]

    def cancel_after_first_tile():
        deadline = time.monotonic() + 30
        wd = Path(snap["workdir"])
        while time.monotonic() < deadline:
            if list(wd.glob("tile_*.npz")):
                break
            time.sleep(0.05)
        _post(server.port, f"/jobs/{job_id}/cancel", {})

    t = threading.Thread(target=cancel_after_first_tile)
    t.start()
    server.serve_forever()
    t.join(timeout=30)
    s = server.job_status(job_id)
    assert s["state"] == "cancelled" and s["exit_code"] == EXIT_CODE_FOR_STATE["cancelled"] == 3
    done = _digest_workdir(s["workdir"])
    assert 1 <= len(done) < 4, "cancel must land mid-run"
    evs = [json.loads(line) for line in open(os.path.join(s["workdir"], "events.jsonl"))]
    assert evs[-1]["ev"] == "run_done" and evs[-1]["status"] == "aborted"
    _cli_segment(stack_dir, s["workdir"], str(tmp_path / "resume_o"))
    resumed = _digest_workdir(s["workdir"])
    assert len(resumed) == 4
    clean_wd = str(tmp_path / "clean_w")
    _cli_segment(stack_dir, clean_wd, str(tmp_path / "clean_o"))
    assert resumed == _digest_workdir(clean_wd)
    assert all(resumed[k] == v for k, v in done.items())


def test_job_timeout_reports_stalled(stack_dir, tmp_path):
    server = _server(ServeConfig(workdir=str(tmp_path / "srv"), max_jobs=1, job_timeout_s=0.6,
                                 fault_schedule="seed=1,dispatch%1.0=slow:0.4"))
    snap = server.submit(_job(stack_dir))
    server.serve_forever()
    s = server.job_status(snap["job_id"])
    assert s["state"] == "stalled", s.get("error")
    assert s["exit_code"] == EXIT_CODE_FOR_STATE["stalled"] == 4
    assert "timeout" in s["error"]


def test_priority_drains_before_fifo(stack_dir, tmp_path):
    server = _server(ServeConfig(workdir=str(tmp_path / "srv"), max_jobs=3, feed_cache_mb=32))
    lo1 = server.submit(_job(stack_dir, tenant="a"))
    lo2 = server.submit(_job(stack_dir, tenant="b"))
    hi = server.submit(_job(stack_dir, tenant="c", priority=5))
    server.serve_forever()
    started = {s["job_id"]: s["started_t"]
               for s in (server.job_status(j["job_id"]) for j in (lo1, lo2, hi))}
    assert started[hi["job_id"]] < started[lo1["job_id"]] < started[lo2["job_id"]]


# ---------------------------------------------------------------------------
# cross-job batching


@pytest.fixture(scope="module")
def reference(stack_dir, tmp_path_factory) -> dict:
    """One batch=False run of the canonical job on the port's server."""
    server = _server(ServeConfig(workdir=str(tmp_path_factory.mktemp("batch_ref") / "srv"),
                                 max_jobs=1, feed_cache_mb=32, batch=False))
    snap = server.submit(_job(stack_dir))
    server.serve_forever()
    snap = server.job_status(snap["job_id"])
    assert snap["state"] == "done"
    ref = _digest_workdir(snap["workdir"])
    assert ref
    return ref


def _batch_events(srv_dir: str) -> tuple[list, list]:
    launches, demuxes = [], []
    with open(Path(srv_dir) / "events.jsonl") as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("ev") == "batch_launch":
                launches.append(rec)
            elif rec.get("ev") == "batch_demux":
                demuxes.append(rec)
    return launches, demuxes


def test_resolve_batch_explicit_wins_and_auto_defaults_on(tmp_path):
    assert resolve_batch(True) is True and resolve_batch(False) is False
    assert resolve_batch("auto") is True
    assert resolve_batch("auto", tune_store_dir=str(tmp_path), scene_shape=(40, 40, 9),
                         device="cpu") is True
    with pytest.raises(ValueError, match="batch"):
        resolve_batch("yes")


def test_resolve_batch_auto_consults_tuning_store(tmp_path):
    from land_trendr_tpu_torch.tune.autotune import device_identity
    from land_trendr_tpu_torch.tune.store import TUNE_SCHEMA, TuningStore, shape_class

    device_kind, backend = device_identity("cpu")
    TuningStore(str(tmp_path)).save({
        "schema": TUNE_SCHEMA, "device_kind": device_kind, "backend": backend,
        "shape_class": shape_class(40, 40, 9), "knobs": {"batch": False},
        "created_t": time.time(),
    })
    kw = dict(tune_store_dir=str(tmp_path), device="cpu")
    assert resolve_batch("auto", scene_shape=(40, 40, 9), **kw) is False
    assert resolve_batch("auto", scene_shape=(4000, 4000, 9), **kw) is True
    assert resolve_batch(False, scene_shape=(40, 40, 9), **kw) is False


def test_warm_batch_buffer_is_best_effort():
    assert warm_batch_buffer(64, 9, "cpu") == 0.0
    # an unusable device is logged, never raised
    assert warm_batch_buffer(64, 9, "not-a-device") == 0.0


def test_flood_coalesces_and_matches_one_run_per_job(stack_dir, reference, jax_served, tmp_path):
    srv_dir = str(tmp_path / "srv")
    server = _server(ServeConfig(workdir=srv_dir, max_jobs=3, feed_cache_mb=32, batch=True,
                                 batch_window_ms=200.0))
    snaps = [server.submit(_job(stack_dir)) for _ in range(3)]
    server.serve_forever()
    for snap in snaps:
        s = server.job_status(snap["job_id"])
        assert s["state"] == "done", s.get("error")
        assert _digest_workdir(s["workdir"]) == reference
        _match_jax(s["outputs"], jax_served)
    launches, demuxes = _batch_events(srv_dir)
    assert len(launches) == 1 and launches[0]["jobs"] == 3
    assert launches[0]["tiles"] == 3 * len(reference)
    assert 0 < launches[0]["occupancy"] <= 1
    assert launches[0]["job_id"] == snaps[0]["job_id"]
    assert sum(d["tiles"] for d in demuxes) == 2 * len(reference)
    assert {d["job_id"] for d in demuxes} == {snaps[1]["job_id"], snaps[2]["job_id"]}
    # the members resumed with no tile computed: every tile was demuxed
    for snap in snaps[1:]:
        assert server.job_status(snap["job_id"])["summary"]["tiles_done"] == 0
    from check_events_schema import main as lint_main

    assert lint_main([srv_dir]) == 0


def test_single_job_fleet_keeps_stock_path(stack_dir, reference, tmp_path):
    srv_dir = str(tmp_path / "srv")
    server = _server(ServeConfig(workdir=srv_dir, max_jobs=1, feed_cache_mb=32, batch=True,
                                 batch_window_ms=200.0))
    snap = server.submit(_job(stack_dir))
    server.serve_forever()
    s = server.job_status(snap["job_id"])
    assert s["state"] == "done" and _digest_workdir(s["workdir"]) == reference
    assert _batch_events(srv_dir) == ([], [])


def test_mixed_affinity_never_co_batches_and_keeps_order(stack_dir, reference, tmp_path):
    srv_dir = str(tmp_path / "srv")
    server = _server(ServeConfig(workdir=srv_dir, max_jobs=3, feed_cache_mb=32, batch=True,
                                 batch_window_ms=200.0))
    a = server.submit(_job(stack_dir))
    b = server.submit(_job(stack_dir, tile_size=10))
    c = server.submit(_job(stack_dir))
    server.serve_forever()
    sa, sb, sc = (server.job_status(s["job_id"]) for s in (a, b, c))
    assert sa["state"] == sb["state"] == sc["state"] == "done"
    assert _batch_events(srv_dir) == ([], [])
    assert sa["finished_t"] <= sb["finished_t"] <= sc["finished_t"]
    assert _digest_workdir(sa["workdir"]) == reference == _digest_workdir(sc["workdir"])


def test_cancelled_member_drops_out_without_harming_batch_mates(stack_dir, reference, tmp_path):
    srv_dir = str(tmp_path / "srv")
    server = _server(ServeConfig(workdir=srv_dir, max_jobs=3, feed_cache_mb=32, batch=True,
                                 batch_window_ms=200.0))
    snaps = [server.submit(_job(stack_dir)) for _ in range(3)]
    assert server.cancel(snaps[1]["job_id"])["state"] == "cancelled"
    server.serve_forever()
    s0, s2 = (server.job_status(snaps[i]["job_id"]) for i in (0, 2))
    assert s0["state"] == s2["state"] == "done"
    assert server.job_status(snaps[1]["job_id"])["state"] == "cancelled"
    assert _digest_workdir(s0["workdir"]) == reference == _digest_workdir(s2["workdir"])
    launches, demuxes = _batch_events(srv_dir)
    assert launches and launches[0]["jobs"] == 2
    assert {d["job_id"] for d in demuxes} == {snaps[2]["job_id"]}


# ---------------------------------------------------------------------------
# the fleet loop


def test_serve_fleet_loop_alert_lifecycle(tmp_path):
    from land_trendr_tpu_torch.obs import aggregate
    from land_trendr_tpu_torch.obs.events import validate_events_file
    from land_trendr_tpu_torch.obs.publish import SNAP_SCHEMA

    wd = str(tmp_path / "srv")
    server = _server(ServeConfig(workdir=wd, publish=True, publish_interval_s=0.1,
                                 flight_ring_events=0, alert_rules=None))
    tel_dir = os.path.join(wd, "telemetry")
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if aggregate.discover_snapshots(tel_dir) and server.telemetry.history is not None:
                if server.telemetry.history.read()[0]:
                    break
            time.sleep(0.05)
        assert aggregate.discover_snapshots(tel_dir)
        stale = {"schema": SNAP_SCHEMA, "kind": "run", "host": "ghost", "pid": 1,
                 "generation": 1, "seq": 1, "t_wall": time.time() - 120, "uptime_s": 1.0,
                 "interval_s": 5.0, "metrics": [], "state": {}}
        ghost = Path(tel_dir) / "ghost.1.snap.json"
        ghost.write_text(json.dumps(stale))
        os.utime(ghost, (stale["t_wall"], stale["t_wall"]))
        deadline = time.monotonic() + 30
        fired = False
        while time.monotonic() < deadline and not fired:
            h = _get(server.port, "/healthz")[1]
            fired = any(a["rule"] == "fleet_host_stale" for a in h.get("alerts", []))
            time.sleep(0.05)
        assert fired and h["fleet"]["stale"] >= 1
        ghost.unlink()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and server.telemetry.active_alerts():
            time.sleep(0.05)
        assert not server.telemetry.active_alerts()
    finally:
        server.stop()
        server.serve_forever()
    from check_events_schema import value_lints

    events_file = os.path.join(wd, "events.jsonl")
    assert validate_events_file(events_file, extra=value_lints()) == []
    states = [
        rec["state"] for rec in map(json.loads, Path(events_file).read_text().splitlines())
        if rec.get("ev") == "alert" and rec.get("rule") == "fleet_host_stale"
    ]
    assert states[:2] == ["firing", "resolved"]
    prom = Path(wd, "metrics.prom").read_text()
    assert "lt_alerts_fired_total 1" in prom and "lt_alerts_resolved_total 1" in prom


# ---------------------------------------------------------------------------
# the serve command's flags


def _serve_actions(parser) -> dict:
    sub = next(a for a in parser._actions if a.dest == "cmd")
    return {a.dest: (a.default, a.choices, a.type, a.nargs, a.const)
            for a in sub.choices["serve"]._actions if a.dest != "help"}


def test_serve_flags_match_the_jax_cli():
    from land_trendr_tpu.cli import build_parser as jax_parser
    from land_trendr_tpu_torch.cli import build_parser

    ours, theirs = _serve_actions(build_parser()), _serve_actions(jax_parser())
    assert ours == theirs


@pytest.mark.parametrize("flag", ["--platform", "--impl"])
def test_serve_has_no_platform_flag(flag):
    from land_trendr_tpu_torch.cli import build_parser

    with pytest.raises(SystemExit):
        build_parser().parse_args(["serve", flag, "cpu"])
