"""The port's serving fleet (``fleet/``, ``obs/reqtrace``, ``loadgen/``
and the ``route`` / ``load`` commands) on the CPU, held against the JAX
package's.

* **Pure parts**: the same seeded inputs through both packages' modules
  give identical results — DRR pick order, replica choices, autoscale
  decisions over a scripted burn history, the scripted decision log and
  its replay, the knee algebra, request-trace assembly over recorded
  event streams, and seeded load traces.  A ``decisions.jsonl`` that the
  port's router writes replays to the same verdicts through the JAX
  package's ``replay_decisions``.
* **The journal**: the crash and replay cases of
  ``tests/test_router_recovery.py`` against the port's journal and
  router, each journal fold equal to the JAX journal's over the same
  appends.  Routers here front in-process port replicas on the CPU.
* **Config and flags**: the router's config verdicts and messages, and
  every ``route`` / ``load`` flag with its default and choices, equal
  the JAX package's.

The end-to-end legs over spawned replica processes are in
``tests/test_torch_route_e2e.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import random
import signal
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import land_trendr_tpu.fleet.autoscale as j_autoscale
import land_trendr_tpu.fleet.capacity as j_capacity
import land_trendr_tpu.fleet.journal as j_journal
import land_trendr_tpu.fleet.scheduling as j_scheduling
import land_trendr_tpu.loadgen as j_loadgen
import land_trendr_tpu.obs.reqtrace as j_reqtrace
import land_trendr_tpu_torch.fleet.autoscale as t_autoscale
import land_trendr_tpu_torch.fleet.capacity as t_capacity
import land_trendr_tpu_torch.fleet.journal as t_journal
import land_trendr_tpu_torch.fleet.scheduling as t_scheduling
import land_trendr_tpu_torch.loadgen as t_loadgen
import land_trendr_tpu_torch.obs.reqtrace as t_reqtrace
from land_trendr_tpu.io.synthetic import SceneSpec, make_stack, write_stack
from land_trendr_tpu_torch.cli import _sigterm_to_interrupt
from land_trendr_tpu_torch.cli import main as cli_main
from land_trendr_tpu_torch.fleet import FleetRouter, RouterConfig
from land_trendr_tpu_torch.fleet.journal import AdmissionJournal, JournalError
from land_trendr_tpu_torch.runtime import faults
from land_trendr_tpu_torch.serve import Rejection, SegmentationServer, ServeConfig

torch.set_num_threads(1)

MODS = {
    "jax": SimpleNamespace(autoscale=j_autoscale, capacity=j_capacity, journal=j_journal,
                           scheduling=j_scheduling, loadgen=j_loadgen, reqtrace=j_reqtrace),
    "torch": SimpleNamespace(autoscale=t_autoscale, capacity=t_capacity, journal=t_journal,
                             scheduling=t_scheduling, loadgen=t_loadgen, reqtrace=t_reqtrace),
}
FIXTURES = Path(__file__).resolve().parent / "fixtures"

_PARAMS = {"max_segments": 4, "vertex_count_overshoot": 2}
_PARAM_FLAGS = ["--max-segments", "4", "--vertex-count-overshoot", "2"]
_TILE = 20


@pytest.fixture(scope="module")
def stack_dir(tmp_path_factory) -> str:
    d = str(tmp_path_factory.mktemp("route_stack") / "stack")
    write_stack(d, make_stack(SceneSpec(width=40, height=40, year_start=2000,
                                        year_end=2008, seed=3)))
    return d


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
    return {"stack_dir": stack_dir, "tile_size": _TILE, "params": dict(_PARAMS),
            "run_overrides": {"retry_backoff_s": 0.0}, **kw}


def _await_terminal(router, job_id: str, timeout_s: float = 300.0) -> dict:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        s = router.job_status(job_id)
        if s is not None and s["state"] not in ("queued", "routed"):
            return s
        time.sleep(0.05)
    raise TimeoutError(f"job {job_id} not terminal within {timeout_s}s")


def _events(workdir: str) -> list:
    return [json.loads(line) for line in (Path(workdir) / "events.jsonl").read_text().splitlines()
            if line.strip()]


class _Replicas:
    """In-process port servers on the CPU, each on a thread."""

    def __init__(self, tmp_path, n: int = 1) -> None:
        self.servers = [
            SegmentationServer(ServeConfig(workdir=str(tmp_path / f"replica{i}"),
                                           feed_cache_mb=32), device="cpu")
            for i in range(n)
        ]
        self.threads = [threading.Thread(target=s.serve_forever) for s in self.servers]
        for t in self.threads:
            t.start()
        self.bases = tuple(f"http://127.0.0.1:{s.port}" for s in self.servers)

    def stop(self) -> None:
        for s in self.servers:
            s.stop()
        for t in self.threads:
            t.join(timeout=120)


# ---------------------------------------------------------------------------
# pure parts: the same seeded inputs, the same results in both packages


def _drr_script(mod, seed: int) -> list:
    rng = random.Random(seed)
    q = mod.scheduling.DrrQueue({"a": 3.0, "b": 1.0, "c": 0.5})
    removed: set = set()
    out = []
    for i in range(400):
        r = rng.random()
        if r < 0.5:
            q.enqueue(rng.choice("abcd"), f"j{i}", front=rng.random() < 0.1)
        elif r < 0.55 and q.depth:
            tenant = rng.choice("abcd")
            out.append(("remove", tenant, q.remove(tenant, f"j{rng.randrange(i)}")))
        else:
            out.append(("pick", q.pick(live=lambda e: e not in removed)))
        out.append((q.depth, [(t, q.deficit(t), q.queued(t)) for t in q.known_tenants()]))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_drr_picks_equal_the_jax_package(seed):
    assert _drr_script(MODS["torch"], seed) == _drr_script(MODS["jax"], seed)


def test_choose_replica_equals_the_jax_package():
    rng = random.Random(11)
    for _ in range(300):
        cands = [(f"r{k}", rng.randrange(3), rng.random() < 0.4)
                 for k in rng.sample(range(6), rng.randrange(0, 6))]
        for affinity in (True, False):
            assert (t_scheduling.choose_replica(list(cands), affinity)
                    == j_scheduling.choose_replica(list(cands), affinity))


def _scale_script(mod, seed: int) -> list:
    rng = random.Random(seed)
    scaler = mod.autoscale.Autoscaler(min_replicas=1, max_replicas=4, up_burn=0.5,
                                      down_burn=0.05, for_s=2.0, hold_s=6.0)
    replicas, out = 1, []
    for t in range(200):
        burn = None if rng.random() < 0.05 else rng.choice([0.0, 0.02, 0.3, 0.7, 1.2])
        d = scaler.decide(burn, rng.randrange(3), replicas, float(t))
        replicas += {"up": 1, "down": -1}.get(d, 0)
        out.append((t, d, replicas))
    out.append(scaler.state())
    return out


@pytest.mark.parametrize("seed", [5, 6])
def test_autoscale_decisions_equal_the_jax_package(seed):
    got = _scale_script(MODS["torch"], seed)
    assert got == _scale_script(MODS["jax"], seed)
    assert {d for _, d, _ in got[:-1]} >= {"up", "down"}


def test_scripted_history_and_replay_equal_the_jax_package(tmp_path):
    paths = {}
    for impl, mod in MODS.items():
        paths[impl] = str(tmp_path / f"{impl}.jsonl")
        assert mod.capacity.write_scripted_history(paths[impl], seed=23, events=400)["records"] == 400
    assert Path(paths["torch"]).read_bytes() == Path(paths["jax"]).read_bytes()
    for impl in MODS:
        for mod in MODS.values():
            rep = mod.capacity.replay_decisions(paths[impl])
            assert rep.match and rep.mismatch_seq is None
            assert rep.decisions == rep.matched > 0
    # one tampered output is caught at the same seq by both
    recs = [json.loads(line) for line in open(paths["torch"])]
    victim = next(r for r in recs if r["kind"] == "pick")
    victim["job_id"] += "-tampered"
    bad = str(tmp_path / "bad.jsonl")
    Path(bad).write_text("".join(json.dumps(r) + "\n" for r in recs))
    reps = [mod.capacity.replay_decisions(bad) for mod in MODS.values()]
    assert [r.match for r in reps] == [False, False]
    assert reps[0].mismatch_seq == reps[1].mismatch_seq == victim["seq"]


def test_knee_and_blame_equal_the_jax_package():
    rng = random.Random(4)
    blame = list(j_reqtrace.BLAME_PRIORITY) + ["other"]
    assert t_reqtrace.BLAME_PRIORITY == j_reqtrace.BLAME_PRIORITY
    for _ in range(100):
        n = rng.randrange(0, 7)
        pts = sorted((rng.uniform(0.1, 8.0), rng.uniform(0.5, 20.0)) for _ in range(n))
        assert t_capacity.find_knee(pts) == j_capacity.find_knee(pts)
        points = [{"offered_qps": x, "p99_s": y,
                   "blame": {rng.choice(blame): rng.uniform(0, 5) for _ in range(3)}}
                  for x, y in pts]
        ours, theirs = json.loads(json.dumps(points)), json.loads(json.dumps(points))
        assert t_capacity.mark_knee(ours) == j_capacity.mark_knee(theirs)
        assert ours == theirs
        vals = [rng.uniform(0, 10) for _ in range(n)]
        for q in (50.0, 99.0, 100.0):
            assert t_capacity.percentile(vals, q) == j_capacity.percentile(vals, q)
        split = {rng.choice(blame): float(rng.randrange(3)) for _ in range(3)}
        assert t_capacity.dominant_blame(split) == j_capacity.dominant_blame(split)


@pytest.mark.parametrize("fixture", ["reqtrace.events.jsonl", "router.events.jsonl",
                                     "serve.events.jsonl", "capacity.events.jsonl"])
def test_reqtrace_assembly_equals_the_jax_package(fixture):
    paths = [str(FIXTURES / fixture)]
    listed = t_reqtrace.list_requests(paths)
    assert listed == j_reqtrace.list_requests(paths)
    ids = {r["trace_id"] for r in listed}
    for line in (FIXTURES / fixture).read_text().splitlines():
        tid = json.loads(line).get("trace_id") if line.strip() else None
        if tid:
            ids.add(tid)
    for tid in sorted(ids) + ["lg-absent"]:
        assert t_reqtrace.assemble_request(paths, tid) == j_reqtrace.assemble_request(paths, tid)


def test_blame_partition_equals_the_jax_package():
    rng = random.Random(9)
    for _ in range(200):
        t0 = rng.uniform(0, 10)
        t1 = t0 + rng.uniform(0, 10)
        spans = [(rng.choice(list(t_reqtrace.BLAME_PRIORITY)), t0 + rng.uniform(-1, 10),
                  t0 + rng.uniform(-1, 12)) for _ in range(rng.randrange(6))]
        assert (t_reqtrace.blame_partition(spans, t0, t1)
                == j_reqtrace.blame_partition(spans, t0, t1))


@pytest.mark.parametrize(
    "kw",
    [
        dict(mode="open", duration_s=120.0, qps=3.0, seed=42, tenants=4, tenant_skew=1.0,
             wave_amp=0.4, wave_period_s=30.0),
        dict(mode="closed", duration_s=5.0, requests=8, seed=0xBEEF, tenants=2),
        dict(mode="open", duration_s=60.0, qps=2.0, seed=7, requests=5, tenant_skew=0.0),
    ],
)
def test_build_trace_equals_the_jax_package(kw):
    ours = [dataclasses.asdict(r) for r in t_loadgen.build_trace(t_loadgen.LoadConfig(**kw))]
    theirs = [dataclasses.asdict(r) for r in j_loadgen.build_trace(j_loadgen.LoadConfig(**kw))]
    assert ours == theirs and ours
    from land_trendr_tpu.loadgen.trace import SHAPE_PARAMS as J_SHAPES
    from land_trendr_tpu_torch.loadgen.trace import SHAPE_PARAMS

    assert SHAPE_PARAMS == J_SHAPES


# ---------------------------------------------------------------------------
# config and flags


@pytest.mark.parametrize(
    "kw",
    [
        dict(replicas=("http://127.0.0.1:1",), route_host="0.0.0.0"),
        dict(),
        dict(replicas=("127.0.0.1:80",)),
        dict(replicas=("http://x",), tenant_weights="oops"),
        dict(spawn_replicas=1, autoscale=True, scale_down_burn=0.9),
        dict(replicas=("http://x",), autoscale=True),
        dict(replicas=("http://x",), fault_schedule="router.forwardd@0"),
    ],
)
def test_router_config_validation_matches_jax(kw):
    from land_trendr_tpu.fleet import RouterConfig as JRouterConfig

    with pytest.raises(ValueError) as ours:
        RouterConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        JRouterConfig(**kw)
    assert str(ours.value) == str(theirs.value)


def test_route_cli_config_errors_exit_2(tmp_path):
    assert cli_main(["route", "--route-host", "0.0.0.0", "--replica", "http://127.0.0.1:1",
                     "--workdir", str(tmp_path / "rt")]) == 2
    assert cli_main(["route", "--workdir", str(tmp_path / "rt2")]) == 2
    assert cli_main(["load", "--router-url", "http://127.0.0.1:1", "--stack-dir", "S",
                     "--mode", "closed", "--workers", "0"]) == 2


def _actions(parser, cmd: str) -> dict:
    sub = next(a for a in parser._actions if a.dest == "cmd")
    return {
        a.dest: (tuple(a.option_strings), a.default, a.choices, a.nargs, a.required,
                 type(a).__name__, getattr(a.type, "__name__", a.type), a.metavar)
        for a in sub.choices[cmd]._actions if a.dest != "help"
    }


@pytest.mark.parametrize("cmd", ["route", "load"])
def test_route_and_load_flags_match_the_jax_cli(cmd):
    from land_trendr_tpu.cli import build_parser as jax_parser
    from land_trendr_tpu_torch.cli import build_parser

    ours, theirs = _actions(build_parser(), cmd), _actions(jax_parser(), cmd)
    assert ours == theirs
    assert len(ours) >= (12 if cmd == "load" else 25)


# ---------------------------------------------------------------------------
# the journal: the port's folds equal the JAX package's


def _fold(journal) -> str:
    return json.dumps(journal.replay(), sort_keys=True)


def test_journal_roundtrip_replays_identically(tmp_path):
    folds = {}
    for impl, mod in MODS.items():
        root = str(tmp_path / impl)
        j = mod.journal.AdmissionJournal(root)
        assert j.was_clean is False
        for i in range(3):
            jid = f"job-{i}"
            j.append("admitted", jid, payload={"n": i}, trace_id=f"t{i}")
            j.append("forwarded", jid, replica_base="http://x", replica_job_id=f"r{i}")
        j.append("terminal", "job-0", state="done", error=None)
        folded = j.replay()
        assert folded["job-0"]["state"] == "done"
        assert folded["job-1"]["status"] == "forwarded"
        assert j.stats()["appends"] == 7 and j.stats()["segments"] == 1
        folds[impl] = before = _fold(j)
        j.close()
        with pytest.raises(mod.journal.JournalError, match="closed"):
            j.append("terminal", "job-1", state="done")
        j2 = mod.journal.AdmissionJournal(root)
        assert _fold(j2) == before
        j2.close()
    # the folds agree, with the wall-clock stamps of the records aside
    strip = [{k: {f: v for f, v in s.items() if f not in ("t", "admitted_t")}
              for k, s in json.loads(f).items()} for f in folds.values()]
    assert strip[0] == strip[1]
    # a journal the port wrote folds the same through the JAX journal
    cross = j_journal.AdmissionJournal(str(tmp_path / "torch"))
    assert _fold(cross) == folds["torch"]
    cross.close()


def test_journal_torn_tail_gc_and_corruption(tmp_path):
    root = str(tmp_path / "j")
    j = AdmissionJournal(root)
    j.append("admitted", "keep-1", payload={})
    before = _fold(j)
    j.close()
    seg = Path(root) / "seg-00000001.jsonl"
    with open(seg, "ab") as f:
        f.write(b'{"rec":"admitted","job_id":"torn-')
    j2 = AdmissionJournal(root)
    assert _fold(j2) == before
    assert "torn-" not in j2.replay()
    j2.close()
    assert seg.read_bytes().endswith(b"\n")
    seg.write_bytes(b"not json\n" + seg.read_bytes())
    with pytest.raises(JournalError, match="corrupt"):
        AdmissionJournal(root)
    with pytest.raises(j_journal.JournalError, match="corrupt"):
        j_journal.AdmissionJournal(root)


def test_journal_rotation_compaction_keeps_live_jobs(tmp_path):
    root = str(tmp_path / "j")
    j = AdmissionJournal(root, segment_bytes=1)
    j.append("admitted", "live-0", payload={})
    i = 0
    while j.stats()["segment"] < 3:
        jid = f"dead-{i:05d}"
        j.append("admitted", jid, payload={"fill": "x" * 64})
        j.append("terminal", jid, state="done")
        i += 1
    folded = j.replay()
    j.compact()
    assert json.dumps(folded, sort_keys=True) == json.dumps(j.replay(), sort_keys=True)
    assert j.stats()["segments"] >= 3
    j.append("terminal", "live-0", state="done")
    dropped = j.compact()
    assert dropped >= 1
    assert all(s["status"] == "terminal" for s in j.replay().values())
    j.close()
    # the JAX journal folds the compacted segments the same
    again = AdmissionJournal(root)
    jax_view = j_journal.AdmissionJournal(root)
    assert _fold(again) == _fold(jax_view)
    again.close()
    jax_view.close()


def test_journal_clean_marker_consumed_at_reopen(tmp_path):
    root = str(tmp_path / "j")
    j = AdmissionJournal(root)
    j.mark_clean()
    j.close()
    assert (Path(root) / "clean").exists()
    j2 = AdmissionJournal(root)
    assert j2.was_clean is True and not (Path(root) / "clean").exists()
    j2.close()
    j3 = AdmissionJournal(root)
    assert j3.was_clean is False
    j3.close()


def test_journal_append_fault_raises_journal_error(tmp_path):
    j = AdmissionJournal(str(tmp_path / "j"))
    faults.activate(faults.parse_schedule("seed=1,router.journal@0=io"))
    try:
        with pytest.raises(JournalError):
            j.append("admitted", "a-1", payload={})
    finally:
        faults.deactivate()
    assert j.stats()["appends"] == 0
    j.append("admitted", "a-1", payload={})
    assert j.replay()["a-1"]["status"] == "admitted"
    j.close()


# ---------------------------------------------------------------------------
# the port's router over in-process port replicas (CPU)


def test_journal_fault_503_then_resubmit_lands(stack_dir, tmp_path):
    replica = _Replicas(tmp_path)
    rt_dir = str(tmp_path / "rt")
    router = FleetRouter(RouterConfig(workdir=rt_dir, replicas=replica.bases,
                                      health_interval_s=0.2,
                                      fault_schedule="seed=1,router.journal@0=io"))
    rt_thread = threading.Thread(target=router.serve_forever)
    rt_thread.start()
    try:
        with pytest.raises(Rejection) as exc:
            router.submit(_job(stack_dir))
        assert (exc.value.http_status, exc.value.reason) == (503, "journal_error")
        assert router.jobs() == []
        s = _await_terminal(router, router.submit(_job(stack_dir))["job_id"])
        assert s["state"] == "done", s.get("error")
    finally:
        router.stop()
        rt_thread.join(timeout=300)
        replica.stop()
    evs = _events(rt_dir)
    assert [e["reason"] for e in evs if e.get("ev") == "job_rejected"] == ["journal_error"]
    assert sorted({e["rec"] for e in evs if e.get("ev") == "journal_append"}) == [
        "admitted", "forwarded", "terminal"]


def test_recovery_window_503_but_dedupe_answers(stack_dir, tmp_path):
    replica = _Replicas(tmp_path)
    router = FleetRouter(RouterConfig(workdir=str(tmp_path / "rt"), replicas=replica.bases,
                                      health_interval_s=0.2))
    try:
        first = router.submit(_job(stack_dir, idempotency_key="win-1"))
        router._recovering = True
        with pytest.raises(Rejection) as exc:
            router.submit(_job(stack_dir))
        assert (exc.value.http_status, exc.value.reason) == (503, "recovering")
        req = urllib.request.Request(
            f"http://127.0.0.1:{router.port}/jobs", data=json.dumps(_job(stack_dir)).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with pytest.raises(urllib.error.HTTPError) as http_exc:
            urllib.request.urlopen(req, timeout=30)
        assert http_exc.value.code == 503
        assert http_exc.value.headers["Retry-After"] is not None
        assert json.loads(http_exc.value.read())["error"] == "recovering"
        again = router.submit(_job(stack_dir, idempotency_key="win-1"))
        assert again["deduped"] is True and again["job_id"] == first["job_id"]
        router._recovering = False
        router.submit(_job(stack_dir))
    finally:
        router.stop()
        router.serve_forever()
        replica.stop()


def test_clean_restart_dedupes_across_incarnations(stack_dir, tmp_path):
    replica = _Replicas(tmp_path)
    rt_dir = str(tmp_path / "rt")
    cfg = dict(workdir=rt_dir, replicas=replica.bases, health_interval_s=0.2)
    router = FleetRouter(RouterConfig(**cfg))
    rt_thread = threading.Thread(target=router.serve_forever)
    rt_thread.start()
    try:
        snap = router.submit(_job(stack_dir, idempotency_key="restart-1"))
        assert _await_terminal(router, snap["job_id"])["state"] == "done"
    finally:
        router.stop()
        rt_thread.join(timeout=300)
    assert (Path(rt_dir) / "journal" / "clean").exists()
    router2 = FleetRouter(RouterConfig(**cfg))
    try:
        assert router2.recovery["clean"] is True
        assert router2.recovery["replayed"] == 0 and router2.recovery["deduped"] == 1
        again = router2.submit(_job(stack_dir, idempotency_key="restart-1"))
        assert again["deduped"] is True and again["job_id"] == snap["job_id"]
        assert again["state"] == "done"
    finally:
        router2.stop()
        router2.serve_forever()
        replica.stop()


def test_crash_recovery_requeues_and_resumes_byte_identical(stack_dir, tmp_path):
    """A crash journal (admitted + forwarded to a dead replica base) is
    requeued with its pinned workdir; the resumed run ends under the
    preserved trace id, byte-equal to the port's ``segment`` of the same
    request, and the idempotency key still dedupes."""
    replica = _Replicas(tmp_path)
    jwd = str(tmp_path / "crash_wd")
    jid = "rt-0-00001"
    payload = _job(stack_dir, workdir=jwd, out_dir=jwd + "_o")
    rt_crash = tmp_path / "rt_crash"
    (rt_crash / "journal").mkdir(parents=True)
    (rt_crash / "journal" / "seg-00000001.jsonl").write_text(
        json.dumps({"rec": "admitted", "job_id": jid, "payload": payload, "tenant": "t",
                    "priority": 0, "key": "k", "trace_id": "testrecover00001",
                    "idempotency_key": "crash-1", "workdir": jwd, "out_dir": jwd + "_o",
                    "source": "http", "t": 0.0}) + "\n"
        + json.dumps({"rec": "forwarded", "job_id": jid, "replica_base": "http://127.0.0.1:9",
                      "replica_job_id": "gone-1", "t": 0.0}) + "\n")
    try:
        router = FleetRouter(RouterConfig(workdir=str(rt_crash), replicas=replica.bases,
                                          health_interval_s=0.2))
        rt_thread = threading.Thread(target=router.serve_forever)
        rt_thread.start()
        try:
            assert router.recovery["replayed"] == 1 and router.recovery["requeued"] == 1
            assert router.recovery["clean"] is False
            s = _await_terminal(router, jid)
            assert s["state"] == "done", s.get("error")
            assert s["trace_id"] == "testrecover00001"
            again = router.submit({**payload, "idempotency_key": "crash-1"})
            assert again["deduped"] is True and again["job_id"] == jid
        finally:
            router.stop()
            rt_thread.join(timeout=300)
    finally:
        replica.stop()
    clean_wd = str(tmp_path / "clean_wd")
    assert cli_main(["--device", "cpu", "segment", stack_dir, "--tile-size", str(_TILE),
                     "--workdir", clean_wd, "--out-dir", str(tmp_path / "clean_o"),
                     *_PARAM_FLAGS]) == 0
    assert _digest_workdir(jwd) == _digest_workdir(clean_wd) != {}
    recovered = [e for e in _events(str(rt_crash)) if e.get("ev") == "router_recovered"]
    assert len(recovered) == 1 and recovered[0]["requeued"] == 1


def test_sigterm_drains_like_sigint():
    with pytest.raises(KeyboardInterrupt):
        _sigterm_to_interrupt(signal.SIGTERM, None)


def _quota_verdicts(router_cls, cfg_cls, tmp_path, name, stack_dir) -> list:
    # an unreachable adopted replica: nothing routes, the queue only fills
    router = router_cls(cfg_cls(workdir=str(tmp_path / name), replicas=("http://127.0.0.1:9",),
                                tenant_quota=2, route_queue_depth=5, health_interval_s=0.2))
    out = []
    try:
        for tenant in ["a", "a", "a", "b", "b", "c", "b", "c", "d"]:
            try:
                snap = router.submit(_job(stack_dir, tenant=tenant))
                out.append((tenant, "accepted", snap["state"]))
            except Exception as e:  # the package's own Rejection
                out.append((tenant, e.reason, e.http_status))
    finally:
        router.stop()
        router.serve_forever()
    return out


def test_quota_and_queue_verdicts_equal_the_jax_router(stack_dir, tmp_path):
    from land_trendr_tpu.fleet import FleetRouter as JFleetRouter
    from land_trendr_tpu.fleet import RouterConfig as JRouterConfig

    ours = _quota_verdicts(FleetRouter, RouterConfig, tmp_path, "t", stack_dir)
    assert ours == _quota_verdicts(JFleetRouter, JRouterConfig, tmp_path, "j", stack_dir)
    assert {v[1] for v in ours} == {"accepted", "tenant_quota", "queue_full"}


def test_router_decision_log_replays_through_the_jax_package(stack_dir, tmp_path):
    """Jobs of two tenants through the port's router with ``decision_log``:
    every job ends done, and the recorded ``decisions.jsonl`` replays to
    the same verdicts through the JAX package's ``replay_decisions``."""
    replica = _Replicas(tmp_path)
    rt_dir = str(tmp_path / "rt")
    router = FleetRouter(RouterConfig(workdir=rt_dir, replicas=replica.bases,
                                      health_interval_s=0.2, decision_log=True,
                                      tenant_weights="a=2,b=1"))
    rt_thread = threading.Thread(target=router.serve_forever)
    rt_thread.start()
    try:
        ids = [router.submit(_job(stack_dir, tenant=t))["job_id"] for t in "aab"]
        states = [_await_terminal(router, i)["state"] for i in ids]
    finally:
        router.stop()
        rt_thread.join(timeout=300)
        replica.stop()
    assert states == ["done"] * 3
    path = str(Path(rt_dir) / "decisions.jsonl")
    kinds = {json.loads(line)["kind"] for line in open(path)}
    assert {"config", "enqueue", "pick", "choose"} <= kinds
    ours, theirs = t_capacity.replay_decisions(path), j_capacity.replay_decisions(path)
    assert ours.match and theirs.match
    assert (ours.decisions, ours.matched) == (theirs.decisions, theirs.matched) != (0, 0)


def test_debug_kernels_reports_the_process_launch_counts(tmp_path):
    # what the smoke reads from each spawned replica on the card
    from land_trendr_tpu_torch.ops import segment_cuda

    replica = _Replicas(tmp_path)
    try:
        with urllib.request.urlopen(f"{replica.bases[0]}/debug/kernels", timeout=30) as r:
            body = json.loads(r.read())
    finally:
        replica.stop()
    assert body == {"launches": segment_cuda.launch_counts()}
    assert sorted(body["launches"]) == sorted(
        [f"{form}{kind}LAUNCHES" for form in ("", "WIDE_", "GLOBAL_")
         for kind in ("", "FAMILY_")] + ["FTV_LAUNCHES", "INDEX_LAUNCHES"])
