"""The port's fleet tools on the CPU: ``tools/lt_request.py`` on
``tests/test_reqtrace.py``'s committed fixture (the same record as the JAX
package's ``tools/lt_request.py``; ``--list``, ``--slowest --trace`` and
exit codes 1 and 2) and ``tools/capacity_bench.py --smoke --device cpu`` at
the JAX tool's sizes with its invariants met — the counterpart of
``tests/test_capacity.py``'s bench smoke.  ``fleet_bench`` runs in
``tests/test_torch_fleet_bench.py``.
"""

import json
import os
import sys

import pytest
import torch

from land_trendr_tpu_torch.tools import capacity_bench
from land_trendr_tpu_torch.tools import lt_request as port_lt_request

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "reqtrace.events.jsonl")
FIXTURE_TRACE = "tr2hop0fixture01"


@pytest.fixture(scope="module")
def jax_lt_request():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import lt_request

    return lt_request


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr()


def test_record_equals_the_jax_tools(jax_lt_request, capsys):
    rc, mine = _run(port_lt_request.main, [FIXTURE_TRACE, FIXTURE], capsys)
    rc_ref, ref = _run(jax_lt_request.main, [FIXTURE_TRACE, FIXTURE], capsys)
    assert rc == rc_ref == 0
    a, b = json.loads(mine.out), json.loads(ref.out)
    assert a == b
    assert a["found"] and len(a["hops"]) == 2
    assert abs(a["blame_sum_s"] - a["latency_s"]) < 5e-3


def test_list_slowest_and_trace(jax_lt_request, capsys, tmp_path):
    rc, mine = _run(port_lt_request.main, ["--list", FIXTURE], capsys)
    rc_ref, ref = _run(jax_lt_request.main, ["--list", FIXTURE], capsys)
    assert rc == rc_ref == 0 and json.loads(mine.out) == json.loads(ref.out)
    assert json.loads(mine.out)["requests"]

    mine_trace, ref_trace = tmp_path / "mine.json", tmp_path / "ref.json"
    rc, mine = _run(port_lt_request.main, ["--slowest", FIXTURE, "--trace", str(mine_trace)],
                    capsys)
    rc_ref, ref = _run(jax_lt_request.main, ["--slowest", FIXTURE, "--trace", str(ref_trace)],
                       capsys)
    assert rc == rc_ref == 0
    a, b = json.loads(mine.out), json.loads(ref.out)
    assert a["trace"]["events"] == b["trace"]["events"] > 0
    a.pop("trace"), b.pop("trace")
    assert a == b
    # the Chrome export is the JAX exporter's, byte for byte
    assert mine_trace.read_bytes() == ref_trace.read_bytes()


def test_exit_codes(capsys, tmp_path):
    rc, err = _run(port_lt_request.main, ["nope", FIXTURE], capsys)
    assert rc == 1 and "not found" in err.err
    rc, err = _run(port_lt_request.main, ["nope", str(tmp_path / "absent")], capsys)
    assert rc == 2
    rc, err = _run(port_lt_request.main, ["--list", str(tmp_path / "absent")], capsys)
    assert rc == 2
    (tmp_path / "empty").mkdir()
    rc, err = _run(port_lt_request.main, ["--slowest", str(tmp_path / "empty")], capsys)
    assert rc == 2
    assert port_lt_request.expand_paths([FIXTURE, FIXTURE]) == [FIXTURE]


def test_capacity_bench_smoke_on_cpu(tmp_path, monkeypatch, capsys):
    # the spawned replicas share this worker's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "cap.json"
    assert capacity_bench.main(["--smoke", "--device", "cpu", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] is True and rep["device"] == "cpu"
    assert all(rep["invariants"].values()), rep["invariants"]
    assert [c["replicas"] for c in rep["curves"]] == [1, 2]
    assert all(len(c["points"]) == 3 for c in rep["curves"])
    # each cell's slowest job bounds its p99 and p50 (the smoke's log reads it)
    assert all(p["max_s"] >= p["p99_s"] >= p["p50_s"]
               for c in rep["curves"] for p in c["points"] if p["done"])
    assert rep["workload"]["scene_px"] == 40 * 40 and rep["workload"]["tile_size"] == 20
    assert rep["replay"]["match"] and rep["scripted_replay"]["match"]
    # the live replicas answered /debug/kernels (the CPU launches none)
    assert rep["curves"][0]["replica_launches"]
    assert all(v == 0 for v in rep["launches"].values())
    summary = json.loads(capsys.readouterr().out.split("wrote ", 1)[1].split("\n", 1)[1])
    assert summary["ok"] is True and set(summary["knees"]) == {"1", "2"}
