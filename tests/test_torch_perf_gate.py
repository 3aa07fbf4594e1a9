"""The port's perf gate (``tools/perf_gate.py``) on the CPU.

With ``--device cpu`` the gate runs every bench smoke and leg except the
minutes-scale scheduler and router legs, against the card's committed
records: every exact check must hold and every band must read ``n/a
(bands are the H100's)`` — the CPU gate carries no timing verdict.  The
JAX package's value lints are passed in for the event streams.  The legs
that need no bench (trace, request trace, fleet telemetry) also run on
their own, the band rule is checked on both devices, and the scheduler,
router and capacity legs accept reports made elsewhere.
"""

import json

import pytest
import torch

from land_trendr_tpu_torch.tools import perf_gate

torch.set_num_threads(1)


def _value_lints():
    from tools.check_events_schema import value_lints

    return value_lints


def test_gate_on_cpu_exact_checks_hold_and_bands_are_na(tmp_path, monkeypatch):
    # the recovery leg's replica and the benches share this worker's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    verdict = perf_gate.run("cpu", str(tmp_path / "gate"), scheduler=False, router=False,
                            lint_extra=_value_lints())
    checks = verdict["checks"]
    exact = [c for c in checks if c["kind"] == "exact"]
    bands = [c for c in checks if c["kind"] == "band"]
    assert [c for c in exact if c["ok"] is not True] == []
    assert bands and all(c["ok"] is None and c["detail"] == perf_gate.BAND_NA for c in bands)
    assert verdict["ok"] is True and verdict["device"] == "cpu"
    assert "lintkit" in verdict["lint"] and "not run" in verdict["lint"]
    names = {c["check"] for c in checks}
    for leg in ("parity", "feed", "fetch", "upload", "store", "serve", "batch", "trace",
                "reqtrace", "fleet", "tune", "capacity", "recovery", "flight"):
        assert any(n.startswith(leg + ".") for n in names), leg
    assert not any(n.startswith(("scheduler.", "router.")) for n in names)
    assert {"fetch.speedup", "upload.speedup", "serve.warm_speedup", "batch.speedup",
            "flight.overhead"} <= {c["check"] for c in bands}


def test_gate_needs_the_records(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(perf_gate, "RECORDS", tmp_path)
    assert perf_gate.main(["--device", "cpu"]) == 2
    assert "records are missing" in capsys.readouterr().err


def test_committed_records_are_the_cards():
    for name in perf_gate.RECORD_FILES.values():
        rec = json.loads((perf_gate.RECORDS / name).read_text())
        assert rec["device"] == "cuda", name
        assert "H100" in rec["nvidia_smi"] and " W" in rec["nvidia_smi"], name
        assert rec["command"].startswith("python -m land_trendr_tpu_torch.tools."), name
        # the code it ran: the package digest (a checkout without .git has
        # no commit), or the commit of a record made before the digest
        assert rec.get("source_sha256") or rec.get("commit"), name
        assert not rec.get("smoke"), name


def test_source_digest_covers_the_sources_only(tmp_path, monkeypatch):
    from land_trendr_tpu_torch.tools import measure

    pkg = tmp_path / "pkg"
    for rel in ("a.py", "csrc/k.cu", "tools/records/R.json", "_build/lib.so",
                "__pycache__/a.cpython-312.pyc"):
        (pkg / rel).parent.mkdir(parents=True, exist_ok=True)
        (pkg / rel).write_text(rel)
    monkeypatch.setattr(measure, "PACKAGE", pkg)
    first = measure.source_digest()
    for rel in ("tools/records/R.json", "_build/lib.so", "__pycache__/a.cpython-312.pyc"):
        (pkg / rel).write_text("changed")
    assert measure.source_digest() == first
    (pkg / "csrc/k.cu").write_text("changed")
    assert measure.source_digest() != first
    meta = measure.record_meta("land_trendr_tpu_torch.tools.x", ["--out", "X.json"], "cpu")
    assert meta["command"] == "python -m land_trendr_tpu_torch.tools.x --out X.json"
    assert meta["source_sha256"] == measure.source_digest() and meta["nvidia_smi"] is None


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_band_rule(device):
    gate = perf_gate.Gate(device)
    gate.exact("x.exact", False, "broken")
    gate.band("x.band", False, "slow")
    assert gate.checks[0] == {"check": "x.exact", "kind": "exact", "ok": False,
                              "detail": "broken"}
    if device == "cuda":
        assert gate.checks[1]["ok"] is False and len(gate.failed) == 2
    else:
        assert gate.checks[1]["ok"] is None and gate.checks[1]["measured"] == "slow"
        assert gate.checks[1]["detail"] == perf_gate.BAND_NA and len(gate.failed) == 1


def test_no_band_is_invented_under_the_floor():
    gate = perf_gate.Gate("cuda")
    gate.ratio("x.below", 0.5, 0.16, "speedup")
    gate.ratio("x.above", 0.5, 2.3, "speedup")
    gate.ratio("x.met", 1.2, 2.3, "speedup")
    below, above, met = gate.checks
    assert below["ok"] is None and below["finding"] is True and "0.16" in below["detail"]
    assert above["ok"] is False and met["ok"] is True  # band max(1.15, 2.3 / 3)
    cpu = perf_gate.Gate("cpu")
    cpu.ratio("x.below", 0.5, 0.16, "speedup")
    assert cpu.checks[0]["ok"] is None and cpu.checks[0]["detail"] == perf_gate.BAND_NA


@pytest.mark.parametrize("leg,rows", [("trace", 7), ("reqtrace", 7), ("fleet", 8)])
def test_bench_free_legs(leg, rows, tmp_path):
    gate = perf_gate.Gate("cpu", _value_lints())
    getattr(perf_gate, f"run_{leg}_leg")(str(tmp_path), gate)
    assert len(gate.checks) == rows
    assert not gate.failed, gate.failed


def _slow_host(unique=36, dup=0, wins=1):
    el = {"unique_done_tiles": unique, "duplicate_done_records": dup, "tiles_speculated": 1,
          "tiles_stolen": 0, "spec_wins": wins, "idle_gap_pod_s": 1.0, "host_imbalance": 1.1}
    st = {**el, "idle_gap_pod_s": 3.0, "host_imbalance": 1.8}
    return {"slow_host": {"scene": {"tiles": 36}, "static": st, "elastic": el}}


def test_scheduler_and_router_legs_take_reports(tmp_path):
    gate = perf_gate.Gate("cuda")
    perf_gate.run_scheduler_leg(str(tmp_path), gate, _slow_host())
    inv = {"affinity_warm_above_noaff": True, "zero_lost_jobs_across_kill": True,
           "parity_across_legs": True, "no_leg_lost_jobs": True,
           "replicas_launched_kernels": True}
    perf_gate.run_router_leg(str(tmp_path), gate, {"legs": {}, "invariants": inv,
                                                   "launches": {"LAUNCHES": 9}})
    assert len(gate.checks) == 6 + 5 and not gate.failed
    bad = perf_gate.Gate("cuda")
    perf_gate.run_scheduler_leg(str(tmp_path), bad, _slow_host(unique=35, wins=0))
    perf_gate.run_router_leg(str(tmp_path), bad, {"legs": {}, "invariants": {
        **inv, "zero_lost_jobs_across_kill": False}})
    assert {c["check"] for c in bad.failed} == {
        "scheduler.static_no_lost_tiles", "scheduler.elastic_no_lost_tiles",
        "scheduler.speculative_win", "router.zero_lost_jobs_across_kill"}


def test_capacity_leg_holds_the_cards_curve(tmp_path):
    record = json.loads((perf_gate.RECORDS / perf_gate.RECORD_FILES["capacity"]).read_text())
    gate = perf_gate.Gate("cpu")
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    perf_gate.run_capacity_leg(str(tmp_path / "a"), gate, record,
                               {"ok": True, "invariants": {"schema_valid": True}})
    assert not gate.failed, gate.failed
    assert "capacity.smoke_invariants" in {c["check"] for c in gate.checks}
    smoke = {**record, "smoke": True, "device": "cpu"}
    gate = perf_gate.Gate("cpu")
    perf_gate.run_capacity_leg(str(tmp_path / "b"), gate, smoke,
                               {"ok": False, "invariants": {"schema_valid": True}})
    assert {c["check"] for c in gate.failed} == {"capacity.curve_schema",
                                                 "capacity.smoke_invariants"}


def test_flight_bench_runs_the_reps_it_is_given(tmp_path):
    # the gate asks the card's flight leg for FLIGHT_GATE_REPS reps; the
    # CPU run here takes 3, each side timed once a rep, with the dump lint
    from land_trendr_tpu_torch.tools import flight_overhead

    got = flight_overhead.run_bench(smoke=True, out_path=str(tmp_path / "f.json"),
                                    device="cpu", lint_extra=_value_lints(), reps=3)
    assert got["reps"] == 3 and len(got["off_s"]) == len(got["on_s"]) == 3
    assert got["min_off_s"] == min(got["off_s"]) and got["min_on_s"] == min(got["on_s"])
    assert got["flight"]["dump_valid"] is True and got["flight"]["samples"] >= 1
    assert json.loads((tmp_path / "f.json").read_text())["reps"] == 3
