"""The port's serving and observability benches at smoke size on the CPU:
``serve_bench``, ``batch_bench``, ``flight_overhead`` and ``tune_bench``.

Each runs end to end with ``--device cpu`` against the real in-process
server or driver, and its exact invariants hold: the warm job runs zero
kernel-library loads, zero program-cache misses and zero TIFF decodes with
artifacts byte-identical to the cold job's; the flood coalesces behind
shared launches at full occupancy while the unbatched leg never batches,
every artifact byte-identical; the flight dump is schema-valid under the
JAX package's value lints and carries sampler events; the tuning store
reloads with zero probes and the tuned run's artifacts equal the default
run's.  Timing verdicts are reported, not asserted here.
"""

import json

import pytest
import torch

from land_trendr_tpu_torch.tools import batch_bench, flight_overhead, serve_bench, tune_bench

torch.set_num_threads(1)


def test_serve_bench_smoke(tmp_path):
    out = tmp_path / "serve.json"
    assert serve_bench.main(["--smoke", "--out", str(out), "--device", "cpu"]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] is True and rep["parity_ok"] is True
    assert rep["invariants"] == {"warm_zero_compiles": True, "warm_zero_decodes": True,
                                 "cold_compiled": True}
    assert rep["warm"]["program_cache"]["misses"] == 0 and rep["warm"]["library_loads"] == 0
    assert rep["cold"]["program_cache"]["misses"] == 1
    assert rep["warm"]["ingest_store"]["hits"] > 0
    assert rep["cold"]["launches"] == rep["warm"]["launches"] == 0  # the plain version
    assert rep["reps"] == 1 and rep["speedup_reps"] == [rep["speedup_warm"]]


def test_serve_bench_reps_report_the_median_pair(tmp_path):
    """Each pair a fresh server (its own program cache and ingest store):
    every cold job misses and decodes, every warm one hits; the median
    speedup's pair stands for the run."""
    out = tmp_path / "serve.json"
    assert serve_bench.main(["--smoke", "--reps", "3", "--out", str(out), "--device",
                             "cpu"]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] is True and rep["parity_ok"] is True and rep["reps"] == 3
    assert all(rep["invariants"].values()) and len(rep["speedup_reps"]) == 3
    assert rep["speedup_warm"] == sorted(rep["speedup_reps"])[1]
    assert rep["speedup_warm"] == round(rep["cold"]["latency_s"] / rep["warm"]["latency_s"], 2)


def test_batch_bench_smoke(tmp_path):
    out = tmp_path / "batch.json"
    assert batch_bench.main(["--smoke", "--out", str(out), "--device", "cpu"]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] is True and rep["parity_ok"] is True
    assert all(rep["invariants"].values()) and "launch_arithmetic" not in rep["invariants"]
    assert rep["base"]["launches"] == 0 and rep["base"]["done"] == rep["workload"]["jobs"] == 8
    assert rep["batched"]["jobs_per_launch"] > 1
    assert rep["batched"]["occupancy"] >= 0.9
    assert set(rep["timing"]) == {"batched_faster", "p99_lower"}
    assert rep["reps"] == 1 and rep["speedup_reps"] == [rep["speedup_batched"]]
    assert rep["base"]["max_s"] >= rep["base"]["p99_s"] >= rep["base"]["p50_s"]


def test_batch_bench_reps_report_the_median_pair(tmp_path):
    out = tmp_path / "batch.json"
    assert batch_bench.main(["--smoke", "--reps", "3", "--out", str(out), "--device",
                             "cpu"]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] is True and rep["parity_ok"] is True and rep["reps"] == 3
    assert len(rep["speedup_reps"]) == 3
    assert rep["speedup_batched"] == sorted(rep["speedup_reps"])[1]
    assert rep["batched"]["occupancy"] >= 0.9


def test_flight_overhead_smoke(tmp_path):
    from tools.check_events_schema import value_lints

    rep = flight_overhead.run_bench(smoke=True, out_path=str(tmp_path / "f.json"),
                                    device="cpu", lint_extra=value_lints)
    assert rep["flight"]["dump_valid"] is True, rep["flight"]["dump_errors"]
    assert rep["flight"]["samples"] >= 1
    assert rep["reps"] == 2 and len(rep["off_s"]) == len(rep["on_s"]) == 2
    assert rep["noise_band_pct"] == flight_overhead.NOISE_BAND_PCT
    assert json.loads((tmp_path / "f.json").read_text())["overhead_min_pct"] == \
        rep["overhead_min_pct"]


def test_tune_bench_smoke(tmp_path):
    out = tmp_path / "tune.json"
    assert tune_bench.main(["--smoke", "--out", str(out), "--device", "cpu"]) == 0
    rep = json.loads(out.read_text())
    inv = rep["invariants"]
    for k in ("warm_zero_probes", "warm_identical_knobs", "profile_roundtrip_byte_stable",
              "resolution_deterministic", "artifacts_byte_identical", "run_tune_profile_event",
              "all_groups_probed", "tuned_never_worse_than_default"):
        assert inv[k] is True, k
    assert rep["legs"]["warm"]["source"] == "store" and rep["legs"]["probe"]["probes"] > 0


@pytest.mark.parametrize("bench", [serve_bench, batch_bench, flight_overhead, tune_bench],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_needs_a_card_by_default(bench, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert bench.main(["--smoke", "--out", str(tmp_path / "x.json")]) == 2
    assert "cuda" in capsys.readouterr().err
