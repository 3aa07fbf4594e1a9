"""The port's elastic soak (``land_trendr_tpu_torch/tools/elastic_soak.py``)
on the CPU at the JAX tool's sizes: the churn leg (a SIGKILL with leases
held, a late joiner, no resume; every tile durable and byte-equal to a
clean run) and the slow-host leg (a two-process ``gloo`` pod; the lease
queue with speculation against the static split).
"""

import json

import pytest

from land_trendr_tpu_torch.tools import elastic_soak


def test_elastic_soak_smoke_both_legs(tmp_path):
    report = elastic_soak.soak(smoke=True, keep=str(tmp_path / "soak"), device="cpu",
                               verbose=False)
    assert report["ok"] is True
    churn = report["churn"]
    assert churn["tiles"] == churn["artifacts"] == churn["tiles_done"] == 16
    assert churn["artifacts_identical"] and churn["completed_without_resume"]
    assert churn["steals"] >= 1 and churn["late_joiner_tiles"] >= 1
    slow = report["slow_host"]
    st, el = slow["static"], slow["elastic"]
    assert st["unique_done_tiles"] == el["unique_done_tiles"] == 36
    assert el["idle_gap_pod_s"] < st["idle_gap_pod_s"]
    assert el["host_imbalance"] < st["host_imbalance"]
    assert el["spec_wins"] >= 1 and st["spec_wins"] == 0
    assert report["churn_s"] > 0 and report["slow_host_s"] > 0


def test_worker_config_round_trip(tmp_path):
    path = elastic_soak._write_worker_cfg(
        tmp_path / "w.json", str(tmp_path / "wd"), 80, 20, {"lease_batch": 2}, "cpu",
        summary_path=str(tmp_path / "s.json"), height=40, years=7)
    cfg = json.loads(open(path).read())
    assert (cfg["width"], cfg["height"], cfg["years"], cfg["device"]) == (80, 40, 7, "cpu")
    assert cfg["run"] == {"lease_batch": 2} and cfg["out_dir"].endswith("wd_o")
    assert elastic_soak._worker_env("cpu")["OMP_NUM_THREADS"]


def test_cli_refuses_a_missing_card(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert elastic_soak.main(["--smoke"]) == 2
    assert "cuda" in capsys.readouterr().err
