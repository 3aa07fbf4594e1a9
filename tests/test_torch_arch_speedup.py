"""The port's ``arch_speedup`` and ``run_segment_measured`` on the CPU.

* The port's ``make_series`` equals the JAX package's ``bench.make_series``
  for the same ``(px, ny, seed)``, array for array and dtype for dtype.
* A tiny ``arch_speedup --device cpu`` writes a record with the JAX
  record's keys (``ARCH_SPEEDUP_r04.json``) less the TPU ones, plus the
  command, commit and source digest, and no card entry.
* ``run_segment_measured`` on a tiny synthetic stack prints the CLI's
  summary on stdout and ``{"peak_rss_mib": > 0}`` on stderr, and with a
  leading ``--out`` also writes a record.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bench import make_series as jax_make_series
from land_trendr_tpu_torch.tools import arch_speedup
from land_trendr_tpu_torch.tools.measure import child_env
from land_trendr_tpu_torch.tools.population import make_series

ROOT = Path(__file__).resolve().parent.parent
#: the JAX record's keys that carry TPU numbers
TPU_KEYS = {"tpu_px_s", "tpu_bench_note", "speedup_tpu_vs_reference_style"}


@pytest.mark.parametrize("px, ny, seed", [(64, 40, 7), (257, 24, 3), (1000, 12, 20261017)])
def test_make_series_equals_bench(px, ny, seed):
    mine, theirs = make_series(px, ny, seed), jax_make_series(px, ny, seed)
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_record_has_the_jax_schema_without_tpu_keys(tmp_path):
    out = tmp_path / "ARCH_SPEEDUP.json"
    assert arch_speedup.main(["8", "128", "--reps", "1", "--device", "cpu",
                              "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    with open(ROOT / "ARCH_SPEEDUP_r04.json") as f:
        jax_keys = set(json.load(f)) - TPU_KEYS
    assert jax_keys <= set(rec) and not TPU_KEYS & set(rec)
    assert rec["oracle_px"] == 8 and rec["kernel_px"] == 128 and rec["years"] == 40
    assert rec["oracle_px_s"] > 0 and rec["kernel_cpu_px_s"] > 0
    assert 0 < rec["kernel_fit_rate"] <= 1 and "card" not in rec
    assert rec["device"] == "cpu" and rec["nvidia_smi"] is None and rec["source_sha256"]


def test_run_segment_measured(tmp_path):
    env = child_env(OMP_NUM_THREADS="1")
    subprocess.run([sys.executable, "-m", "land_trendr_tpu_torch", "--device", "cpu", "synth",
                    "D", "--size", "32"], cwd=tmp_path, env=env, check=True,
                   capture_output=True, timeout=120)
    r = subprocess.run([sys.executable, "-m", "land_trendr_tpu_torch.tools.run_segment_measured",
                        "--out", "rec.json", "--device", "cpu", "segment", "D",
                        "--tile-size", "16", "--workdir", "W", "--out-dir", "O"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    summary = json.loads(r.stdout)["summary"]
    assert summary["tiles_done"] == 4 and summary["pixels"] == 32 * 32
    peak = json.loads(r.stderr.strip().splitlines()[-1])
    assert set(peak) == {"peak_rss_mib"} and peak["peak_rss_mib"] > 0
    rec = json.loads((tmp_path / "rec.json").read_text())
    assert rec["rc"] == 0 and rec["summary"] == summary and rec["peak_rss_mib"] == peak["peak_rss_mib"]
    assert rec["device"] == "cpu" and os.path.isdir(tmp_path / "O")
