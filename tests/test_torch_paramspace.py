"""The port's ``tools/parity_paramspace.py``: the JAX tool's joint draw, and
exact float64 decisions over it on the CPU.

The draw (``sample_params`` / ``make_batch`` from ``default_rng(seed)``)
must equal the JAX tool's for the same seeds: the same ``LTParams`` and the
same pixels.  Four trials of 64 pixels (seed base 2000, the JAX record's)
go through the port's plain version in float64 and are held exactly —
``vertex_indices``, ``n_vertices``, ``model_valid`` on every pixel —
against the port's oracle and the JAX package's XLA kernel
(``ops/segment.py:jax_segment_pixels``, float64 on the CPU).  The tool's
CLI runs with ``--device cpu``; the kernel-form checks are card-only
(``tests/test_torch_cuda.py``).
"""

import json

import numpy as np
import pytest
import torch

from land_trendr_tpu.config import LTParams as JLTParams
from land_trendr_tpu.ops.segment import jax_segment_pixels
from land_trendr_tpu_torch.ops.segment import torch_segment_pixels
from land_trendr_tpu_torch.tools import parity_paramspace as pp

torch.set_num_threads(1)

SEEDS = [2000 + k for k in range(4)]


def _jax_tool():
    from tools import parity_paramspace as jpp

    return jpp


@pytest.mark.parametrize("seed", [1000, 1001, 1255, 2000, 2003, 2255])
def test_draw_is_the_jax_tools(seed):
    jpp = _jax_tool()
    r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
    ny_p, ny_j = int(r_port.choice([16, 24, 40])), int(r_jax.choice([16, 24, 40]))
    assert ny_p == ny_j
    assert pp.sample_params(r_port, ny_p).to_dict() == jpp.sample_params(r_jax, ny_j).to_dict()
    for a, b in zip(pp.make_batch(r_port, 64, ny_p), jpp.make_batch(r_jax, 64, ny_j)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # draw_trial is that same sequence
    ny, params, years, vals, mask = pp.draw_trial(seed)
    r_jax = np.random.default_rng(seed)
    assert ny == int(r_jax.choice([16, 24, 40]))
    assert params.to_dict() == jpp.sample_params(r_jax, ny).to_dict()
    for a, b in zip((years, vals, mask), jpp.make_batch(r_jax, pp.PX, ny)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_f64_exact_against_oracle_and_jax(seed):
    ny, params, years, vals, mask = pp.draw_trial(seed)
    o_vi, o_nv, o_mv = pp.oracle_decisions(seed)
    out = torch_segment_pixels(torch.from_numpy(years), torch.from_numpy(vals),
                               torch.from_numpy(mask), params)
    vi = out.vertex_indices.numpy().astype(np.int64)
    assert np.array_equal(vi, o_vi), (seed, params)
    assert np.array_equal(out.n_vertices.numpy(), o_nv)
    assert np.array_equal(out.model_valid.numpy(), o_mv)
    ref = jax_segment_pixels(years.astype(np.float64), vals, mask,
                             JLTParams(**params.to_dict()))
    assert np.array_equal(np.asarray(ref.vertex_indices).astype(np.int64), vi)
    assert np.array_equal(np.asarray(ref.n_vertices), out.n_vertices.numpy())
    assert np.array_equal(np.asarray(ref.model_valid), out.model_valid.numpy())


def test_cli_on_cpu(tmp_path):
    out = tmp_path / "pp.json"
    assert pp.main(["2", str(out), "--seed-base", "1000,2000", "--workers", "1",
                    "--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    assert rec["ok"] is True and rec["device"] == "cpu"
    assert rec["trials"] == 4 and rec["pixels_total"] == rec["exact"] == 4 * pp.PX
    assert rec["per_seed_base"] == {b: {"trials": 2, "pixels": 128, "exact": 128}
                                    for b in ("1000", "2000")}
    assert rec["forms_bit_identical_trials"] == "n/a (no kernel on the CPU)"
    assert rec["mismatches"] == [] and rec["sampled_space"] == pp.SAMPLED_SPACE
    assert all(v == 0 for v in rec["launches"].values())
    assert rec["command"].endswith("--device cpu") and rec["nvidia_smi"] is None


def test_cli_needs_a_card_by_default(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert pp.main(["1", str(tmp_path / "x.json")]) == 2
    assert "cuda" in capsys.readouterr().err
