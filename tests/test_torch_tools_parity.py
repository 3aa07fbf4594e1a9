"""The port's parity tools on the CPU: ``tools/parity_f32.py`` and
``tools/impl_identity.py`` at 2 x 4,096 px with ``--device cpu``.

The port's float64 decisions equal the JAX package's XLA kernel
(``jax_segment_pixels`` in float64) on the same population exactly; the
port's float32 leg meets the 99.9% exact-vertex floor with a taxonomy that
sums to the pixel count; and the port's population is byte-for-byte the JAX
tool's for the same seeds (so the card's numbers are on
``PARITY_f32.json``'s pixels).
"""

import json

import numpy as np
import pytest
import torch

from land_trendr_tpu.config import LTParams as JLTParams
from land_trendr_tpu.ops.segment import jax_segment_pixels
from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.tools import impl_identity, parity_f32
from tools._population import make_population as jax_population

torch.set_num_threads(1)

PX = 4096


@pytest.mark.parametrize("seed", [0, 1, 15])
def test_population_is_the_jax_tools(seed):
    mine = parity_f32.make_population(PX, parity_f32.NY, seed)
    ref = jax_population(np.random.default_rng(seed), PX, parity_f32.NY)
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1])
def test_float64_decisions_equal_the_xla_kernel(seed):
    years, vals, mask = parity_f32.make_population(PX, parity_f32.NY, seed)
    mine = parity_f32.segment_leg(years, vals, mask, LTParams(), torch.device("cpu"),
                                  torch.float64)
    ref = jax_segment_pixels(years, vals, mask, JLTParams())
    for field in ("vertex_indices", "n_vertices", "model_valid"):
        np.testing.assert_array_equal(getattr(mine, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)


def test_parity_f32_measure_on_cpu():
    """Two population seeds of PX pixels each: the taxonomy and its floors."""
    rec = parity_f32.measure(2 * PX, torch.device("cpu"), chunk=PX, verbose=False)
    assert rec["n_pixels"] == 2 * PX and rec["platform"] == "cpu" and rec["chunk"] == PX
    tax = rec["taxonomy"]
    assert set(tax) == {"exact", "valid_flip", "count_diff", "placement"}
    assert sum(v["count"] for v in tax.values()) == 2 * PX
    assert rec["exact_vertex_agreement"] >= 0.999
    assert rec["exact_vertex_agreement"] == tax["exact"]["count"] / (2 * PX)
    assert 0 <= rec["rmse_abs_delta_max"] < 1e-4
    assert 0 <= rec["fitted_abs_delta_p99_max"] < 1e-5
    # the CPU runs the plain version: no kernel launched
    assert all(v == 0 for v in rec["launches"].values())


def test_parity_f32_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "parity.json"
    assert parity_f32.main([str(PX), str(out), "--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    assert rec["n_pixels"] == PX and rec["platform"] == "cpu"
    assert rec["chunk"] == parity_f32.CHUNK == 65_536  # PARITY_f32.json's seeding
    assert sum(v["count"] for v in rec["taxonomy"].values()) == PX
    assert all(v == 0 for v in rec["launches"].values())
    assert json.loads(capsys.readouterr().out) == rec


def test_parity_f32_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert parity_f32.main(["64", str(tmp_path / "p.json")]) == 2
    assert not (tmp_path / "p.json").exists()


@pytest.mark.parametrize("ny,px,params", [(40, 2 * PX, '{"max_segments": 5}'), (72, 2048, None)])
def test_impl_identity_cli_on_cpu(tmp_path, capsys, ny, px, params):
    out = tmp_path / "ident.json"
    argv = ["--px", str(px), "--ny", str(ny), "--device", "cpu", "--out", str(out)]
    if params:
        argv += ["--params", params]
    assert impl_identity.main(argv) == 0
    rec = json.loads(out.read_text())
    assert rec["n_pixels"] == px and rec["n_years"] == ny
    assert rec["decisions_identical"] is True
    for k in ("pixel_exact_vertex_indices", "model_valid_equal", "n_vertices_equal",
              "p_of_f_bitwise_equal", "float_fields_bitwise_equal"):
        assert rec[k] == px, k
    assert rec["fitted_abs_delta_max"] == 0.0 and rec["p_of_f_rel_delta_max"] == 0.0
    assert rec["instantiation"] == ("narrow" if ny == 40 else "wide")
    assert rec["params"]["max_segments"] == (5 if params else 6)
    assert all(v == 0 for v in rec["launches"].values())
