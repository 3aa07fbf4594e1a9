"""The wide path on the CPU: stacks of more than 64 years and params of
more than 16 candidates, which the CUDA kernels' wide instantiation
takes, and what lies above its caps (the global form).

The port's plain version (what the wide and the global forms are held
against on the card) against the JAX XLA kernel and the oracle on the same numpy
inputs: decisions exact in float64 (floats within ``tests/test_parity.py``'s
tolerances), >= 99.9% in float32 against the float64 truth.  Then
``Run`` with its device resolved to a card admits a stack or params
beyond the wide caps, as the JAX package does, and writes nothing until
it executes.
"""

import numpy as np
import pytest
import torch

from land_trendr_tpu.config import LTParams as JLTParams
from land_trendr_tpu.models import oracle
from land_trendr_tpu.ops.segment import jax_segment_pixels
from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops import segment_cuda as sc
from land_trendr_tpu_torch.ops.segment import torch_segment_pixels
from tools._population import make_population

torch.set_num_threads(1)

DECISIONS = ("vertex_indices", "n_vertices", "model_valid")
#: (NY, LTParams overrides): 72 years at default params, and 18
#: candidates at 40 years — the two populations of the smoke's phase 2c
WIDE = {
    "ny72": (72, {}),
    "nc18": (40, {"max_segments": 14, "vertex_count_overshoot": 3}),
}
#: the same above the wide caps, where the card runs the global form: 160
#: years (three 64-bit words a vertex set) at default params, and 40
#: candidates at 40 years — the two populations of the smoke's phase 2d
GLOBAL = {
    "ny160": (160, {}),
    "nc40": (40, {"max_segments": 36, "vertex_count_overshoot": 3}),
}
#: pixels of each population: fewer above the caps, where the float64
#: oracle's candidate search is the slow part
CASE_PX = {"wide": 384, "global": 128}


def _port(years, vals, mask, params):
    out = torch_segment_pixels(torch.from_numpy(years), torch.from_numpy(vals),
                               torch.from_numpy(mask), params)
    return {k: v.numpy() for k, v in out._asdict().items()}


@pytest.fixture(scope="module", params=sorted(WIDE) + sorted(GLOBAL))
def wide_case(request):
    form = "wide" if request.param in WIDE else "global"
    ny, over = {**WIDE, **GLOBAL}[request.param]
    params = LTParams(**over)
    assert sc.instantiation(ny, params) == form
    years, vals, mask = make_population(np.random.default_rng(20261017), CASE_PX[form], ny)
    years = years.astype(np.float64)
    vals = vals.astype(np.float64)
    ref = {k: np.asarray(v) for k, v in jax_segment_pixels(
        years, vals, mask, JLTParams(**params.to_dict()))._asdict().items()}
    return request.param, years, vals, mask, params, ref


def test_wide_f64_matches_jax_xla(wide_case):
    name, years, vals, mask, params, ref = wide_case
    got = _port(years, vals, mask, params)
    for field in DECISIONS:
        np.testing.assert_array_equal(got[field], ref[field], err_msg=f"{name} {field}")
    for field in ("vertex_years", "vertex_src_vals", "vertex_fit_vals", "seg_magnitude",
                  "seg_duration", "seg_rate", "fitted", "despiked", "rmse"):
        np.testing.assert_allclose(got[field], ref[field], atol=1e-8, rtol=1e-7,
                                   err_msg=f"{name} {field}")
    np.testing.assert_allclose(got["p_of_f"], ref["p_of_f"], atol=1e-9, err_msg=name)
    # the fitted models use the wide capacity: some pixel needs it
    assert int(got["n_vertices"].max()) >= 2


def test_wide_f64_matches_the_oracle(wide_case):
    name, years, vals, mask, params, _ref = wide_case
    got = _port(years, vals, mask, params)
    jp = JLTParams(**params.to_dict())
    for i in range(0, len(vals), 8):
        r = oracle.segment_series(years, vals[i], mask[i], jp)
        assert got["model_valid"][i] == r.model_valid, (name, i)
        assert got["n_vertices"][i] == r.n_vertices, (name, i)
        np.testing.assert_array_equal(got["vertex_indices"][i], r.vertex_indices,
                                      err_msg=f"{name} px {i}")
        np.testing.assert_allclose(got["vertex_fit_vals"][i], r.vertex_fit_vals,
                                   atol=1e-8, rtol=1e-7, err_msg=f"{name} px {i}")


def test_wide_f32_decisions_against_the_f64_truth(wide_case):
    name, years, vals, mask, params, ref = wide_case
    got = _port(years.astype(np.float32), vals.astype(np.float32), mask, params)
    agree = (
        (got["model_valid"] == ref["model_valid"])
        & (got["n_vertices"] == ref["n_vertices"])
        & (got["vertex_indices"] == ref["vertex_indices"]).all(axis=1)
    )
    assert agree.mean() >= 0.999, (name, agree.mean())


def test_more_than_16_candidates_are_used():
    # at 18 candidates the family has 14 members: the wide kernel's arrays
    # beyond the narrow 16 are live (more than 7 vertices chosen somewhere)
    ny, over = WIDE["nc18"]
    params = LTParams(**over)
    years, vals, mask = make_population(np.random.default_rng(20261017), 384, ny)
    got = _port(years.astype(np.float64), vals.astype(np.float64), mask, params)
    assert got["vertex_indices"].shape[1] == 15
    assert int(got["n_vertices"].max()) > 7


# ---------------------------------------------------------------------------
# Run on a card: no cap (beyond the wide caps the global form runs)


def _stack(ny: int):
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
    from land_trendr_tpu_torch.runtime.stack import stack_from_synthetic

    return stack_from_synthetic(make_stack(SceneSpec(width=8, height=8, year_start=1900,
                                                     year_end=1900 + ny - 1, seed=1)))


@pytest.fixture()
def on_card(monkeypatch):
    """The run's device resolved to a card (this machine has none)."""
    from land_trendr_tpu_torch.runtime import driver

    monkeypatch.setattr(driver, "resolve_device", lambda device: torch.device("cuda", 0))
    return driver


@pytest.mark.parametrize(
    "ny,over",
    [(129, {}), (40, {"max_segments": 26, "vertex_count_overshoot": 6})],
    # the test's name and ids date from when the card refused these shapes
    ids=["129-over0-129 exceeds the kernel's 128-year capacity", "40-over1-candidate capacity 32"],
)
def test_run_refuses_beyond_the_wide_caps_before_the_workdir(on_card, tmp_path, ny, over):
    # beyond the wide kernel's caps (129 years; 33 candidates) a card Run
    # is admitted, as the JAX package's is: the global form takes the
    # shape, and nothing is written yet
    stack = _stack(ny)
    assert stack.n_years == ny
    params = LTParams(**over)
    assert ny > sc.WIDE_NY or params.max_candidates > sc.WIDE_NC
    cfg = on_card.RunConfig(workdir=str(tmp_path / "w"), out_dir=str(tmp_path / "o"),
                            tile_size=8, params=params)
    run = on_card.Run(stack, cfg)
    assert run.device.type == "cuda"
    assert sc.instantiation(ny, params) == "global"
    assert not (tmp_path / "w").exists() and not (tmp_path / "o").exists()


@pytest.mark.parametrize(
    "ny,over",
    [(128, {}), (64, {"max_segments": 25, "vertex_count_overshoot": 6})],
)
def test_run_admits_the_wide_caps(on_card, tmp_path, ny, over):
    cfg = on_card.RunConfig(workdir=str(tmp_path / "w"), out_dir=str(tmp_path / "o"),
                            tile_size=8, params=LTParams(**over))
    run = on_card.Run(_stack(ny), cfg)
    assert run.device.type == "cuda"
    assert not (tmp_path / "w").exists()


def test_cpu_run_has_no_cap(tmp_path):
    # the plain version holds any length: a 130-year stack runs on the CPU
    from land_trendr_tpu_torch.runtime import RunConfig, run_stack

    cfg = RunConfig(workdir=str(tmp_path / "w"), out_dir=str(tmp_path / "o"), tile_size=8)
    summary = run_stack(_stack(130), cfg, device="cpu")
    assert summary["tiles_done"] == 1 and summary["impl"] == "torch"
