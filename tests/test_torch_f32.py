"""Float32 quality of the port's plain segmentation, and its own float64
incomplete beta.

Mirrors ``tests/test_f32_quality.py``: the float32 pipeline must agree
exactly (vertex placement, count, validity) with the float64 truth on at
least 99.9% of an 8192-pixel mixed-regime population, with the same tail
bounds on the agreeing pixels.  The float64 truth is the oracle, reached
through the JAX kernel (``jax_segment_pixels`` in float64, which
``tests/test_parity.py`` holds to the oracle decision for decision) and
spot-checked against the oracle itself.
"""

import numpy as np
import pytest
import scipy.special
import torch

from land_trendr_tpu.config import LTParams as JLTParams
from land_trendr_tpu.models.oracle import segment_series
from land_trendr_tpu.ops.segment import (
    _betainc_p_and_logp_lentz,
    _lgamma_fixed,
    jax_segment_pixels,
)
from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops.segment import (
    betainc,
    betainc_p_and_logp_lentz,
    lentz_iters,
    lgamma_fixed,
    torch_segment_pixels,
)

# the suite runs several workers per host: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)


PX = 8192


def _mixed_population(rng, px, ny=40):
    """The population of ``tests/test_f32_quality.py``."""
    years = np.arange(1984, 1984 + ny, dtype=np.int32)
    t = np.arange(ny, dtype=np.float64)[None, :]
    kind = rng.integers(0, 5, size=(px, 1))
    base = rng.uniform(0.45, 0.75, size=(px, 1))
    d_year = rng.integers(4, ny - 4, size=(px, 1))
    mag = rng.uniform(0.1, 0.5, size=(px, 1))
    rec = rng.uniform(0.02, 0.15, size=(px, 1))
    dt = np.maximum(t - d_year, 0.0)
    disturbance = np.where(t >= d_year, mag * np.exp(-rec * dt), 0.0)
    step = np.where(t >= d_year, mag, 0.0)
    trend = rng.uniform(-0.01, 0.01, size=(px, 1)) * t
    walk = np.cumsum(rng.normal(0, 0.03, size=(px, ny)), axis=1)
    traj = base - np.where(
        kind == 0, disturbance,
        np.where(kind == 1, step,
                 np.where(kind == 2, trend,
                          np.where(kind == 3, walk * 0.2, 0.0))),
    )
    traj += rng.normal(0.0, 0.012, size=(px, ny))
    mask = rng.uniform(size=(px, ny)) > 0.08
    return years, -traj, mask


@pytest.fixture(scope="module")
def runs():
    rng = np.random.default_rng(20260729)
    years, vals, mask = _mixed_population(rng, PX)
    truth = {
        k: np.asarray(v)
        for k, v in jax_segment_pixels(years, vals, mask, JLTParams())._asdict().items()
    }
    out32 = torch_segment_pixels(
        torch.from_numpy(years), torch.from_numpy(vals.astype(np.float32)),
        torch.from_numpy(mask), LTParams(),
    )
    got = {k: v.numpy() for k, v in out32._asdict().items()}
    agree = (
        (truth["model_valid"] == got["model_valid"])
        & (truth["n_vertices"] == got["n_vertices"])
        & (truth["vertex_indices"] == got["vertex_indices"]).all(axis=1)
    )
    return years, vals, mask, truth, got, agree


def test_f32_exact_vertex_agreement_floor(runs):
    *_, agree = runs
    rate = agree.mean()
    assert rate >= 0.999, f"f32 exact-vertex agreement {rate:.4%} below floor"


def test_f64_truth_is_the_oracle(runs):
    """The float64 truth above equals the oracle's decisions (spot check)."""
    years, vals, mask, truth, _, _ = runs
    for i in range(0, PX, 64):
        ref = segment_series(years, vals[i], mask[i], JLTParams())
        assert truth["model_valid"][i] == ref.model_valid
        np.testing.assert_array_equal(truth["vertex_indices"][i], ref.vertex_indices)


def test_f32_tail_magnitude(runs):
    _, _, _, truth, got, agree = runs
    d_fit = np.abs(got["fitted"].astype(np.float64) - truth["fitted"])[agree]
    d_rmse = np.abs(got["rmse"].astype(np.float64) - truth["rmse"])[agree]
    assert np.quantile(d_fit, 0.99) < 4e-6, "fitted-trajectory p99 tail fattened"
    assert np.quantile(d_fit, 0.999) < 1e-5, "fitted-trajectory p99.9 tail fattened"
    assert np.quantile(d_rmse, 0.99) < 5e-7, "rmse p99 tail fattened"
    assert np.quantile(d_rmse, 0.999) < 2e-6, "rmse p99.9 tail fattened"


def test_f32_matches_jax_f32_decisions(runs):
    """The port's float32 pipeline and the JAX kernel's make the same
    decisions on (almost) every pixel."""
    years, vals, mask, _, got, _ = runs
    j32 = jax_segment_pixels(years, vals.astype(np.float32), mask, JLTParams())
    same = (
        (np.asarray(j32.model_valid) == got["model_valid"])
        & (np.asarray(j32.vertex_indices) == got["vertex_indices"]).all(axis=1)
    )
    assert same.mean() >= 0.999


def _ftest_domain(ny_max, m_max, n_f=400, seed=0):
    rng = np.random.default_rng(seed)
    a_l, b_l, x_l = [], [], []
    for n in range(6, ny_max + 1):
        for m in range(1, m_max + 1):
            df1, df2 = 2 * m - 1, n - 2 * m
            if df2 < 1:
                continue
            f = 10 ** rng.uniform(-3, 4, n_f)
            x = df2 / (df2 + df1 * f)
            a_l.append(np.full_like(x, df2 / 2.0))
            b_l.append(np.full_like(x, df1 / 2.0))
            x_l.append(x)
    return np.concatenate(a_l), np.concatenate(b_l), np.concatenate(x_l)


@pytest.mark.parametrize("ny_max,m_max", [(40, 6), (64, 15)])
def test_betainc_f64_against_scipy(ny_max, m_max):
    """The float64 F-test's own betainc over the (a, b, x) domain the F
    test reaches (n valid years up to NY, m segments up to max_segments):
    within 1e-13 relative of ``scipy.special.betainc``."""
    a, b, x = _ftest_domain(ny_max, m_max)
    ref = scipy.special.betainc(a, b, x)
    got = betainc(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(x)).numpy()
    ok = ref > 1e-300
    rel = np.abs(got[ok] - ref[ok]) / ref[ok]
    assert rel.max() < 1e-13, rel.max()


def test_betainc_edges():
    a = torch.tensor([2.0, 3.5, 0.5, 7.0], dtype=torch.float64)
    b = torch.tensor([1.5, 0.5, 2.5, 4.0], dtype=torch.float64)
    x = torch.tensor([0.0, 1.0, 0.5, 0.3], dtype=torch.float64)
    got = betainc(a, b, x).numpy()
    ref = scipy.special.betainc(a.numpy(), b.numpy(), x.numpy())
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=0)
    assert got[0] == 0.0 and got[1] == 1.0


def test_betainc_non_half_integer_arguments():
    """Arguments outside the F test's half-integers take the log-gamma path."""
    a = torch.tensor([1.3, 4.7, 12.25], dtype=torch.float64)
    b = torch.tensor([0.7, 2.2, 3.9], dtype=torch.float64)
    x = torch.tensor([0.2, 0.6, 0.9], dtype=torch.float64)
    np.testing.assert_allclose(
        betainc(a, b, x).numpy(),
        scipy.special.betainc(a.numpy(), b.numpy(), x.numpy()),
        rtol=1e-12,
    )


def test_lentz_f32_matches_jax():
    """The float32 scorer is the JAX package's expression for expression.

    The two frameworks' float32 log/exp differ by an ulp or so, and XLA may
    fuse the expression differently, so the values agree within the
    scorer's own validated envelope (max relative p error 2e-4 against
    exact, ``tests/test_f32_quality.py``), not bit for bit."""
    a, b, x = _ftest_domain(40, 6, n_f=50)
    p_t, lp_t = betainc_p_and_logp_lentz(
        torch.from_numpy(a.astype(np.float32)),
        torch.from_numpy(b.astype(np.float32)),
        torch.from_numpy(x.astype(np.float32)),
        iters=lentz_iters(40),
    )
    p_j, lp_j = _betainc_p_and_logp_lentz(
        a.astype(np.float32), b.astype(np.float32), x.astype(np.float32), iters=lentz_iters(40)
    )
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=2e-4, atol=1e-3)
    z = np.linspace(0.5, 40.0, 200).astype(np.float32)
    np.testing.assert_allclose(
        lgamma_fixed(torch.from_numpy(z)).numpy(), np.asarray(_lgamma_fixed(z)),
        rtol=1e-5, atol=1e-5,
    )


@pytest.mark.parametrize("ny,iters", [(20, 12), (40, 12), (64, 15), (100, 18)])
def test_lentz_iters_rule(ny, iters):
    from land_trendr_tpu.ops.segment import _lentz_iters

    assert lentz_iters(ny) == _lentz_iters(ny) == iters


def _scene_nbr(spec: dict):
    """A synthetic scene's NBR series as the port's tile program makes them
    (float32 reflectance from DNs, QA and range masks), as float64 numpy."""
    from land_trendr_tpu.io.synthetic import SceneSpec, make_stack
    from land_trendr_tpu_torch.ops import indices as idx

    st = make_stack(SceneSpec(**spec))
    ny, px = len(st.years), spec["width"] * spec["height"]
    sr = {
        b: idx.scale_sr(torch.from_numpy(np.ascontiguousarray(st.dn(b).reshape(ny, px).T)),
                        2.75e-5, -0.2)
        for b in ("nir", "swir2")
    }
    qa = torch.from_numpy(np.ascontiguousarray(st.qa.reshape(ny, px).T.astype(np.uint16)))
    mask = (idx.qa_valid_mask(qa, idx.DEFAULT_QA_REJECT) & idx.sr_valid_mask(sr)).numpy()
    vals = idx.compute_index("nbr", sr).numpy().astype(np.float64)
    return st.years.astype(np.float64), vals, mask


@pytest.mark.parametrize(
    "scene,spec,over",
    [
        # the 9-year, 4-segment job of tests/test_torch_serve.py
        ("serve_9yr", dict(width=40, height=40, year_start=2000, year_end=2008, seed=3),
         dict(max_segments=4, vertex_count_overshoot=2)),
        ("default_40yr", dict(width=40, height=40, seed=3), {}),
    ],
)
def test_f32_fit_tail_against_float64_on_scenes(scene, spec, over, capsys):
    """The float32 tail of the fitted vertex values against the float64
    truth, the port's beside the JAX XLA kernel's, on two synthetic scenes
    (the numbers of ROADMAP section 3.2; run with ``-s`` to print them).

    Decisions agree exactly in float64 and on >= 99.9% in float32.  Both
    packages' tails stay inside the JAX package's 1e-5 contract (p99.9),
    and the port's tail, which fits in the frame centred on each segment,
    is no wider than the JAX package's: neither its p99.9 nor its max."""
    years, vals, mask = _scene_nbr(spec)
    params = LTParams(**over)
    jp = JLTParams(**params.to_dict())
    out = {}
    for dt in (np.float32, np.float64):
        t = torch_segment_pixels(torch.from_numpy(years.astype(dt)),
                                 torch.from_numpy(vals.astype(dt)), torch.from_numpy(mask), params)
        j = jax_segment_pixels(years.astype(dt), vals.astype(dt), mask, jp)
        out[dt] = ({k: v.numpy() for k, v in t._asdict().items()},
                   {k: np.asarray(v) for k, v in j._asdict().items()})
    (t32, j32), (t64, j64) = out[np.float32], out[np.float64]
    for k in ("vertex_indices", "n_vertices", "model_valid"):
        np.testing.assert_array_equal(t64[k], j64[k], err_msg=k)

    def same(a, b):
        return ((a["model_valid"] == b["model_valid"]) & (a["n_vertices"] == b["n_vertices"])
                & (a["vertex_indices"] == b["vertex_indices"]).all(axis=1))

    agree = same(t32, j64) & same(j32, j64)
    assert agree.mean() >= 0.999, agree.mean()

    def diff(a, b):
        d = np.abs(a["vertex_fit_vals"].astype(np.float64) - b["vertex_fit_vals"])[agree]
        return d[np.isfinite(d)]

    port, jax_, cross = diff(t32, j64), diff(j32, j64), diff(t32, j32)
    with capsys.disabled():
        print(f"\n{scene}: vertex_fit_vals against float64, p99.9 port "
              f"{np.quantile(port, 0.999):.3g} / JAX {np.quantile(jax_, 0.999):.3g}, max "
              f"{port.max():.3g} / {jax_.max():.3g}; port against JAX float32: "
              f"{(cross > 1e-5).mean():.2%} beyond 1e-5, max {cross.max():.3g}")
    assert np.quantile(jax_, 0.999) <= 1e-5
    assert np.quantile(port, 0.999) <= 1e-5
    assert np.quantile(port, 0.999) <= np.quantile(jax_, 0.999)
    assert port.max() <= jax_.max()
