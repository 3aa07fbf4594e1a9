"""FTV of the port against the JAX package's ``jax_fit_to_vertices``.

The vertex sets come from the JAX segmentation of one population; the
target series and its mask come from another draw, so the target's mask
is not the segmentation's: mapped vertex sets then start after the first
valid year, end before the last, collapse below two vertices, or meet an
all-masked row.  In float64 the two agree within 1e-12: both fit the same
vertex sets with the same expressions, but the JAX function sums with
XLA's reductions and the port in year order (measured: at most 3.5e-14).
In float32 they agree within the float32 contract's 1e-5 on 99.9% of the
values (5e-5 at most), as the tile program's floats do.
"""

import numpy as np
import pytest
import torch

from land_trendr_tpu.config import LTParams as JLTParams
from land_trendr_tpu.ops.ftv import jax_fit_to_vertices
from land_trendr_tpu.ops.segment import jax_segment_pixels
from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops.ftv import torch_fit_to_vertices
from land_trendr_tpu_torch.tools.population import make_population

# the suite runs several workers per host: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

NY = 40
PX = 384


def _target_mask(kind: str, rng, mask):
    m = mask.copy()
    if kind == "own":
        return m
    if kind == "trimmed":  # sets start after the first valid year / end before the last
        m[:, : rng.integers(1, 8)] = False
        m[:, NY - rng.integers(1, 8):] = False
    elif kind == "sparse":
        m &= rng.uniform(size=m.shape) > 0.6
    elif kind == "edges":
        m[:16] = False                 # all masked
        m[16:32] = False
        m[16:32, 20] = True            # one valid year
        m[32:48] = False
        m[32:48, [5, 30]] = True       # two valid years
    return m


@pytest.fixture(scope="module")
def segmented():
    rng = np.random.default_rng(31)
    years, vals, mask = make_population(rng, PX, NY)
    seg = jax_segment_pixels(years.astype(np.float64), vals, mask, JLTParams())
    vi = np.asarray(seg.vertex_indices).copy()
    nvx = np.asarray(seg.n_vertices).copy()
    # a few vertex sets of fewer than two vertices
    nvx[:8] = np.arange(8) % 2
    _, target, tmask = make_population(rng, PX, NY)
    return years, vi, nvx, target, tmask


def _port(years, target, tmask, vi, nvx, params=LTParams()):
    return torch_fit_to_vertices(
        torch.from_numpy(years), torch.from_numpy(target), torch.from_numpy(tmask),
        torch.from_numpy(vi), torch.from_numpy(nvx), params,
    ).numpy()


@pytest.mark.parametrize("kind", ["own", "trimmed", "sparse", "edges"])
def test_ftv_matches_jax_f64(segmented, kind):
    years, vi, nvx, target, tmask = segmented
    m = _target_mask(kind, np.random.default_rng(7), tmask)
    got = _port(years, target, m, vi, nvx)
    ref = np.asarray(jax_fit_to_vertices(years, target, m, vi, nvx, JLTParams()))
    assert got.shape == (PX, NY) and got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    if kind == "edges":
        assert (got[:16] == 0).all()                        # flat mean of nothing
        np.testing.assert_array_equal(got[16:32], np.repeat(target[16:32, 20:21], NY, 1))


def test_ftv_params_and_nonfinite(segmented):
    years, vi, nvx, target, tmask = segmented
    t = target.copy()
    t[:, 13] = np.nan
    t[50:60, 2] = np.inf
    params = LTParams(max_segments=4, prevent_one_year_recovery=False)
    jp = JLTParams(**params.to_dict())
    nv = params.max_vertices
    vi4 = np.where(np.arange(vi.shape[1])[None, :nv] < np.minimum(nvx, nv)[:, None], vi[:, :nv], -1)
    nv4 = np.minimum(nvx, nv).astype(np.int32)
    got = _port(years, t, tmask, vi4.astype(np.int32), nv4, params)
    ref = np.asarray(jax_fit_to_vertices(years, t, tmask, vi4.astype(np.int32), nv4, jp))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert np.isfinite(got).all()


def test_ftv_f32_within_tolerance(segmented):
    import jax

    years, vi, nvx, target, tmask = segmented
    t32 = target.astype(np.float32)
    got = _port(years, t32, tmask, vi, nvx)
    with jax.enable_x64(False):
        ref = np.asarray(jax_fit_to_vertices(years, t32, tmask, vi, nvx, JLTParams()))
    assert got.dtype == np.float32
    d = np.abs(got.astype(np.float64) - ref)
    assert np.quantile(d, 0.999) <= 1e-5 and d.max() <= 5e-5, d.max()


def test_ftv_rejects_mismatched_vertex_sets(segmented):
    years, vi, nvx, target, tmask = segmented
    with pytest.raises(ValueError, match="vertex_indices"):
        _port(years, target, tmask, vi[:, :3], nvx)
