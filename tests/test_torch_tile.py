"""The port's tile program against the JAX tile program, on synthetic DNs.

``process_tile_dn(impl="torch")`` (the plain version on the CPU) and the
JAX ``process_tile_dn(impl="xla")`` take the same DNs and QA words; both
segment in float32, so decisions must agree on >= 99.9% of pixels and
floats within 1e-5 on the agreeing pixels (the float32 tolerance
contract).  Two float32 pipelines that sum in different orders each
carry the ~1e-5 tail against float64 that ``tests/test_f32_quality.py``
bounds, so a rare value (an anchored fit with a small denominator) may
differ by a few 1e-5: 99.9% of the float values must agree within 1e-5
and all of them within 5e-5.
"""

import numpy as np
import pytest
import torch

from land_trendr_tpu.config import LTParams as JLTParams
from land_trendr_tpu.io.synthetic import SceneSpec, make_stack
from land_trendr_tpu.ops.tile import process_tile_dn as jax_tile
from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops.tile import process_tile_dn, resolve_impl

# the suite runs several workers per host: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)


BANDS = ("red", "nir", "swir2")


@pytest.fixture(scope="module")
def tile():
    st = make_stack(SceneSpec(height=24, width=30, seed=11))
    ny = len(st.years)
    px = 24 * 30
    dn = {b: np.ascontiguousarray(st.dn(b).reshape(ny, px).T) for b in BANDS}
    qa = np.ascontiguousarray(st.qa.reshape(ny, px).T.astype(np.uint16))
    return st.years.astype(np.int32), dn, qa


def _torch_inputs(tile):
    years, dn, qa = tile
    return torch.from_numpy(years), {k: torch.from_numpy(v) for k, v in dn.items()}, torch.from_numpy(qa)


def _compare(got, ref):
    got = {k: v.numpy() for k, v in got._asdict().items()}
    ref = {k: np.asarray(v) for k, v in ref._asdict().items()}
    agree = (
        (got["model_valid"] == ref["model_valid"])
        & (got["n_vertices"] == ref["n_vertices"])
        & (got["vertex_indices"] == ref["vertex_indices"]).all(axis=1)
    )
    assert agree.mean() >= 0.999, agree.mean()
    assert_floats_close(got, ref, agree)


def assert_floats_close(got, ref, agree):
    for name, a in got.items():
        if a.dtype.kind == "f":
            d = np.abs(a[agree].astype(np.float64) - ref[name][agree])
            d = d[np.isfinite(d)]
            assert np.quantile(d, 0.999) <= 1e-5, name
            assert d.max() <= 5e-5, name


@pytest.mark.parametrize("index", ["nbr", "ndvi"])
def test_tile_matches_jax(tile, index):
    years, dn, qa = tile
    got = process_tile_dn(*_torch_inputs(tile), index=index, impl="torch").seg
    ref = jax_tile(years, dn, qa, index=index, impl="xla").seg
    _compare(got, ref)


def test_padded_chunked_tile_matches_jax(tile):
    """720 px with chunk 256: padded to 768, three chunks, cropped back."""
    years, dn, qa = tile
    got = process_tile_dn(*_torch_inputs(tile), chunk=256, impl="torch").seg
    ref = jax_tile(years, dn, qa, chunk=256, impl="xla").seg
    assert got.fitted.shape[0] == 720
    _compare(got, ref)
    whole = process_tile_dn(*_torch_inputs(tile), impl="torch").seg
    for name, a, b in zip(got._fields, got, whole):
        assert torch.equal(a, b), name


def test_tile_params_and_scaling(tile):
    years, dn, qa = tile
    params = LTParams(max_segments=4, spike_threshold=0.75)
    got = process_tile_dn(
        *_torch_inputs(tile), params=params, scale=1e-4, offset=0.0, reject_bits=0x18,
        impl="torch",
    ).seg
    ref = jax_tile(
        years, dn, qa, params=JLTParams(**params.to_dict()), scale=1e-4, offset=0.0,
        reject_bits=0x18, impl="xla",
    ).seg
    _compare(got, ref)


def test_resolve_impl():
    assert resolve_impl("auto", "cpu") == "torch"
    assert resolve_impl("auto", "cuda") == "cuda"
    assert resolve_impl("torch", "cpu") == "torch"
    assert resolve_impl("cuda", "cuda:0") == "cuda"
    with pytest.raises(ValueError, match="does not run on cpu"):
        resolve_impl("cuda", "cpu")
    # the plain version never stands in for the kernel on the card
    with pytest.raises(ValueError, match="does not run on cuda"):
        resolve_impl("torch", "cuda")
    with pytest.raises(ValueError, match="not one of"):
        resolve_impl("pallas", "cpu")


def test_cuda_impl_rejected_on_cpu_tensors(tile):
    with pytest.raises(ValueError, match="does not run on cpu"):
        process_tile_dn(*_torch_inputs(tile), impl="cuda")


@pytest.fixture(scope="module")
def tile6():
    """All six bands (TCW needs them), for the FTV + change tail."""
    from land_trendr_tpu_torch.ops.indices import BANDS as ALL_BANDS

    st = make_stack(SceneSpec(height=20, width=24, seed=13))
    ny = len(st.years)
    px = 20 * 24
    dn = {b: np.ascontiguousarray(st.dn(b).reshape(ny, px).T) for b in ALL_BANDS}
    qa = np.ascontiguousarray(st.qa.reshape(ny, px).T.astype(np.uint16))
    return st.years.astype(np.int32), dn, qa


@pytest.mark.parametrize("index,ftv", [("nbr", ("ndvi", "tcw")), ("ndvi", ("nbr",))])
def test_tile_ftv_and_change_match_jax(tile6, index, ftv):
    from land_trendr_tpu.ops.change import ChangeFilter as JChangeFilter
    from land_trendr_tpu_torch.ops.change import ChangeFilter

    years, dn, qa = tile6
    out = process_tile_dn(
        *_torch_inputs(tile6), index=index, impl="torch", ftv_indices=ftv,
        change_filt=ChangeFilter(max_dur=4.0),
    )
    ref = jax_tile(years, dn, qa, index=index, impl="xla", ftv_indices=ftv,
                   change_filt=JChangeFilter(max_dur=4.0))
    _compare(out.seg, ref.seg)
    seg = {k: v.numpy() for k, v in out.seg._asdict().items()}
    jseg = {k: np.asarray(v) for k, v in ref.seg._asdict().items()}
    agree = (
        (seg["model_valid"] == jseg["model_valid"])
        & (seg["vertex_indices"] == jseg["vertex_indices"]).all(axis=1)
    )
    assert sorted(out.ftv) == sorted(ref.ftv) == sorted(ftv)
    ftv_got = {k: v.numpy() for k, v in out.ftv.items()}
    ftv_ref = {k: np.asarray(v) for k, v in ref.ftv.items()}
    assert_floats_close(ftv_got, ftv_ref, agree)
    got = {k: v.numpy() for k, v in out.change.items()}
    want = {k: np.asarray(v) for k, v in ref.change.items()}
    assert sorted(got) == sorted(want)
    for k, a in got.items():
        assert a.dtype == want[k].dtype, k
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(a[agree], want[k][agree], err_msg=k)
    assert_floats_close(
        {k: a for k, a in got.items() if a.dtype.kind == "f" and k != "dsnr"}, want, agree
    )
    # dsnr = |mag| / rmse divides by an rmse of ~0.01-0.05, so the float32
    # tail of 1e-5 in rmse becomes a relative one of up to ~1e-3 in dsnr
    a, b = got["dsnr"][agree].astype(np.float64), want["dsnr"][agree]
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-12)
    assert np.quantile(rel, 0.999) <= 1e-3 and rel.max() <= 5e-3, rel.max()
    assert got["mask"].any()


def test_tile_without_tail_has_no_ftv_or_change(tile):
    out = process_tile_dn(*_torch_inputs(tile), impl="torch")
    assert out.ftv == {} and out.change is None
