"""The kernels' wrappers (``ops/segment_cuda.py``): fused and family.

On the CPU the wrapper validates its inputs exactly as it does before a
launch, and runs the plain version for CPU tensors.  The tests marked
``cuda`` build the kernel and hold it against the plain version on the
card; they skip where there is no card.  The file needs nothing from
``tests/conftest.py`` (which imports JAX), so on a machine with the card
and no JAX run:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops import segment_cuda as sc
from land_trendr_tpu_torch.ops.segment import (
    _select_and_assemble,
    torch_family_stats,
    torch_segment_pixels,
    torch_segment_pixels_chunked,
)
from test_torch_nan_guards import ADVERSARIAL, adversarial
from test_torch_nan_guards import FORMS as GUARD_FORMS
from test_torch_nan_guards import PARAMS as GUARD_PARAMS

# the suite runs several workers per host: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture()
def rng():
    return np.random.default_rng(20261016)


def _inputs(rng, px=32, ny=40, dtype=torch.float32):
    years = torch.arange(1984, 1984 + ny, dtype=torch.int32)
    t = np.arange(ny)
    d = rng.integers(5, ny - 5, size=(px, 1))
    vals = np.where(t[None, :] >= d, 0.6, 0.1) + rng.normal(0, 0.02, size=(px, ny))
    mask = rng.uniform(size=(px, ny)) > 0.1
    return years, torch.from_numpy(vals).to(dtype), torch.from_numpy(mask)


@pytest.mark.parametrize("dtype", [torch.float16, torch.int32, torch.bfloat16])
def test_rejects_bad_value_dtype(rng, dtype):
    years, vals, mask = _inputs(rng)
    with pytest.raises(TypeError, match="float32 or float64"):
        sc.cuda_segment_pixels(years, vals.to(dtype), mask)


def test_rejects_bad_mask_dtype(rng):
    years, vals, mask = _inputs(rng)
    with pytest.raises(TypeError, match="bool"):
        sc.cuda_segment_pixels(years, vals, mask.to(torch.uint8))


@pytest.mark.parametrize(
    "shape_case", ["values_1d", "mask_shape", "years_len", "years_2d"]
)

def test_rejects_bad_shapes(rng, shape_case):
    years, vals, mask = _inputs(rng)
    if shape_case == "values_1d":
        vals, mask = vals[0], mask[0]
    elif shape_case == "mask_shape":
        mask = mask[:, :-1]
    elif shape_case == "years_len":
        years = years[:-1]
    else:
        years = years[None, :]
    with pytest.raises(ValueError):
        sc.cuda_segment_pixels(years, vals, mask)


def test_rejects_non_contiguous(rng):
    years, vals, mask = _inputs(rng, px=40, ny=40)
    with pytest.raises(ValueError, match="contiguous"):
        sc.cuda_segment_pixels(years, vals.t(), mask.t())


def test_rejects_more_than_64_years(rng):
    # 65 years take the wide kernel, 129 the global form (the plain version
    # here): no length is refused (the name dates from when one was)
    for ny, form in ((65, "wide"), (129, "global")):
        years, vals, mask = _inputs(rng, ny=ny)
        assert sc.instantiation(ny, LTParams()) == form
        got = sc.cuda_segment_pixels(years, vals, mask)
        ref = torch_segment_pixels(years, vals, mask)
        for name, a, b in zip(got._fields, got, ref):
            assert torch.equal(a, b), (ny, name)


def test_rejects_params_beyond_capacity(rng):
    # 17 candidates take the wide kernel, 33 the global form (the plain
    # version here): no candidate count is refused (the name dates from
    # when one was)
    years, vals, mask = _inputs(rng)
    for over, form in (({"max_segments": 10, "vertex_count_overshoot": 6}, "wide"),
                       ({"max_segments": 26, "vertex_count_overshoot": 6}, "global")):
        params = LTParams(**over)
        assert sc.instantiation(40, params) == form
        got = sc.cuda_segment_pixels(years, vals, mask, params)
        ref = torch_segment_pixels(years, vals, mask, params)
        for name, a, b in zip(got._fields, got, ref):
            assert torch.equal(a, b), (form, name)


@pytest.mark.parametrize("px,chunk,match", [(300, 150, "multiple of the CUDA block"),
                                            (100, 30, "not a multiple")])
def test_chunk_contract(rng, px, chunk, match):
    years, vals, mask = _inputs(rng, px=px)
    with pytest.raises(ValueError, match=match):
        sc.cuda_segment_pixels_chunked(years, vals, mask, chunk=chunk)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_tensors_run_the_plain_version(rng, dtype):
    years, vals, mask = _inputs(rng, dtype=dtype)
    before = sc.LAUNCHES
    got = sc.cuda_segment_pixels(years, vals, mask)
    ref = torch_segment_pixels(years, vals, mask)
    for name, a, b in zip(got._fields, got, ref):
        assert torch.equal(a, b), name
    got = sc.cuda_segment_pixels_chunked(years, vals, mask, chunk=8)
    ref = torch_segment_pixels_chunked(years, vals, mask, chunk=8)
    for name, a, b in zip(got._fields, got, ref):
        assert torch.equal(a, b), name
    assert sc.LAUNCHES == before  # no kernel ran


def test_op_counts_need_the_card(rng):
    years, vals, mask = _inputs(rng)
    with pytest.raises(ValueError, match="CUDA"):
        sc.cuda_segment_op_counts(years, vals, mask)


def _ftv_inputs(rng, px=32, ny=40, dtype=torch.float32, params=LTParams()):
    """A target batch and vertex sets as the segmentation kernel writes
    them (int32, sorted year indices padded -1)."""
    years, vals, mask = _inputs(rng, px=px, ny=ny, dtype=dtype)
    nv = params.max_vertices
    nvert = torch.from_numpy(rng.integers(0, nv + 1, size=px).astype(np.int32))
    picks = np.sort(rng.random((px, ny)).argsort(axis=1)[:, :nv], axis=1)
    vidx = np.where(np.arange(nv)[None, :] < nvert.numpy()[:, None], picks, -1)
    return years, vals, mask, torch.from_numpy(vidx.astype(np.int32)), nvert


def _no_library():
    raise AssertionError("the FTV wrapper loaded the kernel library before its checks")


@pytest.mark.parametrize(
    "case,exc,match",
    [
        ("cpu", ValueError, "CUDA tensors"),
        ("values_dtype", TypeError, "float32 or float64"),
        ("mask_dtype", TypeError, "bool"),
        ("vertex_dtype", TypeError, "vertex_indices must be int32"),
        ("count_dtype", TypeError, "n_vertices must be int32"),
        ("values_1d", ValueError, "matching"),
        ("years_len", ValueError, "years"),
        ("vertex_shape", ValueError, "vertex_indices must be"),
        ("count_shape", ValueError, "vertex_indices must be"),
        ("values_strided", ValueError, "contiguous"),
        ("vertex_strided", ValueError, "contiguous"),
        ("devices", ValueError, "values, vertex_indices and n_vertices on"),
    ],
)
def test_ftv_wrapper_checks_before_loading_the_library(rng, monkeypatch, case, exc, match):
    # every check runs on the CPU, before the library would be built
    monkeypatch.setattr(sc, "load_library", _no_library)
    years, vals, mask, vidx, nvert = _ftv_inputs(rng, px=40)
    if case == "values_dtype":
        vals = vals.to(torch.float16)
    elif case == "mask_dtype":
        mask = mask.to(torch.uint8)
    elif case == "vertex_dtype":
        vidx = vidx.to(torch.int64)
    elif case == "count_dtype":
        nvert = nvert.to(torch.int64)
    elif case == "values_1d":
        vals, mask = vals[0], mask[0]
    elif case == "years_len":
        years = years[:-1]
    elif case == "vertex_shape":
        vidx = vidx[:, :-1].contiguous()
    elif case == "count_shape":
        nvert = nvert[:-1]
    elif case == "values_strided":
        vals, mask = vals.t(), mask.t()
    elif case == "vertex_strided":
        vidx = torch.zeros((40, 14), dtype=torch.int32)[:, ::2]
    elif case == "devices":
        vidx, nvert = vidx.to("meta"), nvert.to("meta")
    with pytest.raises(exc, match=match):
        sc.cuda_fit_to_vertices(years, vals, mask, vidx, nvert)


def test_ftv_fit_is_picked_by_the_resolved_impl():
    # one place picks FTV's implementation, for the tile program and the
    # entry points alike: the kernel on a CUDA device, the plain version on
    # the CPU
    from land_trendr_tpu_torch.ops import tile
    from land_trendr_tpu_torch.ops.ftv import torch_fit_to_vertices

    assert tile.ftv_fit(tile.resolve_impl("auto", "cuda:0")) is sc.cuda_fit_to_vertices
    assert tile.ftv_fit(tile.resolve_impl("auto", "cpu")) is torch_fit_to_vertices


def test_tile_program_on_cpu_takes_the_plain_ftv(rng, monkeypatch):
    # the device picks FTV's implementation as it picks the segmentation's:
    # on the CPU the plain version, and no FTV launch is counted
    from land_trendr_tpu_torch.ops import indices as idx
    from land_trendr_tpu_torch.ops import tile
    from land_trendr_tpu_torch.ops.ftv import torch_fit_to_vertices

    def kernel(*_a, **_k):
        raise AssertionError("the FTV kernel's wrapper ran on CPU tensors")

    monkeypatch.setattr(tile, "cuda_fit_to_vertices", kernel)
    px, ny = 48, 16
    years = torch.arange(2000, 2000 + ny, dtype=torch.int32)
    dn = {b: torch.from_numpy(rng.integers(0, 9000, size=(px, ny)).astype(np.int16))
          for b in idx.BANDS}
    dn["red"][:8] = 0
    dn["nir"][:8] = 0  # NDVI's zero denominators: the index reads 0 there
    qa = torch.zeros((px, ny), dtype=torch.int16).view(torch.uint16)
    before = (sc.FTV_LAUNCHES, sc.LAUNCHES)
    out = tile.process_tile_dn(years, dn, qa, params=LTParams(max_segments=3),
                               scale=1e-4, offset=0.0, ftv_indices=("ndvi", "tcw"))
    assert (sc.FTV_LAUNCHES, sc.LAUNCHES) == before
    sr = {b: idx.scale_sr(v, 1e-4, 0.0) for b, v in dn.items()}
    mask = idx.qa_valid_mask(qa) & idx.sr_valid_mask(sr)
    for name in ("ndvi", "tcw"):
        ref = torch_fit_to_vertices(years, idx.compute_index(name, sr), mask,
                                    out.seg.vertex_indices, out.seg.n_vertices,
                                    LTParams(max_segments=3))
        assert torch.equal(out.ftv[name], ref), name
    assert bool(out.ftv["ndvi"].isfinite().all())


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


def test_tile_program_on_cpu_takes_the_plain_index_pass(rng, monkeypatch):
    # on CPU tensors the tile program's index math is the plain version,
    # with no index launch, and its outputs are the composition it replaced
    # (scale_sr, both masks, compute_index, the cat of the K series, the
    # mask repeated): a primary with two ensemble indices and two FTV
    # indices.  The series handed to the segmentation holds the primary's
    # rows, then each ensemble index's, in order
    from land_trendr_tpu_torch.ops import indices as idx
    from land_trendr_tpu_torch.ops import tile
    from land_trendr_tpu_torch.ops.change import ChangeFilter, select_change
    from land_trendr_tpu_torch.ops.ftv import torch_fit_to_vertices
    from land_trendr_tpu_torch.ops.segment import SegOutputs

    def kernel(*_a, **_k):
        raise AssertionError("the index kernel's wrapper ran on CPU tensors")

    monkeypatch.setattr(tile, "cuda_tile_indices", kernel)
    plain_calls, seg_calls = [], []
    real_plain, real_seg = idx.torch_tile_indices, tile.torch_segment_pixels
    monkeypatch.setattr(idx, "torch_tile_indices",
                        lambda *a: plain_calls.append(a) or real_plain(*a))
    monkeypatch.setattr(tile, "torch_segment_pixels",
                        lambda y, v, m, p: seg_calls.append((v, m)) or real_seg(y, v, m, p))
    px, ny, params = 64, 20, LTParams(max_segments=3)
    ens, ftv = ("tcb", "ndvi"), ("tcw", "ndmi")
    years = torch.arange(2000, 2000 + ny, dtype=torch.int32)
    dn = {b: torch.from_numpy(rng.integers(7300, 40000, size=(px, ny)).astype(np.uint16))
          for b in idx.BANDS}
    qa = torch.from_numpy(np.where(rng.uniform(size=(px, ny)) < 0.1, 8, 0).astype(np.uint16))
    filt = ChangeFilter()
    before = sc.INDEX_LAUNCHES
    out = tile.process_tile_dn(years, dn, qa, params=params, ftv_indices=ftv,
                               change_filt=filt, ensemble_indices=ens)
    assert sc.INDEX_LAUNCHES == before and len(plain_calls) == 1 and len(seg_calls) == 1
    assert plain_calls[0][2:4] == (("nbr", *ens), ftv)

    sr = {b: idx.scale_sr(v) for b, v in dn.items()}
    mask = idx.qa_valid_mask(qa) & idx.sr_valid_mask(sr)
    rows = [idx.compute_index(name, sr) for name in ("nbr", *ens)]
    series, series_mask = seg_calls[0]
    assert series.shape == (3 * px, ny)
    for k, row in enumerate(rows):  # the row order of the (K·PX, NY) series
        assert _same_bits(series[k * px:(k + 1) * px], row), k
    assert _same_bits(series_mask, mask.repeat(3, 1))
    seg = real_seg(years, torch.cat(rows), mask.repeat(3, 1), params)
    parts = [SegOutputs(*(o[k * px:(k + 1) * px] for o in seg)) for k in range(3)]
    for got, want in zip((out.seg, *(out.ens[n] for n in ens)), parts):
        assert all(_same_bits(a, b) for a, b in zip(got, want))
    assert list(out.ens) == list(ens) and list(out.ftv) == list(ftv)
    for name in ftv:
        want = torch_fit_to_vertices(years, idx.compute_index(name, sr), mask,
                                     parts[0].vertex_indices, parts[0].n_vertices, params)
        assert _same_bits(out.ftv[name], want), name
    s = parts[0]
    change = select_change(s.vertex_years, -s.vertex_fit_vals, -s.seg_magnitude, s.seg_duration,
                           -s.seg_rate, s.model_valid, s.p_of_f, s.rmse, sign=-1.0, filt=filt)
    assert change.keys() == out.change.keys()
    assert all(_same_bits(out.change[k], change[k]) for k in change)
    assert bool(out.seg.model_valid.any())


@pytest.mark.parametrize(
    "case,exc,match",
    [
        ("float_dn", TypeError, "int16 or uint16"),
        ("mixed_dn", TypeError, "int16 or uint16"),
        ("int32_qa", TypeError, "int16 or uint16"),
        ("shape", ValueError, "one \\(PX, NY\\) shape"),
        ("unknown", ValueError, "unknown index"),
        ("missing_band", KeyError, "needs the bands"),
        ("no_band", ValueError, "at least one known band"),
        ("too_many", ValueError, "1 to 16 outputs"),
        ("devices", ValueError, "DN bands and QA on"),
        ("cpu", ValueError, "runs on CUDA tensors"),
    ],
)
def test_index_wrapper_checks_before_loading_the_library(rng, monkeypatch, case, exc, match):
    # what the index kernel does not take raises before the library is
    # built or loaded; CPU tensors take the plain version, not this wrapper
    monkeypatch.setattr(sc, "load_library", _no_library)
    dn = {b: torch.from_numpy(rng.integers(0, 9000, size=(32, 40)).astype(np.int16))
          for b in ("red", "nir", "swir2")}
    qa = torch.zeros((32, 40), dtype=torch.int16).view(torch.uint16)
    series, ftv = ("nbr",), ()
    if case == "float_dn":
        dn = {b: v.float() for b, v in dn.items()}
    elif case == "mixed_dn":
        dn["red"] = dn["red"].view(torch.uint16)
    elif case == "int32_qa":
        qa = qa.view(torch.int16).int()
    elif case == "shape":
        dn["nir"] = dn["nir"][:16]
    elif case == "unknown":
        series = ("evi",)
    elif case == "missing_band":
        ftv = ("ndmi",)
    elif case == "no_band":
        dn = {"thermal": dn["nir"]}
    elif case == "too_many":
        ftv = ("ndvi",) * 16
    elif case == "devices":
        qa = qa.to("meta")
    with pytest.raises(exc, match=match):
        sc.cuda_tile_indices(dn, qa, series, ftv)


def test_index_pass_is_picked_by_the_resolved_impl():
    from land_trendr_tpu_torch.ops import indices as idx
    from land_trendr_tpu_torch.ops import tile

    assert tile.tile_indices(tile.resolve_impl("auto", "cuda:0")) is sc.cuda_tile_indices
    assert tile.tile_indices(tile.resolve_impl("auto", "cpu")) is idx.torch_tile_indices


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _decisions(a, b):
    return (
        (a.model_valid == b.model_valid)
        & (a.n_vertices == b.n_vertices)
        & (a.vertex_indices == b.vertex_indices).all(dim=1)
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_kernel_matches_plain_on_card(rng, card, dtype):
    years, vals, mask = (x.to(card) for x in _inputs(rng, px=4096, dtype=dtype))
    before = sc.LAUNCHES
    got = sc.cuda_segment_pixels(years, vals, mask)
    torch.cuda.synchronize()
    assert sc.LAUNCHES == before + 1
    ref = torch_segment_pixels(years, vals, mask)
    agree = _decisions(got, ref)
    if dtype == torch.float64:
        assert bool(agree.all())
    else:
        assert float(agree.float().mean()) >= 0.999
    atol = 1e-8 if dtype == torch.float64 else 1e-5
    for name in got._fields:
        x, y = getattr(got, name)[agree], getattr(ref, name)[agree]
        if not x.dtype.is_floating_point:
            assert torch.equal(x, y), name
            continue
        # a NaN or infinity must stand where the plain version has one
        assert torch.equal(x.isfinite(), y.isfinite()), name
        fin = x.isfinite()
        assert torch.equal(x[~fin].isnan(), y[~fin].isnan()), name
        assert torch.equal(x[x.isinf()], y[x.isinf()]), name
        assert float((x[fin] - y[fin]).abs().max()) <= atol, name


@pytest.mark.cuda
def test_kernel_chunked_equals_unchunked_on_card(rng, card):
    years, vals, mask = (x.to(card) for x in _inputs(rng, px=1024))
    whole = sc.cuda_segment_pixels(years, vals, mask)
    before = sc.LAUNCHES
    parts = sc.cuda_segment_pixels_chunked(years, vals, mask, chunk=256)
    assert sc.LAUNCHES == before + 4
    for name, a, b in zip(whole._fields, whole, parts):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_kernel_op_counts_on_card(rng, card):
    years, vals, mask = (x.to(card) for x in _inputs(rng, px=512))
    ops = sc.cuda_segment_op_counts(years, vals, mask)
    assert ops.shape == (512,) and int(ops.min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_family_kernel_matches_plain_on_card(rng, card, dtype):
    years, vals, mask = _inputs(rng, px=4096, dtype=dtype)
    mask[0] = False                 # no valid year
    mask[1] = False
    mask[1, 7] = True               # one
    vals[2] = 0.25                  # flat
    mask[3, 6:] = False             # below min_observations_needed
    years, vals, mask = years.to(card), vals.to(card), mask.to(card)
    before = sc.FAMILY_LAUNCHES
    desp, vm, sse = sc.cuda_family_stats(years, vals, mask)
    torch.cuda.synchronize()
    assert sc.FAMILY_LAUNCHES == before + 1
    rdesp, rvm, rsse = torch_family_stats(years, vals, mask)
    assert vm.shape == rvm.shape and vm.dtype == torch.bool
    agree = (vm == rvm).all(dim=(1, 2))
    if dtype == torch.float64:
        assert bool(agree.all())
    else:
        assert float(agree.float().mean()) >= 0.999
    atol = 1e-8 if dtype == torch.float64 else 1e-5
    for x, y in ((desp, rdesp), (sse, rsse)):
        x, y = x[agree], y[agree]
        assert torch.equal(x.isfinite(), y.isfinite())
        fin = x.isfinite()
        assert float((x[fin] - y[fin]).abs().max()) <= atol
    # the family kernel + the plain tail make the fused kernel's decisions
    tail = _select_and_assemble(years, vals, mask, desp, vm, sse)
    fused = sc.cuda_segment_pixels(years, vals, mask)
    same = _decisions(tail, fused)
    if dtype == torch.float64:
        assert bool(same.all())
    else:
        assert float(same.float().mean()) >= 0.999


@pytest.mark.cuda
def test_family_kernel_op_counts_on_card(rng, card):
    years, vals, mask = (x.to(card) for x in _inputs(rng, px=512))
    ops = sc.cuda_family_op_counts(years, vals, mask)
    assert ops.shape == (512,) and int(ops.min()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "ny,over",
    [
        (65, {}),
        (128, {}),
        (40, {"max_segments": 10, "vertex_count_overshoot": 6}),   # 17 candidates
        (64, {"max_segments": 25, "vertex_count_overshoot": 6}),   # 32 candidates
    ],
)
def test_wide_kernels_match_plain_on_card(rng, card, dtype, ny, over):
    # beyond the narrow caps the wrapper takes the wide instantiation of
    # both kernels; 1000 px leave a ragged last block at either block size
    params = LTParams(**over)
    assert sc.instantiation(ny, params) == "wide"
    years, vals, mask = (x.to(card) for x in _inputs(rng, px=1000, ny=ny, dtype=dtype))
    before = (sc.LAUNCHES, sc.WIDE_LAUNCHES, sc.FAMILY_LAUNCHES, sc.WIDE_FAMILY_LAUNCHES)
    got = sc.cuda_segment_pixels(years, vals, mask, params)
    desp, vm, sse = sc.cuda_family_stats(years, vals, mask, params)
    torch.cuda.synchronize()
    assert (sc.LAUNCHES, sc.WIDE_LAUNCHES, sc.FAMILY_LAUNCHES, sc.WIDE_FAMILY_LAUNCHES) == (
        before[0], before[1] + 1, before[2], before[3] + 1)
    ref = torch_segment_pixels(years, vals, mask, params)
    agree = _decisions(got, ref)
    rdesp, rvm, rsse = torch_family_stats(years, vals, mask, params)
    fagree = (vm == rvm).all(dim=(1, 2))
    if dtype == torch.float64:
        assert bool(agree.all()) and bool(fagree.all())
    else:
        assert float(agree.float().mean()) >= 0.999
        assert float(fagree.float().mean()) >= 0.999
    atol = 1e-8 if dtype == torch.float64 else 1e-5
    pairs = [(getattr(got, n)[agree], getattr(ref, n)[agree]) for n in got._fields]
    pairs += [(desp[fagree], rdesp[fagree]), (sse[fagree], rsse[fagree])]
    for x, y in pairs:
        if not x.dtype.is_floating_point:
            assert torch.equal(x, y)
            continue
        assert torch.equal(x.isfinite(), y.isfinite())
        assert torch.equal(x.isnan(), y.isnan())
        fin = x.isfinite()
        if bool(fin.any()):
            assert float((x[fin] - y[fin]).abs().max()) <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("ny,over", [(129, {}), (40, {"max_segments": 26, "vertex_count_overshoot": 6})])
def test_beyond_the_wide_caps_is_refused_on_card(rng, card, ny, over):
    # beyond the wide caps nothing is refused (the name dates from when the
    # card did): the global form of both kernels runs, bit-identical to the
    # plain version in float32
    params = LTParams(**over)
    assert sc.instantiation(ny, params) == "global"
    years, vals, mask = (x.to(card) for x in _inputs(rng, px=256, ny=ny))
    counts = (sc.GLOBAL_LAUNCHES, sc.GLOBAL_FAMILY_LAUNCHES)
    got = sc.cuda_segment_pixels(years, vals, mask, params)
    fam = sc.cuda_family_stats(years, vals, mask, params)
    torch.cuda.synchronize()
    assert (sc.GLOBAL_LAUNCHES, sc.GLOBAL_FAMILY_LAUNCHES) == (counts[0] + 1, counts[1] + 1)
    for name, a, b in zip(got._fields, got, torch_segment_pixels(years, vals, mask, params)):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
    for a, b in zip(fam, torch_family_stats(years, vals, mask, params)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "ny,over",
    [
        (160, {}),
        (40, {"max_segments": 36, "vertex_count_overshoot": 3}),   # 40 candidates
        (1000, {}),                                                # the scratch tier
    ],
)
def test_global_kernels_match_plain_on_card(rng, card, dtype, ny, over, monkeypatch):
    # the shape's own tier (one launch a kernel in the shared tier), then
    # the scratch tier, forced where the shared tier holds the shape, under
    # a budget of three blocks: 1000 px in 384 + 384 + 232, three launches
    # of each kernel over one scratch, the last one ragged
    params = LTParams(**over)
    monkeypatch.setattr(sc, "GLOBAL_SCRATCH_BUDGET",
                        sc.global_scratch_bytes(ny, params, dtype, 3 * sc.CUDA_BLOCK))
    years, vals, mask = (x.to(card) for x in _inputs(rng, px=1000, ny=ny, dtype=dtype))
    ref = torch_segment_pixels(years, vals, mask, params)
    rdesp, rvm, rsse = torch_family_stats(years, vals, mask, params)
    own = sc.global_plan(ny, params, dtype).tier
    for tier in dict.fromkeys((own, "scratch")):
        counts = (sc.GLOBAL_LAUNCHES, sc.GLOBAL_FAMILY_LAUNCHES)
        job = sc._Launch(years, vals, mask, params, _tier=tier)
        job.run(0, 1000)
        fjob = sc._FamilyLaunch(years, vals, mask, params, _tier=tier)
        fjob.run()
        torch.cuda.synchronize()
        pieces = 3 if tier == "scratch" else 1
        assert (sc.GLOBAL_LAUNCHES, sc.GLOBAL_FAMILY_LAUNCHES) == (counts[0] + pieces,
                                                                  counts[1] + pieces)
        got = job.result()
        desp, vm, sse = fjob.result()
        assert bool(_decisions(got, ref).all()) and torch.equal(vm, rvm)
        pairs = [*zip(got, ref), (desp, rdesp), (sse, rsse)]
        for x, y in pairs:
            if dtype == torch.float32 or not x.dtype.is_floating_point:
                assert torch.equal(x.contiguous().view(torch.uint8),
                                   y.contiguous().view(torch.uint8))
                continue
            assert torch.equal(x.isnan(), y.isnan())
            fin = x.isfinite()
            if bool(fin.any()):
                assert float((x[fin] - y[fin]).abs().max()) <= 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_global_form_forced_equals_narrow_on_card(rng, card, dtype):
    # forced at a shape the narrow kernel holds, the global form writes
    # the narrow kernel's bits
    years, vals, mask = (x.to(card) for x in _inputs(rng, px=1000, ny=40, dtype=dtype))
    narrow = sc.cuda_segment_pixels(years, vals, mask)
    job = sc._Launch(years, vals, mask, LTParams(), cap="global")
    job.run(0, 1000)
    for name, a, b in zip(narrow._fields, narrow, job.result()):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
    fjob = sc._FamilyLaunch(years, vals, mask, LTParams(), cap="global")
    fjob.run()
    for a, b in zip(sc.cuda_family_stats(years, vals, mask), fjob.result()):
        assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_adversarial_inputs_every_form_on_card(card, case):
    # the reference's adversarial inputs (tests/test_torch_nan_guards.py)
    # through every form of both kernels: float32 bit-identical to the plain
    # version, float64 decisions exact and floats within 1e-8
    for dtype in (torch.float32, torch.float64):
        years, vals, mask = (x.to(card) for x in adversarial(case, dtype))
        ref = torch_segment_pixels(years, vals, mask, GUARD_PARAMS)
        rfam = torch_family_stats(years, vals, mask, GUARD_PARAMS)
        for form, tier in GUARD_FORMS:
            job = sc._Launch(years, vals, mask, GUARD_PARAMS, cap=form, _tier=tier)
            job.run(0, vals.shape[0])
            fjob = sc._FamilyLaunch(years, vals, mask, GUARD_PARAMS, cap=form, _tier=tier)
            fjob.run()
            got = job.result()
            assert bool(_decisions(got, ref).all()), (form, tier)
            assert torch.equal(fjob.result()[1], rfam[1]), (form, tier)
            for x, y in [*zip(got, ref), *zip(fjob.result(), rfam)]:
                if dtype == torch.float32 or not x.dtype.is_floating_point:
                    assert torch.equal(x.contiguous().view(torch.uint8),
                                       y.contiguous().view(torch.uint8)), (form, tier)
                    continue
                assert torch.equal(x.isnan(), y.isnan()), (form, tier)
                fin = x.isfinite()
                if bool(fin.any()):
                    assert float((x[fin] - y[fin]).abs().max()) <= 1e-8, (form, tier)


# ---------------------------------------------------------------------------
# the driver's robustness paths and the medoid composite on the card
# ---------------------------------------------------------------------------


def _card_stack():
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
    from land_trendr_tpu_torch.runtime.stack import stack_from_synthetic

    return stack_from_synthetic(make_stack(SceneSpec(width=128, height=128, seed=5)))


def _tile_bytes(workdir) -> dict:
    import glob
    import os

    out = {}
    for p in sorted(glob.glob(os.path.join(workdir, "tile_*.npz"))):
        with np.load(p) as z:
            out[os.path.basename(p)] = {k: z[k].tobytes() for k in z.files}
    return out


@pytest.mark.cuda
def test_stall_lands_while_the_device_is_busy(card, tmp_path, monkeypatch):
    """A ~10 s device spin before one tile's event: the compute wait polls
    the event from Python, so StallError lands within the timeout + 2 s
    instead of after the spin."""
    import time

    from land_trendr_tpu_torch.runtime import StallError, driver

    sc.load_library()  # the build is not part of the stall budget
    real = driver.process_tile_dn
    calls = []

    def slow_second_tile(*a, **kw):
        out = real(*a, **kw)
        calls.append(1)
        if len(calls) == 2:
            torch.cuda._sleep(int(2e10))  # ~10 s of spinning at H100 clocks
        return out

    monkeypatch.setattr(driver, "process_tile_dn", slow_second_tile)
    cfg = driver.RunConfig(tile_size=32, workdir=str(tmp_path / "w"),
                           out_dir=str(tmp_path / "o"), stall_timeout_s=1.0)
    t0 = time.monotonic()
    with pytest.raises(StallError):
        driver.run_stack(_card_stack(), cfg, device=card)
    assert time.monotonic() - t0 < 1.0 + 2.0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_medoid_on_card_equals_cpu(card, rng):
    from land_trendr_tpu_torch.ops.composite import medoid_composite

    nd, h, w = 3, 96, 80
    dn = {b: rng.integers(7300, 43000, (nd, h, w)).astype(np.uint16) for b in ("nir", "swir2")}
    qa = np.where(rng.uniform(size=(nd, h, w)) < 0.3, 1 << 3, 0).astype(np.uint16)
    on_card = medoid_composite(dn, qa, device=card, chunk_px=4096)
    on_cpu = medoid_composite(dn, qa, device="cpu", chunk_px=4096)
    for b in dn:
        assert np.array_equal(on_card[0][b], on_cpu[0][b]), b
    assert np.array_equal(on_card[1], on_cpu[1])


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 2])
def test_retry_after_recycled_upload_buffer_gives_clean_bytes(card, tmp_path, depth):
    """Faults late in the run, after the pinned upload buffers have been
    recycled: every retried tile is uploaded again from its retained host
    arrays and lands byte-equal to a clean run's tile."""
    from land_trendr_tpu_torch.runtime import driver

    stack = _card_stack()
    kw = dict(tile_size=32, upload_depth=depth, fetch_depth=depth, retry_backoff_s=0.0)
    clean = driver.RunConfig(workdir=str(tmp_path / "c"), out_dir=str(tmp_path / "co"), **kw)
    assert driver.run_stack(stack, clean, device=card)["retries"] == 0
    faulty = driver.RunConfig(
        workdir=str(tmp_path / "f"), out_dir=str(tmp_path / "fo"),
        fault_schedule="seed=1,dispatch@9,compute.wait@11,fetch.wait@13,upload.wait@14",
        **kw,
    )
    summary = driver.run_stack(stack, faulty, device=card)
    assert summary["retries"] == 4 and summary["tiles_quarantined"] == []
    assert summary["upload"]["packed"] and summary["fetch"]["packed"]
    assert _tile_bytes(faulty.workdir) == _tile_bytes(clean.workdir)


# ---------------------------------------------------------------------------
# concurrent builders of the kernel library
# ---------------------------------------------------------------------------

_BUILDER = """
import json, pathlib, sys
from land_trendr_tpu_torch.ops import segment_cuda as sc
sc._BUILD_DIR = pathlib.Path(sys.argv[1])
{action}
path, info = sc._built()
print(json.dumps({{"path": path, "built": info["built"], "ptxas": info["ptxas"]}}))
"""


def _concurrent_builders(build_dir, env, action="", n=2):
    """``n`` processes that build (or load) the library into ``build_dir``
    at the same time; returns their reports."""
    import json
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(env, PYTHONPATH=repo + os.pathsep + env.get("PYTHONPATH", ""))
    code = _BUILDER.format(action=action)
    procs = [
        subprocess.Popen([sys.executable, "-c", code, str(build_dir)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(n)
    ]
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=600)
            assert p.returncode == 0, se[-3000:]
            out.append(json.loads(so.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def test_concurrent_builders_with_stub_nvcc(tmp_path):
    """Two processes build into one cold directory at once (``nvcc``
    replaced by a stub that takes a second): both succeed, each renames its
    own temp files, and one library and one ptxas report remain."""
    import os
    import stat

    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    stub = bin_dir / "nvcc"
    stub.write_text(
        "#!/bin/sh\n"
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        "sleep 1\n"
        'echo "ptxas info    : stub report" >&2\n'
        'printf stub > "$out"\n'
    )
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    build = tmp_path / "build"
    reports = _concurrent_builders(build, dict(os.environ, CUDA_HOME=str(tmp_path / "cuda")))
    assert len({r["path"] for r in reports}) == 1
    assert any(r["built"] for r in reports)
    assert all("stub report" in r["ptxas"] for r in reports)
    names = sorted(os.listdir(build))
    assert [n for n in names if n.startswith(".tmp_")] == [], names
    assert len([n for n in names if n.endswith(".so")]) == 1, names
    assert len([n for n in names if n.endswith(".ptxas.txt")]) == 1, names


@pytest.mark.cuda
def test_two_processes_load_a_cold_build_on_card(card, tmp_path):
    """Two processes build the real library into one cold directory at once
    and each loads it."""
    import os

    reports = _concurrent_builders(tmp_path / "build", dict(os.environ),
                                   action="sc.load_library()")
    assert len({r["path"] for r in reports}) == 1 and any(r["built"] for r in reports)
    assert not [n for n in os.listdir(tmp_path / "build") if n.startswith(".tmp_")]


# ---------------------------------------------------------------------------
# mesh and leases on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_sharded_equals_unsharded_on_card(rng, card):
    from land_trendr_tpu_torch.parallel import make_mesh, segment_pixels_sharded

    years, vals, mask = _inputs(rng, px=4096)
    years, vals, mask = years.to(card), vals.to(card), mask.to(card)
    whole = sc.cuda_segment_pixels(years, vals, mask)
    for mesh in (make_mesh(), [card, card], [card] * 4):
        before = sc.LAUNCHES
        out = segment_pixels_sharded(years, vals, mask, mesh=mesh)
        assert sc.LAUNCHES - before == len(mesh)
        for name, a, b in zip(whole._fields, whole, out):
            assert torch.equal(a.cpu().view(torch.uint8), b.view(torch.uint8)), name


@pytest.mark.cuda
def test_leased_and_mesh_runs_equal_static_on_card(card, tmp_path):
    from land_trendr_tpu_torch.runtime import driver

    stack = _card_stack()
    kw = dict(tile_size=32, retry_backoff_s=0.0)
    runs = {}
    for name, extra, mesh in (
        ("static", {}, None),
        ("leased", dict(lease_batch=2, lease_ttl_s=600.0), None),
        ("mesh", {}, [card, card]),
    ):
        cfg = driver.RunConfig(workdir=str(tmp_path / name), out_dir=str(tmp_path / f"{name}o"),
                               **kw, **extra)
        before = sc.LAUNCHES
        runs[name] = driver.run_stack(stack, cfg, device=card, mesh=mesh)
        assert sc.LAUNCHES - before == 16 * (2 if mesh else 1), name
        assert _tile_bytes(cfg.workdir) == _tile_bytes(str(tmp_path / "static")), name
    assert runs["leased"]["lease"]["acquired"] == 16 and runs["leased"]["lease"]["stolen"] == 0
    assert runs["mesh"]["mesh_devices"] == 2
    assert not runs["mesh"]["upload"]["packed"]  # "auto" uploads per shard on a mesh
    forced = driver.RunConfig(workdir=str(tmp_path / "forced"), upload_packed=True, **kw)
    with pytest.raises(ValueError, match="cannot be combined with a mesh"):
        driver.run_stack(stack, forced, device=card, mesh=[card, card])


@pytest.mark.cuda
def test_every_tune_group_probes_on_card(card, tmp_path):
    """``autotune`` on the card runs every probe group: the fetch probe
    names the device plain ``cuda`` while its tile outputs live on
    ``cuda:0``, so the packed fetcher keys its streams by indexed device."""
    from land_trendr_tpu_torch.runtime import fetch
    from land_trendr_tpu_torch.tune import autotune

    prof = autotune(str(tmp_path / "store"), height=64, width=64, n_years=12,
                    device="cuda", smoke=True, reps=1)
    assert {g: r.get("error") for g, r in prof["groups"].items() if not r["ok"]} == {}
    assert fetch._indexed("cuda") == card


@pytest.mark.cuda
def test_paramspace_forms_and_plain_bit_identical_on_card(card):
    """Two trials of ``parity_paramspace``'s joint draw on the card: the f64
    kernel exact against the oracle, every admitting form bit-identical to
    narrow in f32 and f64, the f32 kernel bit-identical to the plain version."""
    from land_trendr_tpu_torch.tools import parity_paramspace

    rec = parity_paramspace.measure(2, card, (2000,), workers=1, verbose=False)
    assert rec["ok"] is True, rec["mismatches"]
    assert rec["forms_bit_identical_trials"] == rec["plain_bit_identical_trials"] == 2
    assert rec["forms_run"] == {"narrow": 4, "wide": 4, "global": 4}
    assert rec["launches"]["GLOBAL_LAUNCHES"] >= 4


@pytest.mark.cuda
def test_gate_ratio_bands_on_card(card):
    """On the card the gate decides every band it can derive from the
    records; a record under the JAX floor yields a named finding."""
    from land_trendr_tpu_torch.tools import perf_gate

    gate = perf_gate.Gate("cuda")
    gate.ratio("x.ok", 3.0, 2.3, "speedup")
    gate.ratio("x.finding", 0.5, 0.16, "speedup")
    assert gate.checks[0]["ok"] is True and gate.checks[1].get("finding") is True


# ---------------------------------------------------------------------------
# the entry points and the scratch tier's op tally on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_entry_on_card_one_launch_bit_identical(card):
    """``entry()`` defaults to the card: its forward step is one launch of
    the kernel, bit-identical to the plain version on its batch."""
    from land_trendr_tpu_torch.entry import entry

    fn, args = entry()
    assert all(a.device.type == "cuda" for a in args)
    before = sc.LAUNCHES
    out = fn(*args)
    assert sc.LAUNCHES - before == 1
    ref = torch_segment_pixels(*args)
    for name, a, b in zip(out._fields, out, ref):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
    assert out.fitted.shape == (256, 40) and float(out.model_valid.float().mean()) > 0.5


@pytest.mark.cuda
def test_dryrun_multichip_on_one_card(card):
    """The dry run over ``[cuda:0, cuda:0]``: f32 and f64 sharded (2 + 2),
    one device in f64 (1), the feed path (2) and the scene's tiles over the
    mesh, every one a kernel launch."""
    from land_trendr_tpu_torch.entry import dryrun_multichip

    before = sc.LAUNCHES
    rec = dryrun_multichip(2, devices=[card, card])
    assert sc.LAUNCHES - before == 7 + 2 * rec["summary"]["tiles"]
    assert rec["summary"]["mesh_devices"] == 2 and "rmse" in rec["rasters"]
    with pytest.raises(RuntimeError, match="need 3 devices"):
        dryrun_multichip(3, devices=[card, card])


@pytest.mark.cuda
def test_scratch_tier_op_counts_on_card(card, monkeypatch):
    """The scratch tier's op tally equals the shared tier's on the same
    pixels (the operation side of the scratch tier's bound)."""
    params, ny = LTParams(), 72
    monkeypatch.setattr(sc, "GLOBAL_SCRATCH_BUDGET", sc.global_scratch_bytes(
        ny, params, torch.float32, 4 * sc.CUDA_BLOCK))
    years, vals, mask = (t.to(card) for t in _inputs(np.random.default_rng(5), 2000, ny))
    counts = []
    for tier in (None, "scratch"):
        job = sc._Launch(years, vals, mask, params, cap="global", _tier=tier)
        fjob = sc._FamilyLaunch(years, vals, mask, params, cap="global", _tier=tier)
        ops, fops = (torch.zeros(2000, dtype=torch.int64, device=card) for _ in range(2))
        job.run(0, 2000, op_count=ops)
        fjob.run(op_count=fops)
        counts.append((ops, fops))
    for shared, scratch in zip(*counts):
        assert int(shared.min()) > 0 and torch.equal(shared, scratch)


@pytest.mark.cuda
def test_stage_spans_time_a_traced_tile_on_card(card):
    """One traced 1024² tile with FTV and the change map, then its packed
    fetch: each stage logs one record with positive device milliseconds,
    and the segment stage's events bracket its kernel launches."""
    from land_trendr_tpu_torch.ops.change import ChangeFilter
    from land_trendr_tpu_torch.ops.indices import BANDS
    from land_trendr_tpu_torch.ops.tile import process_tile_dn
    from land_trendr_tpu_torch.runtime.driver import RunConfig
    from land_trendr_tpu_torch.runtime.fetch import TileFetcher
    from land_trendr_tpu_torch.utils import profiling

    px, ny, chunk = 1024 * 1024, 40, 262_144
    gen = torch.Generator(device=card).manual_seed(20261018)
    years = torch.arange(1984, 1984 + ny, dtype=torch.int32, device=card)
    dn = {b: torch.randint(8000, 30000, (px, ny), generator=gen, device=card,
                           dtype=torch.int32).to(torch.int16) for b in BANDS}
    qa = torch.zeros((px, ny), dtype=torch.int16, device=card).view(torch.uint16)
    cfg = RunConfig(ftv_indices=("ndvi", "tcw"), change_filt=ChangeFilter(), chunk_px=chunk)
    fetcher = TileFetcher(cfg, card, packed=True)

    def step():
        out = process_tile_dn(years, dn, qa, chunk=chunk, ftv_indices=cfg.ftv_indices,
                              change_filt=cfg.change_filt)
        fetcher.start(out).wait()

    step()  # the library's build and first launches stay out of the trace
    torch.cuda.synchronize()
    profiling.SPAN_LOG.clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step()
        torch.cuda.synchronize()
    recs = profiling.SPAN_LOG.records()
    names = ["lt_tile_prep", "lt_tile_segment", "lt_tile_ftv", "lt_tile_change", "lt_fetch_pack"]
    assert [r.name for r in recs] == names
    ms = {r.name: r.device_ms() for r in recs}
    assert all(v > 0 for v in ms.values()), ms
    assert all(r.host_ms > 0 for r in recs)
    kernels = [e for e in prof.profiler.kineto_results.events()
               if "segment_fused_kernel" in e.name() and str(e.device_type()).endswith("CUDA")]
    assert len(kernels) == px // chunk
    kernel_ms = sum(e.duration_ns() for e in kernels) / 1e6
    assert ms["lt_tile_segment"] >= kernel_ms > 0
    # the FTV kernel: one launch an index, inside the FTV stage, and not
    # under the segmentation kernel's name
    ftv = [e for e in prof.profiler.kineto_results.events()
           if "ftv_fit_kernel" in e.name() and str(e.device_type()).endswith("CUDA")]
    assert len(ftv) == 2 and not any("segment_fused_kernel" in e.name() for e in ftv)
    assert ms["lt_tile_ftv"] >= sum(e.duration_ns() for e in ftv) / 1e6 > 0
    assert sum(e.name() == "lt_ftv_fit" and str(e.device_type()).endswith("CPU")
               for e in prof.profiler.kineto_results.events()) == 2
    # the index kernel: one launch a tile, inside prep, its launch span the
    # host range lt_tile_index
    index = [e for e in prof.profiler.kineto_results.events()
             if "tile_index_kernel" in e.name() and str(e.device_type()).endswith("CUDA")]
    assert len(index) == 1 and "segment_fused_kernel" not in index[0].name()
    assert ms["lt_tile_prep"] >= index[0].duration_ns() / 1e6 > 0
    assert sum(e.name() == "lt_tile_index" and str(e.device_type()).endswith("CPU")
               for e in prof.profiler.kineto_results.events()) == 1
    profiling.SPAN_LOG.clear()


# ---------------------------------------------------------------------------
# the FTV kernel on the card
# ---------------------------------------------------------------------------


def _assert_ftv_equal(got, ref, dtype):
    """float32 bit for bit; float64 within 1e-8 (the fused kernel's float64
    contract), non-finite values nowhere."""
    assert got.dtype == ref.dtype == dtype and got.shape == ref.shape
    assert bool(got.isfinite().all()) and bool(ref.isfinite().all())
    if dtype == torch.float32:
        assert torch.equal(got.view(torch.uint8), ref.view(torch.uint8))
    else:
        assert float((got - ref).abs().max()) <= 1e-8


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "ny,over,px,tier",
    [
        (40, {}, 4099, None),                      # the benchmark's shape; a ragged last block
        (72, {}, 4099, None),
        (160, {}, 4099, None),                     # three set words, a block of 32
        (40, {}, 1000, "scratch"),                 # the scratch tier forced, 4 blocks a piece
        (1000, {}, 300, None),                     # a series no block holds: the scratch tier
        (40, {"max_segments": 70}, 300, None),     # 71 vertices: the scratch tier
    ],
)
def test_ftv_kernel_matches_plain_on_card(card, monkeypatch, dtype, ny, over, px, tier):
    # every population of tests/test_torch_kernel_host.py:ftv_population
    from land_trendr_tpu_torch.ops.ftv import torch_fit_to_vertices
    from test_torch_kernel_host import ftv_population

    params = LTParams(**over)
    if tier is not None:
        monkeypatch.setattr(sc, "GLOBAL_SCRATCH_BUDGET", sc.global_scratch_bytes(
            ny, sc._ftv_params(params), dtype, 4 * sc.CUDA_BLOCK))
    args = [a.to(card) for a in ftv_population(23, px, ny, params, dtype)]
    plan = sc.global_plan(ny, sc._ftv_params(params), dtype, _tier=tier)
    before = (sc.FTV_LAUNCHES, sc.LAUNCHES, sc.GLOBAL_LAUNCHES)
    if tier is None:
        got = sc.cuda_fit_to_vertices(*args, params)
    else:
        got = sc._ftv_launch(*args, params, tier)
    torch.cuda.synchronize()
    pieces = 1 if plan.tier == "shared" else -(-px // sc.global_chunk(
        ny, sc._ftv_params(params), dtype))
    assert (sc.FTV_LAUNCHES - before[0], sc.LAUNCHES, sc.GLOBAL_LAUNCHES) == (
        pieces, *before[1:])
    _assert_ftv_equal(got, torch_fit_to_vertices(*args, params), dtype)


@pytest.mark.cuda
def test_tile_program_fits_ftv_with_the_kernel_on_card(card, monkeypatch):
    # process_tile_dn on the card: two FTV launches, the segmentation's
    # launches alone on LAUNCHES, each index bit for bit the plain
    # version's on the same tensors (rows of zero NIR and red: an NDVI of
    # zero denominators, which the index reads as 0, a flat target)
    from land_trendr_tpu_torch.ops import indices as idx
    from land_trendr_tpu_torch.ops import tile
    from land_trendr_tpu_torch.ops.ftv import torch_fit_to_vertices

    px, ny, chunk = 65_536, 40, 16_384
    gen = torch.Generator(device=card).manual_seed(20261018)
    years = torch.arange(1984, 1984 + ny, dtype=torch.int32, device=card)
    dn = {b: torch.randint(0, 9000, (px, ny), generator=gen, device=card,
                           dtype=torch.int32).to(torch.int16) for b in idx.BANDS}
    dn["red"][:4096] = 0
    dn["nir"][:4096] = 0
    qa = torch.zeros((px, ny), dtype=torch.int16, device=card).view(torch.uint16)
    monkeypatch.setattr(tile, "torch_fit_to_vertices", None)  # never on a CUDA tensor
    before = (sc.FTV_LAUNCHES, sc.LAUNCHES)
    out = tile.process_tile_dn(years, dn, qa, scale=1e-4, offset=0.0, chunk=chunk,
                               ftv_indices=("ndvi", "tcw"))
    torch.cuda.synchronize()
    assert (sc.FTV_LAUNCHES - before[0], sc.LAUNCHES - before[1]) == (2, px // chunk)
    sr = {b: idx.scale_sr(v, 1e-4, 0.0) for b, v in dn.items()}
    mask = idx.qa_valid_mask(qa) & idx.sr_valid_mask(sr)
    ndvi = idx.compute_index("ndvi", sr)
    assert bool((ndvi[:4096] == 0).all())
    for name in ("ndvi", "tcw"):
        ref = torch_fit_to_vertices(years, idx.compute_index(name, sr), mask,
                                    out.seg.vertex_indices, out.seg.n_vertices)
        _assert_ftv_equal(out.ftv[name], ref, torch.float32)


@pytest.mark.cuda
def test_ftv_kernel_times_on_card(card):
    # CUDA-event times of the FTV kernel (the wrapper's call, one launch)
    # at the kernel table's 262,144 px x 40 f32 and at a 2048² tile, and of
    # its plain version at 262,144 px; one JSON line on stdout
    import json
    import subprocess

    from land_trendr_tpu_torch.ops.ftv import torch_fit_to_vertices
    from test_torch_kernel_host import ftv_population

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(reps):
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    base = [a.to(card) for a in ftv_population(29, 262_144, 40, LTParams(), torch.float32)]
    rec = {"kernel_ms_262144": ms(lambda: sc.cuda_fit_to_vertices(*base), 20),
           "plain_ms_262144": ms(lambda: torch_fit_to_vertices(*base), 3)}
    tile = [base[0], *(torch.cat([a] * 16) for a in base[1:])]  # 2048² px
    rec["kernel_ms_2048sq"] = ms(lambda: sc.cuda_fit_to_vertices(*tile), 20)
    rec["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print("ftv_kernel_times " + json.dumps(rec))
    assert 0 < rec["kernel_ms_262144"] < rec["plain_ms_262144"]


# ---------------------------------------------------------------------------
# the ensemble: further indices as rows of one segmentation call
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("side", [1024, 1000])
def test_ensemble_stacked_call_equals_per_index_calls_on_card(card, side):
    # a 1024² tile of six indices is 6 x 1,048,576 rows: 24 launches of
    # 262,144; at 1000² the 6,000,000 rows pad to 23 chunks.  Each index's
    # outputs are the bits of that index's own call, and SERIES counts the
    # padded rows the launches segmented
    from land_trendr_tpu_torch.ops import indices as idx
    from land_trendr_tpu_torch.ops.tile import process_tile_dn

    ensemble = ("ndvi", "ndmi", "tcb", "tcg", "tcw")
    px, ny, chunk = side * side, 40, 262_144
    gen = torch.Generator(device=card).manual_seed(20261018)
    years = torch.arange(1984, 1984 + ny, dtype=torch.int32, device=card)
    dn = {b: torch.randint(8000, 30000, (px, ny), generator=gen, device=card,
                           dtype=torch.int32).to(torch.int16) for b in idx.BANDS}
    # the cloud bit on a tenth of the observations
    cloud = torch.rand((px, ny), generator=gen, device=card) < 0.1
    qa = (cloud.to(torch.int16) * 8).view(torch.uint16)
    padded = -(-6 * px // chunk) * chunk
    before = (sc.LAUNCHES, sc.SERIES)
    out = process_tile_dn(years, dn, qa, chunk=chunk, ensemble_indices=ensemble)
    torch.cuda.synchronize()
    assert (sc.LAUNCHES - before[0], sc.SERIES - before[1]) == (padded // chunk, padded)
    assert list(out.ens) == list(ensemble)
    for name in ("nbr", *ensemble):
        alone = process_tile_dn(years, dn, qa, index=name, chunk=chunk).seg
        got = out.seg if name == "nbr" else out.ens[name]
        for field, a, b in zip(got._fields, got, alone):
            assert a.shape == b.shape and a.dtype == b.dtype, (name, field)
            assert torch.equal(a.contiguous().view(torch.uint8),
                               b.contiguous().view(torch.uint8)), (name, field)
        assert bool(got.model_valid.any())


# ---------------------------------------------------------------------------
# the index kernel on the card
# ---------------------------------------------------------------------------

#: (series indices, FTV indices, shipped bands) of the cells: segall and the
#: change cell (NBR), the ensemble cell, the FTV cell
INDEX_SETS = {
    "nbr": (("nbr",), (), ("nir", "swir2")),
    "ensemble": (("nbr", "ndvi", "ndmi", "tcb", "tcg", "tcw"), (), None),
    "ftv": (("nbr",), ("ndvi", "tcw"), None),
}


def _card_tile(card, px, ny, bands, dtype=torch.int16, seed=20261019):
    """DNs of a forest scene with its extremes, and QA with the cloud bit
    on a tenth of the observations and high bits set on another tenth."""
    from land_trendr_tpu_torch.ops import indices as idx

    gen = torch.Generator(device=card).manual_seed(seed)
    hi = 32767 if dtype == torch.int16 else 43636
    dn = {}
    for b in bands or idx.BANDS:
        d = torch.randint(7000, hi + 1, (px, ny), generator=gen, device=card, dtype=torch.int32)
        edge = torch.rand((px, ny), generator=gen, device=card) < 0.02
        d = torch.where(edge, torch.tensor(0, device=card), d)
        dn[b] = (d.to(torch.int16) if dtype == torch.int16
                 else d.to(torch.int32).to(torch.int16).view(torch.uint16))
    r = torch.rand((px, ny), generator=gen, device=card)
    qa = torch.where(r < 0.1, 8, torch.where(r > 0.9, 0xFF40, 0)).to(torch.int16)
    return dn, qa.view(torch.uint16)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "case,px,ny,dtype",
    [
        ("nbr", 1024 * 1024, 40, torch.int16),         # segall / change cell
        ("ensemble", 1024 * 1024, 40, torch.int16),    # the ensemble cell
        ("ftv", 2048 * 2048, 40, torch.int16),         # the FTV cell
        ("ftv", 1037, 37, torch.uint16),               # one element a thread, a ragged end
        ("ensemble", 1037, 36, torch.uint16),          # eight a thread, a tail of four
    ],
)
def test_index_kernel_matches_plain_on_card(card, case, px, ny, dtype):
    # the mask and every output row bit for bit the plain version's on the
    # same CUDA tensors, one launch
    from land_trendr_tpu_torch.ops import indices as idx

    series_idx, ftv_idx, bands = INDEX_SETS[case]
    dn, qa = _card_tile(card, px, ny, bands, dtype)
    before = sc.INDEX_LAUNCHES
    series, mask, ftv = sc.cuda_tile_indices(dn, qa, series_idx, ftv_idx)
    torch.cuda.synchronize()
    assert sc.INDEX_LAUNCHES - before == 1
    ref_series, ref_mask, ref_ftv = idx.torch_tile_indices(dn, qa, series_idx, ftv_idx)
    assert torch.equal(mask, ref_mask)
    assert 0.5 < float(mask.float().mean()) < 0.95
    assert torch.equal(series.view(torch.int32), ref_series.view(torch.int32))
    assert len(ftv) == len(ftv_idx)
    for a, b in zip(ftv, ref_ftv):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("tail", ["ensemble", "ftv"])
def test_tile_program_indices_with_the_kernel_on_card(card, monkeypatch, tail):
    # process_tile_dn on the card: one index launch a call, and every
    # output (segmentation, ensemble, FTV, change) the bits of the same
    # program with the plain index pass in its place
    from land_trendr_tpu_torch.ops import indices as idx
    from land_trendr_tpu_torch.ops import tile
    from land_trendr_tpu_torch.ops.change import ChangeFilter

    px, ny, chunk = 262_144, 40, 65_536
    dn, qa = _card_tile(card, px, ny, None)
    years = torch.arange(1984, 1984 + ny, dtype=torch.int32, device=card)
    kw = (dict(ensemble_indices=("ndvi", "tcb")) if tail == "ensemble"
          else dict(ftv_indices=("ndvi", "tcw"), change_filt=ChangeFilter()))
    before = sc.INDEX_LAUNCHES
    out = tile.process_tile_dn(years, dn, qa, chunk=chunk, **kw)
    torch.cuda.synchronize()
    assert sc.INDEX_LAUNCHES - before == 1
    monkeypatch.setattr(tile, "tile_indices", lambda impl: idx.torch_tile_indices)
    ref = tile.process_tile_dn(years, dn, qa, chunk=chunk, **kw)
    torch.cuda.synchronize()
    assert sc.INDEX_LAUNCHES - before == 1
    pairs = list(zip(out.seg, ref.seg))
    pairs += [p for n in out.ens for p in zip(out.ens[n], ref.ens[n])]
    pairs += [(out.ftv[n], ref.ftv[n]) for n in out.ftv]
    pairs += [(out.change[k], ref.change[k]) for k in (out.change or {})]
    assert list(out.ens) == list(ref.ens) and list(out.ftv) == list(ref.ftv)
    for a, b in pairs:
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(a.contiguous().view(torch.uint8), b.contiguous().view(torch.uint8))
    assert bool(out.seg.model_valid.any())


@pytest.mark.cuda
def test_index_kernel_times_on_card(card):
    # CUDA-event times of the index kernel (the wrapper's call, one launch)
    # and of its plain version at the cells' tiles, beside the bytes bound
    # (each input byte read and each output byte written once at 3.35
    # TB/s); one JSON line on stdout
    import json
    import subprocess

    from land_trendr_tpu_torch.ops import indices as idx

    def ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        times = []
        for _ in range(reps):
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return sorted(times)[len(times) // 2]

    rec = {}
    for case, side in (("nbr", 1024), ("ensemble", 1024), ("ftv", 2048)):
        series_idx, ftv_idx, bands = INDEX_SETS[case]
        n = side * side * 40
        dn, qa = _card_tile(card, side * side, 40, bands)
        args = (dn, qa, series_idx, ftv_idx)
        moved = n * (2 * (len(dn) + 1) + 1 + 4 * (len(series_idx) + len(ftv_idx)))
        rec[case] = {"kernel_ms": ms(lambda: sc.cuda_tile_indices(*args), 20),
                     "plain_ms": ms(lambda: idx.torch_tile_indices(*args), 5),
                     "bound_ms": moved / 3.35e9, "bytes": moved}
        rec[case]["bound_share"] = rec[case]["bound_ms"] / rec[case]["kernel_ms"]
        del dn, qa, args
        torch.cuda.empty_cache()
    rec["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False).stdout.strip()
    print("index_kernel_times " + json.dumps(rec))
    for case in INDEX_SETS:
        assert 0 < rec[case]["kernel_ms"] < rec[case]["plain_ms"]
