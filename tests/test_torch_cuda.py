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
    years, vals, mask = _inputs(rng, ny=65)
    with pytest.raises(ValueError, match="64-year"):
        sc.cuda_segment_pixels(years, vals, mask)


def test_rejects_params_beyond_capacity(rng):
    years, vals, mask = _inputs(rng)
    params = LTParams(max_segments=10, vertex_count_overshoot=6)  # 17 candidates
    with pytest.raises(ValueError, match="candidate capacity"):
        sc.cuda_segment_pixels(years, vals, mask, params)


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
