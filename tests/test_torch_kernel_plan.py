"""The kernels' launch plan (``ops/segment_cuda.py``): shared memory per
block, pixel-major inputs and outputs with no year-major copies, and the
stage-cycle instrumentation.

On the CPU these tests read the Python-side plan of a launch without
launching anything.  The tests marked ``cuda`` build the kernels and hold
the slab path against the plain version on the card (ragged last blocks,
unaligned views, chunked launches, stage cycles); they skip where there is
no card.  The file needs nothing from ``tests/conftest.py``, so on a
machine with the card and no JAX run:

    python -m pytest tests/test_torch_kernel_plan.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops import segment_cuda as sc
from land_trendr_tpu_torch.ops.segment import torch_family_stats, torch_segment_pixels

torch.set_num_threads(1)


def _inputs(seed, px, ny, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    years = torch.arange(1984, 1984 + ny, dtype=torch.int32)
    t = np.arange(ny)
    d = rng.integers(0, max(ny, 1), size=(px, 1))
    vals = np.where(t[None, :] >= d, 0.6, 0.1) + rng.normal(0, 0.03, size=(px, ny))
    vals[rng.uniform(size=(px, ny)) < 0.01] = np.nan  # non-finite, unmasked
    mask = rng.uniform(size=(px, ny)) > 0.15
    return years, torch.from_numpy(vals).to(dtype), torch.from_numpy(mask)


# ---------------------------------------------------------------------------
# shared memory per block
# ---------------------------------------------------------------------------

# bytes: 16 (mbarrier) + the year axis rounded up to 16 + block threads x
# (NY y-column slots + max(NY, 16) | 1 t-column / staging slots) x value size
@pytest.mark.parametrize(
    "dtype,ny,want",
    [
        (torch.float32, 1, 18_464),
        (torch.float32, 2, 19_488),
        (torch.float32, 40, 83_120),
        (torch.float32, 64, 132_368),
        (torch.float64, 1, 18_464),
        (torch.float64, 2, 19_488),
        (torch.float64, 40, 83_280),
        (torch.float64, 64, 132_624),
    ],
)
def test_smem_bytes_per_block(dtype, ny, want):
    assert sc.smem_bytes(ny, dtype) == want
    assert want <= sc.SMEM_LIMIT == 232_448


@pytest.mark.parametrize("dtype,block", [(torch.float64, 256), (torch.float32, 512)])
def test_smem_plan_rejects_above_the_block_limit(dtype, block):
    with pytest.raises(ValueError, match="232,448"):
        sc.smem_bytes(64, dtype, block)


def test_block_sizes_are_multiples_of_the_chunk_granule():
    assert sc.BLOCKS == {torch.float32: 256, torch.float64: 128}
    # the global form's blocks divide the granule; its block follows the
    # shape (global_plan), so it has no block_of
    assert sc.GLOBAL_SWEEP == (32, 64, 128)
    assert all(sc.CUDA_BLOCK % b == 0 for b in sc.GLOBAL_SWEEP)
    assert all(b % sc.CUDA_BLOCK == 0 for b in sc.BLOCKS.values())
    assert set(sc.BLOCKS.values()) <= set(sc.SWEEP)
    # the wide blocks are half the narrow ones and divide the granule, so a
    # chunk still splits into whole blocks of either instantiation
    assert sc.WIDE_BLOCKS == {torch.float32: 128, torch.float64: 64}
    assert all(sc.CUDA_BLOCK % b == 0 for b in sc.WIDE_BLOCKS.values())
    for dtype in (torch.float32, torch.float64):
        assert sc.block_of(dtype, "narrow") == sc.BLOCKS[dtype]
        assert sc.block_of(dtype, "wide") == sc.WIDE_BLOCKS[dtype]
        with pytest.raises(ValueError, match="global_plan"):
            sc.block_of(dtype, "global")


# the wide plan: the same layout with the staging width max(NY, 32) | 1, at
# the wide blocks (128 float32, 64 float64); NY = 128 fits both
@pytest.mark.parametrize(
    "dtype,ny,want",
    [
        (torch.float32, 1, 17_440),
        (torch.float32, 65, 66_848),
        (torch.float32, 72, 74_544),
        (torch.float32, 128, 132_112),
        (torch.float64, 1, 17_440),
        (torch.float64, 65, 67_104),
        (torch.float64, 128, 132_624),
    ],
)
def test_wide_smem_bytes_per_block(dtype, ny, want):
    assert sc.smem_bytes(ny, dtype, cap="wide") == want
    assert want <= sc.SMEM_LIMIT


def test_wide_plan_rejects_the_narrow_block_at_128_years():
    # a 256-thread float32 block at NY = 128 would need 263,696 B
    with pytest.raises(ValueError, match="263,696"):
        sc.smem_bytes(128, torch.float32, 256, cap="wide")
    with pytest.raises(ValueError, match="1..128-year"):
        sc.smem_bytes(129, torch.float32, cap="wide")
    with pytest.raises(ValueError, match="1..64-year"):
        sc.smem_bytes(65, torch.float32)


def _cands(nc: int) -> LTParams:
    return LTParams(max_segments=nc - 4, vertex_count_overshoot=3)


@pytest.mark.parametrize(
    "ny,nc,want",
    [
        (64, 16, "narrow"),
        (65, 16, "wide"),
        (128, 16, "wide"),
        (129, 16, None),
        (40, 17, "wide"),
        (64, 32, "wide"),
        (128, 32, "wide"),
        (40, 33, None),
        (300, 9, None),
    ],
)
def test_instantiation_from_years_and_candidates(ny, nc, want):
    # None: no fixed instantiation holds the shape, and the global form
    # takes it — nothing is refused for its size
    params = _cands(nc)
    assert params.max_candidates == nc
    want = want or "global"
    assert sc.instantiation(ny, params) == want
    # the launch plan follows the instantiation
    years, vals, mask = _inputs(9, 8, ny)
    job = sc._Launch(years, vals, mask, params)
    fjob = sc._FamilyLaunch(years, vals, mask, params)
    assert job.cap == fjob.cap == want
    assert job.smem == fjob.smem == sc.smem_bytes(ny, torch.float32, cap=want, nc=nc)


@pytest.mark.parametrize("kw", ["cycles", "block"])
def test_wide_jobs_reject_the_narrow_only_entries(kw):
    # stage cycles and the sweep are the narrow kernel's and the global
    # form's shared tier's: the wide kernel and the scratch tier refuse them
    years, vals, mask = _inputs(4, 32, 72)
    job = sc._Launch(years, vals, mask, LTParams())
    assert job.cap == "wide"
    arg = 64 if kw == "block" else torch.zeros((32, 7), dtype=torch.int64)
    with pytest.raises(ValueError, match="the wide kernel has neither"):
        job.run(0, 32, **{kw: arg})
    gjob = sc._Launch(years, vals, mask, LTParams(), cap="global", _tier="scratch")
    with pytest.raises(ValueError, match="scratch tier"):
        gjob.run(0, 32, **{kw: arg})
    # the shared tier's sweep takes the global sweep's blocks only
    if kw == "block":
        sjob = sc._Launch(years, vals, mask, LTParams(), cap="global")
        with pytest.raises(ValueError, match=r"sweep's \(32, 64, 128\)"):
            sjob.run(0, 32, block=256)


# ---------------------------------------------------------------------------
# the global form: the series in shared memory at a block picked from NY,
# the dtype and the candidates; a per-call scratch, cut to a budget, only
# where no block holds it
# ---------------------------------------------------------------------------


# bytes: the fixed forms' layout at the launch's NC (16 + the year axis
# rounded up to 16 + block x (NY + max(NY, NC) | 1) values), plus the
# valid-year set as ceil(NY / 64) 64-bit words a thread, at the plan's
# block; default params (NC 10).  NY = 1000 fits no block: the scratch
# tier, no shared memory
@pytest.mark.parametrize(
    "dtype,ny,block,want",
    [
        (torch.float32, 1, 128, 16 + 16 + 128 * (1 + 11) * 4 + 128 * 8),            # 7,200
        (torch.float32, 40, 128, 16 + 160 + 128 * (40 + 41) * 4 + 128 * 8),         # 42,672
        (torch.float32, 160, 32, 16 + 640 + 32 * (160 + 161) * 4 + 3 * 32 * 8),     # 42,512
        (torch.float32, 1000, None, None),
        (torch.float64, 1, 128, 16 + 16 + 128 * (1 + 11) * 8 + 128 * 8),            # 13,344
        (torch.float64, 40, 64, 16 + 320 + 64 * (40 + 41) * 8 + 64 * 8),            # 42,320
        (torch.float64, 160, 64, 16 + 1280 + 64 * (160 + 161) * 8 + 3 * 64 * 8),    # 167,184
        (torch.float64, 1000, None, None),
    ],
)
def test_global_shared_bytes_per_block(dtype, ny, block, want):
    params = LTParams()
    plan = sc.global_plan(ny, params, dtype)
    if want is None:
        assert plan == sc.GlobalPlan("scratch", sc.CUDA_BLOCK, 0, plan.scratch_per_block)
        with pytest.raises(ValueError, match="232,448"):
            sc.smem_bytes(ny, dtype, cap="global", nc=params.max_candidates)
        return
    assert plan == sc.GlobalPlan("shared", block, want, 0)
    assert sc.smem_bytes(ny, dtype, cap="global", nc=10) == want <= sc.SMEM_LIMIT
    with pytest.raises(ValueError, match="pass nc"):
        sc.smem_bytes(ny, dtype, cap="global")
    with pytest.raises(ValueError, match="needs a year"):
        sc.smem_bytes(0, dtype, cap="global", nc=10)


# the block: of 128, 64 and 32 threads that fit, the one an SM holds the
# most warps of (233,472 shared bytes, 1,024 kept per resident block, at
# most 32 blocks), ties to the larger; the scratch tier (0) when none fits
# (float32 from NY 880, float64 from 444) or above 64 candidates
@pytest.mark.parametrize(
    "dtype,ny,nc,block",
    [
        (torch.float32, 40, 10, 128),    # 5 blocks x 4 warps = 20, 10 x 2 = 20, 19 x 1
        (torch.float32, 160, 10, 32),    # 1 x 4, 2 x 2, 5 x 1 = 5
        (torch.float32, 172, 10, 32), (torch.float32, 173, 10, 128),
        (torch.float32, 221, 10, 128), (torch.float32, 222, 10, 32),
        (torch.float32, 289, 10, 32), (torch.float32, 290, 10, 64),
        (torch.float32, 443, 10, 64), (torch.float32, 444, 10, 32),
        (torch.float32, 879, 10, 32), (torch.float32, 880, 10, 0),
        (torch.float64, 40, 10, 64), (torch.float64, 160, 10, 64),
        (torch.float64, 443, 10, 32), (torch.float64, 444, 10, 0),
        (torch.float32, 40, 64, 128), (torch.float32, 40, 65, 0),
        (torch.float64, 1, 65, 0),
    ],
)
def test_global_block_follows_years_dtype_and_candidates(dtype, ny, nc, block):
    params = _cands(nc)
    plan = sc.global_plan(ny, params, dtype)
    assert plan.block == (block or sc.CUDA_BLOCK)
    assert plan.tier == ("shared" if block else "scratch")
    if block:
        elem = 8 if dtype == torch.float64 else 4

        def warps(b):
            n = sc._global_smem_plan(ny, nc, elem, b)
            return -1 if n > sc.SMEM_LIMIT else min(233_472 // (n + 1_024), 32) * b // 32

        assert plan.smem == sc._global_smem_plan(ny, nc, elem, block) <= sc.SMEM_LIMIT
        # no other block holds more warps, nor a larger one as many
        assert all(warps(b) < warps(block) or (warps(b) == warps(block) and b < block)
                   for b in sc.GLOBAL_SWEEP if b != block)
        assert sc.global_plan(ny, params, dtype, _tier="scratch").tier == "scratch"
    else:
        with pytest.raises(ValueError, match="shared tier holds"):
            sc.global_plan(ny, params, dtype, _tier="shared")


# bytes per call of the scratch tier: one region per 128-px block, each
# the block's layout and then its per-thread arrays as planes — NC ints x 4,
# NM ints, NC values x 4, NM values x 3, a thread each
def _region(ny, nc, nm, elem):
    layout = 16 + (ny * elem + 15) // 16 * 16 + 128 * (ny + (max(ny, nc) | 1)) * elem \
        + (ny + 63) // 64 * 128 * 8
    return layout + ((4 * nc + nm) * 4 + (4 * nc + 3 * nm) * elem) * 128


@pytest.mark.parametrize(
    "ny,over,dtype,px,want",
    [
        # NC 10, NM 6: 1,044,912 B of layout + 53,248 of arrays a block
        (1000, {}, torch.float32, 128, 1_098_160),
        (1000, {}, torch.float64, 128, 2_156_368),
        (1000, {}, torch.float32, 129, 2 * 1_098_160),
        # a forced scratch tier at 40 years: 42,672 + 53,248
        (40, {}, torch.float32, 128, 95_920),
        # 66 candidates (NC 66, NM 62), float64, 1000 px in 8 blocks
        (80, {"max_segments": 62, "vertex_count_overshoot": 3}, torch.float64, 1000,
         8 * _region(80, 66, 62, 8)),
    ],
)
def test_global_scratch_bytes(ny, over, dtype, px, want):
    params = LTParams(**over)
    assert sc.global_scratch_bytes(ny, params, dtype, px) == want
    elem = 8 if dtype == torch.float64 else 4
    assert want == -(-px // 128) * _region(ny, params.max_candidates, params.max_segments, elem)


def test_global_scratch_region_layout():
    # the region's arrays start where the block's layout (the shared
    # tier's bytes at the same block) ends; every plane is whole 128-byte runs
    params = LTParams()
    layout = sc._global_smem_plan(1000, 10, 4, sc.CUDA_BLOCK)
    assert layout == 1_044_912 and layout % 16 == 0
    per_block = sc.global_plan(1000, params, torch.float32).scratch_per_block
    assert per_block - layout == ((4 * 10 + 6) * 4 + (4 * 10 + 3 * 6) * 4) * 128 == 53_248
    assert per_block == sc.global_scratch_bytes(1000, params, torch.float32, 128)


@pytest.mark.parametrize(
    "ny,over,dtype,budget,want",
    [
        (1000, {}, torch.float32, 1 << 30, 125_056),
        (1000, {}, torch.float64, 1 << 30, 63_616),
        (160, {}, torch.float32, 1 << 30, 620_928),
        (40, {"max_segments": 36, "vertex_count_overshoot": 3}, torch.float32, 1 << 30,
         490_368),
        (40, {}, torch.float32, 95_920 * 3 + 5, 384),
        (40, {}, torch.float32, 95_920, 128),
    ],
)
def test_global_chunk_stays_within_the_budget(ny, over, dtype, budget, want):
    params = LTParams(**over)
    assert sc.global_chunk(ny, params, dtype, budget) == want
    assert want % sc.CUDA_BLOCK == 0
    assert sc.global_scratch_bytes(ny, params, dtype, want) <= budget
    assert sc.global_scratch_bytes(ny, params, dtype, want + sc.CUDA_BLOCK) > budget


def test_global_chunk_refuses_a_budget_below_one_block():
    with pytest.raises(ValueError, match="one block of 128 px"):
        sc.global_chunk(40, LTParams(), torch.float32, 95_920 - 1)


def test_global_launch_plan_cuts_the_call_into_pieces(monkeypatch):
    # the scratch tier under a budget of three blocks: 1000 px launch as
    # 384 + 384 + 232, over one scratch sized for the largest piece
    monkeypatch.setattr(sc, "GLOBAL_SCRATCH_BUDGET", 95_920 * 3)
    years, vals, mask = _inputs(8, 1000, 40)
    job = sc._Launch(years, vals, mask, LTParams(), cap="global", _tier="scratch")
    fjob = sc._FamilyLaunch(years, vals, mask, LTParams(), cap="global", _tier="scratch")
    assert job.smem == fjob.smem == 0
    assert job.block == fjob.block == sc.CUDA_BLOCK
    assert job.scratch.chunk == fjob.scratch.chunk == 384
    assert job.scratch.tensor.numel() == 95_920 * 3
    assert job.scratch.tensor.dtype == torch.uint8
    assert list(job.scratch.pieces(0, 1000)) == [(0, 384), (384, 384), (768, 232)]
    assert list(job.scratch.pieces(256, 256)) == [(256, 256)]
    # a call smaller than the chunk allocates only what it needs
    small = sc._Launch(years[:], vals[:100], mask[:100], LTParams(), cap="global",
                       _tier="scratch")
    assert small.scratch.tensor.numel() == sc.global_scratch_bytes(40, LTParams(), px=100)
    # the shared tier allocates none and launches once a call
    shared = sc._Launch(years, vals, mask, LTParams(), cap="global")
    assert shared.scratch is None and shared.block == 128 and shared.smem == 42_672
    assert list(shared._pieces(0, 1000)) == [(0, 1000)]
    with pytest.raises(ValueError, match="the global form's"):
        sc._Launch(years, vals, mask, LTParams(), _tier="scratch")


# the FTV kernel's plan: the global form's at NV = max_segments + 1 in
# place of the candidates (its per-thread arrays hold the vertices): the
# shared tier at the block an SM holds the most warps of, the scratch tier
# where no block holds the series or NV passes the 64 locals
@pytest.mark.parametrize(
    "dtype,ny,over,tier,block,smem",
    [
        (torch.float32, 40, {}, "shared", 128, 42_672),     # the benchmark's shape
        (torch.float64, 40, {}, "shared", 64, 42_320),
        (torch.float32, 160, {}, "shared", 32, 42_512),
        (torch.float32, 880, {}, "scratch", 128, 0),        # no block of 32 holds it
        (torch.float64, 444, {}, "scratch", 128, 0),
        (torch.float32, 40, {"max_segments": 63}, "shared", 128, 54_960),   # NV 64
        (torch.float32, 40, {"max_segments": 64}, "scratch", 128, 0),       # NV 65
    ],
)
def test_ftv_plan_is_the_global_plan_at_nv(dtype, ny, over, tier, block, smem):
    params = LTParams(**over)
    at_nv = sc._ftv_params(params)
    assert at_nv.max_candidates == params.max_vertices
    assert at_nv == LTParams(**{**over, "vertex_count_overshoot": 0})
    plan = sc.global_plan(ny, at_nv, dtype)
    assert (plan.tier, plan.block, plan.smem) == (tier, block, smem)
    assert plan.scratch_per_block == (
        0 if tier == "shared" else sc.global_scratch_bytes(ny, at_nv, dtype, sc.CUDA_BLOCK))


@pytest.mark.parametrize("cap", ["narrow", "wide"])
def test_forcing_a_form_that_cannot_hold_the_shape_is_refused(cap):
    years, vals, mask = _inputs(9, 8, 129)
    with pytest.raises(ValueError, match=f"the {cap} kernel holds"):
        sc._Launch(years, vals, mask, LTParams(), cap=cap)
    with pytest.raises(ValueError, match="not one of"):
        sc._Launch(years, vals, mask, LTParams(), cap="huge")
    # the global form holds it, as the instantiation picks
    assert sc._Launch(years, vals, mask, LTParams()).cap == "global"


# ---------------------------------------------------------------------------
# the launch plan: the caller's tensors in, pixel-major tensors out
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_fused_launch_reads_the_callers_tensors(dtype):
    years, vals, mask = _inputs(1, 37, 40, dtype)
    params = LTParams()
    job = sc._Launch(years, vals, mask, params)
    # no transposed values, no cleaned mask: the kernel reads these
    assert job.values is vals and job.mask is mask
    assert job.years.shape == (40,) and job.years.dtype == dtype
    assert job.smem == sc.smem_bytes(40, dtype)
    nv, nm = params.max_vertices, params.max_segments
    widths = [40, 40, None, nv, nv, nv, nv, nm, nm, nm, None, None, None]
    for out, w in zip(job.outs, widths):
        assert out.shape == ((37,) if w is None else (37, w))
        assert out.is_contiguous()
    # the result is the kernel's output tensors themselves, not copies
    res = job.result()
    assert [o.data_ptr() for o in res] == [
        job.outs[i].data_ptr() for i in (2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 0)
    ]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_family_launch_reads_the_callers_tensors(dtype):
    years, vals, mask = _inputs(2, 37, 40, dtype)
    job = sc._FamilyLaunch(years, vals, mask, LTParams())
    assert job.values is vals and job.mask is mask
    desp, vm, sse = job.result()
    # year-major device outputs, returned as views in the plain layout
    assert desp.shape == (37, 40) and desp.data_ptr() == job.despiked.data_ptr()
    assert vm.shape == (37, 6, 40) and vm.data_ptr() == job.vmasks.data_ptr()
    assert sse.shape == (37, 6) and sse.data_ptr() == job.sses.data_ptr()


@pytest.mark.parametrize("kw", ["op_count", "cycles", "block"])
def test_float32_only_launches_reject_float64(kw):
    # the op tally, stage cycles and sweep entries are float32 kernels: a
    # float64 job is refused before anything is built or launched
    years, vals, mask = _inputs(4, 32, 40, torch.float64)
    job = sc._Launch(years, vals, mask, LTParams())
    arg = 256 if kw == "block" else torch.zeros(32, dtype=torch.int64)
    with pytest.raises(ValueError, match="float32"):
        job.run(0, 32, **{kw: arg})


def test_sweep_launch_rejects_an_unbuilt_block():
    years, vals, mask = _inputs(4, 32, 40)
    job = sc._Launch(years, vals, mask, LTParams())
    with pytest.raises(ValueError, match="sweep"):
        job.run(0, 32, block=64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_stage_cycles_need_the_card(dtype):
    years, vals, mask = _inputs(3, 32, 40, dtype)
    with pytest.raises(ValueError, match="CUDA"):
        sc.cuda_segment_stage_cycles(years, vals, mask)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda", 0)


def _same_decisions_and_bits(got, ref, exact_floats: bool):
    agree = (
        (got.model_valid == ref.model_valid)
        & (got.n_vertices == ref.n_vertices)
        & (got.vertex_indices == ref.vertex_indices).all(dim=1)
    )
    assert bool(agree.all())
    for name, a, b in zip(got._fields, got, ref):
        if exact_floats or not a.dtype.is_floating_point:
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
        else:
            assert torch.equal(a.isnan(), b.isnan()), name
            fin = a.isfinite()
            assert float((a[fin] - b[fin]).abs().max()) <= 1e-8, name


@pytest.mark.cuda
@pytest.mark.parametrize("ny", [1, 2, 39, 64])
def test_ragged_slab_matches_plain_on_card(card, ny):
    # 1000 px: the last block of either block size is ragged
    years, vals, mask = _inputs(ny, 1000, ny, torch.float64)
    for dtype in (torch.float32, torch.float64):
        v, m, y = vals.to(dtype).to(card), mask.to(card), years.to(card)
        got = sc.cuda_segment_pixels(y, v, m)
        ref = torch_segment_pixels(y, v, m)
        _same_decisions_and_bits(got, ref, exact_floats=dtype == torch.float32)
        fam, pfam = sc.cuda_family_stats(y, v, m), torch_family_stats(y, v, m)
        for a, b in zip(fam, pfam):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_unaligned_view_matches_plain_on_card(card):
    # a row offset of 39 values leaves the slab off 16-byte alignment:
    # the blocks take per-thread loads
    years, vals, mask = (x.to(card) for x in _inputs(5, 1025, 39))
    v, m = vals[1:], mask[1:]
    assert v.is_contiguous() and v.data_ptr() % 16
    got = sc.cuda_segment_pixels(years, v, m)
    _same_decisions_and_bits(got, torch_segment_pixels(years, v, m), exact_floats=True)


@pytest.mark.cuda
def test_chunked_pixel_major_equals_unchunked_on_card(card):
    # chunks of 384 start inside a 256-thread block of the float32 kernel
    years, vals, mask = (x.to(card) for x in _inputs(6, 1536, 39))
    whole = sc.cuda_segment_pixels(years, vals, mask)
    before = sc.LAUNCHES
    parts = sc.cuda_segment_pixels_chunked(years, vals, mask, chunk=384)
    assert sc.LAUNCHES == before + 4
    for name, a, b in zip(whole._fields, whole, parts):  # bit for bit, NaN == NaN
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name


@pytest.mark.cuda
def test_stage_cycles_sum_to_the_total_on_card(card):
    years, vals, mask = _inputs(7, 2048, 40)
    mask[:64, 3:] = False  # three valid years: below min_observations
    vals[64:128] = 0.5     # flat: y_range 0, no candidates or family
    years, vals, mask = years.to(card), vals.to(card), mask.to(card)
    cyc = sc.cuda_segment_stage_cycles(years, vals, mask)
    assert cyc.shape == (2048, len(sc.STAGES) + 1)
    assert int(cyc.min()) >= 0
    assert torch.equal(cyc[:, :-1].sum(dim=1), cyc[:, -1])
    assert bool((cyc[:, -1] > 0).all())
    # each mark sits where the stage it closes runs: the stages a pixel
    # skips count 0, and only those
    valid = mask & vals.isfinite()
    enough = valid.sum(dim=1) >= LTParams().min_observations_needed
    desp = sc.cuda_segment_pixels(years, vals, mask).despiked
    y_hi = desp.masked_fill(~valid, -torch.inf).amax(dim=1)
    y_lo = desp.masked_fill(~valid, torch.inf).amin(dim=1)
    fits = enough & (y_hi > y_lo)
    assert bool((~enough[:64]).all()) and bool((enough[64:128] & ~fits[64:128]).all())
    stage = {name: cyc[:, i] > 0 for i, name in enumerate(sc.STAGES)}
    assert bool(stage["load_compact"].all()) and bool(stage["refit_output"].all())
    assert torch.equal(stage["despike"], enough)
    for name in ("candidates_cull", "family_fits", "scoring_selection"):
        assert torch.equal(stage[name], fits), name
