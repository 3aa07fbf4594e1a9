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
