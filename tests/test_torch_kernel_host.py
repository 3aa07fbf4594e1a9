"""The kernel source, compiled for the host, against the plain version on
the CPU: every form of both kernels.

``csrc/segment_fused.cu`` is compiled with g++ (C++20) through
``tests/_cuda_host_shim.h``: CUDA's qualifiers and intrinsics as plain
C++, and a launch run block after block, each block as one thread per CUDA
thread over its own shared memory, ``__syncthreads()`` a barrier of the
block's threads (a thread that returns drops out of it), the bulk copy of
the slab a ``memcpy``.  So the narrow and wide forms and both tiers of the
global form run here as their blocks do on the card: the same slab load,
shared columns, barriers and staged output, launched through the
wrapper's own plan (``_Launch`` / ``_FamilyLaunch``; the scratch tier cut
into pieces).  Decisions and every output are bit-identical to the plain
version, except ``rmse`` and ``p_of_f``: their square roots, logs and
exponentials come from the host's libm here and from PyTorch's CPU
kernels in the plain version, so they agree to a few units in the last
place (1e-8 absolute in float32, 1e-15 in float64).  On the card the same
comparison is bit for bit (``tests/test_torch_cuda.py``).
"""

from __future__ import annotations

import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops import segment_cuda as sc
from land_trendr_tpu_torch.ops.segment import torch_family_stats, torch_segment_pixels
from land_trendr_tpu_torch.tools.population import make_population

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
#: outputs whose elementary functions come from different libraries here
LIBM = {"rmse": {torch.float32: 1e-8, torch.float64: 1e-15},
        "p_of_f": {torch.float32: 1e-8, torch.float64: 1e-15}}


def build_host_library(out: Path) -> Path:
    """The kernel source with the host shim's substitutions, built by g++
    into ``out``; returns the library's path."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    src = sc._SRC.read_text()
    for old, new in (
        ("#include <cuda_runtime.h>", f'#include "{HERE / "_cuda_host_shim.h"}"'),
        # the bulk copy lands the slab, and the wait on its mbarrier (which
        # every thread of the block makes) is a barrier behind the copy
        ("uint32_t bytes,\n                                          uint64_t* bar) {\n",
         "uint32_t bytes,\n                                          uint64_t* bar) {\n"
         "  std::memcpy(dst, src, bytes);\n"),
        ("uint32_t done = 0;", "__syncthreads();\n  uint32_t done = 1;"),
        ("asm volatile(", "LT_NOASM("),
        ("extern __shared__ __align__(16) unsigned char smem[];",
         "unsigned char* smem = lt_emu_smem;"),
        ("  kernel<<<(unsigned)grid, block, (size_t)bytes, st>>>(args...);",
         "  (void)st;\n  lt_emu_launch(kernel, grid, block, (size_t)bytes, args...);"),
    ):
        assert old in src, old
        src = src.replace(old, new)
    (out / "segment_fused_host.cpp").write_text(src)
    lib = out / "libsegment_fused_host.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-pthread", "-shared",
                        "-fPIC", "-w", "-o", str(lib), str(out / "segment_fused_host.cpp")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    return lib


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory, request):
    """The kernel library built for the host and loaded through the
    wrapper (its argtypes and plan checks), restored afterwards."""
    lib = build_host_library(tmp_path_factory.mktemp("kernel_host"))
    mp = pytest.MonkeyPatch()
    sc.load_library.cache_clear()
    mp.setattr(sc, "_built", lambda: (str(lib), {}))
    mp.setattr(torch.cuda, "current_stream",
               lambda device=None: types.SimpleNamespace(cuda_stream=0))
    request.addfinalizer(lambda: (mp.undo(), sc.load_library.cache_clear()))
    return sc.load_library()  # cross-checks the shared-memory, block and scratch plans


def _inputs(ny: int, px: int, dtype):
    years, vals, mask = make_population(np.random.default_rng(7), px, ny)
    return (torch.from_numpy(years.astype(np.float64)).to(dtype),
            torch.from_numpy(vals.astype(np.float64)).to(dtype).contiguous(),
            torch.from_numpy(mask).contiguous())


def assert_matches_plain(got, years, vals, mask, params, dtype, family=None):
    """Every output of ``got`` (and of ``family``, the family kernel's)
    bit-identical to the plain version but the libm fields."""
    ref = torch_segment_pixels(years, vals, mask, params)
    for name, a, b in zip(got._fields, got, ref):
        if name in LIBM:
            assert torch.equal(a.isnan(), b.isnan()), name
            assert float((a - b).abs().nan_to_num().max()) <= LIBM[name][dtype], name
        else:
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
    if family is not None:
        for a, b in zip(family, torch_family_stats(years, vals, mask, params)):
            assert torch.equal(a, b)


def _run_both(years, vals, mask, params, cap, tier=None):
    """Both kernels of form ``cap`` on the host; their results and launches."""
    names = {"narrow": ("LAUNCHES", "FAMILY_LAUNCHES"),
             "wide": ("WIDE_LAUNCHES", "WIDE_FAMILY_LAUNCHES"),
             "global": ("GLOBAL_LAUNCHES", "GLOBAL_FAMILY_LAUNCHES")}[cap]
    before = [getattr(sc, n) for n in names]
    job = sc._Launch(years, vals, mask, params, cap=cap, _tier=tier)
    job.run(0, vals.shape[0])
    fjob = sc._FamilyLaunch(years, vals, mask, params, cap=cap, _tier=tier)
    fjob.run()
    launches = [getattr(sc, n) - b for n, b in zip(names, before)]
    return job, fjob, launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "ny,over,budget_blocks",
    [
        (40, {}, None),                                                  # forced at a narrow shape
        (160, {}, None),                                                 # three set words
        (40, {"max_segments": 36, "vertex_count_overshoot": 3}, None),   # 40 candidates
        (72, {}, 1),                                                     # one block per piece
    ],
)
def test_global_form_on_the_host_matches_plain(host_lib, monkeypatch, dtype, ny, over,
                                               budget_blocks):
    # the shared tier at its own block, or (a budget given) the scratch
    # tier forced, one launch per budget-sized piece
    params = LTParams(**over)
    px = 200
    tier = None
    if budget_blocks is not None:
        tier = "scratch"
        monkeypatch.setattr(sc, "GLOBAL_SCRATCH_BUDGET", sc.global_scratch_bytes(
            ny, params, dtype, budget_blocks * sc.CUDA_BLOCK))
    years, vals, mask = _inputs(ny, px, dtype)
    job, fjob, launches = _run_both(years, vals, mask, params, "global", tier)
    assert job.plan.tier == fjob.plan.tier == (tier or "shared")
    pieces = 1 if tier is None else -(-px // sc.global_chunk(ny, params, dtype))
    assert launches == [pieces, pieces]
    assert (job.scratch is None) == (tier is None)
    assert_matches_plain(job.result(), years, vals, mask, params, dtype, fjob.result())
    assert int(job.result().n_vertices.max()) >= 3  # real models, not only flat ones


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "ny,over,px",
    [
        (1000, {}, 5),                                                   # a series no block holds
        (80, {"max_segments": 62, "vertex_count_overshoot": 3}, 40),     # 66 candidates
    ],
)
def test_global_scratch_tier_on_the_host_matches_plain(host_lib, dtype, ny, over, px):
    params = LTParams(**over)
    years, vals, mask = _inputs(ny, px, dtype)
    job, fjob, launches = _run_both(years, vals, mask, params, "global")
    assert job.plan.tier == fjob.plan.tier == "scratch" and launches == [1, 1]
    assert job.scratch.tensor.numel() == sc.global_scratch_bytes(ny, params, dtype, px)
    assert_matches_plain(job.result(), years, vals, mask, params, dtype, fjob.result())
    assert int(job.result().n_vertices.max()) >= 3


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize(
    "cap,ny,over",
    [
        ("narrow", 40, {}),
        ("wide", 72, {}),
        ("wide", 40, {"max_segments": 14, "vertex_count_overshoot": 3}),  # 18 candidates
    ],
)
def test_fixed_forms_on_the_host_match_plain(host_lib, dtype, cap, ny, over):
    # 300 px: the ragged last block of every block size; the bulk-copied
    # slab, the barriers and the staged output as on the card
    params = LTParams(**over)
    years, vals, mask = _inputs(ny, 300, dtype)
    assert sc.instantiation(ny, params) == cap
    job, fjob, launches = _run_both(years, vals, mask, params, cap)
    assert launches == [1, 1]
    assert_matches_plain(job.result(), years, vals, mask, params, dtype, fjob.result())
    assert int(job.result().n_vertices.max()) >= 3
