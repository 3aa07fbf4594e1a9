"""The kernel source's global form, compiled for the host, against the
plain version on the CPU.

``csrc/segment_fused.cu`` is compiled with g++ through
``tests/_cuda_host_shim.h`` (CUDA's qualifiers and intrinsics as plain
C++, the PTX of the bulk copies dropped, a launch run one thread after
another).  The global form of both kernels keeps no shared memory and
meets at no barrier, so each thread runs here exactly as its pixel's
thread does on the card: the same loops over the same scratch planes,
launched through the wrapper's own plan (``_Launch`` / ``_FamilyLaunch``,
the scratch cut into pieces).  Decisions and every output are
bit-identical to the plain version, except ``rmse`` and ``p_of_f``: their
square roots, logs and exponentials come from the host's libm here and
from PyTorch's CPU kernels in the plain version, so they agree to a few
units in the last place (1e-8 absolute in float32, 1e-15 in float64).
On the card the same comparison is bit for bit (``tests/test_torch_cuda.py``).
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


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory, request):
    """The kernel library built for the host and loaded through the
    wrapper (its argtypes and plan checks), restored afterwards."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    src = sc._SRC.read_text()
    for old, new in (
        ("#include <cuda_runtime.h>", f'#include "{HERE / "_cuda_host_shim.h"}"'),
        ("asm volatile(", "LT_NOASM("),
        ("extern __shared__ __align__(16) unsigned char smem[];",
         "unsigned char* smem = lt_emu_smem;"),
        ("  kernel<<<(unsigned)grid, block, (size_t)bytes, st>>>(args...);",
         "  (void)st;\n  for (long long b = 0; b < grid; ++b)\n"
         "    for (int t = 0; t < block; ++t) {\n"
         "      blockIdx.x = (unsigned)b;\n      threadIdx.x = (unsigned)t;\n"
         "      kernel(args...);\n    }"),
    ):
        assert old in src, old
        src = src.replace(old, new)
    out = tmp_path_factory.mktemp("kernel_host")
    (out / "segment_fused_host.cpp").write_text(src)
    lib = out / "libsegment_fused_host.so"
    r = subprocess.run([gxx, "-std=c++17", "-O0", "-ffp-contract=off", "-shared", "-fPIC", "-w",
                        "-o", str(lib), str(out / "segment_fused_host.cpp")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    mp = pytest.MonkeyPatch()
    sc.load_library.cache_clear()
    mp.setattr(sc, "_built", lambda: (str(lib), {}))
    mp.setattr(torch.cuda, "current_stream",
               lambda device=None: types.SimpleNamespace(cuda_stream=0))
    request.addfinalizer(lambda: (mp.undo(), sc.load_library.cache_clear()))
    return sc.load_library()  # cross-checks the shared-memory and scratch plans


def _inputs(ny: int, px: int, dtype):
    years, vals, mask = make_population(np.random.default_rng(7), px, ny)
    return (torch.from_numpy(years.astype(np.float64)).to(dtype),
            torch.from_numpy(vals.astype(np.float64)).to(dtype).contiguous(),
            torch.from_numpy(mask).contiguous())


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
    params = LTParams(**over)
    px = 200
    if budget_blocks is not None:
        monkeypatch.setattr(sc, "GLOBAL_SCRATCH_BUDGET", sc.global_scratch_bytes(
            ny, params, dtype, budget_blocks * sc.CUDA_BLOCK))
    years, vals, mask = _inputs(ny, px, dtype)
    pieces = -(-px // sc.global_chunk(ny, params, dtype))
    before = (sc.GLOBAL_LAUNCHES, sc.GLOBAL_FAMILY_LAUNCHES)
    job = sc._Launch(years, vals, mask, params, cap="global")
    job.run(0, px)
    fjob = sc._FamilyLaunch(years, vals, mask, params, cap="global")
    fjob.run()
    assert (sc.GLOBAL_LAUNCHES, sc.GLOBAL_FAMILY_LAUNCHES) == (before[0] + pieces,
                                                              before[1] + pieces)
    got, ref = job.result(), torch_segment_pixels(years, vals, mask, params)
    for name, a, b in zip(got._fields, got, ref):
        if name in LIBM:
            assert torch.equal(a.isnan(), b.isnan()), name
            assert float((a - b).abs().nan_to_num().max()) <= LIBM[name][dtype], name
        else:
            assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
    assert int(got.n_vertices.max()) >= 3  # real models, not only flat ones
    for a, b in zip(fjob.result(), torch_family_stats(years, vals, mask, params)):
        assert torch.equal(a, b)
