"""The reference's adversarial inputs through the port
(``tests/test_nan_guards.py``'s ``ADVERSARIAL`` cases, copied here).

* float64, the plain version (``ops/segment.py:torch_segment_pixels``,
  ``ops/ftv.py:torch_fit_to_vertices``): every output finite, as the JAX
  package's guards test holds its kernel under ``jax_debug_nans``;
* float32: the plain version agrees with the JAX package's
  ``jax_segment_pixels`` (decisions equal, floats close, non-finite values
  at the same places) — ``huge_values`` gives a non-finite ``rmse`` in both
  packages, so finiteness is not the float32 contract;
* every form of the kernel source built for the host (narrow, wide, the
  global form's shared and scratch tiers; ``tests/test_torch_kernel_host.py``)
  against the plain version, bit for bit but the libm fields, in both
  dtypes: the slab load's finiteness test and the compaction see these
  inputs first.

``tests/test_torch_cuda.py`` holds the same cases on the card.
"""

from __future__ import annotations

import zlib

import numpy as np
import pytest
import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops import segment_cuda as sc
from land_trendr_tpu_torch.ops.ftv import torch_fit_to_vertices
from land_trendr_tpu_torch.ops.segment import torch_segment_pixels

torch.set_num_threads(1)

PARAMS = LTParams(max_segments=4, vertex_count_overshoot=2)
NY = 20

ADVERSARIAL = {
    "all_masked": lambda rng, ny: (
        rng.normal(size=(4, ny)),
        np.zeros((4, ny), bool),
    ),
    "single_valid_year": lambda rng, ny: (
        rng.normal(size=(4, ny)),
        np.eye(4, ny, dtype=bool),
    ),
    "two_valid_years": lambda rng, ny: (
        rng.normal(size=(4, ny)),
        np.eye(4, ny, dtype=bool) | np.eye(4, ny, k=5, dtype=bool),
    ),
    "constant_series": lambda rng, ny: (
        np.full((4, ny), 0.37),
        np.ones((4, ny), bool),
    ),
    "exact_min_observations": lambda rng, ny: (
        rng.normal(size=(4, ny)),
        np.tile(np.arange(ny) < PARAMS.min_observations_needed, (4, 1)),
    ),
    "huge_values": lambda rng, ny: (
        rng.normal(size=(4, ny)) * 1e30,
        rng.uniform(size=(4, ny)) > 0.2,
    ),
    "tiny_values": lambda rng, ny: (
        rng.normal(size=(4, ny)) * 1e-30,
        rng.uniform(size=(4, ny)) > 0.2,
    ),
    "nan_inputs_masked_out": lambda rng, ny: (
        np.where(rng.uniform(size=(4, ny)) > 0.5, np.nan, 0.5),
        np.ones((4, ny), bool),  # kernel must drop non-finite itself
    ),
    "inf_inputs_masked_out": lambda rng, ny: (
        np.where(rng.uniform(size=(4, ny)) > 0.5, np.inf, 0.5),
        np.ones((4, ny), bool),
    ),
    "alternating_mask": lambda rng, ny: (
        rng.normal(size=(4, ny)),
        np.tile(np.arange(ny) % 2 == 0, (4, 1)),
    ),
}


def adversarial(case: str, dtype=torch.float64):
    """``(years, values, mask)`` of one case, the same draw in every leg."""
    vals, mask = ADVERSARIAL[case](np.random.default_rng(zlib.crc32(case.encode())), NY)
    years = torch.arange(2000, 2000 + NY, dtype=torch.int32)
    return (years, torch.from_numpy(np.asarray(vals, np.float64)).to(dtype).contiguous(),
            torch.from_numpy(np.asarray(mask)).contiguous())


@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_segment_float64_outputs_are_finite(case):
    out = torch_segment_pixels(*adversarial(case), PARAMS)
    for name, field in zip(out._fields, out):
        assert bool(torch.isfinite(field.double()).all()), name


def test_ftv_float64_outputs_are_finite():
    rng = np.random.default_rng(20261018)
    years = torch.arange(2000, 2000 + NY, dtype=torch.int32)
    vals = torch.from_numpy(rng.normal(size=(6, NY)))
    mask = torch.from_numpy(rng.uniform(size=(6, NY)) > 0.2)
    seg = torch_segment_pixels(years, vals, mask, PARAMS)
    # a secondary index with its own pathologies: constants and an all-masked row
    sec = torch.full((6, NY), 2.5, dtype=torch.float64)
    sec_mask = mask.clone()
    sec_mask[0] = False
    ftv = torch_fit_to_vertices(years, sec, sec_mask, seg.vertex_indices, seg.n_vertices,
                                PARAMS)
    assert bool(torch.isfinite(ftv).all())


@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_segment_float32_agrees_with_the_jax_package(case):
    from land_trendr_tpu.config import LTParams as JaxParams
    from land_trendr_tpu.ops.segment import jax_segment_pixels

    years, vals, mask = adversarial(case, torch.float32)
    got = torch_segment_pixels(years, vals, mask, PARAMS)
    ref = jax_segment_pixels(years.numpy(), vals.numpy(), mask.numpy(),
                             JaxParams(max_segments=4, vertex_count_overshoot=2))
    for name, a in zip(got._fields, got):
        b = torch.from_numpy(np.asarray(getattr(ref, name)).copy())
        if not a.dtype.is_floating_point:
            assert torch.equal(a.to(torch.int64), b.to(torch.int64)), name
            continue
        a, b = a.double(), b.double()
        assert torch.equal(a.isnan(), b.isnan()), name
        assert torch.equal(a.isinf(), b.isinf()) and torch.equal(a[a.isinf()], b[b.isinf()]), name
        fin = a.isfinite()
        scale = b[fin].abs().clamp(min=1.0)
        assert bool(((a[fin] - b[fin]).abs() <= 1e-5 * scale).all()), name


#: the kernel's forms on the host: (form, the global form's tier)
FORMS = [("narrow", None), ("wide", None), ("global", "shared"), ("global", "scratch")]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory, request):
    from test_torch_kernel_host import build_host_library
    import types

    lib = build_host_library(tmp_path_factory.mktemp("kernel_host_guards"))
    mp = pytest.MonkeyPatch()
    sc.load_library.cache_clear()
    mp.setattr(sc, "_built", lambda: (str(lib), {}))
    mp.setattr(torch.cuda, "current_stream",
               lambda device=None: types.SimpleNamespace(cuda_stream=0))
    request.addfinalizer(lambda: (mp.undo(), sc.load_library.cache_clear()))
    return sc.load_library()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("form,tier", FORMS)
@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_every_form_on_the_host_matches_plain(host_lib, case, form, tier, dtype):
    from test_torch_kernel_host import _run_both, assert_matches_plain

    years, vals, mask = adversarial(case, dtype)
    years = years.to(dtype)
    job, fjob, launches = _run_both(years, vals, mask, PARAMS, form, tier)
    assert launches == [1, 1]
    assert_matches_plain(job.result(), years, vals, mask, PARAMS, dtype, fjob.result())
