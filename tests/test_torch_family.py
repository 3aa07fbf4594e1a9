"""The model family (stages 1–4a) of the port against the JAX family kernel.

``torch_family_stats`` is the plain version of the family kernel
(``csrc/segment_fused.cu:family_stats_kernel``); here it is held against
``family_stats_pallas(..., interpret=True)`` — the JAX package's own CPU
mode of that kernel — on the same numpy inputs.  In float64 the vertex
sets and the despiked series must be equal and the SSEs within rtol 1e-12
plus an absolute 1e-14: the two compute each residual with different
expressions (the Pallas kernel's year-axis fills against the port's
compacted series), and an SSE of a few 1e-3 is a 40-term sum of O(1)
squares whose rounding is absolute, ~40 ulp(1) ≈ 1e-14 (measured: at
most 3.9e-15, 1.1e-12 relative, on 512 px).
Float32 vertex sets agree on >= 99.5% of 1,024 pixels, the floor
``tests/test_pallas.py`` holds the Pallas kernel to at that size.  The
family followed by the port's tail is bit-identical to
``torch_segment_pixels``, and the stage probe runs on the CPU.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from land_trendr_tpu.config import LTParams as JLTParams
from land_trendr_tpu.ops.segment_pallas import family_stats_pallas
from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops import segment_cuda as sc
from land_trendr_tpu_torch.ops.segment import (
    _select_and_assemble,
    torch_family_stats,
    torch_segment_pixels,
)
from land_trendr_tpu_torch.tools.population import make_population
from tools._population import make_population as jax_make_population

# the suite runs several workers per host: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
NY = 40


def _edge_population(px: int, seed: int):
    """The mixed-regime population with its first rows replaced by the
    cases the fused kernel never runs the family for."""
    years, vals, mask = make_population(np.random.default_rng(seed), px, NY)
    vals = vals.astype(np.float64)
    mask[0] = False                                 # all masked
    mask[1] = False
    mask[1, 17] = True                              # one valid year
    mask[2] = False
    mask[2, [3, 9, 15, 22, 30, 38]] = True          # exactly min_observations_needed
    vals[3, [4, 11, 25]] = [np.nan, np.inf, -np.inf]  # non-finite inputs
    vals[4] = 0.5                                   # flat: y_range == 0
    vals[5] = -0.25
    mask[5, ::3] = False                            # flat and gappy
    mask[6] = False
    mask[6, [0, 39]] = True                         # two valid years
    mask[7] = False
    mask[7, 10:14] = True                           # below min_observations_needed
    return years, vals, mask


def _port_family(years, vals, mask, params):
    out = torch_family_stats(
        torch.from_numpy(years), torch.from_numpy(vals), torch.from_numpy(mask), params
    )
    return [a.numpy() for a in out]


def _jax_family(years, vals, mask, params, interpret=True):
    out = family_stats_pallas(
        years, vals, mask, JLTParams(**params.to_dict()), block=256, interpret=interpret
    )
    return [np.asarray(a) for a in out]


def test_population_copy_matches_jax_package():
    a = make_population(np.random.default_rng(4), 64, NY)
    b = jax_make_population(np.random.default_rng(4), 64, NY)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize(
    "params",
    [
        LTParams(),
        LTParams(spike_threshold=1.0),
        LTParams(prevent_one_year_recovery=False),
        LTParams(max_segments=4),
    ],
    ids=["default", "no_despike", "allow_one_year_recovery", "max_segments_4"],
)
def test_family_matches_pallas_interpret_f64(params):
    years, vals, mask = _edge_population(512, seed=6)
    desp, vm, sse = _port_family(years, vals, mask, params)
    jdesp, jvm, jsse = _jax_family(years, vals, mask, params)
    nm = params.max_segments
    assert desp.shape == (512, NY) and vm.shape == (512, nm, NY) and sse.shape == (512, nm)
    assert vm.dtype == np.bool_ and desp.dtype == sse.dtype == np.float64
    np.testing.assert_array_equal(vm, jvm)
    np.testing.assert_array_equal(desp, jdesp)
    np.testing.assert_allclose(sse, jsse, rtol=1e-12, atol=1e-14)
    # invalid years carry 0 in the despiked series, as in the JAX kernel
    m = mask & np.isfinite(vals)
    assert (desp[~m] == 0).all()


def test_family_edge_rows():
    """What the family holds for the pixels the tail calls flat."""
    years, vals, mask = _edge_population(256, seed=9)
    desp, vm, sse = _port_family(years, vals, mask, LTParams())
    counts = vm.sum(-1)
    assert (counts[0] == 0).all() and (sse[0] == 0).all()       # no valid year
    assert (counts[1] == 1).all() and vm[1, :, 17].all()        # one: itself
    assert (sse[1] == 0).all()
    assert (counts[6] == 2).all() and vm[6][:, [0, 39]].all()   # two: both ends
    assert (counts[4] >= 2).all()                               # flat: a family all the same
    # a pruning chain: vertex counts never grow down the family
    assert (np.diff(counts, axis=1) <= 0).all()


def test_family_f32_vertex_sets_track_f64():
    years, vals, mask = make_population(np.random.default_rng(8), 1024, NY)
    _, vm64, _ = _port_family(years, vals.astype(np.float64), mask, LTParams())
    _, vm32, _ = _port_family(years, vals.astype(np.float32), mask, LTParams())
    agree = (vm64 == vm32).all(axis=(1, 2)).mean()
    assert agree >= 0.995, agree


def test_family_f32_matches_pallas_interpret_f32():
    years, vals, mask = make_population(np.random.default_rng(12), 256, NY)
    v32 = vals.astype(np.float32)
    _, vm, _ = _port_family(years, v32, mask, LTParams())
    with jax.enable_x64(False):
        _, jvm, _ = _jax_family(years, v32, mask, LTParams())
    agree = (vm == jvm).all(axis=(1, 2)).mean()
    assert agree >= 0.995, agree


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("params", [LTParams(), LTParams(max_segments=3, vertex_count_overshoot=1)])
def test_family_then_tail_is_torch_segment_pixels(dtype, params):
    years, vals, mask = _edge_population(384, seed=10)
    args = (torch.from_numpy(years), torch.from_numpy(vals).to(dtype), torch.from_numpy(mask))
    family = torch_family_stats(*args, params)
    got = _select_and_assemble(*args, *family, params)
    ref = torch_segment_pixels(*args, params)
    for name, a, b in zip(ref._fields, got, ref):
        assert a.dtype == b.dtype, name
        if a.dtype.is_floating_point:
            a, b = a.view(torch.uint8), b.view(torch.uint8)
        assert torch.equal(a, b), name


def test_tail_rejects_a_family_of_the_wrong_shape():
    years, vals, mask = _edge_population(16, seed=1)
    args = (torch.from_numpy(years), torch.from_numpy(vals), torch.from_numpy(mask))
    desp, vm, sse = torch_family_stats(*args)
    with pytest.raises(ValueError, match="family must be"):
        _select_and_assemble(*args, desp, vm[:, :3], sse)
    with pytest.raises(ValueError, match="family must be"):
        _select_and_assemble(*args, desp, vm.to(torch.uint8), sse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_family_stats_on_cpu_is_the_plain_version(dtype):
    years, vals, mask = _edge_population(64, seed=2)
    args = (torch.from_numpy(years), torch.from_numpy(vals).to(dtype), torch.from_numpy(mask))
    before = sc.FAMILY_LAUNCHES
    got = sc.cuda_family_stats(*args)
    ref = torch_family_stats(*args)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert sc.FAMILY_LAUNCHES == before  # no kernel ran


def test_cuda_family_stats_checks_inputs():
    years, vals, mask = _edge_population(8, seed=3)
    with pytest.raises(TypeError, match="float32 or float64"):
        sc.cuda_family_stats(torch.from_numpy(years), torch.from_numpy(vals).half(),
                             torch.from_numpy(mask))
    # 70 years take the wide kernel, 129 the global form: no length is
    # refused (the plain version runs here, on the CPU)
    args = (torch.arange(129), torch.rand((8, 129), generator=torch.Generator().manual_seed(1)),
            torch.ones((8, 129), dtype=torch.bool))
    assert sc.instantiation(129, LTParams()) == "global"
    for a, b in zip(sc.cuda_family_stats(*args), torch_family_stats(*args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        sc.cuda_family_op_counts(torch.from_numpy(years),
                                 torch.from_numpy(vals).float(), torch.from_numpy(mask))


def test_probe_stages_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "land_trendr_tpu_torch.tools.probe", "stages",
         "--device", "cpu", "--px", "256", "--reps", "1"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["probe"] == "stages" and res["px"] == 256 and res["device"] == "cpu"
    assert set(res["variants"]) == {"fused", "family_only", "family_plus_tail", "plain"}
    for v in res["variants"].values():
        assert v["per_step_s"] > 0 and v["px_per_s"] > 0
    assert set(res["derived"]) == {"tail_s", "in_kernel_tail_s", "fusion_win_s"}
    assert res["timing"] == "host clock"
