"""The port's entry points (``land_trendr_tpu_torch/entry.py``) against the
JAX package's ``__graft_entry__.py`` on the CPU.

``entry(device="cpu")`` runs the plain version of the kernel on the JAX
function's own example batch; ``dryrun_multichip(n, devices=["cpu"] * 8)``
runs the sharded pipeline over a mesh of CPU devices and is held against
the JAX package's sharded segmentation and metrics on the conftest's
virtual 8-device mesh.  Tolerances: float32 decisions agree on >= 99.9%
of pixels, and on the agreeing pixels every float field's p99.9 |diff| is
<= 1e-5 and its max <= 5e-5 (the float32 contract of
``tests/test_torch_runtime.py``); float64 decisions are exact.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as g
from land_trendr_tpu.ops.segment import jax_segment_pixels  # before parallel: import order
from land_trendr_tpu.config import LTParams as JLTParams
from land_trendr_tpu.parallel import make_mesh as jax_make_mesh
from land_trendr_tpu.parallel import pad_to_multiple as jax_pad_to_multiple
from land_trendr_tpu.parallel import segment_pixels_sharded as jax_segment_pixels_sharded
from land_trendr_tpu.parallel import summarize_sharded as jax_summarize_sharded
from land_trendr_tpu_torch import entry as port

torch.set_num_threads(1)

DECISIONS = ("vertex_indices", "n_vertices", "model_valid")
#: the dry run's parameters (the JAX function's)
DRY_PARAMS = {"max_segments": 4, "vertex_count_overshoot": 2}


def _agree(a, b) -> np.ndarray:
    return ((np.asarray(a.model_valid) == np.asarray(b.model_valid))
            & (np.asarray(a.n_vertices) == np.asarray(b.n_vertices))
            & (np.asarray(a.vertex_indices) == np.asarray(b.vertex_indices)).all(axis=1))


@pytest.mark.parametrize("px,ny", [(256, 40), (25, 16), (7, 16)])
def test_example_batch_bit_equal_to_jax(px, ny):
    for a, b in zip(port._example_batch(px, ny), g._example_batch(px, ny)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_entry_on_cpu_holds_against_the_jax_entry():
    fn, args = port.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    out = fn(*args)
    jfn, jargs = g.entry()
    for a, b in zip(args, jargs):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    jout = jax.jit(jfn)(*jargs)
    jax.block_until_ready(jout)
    assert out.fitted.shape == (256, 40)
    assert float(out.model_valid.float().mean()) > 0.5
    agree = _agree(out, jout)
    assert agree.mean() >= 0.999, agree.mean()
    for name in out._fields:
        a, b = getattr(out, name).numpy(), np.asarray(getattr(jout, name))
        assert a.shape == b.shape, name
        if a.dtype.kind != "f":
            assert np.array_equal(a[agree], b[agree]), name
            continue
        d = np.abs(a[agree].astype(np.float64) - b[agree])
        d = d[np.isfinite(d)]
        assert np.quantile(d, 0.999) <= 1e-5, name
        assert d.max() <= 5e-5, name


def test_entry_batch_in_f64_exact_against_the_jax_kernel():
    fn, (years, vals, mask) = port.entry(device="cpu")
    out = fn(years.double(), vals.double(), mask)
    ref = jax_segment_pixels(years.numpy().astype(np.float64), vals.numpy().astype(np.float64),
                             mask.numpy(), JLTParams())
    for field in DECISIONS:
        assert np.array_equal(getattr(out, field).numpy(), np.asarray(getattr(ref, field))), field


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.dryrun_multichip(2)


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_on_cpu_devices_holds_against_jax(n):
    rec = port.dryrun_multichip(n, devices=["cpu"] * 8)  # asserts internally
    assert rec["mesh"] == ["cpu"] * n
    assert rec["summary"]["mesh_devices"] == n
    assert rec["summary"]["pixels"] == 6 * (2 * n + 1)
    assert "rmse" in rec["rasters"] and "change_mag" in rec["rasters"]
    # the JAX package's sharded segmentation and metrics on the same padded
    # batch, over its first n virtual devices
    years, vals, mask = g._example_batch(px=3 * n + 1, ny=16)
    vals_p, mask_p, n_real = jax_pad_to_multiple(vals, mask, n)
    assert n_real == rec["n_real"]
    mesh = jax_make_mesh(jax.devices()[:n])
    params = JLTParams(**DRY_PARAMS)
    jout = jax_segment_pixels_sharded(years, vals_p, mask_p, params, mesh=mesh)
    jout64 = jax_segment_pixels_sharded(np.asarray(years, np.float64),
                                        np.asarray(vals_p, np.float64), mask_p, params, mesh=mesh)
    for field in DECISIONS:
        assert np.array_equal(rec["decisions_f32"][field], np.asarray(getattr(jout, field))), field
        assert np.array_equal(rec["decisions_f64"][field],
                              np.asarray(getattr(jout64, field))), field
    jm = jax_summarize_sharded(jout, n_real=n_real)
    assert set(rec["metrics"]) == set(jm)
    for k, v in jm.items():
        # counts and rates of counts exactly; the float32 means within the
        # float32 contract's 1e-5
        tol = 0.0 if k in ("pixels", "fit_rate", "no_fit_rate") else 1e-5
        assert abs(rec["metrics"][k] - float(v)) <= tol, (k, rec["metrics"][k], float(v))


def test_dryrun_rejects_an_oversized_mesh():
    with pytest.raises(RuntimeError, match="need 64 devices"):
        port.dryrun_multichip(64, devices=["cpu"] * 8)
