"""The port's pixel-axis sharding (``parallel/mesh.py``), held against the
unsharded port and the JAX package's sharded segmentation.

PyTorch has no virtual devices, so the port's mesh here is ``[cpu] * N``
(each shard runs the plain version on the CPU); the JAX side runs on its
8-device virtual CPU mesh from ``tests/conftest.py``, in float64.
Decisions must be exactly equal, floats within the port's parity
tolerances (``atol=1e-8, rtol=1e-7``, ``p_of_f`` ``atol=1e-9``).
"""

import os

import jax
import numpy as np
import pytest
import torch

from land_trendr_tpu.config import LTParams as JLTParams
from land_trendr_tpu.ops.segment import SegOutputs  # noqa: F401  (the JAX ops load before its parallel package)
from land_trendr_tpu.parallel import make_mesh as jax_make_mesh
from land_trendr_tpu.parallel import pad_to_multiple as jax_pad_to_multiple
from land_trendr_tpu.parallel import segment_pixels_sharded as jax_segment_pixels_sharded
from land_trendr_tpu.parallel import summarize_sharded as jax_summarize_sharded
from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.ops.segment import torch_segment_pixels
from land_trendr_tpu_torch.parallel import (
    PIXEL_AXIS,
    make_mesh,
    pad_to_multiple,
    segment_pixels_sharded,
    shard_pixels,
    summarize_sharded,
)

torch.set_num_threads(1)

CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(scope="module")
def batch():
    """The JAX package's ``tests/test_parallel.py`` batch."""
    rng = np.random.default_rng(7)
    ny, px = 30, 64
    years = np.arange(1990, 1990 + ny, dtype=np.int32)
    base = 0.55 + 0.05 * rng.standard_normal((px, ny))
    d_year = rng.integers(5, ny - 5, size=px)
    mag = rng.uniform(0.2, 0.5, size=px)
    after = np.arange(ny)[None, :] >= d_year[:, None]
    vals = base - after * mag[:, None] * np.exp(
        -0.1 * np.maximum(np.arange(ny)[None, :] - d_year[:, None], 0)
    )
    mask = rng.uniform(size=(px, ny)) > 0.1
    return years, (-vals).astype(np.float64), mask


@pytest.fixture(scope="module")
def jax_mesh():
    assert jax.device_count() == 8, "conftest must provide 8 virtual devices"
    return jax_make_mesh()


def test_make_mesh_rules():
    assert PIXEL_AXIS == "pixels"
    assert make_mesh(["cpu"] * 3) == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="must all be 'cuda' or all 'cpu'"):
        make_mesh(["cpu", "meta"])
    with pytest.raises(ValueError, match="at least one device"):
        make_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()  # never falls back to the CPU


def test_shard_pixels_is_contiguous(batch):
    _, vals, mask = batch
    shards = shard_pixels(CPU4, vals, mask)
    assert [v.shape[0] for v, _ in shards] == [16] * 4
    assert np.array_equal(torch.cat([v for v, _ in shards]).numpy(), vals)
    assert np.array_equal(torch.cat([m for _, m in shards]).numpy(), mask)


def test_sharded_equals_unsharded_and_jax(batch, jax_mesh):
    years, vals, mask = batch
    out = segment_pixels_sharded(years, vals, mask, LTParams(), mesh=CPU4)
    ref = torch_segment_pixels(
        torch.from_numpy(years), torch.from_numpy(vals), torch.from_numpy(mask), LTParams()
    )
    for name, a, b in zip(ref._fields, ref, out):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8)), name
    jx = jax_segment_pixels_sharded(years, vals, mask, JLTParams(), mesh=jax_mesh)
    for name in ("vertex_indices", "n_vertices", "model_valid"):
        assert np.array_equal(getattr(out, name).numpy(), np.asarray(getattr(jx, name))), name
    for name in ("vertex_years", "vertex_src_vals", "vertex_fit_vals", "seg_magnitude",
                 "seg_duration", "seg_rate", "fitted", "despiked", "rmse"):
        np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jx, name)),
                                   atol=1e-8, rtol=1e-7, err_msg=name)
    np.testing.assert_allclose(out.p_of_f.numpy(), np.asarray(jx.p_of_f), atol=1e-9)


def test_indivisible_batch_raises(batch):
    years, vals, mask = batch
    with pytest.raises(ValueError, match="not divisible"):
        segment_pixels_sharded(years, vals[:13], mask[:13], mesh=CPU4)


@pytest.mark.parametrize("n_px", [64, 61], ids=["aligned", "padded"])
def test_summarize_sharded_equals_jax(batch, jax_mesh, n_px):
    years, vals, mask = batch
    v, m, n_real = pad_to_multiple(
        torch.from_numpy(vals[:n_px]), torch.from_numpy(mask[:n_px]), 8
    )
    jv, jm, j_real = jax_pad_to_multiple(vals[:n_px], mask[:n_px], 8)
    assert n_real == j_real == n_px
    out = segment_pixels_sharded(years, v, m, mesh=CPU4)
    got = summarize_sharded(out, n_real=n_real)
    ref = jax_summarize_sharded(
        jax_segment_pixels_sharded(years, jv, jm, mesh=jax_mesh), n_real=j_real
    )
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12), k
    assert got["pixels"] == n_px
    if n_px != v.shape[0]:  # padding rows never fit: leaving them out raises the rate
        assert got["fit_rate"] > summarize_sharded(out)["fit_rate"]


def _tile_bytes(workdir):
    from land_trendr_tpu_torch.runtime import TileManifest

    man = TileManifest(workdir, "")
    out = {}
    for r in man.iter_records():
        if r.get("kind") == "tile":
            with np.load(man.tile_path(r["tile_id"])) as z:
                out[r["tile_id"]] = {k: z[k].tobytes() for k in z.files}
    return out


def test_run_stack_with_a_mesh_is_byte_equal(tmp_path):
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
    from land_trendr_tpu_torch.runtime import (
        RunConfig,
        assemble_outputs,
        run_stack,
        stack_from_synthetic,
    )

    stack = stack_from_synthetic(
        make_stack(SceneSpec(width=48, height=40, year_start=1990, year_end=2013, seed=11))
    )
    params = LTParams(max_segments=4, vertex_count_overshoot=2)
    kw = dict(params=params, tile_size=20)
    plain = RunConfig(workdir=str(tmp_path / "p"), out_dir=str(tmp_path / "po"), **kw)
    sharded = RunConfig(workdir=str(tmp_path / "m"), out_dir=str(tmp_path / "mo"), **kw)
    run_stack(stack, plain, device="cpu")
    # 400 px per tile over 3 devices: the fed tile is padded to 402
    s = run_stack(stack, sharded, device="cpu", mesh=["cpu"] * 3)
    assert s["mesh_devices"] == 3 and s["tiles_done"] == 6
    assert _tile_bytes(sharded.workdir) == _tile_bytes(plain.workdir)
    a = assemble_outputs(stack, plain, device="cpu")
    b = assemble_outputs(stack, sharded, device="cpu")
    for name in a:
        with open(a[name], "rb") as fa, open(b[name], "rb") as fb:
            assert fa.read() == fb.read(), name
    # a per-device slice over chunk_px is rejected before the workdir is touched
    bad = RunConfig(workdir=str(tmp_path / "bad"), chunk_px=100, **kw)
    with pytest.raises(ValueError, match="per-device pixel slice"):
        run_stack(stack, bad, device="cpu", mesh=["cpu"] * 2)
    assert not os.path.exists(bad.workdir)
