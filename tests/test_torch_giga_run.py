"""The port's ``giga_run`` against the JAX package's tool, on the CPU.

* ``gen``: the port's scene at 256² is byte-equal, file for file, to the
  JAX tool's ``cmd_gen`` at 256².
* ``all`` at 256² with the module's ``TILE`` patched to 64 (16 tiles) and
  ``--device cpu``: the ``segment`` child is SIGKILLed once 2 tiles are
  durable (rc -9), the resume skips 2..15 tiles, and the rasters are
  byte-equal to an unkilled run of the same scene.
* The port's decisions on that scene agree with the JAX package's
  ``run_stack`` (``impl="xla"``, the JAX tool's configuration) on >= 99.9%
  of pixels (vertex count, vertex years, validity).  On the agreeing
  pixels ``rmse`` is held to the float32 contract of
  ``tests/test_torch_tile.py`` (99.9% of values within 1e-5, all within
  5e-5).  ``seg_magnitude`` of the port and of the JAX package agree
  within 5e-5 on every agreeing pixel, and on every 16th of them each is
  held to the JAX package's float64 oracle on the same DNs: the port's
  within 1e-5, the JAX package's within 5e-5 (it fits over uncentred
  years in float32, which on this 12-year step scene carries ~4e-5 in a
  segment's magnitude; the port's centred frame carries ~2e-7).
"""

import json
import os
import signal
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from land_trendr_tpu.io.geotiff import read_geotiff as jax_read_geotiff
from land_trendr_tpu.models import oracle as jax_oracle
from land_trendr_tpu.runtime.driver import assemble_outputs as jax_assemble
from land_trendr_tpu.runtime.driver import run_stack as jax_run_stack
from land_trendr_tpu.runtime.stack import open_stack_dir_c2_lazy as jax_open_lazy
from land_trendr_tpu_torch.io.geotiff import read_geotiff
from land_trendr_tpu_torch.ops import indices as idx
from land_trendr_tpu_torch.runtime.stack import open_stack_dir_c2_lazy
from land_trendr_tpu_torch.tools import giga_run
from land_trendr_tpu_torch.tools.measure import digest_files
from tools import giga_run as jax_giga

# the suite runs several workers a host: one intra-op thread each
torch.set_num_threads(1)

SIZE = 256
# every 16th agreeing pixel goes through the per-pixel float64 oracle
ORACLE_STRIDE = 16


@pytest.fixture(scope="module")
def composed(tmp_path_factory):
    """The port's composed run at 256², tile 64, on the CPU: its record."""
    root = tmp_path_factory.mktemp("giga_port")
    out = root / "GIGA.json"
    mp = pytest.MonkeyPatch()
    mp.setattr(giga_run, "TILE", 64)
    # the suite runs several workers a host: one thread per child process
    mp.setenv("OMP_NUM_THREADS", "1")
    try:
        rc = giga_run.main(["all", "--size", str(SIZE), "--out-root", str(root / "run"),
                            "--kill-tiles", "2", "--device", "cpu", "--out", str(out)])
    finally:
        mp.undo()
    assert rc == 0
    return root / "run", json.loads(out.read_text())[f"giga_{SIZE}x{SIZE}"]


def test_gen_byte_equal_to_jax_tool(tmp_path, composed):
    jax_giga.cmd_gen(types.SimpleNamespace(size=SIZE, out_root=str(tmp_path)))
    mine, theirs = digest_files(str(composed[0] / "scene")), digest_files(str(tmp_path / "scene"))
    assert len(mine) == 36 and mine == theirs


def test_killed_resumed_equals_unkilled(composed):
    root, rec = composed
    assert rec["tiles"] == 16 and rec["tile"] == 64
    killed = rec["segment_killed"]
    assert killed["rc"] == -signal.SIGKILL and killed["durable_seen"] >= 2
    resumed = rec["segment_resumed"]
    assert 2 <= resumed["tiles_skipped_resume"] <= 15
    assert resumed["tiles_skipped_resume"] + resumed["tiles_done"] == 16
    assert rec["rasters_equal_unkilled"] and rec["rasters"] == 12
    assert digest_files(str(root / "out")) == digest_files(str(root / "out_ref"))
    for phase in ("gen", "segment_resumed", "assemble", "sieve"):
        assert rec[phase]["peak_rss_mib"] > 0 and rec[phase]["wall_s_total"] > 0
    assert rec["device"] == "cpu" and rec["source_sha256"] and rec["command"].startswith(
        "python -m land_trendr_tpu_torch.tools.giga_run all")


def test_decisions_match_jax_run_stack(tmp_path, composed):
    root, _ = composed
    stack = jax_open_lazy(str(root / "scene"), bands=("nir", "swir2"))
    cfg = jax_giga._cfg(tmp_path, SIZE)
    jax_run_stack(stack, cfg)
    paths = jax_assemble(stack, cfg)

    def port(name):  # (bands, H, W)
        return read_geotiff(str(root / "out" / f"{name}.tif"))[0].reshape(-1, SIZE, SIZE)

    def jax(name):
        return np.asarray(jax_read_geotiff(paths[name])[0]).reshape(-1, SIZE, SIZE)

    agree = (port("model_valid") == jax("model_valid"))[0]
    agree &= (port("n_vertices") == jax("n_vertices"))[0]
    agree &= (port("vertex_years") == jax("vertex_years")).all(axis=0)
    assert agree.mean() >= 0.999, agree.mean()
    a, b = port("rmse")[:, agree].astype(np.float64), jax("rmse")[:, agree].astype(np.float64)
    assert np.array_equal(np.isnan(a), np.isnan(b))
    d = np.abs(a - b)[~np.isnan(a)]
    assert np.quantile(d, 0.999) <= 1e-5 and d.max() <= 5e-5, d.max()

    # seg_magnitude: the port against the JAX package directly on every
    # agreeing pixel, and both against the JAX package's float64 oracle on
    # the same DNs over a sample of them (the raster holds the natural
    # orientation: NBR's disturbance sign flipped).  Read on this scene:
    # port-JAX 4.07e-5, port-oracle 2.5e-7, JAX-oracle 3.9e-5.
    mine, theirs = port("seg_magnitude")[:, agree], jax("seg_magnitude")[:, agree]
    fin = ~np.isnan(mine)
    assert np.array_equal(fin, ~np.isnan(theirs))
    assert np.abs(theirs - mine)[fin].max() <= 5e-5

    pstack = open_stack_dir_c2_lazy(str(root / "scene"), bands=("nir", "swir2"))
    ny = pstack.n_years

    def series(cube):
        return torch.from_numpy(np.asarray(cube[:, :, :]).reshape(ny, -1).T.astype(np.int64))

    sr = {b: idx.scale_sr(series(pstack.dn_bands[b]).double(), 2.75e-5, -0.2)
          for b in ("nir", "swir2")}
    mask = (idx.qa_valid_mask(series(pstack.qa), idx.DEFAULT_QA_REJECT)
            & idx.sr_valid_mask(sr)).numpy()
    values = idx.compute_index("nbr", sr).double().numpy()
    years, params = pstack.years.astype(np.float64), jax_giga._params()
    pixels = np.flatnonzero(agree.reshape(-1))[::ORACLE_STRIDE]
    ref = np.stack([-jax_oracle.segment_series(years, values[i], mask[i], params).seg_magnitude
                    for i in pixels], axis=1)
    at = np.searchsorted(np.flatnonzero(agree.reshape(-1)), pixels)
    mine, theirs = mine[:, at], theirs[:, at]
    fin = ~np.isnan(ref)
    assert np.array_equal(fin, ~np.isnan(mine)) and np.array_equal(fin, ~np.isnan(theirs))
    assert np.abs(mine - ref)[fin].max() <= 1e-5
    assert np.abs(theirs - ref)[fin].max() <= 5e-5
    assert os.path.isfile(paths["change_mask"]) and Path(root / "out" / "change_mask.tif").is_file()
