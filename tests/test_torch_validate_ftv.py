"""The port's ``tools/validate_ftv.py`` over a small FTV run on the CPU.

A 48² x 24-year synthetic stack is segmented with NDVI and TCW FTV through
``run_stack`` + ``assemble_outputs`` on the CPU; the tool re-derives 32
sampled pixels' FTV series from the DNs and the float64 oracle and must
agree within its tolerance (the JAX tool's 1e-3).  An FTV raster shifted
by 0.01 must fail, so the check is not vacuous.
"""

import json
import os

import numpy as np
import pytest
import torch

from land_trendr_tpu_torch.io.geotiff import read_geotiff, write_geotiff
from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack
from land_trendr_tpu_torch.runtime import RunConfig, assemble_outputs, run_stack
from land_trendr_tpu_torch.runtime.stack import stack_from_synthetic
from land_trendr_tpu_torch.tools import validate_ftv

torch.set_num_threads(1)

FTV = ("ndvi", "tcw")


@pytest.fixture(scope="module")
def ftv_run(tmp_path_factory):
    root = tmp_path_factory.mktemp("ftv")
    synth = make_stack(SceneSpec(width=48, height=48, year_start=1990, year_end=2013, seed=5))
    stack_dir = str(root / "stack")
    write_stack(stack_dir, synth)
    stack = stack_from_synthetic(synth)
    cfg = RunConfig(tile_size=24, workdir=str(root / "work"), out_dir=str(root / "out"),
                    ftv_indices=FTV)
    run_stack(stack, cfg, device="cpu")
    assemble_outputs(stack, cfg)
    return stack, stack_dir, cfg.out_dir


def test_validate_passes_within_tolerance(ftv_run):
    stack, _, out_dir = ftv_run
    rep = validate_ftv.validate(stack, out_dir, FTV, n_samples=32)
    assert rep["pass"] is True
    for name in FTV:
        r = rep["indices"][name]
        assert r["tolerance"] == validate_ftv.TOLERANCE == 1e-3
        assert r["max_abs_delta"] <= 1e-3 and r["pass"] is True


def test_cli_on_cpu(ftv_run, tmp_path):
    _, stack_dir, out_dir = ftv_run
    out = tmp_path / "ftv.json"
    assert validate_ftv.main([stack_dir, out_dir, "--samples", "16", "--out", str(out),
                              "--device", "cpu"]) == 0
    rep = json.loads(out.read_text())
    assert rep["pass"] is True and set(rep["indices"]) == set(FTV)
    assert rep["n_samples"] == 16 and rep["device"] == "cpu"


def test_shifted_ftv_fails(ftv_run, tmp_path):
    stack, _, out_dir = ftv_run
    bad = tmp_path / "out"
    bad.mkdir()
    for name in ("vertex_indices.tif", "n_vertices.tif", "ftv_tcw.tif"):
        os.symlink(os.path.join(out_dir, name), bad / name)
    arr, geo, _ = read_geotiff(os.path.join(out_dir, "ftv_ndvi.tif"))
    write_geotiff(str(bad / "ftv_ndvi.tif"), (arr + np.float32(0.01)).astype(arr.dtype), geo)
    rep = validate_ftv.validate(stack, str(bad), FTV, n_samples=8)
    assert rep["indices"]["tcw"]["pass"] is True
    assert rep["indices"]["ndvi"]["pass"] is False and rep["pass"] is False
    assert rep["indices"]["ndvi"]["max_abs_delta"] == pytest.approx(0.01, abs=1e-4)
