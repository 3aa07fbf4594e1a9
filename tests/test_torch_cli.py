"""The port's CLI: ``synth`` then ``segment --device cpu`` on a 64x64 stack,
``params``, resume, FTV and change maps (``segment --ftv --change``, the
``change`` command), and the rejections (absent flags, no card)."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from land_trendr_tpu_torch.cli import build_parser

# the suite runs several workers per host: one intra-op thread each keeps
# torch's thread pools from oversubscribing the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _cli(*argv, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "land_trendr_tpu_torch", *argv],
        cwd=str(cwd), env=env, capture_output=True, text=True, timeout=300,
    )


def test_synth_segment_resume(tmp_path):
    r = _cli("--device", "cpu", "synth", "D", "--size", "64", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["files"] == 40
    r = _cli("--device", "cpu", "segment", "D", "--tile-size", "48", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout)
    assert out["summary"]["tiles_done"] == 4 and out["summary"]["impl"] == "torch"
    assert len(out["outputs"]) == 11
    assert all(os.path.exists(tmp_path / p) for p in out["outputs"].values())
    r = _cli("--device", "cpu", "segment", "D", "--tile-size", "48", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    again = json.loads(r.stdout)["summary"]
    assert again["tiles_skipped_resume"] == 4 and again["tiles_done"] == 0


def test_params_json(tmp_path):
    r = _cli("params", "--max-segments", "4", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout)["max_segments"] == 4


def test_absent_flags_are_rejected(tmp_path):
    r = _cli("--device", "cpu", "segment", "D", "--telemetry", cwd=tmp_path)
    assert r.returncode == 2 and "unrecognized arguments" in r.stderr


def test_impl_is_not_a_flag(capsys):
    # the device decides the implementation; there is no separate switch
    with pytest.raises(SystemExit) as e:
        build_parser().parse_args(["segment", "S", "--impl", "torch"])
    assert e.value.code == 2 and "unrecognized arguments" in capsys.readouterr().err


def test_cuda_without_card_fails_clearly(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _cli("segment", "D", cwd=tmp_path)
    assert r.returncode == 2
    assert "is_available() is False" in r.stderr


@pytest.mark.parametrize(
    "argv,key,value",
    [
        (["segment", "S"], "device", "cuda"),
        (["--device", "cpu", "segment", "S"], "device", "cpu"),
        (["segment", "S"], "tile_size", 512),
        (["segment", "S", "--chunk-px", "none"], "chunk_px", None),
        (["segment", "S", "--chunk-px", "65536"], "chunk_px", 65536),
        (["segment", "S", "--fetch-depth", "3"], "fetch_depth", 3),
        (["segment", "S", "--reject-bits", "0x18"], "reject_bits", 0x18),
        (["segment", "S"], "ftv", ""),
        (["segment", "S"], "fetch_f16", False),
        (["segment", "S"], "change", False),
        (["segment", "S"], "change_mmu", 1),
        (["segment", "S", "--change-max-dur", "4"], "change_max_dur", 4.0),
        (["change", "O"], "dest", "lt_change"),
        (["change", "O"], "mmu", 1),
        (["change", "O"], "max_dur", float("inf")),
        (["change", "O", "--kind", "recovery"], "kind", "recovery"),
    ],
)

def test_parser_defaults(argv, key, value):
    assert getattr(build_parser().parse_args(argv), key) == value


def test_conflicting_packed_flags(tmp_path):
    r = _cli("--device", "cpu", "segment", "D", "--packed-fetch", "--no-packed-fetch",
             cwd=tmp_path)
    assert r.returncode == 2 and "conflicts" in r.stderr


def test_segment_ftv_change_then_change_command(tmp_path):
    from land_trendr_tpu_torch.io.geotiff import read_geotiff

    r = _cli("--device", "cpu", "synth", "D", "--size", "64", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    r = _cli("--device", "cpu", "segment", "D", "--tile-size", "48", "--ftv", "ndvi",
             "--change", "--change-max-dur", "4", "--change-mmu", "4", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout)
    assert out["summary"]["tiles_done"] == 4
    names = set(out["outputs"])
    assert "ftv_ndvi" in names and len(names) == 11 + 1 + 7
    r = _cli("--device", "cpu", "change", "lt_out", "--max-dur", "4", "--mmu", "4",
             "--dest", "C", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    maps = json.loads(r.stdout)["outputs"]
    assert sorted(maps) == sorted(("mask", "yod", "mag", "dur", "rate", "preval", "dsnr"))
    # the fused selection on the device and the change command over the
    # written rasters pick the same segments
    for k in ("mask", "yod", "mag", "dur"):
        fused = read_geotiff(str(tmp_path / "lt_out" / f"change_{k}.tif"))[0]
        post = read_geotiff(str(tmp_path / maps[k]))[0]
        np.testing.assert_array_equal(fused, post, err_msg=k)


def test_change_flags_need_change(tmp_path):
    r = _cli("--device", "cpu", "segment", "D", "--change-min-mag", "0.1", cwd=tmp_path)
    assert r.returncode == 2 and "require --change" in r.stderr
    r = _cli("--device", "cpu", "segment", "D", "--ftv", "evi", cwd=tmp_path)
    assert r.returncode == 2


def test_change_without_card_fails_clearly(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _cli("change", "O", cwd=tmp_path)
    assert r.returncode == 2 and "is_available() is False" in r.stderr
