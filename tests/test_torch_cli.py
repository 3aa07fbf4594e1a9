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
    # the JAX package's platform switch: this package has --device instead
    r = _cli("params", "--platform", "cpu", cwd=tmp_path)
    assert r.returncode == 2 and "unrecognized arguments: --platform" in r.stderr


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


# ---------------------------------------------------------------------------
# pixel and info, against the JAX package's CLI
# ---------------------------------------------------------------------------

#: the integer and boolean fields of a pixel result: equal exactly
_DECISIONS = ("n_vertices", "vertex_indices", "vertex_years", "model_valid")


def _jax_cli_json(argv, capsys):
    """The JAX package's command handler in-process (no subprocess: the
    suite runs JAX in float64, the pixel path's exact-parity mode)."""
    from land_trendr_tpu import cli as jcli

    args = jcli.build_parser().parse_args(argv)
    handler = {"pixel": jcli._run_pixel, "info": jcli._run_info}[args.cmd]
    assert handler(args) == 0
    return json.loads(capsys.readouterr().out)


def _port_cli_json(argv, capsys):
    from land_trendr_tpu_torch.cli import main

    assert main(argv) == 0
    return json.loads(capsys.readouterr().out)


def _assert_pixel_equal(ours: dict, theirs: dict) -> None:
    for name in _DECISIONS:
        assert ours[name] == theirs[name], name
    for name, v in ours.items():
        if name in _DECISIONS or name in ("dtype", "device"):
            continue
        a = np.asarray(v, dtype=np.float64)
        b = np.asarray(theirs[name], dtype=np.float64)
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10, equal_nan=True, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("index", [None, "nbr"])
def test_pixel_json_matches_jax_cli(tmp_path, capsys, seed, index):
    rng = np.random.default_rng(seed)
    years = list(range(1990, 2020))
    t = np.arange(30.0)
    values = 0.6 - 0.35 * (t >= 8 + seed) * np.exp(-0.15 * np.maximum(t - 8 - seed, 0))
    values = values + rng.normal(0, 0.015, 30)
    mask = (rng.uniform(size=30) > 0.1).tolist()
    path = tmp_path / "series.json"
    path.write_text(json.dumps({"years": years, "values": values.tolist(), "mask": mask}))
    extra = ["--index", index] if index else []
    ours = _port_cli_json(["--device", "cpu", "pixel", str(path), *extra], capsys)
    theirs = _jax_cli_json(["pixel", str(path), *extra], capsys)
    assert ours["params"] == theirs["params"]
    assert ours["oracle"] == theirs["oracle"]
    assert ours["torch"]["dtype"] == theirs["jax"]["dtype"] == "float64"
    _assert_pixel_equal(ours["torch"], theirs["jax"])
    assert ours["parity"]["vertex_indices_equal"] == theirs["parity"]["vertex_indices_equal"]
    assert ours["torch"]["device"] == "cpu"


@pytest.fixture(scope="module")
def stack_dir(tmp_path_factory):
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack, write_stack

    d = tmp_path_factory.mktemp("pix") / "D"
    write_stack(str(d), make_stack(SceneSpec(width=32, height=24, year_start=1990,
                                             year_end=2015, seed=3)))
    return str(d)


@pytest.mark.parametrize("x,y", [(10, 20), (0, 0), (31, 5), (17, 11)])
def test_pixel_from_stack_matches_jax_cli(stack_dir, capsys, x, y):
    argv = ["pixel", "--from-stack", stack_dir, "--x", str(x), "--y", str(y)]
    ours = _port_cli_json(["--device", "cpu", *argv], capsys)
    theirs = _jax_cli_json(argv, capsys)
    assert ours["oracle"] == theirs["oracle"]
    _assert_pixel_equal(ours["torch"], theirs["jax"])
    ours_o = _port_cli_json(["pixel", "--engine", "oracle", *argv[1:]], capsys)
    assert "torch" not in ours_o and ours_o["oracle"] == theirs["oracle"]


def test_pixel_needs_card_for_torch_engine(tmp_path, stack_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _cli("pixel", "--from-stack", stack_dir, "--x", "1", "--y", "1", cwd=tmp_path)
    assert r.returncode == 2 and "is_available() is False" in r.stderr


@pytest.fixture(scope="module")
def seg_out(stack_dir, tmp_path_factory):
    import contextlib
    import io

    from land_trendr_tpu_torch.cli import main

    root = tmp_path_factory.mktemp("seg")
    argv = ["--device", "cpu", "segment", stack_dir, "--tile-size", "16",
            "--out-overviews", "2", "--telemetry", "--flight", "--trace", str(root / "T"),
            "--workdir", str(root / "w"), "--out-dir", str(root / "o")]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return root, json.loads(buf.getvalue())


def test_segment_overviews_telemetry_trace(seg_out):
    root, out = seg_out
    summary = out["summary"]
    assert summary["tiles_done"] == 4 and summary["retries"] == 0
    assert summary["tiles_quarantined"] == []
    for k in ("events", "metrics", "flight"):
        assert os.path.exists(summary["telemetry"][k]), k
    traces = os.listdir(root / "T")
    assert len(traces) == 1 and traces[0].endswith(".json")


@pytest.mark.parametrize("product", ["rmse", "vertex_years", "model_valid"])
def test_info_matches_jax_cli(seg_out, capsys, product):
    _, out = seg_out
    path = out["outputs"][product]
    argv = ["info", path, "--window", "2,3,9,7"]
    ours = _port_cli_json(argv, capsys)[path]
    theirs = _jax_cli_json(argv, capsys)[path]
    assert ours.pop("overview_pages") == 2
    assert ours == theirs


@pytest.mark.parametrize(
    "extra,code,msg",
    [
        (["--fault-schedule", "nope@1"], 2, "unknown fault seam"),
        (["--max-retries", "0", "--fault-schedule", "dispatch@0*99"], 3, "failed after 1"),
        (["--max-retries", "0", "--quarantine-tiles", "--fault-schedule", "dispatch@1"],
         3, "quarantined"),
        (["--stall-timeout-s", "0.5", "--fault-schedule", "compute.wait@1=hang:30"], 4,
         "stalled"),
        (["--lazy", "--composite", "medoid"], 2, "--lazy cannot composite"),
        (["--out-overviews", "-1"], 2, "out_overviews"),
    ],
    ids=["bad-schedule", "exhausted", "quarantine", "stall", "lazy-composite", "overviews"],
)
def test_segment_exit_codes(stack_dir, tmp_path, capsys, extra, code, msg):
    from land_trendr_tpu_torch.cli import main

    argv = ["--device", "cpu", "segment", stack_dir, "--tile-size", "16",
            "--retry-backoff-s", "0", "--workdir", str(tmp_path / "w"),
            "--out-dir", str(tmp_path / "o"), *extra]
    assert main(argv) == code
    out = capsys.readouterr()
    assert msg in out.err
    if code == 3 and "quarantined" in msg:
        assert json.loads(out.out)["outputs"] is None


@pytest.mark.parametrize(
    "argv,key,value",
    [
        (["segment", "S"], "max_retries", 2),
        (["segment", "S"], "retry_backoff_s", 0.5),
        (["segment", "S"], "quarantine_tiles", False),
        (["segment", "S"], "stall_timeout_s", None),
        (["segment", "S"], "straggler_k", 4.0),
        (["segment", "S"], "straggler_min_tiles", 5),
        (["segment", "S"], "fault_schedule", None),
        (["segment", "S"], "feed_cache_mb", 256),
        (["segment", "S"], "decode_workers", 0),
        (["segment", "S"], "no_feed_readahead", False),
        (["segment", "S"], "ingest_store_mb", 0),
        (["segment", "S"], "ingest_store_dir", None),
        (["segment", "S"], "lazy", False),
        (["segment", "S"], "composite", None),
        (["segment", "S"], "out_overviews", 0),
        (["segment", "S"], "trace", None),
        (["segment", "S"], "telemetry", False),
        (["segment", "S"], "metrics_port", None),
        (["segment", "S"], "metrics_host", ""),
        (["segment", "S"], "metrics_interval_s", 5.0),
        (["segment", "S"], "flight", False),
        (["segment", "S"], "flight_ring_events", 2048),
        (["segment", "S"], "sampler_interval_s", 5.0),
        (["pixel", "P"], "engine", "both"),
        (["pixel", "P"], "scale", 2.75e-5),
        (["info", "a.tif", "b.tif"], "paths", ["a.tif", "b.tif"]),
        (["segment", "S"], "lease_batch", 0),
        (["segment", "S"], "lease_ttl_s", 30.0),
        (["segment", "S"], "speculate", False),
        (["segment", "S"], "merge_timeout_s", None),
        (["segment", "S"], "mesh", False),
        (["segment", "S"], "tune_store_dir", None),
        (["segment", "S", "--tile-size", "auto"], "tile_size", "auto"),
        (["segment", "S", "--chunk-px", "auto"], "chunk_px", "auto"),
        (["segment", "S", "--fetch-depth", "auto"], "fetch_depth", "auto"),
        (["segment", "S", "--upload-depth", "auto"], "upload_depth", "auto"),
        (["segment", "S", "--feed-workers", "auto"], "feed_workers", "auto"),
        (["segment", "S", "--decode-workers", "auto"], "decode_workers", "auto"),
        (["segment", "S", "--feed-cache-mb", "auto"], "feed_cache_mb", "auto"),
        (["segment", "S", "--out-overviews", "auto"], "out_overviews", "auto"),
        (["tune"], "store_dir", "lt_tune_store"),
        (["tune"], "shape", "512,512,40"),
        (["tune"], "groups", None),
        (["tune"], "reps", 3),
        (["tune"], "smoke", False),
        (["tune"], "retune", False),
        (["tune"], "dry_run", False),
        (["tune"], "workdir", None),
    ],
)
def test_new_flag_defaults_match_jax(argv, key, value):
    from land_trendr_tpu import cli as jcli

    assert getattr(build_parser().parse_args(argv), key) == value
    assert getattr(jcli.build_parser().parse_args(argv), key) == value


def test_lease_and_auto_flags_build_the_jax_config():
    """The same flags parse to the same RunConfig values in both packages,
    and the two configs fingerprint alike (leases and the tuning store are
    execution facts; the resolved knobs are what is fingerprinted)."""
    from types import SimpleNamespace

    from land_trendr_tpu import cli as jcli
    from land_trendr_tpu.runtime.driver import RunConfig as JRunConfig
    from land_trendr_tpu_torch.runtime.driver import RunConfig

    argv = ["segment", "S", "--lease-batch", "3", "--lease-ttl-s", "12", "--speculate",
            "--merge-timeout-s", "40", "--tile-size", "auto", "--chunk-px", "auto",
            "--fetch-depth", "auto", "--tune-store-dir", "T", "--out-overviews", "auto"]
    names = ("lease_batch", "lease_ttl_s", "speculate", "merge_timeout_s", "tile_size",
             "chunk_px", "fetch_depth", "tune_store_dir", "out_overviews")
    ours = build_parser().parse_args(argv)
    theirs = jcli.build_parser().parse_args(argv)
    fields = {n: getattr(ours, n) for n in names}
    assert fields == {n: getattr(theirs, n) for n in names}
    port_cfg, jax_cfg = RunConfig(**fields), JRunConfig(**fields)
    assert all(getattr(port_cfg, n) == getattr(jax_cfg, n) for n in names)
    stack = SimpleNamespace(years=np.arange(1990, 2014), shape=(40, 48))
    explicit = dict(fields, tile_size=64, chunk_px=4096, fetch_depth=3)
    assert RunConfig(**explicit).fingerprint(stack) == JRunConfig(**explicit).fingerprint(stack)


def test_mesh_without_a_card_fails_clearly(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = _cli("--device", "cpu", "synth", "D", "--size", "32", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    r = _cli("--device", "cpu", "segment", "D", "--mesh", cwd=tmp_path)
    assert r.returncode == 2 and "no CUDA device" in r.stderr


def test_two_lease_processes_share_one_workdir(tmp_path):
    """Two ``segment --lease-batch 1`` processes over one workdir and no
    process group: together they win every tile once, and each assembles
    rasters byte-equal to a one-process run's."""
    r = _cli("--device", "cpu", "synth", "D", "--size", "64", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "land_trendr_tpu_torch", "--device", "cpu", "segment", "D",
             "--tile-size", "32", "--workdir", "W", "--out-dir", f"O{i}",
             "--lease-batch", "1", "--lease-ttl-s", "120"],
            cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out)["summary"])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert sum(o["lease"]["acquired"] for o in outs) == 4
    r = _cli("--device", "cpu", "segment", "D", "--tile-size", "32", "--workdir", "W1",
             "--out-dir", "O1p", cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    ref = sorted(os.listdir(tmp_path / "O1p"))
    for i in range(2):
        assert sorted(os.listdir(tmp_path / f"O{i}")) == ref
        for name in ref:
            assert (tmp_path / f"O{i}" / name).read_bytes() == (tmp_path / "O1p" / name).read_bytes()
