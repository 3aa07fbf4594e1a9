"""The port's scale benches against the JAX package's tools, on the CPU.

* ``stream_assembly_bench``: a mosaic fabricated by the JAX tool's code
  assembles under the port, and one fabricated by the port (512², tile
  128: 16 tiles) assembles under the JAX package, each byte-equal to the
  other package's assembly of the same workdir (the two fingerprints
  agree); a forced BigTIFF write reads back equal to the classic one; the
  ``scene`` mode re-assembles a CLI run byte-equal to the CLI's rasters.
* ``change_stream_bench``: at 256², mmu 9, the port's fabricated products
  are byte-equal to the JAX tool's and the port's change maps on them are
  byte-equal to the JAX package's ``write_change_maps``.
* ``multihost_bench``: two ``gloo`` processes at 128² x 8 years, tile 32,
  on the CPU: 8 + 8 tiles, rasters byte-equal to one process.
* ``multiindex_bench`` (the JAX package's configuration #4) at 64² on the
  CPU: its record has every key of the JAX record ``MULTIINDEX_r03.json``,
  its FTV check passes, and its products are the JAX driver's on the same
  stack.
* The committed scale records ran on the card and hold their exact claims;
  every committed card record names the digest of the package it ran.
"""

import json
import os
import shutil
import signal
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import land_trendr_tpu.runtime.driver as jax_driver
from land_trendr_tpu.ops.change import ChangeFilter as JChangeFilter
from land_trendr_tpu.ops.change import write_change_maps as jax_change_maps
from land_trendr_tpu.runtime.driver import RunConfig as JRunConfig
from land_trendr_tpu_torch.io.geotiff import GeoTiffStreamWriter, read_geotiff
from land_trendr_tpu_torch.ops.change import ChangeFilter, write_change_maps
from land_trendr_tpu_torch.tools import (
    change_stream_bench,
    multihost_bench,
    multiindex_bench,
    stream_assembly_bench,
)
from land_trendr_tpu_torch.tools.measure import digest_files
from tools import change_stream_bench as jax_csb
from tools import stream_assembly_bench as jax_sab

# the suite runs several workers a host: one intra-op thread each
torch.set_num_threads(1)


@pytest.fixture
def one_thread_children(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _jax_assemble_mosaic(work, out_dir, h, w, tile):
    stack = jax_sab._stub_stack(stream_assembly_bench.MOSAIC_YEARS, h, w,
                                stream_assembly_bench._mosaic_geo())
    return jax_driver.assemble_outputs(stack, JRunConfig(tile_size=tile, workdir=work,
                                                         out_dir=out_dir))


def test_jax_fabricated_mosaic_assembles_under_the_port(tmp_path, monkeypatch):
    """The JAX tool's mosaic mode at 512², its assembly step intercepted so
    the port assembles the same workdir before the tool removes it."""
    kept = {}
    real = jax_driver.assemble_outputs

    def both(stack, cfg):
        paths = real(stack, cfg)
        kept["jax"] = str(tmp_path / "jax_out")
        shutil.copytree(cfg.out_dir, kept["jax"])
        kept["port"] = str(tmp_path / "port_out")
        stream_assembly_bench.assemble_mosaic(cfg.workdir, kept["port"], 512, 512,
                                              cfg.tile_size, device="cpu")
        return paths

    monkeypatch.setattr(jax_driver, "assemble_outputs", both)
    monkeypatch.setattr(jax_sab, "REPO", str(tmp_path))
    monkeypatch.setattr(jax_sab, "OUT_JSON", str(tmp_path / "STREAMASM.json"))
    assert jax_sab.mosaic_mode(512) == 0
    port, jax = digest_files(kept["port"]), digest_files(kept["jax"])
    assert sorted(port) == ["model_valid.tif", "rmse.tif", "vertex_years.tif"] and port == jax


def test_port_fabricated_mosaic_assembles_under_jax(tmp_path):
    work = str(tmp_path / "work")
    stream_assembly_bench.fabricate_mosaic(work, 512, 512, 128)
    assert len([n for n in os.listdir(work) if n.endswith(".npz")]) == 16
    port = stream_assembly_bench.assemble_mosaic(work, str(tmp_path / "p"), 512, 512, 128,
                                                 device="cpu")
    _jax_assemble_mosaic(work, str(tmp_path / "j"), 512, 512, 128)
    assert digest_files(str(tmp_path / "p")) == digest_files(str(tmp_path / "j"))
    rmse, _, _ = read_geotiff(port["rmse"])
    assert rmse.shape == (512, 512) and 0.0 < float(rmse.mean()) < 0.1


def test_mosaic_record(tmp_path):
    out = tmp_path / "STREAMASM.json"
    assert stream_assembly_bench.main(["mosaic", "--size", "300", "--tile", "128",
                                       "--work-root", str(tmp_path), "--device", "cpu",
                                       "--out", str(out)]) == 0
    rec = json.loads(out.read_text())["mosaic_300x300"]
    assert rec["pixels"] == 90000 and rec["peak_rss_mb"] > 0 and not rec["rmse_bigtiff"]
    assert rec["device"] == "cpu" and rec["source_sha256"]
    assert not os.path.exists(tmp_path / ".streamasm_work")


def test_forced_bigtiff_reads_back_equal_to_classic(tmp_path):
    rng = np.random.default_rng(3)
    a = rng.normal(0.05, 0.01, (300, 280, 2)).astype(np.float32)
    paths = {}
    for big in (False, True):
        paths[big] = str(tmp_path / f"big{int(big)}.tif")
        wr = GeoTiffStreamWriter(paths[big], 300, 280, 2, np.float32, bigtiff=big)
        for y0 in range(0, 300, 100):
            wr.write(y0, 0, a[y0:y0 + 100])
        wr.close()
    classic, _, c_info = read_geotiff(paths[False])
    big, _, b_info = read_geotiff(paths[True])
    assert b_info.big and not c_info.big
    assert np.array_equal(classic, big) and np.array_equal(big, np.moveaxis(a, -1, 0))


def test_scene_mode_reassembles_a_cli_run(tmp_path, one_thread_children):
    from land_trendr_tpu_torch.cli import main as cli

    stack, work, out = str(tmp_path / "D"), str(tmp_path / "W"), str(tmp_path / "O")
    assert cli(["--device", "cpu", "synth", stack, "--size", "64"]) == 0
    assert cli(["--device", "cpu", "segment", stack, "--tile-size", "32", "--workdir", work,
                "--out-dir", out]) == 0
    rec_path = tmp_path / "STREAMASM.json"
    assert stream_assembly_bench.main(["scene", work, "--stack-dir", stack, "--tile-size", "32",
                                       "--device", "cpu", "--out", str(rec_path)]) == 0
    rec = json.loads(rec_path.read_text())["scene_64x64"]
    assert rec["out_sha256"] == digest_files(out) and rec["products"] == 11
    assert not os.path.exists(tmp_path / "out_stream")


def test_change_maps_byte_equal_to_jax(tmp_path, one_thread_children):
    rec_path = tmp_path / "CHANGESTREAM.json"
    assert change_stream_bench.main(["--size=256", "--mmu=9", "--work-root", str(tmp_path),
                                     "--device", "cpu", "--out", str(rec_path)]) == 0
    rec = json.loads(rec_path.read_text())
    body = rec["change_256x256_mmu9"]
    assert body["peak_rss_mb"] > 0 and body["changed_frac_first_rows"] > 0
    assert rec["device"] == "cpu" and rec["command"].endswith("--out " + str(rec_path))

    seg_p, seg_j = tmp_path / "seg_port", tmp_path / "seg_jax"
    seg_p.mkdir()
    seg_j.mkdir()
    change_stream_bench.fabricate(str(seg_p), 256, 256, band_rows=96)
    jax_csb.fabricate(str(seg_j), 256, 256, band_rows=96)
    assert digest_files(str(seg_p)) == digest_files(str(seg_j))
    port = write_change_maps(str(seg_p), str(tmp_path / "c_port"), index="nbr",
                             filt=ChangeFilter(min_mag=0.1), mmu=9, device="cpu")
    jax = jax_change_maps(str(seg_p), str(tmp_path / "c_jax"), index="nbr",
                          filt=JChangeFilter(min_mag=0.1), mmu=9)
    assert sorted(port) == sorted(jax) and len(port) == 7
    assert digest_files(str(tmp_path / "c_port")) == digest_files(str(tmp_path / "c_jax"))


def test_two_process_pod_equals_one_process(tmp_path, one_thread_children):
    out = tmp_path / "MULTIHOST.json"
    assert multihost_bench.main(["--size", "128", "--tile", "32", "--year-start", "2006",
                                 "--year-end", "2013", "--workroot", str(tmp_path / "mh"),
                                 "--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())["pod_128x128x8_tile32"]
    assert [p["tiles_done"] for p in rec["pod"]["per_process"]] == [8, 8]
    assert [p["mesh_devices"] for p in rec["pod"]["per_process"]] == [2, 2]
    assert sum(p["pixels"] for p in rec["pod"]["per_process"]) == 128 * 128
    assert rec["rasters_byte_equal"] and set(rec["raster_agreement_fraction"].values()) == {1.0}
    assert rec["scene"] == {"size": 128, "years": 8, "tile": 32}
    assert not os.path.exists(tmp_path / "mh")


def test_peak_rss_samples_vmrss_where_there_is_no_vmhwm(monkeypatch):
    """A gVisor kernel (the card machine's) keeps no ``VmHWM`` and carries
    ``ru_maxrss`` across fork and exec: the peak is then the sampled
    ``VmRSS``, which sees a transient allocation after it is freed."""
    from land_trendr_tpu_torch.tools import measure

    real = measure._status_kib
    monkeypatch.setattr(measure, "_status_kib",
                        lambda field: None if field == "VmHWM" else real(field))
    monkeypatch.setattr(measure, "_SAMPLED_PEAK_KIB", [])

    def samplers() -> int:
        return sum(t.name == "rss-sampler" for t in threading.enumerate())

    before = samplers()
    stop = measure.watch_rss(interval_s=0.002)
    assert samplers() == before + 1
    try:
        base = measure.rss_mib()
        block = np.ones(256 << 17)  # 256 MiB, every page touched
        time.sleep(0.2)
        del block
        assert measure.rss_mib() < base + 128
        assert measure.peak_rss_mib() >= base + 200
    finally:
        stop()  # no sampler outlives the test in its worker
    assert samplers() == before



def test_peak_rss_raises_without_vmhwm_or_vmrss(monkeypatch):
    """Where ``/proc`` gives no resident set the peak is refused, never
    taken from ``ru_maxrss`` (the parent's after fork and exec)."""
    from land_trendr_tpu_torch.tools import measure

    monkeypatch.setattr(measure, "_status_kib", lambda field: None)
    with pytest.raises(RuntimeError, match="neither VmHWM nor VmRSS"):
        measure.peak_rss_mib()

RECORDS = Path(__file__).resolve().parent.parent / "land_trendr_tpu_torch" / "tools" / "records"
#: the scale records and the tool that made each
SCALE_RECORDS = {
    "SCENE_h100.json": "run_segment_measured",
    "GIGA_h100.json": "giga_run",
    "CHANGESTREAM_h100.json": "change_stream_bench",
    "MULTIHOST_h100.json": "multihost_bench",
    "ARCH_SPEEDUP_h100.json": "arch_speedup",
    "STREAMASM_h100.json": "stream_assembly_bench",
    "MULTIINDEX_h100.json": "multiindex_bench",
}


@pytest.mark.parametrize("name", sorted(SCALE_RECORDS))
def test_committed_scale_records_are_the_cards(name):
    """Each entry of each scale record ran on the card, names its command
    and the digest of the package it ran, and holds its exact claims."""
    rec = json.loads((RECORDS / name).read_text())
    entries = [rec] if "command" in rec else list(rec.values())
    assert entries
    for e in entries:
        assert e["device"] == "cuda" and "H100" in e["nvidia_smi"] and " W" in e["nvidia_smi"]
        assert e["command"].startswith(f"python -m land_trendr_tpu_torch.tools.{SCALE_RECORDS[name]} ")
        assert len(e["source_sha256"]) == 64
        if name == "GIGA_h100.json":
            assert e["segment_killed"]["rc"] == -signal.SIGKILL
            skipped = e["segment_resumed"]["tiles_skipped_resume"]
            assert e["segment_killed"]["kill_tiles"] <= skipped < e["tiles"]
            assert e["rasters_equal_unkilled"]
        if name == "MULTIHOST_h100.json":
            assert e["rasters_byte_equal"]
            assert sum(p["pixels"] for p in e["pod"]["per_process"]) == e["scene"]["size"] ** 2
        if name == "MULTIINDEX_h100.json":
            assert e["ftv_validation"]["pass"] and e["scene"] == {
                "width": 1024, "height": 1024, "years": 40}
            assert {"ftv_ndvi", "ftv_tcw", "rmse"} <= set(e["outputs"])


@pytest.mark.parametrize("name", sorted(p.name for p in RECORDS.glob("*_h100.json")))
def test_every_card_record_names_its_source_digest(name):
    """Presence only: each entry of each committed card record carries the
    sha256 of the package sources it ran (``tools/measure.py:source_digest``)."""
    rec = json.loads((RECORDS / name).read_text())
    entries = [rec] if "command" in rec else list(rec.values())
    assert entries
    for e in entries:
        assert len(e["source_sha256"]) == 64 and int(e["source_sha256"], 16) >= 0


def test_multiindex_bench_on_cpu_holds_against_jax(tmp_path, one_thread_children, monkeypatch):
    """64² x 40 at tile 32 (4 tiles): the record carries every key of the
    JAX record (and of its summary), the FTV check passes, and the products
    are those the JAX driver writes for NBR + FTV ndvi,tcw on the same
    stack; ``main`` adds the run's meta and leaves no work directory."""
    from land_trendr_tpu.ops.indices import required_bands as jax_required_bands
    from land_trendr_tpu.runtime.stack import load_stack_dir as jax_load_stack_dir

    work = tmp_path / "w"
    work.mkdir()
    rec = multiindex_bench.measure(64, 32, str(work), "cpu")
    jrec = json.loads((Path(__file__).resolve().parent.parent / "MULTIINDEX_r03.json")
                      .read_text())
    assert set(jrec) <= set(rec)
    assert set(jrec["summary"]) <= set(rec["summary"])
    assert rec["ftv_validation"]["pass"] is True
    assert rec["ftv_validation"]["n_samples"] == multiindex_bench.SAMPLES == 64
    assert rec["scene"] == {"width": 64, "height": 64, "years": 40} and rec["tile_size"] == 32
    assert rec["summary"]["tiles"] == 4 and rec["summary"]["pixels"] == 64 * 64
    stack = jax_load_stack_dir(str(work / "stack"),
                               bands=jax_required_bands("nbr", multiindex_bench.FTV))
    cfg = JRunConfig(tile_size=32, workdir=str(tmp_path / "jw"), out_dir=str(tmp_path / "jo"),
                     ftv_indices=multiindex_bench.FTV)
    jax_driver.run_stack(stack, cfg)
    assert rec["outputs"] == sorted(jax_driver.assemble_outputs(stack, cfg))

    # main: the measured record (not run again) plus the command's meta
    seen = []
    monkeypatch.setattr(multiindex_bench, "measure",
                        lambda *a: seen.append(a) or dict(rec))
    out = tmp_path / "mi.json"
    argv = ["--device", "cpu", "--size", "64", "--tile-size", "32",
            "--work-root", str(tmp_path / "root"), "--out", str(out)]
    assert multiindex_bench.main(argv) == 0
    made = json.loads(out.read_text())
    assert set(jrec) <= set(made) and "work_dir" not in made
    assert made["command"] == "python -m land_trendr_tpu_torch.tools.multiindex_bench " + " ".join(argv)
    assert made["device"] == "cpu" and made["nvidia_smi"] is None
    assert len(made["source_sha256"]) == 64
    assert [a[:2] + a[3:] for a in seen] == [(64, 32, "cpu")]
    assert os.listdir(tmp_path / "root") == []
