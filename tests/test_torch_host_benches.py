"""The port's host-path benches at smoke size on the CPU: ``feed_bench``,
``fetch_bench``, ``upload_bench`` and ``host_path_bench``.

Each runs end to end with ``--device cpu`` and its structural results hold:
cached reads byte-identical and served from the cache, the feed events
schema-valid and folding to the same cache counters (the JAX package's
linter and report fold), packed fetch and upload one transfer a tile and
byte-identical to the per-product / per-array paths, the ingest store's
warm and restart passes decoding nothing, and every host stage reporting
its single-core rate.  No test holds a wall-clock band: the perf gate
bands the card's numbers.
"""

import json

import torch

from land_trendr_tpu_torch.tools import feed_bench, fetch_bench, host_path_bench, upload_bench

torch.set_num_threads(1)


def test_feed_bench_smoke(tmp_path):
    out = tmp_path / "feed.json"
    ev_dir = tmp_path / "ev"
    assert feed_bench.main(["--smoke", "--size", "256", "--years", "2", "--window", "96",
                            "--out", str(out), "--events-dir", str(ev_dir),
                            "--device", "cpu"]) == 0
    rec = json.loads(out.read_text())
    assert rec["parity_ok"] is True and rec["scene"]["windows"] > 0
    for section in ("baseline_serial_uncached", "parallel_uncached", "cached_parallel",
                    "cached_parallel_readahead"):
        assert rec[section]["wall_s"] > 0
    assert rec["cache_stats"]["hits"] > 0  # straddled windows revisit blocks
    assert rec["device"] == "cpu" and rec["nvidia_smi"] is None and rec["smoke"] is True

    from tools import check_events_schema, obs_report

    assert check_events_schema.main([str(ev_dir)]) == 0
    report, _ = obs_report.fold([str(ev_dir / "events.jsonl")], schema_errors={})
    assert report["feed_cache"]["hits"] == rec["cache_stats"]["hits"]


def test_fetch_bench_smoke(tmp_path):
    out = tmp_path / "fetch.json"
    assert fetch_bench.main(["--smoke", "--out", str(out), "--device", "cpu"]) == 0
    rep = json.loads(out.read_text())
    assert rep["parity"]["ok"] is True
    w = rep["workload"]
    assert w["transfers_per_tile_packed"] == 1
    assert w["artifact_products"] >= 8
    assert w["transfers_per_tile_per_product"] == w["device_copies_per_tile_packed"]
    assert rep["link_model"]["latency_ms"] == 1.0  # the modeled link: the CPU has none
    assert rep["speedup_packed_sync"] > 0 and rep["speedup_packed_async"] > 0
    assert len(rep["per_product_sync"]["wall_s_reps"]) == 1  # --smoke: one rep


def test_upload_bench_smoke(tmp_path):
    out = tmp_path / "upload.json"
    assert upload_bench.main(["--smoke", "--out", str(out), "--device", "cpu"]) == 0
    rep = json.loads(out.read_text())
    assert rep["parity"]["ok"] is True
    assert rep["workload"]["transfers_per_tile_packed"] == 1
    assert rep["workload"]["transfers_per_tile_per_array"] == 3
    assert len(rep["packed_sync"]["wall_s_reps"]) == 1  # --smoke: one rep
    assert rep["speedup_packed_sync"] > 0 and rep["speedup_packed_async"] > 0
    store = rep["ingest_store"]
    assert store["parity_ok"] is True
    assert store["store_warm"]["hit_rate"] == store["store_restart"]["hit_rate"] == 1.0
    assert store["store_warm"]["stats"]["misses"] == store["store_restart"]["stats"]["misses"] == 0
    assert store["store_cold"]["stats"]["misses"] > 0


def test_host_path_bench_small(tmp_path):
    out = tmp_path / "hostpath.json"
    assert host_path_bench.main(["--scene", "192", "--tile", "128", "--out", str(out),
                                 "--device", "cpu"]) == 0
    rep = json.loads(out.read_text())
    stages = rep["stages"]
    assert {"feed.numpy", "write.none", "write.deflate", "write.zlib6"} <= set(stages)
    for s in stages.values():
        assert s["px_per_s_per_core"] > 0 and s["cores_for_kernel_rate"] is None
    assert rep["kernel_px_per_s"] is None  # the kernel's rate is measured on the card only
    assert set(rep["feed_scaling_px_s_aggregate"]) == {"1", "2", "4"}
    assert rep["artifact_bytes"]["deflate"] < rep["artifact_bytes"]["none"]


def test_host_benches_need_a_card_by_default(tmp_path, capsys):
    if torch.cuda.is_available():
        return
    for main in (feed_bench.main, fetch_bench.main, upload_bench.main, host_path_bench.main):
        assert main(["--out", str(tmp_path / "x.json")]) == 2
    assert "cuda" in capsys.readouterr().err
