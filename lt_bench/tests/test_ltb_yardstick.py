"""The frozen byte count of the fused kernel, against hand counts, and
the roofline share read from it."""

import types

import pytest

from lt_bench.spec import load_cell, load_reader
from lt_bench.yardstick import PEAKS, peak, segment_kernel_bytes

H100 = "NVIDIA H100 80GB HBM3"


def test_bytes_at_40_years_by_hand():
    # read: 40 years x 4 B, then per pixel 40 x (4 B value + 1 B mask) = 200 B
    # write per pixel: n_vertices 4; 7 vertices x (index 4 + years, src,
    # fit 3 x 4) = 112; 6 segments x (mag, dur, rate 3 x 4) = 72; rmse 4,
    # p_of_f 4, model_valid 1 -> 197 (fitted and despiked are not counted)
    assert segment_kernel_bytes(1, 40, 6) == 160 + 200 + 197
    assert segment_kernel_bytes(262_144, 40, 6) == 160 + 262_144 * 397
    # four launches read the years four times
    assert segment_kernel_bytes(262_144, 40, 6, launches=4) == 4 * 160 + 262_144 * 397
    ms = 1e3 * segment_kernel_bytes(262_144, 40, 6) / PEAKS[H100]["hbm_bytes_per_s"]
    assert round(ms, 4) == 0.0311


def test_bytes_at_72_years_by_hand():
    # read 72 x 5 = 360 B a pixel; write 4 + 112 + 72 + 9 = 197
    assert segment_kernel_bytes(1, 72, 6) == 288 + 360 + 197
    ms = 1e3 * segment_kernel_bytes(262_144, 72, 6) / 3.35e12
    assert round(ms, 4) == 0.0436


def test_bytes_follow_max_segments_and_width():
    # 4 segments: 5 vertices x 16 + 4 x 12 = 128 against 184 at 6
    assert segment_kernel_bytes(1, 40, 6) - segment_kernel_bytes(1, 40, 4) == 184 - 128
    # float64 values: 8 B a value, the mask and the int32 fields unchanged
    assert segment_kernel_bytes(1, 40, 6, 8) == 320 + 40 * 9 + 4 + 7 * 28 + 6 * 24 + 17


def test_unknown_card_has_no_peak():
    assert peak(H100, "hbm_bytes_per_s") == 3.35e12
    assert peak("some other card", "hbm_bytes_per_s") is None


def _run(tiles_px, launches, kernel_s, kind=H100):
    op = types.SimpleNamespace(kind="kernel", name="segment_fused_kernel<float>", start=0.0,
                               end=kernel_s)
    other = types.SimpleNamespace(kind="kernel", name="elementwise", start=0.0, end=5.0)
    return types.SimpleNamespace(
        cell=load_cell("wrs2-nbr40.change"), device_kind=kind, launches=launches,
        tiles=[types.SimpleNamespace(px=p) for p in tiles_px],
        trace=types.SimpleNamespace(ops=[op, other]),
    )


def test_roofline_counts_the_real_pixels_landed():
    read = load_reader("kernel_roofline_pct")
    # a full 1024^2 tile and an edge tile of 904 x 1024, four launches
    # each over the padded tile: the padding counts for nothing
    px = [1024 * 1024, 904 * 1024]
    need_s = (8 * 160 + sum(px) * 397) / 3.35e12
    assert read(_run(px, 8, 2 * need_s)) == pytest.approx(50.0)
    assert read(_run(px, 8, need_s / 2)) == pytest.approx(200.0)  # not capped: a fault shows
    assert read(_run(px, 0, 1.0)) is None
    assert read(_run(px, 8, 1.0, kind="some other card")) is None
