"""The trace digest: device busy time, idle gaps and their host labels,
with and without the events' ``activity_type`` (older torch lacks it)."""

from __future__ import annotations

import pytest

from lt_bench.report import breakdown
from lt_bench.trace import digest

MS = 1_000_000  # ns


class _Ev:
    def __init__(self, name, dev, start_ms, dur_ms, kind=None):
        self._name, self._dev, self._s, self._d, self._kind = name, dev, start_ms, dur_ms, kind

    def name(self):
        return self._name

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def start_ns(self):
        return int(self._s * MS)

    def duration_ns(self):
        return int(self._d * MS)


class _EvTyped(_Ev):
    def activity_type(self):
        return self._kind


def _events(cls):
    return [
        cls("lt_bench.window", "CPU", 100, 50, "user_annotation"),
        cls("lt_bench.window", "CUDA", 100, 50, "gpu_user_annotation"),
        cls("lt_bench.dispatch", "CPU", 100, 18, "user_annotation"),
        cls("aten::where", "CPU", 101, 3, "cpu_op"),
        cls("cudaLaunchKernel", "CPU", 102, 0.5, "cuda_runtime"),
        cls("lt_bench.wait", "CPU", 119, 31, "user_annotation"),
        cls("void segment_fused_kernel<float, 4>(...)", "CUDA", 95, 15, "kernel"),
        cls("void at::native::elementwise_kernel<...>", "CUDA", 120, 10, "kernel"),
        cls("Memcpy DtoH (Device -> Pinned)", "CUDA", 125, 15, "gpu_memcpy"),
        cls("Memset (Device)", "CUDA", 146, 1, "gpu_memset"),
        cls("void late_kernel()", "CUDA", 160, 5, "kernel"),  # after the window
    ]


@pytest.mark.parametrize("cls", [_Ev, _EvTyped])
def test_digest(cls):
    d = digest(_events(cls))
    assert d.window_s == pytest.approx(0.050)
    kinds = sorted((o.kind, round(o.start, 6), round(o.end, 6)) for o in d.ops)
    # clipped to the window; the annotations' device side and the late kernel left out
    assert kinds == [("kernel", 0.0, 0.010), ("kernel", 0.020, 0.030),
                     ("memcpy", 0.025, 0.040), ("memset", 0.046, 0.047)]
    assert d.busy_s == pytest.approx(0.010 + 0.020 + 0.001)
    gaps = [(round(g.start, 6), round(g.end, 6), g.label) for g in d.gaps]
    assert gaps == [(0.010, 0.020, "lt_bench.dispatch/python"),
                    (0.040, 0.046, "lt_bench.wait/python"),
                    (0.047, 0.050, "lt_bench.wait/python")]
    b = breakdown(d)
    assert b["device_ops"][0] == ["Memcpy DtoH (Device -> Pinned)", pytest.approx(0.015)]
    assert b["idle_gaps"][0] == ["lt_bench.dispatch/python", pytest.approx(0.010)]


def test_gap_labelled_by_the_host_op_running():
    evs = [
        _Ev("lt_bench.window", "CPU", 0, 10),
        _Ev("lt_bench.dispatch", "CPU", 0, 10),
        _Ev("aten::sort", "CPU", 2, 6),
        _Ev("aten::copy_", "CPU", 3, 1),  # nested: the outer op names the gap
        _Ev("kernel_a", "CUDA", 0, 2),
        _Ev("kernel_b", "CUDA", 8, 2),
    ]
    d = digest(evs)
    assert [(g.label, round(g.end - g.start, 6)) for g in d.gaps] == [("lt_bench.dispatch/aten::sort", 0.006)]


def test_no_window_no_digest():
    assert digest([_Ev("aten::mul", "CPU", 0, 1)]) is None
