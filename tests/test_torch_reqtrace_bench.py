"""The port's ``tools/reqtrace_bench.py`` on the CPU: a fleet replay over
two spawned ``serve`` replicas with a mid-trace SIGKILL.

The killed job is one trace with two forward hops (the killed replica's,
then the survivor's), every request's blame sums to its router latency,
the p99 exemplar assembles complete, no job is lost and artifacts stay
byte-identical across the kill.  The trace is the JAX tool's.
"""

import json

from land_trendr_tpu_torch.tools import reqtrace_bench


def test_trace_is_the_jax_tools():
    from tools import reqtrace_bench as jax_reqtrace_bench

    assert reqtrace_bench.TRACE == jax_reqtrace_bench._TRACE


def test_reqtrace_bench_on_cpu(tmp_path, monkeypatch):
    # the spawned replicas share this worker's cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "rq.json"
    assert reqtrace_bench.main(["--device", "cpu", "--out", str(out)]) == 0
    rep = json.loads(out.read_text())
    assert rep["ok"] is True and all(rep["invariants"].values()), rep["invariants"]
    assert "survivor_launched_kernels" not in rep["invariants"]
    hops = [h["replica"] for h in rep["killed_trace"]["hops"]]
    assert len(hops) >= 2 and hops[0] == rep["killed_replica"] != hops[-1]
    kt = rep["killed_trace"]
    assert abs(kt["blame_sum_s"] - kt["latency_s"]) <= 5e-3 and kt["route_attempts"] >= 2
    assert rep["requests_folded"] == len(reqtrace_bench.TRACE) == rep["workload"]["jobs"]
    assert rep["p99_exemplar"]["complete"] is True
