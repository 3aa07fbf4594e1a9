"""The port's ``tools/lt_trace.py`` over the pod fixture, against the JAX
package's ``tools/lt_trace.py``.

The two-host skewed-clock fixture assembles to the same report in both
packages (the port's ``obs/spans`` against the JAX one), and the port's
Chrome export has one trace process per host, stage names as threads,
timestamps rebased to >= 0 and the straggler as an instant.
"""

import json
import os

from land_trendr_tpu_torch.tools import lt_trace

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
POD_FIXTURE = [
    os.path.join(FIXTURES, "podtrace_skew.p0.events.jsonl"),
    os.path.join(FIXTURES, "podtrace_skew.p1.events.jsonl"),
]


def test_lt_trace_cli(tmp_path, capsys):
    out = str(tmp_path / "pod_trace.json")
    assert lt_trace.main([*POD_FIXTURE, "--trace", out]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["files"] == 2
    assert report["pod"]["critical_path"]["bound_stage"] == "compute"
    assert report["trace"]["events"] > 0
    evs = json.load(open(out))["traceEvents"]
    assert {e["args"]["name"] for e in evs if e.get("name") == "process_name"} \
        == {"proc 0 @ host-a", "proc 1 @ host-b"}
    xs = [e for e in evs if e["ph"] == "X"]
    assert xs and all(e["ts"] >= 0 for e in xs)
    assert any(e["name"].startswith("STRAGGLER") for e in evs if e["ph"] == "i")


def test_report_is_the_jax_tools(tmp_path, capsys):
    from tools import lt_trace as jax_lt_trace

    assert lt_trace.main(POD_FIXTURE) == 0
    port = json.loads(capsys.readouterr().out)
    assert jax_lt_trace.main(POD_FIXTURE) == 0
    ref = json.loads(capsys.readouterr().out)
    assert port == ref


def test_lt_trace_cli_missing_path(tmp_path):
    assert lt_trace.main([str(tmp_path / "nope")]) == 2
