"""The result line of one run: metrics by their readers, the device, the
trace's breakdown and the numbers ``correct`` compared."""

from __future__ import annotations

from collections import defaultdict

from lt_bench.spec import load_reader

__all__ = ["breakdown", "result_line"]

#: entries of each breakdown list
_TOP = 10


def breakdown(digest) -> dict:
    """The device operations that took most time and the longest idle time
    of the device by what the host was doing, each in seconds."""
    by_op: dict[str, float] = defaultdict(float)
    for op in digest.ops:
        by_op[op.name[:160]] += op.end - op.start
    by_gap: dict[str, float] = defaultdict(float)
    for g in digest.gaps:
        by_gap[g.label[:160]] += g.end - g.start
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:_TOP]
    gaps = sorted(by_gap.items(), key=lambda kv: -kv[1])[:_TOP]
    return {"device_ops": [[n, s] for n, s in top], "idle_gaps": [[n, s] for n, s in gaps]}


def result_line(out: dict, traced: bool) -> tuple[dict, dict[str, tuple[float, float]]]:
    """``(result, compared)``: the JSON result without its last key, and
    each number compared with its limit."""
    run = out["run"]
    cell = run.cell
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = load_reader(m["name"], cell.root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    numbers = out["checked"]["numbers"]
    compared = {name: (numbers.get(name, float("inf")), limit) for name, limit in cell.limits.items()}
    correct = bool(compared) and all(v <= lim for v, lim in compared.values())
    device = {
        "platform": "gpu",
        "kind": run.device_kind,
        "count": cell.chips,
        "memory_peak_bytes": out["memory_peak_bytes"],
    }
    result = {
        "correct": correct,
        "attempted": len(run.tiles),
        "failed": 0,
        "metrics": metrics,
        "device": device,
    }
    if traced and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        result["breakdown"] = breakdown(run.trace)
    return result, compared
