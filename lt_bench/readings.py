"""The readings a cell's limits are set from, in one process on the card.

    python3 -m lt_bench.readings --workload <name> --seeds 1,2,... \\
        [--control-seeds 7,8,9] [--seconds 3]

For each seed a whole run at the cell's own size and load, with a short
window: the program as the benchmark runs it, and for each control seed
the control, the program with its own lower-precision path switched on
(``fetch_f16``: float products cross the link as float16).  Prints one
JSON line per run (``worst_gap`` and each product's gap) and a summary:
the largest sound reading (the limit's lower end) and the smallest
control reading (its upper end).  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m lt_bench.readings")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds of the program's runs")
    ap.add_argument("--control-seeds", default="", help="comma-separated seeds of control runs")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from lt_bench.harness import run_cell
    from lt_bench.spec import load_cell

    if not torch.cuda.is_available():
        print("lt_bench.readings: needs a CUDA card", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    runs = [(int(s), False) for s in args.seeds.split(",") if s]
    runs += [(int(s), True) for s in args.control_seeds.split(",") if s]
    lines = []
    for seed, control in runs:
        t0 = time.perf_counter()
        out = run_cell(cell, seed, args.seconds, False, t0, fetch_f16=control)
        chk = out["checked"]
        line = {
            "workload": cell.name, "seed": seed, "control": control,
            "tiles": len(out["run"].tiles), "rows": chk["rows"],
            **chk["numbers"], "gaps": chk["gaps"],
            "seconds": time.perf_counter() - t0,
        }
        lines.append(line)
        print(json.dumps(line), flush=True)
    sound = [ln["worst_gap"] for ln in lines if not ln["control"]]
    ctrl = [ln["worst_gap"] for ln in lines if ln["control"]]
    summary = {
        "workload": cell.name,
        "device": torch.cuda.get_device_name(0),
        "lower": max(sound, default=None),
        "upper": min(ctrl, default=None),
        "sound_runs": len(sound),
        "control_runs": len(ctrl),
    }
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
