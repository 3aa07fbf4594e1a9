"""Run one cell of the benchmark once and print its result line.

    python3 -m lt_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout (``BENCHMARK.json`` beside ``lt_bench/``) on
a machine with the cards the cell asks for.  Without them, or without
the program (``land_trendr_tpu_torch``) beside the benchmark, it exits
non-zero and prints no result.  The last line of standard output is one
JSON object; the numbers ``correct`` compared close standard error, each
beside its limit.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

_HERE = Path(__file__).resolve().parent


def _fixed_caches() -> None:
    """The driver's JIT cache at a fixed path inside the checkout (the
    kernel library caches its own build in the program's ``_build/``,
    inside the checkout too, so only a checkout's first run builds)."""
    os.environ["CUDA_CACHE_PATH"] = str(_HERE / ".cache" / "nv")


def _emit(result: dict, compared: dict[str, tuple[float, float]]) -> None:
    for name, (value, limit) in compared.items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    result["compared"] = {n: {"value": v, "limit": lim} for n, (v, lim) in compared.items()}
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m lt_bench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _fixed_caches()

    from lt_bench.spec import load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"lt_bench: {args.workload} needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2

    from lt_bench.harness import forbidden_modules, run_cell
    from lt_bench.report import result_line

    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    print("lt_bench: seconds from start at the end of each phase "
          + json.dumps(out["marks"]), file=sys.stderr)
    result, compared = result_line(out, bool(args.trace))
    # last, after the metric readers have been loaded too
    found = forbidden_modules()
    if found:
        print(f"lt_bench: JAX or the JAX package loaded in this run: {found}", file=sys.stderr)
        return 3
    _emit(result, compared)
    return 0


if __name__ == "__main__":
    sys.exit(main())
