"""Seconds ``nvcc`` takes to build the kernel library, part by part.

The library (:mod:`~land_trendr_tpu_torch.ops.segment_cuda`) compiles
``csrc/segment_fused.cu`` once per ``LT_PART``, all parts started
together, and links the objects.  This tool builds each source file
given, in the order given, with the library's flags: each part alone (one
``nvcc`` at a time), then every part at once and the link, as the
library's first use does.  Name a parent's copy of the source beside this
one, in an A B A order, to compare two versions on one host.  One JSON
record: for each build, the source's sha256, each part's seconds and the
whole build's, with the command, commit, source digest and card line of
:func:`~land_trendr_tpu_torch.tools.measure.record_meta`.  Exits 2
without ``nvcc``, 1 when a build fails.

Usage::

    python -m land_trendr_tpu_torch.tools.build_time SRC [SRC ...] [--out FILE]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

from land_trendr_tpu_torch.ops import segment_cuda
from land_trendr_tpu_torch.tools.measure import record_meta, write_json_atomic

__all__ = ["build", "main", "parts_of"]

_PART = re.compile(r"LT_PART == (\d+)")


def parts_of(text: str) -> "list[int]":
    """The ``LT_PART`` values a source compiles under."""
    return sorted({int(n) for n in _PART.findall(text)})


def _compile(nvcc: str, src: str, part: int, obj: str) -> "list[str]":
    return [nvcc, *segment_cuda._NVCC_FLAGS, f"-DLT_PART={part}", "-c", "-o", obj, src]


def _check(proc: "subprocess.CompletedProcess | subprocess.Popen", err: str, what: str) -> None:
    if proc.returncode:
        raise RuntimeError(f"{what} exited {proc.returncode}: {err[-2000:]}")


def build(src: str, work: str, nvcc: str) -> dict:
    """Each part of ``src`` alone, then the library's build of it, in ``work``."""
    with open(src, "rb") as f:
        text = f.read()
    parts = parts_of(text.decode())
    objs = [os.path.join(work, f"part{n}.o") for n in parts]
    alone = {}
    for n, obj in zip(parts, objs):
        t0 = time.perf_counter()
        r = subprocess.run(_compile(nvcc, src, n, obj), capture_output=True, text=True)
        alone[str(n)] = round(time.perf_counter() - t0, 3)
        _check(r, r.stderr, f"nvcc LT_PART={n}")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(_compile(nvcc, src, n, obj), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for n, obj in zip(parts, objs)]
    for n, p in zip(parts, procs):
        _check(p, p.communicate()[1], f"nvcc LT_PART={n}")
    link = subprocess.run([nvcc, *segment_cuda._NVCC_FLAGS[:2], "-shared", "-o",
                           os.path.join(work, "lib.so"), *objs], capture_output=True, text=True)
    _check(link, link.stderr, "nvcc -shared")
    return {"src": src, "sha256": hashlib.sha256(text).hexdigest(), "parts": parts,
            "part_alone_s": alone, "build_s": round(time.perf_counter() - t0, 3)}


def main(argv: "list[str] | None" = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("src", nargs="+", help="copies of csrc/segment_fused.cu, in build order")
    ap.add_argument("--out", default=None, help="also write the JSON record here")
    args = ap.parse_args(argv)
    try:
        nvcc = segment_cuda._nvcc()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    builds = []
    try:
        for src in args.src:
            with tempfile.TemporaryDirectory(prefix="lt_build_time_") as work:
                builds.append(build(src, work, nvcc))
            print(json.dumps(builds[-1]), file=sys.stderr)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    rec = {"builds": builds, "nproc": os.cpu_count(),
           **record_meta("land_trendr_tpu_torch.tools.build_time", argv, "cuda")}
    if args.out:
        write_json_atomic(args.out, rec, indent=1)
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    sys.exit(main())
