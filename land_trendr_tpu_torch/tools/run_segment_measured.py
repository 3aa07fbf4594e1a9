"""Run the port's CLI in-process and report its peak RSS alongside.

Counterpart of the JAX package's ``tools/run_segment_measured.py`` (a
stand-in for ``/usr/bin/time -v``): the CLI's own output goes to stdout
unchanged, and one JSON line ``{"peak_rss_mib": ...}`` (this process's
peak, ``tools/measure.py:peak_rss_mib``) goes to stderr at exit.  The
arguments are the CLI's, ``--device`` included (the CLI's own top-level
flag: the card unless it says ``cpu``).  A leading ``--out REC`` (before the CLI's arguments) also
writes a record: the CLI's summary, its exit code, wall seconds, the peak
RSS and the resident set before the run (``rss_at_start_mib``: the
imports, torch's libraries among them), the free disk beside the workdir before the run and the command, commit, source digest
and card line of :func:`~land_trendr_tpu_torch.tools.measure.record_meta`.

Usage::

    python -m land_trendr_tpu_torch.tools.run_segment_measured [--out REC] <cli args...>
      e.g. ... run_segment_measured --out SCENE.json segment STACK --tile-size 512
"""

from __future__ import annotations

import contextlib
import io
import json
import sys
import time

from land_trendr_tpu_torch.tools.measure import (
    disk_free,
    peak_rss_mib,
    record_meta,
    rss_mib,
    watch_rss,
    write_json_atomic,
)

__all__ = ["main"]


def _cli_device(cli_args: "list[str]") -> str:
    """The device the CLI runs on: its top-level ``--device`` or the card."""
    dev = "cuda"
    for i, a in enumerate(cli_args):
        if a == "--device" and i + 1 < len(cli_args):
            dev = cli_args[i + 1]
        elif a.startswith("--device="):
            dev = a.split("=", 1)[1]
    return "cuda" if dev.startswith("cuda") else dev


def main(argv: "list[str] | None" = None) -> int:
    from land_trendr_tpu_torch.cli import main as cli_main

    watch_rss()
    rss_at_start = rss_mib()
    args = list(sys.argv[1:] if argv is None else argv)
    out = None
    if args[:1] == ["--out"] and len(args) > 1:
        out, args = args[1], args[2:]
    workdir = next((args[i + 1] for i, a in enumerate(args[:-1]) if a == "--workdir"), ".")
    disk = disk_free(workdir) if out is not None else None
    t0 = time.perf_counter()
    if out is None:
        rc = cli_main(args)
        printed = None
    else:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli_main(args)
        printed = buf.getvalue()
        sys.stdout.write(printed)
    wall = time.perf_counter() - t0
    peak = peak_rss_mib()
    print(json.dumps({"peak_rss_mib": peak}), file=sys.stderr)
    if out is not None:
        try:
            cli_out = json.loads(printed)
        except ValueError:
            cli_out = {"stdout_tail": printed[-2000:]}
        rec = {
            "cli_args": args,
            "rc": rc,
            "wall_s": round(wall, 3),
            "peak_rss_mib": peak,
            "rss_at_start_mib": rss_at_start,
            "disk_before": disk,
            **({"summary": cli_out["summary"], "outputs": sorted(cli_out.get("outputs", {}))}
               if isinstance(cli_out, dict) and "summary" in cli_out else {"cli": cli_out}),
            **record_meta("land_trendr_tpu_torch.tools.run_segment_measured",
                          argv, _cli_device(args)),
        }
        write_json_atomic(out, rec)
    return rc


if __name__ == "__main__":
    sys.exit(main())
