"""Standalone elastic worker: one independent process, one shared workdir.

Counterpart of the JAX package's ``tools/_elastic_worker.py``.  Run as::

    python -m land_trendr_tpu_torch.tools.elastic_worker CONFIG.json

The worker joins no process group (it never touches
``torch.distributed``): elastic lease scheduling coordinates through the
shared manifest alone, so a "pod" here is any set of independent
processes pointed at one workdir, and a host can join a run already in
flight (the late joiner of ``elastic_soak``) or be SIGKILLed without
taking anyone else down.

``CONFIG.json``::

    {
      "workdir": ..., "out_dir": ...,
      "width": 80, "height": 80, "tile_size": 20, "seed": 11,
      "years": 24, "year_start": 1990,
      "device": "cuda",               # or "cpu" (tests)
      "summary_path": ...,            # where the run summary JSON lands
      "start_when": ...,              # optional: a path whose appearance
                                      # starts the run (the late joiner)
      "run": { ... RunConfig overrides: lease_batch, lease_ttl_s,
               speculate, fault_schedule, telemetry, params, ... }
    }

The synthetic scene is deterministic in (width, height, years, seed), so
every worker and the soak's clean reference feed identical pixels.  The
summary carries the fused kernel's launch count of this process.
"""

from __future__ import annotations

import json
import os
import sys
import time

import torch

from land_trendr_tpu_torch.config import LTParams
from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
from land_trendr_tpu_torch.ops import segment_cuda
from land_trendr_tpu_torch.runtime import RunConfig, run_stack, stack_from_synthetic
from land_trendr_tpu_torch.tools.measure import write_json_atomic

__all__ = ["DEFAULT_PARAMS", "main", "scene_of"]

#: the soaks' small model: 4 segments, 2 extra candidates
DEFAULT_PARAMS = {"max_segments": 4, "vertex_count_overshoot": 2}


def scene_of(cfg_json: dict):
    """The worker's deterministic synthetic stack."""
    years = int(cfg_json.get("years", 24))
    start = int(cfg_json.get("year_start", 1990))
    spec = SceneSpec(
        width=int(cfg_json["width"]),
        height=int(cfg_json["height"]),
        year_start=start,
        year_end=start + years - 1,
        seed=int(cfg_json.get("seed", 11)),
    )
    return stack_from_synthetic(make_stack(spec))


def main(argv: "list[str] | None" = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        cfg_json = json.load(f)
    run_kw = dict(cfg_json.get("run", {}))
    params = run_kw.pop("params", DEFAULT_PARAMS)
    cfg = RunConfig(
        params=LTParams.from_dict(params),
        tile_size=int(cfg_json["tile_size"]),
        workdir=cfg_json["workdir"],
        out_dir=cfg_json["out_dir"],
        retry_backoff_s=0.0,
        **run_kw,
    )
    device = cfg_json.get("device", "cuda")
    stack = scene_of(cfg_json)
    gate = cfg_json.get("start_when")
    if gate:
        # a late joiner pays its start-up (imports, the device's context,
        # the scene) before the run is under way, then joins on the signal
        torch.zeros(1, device=device)
        while not os.path.exists(gate):
            time.sleep(0.02)
    launches0 = segment_cuda.LAUNCHES
    summary = run_stack(stack, cfg, device=device)
    summary["launches"] = segment_cuda.LAUNCHES - launches0
    out = cfg_json.get("summary_path")
    if out:
        # the soak polls for this file; rename-as-commit means it never
        # reads a torn summary
        write_json_atomic(out, summary, indent=None, trailing_newline=False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
