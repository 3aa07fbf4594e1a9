"""Worker process for the port's two-process pod test.

Run as: ``python _torch_pod_worker.py <coordinator> <num_procs> <proc_id>
<workdir> <summary_json> [tile] [telemetry] [overrides_json]``.

The worker joins a ``gloo`` process group through the port's
``init_distributed`` (nothing else of ``torch.distributed`` is used),
builds the same deterministic 48 x 40 x 24-year synthetic stack as its
peers and runs the port's ``run_stack`` on the CPU over a SHARED workdir:
``host_share`` hands each process its contiguous part of the tiles and the
shared manifest accumulates them all.  ``overrides_json`` is a path to a
JSON dict of extra ``RunConfig`` fields.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    coordinator, num_procs, proc_id, workdir, out_path = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
    )
    tile = int(sys.argv[6]) if len(sys.argv) > 6 else 20
    telemetry = bool(int(sys.argv[7])) if len(sys.argv) > 7 else False
    overrides = {}
    if len(sys.argv) > 8 and sys.argv[8]:
        with open(sys.argv[8]) as f:
            overrides = json.load(f)

    import torch.distributed as dist

    from land_trendr_tpu_torch.config import LTParams
    from land_trendr_tpu_torch.io.synthetic import SceneSpec, make_stack
    from land_trendr_tpu_torch.parallel import init_distributed, process_count
    from land_trendr_tpu_torch.runtime import RunConfig, run_stack, stack_from_synthetic

    assert init_distributed(coordinator, num_procs, proc_id, timeout_s=60.0) is True
    assert process_count() == num_procs
    scene = make_stack(
        SceneSpec(width=48, height=40, year_start=1990, year_end=2013, seed=11)
    )
    cfg = RunConfig(
        params=LTParams(max_segments=4, vertex_count_overshoot=2),
        tile_size=tile,  # default 20: a 2 x 3 grid, 3 tiles per process
        workdir=workdir,
        out_dir=workdir + "_out",
        telemetry=telemetry,
        **overrides,
    )
    summary = run_stack(stack_from_synthetic(scene), cfg, device="cpu")
    with open(out_path, "w") as f:
        json.dump(summary, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
