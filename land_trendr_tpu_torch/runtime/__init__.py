"""runtime subpackage: host driver, tile manifest, stack loading."""

from land_trendr_tpu_torch.runtime.driver import (
    Run,
    RunCancelled,
    RunConfig,
    StallError,
    TileRetriesExhausted,
    TileSpec,
    assemble_outputs,
    plan_tiles,
    run_stack,
)
from land_trendr_tpu_torch.runtime.manifest import TileManifest, run_fingerprint
from land_trendr_tpu_torch.runtime.stack import (
    RasterStack,
    load_stack_dir,
    load_stack_dir_c2,
    stack_from_synthetic,
)

__all__ = [
    "Run",
    "RunCancelled",
    "RunConfig",
    "StallError",
    "TileRetriesExhausted",
    "TileSpec",
    "assemble_outputs",
    "plan_tiles",
    "run_stack",
    "RasterStack",
    "load_stack_dir",
    "load_stack_dir_c2",
    "stack_from_synthetic",
    "TileManifest",
    "run_fingerprint",
]
