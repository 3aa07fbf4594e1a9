"""Autotuned execution profiles.

Per-device calibration probes (:mod:`~land_trendr_tpu_torch.tune.probes`),
a persisted tuning store keyed by ``(device_kind, backend, scene shape
class, schema)`` (:mod:`~land_trendr_tpu_torch.tune.store`), and the
resolution of ``RunConfig``'s ``"auto"`` knobs
(:func:`~land_trendr_tpu_torch.tune.autotune.resolve_config`).
"""

from land_trendr_tpu_torch.tune.autotune import (
    AUTO,
    CPU_BACKEND,
    KNOB_DEFAULTS,
    TUNABLE_KNOBS,
    autotune,
    device_identity,
    resolve_config,
)
from land_trendr_tpu_torch.tune.store import (
    TUNE_SCHEMA,
    TuningStore,
    profile_key,
    shape_class,
)

__all__ = [
    "AUTO",
    "CPU_BACKEND",
    "KNOB_DEFAULTS",
    "TUNABLE_KNOBS",
    "TUNE_SCHEMA",
    "TuningStore",
    "autotune",
    "device_identity",
    "profile_key",
    "resolve_config",
    "shape_class",
]
