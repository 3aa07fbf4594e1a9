"""LandTrendr parameters of the benchmark's reference.

A frozen copy of the port's ``LTParams`` (``land_trendr_tpu_torch/
config.py``): the published LandTrendr parameterisation (Kennedy, Yang &
Cohen 2010; the LT-GEE defaults of Kennedy et al. 2018, Table 1).  A
configuration file's ``params`` object is read into it key for key.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LTParams:
    """LandTrendr temporal-segmentation parameters (static / hashable).

    Attributes
    ----------
    max_segments:
        Maximum number of piecewise-linear segments in the fitted model;
        the model has at most ``max_segments + 1`` vertices.
    spike_threshold:
        Despike severity threshold in [0, 1].  ``1.0`` disables dampening
        entirely; lower values dampen more aggressively.  A point whose
        spike proportion (see oracle Stage 1) *exceeds* this threshold is
        dampened toward the neighbour interpolation.
    vertex_count_overshoot:
        Extra candidate vertices found by the deviation search before the
        angle-based cull reduces the set back to ``max_segments + 1``.
    recovery_threshold:
        Recovery-rate filter: a segment whose fitted recovery rate exceeds
        ``recovery_threshold`` × (pixel spectral range) per year — i.e. a
        full-range recovery faster than ``1 / recovery_threshold`` years —
        is disallowed (the anchored-fit slope is clamped to the limit).
    prevent_one_year_recovery:
        If true, recovery segments of duration ≤ 1 year are disallowed
        outright (slope clamped to 0 for that segment).
    p_val_threshold:
        Maximum acceptable p-of-F for the selected model; if no candidate
        model passes, the pixel is flagged no-fit and a flat (mean) model
        is returned.
    best_model_proportion:
        Model-selection leniency: among candidate models, prefer the one
        with the *most* segments whose p-value satisfies
        ``p <= p_best / best_model_proportion``.
    min_observations_needed:
        Minimum number of valid (unmasked) years required to attempt a fit.
    """

    max_segments: int = 6
    spike_threshold: float = 0.9
    vertex_count_overshoot: int = 3
    recovery_threshold: float = 0.25
    prevent_one_year_recovery: bool = True
    p_val_threshold: float = 0.05
    best_model_proportion: float = 0.75
    min_observations_needed: int = 6

    def __post_init__(self) -> None:
        if self.max_segments < 1:
            raise ValueError("max_segments must be >= 1")
        if not (0.0 <= self.spike_threshold <= 1.0):
            raise ValueError("spike_threshold must be in [0, 1]")
        if self.vertex_count_overshoot < 0:
            raise ValueError("vertex_count_overshoot must be >= 0")
        if self.recovery_threshold <= 0.0:
            raise ValueError("recovery_threshold must be > 0")
        if not (0.0 < self.p_val_threshold <= 1.0):
            raise ValueError("p_val_threshold must be in (0, 1]")
        if not (0.0 < self.best_model_proportion <= 1.0):
            raise ValueError("best_model_proportion must be in (0, 1]")
        if self.min_observations_needed < 3:
            raise ValueError("min_observations_needed must be >= 3")

    # -- sizes derived from the static parameters --------------------------

    @property
    def max_vertices(self) -> int:
        """Vertex capacity of the final model (``max_segments + 1``)."""
        return self.max_segments + 1

    @property
    def max_candidates(self) -> int:
        """Vertex capacity during the overshoot search."""
        return self.max_segments + 1 + self.vertex_count_overshoot
