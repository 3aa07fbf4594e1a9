"""Segmentation-as-a-service: the long-lived server runtime.

The serve subpackage turns the one-shot ``segment`` pipeline into a
resident service: warm tile programs
(:mod:`~land_trendr_tpu_torch.serve.programs`), a bounded job queue with
admission control and per-tenant caps over a loopback HTTP JSON API and
a filesystem drop-box (:mod:`~land_trendr_tpu_torch.serve.server`), and
request-scoped observability (job lifecycle events, ``lt_serve_*``
instruments, job_id threaded through every run event).  CLI entry:
``lt serve`` beside ``segment``.
"""

from land_trendr_tpu_torch.serve.config import ServeConfig
from land_trendr_tpu_torch.serve.jobs import (
    EXIT_CODE_FOR_STATE,
    TERMINAL_STATES,
    Job,
    JobRequest,
)
from land_trendr_tpu_torch.serve.programs import ProgramCache
from land_trendr_tpu_torch.serve.server import Rejection, SegmentationServer

__all__ = [
    "EXIT_CODE_FOR_STATE",
    "TERMINAL_STATES",
    "Job",
    "JobRequest",
    "ProgramCache",
    "Rejection",
    "SegmentationServer",
    "ServeConfig",
]
