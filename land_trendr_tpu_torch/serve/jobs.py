"""Job model: the request schema, lifecycle states, and exit-code mapping.

A **job** is one AOI/param segmentation request — the serve-mode unit of
work, exactly what one ``lt segment`` invocation does, minus the process
start, config parse, jit compile and (with the shared ingest store) the
TIFF decode that invocation would pay.  Requests arrive as JSON (HTTP
POST or drop-box file), are validated into :class:`JobRequest`, and run
through a warm :class:`~land_trendr_tpu_torch.runtime.driver.Run`.

Job states map onto the documented CLI exit-code contract (README
§Failure semantics) so orchestrators reason about one table:

=====================  ====  =================================================
state                  exit  meaning
=====================  ====  =================================================
``done``               0     run + assembly completed
``config_error``       2     bad request / bad stack (not retryable as-is)
``retries_exhausted``  3     tile(s) exhausted retries / quarantined —
                             manifest resumable (see below)
``stalled``            4     job timeout (the stall watchdog's job-level
                             analog) — manifest resumable
``cancelled``          3     explicit cancel — manifest resumable like any
                             retryable abort
``error``              1     unclassified failure (server-side defect)
=====================  ====  =================================================

**Resuming**: each fresh submission gets a fresh ``jobs/<id>/work``
manifest, so resuming a retryable job means resubmitting with the OLD
job's ``workdir`` pinned in the request (the terminal error string and
the job's status snapshot both carry it); only then does the new job
complete exactly the remaining tiles.

``queued`` / ``running`` are the non-terminal states; ``rejected``
submissions never become jobs (they are answered at admission with the
429-style response and a ``job_rejected`` event).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import threading
import time

__all__ = [
    "EXIT_CODE_FOR_STATE",
    "TERMINAL_STATES",
    "Job",
    "JobRequest",
]

#: terminal job states (see the module docstring's mapping table)
TERMINAL_STATES = (
    "done",
    "config_error",
    "retries_exhausted",
    "stalled",
    "cancelled",
    "error",
)

#: job state → the CLI exit code the same outcome would have produced
EXIT_CODE_FOR_STATE = {
    "done": 0,
    "error": 1,
    "config_error": 2,
    "retries_exhausted": 3,
    "cancelled": 3,
    "stalled": 4,
}


@dataclasses.dataclass(frozen=True)
class JobRequest:
    """One validated AOI/param request.

    The fields mirror the ``segment`` CLI surface a client would
    otherwise drive; ``run_overrides`` passes any further
    :class:`~land_trendr_tpu_torch.runtime.driver.RunConfig` field straight
    through (validated by RunConfig itself — an unknown field or bad
    value is a ``config_error``).  Cache/store knobs are NOT accepted:
    the server owns the process-wide cache and the shared ingest store.
    """

    stack_dir: str
    index: str = "nbr"
    ftv: tuple[str, ...] = ()
    params: "dict | None" = None
    tile_size: "int | str" = 256  # "auto" = tuning-store resolution
    products: "tuple[str, ...] | None" = None
    workdir: "str | None" = None  # default <serve workdir>/jobs/<id>/work
    out_dir: "str | None" = None  # default <serve workdir>/jobs/<id>/out
    tenant: str = "default"
    priority: int = 0  # higher drains first; FIFO within a priority
    timeout_s: "float | None" = None  # overrides ServeConfig.job_timeout_s
    #: SLO deadline, seconds, submit→terminal — ACCOUNTING ONLY: a job
    #: past its deadline keeps running to its natural terminal state
    #: (use ``timeout_s`` to enforce a bound); the miss surfaces as
    #: ``deadline_exceeded`` in the status snapshot, ``met=false`` on
    #: the ``job_slo`` event, and the ``lt_slo_*`` instruments
    deadline_s: "float | None" = None
    max_retries: int = 2
    quarantine_tiles: bool = False
    lazy: bool = False  # windowed C2 ingest (the ingest-store workload)
    assemble: bool = True  # mosaic rasters after the run
    #: resume the manifest found in THIS job's workdir — effective for
    #: resubmissions only when the request pins the prior job's
    #: ``workdir`` (fresh submissions get fresh jobs/<id>/work dirs)
    resume: bool = True
    run_overrides: "dict | None" = None
    #: request-tracing correlation id: stamped by the fleet router at
    #: ITS admission and carried through the forward payload, so a
    #: re-routed submission keeps the original id; a direct submission
    #: leaves it None and the server mints one at serve admission.
    #: Deliberately EXCLUDED from the affinity key — two requests that
    #: differ only in identity run the same programs.
    trace_id: "str | None" = None
    #: client-chosen resubmission token: the fleet router remembers it in
    #: the admission journal, so a duplicate submission (a retry after a
    #: timed-out 200, before OR after a router restart) returns the
    #: EXISTING job instead of double-running.  Like ``trace_id``,
    #: identity only — excluded from the affinity key.
    idempotency_key: "str | None" = None

    #: the per-run knobs the server owns (shared cache/store) or that
    #: cannot mean anything inside a server process — rejected even via
    #: run_overrides, so a request cannot clobber sibling jobs
    _RESERVED_OVERRIDES = (
        "feed_cache_mb",
        "decode_workers",
        "ingest_store_mb",
        "ingest_store_dir",
        "telemetry",
        "metrics_port",
        "metrics_host",
        "fault_schedule",
        "stall_timeout_s",
    )

    @classmethod
    def from_payload(cls, payload: dict) -> "JobRequest":
        """Parse + validate one submission payload (HTTP body or
        drop-box file).  Raises ``ValueError`` on anything malformed —
        the admission layer maps that to a 400-class rejection."""
        if not isinstance(payload, dict):
            raise ValueError(
                f"job request must be a JSON object, got "
                f"{type(payload).__name__}"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(payload) - known)
        if unknown:
            raise ValueError(f"unknown job request field(s): {unknown}")
        if "stack_dir" not in payload or not isinstance(
            payload["stack_dir"], str
        ):
            raise ValueError("job request needs a string 'stack_dir'")
        kw = dict(payload)
        if "ftv" in kw:
            if isinstance(kw["ftv"], str):
                kw["ftv"] = tuple(s for s in kw["ftv"].split(",") if s)
            else:
                kw["ftv"] = tuple(kw["ftv"])
        if kw.get("products") is not None:
            kw["products"] = tuple(kw["products"])
        req = cls(**kw)
        if req.priority < -100 or req.priority > 100:
            raise ValueError(
                f"priority={req.priority} outside -100..100"
            )
        if req.timeout_s is not None and req.timeout_s <= 0:
            raise ValueError(f"timeout_s={req.timeout_s} must be > 0")
        if req.deadline_s is not None and req.deadline_s <= 0:
            raise ValueError(f"deadline_s={req.deadline_s} must be > 0")
        if isinstance(req.tile_size, str):
            # the tuning-store sentinel: resolved at Run construction
            # through the replica's shared store (README §Autotuning)
            if req.tile_size != "auto":
                raise ValueError(
                    f"tile_size={req.tile_size!r} must be an integer or "
                    "'auto'"
                )
        elif req.tile_size < 1:
            raise ValueError(f"tile_size={req.tile_size} must be >= 1")
        if req.max_retries < 0:
            raise ValueError(
                f"max_retries={req.max_retries} must be >= 0"
            )
        if not req.tenant or not isinstance(req.tenant, str):
            raise ValueError("tenant must be a non-empty string")
        if req.trace_id is not None and (
            not isinstance(req.trace_id, str) or not req.trace_id
        ):
            raise ValueError("trace_id must be a non-empty string")
        if req.idempotency_key is not None and (
            not isinstance(req.idempotency_key, str)
            or not req.idempotency_key
        ):
            raise ValueError("idempotency_key must be a non-empty string")
        overrides = req.run_overrides or {}
        if not isinstance(overrides, dict):
            raise ValueError("run_overrides must be a JSON object")
        reserved = sorted(set(overrides) & set(cls._RESERVED_OVERRIDES))
        if reserved:
            raise ValueError(
                f"run_overrides may not set server-owned field(s): "
                f"{reserved}"
            )
        if "ensemble_indices" in overrides:
            # the stack load, cross-job batching and the affinity key know
            # one segmented index a job: refuse rather than drop the field
            raise ValueError(
                "run_overrides may not set ensemble_indices: serve segments "
                "one index a job; run an ensemble with `segment --ensemble`"
            )
        return req

    #: the request fields that select the compiled-program/decoded-block
    #: set a job needs — the AFFINITY key's inputs.  Tenant, priority,
    #: deadlines and directory pins deliberately excluded: two requests
    #: that differ only in those run the SAME programs over the SAME
    #: blocks, so they must hash identically for warm routing.
    _AFFINITY_FIELDS = (
        "stack_dir",
        "index",
        "ftv",
        "params",
        "tile_size",
        "products",
        "lazy",
        "run_overrides",
    )

    def affinity_key(self) -> str:
        """Deterministic warm-affinity key over the shape-relevant
        request fields (see ``_AFFINITY_FIELDS``).

        This is the routing-layer sibling of
        :meth:`~land_trendr_tpu_torch.serve.programs.ProgramCache.key_for`:
        the program-cache key hashes facts only the executing process
        knows (backend, mesh, padded pixel counts), while this key
        hashes the REQUEST alone — so a front-end router and a replica
        compute the same key for the same submission without running
        it.  Repeat shapes hash identically; ``/healthz`` exposes each
        replica's recently-run keys (bounded) for the router's affinity
        table."""
        facts = {name: getattr(self, name) for name in self._AFFINITY_FIELDS}
        blob = json.dumps(facts, sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]

    def to_run_config(self, workdir: str, out_dir: str, telemetry: bool):
        """Project this request onto a RunConfig over the job's resolved
        directories.

        The server's cache/store configuration deliberately does NOT
        ride the RunConfig (the Run uses the process-wide cache and the
        server's ``shared_store`` as configured once at startup);
        RunConfig validation errors propagate as ``ValueError`` — the
        ``config_error`` terminal state.
        """
        from land_trendr_tpu_torch.config import LTParams
        from land_trendr_tpu_torch.runtime import RunConfig

        kw = dict(
            index=self.index,
            ftv_indices=tuple(self.ftv),
            params=LTParams.from_dict(self.params or {}),
            tile_size=self.tile_size,
            products=self.products,
            workdir=workdir,
            out_dir=out_dir,
            resume=self.resume,
            max_retries=self.max_retries,
            quarantine_tiles=self.quarantine_tiles,
            telemetry=telemetry,
        )
        kw.update(self.run_overrides or {})
        return RunConfig(**kw)


@dataclasses.dataclass
class Job:
    """One admitted job's mutable server-side record.

    All mutation happens under the server's lock (the dispatcher and the
    HTTP handler threads share these records); :meth:`status` snapshots
    a JSON-safe view for the API.
    """

    job_id: str
    request: JobRequest
    source: str = "http"  # "http" | "dropbox"
    #: the request-tracing correlation id: the request's own (router
    #: forwards carry it) or minted at serve admission for direct jobs
    trace_id: str = ""
    state: str = "queued"
    submitted_t: float = dataclasses.field(default_factory=time.time)
    started_t: "float | None" = None
    finished_t: "float | None" = None
    error: "str | None" = None
    summary: "dict | None" = None
    outputs: "dict | None" = None
    workdir: "str | None" = None
    out_dir: "str | None" = None
    #: the Run-level cancel event (explicit cancel AND job timeout)
    cancel: threading.Event = dataclasses.field(
        default_factory=threading.Event
    )
    timed_out: bool = False
    #: set by the dispatcher when a shared launch fully demuxed this
    #: job's manifest: its own queue turn is a pure resume, so the
    #: dispatcher holds no batch window for it and never re-packs it
    #: (a batch behind a no-work leader demuxes nothing)
    batch_demuxed: bool = False
    dropbox_path: "str | None" = None
    #: the live Run object while the job executes (the /debug/jobs
    #: progress feed); RELEASED at terminal — a Run pins the job's whole
    #: decoded stack, which a long-lived server must not accumulate
    run: "object | None" = None

    def _latency_split_locked(self) -> "tuple[float, float]":
        """``(queue_wait_s, exec_s)`` with each leg clamped ≥ 0; caller
        holds the server lock.  Latency is DERIVED as their sum, never
        re-measured end−submit: a backwards wall-clock step between the
        three stamps could otherwise break the ``queue_wait + exec <=
        latency`` split the schema value-lint hard-enforces — and this
        one derivation serves both ``slo_locked`` (terminal verdict) and
        ``status_locked`` (live ``deadline_exceeded``) so the two can
        never disagree about the same job."""
        end = self.finished_t if self.finished_t is not None else time.time()
        start = self.started_t if self.started_t is not None else end
        return max(0.0, start - self.submitted_t), max(0.0, end - start)

    def slo_locked(self) -> dict:
        """SLO accounting for a TERMINAL job (caller holds the server
        lock): the latency split — queue wait (submit→dispatch) vs
        execution (dispatch→terminal) — and the deadline verdict.
        A job cancelled while still queued has ``exec_s`` 0 and a queue
        wait spanning its whole life.  The verdict is accounting, never
        enforcement: ``met`` is True when no ``deadline_s`` was set.
        """
        queue_wait, exec_s = self._latency_split_locked()
        latency = queue_wait + exec_s
        deadline = self.request.deadline_s
        out = {
            "queue_wait_s": round(queue_wait, 6),
            "exec_s": round(exec_s, 6),
            "latency_s": round(latency, 6),
            "met": deadline is None or latency <= deadline,
        }
        if deadline is not None:
            out["deadline_s"] = deadline
        return out

    def status_locked(self) -> dict:
        """JSON-safe snapshot; caller holds the server lock."""
        out = {
            "job_id": self.job_id,
            "trace_id": self.trace_id,
            "state": self.state,
            "tenant": self.request.tenant,
            "priority": self.request.priority,
            "source": self.source,
            "submitted_t": self.submitted_t,
            "started_t": self.started_t,
            "finished_t": self.finished_t,
            "workdir": self.workdir,
            "out_dir": self.out_dir,
        }
        if self.state in TERMINAL_STATES:
            out["exit_code"] = EXIT_CODE_FOR_STATE.get(self.state, 1)
        deadline = self.request.deadline_s
        if deadline is not None:
            # live surfacing: a RUNNING job past its deadline already
            # reads deadline_exceeded — the SLO is about the requester's
            # clock, not the job's eventual terminal state
            if sum(self._latency_split_locked()) > deadline:
                out["deadline_exceeded"] = True
        if self.error is not None:
            out["error"] = self.error
        if self.summary is not None:
            out["summary"] = self.summary
        if self.outputs is not None:
            out["outputs"] = self.outputs
        return out
