"""Fleet telemetry alerts: a small declarative rules engine.

The **alerts** quarter of the fleet telemetry plane: evaluate declared
rules over the aggregated history (:mod:`~land_trendr_tpu_torch.obs.history`
samples) and drive a firing → resolved lifecycle per rule — the
machine-readable half of "a deadline miss fires an alert somewhere".

Rule kinds:

=============  ===========================================================
``threshold``  latest sample's ``metric`` compared ``op`` ``value``
``rate``       reset-aware counter rate of ``metric`` over ``window_s``
               (:func:`~land_trendr_tpu_torch.obs.history.counter_rate`)
               compared ``op`` ``value``
``slo_burn``   sugar for a threshold on the pod-max ``lt_slo_burn_rate``
``absent``     host-staleness/absence: fires when the latest sample's
               ``metric`` (default ``stale_hosts``) compares ``op``
               ``value`` (defaults ``> 0`` — one stale host fires), OR
               when no sample landed within ``window_s`` at all — the
               whole plane going dark is itself an alert
=============  ===========================================================

Lifecycle: a rule's condition must hold continuously for ``for_s``
before the rule **fires** (transients don't page), and must stay clear
for ``hold_down_s`` before it **resolves** (flapping doesn't page
twice).  Transitions are returned from :meth:`AlertEngine.evaluate` as
plain dicts matching the ``alert`` event schema (``rule`` / ``state`` /
``value`` / ``threshold`` / ``duration_s``), and the engine is a pure
function of the ``(samples, now)`` sequence it was shown — replaying a
scripted history produces byte-identical transitions, which is exactly
what ``tools/perf_gate.py`` gates.  Stdlib-only, jax-free.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from land_trendr_tpu_torch.obs.history import counter_rate, latest_value

__all__ = [
    "ALERT_KINDS",
    "ALERT_STATES",
    "DEFAULT_RULES",
    "PURE_MACHINES",
    "AlertEngine",
    "AlertRule",
    "load_rules",
    "parse_rules",
]

#: The observability-side pure decision machines, as ``(file, symbol)``
#: data — the other half of lt-lint LT009's registry (see
#: ``fleet/scheduling.py`` for the fleet half and the rationale).  The
#: alert lifecycle engine is replayed against scripted histories by the
#: perf gate; the event value-lint folds (``*_value_errors`` and the
#: stateful lint classes in ``tools/check_events_schema.py``) fold the
#: same stream to the same verdicts on every host, which is the same
#: purity obligation.  ``load_rules``/``parse_rules`` are deliberately
#: absent: loading a rules FILE is configuration, not a replayed
#: decision.
PURE_MACHINES = (
    ("land_trendr_tpu_torch/obs/alerts.py", "AlertEngine.evaluate"),
    ("land_trendr_tpu_torch/obs/alerts.py", "AlertEngine._rule_value"),
    ("land_trendr_tpu_torch/obs/alerts.py", "AlertEngine._transition"),
    ("tools/check_events_schema.py", "*_value_errors"),
    ("tools/check_events_schema.py", "FetchValueLint"),
    ("tools/check_events_schema.py", "TraceRefLint"),
    ("tools/check_events_schema.py", "AlertValueLint"),
)

ALERT_KINDS = ("threshold", "rate", "slo_burn", "absent")

#: the ``alert`` event's state vocabulary (value-linted by
#: ``tools/check_events_schema.py``)
ALERT_STATES = ("firing", "resolved")

_OPS = (">", ">=", "<", "<=")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declared rule (see the module docstring's kind table)."""

    name: str
    kind: str = "threshold"
    #: sample key: a flattened metric (``lt_serve_queue_depth``,
    #: ``lt_tiles_failed_total``...) or a sample health field
    #: (``stale_hosts``, ``corrupt_snaps``); ``slo_burn`` implies
    #: ``lt_slo_burn_rate``, ``absent`` defaults to ``stale_hosts``
    metric: str = ""
    op: str = ">"
    value: float = 0.0
    #: rate window (``rate``) / absence window (``absent``), seconds
    window_s: float = 60.0
    #: condition must hold this long before the rule fires
    for_s: float = 0.0
    #: condition must stay clear this long before the rule resolves
    hold_down_s: float = 0.0

    def __post_init__(self) -> None:
        if not self.name or not isinstance(self.name, str):
            raise ValueError("alert rule needs a non-empty string name")
        if self.kind not in ALERT_KINDS:
            raise ValueError(
                f"rule {self.name!r}: kind {self.kind!r} not one of "
                f"{ALERT_KINDS}"
            )
        if self.op not in _OPS:
            raise ValueError(
                f"rule {self.name!r}: op {self.op!r} not one of {_OPS}"
            )
        if self.kind in ("threshold", "rate") and not self.metric:
            raise ValueError(
                f"rule {self.name!r}: kind {self.kind!r} needs a metric"
            )
        if self.window_s <= 0:
            raise ValueError(
                f"rule {self.name!r}: window_s={self.window_s} must be > 0"
            )
        if self.for_s < 0 or self.hold_down_s < 0:
            raise ValueError(
                f"rule {self.name!r}: for_s/hold_down_s must be >= 0"
            )

    @property
    def resolved_metric(self) -> str:
        if self.kind == "slo_burn":
            return "lt_slo_burn_rate"
        if self.kind == "absent":
            return self.metric or "stale_hosts"
        return self.metric


def parse_rules(spec: "list | dict | str") -> "tuple[AlertRule, ...]":
    """Rule declarations → validated rules.

    Accepts the parsed JSON (a list of rule objects, or ``{"rules":
    [...]}``) or the JSON text itself.  Raises ``ValueError`` on any
    typo — an unknown key, kind or op is a config error at startup,
    never a dead rule discovered after the incident.
    """
    if isinstance(spec, str):
        try:
            spec = json.loads(spec)
        except json.JSONDecodeError as e:
            raise ValueError(f"alert rules are not valid JSON: {e}") from None
    if isinstance(spec, dict):
        spec = spec.get("rules")
    if not isinstance(spec, list):
        raise ValueError(
            "alert rules must be a JSON list of rule objects (or "
            '{"rules": [...]})'
        )
    known = {f.name for f in dataclasses.fields(AlertRule)}
    rules: list = []
    for i, item in enumerate(spec):
        if not isinstance(item, dict):
            raise ValueError(f"alert rule #{i} is not a JSON object")
        unknown = sorted(set(item) - known)
        if unknown:
            raise ValueError(
                f"alert rule #{i} ({item.get('name', '?')}): unknown "
                f"key(s) {unknown}"
            )
        rules.append(AlertRule(**item))
    names = [r.name for r in rules]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise ValueError(f"duplicate alert rule name(s): {dupes}")
    return tuple(rules)


def load_rules(path: str) -> "tuple[AlertRule, ...]":
    """Parse a rules file (JSON, see :func:`parse_rules`)."""
    with open(path) as f:
        return parse_rules(f.read())


#: the rules every fleet loop ships with unless a rules file overrides
#: them: a host going stale/dark, and a burning SLO budget
DEFAULT_RULES: "tuple[AlertRule, ...]" = (
    AlertRule(
        name="fleet_host_stale",
        kind="absent",
        window_s=60.0,
        hold_down_s=10.0,
    ),
    AlertRule(
        name="slo_burn_high",
        kind="slo_burn",
        op=">=",
        value=0.5,
        for_s=0.0,
        hold_down_s=30.0,
    ),
)


def _compare(value: float, op: str, threshold: float) -> bool:
    if op == ">":
        return value > threshold
    if op == ">=":
        return value >= threshold
    if op == "<":
        return value < threshold
    return value <= threshold


class AlertEngine:
    """Per-rule firing → resolved state machine over history samples.

    Single-owner like the history ring (one fleet loop evaluates; other
    threads read :meth:`active` snapshots the owner refreshed).  All
    timing comes from the caller's ``now`` and the samples' own ``t``
    stamps — no internal clock reads — so a scripted history replays to
    identical transitions.
    """

    def __init__(self, rules: "tuple[AlertRule, ...]" = DEFAULT_RULES) -> None:
        self.rules = tuple(rules)
        # phase: "ok" | "pending" | "firing" ; pending_since / fired_t /
        # clear_since are the lifecycle clocks
        self._state: dict = {
            r.name: {
                "phase": "ok",
                "pending_since": None,
                "fired_t": None,
                "clear_since": None,
                "value": None,
            }
            for r in self.rules
        }

    # -- condition evaluation ----------------------------------------------
    def _rule_value(
        self, rule: AlertRule, samples: list, now: float
    ) -> "tuple[float | None, bool]":
        """``(observed value, condition holds)`` for one rule."""
        key = rule.resolved_metric
        if rule.kind == "rate":
            v = counter_rate(samples, key, rule.window_s, now=now)
            return v, v is not None and _compare(v, rule.op, rule.value)
        if rule.kind == "absent":
            recent = [
                s for s in samples
                if isinstance(s.get("t"), (int, float))
                and s["t"] >= now - rule.window_s
            ]
            if not recent:
                # the plane itself is dark: no sample in the window
                return None, True
            v = latest_value(recent, key)
            # the declared op/value are honored (defaults `> 0` — one
            # stale host fires), not a hardcoded bound: a rule asking
            # for `corrupt_snaps >= 3` must page at 3, never silently 1
            return v, v is not None and _compare(v, rule.op, rule.value)
        v = latest_value(samples, key)  # threshold | slo_burn
        return v, v is not None and _compare(v, rule.op, rule.value)

    # -- the lifecycle -----------------------------------------------------
    def evaluate(self, samples: list, now: float) -> list:
        """Advance every rule against the history; returns this
        evaluation's transitions (``alert``-event-shaped dicts), firing
        first, in rule order."""
        transitions: list = []
        for rule in self.rules:
            st = self._state[rule.name]
            value, cond = self._rule_value(rule, samples, now)
            st["value"] = value
            if cond:
                st["clear_since"] = None
                if st["phase"] == "ok":
                    st["phase"] = "pending"
                    st["pending_since"] = now
                if st["phase"] == "pending" and (
                    now - st["pending_since"] >= rule.for_s
                ):
                    st["phase"] = "firing"
                    st["fired_t"] = now
                    transitions.append(self._transition(
                        rule, "firing", value,
                        duration_s=now - st["pending_since"],
                    ))
            else:
                if st["phase"] == "pending":
                    st["phase"] = "ok"
                    st["pending_since"] = None
                elif st["phase"] == "firing":
                    if st["clear_since"] is None:
                        st["clear_since"] = now
                    if now - st["clear_since"] >= rule.hold_down_s:
                        transitions.append(self._transition(
                            rule, "resolved", value,
                            duration_s=now - st["fired_t"],
                        ))
                        st.update(
                            phase="ok", pending_since=None, fired_t=None,
                            clear_since=None,
                        )
        return transitions

    def _transition(
        self, rule: AlertRule, state: str, value: "float | None",
        duration_s: float,
    ) -> dict:
        return {
            "rule": rule.name,
            "state": state,
            "value": round(float(value), 6) if value is not None else 0.0,
            "threshold": float(rule.value),
            "duration_s": round(max(0.0, duration_s), 6),
            "window_s": float(rule.window_s),
        }

    def active(self) -> list:
        """Currently-firing rules (JSON-safe snapshots for ``/healthz``,
        the publisher's ``state.alerts`` block and ``lt top``)."""
        out: list = []
        for rule in self.rules:
            st = self._state[rule.name]
            if st["phase"] == "firing":
                out.append({
                    "rule": rule.name,
                    "state": "firing",
                    "since_t": st["fired_t"],
                    "value": st["value"],
                    "threshold": float(rule.value),
                })
        return out
