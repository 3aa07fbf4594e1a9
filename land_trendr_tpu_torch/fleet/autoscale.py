"""SLO-driven autoscaler: the burn-rate signal → bounded scale actions.

The decision core of the fleet router's autoscaling, deliberately split
from the router so it is a **pure function of the observations it is
shown** — the same property :class:`~land_trendr_tpu_torch.obs.alerts.
AlertEngine` has, because the conditions ARE alert rules: ``scale_up``
fires when the pod ``lt_slo_burn_rate`` (the serve SLO signal, folded
from replica snapshots by ``obs.aggregate.fold_dir``) holds at or above
``scale_up_burn`` for ``scale_for_s``; ``scale_down`` when it holds at
or below ``scale_down_burn``.  On top of the rule lifecycle this class
adds the ACTUATOR discipline the rules cannot express:

* **bounds** — never below ``min_replicas`` or above ``max_replicas``;
* **hold-down** — at most one action per ``scale_hold_s`` window, so a
  burn spike cannot flap the pool;
* **quiesce gate** — scale-down additionally requires an empty router
  queue (shrinking a backlogged fleet only moves the burn up).

All timing comes from the caller's ``now`` — no internal clock reads —
so a scripted burn-rate history replays to byte-identical decisions,
which is exactly what ``tests/test_torch_route.py`` pins against the JAX
package's autoscaler.  Stdlib-only.
"""

from __future__ import annotations

from land_trendr_tpu_torch.obs.alerts import AlertEngine, AlertRule

__all__ = ["Autoscaler"]

#: the sample key the decision rules evaluate (the pod-max fold of the
#: per-replica burn gauges — obs.aggregate's GAUGE default policy)
BURN_METRIC = "lt_slo_burn_rate"


class Autoscaler:
    """Deterministic scale-decision state machine (see module doc).

    Single-owner like :class:`~land_trendr_tpu_torch.obs.alerts.AlertEngine`:
    the router's control loop calls :meth:`decide` each beat; other
    threads read :meth:`state` snapshots the owner refreshed (the
    router serializes both under its lock).
    """

    def __init__(
        self,
        *,
        min_replicas: int,
        max_replicas: int,
        up_burn: float,
        down_burn: float,
        for_s: float = 0.0,
        hold_s: float = 30.0,
    ) -> None:
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.hold_s = float(hold_s)
        self.engine = AlertEngine((
            AlertRule(
                name="scale_up", kind="threshold", metric=BURN_METRIC,
                op=">=", value=float(up_burn), for_s=float(for_s),
            ),
            AlertRule(
                name="scale_down", kind="threshold", metric=BURN_METRIC,
                op="<=", value=float(down_burn), for_s=float(for_s),
            ),
        ))
        self._last_action_t: "float | None" = None
        self._last_burn: "float | None" = None
        self._decisions = 0

    def decide(
        self,
        burn: "float | None",
        queue_depth: int,
        replicas: int,
        now: float,
    ) -> "str | None":
        """Advance the rules with one observation; return ``"up"`` /
        ``"down"`` / ``None``.

        ``burn`` is the pod burn rate (``None`` — a dark telemetry
        plane — advances nothing: scaling blind is worse than holding),
        ``queue_depth`` the router's unsent queue, ``replicas`` the
        CURRENT spawned-pool size the bounds apply to.
        """
        self._last_burn = burn
        self._decisions += 1
        if burn is None:
            return None
        self.engine.evaluate(
            [{"t": now, "metrics": {BURN_METRIC: float(burn)}}], now
        )
        active = {a["rule"] for a in self.engine.active()}
        held = (
            self._last_action_t is not None
            and now - self._last_action_t < self.hold_s
        )
        if held:
            return None
        if "scale_up" in active and replicas < self.max_replicas:
            self._last_action_t = now
            return "up"
        if (
            "scale_down" in active
            and queue_depth == 0
            and replicas > self.min_replicas
        ):
            self._last_action_t = now
            return "down"
        return None

    def state(self) -> dict:
        """JSON-safe snapshot for ``/healthz`` and the router's fleet
        snapshot (``lt top`` / ``lt_fleet`` render it)."""
        return {
            "burn": self._last_burn,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "hold_s": self.hold_s,
            "last_action_t": self._last_action_t,
            "decisions": self._decisions,
            "firing": sorted(a["rule"] for a in self.engine.active()),
        }
