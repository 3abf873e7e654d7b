"""Compile goals: objectives and constraints as first-class values.

The paper's formulation (§4.2) is the *primal* scenario — minimize
energy subject to a periodic deadline — given as :class:`MinEnergy`
(``deadline_s`` or ``rate_hz``).  ``compile(specs, goal, ...)``
(:mod:`repro_torch.core.orchestrator`) returns a
:class:`~repro_torch.core.schedule.PowerSchedule` or, when no schedule
exists, a structured :class:`InfeasibleGoal`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class MinEnergy:
    """Minimize energy subject to a hard per-inference deadline (§4.2).

    Exactly one of ``deadline_s`` / ``rate_hz`` must be given; the
    paper's periodic form ``rate_hz=r`` is the deadline ``1/r``.
    """

    deadline_s: float | None = None
    rate_hz: float | None = None

    def __post_init__(self) -> None:
        if (self.deadline_s is None) == (self.rate_hz is None):
            raise ValueError(
                "MinEnergy takes exactly one of deadline_s= / rate_hz=")
        val = self.deadline_s if self.deadline_s is not None \
            else self.rate_hz
        if not (val > 0.0):
            raise ValueError(f"MinEnergy needs a positive deadline/rate, "
                             f"got {val!r}")

    @property
    def deadline(self) -> float:
        """The resolved deadline T_max [s] (``1/rate_hz``)."""
        if self.deadline_s is not None:
            return float(self.deadline_s)
        return 1.0 / self.rate_hz

    binding = "deadline"

    def describe(self) -> dict[str, Any]:
        return {"type": "min_energy", "deadline_s": self.deadline}


def as_goal(obj) -> MinEnergy:
    """Validate a goal argument (clear error instead of duck-typed
    failures deep in the pipeline)."""
    if isinstance(obj, MinEnergy):
        return obj
    raise TypeError(f"goal must be a MinEnergy value, got {obj!r}")


# ------------------------------------------------- structured infeasible

#: machine-readable reasons: the deadline provably lies below the
#: network's min-time, or the policy found no schedule although the goal
#: is not provably impossible
REASON_DEADLINE = "deadline_below_min_time"
REASON_POLICY = "policy_found_no_schedule"


@dataclasses.dataclass(frozen=True)
class InfeasibleGoal:
    """Structured "compiled and found impossible" result.

    ``reason`` is :data:`REASON_DEADLINE` or :data:`REASON_POLICY`;
    ``detail`` carries the requested deadline and the network's min-time
    lower bound, so callers can tell a hopeless constraint from a
    solvable one.
    """

    reason: str
    goal: dict[str, Any]
    detail: dict[str, Any] = dataclasses.field(default_factory=dict)
    network: str = "net"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "InfeasibleGoal":
        return cls(**json.loads(text))

    def summary(self) -> str:
        parts = ", ".join(f"{k}={v:.4g}" if isinstance(v, float) else
                          f"{k}={v}" for k, v in self.detail.items())
        return (f"InfeasibleGoal[{self.reason}] {self.network}: "
                f"{self.goal}  ({parts})")
