"""Compile goals: objectives and constraints as first-class values.

The paper's formulation (§4.2) is the *primal* scenario — minimize
energy subject to a periodic deadline — and the pre-goal API hardwired
it (``compile_power_schedule(specs, target_rate_hz)``).  Real
deployments also ask the *dual* question (fastest inference under a
battery/energy budget) and often want the whole energy–latency
tradeoff curve per network.  The λ-parameterized DP (``E + λT``)
already contains the machinery for all three; these goal values make
them reachable through one entry point:

  - :class:`MinEnergy` — today's behaviour, bit-identical: min energy
    s.t. ``T_infer ≤ deadline`` (given either as ``deadline_s`` or as
    ``rate_hz``, the paper's periodic-inference form);
  - :class:`MinLatency` — the dual: min ``T_infer`` s.t.
    ``E_op + E_trans ≤ energy_budget_j`` (no deadline, so no terminal
    idle interval exists and the budget covers the pure inference
    energy);
  - :class:`ParetoFront` — the frontier: one MinEnergy point per
    deadline, co-scheduled as stacked sweeps so the whole curve costs
    little more than one compile.

``compile(specs, goal, ...)`` (:mod:`repro_torch.core.orchestrator`)
returns a :class:`~repro_torch.core.schedule.PowerSchedule`, a
structured :class:`InfeasibleGoal` (never a bare ``None`` — the
``compile_power_schedule`` wrapper keeps ``None``), or a
:class:`ParetoFrontier`.
"""

from __future__ import annotations

import dataclasses
import json
from typing import TYPE_CHECKING, Any, Union

import numpy as np

if TYPE_CHECKING:                                       # pragma: no cover
    from repro_torch.core.schedule import PowerSchedule


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
        """The resolved deadline T_max [s] (``1/rate_hz`` uses the same
        float division the legacy entry point performed, so goal-built
        contexts are bit-identical to rate-built ones)."""
        if self.deadline_s is not None:
            return float(self.deadline_s)
        return 1.0 / self.rate_hz

    binding = "deadline"

    def describe(self) -> dict[str, Any]:
        return {"type": "min_energy", "deadline_s": self.deadline}

    def key(self) -> str:
        """Deterministic schedule-cache key component (float repr
        round-trips exactly)."""
        return f"min_energy|{self.deadline!r}"


@dataclasses.dataclass(frozen=True)
class MinLatency:
    """Minimize inference latency subject to an energy budget (the dual).

    The budget bounds the *inference* energy ``E_op + E_trans``: with no
    deadline there is no terminal idle interval, so the emitted schedule
    carries ``t_max == t_infer`` (zero slack, ``e_idle == 0``) and the
    energy budget is the binding constraint.
    """

    energy_budget_j: float

    def __post_init__(self) -> None:
        if not (self.energy_budget_j > 0.0):
            raise ValueError(
                f"MinLatency needs a positive energy budget, got "
                f"{self.energy_budget_j!r}")

    binding = "energy_budget"

    def describe(self) -> dict[str, Any]:
        return {"type": "min_latency",
                "energy_budget_j": float(self.energy_budget_j)}

    def key(self) -> str:
        return f"min_latency|{float(self.energy_budget_j)!r}"


# deadline grid for ParetoFront(n_points=N): deadlines span the fastest
# deployable point (~95 % of the min-time bound's rate) down to a
# deeply relaxed one (30 %), evenly in rate fraction — the operating
# band the paper sweeps in fig. 5
_FRONTIER_FRAC_HI = 0.95
_FRONTIER_FRAC_LO = 0.30


@dataclasses.dataclass(frozen=True)
class ParetoFront:
    """The energy–latency frontier: one :class:`MinEnergy` point per
    deadline, compiled as co-scheduled stacked sweeps.

    Give explicit ``deadlines`` (seconds, any order — points come back
    sorted ascending), or ``n_points=N`` to span rate fractions
    0.95…0.30 of the network's min-time bound automatically.
    """

    n_points: int | None = None
    deadlines: tuple[float, ...] | None = None

    def __post_init__(self) -> None:
        if (self.n_points is None) == (self.deadlines is None):
            raise ValueError(
                "ParetoFront takes exactly one of n_points= / deadlines=")
        if self.n_points is not None and self.n_points < 2:
            raise ValueError(
                f"a frontier needs at least 2 points, got {self.n_points}")
        if self.deadlines is not None:
            dl = tuple(float(d) for d in self.deadlines)
            if len(dl) < 1 or any(d <= 0.0 for d in dl):
                raise ValueError(
                    f"ParetoFront deadlines must be positive, got "
                    f"{self.deadlines!r}")
            object.__setattr__(self, "deadlines", tuple(sorted(dl)))

    binding = "frontier"

    def resolve_deadlines(self, min_time_s: float) -> tuple[float, ...]:
        """The frontier's deadline grid, ascending.  ``min_time_s`` is a
        lower bound on any schedule's latency (the rate-fraction grid
        anchors on it; ignored when deadlines are explicit)."""
        if self.deadlines is not None:
            return self.deadlines
        fracs = np.linspace(_FRONTIER_FRAC_HI, _FRONTIER_FRAC_LO,
                            self.n_points)
        return tuple(sorted(float(min_time_s / f) for f in fracs))

    def describe(self) -> dict[str, Any]:
        if self.deadlines is not None:
            return {"type": "pareto_front",
                    "deadlines": list(self.deadlines)}
        return {"type": "pareto_front", "n_points": self.n_points}

    def key(self) -> str:
        if self.deadlines is not None:
            return f"pareto|{self.deadlines!r}"
        return f"pareto|n{self.n_points}"


Goal = Union[MinEnergy, MinLatency, ParetoFront]


def as_goal(obj: Goal) -> Goal:
    """Validate a goal argument (clear error instead of duck-typed
    failures deep in the pipeline)."""
    if isinstance(obj, (MinEnergy, MinLatency, ParetoFront)):
        return obj
    raise TypeError(
        f"goal must be a MinEnergy, MinLatency, or ParetoFront value, "
        f"got {obj!r}")


# ------------------------------------------------- structured infeasible

#: machine-readable reasons: the two ways a point goal is *provably*
#: impossible (the constraint lies below the network's bound), plus the
#: honest fallback for "the chosen policy found no schedule" — a
#: heuristic policy (greedy ascent, ILP at its time limit) can fail on
#: a feasible goal, and labelling that provably-impossible would send
#: callers renegotiating a constraint that was never the problem
REASON_DEADLINE = "deadline_below_min_time"
REASON_BUDGET = "budget_below_min_energy"
REASON_POLICY = "policy_found_no_schedule"


@dataclasses.dataclass(frozen=True)
class InfeasibleGoal:
    """Structured "compiled and provably impossible" result.

    ``reason`` is :data:`REASON_DEADLINE` (the deadline provably lies
    below the network's min-time even at V_max), :data:`REASON_BUDGET`
    (the budget provably lies below the minimum inference energy), or
    :data:`REASON_POLICY` (the chosen policy found no schedule even
    though the goal is not provably impossible — e.g. a greedy ascent
    that missed, or an ILP at its time limit).  ``detail`` carries the
    requested value plus the relevant lower bound, so callers can tell
    a hopeless constraint from a solvable one.  The
    ``compile_power_schedule`` wrapper returns ``None`` instead.
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


# ------------------------------------------------------ frontier result

@dataclasses.dataclass
class ParetoPoint:
    """One deadline of a compiled frontier."""

    deadline_s: float
    schedule: "PowerSchedule | InfeasibleGoal"

    @property
    def feasible(self) -> bool:
        return not isinstance(self.schedule, InfeasibleGoal)


@dataclasses.dataclass
class ParetoFrontier:
    """A compiled energy–latency frontier: per-point schedules identical
    to independent :class:`MinEnergy` compiles at those deadlines (the
    co-scheduled sweeps only change how kernel launches are grouped)."""

    network: str
    points: list[ParetoPoint]

    def schedules(self) -> list["PowerSchedule | InfeasibleGoal"]:
        return [p.schedule for p in self.points]

    def feasible_points(self) -> list[ParetoPoint]:
        return [p for p in self.points if p.feasible]

    def summary(self) -> str:
        lines = [f"ParetoFrontier {self.network}: {len(self.points)} "
                 f"points ({len(self.feasible_points())} feasible)"]
        for p in self.points:
            if p.feasible:
                s = p.schedule
                lines.append(
                    f"  T_max={p.deadline_s*1e3:8.3f}ms  "
                    f"E={s.e_total*1e6:8.2f}uJ  "
                    f"T={s.t_infer*1e3:8.3f}ms  rails={s.rails}")
            else:
                lines.append(
                    f"  T_max={p.deadline_s*1e3:8.3f}ms  infeasible "
                    f"({p.schedule.reason})")
        return "\n".join(lines)
