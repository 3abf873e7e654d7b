"""The compiled power-schedule artifact (paper §3.3).

"The resulting voltage assignments and memory-gating decisions are
compiled and programmed into the on-chip memory as a static schedule,
along with the layer definitions used during run-time execution, while
the pg_manager manages the inter-layer fine-grained memory-gating
schedules."

:class:`PowerSchedule` is that artifact: per-layer domain voltages, the
bank-gating timeline, the duty-cycle decision, energy/latency breakdown,
and a ``program()`` method that emits the register-write stream a
pg_manager would consume.  It serializes to JSON for deployment and for
the serving runtime (serve/power_runtime.py).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

from repro_torch.hw.edge40nm import DOMAINS

#: serialized-payload schema version.  Mirrors the DiskTier STORE_META
#: policy: every ``to_json`` payload carries its schema, and payloads
#: from an unknown *newer* schema refuse loudly instead of misreading.
#: Pre-versioning payloads (no ``schema`` field) migrate through the
#: legacy shim in :meth:`PowerSchedule.from_json`.
SCHEDULE_SCHEMA = 1
READABLE_SCHEDULE_SCHEMAS = (1,)

_REQUIRED_FIELDS = frozenset({
    "policy", "network", "rails", "layer_voltages", "awake_banks",
    "t_max", "t_infer", "e_total", "e_op", "e_trans", "e_idle",
    "z_active_idle", "n_rail_switches", "feasible",
})
#: fields added after the first serialized artifacts shipped — absent
#: in legacy payloads, filled from the dataclass defaults on load
_OPTIONAL_FIELDS = frozenset({
    "solver_stats", "domains", "goal", "binding_constraint",
    "cost_model",
})


@dataclasses.dataclass
class PowerSchedule:
    policy: str
    network: str
    rails: tuple[float, ...]
    # per layer: domain → voltage (0.0 = gated)
    layer_voltages: list[tuple[float, ...]]
    # per layer: number of awake memory banks
    awake_banks: list[int]
    t_max: float
    t_infer: float
    e_total: float
    e_op: float
    e_trans: float
    e_idle: float
    z_active_idle: int
    n_rail_switches: int
    feasible: bool
    solver_stats: dict[str, Any] = dataclasses.field(default_factory=dict)
    domains: tuple[str, ...] = DOMAINS
    # compile-goal provenance (goal API): the objective this artifact
    # was compiled for (``describe()`` dict of the goal value) and its
    # binding constraint ("deadline" | "energy_budget").  None on
    # artifacts emitted before the goal API / by direct policy calls.
    goal: dict[str, Any] | None = None
    binding_constraint: str | None = None
    # cost-model provenance: "static" for the analytic layer_costs
    # model (the only one this package compiles under); payloads from
    # calibrated compiles carry that model's digest.
    cost_model: str = "static"

    @property
    def energy_uj(self) -> float:
        return self.e_total * 1e6

    @property
    def slack(self) -> float:
        return self.t_max - self.t_infer

    def program(self) -> list[dict[str, Any]]:
        """Emit the static register-write stream (anchor, domain, value)."""
        prog: list[dict[str, Any]] = []
        prev: tuple[float, ...] | None = None
        for i, volts in enumerate(self.layer_voltages):
            for d, v in enumerate(volts):
                if prev is None or prev[d] != v:
                    prog.append({"anchor": i, "domain": self.domains[d],
                                 "op": "set_rail" if v > 0 else "gate",
                                 "value": v})
            prog.append({"anchor": i, "domain": "rram_banks",
                         "op": "awake_mask", "value": self.awake_banks[i]})
            prev = volts
        prog.append({"anchor": len(self.layer_voltages),
                     "domain": "chip",
                     "op": "idle" if self.z_active_idle else "deep_sleep",
                     "value": self.slack})
        return prog

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["schema"] = SCHEDULE_SCHEMA
        d["rails"] = list(self.rails)
        d["domains"] = list(self.domains)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "PowerSchedule":
        d = json.loads(text)
        if not isinstance(d, dict):
            raise ValueError(
                f"power-schedule payload must be a JSON object, "
                f"got {type(d).__name__}")
        schema = d.pop("schema", None)
        # migration shim: pre-versioning payloads carry no schema field
        # and are read as schema 1 (every schema-1 field they may lack
        # is optional and defaulted below)
        if schema is not None and schema not in READABLE_SCHEDULE_SCHEMAS:
            raise ValueError(
                f"power-schedule payload has schema {schema!r}; this "
                f"build reads {READABLE_SCHEDULE_SCHEMAS} — refusing "
                f"to misread a newer layout")
        unknown = set(d) - _REQUIRED_FIELDS - _OPTIONAL_FIELDS
        if unknown:
            raise ValueError(
                "power-schedule payload has unknown fields "
                f"{sorted(unknown)} (schema {schema!r})")
        missing = _REQUIRED_FIELDS - set(d)
        if missing:
            raise ValueError(
                "power-schedule payload is missing required fields "
                f"{sorted(missing)} (schema {schema!r})")
        d["rails"] = tuple(d["rails"])
        if "domains" in d:
            d["domains"] = tuple(d["domains"])
        d["layer_voltages"] = [tuple(v) for v in d["layer_voltages"]]
        return cls(**d)

    def summary(self) -> str:
        lines = [
            f"PowerSchedule[{self.policy}] {self.network}: "
            f"E={self.energy_uj:.2f}uJ  T={self.t_infer*1e3:.3f}ms"
            f"/{self.t_max*1e3:.3f}ms  rails={self.rails}  "
            f"switches={self.n_rail_switches}  "
            f"z={'active-idle' if self.z_active_idle else 'deep-sleep'}",
        ]
        if self.binding_constraint is not None:
            lines[0] += f"  binding={self.binding_constraint}"
        return "\n".join(lines)
