"""Voltage/frequency scaling and power-state transition models.

The paper (§5.2) derives voltage-frequency scaling from SPICE
characterization of an FO4-loaded ring oscillator in TSMC 40nm LP and uses
a first-order voltage-frequency energy model.  We reproduce that with the
standard alpha-power delay law:

    f(V) ∝ (V - V_th)^alpha / V

normalized so that f(V_nom) equals the domain's nominal clock.  Dynamic
energy per event scales as C·V² (first order); leakage power follows a
first-order V·exp(beta·(V - V_nom)) model (DIBL-ish slope), and is zero in
a gated state.

Transition costs (§5.2): worst-case 15 ns for a DVFS rail switch, 5 ns for
memory wake-up; transition energy E_switch = C_dom·(V_high² - V_low²) with
a 1 nJ nominal value at the full voltage swing, swept 0.1 nJ–1 µJ for
sensitivity.  Transitions do not overlap with computation (§4.1).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Sequence

# Gated state sentinel: a domain "voltage" of 0.0 means power-gated.
V_GATED = 0.0


@dataclasses.dataclass(frozen=True)
class DvfsModel:
    """Alpha-power-law DVFS model for one voltage/frequency domain."""

    v_nom: float = 1.1          # nominal supply [V]
    v_th: float = 0.35          # effective threshold [V]
    alpha: float = 1.35         # alpha-power exponent (40nm LP short channel)
    f_nom: float = 500e6        # frequency at v_nom [Hz]
    leak_nom: float = 1.0e-3    # leakage power at v_nom, active [W]
    leak_beta: float = 2.2      # leakage voltage sensitivity [1/V]

    def freq(self, v: float) -> float:
        """Max operating frequency at supply ``v`` [Hz]; 0 when gated."""
        if v <= self.v_th:
            return 0.0
        scale = ((v - self.v_th) ** self.alpha / v) / (
            (self.v_nom - self.v_th) ** self.alpha / self.v_nom
        )
        return self.f_nom * scale

    def dyn_energy_scale(self, v: float) -> float:
        """Per-event dynamic energy multiplier vs nominal (∝ V²)."""
        return (v / self.v_nom) ** 2

    def leak_power(self, v: float) -> float:
        """Static leakage power at supply ``v`` [W]; 0 when gated."""
        if v <= V_GATED:
            return 0.0
        return self.leak_nom * (v / self.v_nom) * math.exp(
            self.leak_beta * (v - self.v_nom)
        )


@dataclasses.dataclass(frozen=True)
class TransitionModel:
    """Pairwise power-state transition latency/energy (paper §5.2).

    Asymmetric and domain-dependent behaviour is supported: rail switches
    cost ``t_rail`` regardless of direction, waking a gated domain costs
    ``t_wake``; gating a domain is assumed free in time (isolation clamps)
    but charged the residual switching energy.  ``e_switch_nom`` is the
    energy of a full-swing rail transition (V_min → V_max); actual energy
    follows C·(V_hi² − V_lo²) scaled to that nominal point.
    """

    t_rail: float = 15e-9       # DVFS rail switch latency [s]
    t_wake: float = 5e-9        # memory wake-up latency [s]
    e_switch_nom: float = 1e-9  # nominal full-swing transition energy [J]
    v_min: float = 0.9
    v_max: float = 1.3

    def _cap_scale(self) -> float:
        """Effective C such that full-swing transition == e_switch_nom."""
        swing = self.v_max**2 - self.v_min**2
        return self.e_switch_nom / swing if swing > 0 else 0.0

    def latency(self, v_from: float, v_to: float) -> float:
        if v_from == v_to:
            return 0.0
        if v_from == V_GATED:          # wake from gated
            return self.t_wake
        if v_to == V_GATED:            # gate: clamp, no stall
            return 0.0
        return self.t_rail             # rail-to-rail switch

    def energy(self, v_from: float, v_to: float) -> float:
        if v_from == v_to:
            return 0.0
        c = self._cap_scale()
        hi, lo = max(v_from, v_to), min(v_from, v_to)
        if lo == V_GATED:
            # wake (charge 0→V) or gate (recover nothing): charge C·V²
            return c * hi**2
        return c * (hi**2 - lo**2)


def voltage_levels(v_min: float = 0.9, v_max: float = 1.3,
                   step: float = 0.05) -> tuple[float, ...]:
    """Discretized candidate voltage set V (paper §4.2: uniform ΔV)."""
    n = int(round((v_max - v_min) / step)) + 1
    return tuple(round(v_min + i * step, 4) for i in range(n))


def rail_subsets(levels: Sequence[float], n_max: int):
    """All rail subsets R ⊆ V with 1 ≤ |R| ≤ N_max (paper §4.2)."""
    for k in range(1, n_max + 1):
        yield from itertools.combinations(levels, k)
