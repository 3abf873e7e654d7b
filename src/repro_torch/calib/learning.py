"""Learned per-layer cost corrections (the calibration subsystem's
model half).

The compiler's :mod:`repro_torch.perfmodel.layer_costs` is a static analytic
model; real silicon drifts (temperature, process, input-dependent
work — SparseDVFS).  This module turns *evidence* about the true costs
into a :class:`CalibratedCostModel` the compiler can solve under:

  - :class:`CalibratedCostModel` — a frozen per-layer work multiplier
    applied on top of the static characterization.  A scale of ``s``
    on layer ``i`` multiplies both its cycle counts and its dynamic
    energies, matching the runtime fault semantics exactly ("more
    cycles at the same state", see
    :meth:`~repro_torch.serve.power_runtime.PowerRuntime.execute_interval`).
    Its ``digest`` is folded into every artifact key a compile under
    it produces (:class:`~repro_torch.core.context.CompilationContext`), so
    calibrated and static schedules never collide in a shared store.
  - :class:`ResidualEstimator` — windowed per-layer ratios of executed
    vs predicted op time from the serving runtime's
    :class:`~repro_torch.serve.power_runtime.IntervalLedger`s.  The median
    over the window is robust to the lognormal per-interval noise the
    fault model injects; ``estimate()`` withholds judgement until
    ``min_samples`` intervals have been observed.

The adaptive control plane (:mod:`repro_torch.serve.control_plane`) feeds
executed ledgers into an estimator and, when the estimate diverges
from the correction it is currently serving under, re-solves its
contingency set under ``model_from_residuals(...)`` — re-centering on
the drift instead of permanently paying tightened-headroom energy.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.context import _digest
from repro_torch.perfmodel.layer_costs import LayerCost


def _round_scale(values, ndigits: int = 3) -> tuple[float, ...]:
    """Quantize a scale vector (0.1% granularity by default) so jittery
    estimates map to a handful of distinct digests instead of
    fragmenting the artifact store with one key per float ulp."""
    return tuple(round(float(v), ndigits) for v in values)


@dataclasses.dataclass(frozen=True)
class CalibratedCostModel:
    """Per-layer multiplicative correction over the static analytic
    characterization.

    ``scale[i]`` multiplies layer ``i``'s work: every domain's cycle
    count and dynamic energy scales together (the runtime's
    ``op_scale`` fault semantics — time and energy move together when
    the work estimate was wrong).  ``source`` records provenance
    ("harness" / "ledger" / "sparsity:<band>" ...) for diagnostics; it
    is part of the digest, so models learned by different routes never
    alias even at equal scales.
    """

    scale: tuple[float, ...]
    source: str = "learned"

    def __post_init__(self) -> None:
        if not self.scale:
            raise ValueError("CalibratedCostModel needs >= 1 layer")
        if any(not (s > 0.0) for s in self.scale):
            raise ValueError(
                f"cost-model scales must be positive, got {self.scale}")

    @property
    def digest(self) -> str:
        return _digest("calibrated_cost_model", repr(self.scale),
                       self.source)

    def apply(self, costs: Sequence[LayerCost]) -> list[LayerCost]:
        """The corrected characterization (float cycle counts are fine:
        every consumer divides by a frequency)."""
        if len(costs) != len(self.scale):
            raise ValueError(
                f"cost model covers {len(self.scale)} layers but the "
                f"network has {len(costs)}")
        out = []
        for c, s in zip(costs, self.scale):
            if s == 1.0:
                out.append(c)
                continue
            out.append(dataclasses.replace(
                c,
                cycles=tuple(cyc * s for cyc in c.cycles),
                dyn_energy_nom=tuple(e * s for e in c.dyn_energy_nom)))
        return out

    def max_deviation(self, other: "CalibratedCostModel | None" = None
                      ) -> float:
        """Largest per-layer relative gap to ``other`` (or to the
        static model when None) — the control plane's recalibration
        trigger metric."""
        ref = other.scale if other is not None \
            else (1.0,) * len(self.scale)
        return max(abs(s / r - 1.0) for s, r in zip(self.scale, ref))


def identity_model(n_layers: int,
                   source: str = "identity") -> CalibratedCostModel:
    return CalibratedCostModel(scale=(1.0,) * n_layers, source=source)


class ResidualEstimator:
    """Windowed per-layer executed/predicted op-time ratios.

    ``observe(executed, predicted)`` takes two per-layer ledgers of the
    *same schedule* — the executed one from the live interval, the
    predicted one from a fault-free replay — and records the per-layer
    time ratio.  Because the runtime scales a faulted layer's time and
    energy by one factor, this ratio *is* the layer's true work scale
    for that interval (bias × noise); the windowed median estimates
    the bias.  Layers whose predicted time is ~0 (fully gated /
    zero-cost) carry no signal and are pinned to ratio 1.
    """

    def __init__(self, n_layers: int, *, window: int = 32,
                 min_samples: int = 12):
        if n_layers < 1:
            raise ValueError(
                f"ResidualEstimator needs n_layers >= 1, got {n_layers}")
        if min_samples < 1 or window < min_samples:
            raise ValueError(
                f"need 1 <= min_samples <= window, got "
                f"min_samples={min_samples} window={window}")
        self.n_layers = int(n_layers)
        self.min_samples = int(min_samples)
        self._win: collections.deque[np.ndarray] = collections.deque(
            maxlen=window)

    @property
    def n(self) -> int:
        return len(self._win)

    def clear(self) -> None:
        self._win.clear()

    def observe(self, executed, predicted) -> None:
        """Record one interval's per-layer ratios from two
        :class:`~repro_torch.serve.power_runtime.IntervalLedger`s (or any
        objects with per-layer ``.layers[i].t_op``)."""
        ex = np.array([l.t_op for l in executed.layers], dtype=float)
        pr = np.array([l.t_op for l in predicted.layers], dtype=float)
        if ex.shape != (self.n_layers,) or pr.shape != (self.n_layers,):
            raise ValueError(
                f"ledger layer count mismatch: executed {ex.shape}, "
                f"predicted {pr.shape}, expected ({self.n_layers},)")
        ratio = np.ones(self.n_layers)
        live = pr > 0.0
        ratio[live] = ex[live] / pr[live]
        self._win.append(ratio)

    def estimate(self) -> np.ndarray | None:
        """Per-layer median ratio over the window, or None until
        ``min_samples`` intervals have been observed."""
        if len(self._win) < self.min_samples:
            return None
        return np.median(np.stack(self._win), axis=0)


def model_from_residuals(estimate: np.ndarray, *,
                         source: str = "ledger",
                         clamp: tuple[float, float] = (0.25, 4.0)
                         ) -> CalibratedCostModel:
    """A :class:`CalibratedCostModel` from an estimator's per-layer
    ratio vector, clamped to a sane band (a wild single-window estimate
    must not compile an absurd schedule) and quantized so near-equal
    estimates share one digest."""
    lo, hi = clamp
    scale = _round_scale(np.clip(np.asarray(estimate, float), lo, hi))
    return CalibratedCostModel(scale=scale, source=source)
