"""Input-adaptive schedule policy tables (SparseDVFS-style).

The static compiler solves for worst-case work per layer; real
inference work varies with a cheap runtime observable — activation
density after ReLU (SparseDVFS, PAPERS.md), batch size, sequence
length.  Instead of re-solving online, a deployment compiles a
*family* of schedules up front — one energy–latency frontier per
observable band, each band's solve run under the
:class:`~repro_torch.calib.learning.CalibratedCostModel` describing that
band's work — and serves a per-inference table lookup.

The whole family compiles as ONE ``compile_many`` fleet: every band's
ParetoFront contributes its sweeps to the same round scheduler
(requests under different cost models stack fine — their lanes are
keyed by per-model content keys), so a K-band × D-deadline table
costs one stacked batch, not K×D solo compiles — and is pinned
bit-identical to those solo compiles by the fleet-equivalence
guarantees of :mod:`repro_torch.core.rails`.

The serving side (:class:`~repro_torch.serve.control_plane.AdaptiveScheduler`
with ``policy_table=``) observes the current band each interval and
snaps among band frontiers exactly as it snaps among deadlines — a
fourth snap axis, never a blocking compile.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Sequence

from repro_torch.calib.learning import CalibratedCostModel, _round_scale
from repro_torch.core.goals import ParetoFront
from repro_torch.core.schedule import PowerSchedule
from repro_torch.perfmodel.layer_costs import LayerSpec

#: layer kinds whose work scales with activation density (MAC traffic);
#: data-movement-bound kinds (pool / eltwise) hold their cost
_MAC_KINDS = frozenset({"conv", "dwconv", "fc", "attn"})


def sparsity_cost_model(density: float, specs: Sequence[LayerSpec], *,
                        floor: float = 0.05,
                        source: str | None = None
                        ) -> CalibratedCostModel:
    """A cost model for one activation-density operating point:
    MAC-dominated layers scale their work by ``density`` (clamped to
    ``floor`` — control overhead never vanishes), movement-bound
    layers keep the static cost."""
    if not (0.0 < density):
        raise ValueError(f"density must be > 0, got {density!r}")
    if not (0.0 < floor <= 1.0):
        raise ValueError(f"floor must lie in (0, 1], got {floor!r}")
    s = max(float(density), floor)
    scale = _round_scale(
        s if spec.kind in _MAC_KINDS else 1.0 for spec in specs)
    return CalibratedCostModel(
        scale=scale,
        source=source if source is not None else f"sparsity:{s:.3f}")


@dataclasses.dataclass
class PolicyBand:
    """One observable band of the table: its half-open range
    ``[lo, hi)``, the cost model its schedules were compiled under, and
    its compiled deadline frontier."""

    lo: float
    hi: float
    cost_model: CalibratedCostModel
    schedules: dict[float, PowerSchedule]
    infeasible: list = dataclasses.field(default_factory=list)

    @property
    def mid(self) -> float:
        return 0.5 * (self.lo + self.hi)


class SchedulePolicyTable:
    """The compiled family: observable band → deadline frontier.

    ``lookup(observable, deadline)`` is the per-inference hot path —
    two bisects, no compile: clamp the observable into a band, then
    snap to the largest compiled deadline ≤ the requested one (the
    schedule provably meets the request) or the band's fastest point
    when the request is tighter than anything compiled.
    """

    def __init__(self, observable: str, bands: Sequence[PolicyBand]):
        if not bands:
            raise ValueError("SchedulePolicyTable needs >= 1 band")
        self.observable = observable
        self.bands = sorted(bands, key=lambda b: b.lo)
        for a, b in zip(self.bands, self.bands[1:]):
            if b.lo < a.hi:
                raise ValueError(
                    f"policy bands overlap: [{a.lo}, {a.hi}) and "
                    f"[{b.lo}, {b.hi})")
        self._los = [b.lo for b in self.bands]
        self._deadlines = {id(b): sorted(b.schedules) for b in self.bands}

    def band_for(self, observable: float) -> PolicyBand:
        """The band containing the observable (out-of-range values
        clamp to the nearest edge band)."""
        i = bisect.bisect_right(self._los, float(observable)) - 1
        return self.bands[max(i, 0)]

    def lookup(self, observable: float,
               deadline_s: float) -> PowerSchedule | None:
        band = self.band_for(observable)
        grid = self._deadlines[id(band)]
        if not grid:
            return None
        i = bisect.bisect_right(grid, float(deadline_s)) - 1
        return band.schedules[grid[max(i, 0)]]

    def deadlines(self) -> list[float]:
        """Union of the compiled deadline grids across bands."""
        return sorted({d for b in self.bands for d in b.schedules})


def compile_policy_table(
        svc, specs: Sequence[LayerSpec], *,
        band_edges: Sequence[float],
        deadlines: Sequence[float],
        observable: str = "density",
        model_for_band: Callable[[float], CalibratedCostModel]
        | None = None,
        cfg=None, network: str = "net") -> SchedulePolicyTable:
    """Compile a (band × deadline) schedule family through a
    :class:`~repro_torch.service.CompileService` as ONE fleet batch.

    ``band_edges`` are the observable's band boundaries (K+1 edges →
    K bands); each band's cost model comes from ``model_for_band``
    applied to the band midpoint (default:
    :func:`sparsity_cost_model`, treating the observable as activation
    density).  Every band issues one deadline-free ParetoFront request
    over ``deadlines``, and all bands' sweeps co-schedule in a single
    ``compile_many`` round scheduler.  Infeasible points land in the
    band's ``infeasible`` list rather than the table.
    """
    from repro_torch.service.compile_service import CompileRequest

    edges = [float(e) for e in band_edges]
    if len(edges) < 2 or any(b <= a for a, b in zip(edges, edges[1:])):
        raise ValueError(
            f"band_edges must be >= 2 strictly increasing values, got "
            f"{band_edges!r}")
    if not deadlines:
        raise ValueError("compile_policy_table needs >= 1 deadline")
    if model_for_band is None:
        model_for_band = lambda mid: sparsity_cost_model(mid, specs)

    grid = tuple(sorted({float(d) for d in deadlines}))
    bands, requests = [], []
    for lo, hi in zip(edges, edges[1:]):
        model = model_for_band(0.5 * (lo + hi))
        bands.append(PolicyBand(lo=lo, hi=hi, cost_model=model,
                                schedules={}))
        requests.append(CompileRequest(
            specs, cfg=cfg, network=f"{network}@{observable}[{lo},{hi})",
            goal=ParetoFront(deadlines=grid), cost_model=model))
    results = svc.compile_many(requests)
    for band, frontier in zip(bands, results):
        for pt in frontier.points:
            if pt.feasible:
                band.schedules[pt.deadline_s] = pt.schedule
            else:
                band.infeasible.append((pt.deadline_s, pt.schedule))
    return SchedulePolicyTable(observable, bands)
