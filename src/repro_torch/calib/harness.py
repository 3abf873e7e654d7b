"""Characterization harness: seeded time/energy micro-benchmarks →
Pagoda-style roofline table, published as a content-addressed
calibration artifact.

Pagoda (PAPERS.md) shows per-accelerator time/energy rooflines must be
*measured*, not assumed.  This harness runs one representative
micro-workload per kernel kind (conv / dwconv / fc / attn / pool /
eltwise — the op set of :mod:`repro_torch.perfmodel.layer_costs` and
:mod:`repro_torch.kernels`) at every voltage level of the accelerator's DVFS
tables, compares the measurement against the analytic model's
prediction at the same operating point, and records the
measured/modelled ratios as a :class:`RooflineTable`.

Determinism contract: the table is a pure function of
``(accelerator, HarnessConfig, measurement source, host
fingerprint)``.  Every stochastic draw comes from a
``SeedSequence([seed, kind, voltage, repeat])`` stream, so re-running
the harness reproduces the table bit-for-bit — and two farm workers
on one host compute (or share) the *same* artifact: the table
publishes into the :class:`~repro_torch.service.ArtifactStore`'s
``calibration`` category under :func:`calibration_key`, a digest of
the host fingerprint + accelerator config + kernel set, so
cross-process workers warm-start from a single measurement pass.

Measurement sources:

  - ``measure=None`` — the analytic model measures itself (all ratios
    exactly 1.0; the parity mode CI pins: a calibration from it must
    compile bit-identical schedules to the static model);
  - :func:`synthetic_measurement` — seeded synthetic "true" silicon
    with per-kind scale factors + lognormal noise (tests recover the
    injected truth);
  - any callable ``(kind, voltage, t_model, e_model, rng) ->
    (t_meas, e_meas)`` — e.g. a wrapper around real hardware counters.

:func:`solver_kernel_walls` is the separate host-side half: wall-clock
micro-benchmarks of the DP sweep dispatch path
(``TorchBackend.dp_multi`` over a padded state slab — the DP kernel of
:mod:`repro_torch.kernels.dp_sweep`, on the card or, on the CPU, its
plain version), recorded alongside the roofline for routing
diagnostics.  Walls are host-dependent by nature and carry no
determinism contract; the paths they time do (``checksum``).
"""

from __future__ import annotations

import dataclasses
import platform
import time
from typing import Callable, Sequence

import numpy as np

from repro_torch.core.context import _digest
from repro_torch.calib.learning import CalibratedCostModel, _round_scale
from repro_torch.hw.dvfs import V_GATED
from repro_torch.hw.edge40nm import (
    D_COMPUTE,
    D_FEEDER,
    D_RRAM,
    EDGE40NM_DEFAULT,
    Edge40nmAccelerator,
)
from repro_torch.perfmodel.layer_costs import (
    LayerSpec,
    attention_spec,
    characterize_layer,
    conv_spec,
    dwconv_spec,
    eltwise_spec,
    fc_spec,
    pool_spec,
)

#: one representative micro-workload per kernel kind (small enough to
#: run everywhere, big enough that every domain has real work)
REFERENCE_SPECS: dict[str, LayerSpec] = {
    "conv": conv_spec("cal_conv", 14, 14, 32, 32, 3),
    "dwconv": dwconv_spec("cal_dwconv", 14, 14, 64, 3),
    "fc": fc_spec("cal_fc", 256, 128),
    "attn": attention_spec("cal_attn", 16, 64, 4, d_ff=128),
    "pool": pool_spec("cal_pool", 14, 14, 32, 2),
    "eltwise": eltwise_spec("cal_eltwise", 14, 14, 32),
}

#: measurement source protocol (see module docstring)
MeasureFn = Callable[[str, float, float, float, np.random.Generator],
                     tuple[float, float]]


@dataclasses.dataclass(frozen=True)
class HarnessConfig:
    """Harness knobs — part of the calibration artifact's content key,
    so differently configured harness runs never alias."""

    seed: int = 0
    repeats: int = 5
    kinds: tuple[str, ...] = ("conv", "dwconv", "fc", "attn", "pool",
                              "eltwise")

    def __post_init__(self) -> None:
        if self.repeats < 1:
            raise ValueError(f"repeats must be >= 1, got {self.repeats}")
        unknown = [k for k in self.kinds if k not in REFERENCE_SPECS]
        if unknown:
            raise ValueError(
                f"unknown kernel kinds {unknown}; harness covers "
                f"{sorted(REFERENCE_SPECS)}")


@dataclasses.dataclass(frozen=True)
class RooflinePoint:
    """One (kernel kind, voltage) operating point: the analytic model's
    time/energy prediction vs the measurement's median."""

    kind: str
    voltage: float
    t_model_s: float
    e_model_j: float
    t_meas_s: float
    e_meas_j: float

    @property
    def t_ratio(self) -> float:
        return self.t_meas_s / self.t_model_s

    @property
    def e_ratio(self) -> float:
        return self.e_meas_j / self.e_model_j


@dataclasses.dataclass
class RooflineTable:
    """The harness output: per-point measured-vs-modelled rooflines,
    the content key it publishes under, and the host/config provenance
    needed to interpret it later."""

    key: str
    host: dict
    config: str                      # repr(HarnessConfig)
    acc: str                         # repr(accelerator)
    points: list[RooflinePoint]
    solver_walls: dict = dataclasses.field(default_factory=dict)

    def ratios_by_kind(self) -> dict[str, tuple[float, float]]:
        """Median (t_ratio, e_ratio) per kernel kind across voltages —
        the per-kind correction the cost model applies."""
        by_kind: dict[str, list[RooflinePoint]] = {}
        for p in self.points:
            by_kind.setdefault(p.kind, []).append(p)
        return {
            kind: (float(np.median([p.t_ratio for p in pts])),
                   float(np.median([p.e_ratio for p in pts])))
            for kind, pts in by_kind.items()}

    def cost_model(self, specs: Sequence[LayerSpec], *,
                   source: str = "harness") -> CalibratedCostModel:
        """A per-layer :class:`CalibratedCostModel` for a network: each
        layer inherits its kind's measured time ratio (work scale —
        time and energy move together, the op_scale semantics); kinds
        the harness did not cover stay at 1.0."""
        ratios = self.ratios_by_kind()
        scale = _round_scale(
            ratios.get(s.kind, (1.0, 1.0))[0] for s in specs)
        return CalibratedCostModel(
            scale=scale, source=f"{source}:{self.key[:12]}")

    # -- serialization (the store's calibration payload is JSON) ------
    def to_record(self) -> dict:
        return {
            "key": self.key, "host": self.host, "config": self.config,
            "acc": self.acc,
            "points": [dataclasses.asdict(p) for p in self.points],
            "solver_walls": self.solver_walls,
        }

    @classmethod
    def from_record(cls, rec: dict) -> "RooflineTable":
        return cls(key=rec["key"], host=rec["host"],
                   config=rec["config"], acc=rec["acc"],
                   points=[RooflinePoint(**p) for p in rec["points"]],
                   solver_walls=rec.get("solver_walls", {}))


def host_fingerprint() -> dict:
    """The stable identity of the measuring host — all farm workers on
    one machine share it (and therefore share one calibration artifact
    digest); different machines never alias."""
    return {"machine": platform.machine(),
            "system": platform.system(),
            "python": platform.python_version()}


def calibration_key(acc: Edge40nmAccelerator, cfg: HarnessConfig,
                    host: dict | None = None) -> str:
    """Content key of one harness run: host fingerprint + accelerator
    config + kernel set/harness knobs."""
    host = host if host is not None else host_fingerprint()
    return _digest("calibration", repr(sorted(host.items())), repr(acc),
                   repr(cfg))


def _op_point(cost, acc: Edge40nmAccelerator, v: float
              ) -> tuple[float, float]:
    """The analytic model's (time, energy) for one layer with every
    domain at voltage ``v`` — the same op arithmetic the runtime and
    the edge builder use (max over domain times; dynamic energy scaled
    per domain; leakage over the op window)."""
    dvfs = [acc.dvfs(D_COMPUTE), acc.dvfs(D_FEEDER), acc.dvfs(D_RRAM)]
    times = [cost.cycles[d] / dvfs[d].freq(v) for d in range(3)
             if dvfs[d].freq(v) > 0]
    t_op = max(times) if times else 0.0
    e_dyn = sum(cost.dyn_energy_nom[d] * dvfs[d].dyn_energy_scale(v)
                for d in range(3))
    p_leak = sum(m.leak_power(v) for m in dvfs)
    return t_op, e_dyn + p_leak * t_op


def synthetic_measurement(true_scale: dict[str, float] | float, *,
                          noise_sigma: float = 0.0) -> MeasureFn:
    """A seeded synthetic "true silicon": per-kind work scale (scalar =
    all kinds) with optional lognormal measurement noise.  Time and
    energy scale together — the same coupling the runtime's op_scale
    faults apply — so the harness-recovered model matches the world a
    faulted serve trace executes in."""
    if noise_sigma < 0.0:
        raise ValueError(f"noise_sigma must be >= 0, got {noise_sigma}")

    def measure(kind: str, voltage: float, t_model: float,
                e_model: float, rng: np.random.Generator
                ) -> tuple[float, float]:
        s = true_scale if isinstance(true_scale, (int, float)) \
            else true_scale.get(kind, 1.0)
        if noise_sigma > 0.0:
            s = s * float(np.exp(rng.normal(0.0, noise_sigma)))
        return t_model * s, e_model * s

    return measure


def run_harness(acc: Edge40nmAccelerator = EDGE40NM_DEFAULT,
                cfg: HarnessConfig | None = None, *,
                measure: MeasureFn | None = None,
                store=None, host: dict | None = None) -> RooflineTable:
    """Run (or fetch) the characterization harness.

    With a ``store``, the table is looked up under its content key
    first — a farm worker whose sibling already measured this host
    reuses the published artifact — and published after a cold run.
    ``measure=None`` is the parity mode: the model measures itself and
    every ratio is exactly 1.0.
    """
    cfg = cfg or HarnessConfig()
    host = host if host is not None else host_fingerprint()
    key = calibration_key(acc, cfg, host)
    if store is not None:
        rec = store.calibration(key)
        if rec is not None:
            return RooflineTable.from_record(rec)
    levels = acc.levels()
    points: list[RooflinePoint] = []
    for ki, kind in enumerate(cfg.kinds):
        cost = characterize_layer(REFERENCE_SPECS[kind], acc)
        for vi, v in enumerate(levels):
            if v == V_GATED:
                continue
            t_model, e_model = _op_point(cost, acc, v)
            if measure is None:
                t_meas, e_meas = t_model, e_model
            else:
                draws = []
                for r in range(cfg.repeats):
                    rng = np.random.default_rng(np.random.SeedSequence(
                        [int(cfg.seed), ki, vi, r]))
                    draws.append(measure(kind, float(v), t_model,
                                         e_model, rng))
                t_meas = float(np.median([d[0] for d in draws]))
                e_meas = float(np.median([d[1] for d in draws]))
            points.append(RooflinePoint(
                kind=kind, voltage=float(v), t_model_s=t_model,
                e_model_j=e_model, t_meas_s=t_meas, e_meas_j=e_meas))
    table = RooflineTable(key=key, host=host, config=repr(cfg),
                          acc=repr(acc), points=points)
    if store is not None:
        store.put_calibration(key, table.to_record())
    return table


def solver_kernel_walls(device: str | None = None, *,
                        n_layers: int = 12, s_pad: int = 16,
                        k_weights: int = 8, repeats: int = 3,
                        seed: int = 0) -> dict:
    """Wall-clock micro-benchmark of the DP sweep dispatch path: one
    ``dp_multi`` slab (the kernel every rail-subset λ round dispatches)
    over a seeded synthetic problem, on ``device`` (``None`` →
    ``"cuda"``; ``"cpu"`` runs the kernel's plain version).  Each wall
    is the host clock around a call whose paths have reached the host.
    Purely informational — walls are host-dependent and never feed the
    cost model."""
    from repro_torch.core.backend import PaddedArrays, get_backend

    rng = np.random.default_rng(np.random.SeedSequence([seed]))
    L, S, K = int(n_layers), int(s_pad), int(k_weights)
    padded = PaddedArrays(
        t_op=rng.uniform(1e-5, 1e-3, (L, S)),
        e_op=rng.uniform(1e-7, 1e-5, (L, S)),
        valid=np.ones((L, S), dtype=bool),
        t_trans=rng.uniform(0.0, 1e-5, (L - 1, S, S)),
        e_trans=rng.uniform(0.0, 1e-7, (L - 1, S, S)),
        switch=np.zeros((L - 1, S, S), dtype=np.int64),
        sizes=(S,) * L)
    w_e = np.linspace(0.2, 1.0, K)
    w_t = 1.0 - w_e
    be = get_backend(device)
    walls = []
    # warm-up: loads the kernel library and copies the slab to the device
    paths = be.dp_multi(padded, w_e, w_t)
    for _ in range(repeats):
        tic = time.perf_counter()
        paths = be.dp_multi(padded, w_e, w_t)
        walls.append(time.perf_counter() - tic)
    return {"backend": be.name, "device": str(be.device),
            "n_layers": L, "s_pad": S,
            "k_weights": K, "wall_s_median": float(np.median(walls)),
            "wall_s_min": float(np.min(walls)),
            "checksum": int(np.asarray(paths).sum())}
