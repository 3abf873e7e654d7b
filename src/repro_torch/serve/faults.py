"""Seeded fault injection for the serving runtime.

The compiled schedule is exact only as long as the world matches the
compiler's model.  Online, three things break first: the layer-cost
model is wrong (input-dependent work, process/temperature drift —
SparseDVFS shows the optimum itself moves), rail transitions overrun
their datasheet latency (regulator settling jitter), and frames arrive
late or not at all (upstream sensor hiccups).  :class:`FaultInjector`
produces seeded, *schedule-independent* per-interval perturbations for
all three so a run under faults is exactly reproducible — and so a
static baseline and the adaptive control plane can be A/B-compared
under the **identical** fault trace.

Determinism contract: ``interval(i)`` is a pure function of
``(config, bias, i)`` — each interval draws from its own
``SeedSequence([seed, i])`` stream, so the draw never depends on which
schedule is executing, how many intervals ran before, or the order of
calls.  The streams are numpy's (a ``torch.Generator`` draws other
values), so a trace equals the JAX package's for the same seed, value
for value; ``tests/test_torch_faults.py`` holds it so.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Perturbation magnitudes (all default to "off").

    ``op_sigma`` / ``trans_sigma`` are lognormal sigmas of per-layer
    multiplicative error on op execution and transition latency;
    ``p_trans_spike`` adds a Bernoulli chance per layer that one
    transition takes ``trans_spike_mult`` × longer (regulator
    re-settle).  ``p_drop`` drops the whole frame (it never arrives);
    ``p_late`` delays its arrival uniformly in ``(0, late_max_s]``.
    """

    seed: int = 0
    op_sigma: float = 0.0
    trans_sigma: float = 0.0
    p_trans_spike: float = 0.0
    trans_spike_mult: float = 5.0
    p_drop: float = 0.0
    p_late: float = 0.0
    late_max_s: float = 0.0

    def __post_init__(self) -> None:
        for name in ("op_sigma", "trans_sigma", "late_max_s"):
            v = getattr(self, name)
            if not (v >= 0.0):           # catches negatives and NaN
                raise ValueError(
                    f"FaultConfig.{name} must be >= 0, got {v!r}")
        for name in ("p_trans_spike", "p_drop", "p_late"):
            v = getattr(self, name)
            if not (0.0 <= v <= 1.0):
                raise ValueError(
                    f"FaultConfig.{name} is a probability and must lie "
                    f"in [0, 1], got {v!r}")
        if not (self.trans_spike_mult > 0.0):
            raise ValueError(
                f"FaultConfig.trans_spike_mult must be > 0, got "
                f"{self.trans_spike_mult!r}")


@dataclasses.dataclass(frozen=True)
class IntervalFaults:
    """One interval's materialized perturbation.

    ``op_scale`` / ``trans_scale`` multiply each layer's op time+energy
    and transition latency (1.0 = nominal).  ``late_s`` shifts the
    frame's arrival; the loop that owns arrival times applies it
    (``serve_trace``), or :meth:`PowerRuntime.execute_interval` charges
    it against the interval budget when executed standalone.
    """

    op_scale: np.ndarray
    trans_scale: np.ndarray
    dropped: bool = False
    late_s: float = 0.0


#: optional drift profile: interval index → multiplicative bias applied
#: on top of the random op-cost error (models a slowly moving cost
#: optimum, e.g. thermal throttle or input-sparsity drift)
BiasFn = Callable[[int], float]


class FaultInjector:
    def __init__(self, cfg: FaultConfig, n_layers: int,
                 op_bias: BiasFn | None = None):
        if n_layers < 1:
            raise ValueError(f"FaultInjector needs n_layers >= 1, "
                             f"got {n_layers}")
        self.cfg = cfg
        self.n_layers = int(n_layers)
        self.op_bias = op_bias

    def interval(self, i: int) -> IntervalFaults:
        """The perturbation of interval ``i`` (pure in ``(cfg, i)``)."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([int(cfg.seed), int(i)]))
        L = self.n_layers
        op = np.ones(L)
        if cfg.op_sigma > 0.0:
            op = np.exp(rng.normal(0.0, cfg.op_sigma, size=L))
        if self.op_bias is not None:
            op = op * float(self.op_bias(i))
        trans = np.ones(L)
        if cfg.trans_sigma > 0.0:
            trans = np.exp(rng.normal(0.0, cfg.trans_sigma, size=L))
        if cfg.p_trans_spike > 0.0:
            spikes = rng.random(L) < cfg.p_trans_spike
            trans = np.where(spikes, trans * cfg.trans_spike_mult,
                             trans)
        dropped = bool(cfg.p_drop > 0.0 and rng.random() < cfg.p_drop)
        late = 0.0
        if cfg.p_late > 0.0 and rng.random() < cfg.p_late:
            late = float(rng.uniform(0.0, cfg.late_max_s))
        return IntervalFaults(op_scale=op, trans_scale=trans,
                              dropped=dropped, late_s=late)


def linear_drift(ramp_per_interval: float, *, start: int = 0,
                 peak: int | None = None) -> BiasFn:
    """A simple cost-drift profile: bias grows linearly from 1.0 by
    ``ramp_per_interval`` starting at ``start``; with ``peak`` set it
    ramps back down symmetrically after ``peak`` (lets tests exercise
    hysteretic recovery when the drift subsides)."""

    def bias(i: int) -> float:
        if i <= start:
            return 1.0
        if peak is not None and i > peak:
            k = max(peak - (i - peak), start)
            return 1.0 + ramp_per_interval * (k - start)
        return 1.0 + ramp_per_interval * (i - start)

    return bias
