"""Bursty / diurnal traffic simulator for the online serving bench.

The paper's workload is "inference at a fixed frame rate"; live
deployments drift around that contract.  :class:`TrafficSimulator`
produces a seeded, *schedule-independent* frame-arrival trace so a
static baseline and the adaptive control plane can be A/B-compared on
the identical workload:

  - ``calm``    — exactly periodic at ``base_rate_hz`` (plus optional
    seeded jitter): the regime a static schedule is compiled for;
  - ``bursty``  — repeating calm → burst → lull phases (frame-indexed,
    deterministic phase boundaries): rates step to
    ``burst_rate_mult`` × base and down to ``lull_rate_mult`` × base;
  - ``diurnal`` — a smooth sinusoidal rate swing of relative depth
    ``diurnal_depth`` with period ``diurnal_period_s`` (a compressed
    day/night cycle).

The per-frame deadline contract is periodic-under-drift: frame *k*
must complete before frame *k+1* arrives (its deadline is the next
arrival), which degenerates to the paper's 1/R deadline under calm
traffic.
"""

from __future__ import annotations

import dataclasses

import numpy as np

SCENARIOS = ("calm", "bursty", "diurnal")


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    base_rate_hz: float = 40.0
    scenario: str = "calm"
    seed: int = 0
    # lognormal sigma on inter-arrival gaps (0 = deterministic)
    jitter_sigma: float = 0.0
    # bursty scenario (phase lengths in frames)
    burst_rate_mult: float = 3.0
    lull_rate_mult: float = 0.4
    calm_len: int = 60
    burst_len: int = 50
    lull_len: int = 70
    # diurnal scenario
    diurnal_period_s: float = 8.0
    diurnal_depth: float = 0.5

    def __post_init__(self) -> None:
        if self.scenario not in SCENARIOS:
            raise ValueError(
                f"unknown traffic scenario {self.scenario!r}; choose "
                f"one of {SCENARIOS}")
        if not (self.base_rate_hz > 0.0):
            raise ValueError(
                f"base_rate_hz must be positive, got "
                f"{self.base_rate_hz!r}")
        if not (0.0 <= self.diurnal_depth < 1.0):
            raise ValueError(
                f"diurnal_depth must lie in [0, 1), got "
                f"{self.diurnal_depth!r}")


class TrafficSimulator:
    def __init__(self, cfg: TrafficConfig):
        self.cfg = cfg

    def rate_for_frame(self, k: int, t: float) -> float:
        """Instantaneous target arrival rate for frame ``k`` arriving
        around time ``t`` (frame-indexed for bursty phases, time-based
        for the diurnal swing)."""
        cfg = self.cfg
        if cfg.scenario == "calm":
            return cfg.base_rate_hz
        if cfg.scenario == "bursty":
            period = cfg.calm_len + cfg.burst_len + cfg.lull_len
            phase = k % period
            if phase < cfg.calm_len:
                return cfg.base_rate_hz
            if phase < cfg.calm_len + cfg.burst_len:
                return cfg.base_rate_hz * cfg.burst_rate_mult
            return cfg.base_rate_hz * cfg.lull_rate_mult
        # diurnal
        swing = 1.0 + cfg.diurnal_depth * np.sin(
            2.0 * np.pi * t / cfg.diurnal_period_s)
        return cfg.base_rate_hz * swing

    def frame_times(self, n_frames: int) -> np.ndarray:
        """``n_frames + 1`` arrival timestamps (frame ``k``'s deadline
        is ``times[k + 1]``), seeded and schedule-independent."""
        cfg = self.cfg
        jitter = np.ones(n_frames + 1)
        if cfg.jitter_sigma > 0.0:
            rng = np.random.default_rng(
                np.random.SeedSequence([int(cfg.seed), 104729]))
            jitter = np.exp(rng.normal(
                -0.5 * cfg.jitter_sigma ** 2, cfg.jitter_sigma,
                size=n_frames + 1))
        times = np.empty(n_frames + 1)
        t = 0.0
        for k in range(n_frames + 1):
            times[k] = t
            t += jitter[k] / self.rate_for_frame(k, t)
        return times
