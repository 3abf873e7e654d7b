"""The paper's §4 problem formulation as a concrete data structure.

A :class:`ScheduleProblem` is the layered state graph: per layer i a list
of feasible operating states (each a per-domain voltage assignment with
characterized ``T_op``/``E_op``), pairwise transition costs between
adjacent layers' states, a hard deadline ``T_max``, and the terminal idle
model (§4.2: ``E_idle = z · P_idle · (T_max − T_infer)``, generalized with
a duty-cycled deep-sleep alternative so ``z`` is a real decision).

Solvers (λ-DP, ILP, greedy) all consume this structure, so every policy
is evaluated under *identical* hardware and timing constraints (§6).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.backend import (
    PaddedArrays,
    build_padded,
    get_backend,
    host_path_costs,
)
from repro_torch.hw.dvfs import TransitionModel, V_GATED


@dataclasses.dataclass(frozen=True)
class StateCost:
    """One feasible operating state of one layer (paper §4.1)."""

    voltages: tuple[float, ...]   # per-domain rail (0.0 = gated)
    t_op: float                   # execution latency at this state [s]
    e_op: float                   # execution energy at this state [J]
    label: str = ""               # provenance for reporting


@dataclasses.dataclass(frozen=True)
class IdleModel:
    """Terminal-state (s_{L+1}) energy model.

    ``z = 1``: stay active → P_idle · slack.
    ``z = 0``: duty-cycle into deep sleep → wake energy + retention power,
    only available when the slack covers the wake latency.
    """

    p_idle: float
    p_sleep: float = 0.0
    e_sleep_wake: float = 0.0
    t_sleep_wake: float = 0.0
    allow_sleep: bool = True

    def energy(self, slack: float) -> float:
        if slack <= 0:
            return 0.0
        active = self.p_idle * slack
        if not self.allow_sleep or slack <= self.t_sleep_wake:
            return active
        sleep = self.e_sleep_wake + self.p_sleep * slack
        return min(active, sleep)

    def z_choice(self, slack: float) -> int:
        """1 = active idle, 0 = duty-cycled sleep (paper's z)."""
        if slack <= 0 or not self.allow_sleep or slack <= self.t_sleep_wake:
            return 1
        return int(self.p_idle * slack <
                   self.e_sleep_wake + self.p_sleep * slack)

    def energy_batch(self, slack: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`energy` over an array of slacks."""
        slack = np.asarray(slack, dtype=float)
        active = self.p_idle * slack
        if not self.allow_sleep:
            return np.where(slack > 0, active, 0.0)
        sleep = self.e_sleep_wake + self.p_sleep * slack
        e = np.where(slack > self.t_sleep_wake,
                     np.minimum(active, sleep), active)
        return np.where(slack > 0, e, 0.0)

    def z_choice_batch(self, slack: np.ndarray) -> np.ndarray:
        """Vectorized :meth:`z_choice` over an array of slacks."""
        slack = np.asarray(slack, dtype=float)
        forced_active = (slack <= 0) | (slack <= self.t_sleep_wake)
        if not self.allow_sleep:
            return np.ones(slack.shape, dtype=np.int64)
        active_cheaper = (self.p_idle * slack
                          < self.e_sleep_wake + self.p_sleep * slack)
        return np.where(forced_active, 1,
                        active_cheaper.astype(np.int64))


def _pairwise_transition(tm: TransitionModel,
                         va: np.ndarray, vb: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized T_trans / E_trans / rail-switch flag between state sets.

    ``va``: [Sa, D] voltages of layer i's states; ``vb``: [Sb, D] of layer
    i+1.  Domains switch in parallel → latency is the max over domains;
    energies add.  Matches :class:`TransitionModel` semantics exactly.

    The third array flags state pairs whose crossing performs a *true*
    rail switch on at least one domain (a voltage change where neither
    endpoint is gated) — power-gating entries/exits are not rail switches.
    """
    # Each domain column draws from a handful of unique rail levels, so
    # the per-domain pairwise quantities are computed on the tiny
    # [Ua, Ub] unique-level grid and gathered out to [Sa, Sb] — one
    # gather per domain per quantity instead of [Sa, Sb, D] elementwise
    # sweeps (~3× less memory traffic on wide master tables).  The
    # per-element arithmetic and the domain reduction order are exactly
    # the direct formulation's, so results are bit-identical.
    Sa, D = va.shape
    Sb = vb.shape[0]
    c = tm._cap_scale()
    t_trans = np.zeros((Sa, Sb))
    e_trans = np.zeros((Sa, Sb))
    any_switch = np.zeros((Sa, Sb), dtype=bool)
    for d in range(D):
        ua, ia = np.unique(va[:, d], return_inverse=True)
        ub, ib = np.unique(vb[:, d], return_inverse=True)
        a = ua[:, None]
        b = ub[None, :]
        changed = a != b
        from_gated = (a == V_GATED) & changed
        to_gated = (b == V_GATED) & changed
        rail_switch = changed & ~from_gated & ~to_gated
        lat = np.where(from_gated, tm.t_wake, 0.0)
        lat = np.where(rail_switch, tm.t_rail, lat)
        # gating (to_gated) costs no stall time
        hi = np.maximum(a, b)
        lo = np.minimum(a, b)
        e = np.where(changed,
                     np.where(lo == V_GATED, c * hi**2,
                              c * (hi**2 - lo**2)),
                     0.0)
        ra = ia[:, None]
        cb = ib[None, :]
        np.maximum(t_trans, lat[ra, cb], out=t_trans)
        e_trans += e[ra, cb]
        any_switch |= rail_switch[ra, cb]
    n_switch = any_switch.astype(np.int64)
    return t_trans, e_trans, n_switch


@dataclasses.dataclass
class ScheduleProblem:
    """Layered state graph + deadline + idle model (paper §4).

    ``layer_states`` may be ``None`` for *array-backed* problems (the
    rail-subset sweep's hot path): the per-layer t/e/voltage arrays are
    injected as master-table slices and ``layer_sizes`` carries the
    state counts, skipping the per-state ``StateCost`` Python lists
    entirely.  Both forms are solver-equivalent; reporting helpers
    (:meth:`state_voltages`) work on either.
    """

    layer_states: list[list[StateCost]] | None
    t_max: float
    idle: IdleModel
    transition_model: TransitionModel
    rails: tuple[float, ...] = ()
    name: str = ""
    layer_sizes: tuple[int, ...] | None = None

    def __post_init__(self) -> None:
        # per-layer t_op/e_op/voltage arrays, derived lazily from the
        # StateCost lists — or injected as master-table slices by
        # CompilationContext / prune_problem, skipping the per-state
        # Python loop entirely (hot in the Σ C(|V|,k) rail sweep).
        self._t_op_c: list[np.ndarray] | None = None
        self._e_op_c: list[np.ndarray] | None = None
        self._volts_c: list[np.ndarray] | None = None
        # per adjacent-layer pair: (T_trans, E_trans, rail-switch flag).
        # May be pre-populated by CompilationContext (shared master-table
        # slices) or prune_problem (parent slices) instead of recomputed.
        self._trans_cache: dict[
            int, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        # lazy master-backed transition provider: ``_trans_src(i)``
        # returns the *master* (T, E, switch) matrices of pair i and
        # ``_trans_sel[i]`` maps this problem's layer-i states to master
        # rows.  Slices materialize per pair on first use — the rail
        # sweep never pays for matrices a subset does not touch, and a
        # pruned view composes its selection with the parent's instead
        # of slicing twice.
        self._trans_src = None
        self._trans_sel: list[np.ndarray] | None = None
        # lazily-built dense padded tensors for the kernels
        # (repro_torch.core.backend); invalidated never — problems are
        # immutable after construction.
        self._padded: PaddedArrays | None = None

    def _build_arrays(self) -> None:
        if self.layer_states is None:
            raise ValueError(
                "array-backed problem (layer_states=None) must have its "
                "per-layer arrays injected at construction")
        self._t_op_c = [np.array([s.t_op for s in states])
                        for states in self.layer_states]
        self._e_op_c = [np.array([s.e_op for s in states])
                        for states in self.layer_states]
        self._volts_c = [np.array([s.voltages for s in states])
                         for states in self.layer_states]

    @property
    def _t_op(self) -> list[np.ndarray]:
        if self._t_op_c is None:
            self._build_arrays()
        return self._t_op_c

    @property
    def _e_op(self) -> list[np.ndarray]:
        if self._e_op_c is None:
            self._build_arrays()
        return self._e_op_c

    @property
    def _volts(self) -> list[np.ndarray]:
        if self._volts_c is None:
            self._build_arrays()
        return self._volts_c

    # -- accessors ----------------------------------------------------
    @property
    def sizes(self) -> tuple[int, ...]:
        """Per-layer feasible-state counts |S_i|."""
        if self.layer_sizes is not None:
            return self.layer_sizes
        return tuple(len(s) for s in self.layer_states)

    @property
    def n_layers(self) -> int:
        if self.layer_states is not None:
            return len(self.layer_states)
        return len(self.layer_sizes)

    def n_states(self) -> int:
        """Σ|S_i| — the layered-state-graph node count (§4.2)."""
        return sum(self.sizes)

    def n_edges(self) -> int:
        """Σ|S_i||S_{i+1}| — adjacent-layer transition count (§4.2)."""
        sizes = self.sizes
        return sum(a * b for a, b in zip(sizes[:-1], sizes[1:]))

    def state_voltages(self, i: int, s: int) -> tuple[float, ...]:
        """Per-domain voltages of state ``s`` of layer ``i`` (works on
        array-backed problems, where no StateCost lists exist).  Plain
        Python floats — schedules serialize to JSON."""
        if self.layer_states is not None:
            return self.layer_states[i][s].voltages
        return tuple(float(v) for v in self._volts[i][s])

    def op_arrays(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        return self._t_op[i], self._e_op[i]

    def _ensure_trans(self, i: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        if i not in self._trans_cache:
            if self._trans_src is not None:
                tt, et, sw = self._trans_src(i)
                sel = np.ix_(self._trans_sel[i], self._trans_sel[i + 1])
                self._trans_cache[i] = (tt[sel], et[sel], sw[sel])
            else:
                self._trans_cache[i] = _pairwise_transition(
                    self.transition_model,
                    self._volts[i], self._volts[i + 1])
        return self._trans_cache[i]

    def trans_elems(self, i: int, a: np.ndarray, b: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Elementwise (T_trans, E_trans, switch) of crossing layer
        boundary ``i`` from states ``a`` to ``b`` (index arrays).

        On master-backed problems with the pair not yet materialized,
        gathers single elements straight from the master matrices —
        single-path evaluation never pays for a full [S_i, S_{i+1}]
        slice.  Values are identical either way.
        """
        if self._trans_src is not None and i not in self._trans_cache:
            tt, et, sw = self._trans_src(i)
            ga = self._trans_sel[i][a]
            gb = self._trans_sel[i + 1][b]
            return tt[ga, gb], et[ga, gb], sw[ga, gb]
        tt, et, sw = self._ensure_trans(i)
        return tt[a, b], et[a, b], sw[a, b]

    def transition_arrays(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """(T_trans, E_trans) matrices between layer i and i+1 states."""
        tt, et, _ = self._ensure_trans(i)
        return tt, et

    def switch_arrays(self, i: int) -> np.ndarray:
        """[S_i, S_{i+1}] flag: crossing performs a true rail switch
        (voltage change with neither endpoint gated) on ≥1 domain."""
        return self._ensure_trans(i)[2]

    def padded_arrays(self) -> PaddedArrays:
        """Dense padded per-layer tensors (cached): state axes rounded
        up to a power-of-two bucket with a validity mask, so rail
        subsets of one master table share lane stores (see
        :mod:`repro_torch.core.backend`)."""
        if self._padded is None:
            self._padded = build_padded(self)
        return self._padded

    # -- schedule evaluation -------------------------------------------
    def evaluate_paths(self, paths, *,
                       backend=None) -> dict[str, np.ndarray]:
        """Batched exact evaluation of P schedules in one shot.

        ``paths``: [P, L] integer state indices (anything array-like).
        Returns a dict of [P]-shaped arrays with the same keys/semantics
        as :meth:`evaluate` (plus ``paths`` echoing the input matrix).
        With ``backend=None`` the cost gathers run on the host
        (:func:`~repro_torch.core.backend.host_path_costs`); a device
        name or :class:`~repro_torch.core.backend.TorchBackend` gathers
        them with the path-components kernel.
        """
        p = np.atleast_2d(np.asarray(paths, dtype=np.int64))
        if p.ndim != 2 or p.shape[1] != self.n_layers:
            raise ValueError(
                f"paths must be [P, {self.n_layers}], got {p.shape}")
        sizes = np.array(self.sizes)
        if (p < 0).any() or (p >= sizes[None, :]).any():
            raise ValueError(
                "path state indices out of range for this problem's "
                f"layer state counts {sizes.tolist()}")
        if backend is None:
            costs = host_path_costs(self, p)
        else:
            costs = get_backend(backend).path_costs(self, p)
        return self.finish_costs(p, costs)

    def finish_costs(self, p: np.ndarray,
                     costs: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """Turn gathered per-path cost components into the full
        evaluation batch (deadline check, idle energy, totals).  Shared
        by :meth:`evaluate_paths` and the subset-stacked sweep's grouped
        evaluator, so both produce bit-identical rows."""
        t_trans = costs["t_trans"]
        e_trans = costs["e_trans"]
        e_op = costs["e_op"]
        n_switch = costs["n_switch"]
        t_infer = costs["t_op"] + t_trans
        slack = self.t_max - t_infer
        e_idle = self.idle.energy_batch(slack)
        return {
            "paths": p,
            "t_infer": t_infer,
            "feasible": t_infer <= self.t_max + 1e-15,
            "e_op": e_op,
            "e_trans": e_trans,
            "t_trans": t_trans,
            "e_idle": e_idle,
            "e_total": e_op + e_trans + e_idle,
            "z": self.idle.z_choice_batch(slack),
            "n_rail_switches": n_switch,
        }

    @staticmethod
    def result_row(batch: dict[str, np.ndarray], j: int) -> dict:
        """Extract evaluation ``j`` of an :meth:`evaluate_paths` batch as
        a scalar dict in the :meth:`evaluate` format."""
        return {
            "path": [int(s) for s in batch["paths"][j]],
            "t_infer": float(batch["t_infer"][j]),
            "feasible": bool(batch["feasible"][j]),
            "e_op": float(batch["e_op"][j]),
            "e_trans": float(batch["e_trans"][j]),
            "t_trans": float(batch["t_trans"][j]),
            "e_idle": float(batch["e_idle"][j]),
            "e_total": float(batch["e_total"][j]),
            "z": int(batch["z"][j]),
            "n_rail_switches": int(batch["n_rail_switches"][j]),
        }

    def evaluate(self, path: Sequence[int]) -> dict:
        """Exact E_tot / T_infer of a schedule (eq. 1–2), incl. idle.

        ``n_rail_switches`` counts layer boundaries whose crossing does a
        true rail switch on ≥1 domain; power-gating entries/exits do not
        count (they match the ``rail_switch`` mask of the transition
        model, not mere voltage-vector inequality).
        """
        if len(path) != self.n_layers:
            raise ValueError(
                f"path must have {self.n_layers} entries, "
                f"got {len(path)}")
        return self.result_row(self.evaluate_paths([list(path)]), 0)
