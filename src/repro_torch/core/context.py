"""Shared compilation state for the staged compiler pipeline (§3.3).

The rail-subset sweep of §6.5 solves ``Σ C(|V|,k)`` subsets of the same
network.  Everything that does not depend on the chosen subset is
computed exactly once here and shared across all of them:

  - layer characterization (cycle counts, per-event energies) and the
    RRAM bank plan — once per compile;
  - a **master per-layer state table** over *all* voltage levels (plus
    the gated RRAM option), from which each subset's
    :class:`ScheduleProblem` is derived as an index-slice view instead of
    re-enumerating the voltage cross-product per subset;
  - **master pairwise transition matrices**, cached by voltage-table
    *content* (most adjacent layer pairs share one of a handful of
    distinct state tables), sliced per subset — ``_pairwise_transition``
    runs once per distinct pair instead of once per subset per layer;
  - per-subset **energy lower bounds** (Σ_i min E_op) used by the sweep
    to cut subsets that provably cannot beat the incumbent.

State ordering invariant: the master table enumerates (V_c, V_f, V_r)
with each domain ascending over sorted levels and the gated RRAM option
last, exactly as :func:`repro_torch.core.edge_builder.layer_states` does for a
sorted rail subset — so a subset slice is *elementwise identical* to the
problem the monolithic builder would have produced.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Sequence

import numpy as np

from repro_torch.core.edge_builder import (
    build_idle_model,
    layer_state_arrays,
    layer_states,
)
from repro_torch.core.problem import (
    ScheduleProblem,
    StateCost,
    _pairwise_transition,
)
from repro_torch.hw.dvfs import V_GATED
from repro_torch.hw.edge40nm import Edge40nmAccelerator, EDGE40NM_DEFAULT
from repro_torch.perfmodel.gating import plan_banks
from repro_torch.perfmodel.layer_costs import LayerSpec, characterize_network


def _digest(*parts: str) -> str:
    """Deterministic short content digest of string parts (frozen
    dataclass reprs round-trip floats exactly, so equal content always
    yields equal keys across processes)."""
    h = hashlib.blake2b(digest_size=16)
    for part in parts:
        h.update(part.encode())
        h.update(b"\x00")
    return h.hexdigest()


class CompilationContext:
    """Per-compile shared state: characterization, bank plan, master
    state tables, and the content-keyed transition cache.  None of them
    depend on the deadline, so one context serves every deadline of its
    network."""

    def __init__(self, specs: Sequence[LayerSpec],
                 target_rate_hz: float | None = None,
                 *, acc: Edge40nmAccelerator = EDGE40NM_DEFAULT,
                 network: str = "net",
                 e_switch_nom: float | None = None,
                 deadline_s: float | None = None):
        if target_rate_hz is not None and deadline_s is not None:
            raise ValueError(
                "give at most one of target_rate_hz / deadline_s")
        self.specs = list(specs)
        self.acc = acc
        self.network = network
        # the *default* deadline for problem_for(t_max=None); a
        # deadline-free context (both None) requires callers to pass
        # t_max explicitly
        if deadline_s is not None:
            self.t_max: float | None = float(deadline_s)
        else:
            self.t_max = (1.0 / target_rate_hz
                          if target_rate_hz is not None else None)
        self.levels: tuple[float, ...] = acc.levels()
        self.transition_model = acc.transitions(e_switch_nom)
        # content keys (deterministic digests of frozen-dataclass
        # reprs): specs_acc_key addresses everything derived from
        # (specs, acc); content_key folds in the transition model and
        # addresses subset lane stores
        self.cost_model_digest = "static"
        self.specs_acc_key = _digest(repr(tuple(self.specs)), repr(acc))
        self.content_key = _digest(self.specs_acc_key,
                                   repr(self.transition_model))
        self.costs = characterize_network(self.specs, acc)
        self.plan = plan_banks(self.costs, acc)
        # gating flag -> per-layer master voltage / t / e tables
        self._master_volts: dict[bool, list[np.ndarray]] = {}
        self._master_t_op: dict[bool, list[np.ndarray]] = {}
        self._master_e_op: dict[bool, list[np.ndarray]] = {}
        self._master_vkey: dict[bool, list[bytes]] = {}
        # gating flag -> per-layer StateCost lists (built on request only)
        self._master: dict[bool, list[list[StateCost]]] = {}
        # (volts_a content, volts_b content) -> (T, E, switch) matrices
        self._trans_cache: dict[
            tuple[bytes, bytes],
            tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        # gating -> per-pair master transition triples (resolved through
        # the content-keyed cache ONCE; problem_for hands out list
        # lookups instead of re-hashing the long content keys per pair
        # per subset)
        self._master_trans: dict[
            bool, list[tuple[np.ndarray, np.ndarray, np.ndarray]]] = {}
        # (gating, volts content, subset) -> master-state index vector
        self._slice_cache: dict[tuple[bool, bytes, tuple[float, ...]],
                                np.ndarray] = {}
        # master-table construction is guarded by this lock (its four
        # dicts must become visible together); the transition and slice
        # caches stay lock-free — concurrent misses recompute the same
        # immutable value and dict writes are atomic under the GIL
        self._master_lock = threading.Lock()

    # -- master state table -------------------------------------------
    def _master_arrays(self, gating: bool) -> None:
        """Build the per-layer master voltage/t/e arrays once per gating
        flag (vectorized — every rail subset is an index slice of these
        arrays)."""
        with self._master_lock:
            if gating in self._master_volts:
                return
            cols = [layer_state_arrays(c, i, self.acc, self.plan,
                                       self.levels, gating=gating)
                    for i, c in enumerate(self.costs)]
            self._master_t_op[gating] = [t for _, t, _ in cols]
            self._master_e_op[gating] = [e for _, _, e in cols]
            self._master_vkey[gating] = [v.tobytes() for v, _, _ in cols]
            # set last: readers key "is the master built?" off this
            self._master_volts[gating] = [v for v, _, _ in cols]

    def master_states(self, gating: bool) -> list[list[StateCost]]:
        """Per-layer master :class:`StateCost` lists — the record view
        of the master arrays, materialized lazily (the sweep hot path
        only ever touches the arrays)."""
        self._master_arrays(gating)
        with self._master_lock:
            if gating not in self._master:
                self._master[gating] = [
                    [StateCost(voltages=(float(v[0]), float(v[1]),
                                         float(v[2])),
                               t_op=float(t), e_op=float(e))
                     for v, t, e in zip(volts, t_ops, e_ops)]
                    for volts, t_ops, e_ops in zip(
                        self._master_volts[gating],
                        self._master_t_op[gating],
                        self._master_e_op[gating])]
            return self._master[gating]

    def _subset_indices(self, gating: bool, layer: int,
                        rails: tuple[float, ...]) -> np.ndarray:
        """Master-state indices whose voltages all lie in the subset
        (gated RRAM always allowed — it is not a rail)."""
        key = (gating, self._master_vkey[gating][layer], rails)
        if key not in self._slice_cache:
            volts = self._master_volts[gating][layer]
            allowed = np.array(sorted(set(rails)) + [V_GATED])
            mask = np.isin(volts, allowed).all(axis=1)
            self._slice_cache[key] = np.nonzero(mask)[0]
        return self._slice_cache[key]

    # -- transition matrices ------------------------------------------
    def transition_arrays(self, va: np.ndarray, vb: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(T_trans, E_trans, switch) for two voltage tables, cached by
        table *content* so results are shared across layers and subsets."""
        return self._transition_keyed(va.tobytes(), vb.tobytes(), va, vb)

    def _transition_keyed(self, ka: bytes, kb: bytes,
                          va: np.ndarray, vb: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        key = (ka, kb)
        hit = self._trans_cache.get(key)
        if hit is None:
            hit = _pairwise_transition(self.transition_model, va, vb)
            self._trans_cache[key] = hit
        return hit

    # -- per-subset problem views -------------------------------------
    def _resolve_t_max(self, t_max: float | None) -> float:
        if t_max is not None:
            return t_max
        if self.t_max is None:
            raise ValueError(
                "deadline-free CompilationContext: pass t_max= to "
                "problem_for (or build the context with a rate/deadline)")
        return self.t_max

    def problem_for(self, rails: Sequence[float], *, gating: bool,
                    allow_sleep: bool, via_master: bool = True,
                    materialize_states: bool = True,
                    t_max: float | None = None) -> ScheduleProblem:
        """Derive the rail subset's :class:`ScheduleProblem` as a slice
        of the master table, with transition matrices sliced from the
        content-keyed master cache (nothing is recomputed per subset).

        ``via_master=False`` enumerates the subset's states directly —
        cheaper for policies that solve a single subset (no sweep to
        amortize the master table over), unless the master already
        exists.  Both paths produce elementwise-identical problems.

        ``materialize_states=False`` returns an *array-backed* problem
        (``layer_states=None``): solvers and reporting only touch the
        injected master-slice arrays, skipping the per-state Python
        list build — the rail sweep's per-subset hot path.

        ``t_max`` overrides the context's default deadline (the master
        tables and transition caches are deadline-independent).
        """
        rails = tuple(rails)
        t_max = self._resolve_t_max(t_max)
        if not via_master and gating not in self._master_volts:
            layers = [layer_states(c, i, self.acc, self.plan, rails,
                                   gating=gating)
                      for i, c in enumerate(self.costs)]
            return ScheduleProblem(
                layer_states=layers,
                t_max=t_max,
                idle=build_idle_model(self.acc, self.plan.n_banks,
                                      gating=gating,
                                      allow_sleep=allow_sleep),
                transition_model=self.transition_model,
                rails=rails,
                name=self.network,
            )
        self._master_arrays(gating)
        master_volts = self._master_volts[gating]
        n_layers = len(master_volts)
        idx = [self._subset_indices(gating, i, rails)
               for i in range(n_layers)]
        if materialize_states:
            # records built straight from the subset's array slices —
            # the full master StateCost table is never materialized
            layers = [
                [StateCost(voltages=(float(v[0]), float(v[1]),
                                     float(v[2])),
                           t_op=float(t), e_op=float(e))
                 for v, t, e in zip(master_volts[i][idx_i],
                                    self._master_t_op[gating][i][idx_i],
                                    self._master_e_op[gating][i][idx_i])]
                for i, idx_i in enumerate(idx)]
        else:
            layers = None
        problem = ScheduleProblem(
            layer_states=layers,
            t_max=t_max,
            idle=build_idle_model(self.acc, self.plan.n_banks,
                                  gating=gating, allow_sleep=allow_sleep),
            transition_model=self.transition_model,
            rails=rails,
            name=self.network,
            layer_sizes=tuple(len(idx_i) for idx_i in idx),
        )
        # inject the per-layer arrays as master-table slices — bitwise
        # identical to deriving them from the StateCost lists, without
        # the per-state Python loop (hot: once per swept subset)
        problem._t_op_c = [self._master_t_op[gating][i][j]
                           for i, j in enumerate(idx)]
        problem._e_op_c = [self._master_e_op[gating][i][j]
                           for i, j in enumerate(idx)]
        problem._volts_c = [master_volts[i][j] for i, j in enumerate(idx)]
        # transitions stay lazy, backed by the content-keyed master
        # cache: a pair materializes (one fancy gather) only when a
        # solver touches it, and a pruned view composes its row
        # selection with ours instead of slicing twice
        if gating not in self._master_trans:
            vkey = self._master_vkey[gating]
            self._master_trans[gating] = [
                self._transition_keyed(vkey[i], vkey[i + 1],
                                       master_volts[i],
                                       master_volts[i + 1])
                for i in range(n_layers - 1)]
        master_trans = self._master_trans[gating]
        problem._trans_src = master_trans.__getitem__
        problem._trans_sel = idx
        return problem

    def _min_op_bound(self, arrays: list[np.ndarray],
                      rails: tuple[float, ...], gating: bool) -> float:
        """Σ_i min over the subset's states of a per-layer master
        array — the shared reduction behind both sweep bounds (inf for
        an empty subset)."""
        total = 0.0
        for i in range(len(arrays)):
            idx = self._subset_indices(gating, i, rails)
            if idx.size == 0:
                return float("inf")
            total += float(arrays[i][idx].min())
        return total

    def min_e_op_bound(self, rails: Sequence[float], *,
                       gating: bool = True) -> float:
        """Cheap lower bound on any schedule's E_total under ``rails``:
        Σ_i min_s E_op (transitions and idle are non-negative).  Used by
        the sweep to cut subsets that cannot beat the incumbent without
        building or solving them."""
        rails = tuple(rails)
        self._master_arrays(gating)
        return self._min_op_bound(self._master_e_op[gating], rails,
                                  gating)

    def min_t_op_bound(self, rails: Sequence[float], *,
                       gating: bool = True) -> float:
        """Cheap lower bound on any schedule's T_infer under ``rails``:
        Σ_i min_s t_op (transition latencies are non-negative).  On the
        full level set it anchors infeasibility reporting."""
        rails = tuple(rails)
        self._master_arrays(gating)
        return self._min_op_bound(self._master_t_op[gating], rails,
                                  gating)
