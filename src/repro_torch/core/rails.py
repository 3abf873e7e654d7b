"""Rail-subset handling (paper §2.3, §4.2, §6.3).

Practical designs expose only a few supply rails (N_max); the optimizer
must pick which voltage levels those rails carry and share them across
all domains and layers.  PF-DNN "enumerates candidate rail subsets and
determines the minimum-energy feasible schedule under each subset,
selecting the overall best solution" (§3.3).

The pfdnn-family sweeps run on the subset-stacked round scheduler
(:func:`run_stacked_sweeps`), which drives the backend through its
device-lane API: every kernel call reads its operands from the device
mirror of a :class:`~repro_torch.core.backend.BucketStack`.  The
sequential :func:`select_rails` serves the evenly-spaced ablation,
which solves one subset per rail count and has nothing to stack.
"""

from __future__ import annotations

import itertools
from collections import deque
import inspect
from typing import Callable, Iterable, Sequence

import numpy as np

from repro_torch.core.backend import PendingResult, StackCaches, get_backend
from repro_torch.core.refinement import move_scores


def all_rail_subsets(levels: Sequence[float],
                     n_max: int) -> list[tuple[float, ...]]:
    subsets: list[tuple[float, ...]] = []
    for k in range(1, n_max + 1):
        subsets.extend(itertools.combinations(levels, k))
    return subsets


def evenly_spaced_rails(levels: Sequence[float],
                        k: int) -> tuple[float, ...]:
    """The conventional designer's choice: k rails evenly spanning V
    (always including V_max so the fastest point stays reachable).

    Always returns exactly ``k`` distinct rails: when index rounding
    (or duplicate input levels) collapses two linspace picks onto one
    level, the gap is backfilled with the unused level nearest to a
    linspace target.  Asking for more rails than there are distinct
    levels is a configuration error and raises ``ValueError``.
    """
    uniq = sorted(set(levels))
    if k < 1:
        raise ValueError(f"need at least one rail, got k={k}")
    if k > len(uniq):
        raise ValueError(
            f"k={k} rails requested but only {len(uniq)} distinct "
            f"voltage levels are available")
    if k == 1:
        return (uniq[-1],)
    targets = np.linspace(0, len(uniq) - 1, k)
    picked = {int(round(t)) for t in targets}
    while len(picked) < k:
        unused = [i for i in range(len(uniq)) if i not in picked]
        nearest = min(unused, key=lambda i: (
            min(abs(i - t) for t in targets), i))
        picked.add(nearest)
    return tuple(uniq[i] for i in sorted(picked))


def select_rails(
    levels: Sequence[float],
    n_max: int,
    solve_fn: Callable[..., dict | None],
    *,
    subsets: Iterable[tuple[float, ...]] | None = None,
    bound_fn: Callable[[tuple[float, ...]], float] | None = None,
) -> tuple[dict | None, tuple[float, ...] | None, dict]:
    """Enumerate rail subsets, solve each in turn, keep the best
    feasible.

    ``solve_fn(subset)`` returns an evaluation dict (with ``e_total``) or
    None when infeasible under that subset.  A cheap dominance shortcut
    skips subsets whose maximum rail is lower than the smallest max-rail
    already proven infeasible (less voltage headroom ⇒ still infeasible,
    since every per-layer latency is monotone non-increasing in voltage).

    Warm-started sweep: when ``solve_fn`` declares a ``hint`` parameter
    it is passed (by keyword) a hint dict ``{"lam_hint": λ* of the last
    solved subset}`` so the λ search can start near the answer.  When
    ``bound_fn(subset)`` (a *lower bound* on any schedule's ``e_total``
    under that subset) is given, subsets whose bound cannot beat the
    incumbent are cut without solving — since the bound is sound this
    never changes the selected subset (ties keep the earlier incumbent,
    exactly as the strict ``<`` comparison does).
    """
    subset_list = list(subsets) if subsets is not None else \
        all_rail_subsets(levels, n_max)
    # try high-voltage subsets first so the infeasibility ceiling is
    # established early
    subset_list.sort(key=lambda s: -max(s))
    takes_hint = accepts_param(solve_fn, "hint")

    best: dict | None = None
    best_subset: tuple[float, ...] | None = None
    infeasible_vmax_ceiling = -np.inf     # max rail of infeasible subsets
    stats = {"subsets_total": 0, "subsets_solved": 0,
             "subsets_skipped": 0, "subsets_cut": 0, "workers": 1}
    hint: dict = {"lam_hint": None}

    for subset in subset_list:
        stats["subsets_total"] += 1
        if max(subset) <= infeasible_vmax_ceiling:
            stats["subsets_skipped"] += 1
            continue
        # a cut subset is never solved, so the vmax ceiling stays put
        # and later lower-max subsets pay a bound_fn call the ceiling
        # skip would have saved: wasted work only, never a wrong pick
        if bound_fn is not None and best is not None and \
                bound_fn(subset) >= best["e_total"]:
            stats["subsets_cut"] += 1
            continue
        result = solve_fn(subset, hint=hint) if takes_hint \
            else solve_fn(subset)
        stats["subsets_solved"] += 1
        if result is None:
            infeasible_vmax_ceiling = max(infeasible_vmax_ceiling,
                                          max(subset))
            continue
        if result.get("lambda_star"):
            hint["lam_hint"] = result["lambda_star"]
        if best is None or result["e_total"] < best["e_total"]:
            best = result
            best_subset = subset
    return best, best_subset, stats


# ------------------------------------------- goal-aware sweep semantics

class MinEnergySelection:
    """The primal (deadline) sweep semantics:

      - incumbent = lexicographic ``(e_total, enumeration order)``
        minimum over solved subsets;
      - infeasibility ceiling: a deadline-infeasible subset's max rail
        caps every later subset with ≤ that much voltage headroom;
      - ``bound_fn`` (a sound lower bound on any schedule's ``e_total``
        under the subset) cuts subsets that provably cannot beat the
        incumbent, with the sequential tie rule (a bound *tie* only
        cuts when the incumbent enumerates earlier).
    """

    binding = "deadline"
    initial_incumbent = np.inf

    def __init__(self, bound_fn: Callable[[tuple[float, ...]], float]
                 | None = None):
        self.bound_fn = bound_fn

    def init_state(self, state: dict) -> None:
        pass

    def score(self, result: dict):
        return result["e_total"]

    def admit_skip(self, idx: int, subset: tuple[float, ...],
                   state: dict) -> str | None:
        if max(subset) <= state["ceiling"]:
            return "subsets_skipped"
        if self.bound_fn is not None and np.isfinite(state["incumbent"]):
            bound = self.bound_fn(subset)
            if state["incumbent"] < bound or (
                    state["incumbent"] == bound
                    and state["incumbent_idx"] < idx):
                return "subsets_cut"
        return None

    def note_infeasible(self, rails: tuple[float, ...],
                        state: dict) -> None:
        state["ceiling"] = max(state["ceiling"], max(rails))


class MinLatencySelection:
    """The dual (energy-budget) sweep semantics: select the fastest
    within-budget schedule, ties broken toward lower energy then
    enumeration order.

    Goal-aware generalizations of the primal cuts:

      - **infeasibility cut** (the ceiling's dual): a subset whose
        energy lower bound (``e_bound_fn``, Σ min E_op) already exceeds
        the budget can never fit it — skipped without solving; and a
        solved subset found over budget proves every *sub*-subset of it
        over budget too (fewer rails ⇒ fewer states ⇒ min energy no
        lower), mirroring "less voltage headroom ⇒ still too slow";
      - **incumbent cut**: a subset whose latency lower bound
        (``t_bound_fn``, Σ min t_op) strictly exceeds the incumbent's
        latency cannot win even on tie-breaks.

    Both cuts are sound (true lower bounds, strict comparisons), so the
    selection equals the cut-free enumeration's lexicographic
    ``((t_infer, e_total), order)`` minimum.
    """

    binding = "energy_budget"
    initial_incumbent = (np.inf, np.inf)

    def __init__(self, budget: float,
                 e_bound_fn: Callable[[tuple[float, ...]], float]
                 | None = None,
                 t_bound_fn: Callable[[tuple[float, ...]], float]
                 | None = None):
        self.budget = budget
        self.e_bound_fn = e_bound_fn
        self.t_bound_fn = t_bound_fn

    def init_state(self, state: dict) -> None:
        state["over_budget"] = []        # solved-infeasible rail sets

    def score(self, result: dict):
        return (result["t_infer"], result["e_total"])

    def admit_skip(self, idx: int, subset: tuple[float, ...],
                   state: dict) -> str | None:
        sset = set(subset)
        if any(over >= sset for over in state["over_budget"]):
            return "subsets_skipped"
        if self.e_bound_fn is not None and \
                self.e_bound_fn(subset) > self.budget:
            return "subsets_skipped"
        inc_t = state["incumbent"][0]
        if self.t_bound_fn is not None and np.isfinite(inc_t) and \
                self.t_bound_fn(subset) > inc_t:
            return "subsets_cut"
        return None

    def note_infeasible(self, rails: tuple[float, ...],
                        state: dict) -> None:
        state["over_budget"].append(set(rails))


# ------------------------------------------------ subset-stacked sweep

_DEFAULT_MAX_LIVE = 16
# size of the cold bootstrap wave: until a first feasible subset has
# published its λ* (and an incumbent for the bound cut), only this many
# tasks are admitted — a full cold fleet would burn wide bracket grids
# on every lane and rob the cuts of their early incumbent.  Admission
# deferral never changes the selection (the cuts it strengthens only
# skip provably non-winning work).
_BOOTSTRAP_LIVE = 4

# run-unique task uids: anonymous lane keys must never collide across
# sweeps sharing one StackCaches
_TASK_UIDS = itertools.count()


class StackedSweep:
    """One network's rail-subset sweep state for the round scheduler.

    Holds the enumeration-ordered admission queue, the ceiling/bound
    cuts, the lexicographic ``(e_total, enumeration index)`` incumbent,
    the per-sweep λ*-hint, and the live task list.
    :func:`run_stacked_sweeps` drives any number of these in lock-step
    rounds; each sweep's admission order, cuts, and hints depend only on
    its *own* results, so its selection is identical whether it runs
    alone or co-scheduled with other networks' sweeps.
    """

    def __init__(self, subsets: Iterable[tuple[float, ...]],
                 make_task: Callable[..., object], *,
                 bound_fn: Callable[[tuple[float, ...]], float] | None
                 = None,
                 max_live: int | None = None,
                 name: str = "net",
                 objective=None):
        self.make_task = make_task
        self.name = name
        # sweep semantics (incumbent comparisons + admission cuts) are a
        # pluggable objective; the default is the primal MinEnergy
        # behaviour with ``bound_fn`` as its incumbent-cut bound
        self.objective = objective if objective is not None \
            else MinEnergySelection(bound_fn)
        self.subset_list = list(subsets)
        # same enumeration order as select_rails: high-voltage subsets
        # first, so the infeasibility ceiling is established early
        self.subset_list.sort(key=lambda s: -max(s))
        self._subset_index = {tuple(s): i
                              for i, s in enumerate(self.subset_list)}
        # optional observer called with (rails, result) as feasible
        # subsets finish — the frontier compiler uses it to re-price a
        # tighter deadline's results into incumbent seeds for the next
        # looser point (see seed_incumbent)
        self.on_result = None
        if max_live is None:
            max_live = _DEFAULT_MAX_LIVE
        self.max_live = max(1, int(max_live))
        self.pending = deque(enumerate(self.subset_list))
        self.active: list = []
        self.state = {"ceiling": -np.inf,
                      "incumbent": self.objective.initial_incumbent,
                      "incumbent_idx": -1, "lam_hint": None}
        self.objective.init_state(self.state)
        self.results: dict[int, dict] = {}
        self.stats = {"subsets_total": 0, "subsets_solved": 0,
                      "subsets_skipped": 0, "subsets_cut": 0,
                      "workers": 1, "stack_max_live": self.max_live}

    def admit(self) -> list:
        """Admit pending subsets up to the live cap (with the
        ceiling/bound cuts and the cold bootstrap wave); returns the
        newly created tasks."""
        state, stats = self.state, self.stats
        out: list = []
        while self.pending and len(self.active) < self.max_live:
            if state["lam_hint"] is None and \
                    len(self.active) >= min(_BOOTSTRAP_LIVE,
                                            self.max_live):
                break                       # cold bootstrap wave is full
            idx, subset = self.pending.popleft()
            stats["subsets_total"] += 1
            reason = self.objective.admit_skip(idx, subset, state)
            if reason is not None:
                stats[reason] += 1
                continue
            task = self.make_task(idx, subset,
                                  {"lam_hint": state["lam_hint"]})
            task.start()
            self.active.append(task)
            out.append(task)
        return out

    def finish(self, task) -> None:
        state, stats = self.state, self.stats
        stats["subsets_solved"] += 1
        result = task.finalize()
        if result is None:
            self.objective.note_infeasible(task.rails, state)
            return
        self.results[task.idx] = result
        if result.get("lambda_star"):
            state["lam_hint"] = result["lambda_star"]
        score = self.objective.score(result)
        if (score, task.idx) < (state["incumbent"],
                                state["incumbent_idx"]):
            state["incumbent"] = score
            state["incumbent_idx"] = task.idx
        if self.on_result is not None:
            self.on_result(task.rails, result)

    def seed_incumbent(self, score: float,
                       rails: tuple[float, ...]) -> None:
        """Merge an externally-derived *achievable* score for ``rails``
        into the incumbent, with exactly :meth:`finish`'s lexicographic
        ``(score, enumeration index)`` order.

        The caller guarantees ``score`` is attainable by this sweep's
        own solve of ``rails`` (the frontier compiler re-prices a
        tighter deadline's schedule, which stays feasible at any looser
        deadline).  An achievable score can only strengthen the
        admission bound cuts — it never beats the subset's own exact
        result in :meth:`selection` (which reads solved results only),
        and the lex tie order makes a seed at exactly its own lower
        bound unable to cut its own subset.  Unknown rails (already
        filtered subsets) are ignored."""
        idx = self._subset_index.get(tuple(rails))
        if idx is None:
            return
        state = self.state
        if (score, idx) < (state["incumbent"],
                           state["incumbent_idx"]):
            state["incumbent"] = score
            state["incumbent_idx"] = idx

    def selection(self) -> tuple[dict | None, tuple[float, ...] | None]:
        """Lexicographic ``(objective score, enumeration order)``
        minimum over all solved subsets — exactly the sequential
        sweep's pick (score = ``e_total`` for the default MinEnergy
        objective, ``(t_infer, e_total)`` for the budget dual)."""
        best: dict | None = None
        best_subset: tuple[float, ...] | None = None
        score = self.objective.score
        for idx in sorted(self.results):
            result = self.results[idx]
            if best is None or score(result) < score(best):
                best = result
                best_subset = self.subset_list[idx]
        return best, best_subset


def _register_task(task, caches: StackCaches) -> None:
    """Driver-side task registration: assign the run-unique uid, default
    the lane key / bucket signature, and admit the padded tensors into
    the bucket's persistent lane store (a no-op when the store already
    holds this lane content).  The resolved store and lane index are
    pinned on the task (lanes are append-only)."""
    task.uid = next(_TASK_UIDS)
    if getattr(task, "bucket_sig", None) is None:
        task.bucket_sig = task.bucket
    if getattr(task, "lane_key", None) is None:
        task.lane_key = ("uid", task.uid)
    bs = caches.bucket(task.bucket_sig, *task.bucket)
    task.lane_store = bs
    task.lane = bs.add(task.lane_key, task.padded)


def run_stacked_sweeps(
    sweeps: Sequence[StackedSweep],
    *,
    backend=None,
    caches: StackCaches | None = None,
) -> dict:
    """Round-based subset-stacked scheduler over one or more sweeps:
    solve whole rail-subset buckets — possibly spanning *different
    networks* — in single backend kernel launches.

    Every live task of every sweep advances one λ-search round per
    iteration:

      1. **kernel phase** — tasks whose pending requests share a
         ``(kind, bucket signature, batch shape)`` are solved in ONE
         lane call (``dp_multi_lanes`` / ``kbest_multi_lanes``) over
         their resident lanes of one :class:`BucketStack`; refinement
         move scoring runs on the host over the store's view;
      2. **evaluation phase** — the fresh candidate paths of every task
         in a bucket are concatenated into one group, and every bucket's
         group is costed in ONE ``path_costs_grouped`` gather per pass;
         the deadline/idle finishing math then runs per ``(t_max,
         idle)`` subgroup;
      3. **bookkeeping phase** — finished tasks are finalized into
         their sweep (ceiling / incumbent / λ*-hint updates), and each
         sweep admits new subsets from its enumeration-ordered queue.

    Every group of a phase is launched (``defer=True``) before any
    result is collected; the ``PendingResult.get()`` calls below are the
    round barriers.  Selection is identical to running each sweep alone:
    per-lane kernel results do not depend on which lanes share a call,
    each task's round sequence depends only on its own responses, and
    each sweep's cuts/hints read only its own state.  Returns the
    fleet-level stats dict (rounds, stacked calls).
    """
    bk = get_backend(backend)
    if caches is None:
        caches = StackCaches()
    fleet = {"stacked_rounds": 0, "stacked_calls": 0,
             "networks": len(sweeps)}

    def admit_all() -> None:
        for sw in sweeps:
            for task in sw.admit():
                _register_task(task, caches)

    admit_all()
    while any(sw.active for sw in sweeps):
        active = [t for sw in sweeps for t in sw.active]
        fleet["stacked_rounds"] += 1
        # -- kernel phase: one lane call per request-shape group; the
        # lanes of a group must live in one store, hence the bucket
        # signature in every key
        groups: dict[tuple, list] = {}
        for task in active:
            req = task.request
            if req.kind == "dp":
                key = ("dp", task.bucket_sig, len(req.w_e))
            elif req.kind == "kbest":
                key = ("kbest", task.bucket_sig, len(req.mus), req.k)
            elif req.kind == "moves":
                # move scoring folds in the deadline/idle math, so the
                # group additionally keys on (t_max, idle)
                key = ("moves", task.bucket_sig,
                       task.problem.t_max, task.problem.idle)
            else:                   # "eval"/"eval_batch": no kernel
                continue
            groups.setdefault(key, []).append(task)
        raw: dict[int, object] = {}
        inflight: list[tuple[tuple, list, PendingResult]] = []
        for key, tasks in groups.items():
            fleet["stacked_calls"] += 1
            store = tasks[0].lane_store
            lanes = [t.lane for t in tasks]
            if key[0] == "dp":
                w_e = np.stack([t.request.w_e for t in tasks])
                w_t = np.stack([t.request.w_t for t in tasks])
                pend = bk.dp_multi_lanes(store, lanes, w_e, w_t,
                                         defer=True)
            elif key[0] == "kbest":
                mus = np.stack([np.asarray(t.request.mus, dtype=float)
                                for t in tasks])
                pend = bk.kbest_multi_lanes(store, lanes, mus, key[3],
                                            defer=True)
            else:                                 # refinement moves
                counts = [len(t.request.paths) for t in tasks]
                mv_lanes = np.concatenate(
                    [np.full(n, t.lane, dtype=np.int64)
                     for t, n in zip(tasks, counts)])
                pa = np.concatenate([t.request.paths for t in tasks])
                t_inf = np.concatenate([t.request.aux[0] for t in tasks])
                e_idl = np.concatenate([t.request.aux[1] for t in tasks])
                pend = PendingResult.ready(move_scores(
                    store.view(), mv_lanes, pa, t_inf, e_idl,
                    key[2], key[3]))
            inflight.append((key, tasks, pend))
        for key, tasks, pend in inflight:       # round barrier
            if key[0] == "dp":
                paths = pend.get()
                for b, t in enumerate(tasks):
                    raw[t.uid] = paths[b]
            elif key[0] == "kbest":
                paths, counts = pend.get()
                for b, t in enumerate(tasks):
                    raw[t.uid] = (paths[b], counts[b])
            else:
                mv_layer, mv_state, mv_gain = pend.get()
                off = 0
                for t in tasks:
                    n = len(t.request.paths)
                    raw[t.uid] = (mv_layer[off:off + n],
                                  mv_state[off:off + n],
                                  mv_gain[off:off + n])
                    off += n
        # -- evaluation phase: ONE cost gather per pass, a group per
        # bucket, for every fresh path of the round, then advance each
        # machine.  Machines whose next request is evaluation-only are
        # served again within the same round, so pure-eval rounds never
        # exist.
        todo = active
        while todo:
            fresh = {t.uid: t.take_kernel(raw.pop(t.uid, None))
                     for t in todo}
            by_bucket: dict[tuple, dict[tuple, list]] = {}
            for t in todo:
                if len(fresh[t.uid]):
                    fin = (t.problem.t_max, t.problem.idle)
                    by_bucket.setdefault(t.bucket_sig, {}) \
                        .setdefault(fin, []).append(t)
            evals: list[tuple[dict, np.ndarray]] = []
            gather: list[tuple] = []
            for fin_groups in by_bucket.values():
                need = [t for sub in fin_groups.values() for t in sub]
                lanes = np.concatenate(
                    [np.full(len(fresh[t.uid]), t.lane, dtype=np.int64)
                     for t in need])
                paths = np.concatenate([fresh[t.uid] for t in need])
                fleet["stacked_calls"] += 1
                gather.append((need[0].lane_store, lanes, paths))
                evals.append((fin_groups, paths))
            # the pass's barrier
            costs_all = bk.path_costs_grouped(gather) if gather else []
            for (fin_groups, paths), costs in zip(evals, costs_all):
                # the deadline/idle finishing math is shared per
                # (t_max, idle) subgroup — one vectorized pass each,
                # row-identical to per-task evaluation
                off = 0
                for sub in fin_groups.values():
                    n_sub = sum(len(fresh[t.uid]) for t in sub)
                    batch = sub[0].problem.finish_costs(
                        paths[off:off + n_sub],
                        {ck: val[off:off + n_sub]
                         for ck, val in costs.items()})
                    soff = 0
                    for t in sub:
                        n = len(fresh[t.uid])
                        t.take_rows({ck: val[soff:soff + n]
                                     for ck, val in batch.items()})
                        soff += n
                    off += n_sub
            for t in todo:
                if len(fresh[t.uid]) == 0:
                    t.take_rows(None)
            todo = [t for t in todo if t.request is not None
                    and t.request.kind in ("eval", "eval_batch")]
        # -- bookkeeping phase: completions, cuts, admission
        for sw in sweeps:
            still = []
            for task in sw.active:
                if task.request is None:
                    sw.finish(task)
                else:
                    still.append(task)
            sw.active = still
        admit_all()
    return fleet


def select_rails_stacked(
    subsets: Iterable[tuple[float, ...]],
    make_task: Callable[[int, tuple[float, ...]], object],
    *,
    bound_fn: Callable[[tuple[float, ...]], float] | None = None,
    backend=None,
    max_live: int | None = None,
    caches: StackCaches | None = None,
) -> tuple[dict | None, tuple[float, ...] | None, dict]:
    """Single-network subset-stacked sweep (see
    :func:`run_stacked_sweeps` for the round scheduler semantics and
    :class:`StackedSweep` for the per-sweep state).

    ``make_task(idx, subset, hint)`` builds a per-subset solver task
    (see :class:`repro_torch.core.lambda_dp.StackedLambdaTask`);
    ``hint`` carries the best-effort λ* of the most recently finished
    subset (``{"lam_hint": float | None}``).
    """
    sweep = StackedSweep(subsets, make_task, bound_fn=bound_fn,
                         max_live=max_live)
    fleet = run_stacked_sweeps([sweep], backend=backend, caches=caches)
    best, best_subset = sweep.selection()
    stats = dict(sweep.stats)
    stats["stacked_rounds"] = fleet["stacked_rounds"]
    stats["stacked_calls"] = fleet["stacked_calls"]
    return best, best_subset, stats


def accepts_param(fn: Callable, name: str) -> bool:
    """True when ``fn`` explicitly declares a keyword-passable ``name``
    parameter (or accepts **kwargs).  Optional protocol arguments
    (``hint`` here, ``goal`` in the orchestrator) are always passed by
    keyword, so a function with an unrelated second positional
    (``def solve(subset, retries=3)``) is never handed one by
    accident."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return False
    if name in sig.parameters:
        p = sig.parameters[name]
        return p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
    return any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values())
