"""Fleet compile service: many networks, one accelerator, shared work.

The paper compiles one schedule per deployment (§3.3); a deployment
service compiles *many* networks for one accelerator under heavy
traffic — and, with the goal API, under a *mix of objectives*.
:class:`CompileService` wraps the staged compiler with the
process-wide :class:`~repro_torch.service.store.ArtifactStore`:

  - ``compile(...)`` answers repeat requests from the persistent
    schedule cache (keyed by network content hash × compile goal ×
    semantic config) and warm-starts cold compiles from the store's
    characterization / master-table / transition / pruning /
    lane-store caches;
  - ``compile_many([...])`` additionally co-schedules the rail-subset
    sweeps of every request in ONE round scheduler
    (:func:`~repro_torch.core.rails.run_stacked_sweeps`): rail subsets from
    different networks — and different *goals*: deadline (MinEnergy)
    and budget (MinLatency) sweeps, plus every point of a ParetoFront
    — that share a padded bucket are stacked into the same lane axis
    and advanced in one kernel launch per round — one fleet per
    device: requests group by ``cfg.device`` and each device's sweeps
    run on its own :class:`~repro_torch.core.backend.TorchBackend`.

Warm or cold, stacked or solo, the emitted schedules are identical to
``compile_power_schedule`` / ``repro_torch.core.compile`` run from
scratch: every shared artifact is content-addressed and immutable,
per-lane kernel results do not depend on which lanes share a launch,
and each sweep reads only its own cuts and hints (see
:mod:`repro_torch.core.rails`).  A request on ``device="cuda"`` always
runs on the card; the service never moves it to the CPU.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.analysis.lockcheck import barrier as lock_barrier
from repro_torch.analysis.lockcheck import make_lock
from repro_torch.core import orchestrator as _orchestrator
from repro_torch.core.context import CompilationContext
from repro_torch.core.goals import (
    Goal,
    InfeasibleGoal,
    MinEnergy,
    MinLatency,
    ParetoFront,
    ParetoFrontier,
    ParetoPoint,
    as_goal,
)
from repro_torch.core.policies import OrchestratorConfig, stacked_compile_job
from repro_torch.core.rails import run_stacked_sweeps
from repro_torch.core.schedule import PowerSchedule
from repro_torch.hw.edge40nm import EDGE40NM_DEFAULT, Edge40nmAccelerator
from repro_torch.perfmodel.layer_costs import LayerSpec
from repro_torch.service.store import _INFEASIBLE, ArtifactStore

# config fields that provably cannot change the emitted schedule (the
# parallel and stacked sweeps are selection-identical to the sequential
# one, see repro_torch.core.rails) — excluded from the schedule-cache
# key so operational knobs don't fragment the cache.  Everything else
# (policy, rails budget, solver options) stays in the key.
_NON_SEMANTIC_CFG = ("stack_max_live",)


def _cfg_key(cfg: OrchestratorConfig) -> str:
    d = dataclasses.asdict(cfg)
    for field in _NON_SEMANTIC_CFG:
        d.pop(field, None)
    # the device is not semantic either: a schedule compiled on the
    # card is byte for byte the CPU's (the kernels are held exactly
    # against their plain versions), so every device shares one entry
    del d["device"]
    d["backend"] = "torch"
    return repr(sorted(d.items()))


@dataclasses.dataclass
class CompileRequest:
    """One deployment point of a ``compile_many`` batch.

    ``goal`` makes the objective explicit (results come back as the
    goal API returns them: schedules, structured
    :class:`InfeasibleGoal`, or a :class:`ParetoFrontier`).  With
    ``goal=None`` the request is the legacy form — MinEnergy at
    ``target_rate_hz``, ``None`` for infeasible.
    """

    specs: Sequence[LayerSpec]
    target_rate_hz: float | None = None
    cfg: OrchestratorConfig | None = None
    network: str = "net"
    goal: Goal | None = None
    #: optional cost model (anything with a ``digest`` and an
    #: ``apply(costs)``) the compile runs under; its digest is part of
    #: the context's content key, so calibrated and static requests
    #: never share schedule-cache entries — but batches mixing models
    #: still co-schedule their sweeps in one fleet.
    cost_model: object | None = None

    def resolve_goal(self) -> Goal:
        if self.goal is not None:
            if self.target_rate_hz is not None:
                raise ValueError(
                    "CompileRequest got both target_rate_hz and goal= "
                    "— they may conflict; give exactly one (use "
                    "MinEnergy(rate_hz=...) for the legacy form)")
            return as_goal(self.goal)
        if self.target_rate_hz is None:
            raise ValueError(
                "CompileRequest needs target_rate_hz or goal=")
        return MinEnergy(rate_hz=self.target_rate_hz)


@dataclasses.dataclass
class ContingencyBundle:
    """The precompiled operating points of one network's online control
    plane (:mod:`repro_torch.serve.control_plane`), produced by ONE
    ``compile_many`` fleet call so a traffic spike at serve time snaps
    to a finished schedule instead of waiting on a cold compile.

    ``points`` is the snap table (the energy–latency frontier: compiled
    deadline → schedule); ``tightened`` maps each of those deadlines to
    a schedule compiled at ``tighten_frac`` × the deadline (slack
    headroom that absorbs cost-model error and transition jitter — the
    degradation ladder's first escalation); ``aggressive`` is the
    max-performance schedule (fastest deployable point); ``budget`` is
    the energy-budget-tightened variant (MinLatency: the fastest
    schedule within a bounded energy envelope).  Points whose goal came
    back infeasible are recorded in ``infeasible`` rather than silently
    dropped.
    """

    network: str
    base_deadline_s: float
    tighten_frac: float
    points: dict[float, PowerSchedule]
    tightened: dict[float, PowerSchedule]
    aggressive: PowerSchedule | None = None
    budget: PowerSchedule | None = None
    infeasible: list = dataclasses.field(default_factory=list)

    def deadlines(self) -> list[float]:
        return sorted(self.points)

    def merge_points(self, other: "ContingencyBundle") -> None:
        """Fold another bundle's snap/tightened points in (the async
        re-solve path extends coverage without replacing the plan)."""
        self.points.update(other.points)
        self.tightened.update(other.tightened)
        self.infeasible.extend(other.infeasible)


class CompileService:
    """Compile deployment power schedules against one accelerator,
    amortizing all content-addressable work across requests (and, with
    ``compile_many``, across networks — and goals — inside one round
    scheduler).

    One service instance (or at least one shared :class:`ArtifactStore`)
    per accelerator per process is the intended deployment shape; the
    store is thread-safe, so concurrent ``compile``/``compile_many``
    calls may share it.
    """

    def __init__(self, acc: Edge40nmAccelerator = EDGE40NM_DEFAULT,
                 store: ArtifactStore | None = None, *,
                 use_schedule_cache: bool = True,
                 disk_path=None):
        if store is not None and disk_path is not None:
            raise ValueError(
                "give store= or disk_path=, not both — a disk-backed "
                "store is built from disk_path; an explicit store "
                "already decided its own backing")
        self.acc = acc
        self.store = store if store is not None \
            else ArtifactStore(disk_path=disk_path)
        self.use_schedule_cache = use_schedule_cache
        self._async_lock = make_lock("compile_service._async_lock")
        self._async_pool: concurrent.futures.Executor | None = None

    # -- lifecycle -----------------------------------------------------
    def close(self, *, wait: bool = True) -> None:
        """Deterministically shut down the service's background resolve
        pool (cancelling queued compiles; ``wait=False`` detaches
        without joining — the :meth:`abandon_async_pool` watchdog
        semantics) and flush any deferred disk publications.  Safe to
        call repeatedly; the service stays usable afterwards (a new
        async submit lazily builds a fresh pool).  Benches, farm
        workers, and examples call this — or use the service as a
        context manager — so the interpreter never hangs on a
        non-daemon pool thread at exit."""
        with self._async_lock:
            pool, self._async_pool = self._async_pool, None
        if pool is not None:
            pool.shutdown(wait=wait, cancel_futures=True)
        self.store.flush_disk()

    def __enter__(self) -> "CompileService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- single compile ------------------------------------------------
    def context_for(self, specs: Sequence[LayerSpec],
                    target_rate_hz: float | None = None, *,
                    cfg: OrchestratorConfig | None = None,
                    network: str = "net",
                    cost_model=None) -> CompilationContext:
        """A store-backed context for one network (reusable across
        policies, goals, and deadlines via ``compile(..., ctx=...)``).
        ``cost_model`` builds it under a calibrated characterization."""
        cfg = cfg or OrchestratorConfig()
        return CompilationContext(
            specs, target_rate_hz, acc=self.acc, network=network,
            e_switch_nom=cfg.e_switch_nom, store=self.store,
            cost_model=cost_model)

    def _schedule_key(self, ctx: CompilationContext, goal: Goal,
                      cfg: OrchestratorConfig) -> tuple:
        return (ctx.content_key, goal.key(), _cfg_key(cfg))

    def _cached(self, key: tuple, network: str, *,
                legacy: bool = True
                ) -> PowerSchedule | InfeasibleGoal | None | str:
        """Schedule-cache lookup: a schedule, an infeasible sentinel
        (legacy string or structured :class:`InfeasibleGoal`), or None
        on miss.  The cached artifact is content-keyed, so only the
        cosmetic network label is rebound to the request's.

        A goal-API caller (``legacy=False``) treats the *legacy*
        string sentinel as a miss: it carries no reason/bound, so the
        point is recompiled once into a structured
        :class:`InfeasibleGoal` rather than fabricating one.
        """
        if not self.use_schedule_cache:
            return None
        hit = self.store.schedule(key)
        if hit == _INFEASIBLE and not legacy:
            return None
        if isinstance(hit, (PowerSchedule, InfeasibleGoal)) \
                and hit.network != network:
            hit = dataclasses.replace(hit, network=network)
        return hit

    def compile(self, specs: Sequence[LayerSpec],
                target_rate_hz: float | None = None, *,
                cfg: OrchestratorConfig | None = None,
                network: str = "net", goal: Goal | None = None,
                cost_model=None
                ) -> PowerSchedule | InfeasibleGoal | ParetoFrontier \
            | None:
        """Compile one deployment point through the store (schedule
        cache first, then a warm-started cold compile).

        With an explicit ``goal`` the result follows the goal API
        (schedule / :class:`InfeasibleGoal` / :class:`ParetoFrontier`);
        the legacy rate-only form keeps returning ``None`` for an
        infeasible deadline.  ParetoFront goals cache *per point* under
        the equivalent MinEnergy keys, so frontier and point traffic
        share cache entries.  ``cost_model`` compiles under a
        calibrated characterization (own cache namespace via the
        context content key).
        """
        legacy = goal is None
        if goal is not None and target_rate_hz is not None:
            raise ValueError(
                "compile() got both target_rate_hz and goal= — they "
                "may conflict; give exactly one (use "
                "MinEnergy(rate_hz=...) for the legacy form)")
        cfg = cfg or OrchestratorConfig()
        resolved = goal if goal is not None \
            else CompileRequest(specs, target_rate_hz).resolve_goal()
        resolved = as_goal(resolved)
        if isinstance(resolved, ParetoFront):
            # the batched driver IS the frontier implementation (one
            # unit per point, per-point MinEnergy cache keys, in-batch
            # dedup of repeated deadlines)
            return self.compile_many([CompileRequest(
                specs, cfg=cfg, network=network, goal=resolved,
                cost_model=cost_model)])[0]
        ctx = self.context_for(specs, cfg=cfg, network=network,
                               cost_model=cost_model)
        if isinstance(resolved, MinEnergy):
            # legacy custom policies read the deadline off the context;
            # the context is otherwise deadline-free (fresh per call)
            ctx.t_max = resolved.deadline
        key = self._schedule_key(ctx, resolved, cfg)
        hit = self._cached(key, network, legacy=legacy)
        if hit is not None:
            return self._emit(hit, legacy)
        self.store.backend(cfg.device)     # stats() reports its counters
        sched = _orchestrator.compile(
            specs, resolved, cfg=cfg, acc=self.acc, network=network,
            ctx=ctx)
        if self.use_schedule_cache:
            self.store.put_schedule(key, sched)
        return self._emit(sched, legacy)

    @staticmethod
    def _emit(result, legacy: bool):
        """Translate a cache/compile result for the caller: legacy
        (rate-only) calls keep ``None`` for infeasible (whether the
        entry is the legacy string sentinel or a structured
        InfeasibleGoal); goal calls get the structured value (goal
        lookups never see the string sentinel — ``_cached`` treats it
        as a miss)."""
        if result == _INFEASIBLE:
            return None
        if legacy and isinstance(result, InfeasibleGoal):
            return None
        return result

    # -- batched compile ----------------------------------------------
    def compile_many(self, requests: Sequence[CompileRequest], *,
                     stack_networks: bool = True) -> list:
        """Compile a batch of deployment points, sharing work three
        ways: the schedule cache answers repeats (within the batch and
        across calls), the artifact store warm-starts every context,
        and — with ``stack_networks`` — all stackable rail sweeps run
        in ONE round scheduler, so same-bucket subsets of different
        networks advance in single backend calls.

        Requests may mix goals freely: MinEnergy and MinLatency sweeps
        co-schedule in the same fleet (their tasks group purely by
        padded bucket and batch shape), and each ParetoFront request
        contributes one sweep per point.  Results are positionally
        aligned with ``requests`` and identical to per-request
        ``compile`` calls (which are in turn identical to cold
        goal-API compiles).

        On a disk-backed store the whole batch publishes its disk
        entries once, at the end (``deferred_publication``) — a farm
        worker's cross-process writes are batched per admitted batch,
        never interleaved into the solve loop.
        """
        with self.store.deferred_publication():
            return self._compile_many(requests,
                                      stack_networks=stack_networks)

    def _compile_many(self, requests: Sequence[CompileRequest], *,
                      stack_networks: bool = True) -> list:
        results: list = [None] * len(requests)
        # one solve unit per (request, frontier point); units carry the
        # slot to write: (request index, point index | None)
        pending_units: list[dict] = []
        frontier_points: dict[int, list] = {}
        ctxs: dict[int, CompilationContext] = {}
        for i, req in enumerate(requests):
            cfg = req.cfg or OrchestratorConfig()
            goal = req.resolve_goal()
            ctx = self.context_for(req.specs, cfg=cfg,
                                   network=req.network,
                                   cost_model=req.cost_model)
            ctxs[i] = ctx
            if isinstance(goal, ParetoFront):
                deadlines = goal.resolve_deadlines(
                    ctx.min_t_op_bound(ctx.levels))
                frontier_points[i] = [None] * len(deadlines)
                for j, deadline in enumerate(deadlines):
                    pending_units.append(
                        {"slot": (i, j), "req": req, "cfg": cfg,
                         "ctx": ctx, "goal": MinEnergy(
                             deadline_s=deadline),
                         "deadline": deadline, "legacy": False})
            else:
                if isinstance(goal, MinEnergy):
                    # fresh per-request context; legacy custom policies
                    # read the deadline off it
                    ctx.t_max = goal.deadline
                pending_units.append(
                    {"slot": (i, None), "req": req, "cfg": cfg,
                     "ctx": ctx, "goal": goal,
                     "legacy": req.goal is None})

        first_of_key: dict[tuple, dict] = {}
        dups: list[tuple[dict, dict]] = []
        # device -> (its backend, unit list)
        fleets: dict[str, tuple] = {}

        def write(unit: dict, value) -> None:
            i, j = unit["slot"]
            if j is None:
                results[i] = self._emit(value, unit["legacy"])
            else:
                frontier_points[i][j] = ParetoPoint(
                    unit["deadline"], self._emit(value, False))

        for unit in pending_units:
            cfg, ctx, goal = unit["cfg"], unit["ctx"], unit["goal"]
            key = self._schedule_key(ctx, goal, cfg)
            unit["key"] = key
            hit = self._cached(key, unit["req"].network,
                               legacy=unit["legacy"])
            if hit is not None:
                write(unit, hit)
                continue
            if key in first_of_key:        # in-batch duplicate: solve once
                dups.append((unit, first_of_key[key]))
                continue
            first_of_key[key] = unit
            job = stacked_compile_job(
                ctx, cfg, caches=self.store.stack_caches, goal=goal) \
                if stack_networks else None
            backend = self.store.backend(cfg.device)
            if job is None:
                # non-stackable policy/config: plain warm compile
                value = _orchestrator.compile(
                    unit["req"].specs, goal, cfg=cfg, acc=self.acc,
                    network=unit["req"].network, ctx=ctx)
                if self.use_schedule_cache:
                    self.store.put_schedule(key, value)
                unit["value"] = value
                write(unit, value)
            else:
                unit["job"] = job
                fleets.setdefault(str(backend.device),
                                  (backend, []))[1].append(unit)
        # one round scheduler per device: every live rail subset of
        # every network — whatever its goal — advances one λ-search
        # round per kernel launch
        for backend, units in fleets.values():
            for unit in units:
                unit["job"].start_clock()  # exclude other fleets' solves
            # the stacked-sweep round loop blocks until every live rail
            # subset converges — entering it with a service/store lock
            # held would starve every other compilation (checked under
            # PFDNN_LOCKCHECK=1)
            lock_barrier("compile_many")
            fleet = run_stacked_sweeps(
                [unit["job"].sweep for unit in units],
                backend=backend,
                caches=self.store.stack_caches)
            for unit in units:
                sched = unit["job"].emit(fleet)
                value = sched if sched is not None \
                    else _orchestrator.infeasible_result(unit["goal"],
                                                         unit["ctx"])
                if self.use_schedule_cache:
                    self.store.put_schedule(unit["key"], value)
                unit["value"] = value
                write(unit, value)
        # resolve in-batch duplicates (shared solve, rebound label)
        for unit, first in dups:
            value = first["value"]
            if isinstance(value, (PowerSchedule, InfeasibleGoal)) \
                    and value.network != unit["req"].network:
                value = dataclasses.replace(
                    value, network=unit["req"].network)
            write(unit, value)
        # assemble frontiers
        for i, pts in frontier_points.items():
            results[i] = ParetoFrontier(network=requests[i].network,
                                        points=pts)
        return results

    # -- contingency batch (online serving) ---------------------------
    def compile_contingencies(
            self, specs: Sequence[LayerSpec], base_rate_hz: float, *,
            rate_band: tuple[float, float] = (0.4, 3.0),
            n_points: int = 8, tighten_frac: float = 0.8,
            budget_frac: float | None = 2.0,
            aggressive_frac: float = 0.95,
            cfg: OrchestratorConfig | None = None,
            network: str = "net",
            cost_model=None) -> ContingencyBundle:
        """Precompile an online control plane's full contingency set in
        ONE ``compile_many`` fleet call (all sweeps co-scheduled, every
        artifact shared through the store):

          - the snap frontier: ``n_points`` deadlines spanning rates
            ``base_rate_hz × rate_band`` (the base deadline itself is
            always on the grid, so calm traffic snaps to exactly the
            schedule a static deployment would run);
          - the deadline-tightened variants: each grid deadline
            recompiled at ``tighten_frac`` × deadline (slack headroom —
            the graceful-degradation ladder's first escalation);
          - the ``aggressive`` max-performance point: MinEnergy at
            ``min_time_bound / aggressive_frac`` (the fastest
            deployable deadline, the ladder's last rung);
          - the energy-budget-tightened variant: MinLatency at
            ``budget_frac`` × the network's min-energy lower bound
            (``budget_frac=None`` skips it — required for policies
            like the greedy ascents that only solve MinEnergy goals).

        Grid deadlines provably below the min-time bound are never
        requested; points that still come back infeasible are recorded
        in ``bundle.infeasible``.

        ``cost_model`` compiles every contingency under a calibrated
        characterization (the adaptive scheduler's ledger-learned
        re-solve path).
        """
        if not (base_rate_hz > 0.0):
            raise ValueError(
                f"compile_contingencies needs base_rate_hz > 0, got "
                f"{base_rate_hz!r}")
        lo, hi = rate_band
        if not (0.0 < lo <= 1.0 <= hi):
            raise ValueError(
                f"rate_band must satisfy 0 < lo <= 1 <= hi so the base "
                f"rate is covered, got {rate_band!r}")
        if not (0.0 < tighten_frac < 1.0):
            raise ValueError(
                f"tighten_frac must lie in (0, 1), got {tighten_frac!r}")
        cfg = cfg or OrchestratorConfig()
        ctx = self.context_for(specs, cfg=cfg, network=network,
                               cost_model=cost_model)
        min_t = ctx.min_t_op_bound(ctx.levels)
        min_e = ctx.min_e_op_bound(ctx.levels)
        aggr_deadline = min_t / aggressive_frac
        base_deadline = 1.0 / base_rate_hz

        rates = np.geomspace(base_rate_hz * lo, base_rate_hz * hi,
                             n_points)
        grid = sorted({float(1.0 / r) for r in rates}
                      | {base_deadline, aggr_deadline})
        grid = [d for d in grid if d >= aggr_deadline]
        tight = {d: tighten_frac * d for d in grid
                 if tighten_frac * d >= aggr_deadline}

        requests = [CompileRequest(
            specs, cfg=cfg, network=network,
            goal=ParetoFront(deadlines=tuple(grid)),
            cost_model=cost_model)]
        if tight:
            requests.append(CompileRequest(
                specs, cfg=cfg, network=network,
                goal=ParetoFront(
                    deadlines=tuple(sorted(tight.values()))),
                cost_model=cost_model))
        requests.append(CompileRequest(
            specs, cfg=cfg, network=network,
            goal=MinEnergy(deadline_s=aggr_deadline),
            cost_model=cost_model))
        if budget_frac is not None:
            requests.append(CompileRequest(
                specs, cfg=cfg, network=network,
                goal=MinLatency(energy_budget_j=budget_frac * min_e),
                cost_model=cost_model))
        results = self.compile_many(requests)

        bundle = ContingencyBundle(
            network=network, base_deadline_s=base_deadline,
            tighten_frac=tighten_frac, points={}, tightened={})
        frontier = results[0]
        for pt in frontier.points:
            if pt.feasible:
                bundle.points[pt.deadline_s] = pt.schedule
            else:
                bundle.infeasible.append(("point", pt.deadline_s,
                                          pt.schedule))
        if tight:
            by_tight = {}
            for pt in results[1].points:
                if pt.feasible:
                    by_tight[pt.deadline_s] = pt.schedule
                else:
                    bundle.infeasible.append(
                        ("tightened", pt.deadline_s, pt.schedule))
            bundle.tightened = {d: by_tight[td]
                                for d, td in tight.items()
                                if td in by_tight}
        aggr = results[2] if tight else results[1]
        if isinstance(aggr, PowerSchedule):
            bundle.aggressive = aggr
        else:
            bundle.infeasible.append(("aggressive", aggr_deadline, aggr))
        if budget_frac is not None:
            budget = results[-1]
            if isinstance(budget, PowerSchedule):
                bundle.budget = budget
            else:
                bundle.infeasible.append(
                    ("budget", budget_frac * min_e, budget))
        return bundle

    # -- async re-solve (online serving) ------------------------------
    def compile_many_async(self, requests: Sequence[CompileRequest],
                           **kwargs) -> concurrent.futures.Future:
        """Submit a ``compile_many`` batch to the service's background
        compile thread and return its Future — the online control
        plane's re-solve entry: the serving loop polls the future
        between intervals and never blocks on a compile.  The store is
        thread-safe, so background solves share every artifact with
        foreground ``compile`` calls.
        """
        return self._submit_async(self.compile_many, list(requests),
                                  **kwargs)

    def compile_contingencies_async(self, specs: Sequence[LayerSpec],
                                    base_rate_hz: float, **kwargs
                                    ) -> concurrent.futures.Future:
        """Background :meth:`compile_contingencies` — the adaptive
        scheduler's sustained-drift re-solve: the returned Future
        resolves to a fresh :class:`ContingencyBundle` whose points are
        merged into the live one (``merge_points``) when polled done."""
        return self._submit_async(self.compile_contingencies, specs,
                                  base_rate_hz, **kwargs)

    def _submit_async(self, fn, *args, **kwargs
                      ) -> concurrent.futures.Future:
        with self._async_lock:
            if self._async_pool is None:
                self._async_pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="pfdnn-resolve")
            pool = self._async_pool
        return pool.submit(fn, *args, **kwargs)

    def abandon_async_pool(self) -> None:
        """Detach the background compile pool (watchdog path): a hung or
        over-slow re-solve keeps its thread, but the next
        :meth:`compile_many_async` gets a fresh pool instead of queueing
        behind it.  The abandoned compile finishes (or hangs) in the
        background; its writes to the thread-safe store stay valid."""
        with self._async_lock:
            pool, self._async_pool = self._async_pool, None
        if pool is not None:
            pool.shutdown(wait=False)

    # -- maintenance ---------------------------------------------------
    def save(self, path) -> None:
        """Persist the store (see :meth:`ArtifactStore.save`)."""
        self.store.save(path)

    def load(self, path) -> "CompileService":
        self.store.load(path)
        return self

    def trim(self, max_lanes: int = 4096) -> bool:
        """Bound the resident subset lane stores (drop-and-rebuild; see
        :meth:`ArtifactStore.trim_stacks`).  Call between batches — not
        concurrently with an in-flight compile on the same store."""
        return self.store.trim_stacks(max_lanes)
