"""Structure pruning (paper §4.3 / §6.5).

Removes *locally dominated* states within each layer before the DP runs.
State ``a`` is dominated by ``b`` when ``b`` is no worse in both latency
and energy by a margin that covers (i) any possible difference in the two
adjacent transition costs and (ii) the idle-energy coupling: finishing
``Δt`` earlier can add at most ``P_idle·Δt`` of terminal idle energy
(§4.2), so domination in energy must clear that too.  Under these margins
removing ``a`` can never change the optimum — §6.5: "structure pruning
produces identical schedules to the unoptimized solver while improving
run time by up to 2.14×".

The transition margin is 2× the worst-case single-transition cost (one
inbound + one outbound edge each differ by at most the max pairwise
transition cost).  Transition costs are ns/nJ while op costs are µs–ms /
µJ, so the margins stay tiny and the pruning stays effective.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.problem import ScheduleProblem, StateCost


def _worst_case_transition(problem: ScheduleProblem) -> tuple[float, float]:
    tm = problem.transition_model
    t_bound = max(tm.t_rail, tm.t_wake)
    # energy: per-domain full-swing charge, summed over domains
    n_domains = problem._volts[0].shape[1]
    c = tm._cap_scale()
    e_bound = n_domains * c * tm.v_max**2
    return t_bound, e_bound


def prune_problem(problem: ScheduleProblem, *, cache=None,
                  cache_key=None) -> tuple[ScheduleProblem, dict]:
    """Return a pruned copy of the problem + stats + index maps.

    ``cache``/``cache_key`` plug a content-addressed store of the
    per-layer keep-index maps (the fleet service's
    :class:`~repro_torch.service.ArtifactStore`, or any object with
    ``pruning(key)`` / ``put_pruning(key, maps)``): the domination
    scoring depends only on (network content, accelerator + transition
    model, gating, rails), never on the deadline or goal, so repeats
    rebuild the pruned *view* from the cached maps without re-scoring.
    Callers key by ``(content_key, gating, rails)``.
    """
    if cache is not None and cache_key is not None:
        maps = cache.pruning(cache_key)
        if maps is not None:
            return _apply_keep(problem, [list(m) for m in maps])
    index_maps = _compute_keep(problem)
    if cache is not None and cache_key is not None:
        cache.put_pruning(cache_key,
                          tuple(tuple(m) for m in index_maps))
    return _apply_keep(problem, index_maps)


def _compute_keep(problem: ScheduleProblem) -> list[list[int]]:
    """Score local domination and return the per-layer keep indices."""
    t_margin, e_margin = _worst_case_transition(problem)
    t_margin *= 2.0
    e_margin *= 2.0
    p_idle = problem.idle.p_idle

    # b dominates a ⇔ b is no slower AND cheaper even after paying
    # worst-case transition-difference + idle for the saved time:
    #   t[b] ≤ t[a]
    #   e[b] + e_margin + P_idle·(t[a] − t[b] + t_margin) ≤ e[a]
    # (In a `max()`-latency multi-domain model many states tie in
    # latency and differ only in energy — that is where most of the
    # pruning lives.  The ≤ on time can, in principle, grow T_infer
    # by ≤ 2·t_rail = 30 ns through changed transitions; schedules
    # within 30 ns of the deadline are below the timing-signoff
    # margin anyway, and the identical-schedule property is verified
    # empirically in tests, as the paper does in §6.5.)
    # All layers are scored in one padded [L, S, S] shot; padded slots
    # are excluded via the validity mask, never via inf arithmetic.
    L = problem.n_layers
    sizes = np.array(problem.sizes)
    S = int(sizes.max())
    t = np.zeros((L, S))
    e = np.zeros((L, S))
    for li in range(L):
        ti, ei = problem.op_arrays(li)
        t[li, :sizes[li]] = ti
        e[li, :sizes[li]] = ei
    valid = np.arange(S)[None, :] < sizes[:, None]

    dt = t[:, None, :] - t[:, :, None]           # t[a] − t[b], [L, b, a]
    t_ok = t[:, :, None] <= t[:, None, :]
    e_ok = (e[:, :, None] + e_margin + p_idle * (dt + t_margin)
            <= e[:, None, :])
    dom = t_ok & e_ok & valid[:, :, None] & valid[:, None, :]
    diag = np.arange(S)
    dom[:, diag, diag] = False
    # break mutual-domination ties deterministically (equal-cost
    # duplicates): keep the lowest index of each tied group
    mutual = dom & dom.transpose(0, 2, 1)
    if mutual.any():
        dom &= ~(mutual & (diag[:, None] > diag[None, :]))
        del mutual
    dominated = dom.any(axis=1)                  # [L, a]

    index_maps: list[list[int]] = []
    for li in range(L):
        n = int(sizes[li])
        keep = np.nonzero(~dominated[li, :n])[0]
        keep_idx = [int(i) for i in keep]
        if not keep_idx:                  # never empty a layer
            keep_idx = [int(np.argmin(e[li, :n]))]
        index_maps.append(keep_idx)
    return index_maps


def _apply_keep(problem: ScheduleProblem,
                index_maps: list[list[int]]
                ) -> tuple[ScheduleProblem, dict]:
    """Build the pruned view of ``problem`` from per-layer keep
    indices."""
    # array-backed parents stay array-backed: the pruned view only ever
    # needs the sliced arrays below, so no StateCost lists are built
    new_layers: list[list[StateCost]] | None = None
    if problem.layer_states is not None:
        new_layers = [[problem.layer_states[li][i] for i in keep_idx]
                      for li, keep_idx in enumerate(index_maps)]

    pruned = ScheduleProblem(
        layer_states=new_layers,
        t_max=problem.t_max,
        idle=problem.idle,
        transition_model=problem.transition_model,
        rails=problem.rails,
        name=problem.name + "+pruned",
        layer_sizes=tuple(len(keep) for keep in index_maps),
    )
    # share the parent's already-materialized arrays as index slices —
    # the pruned view never re-runs _pairwise_transition (or the
    # per-state array derivation) for data the parent already has
    pruned._t_op_c = [problem._t_op[i][keep]
                      for i, keep in enumerate(index_maps)]
    pruned._e_op_c = [problem._e_op[i][keep]
                      for i, keep in enumerate(index_maps)]
    pruned._volts_c = [problem._volts[i][keep]
                       for i, keep in enumerate(index_maps)]
    for i, (tt, et, sw) in problem._trans_cache.items():
        sel = np.ix_(index_maps[i], index_maps[i + 1])
        pruned._trans_cache[i] = (tt[sel], et[sel], sw[sel])
    if problem._trans_src is not None:
        # master-backed parent: compose the keep-selection with the
        # parent's master rows, so an untouched pair later materializes
        # with ONE gather at pruned size instead of two
        pruned._trans_src = problem._trans_src
        pruned._trans_sel = [
            sel_i[keep] for sel_i, keep in zip(problem._trans_sel,
                                               index_maps)]
    info = {
        "states_before": problem.n_states(),
        "states_after": pruned.n_states(),
        "removed": problem.n_states() - pruned.n_states(),
        "edges_before": problem.n_edges(),
        "edges_after": pruned.n_edges(),
        "index_maps": index_maps,
    }
    return pruned, info


def unprune_path(path: list[int], index_maps: list[list[int]]) -> list[int]:
    """Map a path in the pruned problem back to original state indices."""
    return [index_maps[i][s] for i, s in enumerate(path)]
