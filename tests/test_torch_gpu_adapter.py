"""The PF-DNN adapter for the card's power domains against the JAX
package's accelerator adapter.

A :class:`GpuChipModel` built from the fields of the reference's
``TPU_V5E``, read here and mapped field by field (no number of that chip
is written in the port), builds ``build_tpu_problem``'s problem bit for
bit: every ``StateCost`` (voltages, ``t_op``, ``e_op``, label), the
``IdleModel``, the transitions, the rails; and ``solve_lambda_dp`` +
``refine_candidates`` on the CPU port give the reference's paths and
energies exactly.  Then the reference's end-to-end test of its adapter
(``tests/test_system.py::test_tpu_adapter_end_to_end``) with
``H100_SXM``: feasible, and cheaper than the all-max static assignment.
"""

import dataclasses

import pytest

from repro.core import refine_candidates as ref_refine
from repro.core import solve_lambda_dp as ref_solve
from repro.core.tpu_adapter import build_tpu_problem
from repro.core.tpu_adapter import layer_costs_from_dryrun as ref_layers
from repro.hw.tpu import TPU_V5E
from repro_torch.core import refine_candidates, solve_lambda_dp
from repro_torch.core.gpu_adapter import (
    GpuLayerCost,
    build_gpu_problem,
    layer_costs_from_dryrun,
)
from repro_torch.hw.gpu import H100_SXM, GpuChipModel

# the port's field ← the reference chip's field
FIELDS = {
    "peak_flops_bf16": "peak_flops_bf16", "hbm_bw": "hbm_bw",
    "nvlink_bw_per_link": "ici_bw_per_link", "hbm_bytes": "hbm_bytes",
    "v_min": "v_min", "v_max": "v_max", "v_step": "v_step",
    "v_nom": "v_nom", "p_sm_dyn_nom": "p_mxu_dyn_nom",
    "p_hbm_dyn_nom": "p_hbm_dyn_nom", "p_nvlink_dyn_nom": "p_ici_dyn_nom",
    "p_leak_total": "p_leak_total", "leak_split": "leak_split",
    "t_rail": "t_rail", "t_wake": "t_wake", "e_switch_nom": "e_switch_nom",
}


def _ref_chip_as_gpu() -> GpuChipModel:
    assert set(FIELDS) == {f.name for f in dataclasses.fields(GpuChipModel)}
    assert set(FIELDS.values()) == {
        f.name for f in dataclasses.fields(type(TPU_V5E))}
    return GpuChipModel(**{mine: getattr(TPU_V5E, theirs)
                           for mine, theirs in FIELDS.items()})


RECORD = {"cost": {"flops_per_device": 40e12, "bytes_per_device": 80e9,
                   "collective_bytes_per_device": 5e9}}
NO_COLL = {"cost": {"flops_per_device": 60e9, "bytes_per_device": 15e9,
                    "collective_bytes_per_device": 0.0}}


def _states(problem) -> list:
    return [[(s.voltages, s.t_op, s.e_op, s.label) for s in layer]
            for layer in problem.layer_states]


def test_chip_model_matches_the_reference_given_its_constants():
    chip = _ref_chip_as_gpu()
    assert chip.levels() == TPU_V5E.levels()
    for d in range(3):
        assert dataclasses.asdict(chip.dvfs(d)) == \
            dataclasses.asdict(TPU_V5E.dvfs(d))
        assert chip.dyn_power_nom(d) == TPU_V5E.dyn_power_nom(d)
    assert dataclasses.asdict(chip.transitions()) == \
        dataclasses.asdict(TPU_V5E.transitions())


@pytest.mark.parametrize("record", [RECORD, NO_COLL])
@pytest.mark.parametrize("gateable", [0.0, 0.9])
def test_layer_costs_match_the_reference(record, gateable):
    got = layer_costs_from_dryrun(record, 7, gateable)
    want = ref_layers(record, 7, gateable)
    assert [(c.name, c.flops, c.hbm_bytes, c.nvlink_bytes,
             c.gateable_fraction) for c in got] == \
        [(c.name, c.flops, c.hbm_bytes, c.ici_bytes, c.gateable_fraction)
         for c in want]
    assert all(isinstance(c, GpuLayerCost) for c in got)


CASES = [
    # record, layers, gateable, rails, deadline × compute floor, gating,
    # allow_sleep
    (RECORD, 24, 0.9, (0.7, 0.85, 1.0), 3.0, True, True),
    (RECORD, 12, 0.0, (0.7, 0.8, 0.9, 1.0), 1.5, True, False),
    (NO_COLL, 28, 0.0, (0.7, 0.85, 1.0), 2.0, True, True),
    (NO_COLL, 28, 0.75, (0.75, 1.0), 4.0, False, True),
]


@pytest.mark.parametrize("case", CASES)
def test_problem_and_schedule_equal_the_reference(case):
    record, n, gate, rails, slack, gating, sleep = case
    chip = _ref_chip_as_gpu()
    deadline = record["cost"]["bytes_per_device"] / chip.hbm_bw * slack \
        + record["cost"]["flops_per_device"] / chip.peak_flops_bf16
    prob = build_gpu_problem(layer_costs_from_dryrun(record, n, gate),
                             rails, deadline, chip=chip, gating=gating,
                             allow_sleep=sleep, name="qwen")
    ref = build_tpu_problem(ref_layers(record, n, gate), rails, deadline,
                            gating=gating, allow_sleep=sleep, name="qwen")
    assert _states(prob) == _states(ref)
    assert dataclasses.asdict(prob.idle) == dataclasses.asdict(ref.idle)
    assert dataclasses.asdict(prob.transition_model) == \
        dataclasses.asdict(ref.transition_model)
    assert (prob.rails, prob.name, prob.t_max) == \
        (ref.rails, ref.name, ref.t_max)

    best, cands, _ = solve_lambda_dp(prob, backend="cpu")
    ref_best, ref_cands, _ = ref_solve(ref)
    assert best is not None and ref_best is not None
    assert best["path"] == ref_best["path"]
    assert best["e_total"] == ref_best["e_total"]
    assert [c["path"] for c in cands] == [c["path"] for c in ref_cands]
    assert [c["e_total"] for c in cands] == [c["e_total"] for c in ref_cands]
    refined, moves = refine_candidates(prob, cands)
    ref_refined, ref_moves = ref_refine(ref, ref_cands)
    assert moves == ref_moves
    assert refined["path"] == ref_refined["path"]
    for key in ("e_total", "t_infer", "feasible"):
        assert refined[key] == ref_refined[key]


def test_h100_adapter_end_to_end():
    """PF-DNN over the card's roofline terms: solves, meets the deadline,
    and beats the all-max-rail static assignment."""
    layers = layer_costs_from_dryrun(RECORD, n_layers=24,
                                     gateable_fraction=0.9)
    rails = (0.7, 0.85, 1.0)
    assert H100_SXM.v_min <= min(rails) and max(rails) <= H100_SXM.v_max
    t_deadline = 40e12 / H100_SXM.peak_flops_bf16 * 3.0
    prob = build_gpu_problem(layers, rails, t_deadline)
    best, cands, _ = solve_lambda_dp(prob, backend="cpu")
    assert best is not None and best["feasible"]
    refined, _ = refine_candidates(prob, cands)
    assert refined["t_infer"] <= t_deadline
    static = prob.evaluate([
        next(i for i, s in enumerate(states)
             if s.voltages == (1.0, 1.0, 1.0))
        for states in prob.layer_states])
    assert refined["e_total"] < static["e_total"]


def test_h100_model_sums_to_the_board_limit():
    chip = H100_SXM
    busy = sum(chip.dyn_power_nom(d) for d in range(3)) + chip.p_leak_total
    assert chip.v_nom == chip.v_max
    assert busy == 700.0
    assert sum(chip.leak_split) == 1.0
    assert chip.peak_flops_bf16 == 989e12 and chip.hbm_bw == 3.35e12
    assert chip.nvlink_bw_per_link * 18 == 900e9
