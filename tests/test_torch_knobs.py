"""The port's config knobs, held on the CPU against the JAX package's
numpy backend:

  - ``OrchestratorConfig`` keeps the reference's ``stack_max_live`` (and
    its default) and refuses by name the reference fields the port
    leaves out: ``backend`` / ``pallas`` (the port has ``device``) and
    the knobs of the scalar and thread-pool sweeps (``batch_lambda``,
    ``sweep_workers``, ``stack_subsets``), which select slower routes to
    the same schedules;
  - the three ``pfdnn`` goldens under an explicit ``stack_max_live``:
    ``to_json`` byte-identical to the reference (wall-clock and
    backend-name stats aside) and equal to the golden, and the cap
    reaches the scheduler;
  - ``TorchBackend.io_stats`` counts exactly when 4 threads drive lane
    calls on one backend.
"""

import dataclasses
import json
import pathlib
import sys
import threading

import numpy as np
import pytest

import repro.core as R
from conftest import max_rate, random_problem
from repro.models.edge_cnn import edge_network as ref_network
from repro_torch.core import (
    IdleModel,
    MinEnergy,
    OrchestratorConfig,
    ScheduleProblem,
    StateCost,
    compile,
)
from repro_torch.core.backend import BucketStack, TorchBackend, build_padded
from repro_torch.hw.dvfs import TransitionModel
from repro_torch.models.edge_cnn import edge_network

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden"
                     / "pipeline.json").read_text())
PFDNN_KEYS = ["squeezenet1.1|0.9|2|pfdnn", "squeezenet1.1|0.5|3|pfdnn",
              "mobilenetv3-small|0.85|2|pfdnn"]
HOST_STATS = ("wall_time_s", "backend", "ilp_wall_time_s")


def _port_problem(ref: R.ScheduleProblem) -> ScheduleProblem:
    return ScheduleProblem(
        layer_states=[[StateCost(**dataclasses.asdict(s)) for s in layer]
                      for layer in ref.layer_states],
        t_max=ref.t_max, idle=IdleModel(**dataclasses.asdict(ref.idle)),
        transition_model=TransitionModel(
            **dataclasses.asdict(ref.transition_model)))


def _problems(seed, **kw):
    ref = random_problem(np.random.default_rng(seed), **kw)
    return _port_problem(ref), ref


def _host_free_json(sched) -> str:
    stats = {k: v for k, v in sched.solver_stats.items()
             if k not in HOST_STATS}
    return dataclasses.replace(sched, solver_stats=stats).to_json()


# ---------------------------------- the goldens under stack_max_live

def _compile_both(key, **knobs):
    network, frac, n_rails, policy = key.split("|")
    rate = max_rate(network) * float(frac)
    port = compile(edge_network(network), MinEnergy(rate_hz=rate),
                   cfg=OrchestratorConfig(policy=policy,
                                          n_max_rails=int(n_rails),
                                          device="cpu", **knobs),
                   network=network)
    ref = R.compile(ref_network(network), R.MinEnergy(rate_hz=rate),
                    cfg=R.OrchestratorConfig(policy=policy,
                                             n_max_rails=int(n_rails),
                                             backend="numpy", **knobs),
                    network=network)
    return port, ref


def _assert_golden(key, sched):
    g = GOLDEN[key]
    assert sched.feasible == g["feasible"]
    assert sched.e_total == pytest.approx(g["e_total"], rel=1e-9)
    assert sched.t_infer == pytest.approx(g["t_infer"], rel=1e-9)
    assert list(sched.rails) == g["rails"]
    assert [list(v) for v in sched.layer_voltages] == g["layer_voltages"]


@pytest.mark.parametrize("live", [2, 64])
@pytest.mark.parametrize("key", PFDNN_KEYS)
def test_golden_under_stack_max_live_matches_reference(key, live):
    port, ref = _compile_both(key, stack_max_live=live)
    _assert_golden(key, port)
    assert _host_free_json(port) == _host_free_json(ref)
    assert port.solver_stats["stack_max_live"] == live
    assert port.solver_stats["backend"] == "torch"


# ------------------------------------------------------ config fields

def test_config_fields_match_the_reference():
    ref = dataclasses.asdict(R.OrchestratorConfig())
    got = dataclasses.asdict(OrchestratorConfig())
    assert got["stack_max_live"] == ref["stack_max_live"]
    # the port replaces backend/pallas with one field, the device, and
    # leaves out the scalar and thread-pool sweeps' knobs
    assert set(ref) - set(got) == set(REFUSED)
    assert set(got) - set(ref) == {"device"}
    assert {k: v for k, v in got.items() if k != "device"} == \
        {k: v for k, v in ref.items() if k not in REFUSED}


REFUSED = {"backend": "numpy", "pallas": True, "batch_lambda": False,
           "sweep_workers": 4, "stack_subsets": False}


@pytest.mark.parametrize("field", sorted(REFUSED))
def test_reference_fields_are_refused(field):
    with pytest.raises(TypeError, match=field):
        OrchestratorConfig(**{field: REFUSED[field]})


# ------------------------------------------- io_stats under threads

def test_io_stats_exact_under_threads():
    """4 threads admit their own lanes into one store and drive DP,
    k-best and grouped-gather lane calls on one backend: every counter
    comes out exact (each lane uploaded once, one dispatch a call)."""
    n_threads, n_calls, lanes_each = 4, 25, 3
    bk = TorchBackend("cpu")
    probs = [_problems(s, n_layers=4, n_states=4)[0]
             for s in range(n_threads * lanes_each)]
    padded = [build_padded(p) for p in probs]
    store = BucketStack(padded[0].n_layers, padded[0].s_pad)
    errors: list[BaseException] = []
    start = threading.Barrier(n_threads)

    def run(tid: int) -> None:
        try:
            start.wait(timeout=30)
            mine = [store.add(("lane", tid, j),
                              padded[tid * lanes_each + j])
                    for j in range(lanes_each)]
            w = np.ones((len(mine), 2))
            paths = np.zeros((len(mine), padded[0].n_layers), np.int64)
            for _ in range(n_calls):
                bk.dp_multi_lanes(store, mine, w, w)
                bk.kbest_multi_lanes(store, mine, w, 2)
                bk.path_costs_grouped([(store, mine, paths),
                                       (store, mine, paths)])
        except BaseException as exc:     # surfaced in the main thread
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    calls = n_threads * n_calls
    lane_bytes = sum(a.nbytes for p in padded
                     for a in (p.t_op, p.e_op, p.valid, p.t_trans,
                               p.e_trans, p.switch))
    assert bk.io_counts() == {
        "h2d_lane_uploads": n_threads * lanes_each,
        "h2d_lane_bytes": lane_bytes,
        "kernel_dispatches": 3 * calls, "gather_calls": calls,
        "gather_groups": 2 * calls, "dp_lanes": lanes_each * calls,
        "kbest_lanes": lanes_each * calls}
