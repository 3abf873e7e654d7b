"""The port's whole compiler on the CPU: ``repro_torch.core.compile``
under all eight policies (the 23 schedules of
``tests/golden/pipeline.json``) against the frozen goldens and against
``repro.core.compile`` on the numpy backend, the periodic replay of its
schedules, and the reference certifier on its JSON.

Tolerances: goldens at ``rel=1e-9`` with identical rails and layer
voltages (as ``tests/test_pipeline_equivalence.py``); ``to_json``
byte-identical to the reference once the wall-clock/backend-name
solver stats are set aside; replay ledgers at ``rel=1e-9``."""

import json
import pathlib

import pytest
import torch

from conftest import max_rate
from repro.analysis.certify import certify
from repro.core import MinEnergy as RefMinEnergy
from repro.core import OrchestratorConfig as RefConfig
from repro.core import compile as ref_compile
from repro.core.schedule import PowerSchedule as RefSchedule
from repro.hw.edge40nm import EDGE40NM_DEFAULT as REF_ACC
from repro.models.edge_cnn import edge_network as ref_network
from repro.perfmodel import characterize_network as ref_characterize
from repro.perfmodel import plan_banks as ref_plan_banks
from repro.serve.power_runtime import PowerRuntime as RefRuntime
from repro_torch.core import (
    InfeasibleGoal,
    MinEnergy,
    OrchestratorConfig,
    PowerSchedule,
    compile,
)
from repro_torch.hw.edge40nm import EDGE40NM_DEFAULT as ACC
from repro_torch.models.edge_cnn import edge_network
from repro_torch.perfmodel import characterize_network, plan_banks
from repro_torch.serve import PeriodicScheduler, PowerRuntime

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden"
                     / "pipeline.json").read_text())
CASES = ["squeezenet1.1|0.9|2", "squeezenet1.1|0.5|3",
         "mobilenetv3-small|0.85|2"]
POLICIES = ["pfdnn", "baseline", "gating", "greedy", "greedy_gating",
            "pfdnn_even", "pfdnn_nopp", "ilp"]
KEYS = [f"{c}|{p}" for c in CASES for p in POLICIES
        if f"{c}|{p}" in GOLDEN]
# solver stats that measure the host (wall clock) or name the backend
HOST_STATS = ("wall_time_s", "backend", "ilp_wall_time_s")


def _compile_both(key):
    network, frac, n_rails, policy = key.split("|")
    rate = max_rate(network) * float(frac)
    port = compile(edge_network(network), MinEnergy(rate_hz=rate),
                   cfg=OrchestratorConfig(policy=policy,
                                          n_max_rails=int(n_rails),
                                          device="cpu"),
                   network=network)
    ref = ref_compile(ref_network(network), RefMinEnergy(rate_hz=rate),
                      cfg=RefConfig(policy=policy, n_max_rails=int(n_rails),
                                    backend="numpy"),
                      network=network)
    return port, ref


@pytest.fixture(scope="module")
def compiled():
    return {key: _compile_both(key) for key in KEYS}


@pytest.mark.parametrize("key", KEYS)
def test_compile_reproduces_golden(compiled, key):
    s, _ = compiled[key]
    golden = GOLDEN[key]
    assert golden["feasible"] and isinstance(s, PowerSchedule)
    assert s.e_total == pytest.approx(golden["e_total"], rel=1e-9)
    assert s.t_infer == pytest.approx(golden["t_infer"], rel=1e-9)
    assert list(s.rails) == golden["rails"]
    assert [list(v) for v in s.layer_voltages] == golden["layer_voltages"]


def _host_free_json(sched) -> str:
    stats = dict(sched.solver_stats)
    for name in HOST_STATS:
        stats.pop(name, None)
    return type(sched)(**{**vars(sched), "solver_stats": stats}).to_json()


@pytest.mark.parametrize("key", KEYS)
def test_to_json_byte_identical_to_reference(compiled, key):
    s, ref = compiled[key]
    assert _host_free_json(s) == _host_free_json(ref)
    if key.split("|")[-1] in ("pfdnn", "pfdnn_even", "pfdnn_nopp"):
        assert s.solver_stats["backend"] == "torch"
    # the reference's full payload, host stats included, round-trips
    # through the port byte for byte
    assert PowerSchedule.from_json(ref.to_json()).to_json() == ref.to_json()


@pytest.mark.parametrize("key", KEYS)
def test_replay_ledger_equals_prediction(compiled, key):
    s, ref = compiled[key]
    network = key.split("|")[0]
    costs = characterize_network(edge_network(network), ACC)
    plan = plan_banks(costs, ACC)
    run = PeriodicScheduler(PowerRuntime(s, costs, plan, ACC),
                            target_rate_hz=1.0 / s.t_max).run(20)
    assert run["deadline_misses"] == 0
    for led in run["ledgers"]:
        assert led.e_total == pytest.approx(s.e_total, rel=1e-9)
        assert led.t_infer == pytest.approx(s.t_infer, rel=1e-9)
        assert led.n_rail_switches == s.n_rail_switches
    assert run["total_energy_j"] == pytest.approx(20 * s.e_total, rel=1e-9)
    # the port's runtime executes exactly as the reference's
    ref_costs = ref_characterize(ref_network(network), REF_ACC)
    ref_led = RefRuntime(ref, ref_costs, ref_plan_banks(ref_costs, REF_ACC),
                         REF_ACC).execute_interval()
    led = run["ledgers"][0]
    assert (led.e_total, led.t_infer, led.e_idle, led.z_active_idle) == \
        (ref_led.e_total, ref_led.t_infer, ref_led.e_idle,
         ref_led.z_active_idle)


@pytest.mark.parametrize("key", KEYS)
def test_reference_certifier_passes_port_schedules(compiled, key):
    s, _ = compiled[key]
    network, _, n_rails, _ = key.split("|")
    sched = RefSchedule.from_json(s.to_json())
    cert = certify(sched, ref_network(network), n_max_rails=int(n_rails))
    assert cert.ok, cert.summary()
    assert cert.violations == []


def test_infeasible_goal_matches_reference():
    net = "squeezenet1.1"
    got = compile(edge_network(net), MinEnergy(rate_hz=1e6),
                  cfg=OrchestratorConfig(device="cpu"), network=net)
    want = ref_compile(ref_network(net), RefMinEnergy(rate_hz=1e6),
                       cfg=RefConfig(backend="numpy"), network=net)
    assert isinstance(got, InfeasibleGoal)
    assert (got.reason, got.goal, got.detail, got.network) == \
        (want.reason, want.goal, want.detail, want.network)


def test_compile_on_cuda_refuses_without_a_card(monkeypatch):
    from repro_torch.core import backend as tb

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tb, "_INSTANCES", {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compile(edge_network("squeezenet1.1"), MinEnergy(rate_hz=40.0),
                cfg=OrchestratorConfig(n_max_rails=1), network="sqz")
