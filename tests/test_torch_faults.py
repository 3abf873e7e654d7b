"""The port's fault and traffic traces and the runtime's fault hooks on
the CPU, held against the JAX package's for the same seeds and inputs:
``FaultInjector.interval`` value for value (numpy's ``SeedSequence``
streams in both), ``linear_drift``, ``TrafficSimulator.frame_times``
bit for bit, the validation errors, ``execute_interval(faults=,
deadline_s=)`` ledgers field for field, when ``simulate_interval``
skips its check, and ``PeriodicScheduler.run(injector=)``.
"""

import dataclasses

import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

import repro.core as R
import repro.serve as RV
from conftest import max_rate
from repro.hw.edge40nm import EDGE40NM_DEFAULT as REF_ACC
from repro.models.edge_cnn import edge_network as ref_network
from repro.perfmodel import characterize_network as ref_characterize
from repro.perfmodel import plan_banks as ref_plan_banks
from repro.serve.faults import IntervalFaults as RefIntervalFaults
from repro.serve.power_runtime import IntervalLedger as RefIntervalLedger
from repro_torch.core import MinEnergy, OrchestratorConfig, compile
from repro_torch.hw.edge40nm import EDGE40NM_DEFAULT as ACC
from repro_torch.models.edge_cnn import edge_network
from repro_torch.perfmodel import characterize_network, plan_banks
from repro_torch.serve import (
    SCENARIOS,
    FaultConfig,
    FaultInjector,
    IntervalLedger,
    LedgerMismatch,
    PeriodicScheduler,
    PowerRuntime,
    TrafficConfig,
    TrafficSimulator,
    linear_drift,
    simulate_interval,
)
from repro_torch.serve.faults import IntervalFaults

NETWORK = "squeezenet1.1"
L = 26                                   # squeezenet1.1's layers

# every field of FaultConfig away from its default at least once
FAULT_CONFIGS = [
    dict(),
    dict(seed=11, p_drop=0.01),
    dict(seed=11, op_sigma=0.01),
    dict(seed=11, op_sigma=0.02, trans_sigma=0.1, p_trans_spike=0.02,
         p_drop=0.01, p_late=0.01, late_max_s=0.003),
    dict(seed=7, op_sigma=0.05, trans_sigma=0.2, p_trans_spike=0.1,
         trans_spike_mult=3.0, p_drop=0.1, p_late=0.2, late_max_s=0.01),
    dict(seed=3, trans_sigma=0.3),
    dict(seed=5, p_trans_spike=1.0, trans_spike_mult=0.5),
    dict(seed=9, p_late=1.0, late_max_s=0.02),
    dict(seed=2, p_drop=1.0),
]
DRIFTS = [None, (0.01, 0, None), (0.3 / 90, 0, 90), (0.02, 10, 40)]


def _same_faults(a, b) -> None:
    assert type(a.op_scale) is type(b.op_scale) is np.ndarray
    assert a.op_scale.tobytes() == b.op_scale.tobytes()
    assert a.trans_scale.tobytes() == b.trans_scale.tobytes()
    assert (a.dropped, a.late_s) == (b.dropped, b.late_s)
    assert type(a.late_s) is type(b.late_s)


def _injectors(cfg: dict, drift, n_layers=L):
    bias = ref_bias = None
    if drift is not None:
        ramp, start, peak = drift
        bias = linear_drift(ramp, start=start, peak=peak)
        ref_bias = RV.linear_drift(ramp, start=start, peak=peak)
    return (FaultInjector(FaultConfig(**cfg), n_layers, op_bias=bias),
            RV.FaultInjector(RV.FaultConfig(**cfg), n_layers,
                             op_bias=ref_bias))


@pytest.mark.parametrize("drift", DRIFTS, ids=str)
@pytest.mark.parametrize("cfg", FAULT_CONFIGS, ids=str)
def test_fault_trace_equals_reference(cfg, drift):
    port, ref = _injectors(cfg, drift)
    # out of order: interval(i) is pure in (config, bias, i)
    for i in (120, 0, 1, 2, 3, 7, 44, 45, 89, 90, 91, 179, 5):
        _same_faults(port.interval(i), ref.interval(i))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), i=st.integers(0, 10**6),
       n_layers=st.integers(1, 80),
       op_sigma=st.floats(0.0, 0.5), trans_sigma=st.floats(0.0, 0.5),
       p_spike=st.floats(0.0, 1.0), p_drop=st.floats(0.0, 1.0),
       p_late=st.floats(0.0, 1.0), late_max=st.floats(0.0, 0.1))
@example(seed=0, i=0, n_layers=1, op_sigma=0.0, trans_sigma=0.0,
         p_spike=0.0, p_drop=0.0, p_late=0.0, late_max=0.0)
def test_property_fault_trace_equals_reference(
        seed, i, n_layers, op_sigma, trans_sigma, p_spike, p_drop, p_late,
        late_max):
    cfg = dict(seed=seed, op_sigma=op_sigma, trans_sigma=trans_sigma,
               p_trans_spike=p_spike, p_drop=p_drop, p_late=p_late,
               late_max_s=late_max)
    port, ref = _injectors(cfg, (0.001, 3, None), n_layers)
    _same_faults(port.interval(i), ref.interval(i))


@pytest.mark.parametrize("drift", DRIFTS[1:], ids=str)
def test_linear_drift_equals_reference(drift):
    ramp, start, peak = drift
    got = linear_drift(ramp, start=start, peak=peak)
    want = RV.linear_drift(ramp, start=start, peak=peak)
    for i in range(-2, 200):
        assert got(i) == want(i)
        assert type(got(i)) is type(want(i))


BAD_FAULTS = [dict(op_sigma=-0.1), dict(trans_sigma=-1.0),
              dict(late_max_s=-0.001), dict(op_sigma=float("nan")),
              dict(p_trans_spike=-0.01), dict(p_drop=1.5),
              dict(p_late=float("nan")), dict(trans_spike_mult=0.0),
              dict(trans_spike_mult=-2.0)]


@pytest.mark.parametrize("bad", BAD_FAULTS, ids=str)
def test_fault_config_validation_equals_reference(bad):
    with pytest.raises(ValueError) as got:
        FaultConfig(**bad)
    with pytest.raises(ValueError) as want:
        RV.FaultConfig(**bad)
    assert str(got.value) == str(want.value)


def test_injector_needs_a_layer():
    with pytest.raises(ValueError) as got:
        FaultInjector(FaultConfig(), 0)
    with pytest.raises(ValueError) as want:
        RV.FaultInjector(RV.FaultConfig(), 0)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------ traffic

TRAFFIC = [dict(base_rate_hz=60.0, scenario=s, seed=seed, jitter_sigma=j)
           for s in SCENARIOS for seed, j in ((0, 0.0), (3, 0.05))] + [
    dict(base_rate_hz=60.0, scenario="bursty", seed=3, jitter_sigma=0.05,
         burst_rate_mult=1.25, lull_rate_mult=0.4),
    dict(base_rate_hz=40.0, scenario="diurnal", seed=8, jitter_sigma=0.2,
         diurnal_period_s=2.0, diurnal_depth=0.9),
    dict(base_rate_hz=25.0, scenario="bursty", calm_len=3, burst_len=5,
         lull_len=7)]


@pytest.mark.parametrize("cfg", TRAFFIC, ids=str)
def test_frame_times_equal_reference(cfg):
    for n in (0, 1, 180, 420):
        got = TrafficSimulator(TrafficConfig(**cfg)).frame_times(n)
        want = RV.TrafficSimulator(RV.TrafficConfig(**cfg)).frame_times(n)
        assert got.dtype == want.dtype and got.shape == (n + 1,)
        assert got.tobytes() == want.tobytes()
    assert SCENARIOS == RV.SCENARIOS


@pytest.mark.parametrize("bad", [dict(scenario="nope"),
                                 dict(base_rate_hz=0.0),
                                 dict(base_rate_hz=float("nan")),
                                 dict(diurnal_depth=1.0),
                                 dict(diurnal_depth=-0.1)], ids=str)
def test_traffic_config_validation_equals_reference(bad):
    kw = {"base_rate_hz": 60.0, **bad}
    with pytest.raises(ValueError) as got:
        TrafficConfig(**kw)
    with pytest.raises(ValueError) as want:
        RV.TrafficConfig(**kw)
    assert str(got.value) == str(want.value)


# ------------------------------------------------ runtime fault hooks

@pytest.fixture(scope="module")
def runtimes():
    """The pfdnn schedule of squeezenet1.1 at 0.9 x max rate, 2 rails,
    on each package, with each package's characterization."""
    rate = 0.9 * max_rate(NETWORK)
    sched = compile(edge_network(NETWORK), MinEnergy(rate_hz=rate),
                    cfg=OrchestratorConfig(n_max_rails=2, device="cpu"),
                    network=NETWORK)
    ref_sched = R.compile(ref_network(NETWORK), R.MinEnergy(rate_hz=rate),
                          cfg=R.OrchestratorConfig(n_max_rails=2,
                                                   backend="numpy"),
                          network=NETWORK)
    costs = characterize_network(edge_network(NETWORK), ACC)
    ref_costs = ref_characterize(ref_network(NETWORK), REF_ACC)
    return ((sched, costs, plan_banks(costs, ACC)),
            (ref_sched, ref_costs, ref_plan_banks(ref_costs, REF_ACC)))


def _faults_pair(op=None, trans=None, dropped=False, late=0.0):
    op = np.ones(L) if op is None else op
    trans = np.ones(L) if trans is None else trans
    return (IntervalFaults(op_scale=op.copy(), trans_scale=trans.copy(),
                           dropped=dropped, late_s=late),
            RefIntervalFaults(op_scale=op.copy(), trans_scale=trans.copy(),
                              dropped=dropped, late_s=late))


def _fault_cases(t_max):
    rng = np.random.default_rng(4)
    cases = [(None, None), _faults_pair(np.full(L, 1.3), np.full(L, 2.0)),
             _faults_pair(dropped=True), _faults_pair(late=t_max),
             _faults_pair(late=0.25 * t_max),
             _faults_pair(np.exp(rng.normal(0, 0.1, L)),
                          np.exp(rng.normal(0, 0.3, L)), late=1e-4)]
    port, ref = _injectors(FAULT_CONFIGS[4], (0.01, 0, None))
    cases += [(port.interval(i), ref.interval(i)) for i in range(12)]
    return cases


def test_faulted_ledgers_equal_reference(runtimes):
    (sched, costs, plan), (rsched, rcosts, rplan) = runtimes
    rt = PowerRuntime(sched, costs, plan, ACC)
    rrt = RV.PowerRuntime(rsched, rcosts, rplan, REF_ACC)
    seen = set()
    for faults, rfaults in _fault_cases(sched.t_max):
        for deadline in (None, sched.t_max * 0.5, sched.t_max * 1.7,
                         0.0):
            got = rt.execute_interval(faults=faults, deadline_s=deadline)
            want = rrt.execute_interval(faults=rfaults,
                                        deadline_s=deadline)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            seen.add((got.dropped, got.met_deadline, got.t_late > 0))
    # dropped, late, missed and met frames were all exercised
    assert {(True, True, False), (False, False, True),
            (False, True, False), (False, False, False)} <= seen


def test_ledger_fields_equal_reference():
    assert [f.name for f in dataclasses.fields(IntervalLedger)] == \
        [f.name for f in dataclasses.fields(RefIntervalLedger)]


def test_simulate_interval_skips_its_check_as_the_reference(runtimes):
    (sched, costs, plan), (rsched, rcosts, rplan) = runtimes
    # fault-free on the native deadline: checked, and it holds
    assert dataclasses.asdict(simulate_interval(sched, costs, plan, ACC)) \
        == dataclasses.asdict(RV.simulate_interval(rsched, rcosts, rplan,
                                                   REF_ACC))
    # a corrupted cost model: layer 0 took 50 % more cycles
    bad = list(costs)
    bad[0] = dataclasses.replace(
        bad[0], cycles=tuple(c * 1.5 for c in bad[0].cycles))
    rbad = list(rcosts)
    rbad[0] = dataclasses.replace(
        rbad[0], cycles=tuple(c * 1.5 for c in rbad[0].cycles))
    with pytest.raises(LedgerMismatch) as got:
        simulate_interval(sched, bad, plan, ACC)
    with pytest.raises(RV.LedgerMismatch) as want:
        RV.simulate_interval(rsched, rbad, rplan, REF_ACC)
    assert (got.value.field, got.value.executed, got.value.predicted,
            got.value.rel_err, str(got.value)) == \
        (want.value.field, want.value.executed, want.value.predicted,
         want.value.rel_err, str(want.value))
    faults, rfaults = _faults_pair(np.full(L, 1.1))
    # skipped: explicitly, under faults, under a deadline override
    for kw, rkw in ((dict(check=False), dict(check=False)),
                    (dict(faults=faults), dict(faults=rfaults)),
                    (dict(deadline_s=sched.t_max * 2),
                     dict(deadline_s=rsched.t_max * 2))):
        got = simulate_interval(sched, bad, plan, ACC, **kw)
        want = RV.simulate_interval(rsched, rbad, rplan, REF_ACC, **rkw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("cfg", [FAULT_CONFIGS[3], FAULT_CONFIGS[4],
                                 FAULT_CONFIGS[8], None], ids=str)
def test_periodic_scheduler_with_injector_equals_reference(runtimes, cfg):
    (sched, costs, plan), (rsched, rcosts, rplan) = runtimes
    inj, rinj = _injectors(cfg, (0.002, 0, None)) if cfg is not None \
        else (None, None)
    rate = 1.0 / sched.t_max
    got = PeriodicScheduler(PowerRuntime(sched, costs, plan, ACC),
                            rate).run(100, injector=inj)
    want = RV.PeriodicScheduler(
        RV.PowerRuntime(rsched, rcosts, rplan, REF_ACC),
        rate).run(100, injector=rinj)
    ledgers = [dataclasses.asdict(x) for x in got.pop("ledgers")]
    assert ledgers == [dataclasses.asdict(x) for x in want.pop("ledgers")]
    assert got == want
    if cfg is FAULT_CONFIGS[8]:
        assert got["dropped_frames"] == 100 and got["deadline_misses"] == 0
    empty = PeriodicScheduler(PowerRuntime(sched, costs, plan, ACC),
                              rate).run(0, injector=inj)
    assert empty["dropped_frames"] == 0 and empty["intervals"] == 0
