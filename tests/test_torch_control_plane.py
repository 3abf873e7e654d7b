"""The port's adaptive control plane on the CPU, mirroring
``tests/test_serve_robustness.py`` and held against ``repro.serve`` on
the same inputs: ``RateTracker``, ``MissLedger``, ``AsyncResolver``
(fake clock: done, error, timeout), ``AdaptiveConfig`` validation,
snaps and the degradation ladder, ``serve_trace`` on the calm, bursty
and drift traces of ``benchmarks/serve_robustness.py`` (``ServeReport``
``==`` on every field, ``EventLog.to_json()`` byte for byte),
``drift_learned`` with blocking re-solves on a copy of the bundle, and
the async re-solve's merge and watchdog abandonment on a real service.
"""

import concurrent.futures
import dataclasses
import threading

import numpy as np
import pytest

import repro.core as R
import repro.serve as RV
import repro.service as RS
import repro_torch.serve as PV
from repro.hw.edge40nm import EDGE40NM_DEFAULT as REF_ACC
from repro.models.edge_cnn import edge_network as ref_network
from repro.perfmodel import characterize_network as ref_characterize
from repro.perfmodel import plan_banks as ref_plan_banks
from repro.serve.control_plane import RUNG_AGGRESSIVE as REF_AGGRESSIVE
from repro_torch.analysis import lockcheck
from repro_torch.core import OrchestratorConfig
from repro_torch.hw.edge40nm import EDGE40NM_DEFAULT as ACC
from repro_torch.models.edge_cnn import edge_network
from repro_torch.perfmodel import characterize_network, plan_banks
from repro_torch.serve import (
    AdaptiveConfig,
    AdaptiveScheduler,
    AsyncResolver,
    FaultInjector,
    MissLedger,
    RateTracker,
    StaticSchedulePolicy,
    TrafficConfig,
    TrafficSimulator,
    serve_trace,
)
from repro_torch.serve.control_plane import (
    RUNG_AGGRESSIVE,
    RUNG_POINT,
    RUNG_TIGHTENED,
)
from repro_torch.service import CompileService

NETWORK = "squeezenet1.1"
BASE_RATE = 60.0        # the robustness benchmark's setup
UTIL = 0.85
TIGHTEN = 0.92
SEED = 11
PFDNN = OrchestratorConfig(policy="pfdnn", device="cpu")
REF_PFDNN = R.OrchestratorConfig(policy="pfdnn", backend="numpy")
GREEDY = OrchestratorConfig(policy="greedy_gating", device="cpu")
REF_GREEDY = R.OrchestratorConfig(policy="greedy_gating", backend="numpy")


HOST_STATS = ("wall_time_s", "backend", "ilp_wall_time_s")
# counters of the round scheduler as a whole: they depend on what the
# store already holds
FLEET_STATS = ("stacked_rounds", "stacked_calls", "fleet_networks")


def _json(sched, drop=()) -> str:
    """``to_json`` without the host's stats (wall clock, backend) and
    the stats named in ``drop``."""
    stats = {k: v for k, v in sched.solver_stats.items()
             if k not in HOST_STATS + drop}
    return dataclasses.replace(sched, solver_stats=stats).to_json()


def _report(rep) -> tuple:
    """Every field of a ServeReport but the event log, exactly."""
    return dataclasses.astuple(dataclasses.replace(rep, events=None))


def _copy(bundle):
    """A bundle whose dicts the plane may mutate (re-solves replace the
    live set in place), as the benchmark's learned row runs."""
    return dataclasses.replace(bundle, points=dict(bundle.points),
                               tightened=dict(bundle.tightened),
                               infeasible=list(bundle.infeasible))


@pytest.fixture(scope="module")
def net():
    specs, rspecs = edge_network(NETWORK), ref_network(NETWORK)
    costs = characterize_network(specs, ACC)
    rcosts = ref_characterize(rspecs, REF_ACC)
    return ((specs, costs, plan_banks(costs, ACC)),
            (rspecs, rcosts, ref_plan_banks(rcosts, REF_ACC)))


@pytest.fixture(scope="module")
def services():
    with CompileService(ACC) as svc, RS.CompileService(REF_ACC) as rsvc:
        yield svc, rsvc


@pytest.fixture(scope="module")
def pfdnn_bundles(net, services):
    """The benchmark's contingency bundle on each package: pfdnn, base
    rate 60 / 0.85 Hz, tighten 0.92, budget point included."""
    (specs, _, _), (rspecs, _, _) = net
    svc, rsvc = services
    got = svc.compile_contingencies(specs, BASE_RATE / UTIL,
                                    tighten_frac=TIGHTEN, cfg=PFDNN,
                                    network=NETWORK)
    want = rsvc.compile_contingencies(rspecs, BASE_RATE / UTIL,
                                      tighten_frac=TIGHTEN, cfg=REF_PFDNN,
                                      network=NETWORK)
    return got, want


@pytest.fixture(scope="module")
def greedy_bundles(net, services):
    (specs, _, _), (rspecs, _, _) = net
    svc, rsvc = services
    kw = dict(tighten_frac=TIGHTEN, budget_frac=None, network=NETWORK)
    return (svc.compile_contingencies(specs, BASE_RATE / UTIL, cfg=GREEDY,
                                      **kw),
            rsvc.compile_contingencies(rspecs, BASE_RATE / UTIL,
                                       cfg=REF_GREEDY, **kw))


def _planes(net, bundles, **kw):
    (_, costs, plan), (_, rcosts, rplan) = net
    ref_kw = {k: v for k, v in kw.items() if k != "acfg"}
    if "acfg" in kw:
        ref_kw["acfg"] = RV.AdaptiveConfig(**dataclasses.asdict(kw["acfg"]))
    return (AdaptiveScheduler(bundles[0], costs, plan, ACC, **kw),
            RV.AdaptiveScheduler(bundles[1], rcosts, rplan, REF_ACC,
                                 **ref_kw))


# ------------------------------------------------------ observation

@pytest.mark.parametrize("gaps", [
    [1 / 60.0] * 20 + [1 / 66.0] * 3 + [1 / 200.0] * 2,
    [1 / 60.0, 1 / 75.0, 1 / 24.0, 1 / 61.0, 1e-12, 0.5, 1 / 60.0] * 5,
    list(np.diff(TrafficSimulator(TrafficConfig(
        60.0, scenario="bursty", seed=3, jitter_sigma=0.05)).frame_times(
        200)))], ids=["burst", "mixed", "bursty-trace"])
@pytest.mark.parametrize("window", [12, 8, 5])
def test_rate_tracker_equals_reference(gaps, window):
    tr = RateTracker(100.0, window=window, alpha=0.3, burst_tolerance=0.1)
    ref = RV.RateTracker(100.0, window=window, alpha=0.3,
                         burst_tolerance=0.1)
    assert (tr.rate, tr.p95, tr.ewma) == (ref.rate, ref.p95, ref.ewma)
    for gap in gaps:
        tr.observe_gap(gap)
        ref.observe_gap(gap)
        assert (tr.rate, tr.p95, tr.ewma) == (ref.rate, ref.p95, ref.ewma)
        assert type(tr.p95) is type(ref.p95) is float


def test_rate_tracker_gates_bursts():
    tr = RateTracker(60.0, burst_tolerance=0.15)
    for _ in range(20):
        tr.observe_gap(1 / 60.0)
    for _ in range(3):
        tr.observe_gap(1 / 66.0)             # +10 % < tolerance
    assert tr.rate < 66.0 * 0.999
    tr.observe_gap(1 / 200.0)
    tr.observe_gap(1 / 200.0)
    assert tr.rate > 150.0


def test_miss_ledger_equals_reference():
    ml, ref = MissLedger(window=4), RV.MissLedger(window=4)
    for miss in (True, True, False, False, False, True, True, True, True):
        ml.record(miss)
        ref.record(miss)
        assert (ml.n, ml.full, ml.miss_rate()) == \
            (ref.n, ref.full, ref.miss_rate())
    ml.clear()
    assert ml.n == 0 and ml.miss_rate() == 0.0


# --------------------------------------------------- async resolver

class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _resolver_script(cls):
    """The reference test's done / error / timeout sequence; returns
    what each step observed."""
    clock, timeouts, seen = FakeClock(), [], []
    r = cls(10.0, clock=clock, on_timeout=lambda: timeouts.append(clock.t))
    seen.append((r.poll(), r.busy))
    fut = concurrent.futures.Future()
    r.watch("a", fut)
    with pytest.raises(RuntimeError) as exc:
        r.watch("b", concurrent.futures.Future())
    seen.append(str(exc.value))
    fut.set_result(42)
    seen.append((r.poll(), r.busy))
    fut = concurrent.futures.Future()
    fut.set_exception(ValueError("boom"))
    r.watch("b", fut)
    seen.append(r.poll())
    hung = concurrent.futures.Future()
    r.watch("c", hung)
    clock.t = 5.0
    seen.append(r.poll())
    clock.t = 11.0
    seen.append((r.poll(), r.busy, list(timeouts)))
    return seen


def test_async_resolver_equals_reference():
    got = _resolver_script(AsyncResolver)
    assert got == _resolver_script(RV.AsyncResolver)
    assert got[2] == (("done", "a", 42), False)
    assert got[3][0] == "error" and "boom" in got[3][2]
    assert got[5] == (("timeout", "c", 11.0), False, [11.0])
    for bad in (0.0, -1.0, float("nan")):
        with pytest.raises(ValueError) as a:
            AsyncResolver(bad)
        with pytest.raises(ValueError) as b:
            RV.AsyncResolver(bad)
        assert str(a.value) == str(b.value)


@pytest.mark.parametrize("bad", [
    dict(util_target=0.0), dict(util_target=1.2),
    dict(breach_miss_rate=0.2, recover_miss_rate=0.3),
    dict(recover_miss_rate=-0.1), dict(calib_threshold=-1.0),
    dict(calib_window=4, calib_min_samples=8), dict(calib_cooldown=-2)],
    ids=str)
def test_adaptive_config_validation_equals_reference(bad):
    with pytest.raises(ValueError) as got:
        AdaptiveConfig(**bad)
    with pytest.raises(ValueError) as want:
        RV.AdaptiveConfig(**bad)
    assert str(got.value) == str(want.value)


def test_adaptive_config_fields_equal_reference():
    assert dataclasses.asdict(AdaptiveConfig()) == \
        dataclasses.asdict(RV.AdaptiveConfig())


# ------------------------------------------------- adaptive scheduler

def _drive(plane, rplane, gaps, start=0, queue=0):
    """Feed on-time intervals at the given arrival gaps (and a backlog
    of ``k % queue`` frames, if ``queue``) to both planes; the picks
    must agree."""
    t = 0.0
    sched = None
    for k, gap in enumerate(gaps, start):
        depth = k % queue if queue else 0
        sched, rt = plane.pick(k, t, gap, depth)
        rsched, rrt = rplane.pick(k, t, gap, depth)
        assert _json(sched) == _json(rsched)
        assert (rt.idle.p_idle, rt.idle.p_sleep) == \
            (rrt.idle.p_idle, rrt.idle.p_sleep)
        plane.record(k, miss=False, dropped=False, now=t)
        rplane.record(k, miss=False, dropped=False, now=t)
        t += gap
    return sched


def test_snaps_under_rate_steps_equal_reference(net, pfdnn_bundles):
    bundle = pfdnn_bundles[0]
    plane, rplane = _planes(net, pfdnn_bundles)
    base = _drive(plane, rplane, [1 / BASE_RATE] * 30)
    assert base.t_max == pytest.approx(bundle.base_deadline_s)
    burst = _drive(plane, rplane, [1 / (BASE_RATE * 1.25)] * 10, 30)
    assert burst.t_max < bundle.base_deadline_s
    relaxed = _drive(plane, rplane, [1 / (BASE_RATE * 0.5)] * 30, 40)
    assert relaxed.t_max > bundle.base_deadline_s
    _drive(plane, rplane, [1 / BASE_RATE] * 12, 70, queue=4)
    assert plane.events.to_json() == rplane.events.to_json()
    snaps = plane.events.of("snap")
    assert len(snaps) >= 2 and all(e.detail["precompiled"] for e in snaps)
    assert "resolve_start" not in plane.events.kinds()


def test_ladder_and_hysteretic_recovery_equal_reference(net,
                                                        greedy_bundles):
    acfg = AdaptiveConfig(window=8, breach_min_samples=4,
                          breach_miss_rate=0.5, recover_miss_rate=0.05,
                          dwell_intervals=4)
    plane, rplane = _planes(net, greedy_bundles, acfg=acfg)
    gap = 1 / BASE_RATE
    rungs = []
    k = 0
    for miss, n in ((True, 4), (True, 4), (True, 20), (False, 7),
                    (False, 1), (False, 8)):
        for _ in range(n):
            for p in (plane, rplane):
                p.pick(k, k * gap, gap, 0)
                p.record(k, miss=miss, dropped=False, now=k * gap)
            k += 1
        assert plane.rung == rplane.rung
        rungs.append(plane.rung)
    assert rungs == [RUNG_TIGHTENED, RUNG_AGGRESSIVE, RUNG_AGGRESSIVE,
                     RUNG_AGGRESSIVE, RUNG_TIGHTENED, RUNG_POINT]
    assert RUNG_AGGRESSIVE == REF_AGGRESSIVE
    kinds = plane.events.kinds()
    assert kinds["degrade"] == 2 and kinds["recover"] == 2
    assert plane.events.to_json() == rplane.events.to_json()


# ------------------------------------------------------- serve_trace

HORIZON = 180           # the benchmark's smoke horizon


def scenario_plan(pkg, n_frames: int) -> dict:
    """``benchmarks/serve_robustness.py::scenario_plan`` on ``pkg``."""
    return {
        "calm": dict(
            traffic=pkg.TrafficConfig(BASE_RATE, scenario="calm"),
            faults=pkg.FaultConfig(seed=SEED, p_drop=0.01), bias=None),
        "bursty": dict(
            traffic=pkg.TrafficConfig(
                BASE_RATE, scenario="bursty", seed=3, jitter_sigma=0.05,
                burst_rate_mult=1.25, lull_rate_mult=0.4),
            faults=pkg.FaultConfig(
                seed=SEED, op_sigma=0.02, trans_sigma=0.1,
                p_trans_spike=0.02, p_drop=0.01, p_late=0.01,
                late_max_s=0.003),
            bias=None),
        "drift": dict(
            traffic=pkg.TrafficConfig(BASE_RATE, scenario="calm"),
            faults=pkg.FaultConfig(seed=SEED, op_sigma=0.01),
            bias=pkg.linear_drift(0.3 / (n_frames // 2),
                                  peak=n_frames // 2)),
    }


@pytest.mark.parametrize("scenario", ["calm", "bursty", "drift"])
def test_serve_trace_equals_reference(net, pfdnn_bundles, scenario):
    (_, costs, plan), (_, rcosts, rplan) = net
    bundle, rbundle = pfdnn_bundles
    sc = scenario_plan(PV, HORIZON)[scenario]
    rsc = scenario_plan(RV, HORIZON)[scenario]
    times = TrafficSimulator(sc["traffic"]).frame_times(HORIZON)
    assert times.tobytes() == \
        RV.TrafficSimulator(rsc["traffic"]).frame_times(HORIZON).tobytes()
    static_sched = bundle.points[bundle.base_deadline_s]
    rstatic = rbundle.points[rbundle.base_deadline_s]
    out = {}
    for name, policy, rpolicy in (
            ("static", StaticSchedulePolicy(static_sched, costs, plan, ACC),
             RV.StaticSchedulePolicy(rstatic, rcosts, rplan, REF_ACC)),
            ("adaptive", AdaptiveScheduler(bundle, costs, plan, ACC),
             RV.AdaptiveScheduler(rbundle, rcosts, rplan, REF_ACC))):
        got = serve_trace(times, policy, injector=FaultInjector(
            sc["faults"], len(costs), op_bias=sc["bias"]))
        want = RV.serve_trace(times, rpolicy, injector=RV.FaultInjector(
            rsc["faults"], len(rcosts), op_bias=rsc["bias"]))
        assert _report(got) == _report(want)
        if name == "adaptive":
            assert got.events.to_json() == want.events.to_json()
        out[name] = got
    assert out["static"].frames == out["static"].served \
        + out["static"].dropped == HORIZON
    snaps = out["adaptive"].events.of("snap")
    assert snaps and all(e.detail["precompiled"] for e in snaps)
    ratio = out["adaptive"].energy_j / out["static"].energy_j
    if scenario == "calm":
        assert abs(ratio - 1.0) <= 0.01
    else:
        assert out["adaptive"].miss_rate < out["static"].miss_rate


# the benchmark's learned row cut for time: 20 frames (two blocking
# re-solves on each package) and 4 re-solve points, not 10
LEARNED_FRAMES = 20


def test_drift_learned_equals_reference(net, services, pfdnn_bundles):
    """The benchmark's learned row (blocking re-solves under the
    ledger-learned model), at a short horizon, on bundle copies."""
    (specs, costs, plan), (rspecs, rcosts, rplan) = net
    svc, rsvc = services
    bundle, rbundle = pfdnn_bundles
    before = sorted(bundle.points)
    sc = scenario_plan(PV, LEARNED_FRAMES)["drift"]
    rsc = scenario_plan(RV, LEARNED_FRAMES)["drift"]
    times = TrafficSimulator(sc["traffic"]).frame_times(LEARNED_FRAMES)
    kw = dict(calib_enabled=True, calib_blocking=True, util_target=0.95,
              resolve_points=4, resolve_rate_band=(0.5, 1.8),
              calib_window=16, calib_min_samples=8, calib_cooldown=8,
              calib_threshold=0.02)
    plane = AdaptiveScheduler(_copy(bundle), costs, plan, ACC, service=svc,
                              specs=specs, compile_cfg=PFDNN,
                              acfg=AdaptiveConfig(**kw))
    rplane = RV.AdaptiveScheduler(_copy(rbundle), rcosts, rplan, REF_ACC,
                                  service=rsvc, specs=rspecs,
                                  compile_cfg=REF_PFDNN,
                                  acfg=RV.AdaptiveConfig(**kw))
    got = serve_trace(times, plane, injector=FaultInjector(
        sc["faults"], len(costs), op_bias=sc["bias"]))
    want = RV.serve_trace(times, rplane, injector=RV.FaultInjector(
        rsc["faults"], len(rcosts), op_bias=rsc["bias"]))
    assert _report(got) == _report(want)
    assert got.events.to_json() == want.events.to_json()
    dones = plane.events.of("calibrate_done")
    assert len(dones) >= 2
    assert all(e.detail["blocking"]
               for e in plane.events.of("calibrate_start"))
    assert any(e.detail["replaced_points"] > 0 for e in dones)
    assert not np.allclose(plane._applied_scale, 1.0)
    assert plane._applied_scale.tobytes() == rplane._applied_scale.tobytes()
    # the live set is the last re-solve's, schedule for schedule
    assert sorted(plane.bundle.points) == sorted(rplane.bundle.points)
    for d, s in plane.bundle.points.items():
        assert s.cost_model == rplane.bundle.points[d].cost_model \
            == plane._applied_model.digest
        assert (s.rails, s.layer_voltages, s.e_total) == \
            (rplane.bundle.points[d].rails,
             rplane.bundle.points[d].layer_voltages,
             rplane.bundle.points[d].e_total)
    # the shared bundle was not touched
    assert sorted(bundle.points) == before


# -------------------------------------------------- async re-solve

class FakeResolveService:
    """Duck-typed service: hands back a controllable Future and records
    the watchdog's pool abandonment."""

    def __init__(self):
        self.future = concurrent.futures.Future()
        self.requests = []
        self.abandoned = 0

    def compile_contingencies_async(self, specs, rate_hz, **kw):
        self.requests.append((rate_hz, kw))
        return self.future

    def abandon_async_pool(self):
        self.abandoned += 1


def test_resolve_merge_and_watchdog_equal_reference(net, greedy_bundles,
                                                    services):
    (specs, costs, plan), (rspecs, rcosts, rplan) = net
    svc, rsvc = services
    clocks = FakeClock(), FakeClock()
    fakes = FakeResolveService(), FakeResolveService()
    acfg = dict(drift_patience=3, watchdog_s=5.0)
    plane = AdaptiveScheduler(_copy(greedy_bundles[0]), costs, plan, ACC,
                              service=fakes[0], specs=specs,
                              acfg=AdaptiveConfig(**acfg), clock=clocks[0],
                              compile_cfg=GREEDY)
    rplane = RV.AdaptiveScheduler(_copy(greedy_bundles[1]), rcosts, rplan,
                                  REF_ACC, service=fakes[1], specs=rspecs,
                                  acfg=RV.AdaptiveConfig(**acfg),
                                  clock=clocks[1], compile_cfg=REF_GREEDY)
    planes = (plane, rplane)
    slow = 0.5                                # ~2 Hz: far out of coverage
    for k in range(4):
        for p in planes:
            p.pick(k, k * slow, slow, 0)
    assert [len(f.requests) for f in fakes] == [1, 1]
    (rate, kw), (rrate, rkw) = fakes[0].requests[0], fakes[1].requests[0]
    assert rate == rrate and kw.keys() == rkw.keys()
    assert kw["cfg"] is GREEDY and kw["cost_model"] is None
    # the background solves land: points merge into the live bundles
    fakes[0].future.set_result(svc.compile_contingencies(
        specs, 2.0, n_points=2, budget_frac=None, cfg=GREEDY,
        network=NETWORK))
    fakes[1].future.set_result(rsvc.compile_contingencies(
        rspecs, 2.0, n_points=2, budget_frac=None, cfg=REF_GREEDY,
        network=NETWORK))
    for p in planes:
        p.pick(4, 4 * slow, slow, 0)
    assert plane.events.of("resolve_done")[0].detail["new_points"] > 0
    assert sorted(plane.bundle.points) == sorted(rplane.bundle.points)
    assert max(plane._grid) == max(plane.bundle.points)
    # the next solve hangs: the watchdog abandons it
    for f in fakes:
        f.future = concurrent.futures.Future()
    for k in range(5, 30):
        for p in planes:
            p.pick(k, k * slow * 40, slow * 40, 0)
        if len(fakes[0].requests) == 2:
            break
    assert [len(f.requests) for f in fakes] == [2, 2]
    for c in clocks:
        c.t += 6.0
    for p in planes:
        p.pick(50, 0.0, slow, 0)
    assert [f.abandoned for f in fakes] == [1, 1]
    assert not plane.resolver.busy
    assert plane.events.to_json() == rplane.events.to_json()


def test_async_resolve_on_a_service_and_its_abandonment(net, services):
    """A real service: the awaited async re-solve equals the blocking
    one; a second, abandoned through the watchdog, still runs to its end
    on its detached pool (the serving loop went on), leaves no error and
    no cycle in the lock graph, and its bundle is right too.  It shares
    the blocking service's store, with the schedule cache off: the
    sweeps run again on resident lanes."""
    (specs, costs, plan), _ = net
    kw = dict(rate_band=(0.8, 1.25), n_points=2, tighten_frac=TIGHTEN,
              budget_frac=None, cfg=PFDNN, network=NETWORK)
    blocking = services[0].compile_contingencies(
        specs, BASE_RATE / UTIL, **kw)
    svc = CompileService(ACC, store=services[0].store,
                         use_schedule_cache=False)
    futures = []
    gate = threading.Event()
    real = svc.compile_contingencies

    def gated(*args, **kwargs):
        gate.wait(timeout=60)          # holds the second re-solve in flight
        return real(*args, **kwargs)

    lockcheck.enable()
    lockcheck.reset()
    try:
        fut = svc.compile_contingencies_async(specs, BASE_RATE / UTIL, **kw)
        landed = fut.result(timeout=120)
        svc.compile_contingencies = gated
        clock = FakeClock()
        resolver = AsyncResolver(0.01, clock=clock,
                                 on_timeout=svc.abandon_async_pool)
        futures.append(svc.compile_contingencies_async(
            specs, BASE_RATE / UTIL, **kw))
        resolver.watch("resolve", futures[0])
        clock.t = 1.0
        assert resolver.poll() == ("timeout", "resolve", 1.0)
        assert svc._async_pool is None         # detached, not joined
        assert not futures[0].done()
        gate.set()
        abandoned = futures[0].result(timeout=120)
        report = lockcheck.assert_clean()
    finally:
        lockcheck.disable()
        svc.close()
    assert report["ok"] and not report["cycles"] and not report["hazards"]
    for got in (landed, abandoned):
        assert sorted(got.points) == sorted(blocking.points)
        assert sorted(got.tightened) == sorted(blocking.tightened)
        for d in got.points:
            assert _json(got.points[d], FLEET_STATS) == \
                _json(blocking.points[d], FLEET_STATS)
        for d in got.tightened:
            assert _json(got.tightened[d], FLEET_STATS) == \
                _json(blocking.tightened[d], FLEET_STATS)
        assert _json(got.aggressive, FLEET_STATS) == \
            _json(blocking.aggressive, FLEET_STATS)
