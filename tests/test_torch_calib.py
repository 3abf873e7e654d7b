"""The port's calibration subsystem on the CPU, mirroring
``tests/test_calib.py`` and held against ``repro.calib`` on the same
inputs: ``CalibratedCostModel`` (its digest keys calibrated masters in a
disk tier both packages read, so it must equal the reference's byte for
byte), ``ResidualEstimator`` (numpy window medians, even windows
included), the characterization harness (``calibration_key``, roofline
records in parity and synthetic modes, publication and reuse through an
``ArtifactStore`` and its disk tier), calibrated compiles and policy
tables (``to_json`` byte for byte, wall-clock and backend stats aside),
``solver_kernel_walls``' checksum against the reference's numpy backend
and its route on a CUDA request, and the adaptive plane's calibration
and policy-table axes.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

import repro.calib as RC
import repro.core as R
import repro.serve as RV
import repro.service as RS
import repro_torch.calib as PC
from repro.hw.edge40nm import EDGE40NM_DEFAULT as REF_ACC
from repro.perfmodel.gating import plan_banks as ref_plan_banks
from repro.perfmodel.layer_costs import (
    characterize_network as ref_characterize,
)
from repro.perfmodel.layer_costs import conv_spec as ref_conv
from repro.perfmodel.layer_costs import fc_spec as ref_fc
from repro.perfmodel.layer_costs import pool_spec as ref_pool
from repro_torch.calib import (
    CalibratedCostModel,
    HarnessConfig,
    PolicyBand,
    ResidualEstimator,
    RooflineTable,
    SchedulePolicyTable,
    calibration_key,
    compile_policy_table,
    host_fingerprint,
    identity_model,
    model_from_residuals,
    run_harness,
    solver_kernel_walls,
    sparsity_cost_model,
    synthetic_measurement,
)
from repro_torch.core import MinEnergy, OrchestratorConfig, PowerSchedule
from repro_torch.core import backend as backend_mod
from repro_torch.hw.edge40nm import EDGE40NM_DEFAULT as ACC
from repro_torch.kernels import dp_sweep as ks
from repro_torch.perfmodel.gating import plan_banks
from repro_torch.perfmodel.layer_costs import (
    characterize_network,
    conv_spec,
    fc_spec,
    pool_spec,
)
from repro_torch.serve import (
    AdaptiveConfig,
    AdaptiveScheduler,
    FaultConfig,
    FaultInjector,
    linear_drift,
    serve_trace,
)
from repro_torch.service import ArtifactStore, CompileService

SPECS = [conv_spec("c1", 14, 14, 8, 16, 3),
         pool_spec("p1", 14, 14, 16, 2),
         fc_spec("f1", 784, 10)]
REF_SPECS = [ref_conv("c1", 14, 14, 8, 16, 3),
             ref_pool("p1", 14, 14, 16, 2),
             ref_fc("f1", 784, 10)]
DEADLINE = 0.01
CPU = OrchestratorConfig(device="cpu")
NUMPY = R.OrchestratorConfig(backend="numpy")
HOST_STATS = ("wall_time_s", "backend", "ilp_wall_time_s")
# counters of the round scheduler as a whole: a fleet's differ from a
# solo compile's
FLEET_STATS = ("stacked_rounds", "stacked_calls", "fleet_networks")


def _json(sched, drop=()) -> str:
    """``to_json`` without the host's stats, and without the stats and
    the ``cost_model`` named in ``drop``."""
    stats = {k: v for k, v in sched.solver_stats.items()
             if k not in HOST_STATS + drop}
    sched = dataclasses.replace(sched, solver_stats=stats)
    if "cost_model" in drop:
        sched = dataclasses.replace(sched, cost_model="static")
    return sched.to_json()


def _raises_alike(port_call, ref_call):
    with pytest.raises(ValueError) as got:
        port_call()
    with pytest.raises(ValueError) as want:
        ref_call()
    assert str(got.value) == str(want.value)


# ------------------------------------------------- CalibratedCostModel

@pytest.mark.parametrize("scale", [(), (1.0, 0.0), (1.0, -0.5),
                                   (float("nan"),)], ids=str)
def test_model_validation_equals_reference(scale):
    _raises_alike(lambda: CalibratedCostModel(scale=scale),
                  lambda: RC.CalibratedCostModel(scale=scale))


MODELS = [((1.1, 0.9), "learned"), ((1.1, 0.95), "learned"),
          ((1.1, 0.9), "harness"), ((1.0, 1.0, 1.0), "identity"),
          ((0.4, 1.0, 0.4), "sparsity:0.400"), ((4.0, 0.25, 1.235), "ledger"),
          ((1.0000000000000002, 3.3333333333333335), "x")]


@pytest.mark.parametrize("scale,source", MODELS, ids=str)
def test_model_digest_equals_reference(scale, source):
    got = CalibratedCostModel(scale=scale, source=source)
    want = RC.CalibratedCostModel(scale=scale, source=source)
    assert got.digest == want.digest
    assert got.max_deviation() == want.max_deviation()
    other = (1.2,) * len(scale)
    assert got.max_deviation(CalibratedCostModel(other)) == \
        want.max_deviation(RC.CalibratedCostModel(other))


def test_model_apply_equals_reference():
    costs = characterize_network(SPECS, ACC)
    rcosts = ref_characterize(REF_SPECS, REF_ACC)
    for scale in ((2.0, 1.0, 0.5), (1.0, 1.0, 1.0), (0.05, 1.3, 4.0)):
        got = CalibratedCostModel(scale=scale).apply(costs)
        want = RC.CalibratedCostModel(scale=scale).apply(rcosts)
        assert [dataclasses.astuple(c) for c in got] == \
            [dataclasses.astuple(c) for c in want]
        # scale 1.0 layers are the same object, not a copy
        assert all((g is c) == (s == 1.0)
                   for g, c, s in zip(got, costs, scale))
    _raises_alike(lambda: CalibratedCostModel((1.0, 1.0)).apply(costs),
                  lambda: RC.CalibratedCostModel((1.0, 1.0)).apply(rcosts))


def test_identity_model_equals_reference():
    for n in (1, 3, 26):
        assert identity_model(n).digest == RC.identity_model(n).digest
        assert identity_model(n, "x").scale == RC.identity_model(n, "x").scale


# --------------------------------------------------- ResidualEstimator

def _ledger_like(t_ops):
    layer = dataclasses.make_dataclass("L", ["t_op"])
    led = dataclasses.make_dataclass("Led", ["layers"])
    return led(layers=[layer(t_op=float(t)) for t in t_ops])


@pytest.mark.parametrize("window,min_samples,n_obs", [
    (8, 3, 2), (8, 3, 3), (8, 3, 4), (8, 3, 11), (16, 8, 16),
    (32, 12, 31), (32, 12, 40), (5, 1, 1)])
def test_estimator_equals_reference(window, min_samples, n_obs):
    """Windows of even length included: the median of an even window is
    numpy's mean of the two middle values."""
    rng = np.random.default_rng(window * 100 + n_obs)
    est = ResidualEstimator(4, window=window, min_samples=min_samples)
    ref = RC.ResidualEstimator(4, window=window, min_samples=min_samples)
    pred = _ledger_like([1.0, 2.0, 0.0, 3e-4])
    for _ in range(n_obs):
        ex = _ledger_like(np.array([1.0, 2.0, 0.0, 3e-4])
                          * np.exp(rng.normal(0.1, 0.2, 4)))
        est.observe(ex, pred)
        ref.observe(ex, pred)
        got, want = est.estimate(), ref.estimate()
        assert (got is None) == (want is None)
        if got is not None:
            assert got.tobytes() == want.tobytes()
            assert got[2] == 1.0          # a dead layer is pinned to 1
            assert model_from_residuals(got).digest == \
                RC.model_from_residuals(want).digest
    assert est.n == ref.n
    est.clear()
    assert est.n == 0 and est.estimate() is None


def test_estimator_validation_equals_reference():
    _raises_alike(lambda: ResidualEstimator(0),
                  lambda: RC.ResidualEstimator(0))
    _raises_alike(lambda: ResidualEstimator(2, window=4, min_samples=8),
                  lambda: RC.ResidualEstimator(2, window=4, min_samples=8))
    est = ResidualEstimator(2, window=4, min_samples=1)
    ref = RC.ResidualEstimator(2, window=4, min_samples=1)
    _raises_alike(
        lambda: est.observe(_ledger_like([1.0]), _ledger_like([1.0, 2.0])),
        lambda: ref.observe(_ledger_like([1.0]), _ledger_like([1.0, 2.0])))


def test_model_from_residuals_equals_reference():
    for est in ([100.0, 0.001, 1.23456], [1.30001], [1.29999],
                [0.9995, 1.0005, 1.0015], [1.0] * 26):
        got = model_from_residuals(np.array(est))
        want = RC.model_from_residuals(np.array(est))
        assert got.scale == want.scale and got.digest == want.digest
        assert all(type(s) is float for s in got.scale)
    assert model_from_residuals(np.array([100.0, 0.001, 1.23456])).scale \
        == (4.0, 0.25, 1.235)
    got = model_from_residuals(np.array([2.0]), source="s", clamp=(0.5, 1.5))
    want = RC.model_from_residuals(np.array([2.0]), source="s",
                                   clamp=(0.5, 1.5))
    assert (got.scale, got.digest) == ((1.5,), want.digest)


# ------------------------------------------------------------- harness

@pytest.mark.parametrize("bad", [dict(repeats=0),
                                 dict(kinds=("conv", "nosuch"))], ids=str)
def test_harness_config_validation_equals_reference(bad):
    _raises_alike(lambda: HarnessConfig(**bad),
                  lambda: RC.HarnessConfig(**bad))


@pytest.mark.parametrize("cfg", [dict(), dict(seed=1), dict(repeats=3),
                                 dict(kinds=("fc", "conv"))], ids=str)
def test_calibration_key_equals_reference(cfg):
    host = host_fingerprint()
    assert host == RC.host_fingerprint()
    for h in (None, host, {**host, "machine": "other"},
              {"z": "1", "a": "2"}):
        assert calibration_key(ACC, HarnessConfig(**cfg), h) == \
            RC.calibration_key(REF_ACC, RC.HarnessConfig(**cfg), h)
    base = calibration_key(ACC, HarnessConfig(), host)
    if cfg:
        assert calibration_key(ACC, HarnessConfig(**cfg), host) != base


HARNESS_RUNS = [
    (dict(repeats=1), None),
    (dict(), None),
    (dict(seed=7, repeats=3), ({"conv": 1.2}, 0.05)),
    (dict(seed=1, repeats=5), ({"conv": 1.3, "fc": 0.8}, 0.02)),
    (dict(seed=4, repeats=2, kinds=("attn", "dwconv")), (1.1, 0.0)),
    (dict(seed=5, repeats=4), (0.9, 0.1))]


@pytest.mark.parametrize("cfg,truth", HARNESS_RUNS, ids=str)
def test_harness_records_equal_reference(cfg, truth):
    meas = rmeas = None
    if truth is not None:
        meas = synthetic_measurement(truth[0], noise_sigma=truth[1])
        rmeas = RC.synthetic_measurement(truth[0], noise_sigma=truth[1])
    got = run_harness(ACC, HarnessConfig(**cfg), measure=meas)
    want = RC.run_harness(REF_ACC, RC.HarnessConfig(**cfg), measure=rmeas)
    assert got.to_record() == want.to_record()
    assert got.ratios_by_kind() == want.ratios_by_kind()
    model = got.cost_model(SPECS)
    assert model.digest == want.cost_model(REF_SPECS).digest
    assert RooflineTable.from_record(got.to_record()).to_record() == \
        got.to_record()
    if truth is None:
        # parity mode: the model measures itself
        assert set(got.ratios_by_kind().values()) == {(1.0, 1.0)}
        assert model.scale == (1.0, 1.0, 1.0)
    elif cfg.get("seed") == 1:
        ratios = got.ratios_by_kind()
        assert ratios["conv"][0] == pytest.approx(1.3, rel=0.05)
        assert ratios["fc"][0] == pytest.approx(0.8, rel=0.05)
        assert ratios["pool"][0] == pytest.approx(1.0, rel=0.05)


def test_synthetic_measurement_validation_equals_reference():
    _raises_alike(lambda: synthetic_measurement(1.0, noise_sigma=-0.1),
                  lambda: RC.synthetic_measurement(1.0, noise_sigma=-0.1))


def test_harness_publishes_and_reuses_through_the_store(tmp_path):
    cfg = HarnessConfig(repeats=1)
    store = ArtifactStore(disk_path=tmp_path / "tier")
    t1 = run_harness(ACC, cfg, store=store)
    assert store.misses["calibration"] == 1
    t2 = run_harness(ACC, cfg, store=store)
    assert store.hits["calibration"] == 1
    assert t2.to_record() == t1.to_record()
    # another store over the same disk tier (another farm process)
    store2 = ArtifactStore(disk_path=tmp_path / "tier")
    assert run_harness(ACC, cfg, store=store2).to_record() == \
        t1.to_record()
    assert store2.disk_hits["calibration"] == 1
    # the reference's store reads the port's publication, and the
    # port's the reference's: one key, one digest, one record
    ref_store = RS.ArtifactStore(disk_path=tmp_path / "tier")
    assert RC.run_harness(REF_ACC, RC.HarnessConfig(repeats=1),
                          store=ref_store).to_record() == t1.to_record()
    assert ref_store.disk_hits["calibration"] == 1
    rcfg = RC.HarnessConfig(seed=3, repeats=2)
    ref_table = RC.run_harness(
        REF_ACC, rcfg, measure=RC.synthetic_measurement(1.2, noise_sigma=0.1),
        store=RS.ArtifactStore(disk_path=tmp_path / "tier"))
    store3 = ArtifactStore(disk_path=tmp_path / "tier")
    assert run_harness(ACC, HarnessConfig(seed=3, repeats=2),
                       store=store3).to_record() == ref_table.to_record()
    assert store3.disk_hits["calibration"] == 1


# ------------------------------------------------------ solver walls

@pytest.mark.parametrize("shape", [dict(), dict(n_layers=6, s_pad=8,
                                                k_weights=4, seed=3),
                                   dict(n_layers=2, s_pad=4, k_weights=1),
                                   dict(n_layers=20, s_pad=32, k_weights=12,
                                        seed=9)], ids=str)
def test_solver_walls_checksum_equals_numpy_backend(shape):
    got = solver_kernel_walls("cpu", repeats=1, **shape)
    want = RC.solver_kernel_walls("numpy", repeats=1, **shape)
    assert got["checksum"] == want["checksum"]
    assert (got["n_layers"], got["s_pad"], got["k_weights"]) == \
        (want["n_layers"], want["s_pad"], want["k_weights"])
    assert got["device"] == "cpu" and got["backend"] == "torch"
    assert got["wall_s_median"] > 0.0


def test_solver_walls_on_a_host_without_a_card(monkeypatch):
    """``None`` names the card; without one the call raises and never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend_mod, "_INSTANCES", {})
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            solver_kernel_walls(device, repeats=1)


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_solver_walls_on_cuda_go_to_the_kernel(monkeypatch):
    """On a CUDA backend (fake tensors here: this host has no card) the
    timed ``dp_multi`` reaches the DP kernel's wrapper, which loads its
    library; the plain version never runs.  The library load is stubbed
    to raise, as the build does on a host without ``nvcc``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class Loaded(Exception):
        pass

    def refuse():
        raise Loaded

    def no_plain(*args):
        raise AssertionError("the plain version ran on a CUDA request")

    class FakeCudaBackend(backend_mod.TorchBackend):
        def __init__(self):
            self.device = torch.device("cuda", 0)
            self.io_stats = {}
            self._io_lock = threading.Lock()

        def _stage(self, *arrays):           # no pinned packet
            return [self._put(a) for a in arrays]

    asked = []

    def fake_get_backend(device=None):
        asked.append(device)
        return FakeCudaBackend()

    monkeypatch.setattr(ks, "load_library", refuse)
    monkeypatch.setattr(ks, "dp_multi_stacked_plain", no_plain)
    monkeypatch.setattr(backend_mod, "get_backend", fake_get_backend)
    before = dict(ks.LAUNCHES)
    with FakeTensorMode(allow_non_fake_inputs=True):
        for device in (None, "cuda"):
            with pytest.raises(Loaded):
                solver_kernel_walls(device, repeats=1, n_layers=6, s_pad=8,
                                    k_weights=4)
    assert asked == [None, "cuda"]
    assert ks.LAUNCHES == before


# --------------------------------------------- cost-model compilation

def _compile_pair(model_fn=None, deadline=DEADLINE):
    """The same compile on each package; ``model_fn(calib_package,
    specs, acc)`` builds the cost model, if any."""
    with CompileService(ACC) as svc, RS.CompileService(REF_ACC) as rsvc:
        got = svc.compile(
            SPECS, goal=MinEnergy(deadline_s=deadline), cfg=CPU,
            cost_model=model_fn and model_fn(PC, SPECS, ACC))
        want = rsvc.compile(
            REF_SPECS, goal=R.MinEnergy(deadline_s=deadline), cfg=NUMPY,
            cost_model=model_fn and model_fn(RC, REF_SPECS, REF_ACC))
    return got, want


MODEL_FNS = {
    "static": None,
    "identity": lambda pkg, specs, acc: pkg.identity_model(len(specs)),
    "sparsity": lambda pkg, specs, acc: pkg.sparsity_cost_model(0.5, specs),
    "harness-parity": lambda pkg, specs, acc: pkg.run_harness(
        acc, pkg.HarnessConfig(repeats=1)).cost_model(specs),
    "learned": lambda pkg, specs, acc: pkg.CalibratedCostModel(
        scale=(1.3, 0.9, 1.1), source="ledger"),
}


@pytest.fixture(scope="module")
def compiled():
    return {name: _compile_pair(fn) for name, fn in MODEL_FNS.items()}


@pytest.mark.parametrize("name", sorted(MODEL_FNS))
def test_calibrated_compile_equals_reference(name, compiled):
    got, want = compiled[name]
    assert _json(got) == _json(want)
    assert PowerSchedule.from_json(got.to_json()).cost_model == \
        got.cost_model == want.cost_model


@pytest.mark.parametrize("name", ["identity", "harness-parity"])
def test_parity_models_compile_the_static_schedule(name, compiled):
    """A model of all-1.0 scales compiles the static schedule byte for
    byte, its cost-model provenance aside."""
    static, cal = compiled["static"][0], compiled[name][0]
    assert static.cost_model == "static" != cal.cost_model
    assert _json(cal, drop=("cost_model",)) == _json(static)


def test_cache_namespaces_never_collide():
    with CompileService(ACC) as svc:
        static = svc.compile(SPECS, goal=MinEnergy(deadline_s=DEADLINE),
                             cfg=CPU)
        model = sparsity_cost_model(0.5, SPECS)
        cal = svc.compile(SPECS, goal=MinEnergy(deadline_s=DEADLINE),
                          cfg=CPU, cost_model=model)
        assert svc.store.stats()["schedules"] == 2
        again = svc.compile(SPECS, goal=MinEnergy(deadline_s=DEADLINE),
                            cfg=CPU, cost_model=model)
    assert again.to_json() == cal.to_json()
    assert cal.cost_model == model.digest != static.cost_model
    assert cal.e_total < static.e_total


# ------------------------------------------------------- policy table

def test_sparsity_model_equals_reference():
    for density in (0.4, 0.01, 0.5, 1.0, 2.5):
        for floor in (0.05, 0.3, 1.0):
            got = sparsity_cost_model(density, SPECS, floor=floor)
            want = RC.sparsity_cost_model(density, REF_SPECS, floor=floor)
            assert (got.scale, got.source, got.digest) == \
                (want.scale, want.source, want.digest)
    assert sparsity_cost_model(0.4, SPECS).scale == (0.4, 1.0, 0.4)
    _raises_alike(lambda: sparsity_cost_model(0.0, SPECS),
                  lambda: RC.sparsity_cost_model(0.0, REF_SPECS))
    _raises_alike(lambda: sparsity_cost_model(0.5, SPECS, floor=0.0),
                  lambda: RC.sparsity_cost_model(0.5, REF_SPECS, floor=0.0))


def test_table_lookup_equals_reference():
    m, rm = identity_model(3), RC.identity_model(3)
    _raises_alike(lambda: SchedulePolicyTable("density", []),
                  lambda: RC.SchedulePolicyTable("density", []))
    _raises_alike(
        lambda: SchedulePolicyTable("density", [
            PolicyBand(0.0, 0.6, m, {}), PolicyBand(0.5, 1.0, m, {})]),
        lambda: RC.SchedulePolicyTable("density", [
            RC.PolicyBand(0.0, 0.6, rm, {}),
            RC.PolicyBand(0.5, 1.0, rm, {})]))
    grids = [{0.01: "a", 0.02: "b"}, {}, {0.005: "c", 0.03: "d"}]
    edges = [(0.0, 0.3), (0.3, 0.6), (0.6, 1.0)]
    table = SchedulePolicyTable("density", [
        PolicyBand(lo, hi, m, dict(g)) for (lo, hi), g in zip(edges, grids)])
    ref = RC.SchedulePolicyTable("density", [
        RC.PolicyBand(lo, hi, rm, dict(g))
        for (lo, hi), g in zip(edges, grids)])
    for obs in (-1.0, 0.0, 0.2, 0.3, 0.45, 0.6, 0.99, 2.0):
        assert table.band_for(obs).lo == ref.band_for(obs).lo
        for d in (0.001, 0.005, 0.01, 0.015, 0.02, 0.5):
            assert table.lookup(obs, d) == ref.lookup(obs, d)
    assert table.deadlines() == ref.deadlines()


def test_compile_policy_table_validation_equals_reference():
    with CompileService(ACC) as svc, RS.CompileService(REF_ACC) as rsvc:
        for kw in (dict(band_edges=[0.5], deadlines=[DEADLINE]),
                   dict(band_edges=[0.0, 1.0], deadlines=[]),
                   dict(band_edges=[0.0, 0.5, 0.5], deadlines=[DEADLINE])):
            _raises_alike(lambda: compile_policy_table(svc, SPECS, **kw),
                          lambda: RC.compile_policy_table(rsvc, REF_SPECS,
                                                          **kw))


class CountingService(CompileService):
    calls = 0

    def compile_many(self, *args, **kwargs):
        self.calls += 1
        return super().compile_many(*args, **kwargs)


def test_policy_table_equals_solo_compiles_and_reference():
    deadlines = [DEADLINE, 2 * DEADLINE, 2e-6]         # the last infeasible
    svc = CountingService(ACC)
    with svc:
        table = compile_policy_table(svc, SPECS, band_edges=[0.0, 0.5, 1.0],
                                     deadlines=deadlines, cfg=CPU,
                                     network="n")
    assert svc.calls == 1                  # ONE fleet batch
    with RS.CompileService(REF_ACC) as rsvc:
        ref = RC.compile_policy_table(rsvc, REF_SPECS,
                                      band_edges=[0.0, 0.5, 1.0],
                                      deadlines=deadlines, cfg=NUMPY,
                                      network="n")
    assert table.observable == ref.observable
    assert len(table.bands) == len(ref.bands) == 2
    assert all(len(b.infeasible) == 1 for b in table.bands)
    # solo compiles, one after another through one store
    solo_svc = CompileService(ACC, use_schedule_cache=False)
    for band, rband in zip(table.bands, ref.bands):
        assert (band.lo, band.hi, band.cost_model.digest) == \
            (rband.lo, rband.hi, rband.cost_model.digest)
        assert sorted(band.schedules) == sorted(rband.schedules)
        assert [(d, g.to_json()) for d, g in band.infeasible] == \
            [(d, g.to_json()) for d, g in rband.infeasible]
        for d, sched in band.schedules.items():
            assert _json(sched) == _json(rband.schedules[d])
            solo = solo_svc.compile(SPECS, goal=MinEnergy(deadline_s=d),
                                    cfg=CPU, cost_model=band.cost_model)
            assert _json(sched, FLEET_STATS) == _json(dataclasses.replace(
                solo, network=sched.network), FLEET_STATS)
            assert sched.cost_model == band.cost_model.digest
    sparse, dense = table.lookup(0.2, DEADLINE), table.lookup(0.8, DEADLINE)
    assert sparse.e_total < dense.e_total


# ------------------------------------------- adaptive learning plane

GREEDY = OrchestratorConfig(policy="greedy_gating", device="cpu")
REF_GREEDY = R.OrchestratorConfig(policy="greedy_gating", backend="numpy")


@pytest.fixture(scope="module")
def small_bundles():
    """Each package's contingency bundle of SPECS at 60 Hz (greedy
    policies solve only MinEnergy goals: no budget point)."""
    svc, rsvc = CompileService(ACC), RS.CompileService(REF_ACC)
    got = svc.compile_contingencies(SPECS, 60.0, network="net", cfg=GREEDY,
                                    budget_frac=None)
    want = rsvc.compile_contingencies(REF_SPECS, 60.0, network="net",
                                      cfg=REF_GREEDY, budget_frac=None)
    costs = characterize_network(SPECS, ACC)
    rcosts = ref_characterize(REF_SPECS, REF_ACC)
    yield ((svc, got, costs, plan_banks(costs, ACC)),
           (rsvc, want, rcosts, ref_plan_banks(rcosts, REF_ACC)))
    svc.close()
    rsvc.close()


def _report(rep):
    return dataclasses.astuple(dataclasses.replace(rep, events=None))


@pytest.mark.parametrize("bad", [dict(calib_threshold=0.0),
                                 dict(calib_window=4, calib_min_samples=8),
                                 dict(calib_min_samples=0),
                                 dict(calib_cooldown=-1)], ids=str)
def test_calib_config_validation_equals_reference(bad):
    _raises_alike(lambda: AdaptiveConfig(**bad),
                  lambda: RV.AdaptiveConfig(**bad))


def test_calibration_disabled_never_estimates(small_bundles):
    (svc, bundle, costs, plan), (rsvc, rbundle, rcosts, rplan) = \
        small_bundles
    times = np.arange(41) / 60.0
    plane = AdaptiveScheduler(bundle, costs, plan, ACC, service=svc,
                              specs=SPECS, compile_cfg=GREEDY)
    rplane = RV.AdaptiveScheduler(rbundle, rcosts, rplan, REF_ACC,
                                  service=rsvc, specs=REF_SPECS,
                                  compile_cfg=REF_GREEDY)
    cfg = dict(seed=5, op_sigma=0.01)
    got = serve_trace(times, plane, injector=FaultInjector(
        FaultConfig(**cfg), 3, op_bias=linear_drift(0.01)))
    want = RV.serve_trace(times, rplane, injector=RV.FaultInjector(
        RV.FaultConfig(**cfg), 3, op_bias=RV.linear_drift(0.01)))
    assert _report(got) == _report(want)
    assert got.events.to_json() == want.events.to_json()
    assert plane._estimator is None
    assert not plane.events.of("calibrate_start")


def test_policy_table_axis_equals_reference(small_bundles):
    (svc, bundle, costs, plan), (rsvc, rbundle, rcosts, rplan) = \
        small_bundles
    n = 40
    times = np.arange(n + 1) / 60.0
    obs = np.where(np.arange(n) < n // 2, 0.2, 0.8)
    table = compile_policy_table(svc, SPECS, band_edges=[0.0, 0.5, 1.0],
                                 deadlines=[1.0 / 60.0 * 0.85], cfg=CPU)
    rtable = RC.compile_policy_table(rsvc, REF_SPECS,
                                     band_edges=[0.0, 0.5, 1.0],
                                     deadlines=[1.0 / 60.0 * 0.85],
                                     cfg=NUMPY)
    plane = AdaptiveScheduler(bundle, costs, plan, ACC, policy_table=table)
    rplane = RV.AdaptiveScheduler(rbundle, rcosts, rplan, REF_ACC,
                                  policy_table=rtable)
    got = serve_trace(times, plane, observables=obs)
    want = RV.serve_trace(times, rplane, observables=obs)
    assert _report(got) == _report(want)
    assert got.events.to_json() == want.events.to_json()
    table_snaps = [e for e in plane.events.of("snap")
                   if e.detail.get("variant") == "policy_table"]
    assert [tuple(e.detail["band"]) for e in table_snaps] == \
        [(0.0, 0.5), (0.5, 1.0)]
    assert got.served == n
    _raises_alike(
        lambda: serve_trace(times[:5], plane, observables=np.zeros(3)),
        lambda: RV.serve_trace(times[:5], rplane, observables=np.zeros(3)))
