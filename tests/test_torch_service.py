"""The port's fleet compile service on the CPU, mirroring
``tests/test_service.py`` and held against the reference's service on
the same requests: ``repro_torch`` with ``device="cpu"`` (the kernels'
plain versions) against ``repro`` with ``backend="numpy"``.

Schedule comparisons are ``to_json`` byte for byte with the wall-clock,
ILP-wall and backend-name solver stats set aside; a schedule-cache hit
is compared whole.  Covered: warm parity on the goldens, the cache round
trip, ``compile_many`` against solo compiles (with in-batch dedup and
repeat hits), cached infeasible points, two threads' ``compile_many``
on one service, ``clear`` / ``trim`` (device mirrors freed with the
lanes), warm repeats that upload no lane, a prebuilt and a mismatched
``ctx``, ``compile_contingencies`` against the reference's bundle, a
duck-typed cost model, and ``stats()`` on a host with no card.
"""

import dataclasses
import gc
import json
import pathlib
import threading
import weakref

import pytest
import torch

import repro.core as R
import repro.service as RS
from conftest import max_rate
from repro.models.edge_cnn import edge_network as ref_network
from repro_torch.core import (
    CompilationContext,
    MinEnergy,
    OrchestratorConfig,
    compile,
    compile_power_schedule,
)
from repro_torch.core import backend as backend_mod
from repro_torch.models.edge_cnn import edge_network
from repro_torch.service import ArtifactStore, CompileRequest, CompileService

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden"
                     / "pipeline.json").read_text())
# every golden but the two ILP keys (seconds of HiGHS each; the ILP
# policy runs through the same service path as the others)
KEYS = sorted(k for k in GOLDEN if not k.endswith("|ilp"))
HOST_STATS = ("wall_time_s", "backend", "ilp_wall_time_s")
# counters of the round scheduler as a whole: a fleet's differ from a
# solo compile's (the reference's test_service compares no stats there)
FLEET_STATS = ("stacked_rounds", "stacked_calls", "fleet_networks")


def _host_free_json(sched, drop=HOST_STATS) -> str:
    stats = {k: v for k, v in sched.solver_stats.items()
             if k not in drop}
    return dataclasses.replace(sched, solver_stats=stats).to_json()


def _same(a, b, drop=HOST_STATS) -> None:
    assert (a is None) == (b is None)
    if a is not None:
        assert _host_free_json(a, drop) == _host_free_json(b, drop)


def _cfg_for(key: str, **kw):
    network, frac, n_rails, policy = key.split("|")
    rate = max_rate(network) * float(frac)
    return (network, rate,
            OrchestratorConfig(policy=policy, n_max_rails=int(n_rails),
                               device="cpu", **kw),
            R.OrchestratorConfig(policy=policy, n_max_rails=int(n_rails),
                                 backend="numpy", **kw))


def _ref_cold(key: str, **kw):
    network, rate, _, rcfg = _cfg_for(key, **kw)
    return R.compile_power_schedule(ref_network(network), rate, cfg=rcfg,
                                    network=network)


@pytest.fixture(scope="module")
def warm_service():
    """A store populated by compiling every key once."""
    svc = CompileService()
    first = {}
    for key in KEYS:
        network, rate, cfg, _ = _cfg_for(key)
        first[key] = svc.compile(edge_network(network), rate, cfg=cfg,
                                 network=network)
    return svc, first


# ------------------------------------------------ warm-start parity

@pytest.mark.parametrize("key", KEYS)
def test_warm_solve_parity_golden(key, warm_service):
    """A full solve on the populated store (schedule cache bypassed)
    equals the reference's cold compile, and the golden."""
    svc, _ = warm_service
    network, rate, cfg, _ = _cfg_for(key)
    warm = CompileService(store=svc.store, use_schedule_cache=False) \
        .compile(edge_network(network), rate, cfg=cfg, network=network)
    _same(warm, _ref_cold(key))
    g = GOLDEN[key]
    assert list(warm.rails) == g["rails"]
    assert warm.e_total == pytest.approx(g["e_total"], rel=1e-9)


@pytest.mark.parametrize("key", KEYS)
def test_schedule_cache_roundtrip_golden(key, warm_service):
    svc, first = warm_service
    network, rate, cfg, _ = _cfg_for(key)
    before = svc.store.stats()["hits"]["schedule"]
    hit = svc.compile(edge_network(network), rate, cfg=cfg,
                      network=network)
    assert svc.store.stats()["hits"]["schedule"] == before + 1
    assert hit.to_json() == first[key].to_json()


@pytest.mark.parametrize(
    "key", [k for k in KEYS if k.endswith(("|pfdnn", "|pfdnn_nopp"))])
def test_warm_parity_with_stack_max_live(key, warm_service):
    """The live-task cap is not part of the cache key: a capped warm
    solve equals the reference's capped cold compile."""
    svc, _ = warm_service
    network, rate, cfg, _ = _cfg_for(key, stack_max_live=2)
    warm = CompileService(store=svc.store, use_schedule_cache=False) \
        .compile(edge_network(network), rate, cfg=cfg, network=network)
    _same(warm, _ref_cold(key, stack_max_live=2))


def test_device_is_not_part_of_the_cache_key(warm_service):
    """A schedule compiled on one device answers the same request on
    another: the card's schedules are the CPU's byte for byte."""
    svc, first = warm_service
    key = "squeezenet1.1|0.9|2|pfdnn"
    network, rate, cfg, _ = _cfg_for(key)
    ctx = svc.context_for(edge_network(network), cfg=cfg, network=network)
    goal = MinEnergy(rate_hz=rate)
    assert svc._schedule_key(ctx, goal, cfg) == svc._schedule_key(
        ctx, goal, dataclasses.replace(cfg, device="cuda"))
    assert svc._schedule_key(ctx, goal, cfg) != svc._schedule_key(
        ctx, goal, dataclasses.replace(cfg, k_candidates=5))


# ------------------------------------------- cross-network stacking

def _fleet(mod, cfg_cls, network_fn, **dev):
    cfg2 = cfg_cls(policy="pfdnn", n_max_rails=2, **dev)
    return [
        mod.CompileRequest(network_fn("squeezenet1.1"),
                           max_rate("squeezenet1.1") * 0.9, cfg2, "sqz"),
        mod.CompileRequest(network_fn("mobilenetv3-small"),
                           max_rate("mobilenetv3-small") * 0.85, cfg2,
                           "mnv3"),
        mod.CompileRequest(network_fn("squeezenet1.1"),
                           max_rate("squeezenet1.1") * 0.5,
                           cfg_cls(policy="pfdnn", n_max_rails=3, **dev),
                           "sqz-slow"),
    ]


def _port_fleet():
    import repro_torch.service as PS

    return _fleet(PS, OrchestratorConfig, edge_network, device="cpu")


@pytest.fixture(scope="module")
def ref_fleet():
    return RS.CompileService().compile_many(
        _fleet(RS, R.OrchestratorConfig, ref_network, backend="numpy"))


@pytest.mark.parametrize("stack_networks", [True, False])
def test_compile_many_matches_solo_and_reference(stack_networks,
                                                 ref_fleet):
    many = CompileService().compile_many(_port_fleet(),
                                         stack_networks=stack_networks)
    for got, req, ref in zip(many, _port_fleet(), ref_fleet):
        solo = compile_power_schedule(req.specs, req.target_rate_hz,
                                      cfg=req.cfg, network=req.network)
        _same(got, solo, HOST_STATS + FLEET_STATS)
        # the reference's batch is stacked: with stacking off only the
        # fleet counters differ
        _same(got, ref, HOST_STATS if stack_networks
              else HOST_STATS + FLEET_STATS)
    if stack_networks:
        assert all(s.solver_stats["fleet_networks"] == 3 for s in many)


def test_compile_many_dedups_and_caches(ref_fleet):
    reqs = _port_fleet()
    dup = CompileRequest(reqs[0].specs, reqs[0].target_rate_hz,
                         reqs[0].cfg, "sqz-copy")
    svc = CompileService()
    many = svc.compile_many(reqs + [dup])
    _same(many[3], dataclasses.replace(ref_fleet[0], network="sqz-copy"))
    assert many[3].network == "sqz-copy"
    before = svc.store.stats()["hits"]["schedule"]
    io = svc.store.stats()["backend_io"]["cpu"]
    again = svc.compile_many(reqs)
    stats = svc.store.stats()
    assert stats["hits"]["schedule"] == before + 3
    # answered from the cache: no lane call at all
    assert stats["backend_io"]["cpu"]["kernel_dispatches"] \
        == io["kernel_dispatches"]
    for got, ref in zip(again, ref_fleet):
        _same(got, ref)


def test_warm_repeat_uploads_no_lane():
    svc = CompileService(use_schedule_cache=False)
    reqs = _port_fleet()
    first = svc.compile_many(reqs)
    io = svc.store.stats()["backend_io"]["cpu"]
    assert io["h2d_lane_uploads"] > 0
    again = svc.compile_many(reqs)
    io2 = svc.store.stats()["backend_io"]["cpu"]
    assert io2["h2d_lane_uploads"] == io["h2d_lane_uploads"]
    assert io2["kernel_dispatches"] > io["kernel_dispatches"]
    assert svc.store.stats()["hits"]["lanes"] > 0
    for a, b in zip(first, again):
        _same(a, b)


def test_infeasible_point_is_cached():
    specs = edge_network("squeezenet1.1")
    rate = max_rate("squeezenet1.1") * 2.0
    svc = CompileService()
    cfg = OrchestratorConfig(policy="pfdnn", n_max_rails=2, device="cpu")
    assert svc.compile(specs, rate, cfg=cfg) is None
    before = svc.store.stats()["hits"]["schedule"]
    assert svc.compile(specs, rate, cfg=cfg) is None
    assert svc.store.stats()["hits"]["schedule"] == before + 1


def test_threaded_compile_many(ref_fleet):
    svc = CompileService(use_schedule_cache=False)
    reqs = _port_fleet()
    orders = [[0, 1, 2], [2, 0, 1]]
    results: dict[int, list] = {}
    errors: list[BaseException] = []

    def run(tid, order):
        try:
            out = svc.compile_many([reqs[i] for i in order])
            results[tid] = [out[order.index(i)] for i in range(3)]
        except BaseException as exc:
            errors.append(exc)

    threads = [threading.Thread(target=run, args=(t, o))
               for t, o in enumerate(orders)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for tid in range(2):
        for got, ref in zip(results[tid], ref_fleet):
            _same(got, ref)
    assert svc.store.stats()["resident_lanes"] > 0


# ----------------------------------------------- clear / trim / save

def _mirror_refs(store) -> list:
    return [weakref.ref(t) for bs in store.stack_caches.buckets.values()
            for m in bs.scratch.values() for t in m.arrays]


@pytest.mark.parametrize("how", ["trim", "clear"])
def test_clear_and_trim_free_mirrors_and_stay_correct(how):
    specs = edge_network("squeezenet1.1")
    rate = max_rate("squeezenet1.1") * 0.9
    cfg = OrchestratorConfig(policy="pfdnn", n_max_rails=2, device="cpu")
    svc = CompileService(use_schedule_cache=False)
    ref = svc.compile(specs, rate, cfg=cfg, network="sqz")
    assert svc.store.stats()["resident_lanes"] > 0
    refs = _mirror_refs(svc.store)
    assert refs
    gc.disable()
    try:
        if how == "trim":
            assert svc.trim(max_lanes=0)
            assert svc.store.stats()["evictions"]["lanes"] > 0
        else:
            svc.store.clear(stacks=True)
        assert svc.store.stats()["resident_lanes"] == 0
        # nothing else held a mirror: freed without a garbage collection
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
    _same(svc.compile(specs, rate, cfg=cfg, network="sqz"), ref)
    svc.store.clear()
    assert svc.store.stats()["schedules"] == 0
    _same(svc.compile(specs, rate, cfg=cfg, network="sqz"), ref)


def test_compile_without_store_frees_its_lane_stores(monkeypatch):
    """A compile with no store drops its lane stores (and their
    mirrors) by reference counting alone: with the collector off, none
    of the lane stores it built is alive after it returns."""
    made = []
    init = backend_mod.BucketStack.__init__

    def counted(self, *a, **kw):
        init(self, *a, **kw)
        made.append(weakref.ref(self))

    monkeypatch.setattr(backend_mod.BucketStack, "__init__", counted)
    specs = edge_network("squeezenet1.1")
    goal = MinEnergy(rate_hz=max_rate("squeezenet1.1") * 0.9)
    cfg = OrchestratorConfig(policy="pfdnn", n_max_rails=2, device="cpu")
    gc.collect()
    gc.disable()
    try:
        sched = compile(specs, goal, cfg=cfg, network="sqz")
        assert sched.feasible and made
        assert all(r() is None for r in made)
    finally:
        gc.enable()


def test_store_save_load_roundtrip(tmp_path):
    specs = edge_network("squeezenet1.1")
    rate = max_rate("squeezenet1.1") * 0.9
    cfg = OrchestratorConfig(policy="pfdnn", n_max_rails=2, device="cpu")
    svc = CompileService()
    ref = svc.compile(specs, rate, cfg=cfg, network="sqz")
    path = tmp_path / "artifacts.npz"
    svc.save(path)
    loaded = CompileService(store=ArtifactStore().load(path))
    stats = loaded.store.stats()
    assert stats["schedules"] >= 1 and stats["masters"] >= 1
    assert stats["transitions"] >= 1 and stats["prunings"] >= 1
    assert loaded.compile(specs, rate, cfg=cfg, network="sqz").to_json() \
        == ref.to_json()
    loaded.store.clear(schedules=True, stacks=False, tables=False)
    _same(loaded.compile(specs, rate, cfg=cfg, network="sqz"), ref)


# ------------------------------------------------------- ctx= reuse

def test_compile_with_prebuilt_ctx_reuses_characterization(monkeypatch):
    import repro_torch.core.context as context_mod

    calls = {"n": 0}
    real = context_mod.characterize_network

    def counting(specs, acc):
        calls["n"] += 1
        return real(specs, acc)

    monkeypatch.setattr(context_mod, "characterize_network", counting)
    specs = edge_network("squeezenet1.1")
    rate = max_rate("squeezenet1.1") * 0.9
    ctx = CompilationContext(specs, rate, network="sqz")
    assert calls["n"] == 1
    cfgs = [OrchestratorConfig(policy=p, n_max_rails=2, device="cpu")
            for p in ("pfdnn", "greedy_gating")]
    refs = [compile_power_schedule(specs, rate, cfg=c) for c in cfgs]
    calls["n"] = 0
    via = [compile_power_schedule(specs, rate, cfg=c, ctx=ctx)
           for c in cfgs]
    assert calls["n"] == 0
    for a, b in zip(via, refs):
        assert _host_free_json(a) == _host_free_json(
            dataclasses.replace(b, network="sqz"))


def test_compile_with_mismatched_ctx_raises():
    specs = edge_network("squeezenet1.1")
    rate = max_rate("squeezenet1.1") * 0.9
    cfg = OrchestratorConfig(policy="pfdnn", n_max_rails=2, device="cpu")
    ctx = CompilationContext(specs, rate, network="sqz")
    _same(compile_power_schedule(specs, rate * 0.5, cfg=cfg, ctx=ctx),
          compile_power_schedule(specs, rate * 0.5, cfg=cfg, network="sqz"))
    with pytest.raises(ValueError, match="different network"):
        compile_power_schedule(edge_network("mobilenetv3-small"), rate,
                               cfg=cfg, ctx=ctx)
    with pytest.raises(ValueError, match="e_switch_nom"):
        compile_power_schedule(
            specs, rate, cfg=dataclasses.replace(cfg, e_switch_nom=5e-9),
            ctx=ctx)
    with pytest.raises(ValueError, match="network label"):
        compile_power_schedule(specs, rate, cfg=cfg, network="other",
                               ctx=ctx)
    with pytest.raises(ValueError, match="store"):
        compile_power_schedule(specs, rate, cfg=cfg, ctx=ctx,
                               store=ArtifactStore())
    with pytest.raises(ValueError, match="cost model"):
        compile(specs, MinEnergy(rate_hz=rate), cfg=cfg, ctx=ctx,
                cost_model=_ScaleModel((1.1,) * len(specs)))


# ------------------------------------------------ contingency bundle

def test_compile_contingencies_matches_reference():
    net = "squeezenet1.1"
    base = 0.5 * max_rate(net)
    kw = dict(n_points=4, network=net)
    got = CompileService().compile_contingencies(
        edge_network(net), base,
        cfg=OrchestratorConfig(n_max_rails=2, device="cpu"), **kw)
    want = RS.CompileService().compile_contingencies(
        ref_network(net), base,
        cfg=R.OrchestratorConfig(n_max_rails=2, backend="numpy"), **kw)
    assert got.deadlines() == want.deadlines()
    assert sorted(got.tightened) == sorted(want.tightened)
    assert got.base_deadline_s == want.base_deadline_s
    for d in got.points:
        _same(got.points[d], want.points[d])
    for d in got.tightened:
        _same(got.tightened[d], want.tightened[d])
    _same(got.aggressive, want.aggressive)
    _same(got.budget, want.budget)
    assert [(kind, d) for kind, d, _ in got.infeasible] == \
        [(kind, d) for kind, d, _ in want.infeasible]


# ------------------------------------------------ duck-typed cost model

@dataclasses.dataclass(frozen=True)
class _ScaleModel:
    """A fixed per-layer work scale, usable by either package."""

    scale: tuple

    @property
    def digest(self) -> str:
        return f"scale:{self.scale!r}"

    def apply(self, costs):
        return [dataclasses.replace(
            c, cycles=tuple(x * s for x in c.cycles),
            dyn_energy_nom=tuple(e * s for e in c.dyn_energy_nom))
            for c, s in zip(costs, self.scale)]


def test_cost_model_matches_reference():
    net = "squeezenet1.1"
    n = len(edge_network(net))
    model = _ScaleModel(tuple(1.0 + 0.02 * (i % 5) for i in range(n)))
    rate = 0.6 * max_rate(net)
    ctx = CompilationContext(edge_network(net), rate, network=net,
                             cost_model=model)
    rctx = R.CompilationContext(ref_network(net), rate, network=net,
                                cost_model=model)
    assert (ctx.model_key, ctx.content_key) == \
        (rctx.model_key, rctx.content_key)
    assert ctx.model_key != CompilationContext(
        edge_network(net), rate, network=net).model_key
    got = CompileService().compile(
        edge_network(net), rate, network=net, cost_model=model,
        cfg=OrchestratorConfig(n_max_rails=2, device="cpu"))
    want = RS.CompileService().compile(
        ref_network(net), rate, network=net, cost_model=model,
        cfg=R.OrchestratorConfig(n_max_rails=2, backend="numpy"))
    _same(got, want)
    assert got.cost_model == model.digest


# --------------------------------------------- stats() with no card

def test_stats_on_a_host_without_a_card(monkeypatch):
    """The store reports the transfer counters of the backends its
    compiles ran on; it never asks for the default (CUDA) backend,
    which raises on a host with no card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend_mod, "_INSTANCES", {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        backend_mod.get_backend()
    svc = CompileService()
    assert svc.store.stats()["backend_io"] == {}
    net = "squeezenet1.1"
    svc.compile(edge_network(net), 0.9 * max_rate(net), network=net,
                cfg=OrchestratorConfig(n_max_rails=2, device="cpu"))
    io = svc.store.stats()["backend_io"]
    assert list(io) == ["cpu"]
    assert io["cpu"]["kernel_dispatches"] > 0
    assert list(backend_mod._INSTANCES) == ["cpu"]


def test_cuda_request_is_never_moved_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(backend_mod, "_INSTANCES", {})
    net = "squeezenet1.1"
    req = CompileRequest(edge_network(net), 0.9 * max_rate(net),
                         OrchestratorConfig(n_max_rails=2), net)
    svc = CompileService()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        svc.compile_many([req])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        svc.compile(req.specs, req.target_rate_hz, cfg=req.cfg)
    assert svc.store.stats()["schedules"] == 0
