"""The port's on-disk artifact tier and compile farm on the CPU,
mirroring ``tests/test_farm.py``: entry digests, a writer killed
mid-publish, two processes racing on one digest, LRU eviction, schema
refusal and the schema-1 snapshot migration, fair-share admission, a
2-worker ``device="cpu"`` farm against solo compiles and a second farm
of fresh processes answering shared-warm — and the interop of the two
packages' tiers: a directory written by the reference's
``ArtifactStore`` is read by the port's and the reverse, every master,
transition and pruning under the same digest with arrays equal bit for
bit (decoded, since npz bytes carry zip timestamps).

Schedules are compared as ``to_json`` with the wall-clock and
backend-name solver stats set aside, against the reference's numpy
backend and the goldens.
"""

import dataclasses
import json
import multiprocessing
import os
import pathlib
import signal
import time

import numpy as np
import pytest

import repro.core as R
import repro.service as RS
from conftest import max_rate
from repro.models.edge_cnn import edge_network as ref_network
from repro_torch.core import (
    CompilationContext,
    OrchestratorConfig,
    compile_power_schedule,
)
from repro_torch.models.edge_cnn import edge_network
from repro_torch.service import (
    ArtifactStore,
    CompileFarm,
    CompileRequest,
    CompileService,
    DiskTier,
    FairShareAdmission,
    FarmResult,
    latency_summary,
)
from repro_torch.service.disk import DISK_SCHEMA, entry_digest

GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden"
                     / "pipeline.json").read_text())
HOST_STATS = ("wall_time_s", "backend", "ilp_wall_time_s")
# counters of the round scheduler as a whole, which differ between a
# farm batch (a fleet) and a solo compile
FLEET_STATS = ("stacked_rounds", "stacked_calls", "fleet_networks")
KEY = "squeezenet1.1|0.9|2|pfdnn"


def _cfg_for(key: str):
    network, frac, n_rails, policy = key.split("|")
    return (network, max_rate(network) * float(frac),
            OrchestratorConfig(policy=policy, n_max_rails=int(n_rails),
                               device="cpu"))


def _request_for(key: str) -> CompileRequest:
    network, rate, cfg = _cfg_for(key)
    return CompileRequest(edge_network(network), rate, cfg,
                          network=network)


def _ref_solo(key: str):
    network, frac, n_rails, policy = key.split("|")
    return R.compile_power_schedule(
        ref_network(network), max_rate(network) * float(frac),
        cfg=R.OrchestratorConfig(policy=policy, n_max_rails=int(n_rails),
                                 backend="numpy"), network=network)


def _host_free_json(sched, drop=HOST_STATS) -> str:
    stats = {k: v for k, v in sched.solver_stats.items()
             if k not in drop}
    return dataclasses.replace(sched, solver_stats=stats).to_json()


def _assert_matches(key: str, sched, drop=HOST_STATS) -> None:
    """The reference's solo compile, byte for byte, and the golden."""
    assert sched is not None
    assert _host_free_json(sched, drop) == \
        _host_free_json(_ref_solo(key), drop)
    g = GOLDEN[key]
    assert list(sched.rails) == g["rails"]
    assert sched.e_total == pytest.approx(g["e_total"], rel=1e-9)


# ------------------------------------------------- disk tier: digests

def test_entry_digest_matches_reference():
    from repro.service.disk import entry_digest as ref_digest

    assert entry_digest("ab", "c") != entry_digest("a", "bc")
    assert entry_digest("abc") != entry_digest("ab", "c")
    assert entry_digest(b"x") != entry_digest("x")
    for parts in (("k", 1.0), ("m", b"\x00\x01", True),
                  ("p", "c", True, (0.9, 1.2))):
        assert entry_digest(*parts) == ref_digest(*parts)


# ------------------------------------- crash consistency / concurrency

def _orphaning_writer(root: str, digest: str) -> None:
    tmp = pathlib.Path(root) / "schedules" / \
        f"{digest}.json.{os.getpid()}.0.tmp"
    tmp.write_bytes(b'{"schema": 2, "key": ["truncat')
    time.sleep(600)


def test_killed_writer_mid_publish(tmp_path):
    root = tmp_path / "store"
    tier = DiskTier(root)
    key = ("content", "min_energy|0.01", "cfg")
    digest = tier.schedule_digest(key)
    p = multiprocessing.get_context("fork").Process(
        target=_orphaning_writer, args=(str(root), digest))
    p.start()
    orphan = root / "schedules" / f"{digest}.json.{p.pid}.0.tmp"
    for _ in range(200):
        if orphan.exists():
            break
        time.sleep(0.05)
    assert orphan.exists()
    os.kill(p.pid, signal.SIGKILL)
    p.join(timeout=10)
    assert not p.is_alive()

    tier2 = DiskTier(root)
    assert tier2.get_schedule(key) is None
    assert tier2.stats()["entries"]["schedules"] == 0
    assert orphan.exists()                    # fresh orphan: not swept
    tier2.put_schedule(key, "payload")
    assert tier2.get_schedule(key) == "payload"
    old = time.time() - 7200
    os.utime(orphan, (old, old))
    tier3 = DiskTier(root)
    assert not orphan.exists()
    assert tier3.orphans_swept == 1
    assert tier3.get_schedule(key) == "payload"


def _racing_writer(root: str, payload: str, n: int) -> None:
    tier = DiskTier(root)
    for _ in range(n):
        tier.put_schedule(("content", "goal", "cfg"), payload)


def test_two_process_same_digest_race(tmp_path):
    root = tmp_path / "store"
    DiskTier(root)
    payload = json.dumps({"rails": [0.9, 1.3], "e": 1.25e-4})
    ctx = multiprocessing.get_context("fork")
    procs = [ctx.Process(target=_racing_writer,
                         args=(str(root), payload, 60))
             for _ in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        assert p.exitcode == 0
    names = list((root / "schedules").iterdir())
    entries = [p for p in names if not p.name.endswith(".tmp")]
    assert len(entries) == 1 and len(names) == 1
    assert json.loads(entries[0].read_bytes())["payload"] == payload


# ------------------------------------------------- eviction + schema

def test_lru_eviction_oldest_first(tmp_path):
    tier = DiskTier(tmp_path / "store", max_entries=2)
    keys = [("c", f"goal{i}", "cfg") for i in range(4)]
    for i, key in enumerate(keys):
        tier.put_schedule(key, f"payload{i}")
        path = tier._path("schedules", tier.schedule_digest(key), ".json")
        os.utime(path, (1000.0 + i, 1000.0 + i))
    assert tier.get_schedule(keys[0]) == "payload0"   # bumps recency
    assert tier.evict_to_budget() == 2
    assert tier.get_schedule(keys[0]) == "payload0"
    assert tier.get_schedule(keys[3]) == "payload3"
    assert tier.get_schedule(keys[1]) is None
    assert tier.get_schedule(keys[2]) is None
    assert tier.stats()["evictions"]["schedules"] == 2


def test_unknown_newer_schema_refuses(tmp_path):
    root = tmp_path / "store"
    DiskTier(root)
    meta = json.loads((root / "STORE_META.json").read_text())
    assert meta["schema"] == DISK_SCHEMA == 2
    (root / "STORE_META.json").write_text(json.dumps({"schema": 99}))
    for build in (DiskTier, lambda r: ArtifactStore(disk_path=r),
                  lambda r: CompileFarm(r)):
        with pytest.raises(ValueError, match="schema 99"):
            build(root)


def test_store_eviction_budget_and_deferred_publication(tmp_path):
    store = ArtifactStore(disk_path=tmp_path / "store")
    sched_dir = tmp_path / "store" / "schedules"
    with store.deferred_publication():
        store.put_schedule(("c", "g1", "cfg"), None)
        store.put_schedule(("c", "g1", "cfg"), None)   # dedup
        with store.deferred_publication():             # nested: no-op
            store.put_schedule(("c", "g2", "cfg"), None)
        assert list(sched_dir.iterdir()) == []
    assert len(list(sched_dir.iterdir())) == 2
    small = ArtifactStore(disk_path=tmp_path / "small",
                          max_disk_entries=1)
    for i in range(3):
        small.put_schedule(("c", f"g{i}", "cfg"), None)
    small.flush_disk()
    stats = small.stats()["disk"]
    assert stats["entries"]["schedules"] == 1
    assert sum(stats["evictions"].values()) == 2


# ------------------------------------------------- store: disk tier

def test_disk_warm_store_and_clear(tmp_path):
    """A compile publishes to disk; a fresh store over the directory
    answers shared-warm, and a full solve on it warm-starts from the
    tier's tables; clearing memory streams entries back from disk."""
    root = tmp_path / "store"
    network, rate, cfg = _cfg_for(KEY)
    svc = CompileService(disk_path=root)
    _assert_matches(KEY, svc.compile(edge_network(network), rate,
                                     cfg=cfg, network=network))
    svc.store.clear()
    _assert_matches(KEY, svc.compile(edge_network(network), rate,
                                     cfg=cfg, network=network))
    assert svc.store.stats()["disk_hits"]["schedule"] == 1
    fresh = CompileService(store=ArtifactStore(disk_path=root),
                           use_schedule_cache=False)
    _assert_matches(KEY, fresh.compile(edge_network(network), rate,
                                       cfg=cfg, network=network))
    dh = fresh.store.stats()["disk_hits"]
    assert dh["master"] >= 1 and dh["transition"] >= 1
    assert dh["pruning"] >= 1


def test_snapshot_migration_roundtrip(tmp_path):
    network, rate, cfg = _cfg_for(KEY)
    svc = CompileService()
    svc.compile(edge_network(network), rate, cfg=cfg, network=network)
    snap = tmp_path / "snapshot.npz"
    svc.store.save(snap)
    root = tmp_path / "store"
    tier = ArtifactStore(disk_path=root).load(snap).stats()["disk"]
    for cat in ("schedules", "masters", "transitions", "prunings"):
        assert tier["entries"][cat] >= 1
    fresh = CompileService(store=ArtifactStore(disk_path=root))
    _assert_matches(KEY, fresh.compile(edge_network(network), rate,
                                       cfg=cfg, network=network))
    assert fresh.store.stats()["disk_hits"]["schedule"] == 1
    bad = tmp_path / "bad.npz"
    np.savez_compressed(bad, manifest=np.frombuffer(
        json.dumps({"version": 9}).encode(), dtype=np.uint8))
    with pytest.raises(ValueError, match="version 9"):
        ArtifactStore().load(bad)


def test_compile_accepts_store_path(tmp_path):
    network, rate, cfg = _cfg_for(KEY)
    root = tmp_path / "store"
    first = compile_power_schedule(edge_network(network), rate, cfg=cfg,
                                   network=network, store=str(root))
    _assert_matches(KEY, first)
    assert (root / "STORE_META.json").exists()
    again = compile_power_schedule(edge_network(network), rate, cfg=cfg,
                                   network=network, store=root)
    _assert_matches(KEY, again)
    with pytest.raises(TypeError, match="store="):
        compile_power_schedule(edge_network(network), rate, cfg=cfg,
                               network=network, store=42)


# ------------------------------------- interop with the reference's tier

def _entries(root: pathlib.Path) -> list[tuple[str, tuple, str]]:
    """(category, key, file digest) of every published entry, with the
    key read back from the entry's own payload."""
    out = []
    for path in sorted((root / "masters").glob("*.npz")):
        with np.load(path) as npz:
            meta = json.loads(bytes(npz["meta"]).decode())
        out.append(("master", (meta["key"], meta["gating"]), path.stem))
    for path in sorted((root / "transitions").glob("*.npz")):
        with np.load(path) as npz:
            meta = json.loads(bytes(npz["meta"]).decode())
        out.append(("transition", (meta["tm"], bytes.fromhex(meta["a"]),
                                   bytes.fromhex(meta["b"])), path.stem))
    for path in sorted((root / "prunings").glob("*.json")):
        ent = json.loads(path.read_text())
        out.append(("pruning", (ent["content"], ent["gating"],
                                tuple(ent["rails"])), path.stem))
    return out


def _read(tier, cat: str, key: tuple):
    return getattr(tier, f"get_{cat}")(key)


def _assert_entries_equal(a, b) -> None:
    if isinstance(a, dict):                   # master record
        assert a.keys() == b.keys()
        for name in ("volts", "t_op", "e_op"):
            for x, y in zip(a[name], b[name], strict=True):
                assert x.dtype == y.dtype and x.shape == y.shape
                assert x.tobytes() == y.tobytes()
        assert a["vkey"] == b["vkey"]
    else:                                     # transition / pruning
        for x, y in zip(a, b, strict=True):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_disk_tier_interop(tmp_path, writer):
    """One package compiles onto a disk tier; the other reads every
    master, transition and pruning under the same digest, with equal
    arrays, and compiles warm from it to the reference's schedule."""
    network, rate, cfg = _cfg_for(KEY)
    root = tmp_path / "store"
    if writer == "reference":
        R.compile_power_schedule(
            ref_network(network), rate, network=network, store=str(root),
            cfg=R.OrchestratorConfig(n_max_rails=2, backend="numpy"))
    else:
        compile_power_schedule(edge_network(network), rate, cfg=cfg,
                               network=network, store=str(root))
    entries = _entries(root)
    cats = {cat for cat, _, _ in entries}
    assert cats == {"master", "transition", "pruning"}
    port_tier, ref_tier = DiskTier(root), RS.DiskTier(root)
    for cat, key, stem in entries:
        digest = getattr(DiskTier, f"{cat}_digest")(key)
        assert digest == stem == getattr(RS.DiskTier, f"{cat}_digest")(key)
        _assert_entries_equal(_read(port_tier, cat, key),
                              _read(ref_tier, cat, key))
    # the reader's own compile finds its keys in the writer's entries
    if writer == "reference":
        store = ArtifactStore(disk_path=root)
        ctx = CompilationContext(edge_network(network), rate,
                                 network=network, store=store)
        sched = compile_power_schedule(edge_network(network), rate,
                                       cfg=cfg, ctx=ctx)
        hits = store.stats()["disk_hits"]
    else:
        store = RS.ArtifactStore(disk_path=root)
        sched = R.compile_power_schedule(
            ref_network(network), rate, network=network, store=store,
            cfg=R.OrchestratorConfig(n_max_rails=2, backend="numpy"))
        hits = store.stats()["disk_hits"]
    assert hits["master"] >= 1 and hits["transition"] >= 1
    assert hits["pruning"] >= 1
    assert _host_free_json(sched) == _host_free_json(_ref_solo(KEY))


# ------------------------------------------------- fair-share admission

def test_fair_share_round_robin_interleave():
    adm = FairShareAdmission()
    for i in range(6):
        adm.push("A", f"A{i}")
    for t in ("B", "C"):
        for i in range(2):
            adm.push(t, f"{t}{i}")
    assert adm.next_batch(6) == ["A0", "B0", "C0", "A1", "B1", "C1"]
    assert adm.next_batch(10) == ["A2", "A3", "A4", "A5"]
    assert adm.pending() == 0


def test_fair_share_late_tenant_admitted_next_batch():
    adm = FairShareAdmission()
    for i in range(100):
        adm.push("burst", f"b{i}")
    assert adm.next_batch(4) == ["b0", "b1", "b2", "b3"]
    adm.push("interactive", "i0")
    nxt = adm.next_batch(4)
    assert nxt.count("i0") == 1 and len(nxt) == 4


def test_latency_summary_per_tenant():
    rows = [FarmResult(uid=0, tenant=t, value=None, latency_s=s,
                       worker=0, batch_id=0, batch_wall_s=s)
            for t, s in (("A", 0.1), ("A", 0.2), ("A", 0.3),
                         ("B", 1.0), ("B", 2.0))]
    summary = latency_summary(rows)
    assert summary["fleet"]["n"] == 5 and summary["fleet"]["max_s"] == 2.0
    assert summary["tenants"]["A"]["p50_s"] == pytest.approx(0.2)
    assert summary["tenants"]["B"]["n"] == 2


# ------------------------------------------------- farm end to end

def test_farm_inline_repeat_traffic_hits_cache(tmp_path):
    farm = CompileFarm(tmp_path / "store", n_workers=0, batch_size=4)
    uids = farm.submit("A", [_request_for(KEY)] * 3) \
        + farm.submit("B", [_request_for(KEY)] * 3)
    results = farm.drain()
    farm.close()
    for uid in uids:
        assert results[uid].error is None
        _assert_matches(KEY, results[uid].value)
    counters = farm.counters()
    assert counters["hits"]["schedule"] >= 2
    assert counters["misses"]["schedule"] >= 1
    assert farm.n_batches >= 2


def test_farm_validates_arguments(tmp_path):
    with pytest.raises(ValueError, match="n_workers"):
        CompileFarm(tmp_path / "s", n_workers=-1)
    with pytest.raises(ValueError, match="batch_size"):
        CompileFarm(tmp_path / "s", batch_size=0)


def test_farm_cross_process_shared_warm(tmp_path):
    """A 2-worker spawn farm of CPU requests compiles cold; a second
    farm of fresh processes over the same directory answers from the
    first one's entries (cross-process disk hits) — the reference's
    schedules both times, and no error in any result."""
    keys = ["squeezenet1.1|0.9|2|pfdnn", "mobilenetv3-small|0.85|2|pfdnn"]
    root = tmp_path / "store"

    def run_farm():
        with CompileFarm(root, n_workers=2, batch_size=2) as farm:
            uid_to_key = {}
            for tenant, key in zip(("A", "B", "A", "B"), keys * 2):
                (uid,) = farm.submit(tenant, [_request_for(key)])
                uid_to_key[uid] = key
            results = farm.drain()
            counters = farm.counters()
            procs = list(farm._procs)
        assert len(procs) == 2
        assert not any(p.is_alive() for p in procs)   # joined at close
        return [(uid_to_key[u], r) for u, r in results.items()], counters

    cold, _ = run_farm()
    warm, warm_counters = run_farm()
    assert len(cold) == len(warm) == 4
    for key, res in cold + warm:
        assert res.error is None, res.error
        _assert_matches(key, res.value, HOST_STATS + FLEET_STATS)
    assert warm_counters["disk_hits"]["schedule"] >= 1


def test_service_close_and_context_manager(tmp_path):
    network, rate, cfg = _cfg_for(KEY)
    with CompileService(disk_path=tmp_path / "store") as svc:
        _assert_matches(KEY, svc.compile(edge_network(network), rate,
                                         cfg=cfg, network=network))
    svc.close()                        # idempotent
    _assert_matches(KEY, svc.compile(edge_network(network), rate,
                                     cfg=cfg, network=network))
    fut = svc.compile_many_async([_request_for(KEY)])
    _assert_matches(KEY, fut.result(timeout=120)[0])
    svc.close()
    with pytest.raises(ValueError, match="not both"):
        CompileService(store=ArtifactStore(), disk_path=tmp_path / "x")
