"""Multi-tenant compile farm: multi-process workers over one shared
on-disk artifact store.

Production compile traffic is many tenants' ``compile_many`` batches
arriving concurrently.  One process cannot serve it all — and without a
shared store, every extra process re-characterizes, re-builds master
tables, and re-solves schedules another process already paid for.  The
farm closes both gaps:

  - **shared store** — every worker process opens its own
    :class:`~repro_torch.service.ArtifactStore` over the same
    ``disk_path`` (the content-addressable per-entry tier of
    :mod:`repro_torch.service.disk`): artifacts published by one worker are
    disk hits in every other, and a later farm over the same directory
    starts shared-warm;
  - **fair-share admission** — requests queue per tenant and batches
    are formed by round-robin interleave across tenants
    (:class:`FairShareAdmission`): a tenant's thousand-request burst
    fills at most its fair share of every batch, so another tenant's
    interactive compile rides the very next batch instead of queueing
    behind the burst;
  - **merged round scheduling** — each admitted batch (requests from
    *many* tenants) runs as ONE ``compile_many`` on its worker: every
    network's rail sweep co-schedules in a single round scheduler, and
    the batch's store publications flush once at the end
    (``deferred_publication``).

Results are bit-identical to solo ``compile`` calls — ``compile_many``
guarantees per-request identity, the store's artifacts are
content-addressed and immutable, and cross-process entries carry the
exact serialized bytes a solo compile would produce (pinned against
the goldens in ``tests/test_farm.py``).

``n_workers=0`` runs batches inline in the calling process (same
admission, same merged batches — the deterministic vehicle for tests);
``n_workers>=1`` spawns that many worker processes.  Workers default to
the ``spawn`` start method: CUDA cannot run in a forked child, and a
spawned worker inherits no thread or device state from the parent.  A
worker touches no device until a request names one (``cfg.device``),
so a farm of CPU requests starts no CUDA context; the CUDA libraries a
worker loads were built once by whichever process came first (each is
published by ``os.replace``, so no process reads a half-written one).
A worker whose batch raises reports the error in every
:class:`FarmResult` of that batch and keeps serving.
"""

from __future__ import annotations

import collections
import dataclasses
import multiprocessing
import os
import pathlib
import queue as queue_mod
import time
from typing import Sequence

import numpy as np

from repro_torch.hw.edge40nm import EDGE40NM_DEFAULT, Edge40nmAccelerator
from repro_torch.service.compile_service import CompileRequest, CompileService
from repro_torch.service.store import ArtifactStore

_COUNTER_KINDS = ("hits", "misses", "disk_hits")


@dataclasses.dataclass
class FarmResult:
    """One request's outcome: the compile value (schedule /
    ``InfeasibleGoal`` / ``ParetoFrontier`` / legacy None), end-to-end
    queue latency (enqueue → result receipt, the saturation bench's
    latency metric), and placement provenance."""

    uid: int
    tenant: str
    value: object
    latency_s: float
    worker: int
    batch_id: int
    batch_wall_s: float
    error: str | None = None


class FairShareAdmission:
    """Per-tenant FIFO queues with round-robin batch formation.

    ``next_batch(n)`` cycles tenants (resuming after the last-served
    tenant) taking one request per tenant per turn until the batch is
    full or the queues are empty — so a batch holds roughly
    ``n / n_active_tenants`` requests of each active tenant, whatever
    the queue depths.  Within a tenant, order stays FIFO."""

    def __init__(self):
        self._queues: dict[str, collections.deque] = {}
        self._order: list[str] = []
        self._next_tenant = 0

    def push(self, tenant: str, item) -> None:
        if tenant not in self._queues:
            self._queues[tenant] = collections.deque()
            self._order.append(tenant)
        self._queues[tenant].append(item)

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def next_batch(self, n: int) -> list:
        batch: list = []
        while len(batch) < n and self.pending():
            tenant = self._order[self._next_tenant % len(self._order)]
            self._next_tenant += 1
            q = self._queues[tenant]
            if q:
                batch.append(q.popleft())
        return batch


def _stats_counters(store: ArtifactStore) -> dict:
    stats = store.stats()
    return {kind: dict(stats[kind]) for kind in _COUNTER_KINDS}


def _counters_delta(now: dict, base: dict) -> dict:
    return {kind: {c: now[kind][c] - base[kind].get(c, 0)
                   for c in now[kind]} for kind in _COUNTER_KINDS}


def _farm_worker(worker_id: int, disk_path: str,
                 acc: Edge40nmAccelerator, use_schedule_cache: bool,
                 task_q, result_q) -> None:
    """Worker process main: pull admitted batches, run each as one
    ``compile_many`` against the shared disk store, ship results (and
    the batch's store-counter deltas) back.  A ``None`` task is the
    shutdown sentinel."""
    svc = CompileService(acc, store=ArtifactStore(disk_path=disk_path),
                         use_schedule_cache=use_schedule_cache)
    base = _stats_counters(svc.store)
    while True:
        task = task_q.get()
        if task is None:
            break
        batch_id, items = task
        tic = time.perf_counter()
        error = None
        try:
            values = svc.compile_many([req for _, req in items])
        except Exception as exc:  # report, keep the worker serving
            values = [None] * len(items)
            error = repr(exc)
        wall = time.perf_counter() - tic
        now = _stats_counters(svc.store)
        delta = _counters_delta(now, base)
        base = now
        result_q.put((worker_id, batch_id, [uid for uid, _ in items],
                      values, wall, delta, error))
    svc.close()


def _importable_src_root() -> str:
    """Directory that makes ``repro_torch`` importable — prepended to
    the child PYTHONPATH so ``spawn`` workers can re-import this module
    even when the parent got ``repro_torch`` via ``sys.path``
    manipulation (pytest) instead of the environment."""
    import repro_torch

    pkg_dir = pathlib.Path(next(iter(repro_torch.__path__)))
    return str(pkg_dir.resolve().parent)


class CompileFarm:
    """Multi-process compile farm over one shared on-disk artifact
    store (see module docstring).

    Usage::

        with CompileFarm(disk_path, n_workers=4) as farm:
            farm.submit("teamA", requests_a)
            farm.submit("teamB", requests_b)
            results = farm.drain()          # uid -> FarmResult

    ``submit`` may be called repeatedly (also between ``drain`` calls);
    batches are formed lazily as workers free up, so late-arriving
    tenants are admitted fairly against an existing backlog.
    """

    def __init__(self, disk_path, *, n_workers: int = 2,
                 acc: Edge40nmAccelerator = EDGE40NM_DEFAULT,
                 batch_size: int = 16,
                 use_schedule_cache: bool = True,
                 mp_context: str = "spawn",
                 max_disk_bytes: int | None = None):
        if n_workers < 0:
            raise ValueError(f"n_workers must be >= 0, got {n_workers}")
        if batch_size < 1:
            raise ValueError(
                f"batch_size must be >= 1, got {batch_size}")
        self.disk_path = str(disk_path)
        self.n_workers = n_workers
        self.acc = acc
        self.batch_size = batch_size
        self.use_schedule_cache = use_schedule_cache
        self.mp_context = mp_context
        # build (and budget) the tier eagerly so a bad path or an
        # incompatible schema fails at construction, not in a worker
        ArtifactStore(disk_path=self.disk_path,
                      max_disk_bytes=max_disk_bytes)
        self._admission = FairShareAdmission()
        self._meta: dict[int, tuple[str, float]] = {}  # uid -> (tenant, t)
        self._uids = iter(range(1, 1 << 62)).__next__
        self._procs: list = []
        self._task_q = None
        self._result_q = None
        self._in_flight = 0
        self._next_batch_id = 0
        self._inline_svc: CompileService | None = None
        self.worker_counters: dict[int, dict] = {}
        self.n_batches = 0

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "CompileFarm":
        if self.n_workers == 0 or self._procs:
            return self
        ctx = multiprocessing.get_context(self.mp_context)
        self._task_q = ctx.Queue()
        self._result_q = ctx.Queue()
        old_pp = os.environ.get("PYTHONPATH")
        src_root = _importable_src_root()
        parts = old_pp.split(os.pathsep) if old_pp else []
        if src_root not in parts:
            os.environ["PYTHONPATH"] = os.pathsep.join([src_root]
                                                       + parts)
        try:
            for wid in range(self.n_workers):
                p = ctx.Process(
                    target=_farm_worker,
                    args=(wid, self.disk_path, self.acc,
                          self.use_schedule_cache, self._task_q,
                          self._result_q),
                    daemon=True)
                p.start()
                self._procs.append(p)
        finally:
            if old_pp is None:
                os.environ.pop("PYTHONPATH", None)
            else:
                os.environ["PYTHONPATH"] = old_pp
        return self

    def close(self) -> None:
        """Shut the farm down: workers drain their queued batches, get
        a sentinel each, and are joined (terminated if they overrun the
        join timeout)."""
        for _ in self._procs:
            self._task_q.put(None)
        for p in self._procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        self._procs = []
        if self._inline_svc is not None:
            self._inline_svc.close()
            self._inline_svc = None

    def __enter__(self) -> "CompileFarm":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- submission / draining ----------------------------------------
    def submit(self, tenant: str,
               requests: Sequence[CompileRequest]) -> list[int]:
        """Queue a tenant's batch; returns the request uids (keys of
        the ``drain`` result dict).  Enqueue time is stamped here —
        reported latencies include every queueing delay the tenant
        actually saw."""
        uids = []
        now = time.perf_counter()
        for req in requests:
            uid = self._uids()
            self._meta[uid] = (tenant, now)
            self._admission.push(tenant, (uid, req))
            uids.append(uid)
        return uids

    def pending(self) -> int:
        return self._admission.pending() + self._in_flight

    def drain(self) -> dict[int, FarmResult]:
        """Run every queued request to completion and return
        ``uid -> FarmResult``.  Batches are formed (fair-share) only as
        workers free up, one in flight per worker, so admission order —
        not queue arrival order — decides who compiles next."""
        if self.n_workers == 0:
            return self._drain_inline()
        self.start()
        results: dict[int, FarmResult] = {}
        while self._admission.pending() or self._in_flight:
            while self._in_flight < self.n_workers \
                    and self._admission.pending():
                items = self._admission.next_batch(self.batch_size)
                self._task_q.put((self._next_batch_id, items))
                self._next_batch_id += 1
                self.n_batches += 1
                self._in_flight += 1
            msg = self._collect()
            self._record(msg, results)
        return results

    def _collect(self):
        while True:
            try:
                return self._result_q.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [p for p in self._procs if not p.is_alive()]
                if dead:
                    raise RuntimeError(
                        f"{len(dead)} farm worker(s) died with a batch "
                        f"in flight (exitcodes "
                        f"{[p.exitcode for p in dead]})")

    def _record(self, msg, results: dict[int, FarmResult]) -> None:
        worker_id, batch_id, uids, values, wall, delta, error = msg
        self._in_flight -= 1
        now = time.perf_counter()
        if delta is not None:
            agg = self.worker_counters.setdefault(
                worker_id, {k: {} for k in _COUNTER_KINDS})
            for kind in _COUNTER_KINDS:
                for cat, v in delta[kind].items():
                    agg[kind][cat] = agg[kind].get(cat, 0) + v
        for uid, value in zip(uids, values):
            tenant, t_enq = self._meta.pop(uid)
            results[uid] = FarmResult(
                uid=uid, tenant=tenant, value=value,
                latency_s=now - t_enq, worker=worker_id,
                batch_id=batch_id, batch_wall_s=wall, error=error)

    def _drain_inline(self) -> dict[int, FarmResult]:
        if self._inline_svc is None:
            self._inline_svc = CompileService(
                self.acc, store=ArtifactStore(disk_path=self.disk_path),
                use_schedule_cache=self.use_schedule_cache)
        svc = self._inline_svc
        results: dict[int, FarmResult] = {}
        base = _stats_counters(svc.store)
        while self._admission.pending():
            items = self._admission.next_batch(self.batch_size)
            batch_id = self._next_batch_id
            self._next_batch_id += 1
            self.n_batches += 1
            tic = time.perf_counter()
            values = svc.compile_many([req for _, req in items])
            wall = time.perf_counter() - tic
            now_counters = _stats_counters(svc.store)
            msg = (0, batch_id, [uid for uid, _ in items], values, wall,
                   _counters_delta(now_counters, base), None)
            base = now_counters
            self._in_flight += 1       # _record decrements
            self._record(msg, results)
        return results

    # -- aggregate metrics --------------------------------------------
    def counters(self) -> dict:
        """Store hit/miss/disk-hit counters summed over workers — the
        cross-process sharing signal (``disk_hits``) the saturation
        bench reports."""
        total = {k: {} for k in _COUNTER_KINDS}
        for agg in self.worker_counters.values():
            for kind in _COUNTER_KINDS:
                for cat, v in agg[kind].items():
                    total[kind][cat] = total[kind].get(cat, 0) + v
        return total


def latency_summary(results: Sequence[FarmResult]) -> dict:
    """p50/p99/mean/max queue latency, fleet-wide and per tenant —
    shared by the saturation bench and the fairness assertions."""

    def summarize(lat: list[float]) -> dict:
        arr = np.array(lat)
        return {"n": len(lat),
                "p50_s": float(np.percentile(arr, 50)),
                "p99_s": float(np.percentile(arr, 99)),
                "mean_s": float(arr.mean()),
                "max_s": float(arr.max())}

    by_tenant: dict[str, list[float]] = {}
    for r in results:
        by_tenant.setdefault(r.tenant, []).append(r.latency_s)
    return {
        "fleet": summarize([r.latency_s for r in results]),
        "tenants": {t: summarize(lat)
                    for t, lat in sorted(by_tenant.items())},
    }
