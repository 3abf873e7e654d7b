"""Process-wide artifact store for the fleet compile service.

A deployment service compiles many networks for one accelerator under
heavy traffic; almost everything the compiler builds per call is
content-addressable and therefore shareable process-wide:

  - **characterization + bank plan** — keyed by (layer specs, accelerator)
    content;
  - **master per-layer state tables** — keyed by the same content plus
    the gating flag (none of these depend on the target rate);
  - **pairwise transition matrices** — keyed by (transition model,
    voltage table content) pairs, exactly the content keys
    :class:`~repro_torch.core.context.CompilationContext` already uses, now
    shared across contexts;
  - **subset lane stores** (:class:`~repro_torch.core.backend.BucketStack`)
    — the padded tensors of every solved rail subset, keyed by
    ``(levels, n_layers, S_pad)`` bucket signature with content-derived
    lane keys, so later compilations of the same subsets skip both
    ``build_padded`` and the admission copy, and rail subsets of
    *different* networks sharing a bucket stack into one lane axis;
  - **structure-pruning keep maps** — keyed by (network content,
    gating, rails); the domination scoring is deadline/goal-independent,
    so every rate, budget, and frontier point of a network shares one
    entry;
  - **compiled schedules** — keyed by (network content hash, compile
    goal, semantic config), serialized through
    ``PowerSchedule.to_json`` so a cache hit returns a fresh
    deserialized artifact; provably-impossible goals cache their
    structured ``InfeasibleGoal`` (reason + bound) the same way;
  - **characterization calibrations** — measured roofline tables from
    the :mod:`repro_torch.calib` harness, keyed by (host fingerprint,
    accelerator, harness config) content so every farm worker on one
    host shares a single measurement pass.

With ``disk_path=`` the store gains a second tier: a content-addressable
on-disk store of per-entry digest-named immutable files
(:class:`~repro_torch.service.disk.DiskTier` — atomic-rename publication,
concurrent-writer safe, LRU/size-budget eviction, schema-versioned).
Lookups go **memory → disk → miss**: warm entries stream in lazily from
disk instead of loading a whole snapshot, and computed entries publish
through to disk so *other processes* sharing the directory warm-start
from them — the compile farm's shared store
(:mod:`repro_torch.service.farm`).  ``deferred_publication()`` batches the
disk writes of a ``compile_many`` so publication happens once per
batch, not once per artifact mid-solve.  Characterization and the
subset lane stores stay memory-only (both are cheap to rebuild relative
to their serialized size).

Backend instances are process-wide (``get_backend`` memoizes one
:class:`~repro_torch.core.backend.TorchBackend` per device);
:meth:`ArtifactStore.backend` hands them out and records which devices
this store's compiles ran on, so :meth:`stats` reports the transfer
counters of exactly those backends (``backend_io``, by device) and
never touches a device the store did not use.

Device residency rides on the same ownership: the backend keeps a
device mirror of every lane store inside ``BucketStack.scratch`` (one
upload per lane, warm rounds transfer nothing — see
``TorchBackend._mirror``), and nothing else holds a mirror, so
``clear(stacks=True)`` / ``trim_stacks`` free the device buffers
together with the host lanes.

All caches hold immutable values; mutating operations take the store
lock, and value recomputation races at worst duplicate work (identical
content), never tear a read — safe for concurrent ``compile_many``
within a process and, through the disk tier, across processes.

``save``/``load`` persist the transition matrices, master tables, and
the schedule cache to one monolithic ``.npz`` file (arrays + a JSON
manifest, schema 1) so a service restart warm-starts from disk; a
disk-backed store republishes every loaded entry as per-entry files —
the schema-1 → schema-2 migration path for pre-existing snapshots.
"""

from __future__ import annotations

import contextlib
import json
import os
import pathlib
from typing import Sequence

import numpy as np

from repro_torch.analysis.lockcheck import make_lock
from repro_torch.core.backend import StackCaches, get_backend
from repro_torch.core.context import _digest
from repro_torch.core.goals import InfeasibleGoal
from repro_torch.core.problem import _pairwise_transition
from repro_torch.core.schedule import PowerSchedule
from repro_torch.hw.edge40nm import Edge40nmAccelerator
from repro_torch.perfmodel.gating import plan_banks
from repro_torch.perfmodel.layer_costs import LayerSpec, characterize_network
from repro_torch.service.disk import DiskTier

# schedule-cache sentinel for "compiled and found infeasible" — an
# infeasible sweep is as expensive as a feasible one, so repeats of an
# impossible (network, rate) must hit the cache too
_INFEASIBLE = "__infeasible__"
# structured variant: the goal API caches the InfeasibleGoal (reason +
# bounds) so repeats get the diagnosis, not just the verdict
_INFEASIBLE_GOAL_PREFIX = "__infeasible_goal__:"

#: stat categories (hit/miss/eviction counters); "lanes" counts the
#: subset lane stores' warm-padded lookups (see StackCaches)
_CATEGORIES = ("characterization", "master", "transition", "schedule",
               "pruning", "calibration", "lanes")


def _migrate_schedule_key(key: tuple) -> tuple:
    """Normalize a snapshot schedule key to the goal-keyed format.

    Pre-goal snapshots keyed schedules by ``repr(float(rate))``; the
    goal API keys the same point by ``MinEnergy(rate_hz=rate).key()``
    — i.e. ``min_energy|{1/rate!r}``.  The deadline is computed with
    the exact float division the goal value performs, so a migrated
    entry hits precisely the lookups the old one served.  Goal-format
    segments (they all carry a ``|``) pass through untouched.
    """
    if len(key) != 3 or "|" in key[1]:
        return key
    try:
        rate = float(key[1])
    except ValueError:
        return key
    if rate <= 0.0:
        return key
    from repro_torch.core.goals import MinEnergy

    return (key[0], MinEnergy(rate_hz=rate).key(), key[2])


class ArtifactStore:
    """Thread-safe, content-addressable cache of every shareable
    compilation artifact, optionally backed by a shared on-disk tier
    (see module docstring)."""

    def __init__(self, disk_path=None, *,
                 max_disk_bytes: int | None = None,
                 max_disk_entries: int | None = None):
        self._lock = make_lock("store._lock", reentrant=True)
        # specs_acc_key -> (costs, plan)
        self._characterization: dict = {}
        # (specs_acc_key, gating) -> master record (volts/t_op/e_op/vkey)
        self._masters: dict = {}
        # (tm_key, volts_a bytes, volts_b bytes) -> (T, E, switch)
        self._transitions: dict = {}
        # (content_key, goal_key, cfg_key) -> PowerSchedule JSON text
        self._schedules: dict = {}
        # (content_key, gating, rails) -> per-layer keep-index maps
        # (structure pruning is deadline/goal-independent, so one entry
        # serves every rate, budget, and frontier point of a network)
        self._prunings: dict = {}
        # calibration content key -> RooflineTable record (JSON dict);
        # keyed on host fingerprint × accelerator × harness config, so
        # farm workers on one host share a single characterization pass
        self._calibrations: dict = {}
        # persistent subset lane stores (their device mirrors live in
        # each BucketStack's scratch)
        self.stack_caches = StackCaches()
        # device name -> the TorchBackend this store's compiles ran on
        # (see backend(); read by stats())
        self._backends: dict = {}
        self.hits = {c: 0 for c in _CATEGORIES}
        self.misses = {c: 0 for c in _CATEGORIES}
        # entries answered by the disk tier (a subset of hits) — the
        # cross-process sharing signal the farm benchmarks report
        self.disk_hits = {c: 0 for c in _CATEGORIES}
        self.evictions = {"lanes": 0}
        self.disk = DiskTier(disk_path, max_bytes=max_disk_bytes,
                             max_entries=max_disk_entries) \
            if disk_path is not None else None
        # deferred disk publication (see deferred_publication)
        self._defer_depth = 0
        self._pending_disk: dict = {}

    # -- deferred (batched) disk publication ---------------------------
    @contextlib.contextmanager
    def deferred_publication(self):
        """Batch disk-tier writes: inside the context, computed entries
        publish to memory immediately but buffer their disk writes;
        the buffer flushes (deduplicated, one atomic rename per entry)
        when the outermost context exits.  ``compile_many`` wraps its
        solve phase in this so a fleet batch publishes once at the
        end — reads are unaffected (memory answers them).  No-op
        without a disk tier."""
        with self._lock:
            self._defer_depth += 1
        try:
            yield self
        finally:
            with self._lock:
                self._defer_depth -= 1
                flush = self._defer_depth == 0
            if flush:
                self.flush_disk()

    def flush_disk(self) -> int:
        """Write buffered disk publications now (atomic per entry) and
        apply the eviction budget.  Returns the number of entries
        published."""
        with self._lock:
            pending, self._pending_disk = self._pending_disk, {}
        if self.disk is None:
            return 0
        for (cat, key), value in pending.items():
            self._disk_put_now(cat, key, value)
        self.disk.evict_to_budget()
        return len(pending)

    def _disk_put(self, cat: str, key: tuple, value) -> None:
        if self.disk is None:
            return
        with self._lock:
            if self._defer_depth > 0:
                self._pending_disk[(cat, key)] = value
                return
        self._disk_put_now(cat, key, value)

    def _disk_put_now(self, cat: str, key: tuple, value) -> None:
        if cat == "master":
            self.disk.put_master(key, value)
        elif cat == "transition":
            self.disk.put_transition(key, value)
        elif cat == "schedule":
            self.disk.put_schedule(key, value)
        elif cat == "pruning":
            self.disk.put_pruning(key, value)
        elif cat == "calibration":
            self.disk.put_calibration(key, value)
        else:                               # pragma: no cover
            raise ValueError(f"unknown disk category {cat!r}")

    def _count(self, cat: str, *, hit: bool, disk: bool = False) -> None:
        with self._lock:
            (self.hits if hit else self.misses)[cat] += 1
            if disk:
                self.disk_hits[cat] += 1

    # -- characterization ---------------------------------------------
    def characterization(self, specs: Sequence[LayerSpec],
                         acc: Edge40nmAccelerator,
                         key: str | None = None):
        """(costs, plan) for the network content — computed once per
        (specs, accelerator) content process-wide.  ``key`` accepts the
        caller's precomputed specs/acc digest (the context computes it
        anyway; repr-ing the full spec tuple twice would dominate the
        warm fast path)."""
        if key is None:
            key = _digest(repr(tuple(specs)), repr(acc))
        hit = self._characterization.get(key)
        if hit is not None:
            self._count("characterization", hit=True)
            return hit
        costs = characterize_network(list(specs), acc)
        plan = plan_banks(costs, acc)
        with self._lock:
            self.misses["characterization"] += 1
            self._characterization.setdefault(key, (costs, plan))
            return self._characterization[key]

    # -- master state tables ------------------------------------------
    def master(self, key: tuple) -> dict | None:
        rec = self._masters.get(key)
        disk = False
        if rec is None and self.disk is not None:
            rec = self.disk.get_master(key)
            if rec is not None:
                disk = True
                with self._lock:
                    self._masters.setdefault(key, rec)
                    rec = self._masters[key]
        self._count("master", hit=rec is not None, disk=disk)
        return rec

    def put_master(self, key: tuple, rec: dict) -> None:
        with self._lock:
            self._masters.setdefault(key, rec)
        self._disk_put("master", key, rec)

    # -- transition matrices ------------------------------------------
    def transition(self, tm_key: str, ka: bytes, kb: bytes,
                   tm, va: np.ndarray, vb: np.ndarray):
        """(T_trans, E_trans, switch) for two voltage tables under the
        transition model ``tm`` — content-keyed, shared across every
        context (and network) on the store."""
        key = (tm_key, ka, kb)
        hit = self._transitions.get(key)
        if hit is not None:
            self._count("transition", hit=True)
            return hit
        if self.disk is not None:
            hit = self.disk.get_transition(key)
            if hit is not None:
                self._count("transition", hit=True, disk=True)
                with self._lock:
                    self._transitions.setdefault(key, hit)
                    return self._transitions[key]
        val = _pairwise_transition(tm, va, vb)
        with self._lock:
            self.misses["transition"] += 1
            self._transitions.setdefault(key, val)
            val = self._transitions[key]
        self._disk_put("transition", key, val)
        return val

    # -- structure-pruning keep maps ----------------------------------
    def pruning(self, key: tuple) -> tuple | None:
        """Cached per-layer keep-index maps for ``key = (content_key,
        gating, rails)``, or None on miss.  The domination scoring
        (:func:`repro_torch.core.pruning.prune_problem`) depends on
        neither deadline nor goal — a hit rebuilds the pruned view by
        slicing alone."""
        maps = self._prunings.get(key)
        disk = False
        if maps is None and self.disk is not None:
            maps = self.disk.get_pruning(key)
            if maps is not None:
                disk = True
                with self._lock:
                    self._prunings.setdefault(key, maps)
                    maps = self._prunings[key]
        self._count("pruning", hit=maps is not None, disk=disk)
        return maps

    def put_pruning(self, key: tuple, maps: tuple) -> None:
        with self._lock:
            self._prunings.setdefault(key, maps)
        self._disk_put("pruning", key, maps)

    # -- characterization calibrations --------------------------------
    def calibration(self, key: str) -> dict | None:
        """Cached harness roofline record for a calibration content key
        (the calibration harness's key), or None on miss — memory →
        disk → miss like every other category."""
        rec = self._calibrations.get(key)
        disk = False
        if rec is None and self.disk is not None:
            rec = self.disk.get_calibration(key)
            if rec is not None:
                disk = True
                with self._lock:
                    self._calibrations.setdefault(key, rec)
                    rec = self._calibrations[key]
        self._count("calibration", hit=rec is not None, disk=disk)
        return rec

    def put_calibration(self, key: str, rec: dict) -> None:
        with self._lock:
            self._calibrations.setdefault(key, rec)
        self._disk_put("calibration", key, rec)

    # -- compiled schedules -------------------------------------------
    def schedule(self, key: tuple) -> PowerSchedule | None | str | \
            "InfeasibleGoal":
        """Cached schedule for ``key``: a fresh deserialized
        :class:`PowerSchedule`, the :data:`_INFEASIBLE` sentinel when
        the point was compiled and found infeasible (legacy form), a
        structured :class:`~repro_torch.core.goals.InfeasibleGoal` when the
        goal API recorded the reason, or None on miss."""
        text = self._schedules.get(key)
        disk = False
        if text is None and self.disk is not None:
            text = self.disk.get_schedule(key)
            if text is not None:
                disk = True
                with self._lock:
                    self._schedules.setdefault(key, text)
                    text = self._schedules[key]
        self._count("schedule", hit=text is not None, disk=disk)
        if text is None:
            return None
        if text == _INFEASIBLE:
            return _INFEASIBLE
        if text.startswith(_INFEASIBLE_GOAL_PREFIX):
            return InfeasibleGoal.from_json(
                text[len(_INFEASIBLE_GOAL_PREFIX):])
        return PowerSchedule.from_json(text)

    def put_schedule(self, key: tuple,
                     sched: "PowerSchedule | InfeasibleGoal | None"
                     ) -> None:
        """Cache a compiled point: a schedule, a structured
        :class:`InfeasibleGoal` (cached with its reason, like the
        legacy sentinel), or None (legacy infeasible)."""
        if sched is None:
            text = _INFEASIBLE
        elif isinstance(sched, InfeasibleGoal):
            text = _INFEASIBLE_GOAL_PREFIX + sched.to_json()
        else:
            text = sched.to_json()
        with self._lock:
            self._schedules[key] = text
        self._disk_put("schedule", key, text)

    # -- bookkeeping ---------------------------------------------------
    def backend(self, device=None):
        """The process-wide :class:`~repro_torch.core.backend.TorchBackend`
        of ``device`` (``None`` → ``"cuda"``, as ``get_backend``),
        recorded as one this store's compiles run on so :meth:`stats`
        reports its transfer counters."""
        bk = get_backend(device)
        with self._lock:
            self._backends.setdefault(str(bk.device), bk)
        return bk

    def stats(self) -> dict:
        with self._lock:
            hits = dict(self.hits)
            misses = dict(self.misses)
            hits["lanes"] += self.stack_caches.lane_hits
            misses["lanes"] += self.stack_caches.lane_misses
            out = {
                "characterizations": len(self._characterization),
                "masters": len(self._masters),
                "transitions": len(self._transitions),
                "schedules": len(self._schedules),
                "prunings": len(self._prunings),
                "calibrations": len(self._calibrations),
                "resident_lanes": self.stack_caches.n_lanes(),
                "hits": hits,
                "misses": misses,
                "disk_hits": dict(self.disk_hits),
                "evictions": dict(self.evictions),
            }
            backends = dict(self._backends)
        out["disk"] = self.disk.stats() if self.disk is not None \
            else None
        # device-lane transfer counters of every backend this store's
        # compiles ran on, by device — h2d uploads/bytes stay flat
        # across warm rounds while lanes are device-resident
        out["backend_io"] = {dev: bk.io_counts()
                             for dev, bk in sorted(backends.items())}
        return out

    def clear(self, *, schedules: bool = True, stacks: bool = True,
              tables: bool = True) -> None:
        """Drop cached *in-memory* artifacts (selectively).  ``tables``
        covers characterization, master tables, and transition
        matrices; ``stacks`` the subset lane stores and with them their
        device mirrors.  The disk tier is untouched — cleared entries
        stream back in lazily on next use.  Not to be called while a
        compile on this store is in flight."""
        with self._lock:
            if schedules:
                self._schedules.clear()
            if stacks:
                self.stack_caches.clear()
            if tables:
                self._characterization.clear()
                self._masters.clear()
                self._transitions.clear()
                self._prunings.clear()
                self._calibrations.clear()

    def trim_stacks(self, max_lanes: int) -> bool:
        """Reset the subset lane stores — and free their device mirrors
        — once they exceed ``max_lanes`` resident lanes
        (correctness-neutral: evicted lanes are simply rebuilt on next
        use).  Returns True when a trim happened."""
        n = self.stack_caches.n_lanes()
        if n <= max_lanes:
            return False
        self.stack_caches.clear()
        with self._lock:
            self.evictions["lanes"] += n
        return True

    # -- disk persistence ---------------------------------------------
    def save(self, path) -> None:
        """Persist transition matrices, master tables, pruning keep
        maps, and the schedule cache to ``path`` as one monolithic
        ``.npz`` (arrays + JSON manifest, schema 1 — the restart
        snapshot format; the per-entry disk tier is schema 2 and needs
        no explicit save: every entry already published through)."""
        with self._lock:
            transitions = dict(self._transitions)
            masters = dict(self._masters)
            schedules = dict(self._schedules)
            prunings = dict(self._prunings)
        arrays: dict[str, np.ndarray] = {}
        manifest: dict = {"version": 1, "transitions": [],
                          "masters": [], "schedules": [],
                          "prunings": []}
        for i, ((tmk, ka, kb), (t, e, sw)) in \
                enumerate(transitions.items()):
            manifest["transitions"].append(
                {"tm": tmk, "a": ka.hex(), "b": kb.hex()})
            arrays[f"tr{i}_t"] = t
            arrays[f"tr{i}_e"] = e
            arrays[f"tr{i}_s"] = sw
        for j, ((sak, gating), rec) in enumerate(masters.items()):
            manifest["masters"].append(
                {"key": sak, "gating": bool(gating),
                 "layers": len(rec["volts"])})
            for i, (v, t, e) in enumerate(zip(rec["volts"], rec["t_op"],
                                              rec["e_op"])):
                arrays[f"ma{j}_v{i}"] = v
                arrays[f"ma{j}_t{i}"] = t
                arrays[f"ma{j}_e{i}"] = e
        manifest["schedules"] = [
            {"key": list(k), "json": text}
            for k, text in schedules.items()]
        # pruning keep maps are small int lists — JSON floats (the rail
        # values) round-trip exactly, so keys survive the manifest
        manifest["prunings"] = [
            {"content": ck, "gating": bool(g), "rails": list(rails),
             "maps": [list(m) for m in maps]}
            for (ck, g, rails), maps in prunings.items()]
        arrays["manifest"] = np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8)
        # crash-safe: stream into a sibling temp file, then atomically
        # replace — a killed save never leaves a truncated snapshot
        # where the next service start expects a valid one
        path = pathlib.Path(path)
        if path.suffix != ".npz":       # np.savez appends it anyway
            path = path.with_name(path.name + ".npz")
        tmp = path.with_name(path.name + ".tmp.npz")
        try:
            np.savez_compressed(tmp, **arrays)
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)

    def load(self, path) -> "ArtifactStore":
        """Merge a :meth:`save` snapshot into this store (existing
        entries win — loaded content is by construction identical for
        equal keys).  On a disk-backed store, every loaded entry is
        also republished to the per-entry tier — the monolithic
        schema-1 snapshot's migration path into the schema-2 layout
        (batched: one flush at the end).  Returns ``self`` for
        chaining."""
        with np.load(path) as data:
            manifest = json.loads(bytes(data["manifest"]).decode())
            if manifest.get("version") != 1:
                raise ValueError(
                    f"unknown artifact snapshot version "
                    f"{manifest.get('version')!r}")
            with self.deferred_publication():
                with self._lock:
                    for i, ent in enumerate(manifest["transitions"]):
                        key = (ent["tm"], bytes.fromhex(ent["a"]),
                               bytes.fromhex(ent["b"]))
                        self._transitions.setdefault(
                            key, (data[f"tr{i}_t"], data[f"tr{i}_e"],
                                  data[f"tr{i}_s"]))
                        self._disk_put("transition", key,
                                       self._transitions[key])
                    for j, ent in enumerate(manifest["masters"]):
                        volts = [data[f"ma{j}_v{i}"]
                                 for i in range(ent["layers"])]
                        rec = {
                            "volts": volts,
                            "t_op": [data[f"ma{j}_t{i}"]
                                     for i in range(ent["layers"])],
                            "e_op": [data[f"ma{j}_e{i}"]
                                     for i in range(ent["layers"])],
                            "vkey": [v.tobytes() for v in volts],
                        }
                        key = (ent["key"], ent["gating"])
                        self._masters.setdefault(key, rec)
                        self._disk_put("master", key, self._masters[key])
                    for ent in manifest["schedules"]:
                        key = _migrate_schedule_key(tuple(ent["key"]))
                        self._schedules.setdefault(key, ent["json"])
                        self._disk_put("schedule", key,
                                       self._schedules[key])
                    for ent in manifest.get("prunings", []):
                        key = (ent["content"], ent["gating"],
                               tuple(ent["rails"]))
                        self._prunings.setdefault(
                            key, tuple(tuple(m) for m in ent["maps"]))
                        self._disk_put("pruning", key,
                                       self._prunings[key])
        return self
