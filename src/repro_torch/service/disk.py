"""Content-addressable on-disk artifact tier (the compile farm's
shared store).

One directory holds every persisted artifact category as *per-entry
immutable files named by a content digest of their key*:

    <root>/STORE_META.json            # {"schema": 2}
    <root>/masters/<digest>.npz       # per-layer master state tables
    <root>/transitions/<digest>.npz   # pairwise transition matrices
    <root>/schedules/<digest>.json    # compiled PowerSchedule JSON
    <root>/prunings/<digest>.json     # structure-pruning keep maps
    <root>/calibrations/<digest>.json # characterization roofline tables

Design rules (Levanter-checkpoint style, sized down to cache entries):

  - **atomic publication** — every write streams into a same-directory
    temp file (``<digest>.<pid>.<seq>.tmp``) and is published with one
    ``os.replace``; readers only ever see a complete entry or no entry.
    A writer killed mid-publish leaves an orphan ``*.tmp`` that is
    *ignored* by every lookup and swept once it goes stale, so a fresh
    store always opens cleanly.
  - **concurrent writers** — entries are content-addressed: two
    processes racing on the same digest publish byte-identical payloads,
    so last-writer-wins is harmless.  Different digests never collide.
  - **immutability** — a published entry is never rewritten in place
    (reads only bump its mtime for LRU recency).
  - **LRU / size-budget eviction** — ``max_bytes`` / ``max_entries``
    bound the tier; eviction drops oldest-mtime entries first and is
    correctness-neutral (an evicted entry is recomputed and
    re-published on next use).  Concurrent evictors may race on the
    same victim; the loser's unlink is a no-op.
  - **schema versioning** — ``STORE_META.json`` pins the on-disk
    schema (currently 2 — the monolithic npz+JSON snapshot of
    :meth:`ArtifactStore.save` is schema 1); every entry payload also
    carries its schema.  Unknown *newer* schemas refuse loudly instead
    of misreading; pre-PR schema-1 snapshots migrate through
    :meth:`ArtifactStore.load`, which republishes their entries here
    as per-entry files.

The tier stores *serialized payloads* only; all key semantics (what is
content-addressed by what) live in
:class:`~repro_torch.service.store.ArtifactStore`, which layers this under
its in-memory dicts as ``memory -> disk -> miss``.
"""

from __future__ import annotations

import io
import itertools
import json
import os
import pathlib
import time
from hashlib import blake2b

import numpy as np

from repro_torch.analysis.lockcheck import make_lock

DISK_SCHEMA = 2
#: schema versions this build can read (1 is the monolithic snapshot
#: format and never appears as a tier directory, but entry payloads
#: migrated from it keep their own schema field honest)
READABLE_SCHEMAS = (1, 2)
CATEGORIES = ("masters", "transitions", "schedules", "prunings",
              "calibrations")
_META_NAME = "STORE_META.json"
#: orphan temp files older than this are removed at open (a *fresh*
#: orphan may belong to a live writer in another process — deleting it
#: would fail that writer's publish, so only stale ones are swept)
_STALE_TMP_S = 3600.0


def entry_digest(*parts) -> str:
    """Deterministic digest of heterogeneous key parts.  ``bytes``
    parts hash raw; everything else hashes its ``repr`` (frozen
    dataclasses and floats round-trip exactly).  Parts are
    length-prefixed so no two distinct part tuples can collide by
    concatenation."""
    h = blake2b(digest_size=16)
    for part in parts:
        b = part if isinstance(part, bytes) else repr(part).encode()
        h.update(f"{len(b)}:".encode())
        h.update(b)
    return h.hexdigest()


def _atomic_write(final: pathlib.Path, data: bytes,
                  seq=itertools.count()) -> None:
    """Publish ``data`` at ``final`` via temp-file + ``os.replace``.
    The temp name carries the pid so concurrent writers (and a crashed
    writer's orphan) never collide with a live publication."""
    tmp = final.with_name(f"{final.name}.{os.getpid()}.{next(seq)}.tmp")
    try:
        tmp.write_bytes(data)
        os.replace(tmp, final)
    finally:
        tmp.unlink(missing_ok=True)


class DiskTier:
    """The on-disk tier: digest-named immutable entry files under one
    root directory (see module docstring).  Thread-safe; safe to open
    from many processes at once."""

    def __init__(self, path, *, max_bytes: int | None = None,
                 max_entries: int | None = None):
        self.root = pathlib.Path(path)
        self.max_bytes = max_bytes
        self.max_entries = max_entries
        self._lock = make_lock("disk._lock")
        self._puts_since_evict = 0
        self.evictions = {c: 0 for c in CATEGORIES}
        self.orphans_swept = 0
        self.root.mkdir(parents=True, exist_ok=True)
        for cat in CATEGORIES:
            (self.root / cat).mkdir(exist_ok=True)
        self._check_meta()
        self._sweep_stale_tmps()

    def _check_meta(self) -> None:
        meta_path = self.root / _META_NAME
        if meta_path.exists():
            meta = json.loads(meta_path.read_text())
            schema = meta.get("schema")
            if schema not in READABLE_SCHEMAS:
                raise ValueError(
                    f"artifact store at {self.root} has schema "
                    f"{schema!r}; this build reads "
                    f"{READABLE_SCHEMAS} — refusing to misread a newer "
                    f"layout")
            self.schema = schema
        else:
            self.schema = DISK_SCHEMA
            # racing creators publish identical bytes — harmless
            _atomic_write(meta_path, json.dumps(
                {"schema": DISK_SCHEMA,
                 "categories": list(CATEGORIES)}).encode())

    def _sweep_stale_tmps(self) -> None:
        """Remove orphan temp files left by crashed writers.  Fresh
        temps are left alone (their writer may still be alive); lookups
        never see temps either way — entries are only ever the
        ``os.replace`` targets."""
        # epoch clock on purpose: compared against st_mtime, which is
        # epoch-based too
        cutoff = time.time() - _STALE_TMP_S  # pfdnn: allow(wall-clock)
        for cat in CATEGORIES:
            for tmp in (self.root / cat).glob("*.tmp"):
                try:
                    if tmp.stat().st_mtime < cutoff:
                        tmp.unlink()
                        self.orphans_swept += 1
                except OSError:
                    pass        # another process raced us — fine

    # -- generic entry I/O --------------------------------------------
    def _path(self, category: str, digest: str, suffix: str
              ) -> pathlib.Path:
        return self.root / category / f"{digest}{suffix}"

    def _read(self, path: pathlib.Path) -> bytes | None:
        try:
            data = path.read_bytes()
        except FileNotFoundError:
            return None
        try:                    # LRU recency bump — best effort
            os.utime(path)
        except OSError:
            pass
        return data

    def _publish(self, category: str, digest: str, suffix: str,
                 data: bytes) -> None:
        _atomic_write(self._path(category, digest, suffix), data)
        with self._lock:
            self._puts_since_evict += 1
            due = self._puts_since_evict >= 32
            if due:
                self._puts_since_evict = 0
        if due:
            self.evict_to_budget()

    def _entries(self) -> list[tuple[str, pathlib.Path, float, int]]:
        """(category, path, mtime, size) of every published entry —
        temp files excluded by construction."""
        out = []
        for cat in CATEGORIES:
            for p in (self.root / cat).iterdir():
                if p.name.endswith(".tmp"):
                    continue
                try:
                    st = p.stat()
                except FileNotFoundError:
                    continue    # concurrently evicted
                out.append((cat, p, st.st_mtime, st.st_size))
        return out

    def evict_to_budget(self) -> int:
        """Drop oldest-mtime entries until both budgets hold.  Returns
        the number of entries evicted (0 when no budget is set)."""
        if self.max_bytes is None and self.max_entries is None:
            return 0
        entries = sorted(self._entries(), key=lambda e: e[2])
        total_bytes = sum(e[3] for e in entries)
        n = len(entries)
        evicted = 0
        for cat, path, _, size in entries:
            over_bytes = self.max_bytes is not None \
                and total_bytes > self.max_bytes
            over_entries = self.max_entries is not None \
                and n > self.max_entries
            if not (over_bytes or over_entries):
                break
            try:
                path.unlink()
            except FileNotFoundError:
                pass            # concurrent evictor won the race
            total_bytes -= size
            n -= 1
            evicted += 1
            with self._lock:
                self.evictions[cat] += 1
        return evicted

    def stats(self) -> dict:
        entries = self._entries()
        per_cat = {c: 0 for c in CATEGORIES}
        for cat, _, _, _ in entries:
            per_cat[cat] += 1
        with self._lock:
            evictions = dict(self.evictions)
        return {"path": str(self.root), "schema": self.schema,
                "entries": per_cat,
                "bytes": sum(e[3] for e in entries),
                "evictions": evictions,
                "orphans_swept": self.orphans_swept}

    # -- masters -------------------------------------------------------
    # key: (specs_acc_key: str, gating: bool)
    # rec: {"volts": [S_i,3] arrays, "t_op": [S_i] arrays,
    #       "e_op": [S_i] arrays, "vkey": derived}
    @staticmethod
    def master_digest(key: tuple) -> str:
        return entry_digest("master", key[0], bool(key[1]))

    def put_master(self, key: tuple, rec: dict) -> None:
        buf = io.BytesIO()
        arrays = {}
        for i, (v, t, e) in enumerate(zip(rec["volts"], rec["t_op"],
                                          rec["e_op"])):
            arrays[f"v{i}"] = v
            arrays[f"t{i}"] = t
            arrays[f"e{i}"] = e
        arrays["meta"] = np.frombuffer(json.dumps(
            {"schema": DISK_SCHEMA, "category": "masters",
             "key": key[0], "gating": bool(key[1]),
             "layers": len(rec["volts"])}).encode(), dtype=np.uint8)
        np.savez_compressed(buf, **arrays)
        self._publish("masters", self.master_digest(key), ".npz",
                      buf.getvalue())

    def get_master(self, key: tuple) -> dict | None:
        data = self._read(self._path("masters", self.master_digest(key),
                                     ".npz"))
        if data is None:
            return None
        with np.load(io.BytesIO(data)) as npz:
            meta = json.loads(bytes(npz["meta"]).decode())
            _check_entry_schema(meta)
            volts = [npz[f"v{i}"] for i in range(meta["layers"])]
            return {"volts": volts,
                    "t_op": [npz[f"t{i}"] for i in range(meta["layers"])],
                    "e_op": [npz[f"e{i}"] for i in range(meta["layers"])],
                    "vkey": [v.tobytes() for v in volts]}

    # -- transitions ---------------------------------------------------
    # key: (tm_key: str, ka: bytes, kb: bytes); value: (T, E, switch)
    @staticmethod
    def transition_digest(key: tuple) -> str:
        return entry_digest("transition", key[0], key[1], key[2])

    def put_transition(self, key: tuple, val: tuple) -> None:
        t, e, sw = val
        buf = io.BytesIO()
        np.savez_compressed(
            buf, t=t, e=e, s=sw,
            meta=np.frombuffer(json.dumps(
                {"schema": DISK_SCHEMA, "category": "transitions",
                 "tm": key[0], "a": key[1].hex(),
                 "b": key[2].hex()}).encode(), dtype=np.uint8))
        self._publish("transitions", self.transition_digest(key), ".npz",
                      buf.getvalue())

    def get_transition(self, key: tuple) -> tuple | None:
        data = self._read(self._path(
            "transitions", self.transition_digest(key), ".npz"))
        if data is None:
            return None
        with np.load(io.BytesIO(data)) as npz:
            _check_entry_schema(json.loads(bytes(npz["meta"]).decode()))
            return (npz["t"], npz["e"], npz["s"])

    # -- schedules -----------------------------------------------------
    # key: (content_key, goal_key, cfg_key) — all str; value: the
    # serialized schedule text (PowerSchedule JSON or a sentinel, see
    # ArtifactStore)
    @staticmethod
    def schedule_digest(key: tuple) -> str:
        return entry_digest("schedule", *key)

    def put_schedule(self, key: tuple, text: str) -> None:
        self._publish("schedules", self.schedule_digest(key), ".json",
                      json.dumps({"schema": DISK_SCHEMA, "key": list(key),
                                  "payload": text}).encode())

    def get_schedule(self, key: tuple) -> str | None:
        data = self._read(self._path(
            "schedules", self.schedule_digest(key), ".json"))
        if data is None:
            return None
        ent = json.loads(data.decode())
        _check_entry_schema(ent)
        return ent["payload"]

    # -- prunings ------------------------------------------------------
    # key: (content_key: str, gating: bool, rails: tuple[float, ...]);
    # value: per-layer keep-index tuples
    @staticmethod
    def pruning_digest(key: tuple) -> str:
        return entry_digest("pruning", key[0], bool(key[1]),
                            tuple(key[2]))

    def put_pruning(self, key: tuple, maps: tuple) -> None:
        self._publish(
            "prunings", self.pruning_digest(key), ".json",
            json.dumps({"schema": DISK_SCHEMA,
                        "content": key[0], "gating": bool(key[1]),
                        "rails": list(key[2]),
                        "maps": [list(m) for m in maps]}).encode())

    def get_pruning(self, key: tuple) -> tuple | None:
        data = self._read(self._path(
            "prunings", self.pruning_digest(key), ".json"))
        if data is None:
            return None
        ent = json.loads(data.decode())
        _check_entry_schema(ent)
        return tuple(tuple(int(i) for i in m) for m in ent["maps"])

    # -- calibrations --------------------------------------------------
    # key: calibration content key (host fingerprint × accelerator ×
    # harness config digest, see repro_torch.calib.harness.calibration_key);
    # value: the RooflineTable record (JSON dict) —
    # how farm workers on one host share a single characterization pass
    @staticmethod
    def calibration_digest(key: str) -> str:
        return entry_digest("calibration", key)

    def put_calibration(self, key: str, rec: dict) -> None:
        self._publish(
            "calibrations", self.calibration_digest(key), ".json",
            json.dumps({"schema": DISK_SCHEMA, "key": key,
                        "payload": rec}).encode())

    def get_calibration(self, key: str) -> dict | None:
        data = self._read(self._path(
            "calibrations", self.calibration_digest(key), ".json"))
        if data is None:
            return None
        ent = json.loads(data.decode())
        _check_entry_schema(ent)
        return ent["payload"]


def _check_entry_schema(meta: dict) -> None:
    if meta.get("schema") not in READABLE_SCHEMAS:
        raise ValueError(
            f"artifact entry has schema {meta.get('schema')!r}; this "
            f"build reads {READABLE_SCHEMAS}")
