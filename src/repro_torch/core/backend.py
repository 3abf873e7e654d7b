"""Array backend of the solver's hot paths: padded state tensors, the
persistent per-bucket lane stores, and :class:`TorchBackend`, which
runs the subset-stacked sweep's three kernels
(:mod:`repro_torch.kernels.dp_sweep`) over a device mirror of each
lane store.

**Where the data lives.**  State tables stay numpy float64 on the
host: characterization, the master state tables, the transition
matrices, :func:`build_padded` and the :class:`BucketStack` lane
stores are built with numpy exactly as the reference builds them, so
they are elementwise equal to it.  Only the lane stores' mirrors go to
the device, as float64 / bool / int64 torch tensors, one mirror per
:class:`BucketStack` (kept in ``store.scratch``).  A lane is uploaded
once, when first admitted; newly admitted lanes go up as one block per
tensor; the mirror's capacity has a floor of 64 lanes and grows by
copying on the device.  A sweep round then moves only its weight rows
and lane indices to the device and only paths and gathered cost
components back: each lane call stages its host operands as ONE pinned
packet (one non-blocking copy up) and brings its result back in ONE
non-blocking copy whose end a CUDA event marks, and an evaluation pass
gathers the paths of every bucket in one launch
(:meth:`TorchBackend.path_costs_grouped`).

**The device is explicit.**  ``TorchBackend("cuda")`` raises when no
card is present; it never carries on silently on the CPU.  On
``TorchBackend("cpu")`` the mirror holds CPU tensors and every kernel
wrapper takes its plain PyTorch version; on CUDA the lane calls always
launch the kernels.  Lane calls with ``defer=True`` return a
:class:`PendingResult` whose :meth:`~PendingResult.get` waits for the
result's copy to the host, so the round scheduler launches a whole
round before its first barrier.

Padding convention (:class:`PaddedArrays`): op costs are padded with 0
and carry a ``valid`` mask; kernels mask *after* applying the λ
weights, so negative idle-priced μ never produces ``inf · μ`` NaNs.
Valid states occupy the index prefix of every padded axis, which keeps
first-occurrence ``argmin`` ties identical between padded and ragged
kernels.  The k-best kernels break cost ties by the stable ``(value,
flat index)`` order.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Sequence

import numpy as np
import torch

from repro_torch.analysis.lockcheck import make_lock
from repro_torch.kernels.dp_sweep import (
    dp_multi_stacked,
    kbest_multi_stacked,
    path_components_grouped,
    split_components,
)


@dataclasses.dataclass(frozen=True)
class PaddedArrays:
    """Dense per-layer tensors of a :class:`ScheduleProblem`.

    ``S`` is the padded state count (power-of-two bucket ≥ the widest
    layer); valid states sit at indices ``0..sizes[i]-1``.
    """

    t_op: np.ndarray        # [L, S] float64, padded with 0
    e_op: np.ndarray        # [L, S] float64, padded with 0
    valid: np.ndarray       # [L, S] bool
    t_trans: np.ndarray     # [L-1, S, S] float64, padded with 0
    e_trans: np.ndarray     # [L-1, S, S] float64, padded with 0
    switch: np.ndarray      # [L-1, S, S] int64 rail-switch flags
    sizes: tuple[int, ...]  # true per-layer state counts
    # per-instance scratch for device copies (the arrays above are
    # immutable, so cached copies never go stale)
    dev_cache: dict = dataclasses.field(default_factory=dict,
                                        compare=False, repr=False)

    @property
    def n_layers(self) -> int:
        return self.t_op.shape[0]

    @property
    def s_pad(self) -> int:
        return self.t_op.shape[1]


def pad_bucket(n: int) -> int:
    """Round a state count up to its bucket (power of two, minimum 4)
    so subsets of one master table share lane stores.  Above 128
    states, round to a multiple of 128."""
    if n > 128:
        return ((n + 127) // 128) * 128
    b = 4
    while b < n:
        b *= 2
    return b


def build_padded(problem) -> PaddedArrays:
    """Materialize a problem's padded tensors (see module docstring).

    Pad slots of the op tensors are 0 with ``valid`` False; pad slots
    of the transition tensors carry no contract at all — every kernel
    masks them through the inf node costs, so the master-backed fast
    path below may leave arbitrary (finite) master values there.
    """
    L = problem.n_layers
    sizes = problem.sizes
    S = pad_bucket(max(sizes))
    t_op = np.zeros((L, S))
    e_op = np.zeros((L, S))
    valid = np.zeros((L, S), dtype=bool)
    for i in range(L):
        t, e = problem.op_arrays(i)
        t_op[i, :sizes[i]] = t
        e_op[i, :sizes[i]] = e
        valid[i, :sizes[i]] = True
    if L > 1 and problem._trans_src is not None \
            and not problem._trans_cache:
        srcs = [problem._trans_src(i) for i in range(L - 1)]
        if all(s[0] is srcs[0][0] for s in srcs[1:]):
            # every pair shares ONE master matrix (the common case):
            # gather all L-1 padded slabs in three fancy-index shots.
            # Pad slots replicate master row/col 0 — finite, never read.
            mt, me, msw = srcs[0]
            rows = np.zeros((L - 1, S), dtype=np.int64)
            cols = np.zeros((L - 1, S), dtype=np.int64)
            for i in range(L - 1):
                rows[i, :sizes[i]] = problem._trans_sel[i]
                cols[i, :sizes[i + 1]] = problem._trans_sel[i + 1]
            ri = rows[:, :, None]
            ci = cols[:, None, :]
            return PaddedArrays(
                t_op=t_op, e_op=e_op, valid=valid,
                t_trans=mt[ri, ci], e_trans=me[ri, ci],
                switch=msw[ri, ci], sizes=sizes)
    t_trans = np.zeros((max(L - 1, 0), S, S))
    e_trans = np.zeros((max(L - 1, 0), S, S))
    switch = np.zeros((max(L - 1, 0), S, S), dtype=np.int64)
    for i in range(L - 1):
        tt, et = problem.transition_arrays(i)
        sw = problem.switch_arrays(i)
        t_trans[i, :sizes[i], :sizes[i + 1]] = tt
        e_trans[i, :sizes[i], :sizes[i + 1]] = et
        switch[i, :sizes[i], :sizes[i + 1]] = sw
    return PaddedArrays(t_op=t_op, e_op=e_op, valid=valid,
                        t_trans=t_trans, e_trans=e_trans, switch=switch,
                        sizes=sizes)


@dataclasses.dataclass(frozen=True)
class StackedArrays:
    """Padded tensors of B same-bucket problems stacked along a leading
    *lane* axis (a :class:`BucketStack` view)."""

    t_op: np.ndarray        # [B, L, S]
    e_op: np.ndarray        # [B, L, S]
    valid: np.ndarray       # [B, L, S] bool
    t_trans: np.ndarray     # [B, L-1, S, S]
    e_trans: np.ndarray     # [B, L-1, S, S]
    switch: np.ndarray      # [B, L-1, S, S] int64
    max_sizes: tuple[int, ...]   # per-layer max valid count over lanes

    @property
    def n_lanes(self) -> int:
        return self.t_op.shape[0]

    @property
    def n_layers(self) -> int:
        return self.t_op.shape[1]

    @property
    def s_pad(self) -> int:
        return self.t_op.shape[2]


def bucket_key(padded: PaddedArrays) -> tuple[int, int]:
    """The shape class a problem's padded tensors belong to — problems
    with equal keys share one lane store."""
    return (padded.n_layers, padded.s_pad)


# ------------------------------------------------- persistent lane stores

class BucketStack:
    """Persistent lane store of one padded bucket: every problem
    admitted to the bucket copies its padded tensors in ONCE, under a
    caller-chosen *lane key*; kernel calls then address lanes by index.

    Content-derived lane keys make the store reusable across compiles:
    a later compile of the same subset content hits the resident lane
    and skips the copy.  Admission and view construction are
    lock-guarded; the returned views are immutable snapshots (growth
    allocates fresh arrays), so reads through them stay lock-free.
    """

    def __init__(self, n_layers: int, s_pad: int):
        self.n = 0
        self._cap = 8
        self.slot: dict = {}
        self._lock = make_lock("backend.bucket._lock")
        # backend-owned per-bucket scratch (the device lane mirror):
        # dies with the stack, so dropping a stack frees its device
        # buffers too
        self.scratch: dict = {}
        L, S = n_layers, s_pad
        self._t_op = np.zeros((self._cap, L, S))
        self._e_op = np.zeros((self._cap, L, S))
        self._valid = np.zeros((self._cap, L, S), dtype=bool)
        self._t_trans = np.zeros((self._cap, max(L - 1, 0), S, S))
        self._e_trans = np.zeros((self._cap, max(L - 1, 0), S, S))
        self._switch = np.zeros((self._cap, max(L - 1, 0), S, S),
                                dtype=np.int64)
        self._sizes = np.zeros((self._cap, L), dtype=np.int64)
        self._view: StackedArrays | None = None

    def _grow(self) -> None:
        self._cap *= 2
        for name in ("_t_op", "_e_op", "_valid", "_t_trans",
                     "_e_trans", "_switch", "_sizes"):
            old = getattr(self, name)
            new = np.zeros((self._cap,) + old.shape[1:], dtype=old.dtype)
            new[:old.shape[0]] = old
            setattr(self, name, new)

    def add(self, key, padded: PaddedArrays) -> int:
        """Admit ``padded`` under ``key`` (idempotent: an already
        resident key returns its lane without copying)."""
        with self._lock:
            if key in self.slot:
                return self.slot[key]
            if self.n == self._cap:
                self._grow()
            b = self.n
            self._t_op[b] = padded.t_op
            self._e_op[b] = padded.e_op
            self._valid[b] = padded.valid
            self._t_trans[b] = padded.t_trans
            self._e_trans[b] = padded.e_trans
            self._switch[b] = padded.switch
            self._sizes[b] = padded.sizes
            self.slot[key] = b
            self.n += 1
            self._view = None
            return b

    def padded(self, key) -> PaddedArrays | None:
        """Zero-copy :class:`PaddedArrays` view of a resident lane, or
        None when ``key`` was never admitted (warm compiles use this to
        skip ``build_padded``)."""
        with self._lock:
            b = self.slot.get(key)
            if b is None:
                return None
            return PaddedArrays(
                t_op=self._t_op[b], e_op=self._e_op[b],
                valid=self._valid[b], t_trans=self._t_trans[b],
                e_trans=self._e_trans[b], switch=self._switch[b],
                sizes=tuple(int(s) for s in self._sizes[b]))

    def view(self) -> StackedArrays:
        # lock-free fast path: _view is only ever replaced whole
        view = self._view
        if view is not None:
            return view
        with self._lock:
            if self._view is None:
                n = self.n
                self._view = StackedArrays(
                    t_op=self._t_op[:n], e_op=self._e_op[:n],
                    valid=self._valid[:n], t_trans=self._t_trans[:n],
                    e_trans=self._e_trans[:n], switch=self._switch[:n],
                    max_sizes=tuple(int(m)
                                    for m in self._sizes[:n].max(axis=0)))
            return self._view


class StackCaches:
    """The round scheduler's persistent per-bucket-signature
    :class:`BucketStack` lane stores (signature = ``(levels, n_layers,
    s_pad)`` for a sweep job).  A fresh instance per sweep is the
    default; a process-wide owner (the fleet service's
    :class:`~repro_torch.service.ArtifactStore`) keeps one alive across
    compilations.  Reuse only ever turns lane copies into cache hits
    (lane contents are content-addressed), never changes a kernel
    result.  Each store's device mirror lives in its ``scratch``, so
    :meth:`clear` frees the device buffers with the host lanes."""

    def __init__(self):
        self.buckets: dict[tuple, BucketStack] = {}
        self._lock = make_lock("backend.stacks._lock")
        # warm-lane lookup counters (the "lanes" category of
        # ArtifactStore.stats): a hit means a task reused a resident
        # lane's padded tensors and skipped build_padded entirely
        self.lane_hits = 0
        self.lane_misses = 0

    def warm_padded(self, bucket_sig: tuple, lane_key) -> object | None:
        """Resident-lane lookup for a task being admitted: the
        zero-copy :class:`PaddedArrays` of ``lane_key`` in the
        ``bucket_sig`` store, or None — counted as a "lanes" hit or
        miss either way."""
        bs = self.buckets.get(bucket_sig)
        warm = bs.padded(lane_key) if bs is not None else None
        with self._lock:
            if warm is None:
                self.lane_misses += 1
            else:
                self.lane_hits += 1
        return warm

    def bucket(self, sig: tuple, n_layers: int, s_pad: int) -> BucketStack:
        bs = self.buckets.get(sig)          # lock-free fast path
        if bs is not None:
            return bs
        with self._lock:
            if sig not in self.buckets:
                self.buckets[sig] = BucketStack(n_layers, s_pad)
            return self.buckets[sig]

    def n_lanes(self) -> int:
        with self._lock:
            return sum(b.n for b in list(self.buckets.values()))

    def clear(self) -> None:
        with self._lock:
            self.buckets.clear()


class PendingResult:
    """Handle to an in-flight backend result.  The kernel and its copy
    to the host were already issued when the handle was made; :meth:`get`
    waits for them and memoizes the host value, and THAT is the
    blocking round barrier."""

    __slots__ = ("_fn", "_value", "_done")

    def __init__(self, fn):
        self._fn = fn
        self._done = False
        self._value = None

    @classmethod
    def ready(cls, value) -> "PendingResult":
        """An already-materialized result."""
        p = cls(None)
        p._done = True
        p._value = value
        return p

    def get(self):
        if not self._done:
            self._value = self._fn()
            self._done = True
            self._fn = None
        return self._value


class _LaneMirror:
    """Device twin of a :class:`BucketStack`'s lane tensors (built and
    synced by :meth:`TorchBackend._mirror`)."""

    __slots__ = ("arrays", "cap", "n")

    def __init__(self):
        # (t_op, e_op, valid, t_trans, e_trans, switch) tensors at the
        # mirrored capacity; rows [0, n) are resident lanes
        self.arrays: tuple | None = None
        self.cap = 0
        self.n = 0


# ------------------------------------------------------ host evaluator

# above this state count the dense padded tensors stop paying for
# themselves in host evaluation
_PAD_EVAL_MAX_STATES = 256
# below this many paths, building padded tensors just for evaluation
# isn't worth it either
_PAD_EVAL_MIN_PATHS = 5


def _sum_stacked(stacked, lanes: np.ndarray, paths: np.ndarray
                 ) -> dict[str, np.ndarray]:
    """Summed cost components of P paths on lanes of a host stack."""
    L = stacked.t_op.shape[1]
    ln = np.asarray(lanes, dtype=np.int64)[:, None]
    li = np.arange(L)[None, :]
    t_op = stacked.t_op[ln, li, paths].sum(axis=1)
    e_op = stacked.e_op[ln, li, paths].sum(axis=1)
    if L == 1:
        zero = np.zeros_like(t_op)
        return {"t_op": t_op, "e_op": e_op, "t_trans": zero,
                "e_trans": zero.copy(),
                "n_switch": np.zeros(t_op.shape, dtype=np.int64)}
    lt = np.arange(L - 1)[None, :]
    a, b = paths[:, :-1], paths[:, 1:]
    return {"t_op": t_op, "e_op": e_op,
            "t_trans": stacked.t_trans[ln, lt, a, b].sum(axis=1),
            "e_trans": stacked.e_trans[ln, lt, a, b].sum(axis=1),
            "n_switch": stacked.switch[ln, lt, a, b].sum(axis=1)}


def host_path_costs(problem, paths: np.ndarray) -> dict[str, np.ndarray]:
    """Summed per-path cost components on the host (the evaluator of
    :meth:`ScheduleProblem.evaluate_paths` when no backend is named).

    Uses the dense padded tensors when the problem already has them, or
    when the batch is large enough to amortize building them; everything
    else takes the per-layer ragged gather loop.  The two differ only in
    summation order, exactly as in the reference."""
    if problem._padded is not None or (
            paths.shape[0] >= _PAD_EVAL_MIN_PATHS
            and max(problem.sizes) <= _PAD_EVAL_MAX_STATES):
        padded = problem.padded_arrays()
        return _sum_stacked(_single_lane(padded),
                            np.zeros(len(paths), np.int64), paths)
    p = paths
    n = p.shape[0]
    t_op = np.zeros(n)
    e_op = np.zeros(n)
    t_trans = np.zeros(n)
    e_trans = np.zeros(n)
    n_switch = np.zeros(n, dtype=np.int64)
    for i in range(problem.n_layers):
        idx = p[:, i]
        ti, ei = problem.op_arrays(i)
        t_op += ti[idx]
        e_op += ei[idx]
        if i + 1 < problem.n_layers:
            tt, et, sw = problem.trans_elems(i, idx, p[:, i + 1])
            t_trans += tt
            e_trans += et
            n_switch += sw
    return {"t_op": t_op, "e_op": e_op, "t_trans": t_trans,
            "e_trans": e_trans, "n_switch": n_switch}


def _single_lane(padded: PaddedArrays) -> StackedArrays:
    """View one problem as a single-lane stack."""
    return StackedArrays(
        t_op=padded.t_op[None], e_op=padded.e_op[None],
        valid=padded.valid[None], t_trans=padded.t_trans[None],
        e_trans=padded.e_trans[None], switch=padded.switch[None],
        max_sizes=padded.sizes)


# ---------------------------------------------------------- torch

#: torch dtype of each numpy dtype a lane tensor holds
TORCH_DTYPES = {np.dtype(np.float64): torch.float64,
                 np.dtype(bool): torch.bool,
                 np.dtype(np.int64): torch.int64}


class TorchBackend:
    """The solver kernels on one torch device (see module docstring).

    The lane entry points (``dp_multi_lanes``, ``kbest_multi_lanes``,
    ``path_costs_lanes`` and ``path_costs_grouped``) read their operands
    from the device mirror of a :class:`BucketStack`.  The non-stacked
    ``dp_multi``, ``kbest_multi`` and ``path_costs`` run the same
    kernels on a one-lane copy of a problem's padded tensors.
    """

    name = "torch"
    # the round scheduler drives this backend through the lanes API
    device_lanes = True

    _LANE_NAMES = ("_t_op", "_e_op", "_valid", "_t_trans", "_e_trans",
                   "_switch")

    # Mirrors are allocated at this capacity floor even while the host
    # store is small, so the first few admissions never reallocate.
    _MIRROR_MIN_CAP = 64

    def __init__(self, device: str | torch.device = "cuda"):
        dev = torch.device(device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"TorchBackend({str(device)!r}): CUDA is not "
                    "available; pass device='cpu' to run the plain "
                    "versions on the CPU")
            if dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
        elif dev.type != "cpu":
            raise ValueError(f"TorchBackend: unsupported device {dev}")
        self.device = dev
        # host→device traffic and launch accounting of the lane path;
        # the parallel sweep and concurrent compile_many calls share
        # one backend, so every update goes through _count.  A leaf
        # lock: nothing else is ever acquired while it is held.
        self.io_stats = {"h2d_lane_uploads": 0, "h2d_lane_bytes": 0,
                         "kernel_dispatches": 0, "gather_calls": 0,
                         "gather_groups": 0, "dp_lanes": 0,
                         "kbest_lanes": 0}
        self._io_lock = threading.Lock()

    def _count(self, **deltas: int) -> None:
        with self._io_lock:
            for name, n in deltas.items():
                self.io_stats[name] += n

    def io_counts(self) -> dict:
        """A consistent copy of :attr:`io_stats`."""
        with self._io_lock:
            return dict(self.io_stats)

    def _put(self, arr: np.ndarray, dtype=None) -> torch.Tensor:
        arr = np.ascontiguousarray(arr, dtype=dtype)
        return torch.from_numpy(arr).to(self.device)

    def _stage(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """Host arrays of 8-byte elements (int64 / float64) to the
        device as ONE packet: one pinned buffer from PyTorch's caching
        host allocator (a new one per call, so a buffer still in flight
        is never reused) and one non-blocking copy.  Returns a device
        view of each array, of its dtype and shape."""
        flat = [np.ascontiguousarray(a).reshape(-1) for a in arrays]
        cuda = self.device.type == "cuda"
        packet = torch.empty(sum(a.size for a in flat), dtype=torch.int64,
                             pin_memory=cuda)
        host = packet.numpy()
        off = 0
        for a in flat:
            host[off:off + a.size] = a.view(np.int64)
            off += a.size
        if cuda:
            packet = packet.to(self.device, non_blocking=True)
        views, off = [], 0
        for a, orig in zip(flat, arrays):
            views.append(packet[off:off + a.size]
                         .view(TORCH_DTYPES[a.dtype]).view(orig.shape))
            off += a.size
        return views

    def _fetch(self, dev: torch.Tensor, finish) -> PendingResult:
        """ONE non-blocking copy of ``dev`` into pinned host memory; a
        CUDA event marks its end, and :meth:`PendingResult.get` waits on
        that event, then returns ``finish(host numpy array)``."""
        if self.device.type != "cuda":
            return PendingResult(lambda: finish(dev.numpy()))
        host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
        host.copy_(dev, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(self.device))

        def get():
            done.synchronize()
            return finish(host.numpy())

        return PendingResult(get)

    # -- the device mirror --------------------------------------------

    def _mirror(self, store: BucketStack) -> _LaneMirror:
        """Device mirror of a lane store, synced incrementally: lanes
        admitted since the last sync go up as one block per tensor
        (counted in ``io_stats``), capacity growth copies on the device,
        and a warm sync is a bookkeeping check."""
        key = ("torch_lanes", str(self.device))
        uploads = nbytes = 0
        with store._lock:
            m = store.scratch.get(key)
            if m is None:
                m = store.scratch[key] = _LaneMirror()
            cap = max(self._MIRROR_MIN_CAP, store._cap)
            if m.n == store.n and m.cap == cap:
                return m
            host = [getattr(store, nm) for nm in self._LANE_NAMES]
            if m.cap != cap:
                old = m.arrays or (None,) * len(host)
                grown = []
                for arr, h in zip(old, host):
                    new = torch.zeros((cap,) + h.shape[1:],
                                      dtype=TORCH_DTYPES[h.dtype],
                                      device=self.device)
                    if arr is not None and m.n:
                        new[:m.n].copy_(arr[:m.n])
                    grown.append(new)
                m.arrays = tuple(grown)
                m.cap = cap
            if store.n > m.n:
                for arr, h in zip(m.arrays, host):
                    arr[m.n:store.n].copy_(
                        torch.from_numpy(h[m.n:store.n]))
                uploads = store.n - m.n
                nbytes = sum(h[m.n:store.n].nbytes for h in host)
            m.n = store.n
        self._count(h2d_lane_uploads=uploads, h2d_lane_bytes=nbytes)
        return m

    @staticmethod
    def _lanes_of(store: BucketStack, lanes: Sequence[int]) -> np.ndarray:
        idx = np.asarray(lanes, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= store.n):
            raise IndexError(f"lane index out of range [0, {store.n})")
        return idx

    # -- lane entry points (the round scheduler's hot path) -----------

    def dp_multi_lanes(self, store: BucketStack, lanes: Sequence[int],
                       w_e: np.ndarray, w_t: np.ndarray, *,
                       defer: bool = False):
        """Stacked multi-λ DP over resident lanes of ``store``: ``w_e,
        w_t [B, K]`` → ``[B, K, L]`` int64 states.  Lanes and weights go
        up as one packet, the states come down in one copy.  With
        ``defer=True`` returns a :class:`PendingResult` (the kernel is
        launched now, the host waits at ``get()``)."""
        idx = self._lanes_of(store, lanes)
        m = self._mirror(store)
        ln, we, wt = self._stage(idx, np.asarray(w_e, np.float64),
                                 np.asarray(w_t, np.float64))
        out = dp_multi_stacked(*m.arrays[:5], ln, we, wt)
        self._count(kernel_dispatches=1, dp_lanes=len(idx))
        pend = self._fetch(out, lambda a: a.astype(np.int64))
        return pend if defer else pend.get()

    def kbest_multi_lanes(self, store: BucketStack,
                          lanes: Sequence[int], mus: np.ndarray,
                          k: int, *, defer: bool = False):
        """Stacked multi-μ k-best frontier over resident lanes: ``mus
        [B, K]`` → ``(paths [B, K, k, L], counts [B, K])`` int64 (see
        :meth:`dp_multi_lanes` for the staging and defer contract)."""
        idx = self._lanes_of(store, lanes)
        m = self._mirror(store)
        ln, mu = self._stage(idx, np.asarray(mus, np.float64))
        B, K = mu.shape
        L = m.arrays[0].shape[1]
        n_paths = B * K * k * L
        out = torch.empty(n_paths + B * K, dtype=torch.int32,
                          device=self.device)
        kbest_multi_stacked(*m.arrays[:5], ln, mu, k, out=out)
        self._count(kernel_dispatches=1, kbest_lanes=B)
        pend = self._fetch(out, lambda a: (
            a[:n_paths].reshape(B, K, k, L).astype(np.int64),
            a[n_paths:].reshape(B, K).astype(np.int64)))
        return pend if defer else pend.get()

    def path_costs_lanes(self, store: BucketStack, lanes: np.ndarray,
                         paths: np.ndarray, *, defer: bool = False):
        """Summed cost components of paths on resident lanes (global
        stack slots): a one-group :meth:`path_costs_grouped`."""
        pend = self.path_costs_grouped([(store, lanes, paths)], defer=True)
        one = PendingResult(lambda: pend.get()[0])
        return one if defer else one.get()

    def path_costs_grouped(self, groups, *, defer: bool = False):
        """Summed cost components of the paths of several groups, each
        ``(store, lanes [P], paths [P, L])`` on resident lanes of its own
        store, in ONE gather launch: lanes, paths and each group's
        descriptor go up as one packet, the five component blocks of
        every group come down in one copy, and the sums happen on the
        host with ``np.sum`` over C-contiguous ``[P, L]`` rows, in
        numpy's order.  A group's costs do not depend on the groups
        beside it.  Groups with ``L == 1`` (nothing to gather) or no
        paths are summed on the host.  Returns one dict a group (see
        :func:`host_path_costs` for its keys)."""
        done: dict[int, dict] = {}
        launch = []
        for g, (store, lanes, paths) in enumerate(groups):
            lanes = self._lanes_of(store, lanes)
            paths = np.asarray(paths, dtype=np.int64)
            L, S = store._t_op.shape[1], store._t_op.shape[2]
            if paths.shape != (len(lanes), L):
                raise ValueError(f"path_costs: paths must be [P, {L}] for "
                                 f"{len(lanes)} lanes, got {paths.shape}")
            if paths.size and (paths.min() < 0 or paths.max() >= S):
                raise IndexError(f"path state index out of range [0, {S})")
            if L == 1 or not len(lanes):
                done[g] = _sum_stacked(store.view(), lanes, paths)
            else:
                launch.append((g, store, lanes, paths))
        if not launch:
            out = [done[g] for g in range(len(groups))]
            return PendingResult.ready(out) if defer else out
        # every store is synced before any descriptor is read
        mirrors = [self._mirror(store).arrays for _, store, _, _ in launch]
        pend = self._gather([((m[0], m[1], m[3], m[4], m[5]), lanes, paths)
                             for (_, _, lanes, paths), m
                             in zip(launch, mirrors)])

        def merge() -> list[dict]:
            for (g, *_), sums in zip(launch, pend.get()):
                done[g] = sums
            return [done[g] for g in range(len(groups))]

        res = PendingResult(merge)
        return res if defer else res.get()

    def _gather(self, jobs) -> PendingResult:
        """ONE grouped gather launch over ``jobs`` ``(mirror, lanes,
        paths)``; the result is the host sums of each job."""
        mirrors, lanes, paths = zip(*jobs)
        out, layout = path_components_grouped(mirrors, lanes, paths)
        self._count(kernel_dispatches=1, gather_calls=1,
                    gather_groups=len(jobs))
        return self._fetch(out, lambda host: [
            _sum_components(c) for c in split_components(host, layout)])

    # -- non-stacked entry points: the same kernels with B = 1 --------

    def _padded_dev(self, padded: PaddedArrays) -> tuple:
        key = ("torch", str(self.device))
        if key not in padded.dev_cache:
            padded.dev_cache[key] = tuple(
                self._put(getattr(padded, nm)[None])
                for nm in ("t_op", "e_op", "valid", "t_trans", "e_trans",
                           "switch"))
        return padded.dev_cache[key]

    def dp_multi(self, padded: PaddedArrays, w_e: np.ndarray,
                 w_t: np.ndarray) -> np.ndarray:
        """Best path per weight pair ``(w_e[k], w_t[k])`` on one
        problem: ``[K, L]`` int64 states."""
        dev = self._padded_dev(padded)
        ln, we, wt = self._stage(np.zeros(1, np.int64),
                                 np.asarray(w_e, np.float64)[None],
                                 np.asarray(w_t, np.float64)[None])
        out = dp_multi_stacked(*dev[:5], ln, we, wt)
        return self._fetch(out, lambda a: a[0].astype(np.int64)).get()

    def kbest_multi(self, padded: PaddedArrays, mus: np.ndarray,
                    k: int) -> tuple[np.ndarray, np.ndarray]:
        """k best paths per μ on one problem: ``(paths [K, k, L],
        counts [K])`` int64; rows past ``counts[q]`` carry no
        meaning."""
        dev = self._padded_dev(padded)
        ln, mu = self._stage(np.zeros(1, np.int64),
                             np.asarray(mus, np.float64)[None])
        K, L = mu.shape[1], padded.n_layers
        out = torch.empty(K * (k * L + 1), dtype=torch.int32,
                          device=self.device)
        kbest_multi_stacked(*dev[:5], ln, mu, k, out=out)
        return self._fetch(out, lambda a: (
            a[:K * k * L].reshape(K, k, L).astype(np.int64),
            a[K * k * L:].astype(np.int64))).get()

    def path_costs(self, problem, paths: np.ndarray
                   ) -> dict[str, np.ndarray]:
        """Summed per-path cost components on one problem's padded
        tensors: a one-group gather (summed on the host)."""
        padded = problem.padded_arrays()
        paths = np.asarray(paths, dtype=np.int64)
        lanes = np.zeros(len(paths), np.int64)
        if padded.n_layers == 1 or not len(paths):
            return _sum_stacked(_single_lane(padded), lanes, paths)
        t_op, e_op, _, t_trans, e_trans, switch = self._padded_dev(padded)
        return self._gather([((t_op, e_op, t_trans, e_trans, switch),
                              lanes, paths)]).get()[0]


def _sum_components(comps) -> dict[str, np.ndarray]:
    """Host sums of gathered per-layer components — ``np.sum`` over
    C-contiguous [P, L] rows, the reference's exact summation."""
    t, e, tt, et, sw = comps
    return {"t_op": t.sum(axis=1), "e_op": e.sum(axis=1),
            "t_trans": tt.sum(axis=1), "e_trans": et.sum(axis=1),
            "n_switch": sw.sum(axis=1)}


# -------------------------------------------------------- registry

_INSTANCES: dict[str, TorchBackend] = {}
_INSTANCES_LOCK = threading.Lock()


def get_backend(device: str | torch.device | TorchBackend | None = None
                ) -> TorchBackend:
    """The cached :class:`TorchBackend` of ``device`` (``None`` →
    ``"cuda"``); a backend instance is returned as is."""
    if isinstance(device, TorchBackend):
        return device
    key = str(torch.device("cuda" if device is None else device))
    with _INSTANCES_LOCK:
        if key not in _INSTANCES:
            _INSTANCES[key] = TorchBackend(key)
        return _INSTANCES[key]


def available_backends() -> tuple[str, ...]:
    """Devices a :class:`TorchBackend` can run on here: ``"cpu"`` (the
    kernels' plain versions), and ``"cuda"`` when a card is present."""
    return ("cpu", "cuda") if torch.cuda.is_available() else ("cpu",)
