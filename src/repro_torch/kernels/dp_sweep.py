"""Wrappers, plain versions and build loader of the rail sweep's three
CUDA kernels (``repro_torch/csrc/dp_sweep.cu``).

Each wrapper takes the lane tensors of a device mirror (``[cap, L, S]``
node tensors, ``[cap, L-1, S, S]`` transition tensors) plus the lane
indices of one call, so lanes are gathered inside the kernel:

  - :func:`dp_multi_stacked` — stacked multi-λ Viterbi DP → best-path
    states ``[B, K, L]`` int32 (replaces ``dp_multi_stacked_pallas``);
  - :func:`kbest_multi_stacked` — stacked multi-μ k-best frontier →
    ``(paths [B, K, k, L], counts [B, K])`` int32 (replaces
    ``kbest_multi_stacked_pallas``); rows past ``counts`` carry no
    contract;
  - :func:`path_components` — per-layer cost components of P paths
    (replaces ``path_components_pallas``); the caller sums them on the
    host with ``np.sum`` so the totals keep numpy's summation order.

On a tensor that lies on the CPU a wrapper computes its plain PyTorch
float64 version (the ``*_plain`` functions beside it).  On a CUDA
tensor it launches the kernel or raises; it never falls back.  Every
launch adds one to :data:`LAUNCHES`.

The kernels are built at first use with ``nvcc`` for ``sm_90a`` into
``repro_torch/_build/`` and loaded with ``ctypes``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._nvcc import (
    BASE_FLAGS,
    CSRC,
    CudaLibrary,
    raise_on as _raise_on,
    stream_of as _stream,
)

SOURCE = CSRC / "dp_sweep.cu"
NVCC_FLAGS = BASE_FLAGS + ("--fmad=false",)

# widest state bucket the kernels take (their node-row prefetch is
# sized for it)
MAX_STATES = 1024
# dynamic shared memory a CTA may opt into on Hopper
_MAX_SMEM = 232_448

#: kernel launches per wrapper since the last :func:`reset_launch_counts`
LAUNCHES = {"dp_multi_stacked": 0, "kbest_multi_stacked": 0,
            "path_components": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ------------------------------------------------------------- build

def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pfdnn_dp_multi.argtypes = [p] * 10 + [i] * 4 + [p]
    lib.pfdnn_kbest_multi.argtypes = [p] * 10 + [i] * 5 + [p]
    lib.pfdnn_path_components.argtypes = [p] * 12 + [i] * 3 + [p]
    for fn in (lib.pfdnn_dp_multi, lib.pfdnn_kbest_multi,
               lib.pfdnn_path_components):
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, NVCC_FLAGS, _declare)


def build_library():
    """Compile ``dp_sweep.cu`` into a shared library (once per source
    content) and return its path."""
    return LIBRARY.build()


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels; declares every entry
    point's argument and return types."""
    return LIBRARY.load()


# ------------------------------------------------------ validation

def _check(name: str, tensors: dict[str, torch.Tensor],
           dtypes: dict[str, torch.dtype]) -> torch.device:
    dev = None
    for key, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {key} must be a torch.Tensor")
        if dev is None:
            dev = t.device
        if t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, "
                             f"expected {dev}")
        if t.dtype != dtypes[key]:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, "
                            f"expected {dtypes[key]}")
        if dev.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return dev


def _check_lane_shapes(name, t_op, e_op, valid, t_trans, e_trans) -> None:
    cap, L, S = t_op.shape
    if e_op.shape != t_op.shape or valid.shape != t_op.shape:
        raise ValueError(f"{name}: node tensors must share [cap, L, S]")
    want = (cap, max(L - 1, 0), S, S)
    if tuple(t_trans.shape) != want or tuple(e_trans.shape) != want:
        raise ValueError(f"{name}: transition tensors must be {want}, "
                         f"got {tuple(t_trans.shape)}")
    if S > MAX_STATES:
        raise ValueError(f"{name}: {S} padded states exceed the "
                         f"kernels' limit of {MAX_STATES}")



_F64, _I64, _I32 = torch.float64, torch.int64, torch.int32
_LANE_DTYPES = {"t_op": _F64, "e_op": _F64, "valid": torch.bool,
                "t_trans": _F64, "e_trans": _F64, "lanes": _I64}


# --------------------------------------------------------------- dp

def dp_multi_stacked(t_op, e_op, valid, t_trans, e_trans, lanes, w_e,
                     w_t) -> torch.Tensor:
    """Best path per (lane, weight column): node cost ``w_e·e_op +
    w_t·t_op`` (``inf`` where not ``valid``), edge cost ``w_e·e_trans +
    w_t·t_trans``, first-occurrence argmin parents.  ``lanes [B]``
    index the mirror's leading axis; ``w_e, w_t [B, K]`` → ``[B, K,
    L]`` int32 states."""
    dev = _check("dp_multi_stacked",
                 dict(t_op=t_op, e_op=e_op, valid=valid, t_trans=t_trans,
                      e_trans=e_trans, lanes=lanes, w_e=w_e, w_t=w_t),
                 dict(_LANE_DTYPES, w_e=_F64, w_t=_F64))
    _check_lane_shapes("dp_multi_stacked", t_op, e_op, valid, t_trans,
                       e_trans)
    B, K = w_e.shape
    if w_t.shape != w_e.shape or lanes.shape != (B,):
        raise ValueError("dp_multi_stacked: lanes [B], w_e/w_t [B, K]")
    if dev.type == "cpu":
        return dp_multi_stacked_plain(t_op, e_op, valid, t_trans, e_trans,
                                      lanes, w_e, w_t)
    _, L, S = t_op.shape
    out = torch.empty((B, K, L), dtype=_I32, device=dev)
    if B * K == 0:
        return out
    parents = torch.empty((B, K, max(L - 1, 0), S), dtype=_I32,
                          device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.pfdnn_dp_multi(
            t_op.data_ptr(), e_op.data_ptr(), valid.data_ptr(),
            t_trans.data_ptr(), e_trans.data_ptr(), lanes.data_ptr(),
            w_e.data_ptr(), w_t.data_ptr(), parents.data_ptr(),
            out.data_ptr(), B, K, L, S, _stream(dev))
    _raise_on("dp_multi_stacked", err)
    LAUNCHES["dp_multi_stacked"] += 1
    return out


def dp_multi_stacked_plain(t_op, e_op, valid, t_trans, e_trans, lanes,
                           w_e, w_t) -> torch.Tensor:
    """Plain PyTorch float64 version of :func:`dp_multi_stacked` (same
    operation order; ``torch.argmin`` returns the first minimum)."""
    t_op, e_op, valid = t_op[lanes], e_op[lanes], valid[lanes]
    t_trans, e_trans = t_trans[lanes], e_trans[lanes]
    B, L, S = t_op.shape
    K = w_e.shape[1]
    we4 = w_e[:, :, None, None]
    wt4 = w_t[:, :, None, None]
    node = we4 * e_op[:, None] + wt4 * t_op[:, None]          # [B,K,L,S]
    node = torch.where(valid[:, None], node,
                       torch.full_like(node, float("inf")))
    cost = node[:, :, 0]                                        # [B,K,S]
    parents = []
    for i in range(1, L):
        tot = we4 * e_trans[:, None, i - 1] + wt4 * t_trans[:, None, i - 1]
        tot = tot + cost[:, :, :, None]                         # [B,K,Sp,Sn]
        par = torch.argmin(tot, dim=2)                          # [B,K,Sn]
        cost = torch.gather(tot, 2, par[:, :, None, :])[:, :, 0] \
            + node[:, :, i]
        parents.append(par)
    paths = torch.empty((B, K, L), dtype=_I64, device=t_op.device)
    s = torch.argmin(cost, dim=2)                               # [B,K]
    paths[:, :, L - 1] = s
    for i in range(L - 2, -1, -1):
        s = torch.gather(parents[i], 2, s[:, :, None])[:, :, 0]
        paths[:, :, i] = s
    return paths.to(_I32)


# ------------------------------------------------------------ k-best

def kbest_multi_stacked(t_op, e_op, valid, t_trans, e_trans, lanes, mus,
                        k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """k best paths per (lane, μ) under node ``e_op + μ·t_op`` and edge
    ``e_trans + μ·t_trans``, in stable ``(value, flat index)`` order →
    ``(paths [B, K, k, L], counts [B, K])`` int32, ``counts =
    min(k, #finite)``."""
    dev = _check("kbest_multi_stacked",
                 dict(t_op=t_op, e_op=e_op, valid=valid, t_trans=t_trans,
                      e_trans=e_trans, lanes=lanes, mus=mus),
                 dict(_LANE_DTYPES, mus=_F64))
    _check_lane_shapes("kbest_multi_stacked", t_op, e_op, valid, t_trans,
                       e_trans)
    B, K = mus.shape
    if lanes.shape != (B,) or k < 1:
        raise ValueError("kbest_multi_stacked: lanes [B], mus [B, K], "
                         "k >= 1")
    if dev.type == "cpu":
        return kbest_multi_stacked_plain(t_op, e_op, valid, t_trans,
                                         e_trans, lanes, mus, k)
    _, L, S = t_op.shape
    smem = kbest_min_smem(S, k)
    if smem > _MAX_SMEM:
        raise ValueError(f"kbest_multi_stacked: S={S}, k={k} needs {smem} "
                         f"bytes of shared memory (> {_MAX_SMEM})")
    paths = torch.empty((B, K, k, L), dtype=_I32, device=dev)
    counts = torch.empty((B, K), dtype=_I32, device=dev)
    if B * K == 0:
        return paths, counts
    back = torch.empty((B, K, max(L - 1, 0), k, S), dtype=_I32, device=dev)
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.pfdnn_kbest_multi(
            t_op.data_ptr(), e_op.data_ptr(), valid.data_ptr(),
            t_trans.data_ptr(), e_trans.data_ptr(), lanes.data_ptr(),
            mus.data_ptr(), back.data_ptr(), paths.data_ptr(),
            counts.data_ptr(), B, K, L, S, k, _stream(dev))
    _raise_on("kbest_multi_stacked", err)
    LAUNCHES["kbest_multi_stacked"] += 1
    return paths, counts


def kbest_min_smem(S: int, k: int) -> int:
    """Shared memory (bytes) the k-best kernel needs at the least: one
    μ's two [S, k] float64 list slabs (k rounded up to even), its μ, its
    k final indices, two mbarriers, and three stages of a one-column
    tile (both slabs' column, its node values and valid word;
    ``kbest_fixed`` + ``stages_bytes`` in ``csrc/dp_sweep.cu``)."""
    stage = 2 * S + 3                   # doubles, rounded up to even
    return (16 * S * (k + (k & 1)) + 8 + 4 * ((k + 1) & ~1) + 16
            + 3 * 8 * (stage + (stage & 1)))


def kbest_multi_stacked_plain(t_op, e_op, valid, t_trans, e_trans, lanes,
                              mus, k: int
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch float64 version of :func:`kbest_multi_stacked`:
    a full stable sort stands in for the kernel's insertion lists."""
    t_op, e_op, valid = t_op[lanes], e_op[lanes], valid[lanes]
    t_trans, e_trans = t_trans[lanes], e_trans[lanes]
    B, L, S = t_op.shape
    K = mus.shape[1]
    mu4 = mus[:, :, None, None]
    node = e_op[:, None] + mu4 * t_op[:, None]                 # [B,K,L,S]
    node = torch.where(valid[:, None], node,
                       torch.full_like(node, float("inf")))
    costs = torch.full((B, K, S, k), float("inf"), dtype=_F64,
                       device=t_op.device)
    costs[:, :, :, 0] = node[:, :, 0]
    back = []
    for i in range(1, L):
        edge = e_trans[:, None, i - 1] + mu4 * t_trans[:, None, i - 1]
        cand = (costs[:, :, :, :, None]
                + edge[:, :, :, None, :]).reshape(B, K, S * k, S)
        order = torch.sort(cand, dim=2, stable=True).indices[:, :, :k]
        vals = torch.gather(cand, 2, order)                     # [B,K,k,S]
        costs = vals.transpose(2, 3) + node[:, :, i, :, None]
        back.append(order)
    flat = costs.reshape(B, K, S * k)
    order = torch.sort(flat, dim=2, stable=True).indices[:, :, :k]
    counts = torch.clamp(torch.isfinite(flat).sum(dim=2), max=k)
    paths = torch.empty((B, K, k, L), dtype=_I64, device=t_op.device)
    s, r = order // k, order % k                                # [B,K,k]
    paths[:, :, :, L - 1] = s
    bi = torch.arange(B, device=t_op.device)[:, None, None]
    qi = torch.arange(K, device=t_op.device)[None, :, None]
    for i in range(L - 2, -1, -1):
        f = back[i][bi, qi, r, s]
        s, r = f // k, f % k
        paths[:, :, :, i] = s
    return paths.to(_I32), counts.to(_I32)


# ------------------------------------------------------------ gather

def path_components(lanes, paths, t_op, e_op, t_trans, e_trans, switch
                    ) -> tuple[torch.Tensor, ...]:
    """Per-layer components of P paths on lanes of one mirror: ``lanes
    [P]``, ``paths [P, L]`` int64 → ``(t_op [P, L], e_op [P, L],
    t_trans [P, L-1], e_trans [P, L-1], switch [P, L-1])``.  Needs
    ``L >= 2``; indices must lie in range (the caller checks them on
    the host)."""
    dev = _check("path_components",
                 dict(lanes=lanes, paths=paths, t_op=t_op, e_op=e_op,
                      t_trans=t_trans, e_trans=e_trans, switch=switch),
                 dict(lanes=_I64, paths=_I64, t_op=_F64, e_op=_F64,
                      t_trans=_F64, e_trans=_F64, switch=_I64))
    cap, L, S = t_op.shape
    P = paths.shape[0]
    if L < 2 or paths.shape != (P, L) or lanes.shape != (P,):
        raise ValueError("path_components: L >= 2, lanes [P], paths "
                         "[P, L]")
    want = (cap, L - 1, S, S)
    for name, t in (("t_trans", t_trans), ("e_trans", e_trans),
                    ("switch", switch)):
        if tuple(t.shape) != want:
            raise ValueError(f"path_components: {name} must be {want}")
    if dev.type == "cpu":
        return path_components_plain(lanes, paths, t_op, e_op, t_trans,
                                     e_trans, switch)
    outs = (torch.empty((P, L), dtype=_F64, device=dev),
            torch.empty((P, L), dtype=_F64, device=dev),
            torch.empty((P, L - 1), dtype=_F64, device=dev),
            torch.empty((P, L - 1), dtype=_F64, device=dev),
            torch.empty((P, L - 1), dtype=_I64, device=dev))
    if P == 0:
        return outs
    lib = load_library()
    with torch.cuda.device(dev):
        err = lib.pfdnn_path_components(
            lanes.data_ptr(), paths.data_ptr(), t_op.data_ptr(),
            e_op.data_ptr(), t_trans.data_ptr(), e_trans.data_ptr(),
            switch.data_ptr(), *(o.data_ptr() for o in outs), P, L, S,
            _stream(dev))
    _raise_on("path_components", err)
    LAUNCHES["path_components"] += 1
    return outs


def path_components_plain(lanes, paths, t_op, e_op, t_trans, e_trans,
                          switch) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of :func:`path_components`."""
    L = paths.shape[1]
    ln = lanes[:, None]
    li = torch.arange(L, device=paths.device)[None, :]
    lt = li[:, :-1]
    a, b = paths[:, :-1], paths[:, 1:]
    return (t_op[ln, li, paths], e_op[ln, li, paths],
            t_trans[ln, lt, a, b], e_trans[ln, lt, a, b],
            switch[ln, lt, a, b])
