"""Prefill attention: wrapper, plain version and launch count of the
hand-written CUDA kernels ``repro_torch/csrc/flash_attention_wgmma.cu``
(bfloat16, on the tensor cores) and ``repro_torch/csrc/flash_attention.cu``
(float32, on the CUDA cores: the tensor cores have no full-float32
product).

:func:`flash_attention` replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``: causal or
non-causal GQA attention of ``q [B, H, Sq, D]`` over ``k/v [B, KH, Sk,
D]``, queries at absolute positions ``q_offset + i``, optionally over
a sliding window (``window`` > 0 keeps the keys with ``q_pos - k_pos <
window``, the mask of the reference's ``flash_attention_jnp``, which
hymba's prefill computes), with the reference's online-softmax
semantics (``NEG_INF`` masks, the
``0.5·NEG_INF`` clamp, ``p`` rounded to V's dtype before ``P·V``,
``acc / max(l, 1e-30)`` in q's dtype).  ``Sq`` and ``Sk`` need not
divide any block size.

The float32 kernel gives each CTA of 8 warps 128 query rows and
streams 64-key K/V tiles (32-key at D = 192, MLA's prefill head) through
two ``cp.async`` stages; a lane holds a 4 × 8 (4 × 4) score tile and its
rows' outputs in registers, and the softmax stays in the registers of
one warp.  :func:`f32_plan` states
its tiling and shared memory per head dim and :func:`f32_blocks` its
blocks in launch order (heaviest causal query tile first) with the
K/V tiles each runs (a window skips the tiles below its rows' reach),
as the CUDA source sets them; ``chip_smoke.py`` holds the plan against the
library's ``pfdnn_flash_attention_f32_plan`` on the card.

On a tensor that lies on the CPU the wrapper computes
:func:`flash_attention_plain`, at any head dim; on a CUDA tensor it
launches the kernel of its dtype, built for :data:`HEAD_DIMS`, or
raises.  Every launch adds one to :data:`LAUNCHES`.  On a ``meta``
tensor (the dry-run's) each wrapper launches nothing and returns empty
outputs of the kernel's shapes, reporting the kernel's work
(:mod:`repro_torch.kernels._meta`; :func:`kept_pairs`).

The wrapper carries the gradient: it is a ``torch.autograd.Function``
whose backward is :func:`flash_attention_bwd`, hand-written kernels
that replace no TPU kernel (the reference trains through
``flash_attention_jnp`` under autodiff) and take every mask and head
dim the forward takes: ``repro_torch/csrc/flash_attention_bwd_wgmma.cu``
in bf16 (``wgmma`` on the tensor cores) and
``repro_torch/csrc/flash_attention_bwd.cu`` in float32 (CUDA cores),
on a CUDA tensor; :func:`flash_attention_bwd_plain` on a CPU tensor.
When autograd needs a gradient, the forward (kernel or plain version)
also writes each query row's statistics, float32 ``[2, B·H·Sq]``: the
clamped row maximum ``m`` of the scaled scores and ``1 / max(l,
1e-30)`` of its sum, which the backward reads instead of recomputing
them.  Serving (no gradient) writes none.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import _meta
from repro_torch.kernels._nvcc import (
    BASE_FLAGS,
    CSRC,
    CudaLibrary,
    raise_on,
    stream_of,
)

NEG_INF = -1e30
#: head dims the kernels are built for (192: MLA's prefill head)
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128, 192)
#: element types the kernel takes (q, k, v and the output share one)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SOURCE = CSRC / "flash_attention.cu"
WGMMA_SOURCE = CSRC / "flash_attention_wgmma.cu"
BWD_SOURCE = CSRC / "flash_attention_bwd.cu"
BWD_WGMMA_SOURCE = CSRC / "flash_attention_bwd_wgmma.cu"
# held by tolerance, so FMA contraction stays on
NVCC_FLAGS = BASE_FLAGS

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(entry: str, plan: str | None = None
             ) -> Callable[[ctypes.CDLL], None]:
    def declare(lib: ctypes.CDLL) -> None:
        fn = getattr(lib, entry)
        p, i = ctypes.c_void_p, ctypes.c_int
        # q, k, v, out; B, H, KH, Sq, Sk, D, q_offset, causal, window;
        # scale; the row statistics (NULL: none); the stream
        fn.argtypes = [p] * 4 + [i] * 9 + [ctypes.c_float, p, p]
        fn.restype = ctypes.c_int
        if plan is not None:
            fn = getattr(lib, plan)
            fn.argtypes = [i, ctypes.POINTER(i)]
            fn.restype = ctypes.c_int
    return declare


#: float32 kernel (``pfdnn_flash_attention_f32``; its tiling per head
#: dim from ``pfdnn_flash_attention_f32_plan``)
LIBRARY = CudaLibrary(SOURCE, NVCC_FLAGS,
                      _declare("pfdnn_flash_attention_f32",
                               "pfdnn_flash_attention_f32_plan"))
#: bfloat16 tensor-core kernel (``pfdnn_flash_attention_bf16``)
WGMMA_LIBRARY = CudaLibrary(WGMMA_SOURCE, NVCC_FLAGS,
                            _declare("pfdnn_flash_attention_bf16"))


def _declare_bwd(entry: str) -> Callable[[ctypes.CDLL], None]:
    def declare(lib: ctypes.CDLL) -> None:
        fn = getattr(lib, entry)
        p, i = ctypes.c_void_p, ctypes.c_int
        # q, k, v, out, dout, dq, dk, dv, statistics, δ scratch; B, H,
        # KH, Sq, Sk, D, q_offset, causal, window; scale; the stream
        fn.argtypes = [p] * 10 + [i] * 9 + [ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return declare


#: the float32 backward (``pfdnn_flash_attention_bwd_f32``, CUDA cores)
BWD_LIBRARY = CudaLibrary(BWD_SOURCE, NVCC_FLAGS,
                          _declare_bwd("pfdnn_flash_attention_bwd_f32"))
#: the bfloat16 backward (``pfdnn_flash_attention_bwd_bf16``, tensor
#: cores)
BWD_WGMMA_LIBRARY = CudaLibrary(
    BWD_WGMMA_SOURCE, NVCC_FLAGS,
    _declare_bwd("pfdnn_flash_attention_bwd_bf16"))


#: query rows a CTA of the float32 kernel owns; keys a K/V tile (the
#: head dims past 128 take half as many, see :func:`f32_plan`); keys of
#: a part of P through shared memory
F32_BLOCK_ROWS, F32_BLOCK_KEYS, F32_P_KEYS = 128, 64, 16


def f32_plan(d: int) -> dict[str, int]:
    """The float32 kernel's tiling at head dim ``d``, as
    ``csrc/flash_attention.cu`` sets it: a lane owns 4 query rows (and
    ``block_keys / 8`` keys of a tile), a warp 16 rows, a CTA of 8 warps
    128 rows; a K/V tile holds 64 keys, 32 at ``d`` > 128 (two stages of
    64 keys would not fit a block at 192); shared memory holds the Q
    tile (transposed), two stages of K (rows padded by 4 floats) and V,
    and each warp's 16-key part of P."""
    if d not in HEAD_DIMS:
        raise ValueError(f"f32_plan: head dim {d} not in {HEAD_DIMS}")
    rows_per_lane, warps = 4, 8
    keys = F32_BLOCK_KEYS // 2 if d > 128 else F32_BLOCK_KEYS
    warp_rows = F32_BLOCK_ROWS // warps
    floats = (F32_BLOCK_ROWS * d + 2 * keys * (d + 4) + 2 * keys * d
              + warps * F32_P_KEYS * warp_rows)
    return {"block_rows": F32_BLOCK_ROWS, "block_keys": keys,
            "threads": 32 * warps, "rows_per_lane": rows_per_lane,
            "smem_bytes": 4 * floats}


def f32_kv_tiles(first: int, rows: int, sq: int, sk: int, q_offset: int,
                 causal: bool, window: int = 0,
                 keys: int = F32_BLOCK_KEYS) -> int:
    """K/V tiles of ``keys`` keys the float32 kernel runs for query rows
    ``[first, first + rows)``: every tile of ``sk``, or (causal) those
    that start at or before the last real row's position, and
    (``window`` > 0) from the tile of the first row's lowest key,
    ``q_offset + first - window + 1``; 0 when no row sees a key."""
    hi = -(-sk // keys)
    end = min(first + rows, sq)
    if end <= first:
        return 0
    if causal:
        last = q_offset + end - 1
        hi = 0 if last < 0 else min(hi, last // keys + 1)
    lo = 0
    if window > 0:
        lo = max(0, (q_offset + first - window + 1) // keys)
    return max(0, hi - lo)


def f32_blocks(b: int, h: int, sq: int, sk: int, q_offset: int,
               causal: bool, window: int = 0, d: int = 64
               ) -> list[tuple[int, int, int, int]]:
    """The float32 kernel's blocks at head dim ``d`` in launch order, as
    ``(batch, head, first query row, K/V tiles)``: block ``i`` takes
    query tile ``n_qt - 1 - i // (b * h)`` of (batch, head) ``i % (b *
    h)``, so the heaviest causal tiles start first and neighbouring
    blocks share a KV head."""
    keys = f32_plan(d)["block_keys"]
    n_qt = -(-sq // F32_BLOCK_ROWS)
    blocks = []
    for i in range(n_qt * b * h):
        first = (n_qt - 1 - i // (b * h)) * F32_BLOCK_ROWS
        bi, hi = divmod(i % (b * h), h)
        blocks.append((bi, hi, first, f32_kv_tiles(
            first, F32_BLOCK_ROWS, sq, sk, q_offset, causal, window,
            keys)))
    return blocks


def kept_pairs(sq: int, sk: int, q_offset: int, causal: bool,
               window: int = 0) -> int:
    """(query, key) pairs the mask keeps in one (batch, head): keys at
    or before each query's position when ``causal``, and (``window`` >
    0) only the last ``window`` positions."""
    qpos = q_offset + np.arange(sq, dtype=np.int64)
    hi = np.minimum(sk - 1, qpos) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, qpos - window + 1) if window > 0 else 0
    return int(np.maximum(0, hi - lo + 1).sum())


def softmax_scale(d: int) -> float:
    """``1/sqrt(D)`` rounded to float32, as the reference's kernel
    multiplies float32 scores by it."""
    return float(np.float32(1.0 / math.sqrt(d)))


def check_attention_args(name: str, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, q_layout: str, kv_layout: str,
                         head_dims: tuple[int, ...] = HEAD_DIMS) -> None:
    """Types, devices, head counts and head dim shared by the two
    attention kernels (``q_layout``/``kv_layout`` name the dims for the
    error messages); the head dim must be one the kernels are built for
    only on a CUDA tensor (the plain versions take any)."""
    for key, t in (("q", q), ("k", k), ("v", v)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {key} must be a torch.Tensor")
        if t.device != q.device:
            raise ValueError(f"{name}: {key} is on {t.device}, "
                             f"expected {q.device}")
        if t.dtype not in DTYPES:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}; the "
                            f"kernel takes {sorted(map(str, DTYPES))}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name}: q, k and v must share a dtype "
                            f"({q.dtype} vs {t.dtype})")
    if k.shape != v.shape:
        raise ValueError(f"{name}: k and v must share {kv_layout}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    d = q.shape[-1]
    if k.shape[-1] != d:
        raise ValueError(f"{name}: q {q_layout} and k/v {kv_layout} "
                         f"disagree on D ({d} vs {k.shape[-1]})")
    if q.device.type != "cpu" and d not in head_dims:
        raise ValueError(f"{name}: head dim {d} not supported; the "
                         f"kernel takes {head_dims}")


def check_cuda_operands(name: str, tensors: dict[str, torch.Tensor]
                        ) -> None:
    """What a kernel launch needs beyond the shapes: contiguous tensors
    on 16-byte-aligned addresses."""
    for key, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must start on a 16-byte "
                             "boundary")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    window: int = 0) -> torch.Tensor:
    """``q [B, H, Sq, D]`` × ``k/v [B, KH, Sk, D]`` → ``[B, H, Sq, D]``
    in q's dtype; ``H`` a multiple of ``KH``; ``q_offset`` places the
    queries for the causal and window masks; ``window`` > 0 keeps only
    the keys with ``q_pos - k_pos < window`` (0: no window).
    Differentiable in q, k and v through :func:`flash_attention_bwd`."""
    name = "flash_attention"
    window = int(window)
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    _check_shapes(name, q, k, v)
    return _FlashAttention.apply(q, k, v, bool(causal), int(q_offset),
                                 window)


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> None:
    check_attention_args(name, q, k, v, "[B, H, Sq, D]", "[B, KH, Sk, D]")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q [B, H, Sq, D] and k/v [B, KH, Sk, D]")
    B, H = q.shape[:2]
    KH = k.shape[1]
    if k.shape[0] != B or KH == 0 or H % KH:
        raise ValueError(f"{name}: batch or head counts disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")


class _FlashAttention(torch.autograd.Function):
    """The forward kernel (plain version on the CPU), saving q, k, v, the
    output and, when a gradient is needed, the rows' statistics; the
    backward kernel (plain version on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, window):
        out, stats = _forward(q, k, v, causal, q_offset, window,
                              with_stats=any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.mask = (causal, q_offset, window)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, stats = ctx.saved_tensors
        causal, q_offset, window = ctx.mask
        dq, dk, dv = flash_attention_bwd(dout.contiguous(), q, k, v, out,
                                         causal=causal, q_offset=q_offset,
                                         window=window, stats=stats)
        return dq, dk, dv, None, None, None


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             causal: bool, q_offset: int, window: int,
             with_stats: bool = False
             ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(the output, the rows' statistics ``[2, B·H·Sq]`` when
    ``with_stats``, else None)."""
    name = "flash_attention"
    B, H, Sq, D = q.shape
    _, KH, Sk, _ = k.shape
    if q.device.type == "cpu":
        if with_stats:
            return flash_attention_plain(q, k, v, causal=causal,
                                         q_offset=q_offset, window=window,
                                         with_stats=True)
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, window=window), None
    if q.device.type == "meta":
        out = torch.empty_like(q)
        stats = torch.empty((2, B * H * Sq), dtype=torch.float32,
                            device=q.device) if with_stats else None
        pairs = B * H * kept_pairs(Sq, Sk, q_offset, causal, window)
        _meta.report(name, 4 * D * pairs, _meta.nbytes(q, k, v, out, stats))
        return out, stats
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    check_cuda_operands(name, dict(q=q, k=k, v=v))
    out = torch.empty_like(q)
    stats = torch.empty((2, B * H * Sq), dtype=torch.float32,
                        device=q.device) if with_stats else None
    if out.numel() == 0:
        return out, stats
    if q.dtype == torch.bfloat16:
        entry = WGMMA_LIBRARY.load().pfdnn_flash_attention_bf16
    else:
        entry = LIBRARY.load().pfdnn_flash_attention_f32
    with torch.cuda.device(q.device):
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), B, H, KH, Sq, Sk, D, int(q_offset),
                    int(bool(causal)), window, softmax_scale(D),
                    None if stats is None else stats.data_ptr(),
                    stream_of(q.device))
    raise_on(name, err)
    LAUNCHES[name] += 1
    return out, stats


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          q_offset: int = 0, window: int = 0,
                          with_stats: bool = False):
    """Plain PyTorch version of :func:`flash_attention`: the full
    masked softmax in float32, with the kernel's ``NEG_INF`` masks and
    clamp and its cast points (``p`` rounded to V's dtype before
    ``P·V``, the division by ``max(l, 1e-30)`` after it).  With
    ``with_stats``, (the output, the rows' statistics ``[2, B·H·Sq]``:
    ``m`` and ``1 / max(l, 1e-30)``, as the kernels write them)."""
    B, H, Sq, D = q.shape
    g = H // k.shape[1]
    vf = v.repeat_interleave(g, dim=1)
    s = _scores(q, k, causal, q_offset, window)
    m = s.amax(dim=-1, keepdim=True).clamp_min(0.5 * NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), vf.float())
    out = (out / l.clamp_min(1e-30)).to(q.dtype)
    if not with_stats:
        return out
    return out, torch.stack([m.reshape(-1),
                             1.0 / l.clamp_min(1e-30).reshape(-1)])


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool,
            q_offset: int, window: int) -> torch.Tensor:
    """``Q Kᵀ · scale`` in float32 ``[B, H, Sq, Sk]`` (GQA's KV heads
    repeated), ``NEG_INF`` where the mask drops a key."""
    g = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) \
        * softmax_scale(q.shape[-1])
    keep = _keep_mask(q.shape[2], k.shape[2], q_offset, causal, window,
                      q.device)
    if keep is not None:
        s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    return s


def flash_attention_bwd(dout: torch.Tensor, q: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, *, causal: bool = True,
                        q_offset: int = 0, window: int = 0,
                        stats: torch.Tensor | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of :func:`flash_attention` at ``q, k, v`` (shapes
    and mask as there) for the cotangent ``dout`` of its output ``out``,
    in q's dtype; ``stats``: the rows' statistics the forward saved
    (float32 ``[2, B·H·Sq]``), or None to compute them here.  On CPU
    tensors :func:`flash_attention_bwd_plain`; on CUDA tensors one call
    launches the backward kernels of q's dtype (bf16: the tensor-core
    kernels of ``csrc/flash_attention_bwd_wgmma.cu``, float32:
    ``csrc/flash_attention_bwd.cu``), after a statistics pass (the
    forward kernel into scratch) when ``stats`` is None, or raises."""
    name = "flash_attention_bwd"
    _check_shapes(name, q, k, v)
    for key, t in (("dout", dout), ("out", out)):
        if t.shape != q.shape or t.dtype != q.dtype \
                or t.device != q.device:
            raise ValueError(f"{name}: {key} must match q ({tuple(q.shape)}"
                             f" {q.dtype} on {q.device}), got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    B, H, Sq, D = q.shape
    _, KH, Sk, _ = k.shape
    if stats is not None and (stats.shape != (2, B * H * Sq)
                              or stats.dtype != torch.float32
                              or stats.device != q.device):
        raise ValueError(f"{name}: stats must be float32 [2, {B * H * Sq}]"
                         f" on {q.device}, got {tuple(stats.shape)} "
                         f"{stats.dtype} on {stats.device}")
    window = int(window)
    mask = dict(causal=causal, q_offset=q_offset, window=window)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(dout, q, k, v, out, stats=stats,
                                         **mask)
    if q.device.type == "meta":
        if stats is None:
            _, stats = _forward(q, k, v, causal, q_offset, window,
                                with_stats=True)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
            torch.empty_like(v)
        pairs = B * H * kept_pairs(Sq, Sk, q_offset, causal, window)
        _meta.report(name, 10 * D * pairs, _meta.nbytes(
            q, k, v, out, dout, stats, dq, dk, dv))
        return dq, dk, dv
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    check_cuda_operands(name, dict(q=q, k=k, v=v, out=out, dout=dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    if stats is None:
        _, stats = _forward(q, k, v, causal, q_offset, window,
                            with_stats=True)
    check_cuda_operands(name, dict(stats=stats))
    # δ = rowsum(dO ∘ O), from the first kernel to the others
    delta = torch.empty(B * H * Sq, dtype=torch.float32, device=q.device)
    if q.dtype == torch.bfloat16:
        entry = BWD_WGMMA_LIBRARY.load().pfdnn_flash_attention_bwd_bf16
    else:
        entry = BWD_LIBRARY.load().pfdnn_flash_attention_bwd_f32
    with torch.cuda.device(q.device):
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                    dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
                    delta.data_ptr(), B, H, KH, Sq, Sk, D, int(q_offset),
                    int(bool(causal)), window, softmax_scale(D),
                    stream_of(q.device))
    raise_on(name, err)
    LAUNCHES[name] += 1
    return dq, dk, dv


def flash_attention_bwd_plain(dout: torch.Tensor, q: torch.Tensor,
                              k: torch.Tensor, v: torch.Tensor,
                              out: torch.Tensor, *, causal: bool = True,
                              q_offset: int = 0, window: int = 0,
                              stats: torch.Tensor | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch version of :func:`flash_attention_bwd`, the formula
    the float32 kernel computes, in float32: S recomputed with the
    forward's ``NEG_INF`` masks; the rows' ``m`` and ``1 / max(l,
    1e-30)`` from ``stats`` (or computed as the forward computes them,
    with its ``0.5·NEG_INF`` clamp); ``P = exp(S − m) · (1 / l)``, ``dV
    = Pᵀ dO``, ``dP = dO Vᵀ``, ``δ = rowsum(dO ∘ O)``, ``dS = P ∘ (dP −
    δ)``, ``dQ = dS K · scale``, ``dK = dSᵀ Q · scale``, with GQA's dK
    and dV summed over each KV head's group; cast to q's dtype."""
    return _bwd_plain(dout, q, k, v, out, causal, q_offset, window, stats,
                      None)


def flash_attention_bwd_bf16_plain(dout: torch.Tensor, q: torch.Tensor,
                                   k: torch.Tensor, v: torch.Tensor,
                                   out: torch.Tensor, *,
                                   causal: bool = True, q_offset: int = 0,
                                   window: int = 0,
                                   stats: torch.Tensor | None = None
                                   ) -> tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """Plain PyTorch version of the bf16 kernel's algorithm: the formula
    of :func:`flash_attention_bwd_plain`, in float32, except that P and
    dS are rounded to bf16 where they enter a product (``dV = bf16(P)ᵀ
    dO``, ``dQ = bf16(dS) K · scale``, ``dK = bf16(dS)ᵀ Q · scale``, each
    summed in float32), as the kernel feeds them to the tensor cores;
    ``dS`` itself is formed from the float32 P."""
    return _bwd_plain(dout, q, k, v, out, causal, q_offset, window, stats,
                      torch.bfloat16)


def _bwd_plain(dout, q, k, v, out, causal, q_offset, window, stats,
               operand_dtype):
    """The two plain backwards: ``operand_dtype`` None keeps P and dS in
    float32 as product operands, else rounds them to it."""
    B, H, Sq, D = q.shape
    KH, Sk = k.shape[1], k.shape[2]
    g = H // KH
    scale = softmax_scale(D)

    def operand(x):
        return x if operand_dtype is None else x.to(operand_dtype).float()

    qf, do = q.float(), dout.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    s = _scores(q, k, causal, q_offset, window)
    if stats is None:
        m = s.amax(dim=-1, keepdim=True).clamp_min(0.5 * NEG_INF)
        inv_l = 1.0 / torch.exp(s - m).sum(dim=-1, keepdim=True) \
            .clamp_min(1e-30)
    else:
        m = stats[0].view(B, H, Sq, 1)
        inv_l = stats[1].view(B, H, Sq, 1)
    p = torch.exp(s - m) * inv_l
    del s
    dv = torch.matmul(operand(p).transpose(-1, -2), do)
    ds = torch.matmul(do, vf.transpose(-1, -2))
    ds -= (do * out.float()).sum(dim=-1, keepdim=True)
    ds *= p
    del p
    ds = operand(ds)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    dk = dk.view(B, KH, g, Sk, D).sum(dim=2)
    dv = dv.view(B, KH, g, Sk, D).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _keep_mask(sq: int, sk: int, q_offset: int, causal: bool,
               window: int, device) -> torch.Tensor | None:
    """[Sq, Sk] bools: the keys each query keeps (None: all of them)."""
    if not causal and window <= 0:
        return None
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = torch.arange(sk, device=device)
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        keep &= qpos[:, None] >= kpos[None, :]
    if window > 0:
        keep &= qpos[:, None] - kpos[None, :] < window
    return keep
