"""Prefill attention: wrapper, plain version and launch count of the
hand-written CUDA kernels ``repro_torch/csrc/flash_attention_wgmma.cu``
(bfloat16, on the tensor cores) and ``repro_torch/csrc/flash_attention.cu``
(float32, on the CUDA cores: the tensor cores have no full-float32
product).

:func:`flash_attention` replaces the Pallas TPU kernel
``repro.kernels.flash_attention.flash_attention``: causal or
non-causal GQA attention of ``q [B, H, Sq, D]`` over ``k/v [B, KH, Sk,
D]``, queries at absolute positions ``q_offset + i``, with the
reference's online-softmax semantics (``NEG_INF`` masks, the
``0.5·NEG_INF`` clamp, ``p`` rounded to V's dtype before ``P·V``,
``acc / max(l, 1e-30)`` in q's dtype).  ``Sq`` and ``Sk`` need not
divide any block size.

The float32 kernel gives each CTA of 8 warps 128 query rows and
streams 64-key K/V tiles through two ``cp.async`` stages; a lane holds
a 4 × 8 score tile and its rows' outputs in registers, and the softmax
stays in the registers of one warp.  :func:`f32_plan` states
its tiling and shared memory per head dim and :func:`f32_blocks` its
blocks in launch order (heaviest causal query tile first), as the CUDA
source sets them; ``chip_smoke.py`` holds the plan against the
library's ``pfdnn_flash_attention_f32_plan`` on the card.

On a tensor that lies on the CPU the wrapper computes
:func:`flash_attention_plain`; on a CUDA tensor it launches the kernel
of its dtype or raises.  Every launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels._nvcc import (
    BASE_FLAGS,
    CSRC,
    CudaLibrary,
    raise_on,
    stream_of,
)

NEG_INF = -1e30
#: head dims the kernel is built for
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
#: element types the kernel takes (q, k, v and the output share one)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

SOURCE = CSRC / "flash_attention.cu"
WGMMA_SOURCE = CSRC / "flash_attention_wgmma.cu"
# held by tolerance, so FMA contraction stays on
NVCC_FLAGS = BASE_FLAGS

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES = {"flash_attention": 0}


def reset_launch_counts() -> None:
    LAUNCHES["flash_attention"] = 0


def _declare(entry: str, plan: str | None = None
             ) -> Callable[[ctypes.CDLL], None]:
    def declare(lib: ctypes.CDLL) -> None:
        fn = getattr(lib, entry)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p] * 4 + [i] * 8 + [ctypes.c_float, p]
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


#: query rows a CTA of the float32 kernel owns, keys a K/V tile
F32_BLOCK_ROWS, F32_BLOCK_KEYS = 128, 64


def f32_plan(d: int) -> dict[str, int]:
    """The float32 kernel's tiling at head dim ``d``, as
    ``csrc/flash_attention.cu`` sets it: a lane owns 4 query rows (and 8
    keys of a tile), a warp 16 rows, a CTA of 8 warps 128 rows; shared
    memory holds the Q tile (transposed), two stages of K (rows padded
    by 4 floats) and V, and each warp's quarter tile of P."""
    if d not in HEAD_DIMS:
        raise ValueError(f"f32_plan: head dim {d} not in {HEAD_DIMS}")
    rows_per_lane, warps = 4, 8
    warp_rows = F32_BLOCK_ROWS // warps
    floats = (F32_BLOCK_ROWS * d + 2 * F32_BLOCK_KEYS * (d + 4)
              + 2 * F32_BLOCK_KEYS * d
              + warps * (F32_BLOCK_KEYS // 4) * warp_rows)
    return {"block_rows": F32_BLOCK_ROWS, "block_keys": F32_BLOCK_KEYS,
            "threads": 32 * warps, "rows_per_lane": rows_per_lane,
            "smem_bytes": 4 * floats}


def f32_kv_tiles(first: int, rows: int, sq: int, sk: int, q_offset: int,
                 causal: bool) -> int:
    """K/V tiles the float32 kernel runs for query rows ``[first, first
    + rows)``: every tile of ``sk``, or (causal) those that start at or
    before the last real row's position; 0 when no row sees a key."""
    tiles = -(-sk // F32_BLOCK_KEYS)
    end = min(first + rows, sq)
    if end <= first:
        return 0
    if causal:
        last = q_offset + end - 1
        tiles = 0 if last < 0 else min(tiles, last // F32_BLOCK_KEYS + 1)
    return tiles


def f32_blocks(b: int, h: int, sq: int, sk: int, q_offset: int,
               causal: bool) -> list[tuple[int, int, int, int]]:
    """The float32 kernel's blocks in launch order, as ``(batch, head,
    first query row, K/V tiles)``: block ``i`` takes query tile ``n_qt -
    1 - i // (b * h)`` of (batch, head) ``i % (b * h)``, so the heaviest
    causal tiles start first and neighbouring blocks share a KV head."""
    n_qt = -(-sq // F32_BLOCK_ROWS)
    blocks = []
    for i in range(n_qt * b * h):
        first = (n_qt - 1 - i // (b * h)) * F32_BLOCK_ROWS
        bi, hi = divmod(i % (b * h), h)
        blocks.append((bi, hi, first, f32_kv_tiles(
            first, F32_BLOCK_ROWS, sq, sk, q_offset, causal)))
    return blocks


def softmax_scale(d: int) -> float:
    """``1/sqrt(D)`` rounded to float32, as the reference's kernel
    multiplies float32 scores by it."""
    return float(np.float32(1.0 / math.sqrt(d)))


def check_attention_args(name: str, q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, q_layout: str,
                         kv_layout: str) -> None:
    """Types, devices, head counts and head dim shared by the two
    attention kernels (``q_layout``/``kv_layout`` name the dims for the
    error messages)."""
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
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not supported; the "
                         f"kernel takes {HEAD_DIMS}")


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
                    causal: bool = True, q_offset: int = 0
                    ) -> torch.Tensor:
    """``q [B, H, Sq, D]`` × ``k/v [B, KH, Sk, D]`` → ``[B, H, Sq, D]``
    in q's dtype; ``H`` a multiple of ``KH``; ``q_offset`` only matters
    when ``causal``."""
    name = "flash_attention"
    check_attention_args(name, q, k, v, "[B, H, Sq, D]", "[B, KH, Sk, D]")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q [B, H, Sq, D] and k/v [B, KH, Sk, D]")
    B, H, Sq, D = q.shape
    _, KH, Sk, _ = k.shape
    if k.shape[0] != B or KH == 0 or H % KH:
        raise ValueError(f"{name}: batch or head counts disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    check_cuda_operands(name, dict(q=q, k=k, v=v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if q.dtype == torch.bfloat16:
        entry = WGMMA_LIBRARY.load().pfdnn_flash_attention_bf16
    else:
        entry = LIBRARY.load().pfdnn_flash_attention_f32
    with torch.cuda.device(q.device):
        err = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    out.data_ptr(), B, H, KH, Sq, Sk, D, int(q_offset),
                    int(bool(causal)), softmax_scale(D),
                    stream_of(q.device))
    raise_on(name, err)
    LAUNCHES[name] += 1
    return out


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention`: the full
    masked softmax in float32, with the kernel's ``NEG_INF`` masks and
    clamp and its cast points (``p`` rounded to V's dtype before
    ``P·V``, the division by ``max(l, 1e-30)`` after it)."""
    B, H, Sq, D = q.shape
    g = H // k.shape[1]
    Sk = k.shape[2]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.repeat_interleave(g, dim=1)
    s = torch.matmul(q.float(), kf.transpose(-1, -2)) * softmax_scale(D)
    if causal:
        qpos = q_offset + torch.arange(Sq, device=q.device)
        kpos = torch.arange(Sk, device=q.device)
        s = torch.where(qpos[:, None] >= kpos[None, :], s,
                        torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(0.5 * NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), vf.float())
    return (out / l.clamp_min(1e-30)).to(q.dtype)
