"""Decode attention: wrapper, plain version and launch count of the
hand-written CUDA kernel ``repro_torch/csrc/flash_decode.cu``.

:func:`flash_decode` replaces the Pallas TPU kernel
``repro.kernels.flash_decode.flash_decode``: one query token per
sequence, ``q [B, H, D]``, over a KV cache ``k/v [B, S, KH, D]`` of
which the first ``length[b]`` positions are valid, with GQA and the
reference's online-softmax semantics.  Cache positions at or past
``length[b]`` are never read; any ``S`` is taken.

On a tensor that lies on the CPU the wrapper computes
:func:`flash_decode_plain`; on a CUDA tensor it launches the kernel or
raises.  Every launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._nvcc import (
    BASE_FLAGS,
    CSRC,
    CudaLibrary,
    raise_on,
    stream_of,
)
from repro_torch.kernels.flash_attention import (
    DTYPES,
    NEG_INF,
    check_attention_args,
    check_cuda_operands,
    softmax_scale,
)

SOURCE = CSRC / "flash_decode.cu"
# held by tolerance, so FMA contraction stays on
NVCC_FLAGS = BASE_FLAGS
#: query heads one CTA serves (``H / KH``)
MAX_GROUP = 16

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES = {"flash_decode": 0}


def reset_launch_counts() -> None:
    LAUNCHES["flash_decode"] = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pfdnn_flash_decode.argtypes = ([p] * 5 + [i] * 6
                                       + [ctypes.c_float, p])
    lib.pfdnn_flash_decode.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, NVCC_FLAGS, _declare)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor) -> torch.Tensor:
    """``q [B, H, D]`` × cache ``k/v [B, S, KH, D]``, ``length [B]``
    int32 → ``[B, H, D]`` in q's dtype.  A length past ``S`` counts as
    ``S``; a length of 0 gives zeros."""
    name = "flash_decode"
    check_attention_args(name, q, k, v, "[B, H, D]", "[B, S, KH, D]")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"{name}: q [B, H, D] and k/v [B, S, KH, D]")
    B, H, D = q.shape
    _, S, KH, _ = k.shape
    if k.shape[0] != B or KH == 0 or H % KH:
        raise ValueError(f"{name}: batch or head counts disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if (not isinstance(length, torch.Tensor) or length.dtype != torch.int32
            or tuple(length.shape) != (B,) or length.device != q.device):
        raise ValueError(f"{name}: length must be an int32 tensor [B] "
                         f"on {q.device}")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if H // KH > MAX_GROUP:
        raise ValueError(f"{name}: {H // KH} query heads per KV head; "
                         f"the kernel serves at most {MAX_GROUP}")
    check_cuda_operands(name, dict(q=q, k=k, v=v, length=length))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(q.device):
        err = lib.pfdnn_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
            out.data_ptr(), B, H, KH, S, D, DTYPES[q.dtype],
            softmax_scale(D), stream_of(q.device))
    raise_on(name, err)
    LAUNCHES[name] += 1
    return out


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       length: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_decode`: the full masked
    softmax in float32 with the kernel's ``NEG_INF`` mask and clamp and
    its cast points."""
    B, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    g = H // KH
    kf = k.float().permute(0, 2, 3, 1)                     # [B, KH, D, S]
    vf = v.permute(0, 2, 1, 3)                             # [B, KH, S, D]
    s = torch.matmul(q.float().view(B, KH, g, D), kf) * softmax_scale(D)
    valid = (torch.arange(S, device=q.device)[None, :]
             < length.to(q.device)[:, None])               # [B, S]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(0.5 * NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), vf.float())  # [B, KH, g, D]
    return (out / l.clamp_min(1e-30)).reshape(B, H, D).to(q.dtype)
