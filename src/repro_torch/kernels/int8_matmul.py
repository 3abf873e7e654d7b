"""Int8 matrix product: wrapper, plain version and launch count of the
hand-written CUDA kernel ``repro_torch/csrc/int8_matmul.cu``.

:func:`int8_matmul` replaces the Pallas TPU kernel
``repro.kernels.int8_matmul.int8_matmul``: ``x [M, K] int8 × w [K, N]
int8`` accumulated exactly in int32, then dequantized in the Pallas
kernel's epilogue order, ``float32(acc) * (x_scale[i] * w_scale[j])``
(the scale product first, each product rounded to float32).  The
result is ``[M, N]`` float32, bit for bit the Pallas kernel's.  Any
``M``, ``N`` and ``K`` are taken; the Pallas wrapper needs them to
tile.

On a tensor that lies on the CPU the wrapper computes
:func:`int8_matmul_plain`; on a CUDA tensor it launches the kernel or
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

SOURCE = CSRC / "int8_matmul.cu"
# the epilogue's products are rounded one by one (__fmul_rn); no
# contraction anywhere besides
NVCC_FLAGS = BASE_FLAGS + ("--fmad=false",)
#: largest K whose int32 sums cannot overflow (|x·w| ≤ 128·128 per term)
MAX_K = (2**31 - 1) // (128 * 128)

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES = {"int8_matmul": 0}


def reset_launch_counts() -> None:
    LAUNCHES["int8_matmul"] = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pfdnn_int8_matmul.argtypes = [p] * 5 + [i] * 3 + [p]
    lib.pfdnn_int8_matmul.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, NVCC_FLAGS, _declare)


def _check_args(x, w, x_scale, w_scale) -> None:
    name = "int8_matmul"
    for key, t, dtype in (("x", x, torch.int8), ("w", w, torch.int8),
                          ("x_scale", x_scale, torch.float32),
                          ("w_scale", w_scale, torch.float32)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {key} must be a torch.Tensor")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, "
                            f"expected {dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: {key} is on {t.device}, "
                             f"expected {x.device}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{name}: x [M, K] and w [K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if tuple(x_scale.shape) != (x.shape[0],) \
            or tuple(w_scale.shape) != (w.shape[1],):
        raise ValueError(f"{name}: x_scale [M] and w_scale [N], got "
                         f"{tuple(x_scale.shape)} and "
                         f"{tuple(w_scale.shape)}")
    if x.shape[1] > MAX_K:
        raise ValueError(f"{name}: K = {x.shape[1]} > {MAX_K} could "
                         "overflow the int32 sums")


def int8_matmul(x: torch.Tensor, w: torch.Tensor, x_scale: torch.Tensor,
                w_scale: torch.Tensor) -> torch.Tensor:
    """``x [M, K]`` int8 × ``w [K, N]`` int8 (row-major), per-row
    ``x_scale [M]`` and per-column ``w_scale [N]`` float32 → ``[M, N]``
    float32."""
    name = "int8_matmul"
    _check_args(x, w, x_scale, w_scale)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w, x_scale, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    for key, t in (("x", x), ("w", w), ("x_scale", x_scale),
                   ("w_scale", w_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = LIBRARY.load()
    with torch.cuda.device(x.device):
        err = lib.pfdnn_int8_matmul(
            x.data_ptr(), w.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(), M, N, K,
            stream_of(x.device))
    raise_on(name, err)
    LAUNCHES[name] += 1
    return out


def int8_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                      x_scale: torch.Tensor, w_scale: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of :func:`int8_matmul`.  Integer products
    are not implemented for CUDA tensors, so the sum runs in float64,
    which is exact for ``|acc| < 2**53`` (every ``K ≤ MAX_K``); then the
    kernel's epilogue in float32, scale product first."""
    acc = torch.matmul(x.double(), w.double()).to(torch.int32)
    scale = x_scale[:, None] * w_scale[None, :]
    return acc.float() * scale
