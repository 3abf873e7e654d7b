"""Int8 matrix product: wrapper, routes, plain version and launch
counts of the hand-written CUDA kernels ``repro_torch/csrc/int8_matmul.cu``.

:func:`int8_matmul` replaces the Pallas TPU kernel
``repro.kernels.int8_matmul.int8_matmul``: ``x [M, K] int8 × w [K, N]
int8`` accumulated exactly in int32, then dequantized in the Pallas
kernel's epilogue order, ``float32(acc) * (x_scale[i] * w_scale[j])``
(the scale product first, each product rounded to float32).  The
result is ``[M, N]`` float32, bit for bit the Pallas kernel's.  Any
``M``, ``N`` and ``K`` are taken; the Pallas wrapper needs them to
tile.  ``w`` may be row-major or K-major (the transpose of a
contiguous ``[N, K]``, which ``int8_linear`` passes).

On the card :func:`int8_route` picks the kernel by shape and strides:
the ``wgmma`` kernel (TMA ring, tensor-core products) for M > 64 with K
and N multiples of 16, after one transpose pass on the card when ``w``
is row-major; the ``mma.sync`` kernel for every other shape.  On a
tensor that lies on the CPU the wrapper computes
:func:`int8_matmul_plain`; on a CUDA tensor it launches a kernel or
raises.  Every launch adds one to :data:`LAUNCHES` and to its route's
count in :data:`ROUTE_LAUNCHES`.  On a ``meta`` tensor (the dry-run's)
it launches nothing and returns an empty output, reporting 2·M·N·K
operations and its bytes (:mod:`repro_torch.kernels._meta`).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _meta
from repro_torch.kernels._nvcc import (
    BASE_FLAGS,
    CSRC,
    CudaLibrary,
    raise_on,
    refuse_grad,
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
#: the same launches by route, and the transpose passes of a row-major
#: ``w`` on the wgmma route
ROUTE_LAUNCHES = {"wgmma": 0, "mma_sync": 0, "w_transpose": 0}
#: fewest rows the wgmma route takes (``wgmma`` computes 64-row tiles;
#: decode batches are bound by w's bytes and stay on mma.sync)
WGMMA_MIN_M = 65


def reset_launch_counts() -> None:
    LAUNCHES["int8_matmul"] = 0
    for name in ROUTE_LAUNCHES:
        ROUTE_LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pfdnn_int8_matmul.argtypes = [p] * 5 + [i] * 4 + [p]
    lib.pfdnn_int8_matmul_wgmma.argtypes = [p] * 5 + [i] * 3 + [p]
    lib.pfdnn_int8_transpose.argtypes = [p, p, i, i, p]
    for fn in (lib.pfdnn_int8_matmul, lib.pfdnn_int8_matmul_wgmma,
               lib.pfdnn_int8_transpose):
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, NVCC_FLAGS, _declare)


def w_layout(w: torch.Tensor) -> str | None:
    """``"row"`` for a row-major ``w [K, N]``, ``"kmajor"`` for the
    transpose of a contiguous ``[N, K]`` (strides ``(1, K)``), None for
    any other layout.  Where both fit (a dimension of 1), row-major."""
    if w.is_contiguous():
        return "row"
    if w.t().is_contiguous():
        return "kmajor"
    return None


def int8_route(M: int, N: int, K: int, w_strides: tuple[int, int],
               aligned: bool = True) -> str:
    """The kernel a product goes to, by shape and strides alone:
    ``"wgmma"`` (w K-major, strides ``(1, K)``), ``"wgmma+transpose"``
    (a row-major w, transposed on the card first) or ``"mma_sync"``.
    The wgmma route needs M > 64 (64-row tiles; the decode shapes are
    bound by w's bytes), K and N multiples of 16 bytes (TMA's rule for
    global strides) and 16-byte aligned operands (``aligned``: the
    storage offsets of x and w; PyTorch's allocations are aligned)."""
    if M < WGMMA_MIN_M or K % 16 or N % 16 or not aligned:
        return "mma_sync"
    return "wgmma" if tuple(w_strides) == (1, K) else "wgmma+transpose"


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
    """``x [M, K]`` int8 (row-major) × ``w [K, N]`` int8 (row-major, or
    K-major: the transpose of a contiguous ``[N, K]``), per-row
    ``x_scale [M]`` and per-column ``w_scale [N]`` float32 → ``[M, N]``
    float32.  On the card the kernel is chosen by :func:`int8_route`."""
    _check_args(x, w, x_scale, w_scale)
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w, x_scale, w_scale)
    if x.device.type == "meta":
        out = _out(x, w)
        _meta.report("int8_matmul", 2 * x.shape[0] * w.shape[1] * x.shape[1],
                     _meta.nbytes(x, w, x_scale, w_scale, out))
        return out
    _check_cuda(x, w, x_scale, w_scale)
    M, K = x.shape
    N = w.shape[1]
    if M * N * K == 0:
        return _out(x, w).zero_()
    aligned = (x.storage_offset() % 16 == 0
               and w.storage_offset() % 16 == 0)
    route = int8_route(M, N, K, tuple(w.stride()), aligned)
    if route == "mma_sync":
        return _launch_mma(x, w, x_scale, w_scale)
    wt = _transpose(w) if route == "wgmma+transpose" else w.t()
    return _launch_wgmma(x, wt, x_scale, w_scale)


def _check_cuda(x, w, x_scale, w_scale) -> None:
    name = "int8_matmul"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    refuse_grad(name, dict(x_scale=x_scale, w_scale=w_scale))
    for key, t in (("x", x), ("x_scale", x_scale), ("w_scale", w_scale)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if w_layout(w) is None:
        raise ValueError(f"{name}: w must be contiguous [K, N] or the "
                         "transpose of a contiguous [N, K]")


def _out(x, w) -> torch.Tensor:
    return torch.empty((x.shape[0], w.shape[1]), dtype=torch.float32,
                       device=x.device)


def int8_matmul_mma(x, w, x_scale, w_scale) -> torch.Tensor:
    """The mma.sync route of :func:`int8_matmul` on CUDA tensors: any
    shape, ``w`` row-major or K-major."""
    _check_args(x, w, x_scale, w_scale)
    _check_cuda(x, w, x_scale, w_scale)
    if x.shape[0] * w.shape[1] * x.shape[1] == 0:
        return _out(x, w).zero_()
    return _launch_mma(x, w, x_scale, w_scale)


def _launch_mma(x, w, x_scale, w_scale) -> torch.Tensor:
    M, K = x.shape
    N = w.shape[1]
    lib = LIBRARY.load()
    out = _out(x, w)
    with torch.cuda.device(x.device):
        err = lib.pfdnn_int8_matmul(
            x.data_ptr(), w.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(), M, N, K,
            int(w_layout(w) == "kmajor"), stream_of(x.device))
    raise_on("int8_matmul", err)
    LAUNCHES["int8_matmul"] += 1
    ROUTE_LAUNCHES["mma_sync"] += 1
    return out


def _launch_wgmma(x, wt, x_scale, w_scale) -> torch.Tensor:
    M, K = x.shape
    N = wt.shape[0]
    lib = LIBRARY.load()
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.pfdnn_int8_matmul_wgmma(
            x.data_ptr(), wt.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(), M, N, K,
            stream_of(x.device))
    raise_on("int8_matmul", err)
    LAUNCHES["int8_matmul"] += 1
    ROUTE_LAUNCHES["wgmma"] += 1
    return out


def _transpose(w: torch.Tensor) -> torch.Tensor:
    """A row-major ``w [K, N]`` as a contiguous ``[N, K]``, by one pass
    of the library's transpose kernel."""
    K, N = w.shape
    lib = LIBRARY.load()
    wt = torch.empty((N, K), dtype=torch.int8, device=w.device)
    with torch.cuda.device(w.device):
        err = lib.pfdnn_int8_transpose(w.data_ptr(), wt.data_ptr(), K, N,
                                       stream_of(w.device))
    raise_on("int8_matmul", err)
    ROUTE_LAUNCHES["w_transpose"] += 1
    return wt


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
