"""Public wrappers around the kernels: the model-zoo layout (``[B, S,
H, D]``) attention wrappers the transformer calls, and the int8 linear
layer (the paper's INT8 precision, §5.1).

The CUDA kernels mask ragged edges themselves, so no block size is
picked here and any ``Sq``, ``Sk``, cache length ``S`` and ``M``,
``K``, ``N`` is taken.  On CPU tensors the kernels' plain versions run
(see :mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.flash_decode` and
:mod:`repro_torch.kernels.int8_matmul`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode, flash_decode_mla
from repro_torch.kernels.int8_matmul import int8_matmul


def attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int = 0) -> torch.Tensor:
    """``q [B, Sq, H, D]`` × ``k/v [B, Sk, KH, D]`` → ``[B, Sq, H, D]``
    through the prefill attention kernel; ``window`` > 0 keeps the keys
    with ``q_pos - k_pos < window``."""
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    # queries align to the END of the KV range when lengths differ
    q_offset = kt.shape[2] - qt.shape[2] if causal else 0
    out = flash_attention(qt, kt, vt, causal=causal, q_offset=q_offset,
                          window=window)
    return out.transpose(1, 2)


def decode_bshd(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, lengths: torch.Tensor, *,
                with_lse: bool = False):
    """``q [B, 1, H, D]`` × cache ``[B, S, KH, D]`` with ``lengths [B]``
    valid entries → ``[B, 1, H, D]`` through the decode kernel
    (``with_lse``: and each row's log-sum-exp ``[B, H]``)."""
    if with_lse:
        out, lse = flash_decode(q[:, 0], k_cache, v_cache, lengths,
                                with_lse=True)
        return out[:, None], lse
    return flash_decode(q[:, 0], k_cache, v_cache, lengths)[:, None]


def decode_mla(q_lat: torch.Tensor, q_rope: torch.Tensor,
               ckv: torch.Tensor, krope: torch.Tensor,
               lengths: torch.Tensor, *, with_lse: bool = False):
    """MLA's absorbed decode: ``q_lat [B, H, R]`` and ``q_rope [B, H,
    DR]`` over one latent head's cache ``ckv [B, S, R]``, ``krope [B, S,
    DR]`` with ``lengths [B]`` valid entries → ``[B, H, R]`` through the
    MLA decode kernel (``with_lse``: and each row's log-sum-exp)."""
    q_lat, q_rope = q_lat.contiguous(), q_rope.contiguous()
    if with_lse:
        return flash_decode_mla(q_lat, q_rope, ckv, krope, lengths,
                                with_lse=True)
    return flash_decode_mla(q_lat, q_rope, ckv, krope, lengths)


def quantize_int8(x: torch.Tensor, axis: int = -1
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization along ``axis`` → ``(q, scale)``:
    ``scale = max(amax, 1e-8) / 127`` in float32, ``q =
    clip(round(x / scale), -127, 127)`` (round half to even; a bf16
    ``x`` divides in float32)."""
    amax = x.float().abs().amax(dim=axis, keepdim=True)
    scale = amax.clamp_min(1e-8) / 127.0
    # the cast writes q contiguous whatever x's strides (one pass)
    q = torch.round(x / scale).clamp(-127, 127).to(
        torch.int8, memory_format=torch.contiguous_format)
    return q, scale.squeeze(axis)


def int8_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Quantized linear layer: ``x [M, K]`` and ``w [K, N]`` float
    (float32 or bf16), quantized per row of ``x`` and per column of
    ``w``, multiplied on the int8 kernel → ``[M, N]`` float32.  ``w``'s
    codes are made as a contiguous ``[N, K]`` (the rows of ``w.t()``:
    the same codes and scales as per column of ``w``), so the kernel
    reads them K-major and needs no transpose pass."""
    xq, xs = quantize_int8(x, axis=1)
    wq, ws = quantize_int8(w.t(), axis=1)
    return int8_matmul(xq, wq.t(), xs, ws)
