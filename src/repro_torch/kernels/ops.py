"""The model-zoo layout (``[B, S, H, D]``) wrappers around the attention
kernels, as the transformer calls them.

The CUDA kernels mask ragged edges themselves, so no block size is
picked here and any ``Sq``, ``Sk`` and cache length ``S`` is taken.
On CPU tensors the kernels' plain versions run (see
:mod:`repro_torch.kernels.flash_attention` and
:mod:`repro_torch.kernels.flash_decode`).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode


def attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True) -> torch.Tensor:
    """``q [B, Sq, H, D]`` × ``k/v [B, Sk, KH, D]`` → ``[B, Sq, H, D]``
    through the prefill attention kernel."""
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    # queries align to the END of the KV range when lengths differ
    q_offset = kt.shape[2] - qt.shape[2] if causal else 0
    out = flash_attention(qt, kt, vt, causal=causal, q_offset=q_offset)
    return out.transpose(1, 2)


def decode_bshd(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, lengths: torch.Tensor
                ) -> torch.Tensor:
    """``q [B, 1, H, D]`` × cache ``[B, S, KH, D]`` with ``lengths [B]``
    valid entries → ``[B, 1, H, D]`` through the decode kernel."""
    return flash_decode(q[:, 0], k_cache, v_cache, lengths)[:, None]
