"""Transformer building blocks of the port: RoPE and the attention
constants.

The attention math itself lives in the kernel modules
(:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.flash_decode`), reached through the layout
wrappers of :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import NEG_INF

__all__ = ["NEG_INF", "rope_angles", "apply_rope"]


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions [...] → (cos, sin) of shape [..., head_dim/2], float32."""
    half = head_dim // 2
    idx = torch.arange(0, half, dtype=torch.float32,
                       device=positions.device)
    # a Python-float base: float32 pow on the device, no host copy
    freqs = torch.pow(float(theta), -idx / half)
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """x [B, S, H, D], positions [B, S] (llama-style half rotation)."""
    cos, sin = rope_angles(positions, x.shape[-1], theta)
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    dt = x.dtype
    x1, x2 = x1.float(), x2.float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)
