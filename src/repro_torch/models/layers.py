"""Transformer building blocks of the port: RoPE, the VLM's M-RoPE and
the attention constants.

The attention math itself lives in the kernel modules
(:mod:`repro_torch.kernels.flash_attention`,
:mod:`repro_torch.kernels.flash_decode`), reached through the layout
wrappers of :mod:`repro_torch.kernels.ops`.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import NEG_INF

__all__ = ["NEG_INF", "rope_angles", "apply_rope", "apply_mrope"]


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


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                sections: tuple[int, ...], theta: float = 1e6
                ) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): ``x [B, S, H, D]``, ``positions [3,
    B, S]`` (temporal, height, width grids); the ``D/2`` frequency slots
    are split into ``sections``, each driven by its grid.  Text-only
    streams (three equal grids) reduce to :func:`apply_rope`."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"apply_mrope: sections {sections} do not sum to "
                         f"{half}")
    idx = torch.arange(0, half, dtype=torch.float32, device=x.device)
    freqs = torch.pow(float(theta), -idx / half)
    # per-frequency-slot section id → which position grid drives it
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device), output_size=half)
    pos = positions.float()[sec_id]                   # [half, B, S]
    ang = pos.movedim(0, -1) * freqs                  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x, 2, dim=-1)
    dt = x.dtype
    x1, x2 = x1.float(), x2.float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(dt)
