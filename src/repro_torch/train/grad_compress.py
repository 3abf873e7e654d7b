"""Gradient compression on one card, as ``repro.train.grad_compress``
computes it: symmetric per-tensor int8 quantization (``_quantize``,
round half to even as ``jnp.round``) and the error-feedback state that
carries the quantization residual to the next step (EF-SGD), so that
compression bias does not accumulate.

The reference's compressed collectives (``compressed_psum``,
``make_compressed_allreduce``: an int8 or bf16 all-reduce inside
``shard_map`` across pods) need a mesh of cards and wait for the
four-card item (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.train._tree import leaves, tree_map, unflatten


def _quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale float32)``: ``scale = max(amax, 1e-12) / 127``,
    ``q = clip(round(g / scale), -127, 127)``."""
    g32 = g.float()
    scale = torch.clamp(g32.abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


class ErrorFeedback:
    """EF-compression state: residual carried across steps."""

    def __init__(self, params: Any):
        self.residual = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params)

    def compress(self, grads: Any) -> tuple[Any, "ErrorFeedback"]:
        """(the dequantized gradients in their dtypes, self with the
        new residuals)."""
        out, res = [], []
        for g, r in zip(leaves(grads), leaves(self.residual)):
            g32 = g.float() + r
            q, scale = _quantize(g32)
            deq = q.float() * scale
            out.append(deq.to(g.dtype))
            res.append(g32 - deq)
        self.residual = unflatten(self.residual, res)
        return unflatten(grads, out), self
