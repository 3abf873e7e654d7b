"""Gradient compression, as ``repro.train.grad_compress`` computes it:
symmetric per-tensor int8 quantization (``_quantize``, round half to
even as ``jnp.round``), the compressed all-reduces over a group of
ranks, and the error-feedback state that carries the quantization
residual to the next step (EF-SGD), so that compression bias does not
accumulate.

:func:`compressed_psum` is the reference's compressed stage of a
hierarchical reduction (the cross-pod all-reduce over slow links):
int8 (each rank's values quantized with its own scale, the int8 codes
summed as int32 by an all-reduce, the scale the MAX over the ranks) or
bf16 (summed in bf16 by an all-reduce), or ``none``.  The backend picks
the float modes' order of summation, as XLA picks the reference's, so
two backends agree to within the rounding of an n-term sum in the
wire's dtype.  :func:`make_compressed_allreduce` maps it over a tree:
each rank holds its own gradient, the reference's block of a global
array n times as long on its first axis, so every leaf of one or more
axes (each of which the reference reduces) becomes the compressed mean
over the mesh axis; a 0-d or empty leaf stays as it is.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.launch.mesh import all_reduce
from repro_torch.train._tree import leaves, tree_map, unflatten


def _quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale float32)``: ``scale = max(amax, 1e-12) / 127``,
    ``q = clip(round(g / scale), -127, 127)``."""
    g32 = g.float()
    scale = torch.clamp(g32.abs().amax(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """A reduced copy of ``t`` over ``group`` (``None``: one rank)."""
    t = t.clone()
    if group is not None:
        all_reduce(t, group, op)
    return t


def compressed_psum(g: torch.Tensor, group, *,
                    mode: str = "int8") -> torch.Tensor:
    """The sum of ``g`` over the ranks of ``group`` with a compressed
    payload (``None``: one rank, whose value still goes through the
    wire format); mode: int8 | bf16 | none."""
    if mode == "none":
        return _all_reduce(g, group)
    if mode == "bf16":
        return _all_reduce(g.to(torch.bfloat16), group).to(g.dtype)
    if mode != "int8":
        raise ValueError(f"compressed_psum: unknown mode {mode!r}")
    q, scale = _quantize(g)
    # int32 sum (int8 accumulation overflows); the scale's max over ranks
    total = _all_reduce(q.to(torch.int32), group)
    scale = _all_reduce(scale, group, "max")
    return (total.float() * scale).to(g.dtype)


def make_compressed_allreduce(mesh, axis: str = "pod",
                              mode: str = "int8"):
    """Tree-level compressed mean over one mesh axis: each leaf of one
    or more axes becomes ``compressed_psum(leaf) / size`` over the
    axis's group (a rank's leaf is the reference's block, so the global
    array's first axis always divides); a 0-d or empty leaf is returned
    as it is."""
    n = mesh.shape[axis]
    group = mesh.group(axis)

    def reduce_tree(grads: Any) -> Any:
        def one(g):
            # the global first axis (n x g's) divides by n, and is below
            # n only where g's is empty
            if g.dim() and g.shape[0]:
                return compressed_psum(g, group, mode=mode) / n
            return g

        return tree_map(one, grads)

    return reduce_tree


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
