"""AdamW with mixed-precision moments and ZeRO-2 moment sharding, as
``repro.train.optimizer`` computes it: the same float32 arithmetic and
cast points (bf16 or float32 moments, weight decay on tensors of two or
more dims, the clip scale ``min(1, clip / max(norm, 1e-12))``, bias
corrections from the step count as float32).

  - ``adamw_init(params, cfg, placements=)`` → opt_state
    ``{"m", "v", "count"}``
  - ``adamw_update(grads, opt_state, params, cfg, placements=,
    moments=)`` → (params, state, metrics)

On a mesh of ranks (``placements``: each parameter leaf's
:class:`~repro_torch.launch.mesh.Placement`) the gradients are the
reduced ones, each rank holding the leaves' blocks as the parameters
do; the clip's norm sums every block's squares over the axes the leaf
is cut on (a block that a group of ranks holds, a
:class:`~repro_torch.launch.mesh.Part` or a run of an
:class:`~repro_torch.launch.mesh.Uneven`, once).  ``zero_shard``
(ZeRO-2): each moment is cut over ``"data"`` along the axis the
reference's ``_zero_spec`` picks from the parameter's placement (the
first axis it leaves whole that divides by the ``"data"`` size; a leaf
already over ``"data"``, as the routed experts, is left alone), so the
cut composes with the parameter's over ``"model"``; a rank keeps its
slice of such moments, updates its slice of the parameter and
all-gathers the parameter over ``"data"``.  ZeRO on and off give the
same bits.

Deliberate differences from the reference: ``adamw_init`` returns the
state alone (the moments' placements come from
:func:`moment_placements`), and ``adamw_update`` writes the new
parameters and moments into the given tensors in place (one float32
leaf of scratch at a time instead of a second copy of the parameters
and moments) and returns them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.launch.mesh import (
    Placement,
    Uneven,
    all_gather_axis,
    all_reduce,
    mesh_axes,
    part_of,
)
from repro_torch.train._tree import leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    moment_dtype: str = "float32"     # or "bfloat16" (1T-scale memory)
    zero_shard: bool = False          # ZeRO-2 moment sharding over `data`


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to 10% (``step`` a float32 tensor)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.55 + 0.45 * torch.cos(math.pi * frac)
    return cfg.lr * warm * cos


def _zero_spec(spec: tuple, shape: tuple[int, ...], data_size: int
               ) -> tuple:
    """Shard the first unsharded, divisible axis over `data` (ZeRO-2).

    A mesh axis may appear at most once per spec — tensors already
    sharded over `data` (e.g. expert-parallel MoE weights) are left
    unchanged."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    if any("data" in mesh_axes(p) for p in parts):
        return tuple(parts)
    for i, (p, dim) in enumerate(zip(parts, shape)):
        if p is None and dim % data_size == 0 and dim >= data_size:
            parts[i] = "data"
            return tuple(parts)
    return tuple(parts)


def moment_placements(cfg: AdamWConfig, placements: Any,
                      shapes: Any) -> Any:
    """Each moment leaf's placement on the mesh of ``placements`` (the
    parameters'): its parameter's, or, where ``cfg.zero_shard`` and
    :func:`_zero_spec` of the parameter's spec and full shape
    (``shapes``, of ``param_shapes``) add a cut over ``"data"``, that
    spec."""
    pls = leaves(placements)
    mesh = pls[0].mesh
    data = mesh.shape.get("data", 1)
    if not cfg.zero_shard or data == 1:
        return placements
    out = []
    for pl, shape in zip(pls, leaves(shapes, tuples=True)):
        zero = _zero_spec(pl.spec, shape, data)
        padded = tuple(pl.spec) + (None,) * (len(shape) - len(pl.spec))
        out.append(pl if zero == padded else Placement(mesh, zero))
    return unflatten(placements, out)


def adamw_init(params: Any, cfg: AdamWConfig, *,
               placements: Any = None) -> dict:
    """Zero moments in ``cfg.moment_dtype`` and a step count of 0
    (int32), on the parameters' device: each moment of its parameter's
    shape, or, on a mesh (``placements``, the parameters' placement
    tree) with ``cfg.zero_shard``, of this rank's ZeRO slice
    (:func:`moment_placements`)."""
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" \
        else torch.float32
    count = torch.zeros((), dtype=torch.int32,
                        device=leaves(params)[0].device)
    if placements is None:
        def zeros(x):
            return torch.zeros(x.shape, dtype=mdt, device=x.device)

        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": count}
    shapes = tree_map(lambda x, pl: pl.global_shape(tuple(x.shape)),
                      params, placements)
    mpl = moment_placements(cfg, placements, shapes)

    def zeros_on(x, pl, mp):
        shape = mp.local_shape(pl.global_shape(tuple(x.shape)))
        return torch.zeros(shape, dtype=mdt, device=x.device)

    return {"m": tree_map(zeros_on, params, placements, mpl),
            "v": tree_map(zeros_on, params, placements, mpl),
            "count": count}


def global_norm(tree: Any, placements: Any = None) -> torch.Tensor:
    """sqrt of the float32 sum of squares, summed over the leaves in
    flatten order; on a mesh (``placements``), the squares of the leaves
    cut over mesh axes are summed over those axes' ranks first (each
    set of axes as one sum; a block held by ``k`` ranks of an axis, a
    :class:`~repro_torch.launch.mesh.Part` or a run of an
    :class:`~repro_torch.launch.mesh.Uneven`, weighted ``1 / k``, so
    that each block counts once where ``k`` differs between blocks)."""
    if placements is None:
        sq = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
        return torch.sqrt(sq)
    whole, cut = [], {}
    for x, pl in zip(leaves(tree), leaves(placements)):
        s = torch.sum(torch.square(x.float()))
        for e in pl.spec:
            part = part_of(e)
            if part is not None:
                s = s * (part.parts / pl.mesh.shape[part.axis])
            elif isinstance(e, Uneven):
                s = s * (1.0 / e.share(pl.mesh.coord(e.axis)))
        axes = tuple(a for e in pl.spec for a in mesh_axes(e)
                     if pl.mesh.shape[a] > 1)
        (cut.setdefault(axes, []) if axes else whole).append(s)
    mesh = leaves(placements)[0].mesh
    sq = sum(whole) if whole else torch.zeros((), device=mesh.device)
    for axes, parts in cut.items():
        part = sum(parts)
        for axis in axes:
            all_reduce(part, mesh.group(axis))
        sq = sq + part
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(grads: Any, state: dict, params: Any, cfg: AdamWConfig,
                 placements: Any = None, moments: Any = None
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step; returns (params, state, metrics) with the
    parameters and moments updated in place and a new count; metrics
    ``lr`` and ``grad_norm`` are 0-d float32 tensors.  On a mesh
    (``placements``) the gradients are the reduced ones in the
    parameters' blocks; ``moments`` (:func:`moment_placements`; default
    the parameters' placements) says which moments are ZeRO slices: a
    moment cut over ``"data"`` where its parameter is not is this
    rank's slice along that axis; the rank updates that slice and
    all-gathers the parameter over ``"data"``."""
    count = state["count"] + 1
    count_f = count.float()
    lr = lr_schedule(cfg, count_f)
    gnorm = global_norm(grads, placements)
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            max=1.0)
    else:
        scale = torch.ones((), device=gnorm.device)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - torch.pow(b1, count_f)
    bc2 = 1.0 - torch.pow(b2, count_f)

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * torch.square(g)
        mhat = m32 / bc1
        vhat = v32 / bc2
        step_ = mhat / (torch.sqrt(vhat) + cfg.eps)
        if p.dim() >= 2:   # decoupled weight decay on matrices only
            step_ = step_ + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step_)
        m.copy_(m32)
        v.copy_(v32)

    pls = leaves(placements) if placements is not None \
        else [None] * len(leaves(params))
    mps = leaves(moments) if moments is not None else pls
    for p, g, m, v, pl, mp in zip(leaves(params), leaves(grads),
                                  leaves(state["m"]), leaves(state["v"]),
                                  pls, mps):
        if mp is None or mp.spec == pl.spec:
            upd(p, g, m, v)
            continue
        # ZeRO-2: this rank's slice along the axis the moments cut
        axis = tuple(mp.spec).index("data")
        n = m.shape[axis]
        mesh = pl.mesh
        start = mesh.coord("data") * n
        piece = p.narrow(axis, start, n).clone()
        upd(piece, g.narrow(axis, start, n), m, v)
        p.copy_(all_gather_axis(piece, mesh.group("data"),
                                mesh.shape["data"], axis))
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        metrics
