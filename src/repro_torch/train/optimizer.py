"""AdamW with mixed-precision moments, as ``repro.train.optimizer``
computes it: the same float32 arithmetic and cast points (bf16 or
float32 moments, weight decay on tensors of two or more dims, the clip
scale ``min(1, clip / max(norm, 1e-12))``, bias corrections from the
step count as float32).

  - ``adamw_init(params, cfg)`` → opt_state ``{"m", "v", "count"}``
  - ``adamw_update(grads, opt_state, params, cfg)`` → (params, state,
    metrics)

Deliberate differences from the reference: ``adamw_init`` returns the
state alone (the reference also returns its partition specs, which
need a mesh), and :class:`AdamWConfig` has no ``zero_shard`` (ZeRO-2
moment sharding over a mesh of cards; passing it raises ``TypeError``):
both wait for the four-card item (``ROADMAP.md``).  ``adamw_update``
writes the new parameters and moments into the given tensors in place
(one float32 leaf of scratch at a time instead of a second copy of the
parameters and moments) and returns them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.train._tree import leaves, tree_map


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


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to 10% (``step`` a float32 tensor)."""
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.55 + 0.45 * torch.cos(math.pi * frac)
    return cfg.lr * warm * cos


def adamw_init(params: Any, cfg: AdamWConfig) -> dict:
    """Zero moments of each parameter's shape in ``cfg.moment_dtype``
    and a step count of 0 (int32), on the parameters' device."""
    mdt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" \
        else torch.float32

    def zeros(x):
        return torch.zeros(x.shape, dtype=mdt, device=x.device)

    count = torch.zeros((), dtype=torch.int32,
                        device=leaves(params)[0].device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": count}


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the float32 sum of squares, summed over the leaves in
    flatten order."""
    sq = sum(torch.sum(torch.square(x.float())) for x in leaves(tree))
    return torch.sqrt(sq)


@torch.no_grad()
def adamw_update(grads: Any, state: dict, params: Any, cfg: AdamWConfig
                 ) -> tuple[Any, dict, dict]:
    """One AdamW step; returns (params, state, metrics) with the
    parameters and moments updated in place and a new count; metrics
    ``lr`` and ``grad_norm`` are 0-d float32 tensors."""
    count = state["count"] + 1
    count_f = count.float()
    lr = lr_schedule(cfg, count_f)
    gnorm = global_norm(grads)
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

    for args in zip(leaves(params), leaves(grads), leaves(state["m"]),
                    leaves(state["v"])):
        upd(*args)
    metrics = {"lr": lr, "grad_norm": gnorm}
    return params, {"m": state["m"], "v": state["v"], "count": count}, \
        metrics
