"""Mixture-of-Experts FFN on one device, as ``repro.models.moe`` computes
it for a model without a mesh (``moe_ffn_dense``).

Routing: float32 logits and softmax → top-k → renormalization over the
selected experts by ``max(sum, 1e-9)``, cast to x's dtype.  Ties go to
the lower expert index, as with ``jax.lax.top_k`` (``torch.topk``
promises no tie order, so :func:`router_topk` sorts stably).

The reference's oracle gathers each token's expert weights
(``[T, d, f]`` per choice and weight, 11.8 GB in bf16 at T = 2048 for
deepseek-v2-lite).  :func:`moe_ffn_dense` computes the same sum without
that gather: the (token, choice) rows are grouped by expert with a stable
argsort of the flat choices, each expert runs one SwiGLU product over
its rows, the results go back to ``[T, k, d]``, and the choices combine
in the reference's order and dtype (``out = out + cw[:, j] · y_j``, j =
0 … k−1, in x's dtype).  The products are ``torch.matmul``, as the
reference leaves them to XLA; grouping needs the experts' row counts on
the host (one device read a call).  On ``meta`` tensors (the dry-run)
there is nothing to read, and the T·k rows go evenly to the experts
(:func:`balanced_counts`): T·k expert FFN rows, the reference oracle's
work.

The expert-parallel path (``moe_ffn_ep``: experts sharded over a mesh,
``all_to_all`` dispatch inside ``shard_map``) is a four-card item still
to port (``ROADMAP.md``); the reference's ``MoeDims.capacity_factor`` and
``dispatch_dtype`` are read only there, so :class:`MoeDims` lacks them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class MoeDims:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int


def router_topk(x: torch.Tensor, w_router: torch.Tensor, dims: MoeDims
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [T, d] → (expert_idx [T, k] int64, combine_w [T, k] in x's
    dtype); ties between probabilities go to the lower expert index."""
    logits = x.float() @ w_router.float()
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :dims.top_k], top_i[:, :dims.top_k]
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return top_i, top_p.to(x.dtype)


def _expert_ffn(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """SwiGLU expert: x [n, d] with one expert's weights [d, f], [f, d]."""
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def balanced_counts(rows: int, n_experts: int) -> list[int]:
    """``rows`` (token, choice) rows spread evenly over ``n_experts``
    (the first ``rows % n_experts`` experts take one more): the route
    of a dry-run, whose ``meta`` router has no values to read."""
    base, extra = divmod(rows, n_experts)
    return [base + (e < extra) for e in range(n_experts)]


def moe_ffn_dense(x: torch.Tensor, w_router: torch.Tensor,
                  w1: torch.Tensor, w3: torch.Tensor, w2: torch.Tensor,
                  dims: MoeDims) -> torch.Tensor:
    """x [T, d] → [T, d]: each token's top-k experts (``w1``/``w3``
    ``[E, d, f]``, ``w2`` ``[E, f, d]``) weighted by the router, each
    expert run once over the rows routed to it."""
    t, d = x.shape
    k = dims.top_k
    idx, cw = router_topk(x, w_router, dims)
    flat = idx.reshape(-1)                    # row r: token r // k
    order = torch.argsort(flat, stable=True)
    if x.is_meta:
        counts = balanced_counts(t * k, dims.n_experts)
    else:
        counts = torch.bincount(flat, minlength=dims.n_experts).tolist()
    xs = x[order // k]                        # rows grouped by expert
    ys = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(counts):
        if n:
            ys[start:start + n] = _expert_ffn(xs[start:start + n], w1[e],
                                              w3[e], w2[e])
        start += n
    y = torch.empty_like(ys)
    y[order] = ys
    y = y.view(t, k, d)
    out = torch.zeros_like(x)
    for j in range(k):
        out = out + cw[:, j:j + 1] * y[:, j]
    return out
