"""Mixture-of-Experts FFN, as ``repro.models.moe`` computes it: on one
device (``moe_ffn_dense``) and expert-parallel over a mesh of ranks
(``moe_ffn_ep``).

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

:func:`moe_ffn_ep` is the reference's expert-parallel path over a mesh
of ``torch.distributed`` ranks (:func:`repro_torch.launch.mesh.make_mesh`):
experts sharded over ``ep_axis`` (``"data"``), each expert's hidden
dimension over ``tp_axis`` (``"model"``).  Each rank routes its own rows
with a capacity of ``max(1, int(k · T_loc · capacity_factor) // E)``
slots an expert (the (token, choice) pairs whose rank within their
expert, in the stable flat order of :func:`_dispatch_indices`, reaches
it are dropped), scatters them into ``[E, C, d]``, exchanges them with
one ``all_to_all_single`` over ``ep_axis``, runs its experts' SwiGLU
slices as batched products, sums the partial products over ``tp_axis``
and sends the results back with a second ``all_to_all_single``.  The
collectives carry their own backward (``torch.autograd.Function``): an
all-to-all's is the same all-to-all of the gradient; the sum over
``tp_axis`` passes the gradient unchanged, and the expert path's input
gradient is summed over ``tp_axis`` (the block's input is replicated
there, each rank holding part of the hidden dimension).  With
``dispatch_dtype="int8"`` both all-to-alls (and their backward) carry
int8 rows with one float32 scale a row (:func:`_make_quantized_a2a`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.launch.mesh import all_to_all, copy_to, reduce_sum


@dataclasses.dataclass(frozen=True)
class MoeDims:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int
    capacity_factor: float = 1.25
    # EP wire format: int8 dispatch/combine quantization halves the
    # all_to_all bytes (per-row symmetric scales ride along)
    dispatch_dtype: str = "native"    # native | int8


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


# ------------------------------------------------- expert parallelism

def _all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t [n, ...]``: block i goes to the i-th rank of ``group`` and
    block i of the result came from it (the identity for no group)."""
    if group is None:
        return t
    return all_to_all(t, group)


class _AllToAll(torch.autograd.Function):
    """:func:`_all_to_all`; its transpose is itself."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _all_to_all(t, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def _quantize_rows(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 rows: ``scale = max(amax, 1e-8) / 127`` (float32,
    one a row of the last axis), ``q = clip(round(t / scale), ±127)``
    (half to even, as ``jnp.round``).  XLA compiles the reference's
    division by 127 as a product with the float32 reciprocal of 127;
    the port computes that product, so the scales agree bit for bit."""
    t32 = t.float()
    scale = torch.clamp(t32.abs().amax(-1, keepdim=True), min=1e-8) \
        * (1.0 / 127.0)
    q = torch.clamp(torch.round(t32 / scale), -127, 127).to(torch.int8)
    return q, scale


def _wire(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` through the int8 wire: quantized rows and their scales
    exchanged, dequantized to ``t``'s dtype."""
    q, scale = _quantize_rows(t)
    q = _all_to_all(q, group)
    scale = _all_to_all(scale, group)
    return (q.float() * scale).to(t.dtype)


class _QuantizedAllToAll(torch.autograd.Function):
    """:func:`_wire` forward, and the gradient through the same wire."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _wire(t, group)

    @staticmethod
    def backward(ctx, g):
        return _wire(g, ctx.group), None


def _make_quantized_a2a(group):
    """int8-on-the-wire all-to-all over ``group`` with per-row scales in
    both directions: the forward quantizes the dispatch payload, the
    backward quantizes the gradient payload the same way (the
    all-to-all's transpose is itself)."""
    return lambda t: _QuantizedAllToAll.apply(t, group)


def _dispatch_indices(idx: torch.Tensor, dims: MoeDims, capacity: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flat (token, choice) → (expert, rank within its expert in the
    stable order of the flat choices, valid: rank < capacity)."""
    t, k = idx.shape
    e_flat = idx.reshape(-1)                       # [T·k]
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    group_start = torch.searchsorted(
        sorted_e, torch.arange(dims.n_experts, device=idx.device,
                               dtype=sorted_e.dtype))
    rank_sorted = torch.arange(t * k, device=idx.device) \
        - group_start[sorted_e]
    rank = torch.empty(t * k, dtype=torch.int32, device=idx.device)
    rank[order] = rank_sorted.to(torch.int32)
    return e_flat, rank, rank < capacity


def moe_ffn_ep(x: torch.Tensor, w_router: torch.Tensor, w1: torch.Tensor,
               w3: torch.Tensor, w2: torch.Tensor, dims: MoeDims, mesh, *,
               ep_axis: str = "data", tp_axis: str = "model",
               batch_axes: tuple[str, ...] = ("pod", "data"),
               reduce: bool = True) -> torch.Tensor:
    """Expert-parallel MoE FFN on this rank of ``mesh`` (a
    :class:`~repro_torch.launch.mesh.CardMesh`), laid out as the
    reference's ``in_specs``: ``x [B_loc, S, d]`` this rank's rows of the
    batch (split over ``batch_axes``, whole over ``tp_axis``),
    ``w_router [d, E]`` whole, ``w1``/``w3 [E_loc, d, f_loc]`` and ``w2
    [E_loc, f_loc, d]`` this rank's experts (``E / |ep_axis|``, at its
    ``ep_axis`` coordinate) and hidden slice (``f / |tp_axis|``).
    Returns this rank's rows ``[B_loc, S, d]`` (the same on every rank
    of ``tp_axis``); with ``reduce=False`` this rank's partial sum of
    them over ``tp_axis`` (the caller sums it there, with the shared
    experts' partial sums; the combine weights then go through
    ``copy_to``, since each rank weighs only its part; the native wire
    only, since the int8 wire quantizes the sum, as the reference's
    does).  Every rank of the mesh calls it together."""
    if not reduce and dims.dispatch_dtype != "native":
        raise ValueError("moe_ffn_ep: reduce=False needs the native wire; "
                         f"the {dims.dispatch_dtype} wire quantizes the "
                         "sum over the tp axis")
    ep = mesh.shape[ep_axis]
    if dims.n_experts % ep:
        raise ValueError(f"moe_ffn_ep: {dims.n_experts} experts do not "
                         f"divide over {ep_axis} of size {ep}")
    e_loc = dims.n_experts // ep
    if w1.shape[0] != e_loc or w2.shape[0] != e_loc:
        raise ValueError(f"moe_ffn_ep: expert slices of {w1.shape[0]} / "
                         f"{w2.shape[0]} experts, this rank holds {e_loc}")
    ep_group = mesh.group(ep_axis)
    tp_group = mesh.group(tp_axis) if tp_axis in mesh.shape else None
    b_loc, s, d = x.shape
    k = dims.top_k
    t_loc = b_loc * s
    xt = x.reshape(t_loc, d)
    idx, cw = router_topk(xt, w_router, dims)
    capacity = max(1, int(dims.top_k * t_loc * dims.capacity_factor)
                   // dims.n_experts)
    e_flat, rank, valid = _dispatch_indices(idx, dims, capacity)

    # scatter the valid (token, choice) rows into the [E, C, d] buffer
    n_slots = dims.n_experts * capacity
    slot = e_flat * capacity + rank
    tok_rep = torch.arange(t_loc, device=x.device).repeat_interleave(k)
    rows = torch.where(valid[:, None], copy_to(xt, tp_group)[tok_rep],
                       0.0)
    buf = xt.new_zeros((n_slots, d)).index_add(
        0, torch.where(valid, slot, n_slots - 1), rows)
    buf = buf.view(ep, e_loc, capacity, d)

    if dims.dispatch_dtype == "int8":
        a2a = _make_quantized_a2a(ep_group)
    elif ep_group is None:
        def a2a(t):
            return t
    else:
        def a2a(t):
            return _AllToAll.apply(t, ep_group)

    recv = a2a(buf)
    # recv: [ep_src, E_loc, C, d] → [E_loc, ep_src·C, d]
    recv = recv.transpose(0, 1).reshape(e_loc, ep * capacity, d)
    # expert FFN on this rank's slice of the hidden dim, summed over tp
    h = F.silu(torch.matmul(recv, w1)) * torch.matmul(recv, w3)
    part = torch.matmul(h, w2)
    if reduce:
        part = reduce_sum(part, tp_group)
    else:
        cw = copy_to(cw, tp_group)

    # route results back to the source ranks
    back = part.view(e_loc, ep, capacity, d).transpose(0, 1).contiguous()
    out_buf = a2a(back).reshape(n_slots, d)

    # combine: gather each (token, choice) result, weight, and sum
    gathered = torch.where(valid[:, None],
                           out_buf[torch.where(valid, slot, 0)], 0.0)
    contrib = gathered.view(t_loc, k, d) * cw[..., None]
    return contrib.sum(dim=1).view(b_loc, s, d)
