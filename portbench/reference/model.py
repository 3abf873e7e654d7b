"""The plain reference: each configuration's forward pass, loss and AdamW
step in float32 PyTorch with TF32 off, from the published descriptions
(Qwen2: GQA with q/k/v biases, RoPE, SwiGLU; DeepSeek-V2: MLA with a
decoupled RoPE head, softmax top-k routing over routed experts plus
shared experts).  It imports nothing of the program and reads the
weights the benchmark made, in the layout ``portbench.weights.layout``
gives; the departures of the port that a configuration file lists are
followed as the file states them (see its ``departures``).

It runs in blocks, so that it fits beside the program's weights: a
layer's weights are cast up one layer at a time, attention runs over
chunks of queries, the routed experts one expert at a time, the head
over chunks of positions.

``fp8`` set is the control: every matrix product's operands rounded to
float8 e4m3, the product then taken in float32, with a scale a row of
activations and a column of weights (``"rowwise"``: fp8 inference, the
serving cells' control) or a scale a tensor (``"tensorwise"``: an fp8
training recipe, the training cells'); in training the gradients that
reach each product are rounded to e5m2 (a scale a tensor) before its
two backward products.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def q8(x: torch.Tensor, dim: int | None,
       fmt: torch.dtype = torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to the float8 format ``fmt`` with one scale per
    slice along ``dim`` (``None``: one for the tensor), amax over the
    format's largest value, back in float32."""
    amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim,
                                                           keepdim=True)
    scale = amax.clamp_min(1e-30) / torch.finfo(fmt).max
    return (x / scale).to(fmt).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with float8 operands: in e4m3 with a scale a row of ``a``
    and a column of ``b`` (``rowwise``, as fp8 inference takes
    activations per token and weights per channel) or one scale a tensor
    (``tensorwise``, as an fp8 training recipe does); in the backward the
    incoming gradient in e5m2 with one scale, both products against the
    rounded operands."""

    @staticmethod
    def forward(ctx, a, b, rowwise):
        aq = q8(a, -1 if rowwise else None)
        bq = q8(b, -2 if rowwise else None)
        ctx.save_for_backward(aq, bq)
        ctx.shapes = (a.shape, b.shape)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = q8(g, None, torch.float8_e5m2)
        ga = (gq @ bq.transpose(-1, -2)).sum_to_size(ctx.shapes[0])
        gb = (aq.transpose(-1, -2) @ gq).sum_to_size(ctx.shapes[1])
        return ga, gb, None


def mm(a: torch.Tensor, b: torch.Tensor, fp8) -> torch.Tensor:
    """``a @ b`` in float32, or with ``fp8`` (``"rowwise"`` or
    ``"tensorwise"``) through :class:`_Fp8Matmul`."""
    if fp8:
        return _Fp8Matmul.apply(a, b, fp8 == "rowwise")
    return a @ b


def rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """``x [B, S, H, D]`` at positions 0 … S−1, the two halves of D
    rotated by angles ``pos · theta^(−i / (D/2))``."""
    s, dim = x.shape[1], x.shape[-1]
    half = dim // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              fp8, chunk: int = 512) -> torch.Tensor:
    """Causal softmax attention, ``q [B, S, H, Dq]``, ``k [B, S, KH,
    Dq]``, ``v [B, S, KH, Dv]`` → ``[B, S, H, Dv]``, scale 1/sqrt(Dq),
    over chunks of ``chunk`` queries against the keys at or before
    them."""
    b, s, h, dq = q.shape
    kh = k.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(dq)
    qh = q.permute(0, 2, 1, 3).reshape(b, kh, g, s, dq)
    kt = k.permute(0, 2, 3, 1)[:, :, None]            # [B, KH, 1, Dq, S]
    vh = v.permute(0, 2, 1, 3)[:, :, None]            # [B, KH, 1, S, Dv]
    outs = []
    for lo in range(0, s, chunk):
        hi = min(s, lo + chunk)
        sc = mm(qh[:, :, :, lo:hi], kt[..., :hi], fp8) * scale
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(hi, device=q.device)[None]
        sc = sc.masked_fill(kpos > qpos, float("-inf"))
        outs.append(mm(torch.softmax(sc, dim=-1), vh[:, :, :, :hi], fp8))
    out = torch.cat(outs, dim=3)                      # [B, KH, G, S, Dv]
    return out.reshape(b, h, s, -1).permute(0, 2, 1, 3)


def swiglu(x: torch.Tensor, w1, w3, w2, fp8) -> torch.Tensor:
    return mm(F.silu(mm(x, w1, fp8)) * mm(x, w3, fp8), w2, fp8)


def _gqa(lw: dict, s: dict, h: torch.Tensor, fp8) -> torch.Tensor:
    b, n, _ = h.shape
    hd = s["hd"]
    q = (mm(h, lw["wq"], fp8) + lw["bq"]).reshape(b, n, s["h"], hd)
    k = (mm(h, lw["wk"], fp8) + lw["bk"]).reshape(b, n, s["kh"], hd)
    v = (mm(h, lw["wv"], fp8) + lw["bv"]).reshape(b, n, s["kh"], hd)
    out = attention(rope(q, s["theta"]), rope(k, s["theta"]), v, fp8)
    return mm(out.reshape(b, n, -1), lw["wo"], fp8)


def _mla(lw: dict, s: dict, h: torch.Tensor, fp8) -> torch.Tensor:
    """Multi-head latent attention: per head a 128-dim key from the
    512-dim latent plus one shared 64-dim RoPE key, values of 128 from
    the latent."""
    b, n, _ = h.shape
    hd, dr, r = s["hd"], s["dr"], s["r"]
    q = mm(h, lw["wq"], fp8).reshape(b, n, s["h"], hd + dr)
    q = torch.cat([q[..., :hd], rope(q[..., hd:], s["theta"])], dim=-1)
    ckv = mm(h, lw["wdkv"], fp8)
    latent = ckv[..., :r]
    k_rope = rope(ckv[:, :, None, r:], s["theta"])
    k_nope = mm(latent, lw["wuk"], fp8).reshape(b, n, s["kh"], hd)
    v = mm(latent, lw["wuv"], fp8).reshape(b, n, s["kh"], s["dv"])
    k = torch.cat([k_nope, k_rope.expand(b, n, s["kh"], dr)], dim=-1)
    out = attention(q, k, v, fp8)
    return mm(out.reshape(b, n, -1), lw["wo"], fp8)


def _moe(lw: dict, s: dict, h: torch.Tensor, fp8) -> torch.Tensor:
    """Softmax over the routed experts, the top k (ties to the lower
    index), renormalized where the file says so; each routed expert over
    its tokens, weighted; the shared experts over every token."""
    shape = h.shape
    x = h.reshape(-1, shape[-1])
    probs = torch.softmax(mm(x, lw["router"], fp8), dim=-1)
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :s["k"]], top_i[:, :s["k"]]
    if s["renorm"]:
        top_p = top_p / top_p.sum(-1, keepdim=True)
    out = swiglu(x, lw["sw1"], lw["sw3"], lw["sw2"], fp8)
    for e in range(s["E"]):
        rows, slot = (top_i == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(x[rows], lw["ew1"][e], lw["ew3"][e], lw["ew2"][e], fp8)
        out = out.index_add(0, rows, y * top_p[rows, slot, None])
    return out.reshape(shape)


def layer(lw: dict, s: dict, x: torch.Tensor, fp8) -> torch.Tensor:
    """One pre-norm decoder layer over ``x [B, S, d]``."""
    attn = _mla if s["mla"] else _gqa
    x = x + attn(lw, s, rms(x, lw["ln1_g"], s["eps"]), fp8)
    h = rms(x, lw["ln2_g"], s["eps"])
    if s["mla"]:
        return x + _moe(lw, s, h, fp8)
    return x + swiglu(h, lw["w1"], lw["w3"], lw["w2"], fp8)


def _layer_weights(w: dict, i: int) -> dict:
    return {k: v[i].float() for k, v in w["layers"].items()}


@torch.no_grad()
def hidden(w: dict, s: dict, tokens: torch.Tensor,
           fp8=None) -> torch.Tensor:
    """The final-normed hidden states ``[S, d]`` of one prompt
    ``tokens [S]``."""
    x = w["embed"][tokens.long()].float()[None]
    for i in range(s["L"]):
        x = layer(_layer_weights(w, i), s, x, fp8)
    return rms(x[0], w["lnf_g"].float(), s["eps"])


def head_weight(w: dict) -> torch.Tensor:
    return (w["head"] if "head" in w else w["embed"].t()).float()


@torch.no_grad()
def last_logits(w: dict, s: dict, tokens: torch.Tensor,
                fp8=None) -> torch.Tensor:
    """The float32 logits ``[V]`` at the last position of a prompt."""
    return mm(hidden(w, s, tokens, fp8)[-1:], head_weight(w), fp8)[0]


# ------------------------------------------------------------ training

def _ce_chunk(x, wh, g, labels, eps, fp8):
    logits = mm(rms(x, g, eps), wh, fp8)
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long(), reduction="sum")


def loss(p: dict, s: dict, tokens: torch.Tensor, labels: torch.Tensor,
         fp8=None, chunk: int = 1024) -> torch.Tensor:
    """Mean next-token cross-entropy of float32 leaves ``p`` (the tree
    of :func:`portbench.weights.layout`) over ``tokens``/``labels``
    ``[B, S]``; each layer and each chunk of positions of the head is
    recomputed in the backward pass."""
    x = p["embed"][tokens.long()]
    for i in range(s["L"]):
        lw = {k: v[i] for k, v in p["layers"].items()}
        x = checkpoint(lambda x, lw: layer(lw, s, x, fp8), x, lw,
                       use_reentrant=False)
    wh = p["head"] if "head" in p else p["embed"].t()
    total = x.new_zeros(())
    n = x.shape[1]
    for lo in range(0, n, chunk):
        total = total + checkpoint(
            _ce_chunk, x[:, lo:lo + chunk], wh, p["lnf_g"],
            labels[:, lo:lo + chunk], s["eps"], fp8, use_reentrant=False)
    return total / labels.numel()


def leaves(tree: dict) -> list:
    """``(name, tensor)`` of a tree's top-level and stacked leaves."""
    out = [(k, tree[k]) for k in sorted(tree) if k != "layers"]
    return out + [(f"layers.{k}", tree["layers"][k])
                  for k in sorted(tree["layers"])]


def learning_rate(opt: dict, t: int) -> float:
    """Linear warm-up over ``warmup_steps``, then a cosine from the peak
    down to a tenth of it at ``total_steps``."""
    warm = max(opt["warmup_steps"], 1)
    frac = min(max((t - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    return opt["lr"] * min(t / warm, 1.0) * (0.55 + 0.45
                                             * math.cos(math.pi * frac))


def adamw(p: dict, grads: dict, m: dict, v: dict, t: int, opt: dict,
          dtype: torch.dtype) -> None:
    """One decoupled AdamW step (bias-corrected moments, weight decay on
    each layer's matrices) of float32 leaves ``p`` in place, each leaf
    then stored in ``dtype`` (the configuration's weight type) and read
    back, as a model whose weights are kept in that type is."""
    b1, b2 = opt["b1"], opt["b2"]
    lr = learning_rate(opt, t)
    for name, x in p.items():
        g = grads[name]
        m[name].mul_(b1).add_(g, alpha=1 - b1)
        v[name].mul_(b2).addcmul_(g, g, value=1 - b2)
        mhat = m[name] / (1 - b1 ** t)
        vhat = v[name] / (1 - b2 ** t)
        step = mhat / (vhat.sqrt() + opt["eps"])
        per_layer = x.dim() - (1 if name.startswith("layers.") else 0)
        if per_layer >= 2:
            step = step + opt["weight_decay"] * x
        x.sub_(lr * step)
        x.copy_(x.to(dtype).float())


def train_steps(w: dict, s: dict, batches, opt: dict, fp8=None,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """The reference's steps from weights ``w`` over ``batches`` (an
    iterable of ``(tokens, labels)``): each step's loss, the first
    step's clipped gradient norm a leaf (``layers.<name>.<i>`` for a
    layer's slice), and each leaf's change after the last step, as
    norms."""
    flat = {name: t.float().clone() for name, t in leaves(w)}
    m = {k: torch.zeros_like(x) for k, x in flat.items()}
    v = {k: torch.zeros_like(x) for k, x in flat.items()}
    first = None
    losses = []
    for t, (tokens, labels) in enumerate(batches, start=1):
        params = {k: x.requires_grad_(True) for k, x in flat.items()}
        tree = {k: x for k, x in params.items() if not k.startswith("layers.")}
        tree["layers"] = {k[7:]: x for k, x in params.items()
                          if k.startswith("layers.")}
        value = loss(tree, s, tokens, labels, fp8)
        grads = dict(zip(params, torch.autograd.grad(value, list(
            params.values()))))
        losses.append(float(value.detach()))
        with torch.no_grad():
            for x in flat.values():
                x.requires_grad_(False)
            norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            scale = torch.clamp(opt["grad_clip"] / norm.clamp_min(1e-12),
                                max=1.0)
            for g in grads.values():
                g.mul_(scale)
            if first is None:
                first = _slice_norms(grads)
            adamw(flat, grads, m, v, t, opt, dtype)
        del grads, params, tree, value
    change = {}
    with torch.no_grad():
        for name, t0 in leaves(w):
            change.update(_slice_norms({name: flat[name] - t0.float()}))
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def _slice_norms(tree: dict) -> dict:
    """Norms of each top-level leaf and of each layer's slice of a
    stacked leaf, named as :func:`portbench.weights.named_leaves`
    names them."""
    out = {}
    for name, x in tree.items():
        if name.startswith("layers."):
            for i in range(x.shape[0]):
                out[f"{name}.{i}"] = float(torch.linalg.vector_norm(
                    x[i].float()))
        else:
            out[name] = float(torch.linalg.vector_norm(x.float()))
    return out
