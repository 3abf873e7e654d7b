"""The dense decoder-only LM on PyTorch: parameters, prefill and one
decode step, as ``repro.models.transformer`` computes them for the
dense family (tinyllama, qwen2 with its QKV bias, phi3, deepseek-7b).

  - ``prefill``: full-sequence forward that also emits the decode state
    (the KV cache, ``k``/``v`` ``[L, B, C, KH, D]``, and ``lengths
    [B]``, the reference's layout and names);
  - ``decode_step``: one token per sequence through the cached state.

Attention goes through the hand-written CUDA kernels behind the
``[B, S, H, D]`` wrappers of :mod:`repro_torch.kernels.ops` (prefill →
``flash_attention``, decode → ``flash_decode``), or their plain
versions on CPU tensors.  The other products are ``torch.matmul``, as
the reference leaves them to XLA.  Layers are a Python loop over the
stacked per-layer tensors (the reference's ``lax.scan``); there is no
mesh, because one card holds the model.

Other families (MoE, MLA, SSM, hybrid, audio, VLM) raise
``NotImplementedError``: they are still to port (``ROADMAP.md``).

Deliberate difference from the reference: ``decode_step`` writes the
cache in place, and a write past the cache's end raises ``ValueError``
naming the slot, where JAX drops an out-of-range ``.at[].set``
silently.  Within ``prompt + new tokens <= cache_len`` the two agree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope
from repro_torch.models.module import (
    Initializer,
    dense,
    layer_norm,
    materialize,
    normal_init,
    ones_init,
    rms_norm,
    stacked,
    swiglu,
    zeros_init,
)


def check_supported(cfg: ModelConfig) -> None:
    """The port runs the dense family without MoE or MLA."""
    if cfg.family != "dense" or cfg.is_moe or cfg.is_mla \
            or cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: the port's transformer runs the dense family "
            f"(no MoE, MLA or tied embeddings); family {cfg.family!r} is "
            "still to port (see ROADMAP.md)")


# ======================================================================
# parameters
# ======================================================================

def _norm_params(cfg: ModelConfig, name: str) -> dict:
    if cfg.norm == "layernorm":
        return {f"{name}_g": Initializer((cfg.d_model,), ones_init()),
                f"{name}_b": Initializer((cfg.d_model,), zeros_init())}
    return {f"{name}_g": Initializer((cfg.d_model,), ones_init())}


def _attn_params(cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.hd
    h, kh = cfg.n_heads, cfg.n_kv_heads
    p = {}
    p.update(dense("wq", (d, h * hd)))
    p.update(dense("wk", (d, kh * hd)))
    p.update(dense("wv", (d, kh * hd)))
    if cfg.qkv_bias:
        p["bq"] = Initializer((h * hd,), zeros_init())
        p["bk"] = Initializer((kh * hd,), zeros_init())
        p["bv"] = Initializer((kh * hd,), zeros_init())
    p.update(dense("wo", (h * hd, d), fan_in=h * hd))
    return p


def _ffn_params(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {**dense("w1", (d, f)), **dense("w3", (d, f)),
                **dense("w2", (f, d), fan_in=f)}
    return {**dense("w1", (d, f)), **dense("w2", (f, d), fan_in=f)}


def init_decoder_layer(cfg: ModelConfig) -> dict:
    return {**_norm_params(cfg, "ln1"), **_attn_params(cfg),
            **_norm_params(cfg, "ln2"), **_ffn_params(cfg)}


def init_lm(cfg: ModelConfig) -> dict:
    """The parameter tree as Initializers: the reference's names and
    shapes, per-layer leaves stacked on a leading layer axis."""
    check_supported(cfg)
    vp, d = cfg.padded_vocab, cfg.d_model
    tree: dict = {
        "embed": Initializer((vp, d), normal_init(0.02)),
        **_norm_params(cfg, "lnf"),
        **dense("head", (d, vp)),
    }
    tree["layers"] = {key: stacked(init, cfg.n_layers)
                      for key, init in init_decoder_layer(cfg).items()}
    return tree


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape, in the tree layout of :func:`init_lm`."""
    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else v.shape
                for k, v in tree.items()}
    return shapes(init_lm(cfg))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters drawn from ``generator`` on ``device`` in
    float32 and cast to ``cfg.dtype`` (so a float32 and a bfloat16
    model from one seed hold the same draws)."""
    return materialize(init_lm(cfg), generator, torch.device(device),
                       cfg.torch_dtype)


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked per-layer tensors (views)."""
    return {k: v[i] for k, v in params["layers"].items()}


# ======================================================================
# block applications
# ======================================================================

def _norm(p: dict, name: str, x: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layer_norm(x, p[f"{name}_g"], p[f"{name}_b"])
    return rms_norm(x, p[f"{name}_g"])


def _rope(cfg: ModelConfig, x: torch.Tensor,
          positions: torch.Tensor) -> torch.Tensor:
    return apply_rope(x, positions, cfg.rope_theta)


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, _ = x.shape
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (q.reshape(b, s, h, hd), k.reshape(b, s, kh, hd),
            v.reshape(b, s, kh, hd))


def _attention_full(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, return_kv: bool = False):
    """Full-sequence causal attention (prefill), through
    ``flash_attention``."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    out = ops.attention_bshd(q, k, v, causal=True)
    out = out.reshape(b, s, -1) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def _ffn(p: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        h = swiglu(x @ p["w1"], x @ p["w3"])
    else:
        h = F.gelu(x @ p["w1"], approximate="tanh")
    return h @ p["w2"]


def decoder_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, return_kv: bool = False):
    """One decoder block, full-sequence mode.  Returns (x, extras)."""
    h = _norm(p, "ln1", x, cfg)
    attn = _attention_full(p, cfg, h, positions, return_kv=return_kv)
    kv = None
    if return_kv:
        attn, kv = attn
    x = x + attn
    if cfg.d_ff:
        x = x + _ffn(p, cfg, _norm(p, "ln2", x, cfg))
    return x, {"kv": kv}


# ======================================================================
# embedding / head
# ======================================================================

def embed_tokens(params: dict, cfg: ModelConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()].to(cfg.torch_dtype)


def lm_head(params: dict, cfg: ModelConfig,
            x: torch.Tensor) -> torch.Tensor:
    """Full logits ``[B, S, V_padded]`` in the model dtype."""
    return _norm(params, "lnf", x, cfg) @ params["head"]


# ======================================================================
# prefill / decode (serving)
# ======================================================================

def prefill(params: dict, cfg: ModelConfig, batch: dict,
            cache_len: int) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also builds the decode state.

    ``batch["tokens"]`` is ``[B, S]``.  Returns (last-position logits
    ``[B, V_padded]``, state) with state ``{"lengths": [B] int32 (= S),
    "k": [L, B, cache_len, KH, D], "v": same}``, zeros past ``S``.
    """
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    if s > cache_len:
        raise ValueError(f"prefill: {s} prompt tokens do not fit a "
                         f"cache of {cache_len}")
    dev = params["embed"].device
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    x = embed_tokens(params, cfg, tokens.to(dev))
    shape = (cfg.n_layers, b, cache_len, cfg.n_kv_heads, cfg.hd)
    k_cache = torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
    v_cache = torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
    for i in range(cfg.n_layers):
        x, extras = decoder_block(layer_params(params, i), cfg, x, pos,
                                  return_kv=True)
        k, v = extras["kv"]
        k_cache[i, :, :s] = k
        v_cache[i, :, :s] = v
    state = {"lengths": torch.full((b,), s, dtype=torch.int32, device=dev),
             "k": k_cache, "v": v_cache}
    logits = lm_head(params, cfg, x[:, -1:])[:, 0]
    return logits, state


def _decode_attn_dense(p: dict, cfg: ModelConfig, h: torch.Tensor,
                       state_k: torch.Tensor, state_v: torch.Tensor,
                       lengths: torch.Tensor, room: torch.Tensor | None):
    """One-token attention against one layer's cache ``[B, C, KH, D]``;
    writes the new K/V rows at ``lengths`` IN PLACE and returns (out,
    k cache, v cache).  With ``room`` ([B] bool), a row without room
    keeps its cache as it is (its write goes to row C - 1 unchanged)."""
    b = h.shape[0]
    positions = lengths[:, None]
    q, k, v = _qkv(p, cfg, h)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    ar = torch.arange(b, device=h.device)
    if room is None:
        idx = lengths.long()
        state_k[ar, idx] = k[:, 0]
        state_v[ar, idx] = v[:, 0]
    else:
        idx = lengths.long().clamp(max=state_k.shape[1] - 1)
        keep = room[:, None, None]
        state_k[ar, idx] = torch.where(keep, k[:, 0], state_k[ar, idx])
        state_v[ar, idx] = torch.where(keep, v[:, 0], state_v[ar, idx])
    out = ops.decode_bshd(q, state_k, state_v, lengths + 1)
    out = out.reshape(b, 1, -1) @ p["wo"]
    return out, state_k, state_v


def decode_step(params: dict, cfg: ModelConfig, state: dict,
                tokens: torch.Tensor, live=None) -> tuple[torch.Tensor, dict]:
    """One serving step: tokens ``[B]`` → (logits ``[B, V_padded]``,
    state).  The returned state holds the same (updated in place)
    ``k``/``v`` tensors and new ``lengths``.

    ``live`` ([B] bools on the host; default: every slot) marks the
    slots whose output the caller reads.  Without it, a slot whose cache
    is full raises ``ValueError`` naming it, which reads ``lengths``
    back from the device.  With it nothing is read back: the caller
    vouches that live slots have room (``ServingEngine`` checks this
    from the lengths it keeps on the host), and a slot outside ``live``
    that is past its cache skips its K/V write on the device, as the
    JAX reference drops such writes."""
    check_supported(cfg)
    lengths = state["lengths"]
    cache_len = state["k"].shape[2]
    room = None
    if live is None:
        full = lengths >= cache_len
        if bool(full.any()):
            slot = int(torch.nonzero(full)[0, 0])
            raise ValueError(
                f"decode_step: slot {slot} holds {int(lengths[slot])} "
                f"tokens and its cache ends at {cache_len}; the new token "
                "has no cache row (the JAX reference drops such writes "
                "silently)")
    elif not all(live):
        room = lengths < cache_len
    x = embed_tokens(params, cfg, tokens.to(lengths.device)[:, None])
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        h = _norm(lp, "ln1", x, cfg)
        attn, _, _ = _decode_attn_dense(lp, cfg, h, state["k"][i],
                                        state["v"][i], lengths, room)
        x = x + attn
        x = x + _ffn(lp, cfg, _norm(lp, "ln2", x, cfg))
    new_state = dict(state)
    new_state["lengths"] = lengths + 1
    logits = lm_head(params, cfg, x)[:, 0]
    return logits, new_state
