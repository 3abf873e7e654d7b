"""The decoder-only LMs on PyTorch: parameters, prefill and one decode
step, as ``repro.models.transformer`` computes them for the dense
family (tinyllama, qwen2 with its QKV bias, phi3, deepseek-7b), the
hybrid family (hymba: attention and Mamba/SSD heads in every block,
sliding-window attention over a ring-buffer cache) and the ssm family
(xLSTM: mLSTM and sLSTM blocks, a per-layer recurrent state).

  - ``prefill``: full-sequence forward that also emits the decode state
    (the reference's layout and names: dense ``k``/``v`` ``[L, B, C,
    KH, D]``; hybrid ``k``/``v`` rings ``[L, B, window, KH, D]`` and
    ``mamba``, a :class:`~repro_torch.models.ssm.GlsState` stacked on
    the layer axis; ssm ``layers``, one recurrent state a layer; and
    ``lengths [B]``);
  - ``decode_step``: one token per sequence through the cached state.

Attention goes through the hand-written CUDA kernels behind the
``[B, S, H, D]`` wrappers of :mod:`repro_torch.kernels.ops` (prefill →
``flash_attention``, with hymba's window; decode → ``flash_decode``,
over the ring's valid rows for hymba), or their plain versions on CPU
tensors.  The other products are ``torch.matmul``, as the reference
leaves them to XLA, and the recurrent mixers are the plain PyTorch of
:mod:`repro_torch.models.ssm`.  Layers are a Python loop over the
stacked per-layer tensors (the reference's ``lax.scan``), or over the
list of per-layer dicts for the ssm family, whose layers differ in
kind; there is no mesh, because one card holds the model.

Other families (MoE, MLA, audio, VLM) and tied embeddings raise
``NotImplementedError``: they are still to port (``ROADMAP.md``).

Deliberate difference from the reference: for the dense family,
``decode_step`` writes the cache in place, and a write past the
cache's end raises ``ValueError`` naming the slot, where JAX drops an
out-of-range ``.at[].set`` silently.  Within ``prompt + new tokens <=
cache_len`` the two agree.  A hybrid slot never fills (its ring wraps)
and an ssm slot has no cache, so neither raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import ssm as ssm_lib
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


#: the families the port runs
FAMILIES = ("dense", "hybrid", "ssm")


def check_supported(cfg: ModelConfig) -> None:
    """The port runs the dense, hybrid and ssm families without MoE,
    MLA or tied embeddings."""
    if cfg.family not in FAMILIES or cfg.is_moe or cfg.is_mla \
            or cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: the port's transformer runs the dense, hybrid "
            f"and ssm families (no MoE, MLA or tied embeddings); family "
            f"{cfg.family!r} is still to port (see ROADMAP.md)")


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


def _mamba_params(cfg: ModelConfig) -> dict:
    d, h, hd, ss = cfg.d_model, cfg.n_heads, cfg.hd, cfg.ssm_state
    return {
        **dense("mB", (d, h * ss)),
        **dense("mC", (d, h * ss)),
        **dense("mX", (d, h * hd)),
        **dense("mdt", (d, h)),
        "ma_log": Initializer((h,), zeros_init()),
        "mdt_bias": Initializer((h,), zeros_init()),
        "mnorm_g": Initializer((h * hd,), ones_init()),
        "anorm_g": Initializer((h * hd,), ones_init()),
    }


def init_decoder_layer(cfg: ModelConfig) -> dict:
    p = {**_norm_params(cfg, "ln1"), **_attn_params(cfg),
         **_norm_params(cfg, "ln2")}
    if cfg.d_ff:
        p.update(_ffn_params(cfg))
    if cfg.family == "hybrid":
        p.update(_mamba_params(cfg))
    return p


def init_mlstm_layer(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = d * cfg.proj_factor
    return {
        **_norm_params(cfg, "ln1"),
        **dense("w_up", (d, di)),
        **dense("w_gate", (d, di)),
        **dense("wq", (di, di), fan_in=di),
        **dense("wk", (di, di), fan_in=di),
        **dense("wv", (di, di), fan_in=di),
        **dense("wi", (di, cfg.n_heads), fan_in=di),
        **dense("wf", (di, cfg.n_heads), fan_in=di),
        "hnorm_g": Initializer((di,), ones_init()),
        **dense("w_down", (di, d), fan_in=di),
    }


def init_slstm_layer(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    return {
        **_norm_params(cfg, "ln1"),
        **dense("w_gates", (d, 4 * d)),
        "r_gates": Initializer((4, h, dh, dh), normal_init(0.05)),
        "hnorm_g": Initializer((d,), ones_init()),
        **dense("w_out", (d, d)),
        **dense("w_down", (d, d)),
    }


def init_lm(cfg: ModelConfig) -> dict:
    """The parameter tree as Initializers: the reference's names and
    shapes, per-layer leaves stacked on a leading layer axis (the ssm
    family, whose layers differ in kind: a list of per-layer dicts, as
    the reference keeps it)."""
    check_supported(cfg)
    vp, d = cfg.padded_vocab, cfg.d_model
    tree: dict = {
        "embed": Initializer((vp, d), normal_init(0.02)),
        **_norm_params(cfg, "lnf"),
        **dense("head", (d, vp)),
    }
    if cfg.family == "ssm":
        tree["layers"] = [init_slstm_layer(cfg) if _is_slstm(cfg, i)
                          else init_mlstm_layer(cfg)
                          for i in range(cfg.n_layers)]
    else:
        tree["layers"] = {key: stacked(init, cfg.n_layers)
                          for key, init in init_decoder_layer(cfg).items()}
    return tree


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape, in the tree layout of :func:`init_lm`."""
    def shapes(tree):
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tree.shape
    return shapes(init_lm(cfg))


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters drawn from ``generator`` on ``device`` in
    float32 and cast to ``cfg.dtype`` (so a float32 and a bfloat16
    model from one seed hold the same draws)."""
    return materialize(init_lm(cfg), generator, torch.device(device),
                       cfg.torch_dtype)


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s parameters: its slice of the stacked per-layer
    tensors (views), or its dict of the ssm family's list."""
    layers = params["layers"]
    if isinstance(layers, list):
        return layers[i]
    return {k: v[i] for k, v in layers.items()}


def _is_slstm(cfg: ModelConfig, i: int) -> bool:
    return (cfg.family == "ssm" and cfg.slstm_every > 0
            and (i + 1) % cfg.slstm_every == 0)


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
                    positions: torch.Tensor, *, window: int = 0,
                    return_kv: bool = False):
    """Full-sequence causal attention (prefill), through
    ``flash_attention``; ``window`` > 0 keeps the keys of the last
    ``window`` positions of each query (hymba)."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, cfg, x)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    out = ops.attention_bshd(q, k, v, causal=True, window=window)
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


def _mamba_mix(p: dict, cfg: ModelConfig, x: torch.Tensor,
               state: ssm_lib.GlsState | None = None, *,
               decode: bool = False):
    """Mamba-2/SSD head mix (hybrid): returns (y [B,S,H·hd], new_state)."""
    b = x.shape[0]
    h, hd, ss = cfg.n_heads, cfg.hd, cfg.ssm_state
    s = x.shape[1] if not decode else 1
    xB = (x @ p["mB"]).reshape(b, s, h, ss)
    xC = (x @ p["mC"]).reshape(b, s, h, ss)
    xV = (x @ p["mX"]).reshape(b, s, h, hd)
    dt = F.softplus(x @ p["mdt"] + p["mdt_bias"])
    a = -torch.exp(p["ma_log"].float())                   # [H] (negative)
    log_a = dt.float() * a                                # [B,S,H] ≤ 0
    log_i = torch.log(dt.float().clamp_min(1e-9))
    if decode:
        y, new_state = ssm_lib.gls_decode_step(
            state, xC[:, 0], xB[:, 0], xV[:, 0],
            log_a[:, 0], log_i[:, 0], normalized=False)
        y = y[:, None].to(x.dtype)                        # [B,1,H,hd]
    else:
        y, new_state = ssm_lib.gated_linear_scan(
            xC, xB, xV, log_a, log_i, chunk=cfg.gls_chunk,
            normalized=False, initial=state)
    return y.reshape(b, s, h * hd), new_state


def _fuse_hybrid(p: dict, attn: torch.Tensor,
                 my: torch.Tensor) -> torch.Tensor:
    """Hymba's fusion: per-branch RMS normalization, then the mean."""
    return 0.5 * (rms_norm(attn, p["anorm_g"]) + rms_norm(my, p["mnorm_g"]))


def decoder_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *, return_kv: bool = False,
                  mamba_state=None):
    """One decoder block, full-sequence mode.  Returns (x, extras)."""
    h = _norm(p, "ln1", x, cfg)
    window = cfg.window if cfg.family == "hybrid" else 0
    attn = _attention_full(p, cfg, h, positions, window=window,
                           return_kv=return_kv)
    kv = None
    if return_kv:
        attn, kv = attn
    extras: dict = {"kv": kv}
    if cfg.family == "hybrid":
        # Hymba: parallel attention + mamba heads in the same block;
        # H·hd == d_model, so both branches live in residual space
        my, mstate = _mamba_mix(p, cfg, h, mamba_state)
        extras["mamba_state"] = mstate
        x = x + _fuse_hybrid(p, attn, my)
    else:
        x = x + attn
    if cfg.d_ff:
        x = x + _ffn(p, cfg, _norm(p, "ln2", x, cfg))
    return x, extras


def mlstm_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                state: ssm_lib.GlsState | None = None, *,
                decode: bool = False):
    """xLSTM mLSTM block: up-proj → heads → gated linear scan (matrix
    memory, exponential gating) → head-norm → output gate → down-proj."""
    b, s, _ = x.shape
    h = cfg.n_heads
    di = cfg.d_model * cfg.proj_factor
    dh = di // h
    hidden = _norm(p, "ln1", x, cfg)
    u = hidden @ p["w_up"]
    g = hidden @ p["w_gate"]
    # sqrt(dh) rounded to the model dtype, as the reference divides by it
    root = float(torch.sqrt(torch.tensor(float(dh), dtype=x.dtype)))
    q = (u @ p["wq"]).reshape(b, s, h, dh)
    k = (u @ p["wk"]).reshape(b, s, h, dh) / root
    v = (u @ p["wv"]).reshape(b, s, h, dh)
    log_i = (u @ p["wi"]).float()
    f_pre = (u @ p["wf"]).float()
    log_f = -F.softplus(-f_pre)               # log sigmoid
    if decode:
        y, new_state = ssm_lib.gls_decode_step(
            state, q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], log_i[:, 0],
            normalized=True)
        y = y[:, None].to(x.dtype)
    else:
        y, new_state = ssm_lib.gated_linear_scan(
            q, k, v, log_f, log_i, chunk=cfg.gls_chunk,
            normalized=True, initial=state)
    y = rms_norm(y.reshape(b, s, di), p["hnorm_g"])
    y = y * F.silu(g)
    return x + y @ p["w_down"], new_state


def slstm_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                state: ssm_lib.SlstmState | None = None, *,
                decode: bool = False):
    """xLSTM sLSTM block: true recurrence (block-diagonal R), one step a
    token; exponential gating with stabilizer."""
    b, s, d = x.shape
    hidden = _norm(p, "ln1", x, cfg)
    gates = (hidden @ p["w_gates"]).reshape(b, s, 4, d)
    y, new_state = ssm_lib.slstm_scan(gates, p["r_gates"],
                                      n_heads=cfg.n_heads, initial=state)
    y = rms_norm(y, p["hnorm_g"])
    y = y @ p["w_out"]
    out = F.gelu(y, approximate="tanh") @ p["w_down"]
    return x + out, new_state


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

def state_fills(cfg: ModelConfig) -> bool:
    """Whether a slot's decode state can run out of rows: the dense KV
    cache ends at ``cache_len``; a hybrid ring wraps and an ssm state
    has no rows."""
    return cfg.family == "dense"


def _write_prefix(rows: torch.Tensor, k: torch.Tensor, s: int) -> None:
    """Write a [B,S,KH,D] prefix into one layer's K or V rows
    ``[B, R, KH, D]`` in place, absolute position t at row t % R: the
    dense cache (R >= S) or hymba's ring of R = window rows, which keeps
    the last ``window`` positions (the reference's
    ``_ring_from_prefix``)."""
    r = rows.shape[1]
    if s <= r:
        rows[:, :s] = k
        return
    slots = torch.arange(s - r, s, device=k.device) % r
    rows[:, slots] = k[:, s - r:s]


def prefill(params: dict, cfg: ModelConfig, batch: dict,
            cache_len: int) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also builds the decode state.

    ``batch["tokens"]`` is ``[B, S]``.  Returns (last-position logits
    ``[B, V_padded]``, state) with state ``{"lengths": [B] int32 (= S),
    ...}``: dense ``"k"``/``"v"`` ``[L, B, cache_len, KH, D]``, zeros
    past ``S`` (a prompt longer than ``cache_len`` raises); hybrid
    ``"k"``/``"v"`` rings ``[L, B, window, KH, D]`` holding the last
    ``window`` positions at ``t % window`` and ``"mamba"`` (its
    :class:`GlsState` leaves stacked on the layer axis); ssm
    ``"layers"``, one state a layer.  ``cache_len`` only sizes the dense
    cache.
    """
    check_supported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = params["embed"].device
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    x = embed_tokens(params, cfg, tokens.to(dev))
    state: dict = {"lengths": torch.full((b,), s, dtype=torch.int32,
                                         device=dev)}
    if cfg.family == "ssm":
        states = []
        for i in range(cfg.n_layers):
            block = slstm_block if _is_slstm(cfg, i) else mlstm_block
            x, st = block(layer_params(params, i), cfg, x)
            states.append(st)
        state["layers"] = states
    else:
        hybrid = cfg.family == "hybrid"
        # rows a layer's K/V state holds: the cache, or hymba's ring;
        # position t lives at row t % rows (dense: t, since S <= rows)
        rows = cfg.window if hybrid else cache_len
        if not hybrid and s > cache_len:
            raise ValueError(f"prefill: {s} prompt tokens do not fit a "
                             f"cache of {cache_len}")
        shape = (cfg.n_layers, b, rows, cfg.n_kv_heads, cfg.hd)
        k_cache = torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
        v_cache = torch.zeros(shape, dtype=cfg.torch_dtype, device=dev)
        msts = []
        for i in range(cfg.n_layers):
            x, extras = decoder_block(layer_params(params, i), cfg, x, pos,
                                      return_kv=True)
            k, v = extras["kv"]
            _write_prefix(k_cache[i], k, s)
            _write_prefix(v_cache[i], v, s)
            if hybrid:
                msts.append(extras["mamba_state"])
        state["k"], state["v"] = k_cache, v_cache
        if hybrid:
            state["mamba"] = ssm_lib.GlsState(
                *(torch.stack(leaf) for leaf in zip(*msts)))
    logits = lm_head(params, cfg, x[:, -1:])[:, 0]
    return logits, state


def _decode_attn_dense(p: dict, cfg: ModelConfig, h: torch.Tensor,
                       state_k: torch.Tensor, state_v: torch.Tensor,
                       lengths: torch.Tensor, room: torch.Tensor | None):
    """One-token attention against one layer's cache ``[B, C, KH, D]``;
    writes the new K/V rows at ``lengths`` IN PLACE and returns (out,
    k cache, v cache).  With ``room`` ([B] bool), a row without room
    keeps its cache as it is (its write goes to row C - 1 unchanged).
    A hybrid cache is a ring of ``window`` rows: the row goes to slot
    ``lengths % window`` and attention reads ``min(lengths + 1,
    window)`` rows."""
    b = h.shape[0]
    positions = lengths[:, None]
    q, k, v = _qkv(p, cfg, h)
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    ar = torch.arange(b, device=h.device)
    if cfg.family == "hybrid":                     # ring buffer
        window = state_k.shape[1]
        slot = (lengths % window).long()
        state_k[ar, slot] = k[:, 0]
        state_v[ar, slot] = v[:, 0]
        valid = torch.clamp(lengths + 1, max=window)
        out = ops.decode_bshd(q, state_k, state_v, valid)
        out = out.reshape(b, 1, -1) @ p["wo"]
        return out, state_k, state_v
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
    ``k``/``v`` tensors (and hybrid ``mamba`` leaves), new ``lengths``
    and, for the ssm family, new per-layer states.

    ``live`` ([B] bools on the host; default: every slot) marks the
    slots whose output the caller reads.  For the dense family without
    it, a slot whose cache is full raises ``ValueError`` naming it,
    which reads ``lengths`` back from the device.  With it nothing is
    read back: the caller vouches that live slots have room
    (``ServingEngine`` checks this from the lengths it keeps on the
    host), and a slot outside ``live`` that is past its cache skips its
    K/V write on the device, as the JAX reference drops such writes.
    Hybrid rings and ssm states never fill."""
    check_supported(cfg)
    lengths = state["lengths"]
    new_state = dict(state)
    x = embed_tokens(params, cfg, tokens.to(lengths.device)[:, None])
    if cfg.family == "ssm":
        new_layers = []
        for i, st in enumerate(state["layers"]):
            block = slstm_block if _is_slstm(cfg, i) else mlstm_block
            x, st2 = block(layer_params(params, i), cfg, x, state=st,
                           decode=True)
            new_layers.append(st2)
        new_state["layers"] = new_layers
    else:
        room = None
        if state_fills(cfg):
            cache_len = state["k"].shape[2]
            if live is None:
                full = lengths >= cache_len
                if bool(full.any()):
                    slot = int(torch.nonzero(full)[0, 0])
                    raise ValueError(
                        f"decode_step: slot {slot} holds "
                        f"{int(lengths[slot])} tokens and its cache ends "
                        f"at {cache_len}; the new token has no cache row "
                        "(the JAX reference drops such writes silently)")
            elif not all(live):
                room = lengths < cache_len
        mamba = state.get("mamba")
        for i in range(cfg.n_layers):
            lp = layer_params(params, i)
            h = _norm(lp, "ln1", x, cfg)
            attn, _, _ = _decode_attn_dense(lp, cfg, h, state["k"][i],
                                            state["v"][i], lengths, room)
            if mamba is not None:
                mst = ssm_lib.GlsState(*(leaf[i] for leaf in mamba))
                my, mst2 = _mamba_mix(lp, cfg, h, mst, decode=True)
                for leaf, new in zip(mst, mst2):
                    leaf.copy_(new)
                attn = _fuse_hybrid(lp, attn, my)
            x = x + attn
            x = x + _ffn(lp, cfg, _norm(lp, "ln2", x, cfg))
    new_state["lengths"] = lengths + 1
    logits = lm_head(params, cfg, x)[:, 0]
    return logits, new_state
