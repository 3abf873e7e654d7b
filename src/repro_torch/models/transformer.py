"""The LM zoo on PyTorch: parameters, prefill and one decode step, as
``repro.models.transformer`` computes them on one device, for every
family of ``configs/``: dense (tinyllama, qwen2 with its QKV bias,
phi3, deepseek-7b); moe (kimi-k2: GQA attention and routed experts;
deepseek-v2-lite: MLA, a latent-compressed KV with a decoupled RoPE
head, and routed plus shared experts); vlm (qwen2-vl: the dense loop
with M-RoPE position grids); audio (whisper: an encoder over frame
embeddings, a decoder with sinusoidal positions and cross-attention);
hybrid (hymba: attention and Mamba/SSD heads in every block,
sliding-window attention over a ring-buffer cache) and ssm (xLSTM:
mLSTM and sLSTM blocks, a per-layer recurrent state).

  - ``prefill``: full-sequence forward that also emits the decode state
    (the reference's layout and names: ``k``/``v`` ``[L, B, C, KH,
    D]``; MLA ``ckv [L, B, C, r]`` and ``krope [L, B, C, 1, dr]``;
    audio adds the cross-attention cache ``xk``/``xv`` ``[L, B, S_enc,
    KH, D]``; hybrid ``k``/``v`` rings ``[L, B, window, KH, D]`` and
    ``mamba``, a :class:`~repro_torch.models.ssm.GlsState` stacked on
    the layer axis; ssm ``layers``, one recurrent state a layer; and
    ``lengths [B]``);
  - ``decode_step``: one token per sequence through the cached state;
  - ``forward_train``: the full-sequence causal forward (no cache)
    feeding the chunked cross-entropy (``chunked_softmax_xent``, never
    ``[B, S, V]`` at once), differentiable: attention's kernel carries
    its own backward kernel (:mod:`repro_torch.kernels.flash_attention`),
    and ``cfg.remat`` checkpoints each layer's activations.

Attention goes through the hand-written CUDA kernels behind the
wrappers of :mod:`repro_torch.kernels.ops` (prefill, the encoder and
cross-attention → ``flash_attention``, with hymba's window and MLA's
192-wide heads; decode → ``flash_decode``, over the ring's valid rows
for hymba and over the encoder's 1500 rows for whisper's cross
attention; MLA's absorbed decode → ``flash_decode_mla``), or their
plain versions on CPU tensors.  The other products are
``torch.matmul``, as the reference leaves them to XLA (the routed
experts of :mod:`repro_torch.models.moe` too), and the recurrent
mixers are the plain PyTorch of :mod:`repro_torch.models.ssm`.  Layers
are a Python loop over the stacked per-layer tensors (the reference's
``lax.scan``), or over the list of per-layer dicts for the ssm family,
whose layers differ in kind.  MoE layers take the reference's
one-device path (``moe_ffn_dense``) unless a :class:`Runtime` with a mesh of ranks is
given (``rt=``): then the reference's rule (``moe_impl="ep"``, or
``"auto"`` on a distributed mesh whose ``"data"`` size divides the
experts) takes ``moe_ffn_ep``, each rank holding its slice of the
expert leaves (``param_specs``; ``repro_torch.convert.shard_lm_params``)
and its rows of the batch, and ``forward_train``'s loss is the global
NLL sum over the global count of valid labels.  ``moe_impl="ep"``
without a mesh raises ``NotImplementedError``.

Tensor parallelism over ``"model"`` (:func:`tp_plan`, one rule for
which leaves are cut; :func:`param_placements`): attention by whole
query heads, its KV heads by blocks (held by a group of ranks where
there are fewer KV heads than ranks), the FFN's and the shared
experts' columns and rows, the embedding's vocab rows and the head's
vocab columns.  A column-parallel product takes ``copy_to(x,
"model")`` and a row-parallel one ends in ``reduce_sum(·, "model")``;
the embedding is a masked lookup plus ``reduce_sum``; ``lm_head``
returns this rank's vocab columns of the logits and
:func:`chunked_softmax_xent` is vocab-parallel (a MAX all-reduce of the
row maximum, a SUM of the exponentials, the target's logit from its
owner), so the loss is the same on every ``"model"`` rank.  Each rank
keeps the cache of its own KV heads (MLA's latent cache whole), or,
under ``cfg.shard_kv_seq`` (:func:`seq_cut`), every KV head of its
slice of the cache's positions: a decode step attends over the slice
with the decode kernels' log-sum-exp and merges the ranks' partial
softmaxes (a MAX and a SUM all-reduce).  The ssm family cuts xLSTM's
mLSTM and sLSTM mixers by heads (each head held by a group of ranks
where there are fewer heads than ranks); the hybrid family cuts hymba's
attention by KV groups and its Mamba heads on their own, in blocks of
whole heads of unequal size where the heads do not divide
(:class:`~repro_torch.launch.mesh.Uneven`; hymba-1.5b's 25 / 5 heads on
2, 4 or 16 ranks: :func:`hybrid_blocks`), and gathers the Mamba output,
which has no projection of its own, over ``"model"`` before the
fusion, so that the fusion's norms stay whole.  The activations take
their cut from the products around them, so the reference's five
``constrain`` markers have no counterpart here; :func:`constrain` is
the gather that brings a block from one cut to another (the engine's
logits, the tests).

Deliberate differences from the reference's specs (``ROADMAP.md``):
where ``n_kv_heads`` does not divide by the ``"model"`` size each rank
holds the KV head its query heads read, a block shared by a group of
ranks (:class:`~repro_torch.launch.mesh.Part`), where the reference
cuts the KV columns evenly, through heads; ``bk``/``bv`` follow their
KV heads where the reference keeps them whole; where ``n_heads`` does
not divide, the attention leaves stay whole; the decode caches are cut
by KV heads where the reference's are whole over ``"model"``; under
``shard_kv_seq`` a capacity that does not divide by the ``"model"``
size raises ``ValueError`` (the reference pads through GSPMD); xLSTM's
``w_up`` is whole on every rank (its ``u`` feeds every head's q, k, v;
the reference cuts its columns), ``wi``/``wf``, ``hnorm_g`` and
``r_gates`` are cut by heads (the reference's are whole), ``w_gates``
by the heads' columns of each gate kind (the reference cuts its
columns evenly, one gate kind a rank at "model" = 4), and the mLSTM
state by heads (the reference cuts ``h``'s Dk axis); hymba's ``wq``,
``wk``/``wv``, ``mB``/``mC`` and ``mX`` are cut by whole heads in blocks
of unequal size, where the reference cuts their columns evenly, through
heads; ``mdt``'s columns, ``ma_log`` and ``mdt_bias`` are cut by Mamba
head, where the reference keeps them whole; and hymba's rings and
Mamba states are cut by heads, where the reference keeps them whole
over ``"model"``.

Deliberate difference from the reference: where a slot's cache ends at
``cache_len`` (dense, moe, vlm and audio; not the encoder's cross
cache, which is written once), ``decode_step`` writes it in place, and
a write past the cache's end raises ``ValueError`` naming the slot,
where JAX drops an out-of-range ``.at[].set`` silently.  Within
``prompt + new tokens <= cache_len`` the two agree.  A hybrid slot
never fills (its ring wraps) and an ssm slot has no cache, so neither
raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.flash_decode import merge_partials
from repro_torch.launch.mesh import (
    Part,
    Placement,
    Strided,
    Uneven,
    all_reduce,
    batch_axes,
    copy_to,
    gather_to,
    mesh_axes,
    reduce_sum,
    spec_placements,
)
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import apply_mrope, apply_rope
from repro_torch.models.module import (
    Initializer,
    abstract_params,
    dense,
    layer_norm,
    materialize,
    normal_init,
    ones_init,
    rms_norm,
    stack_layer_inits,
    swiglu,
    zeros_init,
)


#: the routed experts' specs (without the layer axis): experts over
#: ``"data"`` (expert parallelism), each expert's hidden dim over
#: ``"model"``
EXPERT_SPECS = {"ew1": ("data", None, "model"),
                "ew3": ("data", None, "model"),
                "ew2": ("data", "model", None)}

#: the families whose mixers keep their "model" leaves whole: none
#: since hymba's attention and Mamba heads are cut in blocks of whole
#: heads (:func:`hybrid_blocks`)
WHOLE_FAMILIES = ()
#: leaves by their part of tensor parallelism (names of init_lm)
_Q_LEAVES = frozenset({"wq", "bq", "wo", "xwq", "xbq", "xwo"})
_KV_LEAVES = frozenset({"wk", "wv", "bk", "bv", "xwk", "xwv", "xbk", "xbv",
                        "wuk", "wuv"})
_FFN_LEAVES = frozenset({"w1", "w2", "w3"})
_SHARED_LEAVES = frozenset({"sw1", "sw2", "sw3"})
_VOCAB_LEAVES = frozenset({"embed", "head"})


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution context: mesh presence decides EP vs dense MoE and
    tensor parallelism (the port's mesh:
    :class:`repro_torch.launch.mesh.CardMesh`)."""

    mesh: Any = None

    @property
    def distributed(self) -> bool:
        return self.mesh is not None and self.mesh.size > 1


@dataclasses.dataclass(frozen=True)
class TpPlan:
    """Which leaves a model cuts over ``"model"`` on a mesh whose
    ``"model"`` axis has ``size`` ranks (:func:`tp_plan`), and this
    rank's place on it: ``attn`` (attention by query heads),
    ``kv_parts`` (the KV heads' blocks: ``size``, or fewer, each held by
    ``size // kv_parts`` ranks), ``ffn``, ``shared`` (the shared
    experts), ``vocab`` (embedding rows, head columns), ``mix`` (the
    ssm family's mLSTM and sLSTM mixers by heads) with ``mix_parts``
    (their heads' blocks, each held by ``size // mix_parts`` ranks);
    ``group`` the ``"model"`` process group (``None``: nothing to
    exchange) and ``coord`` this rank's coordinate on it.  The hybrid
    family's cut is by blocks of whole heads, one ``(start, stop)`` a
    coordinate (:func:`hybrid_blocks`): ``q_blocks`` and ``kv_blocks``
    (its attention, where ``attn``) and ``mamba_blocks`` (its Mamba
    heads; empty: whole)."""

    size: int = 1
    attn: bool = False
    kv_parts: int = 1
    ffn: bool = False
    shared: bool = False
    vocab: bool = False
    mix: bool = False
    mix_parts: int = 1
    group: Any = None
    coord: int = 0
    q_blocks: tuple = ()
    kv_blocks: tuple = ()
    mamba_blocks: tuple = ()

    def over(self, cut: bool):
        """The ``"model"`` group where ``cut``, else ``None``."""
        return self.group if cut else None

    def kv_heads(self, cfg: ModelConfig) -> int:
        """This rank's KV heads (MLA's ``wuk``/``wuv`` heads)."""
        if not self.attn:
            return cfg.n_kv_heads
        if self.kv_blocks:
            a, b = self.kv_blocks[self.coord]
            return b - a
        return cfg.n_kv_heads // self.kv_parts

    def kv_entry(self, width: int = 1):
        """The spec entry of a KV-head axis of ``width`` elements a head:
        ``"model"``, a :class:`~repro_torch.launch.mesh.Part` where fewer
        blocks than ranks, the hybrid family's
        :class:`~repro_torch.launch.mesh.Uneven` blocks, or ``None``
        (whole) where attention is not cut."""
        if not self.attn:
            return None
        if self.kv_blocks:
            return Uneven("model", self.kv_blocks).scaled(width)
        return "model" if self.kv_parts == self.size \
            else Part("model", self.kv_parts)

    def q_entry(self, width: int):
        """The hybrid family's entry of a query-head axis of ``width``
        elements a head (its :class:`~repro_torch.launch.mesh.Uneven`
        blocks), or ``None`` (whole)."""
        if not self.attn or not self.q_blocks:
            return None
        return Uneven("model", self.q_blocks).scaled(width)

    def mamba_entry(self, width: int = 1):
        """The entry of a Mamba-head axis of ``width`` elements a head,
        or ``None`` (whole)."""
        if not self.mamba_blocks:
            return None
        return Uneven("model", self.mamba_blocks).scaled(width)

    def mix_entry(self):
        """The spec entry of the xLSTM mixers' head axis: ``"model"``,
        a :class:`~repro_torch.launch.mesh.Part` where fewer blocks than
        ranks, or ``None`` (whole)."""
        if not self.mix:
            return None
        return "model" if self.mix_parts == self.size \
            else Part("model", self.mix_parts)

    def mix_heads(self, cfg: ModelConfig) -> int:
        """This rank's heads of the xLSTM mixers."""
        return cfg.n_heads // self.mix_parts

    @property
    def mix_rep(self) -> int:
        """Ranks that hold one block of the mixers' heads."""
        return self.size // self.mix_parts if self.mix else 1


def _even_blocks(n: int, m: int) -> tuple:
    """``m`` consecutive blocks of ``n`` items (``m <= n``) as ``(start,
    stop)``, their sizes differing by at most one, the first ones the
    larger."""
    q, r = divmod(n, m)
    out, start = [], 0
    for c in range(m):
        stop = start + q + (c < r)
        out.append((start, stop))
        start = stop
    return tuple(out)


def head_blocks(n: int, m: int) -> tuple:
    """Each of ``m`` ranks' ``(start, stop)`` of ``n`` whole heads: as
    even as whole heads allow (the first ranks hold one more), or, where
    ``m > n``, each head held by a run of consecutive ranks (the runs'
    lengths differing by at most one, the first ones the longer)."""
    if m <= n:
        return _even_blocks(n, m)
    return tuple((j, j + 1) for j, (a, b) in enumerate(_even_blocks(m, n))
                 for _ in range(b - a))


def hybrid_blocks(n_heads: int, n_kv_heads: int, m: int):
    """The hybrid family's attention over ``m`` ranks by KV groups (each
    KV head with its ``g = n_heads / n_kv_heads`` query heads): ``(query
    blocks, KV blocks)``, one ``(start, stop)`` of heads a rank.  Where
    ``m <= n_kv_heads`` each rank holds whole KV groups
    (:func:`head_blocks`); else the ranks form ``n_kv_heads`` runs, each
    holding one KV head and cutting its ``g`` query heads among its
    ranks as evenly as whole heads allow; ``None`` (attention whole)
    where a run would have more ranks than ``g``."""
    g = n_heads // n_kv_heads
    if m <= n_kv_heads:
        kv = head_blocks(n_kv_heads, m)
        return tuple((a * g, b * g) for a, b in kv), kv
    runs = _even_blocks(m, n_kv_heads)
    if max(b - a for a, b in runs) > g:
        return None
    q, kv = [], []
    for j, (a, b) in enumerate(runs):
        for qa, qb in _even_blocks(g, b - a):
            q.append((j * g + qa, j * g + qb))
            kv.append((j, j + 1))
    return tuple(q), tuple(kv)


def tp_plan(cfg: ModelConfig, rt: "Runtime | None" = None) -> TpPlan:
    """The rule of tensor parallelism over ``rt``'s ``"model"`` axis
    (none without a mesh): attention is cut by whole query heads where
    ``n_heads`` divides by its size and the KV heads line up (each
    rank's KV heads, or the one KV head its query heads read where
    ``n_kv_heads`` is a divisor of the size), else whole; the dense
    FFN, the shared experts and the padded vocab where their widths
    divide.  The ssm family's mixers are cut by heads where ``n_heads``
    and the size divide one another (even blocks, or each head held by
    a group of ranks) and ``d_model`` divides by the size (sLSTM's
    ``w_out`` columns).  The hybrid family cuts its attention by KV
    groups and its Mamba heads on their own, in blocks of whole heads
    of unequal size where the heads do not divide
    (:func:`hybrid_blocks`, :func:`head_blocks`)."""
    mesh = rt.mesh if rt is not None else None
    if mesh is None or "model" not in mesh.shape:
        return TpPlan()
    m = mesh.shape["model"]
    h, kh = cfg.n_heads, cfg.n_kv_heads
    fs = cfg.n_shared_experts * cfg.d_ff_expert
    common = dict(
        size=m, ffn=bool(cfg.d_ff) and not cfg.is_moe and cfg.d_ff % m == 0,
        shared=fs > 0 and fs % m == 0, vocab=cfg.padded_vocab % m == 0,
        group=mesh.group("model"), coord=mesh.coord("model"))
    if cfg.family == "hybrid":
        cut = hybrid_blocks(h, kh, m)
        q, kv = cut or ((), ())
        return TpPlan(attn=cut is not None, q_blocks=q, kv_blocks=kv,
                      mamba_blocks=head_blocks(h, m), **common)
    attn = (cfg.family not in WHOLE_FAMILIES + ("ssm",) and h % m == 0
            and (kh % m == 0 or m % kh == 0))
    mix = (cfg.family == "ssm" and (h % m == 0 or m % h == 0)
           and cfg.d_model % m == 0)
    return TpPlan(
        attn=attn, kv_parts=(m if kh % m == 0 else kh) if attn else 1,
        mix=mix, mix_parts=(m if h % m == 0 else h) if mix else 1, **common)


def seq_cut(cfg: ModelConfig, rt: "Runtime | None") -> tuple[int, int] | None:
    """``(ranks, this rank's coordinate)`` of ``"model"`` where
    ``cfg.shard_kv_seq`` cuts the self-attention cache by sequence over
    it (rank ``r`` holds positions ``[r·C/m, (r+1)·C/m)`` of every KV
    head), else ``None``: no mesh, or a family whose state is no such
    cache (hymba's rings and the ssm states keep their cut)."""
    mesh = rt.mesh if rt is not None else None
    if (not cfg.shard_kv_seq or cfg.family in ("hybrid", "ssm")
            or mesh is None or "model" not in mesh.shape):
        return None
    return mesh.shape["model"], mesh.coord("model")


def constrain(x: torch.Tensor, rt: "Runtime | None", *spec,
              have: tuple) -> torch.Tensor:
    """``x``, this rank's block of a tensor cut as ``have``, brought to
    the cut of ``spec`` (one entry a tensor axis, as the reference's
    ``PartitionSpec``; axes the mesh lacks are dropped): gathered over
    the axes that ``spec`` drops (a collective without a backward) and
    cut to this rank's block where ``spec`` adds one.  Off a
    distributed mesh it returns ``x``, as the reference does."""
    if rt is None or not rt.distributed:
        return x
    mesh = rt.mesh

    def filt(entry):
        kept = tuple(a for a in mesh_axes(entry) if a in mesh.shape)
        return kept or None

    want = [filt(e) for e in spec]
    now = [filt(e) for e in have]
    for i in range(x.dim()):
        a = now[i] if i < len(now) else None
        b = want[i] if i < len(want) else None
        if a == b:
            continue
        cut = [None] * x.dim()
        if a is not None:
            cut[i] = a
            x = Placement(mesh, tuple(cut)).gather(x)
        if b is not None:
            cut[i] = b
            x = Placement(mesh, tuple(cut)).shard(x)
    return x


def uses_ep(cfg: ModelConfig, rt: Runtime | None) -> bool:
    """Whether the MoE layers take ``moe_ffn_ep`` (the reference's rule):
    ``moe_impl="ep"``, or ``"auto"`` on a distributed mesh whose
    ``"data"`` size divides the experts."""
    if not cfg.is_moe:
        return False
    rt = rt or Runtime()
    return (cfg.moe_impl == "ep"
            or (cfg.moe_impl == "auto" and rt.distributed
                and "data" in rt.mesh.shape
                and cfg.n_experts % rt.mesh.shape["data"] == 0))


def check_supported(cfg: ModelConfig, rt: Runtime | None = None) -> None:
    """The expert-parallel MoE path (``moe_impl="ep"``) needs a mesh of
    ranks: ``Runtime(make_mesh(...))`` (ROADMAP.md, Queue 1 item 5)."""
    if cfg.is_moe and cfg.moe_impl == "ep" and (rt is None
                                                or rt.mesh is None):
        raise NotImplementedError(
            f"{cfg.name}: moe_impl='ep' shards the experts over a mesh "
            "of ranks; pass rt=Runtime(make_mesh(...)) (see ROADMAP.md), "
            "or 'auto' / 'dense' to run them on one card")


# ======================================================================
# parameters
# ======================================================================

def _norm_params(cfg: ModelConfig, name: str) -> dict:
    if cfg.norm == "layernorm":
        return {f"{name}_g": Initializer((cfg.d_model,), ones_init(),
                                         (None,)),
                f"{name}_b": Initializer((cfg.d_model,), zeros_init(),
                                         (None,))}
    return {f"{name}_g": Initializer((cfg.d_model,), ones_init(), (None,))}


def _attn_params(cfg: ModelConfig, *, cross: bool = False) -> dict:
    """Self-attention (MLA's latent projections where the config has a
    KV rank), or with ``cross`` whisper's cross-attention (``x``
    prefix)."""
    d, hd = cfg.d_model, cfg.hd
    h, kh = cfg.n_heads, cfg.n_kv_heads
    kv_spec = (None, "model") if (kh * hd) % 16 == 0 else (None, None)
    pre = "x" if cross else ""
    p = {}
    if cfg.is_mla and not cross:
        r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
        p.update(dense("wq", (d, h * (hd + dr)), (None, "model")))
        p.update(dense("wdkv", (d, r + dr), (None, None)))
        p.update(dense("wuk", (r, kh * hd), (None, "model"), fan_in=r))
        p.update(dense("wuv", (r, kh * hd), (None, "model"), fan_in=r))
    else:
        p.update(dense(f"{pre}wq", (d, h * hd), (None, "model")))
        p.update(dense(f"{pre}wk", (d, kh * hd), kv_spec))
        p.update(dense(f"{pre}wv", (d, kh * hd), kv_spec))
        if cfg.qkv_bias:
            p[f"{pre}bq"] = Initializer((h * hd,), zeros_init(), ("model",))
            p[f"{pre}bk"] = Initializer((kh * hd,), zeros_init(), (None,))
            p[f"{pre}bv"] = Initializer((kh * hd,), zeros_init(), (None,))
    p.update(dense(f"{pre}wo", (h * hd, d), ("model", None), fan_in=h * hd))
    return p


def _ffn_params(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {**dense("w1", (d, f), (None, "model")),
                **dense("w3", (d, f), (None, "model")),
                **dense("w2", (f, d), ("model", None), fan_in=f)}
    return {**dense("w1", (d, f), (None, "model")),
            **dense("w2", (f, d), ("model", None), fan_in=f)}


def _moe_params(cfg: ModelConfig) -> dict:
    d, fe, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    p = {"router": Initializer((d, e), normal_init(0.02), (None, None))}
    p.update(dense("ew1", (e, d, fe), EXPERT_SPECS["ew1"], fan_in=d))
    p.update(dense("ew3", (e, d, fe), EXPERT_SPECS["ew3"], fan_in=d))
    p.update(dense("ew2", (e, fe, d), EXPERT_SPECS["ew2"], fan_in=fe))
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * fe
        p.update(dense("sw1", (d, fs), (None, "model")))
        p.update(dense("sw3", (d, fs), (None, "model")))
        p.update(dense("sw2", (fs, d), ("model", None), fan_in=fs))
    return p


def _mamba_params(cfg: ModelConfig) -> dict:
    d, h, hd, ss = cfg.d_model, cfg.n_heads, cfg.hd, cfg.ssm_state
    bc_spec = (None, "model") if (h * ss) % 16 == 0 else (None, None)
    return {
        **dense("mB", (d, h * ss), bc_spec),
        **dense("mC", (d, h * ss), bc_spec),
        **dense("mX", (d, h * hd), (None, "model")),
        **dense("mdt", (d, h), (None, None)),
        "ma_log": Initializer((h,), zeros_init(), (None,)),
        "mdt_bias": Initializer((h,), zeros_init(), (None,)),
        "mnorm_g": Initializer((h * hd,), ones_init(), (None,)),
        "anorm_g": Initializer((h * hd,), ones_init(), (None,)),
    }


def init_decoder_layer(cfg: ModelConfig) -> dict:
    p = {**_norm_params(cfg, "ln1"), **_attn_params(cfg),
         **_norm_params(cfg, "ln2")}
    if cfg.family == "audio":       # decoder layer: + cross attention
        p.update(_norm_params(cfg, "lnx"))
        p.update(_attn_params(cfg, cross=True))
    if cfg.is_moe:
        p.update(_moe_params(cfg))
    elif cfg.d_ff:
        p.update(_ffn_params(cfg))
    if cfg.family == "hybrid":
        p.update(_mamba_params(cfg))
    return p


def init_encoder_layer(cfg: ModelConfig) -> dict:
    return {**_norm_params(cfg, "ln1"), **_attn_params(cfg),
            **_norm_params(cfg, "ln2"), **_ffn_params(cfg)}


def init_mlstm_layer(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = d * cfg.proj_factor
    return {
        **_norm_params(cfg, "ln1"),
        **dense("w_up", (d, di), (None, "model")),
        **dense("w_gate", (d, di), (None, "model")),
        **dense("wq", (di, di), (None, "model"), fan_in=di),
        **dense("wk", (di, di), (None, "model"), fan_in=di),
        **dense("wv", (di, di), (None, "model"), fan_in=di),
        **dense("wi", (di, cfg.n_heads), (None, None), fan_in=di),
        **dense("wf", (di, cfg.n_heads), (None, None), fan_in=di),
        "hnorm_g": Initializer((di,), ones_init(), (None,)),
        **dense("w_down", (di, d), ("model", None), fan_in=di),
    }


def init_slstm_layer(cfg: ModelConfig) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    return {
        **_norm_params(cfg, "ln1"),
        **dense("w_gates", (d, 4 * d), (None, "model")),
        "r_gates": Initializer((4, h, dh, dh), normal_init(0.05),
                               (None, None, None, None)),
        "hnorm_g": Initializer((d,), ones_init(), (None,)),
        **dense("w_out", (d, d), (None, "model")),
        **dense("w_down", (d, d), ("model", None)),
    }


def init_lm(cfg: ModelConfig) -> dict:
    """The parameter tree as Initializers: the reference's names and
    shapes, per-layer leaves stacked on a leading layer axis (the ssm
    family, whose layers differ in kind: a list of per-layer dicts, as
    the reference keeps it)."""
    vp, d = cfg.padded_vocab, cfg.d_model
    tree: dict = {
        "embed": Initializer((vp, d), normal_init(0.02), ("model", None)),
        **_norm_params(cfg, "lnf"),
    }
    if not cfg.tie_embeddings:
        tree.update(dense("head", (d, vp), (None, "model")))
    if cfg.family == "ssm":
        tree["layers"] = [init_slstm_layer(cfg) if _is_slstm(cfg, i)
                          else init_mlstm_layer(cfg)
                          for i in range(cfg.n_layers)]
    else:
        tree["layers"] = stack_layer_inits(lambda: init_decoder_layer(cfg),
                                           cfg.n_layers)
    if cfg.family == "audio":
        tree["enc_layers"] = stack_layer_inits(
            lambda: init_encoder_layer(cfg), cfg.n_encoder_layers)
        tree.update(_norm_params(cfg, "enc_lnf"))
    return tree


def abstract(cfg: ModelConfig) -> dict:
    """The parameter tree as ``meta`` stand-ins in ``cfg.dtype`` (the
    dry-run's parameters): nothing allocated."""
    return abstract_params(init_lm(cfg), cfg.torch_dtype)


def param_shapes(cfg: ModelConfig) -> dict:
    """Every parameter's shape, in the tree layout of :func:`init_lm`."""
    def shapes(tree):
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return tree.shape
    return shapes(init_lm(cfg))


def param_specs(cfg: ModelConfig) -> dict:
    """Every parameter's partition spec (the reference's
    ``init_params(...)[1]``, each ``P`` as a tuple), in the tree layout
    of :func:`init_lm`."""
    def specs(tree):
        if isinstance(tree, list):
            return [specs(v) for v in tree]
        if isinstance(tree, dict):
            return {k: specs(v) for k, v in tree.items()}
        return tree.spec
    return specs(init_lm(cfg))


def _tp_spec(name: str, spec: tuple, plan: TpPlan, ep: bool) -> tuple:
    """The port's spec of one leaf from the reference's: its
    ``"model"`` entry kept where ``plan`` cuts the leaf's part (a KV
    leaf's head axis, its last, as ``"model"`` or a
    :class:`~repro_torch.launch.mesh.Part` of ``plan.kv_parts``
    blocks), its ``"data"`` entry where the experts are expert-parallel
    (``ep``); every other entry whole."""
    if name in EXPERT_SPECS:
        keep = ep
    elif name in _Q_LEAVES or name in _KV_LEAVES:
        keep = plan.attn
    elif name in _FFN_LEAVES:
        keep = plan.ffn
    elif name in _SHARED_LEAVES:
        keep = plan.shared
    elif name in _VOCAB_LEAVES:
        keep = plan.vocab
    else:
        keep = False
    if not keep:
        return (None,) * len(spec)
    if name in _KV_LEAVES:
        return (None,) * (len(spec) - 1) + (plan.kv_entry(),)
    return tuple(spec)


def _ssm_spec(name: str, spec: tuple, plan: TpPlan, slstm: bool) -> tuple:
    """The port's spec of one leaf of an xLSTM block where
    :func:`tp_plan` cuts its mixer by heads (entry ``e``): mLSTM's
    ``w_gate``, ``wq``/``wk``/``wv`` and ``wi``/``wf`` by their heads'
    columns, ``hnorm_g`` by its heads' dims and ``w_down`` by their rows,
    ``w_up`` whole (its ``u`` feeds every head); sLSTM's ``w_gates`` by
    its heads' columns of each of the four gate kinds
    (:class:`~repro_torch.launch.mesh.Strided`), ``r_gates`` and
    ``hnorm_g`` by heads, ``w_out``'s columns and ``w_down``'s rows
    evenly over ``"model"`` (the reference's); the norms whole."""
    e = plan.mix_entry()
    whole = (None,) * len(spec)
    if e is None:
        return whole
    if slstm:
        table = {"w_gates": (None, Strided(4, e)),
                 "r_gates": (None, e, None, None), "hnorm_g": (e,),
                 "w_out": (None, "model"), "w_down": ("model", None)}
    else:
        table = {"w_gate": (None, e), "wq": (None, e), "wk": (None, e),
                 "wv": (None, e), "wi": (None, e), "wf": (None, e),
                 "hnorm_g": (e,), "w_down": (e, None)}
    return table.get(name, whole)


def _hybrid_spec(name: str, spec: tuple, plan: TpPlan,
                 cfg: ModelConfig) -> tuple | None:
    """The port's spec of one of hymba's mixer leaves (stacked on the
    layer axis), cut by blocks of whole heads
    (:class:`~repro_torch.launch.mesh.Uneven`): ``wq``'s columns and
    ``wo``'s rows by query heads, ``wk``/``wv``'s columns by KV heads
    (where :func:`tp_plan` cuts attention); ``mX``'s columns by the
    Mamba heads' ``hd``, ``mB``/``mC``'s by their ``ssm_state``,
    ``mdt``'s columns, ``ma_log`` and ``mdt_bias`` by head.  ``None``
    for any other leaf (the norms' gains stay whole)."""
    hd, ss = cfg.hd, cfg.ssm_state
    table = {"wq": (-1, plan.q_entry(hd)), "wo": (-2, plan.q_entry(hd)),
             "wk": (-1, plan.kv_entry(hd)), "wv": (-1, plan.kv_entry(hd)),
             "mX": (-1, plan.mamba_entry(hd)),
             "mB": (-1, plan.mamba_entry(ss)),
             "mC": (-1, plan.mamba_entry(ss)),
             "mdt": (-1, plan.mamba_entry()),
             "ma_log": (-1, plan.mamba_entry()),
             "mdt_bias": (-1, plan.mamba_entry())}
    if name not in table:
        return None
    axis, entry = table[name]
    out = [None] * len(spec)
    out[axis] = entry
    return tuple(out)


def tp_specs(cfg: ModelConfig, rt: Runtime) -> dict:
    """Every parameter's spec on ``rt``'s mesh (:func:`tp_plan`, the
    routed experts by :func:`uses_ep`), in the tree layout of
    :func:`init_lm`."""
    plan, ep = tp_plan(cfg, rt), uses_ep(cfg, rt)
    hybrid = cfg.family == "hybrid"

    def walk(tree, name=None, slstm=None):
        if isinstance(tree, list):          # the ssm family's blocks
            return [walk(v, slstm="w_gates" in v) for v in tree]
        if isinstance(tree, dict):
            return {k: walk(v, k, slstm) for k, v in tree.items()}
        if slstm is not None:
            return _ssm_spec(name, tree.spec, plan, slstm)
        if hybrid:
            spec = _hybrid_spec(name, tree.spec, plan, cfg)
            if spec is not None:
                return spec
        return _tp_spec(name, tree.spec, plan, ep)
    return walk(init_lm(cfg))


def param_placements(cfg: ModelConfig, rt: Runtime) -> dict:
    """Each parameter leaf's :class:`~repro_torch.launch.mesh.Placement`
    on ``rt``'s mesh (:func:`tp_specs`)."""
    return spec_placements(tp_specs(cfg, rt), rt.mesh)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> dict:
    """Random parameters drawn from ``generator`` on ``device`` in
    float32 and cast to ``cfg.dtype`` (so a float32 and a bfloat16
    model from one seed hold the same draws)."""
    return materialize(init_lm(cfg), generator, torch.device(device),
                       cfg.torch_dtype)


def layer_params(params: dict, i: int, key: str = "layers") -> dict:
    """Layer ``i``'s parameters: its slice of the stacked per-layer
    tensors (views; ``key="enc_layers"``: whisper's encoder), or its
    dict of the ssm family's list."""
    layers = params[key]
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
    if cfg.family == "audio":
        return x                     # whisper: sinusoidal at embedding
    if cfg.mrope_sections:
        return apply_mrope(x, positions, cfg.mrope_sections, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


def _qkv(p: dict, cfg: ModelConfig, x: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Q, K, V ``[B, S, heads, hd]`` of the heads whose columns ``p``
    holds (this rank's under tensor parallelism)."""
    b, s, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return (q.reshape(b, s, -1, hd), k.reshape(b, s, -1, hd),
            v.reshape(b, s, -1, hd))


def _mla_qkv(p: dict, cfg: ModelConfig, x: torch.Tensor,
             positions: torch.Tensor, group=None):
    """MLA (DeepSeek-V2): latent-compressed KV + decoupled RoPE head.
    Returns (q_nope [B,S,H,hd], q_rope [B,S,H,dr], c_kv [B,S,r], k_rope
    [B,S,1,dr]) for the heads whose columns ``p`` holds; the queries
    take ``copy_to(x, group)``, the latent (whole on every rank) ``x``
    as it is."""
    b, s, _ = x.shape
    hd = cfg.hd
    r = cfg.kv_lora_rank
    q = (copy_to(x, group) @ p["wq"]).reshape(b, s, -1,
                                              hd + cfg.rope_head_dim)
    q_nope, q_rope = q[..., :hd], _rope(cfg, q[..., hd:], positions)
    ckv_full = x @ p["wdkv"]
    c_kv = ckv_full[..., :r]
    k_rope = _rope(cfg, ckv_full[:, :, None, r:], positions)  # one head
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand_kv(p: dict, cfg: ModelConfig, c_kv: torch.Tensor):
    b, s, _ = c_kv.shape
    hd = cfg.hd
    return ((c_kv @ p["wuk"]).reshape(b, s, -1, hd),
            (c_kv @ p["wuv"]).reshape(b, s, -1, hd))


def _attention_full(p: dict, cfg: ModelConfig, x: torch.Tensor,
                    positions: torch.Tensor, *, causal: bool = True,
                    window: int = 0, return_kv: bool = False,
                    group=None):
    """Full-sequence attention (prefill, whisper's encoder with
    ``causal=False``), through ``flash_attention``; ``window`` > 0 keeps
    the keys of the last ``window`` positions of each query (hymba).
    MLA folds the decoupled RoPE head into an extended head of hd + dr
    (its 1/sqrt(hd + dr) scale is MLA's definition), with V zero-padded
    to it and the output cut back to hd, as the reference does; its
    ``kv`` is the latent cache's (c_kv, k_rope).  ``group``: the
    ``"model"`` group whose ranks each hold their heads' columns (the
    input goes through ``copy_to``, the output through ``reduce_sum``;
    MLA's whole latent through ``copy_to`` before its heads use it)."""
    b, s, _ = x.shape
    if cfg.is_mla:
        q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, x, positions,
                                                group)
        k_nope, v = _mla_expand_kv(p, cfg, copy_to(c_kv, group))
        dr = cfg.rope_head_dim
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, copy_to(k_rope, group).expand(
            b, s, k_nope.shape[2], dr)], dim=-1)
        v_pad = F.pad(v, (0, dr))
        out = ops.attention_bshd(q, k, v_pad, causal=causal,
                                 window=window)[..., :cfg.hd]
        kv = (c_kv, k_rope)
    else:
        q, k, v = _qkv(p, cfg, copy_to(x, group))
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
        out = ops.attention_bshd(q, k, v, causal=causal, window=window)
        kv = (k, v)
    out = reduce_sum(out.reshape(b, s, -1) @ p["wo"], group)
    if return_kv:
        return out, kv
    return out


def _attention_cross(p: dict, cfg: ModelConfig, x: torch.Tensor,
                     k: torch.Tensor, v: torch.Tensor,
                     group=None) -> torch.Tensor:
    """Whisper's cross-attention of the decoder's positions over the
    encoder's (non-causal, Sq != Sk); ``group`` as in
    :func:`_attention_full`."""
    b, s, _ = x.shape
    q = (copy_to(x, group) @ p["xwq"]).reshape(b, s, -1, cfg.hd)
    out = ops.attention_bshd(q, k, v, causal=False)
    return reduce_sum(out.reshape(b, s, -1) @ p["xwo"], group)


def _cross_kv(p: dict, cfg: ModelConfig, enc_out: torch.Tensor,
              group=None):
    b, s, _ = enc_out.shape
    hd = cfg.hd
    enc_out = copy_to(enc_out, group)
    return ((enc_out @ p["xwk"]).reshape(b, s, -1, hd),
            (enc_out @ p["xwv"]).reshape(b, s, -1, hd))


def _ffn(p: dict, cfg: ModelConfig, x: torch.Tensor,
         group=None) -> torch.Tensor:
    """The dense FFN; ``group``: the ``"model"`` group whose ranks each
    hold their columns of ``w1``/``w3`` and rows of ``w2``."""
    x = copy_to(x, group)
    if cfg.act == "swiglu":
        h = swiglu(x @ p["w1"], x @ p["w3"])
    else:
        h = F.gelu(x @ p["w1"], approximate="tanh")
    return reduce_sum(h @ p["w2"], group)


def _moe_ffn(p: dict, cfg: ModelConfig, x: torch.Tensor,
             rt: Runtime | None = None) -> torch.Tensor:
    """Routed experts, expert-parallel over ``rt``'s mesh where
    :func:`uses_ep` says so (``p``'s expert leaves are then this rank's
    slices), else on one device (the reference's ``moe_ffn_dense``
    branch), plus the shared experts (their columns and rows over
    ``"model"`` where :func:`tp_plan` cuts them).  Where both the
    experts' hidden slices and the shared experts' are cut over
    ``"model"`` and the wire is native, their partial sums meet in one
    ``reduce_sum``."""
    b, s, d = x.shape
    dims = moe_lib.MoeDims(cfg.n_experts, cfg.moe_top_k, d,
                           cfg.d_ff_expert, cfg.capacity_factor,
                           dispatch_dtype=cfg.moe_dispatch_dtype)
    tp = tp_plan(cfg, rt)
    sg = tp.over(tp.shared)
    ep = uses_ep(cfg, rt)
    # the EP block's partial sums wait for the shared experts' (the
    # int8 wire quantizes the sum over "model", as the reference does)
    one_sum = (ep and bool(cfg.n_shared_experts) and sg is not None
               and cfg.moe_dispatch_dtype == "native")
    if ep:
        out = moe_lib.moe_ffn_ep(x, p["router"], p["ew1"], p["ew3"],
                                 p["ew2"], dims, rt.mesh,
                                 batch_axes=batch_axes(rt.mesh),
                                 reduce=not one_sum)
    else:
        out = moe_lib.moe_ffn_dense(
            x.reshape(b * s, d), p["router"], p["ew1"], p["ew3"],
            p["ew2"], dims).reshape(b, s, d)
    if cfg.n_shared_experts:
        xc = copy_to(x, sg)
        shared = swiglu(xc @ p["sw1"], xc @ p["sw3"]) @ p["sw2"]
        if one_sum:
            return reduce_sum(out + shared, sg)
        out = out + reduce_sum(shared, sg)
    return out


def _mlp(p: dict, cfg: ModelConfig, x: torch.Tensor,
         rt: Runtime | None = None) -> torch.Tensor:
    """The block's feed-forward: routed experts or the dense FFN."""
    if cfg.is_moe:
        return _moe_ffn(p, cfg, x, rt)
    tp = tp_plan(cfg, rt)
    return _ffn(p, cfg, x, tp.over(tp.ffn))


def _mamba_mix(p: dict, cfg: ModelConfig, x: torch.Tensor,
               state: ssm_lib.GlsState | None = None, *,
               decode: bool = False, rt: Runtime | None = None):
    """Mamba-2/SSD head mix (hybrid): returns (y [B,S,H·hd], new_state).
    Where :func:`tp_plan` cuts the Mamba heads, ``p`` and ``state`` hold
    this rank's heads: ``x`` goes through ``copy_to``, and ``y`` (which
    has no projection of its own) is gathered over ``"model"`` into
    every head's columns (:func:`~repro_torch.launch.mesh.gather_to`,
    whose backward only cuts: the fusion after it runs alike on every
    rank); the state stays this rank's heads."""
    b = x.shape[0]
    tp = tp_plan(cfg, rt)
    group = tp.over(bool(tp.mamba_blocks))
    x = copy_to(x, group)
    h, hd, ss = p["ma_log"].shape[-1], cfg.hd, cfg.ssm_state
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
    y = y.reshape(b, s, h * hd)
    if group is not None:
        y = gather_to(y, rt.mesh, tp.mamba_entry(hd), 2, reduce=False)
    return y, new_state


def _fuse_hybrid(p: dict, attn: torch.Tensor,
                 my: torch.Tensor) -> torch.Tensor:
    """Hymba's fusion: per-branch RMS normalization, then the mean."""
    return 0.5 * (rms_norm(attn, p["anorm_g"]) + rms_norm(my, p["mnorm_g"]))


def decoder_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, *,
                  enc_out: torch.Tensor | None = None,
                  return_kv: bool = False, mamba_state=None,
                  rt: Runtime | None = None):
    """One decoder block, full-sequence mode.  Returns (x, extras)."""
    tp = tp_plan(cfg, rt)
    ag = tp.over(tp.attn)
    h = _norm(p, "ln1", x, cfg)
    window = cfg.window if cfg.family == "hybrid" else 0
    attn = _attention_full(p, cfg, h, positions, window=window,
                           return_kv=return_kv, group=ag)
    kv = None
    if return_kv:
        attn, kv = attn
    extras: dict = {"kv": kv}
    if cfg.family == "hybrid":
        # Hymba: parallel attention + mamba heads in the same block;
        # H·hd == d_model, so both branches live in residual space
        my, mstate = _mamba_mix(p, cfg, h, mamba_state, rt=rt)
        extras["mamba_state"] = mstate
        x = x + _fuse_hybrid(p, attn, my)
    else:
        x = x + attn
    if cfg.family == "audio" and enc_out is not None:
        hx = _norm(p, "lnx", x, cfg)
        xk, xv = _cross_kv(p, cfg, enc_out, ag)
        x = x + _attention_cross(p, cfg, hx, xk, xv, ag)
        extras["cross_kv"] = (xk, xv)
    if cfg.is_moe or cfg.d_ff:
        x = x + _mlp(p, cfg, _norm(p, "ln2", x, cfg), rt)
    return x, extras


def _head_norm(y: torch.Tensor, gamma: torch.Tensor, tp: TpPlan,
               width: int) -> torch.Tensor:
    """The xLSTM mixers' RMS norm over all ``width`` dims of ``y``, whose
    last axis holds this rank's heads where ``tp`` cuts the mixers (and
    ``gamma`` their gains): the sum of squares summed over ``"model"``
    (a block held by k ranks weighs 1/k), forward and backward."""
    if not tp.mix or tp.group is None:
        return rms_norm(y, gamma)
    dt = y.dtype
    yf = y.float()
    ss = torch.sum(torch.square(yf), dim=-1, keepdim=True)
    if tp.mix_rep > 1:
        ss = ss * (1.0 / tp.mix_rep)
    ss = reduce_sum(copy_to(ss, tp.group), tp.group)
    return (yf * torch.rsqrt(ss / width + 1e-6)).to(dt) * gamma


def _share(x: torch.Tensor, tp: TpPlan) -> torch.Tensor:
    """``x``, a partial sum that each of the ``mix_rep`` ranks holding
    one block of heads computes alike, weighed ``1 / mix_rep``, so that
    a sum over ``"model"`` counts the block once (and each of those
    ranks' gradients is that share of the block's)."""
    return x * (1.0 / tp.mix_rep) if tp.mix_rep > 1 else x


def mlstm_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                state: ssm_lib.GlsState | None = None, *,
                decode: bool = False, rt: Runtime | None = None):
    """xLSTM mLSTM block: up-proj → heads → gated linear scan (matrix
    memory, exponential gating) → head-norm → output gate → down-proj.
    Where :func:`tp_plan` cuts the mixers, ``p`` and ``state`` hold this
    rank's heads: ``u`` (whole ``w_up``) feeds them through
    ``copy_to``, the head-norm sums over ``"model"`` and the down-proj
    ends in ``reduce_sum``."""
    b, s, _ = x.shape
    tp = tp_plan(cfg, rt)
    group = tp.over(tp.mix)
    h = tp.mix_heads(cfg)
    di = cfg.d_model * cfg.proj_factor
    dh = di // cfg.n_heads
    hidden = _norm(p, "ln1", x, cfg)
    u = copy_to(hidden @ p["w_up"], group)
    g = copy_to(hidden, group) @ p["w_gate"]
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
    y = _head_norm(y.reshape(b, s, h * dh), p["hnorm_g"], tp, di)
    y = y * F.silu(g)
    return x + reduce_sum(_share(y @ p["w_down"], tp), group), new_state


def slstm_block(p: dict, cfg: ModelConfig, x: torch.Tensor,
                state: ssm_lib.SlstmState | None = None, *,
                decode: bool = False, rt: Runtime | None = None):
    """xLSTM sLSTM block: true recurrence (block-diagonal R), one step a
    token; exponential gating with stabilizer.  Where :func:`tp_plan`
    cuts the mixers, ``p`` and ``state`` hold this rank's heads (the
    recurrence is block-diagonal by heads: no collective inside the
    scan); the head-norm sums over ``"model"``, ``y`` is gathered over
    the heads (:func:`~repro_torch.launch.mesh.gather_to`) for
    ``w_out``'s columns and ``w_down``'s rows end in ``reduce_sum``."""
    b, s, d = x.shape
    tp = tp_plan(cfg, rt)
    group = tp.over(tp.mix)
    h = tp.mix_heads(cfg)
    width = d // cfg.n_heads * h
    hidden = _norm(p, "ln1", x, cfg)
    gates = (copy_to(hidden, group) @ p["w_gates"]).reshape(b, s, 4, width)
    y, new_state = ssm_lib.slstm_scan(gates, p["r_gates"], n_heads=h,
                                      initial=state)
    y = _head_norm(y, p["hnorm_g"], tp, d)
    if group is not None:
        y = gather_to(y, rt.mesh, tp.mix_entry(), 2)
    y = y @ p["w_out"]
    out = F.gelu(y, approximate="tanh") @ p["w_down"]
    return x + reduce_sum(out, group), new_state


# ======================================================================
# embedding / head
# ======================================================================

def embed_tokens(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                 rt: Runtime | None = None) -> torch.Tensor:
    """The tokens' embedding rows; where :func:`tp_plan` cuts the vocab,
    a masked lookup of this rank's rows summed over ``"model"``."""
    # F.embedding, not advanced indexing: its backward sums each row's
    # gradient in a fixed order on the CPU and the card (indexing's
    # accumulating index_put_ does not), so a train step repeats exactly
    tp = tp_plan(cfg, rt)
    tokens = tokens.long()
    if not tp.vocab:
        return F.embedding(tokens, params["embed"]).to(cfg.torch_dtype)
    rows = params["embed"].shape[0]
    local = tokens - tp.coord * rows
    own = (local >= 0) & (local < rows)
    x = F.embedding(torch.where(own, local, 0), params["embed"])
    x = x * own[..., None].to(x.dtype)
    return reduce_sum(x, tp.group).to(cfg.torch_dtype)


def _sinusoidal(positions: torch.Tensor, d: int,
                dtype: torch.dtype) -> torch.Tensor:
    """Whisper's sinusoidal embedding ``[n, d]`` of ``positions`` ``[n]``,
    computed in float32 as the reference computes its table, cast to
    ``dtype``.  Any position has a row: a retired slot that has run past
    its cache still gets one (its output is discarded)."""
    device = positions.device
    pos = positions.to(torch.float32)[:, None]
    step = -torch.log(torch.tensor(10000.0, dtype=torch.float32)) / d
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=device) * step.to(device))
    pe = torch.zeros((pos.shape[0], d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def lm_head(params: dict, cfg: ModelConfig, x: torch.Tensor,
            rt: Runtime | None = None) -> torch.Tensor:
    """Logits ``[B, S, V_padded]`` in the model dtype (the embedding's
    transpose where the config ties them); where :func:`tp_plan` cuts
    the vocab, this rank's columns ``[B, S, V_padded / model]``."""
    w = params["embed"].t() if cfg.tie_embeddings else params["head"]
    tp = tp_plan(cfg, rt)
    return copy_to(_norm(params, "lnf", x, cfg), tp.over(tp.vocab)) @ w


def _positions_for(cfg: ModelConfig, tokens: torch.Tensor,
                   positions: torch.Tensor | None) -> torch.Tensor:
    """The given positions, or ``arange(S)`` per sequence (``[3, B, S]``
    text-only grids for M-RoPE)."""
    if positions is not None:
        return positions.to(tokens.device)
    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    if cfg.mrope_sections:
        pos = pos[None].expand(3, b, s)
    return pos


def _encode_audio(params: dict, cfg: ModelConfig,
                  frames: torch.Tensor, *, remat: bool = False,
                  rt: Runtime | None = None) -> torch.Tensor:
    """Whisper's encoder over stub frame embeddings ``[B, S_enc, d]``:
    sinusoidal positions, non-causal attention blocks, a final norm;
    ``remat``: each layer under activation checkpointing (training)."""
    x = frames.to(device=params["embed"].device, dtype=cfg.torch_dtype)
    x = x + _sinusoidal(torch.arange(x.shape[1], device=x.device),
                        cfg.d_model, x.dtype)[None]
    pos = torch.arange(x.shape[1], device=x.device)[None].expand(
        x.shape[0], -1)

    tp = tp_plan(cfg, rt)

    def body(h, lp):
        h = h + _attention_full(lp, cfg, _norm(lp, "ln1", h, cfg), pos,
                                causal=False, group=tp.over(tp.attn))
        return h + _ffn(lp, cfg, _norm(lp, "ln2", h, cfg),
                        tp.over(tp.ffn))

    for i in range(cfg.n_encoder_layers):
        x = _remat(body, remat)(x, layer_params(params, i, "enc_layers"))
    return _norm(params, "enc_lnf", x, cfg)


def _remat(fn, on: bool):
    """``fn`` under activation checkpointing when ``on`` (the
    reference's ``jax.checkpoint``): its activations are recomputed in
    the backward pass, not kept."""
    if not on:
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def chunked_softmax_xent(params: dict, cfg: ModelConfig, x: torch.Tensor,
                         labels: torch.Tensor,
                         chunk: int = 1024,
                         rt: Runtime | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy without materializing ``[B, S,
    V]``: sequence chunks of ``chunk`` positions (the last one padded
    with label -1), float32 logits, label -1 ignored; each chunk's NLL
    sum and valid count added in chunk order, as the reference's scan
    does.  On ``rt``'s mesh ``x`` and ``labels`` are this rank's rows:
    the NLL sum and the count are summed over the batch axes, so every
    rank returns the global mean, and its gradient is this rank's
    share (its rows' NLL over the global count).  Where :func:`tp_plan`
    cuts the vocab, each rank holds its columns of the logits: the row
    maximum is all-reduced (MAX, a shift with no gradient), then the
    sum of the exponentials (SUM), and the target's logit comes from
    the rank that holds it (SUM); the loss is then the same on every
    ``"model"`` rank, and is not summed over them."""
    b, s, d = x.shape
    w = params["embed"].t() if cfg.tie_embeddings else params["head"]
    tp = tp_plan(cfg, rt)
    vg = tp.over(tp.vocab)
    x = copy_to(_norm(params, "lnf", x, cfg), vg)
    labels = labels.to(x.device)
    c = min(chunk, s)
    nc = -(-s // c)
    pad = nc * c - s
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int32, device=x.device)
    for j in range(nc):
        xb, lb = x[:, j * c:(j + 1) * c], labels[:, j * c:(j + 1) * c]
        logits = (xb @ w).float()
        if tp.vocab:
            lse, picked = _vocab_parallel_terms(logits, lb, tp)
        else:
            lse = torch.logsumexp(logits, dim=-1)
            picked = torch.gather(
                logits, -1, lb.clamp_min(0).long()[..., None])[..., 0]
        valid = lb >= 0
        nll = torch.where(valid, lse - picked, 0.0)
        total = total + nll.sum()
        count = count + valid.sum(dtype=torch.int32)
    if rt is not None and rt.mesh is not None:
        for axis in batch_axes(rt.mesh):
            group = rt.mesh.group(axis)
            total = reduce_sum(total, group)
            count = reduce_sum(count, group)
    return total / count.clamp_min(1)


def _vocab_parallel_terms(logits: torch.Tensor, labels: torch.Tensor,
                          tp: TpPlan):
    """(log-sum-exp, the label's logit) of rows whose logits ``[..., n]``
    are this rank's vocab columns ``[coord · n, (coord + 1) · n)``, each
    the same on every ``"model"`` rank."""
    n = logits.shape[-1]
    top = logits.detach().amax(-1)
    if tp.group is not None:
        all_reduce(top, tp.group, "max")
    total = reduce_sum(torch.exp(logits - top[..., None]).sum(-1), tp.group)
    local = labels.long() - tp.coord * n
    own = (local >= 0) & (local < n)
    picked = torch.gather(logits, -1,
                          local.clamp(0, n - 1)[..., None])[..., 0]
    picked = reduce_sum(torch.where(own, picked, 0.0), tp.group)
    return top + torch.log(total), picked


def forward_train(params: dict, cfg: ModelConfig, batch: dict,
                  rt: Runtime | None = None) -> torch.Tensor:
    """Full-sequence forward → mean cross-entropy loss (the train
    step's objective), for every family: ``batch["tokens"]`` and
    ``batch["labels"]`` ``[B, S]`` (labels -1 ignored), the vlm family's
    optional ``"positions"`` ``[3, B, S]``, the audio family's
    ``"encoder_frames"`` ``[B, S_enc, d]``.  With ``cfg.remat`` each
    layer (and each encoder layer) runs under activation checkpointing,
    so attention runs its forward kernel twice a layer.  On ``rt``'s
    mesh the batch holds this rank's rows (``make_global_batch``) and
    the loss is the global one (:func:`chunked_softmax_xent`)."""
    check_supported(cfg, rt)
    dev = params["embed"].device
    tokens = batch["tokens"].to(dev)
    pos = _positions_for(cfg, tokens, batch.get("positions"))
    x = embed_tokens(params, cfg, tokens, rt)
    enc_out = None
    if cfg.family == "audio":
        x = x + _sinusoidal(torch.arange(tokens.shape[1], device=dev),
                            cfg.d_model, x.dtype)[None]
        enc_out = _encode_audio(params, cfg, batch["encoder_frames"],
                                remat=cfg.remat, rt=rt)

    def decoder(h, lp):
        return decoder_block(lp, cfg, h, pos, enc_out=enc_out, rt=rt)[0]

    for i in range(cfg.n_layers):
        if cfg.family == "ssm":
            block = slstm_block if _is_slstm(cfg, i) else mlstm_block

            def body(h, lp, block=block):
                return block(lp, cfg, h, rt=rt)[0]
        else:
            body = decoder
        x = _remat(body, cfg.remat)(x, layer_params(params, i))
    return chunked_softmax_xent(params, cfg, x, batch["labels"], rt=rt)


# ======================================================================
# prefill / decode (serving)
# ======================================================================

def state_fills(cfg: ModelConfig) -> bool:
    """Whether a slot's decode state can run out of rows: the self-
    attention cache of the dense, moe, vlm and audio families ends at
    ``cache_len``; a hybrid ring wraps and an ssm state has no rows."""
    return cfg.family not in ("hybrid", "ssm")


def _cache_len(state: dict, cut: tuple[int, int] | None = None) -> int:
    """Rows of the self-attention cache (MLA's latent, or K): this
    rank's times the ranks of ``cut`` (:func:`seq_cut`)."""
    rows = state["ckv" if "ckv" in state else "k"].shape[2]
    return rows * (cut[0] if cut else 1)


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
            cache_len: int, rt: Runtime | None = None
            ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that also builds the decode state.

    ``batch["tokens"]`` is ``[B, S]``; ``batch["positions"]`` (optional)
    the M-RoPE grids ``[3, B, S]`` of the vlm family (default: text-only
    grids); ``batch["encoder_frames"]`` the audio family's frame
    embeddings ``[B, S_enc, d]``.  Returns (last-position logits ``[B,
    V_padded]``, state) with state ``{"lengths": [B] int32 (= S),
    ...}``: ``"k"``/``"v"`` ``[L, B, cache_len, KH, D]`` (MLA:
    ``"ckv"`` ``[L, B, cache_len, r]`` and ``"krope"`` ``[L, B,
    cache_len, 1, dr]``), zeros past ``S`` (a prompt longer than
    ``cache_len`` raises); audio adds ``"xk"``/``"xv"`` ``[L, B, S_enc,
    KH, D]``; hybrid ``"k"``/``"v"`` rings ``[L, B, window, KH, D]``
    holding the last ``window`` positions at ``t % window`` and
    ``"mamba"`` (its :class:`GlsState` leaves stacked on the layer
    axis); ssm ``"layers"``, one state a layer.  ``cache_len`` sizes
    the self-attention cache only.  ``rt``: the mesh whose ranks run
    the MoE layers expert-parallel (:func:`uses_ep`) and the cut leaves
    tensor-parallel (:func:`tp_plan`), each on its own ``batch``: the
    logits are then this rank's vocab columns where the vocab is cut,
    and ``k``/``v`` (and ``xk``/``xv``) hold this rank's KV heads; under
    ``cfg.shard_kv_seq`` (:func:`seq_cut`) ``k``/``v`` (MLA's
    ``ckv``/``krope``) hold every KV head of this rank's ``cache_len /
    m`` positions (the new rows gathered over the heads where attention
    is cut), and a ``cache_len`` that does not divide by the ``"model"``
    size ``m`` raises ``ValueError``; ``xk``/``xv`` keep their cut.
    """
    check_supported(cfg, rt)
    tokens = batch["tokens"]
    b, s = tokens.shape
    dev = params["embed"].device
    tokens = tokens.to(dev)
    pos = _positions_for(cfg, tokens, batch.get("positions"))
    x = embed_tokens(params, cfg, tokens, rt)
    state: dict = {"lengths": torch.full((b,), s, dtype=torch.int32,
                                         device=dev)}
    enc_out = None
    if cfg.family == "audio":
        x = x + _sinusoidal(torch.arange(s, device=dev), cfg.d_model,
                            x.dtype)[None]
        enc_out = _encode_audio(params, cfg, batch["encoder_frames"], rt=rt)
    if cfg.family == "ssm":
        states = []
        for i in range(cfg.n_layers):
            block = slstm_block if _is_slstm(cfg, i) else mlstm_block
            x, st = block(layer_params(params, i), cfg, x, rt=rt)
            states.append(st)
        state["layers"] = states
    else:
        hybrid = cfg.family == "hybrid"
        # rows a layer's self-attention state holds: the cache, or
        # hymba's ring; position t lives at row t % rows (t, since S <=
        # rows, where the cache ends); cut by sequence, this rank's
        # positions [start, start + rows)
        rows = cfg.window if hybrid else cache_len
        if not hybrid and s > cache_len:
            raise ValueError(f"prefill: {s} prompt tokens do not fit a "
                             f"cache of {cache_len}")
        cut = seq_cut(cfg, rt)
        heads = tp_plan(cfg, rt).kv_heads(cfg)
        start = 0
        if cut is not None:
            m, coord = cut
            if cache_len % m:
                raise ValueError(
                    f"prefill: a cache of {cache_len} rows does not divide "
                    f"over the {m} ranks of \"model\" (shard_kv_seq cuts "
                    "it by sequence)")
            rows, heads = cache_len // m, cfg.n_kv_heads
            start = coord * rows
        dt, nl = cfg.torch_dtype, cfg.n_layers
        if cfg.is_mla:
            names = ("ckv", "krope")
            shapes = ((nl, b, rows, cfg.kv_lora_rank),
                      (nl, b, rows, 1, cfg.rope_head_dim))
        else:
            names = ("k", "v")
            shapes = ((nl, b, rows, heads, cfg.hd),) * 2
        caches = [torch.zeros(shape, dtype=dt, device=dev)
                  for shape in shapes]
        cross, msts = [], []
        for i in range(nl):
            x, extras = decoder_block(layer_params(params, i), cfg, x, pos,
                                      enc_out=enc_out, return_kv=True,
                                      rt=rt)
            kv = extras["kv"]
            if cut is not None:
                if not cfg.is_mla:
                    kv = _all_kv_heads(kv, cfg, rt)
                kv = tuple(t[:, start:start + rows] for t in kv)
            for cache, t in zip(caches, kv):
                _write_prefix(cache[i], t, t.shape[1])
            if hybrid:
                msts.append(extras["mamba_state"])
            if enc_out is not None:
                cross.append(extras["cross_kv"])
        state.update(zip(names, caches))
        if hybrid:
            state["mamba"] = ssm_lib.GlsState(
                *(torch.stack(leaf) for leaf in zip(*msts)))
        if enc_out is not None:
            state["xk"] = torch.stack([xk for xk, _ in cross])
            state["xv"] = torch.stack([xv for _, xv in cross])
    logits = lm_head(params, cfg, x[:, -1:], rt)[:, 0]
    return logits, state


def _write_row(cache: torch.Tensor, new: torch.Tensor,
               lengths: torch.Tensor, room: torch.Tensor | None) -> None:
    """Write one new row a sequence into ``cache [B, C, ...]`` at
    ``lengths``, in place; with ``room`` ([B] bool), a row without room
    keeps its cache as it is (its write goes to a row in [0, C) that it
    leaves unchanged)."""
    ar = torch.arange(cache.shape[0], device=cache.device)
    if room is None:
        cache[ar, lengths.long()] = new
        return
    idx = lengths.long().clamp(0, cache.shape[1] - 1)
    keep = room.view(-1, *([1] * (new.dim() - 1)))
    cache[ar, idx] = torch.where(keep, new, cache[ar, idx])


def _all_kv_heads(kv: tuple, cfg: ModelConfig, rt: Runtime | None
                  ) -> tuple:
    """K and V ``[B, S, KH', D]`` of this rank's KV heads → of every KV
    head, gathered over ``"model"`` in one all-gather where attention is
    cut by heads (as they are otherwise)."""
    tp = tp_plan(cfg, rt)
    if not tp.attn or tp.group is None:
        return kv
    k, v = kv
    both = Placement(rt.mesh, (None, None, tp.kv_entry())).gather(
        torch.cat([k, v], dim=-1))
    return both[..., :k.shape[-1]], both[..., k.shape[-1]:]


def _all_heads(q: torch.Tensor, tp: TpPlan, rt: Runtime | None
               ) -> torch.Tensor:
    """``q [B, H', ...]`` of this rank's query heads → of every head
    where attention is cut by heads."""
    if not tp.attn or tp.group is None:
        return q
    return Placement(rt.mesh, (None, "model")).gather(q)


def _seq_merge(out: torch.Tensor, lse: torch.Tensor, tp: TpPlan
               ) -> torch.Tensor:
    """Every head's decode output ``[B, H, Dv]`` over the whole cache
    from each rank's over its slice (:func:`~repro_torch.kernels.
    flash_decode.merge_partials`: a MAX all-reduce of ``lse``, one SUM
    all-reduce of the weighted outputs and weights over ``"model"``),
    then this rank's query heads where attention is cut."""
    out = merge_partials(out, lse, lambda t: all_reduce(t, tp.group, "max"),
                         lambda t: all_reduce(t, tp.group))
    if tp.attn:
        n = out.shape[1] // tp.size
        out = out[:, tp.coord * n:(tp.coord + 1) * n]
    return out


def _seq_lengths(lengths: torch.Tensor, cut: tuple[int, int],
                 rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(each sequence's new row's index in this rank's slice of
    ``rows`` positions, and the valid rows of the slice after the
    write), on the device: ``lengths − r·rows`` and ``clamp(lengths + 1
    − r·rows, 0, rows)``."""
    start = cut[1] * rows
    local = lengths - start
    return local, (local + 1).clamp(0, rows).to(torch.int32)


def _decode_attn_seq(p: dict, cfg: ModelConfig, h: torch.Tensor,
                     state_k: torch.Tensor, state_v: torch.Tensor,
                     lengths: torch.Tensor, rt: Runtime,
                     cut: tuple[int, int]):
    """:func:`_decode_attn_dense` over a cache cut by sequence
    (:func:`seq_cut`): this rank's slice ``[B, C/m, KH, D]`` of every KV
    head.  The new K/V rows (gathered over the heads where attention is
    cut) are written only by the rank whose slice holds position
    ``lengths``; every query head (gathered likewise) attends over the
    slice's valid rows through ``flash_decode`` with its log-sum-exp,
    and the ranks' partial softmaxes merge (:func:`_seq_merge`)."""
    tp = tp_plan(cfg, rt)
    group = tp.over(tp.attn)
    b = h.shape[0]
    positions = _decode_positions(cfg, lengths)
    q, k, v = _qkv(p, cfg, copy_to(h, group))
    q = _rope(cfg, q, positions)
    k, v = _all_kv_heads((_rope(cfg, k, positions), v), cfg, rt)
    local, valid = _seq_lengths(lengths, cut, state_k.shape[1])
    own = (local >= 0) & (local < state_k.shape[1])
    _write_row(state_k, k[:, 0], local, own)
    _write_row(state_v, v[:, 0], local, own)
    out, lse = ops.decode_bshd(_all_heads(q[:, 0], tp, rt)[:, None],
                               state_k, state_v, valid, with_lse=True)
    out = _seq_merge(out[:, 0], lse, tp)
    out = reduce_sum(out.reshape(b, 1, -1) @ p["wo"], group)
    return out, state_k, state_v


def _decode_positions(cfg: ModelConfig, lengths: torch.Tensor
                      ) -> torch.Tensor:
    """A decode step's positions ``[B, 1]`` (``[3, B, 1]`` for M-RoPE:
    the reference's text-only grids at ``lengths``)."""
    positions = lengths[:, None]
    if cfg.mrope_sections:
        positions = positions[None].expand(3, -1, -1)
    return positions


def _decode_attn_dense(p: dict, cfg: ModelConfig, h: torch.Tensor,
                       state_k: torch.Tensor, state_v: torch.Tensor,
                       lengths: torch.Tensor, room: torch.Tensor | None,
                       group=None):
    """One-token attention against one layer's cache ``[B, C, KH, D]``;
    writes the new K/V rows at ``lengths`` IN PLACE and returns (out,
    k cache, v cache).  With ``room`` ([B] bool), a row without room
    keeps its cache as it is (its write goes to row C - 1 unchanged).
    A hybrid cache is a ring of ``window`` rows: the row goes to slot
    ``lengths % window`` and attention reads ``min(lengths + 1,
    window)`` rows.  ``group`` as in :func:`_attention_full` (the
    cache holds this rank's KV heads)."""
    b = h.shape[0]
    positions = _decode_positions(cfg, lengths)
    q, k, v = _qkv(p, cfg, copy_to(h, group))
    q = _rope(cfg, q, positions)
    k = _rope(cfg, k, positions)
    if cfg.family == "hybrid":                     # ring buffer
        ar = torch.arange(b, device=h.device)
        window = state_k.shape[1]
        slot = (lengths % window).long()
        state_k[ar, slot] = k[:, 0]
        state_v[ar, slot] = v[:, 0]
        valid = torch.clamp(lengths + 1, max=window)
        out = ops.decode_bshd(q, state_k, state_v, valid)
        out = reduce_sum(out.reshape(b, 1, -1) @ p["wo"], group)
        return out, state_k, state_v
    _write_row(state_k, k[:, 0], lengths, room)
    _write_row(state_v, v[:, 0], lengths, room)
    out = ops.decode_bshd(q, state_k, state_v, lengths + 1)
    out = reduce_sum(out.reshape(b, 1, -1) @ p["wo"], group)
    return out, state_k, state_v


def _decode_attn_mla(p: dict, cfg: ModelConfig, h: torch.Tensor,
                     ckv_cache: torch.Tensor, krope_cache: torch.Tensor,
                     lengths: torch.Tensor, room: torch.Tensor | None,
                     rt: Runtime | None = None,
                     cut: tuple[int, int] | None = None):
    """Absorbed MLA decode: scores in latent space, no K/V expansion.
    Writes the new latent rows at ``lengths`` IN PLACE (``room`` as in
    :func:`_decode_attn_dense`).  W_uk is absorbed into q (each latent
    head repeated over its query group), and q is rescaled by
    ``sqrt((r + dr) / (hd + dr))`` rounded to q's dtype, in q's dtype,
    as the reference does before the decode attention's own
    ``1/sqrt(r + dr)``.  ``rt``: this rank's heads (where
    :func:`tp_plan` cuts attention) over the whole latent cache, or,
    cut by sequence (``cut``, :func:`seq_cut`), every head (gathered)
    over this rank's slice, the new row written by the rank that holds
    its position and the partial softmaxes merged (:func:`_seq_merge`)."""
    tp = tp_plan(cfg, rt)
    group = tp.over(tp.attn)
    b = h.shape[0]
    r, dr, hd = cfg.kv_lora_rank, cfg.rope_head_dim, cfg.hd
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, cfg, h, lengths[:, None],
                                            group)
    valid = lengths + 1
    if cut is not None:
        local, valid = _seq_lengths(lengths, cut, ckv_cache.shape[1])
        room = (local >= 0) & (local < ckv_cache.shape[1])
        lengths = local
    _write_row(ckv_cache, c_kv[:, 0], lengths, room)
    _write_row(krope_cache, k_rope[:, 0], lengths, room)
    kh = p["wuk"].shape[-1] // hd
    g = q_nope.shape[2] // kh
    wuk = p["wuk"].reshape(r, kh, hd).repeat_interleave(g, dim=1)
    q_eff = torch.einsum("bshe,rhe->bshr", q_nope, wuk)    # [B,1,H,r]
    # rounded to q's dtype on the host; the product rounds in q's dtype
    scale = float(torch.sqrt(torch.tensor((r + dr) / (hd + dr),
                                          dtype=h.dtype)))
    q_lat, q_rope = (q_eff * scale)[:, 0], (q_rope * scale)[:, 0]
    if cut is None:
        out_lat = ops.decode_mla(q_lat, q_rope, ckv_cache,
                                 krope_cache[:, :, 0], valid)   # [B,H,r]
    else:
        q_all = _all_heads(torch.cat([q_lat, q_rope], dim=-1), tp, rt)
        out_lat, lse = ops.decode_mla(q_all[..., :r], q_all[..., r:],
                                      ckv_cache, krope_cache[:, :, 0],
                                      valid, with_lse=True)
        out_lat = _seq_merge(out_lat, lse, tp)
    wuv = p["wuv"].reshape(r, kh, hd).repeat_interleave(g, dim=1)
    out = torch.einsum("bhr,rhe->bhe", out_lat, wuv)
    out = reduce_sum(out.reshape(b, 1, -1) @ p["wo"], group)
    return out, ckv_cache, krope_cache


def decode_step(params: dict, cfg: ModelConfig, state: dict,
                tokens: torch.Tensor, live=None,
                rt: Runtime | None = None) -> tuple[torch.Tensor, dict]:
    """One serving step: tokens ``[B]`` → (logits ``[B, V_padded]``,
    state).  The returned state holds the same (updated in place)
    caches (``k``/``v`` or MLA's ``ckv``/``krope``; audio's ``xk``/``xv``
    are only read; hybrid ``mamba`` leaves), new ``lengths`` and, for
    the ssm family, new per-layer states.

    ``live`` ([B] bools on the host; default: every slot) marks the
    slots whose output the caller reads.  Where the cache ends at
    ``cache_len`` (every family but hybrid and ssm), without it a slot
    whose cache is full raises ``ValueError`` naming it, which reads
    ``lengths`` back from the device.  With it nothing is read back: the
    caller vouches that live slots have room (``ServingEngine`` checks
    this from the lengths it keeps on the host), and a slot outside
    ``live`` that is past its cache skips its cache write on the device,
    as the JAX reference drops such writes.  Hybrid rings and ssm states
    never fill.  ``rt`` as in :func:`prefill`."""
    check_supported(cfg, rt)
    tp = tp_plan(cfg, rt)
    ag = tp.over(tp.attn)
    cut = seq_cut(cfg, rt)
    lengths = state["lengths"]
    new_state = dict(state)
    x = embed_tokens(params, cfg, tokens.to(lengths.device)[:, None], rt)
    if cfg.family == "audio":
        x = x + _sinusoidal(lengths, cfg.d_model, x.dtype)[:, None]
    if cfg.family == "ssm":
        new_layers = []
        for i, st in enumerate(state["layers"]):
            block = slstm_block if _is_slstm(cfg, i) else mlstm_block
            x, st2 = block(layer_params(params, i), cfg, x, state=st,
                           decode=True, rt=rt)
            new_layers.append(st2)
        new_state["layers"] = new_layers
    else:
        room = None
        if state_fills(cfg):
            cache_len = _cache_len(state, cut)
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
        if "xk" in state:
            enc_len = torch.full_like(lengths, state["xk"].shape[2])
        for i in range(cfg.n_layers):
            lp = layer_params(params, i)
            h = _norm(lp, "ln1", x, cfg)
            if cfg.is_mla:
                attn, _, _ = _decode_attn_mla(
                    lp, cfg, h, state["ckv"][i], state["krope"][i],
                    lengths, room, rt, cut)
            elif cut is not None:
                attn, _, _ = _decode_attn_seq(
                    lp, cfg, h, state["k"][i], state["v"][i], lengths, rt,
                    cut)
            else:
                attn, _, _ = _decode_attn_dense(
                    lp, cfg, h, state["k"][i], state["v"][i], lengths, room,
                    ag)
            if mamba is not None:
                mst = ssm_lib.GlsState(*(leaf[i] for leaf in mamba))
                my, mst2 = _mamba_mix(lp, cfg, h, mst, decode=True, rt=rt)
                for leaf, new in zip(mst, mst2):
                    leaf.copy_(new)
                attn = _fuse_hybrid(lp, attn, my)
            x = x + attn
            if "xk" in state:
                hx = _norm(lp, "lnx", x, cfg)
                q = (copy_to(hx, ag) @ lp["xwq"]).reshape(
                    x.shape[0], 1, -1, cfg.hd)
                xatt = ops.decode_bshd(q, state["xk"][i], state["xv"][i],
                                       enc_len)
                x = x + reduce_sum(
                    xatt.reshape(x.shape[0], 1, -1) @ lp["xwo"], ag)
            if cfg.is_moe or cfg.d_ff:
                x = x + _mlp(lp, cfg, _norm(lp, "ln2", x, cfg), rt)
    new_state["lengths"] = lengths + 1
    logits = lm_head(params, cfg, x, rt)[:, 0]
    return logits, new_state
