"""``meta`` stand-ins and placements for every (arch × shape) cell.

Nothing here allocates: parameters, optimizer state, batches and decode
states are ``meta`` tensors of the port's own layouts (the parameter
tree of :func:`repro_torch.models.transformer.init_lm`, the state
:func:`repro_torch.models.transformer.prefill` builds), which are the
reference's names and shapes.  Each function returns the reference's
``(stand-ins, placements)`` pair.  On the one-card mesh of
:func:`repro_torch.launch.mesh.make_host_mesh` every leaf is placed
whole on the mesh's card, so a placement is that ``torch.device``.  On
an abstract mesh (:func:`repro_torch.launch.mesh.make_production_mesh`)
a placement is a :class:`~repro_torch.launch.mesh.Placement` per leaf
and the stand-ins are rank 0's blocks: the parameters by
:func:`~repro_torch.models.transformer.param_placements` (tensor
parallelism over ``"model"``, the routed experts over ``"data"``), the
moments by :func:`~repro_torch.train.optimizer.moment_placements` (ZeRO
where the optimizer asks for it), batches, tokens and decode states
over the batch axes where the batch divides by them (the reference's
``_bshard``), the KV caches over ``"model"`` by KV heads where
:func:`~repro_torch.models.transformer.tp_plan` cuts them, or by
sequence with every head under ``shard_kv_seq``
(:func:`~repro_torch.models.transformer.seq_cut`: ``k``/``v`` and MLA's
``ckv``/``krope``; whisper's cross cache keeps its cut), hymba's rings
by its KV heads' blocks and its Mamba states by its Mamba heads'
(:class:`~repro_torch.launch.mesh.Uneven`), and the xLSTM states by
heads where ``tp_plan`` cuts the mixers.  The modality
frontends are stubs as in the reference: whisper gets precomputed frame
embeddings, qwen2-vl M-RoPE position grids.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch.mesh import CardMesh, Placement, batch_axes
from repro_torch.models import transformer as tf
from repro_torch.models.ssm import GlsState, SlstmState
from repro_torch.train._tree import tree_map
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_init,
    moment_placements,
)


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _placed(mesh: CardMesh, tree: Any) -> Any:
    """The placement tree of ``tree``: every leaf whole on the card.
    (Named tuples such as the recurrent states keep their type.)"""
    if isinstance(tree, dict):
        return {k: _placed(mesh, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_placed(mesh, v) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(_placed(mesh, v) for v in tree))
    return mesh.device


def _local(tree: Any, placements: Any) -> Any:
    """Rank 0's block of each ``meta`` stand-in of ``tree`` by its
    placement (named tuples keep their type)."""
    if isinstance(tree, dict):
        return {k: _local(v, placements[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_local(v, p) for v, p in zip(tree, placements)]
    if isinstance(tree, tuple):
        return type(tree)(*(_local(v, p) for v, p in zip(tree, placements)))
    return _meta(placements.local_shape(tuple(tree.shape)), tree.dtype)


def _cut(mesh: CardMesh, tree: dict, spec_of) -> tuple[Any, Any]:
    """(stand-ins, placements) of a dict of stand-ins: on the one card
    ``tree`` whole on the card; on an abstract mesh each leaf under key
    ``k`` cut by ``Placement(mesh, spec_of(k))``."""
    if not mesh.abstract:
        return tree, _placed(mesh, tree)

    def place(node, spec):
        if isinstance(node, list):
            return [place(v, spec) for v in node]
        if isinstance(node, tuple):
            return type(node)(*(place(v, spec) for v in node))
        return Placement(mesh, spec)

    placements = {k: place(v, spec_of(k)) for k, v in tree.items()}
    return _local(tree, placements), placements


def _bshard(mesh: CardMesh, batch: int):
    """The batch axis's spec entry: the batch axes where ``batch``
    divides by their size, else whole (the reference's ``_bshard``)."""
    axes = batch_axes(mesh)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return axes if batch % n == 0 and batch >= n else None


def abstract_model(cfg: ModelConfig, mesh: CardMesh) -> tuple[Any, Any]:
    """(parameter stand-ins, placements)."""
    params = tf.abstract(cfg)
    if not mesh.abstract:
        return params, _placed(mesh, params)
    placements = tf.param_placements(cfg, tf.Runtime(mesh))
    return _local(params, placements), placements


def abstract_opt_state(params: Any, param_placements: Any,
                       ocfg: AdamWConfig, mesh: CardMesh):
    """AdamW's state ``{"m", "v", "count"}`` for ``params``: moments in
    ``ocfg.moment_dtype``, an int32 step count; on an abstract mesh
    rank 0's blocks (:func:`~repro_torch.train.optimizer.adamw_init`,
    ZeRO where ``ocfg`` asks for it)."""
    if mesh.abstract:
        state = adamw_init(params, ocfg, placements=param_placements)
        shapes = tree_map(lambda x, pl: pl.global_shape(tuple(x.shape)),
                          params, param_placements)
        mp = moment_placements(ocfg, param_placements, shapes)
        return state, {"m": mp, "v": mp,
                       "count": Placement(mesh, ())}
    mdt = torch.bfloat16 if ocfg.moment_dtype == "bfloat16" \
        else torch.float32
    m = tree_map(lambda x: _meta(x.shape, mdt), params)
    v = tree_map(lambda x: _meta(x.shape, mdt), params)
    state = {"m": m, "v": v, "count": _meta((), torch.int32)}
    placements = {"m": param_placements, "v": param_placements,
                  "count": mesh.device}
    return state, placements


def _train_batch(cfg: ModelConfig, cell: ShapeCell, make) -> dict:
    """The global train batch of ``cell``, each array ``make(shape,
    dtype)``."""
    b, s = cell.global_batch, cell.seq_len
    batch = {"tokens": make((b, s), torch.int32),
             "labels": make((b, s), torch.int32)}
    if cfg.family == "audio":
        batch["encoder_frames"] = make((b, cfg.encoder_seq, cfg.d_model),
                                       cfg.torch_dtype)
    if cfg.family == "vlm":
        batch["positions"] = make((3, b, s), torch.int32)
    return batch


def host_train_batch(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """The global train batch of ``cell`` as the host holds it, in
    zero-stride stand-ins of no memory: a train step on a mesh cuts its
    rank's rows from it."""
    return _train_batch(cfg, cell, lambda shape, dtype: torch.zeros(
        (), dtype=dtype).expand(shape))


def train_batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh: CardMesh):
    batch = _train_batch(cfg, cell, _meta)
    bs = _bshard(mesh, cell.global_batch)
    return _cut(mesh, batch,
                lambda key: (None, bs) if key == "positions" else (bs,))


def decode_state_specs(cfg: ModelConfig, cell: ShapeCell, mesh: CardMesh):
    """Decode state in :func:`~repro_torch.models.transformer.prefill`'s
    layout for a cache of ``cell.seq_len`` rows."""
    state = _decode_state(cfg, cell, mesh)
    bs = _bshard(mesh, cell.global_batch)
    rt = tf.Runtime(mesh)
    plan = tf.tp_plan(cfg, rt)
    kv = plan.kv_entry()
    seq = tf.seq_cut(cfg, rt) is not None

    def spec_of(key):
        if seq and key in ("k", "v", "ckv", "krope"):
            return (None, bs, "model")
        if key in ("k", "v", "xk", "xv"):
            return (None, bs, None, kv)
        if key == "layers":
            return (bs, plan.mix_entry())
        if key == "mamba":
            return (None, bs, plan.mamba_entry())
        return (bs,) if key == "lengths" else (None, bs)

    return _cut(mesh, state, spec_of)


def _decode_state(cfg: ModelConfig, cell: ShapeCell,
                  mesh: CardMesh) -> dict:
    """The whole decode state of :func:`decode_state_specs`; raises
    ``ValueError`` where ``shard_kv_seq`` cuts a cache whose length does
    not divide by the ``"model"`` size (as ``prefill`` does)."""
    b, c = cell.global_batch, cell.seq_len
    cut = tf.seq_cut(cfg, tf.Runtime(mesh))
    if cut is not None and c % cut[0]:
        raise ValueError(f"decode state: a cache of {c} rows does not "
                         f"divide over the {cut[0]} ranks of \"model\" "
                         "(shard_kv_seq cuts it by sequence)")
    l, kh, hd = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    f32 = torch.float32
    dt = cfg.torch_dtype
    state: dict = {"lengths": _meta((b,), torch.int32)}

    if cfg.family == "ssm":
        di = cfg.d_model * cfg.proj_factor
        dh = di // cfg.n_heads
        layers = []
        for i in range(l):
            if tf._is_slstm(cfg, i):
                layers.append(SlstmState(*(_meta((b, cfg.d_model), f32)
                                           for _ in range(4))))
            else:
                layers.append(GlsState(h=_meta((b, cfg.n_heads, dh, dh), f32),
                                       n=_meta((b, cfg.n_heads, dh), f32),
                                       m=_meta((b, cfg.n_heads), f32)))
        state["layers"] = layers
        return state

    if cfg.family == "hybrid":
        w = cfg.window
        state["k"] = _meta((l, b, w, kh, hd), dt)
        state["v"] = _meta((l, b, w, kh, hd), dt)
        state["mamba"] = GlsState(
            h=_meta((l, b, cfg.n_heads, cfg.ssm_state, hd), f32),
            n=_meta((l, b, cfg.n_heads, cfg.ssm_state), f32),
            m=_meta((l, b, cfg.n_heads), f32))
        return state

    if cfg.is_mla:
        r, dr = cfg.kv_lora_rank, cfg.rope_head_dim
        state["ckv"] = _meta((l, b, c, r), dt)
        state["krope"] = _meta((l, b, c, 1, dr), dt)
    else:
        state["k"] = _meta((l, b, c, kh, hd), dt)
        state["v"] = _meta((l, b, c, kh, hd), dt)
    if cfg.family == "audio":
        es = cfg.encoder_seq
        state["xk"] = _meta((l, b, es, kh, hd), dt)
        state["xv"] = _meta((l, b, es, kh, hd), dt)
    return state


def decode_token_specs(cell: ShapeCell, mesh: CardMesh):
    tokens, placements = _cut(mesh, {"t": _meta((cell.global_batch,),
                                               torch.int32)},
                              lambda key: (_bshard(mesh, cell.global_batch),))
    return tokens["t"], placements["t"]
