"""``meta`` stand-ins and placements for every (arch × shape) cell.

Nothing here allocates: parameters, optimizer state, batches and decode
states are ``meta`` tensors of the port's own layouts (the parameter
tree of :func:`repro_torch.models.transformer.init_lm`, the state
:func:`repro_torch.models.transformer.prefill` builds), which are the
reference's names and shapes.  Each function returns the reference's
``(stand-ins, placements)`` pair; on the one-card mesh of
:func:`repro_torch.launch.mesh.make_host_mesh` every leaf is placed
whole on the mesh's card, so a placement is that ``torch.device``.
Per-leaf partitions in the dry-run wait for Queue 1 item 5b
(``ROADMAP.md``).  The modality frontends are stubs as in the reference:
whisper gets precomputed frame embeddings, qwen2-vl M-RoPE position
grids.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ModelConfig, ShapeCell
from repro_torch.launch.mesh import CardMesh
from repro_torch.models import transformer as tf
from repro_torch.models.ssm import GlsState, SlstmState
from repro_torch.train._tree import tree_map
from repro_torch.train.optimizer import AdamWConfig


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


def abstract_model(cfg: ModelConfig, mesh: CardMesh) -> tuple[Any, Any]:
    """(parameter stand-ins, placements)."""
    params = tf.abstract(cfg)
    return params, _placed(mesh, params)


def abstract_opt_state(params: Any, param_placements: Any,
                       ocfg: AdamWConfig, mesh: CardMesh):
    """AdamW's state ``{"m", "v", "count"}`` for ``params``: moments in
    ``ocfg.moment_dtype``, an int32 step count."""
    mdt = torch.bfloat16 if ocfg.moment_dtype == "bfloat16" \
        else torch.float32
    m = tree_map(lambda x: _meta(x.shape, mdt), params)
    v = tree_map(lambda x: _meta(x.shape, mdt), params)
    state = {"m": m, "v": v, "count": _meta((), torch.int32)}
    placements = {"m": param_placements, "v": param_placements,
                  "count": mesh.device}
    return state, placements


def train_batch_specs(cfg: ModelConfig, cell: ShapeCell, mesh: CardMesh):
    b, s = cell.global_batch, cell.seq_len
    batch = {"tokens": _meta((b, s), torch.int32),
             "labels": _meta((b, s), torch.int32)}
    if cfg.family == "audio":
        batch["encoder_frames"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                                        cfg.torch_dtype)
    if cfg.family == "vlm":
        batch["positions"] = _meta((3, b, s), torch.int32)
    return batch, _placed(mesh, batch)


def decode_state_specs(cfg: ModelConfig, cell: ShapeCell, mesh: CardMesh):
    """Decode state in :func:`~repro_torch.models.transformer.prefill`'s
    layout for a cache of ``cell.seq_len`` rows."""
    b, c = cell.global_batch, cell.seq_len
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
        return state, _placed(mesh, state)

    if cfg.family == "hybrid":
        w = cfg.window
        state["k"] = _meta((l, b, w, kh, hd), dt)
        state["v"] = _meta((l, b, w, kh, hd), dt)
        state["mamba"] = GlsState(
            h=_meta((l, b, cfg.n_heads, cfg.ssm_state, hd), f32),
            n=_meta((l, b, cfg.n_heads, cfg.ssm_state), f32),
            m=_meta((l, b, cfg.n_heads), f32))
        return state, _placed(mesh, state)

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
    return state, _placed(mesh, state)


def decode_token_specs(cell: ShapeCell, mesh: CardMesh):
    return _meta((cell.global_batch,), torch.int32), mesh.device
