"""Carry inputs and state across from the JAX package's formats.

Every input here is plain data (numpy arrays, dicts, JSON text), so
the port reads what the reference writes without importing it:

  - :func:`layer_specs_from_records` — layer specs given as dicts of the
    reference ``LayerSpec`` fields → the port's
    :class:`~repro_torch.perfmodel.layer_costs.LayerSpec`;
  - :func:`padded_from_numpy` — the arrays of a reference
    ``PaddedArrays`` → one-lane tensors in the layout the kernels take;
  - :func:`lm_params_from_numpy` — a reference LM parameter tree (from
    ``repro.models.transformer.init_params``, as numpy; stacked layers,
    with routed experts ``[L, E, d, f]``, MLA's latent projections and
    whisper's stacked ``enc_layers``, ``enc_lnf`` and cross projections;
    ssm a list of per-layer dicts of two kinds) → the port's parameters,
    so both packages compute with the same weights;
  - :func:`opt_state_from_numpy` — a reference AdamW state ``{m, v,
    count}`` → the port's, so both packages take the same step;
  - :func:`shard_lm_params` — a reference LM parameter tree → this
    rank's blocks on a mesh of ranks (``param_placements``: the routed
    experts cut by their specs where the model runs them
    expert-parallel, every other leaf whole).

A reference ``PowerSchedule.to_json`` payload is read by the port's own
:meth:`~repro_torch.core.schedule.PowerSchedule.from_json` (same schema,
same field set).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import shard_tree
from repro_torch.models.transformer import (
    Runtime,
    param_placements,
    param_shapes,
)
from repro_torch.perfmodel.layer_costs import LayerSpec

#: the padded-tensor names, in the order the kernels take them
PADDED_NAMES = ("t_op", "e_op", "valid", "t_trans", "e_trans", "switch")

_SPEC_FIELDS = frozenset(f.name for f in dataclasses.fields(LayerSpec))
_PADDED_DTYPES = {"t_op": np.float64, "e_op": np.float64, "valid": bool,
                  "t_trans": np.float64, "e_trans": np.float64,
                  "switch": np.int64}


def layer_specs_from_records(records: Iterable[Mapping]) -> list[LayerSpec]:
    """One :class:`LayerSpec` per record; a record names exactly the
    reference ``LayerSpec`` fields (the ones with defaults may be
    omitted)."""
    specs = []
    for i, rec in enumerate(records):
        unknown = set(rec) - _SPEC_FIELDS
        if unknown:
            raise ValueError(f"layer record {i} has unknown fields "
                             f"{sorted(unknown)}")
        specs.append(LayerSpec(**rec))
    return specs


def padded_from_numpy(arrays: Mapping[str, np.ndarray],
                      device: str | torch.device = "cuda"
                      ) -> tuple[torch.Tensor, ...]:
    """The six padded tensors of one problem (``t_op, e_op, valid [L,
    S]``, ``t_trans, e_trans, switch [L-1, S, S]``) as contiguous
    one-lane tensors ``[1, ...]`` on ``device``, in
    :data:`PADDED_NAMES` order — the layout of a lane mirror, so the
    kernels take them with ``lanes = [0]``."""
    out = []
    for name in PADDED_NAMES:
        arr = np.ascontiguousarray(arrays[name], dtype=_PADDED_DTYPES[name])
        out.append(torch.from_numpy(arr[None]).to(device))
    L, S = out[0].shape[1:]
    want = (1, max(L - 1, 0), S, S)
    for name, t in zip(PADDED_NAMES, out):
        if tuple(t.shape) != ((1, L, S) if t.dim() == 3 else want):
            raise ValueError(f"padded {name} has shape "
                             f"{tuple(t.shape[1:])}, expected [L, S] / "
                             f"[L-1, S, S] with L={L}, S={S}")
    return tuple(out)


def lm_params_from_numpy(tree: Mapping, cfg: ModelConfig,
                         device: str | torch.device = "cuda") -> dict:
    """The port's LM parameters from a reference parameter tree of
    numpy arrays (any float dtype, bfloat16 included): same names,
    per-layer leaves stacked on axis 0 (a list of per-layer dicts, the
    reference's unscanned layout, is stacked here), cast to
    ``cfg.dtype`` on ``device``.  The ssm family keeps its list of
    per-layer dicts (mLSTM and sLSTM layers differ in their names).
    Every name and shape must be the one
    :func:`repro_torch.models.transformer.init_params` makes."""
    return _lm_tree(tree, cfg, device, lambda arr: cfg.torch_dtype)


def opt_state_from_numpy(tree: Mapping, cfg: ModelConfig,
                         device: str | torch.device = "cuda") -> dict:
    """The port's AdamW state from a reference one (``{"m", "v",
    "count"}`` as numpy, from ``repro.train.optimizer.adamw_init`` or a
    step of ``adamw_update``): ``m`` and ``v`` laid out as
    :func:`lm_params_from_numpy` lays out the parameters of ``cfg``,
    each moment in its own dtype (``bfloat16`` by its name, else
    float32), ``count`` an int32 scalar; on ``device``."""
    def moment_dtype(arr):
        return torch.bfloat16 if str(arr.dtype) == "bfloat16" \
            else torch.float32

    return {"m": _lm_tree(tree["m"], cfg, device, moment_dtype),
            "v": _lm_tree(tree["v"], cfg, device, moment_dtype),
            "count": torch.tensor(int(np.asarray(tree["count"])),
                                  dtype=torch.int32, device=device)}


def shard_lm_params(tree: Mapping, cfg: ModelConfig, rt: Runtime) -> dict:
    """This rank's blocks of a reference parameter tree (numpy) on
    ``rt``'s mesh, on the mesh's device, in ``cfg.dtype``: each leaf as
    :func:`lm_params_from_numpy` makes it, cut by
    ``param_placements(cfg, rt)``."""
    return shard_tree(lm_params_from_numpy(tree, cfg, "cpu"),
                      param_placements(cfg, rt))


def _lm_tree(tree: Mapping, cfg: ModelConfig, device,
             dtype_of) -> dict:
    """A reference tree of the LM's parameter layout as the port's
    tensors, each in ``dtype_of(numpy array)``."""
    tree = dict(tree)
    layers = tree.get("layers")
    if isinstance(layers, (list, tuple)) and cfg.family != "ssm":
        tree["layers"] = {key: np.stack([np.asarray(lp[key], np.float32)
                                         for lp in layers])
                          for key in layers[0]}

    def convert(node, want, path):
        if isinstance(want, list):
            if not isinstance(node, (list, tuple)) \
                    or len(node) != len(want):
                raise ValueError(f"LM parameters{path}: expected a list "
                                 f"of {len(want)} layers")
            return [convert(n, w, f"{path}[{i}]")
                    for i, (n, w) in enumerate(zip(node, want))]
        if set(node) != set(want):
            raise ValueError(f"LM parameters{path}: names "
                             f"{sorted(node)} != expected {sorted(want)}")
        out = {}
        for key, shape in want.items():
            if isinstance(shape, (dict, list)):
                out[key] = convert(node[key], shape, f"{path}.{key}")
                continue
            dtype = dtype_of(node[key])
            arr = np.array(node[key], np.float32)          # a copy
            if arr.shape != tuple(shape):
                raise ValueError(f"LM parameter {path}.{key} has shape "
                                 f"{arr.shape}, expected {tuple(shape)}")
            out[key] = torch.from_numpy(arr).to(device=device, dtype=dtype)
        return out

    return convert(tree, param_shapes(cfg), "")
