"""Carry inputs and state across from the JAX package's formats.

Every input here is plain data (numpy arrays, dicts, JSON text), so
the port reads what the reference writes without importing it:

  - :func:`layer_specs_from_records` — layer specs given as dicts of the
    reference ``LayerSpec`` fields → the port's
    :class:`~repro_torch.perfmodel.layer_costs.LayerSpec`;
  - :func:`padded_from_numpy` — the arrays of a reference
    ``PaddedArrays`` → one-lane tensors in the layout the kernels take.

A reference ``PowerSchedule.to_json`` payload is read by the port's own
:meth:`~repro_torch.core.schedule.PowerSchedule.from_json` (same schema,
same field set).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

import numpy as np
import torch

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

