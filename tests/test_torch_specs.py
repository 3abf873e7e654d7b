"""The dry-run's stand-ins against the JAX package's, for every
(architecture × applicable shape) cell: the port's ``meta`` tensors
(``repro_torch.launch.specs`` on the one-card mesh) and the reference's
``ShapeDtypeStruct``s (``repro.launch.specs`` on its degenerate host
mesh) in shape and dtype, leaf for leaf in JAX's flatten order
(parameters, optimizer state, batches, decode states, tokens); every
placement is the card, whole.  The one-card mesh itself against the
reference's host mesh.  Every comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import all_cells as ref_all_cells
from repro.configs import get_config as ref_get_config
from repro.launch import mesh as ref_mesh
from repro.launch import specs as ref_specs
from repro.train.optimizer import AdamWConfig as RefAdamWConfig
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs
from repro_torch.train._tree import leaves
from repro_torch.train.optimizer import AdamWConfig

CELLS = [(arch, shape) for arch, shape, ok, _ in ref_all_cells() if ok]


def _ref_layout(tree) -> list:
    return [(tuple(x.shape), str(np.dtype(x.dtype)))
            for x in jax.tree.leaves(tree)]


def _layout(tree) -> list:
    out = []
    for x in leaves(tree):
        assert isinstance(x, torch.Tensor) and x.is_meta
        out.append((tuple(x.shape), str(x.dtype).removeprefix("torch.")))
    return out


def _all_on_card(placements, mesh) -> bool:
    return all(p == mesh.device for p in leaves(placements))


@pytest.fixture(scope="module")
def meshes():
    return mesh_lib.make_host_mesh(), ref_mesh.make_host_mesh()


def test_one_card_mesh_matches_the_reference_host_mesh(meshes):
    mesh, ref = meshes
    assert mesh.axis_names == tuple(ref.axis_names)
    assert mesh.shape == dict(ref.shape)
    assert mesh.size == ref.size == 1
    assert mesh.name == "card1x1"
    assert mesh.device == torch.device("cuda")
    assert mesh_lib.batch_axes(mesh) == ref_mesh.batch_axes(ref)
    assert mesh_lib.make_host_mesh("cpu").device == torch.device("cpu")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_stand_ins_match_the_reference(arch, shape, meshes):
    mesh, rmesh = meshes
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    cell, ref_cell = SHAPES[shape], REF_SHAPES[shape]
    params, placed = specs.abstract_model(cfg, mesh)
    ref_params, _ = ref_specs.abstract_model(ref_cfg, rmesh)
    assert _layout(params) == _ref_layout(ref_params)
    assert _all_on_card(placed, mesh)

    if cell.kind == "train":
        big = cfg.n_params() > 5e10
        moments = "bfloat16" if big else "float32"
        opt, opt_pl = specs.abstract_opt_state(
            params, placed, AdamWConfig(moment_dtype=moments), mesh)
        ref_opt, _ = ref_specs.abstract_opt_state(
            ref_params, None, RefAdamWConfig(moment_dtype=moments), rmesh)
        assert _layout(opt) == _ref_layout(ref_opt)
        assert _all_on_card(opt_pl, mesh)
    if cell.kind in ("train", "prefill"):
        batch, batch_pl = specs.train_batch_specs(cfg, cell, mesh)
        ref_batch, _ = ref_specs.train_batch_specs(ref_cfg, ref_cell, rmesh)
        assert sorted(batch) == sorted(ref_batch)
        assert _layout(batch) == _ref_layout(ref_batch)
        assert _all_on_card(batch_pl, mesh)
    else:
        state, state_pl = specs.decode_state_specs(cfg, cell, mesh)
        ref_state, _ = ref_specs.decode_state_specs(ref_cfg, ref_cell, rmesh)
        assert sorted(state) == sorted(ref_state)
        assert _layout(state) == _ref_layout(ref_state)
        for key, val in state.items():
            if isinstance(val, tuple):   # the recurrent states' types
                assert type(val).__name__ == type(ref_state[key]).__name__
        assert _all_on_card(state_pl, mesh)
        tokens, tok_pl = specs.decode_token_specs(cell, mesh)
        ref_tokens, _ = ref_specs.decode_token_specs(ref_cell, rmesh)
        assert _layout(tokens) == _ref_layout(ref_tokens)
        assert tok_pl == mesh.device
