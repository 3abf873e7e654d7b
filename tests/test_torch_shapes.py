"""The dry-run's cells and parameter sizes against the JAX package:
``SHAPES``, ``SUBQUADRATIC_FAMILIES``, ``cell_applicable`` and
``all_cells`` (plain data: equal, cell for cell, with the same skip
reasons); ``param_count`` and ``param_bytes`` of every architecture's
``meta`` stand-ins against the reference's over ``tf.abstract(cfg)[0]``;
``stack_layer_inits`` and ``abstract_params`` (nothing allocated).
Every comparison is exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import module as ref_module
from repro.models import transformer as ref_tf
import repro_torch.configs as configs
from repro_torch.models import module
from repro_torch.models import transformer as tf
from repro_torch.train._tree import leaves as tree_leaves


def test_shape_cells_equal_the_reference():
    assert list(configs.SHAPES) == list(ref_configs.SHAPES)
    for name, cell in configs.SHAPES.items():
        ref = ref_configs.SHAPES[name]
        assert dataclasses.asdict(cell) == dataclasses.asdict(ref)
        assert cell.tokens == ref.tokens
    assert configs.SUBQUADRATIC_FAMILIES == ref_configs.SUBQUADRATIC_FAMILIES


def test_all_cells_equal_the_reference():
    got = configs.all_cells()
    assert len(got) == 40
    assert got == ref_configs.all_cells()
    assert sum(ok for _, _, ok, _ in got) == 32


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_cell_applicable_equals_the_reference(arch):
    cfg, ref_cfg = configs.get_config(arch), ref_configs.get_config(arch)
    for shape in configs.SHAPES:
        assert configs.cell_applicable(cfg, shape) == \
            ref_configs.cell_applicable(ref_cfg, shape)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_count_and_bytes_equal_the_reference(arch):
    params = tf.abstract(configs.get_config(arch))
    ref_params = ref_tf.abstract(ref_configs.get_config(arch))[0]
    assert module.param_count(params) == ref_module.param_count(ref_params)
    assert module.param_bytes(params) == ref_module.param_bytes(ref_params)
    leaves = tree_leaves(params)
    assert all(x.is_meta for x in leaves)
    dtype = configs.get_config(arch).torch_dtype
    assert {x.dtype for x in leaves} == {dtype}


def test_stack_layer_inits_shapes_equal_the_reference():
    cfg = configs.get_config("deepseek-v2-lite-16b").reduced()
    ref_cfg = ref_configs.get_config("deepseek-v2-lite-16b").reduced()
    got = module.stack_layer_inits(lambda: tf.init_decoder_layer(cfg), 5)
    want = ref_module.stack_layer_inits(
        lambda: ref_tf.init_decoder_layer(ref_cfg), 5)
    assert sorted(got) == sorted(want)
    for key, init in got.items():
        assert init.shape == want[key].shape
        assert init.shape[0] == 5


def test_abstract_params_allocates_nothing_and_counts_like_tensors():
    tree = {"a": module.Initializer((3, 4), module.zeros_init()),
            "b": [module.Initializer((5,), module.ones_init()),
                  {"c": module.Initializer((2, 2, 2), module.zeros_init())}]}
    meta = module.abstract_params(tree, torch.float32)
    assert meta["a"].is_meta and meta["a"].shape == (3, 4)
    assert meta["b"][1]["c"].dtype == torch.float32
    real = module.materialize(tree, torch.Generator().manual_seed(0), "cpu",
                              torch.bfloat16)
    assert module.param_count(meta) == module.param_count(real) == 12 + 5 + 8
    assert module.param_bytes(meta) == 4 * 25
    assert module.param_bytes(real) == 2 * 25
    # the reference counts numpy arrays the same way
    ref_tree = {"a": np.zeros((3, 4), np.float32),
                "b": [np.zeros(5, np.float32),
                      {"c": np.zeros((2, 2, 2), np.float32)}]}
    assert ref_module.param_count(ref_tree) == 25
    assert ref_module.param_bytes(ref_tree) == module.param_bytes(meta)
