"""The port's host-side tables — layer specs, characterization, bank
plan, master state tables, transition matrices and ``build_padded`` —
held elementwise equal (exact) to the reference for all four edge
networks, plus ``repro_torch.convert``'s carry-over of reference data."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.context import CompilationContext as RefContext
from repro.hw.edge40nm import EDGE40NM_DEFAULT as REF_ACC
from repro.models.edge_cnn import EDGE_NETWORKS as REF_NETWORKS
from repro.models.edge_cnn import edge_network as ref_network
from repro.perfmodel import characterize_network as ref_characterize
from repro.perfmodel import plan_banks as ref_plan_banks
from repro_torch import convert
from repro_torch.core.backend import TORCH_DTYPES
from repro_torch.core.context import CompilationContext
from repro_torch.hw.edge40nm import EDGE40NM_DEFAULT as ACC
from repro_torch.models.edge_cnn import EDGE_NETWORKS, edge_network
from repro_torch.perfmodel import characterize_network, plan_banks

# one subset per rail count, plus the widest 3-rail subset of the menu
SUBSETS = [(1.3,), (1.3, 0.9), (1.2, 1.0, 0.9), (1.3, 1.1, 0.95)]


def test_network_catalogue_and_accelerator_match():
    assert EDGE_NETWORKS == REF_NETWORKS
    assert dataclasses.asdict(ACC) == dataclasses.asdict(REF_ACC)
    assert ACC.levels() == REF_ACC.levels()


@pytest.mark.parametrize("net", EDGE_NETWORKS)
def test_specs_costs_and_bank_plan_match(net):
    specs, ref_specs = edge_network(net), ref_network(net)
    assert [dataclasses.asdict(s) for s in specs] == \
        [dataclasses.asdict(s) for s in ref_specs]
    costs = characterize_network(specs, ACC)
    ref_costs = ref_characterize(ref_specs, REF_ACC)
    assert [dataclasses.asdict(c) for c in costs] == \
        [dataclasses.asdict(c) for c in ref_costs]
    assert dataclasses.asdict(plan_banks(costs, ACC)) == \
        dataclasses.asdict(ref_plan_banks(ref_costs, REF_ACC))


def _assert_padded_equal(got, want):
    assert got.sizes == want.sizes
    for name in convert.PADDED_NAMES:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("net", EDGE_NETWORKS)
def test_master_tables_and_padded_tensors_match(net):
    ctx = CompilationContext(edge_network(net), network=net)
    ref = RefContext(ref_network(net), network=net)
    assert ctx.content_key == ref.content_key
    for gating in (True, False):
        ctx._master_arrays(gating)
        ref._master_arrays(gating)
        for attr in ("_master_volts", "_master_t_op", "_master_e_op"):
            for a, b in zip(getattr(ctx, attr)[gating],
                            getattr(ref, attr)[gating], strict=True):
                np.testing.assert_array_equal(a, b)
    t_max = 1.0
    for rails in SUBSETS:
        kw = dict(gating=True, allow_sleep=True, t_max=t_max)
        p, rp = ctx.problem_for(rails, **kw), ref.problem_for(rails, **kw)
        assert p.sizes == rp.sizes
        _assert_padded_equal(p.padded_arrays(), rp.padded_arrays())
        assert ctx.min_e_op_bound(rails, gating=True) == \
            ref.min_e_op_bound(rails, gating=True)
    assert ctx.min_t_op_bound(ctx.levels) == ref.min_t_op_bound(ref.levels)


def test_convert_carries_reference_data():
    net = "mobilenetv3-small"
    records = [dataclasses.asdict(s) for s in ref_network(net)]
    assert convert.layer_specs_from_records(records) == edge_network(net)
    with pytest.raises(ValueError, match="unknown fields"):
        convert.layer_specs_from_records([dict(records[0], bogus=1)])
    ref = RefContext(ref_network(net), network=net)
    padded = ref.problem_for((1.3, 1.0), gating=True, allow_sleep=True,
                             t_max=1.0).padded_arrays()
    tensors = convert.padded_from_numpy(
        {n: getattr(padded, n) for n in convert.PADDED_NAMES}, "cpu")
    for name, t in zip(convert.PADDED_NAMES, tensors):
        assert t.dtype == TORCH_DTYPES[getattr(padded, name).dtype]
        np.testing.assert_array_equal(t[0].numpy(), getattr(padded, name))
    with pytest.raises(ValueError, match="shape"):
        convert.padded_from_numpy(
            {n: getattr(padded, n)[..., :1] if n == "switch"
             else getattr(padded, n) for n in convert.PADDED_NAMES}, "cpu")
    assert tensors[0].device == torch.device("cpu")
