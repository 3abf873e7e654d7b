"""The grouped path-cost gather (``repro_torch.kernels.dp_sweep.
path_components_grouped`` and ``TorchBackend.path_costs_grouped``), held
on the CPU against the JAX package: ``NumpyBackend.path_costs_stacked``
and ``path_components_pallas`` in interpret mode, per group, over lane
stores of different ``(L, S)`` in one call; and the round scheduler's
one-gather-per-evaluation-pass against the reference compile.

On CPU tensors the wrapper computes its plain version from the same
packet (descriptors, lanes, paths) the CUDA kernel reads; the kernel is
held against that plain version on the card by ``chip_smoke.py``.
Tolerance: exact (``==`` on float64, as
``tests/test_torch_kernels.py`` holds the one-group gather).
"""

import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from conftest import max_rate
from repro.core import MinEnergy as RefMinEnergy
from repro.core import OrchestratorConfig as RefConfig
from repro.core import compile as ref_compile
from repro.core.backend import NumpyBackend, StackedArrays
from repro.kernels.dp_sweep import path_components_pallas
from repro.models.edge_cnn import edge_network as ref_network
from repro_torch.core import MinEnergy, OrchestratorConfig, compile
from repro_torch.core import backend as tb
from repro_torch.kernels import dp_sweep as ks
from repro_torch.models.edge_cnn import edge_network

COMPONENTS = ("t_op", "e_op", "t_trans", "e_trans", "n_switch")


def _store(seed, cap, L, S):
    """A BucketStack of ``cap`` random lanes (valid prefixes, values on
    a coarse grid, finite garbage in the pad slots) and its generator."""
    rng = np.random.default_rng(seed)
    bs = tb.BucketStack(L, S)
    for b in range(cap):
        sizes = tuple(int(n) for n in rng.integers(1, S + 1, size=L))
        valid = np.arange(S)[None, :] < np.array(sizes)[:, None]
        padded = tb.PaddedArrays(
            t_op=np.where(valid, rng.integers(1, 9, (L, S)) * 0.125, 0.0),
            e_op=np.where(valid, rng.integers(1, 9, (L, S)) * 0.25, 0.0),
            valid=valid,
            t_trans=rng.integers(0, 5, (L - 1, S, S)) * 0.0625,
            e_trans=rng.integers(0, 5, (L - 1, S, S)) * 0.5,
            switch=rng.integers(0, 3, (L - 1, S, S)).astype(np.int64),
            sizes=sizes)
        assert bs.add(("lane", b), padded) == b
    return bs, rng


def _paths(rng, bs, P):
    view = bs.view()
    lanes = rng.integers(0, bs.n, size=P).astype(np.int64)
    sizes = view.valid.sum(axis=2)                      # [n, L]
    paths = (rng.random((P, view.n_layers)) * sizes[lanes]).astype(np.int64)
    return lanes, paths


def _full(bs):
    v = bs.view()
    return StackedArrays(t_op=v.t_op, e_op=v.e_op, valid=v.valid,
                         t_trans=v.t_trans, e_trans=v.e_trans,
                         switch=v.switch, max_sizes=v.max_sizes)


# (seed, [(lanes in the store, L, S, paths), ...]): stores of different
# (L, S) in one call, L = 2 among them, an empty group, an L = 1 group
GROUPS = [
    pytest.param(1, [(5, 6, 8, 11), (3, 2, 4, 7), (4, 4, 16, 0)],
                 id="L6S8-L2S4-empty"),
    pytest.param(2, [(4, 2, 16, 9), (6, 5, 8, 13)], id="L2S16-L5S8"),
    pytest.param(3, [(3, 3, 4, 5), (2, 1, 8, 4), (5, 7, 32, 17)],
                 id="L3S4-L1S8-L7S32"),
]


def _make(seed, spec):
    out = []
    for i, (cap, L, S, P) in enumerate(spec):
        bs, rng = _store(100 * seed + i, cap, L, S)
        lanes, paths = _paths(rng, bs, P)
        out.append((bs, lanes, paths))
    return out


@pytest.mark.parametrize("seed,spec", GROUPS)
def test_grouped_costs_equal_numpy_and_pallas(seed, spec):
    groups = _make(seed, spec)
    got = tb.TorchBackend("cpu").path_costs_grouped(groups, defer=True).get()
    assert len(got) == len(groups)
    for (bs, lanes, paths), costs in zip(groups, got):
        want = NumpyBackend().path_costs_stacked(_full(bs), lanes, paths)
        assert set(costs) == set(want)
        for key in want:
            assert costs[key].dtype == want[key].dtype
            assert costs[key].shape == (len(lanes),)
            assert (costs[key] == want[key]).all(), key


@pytest.mark.parametrize("seed,spec", GROUPS)
def test_grouped_plain_components_equal_pallas_interpret(seed, spec):
    groups = [g for g in _make(seed, spec)
              if len(g[1]) and g[0].view().n_layers >= 2]
    mirrors, lanes, paths = [], [], []
    for bs, ln, pa in groups:
        v = bs.view()
        mirrors.append(tuple(torch.from_numpy(np.ascontiguousarray(a))
                             for a in (v.t_op, v.e_op, v.t_trans,
                                       v.e_trans, v.switch)))
        lanes.append(ln)
        paths.append(pa)
    before = dict(ks.LAUNCHES)
    out, layout = ks.path_components_grouped(mirrors, lanes, paths)
    assert ks.LAUNCHES == before          # the CPU takes the plain version
    assert out.dtype == torch.float64 and out.shape == (layout.out_words,)
    parts = ks.split_components(out.numpy(), layout)
    for (bs, ln, pa), comps in zip(groups, parts):
        v = bs.view()
        with jax.enable_x64(True):
            pal = path_components_pallas(ln, pa, v.t_op, v.e_op, v.t_trans,
                                         v.e_trans, v.switch, interpret=True)
        for got, want in zip(comps, pal):
            assert got.flags.c_contiguous
            assert got.dtype == np.asarray(want).dtype
            assert (got == np.asarray(want)).all()


def test_a_group_does_not_depend_on_its_neighbours():
    groups = _make(4, [(5, 6, 8, 11), (3, 2, 4, 7), (5, 7, 32, 17)])
    bk = tb.TorchBackend("cpu")
    together = bk.path_costs_grouped(groups)
    for group, costs in zip(groups, together):
        alone = bk.path_costs_lanes(*group)
        for key in COMPONENTS:
            assert (alone[key] == costs[key]).all()
    assert bk.path_costs_grouped([]) == []


def test_packet_layout_and_offsets():
    groups = _make(5, [(5, 6, 8, 11), (3, 2, 4, 7), (5, 7, 32, 300)])
    mirrors = [tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        bs.view().t_op, bs.view().e_op, bs.view().t_trans,
        bs.view().e_trans, bs.view().switch)) for bs, _, _ in groups]
    packet, layout = ks.pack_gather(mirrors, [g[1] for g in groups],
                                    [g[2] for g in groups])
    host = packet.numpy()
    G = len(groups)
    assert layout.shapes == ((11, 6), (7, 2), (300, 7))
    assert layout.node_off == (0, 66, 80)
    assert layout.trans_off == (0, 55, 62)
    assert layout.n_node == 66 + 14 + 2100 and layout.n_trans == 55 + 7 + 1800
    assert layout.blocks == 1 + 1 + 9
    lane_at = G * ks.GD_WORDS
    path_at = lane_at + 11 + 7 + 300
    assert host.size == path_at + layout.n_node
    for g, ((bs, ln, pa), mirror) in enumerate(zip(groups, mirrors)):
        row = host[g * ks.GD_WORDS:(g + 1) * ks.GD_WORDS]
        assert list(row[:5]) == [t.data_ptr() for t in mirror]
        assert (row[ks.GD_L], row[ks.GD_S], row[ks.GD_P]) == (
            pa.shape[1], bs.view().s_pad, len(ln))
        assert row[ks.GD_NODE] == layout.node_off[g]
        assert row[ks.GD_TRANS] == layout.trans_off[g]
        assert (host[row[ks.GD_LANES]:row[ks.GD_LANES] + len(ln)] == ln).all()
        assert (host[row[ks.GD_PATHS]:row[ks.GD_PATHS] + pa.size]
                == pa.reshape(-1)).all()
    assert [r[ks.GD_BLOCK] for r in host[:G * ks.GD_WORDS].reshape(
        G, ks.GD_WORDS)] == [0, 1, 2]


@pytest.mark.parametrize("bad", [0, 1, 2])
@pytest.mark.parametrize("what", ["state", "negative", "lane"])
def test_an_out_of_range_index_in_any_group_raises(bad, what):
    groups = _make(6, [(5, 6, 8, 11), (3, 2, 4, 7), (2, 1, 8, 4)])
    bs, lanes, paths = groups[bad]
    lanes, paths = lanes.copy(), paths.copy()
    if what == "state":
        paths[-1, -1] = bs.view().s_pad
    elif what == "negative":
        paths[0, 0] = -1
    else:
        lanes[1] = bs.n
    groups[bad] = (bs, lanes, paths)
    bk = tb.TorchBackend("cpu")
    with pytest.raises(IndexError):
        bk.path_costs_grouped(groups)
    # nothing was gathered, nor any mirror built, before the check
    assert bk.io_stats["gather_calls"] == 0


def test_mismatched_path_width_raises():
    groups = _make(7, [(5, 6, 8, 3)])
    bs, lanes, paths = groups[0]
    with pytest.raises(ValueError):
        tb.TorchBackend("cpu").path_costs_grouped([(bs, lanes, paths[:, 1:])])


GOLDEN = json.loads((pathlib.Path(__file__).parent / "golden"
                     / "pipeline.json").read_text())
PFDNN_KEYS = [k for k in GOLDEN if k.endswith("|pfdnn")]
HOST_STATS = ("wall_time_s", "backend", "ilp_wall_time_s")


def _host_free_json(sched) -> str:
    stats = {k: v for k, v in sched.solver_stats.items()
             if k not in HOST_STATS}
    return type(sched)(**{**vars(sched), "solver_stats": stats}).to_json()


@pytest.mark.parametrize("key", PFDNN_KEYS)
def test_one_gather_per_pass_reproduces_pfdnn_goldens(key, monkeypatch):
    """``run_stacked_sweeps`` costs each evaluation pass in one grouped
    call (never the one-bucket ``path_costs_lanes``), and the schedule
    is byte-identical to the reference's."""
    calls = []
    grouped = tb.TorchBackend.path_costs_grouped

    def spy(self, groups, **kw):
        calls.append(len(groups))
        return grouped(self, groups, **kw)

    def refuse(self, *args, **kw):
        raise AssertionError("the sweep called path_costs_lanes")

    monkeypatch.setattr(tb.TorchBackend, "path_costs_grouped", spy)
    monkeypatch.setattr(tb.TorchBackend, "path_costs_lanes", refuse)
    net, frac, n_rails, policy = key.split("|")
    rate = max_rate(net) * float(frac)
    sched = compile(edge_network(net), MinEnergy(rate_hz=rate),
                    cfg=OrchestratorConfig(policy=policy,
                                           n_max_rails=int(n_rails),
                                           device="cpu"), network=net)
    ref = ref_compile(ref_network(net), RefMinEnergy(rate_hz=rate),
                      cfg=RefConfig(policy=policy, n_max_rails=int(n_rails),
                                    backend="numpy"), network=net)
    assert _host_free_json(sched) == _host_free_json(ref)
    # every bucket of a pass rode in one call: the buckets' logical calls
    # (the reference's count, kept in the stats) add up to the groups
    assert calls and min(calls) >= 1
    assert sum(calls) <= sched.solver_stats["stacked_calls"]
    assert len(calls) < sum(calls) or max(calls) == 1


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_cuda_mirrors_go_to_the_kernel_never_the_plain_version(monkeypatch):
    """On CUDA tensors (fake ones here: this host has no card) the grouped
    wrapper validates for the kernel and loads its library; it never
    computes the plain version.  The library load is stubbed to raise,
    as the build does on a host without ``nvcc``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    class Loaded(Exception):
        pass

    def refuse():
        raise Loaded

    def no_plain(*args):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(ks, "load_library", refuse)
    monkeypatch.setattr(ks, "path_components_grouped_plain", no_plain)
    before = dict(ks.LAUNCHES)
    with FakeTensorMode():
        def mirror(cap, L, S):
            f = torch.empty((cap, L, S), dtype=torch.float64, device="cuda")
            t = torch.empty((cap, L - 1, S, S), dtype=torch.float64,
                            device="cuda")
            return f, f, t, t, t.long()

        lanes = [np.zeros(3, np.int64), np.zeros(2, np.int64)]
        paths = [np.zeros((3, 4), np.int64), np.zeros((2, 2), np.int64)]
        with pytest.raises(Loaded):
            ks.path_components_grouped([mirror(2, 4, 8), mirror(3, 2, 4)],
                                       lanes, paths)
        # a group whose mirror does not match its paths' L is refused
        with pytest.raises(ValueError):
            ks.path_components_grouped([mirror(2, 5, 8)], lanes[:1],
                                       paths[:1])
    assert ks.LAUNCHES == before
