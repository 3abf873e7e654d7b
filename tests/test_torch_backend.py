"""The port's ``TorchBackend`` lane API over a ``BucketStack``, held on
the CPU against the reference ``NumpyBackend``'s stacked calls on the
same lanes (real rail-subset problems of SqueezeNet1.1), plus the
mirror's upload accounting and the non-stacked entry points.
Tolerance: exact (paths equal, k-best rows below ``counts`` equal,
cost sums bit-equal)."""

import numpy as np
import pytest
import torch

from conftest import max_rate
from repro.core.backend import NumpyBackend, stack_padded
from repro.core.context import CompilationContext as RefContext
from repro.core.lambda_dp import solve_lambda_dp as ref_solve
from repro.models.edge_cnn import edge_network as ref_network
from repro_torch.core import backend as tb
from repro_torch.core.context import CompilationContext
from repro_torch.core.lambda_dp import solve_lambda_dp
from repro_torch.models.edge_cnn import edge_network

NET = "squeezenet1.1"
# five subsets that share the (L, S_pad) bucket of the 2-rail subsets
SUBSETS = [(1.3, 1.2), (1.3, 1.0), (1.25, 0.9), (1.1, 0.95), (1.2, 1.15)]


@pytest.fixture(scope="module")
def problems():
    t_max = 1.0 / (max_rate(NET) * 0.7)
    ref_ctx = RefContext(ref_network(NET), network=NET)
    ctx = CompilationContext(edge_network(NET), network=NET)
    kw = dict(gating=True, allow_sleep=True, t_max=t_max)
    ref = [ref_ctx.problem_for(r, **kw) for r in SUBSETS]
    port = [ctx.problem_for(r, **kw) for r in SUBSETS]
    return ref, port


@pytest.fixture
def store(problems):
    _, port = problems
    padded = [p.padded_arrays() for p in port]
    assert len({(p.n_layers, p.s_pad) for p in padded}) == 1
    bs = tb.BucketStack(padded[0].n_layers, padded[0].s_pad)
    for i, p in enumerate(padded):
        assert bs.add(("subset", i), p) == i
    return bs


def _members(problems, lanes):
    ref, _ = problems
    return stack_padded([ref[i].padded_arrays() for i in lanes],
                        with_switch=False)


def test_dp_lanes_match_numpy_stacked(problems, store):
    bk = tb.TorchBackend("cpu")
    lanes = [3, 0, 4]
    w_e = np.array([[0.0, 1.0, 1.0, 1.0]] * 3)
    w_t = np.array([[1.0, 0.0, -1e-3, 5.0], [1.0, 0.0, 2.0, 0.5],
                    [1.0, 0.0, 1e-4, 50.0]])
    got = bk.dp_multi_lanes(store, lanes, w_e, w_t)
    want = NumpyBackend().dp_multi_stacked(_members(problems, lanes),
                                           w_e, w_t)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    pend = bk.dp_multi_lanes(store, lanes, w_e, w_t, defer=True)
    assert isinstance(pend, tb.PendingResult)
    np.testing.assert_array_equal(pend.get(), want)


def test_kbest_lanes_match_numpy_stacked(problems, store):
    bk = tb.TorchBackend("cpu")
    lanes = [1, 2]
    mus = np.array([[0.02, 0.02 - 1e-4], [3.0, 0.0]])
    paths, counts = bk.kbest_multi_lanes(store, lanes, mus, 10)
    want_p, want_c = NumpyBackend().kbest_multi_stacked(
        _members(problems, lanes), mus, 10)
    np.testing.assert_array_equal(counts, want_c)
    for b in range(2):
        for q in range(2):
            n = counts[b, q]
            np.testing.assert_array_equal(paths[b, q, :n],
                                          want_p[b, q, :n])


def test_path_costs_lanes_match_numpy_stacked(problems, store):
    ref, _ = problems
    bk = tb.TorchBackend("cpu")
    rng = np.random.default_rng(0)
    lanes = rng.integers(0, store.n, size=40)
    paths = np.stack([[rng.integers(0, s) for s in ref[ln].sizes]
                      for ln in lanes]).astype(np.int64)
    got = bk.path_costs_lanes(store, lanes, paths, defer=True).get()
    full = stack_padded([p.padded_arrays() for p in ref])
    want = NumpyBackend().path_costs_stacked(full, lanes, paths)
    assert set(got) == set(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


def test_mirror_uploads_each_lane_once(problems, store):
    _, port = problems
    bk = tb.TorchBackend("cpu")
    w = np.ones((2, 1))
    bk.dp_multi_lanes(store, [0, 1], w, w)
    assert bk.io_stats["h2d_lane_uploads"] == store.n
    first_bytes = bk.io_stats["h2d_lane_bytes"]
    assert first_bytes > 0
    mirror = store.scratch[("torch_lanes", "cpu")]
    assert mirror.cap == 64 and mirror.arrays[0].shape[0] == 64
    bk.dp_multi_lanes(store, [2, 3], w, w)
    bk.path_costs_lanes(store, [4], np.zeros((1, store.view().n_layers),
                                             dtype=np.int64))
    assert bk.io_stats["h2d_lane_uploads"] == store.n     # warm: nothing
    assert bk.io_stats["kernel_dispatches"] == 3
    padded = port[0].padded_arrays()
    bs2 = tb.BucketStack(padded.n_layers, padded.s_pad)
    for i in range(70):                    # past the 64-lane floor
        bs2.add(i, padded)
    bk.dp_multi_lanes(bs2, [69], np.ones((1, 1)), np.ones((1, 1)))
    m2 = bs2.scratch[("torch_lanes", "cpu")]
    assert m2.cap == 128 and m2.n == 70
    assert bk.io_stats["h2d_lane_uploads"] == store.n + 70
    bs2.add("one more", padded)
    bk.dp_multi_lanes(bs2, [70], np.ones((1, 1)), np.ones((1, 1)))
    assert bk.io_stats["h2d_lane_uploads"] == store.n + 71


def test_lane_index_out_of_range_raises(store):
    bk = tb.TorchBackend("cpu")
    with pytest.raises(IndexError):
        bk.dp_multi_lanes(store, [store.n], np.ones((1, 1)),
                          np.ones((1, 1)))


def test_non_stacked_entry_points_match_numpy(problems):
    ref, port = problems
    bk = tb.TorchBackend("cpu")
    nb = NumpyBackend()
    w_e = np.array([0.0, 1.0, 1.0])
    w_t = np.array([1.0, 0.0, 0.03])
    np.testing.assert_array_equal(
        bk.dp_multi(port[2].padded_arrays(), w_e, w_t),
        nb.dp_multi(ref[2].padded_arrays(), w_e, w_t))
    p, c = bk.kbest_multi(port[2].padded_arrays(), w_t, 10)
    wp, wc = nb.kbest_multi(ref[2].padded_arrays(), w_t, 10)
    np.testing.assert_array_equal(c, wc)
    for q in range(len(w_t)):
        np.testing.assert_array_equal(p[q, :c[q]], wp[q, :wc[q]])
    paths = nb.dp_multi(ref[2].padded_arrays(), w_e, w_t)
    got = bk.path_costs(port[2], paths)
    want = nb.path_costs(ref[2], paths)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_solve_lambda_dp_matches_reference(problems):
    """The sequential λ search (non-stacked kernels, B = 1)."""
    ref, port = problems
    best, cands, stats = solve_lambda_dp(port[1], backend="cpu")
    rbest, rcands, rstats = ref_solve(ref[1])
    assert best["path"] == rbest["path"]
    assert best["e_total"] == rbest["e_total"]
    assert [c["path"] for c in cands] == [c["path"] for c in rcands]
    assert stats.dp_calls == rstats.dp_calls
    assert stats.backend == "torch"


def test_cuda_backend_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tb.TorchBackend("cuda")


def test_get_backend_caches_per_device():
    a = tb.get_backend("cpu")
    assert tb.get_backend("cpu") is a and tb.get_backend(a) is a
    assert a.device == torch.device("cpu")
