"""The DP and k-best kernels' plain versions (``repro_torch.kernels.
dp_sweep``, what their wrappers compute on CPU tensors) on tie-heavy and
inf-heavy inputs, held against the JAX package's Pallas kernels in
interpret mode (float64) and against ``NumpyBackend``'s stacked
kernels.

The shapes are those ``chip_smoke.py`` holds the CUDA kernels to on the
card (``KERNEL_EDGES``): values on a coarse grid, so ties abound in every
argmin and every k-best merge; lanes with one or three valid states a
layer, so fewer finite paths than k; L = 1 and 2; S = 1, odd S and S
not a multiple of 32; S = 200 (the kernels tile its slabs); and more μ
values than one CTA takes.  Tolerance: exact (integer paths and counts
equal; k-best rows past ``counts`` carry no contract).
"""

import jax
import numpy as np
import pytest
import torch

from repro.core.backend import NumpyBackend, StackedArrays
from repro.kernels.dp_sweep import (
    dp_multi_stacked_pallas,
    kbest_multi_stacked_pallas,
)
from repro_torch.kernels import dp_sweep as ks

# (seed, lanes in the store, lanes in the call, L, S, DP columns, μ
# values, k, sparse)
EDGES = [
    pytest.param(1, 4, 3, 6, 64, 20, 2, 10, False, id="ties-S64"),
    pytest.param(2, 4, 3, 9, 64, 20, 2, 10, True, id="sparse-S64"),
    pytest.param(3, 3, 2, 2, 64, 7, 2, 10, False, id="L2"),
    pytest.param(4, 3, 3, 1, 16, 5, 3, 4, False, id="L1"),
    pytest.param(5, 3, 2, 7, 1, 4, 2, 3, False, id="S1"),
    pytest.param(6, 4, 3, 8, 45, 20, 2, 10, True, id="sparse-S45"),
    pytest.param(7, 3, 2, 5, 37, 3, 1, 7, False, id="S37-odd-k"),
    pytest.param(8, 3, 2, 4, 200, 20, 2, 10, False, id="S200-tiled"),
    pytest.param(10, 3, 3, 5, 64, 9, 12, 10, False, id="mu12"),
]


def _store(seed, cap, L, S, sparse):
    """As chip_smoke's ``synthetic_lanes``, on the host."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, S + 1, size=(cap, L))
    sizes[0, :] = S
    if sparse:
        sizes[1:] = 1
        sizes[np.arange(1, cap), rng.integers(0, L, size=cap - 1)] = min(S, 3)
    valid = np.arange(S)[None, None, :] < sizes[:, :, None]
    t_op = np.where(valid, rng.integers(1, 5, (cap, L, S)) * 0.25, 0.0)
    e_op = np.where(valid, rng.integers(1, 5, (cap, L, S)) * 0.5, 0.0)
    t_trans = rng.integers(0, 3, (cap, max(L - 1, 0), S, S)) * 0.125
    e_trans = rng.integers(0, 3, (cap, max(L - 1, 0), S, S)) * 0.25
    return t_op, e_op, valid, t_trans, e_trans


def _weights(seed, B, K):
    """As chip_smoke's ``tie_weights``."""
    rng = np.random.default_rng(seed)
    w_e = rng.choice([0.0, 1.0, 1.0, 0.5], size=(B, K))
    w_t = rng.choice([0.0, 1.0, 2.0, -0.25, 0.75], size=(B, K))
    w_e[:, 0], w_t[:, 0] = 0.0, 1.0
    mus = rng.choice([0.0, 0.5, 1.0, -0.125, 3.0], size=(B, K))
    return w_e, w_t, mus


def _setup(seed, cap, B, L, S, sparse):
    arrs = _store(seed, cap, L, S, sparse)
    lanes = np.array([cap - 1 - i for i in range(B)], np.int64)
    members = tuple(a[lanes] for a in arrs)
    sizes = members[2].sum(axis=2).max(axis=0)
    mem = StackedArrays(*members,
                        switch=np.zeros(members[3].shape, np.int64),
                        max_sizes=tuple(int(s) for s in sizes))
    tens = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs)
    return tens + (torch.from_numpy(lanes),), mem


@pytest.mark.parametrize("seed,cap,B,L,S,K,Km,k,sparse", EDGES)
def test_dp_ties_and_invalid_states_match_pallas_and_numpy(
        seed, cap, B, L, S, K, Km, k, sparse):
    args, mem = _setup(seed, cap, B, L, S, sparse)
    w_e, w_t, _ = _weights(seed, B, K)
    got = ks.dp_multi_stacked(*args, torch.from_numpy(w_e),
                              torch.from_numpy(w_t)).numpy()
    np.testing.assert_array_equal(
        got, NumpyBackend().dp_multi_stacked(mem, w_e, w_t))
    with jax.enable_x64(True):
        pal = dp_multi_stacked_pallas(mem.t_op, mem.e_op, mem.valid,
                                      mem.t_trans, mem.e_trans, w_e, w_t,
                                      interpret=True)
    np.testing.assert_array_equal(got, np.asarray(pal))


def _assert_kbest_equal(got_p, got_c, want_p, want_c):
    np.testing.assert_array_equal(got_c, want_c)
    B, K = got_c.shape
    for b in range(B):
        for q in range(K):
            n = int(got_c[b, q])
            np.testing.assert_array_equal(got_p[b, q, :n], want_p[b, q, :n])


@pytest.mark.parametrize("seed,cap,B,L,S,K,Km,k,sparse", EDGES)
def test_kbest_ties_and_short_lanes_match_pallas_and_numpy(
        seed, cap, B, L, S, K, Km, k, sparse):
    args, mem = _setup(seed, cap, B, L, S, sparse)
    _, _, mus = _weights(seed + 100, B, Km)
    paths, counts = ks.kbest_multi_stacked(*args, torch.from_numpy(mus), k)
    paths, counts = paths.numpy(), counts.numpy()
    if sparse:
        assert (counts < k).any()            # fewer finite paths than k
    want_p, want_c = NumpyBackend().kbest_multi_stacked(mem, mus, k)
    _assert_kbest_equal(paths, counts, want_p, want_c)
    with jax.enable_x64(True):
        pal_p, pal_c = kbest_multi_stacked_pallas(
            mem.t_op, mem.e_op, mem.valid, mem.t_trans, mem.e_trans, mus,
            k=k, interpret=True)
    _assert_kbest_equal(paths, counts, np.asarray(pal_p), np.asarray(pal_c))


def test_kbest_shared_memory_limit_follows_the_kernels_layout():
    """The wrapper's check on a CUDA tensor uses the kernel's layout: at
    S = 1024 one μ's lists (k rounded up to even) and three one-column
    stages leave room for k <= 10, at S = 64 for far more."""
    assert ks.kbest_min_smem(1024, 10) <= ks._MAX_SMEM
    assert ks.kbest_min_smem(1024, 11) > ks._MAX_SMEM
    assert ks.kbest_min_smem(64, 200) <= ks._MAX_SMEM
