"""The port's three solver kernels (``repro_torch.kernels.dp_sweep``),
held on the CPU against the JAX package's Pallas kernels (interpret
mode, float64) and against ``NumpyBackend``'s stacked kernels.

On CPU tensors each wrapper computes its plain PyTorch version, which
repeats the CUDA kernel's arithmetic; the CUDA kernels themselves are
held against these plain versions on the card by ``chip_smoke.py``.
Tolerance: exact — integer paths equal, gathered floats bit-equal, and
host sums bit-equal to the numpy backend's.
"""

import os

import jax
import numpy as np
import pytest
import torch

from repro.core.backend import NumpyBackend, StackedArrays
from repro.kernels.dp_sweep import (
    dp_multi_stacked_pallas,
    kbest_multi_stacked_pallas,
    path_components_pallas,
)
from repro_torch.kernels import dp_sweep as ks

# (lanes in the call, store capacity, layers, padded states, λ columns)
CASES = [
    pytest.param(3, 5, 6, 8, 4, id="B3-L6-S8"),
    pytest.param(2, 4, 4, 16, 3, id="B2-L4-S16"),
    pytest.param(2, 3, 2, 4, 5, id="L2"),
    pytest.param(3, 4, 1, 8, 3, id="L1"),
]
K_BEST = 4


def _store(rng, cap, L, S):
    """A lane store of ``cap`` random problems with valid prefixes,
    forced ties (values on a coarse grid), inf-padded tails and finite
    garbage in the pad slots of the transition tensors."""
    sizes = rng.integers(1, S + 1, size=(cap, L))
    sizes[0, :] = S                        # one lane fills the bucket
    valid = np.arange(S)[None, None, :] < sizes[:, :, None]
    t_op = np.where(valid, rng.integers(1, 5, (cap, L, S)) * 0.25, 0.0)
    e_op = np.where(valid, rng.integers(1, 5, (cap, L, S)) * 0.5, 0.0)
    t_trans = rng.integers(0, 3, (cap, max(L - 1, 0), S, S)) * 0.125
    e_trans = rng.integers(0, 3, (cap, max(L - 1, 0), S, S)) * 0.25
    switch = rng.integers(0, 2, (cap, max(L - 1, 0), S, S)).astype(np.int64)
    return t_op, e_op, valid, t_trans, e_trans, switch


def _weights(rng, B, K):
    """Weight columns with zeros, exact duplicates and negative
    (idle-priced) entries, as the λ search issues them."""
    w_e = rng.choice([0.0, 1.0, 1.0, 0.5], size=(B, K))
    w_t = rng.choice([0.0, 1.0, 2.0, -0.25, 0.75], size=(B, K))
    w_e[:, 0], w_t[:, 0] = 0.0, 1.0        # the min-time column
    return w_e, w_t


def _members(arrs, lanes):
    """Host member stack of ``lanes`` (what Pallas and numpy take)."""
    t_op, e_op, valid, t_trans, e_trans, switch = (a[lanes] for a in arrs)
    sizes = valid.sum(axis=2).max(axis=0)
    return StackedArrays(t_op=t_op, e_op=e_op, valid=valid,
                         t_trans=t_trans, e_trans=e_trans, switch=switch,
                         max_sizes=tuple(int(s) for s in sizes))


def _torch(arrs, lanes):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrs) \
        + (torch.from_numpy(np.asarray(lanes, dtype=np.int64)),)


def _setup(seed, B, cap, L, S):
    rng = np.random.default_rng(seed)
    arrs = _store(rng, cap, L, S)
    lanes = rng.permutation(cap)[:B]
    return rng, arrs, lanes


@pytest.mark.parametrize("B,cap,L,S,K", CASES)
def test_dp_matches_pallas_and_numpy(B, cap, L, S, K):
    rng, arrs, lanes = _setup(10 + L, B, cap, L, S)
    w_e, w_t = _weights(rng, B, K)
    t_op, e_op, valid, t_trans, e_trans, _, idx = _torch(arrs, lanes)
    before = dict(ks.LAUNCHES)
    got = ks.dp_multi_stacked(t_op, e_op, valid, t_trans, e_trans, idx,
                              torch.from_numpy(w_e), torch.from_numpy(w_t))
    assert got.dtype == torch.int32 and got.shape == (B, K, L)
    assert ks.LAUNCHES == before          # the CPU takes the plain version
    mem = _members(arrs, lanes)
    want = NumpyBackend().dp_multi_stacked(mem, w_e, w_t)
    np.testing.assert_array_equal(got.numpy(), want)
    with jax.enable_x64(True):
        pal = dp_multi_stacked_pallas(mem.t_op, mem.e_op, mem.valid,
                                      mem.t_trans, mem.e_trans, w_e, w_t,
                                      interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pal))


def test_dp_ties_break_first_occurrence():
    """All-equal costs: every argmin picks state 0 (numpy's rule)."""
    L, S = 3, 8
    ones = torch.ones((1, L, S), dtype=torch.float64)
    trans = torch.zeros((1, L - 1, S, S), dtype=torch.float64)
    got = ks.dp_multi_stacked(ones, ones, torch.ones((1, L, S), dtype=bool),
                              trans, trans, torch.zeros(1, dtype=torch.int64),
                              torch.ones((1, 2), dtype=torch.float64),
                              torch.ones((1, 2), dtype=torch.float64))
    assert got.tolist() == [[[0] * L, [0] * L]]


def _assert_kbest_equal(got_p, got_c, want_p, want_c):
    np.testing.assert_array_equal(got_c, want_c)
    B, K = got_c.shape
    for b in range(B):
        for q in range(K):
            n = int(got_c[b, q])         # rows past counts: no contract
            np.testing.assert_array_equal(got_p[b, q, :n],
                                          want_p[b, q, :n])


@pytest.mark.parametrize("B,cap,L,S,K", CASES)
def test_kbest_matches_pallas_and_numpy(B, cap, L, S, K):
    rng, arrs, lanes = _setup(20 + L, B, cap, L, S)
    mus = rng.choice([0.0, 0.5, 1.0, -0.125, 3.0], size=(B, K))
    t_op, e_op, valid, t_trans, e_trans, _, idx = _torch(arrs, lanes)
    paths, counts = ks.kbest_multi_stacked(t_op, e_op, valid, t_trans,
                                           e_trans, idx,
                                           torch.from_numpy(mus), K_BEST)
    assert paths.dtype == counts.dtype == torch.int32
    assert paths.shape == (B, K, K_BEST, L) and counts.shape == (B, K)
    mem = _members(arrs, lanes)
    want_p, want_c = NumpyBackend().kbest_multi_stacked(mem, mus, K_BEST)
    _assert_kbest_equal(paths.numpy(), counts.numpy(), want_p, want_c)
    with jax.enable_x64(True):
        pal_p, pal_c = kbest_multi_stacked_pallas(
            mem.t_op, mem.e_op, mem.valid, mem.t_trans, mem.e_trans, mus,
            k=K_BEST, interpret=True)
    _assert_kbest_equal(paths.numpy(), counts.numpy(), np.asarray(pal_p),
                        np.asarray(pal_c))


def test_kbest_counts_fewer_finite_paths_than_k():
    """One valid state per layer: a single finite path, counts == 1."""
    L, S = 3, 4
    valid = torch.zeros((1, L, S), dtype=bool)
    valid[:, :, 0] = True
    z = torch.zeros((1, L, S), dtype=torch.float64)
    zt = torch.zeros((1, L - 1, S, S), dtype=torch.float64)
    paths, counts = ks.kbest_multi_stacked(
        z, z, valid, zt, zt, torch.zeros(1, dtype=torch.int64),
        torch.ones((1, 1), dtype=torch.float64), 5)
    assert counts.tolist() == [[1]]
    assert paths[0, 0, 0].tolist() == [0] * L


@pytest.mark.parametrize("B,cap,L,S,K", [c for c in CASES
                                          if c.values[2] >= 2])
def test_path_components_match_pallas_and_numpy(B, cap, L, S, K):
    rng, arrs, _ = _setup(30 + L, B, cap, L, S)
    P = 11
    lanes = rng.integers(0, cap, size=P)
    paths = np.stack([rng.integers(0, (arrs[2][ln].sum(axis=1))).astype(
        np.int64) for ln in lanes])
    t_op, e_op, _, t_trans, e_trans, switch, _ = _torch(arrs, lanes)
    comps = ks.path_components(torch.from_numpy(lanes),
                               torch.from_numpy(paths), t_op, e_op,
                               t_trans, e_trans, switch)
    with jax.enable_x64(True):
        pal = path_components_pallas(lanes, paths, arrs[0], arrs[1],
                                     arrs[3], arrs[4], arrs[5],
                                     interpret=True)
    for got, want in zip(comps, pal):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = StackedArrays(*arrs, max_sizes=(S,) * L)
    want = NumpyBackend().path_costs_stacked(full, lanes, paths)
    sums = [c.numpy().sum(axis=1) for c in comps]
    for key, got in zip(("t_op", "e_op", "t_trans", "e_trans", "n_switch"),
                        sums):
        np.testing.assert_array_equal(got, want[key])


def test_wrappers_reject_malformed_inputs():
    L, S = 3, 4
    f = torch.zeros((2, L, S), dtype=torch.float64)
    v = torch.ones((2, L, S), dtype=bool)
    tt = torch.zeros((2, L - 1, S, S), dtype=torch.float64)
    lanes = torch.zeros(1, dtype=torch.int64)
    w = torch.ones((1, 2), dtype=torch.float64)
    with pytest.raises(TypeError):
        ks.dp_multi_stacked(f.float(), f, v, tt, tt, lanes, w, w)
    with pytest.raises(ValueError):
        ks.dp_multi_stacked(f, f, v, tt[:, :1], tt, lanes, w, w)
    with pytest.raises(ValueError):
        ks.kbest_multi_stacked(f, f, v, tt, tt, lanes.repeat(2), w, 3)
    with pytest.raises(ValueError):
        ks.path_components(lanes, torch.zeros((1, L + 1), dtype=torch.int64),
                           f, f, tt, tt, tt.long())
    wide = ks.MAX_STATES * 2
    with pytest.raises(ValueError, match="exceed"):
        ks.dp_multi_stacked(
            torch.zeros((1, 1, wide), dtype=torch.float64),
            torch.zeros((1, 1, wide), dtype=torch.float64),
            torch.ones((1, 1, wide), dtype=bool),
            torch.zeros((1, 0, wide, wide), dtype=torch.float64),
            torch.zeros((1, 0, wide, wide), dtype=torch.float64),
            lanes, w, w)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler: the loader raises; nothing falls back to a plain
    version behind the caller's back."""
    monkeypatch.setattr(ks.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(ks, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        ks.build_library()
    assert not os.path.exists(tmp_path / "build")
