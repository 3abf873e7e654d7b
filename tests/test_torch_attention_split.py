"""The split-sequence decode and the dtype routing of the prefill
attention (``repro_torch.kernels.flash_decode`` and
``flash_attention``), held on the CPU against the JAX package.

``flash_decode_split_plain`` is the decode kernel's two-pass algorithm
(a float32 partial per chunk of the cache, then a combine in chunk
order) in plain PyTorch; it is held against the one-pass plain version
and against the Pallas kernel in interpret mode.  Tolerances are those
of ``tests/test_kernels.py``: 3e-5 absolute in float32 (summation order
differs), 2e-2 in bfloat16 (``p`` is rounded to bfloat16 against each
chunk's own maximum).

The wrappers are then called on fake CUDA tensors (this host has no
card) with recording stand-ins for the kernel libraries: the decode
wrapper allocates its scratch, picks its split count without reading
``length`` (a data-dependent read raises under ``FakeTensorMode``) and
computes no plain version; bfloat16 attention reaches the tensor-core
entry point and float32 the CUDA-core one.
"""

import contextlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.flash_decode import flash_decode as pallas_decode
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(x).to(TORCH[dtype])


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


# (b, h, kh, s, d, bs, n_split, dtype, lengths): bs is the Pallas
# kernel's block; lengths of 0 and S, chunks wholly past the length,
# n_split not dividing S, n_split = 1, n_split > S, G = 1 and 8
SPLIT_CASES = [
    (3, 8, 1, 96, 32, 32, 5, "float32", [0, 96, 17]),
    (2, 4, 4, 128, 16, 64, 1, "float32", [128, 50]),
    (2, 8, 8, 64, 64, 32, 3, "bfloat16", [64, 0]),
    (4, 16, 2, 256, 64, 64, 8, "bfloat16", [1, 256, 100, 200]),
    (2, 8, 1, 8, 16, 8, 11, "float32", [3, 8]),
    (2, 8, 4, 192, 128, 64, 7, "bfloat16", [191, 65]),
]


@pytest.mark.parametrize("b,h,kh,s,d,bs,n_split,dtype,lens", SPLIT_CASES)
def test_split_plain_matches_plain_and_pallas(b, h, kh, s, d, bs, n_split,
                                              dtype, lens):
    rng = np.random.default_rng(s * 3 + d + n_split)
    qj, qt = _pair(rng, (b, h, d), dtype)
    kj, kt = _pair(rng, (b, s, kh, d), dtype)
    vj, vt = _pair(rng, (b, s, kh, d), dtype)
    lens = np.asarray(lens, np.int32)
    got = fd.flash_decode_split_plain(qt, kt, vt, torch.from_numpy(lens),
                                      n_split)
    assert got.dtype == TORCH[dtype] and got.shape == (b, h, d)
    plain = fd.flash_decode_plain(qt, kt, vt, torch.from_numpy(lens))
    pallas = pallas_decode(qj, kj, vj, jnp.asarray(lens), bs=bs,
                           interpret=True)
    tol = TOL[dtype]
    assert np.max(np.abs(_f32(got) - _f32(plain))) < tol
    assert np.max(np.abs(_f32(got) - _f32(pallas))) < tol
    for i in np.flatnonzero(lens == 0):
        assert torch.all(got[i] == 0)


def test_split_plain_with_one_split_is_the_plain_version():
    """One chunk is the one-pass algorithm: the combine's weight is
    exp(0) = 1, so the two agree to the last bit."""
    rng = np.random.default_rng(1)
    _, q = _pair(rng, (2, 8, 32), "float32")
    _, k = _pair(rng, (2, 40, 2, 32), "float32")
    _, v = _pair(rng, (2, 40, 2, 32), "float32")
    lens = torch.tensor([40, 9], dtype=torch.int32)
    assert torch.equal(fd.flash_decode_split_plain(q, k, v, lens, 1),
                       fd.flash_decode_plain(q, k, v, lens))


def test_decode_splits_is_pure_and_fills_the_card():
    """A function of two integers: the same answer on every call, and at
    tinyllama-1.1b's decode batch (B = 16, KH = 4, S = 2048) more CTAs
    than the H100's 132 SMs; each chunk at least MIN_CHUNK positions
    (or the whole cache)."""
    assert fd.decode_splits(2048, 132) == fd.decode_splits(2048, 132)
    assert 16 * 4 * fd.decode_splits(2048, 132) > 132
    for cap in (0, 1, 63, 64, 65, 96, 1001, 2048, 10 ** 6):
        for sms in (1, 16, 132):
            ns = fd.decode_splits(cap, sms)
            assert 1 <= ns <= max(1, sms // fd.SMS_PER_SPLIT)
            if cap:
                assert math.ceil(cap / ns) >= min(cap, fd.MIN_CHUNK)


class _Library:
    """Stands in for a loaded kernel library: records each call of its
    entry point and returns cudaSuccess."""

    def __init__(self, entry):
        self.calls = []
        setattr(self, entry, self._record)

    def _record(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def fake_card(monkeypatch):
    """What a launch needs from the card, stubbed: no stream, no device
    context, 132 SMs; the launch counts restored afterwards."""
    monkeypatch.setattr(fa, "stream_of", lambda device: 0)
    monkeypatch.setattr(fd, "stream_of", lambda device: 0)
    monkeypatch.setattr(fd, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setitem(fa.LAUNCHES, "flash_attention", 0)
    monkeypatch.setitem(fd.LAUNCHES, "flash_decode", 0)


def _refuse(*args, **kwargs):
    raise AssertionError("the plain version ran on a CUDA tensor")


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_fake_cuda_decode_allocates_scratch_and_reads_no_length(
        monkeypatch, fake_card):
    lib = _Library("pfdnn_flash_decode")
    monkeypatch.setattr(fd.LIBRARY, "load", lambda: lib)
    monkeypatch.setattr(fd, "flash_decode_plain", _refuse)
    monkeypatch.setattr(fd, "flash_decode_split_plain", _refuse)
    empties = []
    empty = torch.empty

    def recording_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        empties.append(t)
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    B, S, KH, H, D = 16, 2048, 4, 32, 64
    with FakeTensorMode():
        q = empty(B, H, D, device="cuda", dtype=torch.bfloat16)
        cache = empty(B, S, KH, D, device="cuda", dtype=torch.bfloat16)
        lens = empty(B, device="cuda", dtype=torch.int32)
        with pytest.raises(Exception):     # a read of length would raise
            int(lens.max())
        out = fd.flash_decode(q, cache, cache, lens)
    assert out.shape == (B, H, D) and out.dtype == torch.bfloat16
    assert len(lib.calls) == 1
    n_split = lib.calls[0][11]
    assert n_split == fd.decode_splits(S, 132) and KH * B * n_split > 132
    scratch = [t for t in empties if t.dtype == torch.float32]
    assert len(scratch) == 1
    assert scratch[0].device.type == "cuda"
    assert scratch[0].numel() == B * H * n_split * (D + 2)
    assert fd.LAUNCHES["flash_decode"] == 1


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_fake_cuda_attention_routes_by_dtype(monkeypatch, fake_card):
    f32 = _Library("pfdnn_flash_attention_f32")
    bf16 = _Library("pfdnn_flash_attention_bf16")
    monkeypatch.setattr(fa.LIBRARY, "load", lambda: f32)
    monkeypatch.setattr(fa.WGMMA_LIBRARY, "load", lambda: bf16)
    monkeypatch.setattr(fa, "flash_attention_plain", _refuse)
    with FakeTensorMode():
        for dtype in (torch.bfloat16, torch.float32, torch.bfloat16):
            q = torch.empty(2, 8, 100, 64, device="cuda", dtype=dtype)
            kv = torch.empty(2, 2, 130, 64, device="cuda", dtype=dtype)
            out = fa.flash_attention(q, kv, kv, causal=True, q_offset=30)
            assert out.dtype == dtype and out.shape == q.shape
    assert len(bf16.calls) == 2 and len(f32.calls) == 1
    for call in bf16.calls + f32.calls:
        # B, H, KH, Sq, Sk, D, q_offset, causal
        assert call[4:12] == (2, 8, 2, 100, 130, 64, 30, 1)
    assert fa.LAUNCHES["flash_attention"] == 3
