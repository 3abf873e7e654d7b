"""The port's two attention kernels (``repro_torch.kernels.flash_attention``
and ``flash_decode``) and their ``[B, S, H, D]`` wrappers
(``repro_torch.kernels.ops``), held on the CPU against the JAX package:
the Pallas kernels in interpret mode, their ``kernels/ref.py`` oracles
and the model zoo's ``flash_attention_jnp`` / ``decode_attention_jnp``.

On CPU tensors each wrapper computes its plain PyTorch version; the
CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``.  Inputs are drawn with numpy and handed to both
packages.  Tolerances are those of ``tests/test_kernels.py``: 3e-5
absolute in float32 (summation order differs), 2e-2 in bfloat16 (the
rounding of ``p`` and of the output to bfloat16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro.kernels.flash_decode import flash_decode as pallas_decode
from repro.kernels.ref import flash_attention_ref, flash_decode_ref
from repro.models.layers import (
    AttnChunks,
    decode_attention_jnp,
    flash_attention_jnp,
)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype):
    """One numpy draw as a jax array and a torch tensor of ``dtype``
    (both round the float32 draw to nearest even: equal values)."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(x).to(TORCH[dtype])


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


# (b, h, kh, sq, sk, d, bq, bk, causal, dtype): the sweep of
# tests/test_kernels.py, plus ragged Sq = Sk = 13 (one 13-row block);
# then chip_smoke.py's float32 edges at fewer heads: every head dim the
# sweep has no float32 case for (48, 80-128), Sq = Sk = 1000 causal and
# not, Sq < Sk causal (q_offset 700) and not, GQA group 1, and Sq > Sk
# (negative q_offset) at D = 64 and 128.  The Pallas kernel takes blocks
# that divide Sq and Sk, so a ragged shape runs as one block.
ATTN_CASES = [
    (2, 4, 4, 128, 128, 64, 64, 64, True, "float32"),
    (1, 8, 2, 64, 128, 32, 32, 32, True, "float32"),
    (2, 4, 1, 128, 256, 32, 64, 128, False, "float32"),
    (1, 2, 2, 256, 256, 128, 128, 64, True, "bfloat16"),
    (1, 4, 2, 64, 64, 16, 16, 16, True, "float32"),
    (2, 4, 2, 13, 13, 16, 13, 13, True, "float32"),
    (2, 4, 2, 200, 333, 48, 200, 333, False, "float32"),
    (1, 4, 2, 130, 130, 80, 130, 130, True, "float32"),
    (1, 4, 4, 200, 200, 96, 40, 40, False, "float32"),
    (1, 8, 2, 257, 257, 112, 257, 257, True, "float32"),
    (1, 2, 2, 512, 512, 128, 256, 256, True, "float32"),
    (1, 4, 2, 1000, 1000, 64, 500, 500, True, "float32"),
    (1, 4, 2, 1000, 1000, 64, 500, 500, False, "float32"),
    (1, 4, 2, 300, 1000, 64, 300, 500, True, "float32"),
    (1, 4, 2, 100, 60, 64, 100, 60, True, "float32"),
    (1, 8, 2, 300, 170, 128, 300, 170, True, "float32"),
]


@pytest.mark.parametrize("b,h,kh,sq,sk,d,bq,bk,causal,dtype", ATTN_CASES)
def test_flash_attention_plain_matches_pallas_and_ref(b, h, kh, sq, sk, d,
                                                      bq, bk, causal,
                                                      dtype):
    rng = np.random.default_rng(sq * 7 + sk + d)
    qj, qt = _pair(rng, (b, h, sq, d), dtype)
    kj, kt = _pair(rng, (b, kh, sk, d), dtype)
    vj, vt = _pair(rng, (b, kh, sk, d), dtype)
    q_offset = (sk - sq) if causal else 0
    got = fa.flash_attention(qt, kt, vt, causal=causal, q_offset=q_offset)
    assert got.dtype == TORCH[dtype] and got.shape == (b, h, sq, d)
    assert fa.LAUNCHES["flash_attention"] == 0      # plain on the CPU
    pallas = pallas_attention(qj, kj, vj, causal=causal, bq=bq, bk=bk,
                              q_offset=q_offset, interpret=True)
    g = h // kh
    ref = flash_attention_ref(
        jnp.asarray(qj, jnp.float32),
        jnp.repeat(jnp.asarray(kj, jnp.float32), g, axis=1),
        jnp.repeat(jnp.asarray(vj, jnp.float32), g, axis=1),
        causal=causal)
    tol = TOL[dtype]
    assert np.max(np.abs(_f32(got) - _f32(pallas))) < tol
    # the oracle averages a row that sees no key uniformly; the kernels
    # give it zeros (the clamp), so it is compared on the other rows
    seen = max(0, -q_offset)
    assert np.max(np.abs(_f32(got)[:, :, seen:]
                         - _f32(ref)[:, :, seen:])) < tol
    assert np.all(_f32(got)[:, :, :seen] == 0)


@pytest.mark.parametrize("b,sq,sk,h,kh,d,chunk", [
    (2, 128, 128, 8, 2, 64, 32),     # tests/test_kernels.py's drop-in case
    (3, 13, 13, 4, 2, 16, 8),        # ragged: padded chunks in the jnp path
])
def test_attention_bshd_matches_model_zoo_attention(b, sq, sk, h, kh, d,
                                                    chunk):
    rng = np.random.default_rng(sq + d)
    qj, qt = _pair(rng, (b, sq, h, d), "float32")
    kj, kt = _pair(rng, (b, sk, kh, d), "float32")
    vj, vt = _pair(rng, (b, sk, kh, d), "float32")
    got = ops.attention_bshd(qt, kt, vt, causal=True)
    want = flash_attention_jnp(qj, kj, vj, causal=True,
                               chunks=AttnChunks(chunk, chunk))
    assert got.shape == (b, sq, h, d)
    assert np.max(np.abs(_f32(got) - _f32(want))) < 3e-5


def test_flash_attention_fully_masked_rows_are_zero():
    """Causal rows that see no key (negative ``q_offset``) give 0, as
    the reference kernel's clamp does, not a uniform average."""
    rng = np.random.default_rng(5)
    _, q = _pair(rng, (1, 2, 6, 16), "float32")
    _, k = _pair(rng, (1, 1, 4, 16), "float32")
    _, v = _pair(rng, (1, 1, 4, 16), "float32")
    out = fa.flash_attention(q, k, v, causal=True, q_offset=-2)
    assert torch.all(out[:, :, :2] == 0)
    assert torch.all(out[:, :, 2:].abs().sum(-1) > 0)


# (b, h, kh, s, d, bs, dtype): tests/test_kernels.py's decode sweep
DECODE_CASES = [
    (2, 4, 4, 256, 64, 64, "float32"),
    (3, 8, 2, 128, 32, 32, "float32"),
    (1, 4, 1, 512, 128, 128, "bfloat16"),
]


@pytest.mark.parametrize("b,h,kh,s,d,bs,dtype", DECODE_CASES)
def test_flash_decode_plain_matches_pallas_and_ref(b, h, kh, s, d, bs,
                                                   dtype):
    rng = np.random.default_rng(s + d)
    qj, qt = _pair(rng, (b, h, d), dtype)
    kj, kt = _pair(rng, (b, s, kh, d), dtype)
    vj, vt = _pair(rng, (b, s, kh, d), dtype)
    tol = TOL[dtype]
    # per-batch lengths: 1, a tile boundary, the whole cache, random
    for lens in ([1] * b, [bs] * b, [s] * b,
                 list(rng.integers(1, s + 1, size=b))):
        lens = np.asarray(lens, np.int32)
        got = fd.flash_decode(qt, kt, vt, torch.from_numpy(lens))
        assert got.dtype == TORCH[dtype] and got.shape == (b, h, d)
        pallas = pallas_decode(qj, kj, vj, jnp.asarray(lens), bs=bs,
                               interpret=True)
        g = h // kh
        ref = flash_decode_ref(
            jnp.asarray(qj, jnp.float32),
            jnp.repeat(jnp.asarray(kj, jnp.float32), g, axis=2),
            jnp.repeat(jnp.asarray(vj, jnp.float32), g, axis=2),
            jnp.asarray(lens))
        zoo = decode_attention_jnp(qj[:, None], kj, vj, jnp.asarray(lens))
        assert np.max(np.abs(_f32(got) - _f32(pallas))) < tol
        assert np.max(np.abs(_f32(got) - _f32(ref))) < tol
        assert np.max(np.abs(_f32(got) - _f32(zoo[:, 0]))) < tol
    assert fd.LAUNCHES["flash_decode"] == 0


def test_decode_bshd_matches_model_zoo_decode():
    rng = np.random.default_rng(11)
    b, s, h, kh, d = 3, 40, 8, 2, 32          # S on no tile boundary
    qj, qt = _pair(rng, (b, 1, h, d), "float32")
    kj, kt = _pair(rng, (b, s, kh, d), "float32")
    vj, vt = _pair(rng, (b, s, kh, d), "float32")
    lens = np.asarray([1, 17, 40], np.int32)
    got = ops.decode_bshd(qt, kt, vt, torch.from_numpy(lens))
    want = decode_attention_jnp(qj, kj, vj, jnp.asarray(lens))
    assert got.shape == (b, 1, h, d)
    assert np.max(np.abs(_f32(got) - _f32(want))) < 3e-5


def test_flash_decode_zero_length_gives_zeros():
    rng = np.random.default_rng(3)
    _, q = _pair(rng, (2, 4, 16), "float32")
    _, k = _pair(rng, (2, 8, 2, 16), "float32")
    out = fd.flash_decode(q, k, k, torch.tensor([0, 8], dtype=torch.int32))
    assert torch.all(out[0] == 0) and torch.all(out[1].abs().sum(-1) > 0)


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_wrappers_reject_what_the_kernels_do_not_take():
    """A head dim the kernels are not built for is refused for the
    kernel (on a CUDA tensor, a fake one here); the plain version on the
    CPU takes it (MLA's reduced prefill head, hd + dr = 24)."""
    z = torch.zeros
    with FakeTensorMode():
        x = torch.empty(1, 2, 4, 24, device="cuda")
        with pytest.raises(ValueError, match="head dim"):
            fa.flash_attention(x, x, x)
        with pytest.raises(ValueError, match="head dim"):
            fd.flash_decode(torch.empty(1, 2, 192, device="cuda"),
                            torch.empty(1, 4, 2, 192, device="cuda"),
                            torch.empty(1, 4, 2, 192, device="cuda"),
                            torch.ones(1, dtype=torch.int32,
                                       device="cuda"))
    assert fa.flash_attention(z(1, 2, 4, 24), z(1, 2, 4, 24),
                              z(1, 2, 4, 24)).shape == (1, 2, 4, 24)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_attention(z(1, 2, 4, 16, dtype=torch.float16),
                           z(1, 2, 4, 16), z(1, 2, 4, 16))
    with pytest.raises(ValueError, match="head counts"):
        fa.flash_attention(z(1, 3, 4, 16), z(1, 2, 4, 16), z(1, 2, 4, 16))
    with pytest.raises(ValueError, match="length"):
        fd.flash_decode(z(1, 2, 16), z(1, 4, 2, 16), z(1, 4, 2, 16),
                        torch.ones(1, dtype=torch.int64))


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_cuda_tensors_go_to_the_kernel_never_the_plain_version(
        monkeypatch):
    """On CUDA tensors (fake ones here: this host has no card) each
    wrapper validates for the kernel and loads its library; it never
    computes the plain version.  The library load is stubbed to raise,
    as the build does on a host without ``nvcc``."""
    class Loaded(Exception):
        pass

    def refuse():
        raise Loaded

    monkeypatch.setattr(fa.LIBRARY, "load", refuse)
    monkeypatch.setattr(fd.LIBRARY, "load", refuse)
    with FakeTensorMode():
        q = torch.empty(1, 4, 8, 16, device="cuda")
        kv = torch.empty(1, 2, 8, 16, device="cuda")
        with pytest.raises(Loaded):
            fa.flash_attention(q, kv, kv)
        with pytest.raises(ValueError, match="contiguous"):
            fa.flash_attention(torch.empty_strided(
                (1, 4, 8, 16), (1024, 16, 128, 1), device="cuda"), kv, kv)
        cache = torch.empty(1, 8, 2, 16, device="cuda")
        lens = torch.empty(1, dtype=torch.int32, device="cuda")
        with pytest.raises(Loaded):
            fd.flash_decode(torch.empty(1, 4, 16, device="cuda"), cache,
                            cache, lens)
        with pytest.raises(ValueError, match="at most"):
            fd.flash_decode(torch.empty(1, 34, 16, device="cuda"),
                            torch.empty(1, 8, 2, 16, device="cuda"),
                            torch.empty(1, 8, 2, 16, device="cuda"), lens)
    assert fa.LAUNCHES["flash_attention"] == 0
    assert fd.LAUNCHES["flash_decode"] == 0
