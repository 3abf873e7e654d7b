"""MLA's attention shapes in the port's two attention kernels, held on
the CPU against the JAX package: the prefill kernel's plain version at
MLA's head of hd + dr = 192 against the Pallas kernel in interpret mode
and its oracle; ``flash_decode_mla``'s plain version against the
reference's ``decode_attention_jnp`` over the concatenated keys
``[ckv | krope]`` (576 columns) with values ``ckv`` (512), one latent
head and 16 query heads; the MLA kernels' split plan (``mla_splits``)
and their two-pass algorithm at that plan (``flash_decode_split_plain``
over ``mla_operands``) against ``decode_attention_jnp`` at 8, 16 and 32
heads and lengths at the tile edges; and the wrapper's routes (a CUDA
tensor goes to the kernel, never the plain version, and a refusing
library raises).

Tolerances are those of ``tests/test_kernels.py``: 3e-5 absolute in
float32 (summation order differs), 2e-2 in bfloat16.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.flash_attention import flash_attention as pallas_attention
from repro.kernels.ref import flash_attention_ref
from repro.models.layers import decode_attention_jnp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops

TOL = {"float32": 3e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(x).to(TORCH[dtype])


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


# (b, h, kh, sq, sk, bq, bk, causal, dtype) at D = 192: deepseek-v2-lite's
# prefill head count at a small length, ragged, Sq < Sk, Sq > Sk (rows
# that see no key), one query, one key, non-causal (Sq != Sk)
MLA_PREFILL = [
    (1, 16, 16, 128, 128, 64, 64, True, "float32"),
    (1, 4, 4, 70, 70, 70, 70, True, "float32"),
    (2, 2, 2, 40, 100, 40, 100, True, "float32"),
    (1, 2, 2, 50, 30, 50, 30, True, "float32"),
    (1, 2, 2, 1, 33, 1, 33, True, "float32"),
    (1, 2, 2, 9, 1, 9, 1, False, "float32"),
    (1, 4, 2, 64, 96, 64, 96, False, "bfloat16"),
]


@pytest.mark.parametrize("b,h,kh,sq,sk,bq,bk,causal,dtype", MLA_PREFILL)
def test_prefill_plain_at_the_mla_head_matches_pallas_and_ref(
        b, h, kh, sq, sk, bq, bk, causal, dtype):
    d = 192
    assert d in fa.HEAD_DIMS
    rng = np.random.default_rng(sq * 3 + sk)
    qj, qt = _pair(rng, (b, h, sq, d), dtype)
    kj, kt = _pair(rng, (b, kh, sk, d), dtype)
    vj, vt = _pair(rng, (b, kh, sk, d), dtype)
    q_offset = (sk - sq) if causal else 0
    got = fa.flash_attention(qt, kt, vt, causal=causal, q_offset=q_offset)
    assert got.shape == (b, h, sq, d)
    pallas = pallas_attention(qj, kj, vj, causal=causal, bq=bq, bk=bk,
                              q_offset=q_offset, interpret=True)
    g = h // kh
    ref = flash_attention_ref(
        jnp.asarray(qj, jnp.float32),
        jnp.repeat(jnp.asarray(kj, jnp.float32), g, axis=1),
        jnp.repeat(jnp.asarray(vj, jnp.float32), g, axis=1),
        causal=causal)
    assert np.max(np.abs(_f32(got) - _f32(pallas))) < TOL[dtype]
    seen = max(0, -q_offset)
    assert np.max(np.abs(_f32(got)[:, :, seen:]
                         - _f32(ref)[:, :, seen:])) < TOL[dtype]
    assert np.all(_f32(got)[:, :, :seen] == 0)
    assert fa.LAUNCHES["flash_attention"] == 0


# (b, s, h, r, dr, dtype): deepseek-v2-lite's widths (r 512, dr 64, 16
# query heads of one latent head) at small S; the reduced config's
# widths (r 32, dr 8, 4 heads); bf16 at the real widths
MLA_DECODE = [
    (2, 40, 16, 512, 64, "float32"),
    (3, 17, 4, 32, 8, "float32"),
    (2, 33, 16, 512, 64, "bfloat16"),
]


@pytest.mark.parametrize("b,s,h,r,dr,dtype", MLA_DECODE)
def test_flash_decode_mla_plain_matches_decode_attention_jnp(b, s, h, r, dr,
                                                            dtype):
    rng = np.random.default_rng(s + r)
    qlj, qlt = _pair(rng, (b, h, r), dtype)
    qrj, qrt = _pair(rng, (b, h, dr), dtype)
    cj, ct = _pair(rng, (b, s, r), dtype)
    kj, kt = _pair(rng, (b, s, dr), dtype)
    q_cat = jnp.concatenate([qlj, qrj], axis=-1)[:, None]     # [B,1,H,576]
    k_cat = jnp.concatenate([cj, kj], axis=-1)[:, :, None]    # [B,S,1,576]
    for lens in ([1] * b, [s] * b, list(rng.integers(1, s + 1, size=b))):
        lens = np.asarray(lens, np.int32)
        got = fd.flash_decode_mla(qlt, qrt, ct, kt, torch.from_numpy(lens))
        assert got.dtype == TORCH[dtype] and got.shape == (b, h, r)
        want = decode_attention_jnp(q_cat, k_cat, cj[:, :, None],
                                    jnp.asarray(lens))[:, 0]
        assert np.max(np.abs(_f32(got) - _f32(want))) < TOL[dtype]
        via_ops = ops.decode_mla(qlt, qrt, ct, kt, torch.from_numpy(lens))
        assert torch.equal(via_ops, got)
    zero = fd.flash_decode_mla(qlt, qrt, ct, kt,
                               torch.zeros(b, dtype=torch.int32))
    assert torch.all(zero == 0)
    assert fd.LAUNCHES["flash_decode_mla"] == 0


def test_flash_decode_mla_drops_nothing_from_the_scores():
    """The rope columns count: zeroing q_rope changes the result (the
    planted fault chip_smoke's MLA check must catch)."""
    rng = np.random.default_rng(7)
    _, ql = _pair(rng, (1, 16, 512), "float32")
    _, qr = _pair(rng, (1, 16, 64), "float32")
    _, c = _pair(rng, (1, 20, 512), "float32")
    _, k = _pair(rng, (1, 20, 64), "float32")
    lens = torch.tensor([20], dtype=torch.int32)
    full = fd.flash_decode_mla(ql, qr, c, k, lens)
    no_rope = fd.flash_decode_mla(ql, torch.zeros_like(qr), c, k, lens)
    assert float((full - no_rope).abs().max()) > 1e-3


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_flash_decode_mla_on_cuda_goes_to_the_kernel(monkeypatch):
    """On CUDA tensors (fake ones here) the wrapper checks the kernel's
    widths and loads its library; it never computes the plain version."""
    class Loaded(Exception):
        pass

    def refuse():
        raise Loaded

    monkeypatch.setattr(fd.MLA_LIBRARY, "load", refuse)
    with FakeTensorMode():
        def t(*shape, dtype=torch.bfloat16):
            return torch.empty(shape, dtype=dtype, device="cuda")

        lens = t(2, dtype=torch.int32)
        with pytest.raises(Loaded):
            fd.flash_decode_mla(t(2, 16, 512), t(2, 16, 64), t(2, 9, 512),
                                t(2, 9, 64), lens)
        with pytest.raises(ValueError, match="widths"):
            fd.flash_decode_mla(t(2, 4, 32), t(2, 4, 8), t(2, 9, 32),
                                t(2, 9, 8), lens)
        strided = torch.empty_strided((2, 16, 512), (16 * 1024, 1024, 1),
                                      dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="contiguous"):
            fd.flash_decode_mla(strided, t(2, 16, 64), t(2, 9, 512),
                                t(2, 9, 64), lens)
    with pytest.raises(ValueError, match="shapes"):
        fd.flash_decode_mla(torch.zeros(2, 4, 32), torch.zeros(2, 4, 8),
                            torch.zeros(2, 9, 32), torch.zeros(2, 8, 8),
                            torch.ones(2, dtype=torch.int32))
    assert fd.LAUNCHES["flash_decode_mla"] == 0


# capacities around the 32-key tile and the chunk edges, deepseek's
# serving cache, the long-context row and one far past it
PLAN_CAPACITIES = (0, 1, 31, 32, 33, 63, 64, 65, 1001, 2048, 8192, 10 ** 6)


@pytest.mark.parametrize("capacity", PLAN_CAPACITIES)
def test_mla_splits_is_pure_and_tiles_the_cache(capacity):
    """A function of four integers: the same answer on every call; its
    chunks are multiples of the key tile, cover the cache, and none lies
    wholly past it; the (sequence, head group) pairs' CTAs stay within
    two an SM (one wave) unless one split alone exceeds that, with at
    least half the splits that allows (or one chunk a tile)."""
    for batch in (1, 3, 16, 32):
        for heads in (8, 16, 32):
            for sms in (1, 16, 132):
                plan = fd.mla_splits(capacity, batch, heads, sms)
                assert plan == fd.mla_splits(capacity, batch, heads, sms)
                n_split, chunk = plan
                assert n_split >= 1 and chunk >= fd.MLA_KEY_TILE
                assert chunk % fd.MLA_KEY_TILE == 0
                assert n_split * chunk >= capacity
                assert (n_split - 1) * chunk < max(capacity, 1)
                pairs = batch * -(-heads // fd.MLA_HEADS)
                tiles = max(1, -(-capacity // fd.MLA_KEY_TILE))
                most = min(tiles, max(1, fd.MLA_CTAS_PER_SM * sms // pairs))
                assert n_split == 1 or n_split * pairs <= (
                    fd.MLA_CTAS_PER_SM * sms)
                assert most // 2 <= n_split <= most


@pytest.mark.parametrize("capacity", PLAN_CAPACITIES)
def test_decode_splits_unchanged_by_the_mla_plan(capacity):
    """#5's split count is its own, as before the MLA kernels had a
    plan: ``min(n_sms // SMS_PER_SPLIT, capacity // MIN_CHUNK)``, at
    least 1 (8 at S = 2048 on 132 SMs)."""
    for sms in (1, 16, 100, 132):
        assert fd.decode_splits(capacity, sms) == max(
            1, min(max(1, sms // 16), capacity // 64))
    assert fd.decode_splits(2048, 132) == 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [1, 1001, 2048])
@pytest.mark.parametrize("h", [8, 16, 32])
def test_mla_split_plain_at_the_kernel_plan_matches_decode_attention_jnp(
        h, s, dtype):
    """The MLA kernels' two passes at their own plan on a 132-SM card,
    against the reference over the concatenated keys, with lengths of 0,
    1 and around the 32-key tile and the 64-position edge, and a full
    cache.  The reference's softmax over no valid key averages the whole
    cache; the kernels' semantics (the Pallas kernel's) give zeros."""
    r, dr = fd.MLA_WIDTHS
    lens = np.minimum([0, 1, 63, 64, 65, s], s).astype(np.int32)
    b = len(lens)
    rng = np.random.default_rng(h * 7 + s)
    qlj, qlt = _pair(rng, (b, h, r), dtype)
    qrj, qrt = _pair(rng, (b, h, dr), dtype)
    cj, ct = _pair(rng, (b, s, r), dtype)
    kj, kt = _pair(rng, (b, s, dr), dtype)
    lt = torch.from_numpy(lens)
    got = fd.flash_decode_mla_split_plain(qlt, qrt, ct, kt, lt, 132)
    n_split, chunk = fd.mla_splits(s, b, h, 132)
    assert torch.equal(got, fd.flash_decode_split_plain(
        *fd.mla_operands(qlt, qrt, ct, kt), lt, n_split, chunk))
    assert got.dtype == TORCH[dtype] and got.shape == (b, h, r)
    q_cat = jnp.concatenate([qlj, qrj], axis=-1)[:, None]
    k_cat = jnp.concatenate([cj, kj], axis=-1)[:, :, None]
    want = _f32(decode_attention_jnp(q_cat, k_cat, cj[:, :, None],
                                     jnp.asarray(lens))[:, 0])
    live = lens > 0
    assert np.max(np.abs(_f32(got)[live] - want[live])) < TOL[dtype]
    assert np.all(_f32(got)[~live] == 0)
    one_pass = fd.flash_decode_mla_plain(qlt, qrt, ct, kt, lt)
    assert np.max(np.abs(_f32(got) - _f32(one_pass))) < TOL[dtype]


class _Library:
    """Stands in for the loaded MLA library: records each call of its
    entry point and returns ``err``."""

    def __init__(self, err=0):
        self.calls, self.err = [], err

    def pfdnn_flash_decode_mla(self, *args):
        self.calls.append(args)
        return self.err


@pytest.mark.filterwarnings("ignore::UserWarning")
@pytest.mark.parametrize("dtype,code", [(torch.bfloat16, 1),
                                        (torch.float32, 0)])
def test_fake_cuda_mla_launches_at_its_plan_or_raises(monkeypatch, dtype,
                                                      code):
    """On CUDA tensors (fake ones here) the wrapper hands the kernel its
    dtype's route (1: bf16 on the tensor cores, 0: float32), the plan of
    ``mla_splits`` and a scratch of ``B * H * n_split * (R + 2)``
    float32 values, reads no length on the host and computes no plain
    version; an error from the library raises and counts no launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on a CUDA tensor")

    monkeypatch.setattr(fd, "stream_of", lambda device: 0)
    monkeypatch.setattr(fd, "_sm_count", lambda index: 132)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setitem(fd.LAUNCHES, "flash_decode_mla", 0)
    for name in ("flash_decode_plain", "flash_decode_split_plain",
                 "flash_decode_mla_plain"):
        monkeypatch.setattr(fd, name, refuse)
    empties = []
    empty = torch.empty

    def recording_empty(*args, **kwargs):
        t = empty(*args, **kwargs)
        empties.append(t)
        return t

    monkeypatch.setattr(torch, "empty", recording_empty)
    B, S, H = 16, 2048, 16
    lib = _Library()
    monkeypatch.setattr(fd.MLA_LIBRARY, "load", lambda: lib)
    with FakeTensorMode():
        def t(*shape):
            return empty(shape, dtype=dtype, device="cuda")

        args = (t(B, H, 512), t(B, H, 64), t(B, S, 512), t(B, S, 64),
                empty(B, dtype=torch.int32, device="cuda"))
        out = fd.flash_decode_mla(*args)
        assert out.shape == (B, H, 512) and out.dtype == dtype
        assert fd.LAUNCHES["flash_decode_mla"] == 1
        (call,) = lib.calls
        n_split, chunk = fd.mla_splits(S, B, H, 132)
        assert call[7:16] == (B, H, S, 512, 64, n_split, chunk, code,
                              fa.softmax_scale(576))
        assert (n_split, chunk) == (16, 128)
        scratch = [x for x in empties if x.dtype == torch.float32
                   and x.device.type == "cuda"]
        assert [x.numel() for x in scratch][-1] == B * H * n_split * 514
        monkeypatch.setattr(fd.MLA_LIBRARY, "load", lambda: _Library(1))
        with pytest.raises(RuntimeError, match="flash_decode_mla"):
            fd.flash_decode_mla(*args)
    assert fd.LAUNCHES["flash_decode_mla"] == 1
