"""The prefill attention's gradient on the CPU, against the JAX package:
``flash_attention_bwd_plain`` (the formula the backward kernel
``csrc/flash_attention_bwd.cu`` computes) and the autograd Function's
CPU backward, held against ``jax.vjp`` of ``flash_attention_jnp`` (what
the reference trains through) on the same numpy-seeded inputs and
cotangent: causal, non-causal with Sq != Sk, ``q_offset`` > 0, a
sliding window, GQA groups 1/2/4/8, head dims 16/64/192 (MLA's 192
with V zero-padded from 128, as its prefill pads it), float32 and
bf16, and rows that see no key (zero gradient).  The reference runs its
online softmax over 16-position chunks.

Tolerances, each gradient's max abs error over the largest |gradient|
of the three: float32 1e-5 (the same function summed in another order;
the measured worst is ~4e-7); bf16 1e-2 (the reference rounds p and the
cotangents of its P·V product to bf16 inside autodiff and both sides
round the gradients to bf16, each a half ulp of 2^-8; the measured
worst is ~4.4e-3).

Also: every kernel wrapper given CUDA tensors that require grad either
carries the gradient (``flash_attention``, through its Function) or
raises (``flash_decode``, ``flash_decode_mla``, ``int8_matmul``, which
have no backward); fake CUDA tensors stand in for the card.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.models.layers import AttnChunks, flash_attention_jnp
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import int8_matmul as im

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (b, h, kh, sq, sk, d, causal, q_offset, window, v_pad)
CASES = {
    "causal": (2, 4, 4, 37, 37, 16, True, 0, 0, 0),
    "full_sq_ne_sk": (2, 4, 2, 30, 45, 64, False, 0, 0, 0),
    "q_offset": (1, 8, 1, 20, 50, 16, True, 30, 0, 0),
    "window": (2, 8, 2, 40, 40, 16, True, 0, 9, 0),
    "window_full": (1, 4, 2, 24, 24, 16, False, 0, 5, 0),
    "gqa8": (1, 8, 1, 33, 33, 16, True, 0, 0, 0),
    "group1": (1, 8, 8, 25, 25, 16, True, 0, 0, 0),
    "mla_192": (1, 4, 4, 33, 33, 192, True, 0, 0, 64),
    "no_key_rows": (1, 4, 2, 40, 25, 16, True, -15, 0, 0),
}


def _inputs(case):
    b, h, kh, sq, sk, d, _, _, _, v_pad = case
    rng = np.random.default_rng(sq * 1000 + sk)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kh, d)).astype(np.float32)
    if v_pad:
        v[..., d - v_pad:] = 0.0
    do = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    return q, k, v, do


@functools.lru_cache(maxsize=None)
def _reference(case, dtype):
    """(out, dq, dk, dv) of ``jax.vjp(flash_attention_jnp)`` in the
    port's [B, H, S, D] layout, as float32 numpy."""
    _, _, _, _, _, _, causal, q_offset, window, _ = case
    q, k, v, do = _inputs(case)
    jd = JNP[dtype]

    def f(q, k, v):
        return flash_attention_jnp(q, k, v, causal=causal,
                                   q_offset=q_offset, window=window,
                                   chunks=AttnChunks(16, 16))

    out, vjp = jax.vjp(f, jnp.asarray(q, jd), jnp.asarray(k, jd),
                       jnp.asarray(v, jd))
    grads = vjp(jnp.asarray(do, jd))
    return [np.asarray(x.astype(jnp.float32)).transpose(0, 2, 1, 3)
            for x in (out, *grads)]


def _port(case, dtype):
    q, k, v, do = (torch.from_numpy(x).to(TORCH[dtype]).transpose(1, 2)
                   .contiguous() for x in _inputs(case))
    return q, k, v, do


def _mask(case):
    _, _, _, _, _, _, causal, q_offset, window, _ = case
    return dict(causal=causal, q_offset=q_offset, window=window)


def _check(got, want, dtype):
    scale = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        err = float(np.abs(g.float().numpy() - w).max()) / scale
        assert err <= TOL[dtype], (err, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_jax_vjp(name, dtype):
    case = CASES[name]
    ref_out, *ref_grads = _reference(case, dtype)
    q, k, v, do = _port(case, dtype)
    out = fa.flash_attention(q, k, v, **_mask(case))
    got = fa.flash_attention_bwd_plain(do, q, k, v, out, **_mask(case))
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
    _check(got, ref_grads, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["causal", "window", "q_offset",
                                  "no_key_rows", "mla_192"])
def test_function_backward_on_cpu_is_the_plain_backward(name, dtype):
    """autograd through ``flash_attention`` (and through
    ``ops.attention_bshd``'s layout) gives the plain backward bit for
    bit, and so the reference's gradient."""
    from repro_torch.kernels import ops

    case = CASES[name]
    q, k, v, do = _port(case, dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention(*leaves, **_mask(case))
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, leaves, do)
    want = fa.flash_attention_bwd_plain(do, q, k, v, out.detach(),
                                        **_mask(case))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    _check(got, _reference(case, dtype)[1:], dtype)
    if case[7] == 0 and case[8] == 0:
        # the model layout: [B, S, H, D], queries aligned to the keys' end
        bshd = [t.transpose(1, 2).detach().clone().requires_grad_(True)
                for t in (q, k, v)]
        out = ops.attention_bshd(*bshd, causal=case[6])
        got2 = torch.autograd.grad(out, bshd, do.transpose(1, 2))
        for g, w in zip(got2, got):
            assert torch.equal(g.transpose(1, 2), w)


def test_rows_that_see_no_key_get_zero_gradient():
    case = CASES["no_key_rows"]
    q, k, v, do = _port(case, "float32")
    out = fa.flash_attention(q, k, v, **_mask(case))
    dq, _, _ = fa.flash_attention_bwd_plain(do, q, k, v, out, **_mask(case))
    blind = -case[7]                        # queries before the first key
    assert torch.count_nonzero(out[:, :, :blind]) == 0
    assert torch.count_nonzero(dq[:, :, :blind]) == 0
    assert torch.count_nonzero(dq[:, :, blind:]) > 0


def test_backward_checks_its_arguments():
    q = torch.zeros(1, 2, 4, 16)
    with pytest.raises(ValueError, match="dout"):
        fa.flash_attention_bwd(torch.zeros(1, 2, 5, 16), q, q, q, q)
    with pytest.raises(ValueError, match="out"):
        fa.flash_attention_bwd(q, q, q, q, q.to(torch.bfloat16))
    with pytest.raises(ValueError, match="head counts"):
        fa.flash_attention_bwd(torch.zeros(1, 3, 4, 16),
                               torch.zeros(1, 3, 4, 16), q, q,
                               torch.zeros(1, 3, 4, 16))


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_cuda_backward_goes_to_the_kernel_never_the_plain_version(
        monkeypatch):
    """On CUDA tensors (fake ones here: this host has no card) the
    Function's forward and backward validate for the kernels and load
    their libraries (stubbed to raise, as the build does without
    ``nvcc``); neither ever computes a plain version.  (The CPU build
    of PyTorch cannot record an autograd node on a CUDA tensor, so the
    Function's two halves are called as autograd calls them.)"""
    class Loaded(Exception):
        pass

    def refuse(*args, **kwargs):
        raise Loaded

    def never(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    for lib in (fa.LIBRARY, fa.WGMMA_LIBRARY, fa.BWD_LIBRARY):
        monkeypatch.setattr(lib, "load", refuse)
    monkeypatch.setattr(fa, "flash_attention_plain", never)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", never)
    saved = {}
    ctx = types.SimpleNamespace(
        save_for_backward=lambda *t: saved.update(t=t))
    with FakeTensorMode():
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.empty(1, 4, 8, 16, device="cuda", dtype=dtype)
            kv = torch.empty(1, 2, 8, 16, device="cuda", dtype=dtype)
            with pytest.raises(Loaded):
                fa._FlashAttention.forward(ctx, q, kv, kv, True, 0, 0)
            ctx.saved_tensors, ctx.mask = (q, kv, kv, q), (True, 0, 3)
            with pytest.raises(Loaded):
                fa._FlashAttention.backward(ctx, q)
            with pytest.raises(ValueError, match="contiguous"):
                fa.flash_attention_bwd(
                    torch.empty(1, 4, 16, 8, device="cuda",
                                dtype=dtype).transpose(2, 3), q, kv, kv, q)
    for name in ("flash_attention", "flash_attention_bwd"):
        assert fa.LAUNCHES[name] == 0


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_kernels_without_a_backward_refuse_inputs_that_require_grad(
        monkeypatch):
    """``flash_decode``, ``flash_decode_mla`` and ``int8_matmul`` on CUDA
    tensors (fake ones) that require grad raise under autograd, where
    their output would carry no gradient; under ``torch.no_grad()``
    they go on to their kernels."""
    class Loaded(Exception):
        pass

    def refuse():
        raise Loaded

    for lib in (fd.LIBRARY, fd.MLA_LIBRARY, im.LIBRARY):
        monkeypatch.setattr(lib, "load", refuse)
    r, dr = fd.MLA_WIDTHS
    with FakeTensorMode():
        lens = torch.empty(1, dtype=torch.int32, device="cuda")
        cache = torch.empty(1, 8, 2, 16, device="cuda")
        x8 = torch.empty(32, 64, dtype=torch.int8, device="cuda")
        w8 = torch.empty(64, 32, dtype=torch.int8, device="cuda")
        calls = {
            "flash_decode": lambda g: fd.flash_decode(
                torch.empty(1, 4, 16, device="cuda", requires_grad=g),
                cache, cache, lens),
            "flash_decode_mla": lambda g: fd.flash_decode_mla(
                torch.empty(1, 16, r, device="cuda", requires_grad=g),
                torch.empty(1, 16, dr, device="cuda"),
                torch.empty(1, 8, r, device="cuda"),
                torch.empty(1, 8, dr, device="cuda"), lens),
            "int8_matmul": lambda g: im.int8_matmul(
                x8, w8, torch.empty(32, device="cuda", requires_grad=g),
                torch.empty(32, device="cuda")),
        }
        for name, call in calls.items():
            with pytest.raises(RuntimeError, match=f"{name}: .* requires "
                               "grad"):
                call(True)
            with torch.no_grad(), pytest.raises(Loaded):
                call(True)
            with pytest.raises(Loaded):
                call(False)
