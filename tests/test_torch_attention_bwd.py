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

The bf16 kernel's algorithm (``flash_attention_bwd_bf16_plain``: P and
dS rounded to bf16 as product operands) is held against the same
reference at the bf16 tolerance.  The rows' statistics the forward
saves give the plain backwards what they compute without them (within
1e-6 relative: the same float32 operations).

Also: every kernel wrapper given CUDA tensors that require grad either
carries the gradient (``flash_attention``, through its Function) or
raises (``flash_decode``, ``flash_decode_mla``, ``int8_matmul``, which
have no backward); fake CUDA tensors stand in for the card, and show
that the forward passes a statistics buffer only when a gradient is
needed and that the backward launches the bf16 library for bf16 and
the float32 one for float32.
"""

import contextlib
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

    for lib in (fa.LIBRARY, fa.WGMMA_LIBRARY, fa.BWD_LIBRARY,
                fa.BWD_WGMMA_LIBRARY):
        monkeypatch.setattr(lib, "load", refuse)
    monkeypatch.setattr(fa, "flash_attention_plain", never)
    monkeypatch.setattr(fa, "flash_attention_bwd_plain", never)
    monkeypatch.setattr(fa, "flash_attention_bwd_bf16_plain", never)
    saved = {}
    ctx = types.SimpleNamespace(
        save_for_backward=lambda *t: saved.update(t=t),
        needs_input_grad=(True, True, True, False, False, False))
    with FakeTensorMode():
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.empty(1, 4, 8, 16, device="cuda", dtype=dtype)
            kv = torch.empty(1, 2, 8, 16, device="cuda", dtype=dtype)
            with pytest.raises(Loaded):
                fa._FlashAttention.forward(ctx, q, kv, kv, True, 0, 0)
            ctx.saved_tensors, ctx.mask = (q, kv, kv, q, None), (True, 0, 3)
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


@pytest.mark.parametrize("name", ["causal", "window", "full_sq_ne_sk",
                                  "no_key_rows", "mla_192"])
def test_bf16_kernel_algorithm_matches_jax_vjp(name):
    case = CASES[name]
    ref_out, *ref_grads = _reference(case, "bfloat16")
    q, k, v, do = _port(case, "bfloat16")
    out, stats = fa.flash_attention_plain(q, k, v, with_stats=True,
                                          **_mask(case))
    got = fa.flash_attention_bwd_bf16_plain(do, q, k, v, out, stats=stats,
                                            **_mask(case))
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == t.dtype and g.shape == t.shape
    _check(got, ref_grads, "bfloat16")
    if case[7] < 0:
        assert torch.count_nonzero(got[0][:, :, :-case[7]]) == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["causal", "q_offset", "window",
                                  "no_key_rows", "mla_192"])
def test_saved_statistics_give_the_backward_without_them(name, dtype):
    case = CASES[name]
    q, k, v, do = _port(case, dtype)
    out, stats = fa.flash_attention_plain(q, k, v, with_stats=True,
                                          **_mask(case))
    assert torch.equal(out, fa.flash_attention_plain(q, k, v,
                                                     **_mask(case)))
    b, h, sq = q.shape[:3]
    assert stats.shape == (2, b * h * sq) and stats.dtype == torch.float32
    for bwd in (fa.flash_attention_bwd_plain,
                fa.flash_attention_bwd_bf16_plain):
        with_stats = bwd(do, q, k, v, out, stats=stats, **_mask(case))
        without = bwd(do, q, k, v, out, **_mask(case))
        for x, y in zip(with_stats, without):
            scale = max(float(y.float().abs().max()), 1e-30)
            assert float((x.float() - y.float()).abs().max()) <= 1e-6 * scale


class _Library:
    """Stands in for a loaded kernel library: records each call of its
    entry point (pointers as the wrapper passes them: an int, or None
    for NULL) and returns cudaSuccess."""

    def __init__(self, entry):
        self.calls = []
        setattr(self, entry, self._record)

    def _record(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_fake_cuda_statistics_and_backward_routes(monkeypatch):
    """On fake CUDA tensors: the Function's forward hands the kernel a
    statistics buffer (argument 14) only when an input needs a
    gradient, and the backward passes the saved one on; bf16 goes to the
    tensor-core backward library, float32 to the CUDA-core one; without
    saved statistics the backward first runs the forward kernel for
    them; no plain version runs and each backward call counts one
    launch."""
    libs = {"f32": _Library("pfdnn_flash_attention_f32"),
            "bf16": _Library("pfdnn_flash_attention_bf16"),
            "bwd_f32": _Library("pfdnn_flash_attention_bwd_f32"),
            "bwd_bf16": _Library("pfdnn_flash_attention_bwd_bf16")}
    for key, lib in (("f32", fa.LIBRARY), ("bf16", fa.WGMMA_LIBRARY),
                     ("bwd_f32", fa.BWD_LIBRARY),
                     ("bwd_bf16", fa.BWD_WGMMA_LIBRARY)):
        monkeypatch.setattr(lib, "load", lambda stub=libs[key]: stub)

    def never(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("flash_attention_plain", "flash_attention_bwd_plain",
                 "flash_attention_bwd_bf16_plain"):
        monkeypatch.setattr(fa, name, never)
    monkeypatch.setattr(fa, "stream_of", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    for name in fa.LAUNCHES:
        monkeypatch.setitem(fa.LAUNCHES, name, 0)
    saved = {}
    with FakeTensorMode():
        for dtype, fwd, bwd in ((torch.bfloat16, "bf16", "bwd_bf16"),
                                (torch.float32, "f32", "bwd_f32")):
            q = torch.empty(2, 8, 100, 64, device="cuda", dtype=dtype)
            kv = torch.empty(2, 2, 130, 64, device="cuda", dtype=dtype)
            for grad in (False, True):
                ctx = types.SimpleNamespace(
                    save_for_backward=lambda *t: saved.update(t=t),
                    needs_input_grad=(grad, False, False, False, False,
                                      False))
                out = fa._FlashAttention.forward(ctx, q, kv, kv, True, 30,
                                                 0)
                stats = saved["t"][4]
                assert (stats is not None) == grad
                assert (libs[fwd].calls[-1][14] is None) == (not grad)
            assert stats.shape == (2, 2 * 8 * 100)
            ctx.saved_tensors, ctx.mask = saved["t"], (True, 30, 0)
            n_fwd = len(libs[fwd].calls)
            dq, dk, dv = fa._FlashAttention.backward(ctx, out)[:3]
            assert len(libs[fwd].calls) == n_fwd
            assert dq.shape == q.shape and dk.shape == dv.shape == kv.shape
            # no statistics: a pass of the forward kernel first
            fa.flash_attention_bwd(out, q, kv, kv, out, causal=True,
                                   q_offset=30)
            assert len(libs[fwd].calls) == n_fwd + 1
            assert libs[fwd].calls[-1][14] is not None
            assert len(libs[bwd].calls) == 2
            # B, H, KH, Sq, Sk, D, q_offset, causal, window
            for call in libs[bwd].calls:
                assert call[10:19] == (2, 8, 2, 100, 130, 64, 30, 1, 0)
    assert fa.LAUNCHES["flash_attention_bwd"] == 4
