"""The port's int8 kernel (``repro_torch.kernels.int8_matmul``) and its
entry point (``repro_torch.kernels.quantize_int8`` / ``int8_linear``),
held on the CPU against the JAX package: the Pallas kernel in interpret
mode, its ``kernels/ref.py`` oracle, and ``repro.kernels.ops``.

On CPU tensors the wrapper computes its plain PyTorch version; the CUDA
kernel is held against that plain version on the card by
``chip_smoke.py``.  Inputs are drawn with numpy and handed to both
packages.  Tolerances: exact (bit for bit) against the Pallas kernel,
which multiplies in the same order (``f32(acc) * (xs * ws)``); ``rtol
1e-6, atol 1e-4`` against ``int8_matmul_ref``, which multiplies in
another order (``f32(acc) * xs * ws``) and so rounds differently, as
``tests/test_kernels.py`` holds the Pallas kernel against it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.int8_matmul import int8_matmul as pallas_int8_matmul
from repro.kernels.ops import int8_linear as ref_int8_linear
from repro.kernels.ops import quantize_int8 as ref_quantize_int8
from repro.kernels.ref import int8_matmul_ref
from repro_torch.kernels import int8_linear, quantize_int8
from repro_torch.kernels import int8_matmul as im

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _operands(seed, m, k, n):
    """int8 x [M, K], w [K, N] over the full int8 range and float32
    scales in [0.5, 2), as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    xs = rng.uniform(0.5, 2.0, m).astype(np.float32)
    ws = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return x, w, xs, ws


def _port(*arrays):
    return im.int8_matmul(*(torch.from_numpy(a) for a in arrays)).numpy()


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 512, 128, 128, 128, 128),
    (64, 64, 192, 32, 64, 32),
    (32, 96, 32, 16, 16, 16),
])
def test_int8_matmul_equals_pallas_interpret_bit_for_bit(m, k, n, bm, bn,
                                                         bk):
    ops = _operands(m + k + n, m, k, n)
    want = np.asarray(pallas_int8_matmul(
        *(jnp.asarray(a) for a in ops), bm=bm, bn=bn, bk=bk,
        interpret=True))
    got = _port(*ops)
    assert got.dtype == np.float32 and got.shape == (m, n)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("m,k,n", [
    (13, 70, 33), (1, 1, 1), (65, 17, 129), (7, 300, 5),
])
def test_int8_matmul_ragged_shapes_match_ref(m, k, n):
    """Any M, K, N: the Pallas wrapper needs them to tile, the port
    does not."""
    ops = _operands(7, m, k, n)
    want = np.asarray(int8_matmul_ref(*(jnp.asarray(a) for a in ops)))
    got = _port(*ops)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    # and exactly the Pallas kernel's epilogue order
    acc = ops[0].astype(np.int64) @ ops[1].astype(np.int64)
    scale = ops[2][:, None] * ops[3][None, :]
    assert np.array_equal(got, acc.astype(np.float32) * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_int8_codes_and_scales_equal_reference(dtype, axis):
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((48, 80)) * 3.0).astype(np.float32)
    x[5] = 0.0                                  # an all-zero row
    x[:, 7] = 0.0                               # and column
    q_ref, s_ref = ref_quantize_int8(jnp.asarray(x).astype(JNP[dtype]),
                                     axis=axis)
    q, s = quantize_int8(torch.from_numpy(x).to(TORCH[dtype]), axis=axis)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(q_ref))
    assert np.array_equal(s.numpy(), np.asarray(s_ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_equals_reference_bit_for_bit(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    w = rng.standard_normal((256, 128)).astype(np.float32)
    want = np.asarray(ref_int8_linear(jnp.asarray(x).astype(JNP[dtype]),
                                      jnp.asarray(w).astype(JNP[dtype]),
                                      interpret=True))
    got = int8_linear(torch.from_numpy(x).to(TORCH[dtype]),
                      torch.from_numpy(w).to(TORCH[dtype])).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def test_int8_linear_quantization_error_bounded():
    """The reference test's noise budget, on a transposed (strided)
    weight view as well."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((64, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((128, 256)).astype(np.float32))
    out = int8_linear(x, w.t())
    ref = x @ w.t()
    assert float((out - ref).abs().max() / ref.abs().max()) < 0.05


def test_int8_matmul_argument_checks():
    x = torch.zeros(4, 8, dtype=torch.int8)
    w = torch.zeros(8, 3, dtype=torch.int8)
    xs, ws = torch.ones(4), torch.ones(3)
    with pytest.raises(TypeError, match="dtype"):
        im.int8_matmul(x.float(), w, xs, ws)
    with pytest.raises(ValueError, match=r"x \[M, K\] and w \[K, N\]"):
        im.int8_matmul(x, w[:5], xs, ws)
    with pytest.raises(ValueError, match="x_scale"):
        im.int8_matmul(x, w, ws, ws)
    with pytest.raises(ValueError, match="overflow"):
        im.int8_matmul(torch.zeros(1, im.MAX_K + 1, dtype=torch.int8),
                       torch.zeros(im.MAX_K + 1, 1, dtype=torch.int8),
                       torch.ones(1), torch.ones(1))
    assert im.int8_matmul(x, w, xs, ws).abs().max() == 0.0


@pytest.mark.filterwarnings("ignore::UserWarning")
def test_cuda_tensors_go_to_the_kernel_never_the_plain_version(
        monkeypatch):
    """On CUDA tensors (fake ones here: this host has no card) the
    wrapper validates for the kernel and loads its library; it never
    computes the plain version.  The library load is stubbed to raise,
    as the build does on a host without ``nvcc``."""
    class Loaded(Exception):
        pass

    def refuse():
        raise Loaded

    def no_plain(*args):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(im.LIBRARY, "load", refuse)
    monkeypatch.setattr(im, "int8_matmul_plain", no_plain)
    im.reset_launch_counts()
    with FakeTensorMode():
        x = torch.empty(16, 64, dtype=torch.int8, device="cuda")
        w = torch.empty(64, 32, dtype=torch.int8, device="cuda")
        xs = torch.empty(16, device="cuda")
        ws = torch.empty(32, device="cuda")
        with pytest.raises(Loaded):
            im.int8_matmul(x, w, xs, ws)
        # a K-major w (the transpose of a contiguous [N, K]) goes to the
        # kernel as well; rows padded past N do not
        with pytest.raises(Loaded):
            im.int8_matmul(x, torch.empty_strided(
                (64, 32), (1, 64), dtype=torch.int8, device="cuda"), xs, ws)
        with pytest.raises(ValueError, match="contiguous"):
            im.int8_matmul(x, torch.empty_strided(
                (64, 32), (64, 1), dtype=torch.int8, device="cuda"), xs, ws)
        # the wgmma route (M > 64), with w in either layout
        xw = torch.empty(128, 64, dtype=torch.int8, device="cuda")
        xsw = torch.empty(128, device="cuda")
        for ww in (w, torch.empty(32, 64, dtype=torch.int8,
                                  device="cuda").t()):
            with pytest.raises(Loaded):
                im.int8_matmul(xw, ww, xsw, ws)
        with pytest.raises(Loaded):
            int8_linear(torch.empty(16, 64, dtype=torch.bfloat16,
                                    device="cuda"),
                        torch.empty(64, 32, dtype=torch.bfloat16,
                                    device="cuda"))
    assert im.LAUNCHES["int8_matmul"] == 0
