"""The int8 product's operand layouts and routes
(``repro_torch.kernels.int8_matmul``), held on the CPU against the JAX
package: a K-major ``w`` (the transpose of a contiguous ``[N, K]``)
against the Pallas kernel in interpret mode, ``int8_linear``'s ``[N,
K]`` quantization of ``w`` against ``repro.kernels.ops``, and the
shape routing of ``chip_smoke.py``'s ``INT8_SHAPES``.

The CUDA kernels of both routes are held against the plain version on
the card by ``chip_smoke.py``.  Tolerance: exact (bit for bit).
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.int8_matmul import int8_matmul as pallas_int8_matmul
from repro.kernels.ops import int8_linear as ref_int8_linear
from repro.kernels.ops import quantize_int8 as ref_quantize_int8
from repro_torch.kernels import int8_linear, quantize_int8
from repro_torch.kernels import int8_matmul as im

ROOT = pathlib.Path(__file__).resolve().parent.parent
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _operands(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    xs = rng.uniform(0.5, 2.0, m).astype(np.float32)
    ws = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return x, w, xs, ws


def _kmajor(w: np.ndarray) -> torch.Tensor:
    """``w [K, N]`` as the transpose of a contiguous ``[N, K]``."""
    return torch.from_numpy(np.ascontiguousarray(w.T)).t()


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 128, 128, 128, 128, 128),
    (256, 512, 128, 128, 128, 128),
    (64, 64, 192, 32, 64, 32),
    (32, 96, 32, 16, 16, 16),
    (192, 256, 64, 64, 64, 128),
])
def test_kmajor_w_equals_pallas_interpret_bit_for_bit(m, k, n, bm, bn, bk):
    x, w, xs, ws = _operands(m * 3 + k + n, m, k, n)
    want = np.asarray(pallas_int8_matmul(
        *(jnp.asarray(a) for a in (x, w, xs, ws)), bm=bm, bn=bn, bk=bk,
        interpret=True))
    wk = _kmajor(w)
    assert wk.stride() == (1, k) and im.w_layout(wk) == "kmajor"
    for fn in (im.int8_matmul, im.int8_matmul_plain):
        got = fn(torch.from_numpy(x), wk, torch.from_numpy(xs),
                 torch.from_numpy(ws)).numpy()
        assert got.dtype == np.float32 and got.shape == (m, n)
        assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n", [(256, 128), (96, 48), (70, 33)])
def test_int8_linear_nk_quantization_equals_reference(dtype, k, n):
    """``quantize_int8(w.t(), axis=1)`` gives the reference's per-column
    codes and scales of ``w``, as a contiguous ``[N, K]``; the product
    equals the reference's bit for bit."""
    rng = np.random.default_rng(k + n)
    x = rng.standard_normal((64, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 2.0).astype(np.float32)
    w[:, 3] = 0.0                               # an all-zero column
    wt = torch.from_numpy(w).to(TORCH[dtype])
    q, s = quantize_int8(wt.t(), axis=1)
    q_ref, s_ref = ref_quantize_int8(jnp.asarray(w).astype(JNP[dtype]),
                                     axis=0)
    assert q.shape == (n, k) and q.is_contiguous()
    assert np.array_equal(q.t().numpy(), np.asarray(q_ref))
    assert np.array_equal(s.numpy(), np.asarray(s_ref))
    want = np.asarray(ref_int8_linear(jnp.asarray(x).astype(JNP[dtype]),
                                      jnp.asarray(w).astype(JNP[dtype]),
                                      interpret=True))
    got = int8_linear(torch.from_numpy(x).to(TORCH[dtype]), wt).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_shapes", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _want(m, k, n, kmajor):
    if m <= 64 or k % 16 or n % 16:
        return "mma_sync"
    return "wgmma" if kmajor else "wgmma+transpose"


@pytest.mark.parametrize("kmajor", [False, True])
def test_route_of_every_chip_smoke_shape(kmajor):
    """M = 16384 (prefill) takes wgmma, M = 16 (decode) mma.sync, and
    the shapes TMA cannot take (K or N not a multiple of 16) mma.sync."""
    shapes = _chip_smoke().INT8_SHAPES
    routes = {}
    for m, k, n in shapes:
        strides = (1, k) if kmajor else (n, 1)
        routes[(m, k, n)] = im.int8_route(m, n, k, strides)
        assert routes[(m, k, n)] == _want(m, k, n, kmajor), (m, k, n)
    wg = "wgmma" if kmajor else "wgmma+transpose"
    assert all(routes[s] == wg for s in shapes if s[0] == 16384)
    assert all(routes[s] == "mma_sync" for s in shapes if s[0] == 16)
    assert routes[(13, 70, 33)] == "mma_sync"


def test_route_is_a_function_of_shape_strides_and_alignment():
    assert im.int8_route(65, 16, 16, (1, 16)) == "wgmma"
    assert im.int8_route(64, 16, 16, (1, 16)) == "mma_sync"
    assert im.int8_route(128, 16, 24, (1, 24)) == "mma_sync"   # K % 16
    assert im.int8_route(128, 40, 32, (40, 1)) == "mma_sync"   # N % 16
    assert im.int8_route(128, 32, 32, (32, 1)) == "wgmma+transpose"
    assert im.int8_route(128, 32, 32, (1, 32), aligned=False) == "mma_sync"


def test_w_layout():
    w = torch.zeros(8, 4, dtype=torch.int8)
    assert im.w_layout(w) == "row"
    assert im.w_layout(torch.zeros(4, 8, dtype=torch.int8).t()) == "kmajor"
    assert im.w_layout(torch.zeros(8, 6, dtype=torch.int8)[:, :4]) is None
    assert im.w_layout(torch.zeros(8, 1, dtype=torch.int8)) == "row"
