"""The port's one-device MoE FFN (``repro_torch.models.moe``) on the CPU,
against the JAX package: ``router_topk`` (ties to the lower expert
index, as ``jax.lax.top_k``), and ``moe_ffn_dense``, which groups the
(token, choice) rows by expert and runs each expert once, against a
per-token gather oracle (the reference's algorithm, written here in
PyTorch) and against ``repro.models.moe.moe_ffn_dense``, in float32 at
reduced sizes.  Inputs are drawn with numpy and handed to both packages.
Tolerance: 1e-5 absolute (float32; the products sum in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import moe as ref_moe
from repro_torch.models import moe

TOL = 1e-5


def _dims(e, k, d, f):
    return (moe.MoeDims(e, k, d, f),
            ref_moe.MoeDims(e, k, d, f, capacity_factor=10.0))


def test_router_topk_ties_go_to_the_lower_index():
    dims, rdims = _dims(8, 3, 4, 8)
    x = np.ones((5, 4), np.float32)
    # every expert equal, then experts 2 and 5 tied ahead of the rest,
    # then experts 1, 4, 6 tied for the second place
    w = np.zeros((4, 8), np.float32)
    w2 = np.zeros((4, 8), np.float32)
    w2[0, [2, 5]] = 1.0
    w2[0, [1, 4, 6]] = 0.5
    for wr, want in ((w, [0, 1, 2]), (w2, [2, 5, 1])):
        idx, cw = moe.router_topk(torch.from_numpy(x), torch.from_numpy(wr),
                                  dims)
        ridx, rcw = ref_moe.router_topk(jnp.asarray(x), jnp.asarray(wr),
                                        rdims)
        assert idx.tolist() == [want] * 5 == np.asarray(ridx).tolist()
        assert np.max(np.abs(cw.numpy() - np.asarray(rcw))) <= TOL
        assert torch.allclose(cw.sum(-1), torch.ones(5))
        assert cw.dtype == torch.float32


def test_router_topk_matches_reference_on_random_logits():
    dims, rdims = _dims(16, 4, 12, 8)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((33, 12)).astype(np.float32)
    wr = rng.standard_normal((12, 16)).astype(np.float32)
    idx, cw = moe.router_topk(torch.from_numpy(x), torch.from_numpy(wr), dims)
    ridx, rcw = ref_moe.router_topk(jnp.asarray(x), jnp.asarray(wr), rdims)
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert np.max(np.abs(cw.numpy() - np.asarray(rcw))) <= TOL
    bf = moe.router_topk(torch.from_numpy(x).bfloat16(),
                         torch.from_numpy(wr).bfloat16(), dims)[1]
    assert bf.dtype == torch.bfloat16


def _gather_oracle(x, wr, w1, w3, w2, dims):
    """The reference's algorithm: gather each token's expert weights,
    one choice at a time."""
    idx, cw = moe.router_topk(x, wr, dims)
    out = torch.zeros_like(x)
    for j in range(dims.top_k):
        e = idx[:, j]
        h = F.silu(torch.einsum("td,tdf->tf", x, w1[e])) \
            * torch.einsum("td,tdf->tf", x, w3[e])
        out = out + cw[:, j:j + 1] * torch.einsum("tf,tfd->td", h, w2[e])
    return out


# (tokens, experts, top_k, d, f): the reduced configs' MoE (8 experts,
# top 2, d 64, f 32), one token, a top-k of every expert, more experts
# than tokens (idle experts), a top-1 router
MOE_CASES = [(21, 8, 2, 64, 32), (1, 8, 2, 16, 8), (7, 4, 4, 16, 8),
             (3, 12, 3, 8, 16), (40, 6, 1, 32, 24)]


@pytest.mark.parametrize("t,e,k,d,f", MOE_CASES)
def test_grouped_experts_match_gather_oracle_and_reference(t, e, k, d, f):
    dims, rdims = _dims(e, k, d, f)
    rng = np.random.default_rng(t * 13 + e)
    arrays = [rng.standard_normal(shape).astype(np.float32) * scale
              for shape, scale in (((t, d), 1.0), ((d, e), 0.5),
                                   ((e, d, f), 0.2), ((e, d, f), 0.2),
                                   ((e, f, d), 0.2))]
    got = moe.moe_ffn_dense(*map(torch.from_numpy, arrays), dims)
    oracle = _gather_oracle(*map(torch.from_numpy, arrays), dims)
    want = ref_moe.moe_ffn_dense(*map(jnp.asarray, arrays), rdims)
    assert got.shape == (t, d) and got.dtype == torch.float32
    assert float((got - oracle).abs().max()) <= TOL
    assert np.max(np.abs(got.numpy() - np.asarray(want))) <= TOL
