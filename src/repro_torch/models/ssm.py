"""Linear-recurrence sequence mixers on PyTorch: the chunked gated
linear scan (shared by xLSTM's mLSTM and Hymba's Mamba/SSD heads) and
the sequential sLSTM, as ``repro.models.ssm`` computes them.

The recurrence per head (matrix state H ∈ R^{dk×dv}, normalizer N ∈ R^dk):

    H_t = a_t · H_{t-1} + i_t · k_t v_tᵀ          a_t ∈ (0,1], i_t ≥ 0
    y_t = q_t · H_t   (optionally / max(|q_t·N_t|, exp(−m_t)) for mLSTM)

Chunked form (Mamba-2/SSD [arXiv:2405.21060], xLSTM
[arXiv:2405.04517]): intra-chunk pairs go through a [c × c]
decay-masked product, and the inter-chunk state is carried chunk by
chunk in a Python loop (the reference's ``lax.scan``).  Numerics are
stabilized in log space with a running max ``m`` so every materialized
exponent is ≤ 0; everything computes in float32, as the reference does.

These are plain PyTorch on tensors (``torch.matmul``/``einsum``,
cuBLAS on the card): the reference computes them outside any Pallas
kernel.  ``slstm_scan`` is a true recurrence over time, a few
launches a token on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

LOG_EPS = -1e30


class GlsState(NamedTuple):
    """Inter-chunk carry: true state = exp(m)·(H, N)."""

    h: torch.Tensor    # [B, HD, Dk, Dv]
    n: torch.Tensor    # [B, HD, Dk]
    m: torch.Tensor    # [B, HD]


def init_gls_state(batch: int, heads: int, dk: int, dv: int,
                   dtype=torch.float32, device=None) -> GlsState:
    return GlsState(
        h=torch.zeros((batch, heads, dk, dv), dtype=dtype, device=device),
        n=torch.zeros((batch, heads, dk), dtype=dtype, device=device),
        m=torch.full((batch, heads), LOG_EPS, dtype=dtype, device=device),
    )


def gated_linear_scan(
    q: torch.Tensor,          # [B, S, HD, Dk]
    k: torch.Tensor,          # [B, S, HD, Dk]
    v: torch.Tensor,          # [B, S, HD, Dv]
    log_a: torch.Tensor,      # [B, S, HD]  log forget/decay gate (≤ 0)
    log_i: torch.Tensor,      # [B, S, HD]  log input gate
    *,
    chunk: int = 128,
    normalized: bool = False,   # True → mLSTM denominator semantics
    initial: GlsState | None = None,
) -> tuple[torch.Tensor, GlsState]:
    """Chunk-parallel gated linear attention.  Returns (y, final_state)."""
    b, s, hd, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk, s)
    nc = -(-s // c)
    pad = nc * c - s
    if pad:
        def zpad(x):
            return F.pad(x, (0, 0) * (x.dim() - 2) + (0, pad))
        q, k, v = zpad(q), zpad(k), zpad(v)
        log_a = F.pad(log_a, (0, 0, 0, pad))                  # a=1 ⇒ log 0
        log_i = F.pad(log_i, (0, 0, 0, pad), value=LOG_EPS)  # i=0

    f32 = torch.float32
    qc = q.reshape(b, nc, c, hd, dk).to(f32)
    kc = k.reshape(b, nc, c, hd, dk).to(f32)
    vc = v.reshape(b, nc, c, hd, dv).to(f32)
    la = torch.cumsum(log_a.reshape(b, nc, c, hd).to(f32), dim=2)
    li = log_i.reshape(b, nc, c, hd).to(f32)
    # Convention H_t = a_t H_{t-1} + i_t k_t v_tᵀ ⇒ pair weight for t ≥ s
    # is exp(La_t − La_s + log i_s) = exp(La_t + b_s) with b_s = li_s − La_s.
    bgate = li - la

    state = initial if initial is not None else init_gls_state(
        b, hd, dk, dv, device=q.device)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=q.device))
    ys = []
    for j in range(nc):
        h, n, m = state
        qb, kb, vb, lab, bb = (qc[:, j], kc[:, j], vc[:, j], la[:, j],
                               bgate[:, j])
        # stabilizers (per head): μ_t = La_t + max(m, cummax_{s≤t} b_s)
        bmax = torch.cummax(bb, dim=1).values                # [B,c,HD]
        mu = lab + torch.maximum(m[:, None, :], bmax)
        # inter-chunk contribution
        w_prev = torch.exp(m[:, None, :] + lab - mu)          # [B,c,HD]
        qw = qb * w_prev[..., None]
        y_inter = torch.einsum("bchk,bhkv->bchv", qw, h)
        d_inter = torch.einsum("bchk,bhk->bch", qw, n)
        # intra-chunk pairs: D[t,s] = exp(La_t + b_s − μ_t) for s ≤ t;
        # the pairs s > t are masked before the exponential (LOG_EPS, so
        # 0), which μ_t does not bound: exp of them can overflow, and
        # the gradient of an inf masked after exp is 0·inf = NaN (the
        # reference's jnp.where(tri, exp(expo), 0) gives NaN gradients
        # there; the forward is the same)
        expo = lab[:, :, None, :] + bb[:, None, :, :] - mu[:, :, None, :]
        dmat = torch.exp(expo.masked_fill(~tri[None, :, :, None], LOG_EPS))
        scores = torch.einsum("bthk,bshk->btsh", qb, kb) * dmat
        y_intra = torch.einsum("btsh,bshv->bthv", scores, vb)
        d_intra = torch.sum(scores, dim=2)                   # [B,c,HD]
        y = y_inter + y_intra
        den = d_inter + d_intra
        if normalized:
            # mLSTM denominator: num/den both carry exp(−μ); the true-unit
            # floor exp(−m_t) = exp(−μ_t) becomes exp(−2μ) in scaled units
            y = y / torch.maximum(torch.abs(den),
                                  torch.exp(-2.0 * mu))[..., None]
        else:
            # SSD/Mamba path: gates are bounded (μ ≈ O(1)); undo the
            # stabilizer scale to return true units
            y = y * torch.exp(mu)[..., None]
        # state update to chunk end
        la_end = lab[:, -1, :]                               # [B,HD]
        m_new = la_end + torch.maximum(m, torch.amax(bb, dim=1))
        w_old = torch.exp(m + la_end - m_new)                # [B,HD]
        w_in = torch.exp(la_end[:, None, :] + bb - m_new[:, None, :])
        kw = kb * w_in[..., None]
        h_new = (h * w_old[..., None, None]
                 + torch.einsum("bshk,bshv->bhkv", kw, vb))
        n_new = n * w_old[..., None] + torch.sum(kw, dim=1)
        state = GlsState(h_new, n_new, m_new)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(b, nc * c, hd, dv)[:, :s]
    return y.to(v.dtype), state


def gls_decode_step(
    state: GlsState,
    q: torch.Tensor,          # [B, HD, Dk]
    k: torch.Tensor,
    v: torch.Tensor,          # [B, HD, Dv]
    log_a: torch.Tensor,      # [B, HD]
    log_i: torch.Tensor,
    *,
    normalized: bool = False,
) -> tuple[torch.Tensor, GlsState]:
    """Single-token recurrent update (serving decode path)."""
    h, n, m = state
    f32 = torch.float32
    q, k, v = q.to(f32), k.to(f32), v.to(f32)
    log_a, log_i = log_a.to(f32), log_i.to(f32)
    m_new = torch.maximum(m + log_a, log_i)
    w_old = torch.exp(m + log_a - m_new)[..., None, None]
    w_in = torch.exp(log_i - m_new)[..., None, None]
    h_new = h * w_old + (k[..., :, None] * v[..., None, :]) * w_in
    n_new = n * w_old[..., 0] + k * w_in[..., 0]
    y = torch.einsum("bhk,bhkv->bhv", q, h_new)
    if normalized:
        den = torch.einsum("bhk,bhk->bh", q, n_new)
        y = y / torch.maximum(torch.abs(den),
                              torch.exp(-2.0 * m_new))[..., None]
    else:
        y = y * torch.exp(m_new)[..., None]
    return y, GlsState(h_new, n_new, m_new)


# ------------------------------------------------------------- sLSTM

class SlstmState(NamedTuple):
    c: torch.Tensor   # [B, D]
    n: torch.Tensor   # [B, D]
    m: torch.Tensor   # [B, D]
    h: torch.Tensor   # [B, D]


def init_slstm_state(batch: int, d: int, dtype=torch.float32,
                     device=None) -> SlstmState:
    def z():
        return torch.zeros((batch, d), dtype=dtype, device=device)

    return SlstmState(z(), z(), torch.full((batch, d), LOG_EPS, dtype=dtype,
                                           device=device), z())


def slstm_scan(
    x_gates: torch.Tensor,     # [B, S, 4, D] pre-activations (z, i, f, o)
    r_weights: torch.Tensor,   # [4, H, Dh, Dh] block-diag recurrent weights
    *,
    n_heads: int,
    initial: SlstmState | None = None,
) -> tuple[torch.Tensor, SlstmState]:
    """sLSTM (xLSTM [arXiv:2405.04517]): exponential gating with
    stabilizer state, sequential over time (true recurrence via the
    block-diagonal R), one step a token."""
    b, s, _, d = x_gates.shape
    dh = d // n_heads
    state = initial if initial is not None else init_slstm_state(
        b, d, device=x_gates.device)
    r = r_weights.to(torch.float32).reshape(4, n_heads, dh, dh)
    xg_all = x_gates.to(torch.float32)
    hs = []
    for t in range(s):
        c, n, m, h = state
        hh = h.reshape(b, n_heads, dh).to(torch.float32)
        rec = torch.einsum("knij,bnj->kbni", r, hh)     # [4, B, nH, Dh]
        rec = rec.reshape(4, b, d)
        xg = xg_all[:, t]
        z_pre = xg[:, 0] + rec[0]
        i_pre = xg[:, 1] + rec[1]
        f_pre = xg[:, 2] + rec[2]
        o_pre = xg[:, 3] + rec[3]
        z = torch.tanh(z_pre)
        o = torch.sigmoid(o_pre)
        log_f = -F.softplus(-f_pre)                     # log sigmoid(f)
        m_new = torch.maximum(log_f + m, i_pre)
        c_new = (torch.exp(log_f + m - m_new) * c
                 + torch.exp(i_pre - m_new) * z)
        n_new = torch.exp(log_f + m - m_new) * n + torch.exp(i_pre - m_new)
        h_new = o * c_new / n_new.clamp_min(1e-6)
        state = SlstmState(c_new, n_new, m_new, h_new)
        hs.append(h_new)
    return torch.stack(hs, dim=1).to(x_gates.dtype), state
