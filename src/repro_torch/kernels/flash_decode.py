"""Decode attention: wrapper, plain version and launch count of the
hand-written CUDA kernel ``repro_torch/csrc/flash_decode.cu``.

:func:`flash_decode` replaces the Pallas TPU kernel
``repro.kernels.flash_decode.flash_decode``: one query token per
sequence, ``q [B, H, D]``, over a KV cache ``k/v [B, S, KH, D]`` of
which the first ``length[b]`` positions are valid, with GQA and the
reference's online-softmax semantics.  Cache positions at or past
``length[b]`` are never read; any ``S`` is taken.

The kernel splits each sequence's cache range into
:func:`decode_splits` chunks, a function of the capacity ``S`` and the
SM count only (so the wrapper never reads ``length`` on the host), and
combines the chunks' float32 partials in a second pass;
:func:`flash_decode_split_plain` is that two-pass algorithm in plain
PyTorch.

MLA's absorbed decode has kernels of its own,
``repro_torch/csrc/flash_decode_mla.cu`` behind :func:`flash_decode_mla`:
the reference's ``decode_attention_jnp`` over keys ``[ckv | krope]``
(576 columns) of one latent head with values ``ckv`` (512), every query
head of the latent in one CTA; bf16 on the tensor cores (``mma.sync``),
float32 on the CUDA cores.  Its split plan is :func:`mla_splits`, a
function of ``S``, the batch, the heads and the SM count only.  Its
plain versions are :func:`flash_decode_mla_plain` and, at the kernel's
plan, :func:`flash_decode_mla_split_plain`.

Both kernels can also return each row's log-sum-exp (``with_lse``): a
float32 ``[B, H]`` of ``log Σ exp(s)`` over the valid positions, the
scores ``s`` in the softmax's own scaling (``dot(q, k)`` times the
kernel's ``1/sqrt(D)``), ``NEG_INF`` for a row with no valid position.
Ranks that each hold a slice of a cache merge their partial outputs by
it (:func:`merge_partials`).  Without it the kernels write nothing
more.

On a tensor that lies on the CPU each wrapper computes its plain
version; on a CUDA tensor it launches its kernel or raises.  Every
launch adds one to :data:`LAUNCHES`.  On a ``meta`` tensor (the
dry-run's) each launches nothing and returns an empty output, reporting
the kernel's work over every row of the cache
(:mod:`repro_torch.kernels._meta`).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _meta
from repro_torch.kernels._nvcc import (
    BASE_FLAGS,
    CSRC,
    CudaLibrary,
    raise_on,
    refuse_grad,
    stream_of,
)
from repro_torch.kernels.flash_attention import (
    DTYPES,
    NEG_INF,
    check_attention_args,
    check_cuda_operands,
    softmax_scale,
)

SOURCE = CSRC / "flash_decode.cu"
MLA_SOURCE = CSRC / "flash_decode_mla.cu"
# held by tolerance, so FMA contraction stays on
NVCC_FLAGS = BASE_FLAGS
#: head dims the decode kernel is built for
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)
#: query heads per KV head (``H / KH``) the kernel takes
MAX_GROUP = 16
#: the MLA kernel's latent and rope widths (deepseek-v2's r and dr)
MLA_WIDTHS = (512, 64)
#: fewest cache positions worth a chunk of their own (one kernel tile)
MIN_CHUNK = 64
#: SMs per split: the splits of 16 (batch, KV head) pairs fill the card
SMS_PER_SPLIT = 16
#: keys a tile of the MLA kernels; an MLA chunk is a multiple of it
MLA_KEY_TILE = 32
#: query heads one CTA of the MLA kernels serves
MLA_HEADS = 16
#: CTAs an SM the MLA split plan allows (two fit in one SM's shared
#: memory and registers)
MLA_CTAS_PER_SM = 2

#: kernel launches since the last :func:`reset_launch_counts`
LAUNCHES = {"flash_decode": 0, "flash_decode_mla": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pfdnn_flash_decode.argtypes = ([p] * 6 + [i] * 7
                                       + [ctypes.c_float, p, p])
    lib.pfdnn_flash_decode.restype = ctypes.c_int


def _declare_mla(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pfdnn_flash_decode_mla.argtypes = ([p] * 7 + [i] * 8
                                           + [ctypes.c_float, p, p])
    lib.pfdnn_flash_decode_mla.restype = ctypes.c_int


LIBRARY = CudaLibrary(SOURCE, NVCC_FLAGS, _declare)
#: MLA's absorbed decode (``pfdnn_flash_decode_mla``)
MLA_LIBRARY = CudaLibrary(MLA_SOURCE, NVCC_FLAGS, _declare_mla)


def decode_splits(capacity: int, n_sms: int) -> int:
    """Chunks each sequence's cache range of ``capacity`` positions is
    split into: at most ``n_sms // SMS_PER_SPLIT``, each at least
    ``MIN_CHUNK`` positions.  A pure function of its two integers."""
    most = max(1, n_sms // SMS_PER_SPLIT)
    return max(1, min(most, capacity // MIN_CHUNK))


def mla_splits(capacity: int, batch: int, heads: int,
               n_sms: int) -> tuple[int, int]:
    """``(n_split, chunk)`` of the MLA kernels: each sequence's cache
    range of ``capacity`` positions cut into ``n_split`` chunks of
    ``chunk`` positions, a multiple of ``MLA_KEY_TILE``, none of them
    wholly past ``capacity``.  The ``batch * ceil(heads / MLA_HEADS)``
    (sequence, head group) pairs get at most ``MLA_CTAS_PER_SM`` CTAs an
    SM, one wave of resident CTAs even when every chunk is live (or one
    split when the pairs alone exceed that), and as many splits as that
    allows, cut into chunks of equal tiles.  A pure function of its
    integers."""
    tiles = max(1, -(-capacity // MLA_KEY_TILE))
    pairs = max(1, batch * -(-heads // MLA_HEADS))
    most = min(tiles, max(1, MLA_CTAS_PER_SM * n_sms // pairs))
    per = -(-tiles // most)                    # tiles a chunk
    return -(-tiles // per), per * MLA_KEY_TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 length: torch.Tensor, *, with_lse: bool = False):
    """``q [B, H, D]`` × cache ``k/v [B, S, KH, D]``, ``length [B]``
    int32 → ``[B, H, D]`` in q's dtype.  A length past ``S`` counts as
    ``S``; a length of 0 gives zeros.  ``with_lse``: ``(out, lse)``,
    ``lse`` each row's float32 log-sum-exp of its scaled scores
    (``NEG_INF`` with no valid position)."""
    name = "flash_decode"
    check_attention_args(name, q, k, v, "[B, H, D]", "[B, S, KH, D]",
                         HEAD_DIMS)
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"{name}: q [B, H, D] and k/v [B, S, KH, D]")
    B, H, D = q.shape
    _, S, KH, _ = k.shape
    if k.shape[0] != B or KH == 0 or H % KH:
        raise ValueError(f"{name}: batch or head counts disagree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if (not isinstance(length, torch.Tensor) or length.dtype != torch.int32
            or tuple(length.shape) != (B,) or length.device != q.device):
        raise ValueError(f"{name}: length must be an int32 tensor [B] "
                         f"on {q.device}")
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, length, with_lse=with_lse)
    if q.device.type == "meta":
        out = torch.empty_like(q)
        lse = _lse_buffer(q, with_lse)
        _meta.report(name, 4 * D * B * H * S,
                     _meta.nbytes(q, k, v, length, out, lse))
        return (out, lse) if with_lse else out
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    if H // KH > MAX_GROUP:
        raise ValueError(f"{name}: {H // KH} query heads per KV head; "
                         f"the kernel serves at most {MAX_GROUP}")
    refuse_grad(name, dict(q=q, k=k, v=v))
    check_cuda_operands(name, dict(q=q, k=k, v=v, length=length))
    out = torch.empty_like(q)
    lse = _lse_buffer(q, with_lse)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    lib = LIBRARY.load()
    index = q.device.index
    n_split = decode_splits(S, _sm_count(
        torch.cuda.current_device() if index is None else index))
    # float32 partials (acc [B, H, n_split, D], then (m, l) [B, H,
    # n_split, 2]); the first pass writes every slot
    part = torch.empty(B * H * n_split * (D + 2), dtype=torch.float32,
                       device=q.device)
    with torch.cuda.device(q.device):
        err = lib.pfdnn_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
            part.data_ptr(), out.data_ptr(), B, H, KH, S, D, n_split,
            DTYPES[q.dtype], softmax_scale(D), stream_of(q.device),
            _ptr(lse))
    raise_on(name, err)
    LAUNCHES[name] += 1
    return (out, lse) if with_lse else out


def _lse_buffer(q: torch.Tensor, with_lse: bool) -> torch.Tensor | None:
    """The float32 ``[B, H]`` log-sum-exp output, or ``None``."""
    if not with_lse:
        return None
    return torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _lse_of(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """``m + log(l)`` where ``l > 0``, else ``NEG_INF`` (float32)."""
    return torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                       torch.full_like(m, NEG_INF))


def merge_partials(out: torch.Tensor, lse: torch.Tensor, reduce_max,
                   reduce_sum) -> torch.Tensor:
    """Merge the decode outputs ``out [B, H, Dv]`` of ranks that each
    attended over their slice of one cache, by their rows' log-sum-exp
    ``lse [B, H]``: ``M = max_r lse_r``, then ``Σ_r w_r·out_r / Σ_r w_r``
    with ``w_r = exp(lse_r − M)`` in float32, in ``out``'s dtype.
    ``reduce_max(t)`` and ``reduce_sum(t)`` reduce a float32 tensor over
    the ranks (in place or not; their results are used).  A rank whose
    slice holds no valid row (``lse = NEG_INF``) weighs 0 beside one
    that does; a row no rank holds gives zeros (each ``out_r`` is 0)."""
    top = reduce_max(lse.clone())
    w = torch.exp(lse - top)[..., None]
    both = reduce_sum(torch.cat([out.float() * w, w], dim=-1))
    return (both[..., :-1] / both[..., -1:]).to(out.dtype)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       length: torch.Tensor, *, with_lse: bool = False):
    """Plain PyTorch version of :func:`flash_decode`: the full masked
    softmax in float32 with the kernel's ``NEG_INF`` mask and clamp and
    its cast points.  V may be narrower than K (MLA's values).
    ``with_lse`` as :func:`flash_decode`'s."""
    B, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    g = H // KH
    kf = k.float().permute(0, 2, 3, 1)                     # [B, KH, D, S]
    vf = v.permute(0, 2, 1, 3)                             # [B, KH, S, Dv]
    s = torch.matmul(q.float().view(B, KH, g, D), kf) * softmax_scale(D)
    valid = (torch.arange(S, device=q.device)[None, :]
             < length.to(q.device)[:, None])               # [B, S]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(0.5 * NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), vf.float())  # [B, KH, g, Dv]
    out = (out / l.clamp_min(1e-30)).reshape(B, H, -1).to(q.dtype)
    if with_lse:
        return out, _lse_of(m, l).reshape(B, H)
    return out


def flash_decode_split_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, length: torch.Tensor,
                             n_split: int, chunk: int | None = None, *,
                             with_lse: bool = False):
    """Plain PyTorch version of the kernel's two passes: the cache range
    cut into ``n_split`` chunks of ``chunk`` positions (by default
    ``ceil(S / n_split)``, :func:`flash_decode`'s; ``n_split * chunk >=
    S``), a float32 partial ``(m, l, acc)`` per chunk (``p`` rounded to
    V's dtype before ``P·V``; a chunk wholly past ``length`` gives ``m =
    NEG_INF, l = 0, acc = 0``), then the partials combined in chunk order
    with the clamp and ``acc / max(l, 1e-30)``; ``with_lse`` also the
    combine's ``m + log(l)`` (as :func:`flash_decode`'s).  V may be
    narrower than K (MLA's values)."""
    B, H, D = q.shape
    S, KH = k.shape[1], k.shape[2]
    g = H // KH
    chunk = -(-S // n_split) if chunk is None else chunk
    pad = n_split * chunk - S
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, 0, 0, pad))
    vf = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    kf = kf.view(B, n_split, chunk, KH, D).permute(0, 3, 1, 4, 2)
    vf = vf.view(B, n_split, chunk, KH, -1).permute(0, 3, 1, 2, 4)
    # s [B, KH, n_split, g, chunk]
    s = torch.matmul(q.float().view(B, KH, 1, g, D), kf) * softmax_scale(D)
    pos = torch.arange(n_split * chunk, device=q.device).view(n_split, chunk)
    valid = pos[None] < length.to(q.device).clamp(0, S)[:, None, None]
    s = torch.where(valid[:, None, :, None, :], s,
                    torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)                    # unclamped
    p = torch.exp(s - m.clamp_min(0.5 * NEG_INF))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), vf.float())
    m_all = m.amax(dim=2, keepdim=True).clamp_min(0.5 * NEG_INF)
    w = torch.exp(m.clamp_min(0.5 * NEG_INF) - m_all)
    lg = (l * w).sum(dim=2)
    out = (acc * w).sum(dim=2) / lg.clamp_min(1e-30)
    out = out.reshape(B, H, -1).to(q.dtype)
    if with_lse:
        return out, _lse_of(m_all[:, :, 0], lg).reshape(B, H)
    return out


def flash_decode_mla(q_lat: torch.Tensor, q_rope: torch.Tensor,
                     ckv: torch.Tensor, krope: torch.Tensor,
                     length: torch.Tensor, *, with_lse: bool = False):
    """MLA's absorbed decode: ``q_lat [B, H, R]`` and ``q_rope [B, H,
    DR]`` over one latent head's cache ``ckv [B, S, R]`` and ``krope [B,
    S, DR]``, ``length [B]`` int32 → ``[B, H, R]`` in q's dtype: decode
    attention with keys ``[ckv | krope]``, values ``ckv`` and the scale
    ``1/sqrt(R + DR)``.  A length past ``S`` counts as ``S``; a length of
    0 gives zeros.  The kernel takes ``(R, DR) = MLA_WIDTHS``; the plain
    version any widths.  ``with_lse`` as :func:`flash_decode`'s."""
    name = "flash_decode_mla"
    tensors = dict(q_lat=q_lat, q_rope=q_rope, ckv=ckv, krope=krope)
    for key, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {key} must be a torch.Tensor")
        if t.device != q_lat.device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{q_lat.device}")
        if t.dtype not in DTYPES or t.dtype != q_lat.dtype:
            raise TypeError(f"{name}: {key} has dtype {t.dtype}; all four "
                            f"share one of {sorted(map(str, DTYPES))}")
        if t.dim() != 3:
            raise ValueError(f"{name}: q_lat/q_rope [B, H, R/DR] and "
                             f"ckv/krope [B, S, R/DR]")
    B, H, R = q_lat.shape
    S, DR = ckv.shape[1], krope.shape[2]
    if (q_rope.shape != (B, H, DR) or ckv.shape != (B, S, R)
            or krope.shape != (B, S, DR)):
        raise ValueError(f"{name}: shapes disagree: q_lat "
                         f"{tuple(q_lat.shape)}, q_rope "
                         f"{tuple(q_rope.shape)}, ckv {tuple(ckv.shape)}, "
                         f"krope {tuple(krope.shape)}")
    if (not isinstance(length, torch.Tensor) or length.dtype != torch.int32
            or tuple(length.shape) != (B,)
            or length.device != q_lat.device):
        raise ValueError(f"{name}: length must be an int32 tensor [B] "
                         f"on {q_lat.device}")
    if q_lat.device.type == "cpu":
        return flash_decode_mla_plain(q_lat, q_rope, ckv, krope, length,
                                      with_lse=with_lse)
    if q_lat.device.type == "meta":
        out = torch.empty_like(q_lat)
        lse = _lse_buffer(q_lat, with_lse)
        _meta.report(name, (2 * (R + DR) + 2 * R) * B * H * S,
                     _meta.nbytes(q_lat, q_rope, ckv, krope, length, out,
                                  lse))
        return (out, lse) if with_lse else out
    if q_lat.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q_lat.device}")
    if (R, DR) != MLA_WIDTHS:
        raise ValueError(f"{name}: widths (R, DR) = {(R, DR)}; the kernel "
                         f"is built for {MLA_WIDTHS}")
    refuse_grad(name, tensors)
    check_cuda_operands(name, dict(tensors, length=length))
    out = torch.empty_like(q_lat)
    lse = _lse_buffer(q_lat, with_lse)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    lib = MLA_LIBRARY.load()
    index = q_lat.device.index
    n_split, chunk = mla_splits(S, B, H, _sm_count(
        torch.cuda.current_device() if index is None else index))
    # float32 partials (acc [B, H, n_split, R], then (m, l) [B, H,
    # n_split, 2]); only the chunks below length are written and read
    part = torch.empty(B * H * n_split * (R + 2), dtype=torch.float32,
                       device=q_lat.device)
    with torch.cuda.device(q_lat.device):
        err = lib.pfdnn_flash_decode_mla(
            q_lat.data_ptr(), q_rope.data_ptr(), ckv.data_ptr(),
            krope.data_ptr(), length.data_ptr(), part.data_ptr(),
            out.data_ptr(), B, H, S, R, DR, n_split, chunk,
            DTYPES[q_lat.dtype], softmax_scale(R + DR),
            stream_of(q_lat.device), _ptr(lse))
    raise_on(name, err)
    LAUNCHES[name] += 1
    return (out, lse) if with_lse else out


def mla_operands(q_lat: torch.Tensor, q_rope: torch.Tensor,
                 ckv: torch.Tensor, krope: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """MLA's decode as :func:`flash_decode`'s operands: ``q [B, H, R +
    DR]``, keys ``[ckv | krope]`` and values ``ckv`` as one KV head ``[B,
    S, 1, R + DR]`` and ``[B, S, 1, R]``."""
    return (torch.cat([q_lat, q_rope], dim=-1),
            torch.cat([ckv, krope], dim=-1)[:, :, None], ckv[:, :, None])


def flash_decode_mla_plain(q_lat: torch.Tensor, q_rope: torch.Tensor,
                           ckv: torch.Tensor, krope: torch.Tensor,
                           length: torch.Tensor, *, with_lse: bool = False):
    """Plain PyTorch version of :func:`flash_decode_mla`:
    :func:`flash_decode_plain` over :func:`mla_operands`."""
    return flash_decode_plain(*mla_operands(q_lat, q_rope, ckv, krope),
                              length, with_lse=with_lse)


def flash_decode_mla_split_plain(q_lat: torch.Tensor, q_rope: torch.Tensor,
                                 ckv: torch.Tensor, krope: torch.Tensor,
                                 length: torch.Tensor, n_sms: int, *,
                                 with_lse: bool = False):
    """The MLA kernels' two passes in plain PyTorch:
    :func:`flash_decode_split_plain` over :func:`mla_operands` at
    :func:`mla_splits`' plan for a card of ``n_sms`` SMs."""
    B, H, _ = q_lat.shape
    n_split, chunk = mla_splits(ckv.shape[1], B, H, n_sms)
    return flash_decode_split_plain(*mla_operands(q_lat, q_rope, ckv, krope),
                                    length, n_split, chunk,
                                    with_lse=with_lse)
