"""The yardstick: the H100's published peaks and the work each cell's
shapes need, counted from the configuration (never from the program),
and the device's busy time in a profile.

Model FLOPs a token are 2 × the matrix parameters a token passes through
(attention projections, and the FFN: the dense one, or the router, the
shared experts and ``top_k`` routed experts, each counted once), plus
2·(D_qk + D_v) a head and a kept causal (query, key) pair for attention;
the embedding is a lookup and counts nothing; the head counts where
logits are made (the last position of a prefill, every position of a
training step).  A training step is 3 × its forward (no recomputation
counted).
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal mask keeps in a sequence of ``s``."""
    return s * (s + 1) // 2


def qk_v_dims(sz: dict) -> tuple[int, int]:
    """(D_qk, D_v) of the model's attention heads: MLA's key is the
    128-dim latent key and the 64-dim RoPE key, its value 128."""
    if sz["mla"]:
        return sz["hd"] + sz["dr"], sz["dv"]
    return sz["hd"], sz["hd"]


def layer_matrix_params(sz: dict) -> int:
    """Matrix parameters a token passes through in one layer."""
    d, h, kh, hd = sz["d"], sz["h"], sz["kh"], sz["hd"]
    if sz["mla"]:
        r, dr, dv = sz["r"], sz["dr"], sz["dv"]
        attn = d * h * (hd + dr) + d * (r + dr) + r * kh * (hd + dv) \
            + h * dv * d
        ffn = d * sz["E"] + 3 * d * sz["fs"] + sz["k"] * 3 * d * sz["fe"]
    else:
        attn = d * h * hd + 2 * d * kh * hd + h * hd * d
        ffn = 3 * d * sz["f"]
    return attn + ffn


def active_params(sz: dict) -> int:
    """Parameters a token uses: every layer's matrices (shared experts
    once, ``top_k`` routed experts), the embedding row and the head."""
    return sz["L"] * layer_matrix_params(sz) + 2 * sz["d"] * sz["V"]


def attention_flops(sz: dict, pairs: int) -> int:
    """Attention's products over ``pairs`` kept pairs in every layer and
    head: QKᵀ (2·D_qk) and PV (2·D_v) a pair."""
    dqk, dv = qk_v_dims(sz)
    return sz["L"] * sz["h"] * 2 * (dqk + dv) * pairs


def prefill_flops(sz: dict, s: int) -> int:
    """One prompt of ``s`` tokens, logits at its last position."""
    return 2 * sz["L"] * layer_matrix_params(sz) * s \
        + 2 * sz["d"] * sz["V"] + attention_flops(sz, causal_pairs(s))


def train_step_flops(sz: dict, batch: int, seq: int) -> int:
    """3 × the forward of ``batch`` sequences of ``seq``, logits at every
    position."""
    tokens = batch * seq
    fwd = 2 * sz["L"] * layer_matrix_params(sz) * tokens \
        + 2 * sz["d"] * sz["V"] * tokens \
        + attention_flops(sz, batch * causal_pairs(seq))
    return 3 * fwd


def attention_fwd_least_s(sz: dict, batch: int, s: int) -> float:
    """The least time of one layer's causal attention forward over
    ``batch`` sequences of ``s`` in bf16: the larger of its operations at
    the bf16 peak and its bytes (q, k, v read once, the output written
    once) at HBM bandwidth."""
    dqk, dv = qk_v_dims(sz)
    h, kh = sz["h"], sz["kh"]
    ops = h * 2 * (dqk + dv) * batch * causal_pairs(s)
    nbytes = 2 * batch * s * (h * dqk + kh * dqk + kh * dv + h * dv)
    return max(ops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def attention_bwd_least_s(sz: dict, batch: int, s: int) -> float:
    """The same for the backward: the scores again (2·D_qk a pair), dP
    and dV (2·D_v each), dQ and dK (2·D_qk each); q, k, v, the output
    and its gradient read once, dq, dk, dv written once."""
    dqk, dv = qk_v_dims(sz)
    h, kh = sz["h"], sz["kh"]
    ops = h * (6 * dqk + 4 * dv) * batch * causal_pairs(s)
    nbytes = 2 * batch * s * (2 * (h * dqk + kh * dqk + kh * dv)
                              + 2 * h * dv)
    return max(ops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def busy(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total = 0.0
    end = float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def device_busy(prof) -> tuple[float, list] | None:
    """The card's busy time in a profile (union of its kernel and copy
    intervals, µs) and the device time by operation, largest first;
    None when the profiler recorded no device events."""
    import torch

    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
    by_name: dict[str, list] = {}
    for ev in dev:
        acc = by_name.setdefault(ev.name, [0, 0.0])
        acc[0] += 1
        acc[1] += ev.time_range.elapsed_us()
    total = busy((ev.time_range.start, ev.time_range.end) for ev in dev)
    return total, sorted(by_name.items(), key=lambda kv: -kv[1][1])


def profiler_check(reps: int = 10) -> str:
    """torch.profiler against CUDA events on one spin kernel of a fixed
    cycle count (``torch.cuda._sleep``, ~1 ms): how many of ``reps``
    launches the profiler recorded, and the factor by which its device
    time reads at this point of the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def spin():
        torch.cuda._sleep(2_000_000)

    spin()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        spin()
    stop.record()
    torch.cuda.synchronize()
    ev = start.elapsed_time(stop) / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            spin()
        torch.cuda.synchronize()
    found = device_busy(prof)
    if found is None:
        return "profiler check: no device events recorded"
    total, by_name = found
    seen = sum(n for _, (n, _) in by_name)
    return (f"profiler check: a spin kernel takes {ev:.4f} ms by CUDA "
            f"events; torch.profiler recorded {seen} of {reps} launches, a "
            f"busy time of {total / reps / 1e3:.5f} ms a call (ratio "
            f"{total / reps / 1e3 / ev:.4f})")
