"""``attn_roofline.train``: the least time of the traced steps' causal
attention, forward and backward, in every layer
(``flops.attention_fwd_least_s`` + ``attention_bwd_least_s``: the work
the shapes need once, whatever remat recomputes) over the device time of
the kernels whose names match ``KERNELS``, in %."""

import re

from portbench import flops

# #4's forward (run again by remat) and its backward 4' (delta, dq, dkv)
KERNELS = re.compile(r"flash_attention_wgmma_kernel"
                     r"|flash_attention_f32_kernel"
                     r"|\bdelta_kernel|\bdq_kernel|\bdkv_kernel")


def read(window: dict, trace) -> float | None:
    if trace is None:
        return None
    spent = trace.device_s(KERNELS.search)
    if spent <= 0:
        return None
    sz = window["sizes"]
    least = sum(sz["L"] * (flops.attention_fwd_least_s(sz, b, s)
                           + flops.attention_bwd_least_s(sz, b, s))
                for b, s in trace.work)
    return 100.0 * least / spent
