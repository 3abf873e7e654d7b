"""``attn_fwd_roofline.prefill``: the least time of the traced requests'
causal attention (every layer, at the model's own D_qk and D_v:
``flops.attention_fwd_least_s``) over the device time of the kernels
whose names match ``KERNELS``, in %."""

import re

from portbench import flops

# the prefill attention kernel #4 (bf16 on wgmma, float32 on CUDA cores)
KERNELS = re.compile(r"flash_attention_wgmma_kernel"
                     r"|flash_attention_f32_kernel")


def read(window: dict, trace) -> float | None:
    if trace is None:
        return None
    spent = trace.device_s(KERNELS.search)
    if spent <= 0:
        return None
    sz = window["sizes"]
    least = sum(sz["L"] * flops.attention_fwd_least_s(sz, 1, n)
                for n in trace.work)
    return 100.0 * least / spent
