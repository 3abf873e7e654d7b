"""``elementwise_share.train``: the device time of the kernels that are
neither a matrix product nor the port's attention (the optimizer's and
the model's elementwise passes and reductions; copies and memsets are
not kernels and count only in the busy time) over the device busy time
of the traced steps, in %."""

import re

GEMM = re.compile(r"gemm|gemv|nvjet|cutlass|xmma|cublas|splitKreduce",
                  re.IGNORECASE)
ATTENTION = re.compile(r"flash_attention_wgmma_kernel"
                       r"|flash_attention_f32_kernel"
                       r"|\bdelta_kernel|\bdq_kernel|\bdkv_kernel")
NOT_KERNELS = re.compile(r"^(Memcpy|Memset)")


def _elementwise(name: str) -> bool:
    return not (GEMM.search(name) or ATTENTION.search(name)
                or NOT_KERNELS.search(name))


def read(window: dict, trace) -> float | None:
    if trace is None or not trace.dev:
        return None
    return 100.0 * trace.device_s(_elementwise) / trace.busy_s
