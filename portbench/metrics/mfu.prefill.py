"""``mfu.prefill``: the model FLOPs of every prompt prefilled in the
window (``flops.prefill_flops``: the benchmark's count from the
configuration) over the window's host-clock length, as a share of the
H100's dense bf16 peak, in %."""

from portbench import flops


def read(window: dict, trace) -> float | None:
    if not window.get("requests"):
        return None
    return 100.0 * window["flops"] / window["seconds"] / flops.BF16_FLOPS
