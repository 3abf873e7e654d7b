"""``mfu.train``: 3 × the forward model FLOPs of every step of the
window (``flops.train_step_flops``; the recomputation of remat is not
counted) over the window's host-clock length, as a share of the H100's
dense bf16 peak, in %."""

from portbench import flops


def read(window: dict, trace) -> float | None:
    if not window.get("steps"):
        return None
    return 100.0 * window["flops"] / window["seconds"] / flops.BF16_FLOPS
