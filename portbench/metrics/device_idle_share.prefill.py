"""The share of the traced segment's host-clock length in which no
kernel or copy ran on the device (1 − the profiler's busy union over
the segment), in %."""


def read(window: dict, trace) -> float | None:
    if trace is None or not trace.dev or trace.wall_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.wall_s)
