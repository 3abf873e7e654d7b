"""``device_ops_per_request.prefill``: the kernels and copies the
profiler recorded over the traced requests (one pass over the replay
set), per request.  The MoE FFN's loop over experts sets most of it in
a MoE model."""


def read(window: dict, trace) -> float | None:
    if trace is None or not trace.dev or not trace.units:
        return None
    return len(trace.dev) / trace.units
