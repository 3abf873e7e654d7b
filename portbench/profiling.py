"""The traced segment of a ``--trace 1`` run: ``torch.profiler`` over a
fixed piece of work (whole requests or whole steps), read into device
intervals by name and the host operations running meanwhile.

``busy_s`` is the union of the device's kernel and copy intervals,
``wall_s`` the host clock around the work (ended by a synchronize).  The
breakdown gives the device operations that took most time, and the
idle gaps (no kernel or copy running) summed by the innermost host
operation running at each gap's middle ("host python" where none is).
"""

from __future__ import annotations

import bisect
import dataclasses
import time

from portbench.flops import busy

NAME_CHARS = 120


@dataclasses.dataclass
class Trace:
    dev: list            # (name, start_us, end_us) of kernels and copies
    host: list           # (name, start_us, end_us) of host operations
    wall_s: float
    units: int           # requests or steps traced
    work: list           # what each unit was: a prompt length, a batch

    @property
    def busy_s(self) -> float:
        return busy((s, e) for _, s, e in self.dev) / 1e6

    def device_s(self, match) -> float:
        """Device seconds of the operations whose name ``match`` takes."""
        return sum(e - s for n, s, e in self.dev if match(n)) / 1e6

    def by_kind(self, kinds: dict) -> dict:
        """Device seconds of each kind (``{kind: match}``, the first that
        matches a name) and of the rest."""
        out = dict.fromkeys([*kinds, "other"], 0.0)
        for name, s, e in self.dev:
            kind = next((k for k, match in kinds.items() if match(name)),
                        "other")
            out[kind] += (e - s) / 1e6
        return out

    def top_ops(self, n: int = 10) -> list:
        acc: dict[str, float] = {}
        for name, s, e in self.dev:
            acc[name] = acc.get(name, 0.0) + (e - s) / 1e6
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:NAME_CHARS], sec] for name, sec in top]

    def idle_gaps(self, n: int = 10) -> list:
        if not self.dev:
            return []
        host = sorted(self.host, key=lambda ev: ev[1])
        starts = [ev[1] for ev in host]
        acc: dict[str, float] = {}
        end = None
        for _, s, e in sorted(self.dev, key=lambda ev: ev[1]):
            if end is not None and s > end:
                acc_key = _host_at(host, starts, (end + s) / 2)
                acc[acc_key] = acc.get(acc_key, 0.0) + (s - end) / 1e6
            end = e if end is None else max(end, e)
        top = sorted(acc.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:NAME_CHARS], sec] for name, sec in top]


def _host_at(host: list, starts: list, t: float, scan: int = 4000) -> str:
    """The innermost host operation running at ``t``: of those that
    started before it, the latest to start that has not ended."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - scan), -1):
        name, s, e = host[j]
        if e >= t:
            return name
    return "host python"


def _events(prof) -> tuple[list, list]:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    try:
        raw = prof.profiler.kineto_results.events()
        for ev in raw:
            start = ev.start_ns() / 1e3
            row = (ev.name(), start, start + ev.duration_ns() / 1e3)
            (dev if ev.device_type() == cuda else host).append(row)
    except AttributeError:
        for ev in prof.events():
            row = (ev.name, ev.time_range.start, ev.time_range.end)
            (dev if ev.device_type == cuda else host).append(row)
    return dev, host


def capture(fn, units: int, work: list, device: str) -> Trace:
    """Run ``fn`` (``units`` whole requests or steps) under the profiler,
    host and (on a card) device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    card = device != "cpu"
    activities = [ProfilerActivity.CPU]
    if card:
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if card:
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    dev, host = _events(prof)
    return Trace(dev=dev, host=host, wall_s=wall, units=units, work=work)
