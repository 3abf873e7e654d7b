"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; the traffic's
``kind`` picks the module (``kinds/<kind>.py``) that builds the port's
system from the seed, warms it, measures for ``--seconds`` and checks
what the window produced against the plain reference.  With ``--trace
0`` the line's metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, each read by ``metrics/<name>.py``
(a reader that finds nothing to read leaves its metric out).  The last
lines on standard error, and the ``checks`` key that ends the result
line, give each compared number beside its limit.  The run needs a CUDA
device and exits non-zero, printing no result, without one, or if JAX
or the JAX package was loaded.
"""

from __future__ import annotations

import time

STARTED = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the device operations of a traced run by kind, for the log
KINDS = {"copies": r"^(Memcpy|Memset)",
         "attention": r"flash_attention|\bdelta_kernel|\bdq_kernel|"
                      r"\bdkv_kernel|flash_decode|mla_",
         "gemm": r"gemm|gemv|nvjet|cutlass|xmma|cublas|splitKreduce"}


def process_start() -> float:
    """When this process started (from /proc), else when this module
    was loaded."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return STARTED


def forbidden_modules(names) -> list:
    """The modules among ``names`` whose top-level name is JAX's or the
    JAX package's, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def _metric(entry: dict, value: float) -> dict:
    return {"value": value, "unit": entry["unit"]}


def main(argv=None, device: str | None = None, root: Path = ROOT) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ["USE_FLAX"] = "0"
    # a test's process (``device`` given) may hold modules other tests
    # loaded; a run judges the whole process
    preloaded = set(sys.modules) if device is not None else set()

    from portbench import check, flops, spec, weights

    cell = spec.cell(args.workload, root)
    chips = cell.chips
    import torch

    if device is None:
        if not torch.cuda.is_available():
            print("portbench: no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < chips:
            print(f"portbench: {args.workload} needs {chips} CUDA devices, "
                  f"{torch.cuda.device_count()} found", file=sys.stderr)
            return 2
        device = "cuda"
        torch.cuda.set_device(0)
        torch.cuda.reset_peak_memory_stats()
    ctx = spec.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                   trace=bool(args.trace), device=device,
                   started=process_start())
    out = spec.kind(cell.traffic, root).run(ctx)

    correct, checks = check.verdict(out["readings"], cell.limits)
    gpu = device != "cpu"
    dev = {"platform": "gpu" if gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if gpu else "cpu",
           "count": chips,
           "memory_peak_bytes": out.get("memory_peak_bytes", 0)}
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"]}
    if args.trace:
        trace = out.get("trace")
        metrics = {}
        window = {**out["window"], "cell": cell,
                  "sizes": weights.sizes(cell.conf)}
        for entry in cell.per_layer:
            value = spec.reader(entry["name"], root).read(window, trace)
            if value is not None:
                metrics[entry["name"]] = _metric(entry, value)
        if gpu:
            print(f"portbench: {flops.profiler_check()}", file=sys.stderr)
        if trace is not None:
            kinds = {name: re.compile(pattern, re.I).search
                     for name, pattern in KINDS.items()}
            print(f"portbench: device seconds by kind "
                  f"{trace.by_kind(kinds)}, busy {trace.busy_s}, wall "
                  f"{trace.wall_s}", file=sys.stderr)
            dev["busy_s"] = trace.busy_s
            dev["window_s"] = trace.wall_s
            line["breakdown"] = {"device_ops": trace.top_ops(),
                                 "idle_gaps": trace.idle_gaps()}
    else:
        metrics = {e["name"]: _metric(e, out["end_to_end"][e["name"]])
                   for e in cell.end_to_end}
    line["metrics"] = metrics
    line["device"] = dev
    line["checks"] = checks

    bad = forbidden_modules(set(sys.modules) - preloaded)
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    print(f"portbench: {args.workload} seed {args.seed}: {out['attempted']} "
          f"attempted, {out['checked']} checked, correct {correct}",
          file=sys.stderr)
    for name in set(out["readings"]) - set(checks):
        print(f"portbench: {name} {out['readings'][name]!r} not compared: "
              f"{cell.limits['not_compared'][name]}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
