#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU:

  1. prints the card's name and power limit, builds the CUDA kernels
     from ``src/repro_torch/csrc/`` with ``nvcc`` and prints the build
     time;
  2. kernel phase: calls each kernel's wrapper on the card at the
     shapes the rail sweep gives it (lanes of real rail-subset
     problems) and holds the result against its plain PyTorch version
     on the same inputs, exactly (integer paths equal, gathered floats
     bit-equal); prints each kernel's time (CUDA events, median of 25),
     its plain version's time and its bound;
  3. path phase: compiles the ``pfdnn`` schedule of all four edge
     networks at full width (0.9 x each network's max rate, default
     config) through ``repro_torch.core.compile`` on the card, with the
     launch counts set to 0 just before and read just after; checks
     every schedule byte for byte against the same compile on the CPU
     (plain versions), the three ``pfdnn`` goldens of
     ``tests/golden/pipeline.json``, and replays each schedule for 100
     periods (ledger = prediction, no deadline miss);
  4. profiles one more mobilevit-xxs compile (device busy time against
     the wall clock);
  5. prints the ``kernels`` JSON line and, last, the result line.

Run from the repository root with no arguments: ``python3
chip_smoke.py``.  It needs one CUDA card and exits non-zero, printing
no result, without one or without the repository beside it.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA's data sheet): HBM3 bandwidth, and float64
# outside the tensor cores — the DP's min-plus recurrences have no
# tensor-core form
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12

DEVICE = "cuda"
RATE_FRACTION = 0.9
N_PERIODS = 100
REPS = 25
GOLDEN_KEYS = ("squeezenet1.1|0.9|2|pfdnn", "squeezenet1.1|0.5|3|pfdnn",
               "mobilenetv3-small|0.85|2|pfdnn")
SOURCE = "src/repro_torch/csrc/dp_sweep.cu"
REPLACES = {"dp_multi_stacked": "src/repro/kernels/dp_sweep.py:81",
            "kbest_multi_stacked": "src/repro/kernels/dp_sweep.py:148",
            "path_components": "src/repro/kernels/dp_sweep.py:205"}
# (network, lanes in one call) of the kernel phase: the widest bucket
# of each network's 3-rail sweep
KERNEL_SHAPES = (("mobilevit-xxs", 3), ("mobilenetv3-small", 3),
                 ("squeezenet1.1", 1))
GATHER_PATHS = 512
GATHER_STORE = 64


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def max_rate(name: str) -> float:
    """1 / latency with every domain at V_max (the fastest any schedule
    runs) — the operating points of the goldens derive from it."""
    from repro_torch.hw.edge40nm import EDGE40NM_DEFAULT as acc
    from repro_torch.models.edge_cnn import edge_network
    from repro_torch.perfmodel import characterize_network

    costs = characterize_network(edge_network(name), acc)
    fs = [acc.dvfs(d).freq(acc.v_max) for d in range(3)]
    return 1.0 / sum(max(cy / f for cy, f in zip(c.cycles, fs))
                     for c in costs)


def time_ms(fn) -> float:
    """Median device time of one call (CUDA events, after a warm-up);
    the L2 cache is not flushed between calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ------------------------------------------------------- kernel phase

def sweep_bucket(net: str):
    """The lane store of the widest padded bucket of ``net``'s 3-rail
    pfdnn sweep (pruned subset problems, as the sweep admits them) and
    the idle model of its problems."""
    from repro_torch.core.backend import BucketStack, bucket_key
    from repro_torch.core.context import CompilationContext
    from repro_torch.core.pruning import prune_problem
    from repro_torch.core.rails import all_rail_subsets
    from repro_torch.models.edge_cnn import edge_network

    ctx = CompilationContext(edge_network(net), network=net)
    t_max = 1.0 / (RATE_FRACTION * max_rate(net))
    by_bucket: dict = {}
    for rails in all_rail_subsets(ctx.levels, 3):
        problem = ctx.problem_for(rails, gating=True, allow_sleep=True,
                                  materialize_states=False, t_max=t_max)
        pruned, _ = prune_problem(problem)
        padded = pruned.padded_arrays()
        by_bucket.setdefault(bucket_key(padded), []).append(padded)
    key = max(by_bucket, key=lambda k: k[1])
    store = BucketStack(*key)
    for i, padded in enumerate(by_bucket[key]):
        store.add(i, padded)
    return store, problem.idle


def device_lanes(store, n: int | None = None):
    """The store's first ``n`` lanes (all by default) as float64 / bool
    / int64 tensors on the card — the layout of a lane mirror."""
    import torch

    view = store.view()
    names = ("t_op", "e_op", "valid", "t_trans", "e_trans", "switch")
    return tuple(torch.from_numpy(getattr(view, nm)[:n]).to(DEVICE)
                 for nm in names)


def dp_bound(B, K, L, S) -> tuple[float, str]:
    nbytes = B * (L * S * 17 + (L - 1) * S * S * 16) + B * 8 \
        + 2 * B * K * 8 + B * K * L * 4
    # per (lane, column): 2 mul + 1 add per node, 2 mul + 2 add + 1
    # compare per edge
    ops = B * K * (L * S * 3 + (L - 1) * S * S * 5)
    return _bound(nbytes, ops)


def kbest_bound(B, K, L, S, k) -> tuple[float, str]:
    nbytes = B * (L * S * 17 + (L - 1) * S * S * 16) + B * 8 \
        + B * K * 8 + B * K * k * L * 4 + B * K * 4
    # per (lane, μ): 1 mul + 1 add per node and per edge; 1 add and at
    # least 1 compare per (edge, rank) candidate of the selection
    ops = B * K * (L * S * 2 + (L - 1) * S * S * (2 + 2 * k))
    return _bound(nbytes, ops)


def gather_bound(P, L) -> tuple[float, str]:
    moved = P * L * 16 + P * (L - 1) * 24      # gathered, then written
    nbytes = P * 8 + P * L * 8 + 2 * moved
    return _bound(nbytes, 0)


def _bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sweep_weights(idle, B: int):
    """The λ search's first DP round (min-time, μ = 0, both idle-priced
    branches and the 16-point cold bracket grid) and its k-best round
    (λ and the sleep-priced branch), as ``[B, K]`` rows."""
    import numpy as np

    lam0 = max(idle.p_idle, 1e-3)
    grid = lam0 * 4.0 ** np.arange(-3, 13)
    w_e = np.array([0.0, 1.0, 1.0, 1.0] + [1.0] * len(grid))
    w_t = np.concatenate([[1.0, 0.0, -idle.p_sleep, -idle.p_idle], grid])
    lam = lam0 * 16.0
    mus = np.array([lam, lam - idle.p_sleep])
    return (np.tile(w_e, (B, 1)), np.tile(w_t, (B, 1)),
            np.tile(mus, (B, 1)))


def _max_abs_err(got, want) -> float:
    import torch

    if got.numel() == 0:
        return 0.0
    diff = (got.to(torch.float64) - want.to(torch.float64)).abs()
    return float(torch.nan_to_num(diff, nan=float("inf")).max())


def kernel_phase(k_best: int) -> list[dict]:
    import numpy as np
    import torch

    from repro_torch.kernels import dp_sweep as ks

    rows: dict[str, dict] = {}
    buckets = {net: sweep_bucket(net) for net, _ in KERNEL_SHAPES}
    for net, B in KERNEL_SHAPES:
        store, idle = buckets[net]
        t_op, e_op, valid, t_trans, e_trans, _ = device_lanes(store, B)
        _, L, S = t_op.shape
        lanes = torch.arange(B, dtype=torch.int64, device=DEVICE)
        w_e, w_t, mus = (torch.from_numpy(a).to(DEVICE)
                         for a in sweep_weights(idle, B))
        K = w_e.shape[1]
        args = (t_op, e_op, valid, t_trans, e_trans, lanes)

        err = _max_abs_err(ks.dp_multi_stacked(*args, w_e, w_t),
                           ks.dp_multi_stacked_plain(*args, w_e, w_t))
        check(err == 0.0, f"dp_multi_stacked != plain at [{B},{L},{S}] "
              f"K={K}: max abs err {err}")
        bound, by = dp_bound(B, K, L, S)
        _kernel_row(rows, "dp_multi_stacked", f"[{B},{L},{S}] K={K}",
                    time_ms(lambda: ks.dp_multi_stacked(*args, w_e, w_t)),
                    time_ms(lambda: ks.dp_multi_stacked_plain(*args, w_e,
                                                               w_t)),
                    bound, by, err)

        Km = mus.shape[1]
        paths, counts = ks.kbest_multi_stacked(*args, mus, k_best)
        wp, wc = ks.kbest_multi_stacked_plain(*args, mus, k_best)
        # rows past counts carry no contract: compare the rows below
        rank = torch.arange(k_best, device=DEVICE)[None, None, :, None]
        below = rank < wc[:, :, None, None]
        err = max(_max_abs_err(counts, wc),
                  _max_abs_err(torch.where(below, paths, 0),
                               torch.where(below, wp, 0)))
        check(err == 0.0, f"kbest_multi_stacked != plain at [{B},{L},{S}] "
              f"K={Km}: max abs err {err}")
        bound, by = kbest_bound(B, Km, L, S, k_best)
        _kernel_row(rows, "kbest_multi_stacked",
                    f"[{B},{L},{S}] K={Km} k={k_best}",
                    time_ms(lambda: ks.kbest_multi_stacked(*args, mus,
                                                           k_best)),
                    time_ms(lambda: ks.kbest_multi_stacked_plain(
                        *args, mus, k_best)),
                    bound, by, err)
        del args, t_trans, e_trans

    # the gather: P paths over a 64-lane store of mobilevit-xxs lanes
    from repro_torch.core.backend import BucketStack

    store, _ = buckets[KERNEL_SHAPES[0][0]]
    full = BucketStack(store.view().n_layers, store.view().s_pad)
    for i in range(GATHER_STORE):
        full.add(i, store.padded(i % store.n))
    t_op, e_op, valid, t_trans, e_trans, switch = device_lanes(full)
    rng = np.random.default_rng(0)
    lane_np = rng.integers(0, GATHER_STORE, size=GATHER_PATHS)
    sizes = full.view().valid.sum(axis=2)                # [n, L]
    paths_np = (rng.random((GATHER_PATHS, sizes.shape[1]))
                * sizes[lane_np]).astype(np.int64)
    lanes = torch.from_numpy(lane_np).to(DEVICE)
    paths = torch.from_numpy(paths_np).to(DEVICE)
    gargs = (lanes, paths, t_op, e_op, t_trans, e_trans, switch)
    err = max(_max_abs_err(a, b) for a, b in
              zip(ks.path_components(*gargs),
                  ks.path_components_plain(*gargs)))
    check(err == 0.0, f"path_components != plain: max abs err {err}")
    L = paths.shape[1]
    bound, by = gather_bound(GATHER_PATHS, L)
    _kernel_row(rows, "path_components",
                f"P={GATHER_PATHS} L={L} store={GATHER_STORE} lanes",
                time_ms(lambda: ks.path_components(*gargs)),
                time_ms(lambda: ks.path_components_plain(*gargs)),
                bound, by, err)
    return list(rows.values())


def _kernel_row(rows, name, shape, ms, plain_ms, bound_ms, bound_by,
                err) -> None:
    print(f"kernel {name:20s} {shape:28s} {ms:9.4f} ms  plain "
          f"{plain_ms:9.4f} ms  bound {bound_ms:9.5f} ms ({bound_by})  "
          f"max_abs_err {err}", flush=True)
    # the JSON line carries the widest shape of each kernel (measured
    # first); every shape is printed above
    rows.setdefault(name, {
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None, "shape": shape})


# --------------------------------------------------------- path phase

def _host_free_json(sched) -> str:
    """``to_json`` with the solver stats that measure the host (wall
    clock) or name the device set aside."""
    stats = {k: v for k, v in sched.solver_stats.items()
             if k not in ("wall_time_s", "backend")}
    return dataclasses.replace(sched, solver_stats=stats).to_json()


def path_phase() -> tuple[dict, dict]:
    import torch

    from repro_torch.core import (
        MinEnergy,
        OrchestratorConfig,
        PowerSchedule,
        compile,
    )
    from repro_torch.hw.edge40nm import EDGE40NM_DEFAULT as acc
    from repro_torch.kernels import dp_sweep as ks
    from repro_torch.models.edge_cnn import EDGE_NETWORKS, edge_network
    from repro_torch.perfmodel import characterize_network, plan_banks
    from repro_torch.serve import PeriodicScheduler, PowerRuntime

    golden = json.loads((ROOT / "tests" / "golden" / "pipeline.json")
                        .read_text())
    jobs = [(net, RATE_FRACTION, 3) for net in EDGE_NETWORKS]
    for key in GOLDEN_KEYS:
        net, frac, n_rails, _ = key.split("|")
        jobs.append((net, float(frac), int(n_rails)))

    ks.reset_launch_counts()
    per_job = []
    for net, frac, n_rails in jobs:
        before = dict(ks.LAUNCHES)
        tic = time.perf_counter()
        sched = compile(edge_network(net),
                        MinEnergy(rate_hz=frac * max_rate(net)),
                        cfg=OrchestratorConfig(n_max_rails=n_rails,
                                               device=DEVICE),
                        network=net)
        wall = time.perf_counter() - tic
        launches = {k: ks.LAUNCHES[k] - before[k] for k in ks.LAUNCHES}
        per_job.append((net, frac, n_rails, sched, wall, launches))
    counts = dict(ks.LAUNCHES)
    print(f"path launches: {json.dumps(counts)}", flush=True)
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")

    for net, frac, n_rails, sched, wall, launches in per_job:
        check(isinstance(sched, PowerSchedule),
              f"{net}: no schedule ({sched})")
        stats = sched.solver_stats
        print(f"compile {net:18s} rate {frac} x max  rails<= {n_rails}  "
              f"wall {wall:8.3f} s  E={sched.e_total!r} J  "
              f"T={sched.t_infer!r} s  rails={sched.rails}  "
              f"rounds {stats['stacked_rounds']}  calls "
              f"{stats['stacked_calls']}  launches {json.dumps(launches)}",
              flush=True)
        key = f"{net}|{frac}|{n_rails}|pfdnn"
        if key in golden:
            g = golden[key]
            check(abs(sched.e_total - g["e_total"])
                  <= 1e-9 * abs(g["e_total"])
                  and abs(sched.t_infer - g["t_infer"])
                  <= 1e-9 * abs(g["t_infer"])
                  and list(sched.rails) == g["rails"]
                  and [list(v) for v in sched.layer_voltages]
                  == g["layer_voltages"], f"golden {key} not reproduced")
            print(f"golden {key}: reproduced", flush=True)
        else:
            # the same compile on the CPU (plain versions), byte for byte
            tic = time.perf_counter()
            cpu = compile(edge_network(net),
                          MinEnergy(rate_hz=frac * max_rate(net)),
                          cfg=OrchestratorConfig(n_max_rails=n_rails,
                                                 device="cpu"),
                          network=net)
            check(_host_free_json(cpu) == _host_free_json(sched),
                  f"{net}: schedule on {DEVICE} differs from the CPU's")
            print(f"  {net}: identical to the CPU compile "
                  f"({time.perf_counter() - tic:.3f} s on the CPU)",
                  flush=True)
        # replay
        costs = characterize_network(edge_network(net), acc)
        run = PeriodicScheduler(
            PowerRuntime(sched, costs, plan_banks(costs, acc), acc),
            target_rate_hz=1.0 / sched.t_max).run(N_PERIODS)
        check(run["deadline_misses"] == 0, f"{net}: deadline misses")
        worst = max(abs(led.e_total - sched.e_total) / sched.e_total
                    for led in run["ledgers"])
        check(worst <= 1e-9, f"{net}: ledger/prediction rel err {worst}")
        print(f"  {net}: replayed {N_PERIODS} periods, 0 misses, "
              f"max ledger rel err {worst!r}", flush=True)
    walls = {net: wall for net, frac, n, _, wall, _ in per_job
             if frac == RATE_FRACTION and n == 3}
    return counts, walls


def profile_phase(net: str) -> None:
    """One more compile of ``net`` under ``torch.profiler``: the card's
    busy time (union of its kernel and copy intervals) against the
    compile's wall clock, and the device time by operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import MinEnergy, OrchestratorConfig, compile
    from repro_torch.models.edge_cnn import edge_network

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        compile(edge_network(net),
                MinEnergy(rate_hz=RATE_FRACTION * max_rate(net)),
                cfg=OrchestratorConfig(device=DEVICE), network=net)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tic) * 1e6
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print(f"profile {net}: device time not measured (the profiler "
              "recorded no device events)", flush=True)
        return
    busy = 0.0
    end = float("-inf")
    for s, e in sorted((ev.time_range.start, ev.time_range.end)
                       for ev in dev):
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name: dict[str, list] = {}
    for ev in dev:
        acc = by_name.setdefault(ev.name, [0, 0.0])
        acc[0] += 1
        acc[1] += ev.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"profile {net}: wall {wall_us / 1e3:.3f} ms (profiled)  device "
          f"busy {busy / 1e3:.3f} ms  idle share "
          f"{1.0 - busy / wall_us:.4f}", flush=True)
    for name, (n, us) in top:
        print(f"  device {n:6d} x {us / 1e3:10.3f} ms  {name[:90]}",
              flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import dp_sweep as ks
    except ImportError as exc:
        print(f"chip_smoke: the port is not beside this script ({exc})",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    tic = time.perf_counter()
    ks.load_library()
    print(f"build: {ks.build_library().name} in "
          f"{time.perf_counter() - tic:.2f} s", flush=True)

    from repro_torch.core.policies import OrchestratorConfig
    rows = kernel_phase(OrchestratorConfig().k_candidates)
    counts, walls = path_phase()
    profile_phase(KERNEL_SHAPES[0][0])
    for row in rows:
        row["launches"] = counts[row["name"]]
    print(f"compile walls (s): {json.dumps(walls)}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
