#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU:

  1. prints the card's name and power limit, builds the CUDA kernels
     from ``src/repro_torch/csrc/`` (one ``nvcc`` per source, all
     started together), prints each build's time and the count of
     ``HGMMA`` instructions in the bf16 attention library's SASS and of
     ``IGMMA`` in the int8 library's (``cuobjdump -sass``; each must be
     > 0), and the float32 attention kernel's registers and spills
     (``ptxas -v``);
  2. kernel phase: calls each rail-sweep kernel's wrapper on the card
     at the shapes the rail sweep gives it (lanes of real rail-subset
     problems) and holds the result against its plain PyTorch version
     on the same inputs, exactly (integer paths equal, gathered floats
     bit-equal), with its device time; then the DP and k-best kernels at
     their edges (``KERNEL_EDGES``: values on a coarse grid so ties
     abound, lanes with fewer finite paths than k, L = 1 and 2, S = 1,
     odd S, S = 200 whose slabs are tiled, S = 1024, 12 values of μ),
     exactly; then the grouped gather over the three networks' buckets
     in one launch, exactly, and whole evaluation passes through
     ``TorchBackend.path_costs_grouped`` (an empty and an L = 1 group
     beside them) against the host's sums, with their time a pass
     (events, device, host clock), beside the same pass made one
     ``path_costs_lanes`` call a bucket; then checks the float32
     attention kernel's tiling per head dim against
     ``flash_attention.f32_plan`` and holds the two attention kernels
     against their
     plain versions at the serving shapes of tinyllama-1.1b, the sweep
     of ``tests/test_kernels.py`` and the edges of the bf16 tensor-core
     prefill, the float32 prefill and the split decode (3e-5 abs in
     float32, 2e-2 in bfloat16; rows that see no key and lengths of 0
     give zeros), the serving rows also back to back;
     prints each kernel's time (CUDA events, median of 25), its device
     time (``torch.profiler``), its plain version's time, its bound and,
     for attention, the time of ``scaled_dot_product_attention`` on the
     same inputs (a yardstick the port never calls);
  3. path phase: compiles the ``pfdnn`` schedule of all four edge
     networks at full width (0.9 x each network's max rate, default
     config) through ``repro_torch.core.compile`` on the card, with the
     launch counts set to 0 just before and read just after, and prints
     the evaluation passes and ``path_components`` launches (at most
     one a pass); checks every schedule byte for byte against the same
     compile on the CPU
     (plain versions), the three ``pfdnn`` goldens of
     ``tests/golden/pipeline.json``, and replays each schedule for 100
     periods (ledger = prediction, no deadline miss);
  4. profiles one more mobilevit-xxs compile (device busy time against
     the wall clock, every copy by kind);
  5. serve phase, tinyllama-1.1b at full width on the card: runs the
     entry point ``repro_torch.launch.serve`` as users run it (8
     requests, 16 new tokens, the ``pfdnn`` schedule at 30 Hz, bf16)
     with the launch counts set to 0 just before and read just after;
     holds the kernel path against the plain path (same weights and
     prompts, prefill + 8 decode steps; logits within 1e-3 x max
     |logits| in float32, 2e-2 x in bf16); serves 16 requests of
     512-1024 prompt tokens at batch 16 and prints prefill and decode
     rates and the decode loop's device busy share;
  6. int8 phase (its kernel rows run right after the attention
     kernels' and its entry point after the serve phase): holds the
     int8 matmul kernels exactly (bit for bit)
     against their plain version, ``w`` row-major and K-major, at the
     shapes of ``tests/test_kernels.py``, a ragged shape and
     tinyllama-1.1b's four projection widths at M = 16 (a decode batch,
     the mma.sync route) and M = 16384 (16 x 1024 prefill tokens, the
     wgmma route), printing the route each took; with its time, its
     plain version's, its bound, the time of ``torch._int_mm`` plus the
     same epilogue and, at the projection widths, of ``torch._int_mm``
     alone (yardsticks the port never calls); at M = 16384 also the
     mma.sync route, back-to-back call times and the card's clocks;
     then drives the int8 entry point
     ``repro_torch.kernels.int8_linear`` on bf16 activations and weights
     at those widths (launch counts set to 0 just before, read just
     after, by route: M = 16384 on wgmma, M = 16 on mma.sync, no
     transpose pass; error against ``x @ w`` in float32 below 0.05);
  7. policy phase: compiles all 23 schedules of
     ``tests/golden/pipeline.json`` (all eight policies) on the card and
     holds each against its golden, compares every policy's schedule of
     ``squeezenet1.1|0.5|3`` with the CPU compile byte for byte, compiles
     ``MinLatency`` and ``ParetoFront`` goals on the card against the
     CPU, and prints each compile's wall and DP-kernel launches;
  8. prints the ``kernels`` JSON line and, last, the result line.

``profiler_check`` runs at the start, in the int8 phase and at the end:
it times a spin kernel of a fixed cycle count by CUDA events and under
``torch.profiler`` and prints how many launches the profiler recorded.
The profiler can drop whole launches, more often late in the run, so
``device_ms`` measures a window again when an operation's count is not
a multiple of the calls, and prints "not measured" when no window was
whole; the compile and decode profiles cannot be checked that way and
may read low late in the run.  CUDA-event times are not affected.

Run from the repository root with no arguments: ``python3
chip_smoke.py``.  It needs one CUDA card and exits non-zero, printing
no result, without one or without the repository beside it.  ``python3
chip_smoke.py --sweep-kernels`` builds the rail-sweep library alone,
runs the kernel phase's rail-sweep rows, the grouped gather and the
edges and profiles one mobilevit-xxs compile, and prints no result
line.  ``python3 chip_smoke.py --attention-kernels`` builds the two
prefill attention libraries alone, prints the float32 kernel's
registers and spills (``ptxas -v``) and its plan, runs the prefill
rows and prints the float32 serving row's events, back-to-back, device,
bound and SDPA times; it prints no result line.  Run from a ``git
archive`` of another commit, this script times that commit's kernels
(a tree without the float32 plan skips its check).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
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
# tensor-core form; dense bf16 on the tensor cores, and float32 outside
# them (the attention reference computes float32 without TF32)
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12
INT8_OPS_PER_S = 1979e12

DEVICE = "cuda"
RATE_FRACTION = 0.9
N_PERIODS = 100
REPS = 25
GOLDEN_KEYS = ("squeezenet1.1|0.9|2|pfdnn", "squeezenet1.1|0.5|3|pfdnn",
               "mobilenetv3-small|0.85|2|pfdnn")
SOURCES = {"dp_multi_stacked": "src/repro_torch/csrc/dp_sweep.cu",
           "kbest_multi_stacked": "src/repro_torch/csrc/dp_sweep.cu",
           "path_components": "src/repro_torch/csrc/dp_sweep.cu",
           # the JSON row is the bf16 serving shape; float32 runs on
           # csrc/flash_attention.cu
           "flash_attention": "src/repro_torch/csrc/flash_attention_wgmma.cu",
           "flash_decode": "src/repro_torch/csrc/flash_decode.cu",
           "int8_matmul": "src/repro_torch/csrc/int8_matmul.cu"}
REPLACES = {"dp_multi_stacked": "src/repro/kernels/dp_sweep.py:81",
            "kbest_multi_stacked": "src/repro/kernels/dp_sweep.py:148",
            "path_components": "src/repro/kernels/dp_sweep.py:205",
            "flash_attention": "src/repro/kernels/flash_attention.py:81",
            "flash_decode": "src/repro/kernels/flash_decode.py:68",
            "int8_matmul": "src/repro/kernels/int8_matmul.py:47"}
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


def time_ms_b2b(fn, n: int = 10) -> float:
    """Device time of one call of ``fn`` within ``n`` back-to-back calls
    (one pair of CUDA events around all of them, after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def host_ms(fn, reps: int = REPS) -> float:
    """Median host-clock time of one call of ``fn`` that ends on the
    host (after a warm-up); what a caller waits for."""
    fn()
    times = []
    for _ in range(reps):
        tic = time.perf_counter()
        fn()
        times.append((time.perf_counter() - tic) * 1e3)
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


def _kbest_err(got, want, k: int) -> float:
    """Counts, and the paths of the rows below them (rows past counts
    carry no contract)."""
    import torch

    paths, counts = got
    wp, wc = want
    rank = torch.arange(k, device=paths.device)[None, None, :, None]
    below = rank < wc[:, :, None, None]
    return max(_max_abs_err(counts, wc),
               _max_abs_err(torch.where(below, paths, 0),
                            torch.where(below, wp, 0)))


def synthetic_lanes(seed: int, cap: int, L: int, S: int,
                    sparse: bool = False):
    """A lane store of ``cap`` problems on the card, the layout of a lane
    mirror, with values on a coarse grid (ties in every argmin and every
    k-best merge), invalid tails of random length and finite values in
    the pad slots of the transition tensors; with ``sparse``, lanes 1..
    keep one valid state a layer but for one layer of three, so they
    have three finite paths, fewer than k."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, S + 1, size=(cap, L))
    sizes[0, :] = S                          # one lane fills the bucket
    if sparse:
        sizes[1:] = 1
        sizes[np.arange(1, cap), rng.integers(0, L, size=cap - 1)] = min(S, 3)
    valid = np.arange(S)[None, None, :] < sizes[:, :, None]
    t_op = np.where(valid, rng.integers(1, 5, (cap, L, S)) * 0.25, 0.0)
    e_op = np.where(valid, rng.integers(1, 5, (cap, L, S)) * 0.5, 0.0)
    t_trans = rng.integers(0, 3, (cap, max(L - 1, 0), S, S)) * 0.125
    e_trans = rng.integers(0, 3, (cap, max(L - 1, 0), S, S)) * 0.25
    return tuple(torch.from_numpy(a).to(DEVICE)
                 for a in (t_op, e_op, valid, t_trans, e_trans))


def tie_weights(seed: int, B: int, K: int):
    """Weight columns with zeros, exact duplicates and negative entries
    (as the λ search issues them) and μ values likewise, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    w_e = rng.choice([0.0, 1.0, 1.0, 0.5], size=(B, K))
    w_t = rng.choice([0.0, 1.0, 2.0, -0.25, 0.75], size=(B, K))
    w_e[:, 0], w_t[:, 0] = 0.0, 1.0          # the min-time column
    mus = rng.choice([0.0, 0.5, 1.0, -0.125, 3.0], size=(B, K))
    return tuple(torch.from_numpy(a).to(DEVICE) for a in (w_e, w_t, mus))


def device_mirror(store):
    """The store's lanes as the five tensors a gather reads (t_op, e_op,
    t_trans, e_trans, switch) on the card."""
    t_op, e_op, _, t_trans, e_trans, switch = device_lanes(store)
    return t_op, e_op, t_trans, e_trans, switch


def gather_group(store, P: int, rng):
    """``(store, lanes [P], paths [P, L])``: P random valid paths on
    random lanes of ``store``, host int64 arrays."""
    import numpy as np

    view = store.view()
    lanes = rng.integers(0, store.n, size=P).astype(np.int64)
    sizes = view.valid.sum(axis=2)                      # [n, L]
    paths = (rng.random((P, view.n_layers)) * sizes[lanes]).astype(np.int64)
    return store, lanes, paths


def _ms(v: float | None) -> str:
    return "not measured" if v is None else f"{v:9.5f} ms"


def _gather_err(got, want) -> float:
    """Kernel vs plain output of a grouped gather (float64 words,
    switch bits included: compared as int64 bits, then as values)."""
    import torch

    (a, _), (b, _) = got, want
    check(torch.equal(a.view(torch.int64), b.view(torch.int64)),
          "grouped gather: output bits differ from the plain version")
    return _max_abs_err(a, b)


# (lanes a store keeps, paths a group) of the grouped-gather phase: one
# group per bucket of KERNEL_SHAPES (mobilevit-xxs [70, 64],
# mobilenetv3-small [54, 32], squeezenet1.1 [26, 16]), as an evaluation
# pass of a multi-network sweep hands them over
GROUPED_PATHS = (512, 256, 128)


def gather_phase(buckets, full) -> None:
    """The grouped gather over mixed buckets: the kernel against its
    plain version (exactly), then whole evaluation passes through
    ``TorchBackend.path_costs_grouped`` (upload, launch, download, host
    sums) against the host's sums, with an empty group and an L = 1
    group beside them; event ms, device ms and bound per pass."""
    import numpy as np

    from repro_torch.core.backend import (
        BucketStack,
        PaddedArrays,
        _sum_components,
        _sum_stacked,
        get_backend,
    )
    from repro_torch.kernels import dp_sweep as ks

    rng = np.random.default_rng(1)
    stores = [full] + [buckets[net][0] for net, _ in KERNEL_SHAPES[1:]]
    groups = [gather_group(st, P, rng)
              for st, P in zip(stores, GROUPED_PATHS)]
    mirrors = [device_mirror(st) for st, _, _ in groups]
    gargs = (mirrors, [g[1] for g in groups], [g[2] for g in groups])
    err = _gather_err(ks.path_components_grouped(*gargs),
                      ks.path_components_grouped_plain(*gargs))
    check(err == 0.0, f"grouped path_components != plain: max abs err {err}")
    bound = sum(gather_bound(len(ln), pa.shape[1])[0]
                for _, ln, pa in groups)
    label = " + ".join(f"[P={len(ln)} L={pa.shape[1]} "
                       f"S={st.view().s_pad}]" for st, ln, pa in groups)
    kernel = lambda: ks.path_components_grouped(*gargs)  # noqa: E731
    print(f"gather grouped kernel {label}: {time_ms(kernel):9.4f} ms  "
          f"device {_ms(device_ms(kernel))}  bound {bound:9.5f} ms "
          f"(bytes)  max_abs_err {err}", flush=True)

    # whole passes through the backend; an empty group and an L = 1
    # group ride along (summed on the host)
    bk = get_backend(DEVICE)
    one = BucketStack(1, 16)
    one.add(0, PaddedArrays(
        t_op=np.full((1, 16), 0.5), e_op=np.full((1, 16), 0.25),
        valid=np.ones((1, 16), bool), t_trans=np.zeros((0, 16, 16)),
        e_trans=np.zeros((0, 16, 16)),
        switch=np.zeros((0, 16, 16), np.int64), sizes=(16,)))
    passes = {
        "one group": [groups[0]],
        "mixed": groups + [(stores[1], np.zeros(0, np.int64),
                            np.zeros((0, 54), np.int64)),
                           (one, np.zeros(3, np.int64),
                            np.arange(3, dtype=np.int64)[:, None])],
    }
    for name, pas in passes.items():
        before = ks.LAUNCHES["path_components"]
        got = bk.path_costs_grouped(pas)
        launches = ks.LAUNCHES["path_components"] - before
        check(launches == 1, f"a gather pass ({name}) made {launches} "
              "launches")
        for (st, ln, pa), costs in zip(pas, got):
            want = _sum_stacked(st.view(), ln, pa)
            check(all(np.array_equal(costs[k], want[k])
                      and costs[k].dtype == want[k].dtype for k in want),
                  f"path_costs_grouped ({name}) != host sums")
        ms = time_ms(lambda: bk.path_costs_grouped(pas))
        dev = device_ms(lambda: bk.path_costs_grouped(pas))
        host = host_ms(lambda: bk.path_costs_grouped(pas))
        bound = sum(gather_bound(len(ln), pa.shape[1])[0]
                    for _, ln, pa in pas if len(ln) and pa.shape[1] > 1)
        print(f"gather pass ({name}, {len(pas)} groups) through "
              f"TorchBackend.path_costs_grouped: {ms:9.4f} ms a pass "
              f"(events; upload, launch, download, host sums)  device "
              f"{_ms(dev)}  host clock {host:9.4f} ms  bound {bound:9.5f} "
              f"ms (bytes)  launches a pass {launches}  sums identical",
              flush=True)
    # the same mixed pass the way the evaluation ran it before: one
    # one-bucket call each, all launched before the first result is read
    mixed = passes["mixed"]

    def per_bucket():
        pend = [bk.path_costs_lanes(*g, defer=True) for g in mixed]
        return [p.get() for p in pend]

    before = ks.LAUNCHES["path_components"]
    per_bucket()
    launches = ks.LAUNCHES["path_components"] - before
    print(f"gather pass (mixed) as one path_costs_lanes call a bucket: "
          f"{time_ms(per_bucket):9.4f} ms a pass  device "
          f"{_ms(device_ms(per_bucket))}  host clock "
          f"{host_ms(per_bucket):9.4f} ms  launches a pass {launches}",
          flush=True)
    # where a pass's host time goes, by step (host clock, median)
    lanes, paths = [g[1] for g in groups], [g[2] for g in groups]
    out, layout = ks.path_components_grouped(mirrors, lanes, paths)
    host_out = out.cpu().numpy()
    pack = host_ms(lambda: ks.pack_gather(mirrors, lanes, paths,
                                          pin=DEVICE == "cuda"))
    wrapper = host_ms(lambda: ks.path_components_grouped(mirrors, lanes,
                                                         paths))
    sums = host_ms(lambda: [_sum_components(c) for c in
                            ks.split_components(host_out, layout)])
    print(f"gather pass (3 groups) host steps: pack_gather {pack:.4f} ms, "
          f"wrapper (pack, copy up, launch) {wrapper:.4f} ms, split + "
          f"np.sum {sums:.4f} ms", flush=True)


# (seed, lanes in the store, lanes in the call, L, S, DP columns, μ
# values, k, sparse): the edges of the staged, merged kernels — ties
# everywhere; lanes with fewer finite paths than k; L = 1 and 2; S = 1,
# S not a multiple of 32 (odd, so rows copy in 8-byte chunks); S = 200,
# whose slabs do not fit in shared memory whole (tiles of columns); S
# = 1024, the widest bucket; and more μ values than one CTA takes at S
# = 64
KERNEL_EDGES = (
    (1, 4, 3, 6, 64, 20, 2, 10, False),
    (2, 4, 3, 9, 64, 20, 2, 10, True),
    (3, 3, 2, 2, 64, 7, 2, 10, False),
    (4, 3, 3, 1, 16, 5, 3, 4, False),
    (5, 3, 2, 7, 1, 4, 2, 3, False),
    (6, 4, 3, 8, 45, 20, 2, 10, True),
    (7, 3, 2, 5, 37, 3, 1, 7, False),
    (8, 3, 2, 4, 200, 20, 2, 10, False),
    (9, 2, 1, 2, 1024, 4, 1, 10, False),
    (10, 3, 3, 5, 64, 9, 12, 10, False),
)


def kernel_edge_phase() -> None:
    """The DP and k-best kernels against their plain versions at
    KERNEL_EDGES, exactly."""
    import torch

    from repro_torch.kernels import dp_sweep as ks

    for seed, cap, B, L, S, K, Km, k, sparse in KERNEL_EDGES:
        store = synthetic_lanes(seed, cap, L, S, sparse)
        lanes = torch.tensor([cap - 1 - i for i in range(B)],
                             dtype=torch.int64, device=DEVICE)
        w_e, w_t, _ = tie_weights(seed, B, K)
        _, _, mus = tie_weights(seed + 100, B, Km)
        args = store + (lanes,)
        label = (f"[{B},{L},{S}] of {cap} lanes"
                 f"{' sparse' if sparse else ''}")
        err = _max_abs_err(ks.dp_multi_stacked(*args, w_e, w_t),
                           ks.dp_multi_stacked_plain(*args, w_e, w_t))
        check(err == 0.0, f"dp_multi_stacked != plain at {label} K={K}: "
              f"max abs err {err}")
        ms = time_ms(lambda: ks.dp_multi_stacked(*args, w_e, w_t))
        print(f"kernel edge dp_multi_stacked    {label} K={K}: {ms:9.4f} ms"
              f"  max_abs_err {err}", flush=True)
        got = ks.kbest_multi_stacked(*args, mus, k)
        want = ks.kbest_multi_stacked_plain(*args, mus, k)
        err = _kbest_err(got, want, k)
        check(err == 0.0, f"kbest_multi_stacked != plain at {label} K={Km} "
              f"k={k}: max abs err {err}")
        ms = time_ms(lambda: ks.kbest_multi_stacked(*args, mus, k))
        short = int((want[1] < k).sum())
        print(f"kernel edge kbest_multi_stacked {label} K={Km} k={k}: "
              f"{ms:9.4f} ms  max_abs_err {err}  (lane, μ) rows with "
              f"fewer finite paths than k: {short}", flush=True)
        del store, args


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
        kernel = lambda: ks.dp_multi_stacked(*args, w_e, w_t)  # noqa: E731
        _kernel_row(rows, "dp_multi_stacked", f"[{B},{L},{S}] K={K}",
                    time_ms(kernel),
                    time_ms(lambda: ks.dp_multi_stacked_plain(*args, w_e,
                                                               w_t)),
                    bound, by, err, dev_ms=device_ms(kernel))

        Km = mus.shape[1]
        err = _kbest_err(ks.kbest_multi_stacked(*args, mus, k_best),
                         ks.kbest_multi_stacked_plain(*args, mus, k_best),
                         k_best)
        check(err == 0.0, f"kbest_multi_stacked != plain at [{B},{L},{S}] "
              f"K={Km}: max abs err {err}")
        bound, by = kbest_bound(B, Km, L, S, k_best)
        kernel = lambda: ks.kbest_multi_stacked(  # noqa: E731
            *args, mus, k_best)
        _kernel_row(rows, "kbest_multi_stacked",
                    f"[{B},{L},{S}] K={Km} k={k_best}", time_ms(kernel),
                    time_ms(lambda: ks.kbest_multi_stacked_plain(
                        *args, mus, k_best)),
                    bound, by, err, dev_ms=device_ms(kernel))
        del args, t_trans, e_trans

    # the gather: P paths over a 64-lane store of mobilevit-xxs lanes, as
    # one group (host lanes and paths, as the backend hands them over)
    from repro_torch.core.backend import BucketStack

    store, _ = buckets[KERNEL_SHAPES[0][0]]
    full = BucketStack(store.view().n_layers, store.view().s_pad)
    for i in range(GATHER_STORE):
        full.add(i, store.padded(i % store.n))
    rng = np.random.default_rng(0)
    group = gather_group(full, GATHER_PATHS, rng)
    mirror = device_mirror(full)
    gargs = ([mirror], [group[1]], [group[2]])
    err = _gather_err(ks.path_components_grouped(*gargs),
                      ks.path_components_grouped_plain(*gargs))
    check(err == 0.0, f"path_components != plain: max abs err {err}")
    L = group[2].shape[1]
    bound, by = gather_bound(GATHER_PATHS, L)
    kernel = lambda: ks.path_components_grouped(*gargs)  # noqa: E731
    _kernel_row(rows, "path_components",
                f"P={GATHER_PATHS} L={L} store={GATHER_STORE} lanes",
                time_ms(kernel),
                time_ms(lambda: ks.path_components_grouped_plain(*gargs)),
                bound, by, err, dev_ms=device_ms(kernel))
    print(f"  the kernel alone: device "
          f"{_ms(device_ms(kernel, only='gather'))} (the rest of the device "
          "time is the packet's copy up)", flush=True)
    gather_phase(buckets, full)
    kernel_edge_phase()
    return list(rows.values())


def device_ms(fn, reps: int = 10, only: str | None = None,
              tries: int = 3) -> float | None:
    """The card's busy time per call of ``fn`` (union of its kernel and
    copy intervals under ``torch.profiler``, over ``reps`` calls): the
    kernel's own time where the host's launch cost sets ``time_ms``;
    with ``only``, the time of the device operations whose name holds
    ``only`` alone.  The profiler can drop whole launches
    (``profiler_check``): a window in which some operation was recorded
    a number of times that is not a multiple of ``reps`` is measured
    again, up to ``tries`` windows.  None when no window was whole or
    the profiler recorded no device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        found = device_busy(prof)
        if found is None:
            return None
        if all(n % reps == 0 for _, (n, _) in found[1]):
            break
    else:
        return None
    if only is None:
        return found[0] / reps / 1e3
    return sum(us for name, (_, us) in found[1] if only in name) / reps / 1e3


def profiler_check(label: str, reps: int = 10) -> None:
    """torch.profiler against CUDA events on one spin kernel of a fixed
    cycle count (``torch.cuda._sleep``, ~1 ms): how many of ``reps``
    launches the profiler recorded, and the factor by which its device
    time (``device_ms``) reads at this point of the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def spin():
        torch.cuda._sleep(2_000_000)

    ev = time_ms_b2b(spin, reps)
    spin()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            spin()
        torch.cuda.synchronize()
    found = device_busy(prof)
    if found is None:
        print(f"profiler check ({label}): no device events recorded",
              flush=True)
        return
    busy, by_name = found
    seen = sum(n for _, (n, _) in by_name)
    mean = sum(us for _, (_, us) in by_name) / seen / 1e3
    print(f"profiler check ({label}): a spin kernel takes {ev:.4f} ms by "
          f"CUDA events (back-to-back); torch.profiler recorded {seen} of "
          f"{reps} launches of {mean:.5f} ms on average, a busy time of "
          f"{busy / reps / 1e3:.5f} ms a call (ratio "
          f"{busy / reps / 1e3 / ev:.4f})", flush=True)


def _kernel_row(rows, name, shape, ms, plain_ms, bound_ms, bound_by,
                err, library_ms=None, dev_ms=None) -> None:
    lib = "" if library_ms is None else f"  library {library_ms:9.4f} ms"
    dev = "" if dev_ms is None else f"  device {dev_ms:9.5f} ms"
    print(f"kernel {name:20s} {shape:28s} {ms:9.4f} ms  plain "
          f"{plain_ms:9.4f} ms  bound {bound_ms:9.5f} ms ({bound_by})"
          f"{lib}{dev}  max_abs_err {err}", flush=True)
    # the JSON line carries the first shape of each kernel (the widest,
    # or for attention the serving shape); every shape is printed above
    rows.setdefault(name, {
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": 0, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms, "shape": shape,
        "device_ms": dev_ms})


# ---------------------------------------------------- attention kernels

# (b, h, kh, sq, sk, d, causal, dtype): tinyllama-1.1b's serving shape
# (GQA 32 over 4 heads, D = 64) in bf16 and float32, a ragged prefill,
# then the sweep of tests/test_kernels.py (Sq < Sk with q_offset in the
# second); then the bf16 tensor-core kernel's edges: every other head
# dim, non-causal, Sq < Sk with q_offset, Sq = Sk = 1000 (no multiple of
# a tile), GQA group 1, and Sq > Sk (negative q_offset: rows that see no
# key give zeros); then the float32 kernel's: the serve parity run's
# prefill (4 prompts of 200 tokens), every head dim the rows above give
# no float32 row (48 and 80-128; above 64 one CTA an SM, and D % 32 !=
# 0 reads V by float2), Sq = Sk = 1000, Sq < Sk causal and non-causal,
# GQA group 1, and Sq > Sk at D = 64 and 128
ATTENTION_SHAPES = (
    (16, 32, 4, 1024, 1024, 64, True, "bfloat16"),
    (16, 32, 4, 1024, 1024, 64, True, "float32"),
    (1, 32, 4, 13, 13, 64, True, "bfloat16"),
    (2, 4, 4, 128, 128, 64, True, "float32"),
    (1, 8, 2, 64, 128, 32, True, "float32"),
    (2, 4, 1, 128, 256, 32, False, "float32"),
    (1, 2, 2, 256, 256, 128, True, "bfloat16"),
    (1, 4, 2, 64, 64, 16, True, "float32"),
    (2, 8, 2, 256, 256, 16, True, "bfloat16"),
    (2, 8, 4, 300, 300, 32, True, "bfloat16"),
    (2, 4, 2, 200, 333, 48, False, "bfloat16"),
    (1, 4, 2, 130, 130, 80, True, "bfloat16"),
    (1, 4, 4, 200, 200, 96, False, "bfloat16"),
    (1, 8, 2, 257, 257, 112, True, "bfloat16"),
    (2, 8, 8, 512, 512, 128, True, "bfloat16"),
    (2, 8, 2, 300, 1000, 64, True, "bfloat16"),
    (2, 16, 4, 1000, 1000, 64, True, "bfloat16"),
    (2, 16, 4, 1000, 1000, 64, False, "bfloat16"),
    (1, 4, 2, 100, 60, 64, True, "bfloat16"),
    (4, 32, 4, 200, 200, 64, True, "float32"),
    (2, 4, 2, 200, 333, 48, False, "float32"),
    (1, 4, 2, 130, 130, 80, True, "float32"),
    (1, 4, 4, 200, 200, 96, False, "float32"),
    (1, 8, 2, 257, 257, 112, True, "float32"),
    (2, 8, 8, 512, 512, 128, True, "float32"),
    (2, 8, 2, 300, 1000, 64, True, "float32"),
    (2, 16, 4, 1000, 1000, 64, True, "float32"),
    (2, 16, 4, 1000, 1000, 64, False, "float32"),
    (1, 4, 2, 100, 60, 64, True, "float32"),
    (1, 8, 2, 300, 170, 128, True, "float32"),
)
# the rows whose back-to-back time is printed too: the serving shapes
SERVING_ROWS = 2
# (b, s, kh, h, d, dtype, zero_last): tinyllama-1.1b decoding at batch
# 16 over a 2048-token cache, the launcher's cache (B = 4, S = 96), then
# the sweep of tests/test_kernels.py; then the split kernel's edges: B =
# 1 with KH = 1, S on no chunk boundary, G = 1, G = 16 (two head groups)
# and G = 12; lengths drawn from [1, S], the first sequence's cache
# full, the last one's empty where zero_last (its output must be zeros)
DECODE_SHAPES = (
    (16, 2048, 4, 32, 64, "bfloat16", False),
    (16, 2048, 4, 32, 64, "float32", False),
    (4, 96, 4, 32, 64, "bfloat16", False),
    (2, 256, 4, 4, 64, "float32", False),
    (3, 128, 2, 8, 32, "float32", False),
    (1, 512, 1, 4, 128, "bfloat16", False),
    (1, 2048, 1, 8, 64, "bfloat16", False),
    (3, 1001, 2, 8, 128, "bfloat16", True),
    (3, 777, 8, 8, 64, "bfloat16", True),
    (2, 1500, 2, 32, 64, "bfloat16", True),
    (3, 300, 1, 12, 48, "float32", True),
)
ATTN_TOL = {"float32": 3e-5, "bfloat16": 2e-2}


def _dtype(name: str):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _bound_typed(nbytes: int, ops: int, dtype: str
                 ) -> tuple[float, str, int, int]:
    """(bound ms, what bounds it, bytes, operations)."""
    peak = BF16_OPS_PER_S if dtype == "bfloat16" else FP32_OPS_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", nbytes, ops
    return t_ops, "operations", nbytes, ops


def attention_bound(b, h, kh, sq, sk, d, causal, q_offset, dtype
                    ) -> tuple[float, str, int, int]:
    """q, k, v read once and the output written once; 4·D operations
    (two multiply-adds, QK and PV) per (query, key) pair the mask
    keeps."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * h * sq * d + 2 * b * kh * sk * d) * elt
    if causal:
        pairs = sum(min(sk, max(0, q_offset + i + 1)) for i in range(sq))
    else:
        pairs = sq * sk
    return _bound_typed(nbytes, 4 * d * b * h * pairs, dtype)


def decode_bound(h, kh, d, lengths, dtype
                 ) -> tuple[float, str, int, int]:
    """q read and out written once, the valid K/V rows read once (the
    kernel reads nothing past ``length``), the lengths; 4·D operations
    per (query head, valid position)."""
    elt = 2 if dtype == "bfloat16" else 4
    b = len(lengths)
    valid = sum(lengths)
    nbytes = 2 * b * h * d * elt + 2 * valid * kh * d * elt + 4 * b
    return _bound_typed(nbytes, 4 * d * h * valid, dtype)


def attention_phase() -> list[dict]:
    """The two attention kernels against their plain versions and the
    library yardstick, at ATTENTION_SHAPES and DECODE_SHAPES."""
    import torch

    rows: dict[str, dict] = {}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    f32_plan_check()
    prefill_rows(rows, gen)
    decode_rows(rows, gen)
    return list(rows.values())


def _attn_label(b, h, kh, sq, sk, d, causal, dtype) -> str:
    return (f"[{b},{h},{sq},{d}]x[{kh},{sk}] "
            f"{'causal' if causal else 'full'} {dtype}")


def _randn(gen, *shape, dtype):
    import torch

    return torch.randn(shape, generator=gen, device=DEVICE,
                       dtype=torch.float32).to(_dtype(dtype))


def prefill_rows(rows: dict, gen) -> dict[str, dict]:
    """``flash_attention`` at ATTENTION_SHAPES against its plain version
    (3e-5 in float32, 2e-2 in bf16; rows that see no key give zeros),
    with its times beside its bound and SDPA's; returns each row's
    numbers by label."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    def randn(*shape, dtype):
        return _randn(gen, *shape, dtype=dtype)

    found = {}
    for n, (b, h, kh, sq, sk, d, causal, dtype) in enumerate(
            ATTENTION_SHAPES):
        q = randn(b, h, sq, d, dtype=dtype)
        k = randn(b, kh, sk, d, dtype=dtype)
        v = randn(b, kh, sk, d, dtype=dtype)
        q_offset = sk - sq if causal else 0
        args = dict(causal=causal, q_offset=q_offset)
        got = fa.flash_attention(q, k, v, **args)
        want = fa.flash_attention_plain(q, k, v, **args)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        label = _attn_label(b, h, kh, sq, sk, d, causal, dtype)
        check(err <= ATTN_TOL[dtype], f"flash_attention != plain at "
              f"{label}: max abs err {err}")
        mask = None
        if causal and sq != sk:
            qpos = q_offset + torch.arange(sq, device=DEVICE)
            mask = qpos[:, None] >= torch.arange(sk, device=DEVICE)[None]

        def library():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)

        if q_offset < 0:
            check(bool((got[:, :, :-q_offset] == 0).all()),
                  f"flash_attention at {label}: rows that see no key are "
                  "not zero")
        lib_err = _max_abs_err(library(), want)
        bound, by, nbytes, ops = attention_bound(b, h, kh, sq, sk, d,
                                                 causal, q_offset, dtype)
        kernel = lambda: fa.flash_attention(q, k, v, **args)  # noqa: E731
        got_row = dict(ms=time_ms(kernel), dev_ms=device_ms(kernel),
                       lib_ms=time_ms(library), bound=bound, by=by,
                       b2b=time_ms_b2b(kernel) if n < SERVING_ROWS
                       else None)
        found[label] = got_row
        _kernel_row(rows, "flash_attention", label, got_row["ms"],
                    time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                             **args)),
                    bound, by, err, got_row["lib_ms"], got_row["dev_ms"])
        b2b = ("" if got_row["b2b"] is None
               else f"  back-to-back {got_row['b2b']:.4f} ms")
        print(f"  bytes {nbytes}  operations {ops}  library max abs err "
              f"vs plain {lib_err}{b2b}", flush=True)
        del q, k, v, got, want
    return found


def decode_rows(rows: dict, gen) -> None:
    """``flash_decode`` at DECODE_SHAPES against its plain version, with
    its times beside its bound and SDPA's."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd

    def randn(*shape, dtype):
        return _randn(gen, *shape, dtype=dtype)

    lrng = np.random.default_rng(0)
    for b, s, kh, h, d, dtype, zero_last in DECODE_SHAPES:
        q = randn(b, h, d, dtype=dtype)
        k = randn(b, s, kh, d, dtype=dtype)
        v = randn(b, s, kh, d, dtype=dtype)
        lens_np = lrng.integers(1, s + 1, size=b).astype(np.int32)
        lens_np[0] = s                      # one full cache
        if zero_last:
            lens_np[-1] = 0
        lens = torch.from_numpy(lens_np).to(DEVICE)
        got = fd.flash_decode(q, k, v, lens)
        want = fd.flash_decode_plain(q, k, v, lens)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        n_split = fd.decode_splits(
            s, torch.cuda.get_device_properties(0).multi_processor_count)
        label = (f"B={b} S={s} {h}/{kh} heads D={d} {dtype} "
                 f"splits={n_split}")
        check(err <= ATTN_TOL[dtype], f"flash_decode != plain at {label}: "
              f"max abs err {err}")
        if zero_last:
            check(bool((got[-1] == 0).all()), f"flash_decode at {label}: a "
                  "length of 0 does not give zeros")
        qs = q[:, :, None, :]
        ks, vs = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        mask = (torch.arange(s, device=DEVICE)[None, :]
                < lens[:, None])[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)[:, :, 0]

        lib_err = _max_abs_err(library(), want)
        bound, by, nbytes, ops = decode_bound(
            h, kh, d, [int(x) for x in lens_np], dtype)
        kernel = lambda: fd.flash_decode(q, k, v, lens)  # noqa: E731
        _kernel_row(rows, "flash_decode", label, time_ms(kernel),
                    time_ms(lambda: fd.flash_decode_plain(q, k, v, lens)),
                    bound, by, err, time_ms(library), device_ms(kernel))
        print(f"  bytes {nbytes}  operations {ops}  library max abs err "
              f"vs plain {lib_err}", flush=True)
        del q, k, v, got, want


def f32_plan_check() -> None:
    """The float32 kernel's tiling as the library reports it on this
    card (``pfdnn_flash_attention_f32_plan``: CTAs an SM holds from the
    occupancy calculator) against ``flash_attention.f32_plan``, for
    every head dim.  Skipped for a tree whose library has no plan."""
    import ctypes

    from repro_torch.kernels import flash_attention as fa

    lib = fa.LIBRARY.load()
    if not hasattr(fa, "f32_plan") or not hasattr(
            lib, "pfdnn_flash_attention_f32_plan"):
        print("f32 plan: this tree's float32 kernel reports no plan",
              flush=True)
        return
    keys = ("block_rows", "block_keys", "threads", "rows_per_lane",
            "smem_bytes")
    for d in fa.HEAD_DIMS:
        out = (ctypes.c_int * 6)()
        err = lib.pfdnn_flash_attention_f32_plan(d, out)
        check(err == 0, f"pfdnn_flash_attention_f32_plan({d}) failed "
              f"(cudaError {err})")
        got = dict(zip(keys, out[:5]))
        check(got == fa.f32_plan(d), f"float32 attention plan at D = {d}: "
              f"library {got} != f32_plan {fa.f32_plan(d)}")
        print(f"f32 plan D={d}: {json.dumps(got)}  CTAs an SM {out[5]}",
              flush=True)


def ptxas_usage(lib) -> str:
    """Registers and spills of each kernel of ``lib``'s source, as
    ``ptxas -v`` prints them for a cubin built with the library's own
    flags (one line a kernel)."""
    import re

    from repro_torch.kernels._nvcc import BUILD_DIR, nvcc

    flags = [f for f in lib.flags
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f".ptxas_{lib.source.stem}_{id(lib)}.cubin"
    proc = subprocess.run([nvcc(), *flags, "-cubin", "-Xptxas", "-v",
                           "-o", str(out), str(lib.source)],
                          capture_output=True, text=True)
    out.unlink(missing_ok=True)
    if proc.returncode != 0:
        return f"ptxas: {lib.source.name}: the build failed\n{proc.stderr}"
    lines, name, spill = [], "", ""
    for line in (proc.stdout + proc.stderr).splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            name = entry.group(1)
        props = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        if props:
            spill = (f"stack {props.group(1)} B, spill stores "
                     f"{props.group(2)} B, spill loads {props.group(3)} B")
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            d = re.search(r"ILi(\d+)E", name)
            label = f"{name[:48]}..." if d is None else f"D={d.group(1)}"
            lines.append(f"ptxas: {lib.source.name} {label}: {regs.group(1)} "
                         f"registers, {spill}")
            name, spill = "", ""
    return "\n".join(lines)


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
    from repro_torch.core.backend import get_backend
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

    io = get_backend(DEVICE).io_stats
    io_before = dict(io)
    ks.reset_launch_counts()
    per_job = []
    for net, frac, n_rails in jobs:
        before = dict(ks.LAUNCHES)
        passes = io["gather_calls"]
        tic = time.perf_counter()
        sched = compile(edge_network(net),
                        MinEnergy(rate_hz=frac * max_rate(net)),
                        cfg=OrchestratorConfig(n_max_rails=n_rails,
                                               device=DEVICE),
                        network=net)
        wall = time.perf_counter() - tic
        launches = {k: ks.LAUNCHES[k] - before[k] for k in ks.LAUNCHES}
        launches["gather passes"] = io["gather_calls"] - passes
        per_job.append((net, frac, n_rails, sched, wall, launches))
    counts = dict(ks.LAUNCHES)
    print(f"path launches: {json.dumps(counts)}", flush=True)
    for name, n in counts.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    passes = io["gather_calls"] - io_before["gather_calls"]
    groups = io["gather_groups"] - io_before["gather_groups"]
    print(f"path gather: {passes} evaluation passes with fresh paths, "
          f"{counts['path_components']} path_components launches "
          f"({counts['path_components'] / passes:.3f} a pass), {groups} "
          "groups (one launch each in the per-bucket design)", flush=True)
    check(counts["path_components"] <= passes,
          "path_components launched more than once in an evaluation pass")

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


def device_busy(prof) -> tuple[float, list] | None:
    """The card's busy time in a profile (union of its kernel and copy
    intervals, µs) and the device time by operation, largest first;
    None when the profiler recorded no device events."""
    import torch

    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        return None
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
    return busy, sorted(by_name.items(), key=lambda kv: -kv[1][1])


def _print_busy(label: str, prof, wall_us: float) -> None:
    found = device_busy(prof)
    if found is None:
        print(f"{label}: device time not measured (the profiler "
              "recorded no device events)", flush=True)
        return
    busy, by_name = found
    print(f"{label}: wall {wall_us / 1e3:.3f} ms (profiled)  device "
          f"busy {busy / 1e3:.3f} ms  idle share "
          f"{1.0 - busy / wall_us:.4f}", flush=True)
    for name, (n, us) in by_name[:8]:
        print(f"  device {n:6d} x {us / 1e3:10.3f} ms  {name[:90]}",
              flush=True)
    # every copy, however small its share
    for name, (n, us) in by_name:
        if name.startswith("Memcpy"):
            print(f"  copies {n:6d} x {us / 1e3:10.3f} ms  {name[:90]}",
                  flush=True)


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
    _print_busy(f"profile {net}", prof, wall_us)


# -------------------------------------------------------- serve phase

ARCH = "tinyllama-1.1b"
CLI_ARGS = ["--arch", ARCH, "--requests", "8", "--max-new", "16",
            "--rate", "30", "--policy", "pfdnn"]
PARITY_PROMPTS, PARITY_LEN, PARITY_STEPS = 4, 200, 8
# kernel vs plain path, max |dlogits| over max |logits|: float32 only
# reorders sums; bf16 also rounds p and every layer's output to bf16
PARITY_LIMIT = {"float32": 1e-3, "bfloat16": 2e-2}
BATCH, BATCH_CACHE, BATCH_NEW = 16, 2048, 32
PROFILED_STEPS = (8, 16)              # decode steps run under the profiler


def _kernel_modules() -> tuple:
    from repro_torch.kernels import (
        dp_sweep,
        flash_attention,
        flash_decode,
        int8_matmul,
    )

    return dp_sweep, flash_attention, flash_decode, int8_matmul


def _reset_counts() -> None:
    for mod in _kernel_modules():
        mod.reset_launch_counts()


def _counts() -> dict:
    return {name: n for mod in _kernel_modules()
            for name, n in mod.LAUNCHES.items()}


def cli_run() -> dict:
    """The entry point as users run it, in-process, with the launch
    counts set to 0 just before and read just after."""
    from repro_torch.launch import serve as launch

    _reset_counts()
    tic = time.perf_counter()
    out = launch.main(list(CLI_ARGS))
    wall = time.perf_counter() - tic
    counts = _counts()
    print(f"serve cli: {' '.join(CLI_ARGS)}: wall {wall:.3f} s  launches "
          f"{json.dumps(counts)}", flush=True)
    done = out["done"]
    check(len(done) == 8 and all(len(r.generated) == 16 and not
                                 r.truncated for r in done),
          "the launcher did not serve 8 requests of 16 tokens")
    for name in ("flash_attention", "flash_decode"):
        check(counts[name] > 0, f"kernel {name} was not launched by the "
              "launcher")
    for name in ("dp_multi_stacked", "kbest_multi_stacked",
                 "path_components"):
        check(counts[name] > 0, f"the launcher's power compile did not "
              f"launch {name} on the card")
    check(out["schedule"] is not None, "no power schedule at 30 Hz")
    check(out["replay"]["deadline_misses"] == 0
          and len(out["replay"]["ledgers"]) == 10,
          "the launcher's 10 replayed periods missed a deadline")
    return counts


@contextlib.contextmanager
def plain_attention(n_split: int | None = None):
    """Route the transformer's attention through the kernels' plain
    versions (on the same card tensors) for the duration; with
    ``n_split``, decode through the two-pass plain version instead."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops

    saved = ops.flash_attention, ops.flash_decode
    ops.flash_attention = fa.flash_attention_plain
    ops.flash_decode = fd.flash_decode_plain
    if n_split is not None:
        def two_pass(q, k, v, length):
            return fd.flash_decode_split_plain(q, k, v, length, n_split)

        ops.flash_decode = two_pass
    try:
        yield
    finally:
        ops.flash_attention, ops.flash_decode = saved


def parity_run(dtype: str) -> None:
    """Kernel path against plain path: the same seeded weights in
    ``dtype``, the same prompts, prefill + PARITY_STEPS decode steps, the
    kernel path's greedy tokens fed to all.  Beside it, and not held to
    the limit, the floor: the plain path against the plain path with the
    two-pass plain decode at the kernel's split count, which differ only
    in where p is rounded."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.transformer import (
        decode_step,
        init_params,
        prefill,
    )

    cfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
    limit = PARITY_LIMIT[dtype]
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                         DEVICE)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (PARITY_PROMPTS, PARITY_LEN))).to(DEVICE)
    cache = PARITY_LEN + PARITY_STEPS
    n_split = fd.decode_splits(
        cache, torch.cuda.get_device_properties(0).multi_processor_count)
    tic = time.perf_counter()
    prefill(params, cfg, {"tokens": toks}, cache)     # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    tic_prefill = time.perf_counter()
    lk, sk = prefill(params, cfg, {"tokens": toks}, cache)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - tic_prefill) * 1e3
    prefill_counts = _counts()
    tic_prefill = time.perf_counter()
    with plain_attention():
        lp, sp = prefill(params, cfg, {"tokens": toks}, cache)
    torch.cuda.synchronize()
    plain_prefill_ms = (time.perf_counter() - tic_prefill) * 1e3
    with plain_attention(n_split):
        lf, sf = prefill(params, cfg, {"tokens": toks}, cache)
    worst, floor, same, total = 0.0, 0.0, 0, 0
    for step in range(PARITY_STEPS + 1):
        diff = float((lk - lp).abs().max())
        scale = float(lk.abs().max())
        worst = max(worst, diff / scale)
        floor = max(floor, float((lf - lp).abs().max()) / scale)
        check(diff <= limit * scale, f"kernel vs plain logits ({dtype}) at "
              f"step {step}: max |diff| {diff} > {limit} x {scale}")
        tk, tp = lk.argmax(-1), lp.argmax(-1)
        same += int((tk == tp).sum())
        total += tk.numel()
        if step == PARITY_STEPS:
            break
        lk, sk = decode_step(params, cfg, sk, tk)
        with plain_attention():
            lp, sp = decode_step(params, cfg, sp, tk)
        with plain_attention(n_split):
            lf, sf = decode_step(params, cfg, sf, tk)
    torch.cuda.synchronize()
    print(f"serve parity: {ARCH} {dtype}, {PARITY_PROMPTS} prompts of "
          f"{PARITY_LEN} tokens, prefill + {PARITY_STEPS} decode steps: "
          f"max |dlogits| / max |logits| {worst!r} (limit {limit}); "
          f"floor (plain vs two-pass plain decode, {n_split} splits) "
          f"{floor!r}; identical greedy tokens {same}/{total}; wall "
          f"{time.perf_counter() - tic:.3f} s; kernel-path prefill "
          f"launched flash_attention {prefill_counts['flash_attention']} "
          f"times; prefill {prefill_ms:.3f} ms on the kernel path, "
          f"{plain_prefill_ms:.3f} ms on the plain path (host clock, "
          "synchronized, after one warm-up prefill)", flush=True)


def batch_run() -> None:
    """Serving at a real batch: BATCH requests of 512-1024 prompt
    tokens, BATCH_NEW new tokens each, bf16, through ServingEngine."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serve import EngineConfig, ServingEngine

    cfg = get_config(ARCH)
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                         DEVICE)
    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch=BATCH, cache_len=BATCH_CACHE, max_new_tokens=BATCH_NEW,
        eos_token=-1))
    rng = np.random.default_rng(0)
    lengths = rng.integers(512, 1025, size=BATCH)
    for n in lengths:
        engine.submit(list(rng.integers(1, cfg.vocab_size, int(n))))
    prefill_walls = []
    inner = engine._prefill_batch

    def timed_prefill(requests):
        torch.cuda.synchronize()
        tic = time.perf_counter()
        inner(requests)
        torch.cuda.synchronize()
        prefill_walls.append(time.perf_counter() - tic)

    engine._prefill_batch = timed_prefill
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    steps, prof, prof_tic, prof_wall = [], None, 0.0, 0.0
    tic_all = time.perf_counter()
    while engine.queue or engine.active:
        i = len(steps)
        torch.cuda.synchronize()
        if i == PROFILED_STEPS[0]:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            prof_tic = time.perf_counter()
        # this step decodes unless every live request emits its last
        # token in it
        decodes = any(len(r.generated) < BATCH_NEW - 1
                      for r in engine.active.values())
        tic = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - tic, decodes))
        if i + 1 == PROFILED_STEPS[1]:
            prof_wall = time.perf_counter() - prof_tic
            prof.__exit__(None, None, None)
    total = time.perf_counter() - tic_all
    counts = _counts()
    padded = BATCH * int(lengths.max())
    decode_walls = [w for j, (w, dec) in enumerate(steps)
                    if dec and not PROFILED_STEPS[0] <= j < PROFILED_STEPS[1]]
    med = statistics.median(decode_walls)
    print(f"serve batch: {ARCH} bf16, {BATCH} requests, prompts "
          f"{int(lengths.min())}-{int(lengths.max())} tokens "
          f"({int(lengths.sum())} real, {padded} padded), cache "
          f"{BATCH_CACHE}, {BATCH_NEW} new tokens; {len(steps)} engine "
          f"steps in {total:.3f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print(f"  prefill wall {prefill_walls[0] * 1e3:.3f} ms: "
          f"{padded / prefill_walls[0]:.1f} padded tokens/s "
          f"({int(lengths.sum()) / prefill_walls[0]:.1f} real)", flush=True)
    print(f"  decode step (emit + decode_step + logits to host) median "
          f"{med * 1e3:.3f} ms over {len(decode_walls)} unprofiled steps "
          f"(min {min(decode_walls) * 1e3:.3f}, max "
          f"{max(decode_walls) * 1e3:.3f}): {BATCH / med:.1f} decode "
          f"tokens/s", flush=True)
    print(f"  launches {json.dumps(counts)}", flush=True)
    check(counts["flash_attention"] == cfg.n_layers
          and counts["flash_decode"] == cfg.n_layers * (BATCH_NEW - 1),
          f"batch serve launches {counts}")
    label = (f"  profile decode steps {PROFILED_STEPS[0]}-"
             f"{PROFILED_STEPS[1] - 1}")
    _print_busy(label, prof, prof_wall * 1e6)
    found = device_busy(prof)
    if found is not None:
        n_steps = PROFILED_STEPS[1] - PROFILED_STEPS[0]
        n_ops = sum(n for _, (n, _) in found[1])
        print(f"{label}: {n_ops / n_steps:.1f} device operations "
              f"(kernels and copies) a step, {found[0] / n_steps / 1e3:.3f} "
              f"ms device busy a step, {prof_wall / n_steps * 1e3:.3f} ms "
              "wall a step", flush=True)


def serve_phase() -> dict:
    tic = time.perf_counter()
    counts = cli_run()
    print(f"phase serve cli: {time.perf_counter() - tic:.3f} s", flush=True)
    tic = time.perf_counter()
    for dtype in PARITY_LIMIT:
        parity_run(dtype)
    print(f"phase serve parity: {time.perf_counter() - tic:.3f} s",
          flush=True)
    tic = time.perf_counter()
    batch_run()
    print(f"phase serve batch: {time.perf_counter() - tic:.3f} s",
          flush=True)
    return counts


# ------------------------------------------------------- int8 phase

# (M, K, N): tinyllama-1.1b's projections (q/o 2048 -> 2048, k/v 2048 ->
# 256 = 4 KV heads x 64, gate/up 2048 -> 5632, down 5632 -> 2048) at a
# 16 x 1024-token prefill and at a decode batch of 16, the four shapes
# of tests/test_kernels.py, and a ragged shape (no dim tiles, K % 4 != 0)
LM_WIDTHS = ((2048, 2048), (2048, 256), (2048, 5632), (5632, 2048))
INT8_SHAPES = (tuple((16384, k, n) for k, n in LM_WIDTHS)
               + tuple((16, k, n) for k, n in LM_WIDTHS)
               + ((128, 128, 128), (256, 512, 128), (64, 64, 192),
                  (32, 96, 32), (13, 70, 33)))
INT8_LINEAR_SHAPES = INT8_SHAPES[:8]
INT8_LINEAR_TOL = 0.05      # tests/test_kernels.py's quantization budget


def int8_bound(m: int, k: int, n: int) -> tuple[float, str]:
    """x, w and both scales read once, the float32 output written once;
    2·M·N·K operations over the dense int8 tensor-core rate."""
    nbytes = m * k + k * n + 4 * m + 4 * n + 4 * m * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * m * n * k / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def clocks() -> str:
    """The card's SM clock (now and max), power draw and temperature."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"], capture_output=True,
        text=True, check=True).stdout.strip()


def int8_phase() -> list[dict]:
    """The int8 kernels against their plain version (bit for bit), w
    row-major and K-major, with the route each took, and the library
    yardstick at INT8_SHAPES; at M = 16384 the mma.sync route beside the
    wgmma route, and what sets the CUDA-event time against the device
    time (back-to-back calls, the output allocation, clocks)."""
    import torch

    from repro_torch.kernels import int8_matmul as im

    rows: dict[str, dict] = {}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    routes_before = dict(im.ROUTE_LAUNCHES)
    print(f"int8 clocks before (sm, max sm, power, temperature): "
          f"{clocks()}", flush=True)
    profiler_check("int8 phase")
    for m, k, n in INT8_SHAPES:
        x = torch.randint(-128, 128, (m, k), generator=gen, device=DEVICE,
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (k, n), generator=gen, device=DEVICE,
                          dtype=torch.int8)
        # the same w K-major (as int8_linear hands it over)
        wk = w.t().contiguous().t()
        xs = torch.rand(m, generator=gen, device=DEVICE) * 1.5 + 0.5
        ws = torch.rand(n, generator=gen, device=DEVICE) * 1.5 + 0.5
        want = im.int8_matmul_plain(x, w, xs, ws)
        label = f"M={m} K={k} N={n}"
        routes = {}
        for layout, ww in (("row-major", w), ("K-major", wk)):
            routes[layout] = im.int8_route(m, n, k, tuple(ww.stride()))
            got = im.int8_matmul(x, ww, xs, ws)
            torch.cuda.synchronize()
            err = _max_abs_err(got, want)
            check(err == 0.0 and torch.equal(got.view(torch.int32),
                                              want.view(torch.int32)),
                  f"int8_matmul (w {layout}, {routes[layout]}) != plain at "
                  f"{label}: max abs err {err}")
            del got
        lib_ms, lib_note = None, "none"
        # torch._int_mm takes M > 16 and K, N multiples of 8
        if m > 16 and k % 8 == 0 and n % 8 == 0:
            def library():
                acc = torch._int_mm(x, w)
                return acc.float() * (xs[:, None] * ws[None, :])

            lib_note = f"max abs err vs plain {_max_abs_err(library(), want)}"
            lib_ms = time_ms(library)
        bound, by = int8_bound(m, k, n)
        kernel = lambda: im.int8_matmul(x, wk, xs, ws)  # noqa: E731
        row_major = lambda: im.int8_matmul(x, w, xs, ws)  # noqa: E731
        _kernel_row(rows, "int8_matmul", f"{label} {routes['K-major']}",
                    time_ms(kernel),
                    time_ms(lambda: im.int8_matmul_plain(x, w, xs, ws)),
                    bound, by, err, lib_ms, device_ms(kernel))
        print(f"  w row-major -> {routes['row-major']}: "
              f"{time_ms(row_major):9.4f} ms  device "
              f"{_ms(device_ms(row_major))}", flush=True)
        print(f"  library (torch._int_mm + epilogue): {lib_note}",
              flush=True)
        if m == 16384:
            mma = lambda: im.int8_matmul_mma(x, w, xs, ws)  # noqa: E731
            got = mma()
            torch.cuda.synchronize()
            check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
                  f"int8_matmul_mma != plain at {label}")
            del got
            print(f"  mma_sync route (w row-major): {time_ms(mma):9.4f} ms  "
                  f"device {_ms(device_ms(mma))}  back-to-back "
                  f"{time_ms_b2b(mma):9.4f} ms a call", flush=True)
            print(f"  wgmma route (w K-major): back-to-back "
                  f"{time_ms_b2b(kernel):9.4f} ms a call; the output's "
                  f"torch.empty alone {time_ms(lambda: torch.empty((m, n), device=DEVICE)):9.4f} ms",
                  flush=True)
        if (m, k, n) in INT8_LINEAR_SHAPES:
            # the int32 product alone, no epilogue; _int_mm takes M > 16,
            # so a 16-row x is zero-padded to 32 rows
            xp = x
            if m <= 16:
                xp = torch.zeros((32, k), dtype=torch.int8, device=DEVICE)
                xp[:m] = x
            print(f"  torch._int_mm alone (x {tuple(xp.shape)}"
                  f"{', rows zero-padded' if xp is not x else ''}): "
                  f"{time_ms(lambda: torch._int_mm(xp, w)):.4f} ms",
                  flush=True)
        del x, w, wk, want
    print(f"int8 clocks after: {clocks()}", flush=True)
    print(f"int8 route launches in the kernel phase: " + json.dumps(
        {r: im.ROUTE_LAUNCHES[r] - routes_before[r]
         for r in im.ROUTE_LAUNCHES}), flush=True)
    return list(rows.values())


def int8_path_phase() -> dict:
    """The int8 entry point as users call it: ``int8_linear`` on bf16
    activations and weights at tinyllama-1.1b's widths, with the launch
    counts set to 0 just before and read just after."""
    import torch

    from repro_torch.kernels import int8_linear
    from repro_torch.kernels import int8_matmul as im

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    _reset_counts()
    for m, k, n in INT8_LINEAR_SHAPES:
        x = torch.randn((m, k), generator=gen, device=DEVICE
                        ).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=DEVICE)
             * k ** -0.5).to(torch.bfloat16)
        tic = time.perf_counter()
        out = int8_linear(x, w)
        torch.cuda.synchronize()
        wall = time.perf_counter() - tic
        ref = x.float() @ w.float()
        rel = float((out - ref).abs().max() / ref.abs().max())
        check(out.shape == (m, n) and out.dtype == torch.float32
              and bool(torch.isfinite(out).all()),
              f"int8_linear at M={m} K={k} N={n}: bad output")
        check(rel < INT8_LINEAR_TOL, f"int8_linear at M={m} K={k} N={n}: "
              f"rel err {rel} >= {INT8_LINEAR_TOL}")
        print(f"int8_linear M={m} K={k} N={n} bf16: rel err vs x @ w "
              f"(float32) {rel!r}  wall {wall * 1e3:.3f} ms", flush=True)
        del x, w, out, ref
    counts = _counts()
    routes = dict(im.ROUTE_LAUNCHES)
    print(f"int8 path launches: {json.dumps(counts)}; by route "
          f"{json.dumps(routes)}", flush=True)
    check(counts["int8_matmul"] == len(INT8_LINEAR_SHAPES),
          f"int8_linear launched int8_matmul {counts['int8_matmul']} "
          f"times, expected {len(INT8_LINEAR_SHAPES)}")
    # M = 16384 on wgmma, M = 16 on mma.sync, and w's codes K-major (no
    # transpose pass)
    want = {"wgmma": sum(m > 64 for m, _, _ in INT8_LINEAR_SHAPES),
            "mma_sync": sum(m <= 64 for m, _, _ in INT8_LINEAR_SHAPES),
            "w_transpose": 0}
    check(routes == want, f"int8_linear routes {routes}, expected {want}")
    return counts


# ----------------------------------------------------- policy phase

POLICY_CASE = "squeezenet1.1|0.5|3"       # every policy vs the CPU
DP_KERNELS = ("dp_multi_stacked", "kbest_multi_stacked", "path_components")
# must launch the DP kernels on the card
DEVICE_POLICIES = ("pfdnn", "pfdnn_even", "pfdnn_nopp", "ilp")


def _policy_free_json(result) -> str:
    """``to_json`` of a schedule without its host stats, or of an
    InfeasibleGoal as it is."""
    if not hasattr(result, "solver_stats"):
        return result.to_json()
    stats = {k: v for k, v in result.solver_stats.items()
             if k not in ("wall_time_s", "backend", "ilp_wall_time_s")}
    return dataclasses.replace(result, solver_stats=stats).to_json()


def _compile_counted(specs, goal, cfg, net):
    """One compile with its wall and the DP-kernel launches it made."""
    from repro_torch.core import compile

    before = _counts()
    tic = time.perf_counter()
    out = compile(specs, goal, cfg=cfg, network=net)
    wall = time.perf_counter() - tic
    after = _counts()
    return out, wall, sum(after[k] - before[k] for k in DP_KERNELS)


def policy_phase() -> None:
    """Every golden schedule compiled on the card (all eight policies),
    one case's schedules and the MinLatency / ParetoFront goals against
    the CPU, with walls and DP launches (counts set to 0 at the start)."""
    from repro_torch.core import (
        MinEnergy,
        MinLatency,
        OrchestratorConfig,
        ParetoFront,
        ParetoFrontier,
        PowerSchedule,
        compile,
    )
    from repro_torch.models.edge_cnn import edge_network

    golden = json.loads((ROOT / "tests" / "golden" / "pipeline.json")
                        .read_text())
    _reset_counts()
    per_policy: dict[str, int] = {}
    case_scheds = {}
    for key, g in golden.items():
        net, frac, n_rails, policy = key.split("|")
        cfg = OrchestratorConfig(policy=policy, n_max_rails=int(n_rails),
                                 device=DEVICE)
        sched, wall, dp = _compile_counted(
            edge_network(net), MinEnergy(rate_hz=float(frac) * max_rate(net)),
            cfg, net)
        per_policy[policy] = per_policy.get(policy, 0) + dp
        check(isinstance(sched, PowerSchedule), f"{key}: no schedule")
        check(abs(sched.e_total - g["e_total"]) <= 1e-9 * abs(g["e_total"])
              and abs(sched.t_infer - g["t_infer"])
              <= 1e-9 * abs(g["t_infer"])
              and list(sched.rails) == g["rails"]
              and [list(v) for v in sched.layer_voltages]
              == g["layer_voltages"], f"golden {key} not reproduced")
        print(f"policy {key:38s} golden reproduced  wall {wall:8.3f} s  "
              f"DP launches {dp}", flush=True)
        if key.rsplit("|", 1)[0] == POLICY_CASE:
            case_scheds[policy] = sched
    for policy, sched in case_scheds.items():
        net, frac, n_rails = POLICY_CASE.split("|")
        cfg = OrchestratorConfig(policy=policy, n_max_rails=int(n_rails),
                                 device="cpu")
        cpu = compile(edge_network(net),
                      MinEnergy(rate_hz=float(frac) * max_rate(net)),
                      cfg=cfg, network=net)
        check(_policy_free_json(cpu) == _policy_free_json(sched),
              f"{POLICY_CASE}|{policy}: card schedule differs from the CPU's")
    print(f"policy {POLICY_CASE}: all {len(case_scheds)} policies identical "
          "to the CPU compile", flush=True)

    net = "squeezenet1.1"
    pf = case_scheds["pfdnn"]
    budget = (pf.e_op + pf.e_trans) * 1.25
    goals = {"MinLatency": MinLatency(energy_budget_j=budget),
             "ParetoFront": ParetoFront(n_points=4)}
    for name, goal in goals.items():
        card, wall, dp = _compile_counted(
            edge_network(net), goal, OrchestratorConfig(device=DEVICE), net)
        cpu = compile(edge_network(net), goal,
                      cfg=OrchestratorConfig(device="cpu"), network=net)
        per_policy[name] = dp
        if name == "ParetoFront":
            check(isinstance(card, ParetoFrontier)
                  and len(card.points) == len(cpu.points)
                  and all(_policy_free_json(a.schedule)
                          == _policy_free_json(b.schedule)
                          for a, b in zip(card.points, cpu.points)),
                  "ParetoFront on the card differs from the CPU's")
            desc = (f"{len(card.feasible_points())}/{len(card.points)} "
                    "points feasible")
        else:
            check(isinstance(card, PowerSchedule)
                  and card.e_op + card.e_trans <= budget
                  and _policy_free_json(card) == _policy_free_json(cpu),
                  "MinLatency on the card differs from the CPU's")
            desc = (f"budget {budget!r} J: T={card.t_infer!r} s "
                    f"rails={card.rails}")
        print(f"goal {name} {net}: {desc}; identical to the CPU compile  "
              f"wall {wall:8.3f} s  DP launches {dp}", flush=True)
    print(f"policy DP launches: {json.dumps(per_policy)}", flush=True)
    for name in DEVICE_POLICIES + tuple(goals):
        check(per_policy.get(name, 0) > 0,
              f"{name} launched no DP kernel on the card")


def sass_count(lib, op: str) -> int:
    """Instructions of ``op`` (e.g. ``HGMMA``, ``IGMMA``: what ``wgmma``
    compiles to for bf16 and int8) in a built library's SASS
    (``cuobjdump -sass``)."""
    from repro_torch.kernels._nvcc import nvcc

    cuobjdump = pathlib.Path(nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib.path())],
                          capture_output=True, text=True, check=True).stdout
    return sum(f"{op}." in line for line in sass.splitlines())


def build_all() -> None:
    """Build every kernel library, one ``nvcc`` per source, all started
    together, then load each; count the tensor-core product
    instructions (``HGMMA`` and ``IGMMA``, what ``wgmma`` compiles to)
    in the bf16 attention and the int8 libraries' SASS."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im

    libs = [m.LIBRARY for m in _kernel_modules()] + [fa.WGMMA_LIBRARY]

    def build(lib):
        tic = time.perf_counter()
        path = lib.build()
        return path.name, time.perf_counter() - tic

    tic = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs) + 1) as pool:
        usage = pool.submit(ptxas_usage, fa.LIBRARY)
        for name, secs in pool.map(build, libs):
            print(f"build: {name} in {secs:.2f} s", flush=True)
        print(usage.result(), flush=True)
    for lib in libs:
        lib.load()
    print(f"build: all in {time.perf_counter() - tic:.2f} s", flush=True)
    for lib, op, what in ((fa.WGMMA_LIBRARY, "HGMMA", "bf16 attention"),
                          (im.LIBRARY, "IGMMA", "int8")):
        n = sass_count(lib, op)
        print(f"sass: {lib.path().name}: {n} {op} instructions", flush=True)
        check(n > 0, f"the {what} library holds no {op}")


def sweep_kernels_only(k_best: int) -> int:
    """``--sweep-kernels``: build the rail-sweep library alone, run the
    kernel phase's rail-sweep rows and edges, profile one mobilevit-xxs
    compile after an unprofiled one, print the rows; no result line."""
    from repro_torch.core import MinEnergy, OrchestratorConfig, compile
    from repro_torch.core.backend import get_backend
    from repro_torch.kernels import dp_sweep as ks
    from repro_torch.models.edge_cnn import edge_network

    tic = time.perf_counter()
    ks.LIBRARY.load()
    print(f"build: {ks.LIBRARY.path().name} in "
          f"{time.perf_counter() - tic:.2f} s", flush=True)
    rows = kernel_phase(k_best)
    net = KERNEL_SHAPES[0][0]
    ks.reset_launch_counts()
    passes = get_backend(DEVICE).io_stats["gather_calls"]
    tic = time.perf_counter()
    compile(edge_network(net), MinEnergy(rate_hz=RATE_FRACTION
                                         * max_rate(net)),
            cfg=OrchestratorConfig(device=DEVICE), network=net)
    print(f"compile {net}: wall {time.perf_counter() - tic:.3f} s  "
          f"launches {json.dumps(ks.LAUNCHES)}  gather passes "
          f"{get_backend(DEVICE).io_stats['gather_calls'] - passes}",
          flush=True)
    profile_phase(net)
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


def attention_kernels_only() -> int:
    """``--attention-kernels``: build the two prefill libraries alone
    (and the float32 one's ``ptxas -v`` report beside them), check the
    float32 plan, run the prefill rows and print the float32 serving
    row's numbers; no result line."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    libs = (fa.LIBRARY, fa.WGMMA_LIBRARY)
    tic = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs) + 1) as pool:
        usage = pool.submit(ptxas_usage, fa.LIBRARY)
        for path in pool.map(lambda lib: lib.build(), libs):
            print(f"build: {path.name}", flush=True)
        print(usage.result(), flush=True)
    for lib in libs:
        lib.load()
    print(f"build: both in {time.perf_counter() - tic:.2f} s", flush=True)
    f32_plan_check()
    rows: dict[str, dict] = {}
    found = prefill_rows(rows, torch.Generator(device=DEVICE).manual_seed(0))
    b, h, kh, sq, sk, d, causal, dtype = ATTENTION_SHAPES[1]
    label = _attn_label(*ATTENTION_SHAPES[1])
    row = found[label]
    print(f"f32 serving row {label}: events {row['ms']:.4f} ms  "
          f"back-to-back {row['b2b']:.4f} ms  device {_ms(row['dev_ms'])}  "
          f"bound {row['bound']:.5f} ms ({row['by']})  SDPA "
          f"{row['lib_ms']:.4f} ms", flush=True)
    # the card's clocks and power while ~1 s of these launches run
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    q = _randn(gen, b, h, sq, d, dtype=dtype)
    k = _randn(gen, b, kh, sk, d, dtype=dtype)
    v = _randn(gen, b, kh, sk, d, dtype=dtype)
    torch.cuda.synchronize()
    for _ in range(max(1, int(1000 / row["b2b"]))):
        fa.flash_attention(q, k, v, causal=causal)
    loaded = clocks()
    torch.cuda.synchronize()
    print(f"f32 serving row under load (sm clock, max sm clock, power, "
          f"temperature): {loaded}", flush=True)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    return 0


def main(argv: list[str]) -> int:
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
        from repro_torch.kernels import dp_sweep  # noqa: F401
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
    # float32 products in full float32, as the reference computes them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: matmul off, cudnn off", flush=True)

    from repro_torch.core.policies import OrchestratorConfig
    if argv == ["--sweep-kernels"]:
        return sweep_kernels_only(OrchestratorConfig().k_candidates)
    if argv == ["--attention-kernels"]:
        return attention_kernels_only()
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    build_all()
    profiler_check("start")

    tic = time.perf_counter()
    rows = kernel_phase(OrchestratorConfig().k_candidates)
    rows += attention_phase()
    # the int8 kernel rows run here, early: late in the run torch.profiler
    # drops more launches (profiler_check)
    rows += int8_phase()
    print(f"phase kernels: {time.perf_counter() - tic:.3f} s", flush=True)
    tic = time.perf_counter()
    counts, walls = path_phase()
    profile_phase(KERNEL_SHAPES[0][0])
    print(f"phase path: {time.perf_counter() - tic:.3f} s", flush=True)
    serve_counts = serve_phase()
    tic = time.perf_counter()
    int8_counts = int8_path_phase()
    print(f"phase int8: {time.perf_counter() - tic:.3f} s", flush=True)
    tic = time.perf_counter()
    policy_phase()
    print(f"phase policy: {time.perf_counter() - tic:.3f} s", flush=True)
    for row in rows:
        name = row["name"]
        row["launches"] = (serve_counts if name.startswith("flash")
                           else int8_counts if name == "int8_matmul"
                           else counts)[name]
    profiler_check("end")
    print(f"compile walls (s): {json.dumps(walls)}", flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
