#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU:

  1. prints the card's name and power limit, builds the CUDA kernels
     from ``src/repro_torch/csrc/`` (one ``nvcc`` per source, all
     started together; the attention backward's must not spill),
     prints each build's time and the count of
     ``HGMMA`` instructions in the bf16 attention library's SASS, of
     ``IGMMA`` in the int8 library's and of ``HMMA`` in the MLA decode's
     (``cuobjdump -sass``; each must be > 0), and the registers and
     spills of the float32 attention kernel and of the MLA decode's
     kernels (``ptxas -v``; the MLA decode's must spill nothing);
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
     give zeros), the serving rows also back to back; then the prefill
     kernels with hymba-1.5b's sliding window (``WINDOW_SHAPES``:
     hymba's prefill at 2 x 2048 and 1 x 1536 tokens, 25 query heads
     over 5 KV heads, window 1024, and the window's edges: window 1,
     window >= Sk, a window off the 64-key grid, q_offset > 0, rows that
     see no key) and the decode kernel over hymba's rings
     (``RING_SHAPES``: 1024 rows read up to min(length + 1, 1024)), each
     against its plain version with the same tolerances, the bound
     counting only the pairs the window keeps, SDPA with the same boolean
     mask beside it; then the moe, vlm and audio families' shapes
     (``FAMILY_PREFILL_SHAPES``: MLA's prefill head of 192 at
     deepseek-v2-lite's 2 x 1024 tokens and its edges in both dtypes,
     whisper-large-v3's encoder and cross-attention, kimi-k2's 64 / 8
     heads at D = 112), MLA's absorbed decode ``flash_decode_mla``
     (``MLA_DECODE_SHAPES``: 16 heads of one latent head, keys of 512 +
     64, values of 512, batch 16 over 2048 rows, lengths of 0 and S
     among them, batch 32 over 8192 rows, and the edges: 8 and 32
     heads, lengths around the 32-key tile, S = 1; bf16 on the tensor
     cores, float32 on the CUDA cores; SDPA over the concatenated keys
     with V padded beside it) and whisper's cross-attention decode over
     1500 rows;
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
  6. hybrid phase, hymba-1.5b at full width on the card (32 layers,
     d_model 1600, bf16, seed-0 weights): the launcher (8 requests, 16
     new tokens, the 30 Hz ``pfdnn`` schedule; launch counts set to 0
     just before and read just after: both attention kernels must
     launch); the kernel path against the plain path on 2 x 1536 and 2
     x 2048-token prompts (the window of 1024 cuts prefill, the rings
     have wrapped before the first decode step), prefill + 8 decode
     steps, 1e-3 x max |logits| in float32 and ``HYMBA_BF16_LIMIT`` in
     bf16, printing the floor (the plain path against the kernels'
     algorithms in plain PyTorch: 64-key tiled prefill, two-pass decode);
     a planted fault the bf16 limit must fail (the window dropped from
     the kernel path's prefill); a mid-batch refill through
     ``ServingEngine`` in float32, each step's logits against each
     request alone within 1e-3 x max |logits|, tokens equal;
     then where a 2 x 2048-token bf16 prefill and the decode steps spend
     their time (``gated_linear_scan``'s share; ``torch.profiler``:
     device busy, idle share, device time by kind);
  7. ssm phase, xlstm-350m at full width: the launcher (no attention
     kernel may launch; the power compile's sweep kernels must), prefill
     of 8 x 512 tokens and 16 decode steps with ``slstm_scan``'s share,
     and the card against the CPU port in float32 (every block on the
     same inputs within 1e-4, end to end within ``XLSTM_LIMIT`` beside
     the floor of one rounding);
  7b. moe, vlm and audio phases (seed-0 weights drawn on the card, each
     model freed before the next): deepseek-v2-lite-16b at full width
     (27 layers, MLA, 64 experts top-6 + 2 shared, bf16): the launcher
     (``flash_attention`` and ``flash_decode_mla`` must launch,
     ``flash_decode`` not); the kernel path against the plain path on 2
     x 1024-token prompts + 8 decode steps with the plain path's MoE
     routes replayed (``moe_routes``), the limit 1.5 x the floor measured
     in the same run, at most 0.1 x max |logits| (PERF.md section 2), a
     free-routing run printing how many routes differ, and a planted
     fault the limit must fail (``krope`` dropped from the MLA decode's
     scores); the same in float32 cut to 4 layers (1e-3), a float32
     mid-batch refill against each request alone, and a profiled batch-16
     decode step (the MoE FFN's share, device operations a step with and
     without it, idle share); kimi-k2-1t-a32b at full width cut to 1
     layer (384 experts top-8), kernel vs plain in bf16; qwen2-vl-72b at
     full width cut to 16 layers (bf16) and 4 (float32), kernel vs plain
     on prompts whose M-RoPE grids carry a 16 x 16 stub image block, and
     text-only grids against plain RoPE bit for bit; whisper-large-v3 at
     full width (32 + 32 layers, 1500 frames): the launcher (zero
     frames), kernel vs plain on seeded frames in bf16 with a planted
     fault (prefill's cross-attention made causal) and in float32, the
     encoder's share of a prefill and a float32 refill; the peak device
     memory of the three phases;
  7c. training phase (seed-0 weights drawn on the card, the earlier
     phases' models freed first): the backward kernels
     ``flash_attention_bwd`` (bf16: ``csrc/flash_attention_bwd_wgmma.cu``
     on the tensor cores; float32: ``csrc/flash_attention_bwd.cu``)
     against their plain version at ``BWD_SHAPES`` (tinyllama-1.1b's
     training shape [8, 32, 2048, 64] / 4 in bf16 and float32, hymba's
     window, whisper's encoder and cross-attention, MLA's 192 and the
     edges: Sq and Sk off the tile grid with q_offset > 0, groups 1 and
     8, rows that see no key, window 1, a window over Sq < Sk), each with
     the forward's saved row statistics and without: float32 within 1e-4
     x the largest gradient, bf16 against a float32 backward within 1.5
     x the larger of two floors (the plain backward in bf16; the bf16
     kernel's algorithm in plain PyTorch), at most 0.05, with a planted
     fault (the window dropped) that must exceed it; a second call
     bit-identical; its times beside its bound, its plain version's and
     SDPA forward + backward's; one full-width bf16 step on the kernels
     against plain attention (loss and gradient norm within 1e-3); the
     entry point
     ``repro_torch.launch.train`` at full width (tinyllama-1.1b, 8 x 2048
     tokens, 6 steps, remat, ``TRAIN_ARGS``) with the launch counts set
     to 0 just before and read just after (44 forward and 22 backward
     launches a step; every loss and gradient norm finite, the last
     loss below the first; peak memory) and one more step profiled
     (device time by kind); the full-width trajectories of
     ``TRAIN_LR_SWEEP``; four reduced float32 steps on the card against
     the CPU port (losses within 1e-5 relative, parameters within 1e-4
     x max |p|); the crash-restart drill on the card (crash after step
     7, resume at 7; the reference's tolerances; whether it is
     bit-identical); one reduced float32 step (loss and gradients) of
     hymba (window 100), whisper (150 frames) and deepseek-v2-lite
     (MLA's real heads) on the kernels against plain attention (1e-5 /
     1e-4), and a planted fault the check must catch (hymba's backward
     with the window dropped);
  8. int8 phase (its kernel rows run right after the attention
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
  9. policy phase: compiles all 23 schedules of
     ``tests/golden/pipeline.json`` (all eight policies) on the card and
     holds each against its golden, compares every policy's schedule of
     ``squeezenet1.1|0.5|3`` with the CPU compile byte for byte, compiles
     ``MinLatency`` and ``ParetoFront`` goals on the card against the
     CPU, and prints each compile's wall and DP-kernel launches;
  10. service phase, the fleet compile service on the card: checks
     that a collection frees no device memory left by the earlier
     phases; compiles ``pfdnn`` for the four edge networks at 0.5, 0.7
     and 0.9 x max rate (3 rails of the 9-level menu) plus a
     ``MinLatency`` and a ``ParetoFront(n_points=4)`` request on
     squeezenet1.1, first each alone with the collector off (device
     memory back within 1 MiB after them), then each alone through one
     shared ``ArtifactStore``, then as one
     ``CompileService.compile_many`` (launch counts set to 0 just
     before and read just after; each result equal to its solo compile
     and, byte for byte, to the same fleet compiled on the CPU in a
     spawned process meanwhile), printing the walls, the DP, k-best and
     gather launches and lanes per launch of the three runs, and the
     fleet's device busy time (``torch.profiler``, device activity
     only); repeats the batch from the schedule cache (0 launches) and
     with the cache off (0 lane uploads); reads
     ``torch.cuda.memory_allocated`` before the fleet, with the lane
     mirrors resident and after ``store.clear(stacks=True)`` (back
     within 1 MiB); runs two threads' ``compile_many`` on one service
     under ``lockcheck`` (clean: no cycle, no lock held across the
     barrier); then a 2-worker ``CompileFarm`` on the card over a
     temporary disk store (8 requests, 2 tenants, no error, equal to
     solo) and a 1-worker farm of a fresh process answering from the
     first one's entries, with the p50 and p95 of each;
  11. control phase, the adaptive control plane on the card
     (``benchmarks/serve_robustness.py``'s setup: squeezenet1.1 at full
     width, ``pfdnn``, 3 rails, base rate 60 Hz provisioned at 0.85,
     tightened variants at 0.92, seed 11, ``CONTROL_FRAMES`` frames a
     row): compiles the contingency bundle in one
     ``compile_contingencies`` (launch counts set to 0 just before and
     read just after; DP, k-best and gather must launch); serves the
     calm, bursty and drift traces, static and adaptive, then
     drift_learned, whose blocking ledger-learned re-solves each run on
     the card (wall and launches printed, each kernel launched by
     each); computes the benchmark's acceptance block (its ``--smoke``
     six must hold, all eight at 420 frames); runs an async re-solve,
     awaited and equal to the blocking one, then one that the watchdog
     abandons mid-flight while serving goes on (no error, device memory
     back within 1 MiB after ``clear(stacks=True)``, ``lockcheck``
     clean); the calibration harness (parity, a synthetic truth
     recovered, publication and reuse through a disk store, the parity
     model compiling the static schedule, ``solver_kernel_walls`` on the
     card with the CUDA-event time of the same calls); a 3-band policy
     table in one ``compile_many`` and a trace over its bands; 100
     periods of ``PeriodicScheduler`` under the bursty faults; one
     blocking re-solve under ``torch.profiler`` (idle share).  The same
     phase runs on the CPU port in two spawned processes meanwhile;
     every schedule, ``ServeReport``, event log, table, periodic ledger
     and the walls' checksum must equal it;
 12. analysis phase: ``python -m repro_torch.analysis`` as users run it,
     in subprocesses started together: ``certify --goldens`` on the card
     (its DP, k-best and gather launches must be > 0) and on the CPU,
     whose 23 lines must be equal and each PASS; ``lint`` (clean under
     the port's baseline); ``certify --store`` on the service phase's
     farm store (OK, entries > 0); ``lockcheck --dump`` on the service
     phase's two-thread lock graph (no cycle, no barrier hazard);
 13. dryrun phase: the dry-run (``repro_torch.launch.dryrun``) of all
     40 (architecture × shape) cells on ``meta`` tensors at full width,
     its counting passes on ``DRYRUN_JOBS`` processes (each cell ``OK``
     or ``SKIP`` as ``all_cells`` says; one line a cell: peak GiB, fits
     one card, the compute and memory terms of the H100 roofline,
     dominant) and ``H100_SXM.hbm_bytes`` against the card's
     ``total_memory``; tinyllama-1.1b's bf16 decode step at the serving
     shape (batch 16, a cache of 2048 rows) dry-run and then run on the
     card: the record's argument bytes equal to the real parameters,
     cache and tokens, its FLOPs and bytes over the H100's rates beside
     the step's events and device ms, its peak beside
     ``torch.cuda.max_memory_allocated``; the PF-DNN adapter on the
     port's own qwen2-7b ``decode_32k`` record (28 layers, rails 0.7 /
     0.85 / 1.0, deadlines of 1.2, 2 and 4 x the memory floor), solved
     on the card (the DP and k-best kernels must launch) and on the CPU
     port: paths, energies and times equal, every deadline met, energy
     against the all-max static assignment; then the card's power draw
     (``nvidia-smi`` every 100 ms) idle, under a bf16 GEMM loop and under
     a device-copy loop, beside the chip model's nominal powers; and
     ``DRYRUN_POD_CELLS`` on the production meshes ``pod16x16`` and
     ``pod2x16x16`` (rank 0's step on an abstract mesh: per-device
     peak, fits one card, the port's own collectives by op, kimi-k2's
     train cell with ZeRO);
 14. mesh phase, the port over a mesh of ``torch.distributed`` ranks:
     NCCL in a world of one (its version printed; deepseek-v2-lite at
     full width cut to ``MESH_NCCL_LAYERS``, float32, ``moe_impl="ep"``
     on a (1,1) mesh): prefill + decode against the dense path on the
     dense path's routes (``moe_routes``) at a capacity factor that
     drops nothing, for the native and the int8 wire; the (token,
     choice) pairs that drop at the configuration's 1.25; one train step
     (EP, ZeRO on) against the dense one; the MoE block's events beside
     the dense block's; the tensor-parallel path runs there over groups
     of one (every logged collective of size 1).  Then four gloo ranks spawned on the card (the
     process groups' timeout and each join ``MESH_TIMEOUT_S``; a rank's
     exception fails the phase): which of the port's collectives gloo
     takes on CUDA tensors; ``compressed_psum`` on CUDA against CPU
     tensors; (a) deepseek-v2-lite cut to ``MESH_EP_LAYERS`` on (2,2),
     the EP block and ``forward_train``'s loss and gradients against
     rank 0's one-process dense path on its routes, then
     ``ServingEngine(rt)`` serving ``MESH_ENGINE_PROMPTS`` (slots
     refilled mid-batch), the same tokens on every rank; (b) tinyllama-1.1b
     cut to ``MESH_DP_LAYERS`` on a ``"data"`` mesh of 4 with ZeRO-2
     against one process, ZeRO on and off bit for bit, a rank's moment
     bytes; (d) tensor parallelism: tinyllama-1.1b cut to
     ``MESH_TP_LAYERS`` on (1,4) (8 query heads over one KV head a rank)
     and (2,2) against rank 0's one process (prefill and decode logits,
     the loss, the reduced gradients gathered; ``ServingEngine(rt)``'s
     tokens), then on (2,2) one train, prefill and decode step of
     tinyllama and deepseek-v2-lite (EP) each with its collectives
     logged, every rank's log and held bytes equal to the dry-run
     counter's on an abstract (2,2) mesh; (a) runs EP with tensor
     parallelism (MLA's 8 heads a rank); (c) 4 ranks crash after step 7
     and 2 ranks resume, against the clean 4-rank run.  A second world
     of four runs (e) the KV cache cut by sequence, (f) xLSTM's mixers
     cut by heads and (g) hymba-1.5b's attention and Mamba heads cut in
     blocks of whole heads of unequal size (``MESH_HYBRID_*``, 4 layers
     at full width: prefill past the window, decode, the engine and a
     train step against one process on (1,4) and (2,2); a planted fault
     in the uneven gather; exact counts, each rank against the counter
     at its own "model" coordinate).  Launch counts are set to 0 just
     before the EP runs and read just after: the prefill, backward and
     MLA-decode kernels must launch.  gloo stages CUDA tensors through
     host memory: its times are no performance figure;
 15. prints the card's name and power limit again, the ``kernels`` JSON
     line (the families' configurations of #4 and #5 as rows of their
     own, with the launches of their launcher or, where it has none or
     the row is float32, of their kernel-path run: ``FAMILY_ROWS``;
     ``flash_decode_mla`` is #5's MLA kernel; ``flash_attention_bwd``,
     the backward of #4, with the training launcher's launches) and,
     last, the result line.

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
bound and SDPA times; it prints no result line.  ``python3
chip_smoke.py --service`` builds the rail-sweep library alone and runs
the service phase; it prints no result line.  ``python3 chip_smoke.py
--control`` builds the rail-sweep library alone and runs the control
phase; it prints no result line.  ``python3 chip_smoke.py
--lm-families`` builds the attention, decode and rail-sweep libraries
and runs the windowed, ring and new families' kernel rows, the hybrid,
ssm, moe, vlm, audio and analysis phases (without the store audit and
the lock dump, which need the service phase); it prints no result
line.  ``python3 chip_smoke.py --mla-decode`` builds the MLA decode
library alone, prints its ``ptxas -v`` report (no spills) and its
``HMMA`` count (> 0), and runs the MLA_DECODE_SHAPES rows; it prints no
result line.  ``python3 chip_smoke.py --train`` builds the two prefill
attention libraries and the backward's (its ``ptxas -v`` report: no
spills) and runs the training phase; it prints the ``kernels`` line
with the backward's row and no result line.  ``python3 chip_smoke.py
--dryrun`` builds the prefill bf16, decode and rail-sweep libraries and
runs the dryrun phase; it prints no result line.  ``python3
chip_smoke.py --mesh`` builds the prefill, backward, decode and MLA-decode
libraries and runs the mesh phase; it prints no result line.  Run from
a ``git
archive`` of another commit, this script times that commit's kernels
(a tree without the float32 plan skips its check).
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import tempfile
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
           # csrc/flash_attention.cu, as hymba's float32 window row says
           "flash_attention": "src/repro_torch/csrc/flash_attention_wgmma.cu",
           "flash_attention_f32": "src/repro_torch/csrc/flash_attention.cu",
           # the JSON row is bf16; float32 runs on
           # csrc/flash_attention_bwd.cu
           "flash_attention_bwd":
               "src/repro_torch/csrc/flash_attention_bwd_wgmma.cu",
           "flash_decode": "src/repro_torch/csrc/flash_decode.cu",
           "flash_decode_mla": "src/repro_torch/csrc/flash_decode_mla.cu",
           "int8_matmul": "src/repro_torch/csrc/int8_matmul.cu"}
REPLACES = {"dp_multi_stacked": "src/repro/kernels/dp_sweep.py:81",
            "kbest_multi_stacked": "src/repro/kernels/dp_sweep.py:148",
            "path_components": "src/repro/kernels/dp_sweep.py:205",
            "flash_attention": "src/repro/kernels/flash_attention.py:81",
            "flash_attention_f32": "src/repro/kernels/flash_attention.py:81",
            # no TPU kernel: the reference differentiates this jnp
            # attention by autodiff
            "flash_attention_bwd": "src/repro/models/layers.py:87",
            "flash_decode": "src/repro/kernels/flash_decode.py:68",
            "flash_decode_mla": "src/repro/kernels/flash_decode.py:68",
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
                err, library_ms=None, dev_ms=None, kernel=None) -> None:
    """Print one kernel row; the first row of each ``name`` goes into the
    JSON line (``kernel``: the kernel's own name, for rows that carry
    another configuration of it under their own name)."""
    kernel = kernel or name
    lib = "" if library_ms is None else f"  library {library_ms:9.4f} ms"
    dev = "" if dev_ms is None else f"  device {dev_ms:9.5f} ms"
    print(f"kernel {name:20s} {shape:28s} {ms:9.4f} ms  plain "
          f"{plain_ms:9.4f} ms  bound {bound_ms:9.5f} ms ({bound_by})"
          f"{lib}{dev}  max_abs_err {err}", flush=True)
    # the JSON line carries the first shape of each kernel (the widest,
    # or for attention the serving shape); every shape is printed above
    rows.setdefault(name, {
        "name": name, "route": "cuda", "source": SOURCES[kernel],
        "replaces": REPLACES[kernel], "launches": 0, "max_abs_err": err,
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
    # tensor parallelism's local heads: tinyllama-1.1b on "model" = 4, 8
    # query heads over one KV head
    (16, 8, 1, 1024, 1024, 64, True, "bfloat16"),
    (16, 8, 1, 1024, 1024, 64, True, "float32"),
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
    # tensor parallelism's local heads (tinyllama-1.1b on "model" = 4)
    (16, 2048, 1, 8, 64, "bfloat16", False),
    (16, 2048, 1, 8, 64, "float32", False),
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


def attention_bound(b, h, kh, sq, sk, d, causal, q_offset, dtype,
                    window: int = 0) -> tuple[float, str, int, int]:
    """q, k, v read once and the output written once; 4·D operations
    (two multiply-adds, QK and PV) per (query, key) pair the mask keeps
    (causal: keys at or before the query; ``window`` > 0: only the last
    ``window`` positions of each query)."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (2 * b * h * sq * d + 2 * b * kh * sk * d) * elt
    pairs = 0
    for i in range(sq):
        qpos = q_offset + i
        hi = min(sk - 1, qpos) if causal else sk - 1
        lo = max(0, qpos - window + 1) if window > 0 else 0
        pairs += max(0, hi - lo + 1)
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
    lse_rows(rows, gen)
    window_rows(rows, gen)
    ring_rows(rows, gen)
    family_rows(rows, gen)
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


# the decode kernels with their log-sum-exp output, at one rank's slice
# of a cache cut by sequence (shard_kv_seq: tinyllama-1.1b's 2048 rows
# over "model" = 4): (b, s, kh, h, d, dtype) for flash_decode, (b, s, h,
# dtype) for the MLA decode (deepseek-v2-lite's 16 heads); lengths from
# [0, S] with a full and an empty slice
LSE_DECODE_SHAPES = ((16, 512, 4, 32, 64, "bfloat16"),
                     (16, 512, 4, 32, 64, "float32"))
LSE_MLA_SHAPES = ((16, 512, 16, "bfloat16"), (16, 512, 16, "float32"))
#: lse against its plain version, x max |lse| of the row (fixed before
#: the first run; PERF.md section 2)
LSE_TOL = 1e-5


def _lse_err(got, want, lens) -> float:
    """max |got - want| / max |want| over the rows of a valid position;
    inf unless the empty rows read NEG_INF exactly."""
    import torch

    from repro_torch.kernels.flash_decode import NEG_INF

    live = lens > 0
    if not bool((got[~live] == NEG_INF).all()):
        return float("inf")
    if not bool(live.any()):
        return 0.0
    return (float((got[live] - want[live]).abs().max())
            / float(want[live].abs().max()))


def lse_rows(rows: dict, gen) -> None:
    """``flash_decode`` and ``flash_decode_mla`` with their log-sum-exp
    at LSE_DECODE_SHAPES / LSE_MLA_SHAPES against their plain versions
    (out at ATTN_TOL, lse within LSE_TOL x max |lse|), their device ms
    beside the same call without lse, with bound and SDPA ms; the JSON
    line carries the bf16 rows as ``flash_decode_lse`` and
    ``flash_decode_mla_lse``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd

    lrng = np.random.default_rng(2)

    def lengths(b, s):
        lens = lrng.integers(0, s + 1, size=b).astype(np.int32)
        lens[0], lens[-1] = s, 0            # a full and an empty slice
        return lens

    for b, s, kh, h, d, dtype in LSE_DECODE_SHAPES:
        q = _randn(gen, b, h, d, dtype=dtype)
        k = _randn(gen, b, s, kh, d, dtype=dtype)
        v = _randn(gen, b, s, kh, d, dtype=dtype)
        lens_np = lengths(b, s)
        lens = torch.from_numpy(lens_np).to(DEVICE)
        got, lse = fd.flash_decode(q, k, v, lens, with_lse=True)
        want, want_lse = fd.flash_decode_plain(q, k, v, lens, with_lse=True)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        lse_err = _lse_err(lse, want_lse, lens)
        label = f"B={b} S={s} {h}/{kh} heads D={d} {dtype} lse"
        check(err <= ATTN_TOL[dtype] and lse_err <= LSE_TOL,
              f"flash_decode with lse != plain at {label}: out {err}, lse "
              f"{lse_err}")
        mask = (torch.arange(s, device=DEVICE)[None, :]
                < lens[:, None])[:, None, None, :]
        qs, ks, vs = q[:, :, None], k.permute(0, 2, 1, 3), \
            v.permute(0, 2, 1, 3)

        def library():
            return F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)[:, :, 0]

        bound, by, nbytes, ops = decode_bound(
            h, kh, d, [int(x) for x in lens_np], dtype)
        # + the float32 lse written
        bound, by, _, _ = _bound_typed(nbytes + 4 * b * h, ops, dtype)
        kernel = lambda: fd.flash_decode(q, k, v, lens,  # noqa: E731
                                         with_lse=True)
        plain = lambda: fd.flash_decode(q, k, v, lens)  # noqa: E731
        _kernel_row(rows, "flash_decode_lse" + (
            "" if dtype == "bfloat16" else "_f32"), label, time_ms(kernel),
                    time_ms(lambda: fd.flash_decode_plain(
                        q, k, v, lens, with_lse=True)),
                    bound, by, err, time_ms(library), device_ms(kernel),
                    kernel="flash_decode")
        print(f"  lse max |dlse| / max |lse| {lse_err!r} (limit {LSE_TOL});"
              f" the same call without lse: device {_ms(device_ms(plain))}",
              flush=True)
        del q, k, v, got, want
    r, dr = fd.MLA_WIDTHS
    for b, s, h, dtype in LSE_MLA_SHAPES:
        args = (_randn(gen, b, h, r, dtype=dtype),
                _randn(gen, b, h, dr, dtype=dtype),
                _randn(gen, b, s, r, dtype=dtype),
                _randn(gen, b, s, dr, dtype=dtype))
        lens_np = lengths(b, s)
        lens = torch.from_numpy(lens_np).to(DEVICE)
        got, lse = fd.flash_decode_mla(*args, lens, with_lse=True)
        want, want_lse = fd.flash_decode_mla_plain(*args, lens,
                                                   with_lse=True)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        lse_err = _lse_err(lse, want_lse, lens)
        label = f"B={b} S={s} {h}/1 heads K={r}+{dr} V={r} {dtype} lse"
        check(err <= ATTN_TOL[dtype] and lse_err <= LSE_TOL,
              f"flash_decode_mla with lse != plain at {label}: out {err}, "
              f"lse {lse_err}")
        q_lat, q_rope, ckv, krope = args
        qs = torch.cat([q_lat, q_rope], dim=-1)[:, :, None]
        ks = torch.cat([ckv, krope], dim=-1)[:, None]
        vs = F.pad(ckv, (0, dr))[:, None]
        mask = (torch.arange(s, device=DEVICE)[None, :]
                < lens[:, None])[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)[:, :, 0, :r]

        valid = int(lens_np.sum())
        elt = 2 if dtype == "bfloat16" else 4
        nbytes = (b * h * (r + dr) + b * h * r + valid * (r + dr)) * elt \
            + 4 * b + 4 * b * h
        bound, by, _, _ = _bound_typed(nbytes, 2 * (2 * r + dr) * h * valid,
                                       dtype)
        kernel = lambda: fd.flash_decode_mla(  # noqa: E731
            *args, lens, with_lse=True)
        plain = lambda: fd.flash_decode_mla(*args, lens)  # noqa: E731
        _kernel_row(rows, "flash_decode_mla_lse" + (
            "" if dtype == "bfloat16" else "_f32"), label, time_ms(kernel),
                    time_ms(lambda: fd.flash_decode_mla_plain(
                        *args, lens, with_lse=True)),
                    bound, by, err, time_ms(library), device_ms(kernel),
                    kernel="flash_decode_mla")
        print(f"  lse max |dlse| / max |lse| {lse_err!r} (limit {LSE_TOL});"
              f" the same call without lse: device {_ms(device_ms(plain))}",
              flush=True)
        del args, got, want, qs, ks, vs


# (b, h, kh, sq, sk, d, window, dtype): hymba-1.5b's prefill (25 query
# heads over 5 KV heads, a group of 5, D = 64, window 1024) at the
# hybrid parity run's longest prompt, in bf16 and float32; then the
# window's edges in both dtypes: window 1 (each row sees itself),
# window >= Sk (the causal mask alone), a window that is no multiple of
# a 64-key tile, q_offset > 0 (Sq < Sk) with a window that cuts the
# first rows, and Sq > Sk (rows that see no key); all causal, as hymba's
HYMBA = "hymba-1.5b"
WINDOW_SHAPES = (
    (2, 25, 5, 2048, 2048, 64, 1024, "bfloat16"),
    (2, 25, 5, 2048, 2048, 64, 1024, "float32"),
    (1, 25, 5, 1536, 1536, 64, 1024, "bfloat16"),
    (1, 10, 2, 300, 300, 64, 1, "bfloat16"),
    (1, 10, 2, 300, 300, 64, 1, "float32"),
    (1, 10, 2, 500, 500, 64, 4096, "bfloat16"),
    (1, 10, 2, 500, 500, 64, 4096, "float32"),
    (2, 5, 1, 1000, 1000, 64, 1000, "bfloat16"),
    (2, 5, 1, 1000, 1000, 64, 1000, "float32"),
    (1, 10, 2, 300, 1000, 64, 333, "bfloat16"),
    (1, 10, 2, 300, 1000, 64, 333, "float32"),
    (1, 25, 5, 257, 1100, 128, 100, "bfloat16"),
    (1, 25, 5, 257, 1100, 32, 100, "float32"),
    (1, 10, 2, 200, 150, 64, 77, "bfloat16"),
    (1, 10, 2, 200, 150, 64, 77, "float32"),
    # tensor parallelism's local heads: hymba-1.5b on "model" = 4, rank
    # 0 (10 query heads over 2 KV heads) and ranks 1-3 (5 over 1)
    (2, 10, 2, 2048, 2048, 64, 1024, "bfloat16"),
    (2, 10, 2, 2048, 2048, 64, 1024, "float32"),
    (2, 5, 1, 2048, 2048, 64, 1024, "bfloat16"),
    (2, 5, 1, 2048, 2048, 64, 1024, "float32"),
)
# the JSON rows of the families' configurations, and the count each
# carries, as (run, counter): the hymba rows (hybrid_phase) the hymba
# launcher's launches for bf16 (its bf16 prefill runs the wgmma kernel
# alone) and for the float32 row the float32 kernel's launches in the
# float32 parity runs' kernel-path prefills, the only hymba run in
# float32; the rows of the moe, vlm and audio families
# (families_phase) the deepseek-v2-lite and whisper launchers' launches
# for bf16, the float32 parity runs' kernel paths for float32, and
# kimi-k2's bf16 parity run's kernel path (it has no launcher run).  The
# whisper launcher's bf16 rows take the launches of their own use
# (``launches_by_use``: encoder, cross-attention); the float32 row, the
# float32 kernel's total in that parity run
FAMILY_ROWS = {"flash_attention_window": ("hybrid", "flash_attention"),
               "flash_attention_window_f32": ("hybrid",
                                              "flash_attention_f32"),
               "flash_decode_ring": ("hybrid", "flash_decode"),
               "flash_attention_mla": ("moe", "flash_attention"),
               "flash_attention_mla_f32": ("moe f32", "flash_attention"),
               "flash_decode_mla": ("moe", "flash_decode_mla"),
               "flash_decode_mla_f32": ("moe f32", "flash_decode_mla"),
               "flash_attention_kimi": ("kimi", "flash_attention"),
               "flash_attention_whisper": ("audio",
                                           "flash_attention encoder"),
               "flash_attention_whisper_f32": ("audio f32",
                                               "flash_attention"),
               "flash_attention_cross": ("audio", "flash_attention cross"),
               "flash_decode_cross": ("audio", "flash_decode cross")}
# (b, h, kh, d, dtype, lengths): hymba-1.5b's ring decode, a ring of
# window = 1024 rows read up to min(length + 1, 1024) rows: a batch of 8
# whose rings have all wrapped, then a batch of 8 with lengths short of
# the window and at it, in bf16 and float32
RING_WINDOW = 1024
RING_SHAPES = (
    (8, 25, 5, 64, "bfloat16", (2049,) * 8),
    (8, 25, 5, 64, "float32", (2049,) * 8),
    (8, 25, 5, 64, "bfloat16", (1, 17, 500, 1022, 1023, 1024, 1500, 3000)),
    (8, 25, 5, 64, "float32", (1, 17, 500, 1022, 1023, 1024, 1500, 3000)),
    # tensor parallelism's local heads: hymba-1.5b on "model" = 4
    (8, 10, 2, 64, "bfloat16", (2049,) * 8),
    (8, 10, 2, 64, "float32", (2049,) * 8),
    (8, 5, 1, 64, "bfloat16", (2049,) * 8),
    (8, 5, 1, 64, "float32", (2049,) * 8),
)


def window_rows(rows: dict, gen) -> None:
    """``flash_attention`` with a sliding window at WINDOW_SHAPES
    against its plain version (3e-5 in float32, 2e-2 in bf16; rows that
    see no key give zeros), with its times beside its bound (the pairs
    the window keeps) and SDPA's with the same boolean mask."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    for b, h, kh, sq, sk, d, window, dtype in WINDOW_SHAPES:
        q = _randn(gen, b, h, sq, d, dtype=dtype)
        k = _randn(gen, b, kh, sk, d, dtype=dtype)
        v = _randn(gen, b, kh, sk, d, dtype=dtype)
        q_offset = sk - sq
        args = dict(causal=True, q_offset=q_offset, window=window)
        got = fa.flash_attention(q, k, v, **args)
        want = fa.flash_attention_plain(q, k, v, **args)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        label = (_attn_label(b, h, kh, sq, sk, d, True, dtype)
                 + f" window {window}")
        check(err <= ATTN_TOL[dtype], f"flash_attention != plain at "
              f"{label}: max abs err {err}")
        if q_offset < 0:
            check(bool((got[:, :, :-q_offset] == 0).all()),
                  f"flash_attention at {label}: rows that see no key are "
                  "not zero")
        qpos = q_offset + torch.arange(sq, device=DEVICE)
        kpos = torch.arange(sk, device=DEVICE)
        mask = (qpos[:, None] >= kpos[None]) \
            & (qpos[:, None] - kpos[None] < window)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)

        # SDPA gives NaN for a row that sees no key: compare the others
        seen = mask.any(dim=1)
        lib_err = _max_abs_err(library()[:, :, seen], want[:, :, seen])
        bound, by, nbytes, ops = attention_bound(b, h, kh, sq, sk, d, True,
                                                 q_offset, dtype, window)
        kernel = lambda: fa.flash_attention(q, k, v, **args)  # noqa: E731
        bf16 = dtype == "bfloat16"
        name = ("flash_attention_window" if bf16
                else "flash_attention_window_f32")
        _kernel_row(rows, name, label, time_ms(kernel),
                    time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                             **args)),
                    bound, by, err, time_ms(library), device_ms(kernel),
                    kernel="flash_attention" if bf16
                    else "flash_attention_f32")
        print(f"  bytes {nbytes}  operations {ops}  library max abs err "
              f"vs plain {lib_err}", flush=True)
        del q, k, v, got, want


def ring_rows(rows: dict, gen) -> None:
    """``flash_decode`` over hymba's ring buffers (RING_SHAPES) against
    its plain version, with its times beside its bound (the valid rows
    read once) and SDPA's with the same length mask."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd

    s = RING_WINDOW
    for b, h, kh, d, dtype, lengths in RING_SHAPES:
        q = _randn(gen, b, h, d, dtype=dtype)
        k = _randn(gen, b, s, kh, d, dtype=dtype)
        v = _randn(gen, b, s, kh, d, dtype=dtype)
        # a decode step at length n reads min(n + 1, window) ring rows
        valid_np = np.minimum(np.asarray(lengths) + 1, s).astype(np.int32)
        valid = torch.from_numpy(valid_np).to(DEVICE)
        got = fd.flash_decode(q, k, v, valid)
        want = fd.flash_decode_plain(q, k, v, valid)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        n_split = fd.decode_splits(
            s, torch.cuda.get_device_properties(0).multi_processor_count)
        label = (f"ring B={b} W={s} {h}/{kh} heads D={d} {dtype} "
                 f"lengths {min(lengths)}-{max(lengths)} splits={n_split}")
        check(err <= ATTN_TOL[dtype], f"flash_decode != plain at {label}: "
              f"max abs err {err}")
        qs = q[:, :, None, :]
        ks, vs = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        mask = (torch.arange(s, device=DEVICE)[None, :]
                < valid[:, None])[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)[:, :, 0]

        bound, by, nbytes, ops = decode_bound(
            h, kh, d, [int(x) for x in valid_np], dtype)
        kernel = lambda: fd.flash_decode(q, k, v, valid)  # noqa: E731
        _kernel_row(rows, "flash_decode_ring", label, time_ms(kernel),
                    time_ms(lambda: fd.flash_decode_plain(q, k, v, valid)),
                    bound, by, err, time_ms(library), device_ms(kernel),
                    kernel="flash_decode")
        print(f"  bytes {nbytes}  operations {ops}  library max abs err "
              f"vs plain {_max_abs_err(library(), want)}", flush=True)
        del q, k, v, got, want


# (b, h, kh, sq, sk, d, causal, dtype) of the slice's new prefill shapes,
# each row under its JSON name: MLA's head (hd + dr = 192, V padded to
# it) at deepseek-v2-lite's parity prefill (2 x 1024 tokens, 16 heads)
# in bf16 and float32, then its edges in both dtypes: Sq = Sk = 1000 (no
# multiple of a tile), Sq < Sk, Sq > Sk (rows that see no key), one
# query and one key, one query over 333 keys, one key non-causal with
# GQA; whisper-large-v3's encoder (1500 frames, 20 heads of 64,
# non-causal) and its cross-attention (448 decoder positions over the
# 1500 frames); kimi-k2's prefill (64 query heads over 8 KV heads, D =
# 112) at its parity run's 2 x 512 tokens
FAMILY_PREFILL_SHAPES = (
    ("flash_attention_mla", (2, 16, 16, 1024, 1024, 192, True, "bfloat16")),
    ("flash_attention_mla_f32",
     (2, 16, 16, 1024, 1024, 192, True, "float32")),
    ("flash_attention_mla", (1, 16, 16, 1000, 1000, 192, True, "bfloat16")),
    ("flash_attention_mla_f32",
     (1, 16, 16, 1000, 1000, 192, True, "float32")),
    ("flash_attention_mla", (1, 4, 4, 300, 1000, 192, True, "bfloat16")),
    ("flash_attention_mla_f32", (1, 4, 4, 300, 1000, 192, True, "float32")),
    ("flash_attention_mla", (1, 4, 4, 100, 60, 192, True, "bfloat16")),
    ("flash_attention_mla_f32", (1, 4, 4, 100, 60, 192, True, "float32")),
    ("flash_attention_mla", (1, 4, 4, 1, 1, 192, True, "bfloat16")),
    ("flash_attention_mla_f32", (1, 4, 4, 1, 1, 192, True, "float32")),
    ("flash_attention_mla", (1, 4, 4, 1, 333, 192, True, "bfloat16")),
    ("flash_attention_mla_f32", (1, 4, 4, 1, 333, 192, True, "float32")),
    ("flash_attention_mla", (2, 4, 2, 130, 1, 192, False, "bfloat16")),
    ("flash_attention_mla_f32", (2, 4, 2, 130, 1, 192, False, "float32")),
    ("flash_attention_whisper",
     (2, 20, 20, 1500, 1500, 64, False, "bfloat16")),
    ("flash_attention_whisper_f32",
     (2, 20, 20, 1500, 1500, 64, False, "float32")),
    ("flash_attention_cross", (2, 20, 20, 448, 1500, 64, False, "bfloat16")),
    ("flash_attention_kimi", (2, 64, 8, 512, 512, 112, True, "bfloat16")),
    # tensor parallelism's local heads: deepseek-v2-lite on "model" = 2
    ("flash_attention_mla", (2, 8, 8, 1024, 1024, 192, True, "bfloat16")),
    ("flash_attention_mla_f32", (2, 8, 8, 1024, 1024, 192, True, "float32")),
)
# (b, s, h, dtype, lengths): MLA's absorbed decode (16 query heads of one
# latent head, keys of 512 + 64, values of 512) at batch 16 over a
# 2048-row cache, lengths drawn from [1, S] with one full cache and one
# empty (its output must be zeros), in bf16 and float32; then S = 1001
# (no chunk boundary) with short lengths; the long-context row (batch 32
# over 8192 rows, lengths drawn the same way); deepseek-v2-lite's
# profiled decode step (moe_profile: 16 sequences of 1040 positions, all
# alike, in a 1052-row cache); then the edges in both dtypes: 8 and 32
# heads (half a head group, two groups) with lengths 0, 1, at the 32-key
# tile's and the 64-position edges and full, and S = 1
MLA_EDGE_LENGTHS = (0, 1, 63, 64, 65)
MLA_DECODE_SHAPES = (
    (16, 2048, 16, "bfloat16", None),
    (16, 2048, 16, "float32", None),
    (3, 1001, 16, "bfloat16", (1, 31, 1001)),
    (32, 8192, 16, "bfloat16", None),
    (16, 1052, 16, "bfloat16", (1040,) * 16),
    (6, 2048, 8, "bfloat16", MLA_EDGE_LENGTHS + (2048,)),
    (6, 2048, 32, "bfloat16", MLA_EDGE_LENGTHS + (2048,)),
    (6, 1001, 8, "float32", MLA_EDGE_LENGTHS + (1001,)),
    (6, 1001, 32, "float32", MLA_EDGE_LENGTHS + (1001,)),
    (2, 1, 16, "bfloat16", (0, 1)),
    (2, 1, 16, "float32", (0, 1)),
    # tensor parallelism's local heads (deepseek-v2-lite on "model" = 2):
    # 8 heads, half of the CTA's 16 rows padding
    (16, 2048, 8, "bfloat16", None),
    (16, 2048, 8, "float32", None),
)
# (b, s, h, kh, d, dtype): whisper's cross-attention decode, every
# query reads all 1500 encoder rows (group 1)
CROSS_DECODE_SHAPES = ((8, 1500, 20, 20, 64, "bfloat16"),)


def family_rows(rows: dict, gen) -> None:
    """The slice's new kernel shapes against their plain versions with
    the attention tolerances: ``flash_attention`` at
    FAMILY_PREFILL_SHAPES (SDPA beside it, with ``enable_gqa`` and the
    same causal mask), ``flash_decode_mla`` at MLA_DECODE_SHAPES
    (``mla_decode_rows``) and ``flash_decode`` over whisper's encoder
    rows."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    for name, (b, h, kh, sq, sk, d, causal, dtype) in FAMILY_PREFILL_SHAPES:
        q = _randn(gen, b, h, sq, d, dtype=dtype)
        k = _randn(gen, b, kh, sk, d, dtype=dtype)
        v = _randn(gen, b, kh, sk, d, dtype=dtype)
        q_offset = sk - sq if causal else 0
        args = dict(causal=causal, q_offset=q_offset)
        got = fa.flash_attention(q, k, v, **args)
        want = fa.flash_attention_plain(q, k, v, **args)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        label = _attn_label(b, h, kh, sq, sk, d, causal, dtype)
        check(err <= ATTN_TOL[dtype], f"flash_attention != plain at "
              f"{label}: max abs err {err}")
        if q_offset < 0:
            check(bool((got[:, :, :-q_offset] == 0).all()),
                  f"flash_attention at {label}: rows that see no key are "
                  "not zero")
        mask = None
        if causal:
            qpos = q_offset + torch.arange(sq, device=DEVICE)
            mask = qpos[:, None] >= torch.arange(sk, device=DEVICE)[None]

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)

        seen = slice(max(0, -q_offset), None)
        lib_err = _max_abs_err(library()[:, :, seen], want[:, :, seen])
        bound, by, nbytes, ops = attention_bound(b, h, kh, sq, sk, d,
                                                 causal, q_offset, dtype)
        kernel = lambda: fa.flash_attention(q, k, v, **args)  # noqa: E731
        _kernel_row(rows, name, label, time_ms(kernel),
                    time_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                             **args)),
                    bound, by, err, time_ms(library), device_ms(kernel),
                    kernel="flash_attention" if dtype == "bfloat16"
                    else "flash_attention_f32")
        print(f"  bytes {nbytes}  operations {ops}  library max abs err "
              f"vs plain {lib_err}", flush=True)
        del q, k, v, got, want

    mla_decode_rows(rows, gen)

    for b, s, h, kh, d, dtype in CROSS_DECODE_SHAPES:
        q = _randn(gen, b, h, d, dtype=dtype)
        k = _randn(gen, b, s, kh, d, dtype=dtype)
        v = _randn(gen, b, s, kh, d, dtype=dtype)
        lens = torch.full((b,), s, dtype=torch.int32, device=DEVICE)
        got = fd.flash_decode(q, k, v, lens)
        want = fd.flash_decode_plain(q, k, v, lens)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        label = f"cross B={b} S={s} {h}/{kh} heads D={d} {dtype} all rows"
        check(err <= ATTN_TOL[dtype], f"flash_decode != plain at {label}: "
              f"max abs err {err}")
        qs = q[:, :, None, :]
        ks, vs = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)

        def library():
            return F.scaled_dot_product_attention(qs, ks, vs)[:, :, 0]

        bound, by, nbytes, ops = decode_bound(h, kh, d, [s] * b, dtype)
        kernel = lambda: fd.flash_decode(q, k, v, lens)  # noqa: E731
        _kernel_row(rows, "flash_decode_cross", label, time_ms(kernel),
                    time_ms(lambda: fd.flash_decode_plain(q, k, v, lens)),
                    bound, by, err, time_ms(library), device_ms(kernel),
                    kernel="flash_decode")
        print(f"  bytes {nbytes}  operations {ops}  library max abs err "
              f"vs plain {_max_abs_err(library(), want)}", flush=True)
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


def mla_decode_rows(rows: dict, gen) -> None:
    """``flash_decode_mla`` at MLA_DECODE_SHAPES against its plain
    version (2e-2 bf16 on the tensor cores, 3e-5 float32 on the CUDA
    cores; a length of 0 gives zeros), beside its two passes in plain
    PyTorch at the kernel's own plan (``mla_splits``) and SDPA over the
    concatenated keys with V zero-padded to 576; the bf16 rows go into
    the JSON line as ``flash_decode_mla``, the float32 ones as
    ``flash_decode_mla_f32``."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_decode as fd

    r, dr = fd.MLA_WIDTHS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lrng = np.random.default_rng(1)
    for b, s, h, dtype, lengths in MLA_DECODE_SHAPES:
        q_lat = _randn(gen, b, h, r, dtype=dtype)
        q_rope = _randn(gen, b, h, dr, dtype=dtype)
        ckv = _randn(gen, b, s, r, dtype=dtype)
        krope = _randn(gen, b, s, dr, dtype=dtype)
        if lengths is None:
            lens_np = lrng.integers(1, s + 1, size=b).astype(np.int32)
            lens_np[0], lens_np[-1] = s, 0      # a full and an empty cache
        else:
            lens_np = np.asarray(lengths, np.int32)
        lens = torch.from_numpy(lens_np).to(DEVICE)
        args = (q_lat, q_rope, ckv, krope, lens)
        got = fd.flash_decode_mla(*args)
        want = fd.flash_decode_mla_plain(*args)
        two_pass = fd.flash_decode_mla_split_plain(*args, sms)
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        n_split, chunk = fd.mla_splits(s, b, h, sms)
        label = (f"B={b} S={s} {h}/1 heads K={r}+{dr} V={r} {dtype} "
                 f"lengths {lens_np.min()}-{lens_np.max()} "
                 f"splits={n_split}x{chunk}")
        check(err <= ATTN_TOL[dtype], f"flash_decode_mla != plain at "
              f"{label}: max abs err {err}")
        check(bool((got[lens == 0] == 0).all()), f"flash_decode_mla at "
              f"{label}: a length of 0 does not give zeros")
        qs = torch.cat([q_lat, q_rope], dim=-1)[:, :, None]
        ks = torch.cat([ckv, krope], dim=-1)[:, None]
        vs = F.pad(ckv, (0, dr))[:, None]
        mask = (torch.arange(s, device=DEVICE)[None, :]
                < lens[:, None])[:, None, None, :]

        def library():
            return F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=mask, enable_gqa=True)[:, :, 0, :r]

        live = lens > 0
        lib_err = _max_abs_err(library()[live], want[live])
        valid = int(lens_np.sum())
        elt = 2 if dtype == "bfloat16" else 4
        nbytes = (b * h * (r + dr) + b * h * r + valid * (r + dr)) * elt \
            + 4 * b
        bound, by, _, ops = _bound_typed(
            nbytes, 2 * (2 * r + dr) * h * valid, dtype)
        kernel = lambda: fd.flash_decode_mla(*args)  # noqa: E731
        _kernel_row(rows, "flash_decode_mla" + (
            "" if dtype == "bfloat16" else "_f32"), label, time_ms(kernel),
                    time_ms(lambda: fd.flash_decode_mla_plain(*args)),
                    bound, by, err, time_ms(library), device_ms(kernel),
                    kernel="flash_decode_mla")
        print(f"  bytes {nbytes}  operations {ops}  two passes at the plan "
              f"max abs err vs kernel {_max_abs_err(got, two_pass)}  "
              f"library (V padded to {r + dr}) max abs err vs plain "
              f"{lib_err}", flush=True)
        del q_lat, q_rope, ckv, krope, got, want, two_pass, qs, ks, vs


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
            d = re.search(r"ILi(\d+)E((?:Lb[01]E)*)", name)
            mla = re.search(r"mla_[a-z0-9_]*[a-z0-9]", name)
            label = (f"D={d.group(1)}" if d is not None
                     else mla.group(0) + ("<bf16>" if "bfloat16" in name
                                          and "combine" in name else "")
                     if mla is not None else f"{name[:48]}...")
            # the bool template arguments after D: the window, then (the
            # float32 forward) the statistics write
            flags = re.findall(r"Lb([01])E", d.group(2)) if d else []
            for flag, word in zip(flags, (" window", " stats")):
                label += word if flag == "1" else ""
            kind = re.search(r"(dq|dkv|delta)_kernel", name)
            if kind is not None:
                label = (f"{kind.group(0)} {label}" if d is not None
                         else kind.group(0))
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


#: the lse rows' kernels, launched on the path by (e) (the kvseq decode,
#: float32)
SEQ_ROWS = {"flash_decode_lse": "flash_decode",
            "flash_decode_lse_f32": "flash_decode",
            "flash_decode_mla_lse": "flash_decode_mla",
            "flash_decode_mla_lse_f32": "flash_decode_mla"}
#: the attention kernels a launcher's model runs (MLA decodes on its own
#: kernel; an ssm model runs none)
ATTENTION_KERNELS = ("flash_attention", "flash_decode")
MLA_KERNELS = ("flash_attention", "flash_decode_mla")


def cli_run(argv: list[str] = CLI_ARGS,
            kernels: tuple[str, ...] = ATTENTION_KERNELS) -> dict:
    """The entry point as users run it, in-process, with the launch
    counts set to 0 just before and read just after: 8 requests of 16
    tokens served, the attention kernels of ``kernels`` launched and the
    others not, the power compile's sweep kernels launched on the card
    and its 10 replayed periods without a miss."""
    from repro_torch.launch import serve as launch

    _reset_counts()
    tic = time.perf_counter()
    out = launch.main(list(argv))
    wall = time.perf_counter() - tic
    counts = _counts()
    arch = argv[argv.index("--arch") + 1]
    print(f"serve cli: {' '.join(argv)}: wall {wall:.3f} s  launches "
          f"{json.dumps(counts)}", flush=True)
    done = out["done"]
    check(len(done) == 8 and all(len(r.generated) == 16 and not
                                 r.truncated for r in done),
          f"the launcher ({arch}) did not serve 8 requests of 16 tokens")
    for name in ("flash_attention", "flash_decode", "flash_decode_mla"):
        if name in kernels:
            check(counts[name] > 0, f"kernel {name} was not launched by "
                  f"the {arch} launcher")
        else:
            check(counts[name] == 0, f"the {arch} launcher launched {name}")
    for name in DP_KERNELS:
        check(counts[name] > 0, f"the {arch} launcher's power compile did "
              f"not launch {name} on the card")
    check(out["schedule"] is not None, "no power schedule at 30 Hz")
    check(out["replay"]["deadline_misses"] == 0
          and len(out["replay"]["ledgers"]) == 10,
          f"the {arch} launcher's 10 replayed periods missed a deadline")
    return counts


def tiled_plain_attention(q, k, v, *, causal: bool = True,
                          q_offset: int = 0, window: int = 0):
    """The prefill kernels' algorithm in plain PyTorch: an online
    softmax over K/V tiles of 64 keys (both kernels' tile) with a
    float32 ``(m, l, acc)`` carry, the ``0.5·NEG_INF`` clamp on both
    maxima, ``l`` summing the unrounded ``p`` and ``p`` rounded to V's
    dtype against the running maximum before ``P·V``.  It differs from
    ``flash_attention_plain`` (one softmax over all keys) only in where
    ``p`` is rounded, so the two bound what rounding alone moves; it is
    the reference's ``flash_attention_jnp`` at a 64-key chunk."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    B, H, Sq, D = q.shape
    g = H // k.shape[1]
    Sk = k.shape[2]
    kf = k.float().repeat_interleave(g, dim=1)
    vt = v.repeat_interleave(g, dim=1)
    qf = q.float()
    scale = fa.softmax_scale(D)
    keep = fa._keep_mask(Sq, Sk, q_offset, causal, window, q.device)
    m = torch.full((B, H, Sq, 1), fa.NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, fa.F32_BLOCK_KEYS):
        k1 = min(k0 + fa.F32_BLOCK_KEYS, Sk)
        s = torch.matmul(qf, kf[:, :, k0:k1].transpose(-1, -2)) * scale
        if keep is not None:
            s = torch.where(keep[:, k0:k1], s,
                            torch.full_like(s, fa.NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_sub = m_new.clamp_min(0.5 * fa.NEG_INF)
        p = torch.exp(s - m_sub)
        corr = torch.exp(m.clamp_min(0.5 * fa.NEG_INF) - m_sub)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v.dtype).float(),
                                        vt[:, :, k0:k1].float())
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


@contextlib.contextmanager
def launches_by_use(uses: dict, cross_rows: int):
    """For the duration, add the launches that each call of
    ``ops.flash_attention`` and ``ops.flash_decode`` makes (the rise of
    its wrapper's count over the call) to ``uses["<counter> <use>"]``.
    The use comes from the call's shapes: a prefill is ``self`` (causal),
    ``encoder`` (non-causal, as many queries as keys) or ``cross``
    (non-causal, fewer queries than keys); a decode is ``cross`` over a
    cache of ``cross_rows`` rows and ``self`` over any other."""
    from repro_torch.kernels import ops

    def tallied(name, fn, use_of):
        def call(*args, **kwargs):
            before = _counts()[name]
            out = fn(*args, **kwargs)
            key = f"{name} {use_of(*args, **kwargs)}"
            uses[key] = uses.get(key, 0) + _counts()[name] - before
            return out
        return call

    def prefill_use(q, k, v, *, causal=True, **_):
        return ("self" if causal else "encoder" if q.shape[2] == k.shape[2]
                else "cross")

    def decode_use(q, k, v, length):
        return "cross" if k.shape[1] == cross_rows else "self"

    saved = ops.flash_attention, ops.flash_decode
    ops.flash_attention = tallied("flash_attention", ops.flash_attention,
                                  prefill_use)
    ops.flash_decode = tallied("flash_decode", ops.flash_decode, decode_use)
    try:
        yield
    finally:
        ops.flash_attention, ops.flash_decode = saved


@contextlib.contextmanager
def plain_attention(n_split: int | None = None):
    """Route the transformer's attention through the kernels' plain
    versions (on the same card tensors) for the duration; with
    ``n_split``, through the kernels' algorithms in plain PyTorch
    instead: prefill over 64-key tiles (``tiled_plain_attention``) and
    decode in two passes over ``n_split`` chunks (MLA's over the chunks
    of its kernels' own plan, ``mla_splits``)."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import ops

    saved = ops.flash_attention, ops.flash_decode, ops.flash_decode_mla
    ops.flash_attention = fa.flash_attention_plain
    ops.flash_decode = fd.flash_decode_plain
    ops.flash_decode_mla = fd.flash_decode_mla_plain
    if n_split is not None:
        def two_pass(q, k, v, length):
            return fd.flash_decode_split_plain(q, k, v, length, n_split)

        def mla_two_pass(q_lat, q_rope, ckv, krope, length):
            return fd.flash_decode_mla_split_plain(
                q_lat, q_rope, ckv, krope, length,
                torch.cuda.get_device_properties(0).multi_processor_count)

        ops.flash_attention = tiled_plain_attention
        ops.flash_decode = two_pass
        ops.flash_decode_mla = mla_two_pass
    try:
        yield
    finally:
        ops.flash_attention, ops.flash_decode, ops.flash_decode_mla = saved


def parity_run(dtype: str, arch: str = ARCH,
               n_prompts: int = PARITY_PROMPTS,
               prompt_len: int = PARITY_LEN,
               limit: float | None = None) -> float:
    """Kernel path against plain path: the same seeded weights in
    ``dtype``, the same prompts, prefill + PARITY_STEPS decode steps, the
    kernel path's greedy tokens fed to all.  Beside it, and not held to
    the limit, the floor: the plain path against the kernels' algorithms
    in plain PyTorch (prefill over 64-key tiles, decode in two passes at
    the kernel's split count), which differ only in where p is rounded;
    and the kernel path against that tiled plain path.  Returns the
    floor and the kernel-path prefill's ``flash_attention`` launches
    (the counts set to 0 just before that prefill, read just after)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models.transformer import (
        decode_step,
        init_params,
        prefill,
    )

    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    limit = PARITY_LIMIT[dtype] if limit is None else limit
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                         DEVICE)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (n_prompts, prompt_len))).to(DEVICE)
    cache = prompt_len + PARITY_STEPS
    # the rows decode reads: the cache, or hymba's ring of `window` rows
    rows = cfg.window if cfg.family == "hybrid" else cache
    n_split = fd.decode_splits(
        rows, torch.cuda.get_device_properties(0).multi_processor_count)
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
    worst, floor, tiled, same, total = 0.0, 0.0, 0.0, 0, 0
    over = []                    # steps past the limit, held after the print
    for step in range(PARITY_STEPS + 1):
        diff = float((lk - lp).abs().max())
        scale = float(lk.abs().max())
        worst = max(worst, diff / scale)
        floor = max(floor, float((lf - lp).abs().max()) / scale)
        tiled = max(tiled, float((lk - lf).abs().max()) / scale)
        if diff > limit * scale:
            over.append(f"step {step}: max |diff| {diff} > {limit} x "
                        f"{scale}")
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
    print(f"serve parity: {arch} {dtype}, {n_prompts} prompts of "
          f"{prompt_len} tokens, prefill + {PARITY_STEPS} decode steps: "
          f"max |dlogits| / max |logits| {worst!r} (limit {limit}); "
          f"floor (plain vs tiled plain prefill and two-pass plain "
          f"decode, {n_split} splits) {floor!r}; kernel vs tiled plain "
          f"{tiled!r}; identical greedy tokens {same}/{total}; wall "
          f"{time.perf_counter() - tic:.3f} s; kernel-path prefill "
          f"launched flash_attention {prefill_counts['flash_attention']} "
          f"times; prefill {prefill_ms:.3f} ms on the kernel path, "
          f"{plain_prefill_ms:.3f} ms on the plain path (host clock, "
          "synchronized, after one warm-up prefill)", flush=True)
    check(not over, f"kernel vs plain logits ({arch} {dtype}) at "
          + "; ".join(over))
    return floor, prefill_counts["flash_attention"]


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
    # the wrapper holds the engine through ``inner``: drop it, or the
    # cycle keeps the engine's weights on the card until a collection
    del engine._prefill_batch
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


# --------------------------------------------- hybrid and ssm phases

HYMBA_ARGS = ["--arch", HYMBA, "--requests", "8", "--max-new", "16",
              "--rate", "30", "--policy", "pfdnn"]
# prompts past hymba's window of 1024: prefill attention is cut by it,
# and the ring has wrapped before the first decode step
HYMBA_PARITY = ((2, 1536), (2, 2048))
# hymba's bf16 limit, set from its floor: the plain path and the kernels'
# algorithm in plain PyTorch, which differ only in where p is rounded,
# differ by up to 0.0532 x max |logits| at full width (random weights
# amplify any rounding through the 32 layers' normalized branches), so
# the kernel path may differ from the plain path by 1.5 x that floor
# (PERF.md section 2); float32 keeps 1e-3
HYMBA_BF16_LIMIT = 0.08
# the refill check's prompts (the first request's, then the one that
# refills the free slot; both past the window) and new tokens each
HYMBA_REFILL = (1100, 1300)
HYMBA_REFILL_NEW = 6
XLSTM = "xlstm-350m"
XLSTM_ARGS = ["--arch", XLSTM, "--requests", "8", "--max-new", "16",
              "--rate", "30", "--policy", "pfdnn"]
XLSTM_BATCH, XLSTM_PROMPT, XLSTM_STEPS = 8, 512, 16
XLSTM_PARITY = (2, 16, 4)           # prompts, tokens, decode steps
# card vs CPU port in float32, relative to the largest value: each block
# on the same inputs (only summation order differs), and end to end,
# where one float32 rounding of the embeddings alone moves the logits by
# 0.0028 x max |logits| at full width (the floor this phase prints) and
# the card differs from the CPU in every product's summation order, so
# the limit is set from that floor (PERF.md section 2)
XLSTM_BLOCK_LIMIT = 1e-4
XLSTM_LIMIT = 1e-2


def hybrid_phase() -> dict:
    """hymba-1.5b at full width: the launcher (its counts), then the
    kernel path against the plain path on prompts past the window, in
    float32 and bf16, the bf16 limit against a planted fault, and a
    mid-batch refill; returns the launcher's counts and, under
    ``flash_attention_f32``, the float32 kernel's launches in the
    float32 parity runs' kernel-path prefills."""
    tic = time.perf_counter()
    counts = cli_run(HYMBA_ARGS)
    print(f"phase hybrid cli: {time.perf_counter() - tic:.3f} s",
          flush=True)
    tic = time.perf_counter()
    floors, f32_launches = [], 0
    for dtype in PARITY_LIMIT:
        limit = HYMBA_BF16_LIMIT if dtype == "bfloat16" else None
        for n, length in HYMBA_PARITY:
            floor, launched = parity_run(dtype, HYMBA, n, length, limit)
            if dtype == "bfloat16":
                floors.append(floor)
            else:
                f32_launches += launched
    print(f"hybrid parity: {HYMBA} bf16 floor (plain vs tiled plain "
          f"prefill and two-pass plain decode) {max(floors)!r} against "
          f"the limit {HYMBA_BF16_LIMIT}", flush=True)
    window_fault_run(*HYMBA_PARITY[-1])
    print(f"phase hybrid parity: {time.perf_counter() - tic:.3f} s",
          flush=True)
    tic = time.perf_counter()
    hybrid_refill_check()
    print(f"phase hybrid refill: {time.perf_counter() - tic:.3f} s",
          flush=True)
    tic = time.perf_counter()
    hybrid_profile()
    print(f"phase hybrid profile: {time.perf_counter() - tic:.3f} s",
          flush=True)
    return {**counts, "flash_attention_f32": f32_launches}


def _hymba(dtype: str):
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_config(HYMBA), dtype=dtype)
    return cfg, init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)


def window_fault_run(n_prompts: int, prompt_len: int) -> None:
    """A planted fault the bf16 limit must catch: hymba's kernel path
    with the window dropped from every prefill attention call (each row
    then sees every earlier key), against the plain path, on the parity
    run's prompts and seed-0 weights, prefill + PARITY_STEPS decode
    steps (the kernel path's greedy tokens fed to both)."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import decode_step, prefill

    cfg, params = _hymba("bfloat16")
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (n_prompts, prompt_len))).to(DEVICE)
    cache = prompt_len + PARITY_STEPS

    def no_window(q, k, v, **kw):
        return fa.flash_attention(q, k, v, **{**kw, "window": 0})

    saved, ops.flash_attention = ops.flash_attention, no_window
    try:
        lk, sk = prefill(params, cfg, {"tokens": toks}, cache)
    finally:
        ops.flash_attention = saved
    with plain_attention():
        lp, sp = prefill(params, cfg, {"tokens": toks}, cache)
    worst = 0.0
    for step in range(PARITY_STEPS + 1):
        worst = max(worst, float((lk - lp).abs().max())
                    / float(lk.abs().max()))
        if step == PARITY_STEPS:
            break
        tk = lk.argmax(-1)
        lk, sk = decode_step(params, cfg, sk, tk)
        with plain_attention():
            lp, sp = decode_step(params, cfg, sp, tk)
    print(f"hybrid parity: planted fault (the bf16 kernel path's prefill "
          f"ignores the window), {n_prompts} prompts of {prompt_len} "
          f"tokens, prefill + {PARITY_STEPS} decode steps: max |dlogits| "
          f"/ max |logits| {worst!r} against the limit "
          f"{HYMBA_BF16_LIMIT}", flush=True)
    check(worst > HYMBA_BF16_LIMIT, f"the bf16 limit {HYMBA_BF16_LIMIT} "
          f"passes a prefill that ignores the window ({worst})")


def hybrid_refill_check() -> None:
    """A mid-batch refill of a hymba slot (``refill_check``): both
    prompts pass the window, so both rings have wrapped."""
    cfg, params = _hymba("float32")
    refill_check("hybrid", cfg, params, HYMBA_REFILL, HYMBA_REFILL_NEW)


def refill_check(phase: str, cfg, params, lengths: tuple[int, int],
                 new: int) -> None:
    """A mid-batch refill through ``ServingEngine`` on the card, in
    float32: two slots, request A prefilled alone, and one step later B
    prefilled into the free slot (``_prefill_slot`` scatters its whole
    decode state into the live batch state); after every step each live
    slot's next-token logits against its request prefilled and decoded
    alone (1e-3 x max |logits|, as the float32 parity), and the greedy
    tokens equal.  ``lengths``: the two prompts' tokens."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import decode_step, prefill
    from repro_torch.serve import EngineConfig, ServingEngine

    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab_size, n).astype(np.int32)
               for n in lengths]
    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch=2, cache_len=max(lengths) + new, eos_token=-1,
        max_new_tokens=new))
    alone = []                     # each request's logits, step by step
    for prompt in prompts:
        logits, st = prefill(params, cfg, engine._prefill_inputs(
            prompt[None]), len(prompt) + new)
        seq = [logits[0].float().cpu().numpy()]
        for _ in range(new - 1):
            tok = int(np.argmax(seq[-1])) % cfg.vocab_size
            logits, st = decode_step(params, cfg, st, torch.tensor(
                [tok], device=DEVICE))
            seq.append(logits[0].float().cpu().numpy())
        alone.append(seq)
        del st
    worst = 0.0

    def hold() -> float:
        err = 0.0
        for slot, r in engine.active.items():
            if not r.done:
                want = alone[r.rid][len(r.generated)]
                err = max(err, float(np.abs(engine._logits[slot] - want)
                                     .max() / np.abs(want).max()))
        return err

    engine.submit(list(prompts[0]))
    engine.step()
    worst = max(worst, hold())
    engine.submit(list(prompts[1]))
    engine.step()
    refilled = {s: r.rid for s, r in engine.active.items()} == {0: 0, 1: 1}
    worst = max(worst, hold())
    while engine.queue or engine.active:
        engine.step()
        worst = max(worst, hold())
    done = {r.rid: r.generated for r in engine.completed}
    want_tokens = [[int(np.argmax(x)) % cfg.vocab_size for x in seq]
                   for seq in alone]
    same = all(done.get(i) == want_tokens[i] for i in range(2))
    print(f"{phase} refill: {cfg.name} float32 ({cfg.n_layers} layers), 2 "
          f"slots, prompts {lengths[0]} and {lengths[1]} tokens (the "
          f"second prefilled into the free slot one step later: "
          f"{refilled}), {new} tokens each: every step's logits against "
          f"each request alone, max |dlogits| / max |logits| {worst!r} "
          f"(limit {PARITY_LIMIT['float32']}); tokens equal {same}",
          flush=True)
    check(refilled, f"the {cfg.name} engine did not refill the free slot "
          "mid-batch")
    check(worst <= PARITY_LIMIT["float32"] and same,
          f"a refilled {cfg.name} batch differs from its requests alone "
          f"({worst}, tokens equal {same})")


HYMBA_PROFILE = (2, 2048, 16)      # prompts, tokens, decode steps (bf16)
PROFILED_DECODE = 8                # decode steps run under the profiler
# device operations by kind, from their kernel names
DEVICE_KINDS = (("attention kernels", ("flash_attention", "decode_split",
                                       "decode_combine", "mla_split",
                                       "mla_combine")),
                ("cuBLAS products", ("gemm", "nvjet", "cutlass", "xmma")),
                ("copies", ("Memcpy", "Memset")))


def _by_kind(prof, kinds=DEVICE_KINDS) -> str:
    found = device_busy(prof)
    if found is None:
        return "device time not measured"
    sums = {kind: 0.0 for kind, _ in kinds}
    other = 0.0
    for name, (_, us) in found[1]:
        for kind, keys in kinds:
            if any(key in name for key in keys):
                sums[kind] += us
                break
        else:
            other += us
    return "; ".join(f"{kind} {us / 1e3:.3f} ms"
                     for kind, us in (*sums.items(), ("other", other)))


def hybrid_profile() -> None:
    """Where hymba-1.5b's bf16 serving time goes: a 2 x 2048-token
    prefill and decode steps over the wrapped rings, timed (host clock,
    synchronized), with ``gated_linear_scan``'s share of the prefill
    (synchronized around each call), then one prefill and
    PROFILED_DECODE decode steps under ``torch.profiler``: device busy
    and idle share, and device time by kind of operation."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as tf

    n, length, steps = HYMBA_PROFILE
    cfg = get_config(HYMBA)
    params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                            DEVICE)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         (n, length))).to(DEVICE)
    feed = torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         (steps, n))).to(DEVICE)

    def prefill():
        return tf.prefill(params, cfg, {"tokens": toks}, 0)

    prefill()                                     # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, state = prefill()
    torch.cuda.synchronize()
    pre = time.perf_counter() - t0
    walls = []
    for step in range(steps):
        t0 = time.perf_counter()
        logits, state = tf.decode_step(params, cfg, state, feed[step])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(bool(torch.isfinite(logits.float()).all()),
          f"{HYMBA}: non-finite decode logits")
    spent = [0.0]
    inner = ssm_lib.gated_linear_scan

    def timed_scan(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    tf.ssm_lib.gated_linear_scan = timed_scan
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prefill()
        torch.cuda.synchronize()
        pre_t = time.perf_counter() - t0
    finally:
        tf.ssm_lib.gated_linear_scan = inner
    med = statistics.median(walls)
    print(f"hybrid serve: {HYMBA} bf16, {n} x {length} prompt tokens: "
          f"prefill {pre * 1e3:.3f} ms ({n * length / pre:.1f} tokens/s), "
          f"of it gated_linear_scan {spent[0] * 1e3:.3f} ms of a "
          f"{pre_t * 1e3:.3f} ms synchronized prefill "
          f"({spent[0] / pre_t:.4f}); decode step over the wrapped rings "
          f"median {med * 1e3:.3f} ms over {steps} (min "
          f"{min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}): "
          f"{n / med:.1f} decode tokens/s", flush=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, state = prefill()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _print_busy("profile hybrid prefill", prof, wall * 1e6)
    print(f"profile hybrid prefill by kind: {_by_kind(prof)}", flush=True)
    _print_host("profile hybrid prefill", prof)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for step in range(PROFILED_DECODE):
            _, state = tf.decode_step(params, cfg, state,
                                      feed[step % steps])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _print_busy(f"profile hybrid decode ({PROFILED_DECODE} steps)", prof,
                wall * 1e6)
    print(f"profile hybrid decode by kind ({PROFILED_DECODE} steps): "
          f"{_by_kind(prof)}", flush=True)
    _print_host(f"profile hybrid decode ({PROFILED_DECODE} steps)", prof)


def _print_host(label: str, prof, rows: int = 12) -> None:
    """The host's time by operator in a profile (self CPU time, largest
    first): where a host-bound loop spends its wall."""
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    for e in ops[:rows]:
        print(f"{label} host: {e.count:7d} x {e.self_cpu_time_total / 1e3:10.3f}"
              f" ms self CPU  {e.key[:80]}", flush=True)


def ssm_phase() -> dict:
    """xlstm-350m at full width: the launcher (no kernel of the table in
    the engine), prefill and decode-step times with ``slstm_scan``'s
    share, and the card against the CPU port on a few tokens in float32
    (no kernel on either side: cuBLAS and the plain scans)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as tf

    tic = time.perf_counter()
    counts = cli_run(XLSTM_ARGS, kernels=())
    print(f"phase ssm cli: {time.perf_counter() - tic:.3f} s", flush=True)

    cfg = get_config(XLSTM)
    params = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                            DEVICE)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (XLSTM_BATCH, XLSTM_PROMPT))).to(DEVICE)
    feed = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (XLSTM_STEPS, XLSTM_BATCH))).to(DEVICE)
    spent = [0.0]
    inner = ssm_lib.slstm_scan

    def timed_scan(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t0
        return out

    def run(timed: bool) -> tuple[float, list[float], float, float]:
        """(prefill s, decode step walls, sLSTM s in prefill, in decode)"""
        spent[0] = 0.0
        tf.ssm_lib.slstm_scan = timed_scan if timed else inner
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state = tf.prefill(params, cfg, {"tokens": toks}, 0)
            torch.cuda.synchronize()
            pre = time.perf_counter() - t0
            pre_scan, spent[0] = spent[0], 0.0
            walls = []
            for step in range(XLSTM_STEPS):
                t0 = time.perf_counter()
                logits, state = tf.decode_step(params, cfg, state,
                                               feed[step])
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            check(bool(torch.isfinite(logits).all()),
                  f"{XLSTM}: non-finite decode logits")
            return pre, walls, pre_scan, spent[0]
        finally:
            tf.ssm_lib.slstm_scan = inner

    run(False)                                    # warm-up
    pre, walls, _, _ = run(False)
    pre_t, walls_t, pre_scan, dec_scan = run(True)
    med = statistics.median(walls)
    print(f"ssm serve: {XLSTM} bf16, batch {XLSTM_BATCH} x {XLSTM_PROMPT} "
          f"prompt tokens: prefill {pre * 1e3:.3f} ms "
          f"({XLSTM_BATCH * XLSTM_PROMPT / pre:.1f} tokens/s); decode step "
          f"median {med * 1e3:.3f} ms over {XLSTM_STEPS} (min "
          f"{min(walls) * 1e3:.3f}, max {max(walls) * 1e3:.3f}): "
          f"{XLSTM_BATCH / med:.1f} decode tokens/s", flush=True)
    n_slstm = sum(tf._is_slstm(cfg, i) for i in range(cfg.n_layers))
    print(f"ssm serve: slstm_scan ({n_slstm} of {cfg.n_layers} layers, "
          f"synchronized around each call): {pre_scan * 1e3:.3f} ms of a "
          f"{pre_t * 1e3:.3f} ms prefill ({pre_scan / pre_t:.4f}), "
          f"{dec_scan / XLSTM_STEPS * 1e3:.3f} ms of a "
          f"{statistics.median(walls_t) * 1e3:.3f} ms decode step "
          f"({dec_scan / sum(walls_t):.4f} of the steps' wall)", flush=True)
    del params, toks, feed

    # card against the CPU port: float32 weights drawn once on the CPU
    n, length, steps = XLSTM_PARITY
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    cpu_params = tf.init_params(cfg32, torch.Generator().manual_seed(0),
                                "cpu")

    def to_card(tree):
        if isinstance(tree, (list, tuple)):
            out = [to_card(t) for t in tree]
            return type(tree)(*out) if hasattr(tree, "_fields") \
                else type(tree)(out)
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.to(DEVICE)

    card_params = to_card(cpu_params)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (n, length)))
    tic = time.perf_counter()

    # 1. each block on the same inputs (the CPU's), prefill and one
    # decode step from the CPU's state: only summation order differs
    x = tf.embed_tokens(cpu_params, cfg32, toks)
    x1 = tf.embed_tokens(cpu_params, cfg32, toks[:, :1])
    block_err = 0.0
    for i in range(cfg.n_layers):
        block = tf.slstm_block if tf._is_slstm(cfg, i) else tf.mlstm_block
        lc, lg = tf.layer_params(cpu_params, i), tf.layer_params(card_params,
                                                                 i)
        yc, stc = block(lc, cfg32, x)
        yg, _ = block(lg, cfg32, x.to(DEVICE))
        dc, _ = block(lc, cfg32, x1, state=stc, decode=True)
        dg, _ = block(lg, cfg32, x1.to(DEVICE), state=to_card(stc),
                      decode=True)
        for got, want in ((yg, yc), (dg, dc)):
            block_err = max(block_err, float((got.cpu() - want).abs().max())
                            / float(want.abs().max()))
        x, x1 = yc, dc
    check(block_err <= XLSTM_BLOCK_LIMIT, f"{XLSTM} block on the card vs "
          f"the CPU on the same inputs: {block_err} > {XLSTM_BLOCK_LIMIT}")

    # 2. end to end, beside the floor: the CPU port against itself with
    # its embedding table moved by one float32 rounding (each entry x (1
    # +- 2^-24)), which measures how far the model carries one rounding
    nudge = torch.where(torch.rand(cpu_params["embed"].shape,
                                   generator=torch.Generator().manual_seed(1))
                        < 0.5, 1 - 2.0 ** -24, 1 + 2.0 ** -24)
    nudged = dict(cpu_params, embed=cpu_params["embed"] * nudge)
    got_l, got = tf.prefill(card_params, cfg32,
                            {"tokens": toks.to(DEVICE)}, 0)
    want_l, want = tf.prefill(cpu_params, cfg32, {"tokens": toks}, 0)
    near_l, near = tf.prefill(nudged, cfg32, {"tokens": toks}, 0)
    worst, floor = 0.0, 0.0
    for step in range(steps + 1):
        scale = float(want_l.abs().max())
        worst = max(worst, float((got_l.cpu() - want_l).abs().max()) / scale)
        floor = max(floor, float((near_l - want_l).abs().max()) / scale)
        if step == steps:
            break
        nxt = want_l.argmax(-1)
        got_l, got = tf.decode_step(card_params, cfg32, got, nxt.to(DEVICE))
        want_l, want = tf.decode_step(cpu_params, cfg32, want, nxt)
        near_l, near = tf.decode_step(nudged, cfg32, near, nxt)
    print(f"ssm parity: {XLSTM} float32 on the card against the CPU port, "
          f"{n} prompts of {length} tokens: each of {cfg.n_layers} blocks "
          f"on the same inputs (prefill and a decode step) max |dy| / max "
          f"|y| {block_err!r} (limit {XLSTM_BLOCK_LIMIT}); end to end, "
          f"prefill + {steps} decode steps, max |dlogits| / max |logits| "
          f"{worst!r}; floor (the CPU port against itself with its "
          f"embeddings moved by one rounding) {floor!r}; wall "
          f"{time.perf_counter() - tic:.3f} s", flush=True)
    check(worst <= XLSTM_LIMIT, f"{XLSTM} card vs CPU end to end: {worst} "
          f"> {XLSTM_LIMIT}")
    return counts


# ------------------------------------------- moe, vlm and audio phases

DEEPSEEK = "deepseek-v2-lite-16b"
KIMI = "kimi-k2-1t-a32b"
QWEN_VL = "qwen2-vl-72b"
WHISPER = "whisper-large-v3"
DEEPSEEK_ARGS = ["--arch", DEEPSEEK, "--requests", "8", "--max-new", "16",
                 "--rate", "30", "--policy", "pfdnn"]
WHISPER_ARGS = ["--arch", WHISPER, "--requests", "8", "--max-new", "16",
                "--rate", "30", "--policy", "pfdnn"]
# kernel vs plain runs: (prompts, tokens, decode steps)
DEEPSEEK_PARITY = (2, 1024, 8)
KIMI_PARITY = (2, 512, 4)
QWEN_VL_PARITY = (2, 512, 8)
WHISPER_PARITY = (2, 448, 8)
# depth cuts (full width): deepseek's float32 run, kimi-k2 (61 layers,
# ~19.4 B parameters a layer with its 384 experts), qwen2-vl-72b (80
# layers of ~1.76 GB in bf16) and its float32 run
DEEPSEEK_F32_LAYERS = 4
KIMI_LAYERS = 1
QWEN_VL_LAYERS = 16
QWEN_VL_F32_LAYERS = 4
QWEN_VL_IMAGE = 16                  # a 16 x 16 patch block after 8 tokens
# the float32 refills: (prompt tokens of the two requests), 6 new each
DEEPSEEK_REFILL = (300, 500)
WHISPER_REFILL = (60, 90)
REFILL_NEW = 6
MOE_PROFILE = (16, 1024, 16)        # prompts, tokens, decode steps (bf16)
MOE_PROFILED = 2                    # decode steps under the profiler
# the bf16 limit of the new families, fixed before their first chip run
# (PERF.md section 2): 1.5 x the floor measured in the same run (the
# plain path against the kernels' algorithms in plain PyTorch, with the
# MoE routes replayed), capped at 0.1 x max |logits|
BF16_FLOOR_FACTOR, BF16_LIMIT_CAP = 1.5, 0.1


def _free() -> None:
    """Return the memory of a phase's weights to the card before the
    next model is drawn."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def _model(arch: str, dtype: str, n_layers: int | None = None):
    """(config, seed-0 weights on the card) of ``arch`` at full width in
    ``dtype``, cut to ``n_layers`` where given."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg, init_params(
        cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)


@contextlib.contextmanager
def moe_routes(record: list | None = None, replay: list | None = None):
    """Record the experts ``router_topk`` picks, call by call (``record``),
    or replay recorded ones (``replay``): the path then takes the
    recorded experts and weighs them with its own router probabilities,
    renormalized as ``router_topk`` does.  MoE routing is discontinuous:
    a near-tie between the k-th and the (k+1)-th expert flips on any
    rounding difference upstream, so two paths are compared on the same
    routes."""
    import torch

    from repro_torch.models import moe

    inner = moe.router_topk
    replayed = iter(replay) if replay is not None else None

    def routed(x, w_router, dims):
        if replayed is None:
            idx, cw = inner(x, w_router, dims)
            record.append(idx)
            return idx, cw
        idx = next(replayed)
        probs = torch.softmax(x.float() @ w_router.float(), dim=-1)
        top_p = probs.gather(-1, idx)
        top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
        return idx, top_p.to(x.dtype)

    moe.router_topk = routed
    try:
        yield
    finally:
        moe.router_topk = inner


def _path(cfg, params, batch, cache: int, steps: int, contexts,
          feed=None, rt=None) -> tuple[list, list]:
    """Prefill + ``steps`` decode steps under ``contexts`` (on ``rt``'s
    mesh where given): every step's logits (float32) and the tokens fed
    (``feed``, or this path's greedy tokens)."""
    import torch

    from repro_torch.models.transformer import decode_step, prefill

    with contextlib.ExitStack() as stack:
        for ctx in contexts:
            stack.enter_context(ctx)
        logits, st = prefill(params, cfg, batch, cache, rt=rt)
        out, fed = [logits.float()], []
        for step in range(steps):
            tok = feed[step] if feed is not None else logits.argmax(-1)
            fed.append(tok)
            logits, st = decode_step(params, cfg, st, tok, rt=rt)
            out.append(logits.float())
        torch.cuda.synchronize()
    del st
    return out, fed


def _rel(a: list, b: list) -> float:
    """max over steps of max |a - b| / max |a|."""
    return max(float((x - y).abs().max()) / float(x.abs().max())
               for x, y in zip(a, b))


def family_parity(phase: str, cfg, params, batch, steps: int,
                  fault=None, fault_label: str = "") -> dict:
    """Kernel path against plain path on the same weights and prompts,
    prefill + ``steps`` decode steps, the plain path's greedy tokens fed
    to every path; a MoE model's routes are the plain path's, replayed
    (``moe_routes``).  The floor: the plain path against the kernels'
    algorithms in plain PyTorch (prefill over 64-key tiles, decode in
    two passes at the kernel's split count), which differ only in where
    p is rounded.  The limit: 1e-3 x max |logits| in float32; in bf16
    ``BF16_FLOOR_FACTOR`` x the floor, at most ``BF16_LIMIT_CAP``.  A
    MoE model also runs the kernel path with free routing (the routes
    that differ are printed, with no limit); ``fault`` (a context) plants
    a fault in the kernel path, which must then fail the limit.
    Returns the floor, the worst difference, the limit and the kernel
    path's launch counts (set to 0 just before it, read just after)."""
    import torch

    from repro_torch.kernels import flash_decode as fd

    tic = time.perf_counter()
    cache = batch["tokens"].shape[1] + steps
    n_split = fd.decode_splits(
        cache, torch.cuda.get_device_properties(0).multi_processor_count)
    moe = cfg.is_moe
    routes: list = []

    def replay():
        return [moe_routes(replay=routes)] if moe else []

    plain, feed = _path(cfg, params, batch, cache, steps,
                        [plain_attention()]
                        + ([moe_routes(record=routes)] if moe else []))
    _reset_counts()
    t0 = time.perf_counter()
    kern, _ = _path(cfg, params, batch, cache, steps, replay(), feed)
    kernel_s = time.perf_counter() - t0
    counts = _counts()
    tiled, _ = _path(cfg, params, batch, cache, steps,
                     [plain_attention(n_split)] + replay(), feed)
    worst, floor = _rel(kern, plain), _rel(tiled, plain)
    dtype = cfg.dtype
    limit = (PARITY_LIMIT["float32"] if dtype == "float32"
             else min(BF16_LIMIT_CAP, BF16_FLOOR_FACTOR * floor))
    same = sum(int((k.argmax(-1) == p.argmax(-1)).sum())
               for k, p in zip(kern, plain))
    b, s = batch["tokens"].shape
    free = ""
    if moe:
        picked: list = []
        fr, _ = _path(cfg, params, batch, cache, steps,
                      [moe_routes(record=picked)], feed)
        moved = sum(int((x.sort(-1).values != y.sort(-1).values)
                        .any(-1).sum()) for x, y in zip(picked, routes))
        total = sum(x.shape[0] for x in routes)
        free = (f"; free routing: {moved} of {total} (token, layer) "
                f"expert sets differ from the plain path's, max |dlogits| "
                f"/ max |logits| {_rel(fr, plain)!r} (no limit)")
    print(f"{phase} parity: {cfg.name} {dtype} ({cfg.n_layers} layers), "
          f"{b} prompts of {s} tokens, prefill + {steps} decode steps"
          f"{', routes replayed' if moe else ''}: max |dlogits| / max "
          f"|logits| {worst!r} (limit {limit!r}); floor (plain vs tiled "
          f"plain prefill and two-pass plain decode, {n_split} splits) "
          f"{floor!r}; identical greedy tokens {same}/{b * (steps + 1)}; "
          f"kernel path {kernel_s:.3f} s, launches {json.dumps(counts)}"
          f"{free}; wall {time.perf_counter() - tic:.3f} s", flush=True)
    check(worst <= limit, f"{phase}: kernel vs plain logits ({cfg.name} "
          f"{dtype}) {worst} > {limit}")
    if fault is not None:
        bad, _ = _path(cfg, params, batch, cache, steps,
                       [fault()] + replay(), feed)
        wrong = _rel(bad, plain)
        print(f"{phase} parity: planted fault ({fault_label}), {cfg.name} "
              f"{dtype}: max |dlogits| / max |logits| {wrong!r} against "
              f"the limit {limit!r}", flush=True)
        check(wrong > limit, f"{phase}: the limit {limit} passes a planted "
              f"fault ({fault_label}: {wrong})")
    return {"floor": floor, "worst": worst, "limit": limit,
            "counts": counts}


def _tokens(cfg, n: int, length: int, seed: int = 0):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(1, cfg.vocab_size,
                                         (n, length))).to(DEVICE)


@contextlib.contextmanager
def mla_rope_fault():
    """The planted MLA fault: the absorbed decode scores without the
    decoupled RoPE columns (``q_rope`` zeroed, so ``krope`` drops out)."""
    import torch

    from repro_torch.kernels import ops

    inner = ops.flash_decode_mla

    def no_rope(q_lat, q_rope, ckv, krope, length):
        return inner(q_lat, torch.zeros_like(q_rope), ckv, krope, length)

    ops.flash_decode_mla = no_rope
    try:
        yield
    finally:
        ops.flash_decode_mla = inner


@contextlib.contextmanager
def causal_cross_fault():
    """The planted whisper fault: prefill's cross-attention (the one
    non-causal call with fewer queries than keys) made causal."""
    from repro_torch.kernels import ops

    inner = ops.flash_attention

    def causal_cross(q, k, v, **kw):
        if q.shape[2] != k.shape[2] and not kw.get("causal", True):
            kw = {**kw, "causal": True}
        return inner(q, k, v, **kw)

    ops.flash_attention = causal_cross
    try:
        yield
    finally:
        ops.flash_attention = inner


def moe_phase() -> dict:
    """deepseek-v2-lite-16b at full width (27 layers, MLA, 64 experts
    top-6 + 2 shared, bf16): the launcher; kernel vs plain path (bf16,
    then float32 cut to DEEPSEEK_F32_LAYERS) with the MLA fault planted;
    a float32 mid-batch refill; a profiled batch-16 decode step; then
    kimi-k2-1t-a32b at full width cut to KIMI_LAYERS (384 experts top-8,
    GQA 64 / 8 at D = 112), kernel vs plain in bf16.  Returns the launch
    counts by run."""
    tic = time.perf_counter()
    counts = {"moe": cli_run(DEEPSEEK_ARGS, MLA_KERNELS)}
    print(f"phase moe cli: {time.perf_counter() - tic:.3f} s", flush=True)
    _free()
    tic = time.perf_counter()
    n, length, steps = DEEPSEEK_PARITY
    cfg, params = _model(DEEPSEEK, "bfloat16")
    toks = _tokens(cfg, n, length)
    family_parity("moe", cfg, params, {"tokens": toks}, steps,
                  mla_rope_fault, "the MLA decode drops krope from the "
                  "scores")
    print(f"phase moe parity bf16: {time.perf_counter() - tic:.3f} s",
          flush=True)
    tic = time.perf_counter()
    moe_profile(cfg, params)
    print(f"phase moe profile: {time.perf_counter() - tic:.3f} s",
          flush=True)
    del params
    _free()
    tic = time.perf_counter()
    cfg, params = _model(DEEPSEEK, "float32", DEEPSEEK_F32_LAYERS)
    f32 = family_parity("moe", cfg, params, {"tokens": toks}, steps)
    counts["moe f32"] = f32["counts"]
    refill_check("moe", cfg, params, DEEPSEEK_REFILL, REFILL_NEW)
    print(f"phase moe float32: {time.perf_counter() - tic:.3f} s",
          flush=True)
    del params
    _free()
    tic = time.perf_counter()
    n, length, steps = KIMI_PARITY
    cfg, params = _model(KIMI, "bfloat16", KIMI_LAYERS)
    kimi = family_parity("moe", cfg, params,
                         {"tokens": _tokens(cfg, n, length)}, steps)
    counts["kimi"] = kimi["counts"]
    print(f"phase moe kimi: {time.perf_counter() - tic:.3f} s", flush=True)
    del params
    _free()
    return counts


def moe_profile(cfg, params) -> None:
    """Where a deepseek-v2-lite bf16 serving step goes: MOE_PROFILE
    prompts prefilled, then decode steps at batch 16 timed (host clock,
    synchronized), the MoE FFN's share of them (synchronized around each
    call), then PROFILED_DECODE steps under ``torch.profiler`` (device
    busy, idle share, device operations a step, device time by kind, the
    MLA decode kernels' time a step and share of the busy time),
    and the same steps with the MoE FFN replaced by zeros: the
    difference in device operations is the MoE's launches a step (each
    profiled window MOE_PROFILED steps: a step launches ~10^4 device
    operations, and the profiler's events take a minute to read at
    PROFILED_DECODE steps)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import transformer as tf

    n, length, steps = MOE_PROFILE
    toks = _tokens(cfg, n, length, seed=2)
    feed = _tokens(cfg, steps, n, seed=3)
    cache = length + steps + PROFILED_DECODE + 2 * MOE_PROFILED
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, state = tf.prefill(params, cfg, {"tokens": toks}, cache)
    torch.cuda.synchronize()
    pre = time.perf_counter() - t0
    inner = tf._moe_ffn
    spent = [0.0]

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        spent[0] += time.perf_counter() - t1
        return out

    walls = []
    for step in range(steps):
        t0 = time.perf_counter()
        logits, state = tf.decode_step(params, cfg, state, feed[step])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    check(bool(torch.isfinite(logits.float()).all()),
          f"{cfg.name}: non-finite decode logits")
    tf._moe_ffn = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(PROFILED_DECODE):
            _, state = tf.decode_step(params, cfg, state, feed[step])
        torch.cuda.synchronize()
        timed_wall = time.perf_counter() - t0
    finally:
        tf._moe_ffn = inner
    med = statistics.median(walls)
    print(f"moe serve: {cfg.name} bf16, {n} x {length} prompt tokens: "
          f"prefill {pre * 1e3:.3f} ms ({n * length / pre:.1f} tokens/s); "
          f"decode step at batch {n} median {med * 1e3:.3f} ms over "
          f"{steps} (min {min(walls) * 1e3:.3f}, max "
          f"{max(walls) * 1e3:.3f}): {n / med:.1f} decode tokens/s; the "
          f"MoE FFN {spent[0] * 1e3:.3f} ms of {PROFILED_DECODE} "
          f"synchronized steps of {timed_wall * 1e3:.3f} ms "
          f"({spent[0] / timed_wall:.4f})", flush=True)
    ops_a_step = {}
    for label, ffn in (("decode", inner),
                       ("decode without the MoE FFN",
                        lambda p, c, x, rt=None: torch.zeros_like(x))):
        tf._moe_ffn = ffn
        try:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for step in range(MOE_PROFILED):
                    _, state = tf.decode_step(params, cfg, state,
                                              feed[step])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            tf._moe_ffn = inner
        found = device_busy(prof)
        ops_a_step[label] = (None if found is None else
                             sum(k for _, (k, _) in found[1])
                             / MOE_PROFILED)
        _print_busy(f"profile moe {label} ({MOE_PROFILED} steps)", prof,
                    wall * 1e6)
        print(f"profile moe {label} by kind: {_by_kind(prof)}", flush=True)
        if label == "decode":
            _print_host(f"profile moe {label}", prof)
        if label == "decode" and found is not None:
            mla = [(k, us) for name, (k, us) in found[1]
                   if "mla_split" in name or "mla_combine" in name]
            mla_us = sum(us for _, us in mla)
            print(f"profile moe decode: MLA decode kernels "
                  f"{sum(k for k, _ in mla)} launches, "
                  f"{mla_us / MOE_PROFILED / 1e3:.5f} ms a step, "
                  f"{mla_us / found[0]:.5f} of the device busy time",
                  flush=True)
    full, bare = ops_a_step["decode"], ops_a_step["decode without the MoE FFN"]
    moe_ops = "not measured" if None in (full, bare) else f"{full - bare:.1f}"
    print(f"moe serve: device operations a decode step {full}, without the "
          f"MoE FFN {bare}: the MoE's {moe_ops} a step", flush=True)


def _mrope_grid(n: int, length: int, side: int):
    """M-RoPE grids ``[3, n, length]`` of a prompt with a stub image: 8
    text tokens, a ``side`` x ``side`` patch block (temporal position 8,
    heights and widths 8 + row, 8 + column), then text from the block's
    largest position + 1, as Qwen2-VL numbers them."""
    import torch

    t = torch.arange(length)
    grid = torch.stack([t, t, t])
    start, patches = 8, side * side
    rows = torch.arange(patches) // side
    cols = torch.arange(patches) % side
    grid[0, start:start + patches] = start
    grid[1, start:start + patches] = start + rows
    grid[2, start:start + patches] = start + cols
    rest = length - start - patches
    grid[:, start + patches:] = start + side + torch.arange(rest)
    return grid[:, None].expand(3, n, length).contiguous().to(DEVICE)


def vlm_phase() -> dict:
    """qwen2-vl-72b at full width, cut to QWEN_VL_LAYERS (bf16) and
    QWEN_VL_F32_LAYERS (float32): kernel vs plain path on prompts whose
    M-RoPE grids carry a stub image block; text-only grids against the
    same model with plain RoPE, which must be equal bit for bit."""
    import torch

    from repro_torch.models.transformer import decode_step, prefill

    counts = {}
    n, length, steps = QWEN_VL_PARITY
    for dtype, layers in (("bfloat16", QWEN_VL_LAYERS),
                          ("float32", QWEN_VL_F32_LAYERS)):
        tic = time.perf_counter()
        cfg, params = _model(QWEN_VL, dtype, layers)
        toks = _tokens(cfg, n, length)
        batch = {"tokens": toks,
                 "positions": _mrope_grid(n, length, QWEN_VL_IMAGE)}
        got = family_parity("vlm", cfg, params, batch, steps)
        counts["vlm" if dtype == "bfloat16" else "vlm f32"] = got["counts"]
        if dtype == "bfloat16":
            plain_rope = dataclasses.replace(cfg, mrope_sections=())
            a, sa = prefill(params, cfg, {"tokens": toks}, length + 2)
            b, sb = prefill(params, plain_rope, {"tokens": toks},
                            length + 2)
            same = [bool(torch.equal(a, b))]
            for _ in range(2):
                tok = a.argmax(-1)
                a, sa = decode_step(params, cfg, sa, tok)
                b, sb = decode_step(params, plain_rope, sb, tok)
                same.append(bool(torch.equal(a, b)))
            print(f"vlm text grid: {cfg.name} bf16, text-only M-RoPE grids "
                  f"against plain RoPE on the same weights, prefill + 2 "
                  f"decode steps, logits equal bit for bit: {same}",
                  flush=True)
            check(all(same), "text-only M-RoPE grids differ from plain "
                  "RoPE on the card")
            del sa, sb
        print(f"phase vlm {dtype}: {time.perf_counter() - tic:.3f} s",
              flush=True)
        del params
        _free()
    return counts


def audio_phase() -> dict:
    """whisper-large-v3 at full width (32 encoder and 32 decoder layers,
    1500 frames): the launcher (zero frames, as the engine gives them);
    kernel vs plain path on seeded random frames in bf16, with the
    causal-cross-attention fault planted, and in float32; the encoder's
    share of a prefill; a float32 mid-batch refill."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf

    tic = time.perf_counter()
    uses: dict = {}
    with launches_by_use(uses, get_config(WHISPER).encoder_seq):
        counts = {"audio": cli_run(WHISPER_ARGS, ATTENTION_KERNELS)}
    print(f"serve cli: {WHISPER} launches by use {json.dumps(uses)}",
          flush=True)
    for name in ("flash_attention", "flash_decode"):
        check(sum(n for key, n in uses.items() if key.startswith(name))
              == counts["audio"][name], f"the {WHISPER} launcher's {name} "
              f"launches by use {uses} do not add up to its count")
    for key in ("flash_attention encoder", "flash_attention self",
                "flash_attention cross", "flash_decode self",
                "flash_decode cross"):
        check(uses.get(key, 0) > 0, f"the {WHISPER} launcher launched no "
              f"{key} attention")
    counts["audio"].update(uses)
    print(f"phase audio cli: {time.perf_counter() - tic:.3f} s", flush=True)
    _free()
    n, length, steps = WHISPER_PARITY
    for dtype in ("bfloat16", "float32"):
        tic = time.perf_counter()
        cfg, params = _model(WHISPER, dtype)
        gen = torch.Generator(device=DEVICE).manual_seed(1)
        frames = _randn(gen, n, cfg.encoder_seq, cfg.d_model, dtype=dtype)
        batch = {"tokens": _tokens(cfg, n, length),
                 "encoder_frames": frames}
        if dtype == "bfloat16":
            family_parity("audio", cfg, params, batch, steps,
                          causal_cross_fault, "prefill's cross-attention "
                          "made causal")
            inner, spent = tf._encode_audio, [0.0]

            def timed(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = inner(*args, **kwargs)
                torch.cuda.synchronize()
                spent[0] += time.perf_counter() - t0
                return out

            tf.prefill(params, cfg, batch, length)       # warm
            tf._encode_audio = timed
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tf.prefill(params, cfg, batch, length)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                tf._encode_audio = inner
            print(f"audio serve: {cfg.name} bf16, {n} x {length} prompt "
                  f"tokens over {cfg.encoder_seq} frames: synchronized "
                  f"prefill {wall * 1e3:.3f} ms, of it the encoder "
                  f"{spent[0] * 1e3:.3f} ms ({spent[0] / wall:.4f})",
                  flush=True)
        else:
            got = family_parity("audio", cfg, params, batch, steps)
            counts["audio f32"] = got["counts"]
            refill_check("audio", cfg, params, WHISPER_REFILL, REFILL_NEW)
        print(f"phase audio {dtype}: {time.perf_counter() - tic:.3f} s",
              flush=True)
        del params, frames, batch
        _free()
    return counts


def families_phase() -> dict:
    """The moe, vlm and audio phases; their launch counts by run."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    tic = time.perf_counter()
    counts = moe_phase()
    print(f"phase moe: {time.perf_counter() - tic:.3f} s", flush=True)
    tic = time.perf_counter()
    counts.update(vlm_phase())
    print(f"phase vlm: {time.perf_counter() - tic:.3f} s", flush=True)
    tic = time.perf_counter()
    counts.update(audio_phase())
    print(f"phase audio: {time.perf_counter() - tic:.3f} s", flush=True)
    print(f"families: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return counts


# ---------------------------------------------------- training phase

# the launcher at full width: tinyllama-1.1b (22 layers, d 2048, bf16,
# remat on), 8 sequences of 2048 tokens, 6 steps, at lr 3e-5: from
# this init, at the launcher's default of 3e-3 (the reference's, chosen
# for --reduced runs) and at 3e-4 the loss swings above its start in
# bf16 and float32 alike (TRAIN_LR_SWEEP prints it; PERF.md §6)
TRAIN_ARGS = ["--arch", ARCH, "--batch", "8", "--seq", "2048",
              "--steps", "6", "--lr", "3e-5"]
# (dtype, lr) of the full-width trajectories printed beside the
# launcher's, through the same train step
TRAIN_LR_SWEEP = (("bfloat16", 3e-3), ("float32", 3e-4))
# one full-width bf16 step, kernel path vs plain attention: loss and
# gradient norm (their gradients agree to the bf16 level, leaf by leaf)
TRAIN_FULL_TOL = 1e-3
# (label, (b, h, kh, sq, sk, d, causal, q_offset, window, dtype)): the
# backward kernel at tinyllama's training shape in bf16 (the JSON row)
# and float32, hymba-1.5b's window (WINDOW_SHAPES' first row), whisper's
# encoder and cross-attention, MLA's head of 192 (deepseek-v2-lite's
# prefill row); then its edges: Sq and Sk off the tile grid with
# q_offset > 0, GQA group 1 at D = 128 and group 8, rows that see no key
# (q_offset < 0), window 1, a window off the tile grid over Sq < Sk
BWD_SHAPES = (
    ("tinyllama", (8, 32, 4, 2048, 2048, 64, True, 0, 0, "bfloat16")),
    ("tinyllama", (8, 32, 4, 2048, 2048, 64, True, 0, 0, "float32")),
    ("hymba window", (2, 25, 5, 2048, 2048, 64, True, 0, 1024,
                      "bfloat16")),
    ("whisper encoder", (2, 20, 20, 1500, 1500, 64, False, 0, 0,
                         "bfloat16")),
    ("whisper cross", (2, 20, 20, 448, 1500, 64, False, 0, 0, "bfloat16")),
    ("mla", (2, 16, 16, 1024, 1024, 192, True, 0, 0, "bfloat16")),
    ("mla", (1, 4, 4, 300, 300, 192, True, 0, 0, "float32")),
    ("edge", (2, 8, 2, 300, 333, 64, True, 33, 0, "bfloat16")),
    ("edge", (2, 8, 2, 300, 333, 64, True, 33, 0, "float32")),
    ("edge", (2, 8, 8, 257, 257, 128, True, 0, 0, "bfloat16")),
    ("edge", (2, 8, 8, 257, 257, 128, True, 0, 0, "float32")),
    ("edge", (1, 8, 1, 200, 200, 64, True, 0, 0, "float32")),
    ("edge", (1, 4, 2, 100, 60, 64, True, -40, 0, "bfloat16")),
    ("edge", (1, 4, 2, 100, 60, 16, True, -40, 0, "float32")),
    ("edge", (1, 10, 2, 300, 300, 64, True, 0, 1, "float32")),
    ("edge", (1, 10, 2, 300, 1000, 48, True, 700, 333, "bfloat16")),
    ("edge", (1, 10, 2, 300, 1000, 96, True, 700, 333, "float32")),
    # tensor parallelism's local heads: tinyllama-1.1b on "model" = 4,
    # deepseek-v2-lite's MLA on "model" = 2
    ("tp tinyllama", (8, 8, 1, 2048, 2048, 64, True, 0, 0, "bfloat16")),
    ("tp tinyllama", (8, 8, 1, 2048, 2048, 64, True, 0, 0, "float32")),
    ("tp mla", (2, 8, 8, 1024, 1024, 192, True, 0, 0, "bfloat16")),
    # hymba-1.5b on "model" = 4, rank 0: 10 query heads over 2 KV heads
    ("tp hymba window", (2, 10, 2, 2048, 2048, 64, True, 0, 1024,
                         "bfloat16")),
    ("tp hymba window", (2, 10, 2, 2048, 2048, 64, True, 0, 1024,
                         "float32")),
)
# float32: within 1e-4 x the largest |gradient| of the three (sums in
# another order); bf16: the kernel's error against the float32 plain
# backward (over the largest |gradient|) within 1.5 x the larger of two
# floors measured at the same row: the plain backward's in bf16 (the
# gradients' rounding to bf16) and the kernel's algorithm in plain
# PyTorch (``flash_attention_bwd_bf16_plain``: P and dS rounded to bf16
# as product operands); the limit is capped at 0.05
BWD_F32_TOL, BWD_BF16_FACTOR, BWD_BF16_CAP = 1e-4, 1.5, 0.05
# one reduced float32 training step of the families whose attention the
# kernels reach with another mask or head: (arch, config overrides);
# hymba's window and whisper's encoder cross several 64-key tiles, and
# deepseek-v2-lite keeps MLA's real heads (128 + 64 = 192)
TRAIN_FAMILIES = (("hymba-1.5b", {"window": 100}),
                  ("whisper-large-v3", {"encoder_seq": 150}),
                  ("deepseek-v2-lite-16b", {"head_dim": 128,
                                            "rope_head_dim": 64}))
TRAIN_FAMILY_SEQ = 300
TRAIN_GRAD_TOL = 1e-4
# the device time of a training step by kind, from kernel names
TRAIN_KINDS = (("attention forward", ("flash_attention_f32_kernel",
                                      "flash_attention_wgmma_kernel")),
               ("attention backward", ("dq_kernel", "dkv_kernel",
                                       "delta_kernel")),
               ("cuBLAS products", ("gemm", "nvjet", "cutlass", "xmma")),
               ("copies", ("Memcpy", "Memset")))


def bwd_bound(b, h, kh, sq, sk, d, causal, q_offset, window, dtype
              ) -> tuple[float, str, int, int]:
    """q, the output and its cotangent read and dq written once, k and v
    read and dk and dv written once, the forward's float32 row
    statistics (two a row) read once; 10·D operations (five products:
    QKᵀ again, dO Vᵀ, Pᵀ dO, dS K, dSᵀ Q) per (query, key) pair the mask
    keeps, 2.5 x the forward's."""
    elt = 2 if dtype == "bfloat16" else 4
    nbytes = (4 * b * h * sq * d + 4 * b * kh * sk * d) * elt \
        + 8 * b * h * sq
    fwd_ops = attention_bound(b, h, kh, sq, sk, d, causal, q_offset, dtype,
                              window)[3]
    return _bound_typed(nbytes, fwd_ops * 5 // 2, dtype)


def bwd_rows(rows: dict, gen) -> None:
    """``flash_attention_bwd`` at BWD_SHAPES against its plain version,
    with the forward's saved statistics (the training route) and
    without them (its own statistics pass), each the same bits on a
    second call, with its times beside its bound, its plain version's
    and SDPA forward + backward's; at hymba's row a planted fault (the
    bf16 kernel without the window) must fail the bf16 limit."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    for label, (b, h, kh, sq, sk, d, causal, q_offset, window,
                dtype) in BWD_SHAPES:
        def randn(*shape):
            return _randn(gen, *shape, dtype=dtype)

        q, k, v = randn(b, h, sq, d), randn(b, kh, sk, d), randn(b, kh, sk, d)
        do = randn(b, h, sq, d)
        mask = dict(causal=causal, q_offset=q_offset, window=window)
        out, stats = fa._forward(q, k, v, causal, q_offset, window,
                                 with_stats=True)
        got = fa.flash_attention_bwd(do, q, k, v, out, stats=stats, **mask)
        again = fa.flash_attention_bwd(do, q, k, v, out, stats=stats,
                                       **mask)
        own = fa.flash_attention_bwd(do, q, k, v, out, **mask)
        own_again = fa.flash_attention_bwd(do, q, k, v, out, **mask)
        want = fa.flash_attention_bwd_plain(do, q, k, v, out, **mask)
        torch.cuda.synchronize()
        name = _attn_label(b, h, kh, sq, sk, d, causal, dtype) + (
            f" q_offset {q_offset}" if q_offset else "") + (
            f" window {window}" if window else "")
        check(all(torch.equal(x, y) for x, y in zip(got, again))
              and all(torch.equal(x, y) for x, y in zip(own, own_again)),
              f"flash_attention_bwd at {name}: a second call gave other "
              "bits")
        err = max(_max_abs_err(x, y) for x, y in zip(got, want))
        if dtype == "float32":
            scale = max(float(y.abs().max()) for y in want)
            rel = err / scale
            rel_own = max(_max_abs_err(x, y) for x, y in zip(own, want)) \
                / scale
            limit = BWD_F32_TOL
            detail = (f"max abs err / max |grad| {rel!r}, without saved "
                      f"statistics {rel_own!r} (limit {limit})")
        else:
            f32 = fa.flash_attention_bwd_plain(
                do.float(), q.float(), k.float(), v.float(), out.float(),
                **mask)
            scale = max(float(y.abs().max()) for y in f32)

            def rel_to_f32(grads):
                return max(_max_abs_err(x, y)
                           for x, y in zip(grads, f32)) / scale

            rel, rel_own = rel_to_f32(got), rel_to_f32(own)
            floor_round = rel_to_f32(want)
            floor_alg = rel_to_f32(fa.flash_attention_bwd_bf16_plain(
                do, q, k, v, out, stats=stats, **mask))
            limit = min(BWD_BF16_CAP,
                        BWD_BF16_FACTOR * max(floor_round, floor_alg))
            detail = (f"against the float32 backward {rel!r}, without "
                      f"saved statistics {rel_own!r}; floors: gradients "
                      f"rounded {floor_round!r}, the kernel's algorithm "
                      f"{floor_alg!r} (limit {limit!r})")
            if window:
                fault = rel_to_f32(fa.flash_attention_bwd(
                    do, q, k, v, out, stats=stats,
                    **{**mask, "window": 0}))
                print(f"bwd {label} {name}: planted fault (the bf16 kernel "
                      f"drops the window): {fault!r} against the limit "
                      f"{limit!r}", flush=True)
                check(fault > limit, "the bf16 backward's limit passes a "
                      "kernel that drops the window")
            del f32
        print(f"bwd {label} {name}: {detail}", flush=True)
        check(rel <= limit and rel_own <= limit,
              f"flash_attention_bwd != plain at {name}: {detail}")
        if q_offset < 0:
            check(all(bool((x[:, :, :-q_offset] == 0).all())
                      for x in (got[0], own[0])),
                  f"flash_attention_bwd at {name}: rows that see no key "
                  "have a gradient")
        attn_mask = None
        if window or (causal and sq != sk):
            attn_mask = fa._keep_mask(sq, sk, q_offset, causal, window,
                                      q.device)
        lq, lk, lv = (t.detach().requires_grad_(True) for t in (q, k, v))

        def library():
            o = F.scaled_dot_product_attention(
                lq, lk, lv, attn_mask=attn_mask,
                is_causal=causal and attn_mask is None, enable_gqa=True)
            torch.autograd.grad(o, (lq, lk, lv), do)

        def kernel():
            fa.flash_attention_bwd(do, q, k, v, out, stats=stats, **mask)

        def kernel_own():
            fa.flash_attention_bwd(do, q, k, v, out, **mask)

        bound, by, nbytes, ops = bwd_bound(b, h, kh, sq, sk, d, causal,
                                           q_offset, window, dtype)
        _kernel_row(rows, "flash_attention_bwd", f"{label} {name}",
                    time_ms(kernel), time_ms(
                        lambda: fa.flash_attention_bwd_plain(
                            do, q, k, v, out, **mask)),
                    bound, by, err, time_ms(library), device_ms(kernel))
        print(f"  bytes {nbytes}  operations {ops}  (SDPA: forward + "
              f"backward); without saved statistics: {time_ms(kernel_own)}"
              f" ms, device {device_ms(kernel_own)} ms", flush=True)
        if dtype == "bfloat16":
            split = {part: device_ms(kernel, only=part) for part in
                     ("delta_kernel", "dq_kernel", "dkv_kernel")}
            print(f"  device ms by kernel: {split}", flush=True)
        del q, k, v, do, out, stats, got, again, own, own_again, want, lq, \
            lk, lv
        _free()


def _loss_and_grads(params, cfg, batch):
    """(loss, gradients of every parameter leaf) of ``forward_train``,
    through the train step's own ``value_and_grad`` (which leaves no
    leaf requiring grad)."""
    from repro_torch.train.trainer import value_and_grad

    return value_and_grad(params, cfg, batch)


def _grad_err(a: list, b: list) -> float:
    """Max over leaves of max |a - b| / max |b|."""
    return max(_max_abs_err(x, y) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(a, b))


def train_launcher() -> dict:
    """``repro_torch.launch.train`` at full width as users run it, launch
    counts set to 0 just before and read just after; every loss and
    gradient norm finite, the last loss below the first, the forward
    kernel launched twice a layer a step (remat) and the backward kernel
    once; then one more step under the profiler."""
    import math

    import torch

    from repro_torch.launch import train as launch

    _free()
    train_full_parity()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    tic = time.perf_counter()
    out = launch.main(list(TRAIN_ARGS))
    wall = time.perf_counter() - tic
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    print(f"train cli: {' '.join(TRAIN_ARGS)}: wall {wall:.3f} s  launches "
          f"{json.dumps(counts)}  peak device memory {peak} B "
          f"({peak / 2**30:.2f} GiB)", flush=True)
    for m in hist:
        print(f"train step {m['step']}: loss {m['loss']!r}  grad_norm "
              f"{m['grad_norm']!r}  lr {m['lr']!r}  step_time_s "
              f"{m['step_time_s']!r}", flush=True)
    steps = len(hist)
    print(f"train steps 1-{steps - 1}: median step time "
          f"{statistics.median(m['step_time_s'] for m in hist[1:])!r} s",
          flush=True)
    check(steps == 6 and all(math.isfinite(m["loss"])
                             and math.isfinite(m["grad_norm"])
                             for m in hist),
          "the training launcher gave a non-finite loss or gradient norm")
    check(hist[-1]["loss"] < hist[0]["loss"],
          "the training launcher's loss did not fall")
    layers = 22
    check(counts["flash_attention"] == 2 * layers * steps,
          f"the forward kernel launched {counts['flash_attention']} times "
          f"in {steps} steps, not twice a layer a step")
    check(counts["flash_attention_bwd"] == layers * steps,
          f"the backward kernel launched {counts['flash_attention_bwd']} "
          f"times in {steps} steps, not once a layer a step")
    train_profile(out["params"], out["opt_state"])
    del out
    _free()
    return counts


def _full_width(dtype: str):
    """(tinyllama-1.1b at full width in ``dtype``, seed-0 weights drawn
    as the launcher draws them, its stream of 8 x 2048 tokens)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models.transformer import init_params

    cfg = dataclasses.replace(get_config(ARCH), dtype=dtype)
    params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                         DEVICE)
    return cfg, params, SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=2048, global_batch=8))


def train_full_parity() -> None:
    """One full-width bf16 step's loss and gradients on the kernel path
    against plain attention on the same card tensors."""
    import torch

    from repro_torch.train.optimizer import global_norm

    cfg, params, stream = _full_width("bfloat16")
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in stream.batch(0).items()}
    loss_k, grads_k = _loss_and_grads(params, cfg, batch)
    with plain_attention():
        loss_p, grads_p = _loss_and_grads(params, cfg, batch)
    loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    norm_k, norm_p = float(global_norm(grads_k)), float(global_norm(grads_p))
    norm_err = abs(norm_k - norm_p) / norm_p
    leaf = _grad_err(grads_k, grads_p)
    print(f"train full width: one bf16 step, kernel vs plain attention: "
          f"loss {float(loss_k)!r} / {float(loss_p)!r} (rel err "
          f"{loss_err!r}), gradient norm {norm_k!r} / {norm_p!r} (rel err "
          f"{norm_err!r}), worst leaf max |dg| / max |g| {leaf!r}; limit "
          f"{TRAIN_FULL_TOL} on the loss and the norm", flush=True)
    check(loss_err <= TRAIN_FULL_TOL and norm_err <= TRAIN_FULL_TOL,
          "a full-width training step on the kernels differs from plain "
          "attention")
    del params, grads_k, grads_p
    _free()


def train_lr_sweep() -> None:
    """The full-width loss and gradient norm of 6 steps at each
    TRAIN_LR_SWEEP (dtype, lr), 5 warmup steps as the launcher sets
    them (no check: where the launcher's learning rate comes from)."""
    import torch

    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import TrainConfig, make_train_step

    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    for dtype, lr in TRAIN_LR_SWEEP:
        cfg, params, stream = _full_width(dtype)
        tcfg = TrainConfig(optimizer=AdamWConfig(lr=lr, warmup_steps=5,
                                                 total_steps=steps))
        opt_state = adamw_init(params, tcfg.optimizer)
        step_fn = make_train_step(cfg, tcfg)
        trace = []
        for step in range(steps):
            params, opt_state, metrics = step_fn(params, opt_state,
                                                 stream.batch(step))
            trace.append((float(metrics["loss"]),
                          float(metrics["grad_norm"])))
        print(f"train lr sweep: {dtype} lr {lr}: (loss, grad_norm) by step "
              f"{trace}", flush=True)
        del params, opt_state
        _free()
    torch.cuda.synchronize()


def train_profile(params, opt_state) -> None:
    """One more full-width step (the launcher's next batch) under
    ``torch.profiler``: wall, device busy, idle share and device time
    by kind."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, make_train_step

    cfg = get_config(ARCH)
    steps = int(TRAIN_ARGS[TRAIN_ARGS.index("--steps") + 1])
    lr = float(TRAIN_ARGS[TRAIN_ARGS.index("--lr") + 1])
    step_fn = make_train_step(cfg, TrainConfig(optimizer=AdamWConfig(
        lr=lr, warmup_steps=5, total_steps=steps)))
    batch = SyntheticLMStream(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=2048, global_batch=8)).batch(
            steps)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        step_fn(params, opt_state, batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - tic) * 1e6
    _print_busy("train profile: one full-width step", prof, wall_us)
    print(f"train profile by kind: {_by_kind(prof, TRAIN_KINDS)}",
          flush=True)


def train_card_vs_cpu() -> dict:
    """Reduced float32 tinyllama, the same weights (drawn on the host)
    and batches: four train steps on the card against four on the CPU
    port; losses within 1e-5 relative, parameters within 1e-4 x max
    |p|.  Returns the card run's launch counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.models.transformer import init_params
    from repro_torch.train._tree import leaves, tree_map
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import TrainConfig, make_train_step

    cfg = get_config(ARCH).reduced()
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=3e-3, warmup_steps=2,
                                             total_steps=4))
    stream = SyntheticLMStream(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=256, global_batch=4))
    cpu = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to(DEVICE, copy=True), cpu)
    state = {"cpu": (cpu, adamw_init(cpu, tcfg.optimizer)),
             "card": (card, adamw_init(card, tcfg.optimizer))}
    step_fn = make_train_step(cfg, tcfg)
    _reset_counts()
    worst = 0.0
    for step in range(4):
        batch = stream.batch(step)
        losses = {}
        for where, (params, opt_state) in state.items():
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            state[where] = (params, opt_state)
            losses[where] = float(metrics["loss"])
        worst = max(worst, abs(losses["card"] - losses["cpu"])
                    / abs(losses["cpu"]))
    counts = _counts()
    p_err = _grad_err([t.detach().cpu() for t in leaves(state["card"][0])],
                      [t.detach() for t in leaves(state["cpu"][0])])
    print(f"train card vs cpu: reduced float32 {ARCH}, 4 steps of 4 x 256 "
          f"tokens: loss rel err {worst!r} (limit 1e-5), parameters max "
          f"|dp| / max |p| {p_err!r} (limit 1e-4); launches "
          f"{json.dumps(counts)}", flush=True)
    check(worst <= 1e-5 and p_err <= 1e-4,
          "the card's training steps differ from the CPU port's")
    check(counts["flash_attention_bwd"] == 4 * cfg.n_layers,
          "the reduced float32 run did not launch the backward kernel "
          "once a layer a step")
    return counts


def train_drill() -> None:
    """The crash-restart drill of tests/test_fault_tolerance.py on the
    card: reduced tinyllama, crash after step 7, restart from the step-6
    checkpoint; losses within 1e-5 relative and parameters within rtol
    1e-5 / atol 1e-6 of a clean run; prints whether they are
    bit-identical."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.train._tree import leaves
    from repro_torch.train.elastic import (
        CrashRequested,
        ElasticRun,
        run_elastic,
    )
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig

    cfg = get_config(ARCH).reduced()
    with tempfile.TemporaryDirectory() as tmp:
        def run(sub: str) -> ElasticRun:
            return ElasticRun(
                cfg=cfg, tcfg=TrainConfig(optimizer=AdamWConfig(
                    lr=1e-3, warmup_steps=2, total_steps=12)),
                data=DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                global_batch=4),
                ckpt_dir=pathlib.Path(tmp) / sub, ckpt_every=3)

        clean = run_elastic(run("a"), total_steps=12, device=DEVICE)
        crashed = False
        try:
            run_elastic(run("b"), total_steps=12, crash_at=7, device=DEVICE)
        except CrashRequested:
            crashed = True
        resumed = run_elastic(run("b"), total_steps=12, device=DEVICE)
    check(crashed and resumed["resumed_from"] == 7,
          "the drill did not crash after step 7 and resume at step 7")
    want = {h["step"]: h["loss"] for h in clean["history"]}
    loss_ok = all(abs(want[h["step"]] - h["loss"]) <= 1e-5 * abs(h["loss"])
                  for h in resumed["history"])
    a = [t.detach().cpu().float().numpy() for t in leaves(clean["params"])]
    b = [t.detach().cpu().float().numpy()
         for t in leaves(resumed["params"])]
    close = all(np.allclose(x, y, rtol=1e-5, atol=1e-6)
                for x, y in zip(a, b))
    same = all(torch.equal(x, y) for x, y in zip(
        leaves([clean["params"], clean["opt_state"]]),
        leaves([resumed["params"], resumed["opt_state"]]))) and all(
        want[h["step"]] == h["loss"] for h in resumed["history"])
    print(f"train drill: crash after step 7, resumed at "
          f"{resumed['resumed_from']}: losses within 1e-5 {loss_ok}, "
          f"parameters within rtol 1e-5 / atol 1e-6 {close}, bit-identical "
          f"to the clean run {same}", flush=True)
    check(loss_ok and close, "the card's crash-restart drill diverged from "
          "its clean run")


def train_families() -> None:
    """One reduced float32 training step (loss and gradients, remat on)
    of each TRAIN_FAMILIES config on the kernel path against the same
    step with the plain attention (``plain_attention``) on the card;
    then a planted fault the tolerance must catch: hymba's step with a
    backward that drops the window."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import init_params

    for arch, over in TRAIN_FAMILIES:
        cfg = get_config(arch).reduced(remat=True, **over)
        params = init_params(cfg, torch.Generator(device=DEVICE)
                             .manual_seed(0), DEVICE)
        batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in
                 SyntheticLMStream(DataConfig(
                     vocab_size=cfg.vocab_size, seq_len=TRAIN_FAMILY_SEQ,
                     global_batch=2)).batch(0).items()}
        if cfg.family == "audio":
            batch["encoder_frames"] = torch.randn(
                (2, cfg.encoder_seq, cfg.d_model), device=DEVICE,
                generator=torch.Generator(device=DEVICE).manual_seed(1))
        _reset_counts()
        loss_k, grads_k = _loss_and_grads(params, cfg, batch)
        counts = _counts()
        with plain_attention():
            loss_p, grads_p = _loss_and_grads(params, cfg, batch)
        loss_err = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
        grad_err = _grad_err(grads_k, grads_p)
        print(f"train family {arch} (reduced, {over}, 2 x "
              f"{TRAIN_FAMILY_SEQ} tokens): kernel vs plain attention: loss "
              f"rel err {loss_err!r}, gradients max |dg| / max |g| "
              f"{grad_err!r} (limit {TRAIN_GRAD_TOL}); launches "
              f"{json.dumps(counts)}", flush=True)
        check(loss_err <= 1e-5 and grad_err <= TRAIN_GRAD_TOL,
              f"{arch}: the kernel path's training step differs from the "
              "plain attention's")
        check(counts["flash_attention"] > 0
              and counts["flash_attention_bwd"] > 0,
              f"{arch}: the training step did not launch both kernels")
        if cfg.family == "hybrid":
            right = fa.flash_attention_bwd

            def no_window(*args, **kw):
                return right(*args, **{**kw, "window": 0})

            fa.flash_attention_bwd = no_window
            try:
                _, grads_f = _loss_and_grads(params, cfg, batch)
            finally:
                fa.flash_attention_bwd = right
            fault = _grad_err(grads_f, grads_p)
            print(f"train family {arch}: planted fault (the backward drops "
                  f"the window): gradients max |dg| / max |g| {fault!r} "
                  f"against the limit {TRAIN_GRAD_TOL}", flush=True)
            check(fault > TRAIN_GRAD_TOL, "the training tolerance passes a "
                  "backward that drops the window")
        del params, grads_k, grads_p
        _free()


def train_phase() -> tuple[list[dict], dict]:
    """The backward kernel's rows, the launcher at full width, the card
    against the CPU port, the drill and the families' steps; returns
    (the JSON rows, the full-width run's launch counts)."""
    import torch

    _free()
    rows: dict[str, dict] = {}
    tic = time.perf_counter()
    bwd_rows(rows, torch.Generator(device=DEVICE).manual_seed(0))
    print(f"phase train rows: {time.perf_counter() - tic:.3f} s", flush=True)
    tic = time.perf_counter()
    counts = train_launcher()
    print(f"phase train cli: {time.perf_counter() - tic:.3f} s", flush=True)
    tic = time.perf_counter()
    train_lr_sweep()
    train_card_vs_cpu()
    train_drill()
    train_families()
    print(f"phase train checks: {time.perf_counter() - tic:.3f} s",
          flush=True)
    return list(rows.values()), counts


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


# ----------------------------------------------------- service phase

SERVICE_FRACTIONS = (0.5, 0.7, 0.9)       # x max rate, every edge network
SERVICE_GOAL_NET = "squeezenet1.1"        # + a MinLatency and a ParetoFront
SERVICE_BUDGET = 1.5                      # x the network's min-E_op bound
FARM_TENANTS = {"A": 0.9, "B": 0.7}       # 4 networks each, 8 requests
THREAD_NETS = ("squeezenet1.1", "mobilenetv3-small", "resnet18")
# counters of the round scheduler as a whole: a fleet's differ from a
# solo compile's, so solo comparisons set them aside
FLEET_STATS = ("stacked_rounds", "stacked_calls", "fleet_networks")
MIB = 1 << 20


def _result_json(result, drop: tuple = ()):
    """A compile result as comparable JSON: a schedule without its host
    stats (and ``drop``), an InfeasibleGoal as it is, a frontier point
    by point."""
    if hasattr(result, "points"):
        return [(p.deadline_s, _result_json(p.schedule, drop))
                for p in result.points]
    if not hasattr(result, "solver_stats"):
        return result.to_json()
    skip = ("wall_time_s", "backend", "ilp_wall_time_s") + drop
    stats = {k: v for k, v in result.solver_stats.items() if k not in skip}
    return dataclasses.replace(result, solver_stats=stats).to_json()


def service_requests(device: str, nets=None, fractions=SERVICE_FRACTIONS,
                     goals: bool = True) -> list:
    """The fleet of the service phase: ``pfdnn`` for every edge network
    at each fraction of its max rate (3 rails of the 9-level menu), then
    a ``MinLatency`` and a ``ParetoFront(n_points=4)`` request."""
    from repro_torch.core import (
        CompilationContext,
        MinLatency,
        OrchestratorConfig,
        ParetoFront,
    )
    from repro_torch.models.edge_cnn import EDGE_NETWORKS, edge_network
    from repro_torch.service import CompileRequest

    cfg = OrchestratorConfig(device=device)
    reqs = [CompileRequest(edge_network(net), frac * max_rate(net), cfg,
                           net)
            for net in (nets or EDGE_NETWORKS) for frac in fractions]
    if goals:
        net = SERVICE_GOAL_NET
        ctx = CompilationContext(edge_network(net), network=net)
        budget = SERVICE_BUDGET * ctx.min_e_op_bound(ctx.levels)
        reqs += [CompileRequest(edge_network(net), cfg=cfg, network=net,
                                goal=MinLatency(energy_budget_j=budget)),
                 CompileRequest(edge_network(net), cfg=cfg, network=net,
                                goal=ParetoFront(n_points=4))]
    return reqs


def _label(req) -> str:
    goal = req.goal.key() if req.goal is not None \
        else f"{req.target_rate_hz / max_rate(req.network):.1f} x max"
    return f"{req.network} {goal}"


# intra-op threads of the spawned CPU-side process: it shares the host
# with the card-side compiles and the farm's workers
CPU_SIDE_THREADS = 2


def cpu_fleet() -> list:
    """The service phase's fleet compiled on the CPU (plain versions),
    as comparable JSON.  Runs in a spawned process beside the card's
    work."""
    import torch

    from repro_torch.service import CompileService

    torch.set_num_threads(CPU_SIDE_THREADS)

    with CompileService() as svc:
        return [_result_json(r)
                for r in svc.compile_many(service_requests("cpu"))]


def _dp_counts(io_before: dict, io_after: dict, before: dict,
               after: dict) -> dict:
    """DP / k-best / gather launches between two readings and the
    lanes a DP and a k-best launch carried on average."""
    d = {k: after[k] - before[k] for k in DP_KERNELS}
    d["lanes per DP launch"] = round(
        (io_after["dp_lanes"] - io_before["dp_lanes"])
        / max(d["dp_multi_stacked"], 1), 3)
    d["lanes per k-best launch"] = round(
        (io_after["kbest_lanes"] - io_before["kbest_lanes"])
        / max(d["kbest_multi_stacked"], 1), 3)
    return d


def _percentiles(results) -> str:
    lat = sorted(r.latency_s for r in results)
    p50 = statistics.quantiles(lat, n=100, method="inclusive")[49]
    p95 = statistics.quantiles(lat, n=100, method="inclusive")[94]
    return f"p50 {p50:.3f} s  p95 {p95:.3f} s"


def _farm_run(root: str, solo: dict, n_workers: int) -> dict:
    """One farm of fresh processes on the card over the disk store at
    ``root``: 8 requests from 2 tenants, each result held against the
    solo compile; returns the farm's summed counters."""
    from repro_torch.service import CompileFarm

    tic = time.perf_counter()
    with CompileFarm(root, n_workers=n_workers, batch_size=2) as farm:
        uid_req = {}
        for tenant, frac in FARM_TENANTS.items():
            reqs = service_requests(DEVICE, fractions=(frac,), goals=False)
            for uid, req in zip(farm.submit(tenant, reqs), reqs):
                uid_req[uid] = req
        results = farm.drain()
        counters = farm.counters()
    wall = time.perf_counter() - tic
    for uid, res in results.items():
        check(res.error is None, f"farm worker {res.worker}: {res.error}")
        label = _label(uid_req[uid])
        check(_result_json(res.value, FLEET_STATS) == solo[label],
              f"farm {label}: differs from the solo compile")
    by_tenant = {t: [r for r in results.values() if r.tenant == t]
                 for t in FARM_TENANTS}
    print(f"service farm: {n_workers} worker{'s' * (n_workers > 1)}, "
          f"{len(results)} results, "
          f"wall {wall:.3f} s "
          f"(process start included), {farm.n_batches} batches, fleet "
          f"{_percentiles(results.values())}; "
          + "; ".join(f"tenant {t} {_percentiles(rs)}"
                      for t, rs in by_tenant.items())
          + f"; disk hits {json.dumps(counters['disk_hits'])}", flush=True)
    return counters


def service_phase(keep: pathlib.Path | None = None) -> dict:
    """The fleet compile service on the card (see the module docstring,
    phase 10); returns the DP kernels' launches of its fleet run.  With
    ``keep``, the farm's disk store stays at ``keep / "farm"`` and the
    two-thread run's lock graph is dumped to ``keep /
    "lockcheck.jsonl"`` (``lockcheck.dump``, what
    ``PFDNN_LOCKCHECK_DUMP`` makes a process write at exit), for the
    analysis phase."""
    import gc
    import multiprocessing
    import threading

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis import lockcheck
    from repro_torch.core import compile
    from repro_torch.core.backend import get_backend
    from repro_torch.service import ArtifactStore, CompileService

    pool = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_side = pool.submit(cpu_fleet)
        reqs = service_requests(DEVICE)
        bk = get_backend(DEVICE)

        # the earlier phases hold no device memory in reference cycles:
        # a collection here frees nothing
        torch.cuda.synchronize()
        mem_in = torch.cuda.memory_allocated()
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        print(f"service memory: allocated {mem_in} B at the phase's "
              f"start, {mem0} B after a collection", flush=True)
        check(abs(mem_in - mem0) <= MIB, f"{mem_in - mem0} B of device "
              "memory were held by reference cycles of earlier phases")

        # solo: each request compiled alone on the card (no store), with
        # the collector off: a compile frees its lane mirrors itself
        solo, solo_walls = {}, {}
        io0, c0 = bk.io_counts(), _counts()
        gc.disable()
        try:
            for req in reqs:
                tic = time.perf_counter()
                out = compile(req.specs, req.resolve_goal(), cfg=req.cfg,
                              network=req.network)
                solo_walls[_label(req)] = time.perf_counter() - tic
                solo[_label(req)] = _result_json(out, FLEET_STATS)
            del out
            torch.cuda.synchronize()
            mem_solo = torch.cuda.memory_allocated()
        finally:
            gc.enable()
        solo_counts = _dp_counts(io0, bk.io_counts(), c0, _counts())
        solo_sum = sum(solo_walls.values())
        print(f"service memory: {mem_solo} B after {len(reqs)} solo "
              "compiles with the collector off", flush=True)
        check(abs(mem_solo - mem0) <= MIB, f"{len(reqs)} solo compiles "
              f"left {mem_solo - mem0} B of device memory")

        # solo through one store: the same compiles, one after another,
        # sharing master tables, transitions, prunings and resident
        # lanes (schedule cache off), so that the fleet's gain splits
        # into artifact reuse and launch merging
        store = ArtifactStore()
        io0, c0 = bk.io_counts(), _counts()
        tic = time.perf_counter()
        for req in reqs:
            out = CompileService(store=store, use_schedule_cache=False) \
                .compile(req.specs, goal=req.resolve_goal(), cfg=req.cfg,
                         network=req.network)
            check(_result_json(out, FLEET_STATS) == solo[_label(req)],
                  f"solo through a store {_label(req)}: differs from solo")
        stored_wall = time.perf_counter() - tic
        stored_counts = _dp_counts(io0, bk.io_counts(), c0, _counts())
        store.clear(stacks=True)
        del store, out

        # 1. the fleet: every request in one compile_many, under the
        # profiler's device activity only (no host events: it costs the
        # host nothing measurable)
        svc = CompileService()
        _reset_counts()
        io0 = bk.io_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tic = time.perf_counter()
            fleet = svc.compile_many(reqs)
            torch.cuda.synchronize()
            fleet_wall = time.perf_counter() - tic
        counts = {k: n for k, n in _counts().items() if k in DP_KERNELS}
        fleet_counts = _dp_counts(io0, bk.io_counts(),
                                  dict.fromkeys(DP_KERNELS, 0), counts)
        print(f"service launches: {json.dumps(counts)}", flush=True)
        for name in DP_KERNELS:
            check(counts[name] > 0,
                  f"kernel {name} was not launched by the fleet")
        for req, res in zip(reqs, fleet):
            check(_result_json(res, FLEET_STATS) == solo[_label(req)],
                  f"fleet {_label(req)}: differs from the solo compile")
        print(f"service fleet: {len(reqs)} requests  wall "
              f"{fleet_wall:.3f} s against {solo_sum:.3f} s of solo "
              f"walls ({fleet_wall / solo_sum:.3f}) and {stored_wall:.3f} "
              f"s of solo compiles through one store "
              f"({fleet_wall / stored_wall:.3f}); identical to each solo "
              "compile on the card", flush=True)
        print(f"service launches fleet {json.dumps(fleet_counts)}; solo "
              f"{json.dumps(solo_counts)}; solo through one store "
              f"{json.dumps(stored_counts)}", flush=True)
        _print_busy("profile service fleet", prof, fleet_wall * 1e6)

        # 2. warm answers: the schedule cache, then lanes already resident
        c0 = _counts()
        again = svc.compile_many(reqs)
        delta = {k: _counts()[k] - c0[k] for k in DP_KERNELS}
        check(not any(delta.values()),
              f"cached repeat launched kernels: {delta}")
        check([_result_json(r) for r in again]
              == [_result_json(r) for r in fleet],
              "cached repeat differs from the fleet")
        io0 = bk.io_counts()
        tic = time.perf_counter()
        warm = CompileService(store=svc.store, use_schedule_cache=False) \
            .compile_many(reqs)
        warm_wall = time.perf_counter() - tic
        uploads = bk.io_counts()["h2d_lane_uploads"] \
            - io0["h2d_lane_uploads"]
        check(uploads == 0, f"warm repeat uploaded {uploads} lanes")
        check([_result_json(r) for r in warm]
              == [_result_json(r) for r in fleet],
              "warm repeat differs from the fleet")
        stats = svc.store.stats()
        print(f"service warm: cached repeat 0 launches; warm repeat "
              f"(schedule cache off) wall {warm_wall:.3f} s, 0 lane "
              f"uploads, {stats['resident_lanes']} lanes resident, lane "
              f"hits {stats['hits']['lanes']}", flush=True)

        # 3. device memory: the mirrors go with the lane stores
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        svc.store.clear(stacks=True)
        torch.cuda.synchronize()
        mem2 = torch.cuda.memory_allocated()
        print(f"service memory: allocated {mem0} B before the fleet, "
              f"{mem1} B with the mirrors resident, {mem2} B after "
              f"clear(stacks=True)", flush=True)
        check(mem1 > mem0, "no device memory held by the lane mirrors")
        check(abs(mem2 - mem0) <= MIB,
              f"clear left {mem2 - mem0} B of device memory")

        # 4. two threads, one service, under the lock checker
        lockcheck.enable()
        lockcheck.reset()
        try:
            shared = CompileService(use_schedule_cache=False)
            mine = service_requests(DEVICE, nets=THREAD_NETS,
                                    fractions=(0.9,), goals=False)
            out, errors = {}, []

            def run(tid, order):
                try:
                    res = shared.compile_many([mine[i] for i in order])
                    out[tid] = dict(zip(order, res))
                except BaseException as exc:    # re-raised below
                    errors.append(exc)

            tic = time.perf_counter()
            order = list(range(len(mine)))
            threads = [threading.Thread(target=run, args=(t, o))
                       for t, o in enumerate((order, order[::-1]))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            wall = time.perf_counter() - tic
            check(not any(t.is_alive() for t in threads),
                  "a compile_many thread did not finish")
            if errors:
                raise errors[0]
            for res in out.values():
                for i, r in res.items():
                    check(_result_json(r, FLEET_STATS)
                          == solo[_label(mine[i])],
                          f"thread {_label(mine[i])}: differs from solo")
            report = lockcheck.assert_clean()
            locks = lockcheck.graph()["locks"]
            if keep is not None:
                lockcheck.dump(keep / LOCK_DUMP)
            shared.store.clear()
        finally:
            lockcheck.disable()
        print(f"service threads: 2 x compile_many of {len(mine)} on one "
              f"service, wall {wall:.3f} s, equal to solo; lockcheck "
              f"clean: {len(report['edges'])} edges, 0 cycles, 0 hazards "
              f"over {len(locks)} locks {locks}", flush=True)

        # 5. the farm: 2 workers on the card, then 1 fresh one warm
        with contextlib.ExitStack() as stack:
            if keep is None:
                root = stack.enter_context(tempfile.TemporaryDirectory())
            else:
                root = str(keep / FARM_DIR)
            _farm_run(root, solo, 2)
            warm_counters = _farm_run(root, solo, 1)
        check(warm_counters["disk_hits"]["schedule"] > 0,
              "the second farm answered nothing from the first one's disk")

        # the CPU side, computed meanwhile
        tic = time.perf_counter()
        cpu = cpu_side.result(timeout=600)
        for req, res, want in zip(reqs, fleet, cpu):
            check(_result_json(res) == want,
                  f"fleet {_label(req)}: differs from the CPU fleet")
        print(f"service CPU: the fleet ({len(cpu)} results) identical to "
              f"the CPU compiles (waited {time.perf_counter() - tic:.3f} s "
              "for them)", flush=True)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    return counts


# ----------------------------------------------------- control phase

# benchmarks/serve_robustness.py's setup: squeezenet1.1 at full width,
# pfdnn, 3 rails of the 9-level menu, the base rate provisioned at
# CONTROL_UTIL, deadline-tightened variants at CONTROL_TIGHTEN
CONTROL_NET = "squeezenet1.1"
CONTROL_RATE = 60.0
CONTROL_UTIL = 0.85
CONTROL_TIGHTEN = 0.92
CONTROL_SEED = 11
# the benchmark's smoke horizon, shared by every row (drift_learned's
# energy ratio divides by the drift row's static energy); PERF.md says
# why not its 420
CONTROL_FRAMES = 180
# the acceptance booleans serve_robustness.py --smoke asserts
SMOKE_ACCEPTANCE = ("bursty_miss_improved", "calm_energy_within_1pct",
                    "all_snaps_precompiled", "drift_learned_recalibrated",
                    "drift_learned_energy_improved", "drift_learned_miss_leq")
POLICY_BANDS = (0.0, 0.4, 0.7, 1.0)       # activation-density bands
PERIODIC_INTERVALS = 100


def control_scenarios(n_frames: int) -> dict:
    """Traffic and faults of each row (``serve_robustness.py``'s
    ``scenario_plan``)."""
    from repro_torch.serve import FaultConfig, TrafficConfig, linear_drift

    return {
        "calm": dict(
            traffic=TrafficConfig(CONTROL_RATE, scenario="calm"),
            faults=FaultConfig(seed=CONTROL_SEED, p_drop=0.01), bias=None),
        "bursty": dict(
            traffic=TrafficConfig(
                CONTROL_RATE, scenario="bursty", seed=3, jitter_sigma=0.05,
                burst_rate_mult=1.25, lull_rate_mult=0.4),
            faults=FaultConfig(
                seed=CONTROL_SEED, op_sigma=0.02, trans_sigma=0.1,
                p_trans_spike=0.02, p_drop=0.01, p_late=0.01,
                late_max_s=0.003),
            bias=None),
        # layer-cost error ramps to +30 % at mid-trace, then back down
        "drift": dict(
            traffic=TrafficConfig(CONTROL_RATE, scenario="calm"),
            faults=FaultConfig(seed=CONTROL_SEED, op_sigma=0.01),
            bias=linear_drift(0.3 / (n_frames // 2),
                              peak=n_frames // 2)),
    }


def learned_config():
    """The benchmark's drift_learned plane: blocking ledger-learned
    re-solves, provisioned at 0.95, 10 points over (0.5, 1.8)."""
    from repro_torch.serve import AdaptiveConfig

    return AdaptiveConfig(calib_enabled=True, calib_blocking=True,
                          util_target=0.95, resolve_points=10,
                          resolve_rate_band=(0.5, 1.8), calib_window=16,
                          calib_min_samples=8, calib_cooldown=8,
                          calib_threshold=0.02)


def _resolve_service_class():
    from repro_torch.service import CompileService

    class ResolveLog(CompileService):
        """A service that records each ``compile_contingencies`` call's
        wall and its DP, k-best and gather launches, and the arguments
        of the last one."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.calls: list[tuple[float, dict]] = []
            self.last: tuple | None = None
            self.fleets = 0

        def compile_many(self, *args, **kwargs):
            self.fleets += 1
            return super().compile_many(*args, **kwargs)

        def compile_contingencies(self, *args, **kwargs):
            self.last = (args, kwargs)
            c0 = _counts()
            tic = time.perf_counter()
            out = super().compile_contingencies(*args, **kwargs)
            wall = time.perf_counter() - tic
            self.calls.append((wall, {k: _counts()[k] - c0[k]
                                      for k in DP_KERNELS}))
            return out

    return ResolveLog


def _control_net():
    from repro_torch.hw.edge40nm import EDGE40NM_DEFAULT as acc
    from repro_torch.models.edge_cnn import edge_network
    from repro_torch.perfmodel import characterize_network, plan_banks

    specs = edge_network(CONTROL_NET)
    costs = characterize_network(specs, acc)
    return specs, costs, plan_banks(costs, acc), acc


def _report_row(report) -> tuple:
    """Every field of a ServeReport but its event log."""
    return dataclasses.astuple(dataclasses.replace(report, events=None))


def _bundle_json(bundle, drop: tuple = ()) -> dict:
    """A contingency bundle as comparable JSON (schedules without their
    host stats and ``drop``)."""
    def one(sched):
        return None if sched is None else _result_json(sched, drop)

    return {"base": bundle.base_deadline_s,
            "points": [(d, one(s)) for d, s in sorted(bundle.points.items())],
            "tightened": [(d, one(s))
                          for d, s in sorted(bundle.tightened.items())],
            "aggressive": one(bundle.aggressive),
            "budget": one(bundle.budget),
            "infeasible": [(kind, d) for kind, d, _ in bundle.infeasible]}


def control_bundle(svc, device: str):
    """Step 1: the contingency bundle of the base rate, one
    ``compile_contingencies`` (one ``compile_many``)."""
    from repro_torch.core import OrchestratorConfig

    specs = _control_net()[0]
    return svc.compile_contingencies(
        specs, CONTROL_RATE / CONTROL_UTIL, tighten_frac=CONTROL_TIGHTEN,
        cfg=OrchestratorConfig(policy="pfdnn", device=device),
        network=CONTROL_NET)


def control_rows(bundle, n_frames: int) -> dict:
    """Step 2, without the learned row: calm, bursty and drift, static
    and adaptive, on the bundle."""
    from repro_torch.serve import (
        AdaptiveScheduler,
        FaultInjector,
        StaticSchedulePolicy,
        TrafficSimulator,
        serve_trace,
    )

    _, costs, plan, acc = _control_net()
    static_sched = bundle.points[bundle.base_deadline_s]
    rows = {}
    for name, sc in control_scenarios(n_frames).items():
        times = TrafficSimulator(sc["traffic"]).frame_times(n_frames)
        static = serve_trace(
            times, StaticSchedulePolicy(static_sched, costs, plan, acc),
            injector=FaultInjector(sc["faults"], len(costs),
                                   op_bias=sc["bias"]))
        adaptive = serve_trace(
            times, AdaptiveScheduler(bundle, costs, plan, acc),
            injector=FaultInjector(sc["faults"], len(costs),
                                   op_bias=sc["bias"]))
        rows[name] = {"static": static, "adaptive": adaptive}
    return rows


def control_learned(svc, bundle, device: str, n_frames: int):
    """Step 2's learned row: the drift trace on a copy of the bundle
    (re-solves replace its points in place), blocking re-solves through
    ``svc``; returns the report and the plane."""
    from repro_torch.core import OrchestratorConfig
    from repro_torch.serve import (
        AdaptiveScheduler,
        FaultInjector,
        TrafficSimulator,
        serve_trace,
    )

    specs, costs, plan, acc = _control_net()
    sc = control_scenarios(n_frames)["drift"]
    times = TrafficSimulator(sc["traffic"]).frame_times(n_frames)
    copy = dataclasses.replace(bundle, points=dict(bundle.points),
                               tightened=dict(bundle.tightened),
                               infeasible=list(bundle.infeasible))
    plane = AdaptiveScheduler(
        copy, costs, plan, acc, service=svc, specs=specs,
        compile_cfg=OrchestratorConfig(policy="pfdnn", device=device),
        acfg=learned_config())
    report = serve_trace(times, plane, injector=FaultInjector(
        sc["faults"], len(costs), op_bias=sc["bias"]))
    return report, plane


def control_table(svc, bundle, device: str):
    """Step 5: a 3-band policy table in one ``compile_many``, then a
    40-frame trace whose observable walks the bands.  The trace applies
    no input-dependent work, so a sparse band's schedule (planned for
    less MAC work) runs long and misses; the ladder is held (a dwell
    longer than the trace) so that every band regime snaps."""
    import numpy as np

    from repro_torch.calib import compile_policy_table
    from repro_torch.core import OrchestratorConfig
    from repro_torch.serve import (
        AdaptiveConfig,
        AdaptiveScheduler,
        serve_trace,
    )

    specs, costs, plan, acc = _control_net()
    base = CONTROL_UTIL / CONTROL_RATE
    table = compile_policy_table(
        svc, specs, band_edges=POLICY_BANDS, deadlines=[base, 1.25 * base],
        cfg=OrchestratorConfig(policy="pfdnn", device=device),
        network=CONTROL_NET)
    n = 40
    times = np.arange(n + 1) / CONTROL_RATE
    obs = np.repeat([0.2, 0.5, 0.9, 0.5], n // 4)
    plane = AdaptiveScheduler(bundle, costs, plan, acc, policy_table=table,
                              acfg=AdaptiveConfig(dwell_intervals=n + 1))
    report = serve_trace(times, plane, observables=obs)
    return table, report


def control_periodic(static_sched) -> dict:
    """Step 6: 100 periods of the static schedule under the bursty
    faults."""
    from repro_torch.serve import (
        FaultInjector,
        PeriodicScheduler,
        PowerRuntime,
    )

    _, costs, plan, acc = _control_net()
    faults = control_scenarios(CONTROL_FRAMES)["bursty"]["faults"]
    out = PeriodicScheduler(
        PowerRuntime(static_sched, costs, plan, acc),
        1.0 / static_sched.t_max).run(
        PERIODIC_INTERVALS, injector=FaultInjector(faults, len(costs)))
    out["ledgers"] = [dataclasses.asdict(x) for x in out["ledgers"]]
    return out


def _table_json(table) -> list:
    """A policy table as comparable JSON; the round scheduler's counters
    are set aside (they depend on what the store already held)."""
    return [(b.lo, b.hi, b.cost_model.digest,
             [(d, _result_json(s, FLEET_STATS))
              for d, s in sorted(b.schedules.items())],
             [(d, g.to_json()) for d, g in b.infeasible])
            for b in table.bands]


def cpu_control(part: str, n_frames: int) -> dict:
    """The control phase's CPU side (plain versions), as comparable
    values: ``"rows"`` is the bundle, the calm, bursty and drift rows,
    the policy table and its trace, the periodic run and the solver
    walls' checksum; ``"learned"`` is the drift_learned row and its
    re-solves' walls.  Runs in a spawned process beside the card's
    work."""
    import torch

    from repro_torch.calib import solver_kernel_walls

    torch.set_num_threads(CPU_SIDE_THREADS)
    svc = _resolve_service_class()()
    with svc:
        bundle = control_bundle(svc, "cpu")
        if part == "learned":
            svc.calls.clear()
            report, plane = control_learned(svc, bundle, "cpu", n_frames)
            return {"learned": (_report_row(report),
                                plane.events.to_json()),
                    "resolve_walls": [wall for wall, _ in svc.calls]}
        rows = control_rows(bundle, n_frames)
        table, table_report = control_table(svc, bundle, "cpu")
        return {
            "bundle": _bundle_json(bundle),
            "rows": {name: (_report_row(r["static"]),
                            _report_row(r["adaptive"]),
                            r["adaptive"].events.to_json())
                     for name, r in rows.items()},
            "table": _table_json(table),
            "table_trace": (_report_row(table_report),
                            table_report.events.to_json()),
            "periodic": control_periodic(
                bundle.points[bundle.base_deadline_s]),
            "walls_checksum": solver_kernel_walls("cpu")["checksum"]}


def control_acceptance(rows: dict, learned, n_recal: int) -> dict:
    """``serve_robustness.py``'s acceptance block over the rows."""
    def ratio(name):
        return rows[name]["adaptive"].energy_j / \
            rows[name]["static"].energy_j

    def precompiled(events):
        snaps = events.of("snap")
        return bool(snaps) and all(e.detail.get("precompiled")
                                   for e in snaps)

    learned_ratio = learned.energy_j / rows["drift"]["static"].energy_j
    return {
        "drift_learned_energy_improved": learned_ratio < ratio("drift"),
        "drift_learned_miss_leq":
            learned.miss_rate <= rows["drift"]["adaptive"].miss_rate + 1e-9,
        "drift_learned_recalibrated": n_recal > 0,
        "bursty_miss_improved": rows["bursty"]["adaptive"].miss_rate
        < rows["bursty"]["static"].miss_rate,
        "bursty_energy_leq": ratio("bursty") <= 1.0 + 1e-9,
        "calm_energy_within_1pct": abs(ratio("calm") - 1.0) <= 0.01,
        "drift_miss_improved": rows["drift"]["adaptive"].miss_rate
        < rows["drift"]["static"].miss_rate,
        "all_snaps_precompiled": all(
            precompiled(r["adaptive"].events) for r in rows.values())
        and precompiled(learned.events),
    }


def _check_equal(card, cpu, what: str) -> None:
    """Fail, naming the innermost differing key, unless equal."""
    if card != cpu:
        if isinstance(card, dict) and isinstance(cpu, dict):
            for key in sorted(card.keys() | cpu.keys()):
                _check_equal(card.get(key), cpu.get(key), f"{what}.{key}")
        fail(f"{what}: the card's differs from the CPU port's")


def control_phase() -> dict:
    """The adaptive control plane on the card (see the module
    docstring, phase 11); returns the sweep kernels' launches of its
    bundle compile and blocking re-solves."""
    import gc
    import multiprocessing
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.analysis import lockcheck
    from repro_torch.calib import (
        HarnessConfig,
        identity_model,
        run_harness,
        solver_kernel_walls,
        synthetic_measurement,
    )
    from repro_torch.core import MinEnergy, OrchestratorConfig, compile
    from repro_torch.core.backend import get_backend
    from repro_torch.serve import (
        AsyncResolver,
        StaticSchedulePolicy,
        TrafficSimulator,
        serve_trace,
    )
    from repro_torch.service import ArtifactStore

    n_frames = CONTROL_FRAMES
    print(f"control horizon: {n_frames} frames, every row", flush=True)
    ResolveLog = _resolve_service_class()
    specs, costs, plan, acc = _control_net()
    card_cfg = OrchestratorConfig(policy="pfdnn", device=DEVICE)
    pool = concurrent.futures.ProcessPoolExecutor(
        2, mp_context=multiprocessing.get_context("spawn"))
    try:
        cpu_parts = [pool.submit(cpu_control, part, n_frames)
                     for part in ("learned", "rows")]
        svc = ResolveLog()
        total = dict.fromkeys(DP_KERNELS, 0)

        # 1. the contingency bundle, one compile_contingencies
        _reset_counts()
        tic = time.perf_counter()
        bundle = control_bundle(svc, DEVICE)
        bundle_wall = time.perf_counter() - tic
        counts = {k: _counts()[k] for k in DP_KERNELS}
        for k in DP_KERNELS:
            total[k] += counts[k]
        print(f"control bundle: {len(bundle.points)} points, "
              f"{len(bundle.tightened)} tightened, aggressive "
              f"{bundle.aggressive is not None}, budget "
              f"{bundle.budget is not None}, {svc.fleets} compile_many; "
              f"wall {bundle_wall:.3f} s  launches {json.dumps(counts)}",
              flush=True)
        check(svc.fleets == 1, "the bundle took more than one compile_many")
        for name in DP_KERNELS:
            check(counts[name] > 0,
                  f"kernel {name} was not launched by the bundle compile")

        # 2. the rows, then drift_learned with blocking re-solves
        tic = time.perf_counter()
        rows = control_rows(bundle, n_frames)
        rows_wall = time.perf_counter() - tic
        svc.calls.clear()
        tic = time.perf_counter()
        learned, plane = control_learned(svc, bundle, DEVICE, n_frames)
        learned_wall = time.perf_counter() - tic
        for i, (wall, c) in enumerate(svc.calls):
            print(f"control re-solve {i + 1}: wall {wall:.3f} s  launches "
                  f"{json.dumps(c)}", flush=True)
            for k in DP_KERNELS:
                total[k] += c[k]
                check(c[k] > 0, f"re-solve {i + 1} launched no {k}")
        n_recal = len(plane.events.of("calibrate_done"))
        resolve_walls = [w for w, _ in svc.calls]
        check(len(resolve_walls) == n_recal > 0,
              f"{len(resolve_walls)} re-solves for {n_recal} calibrations")
        for name, r in rows.items():
            for side in ("static", "adaptive"):
                print(f"control {name:8s} {side:8s} {r[side].summary()}",
                      flush=True)
        print(f"control learned  adaptive {learned.summary()}  events "
              f"{json.dumps(plane.events.kinds())}", flush=True)
        print(f"control serve walls: 6 rows {rows_wall:.3f} s; "
              f"drift_learned {learned_wall:.3f} s, of which "
              f"{sum(resolve_walls):.3f} s in {n_recal} blocking re-solves "
              f"(median {statistics.median(resolve_walls):.3f} s, max "
              f"{max(resolve_walls):.3f} s)", flush=True)
        accept = control_acceptance(rows, learned, n_recal)
        print(f"control acceptance: {json.dumps(accept)}", flush=True)
        for key in SMOKE_ACCEPTANCE:
            check(accept[key], f"control acceptance {key} is false")
        if n_frames >= 420:
            for key, val in accept.items():
                check(val, f"control acceptance {key} is false")

        # 3. async re-solves on a store of their own, with the last
        # blocking re-solve's arguments: one awaited, one (at another
        # rate) abandoned by the watchdog mid-flight while serving goes on
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        (_, base_rate), kw = svc.last
        lockcheck.enable()
        lockcheck.reset()
        try:
            asvc = ResolveLog(use_schedule_cache=False)
            c0 = _counts()
            tic = time.perf_counter()
            landed = asvc.compile_contingencies_async(
                specs, base_rate, **kw).result(timeout=300)
            async_wall = time.perf_counter() - tic
            c = {k: _counts()[k] - c0[k] for k in DP_KERNELS}
            # the live bundle's infeasible list accumulates over the
            # re-solves; its points are the last re-solve's
            got, want = (_bundle_json(b, FLEET_STATS)
                         for b in (landed, plane.bundle))
            check(all(got[k] == want[k] for k in ("points", "tightened",
                                                  "aggressive", "budget")),
                  "the awaited async re-solve differs from the blocking one")
            print(f"control async: awaited re-solve wall {async_wall:.3f} s "
                  f"launches {json.dumps(c)}; equal to the blocking "
                  "re-solve's bundle", flush=True)
            resolver = AsyncResolver(1e-3, on_timeout=asvc.abandon_async_pool)
            future = asvc.compile_contingencies_async(
                specs, 1.1 * base_rate, **kw)
            resolver.watch("resolve", future)
            time.sleep(0.01)
            polled = resolver.poll()
            check(polled is not None and polled[0] == "timeout"
                  and not future.done(),
                  f"the watchdog did not abandon the re-solve: {polled}")
            # the serving loop goes on while the abandoned compile runs
            times = TrafficSimulator(
                control_scenarios(60)["calm"]["traffic"]).frame_times(60)
            serve_trace(times, StaticSchedulePolicy(
                bundle.points[bundle.base_deadline_s], costs, plan, acc))
            ran = future.done()
            abandoned = future.result(timeout=300)
            check(abandoned.points, "the abandoned re-solve found no point")
            report = lockcheck.assert_clean()
            locks = lockcheck.graph()["locks"]
        finally:
            lockcheck.disable()
        torch.cuda.synchronize()
        mem1 = torch.cuda.memory_allocated()
        asvc.store.clear(stacks=True)
        del asvc, landed, abandoned, future
        gc.collect()
        torch.cuda.synchronize()
        mem2 = torch.cuda.memory_allocated()
        state = "had ended" if ran else "still ran"
        print(f"control abandon: watchdog {polled[0]} after "
              f"{polled[2] * 1e3:.3f} ms, the compile {state} when the "
              "60-frame serve ended; it ended without error; "
              f"memory {mem0} B before, {mem1} B with its mirrors, {mem2} "
              f"B after clear(stacks=True); lockcheck clean: "
              f"{len(report['edges'])} edges, 0 cycles, 0 hazards over "
              f"{len(locks)} locks", flush=True)
        check(abs(mem2 - mem0) <= MIB,
              f"the async re-solves left {mem2 - mem0} B of device memory")

        # 4. the calibration harness
        parity = run_harness(acc, HarnessConfig())
        check(set(parity.ratios_by_kind().values()) == {(1.0, 1.0)},
              "harness parity mode: a ratio is not 1.0")
        truth = {"conv": 1.3, "fc": 0.8}
        synth = run_harness(acc, HarnessConfig(repeats=5, seed=1),
                            measure=synthetic_measurement(
                                truth, noise_sigma=0.02))
        ratios = synth.ratios_by_kind()
        check(all(abs(ratios[k][0] / truth.get(k, 1.0) - 1.0) <= 0.05
                  for k in ratios),
              f"the harness did not recover {truth}: {ratios}")
        with tempfile.TemporaryDirectory() as root:
            store = ArtifactStore(disk_path=root)
            run_harness(acc, HarnessConfig(), store=store)
            again = run_harness(acc, HarnessConfig(), store=store)
            other = ArtifactStore(disk_path=root)
            reused = run_harness(acc, HarnessConfig(), store=other)
            check(store.misses["calibration"] == 1
                  and store.hits["calibration"] == 1
                  and other.disk_hits["calibration"] == 1
                  and again.to_record() == reused.to_record()
                  == parity.to_record(),
                  "harness publication or reuse through the store failed")
        model = parity.cost_model(specs)
        static = compile(specs, MinEnergy(rate_hz=base_rate), cfg=card_cfg,
                         network=CONTROL_NET)
        c0 = _counts()
        calibrated = compile(specs, MinEnergy(rate_hz=base_rate),
                             cfg=card_cfg, network=CONTROL_NET,
                             cost_model=model)
        c = {k: _counts()[k] - c0[k] for k in DP_KERNELS}
        check(calibrated.cost_model == model.digest != static.cost_model,
              "the calibrated schedule does not carry its model")
        check(_result_json(dataclasses.replace(calibrated,
                                               cost_model="static"))
              == _result_json(static),
              "the parity model compiled another schedule than static")
        check(identity_model(len(specs)).scale == model.scale,
              "the parity model is not the identity")
        be = get_backend(DEVICE)
        timed = []
        plain_call = be.dp_multi

        def dp_multi(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = plain_call(*args)
            end.record()
            end.synchronize()
            timed.append(start.elapsed_time(end))
            return out

        be.dp_multi = dp_multi
        c1 = _counts()
        try:
            walls = solver_kernel_walls(DEVICE)
        finally:
            del be.dp_multi
        dp_launches = _counts()["dp_multi_stacked"] - c1["dp_multi_stacked"]
        check(dp_launches == len(timed) == 4,
              f"solver_kernel_walls launched the DP kernel {dp_launches} "
              f"times in {len(timed)} calls")
        print(f"control harness: parity all 1.0 over "
              f"{len(parity.points)} points; synthetic {truth} recovered "
              f"as conv {ratios['conv'][0]!r}, fc {ratios['fc'][0]!r}; "
              f"published, then 1 hit and 1 disk hit; the parity model's "
              f"compile equals static (launches {json.dumps(c)})",
              flush=True)
        print(f"control solver walls: median "
              f"{walls['wall_s_median'] * 1e3:.4f} ms, min "
              f"{walls['wall_s_min'] * 1e3:.4f} ms (host clock, "
              f"paths on the host); CUDA events of the same calls "
              f"{', '.join(f'{t:.4f}' for t in timed[1:])} ms (warm-up "
              f"{timed[0]:.4f} ms); checksum {walls['checksum']}",
              flush=True)

        # 5. the policy table, one compile_many, and its trace
        fleets = svc.fleets
        c0 = _counts()
        tic = time.perf_counter()
        table, table_report = control_table(svc, bundle, DEVICE)
        table_wall = time.perf_counter() - tic
        c = {k: _counts()[k] - c0[k] for k in DP_KERNELS}
        check(svc.fleets - fleets == 1,
              "the policy table took more than one compile_many")
        snaps = [e for e in table_report.events.of("snap")
                 if e.detail.get("variant") == "policy_table"]
        check(len(snaps) == 4, f"{len(snaps)} policy-table snaps, not 4")
        print(f"control policy table: {len(table.bands)} bands x "
              f"{len(table.deadlines())} deadlines in one compile_many, "
              f"wall {table_wall:.3f} s (trace included) launches "
              f"{json.dumps(c)}; 40 frames: {table_report.summary()}, "
              f"{len(snaps)} band snaps", flush=True)

        # 6. the periodic scheduler under the bursty faults
        periodic = control_periodic(bundle.points[bundle.base_deadline_s])
        print(f"control periodic: {PERIODIC_INTERVALS} periods, "
              f"{periodic['deadline_misses']} misses, "
              f"{periodic['dropped_frames']} dropped, "
              f"{periodic['avg_power_mw']!r} mW", flush=True)

        # 7. one blocking re-solve under the profiler, cold (own store)
        psvc = ResolveLog(use_schedule_cache=False)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            tic = time.perf_counter()
            psvc.compile_contingencies(specs, base_rate, **kw)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - tic
        _print_busy("profile control re-solve", prof, prof_wall * 1e6)
        psvc.store.clear(stacks=True)

        # the CPU side, computed meanwhile
        tic = time.perf_counter()
        cpu = {}
        for part in cpu_parts:
            cpu.update(part.result(timeout=900))
        card = {
            "bundle": _bundle_json(bundle),
            "rows": {name: (_report_row(r["static"]),
                            _report_row(r["adaptive"]),
                            r["adaptive"].events.to_json())
                     for name, r in rows.items()},
            "learned": (_report_row(learned), plane.events.to_json()),
            "table": _table_json(table),
            "table_trace": (_report_row(table_report),
                            table_report.events.to_json()),
            "periodic": periodic,
            "walls_checksum": walls["checksum"]}
        cpu_walls = cpu.pop("resolve_walls")
        _check_equal(card, cpu, "control")
        print(f"control CPU port re-solves ({CPU_SIDE_THREADS} threads, "
              f"beside the card's work): {len(cpu_walls)}, median "
              f"{statistics.median(cpu_walls):.3f} s, max "
              f"{max(cpu_walls):.3f} s, sum {sum(cpu_walls):.3f} s; on "
              f"the card median {statistics.median(resolve_walls):.3f} s",
              flush=True)
        print(f"control CPU: bundle, {len(rows)} rows x 2 policies and "
              f"drift_learned (reports field for field, event logs byte "
              f"for byte), the policy table, the periodic run and the "
              f"walls' checksum identical to the CPU port's (waited "
              f"{time.perf_counter() - tic:.3f} s for them)", flush=True)
        svc.store.clear(stacks=True)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    print(f"control launches: {json.dumps(total)}", flush=True)
    return total


# ---------------------------------------------------- analysis phase

FARM_DIR, LOCK_DUMP = "farm", "lockcheck.jsonl"
# runs `python -m repro_torch.analysis <args>` as a user does and, at
# exit, prints the kernels' launch counts of the process on stderr
ANALYSIS_MAIN = """
import atexit, json, runpy, sys
from repro_torch.kernels import dp_sweep
atexit.register(lambda: print("LAUNCHES " + json.dumps(dp_sweep.LAUNCHES),
                              file=sys.stderr, flush=True))
sys.argv = ["python -m repro_torch.analysis"] + sys.argv[1:]
runpy.run_module("repro_torch.analysis", run_name="__main__",
                 alter_sys=True)
"""


def _analysis(args: list[str]) -> subprocess.Popen:
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    return subprocess.Popen([sys.executable, "-c", ANALYSIS_MAIN, *args],
                            cwd=str(ROOT), env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(proc: subprocess.Popen, what: str,
            timeout: float = 600) -> tuple[float, list[str], dict]:
    """(wall, stdout lines, launch counts) of a finished analysis run;
    fails on a nonzero exit."""
    tic = time.perf_counter()
    out, err = proc.communicate(timeout=timeout)
    counts = {}
    for line in err.splitlines():
        if line.startswith("LAUNCHES "):
            counts = json.loads(line[len("LAUNCHES "):])
    check(proc.returncode == 0, f"python -m repro_torch.analysis {what} "
          f"exited {proc.returncode}:\n{out[-2000:]}\n{err[-2000:]}")
    return time.perf_counter() - tic, out.splitlines(), counts


def analysis_phase(keep: pathlib.Path | None) -> None:
    """``python -m repro_torch.analysis`` as users run it, in
    subprocesses started together: ``certify --goldens`` on the card
    (every golden case compiled through ``repro_torch.core`` on the card
    and certified; its DP, k-best and gather launches) and on the CPU
    (``--device cpu``: the plain versions), whose lines must be equal
    and each PASS; ``lint`` over the port's tree (clean under its
    baseline); with ``keep`` (the service phase's leavings),
    ``certify --store`` on the farm's disk store (OK, entries > 0) and
    ``lockcheck --dump`` on the two-thread run's lock graph (no cycle,
    no barrier hazard)."""
    from repro_torch.analysis import __main__ as cli

    tic = time.perf_counter()
    procs = {"card": _analysis(["certify", "--goldens"]),
             "cpu": _analysis(["certify", "--goldens", "--device", "cpu"]),
             "lint": _analysis(["lint"])}
    if keep is not None:
        procs["store"] = _analysis(["certify", "--store",
                                    str(keep / FARM_DIR)])
        procs["lockcheck"] = _analysis(["lockcheck", "--dump",
                                        str(keep / LOCK_DUMP)])
    wall, card, counts = _finish(procs["card"], "certify --goldens")
    n_cases = len(cli._golden_cases())
    print(f"analysis certify --goldens on the card: {len(card)} lines, "
          f"process wall {time.perf_counter() - tic:.3f} s, launches "
          f"{json.dumps(counts)}", flush=True)
    for line in card:
        print(f"  {line}", flush=True)
    check(len(card) == n_cases and all(": PASS  dual-gap=" in line
                                       for line in card),
          "certify --goldens on the card: not every golden case PASSes")
    for name in DP_KERNELS:
        check(counts.get(name, 0) > 0, f"certify --goldens did not launch "
              f"{name} on the card")
    _, cpu, cpu_counts = _finish(procs["cpu"], "certify --goldens --device "
                                 "cpu")
    check(cpu == card, "certify --goldens: the card's lines differ from "
          "the CPU's")
    check(not any(cpu_counts.values()), f"certify --goldens --device cpu "
          f"launched kernels: {cpu_counts}")
    print(f"analysis certify --goldens --device cpu: the same {len(cpu)} "
          "lines, no launch", flush=True)
    _, lint, _ = _finish(procs["lint"], "lint")
    print(f"analysis lint: {lint[-1]}", flush=True)
    check(lint[-1].startswith("lint: 0 finding(s)"), "lint found findings")
    if keep is None:
        print("analysis: no service phase ran; certify --store and "
              "lockcheck --dump skipped", flush=True)
    else:
        _, store, _ = _finish(procs["store"], "certify --store")
        print(f"analysis certify --store {keep / FARM_DIR}: {store[0]}",
              flush=True)
        check(store[0].endswith("entries, OK")
              and not store[0].startswith("store audit: 0 "),
              f"certify --store: {store}")
        _, lock, _ = _finish(procs["lockcheck"], "lockcheck --dump")
        for line in lock:
            print(f"  {line}", flush=True)
        check(lock[-1] == "lockcheck: OK"
              and " 0 barrier hazard(s)" in lock[0], "lockcheck --dump")
    print(f"phase analysis: {time.perf_counter() - tic:.3f} s", flush=True)


def sass_count(lib, op: str) -> int:
    """Instructions of ``op`` (e.g. ``HGMMA``, ``IGMMA``: what ``wgmma``
    compiles to for bf16 and int8) in a built library's SASS
    (``cuobjdump -sass``)."""
    from repro_torch.kernels._nvcc import nvcc

    cuobjdump = pathlib.Path(nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib.path())],
                          capture_output=True, text=True, check=True).stdout
    return sum(f"{op}." in line for line in sass.splitlines())


def check_no_spills(report: str) -> None:
    """Every kernel of a ``ptxas_usage`` report spills nothing."""
    lines = report.splitlines()
    check(bool(lines) and all("spill stores 0 B, spill loads 0 B" in line
                              for line in lines),
          f"a kernel spills or its report failed:\n{report}")


def build_all() -> None:
    """Build every kernel library, one ``nvcc`` per source, all started
    together, then load each; count the tensor-core product
    instructions (``HGMMA`` and ``IGMMA``, what ``wgmma`` compiles to,
    in the bf16 attention and the int8 libraries, ``HMMA``, what
    ``mma.sync`` compiles to, in the MLA decode's) in their SASS; the
    MLA decode's kernels spill nothing (``ptxas -v``)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import int8_matmul as im

    from repro_torch.kernels import flash_decode as fd

    libs = ([m.LIBRARY for m in _kernel_modules()]
            + [fa.WGMMA_LIBRARY, fa.BWD_LIBRARY, fa.BWD_WGMMA_LIBRARY,
               fd.MLA_LIBRARY])
    reported = (fa.LIBRARY, fa.WGMMA_LIBRARY, fd.MLA_LIBRARY,
                fa.BWD_LIBRARY, fa.BWD_WGMMA_LIBRARY)

    def build(lib):
        tic = time.perf_counter()
        path = lib.build()
        return path.name, time.perf_counter() - tic

    tic = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(
            len(libs) + len(reported)) as pool:
        usage = [pool.submit(ptxas_usage, lib) for lib in reported]
        for name, secs in pool.map(build, libs):
            print(f"build: {name} in {secs:.2f} s", flush=True)
        for report in usage:
            print(report.result(), flush=True)
        mla_report = usage[reported.index(fd.MLA_LIBRARY)].result()
    for lib in libs:
        lib.load()
    print(f"build: all in {time.perf_counter() - tic:.2f} s", flush=True)
    for lib, op, what in ((fa.WGMMA_LIBRARY, "HGMMA", "bf16 attention"),
                          (fa.BWD_WGMMA_LIBRARY, "HGMMA",
                           "bf16 attention backward"),
                          (im.LIBRARY, "IGMMA", "int8"),
                          (fd.MLA_LIBRARY, "HMMA", "MLA decode")):
        n = sass_count(lib, op)
        print(f"sass: {lib.path().name}: {n} {op} instructions", flush=True)
        check(n > 0, f"the {what} library holds no {op}")
    check_no_spills(mla_report)
    for lib in (fa.BWD_LIBRARY, fa.BWD_WGMMA_LIBRARY):
        check_no_spills(usage[reported.index(lib)].result())


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


def mla_decode_only() -> int:
    """``--mla-decode``: build the MLA decode library alone (its ``ptxas
    -v`` report beside it: no spills; ``HMMA`` in its SASS), run the
    MLA_DECODE_SHAPES rows; no result line."""
    import torch

    from repro_torch.kernels import flash_decode as fd

    tic = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        usage = pool.submit(ptxas_usage, fd.MLA_LIBRARY)
        print(f"build: {fd.MLA_LIBRARY.build().name}", flush=True)
        report = usage.result()
    fd.MLA_LIBRARY.load()
    print(report, flush=True)
    print(f"build: {time.perf_counter() - tic:.2f} s", flush=True)
    check_no_spills(report)
    n = sass_count(fd.MLA_LIBRARY, "HMMA")
    print(f"sass: {fd.MLA_LIBRARY.path().name}: {n} HMMA instructions",
          flush=True)
    check(n > 0, "the MLA decode library holds no HMMA")
    rows: dict[str, dict] = {}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    mla_decode_rows(rows, gen)
    mla_plan_sweep(gen)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    return 0


def mla_plan_sweep(gen) -> None:
    """The bf16 MLA rows of batch 16 over 2048 rows and batch 32 over
    8192 (lengths drawn as there) under split plans of 1, 2 (the
    shipped ``MLA_CTAS_PER_SM``), 3 and 4 CTAs an SM: events ms, device
    ms, and the device ms of the split and the combine kernels apart."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_decode as fd

    r, dr = fd.MLA_WIDTHS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lrng = np.random.default_rng(2)
    shipped = fd.MLA_CTAS_PER_SM
    for b, s in ((16, 2048), (32, 8192)):
        lens_np = lrng.integers(1, s + 1, size=b).astype(np.int32)
        lens_np[0], lens_np[-1] = s, 0
        args = (_randn(gen, b, 16, r, dtype="bfloat16"),
                _randn(gen, b, 16, dr, dtype="bfloat16"),
                _randn(gen, b, s, r, dtype="bfloat16"),
                _randn(gen, b, s, dr, dtype="bfloat16"),
                torch.from_numpy(lens_np).to(DEVICE))
        kernel = lambda: fd.flash_decode_mla(*args)  # noqa: E731
        try:
            for per_sm in (1, 2, 3, 4):
                fd.MLA_CTAS_PER_SM = per_sm
                n_split, chunk = fd.mla_splits(s, b, 16, sms)
                print(f"mla plan B={b} S={s} {per_sm} CTAs an SM "
                      f"({n_split}x{chunk}): events {time_ms(kernel):.4f} ms"
                      f"  device {_ms(device_ms(kernel))}  split "
                      f"{_ms(device_ms(kernel, only='mla_split'))}  combine "
                      f"{_ms(device_ms(kernel, only='mla_combine'))}",
                      flush=True)
        finally:
            fd.MLA_CTAS_PER_SM = shipped
        del args


def service_only() -> int:
    """``--service``: build the rail-sweep library alone and run the
    service phase; no result line."""
    from repro_torch.kernels import dp_sweep as ks

    tic = time.perf_counter()
    ks.LIBRARY.load()
    print(f"build: {ks.LIBRARY.path().name} in "
          f"{time.perf_counter() - tic:.2f} s", flush=True)
    tic = time.perf_counter()
    service_phase()
    print(f"phase service: {time.perf_counter() - tic:.3f} s", flush=True)
    return 0


def lm_families_only() -> int:
    """``--lm-families``: build the attention, decode and rail-sweep
    libraries, run the windowed, ring and new families' kernel rows, the
    hybrid, ssm, moe, vlm and audio phases and the analysis phase
    without the service phase's store and dump; no result line."""
    import torch

    from repro_torch.kernels import dp_sweep as ks
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    libs = (fa.LIBRARY, fa.WGMMA_LIBRARY, fd.LIBRARY, fd.MLA_LIBRARY,
            ks.LIBRARY)
    tic = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for path in pool.map(lambda lib: lib.build(), libs):
            print(f"build: {path.name}", flush=True)
    for lib in libs:
        lib.load()
    print(f"build: all in {time.perf_counter() - tic:.2f} s", flush=True)
    rows: dict[str, dict] = {}
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    window_rows(rows, gen)
    ring_rows(rows, gen)
    family_rows(rows, gen)
    counts = {"hybrid": hybrid_phase()}
    ssm_phase()
    counts.update(families_phase())
    analysis_phase(None)
    for name, row in rows.items():
        run, counter = FAMILY_ROWS[name]
        row["launches"] = counts[run][counter]
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    return 0


def train_only() -> int:
    """``--train``: build the two prefill attention libraries and the
    two backward libraries alone (the backwards' ``ptxas -v`` reports
    beside them: no spills; the bf16 backward's ``HGMMA`` count), run
    the training phase; no result line."""
    from repro_torch.kernels import flash_attention as fa

    libs = (fa.LIBRARY, fa.WGMMA_LIBRARY, fa.BWD_LIBRARY,
            fa.BWD_WGMMA_LIBRARY)
    tic = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs) + 2) as pool:
        usage = [pool.submit(ptxas_usage, lib)
                 for lib in (fa.BWD_LIBRARY, fa.BWD_WGMMA_LIBRARY)]
        for path in pool.map(lambda lib: lib.build(), libs):
            print(f"build: {path.name}", flush=True)
        reports = [u.result() for u in usage]
    for lib in libs:
        lib.load()
    for report in reports:
        print(report, flush=True)
    print(f"build: all in {time.perf_counter() - tic:.2f} s", flush=True)
    n = sass_count(fa.BWD_WGMMA_LIBRARY, "HGMMA")
    print(f"sass: {fa.BWD_WGMMA_LIBRARY.path().name}: {n} HGMMA "
          "instructions", flush=True)
    check(n > 0, "the bf16 attention backward library holds no HGMMA")
    for report in reports:
        check_no_spills(report)
    tic = time.perf_counter()
    rows, counts = train_phase()
    print(f"phase train: {time.perf_counter() - tic:.3f} s", flush=True)
    for row in rows:
        row["launches"] = counts[row["name"]]
    print(json.dumps({"kernels": rows}), flush=True)
    return 0


def control_only() -> int:
    """``--control``: build the rail-sweep library alone and run the
    control phase; no result line."""
    from repro_torch.kernels import dp_sweep as ks

    tic = time.perf_counter()
    ks.LIBRARY.load()
    print(f"build: {ks.LIBRARY.path().name} in "
          f"{time.perf_counter() - tic:.2f} s", flush=True)
    tic = time.perf_counter()
    control_phase()
    print(f"phase control: {time.perf_counter() - tic:.3f} s", flush=True)
    return 0


# --------------------------------------------------------- mesh phase

# the world of one (NCCL): deepseek-v2-lite at full width, float32, cut
# to MESH_NCCL_LAYERS; prefill of (prompts, tokens) + decode steps; the
# train check's (layers, rows, tokens)
MESH_NCCL_LAYERS = 4
MESH_PARITY = (2, 1024, 8)
MESH_TRAIN = (2, 2, 256)
# four gloo ranks sharing the card: deepseek-v2-lite on (2,2) cut to
# MESH_EP_LAYERS with a global batch of (rows, tokens); tinyllama-1.1b
# on a "data" mesh of 4 cut to MESH_DP_LAYERS, (rows, tokens) a step
MESH_EP_LAYERS = 2
MESH_EP_BATCH = (4, 512)
# the serving engine on (2,2) after (a): slots, cache rows, new tokens a
# request; prompt lengths, served three, then one step later two more
MESH_ENGINE = (4, 64, 4)
MESH_ENGINE_PROMPTS = (24, 40, 16, 32, 20)
MESH_DP_LAYERS = 4
MESH_DP_BATCH = (8, 512)
MESH_DP_STEPS = 4
MESH_DRILL = (12, 7, 3)             # steps, crash after, checkpoint every
MESH_TIMEOUT_S = 60                 # process groups and each join
MESH_DEADLINE_S = 240               # a world's ranks, from their spawn
# limits, fixed before the phase's first run (PERF.md section 2)
MESH_LOGIT_TOL = 1e-3               # x max |logits|, the native wire
# the int8 wire rounds each row it carries to a step of 1/127 of the
# row's largest value, dispatch and combine: one step of each a layer
MESH_INT8_STEPS = 2 / 127           # x max |logits| a layer
MESH_BLOCK_TOL = 1e-5               # x max |y|
MESH_LOSS_TOL = 1e-5                # relative
MESH_GRAD_TOL = 1e-4                # x max |g|, each leaf
MESH_PARAM_TOL = 1e-4               # x max |p|, each leaf
MESH_DRILL_TOL = 1e-5               # relative, the reference drill's
# (d) tensor parallelism in the four-rank world: tinyllama-1.1b at full
# width cut to MESH_TP_LAYERS, float32, on each mesh of MESH_TP_MESHES
# against one process: a prefill of (rows, tokens) and decode steps
# (logits within MESH_LOGIT_TOL), a train batch of (rows, tokens) (loss
# within MESH_LOSS_TOL, gathered gradients within MESH_GRAD_TOL), the
# engine's tokens (identical); then on (2,2) the exact-count cells of
# (rows, tokens): tinyllama (MESH_TP_LAYERS) and deepseek-v2-lite
# (MESH_EP_LAYERS, expert parallelism), each rank's logged collectives
# and held bytes equal to the dry-run counter's on an abstract (2,2)
# mesh, exactly
MESH_TP_LAYERS = 4
MESH_TP_MESHES = ((1, 4), (2, 2))
MESH_TP_PARITY = (4, 512, 8)
MESH_TP_TRAIN = (4, 256)
MESH_TP_EXACT = (4, 16)
#: (d)'s models: arch → config overrides (full width, float32)
MESH_TP_CONFIGS = {ARCH: {"dtype": "float32", "n_layers": MESH_TP_LAYERS},
                   DEEPSEEK: {"dtype": "float32",
                              "n_layers": MESH_EP_LAYERS,
                              "moe_impl": "ep", "remat": False}}
MESH_COLLECTIVES = ("all_reduce SUM", "all_reduce MAX",
                    "all_gather_into_tensor", "all_to_all_single",
                    "broadcast")


def _capacity(t: int, k: int, e: int, cf: float) -> int:
    """``moe_ffn_ep``'s slots an expert for ``t`` tokens."""
    return max(1, int(k * t * cf) // e)


def no_drop_cf(routes: list, e: int, k: int, shards: int = 1) -> float:
    """The least capacity factor (above 1.25) at which no (token,
    choice) pair of ``routes`` (one ``[T, k]`` index tensor a router
    call, each cut into ``shards`` row blocks routed apart) drops."""
    import torch

    cf = 1.25
    for idx in routes:
        for part in idx.chunk(shards):
            t = part.shape[0]
            need = int(torch.bincount(part.reshape(-1), minlength=e).max())
            cf = max(cf, need * e / (k * t))
            while _capacity(t, k, e, cf) < need:
                cf *= 1 + 1e-6
    return cf


def drops_at(routes: list, e: int, k: int, cf: float) -> int:
    """(token, choice) pairs that reach their expert's capacity."""
    import torch

    n = 0
    for idx in routes:
        counts = torch.bincount(idx.reshape(-1), minlength=e)
        cap = _capacity(idx.shape[0], k, e, cf)
        n += int((counts - cap).clamp_min(0).sum())
    return n


def _deepseek_ep(n_layers: int, **overrides):
    """(EP config, dense config, seed-0 float32 weights on the card):
    deepseek-v2-lite at full width cut to ``n_layers``, remat off (the
    router runs once a layer, so recorded routes replay in order)."""
    cfg, params = _model(DEEPSEEK, "float32", n_layers)
    cfg = dataclasses.replace(cfg, moe_impl="ep", remat=False, **overrides)
    return cfg, dataclasses.replace(cfg, moe_impl="dense"), params


def _lm_batch(vocab: int, rows: int, seq: int, seed: int) -> dict:
    """int32 tokens and labels (a few ignored) as numpy, from ``seed``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (rows, seq + 1))
    labels = toks[:, 1:].astype(np.int32)
    labels[0, :8] = -1
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": labels}


def mesh_nccl(root: pathlib.Path) -> dict:
    """The production backend in a world of one: NCCL's version;
    deepseek-v2-lite (full width, MESH_NCCL_LAYERS, float32) through
    ``moe_impl="ep"`` on a (1,1) mesh against the dense path with its
    routes replayed, both wires; the drops at the configuration's
    capacity factor; one train step (EP, ZeRO on) against the dense
    one; the EP block timed beside the dense block.  Returns the
    launch counts of the EP runs."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import log_collectives, make_mesh
    from repro_torch.models import moe
    from repro_torch.models.transformer import (
        Runtime,
        layer_params,
        tp_plan,
    )
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import (
        TrainConfig,
        make_train_step,
        value_and_grad,
    )

    print(f"mesh nccl: NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}"
          f", a world of one", flush=True)
    dist.init_process_group(
        "nccl", store=dist.FileStore(str(root / "nccl_store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        rt = Runtime(make_mesh((1, 1), device=DEVICE))
        cfg, dense, params = _deepseek_ep(MESH_NCCL_LAYERS)
        e, k = cfg.n_experts, cfg.moe_top_k
        n, length, steps = MESH_PARITY
        batch = {"tokens": _tokens(cfg, n, length)}
        routes: list = []
        want, fed = _path(dense, params, batch, length + steps, steps,
                          [moe_routes(record=routes)])
        cf = no_drop_cf(routes, e, k)
        prefill_calls = cfg.n_layers
        print(f"mesh nccl: drops at capacity factor {cfg.capacity_factor}"
              f": prefill {drops_at(routes[:prefill_calls], e, k, cfg.capacity_factor)}"
              f" of {n * length * k} (token, choice) pairs, decode "
              f"{drops_at(routes[prefill_calls:], e, k, cfg.capacity_factor)}"
              f" of {steps * n * k}; no drop at {cf!r}", flush=True)
        _reset_counts()
        counts = {}
        for wire in ("native", "int8"):
            ep = dataclasses.replace(cfg, capacity_factor=cf,
                                     moe_dispatch_dtype=wire)
            with log_collectives() as log:
                got, _ = _path(ep, params, batch, length + steps, steps,
                               [moe_routes(replay=routes)], feed=fed, rt=rt)
            if wire == "native":
                plan = tp_plan(ep, rt)
                kinds = collections.Counter(k for k, _, _ in log)
                print(f"mesh nccl: tensor parallelism over groups of one "
                      f"(attention {plan.attn}, shared experts "
                      f"{plan.shared}, vocab {plan.vocab}): {dict(kinds)} "
                      f"over groups of {sorted({g for _, g, _ in log})}",
                      flush=True)
                check(plan.attn and plan.shared and plan.vocab
                      and kinds["all-reduce"] > 0
                      and {g for _, g, _ in log} == {1},
                      "the world of one did not run the tensor-parallel "
                      "path over groups of one")
            err = _rel(want, got)
            limit = MESH_LOGIT_TOL if wire == "native" \
                else MESH_INT8_STEPS * cfg.n_layers
            print(f"mesh nccl: {DEEPSEEK} {cfg.n_layers} layers float32, "
                  f"{n} x {length} prefill + {steps} decode steps, EP "
                  f"{wire} wire vs dense: max |dlogits| / max |logits| "
                  f"{err!r} (limit {limit!r})", flush=True)
            check(err <= limit,
                  f"the EP path ({wire} wire) differs from the dense path")
            del got
        counts = _counts()
        del want

        # the EP block beside the dense block (layer 0, the prefill's
        # tokens, the configuration's capacity factor)
        lp = layer_params(params, 0)
        x = torch.randn((n, length, cfg.d_model), device=DEVICE,
                        generator=torch.Generator(device=DEVICE)
                        .manual_seed(1))
        times = {}
        with torch.no_grad():
            for wire in ("native", "int8"):
                dims = moe.MoeDims(e, k, cfg.d_model, cfg.d_ff_expert,
                                   cfg.capacity_factor, wire)
                times[f"ep {wire}"] = time_ms(lambda: moe.moe_ffn_ep(
                    x, lp["router"], lp["ew1"], lp["ew3"], lp["ew2"], dims,
                    rt.mesh, batch_axes=("data",)))
            dims = moe.MoeDims(e, k, cfg.d_model, cfg.d_ff_expert)
            times["dense"] = time_ms(lambda: moe.moe_ffn_dense(
                x.view(-1, cfg.d_model), lp["router"], lp["ew1"],
                lp["ew3"], lp["ew2"], dims))
        print(f"mesh nccl: MoE block, {n} x {length} tokens float32, "
              f"capacity factor {cfg.capacity_factor} (events, ms): "
              f"{json.dumps(times)}", flush=True)
        del params, lp, x
        _free()

        # one train step: gradients (routes replayed) and the EP step
        layers, rows, seq = MESH_TRAIN
        cfg, dense, params = _deepseek_ep(layers)
        host = _lm_batch(cfg.vocab_size, rows, seq, 2)
        on_card = {key: torch.from_numpy(v).to(DEVICE)
                   for key, v in host.items()}
        routes = []
        with moe_routes(record=routes):
            loss_d, grads_d = value_and_grad(params, dense, on_card)
        ep = dataclasses.replace(cfg, capacity_factor=no_drop_cf(
            routes, e, k))
        _reset_counts()
        with moe_routes(replay=routes):
            loss_e, grads_e = value_and_grad(
                params, ep, make_global_batch(host, rt.mesh), rt)
        train_counts = _counts()
        l_err = abs(float(loss_e) - float(loss_d)) / abs(float(loss_d))
        g_err = _grad_err(grads_e, grads_d)
        del grads_d, grads_e
        tcfg = TrainConfig(optimizer=AdamWConfig(zero_shard=True))
        state = adamw_init(params, tcfg.optimizer)
        _reset_counts()
        with moe_routes(replay=routes):
            params, state, metrics = make_train_step(ep, tcfg, rt)(
                params, state, host)
        train_counts = {name: n + train_counts[name]
                        for name, n in _counts().items()}
        s_err = abs(float(metrics["loss"]) - float(loss_d)) \
            / abs(float(loss_d))
        print(f"mesh nccl: train step, {layers} layers, {rows} x {seq} "
              f"tokens float32, EP (ZeRO on) vs dense: loss rel err "
              f"{l_err!r}, the step's {s_err!r} (limit {MESH_LOSS_TOL}); "
              f"gradients max |dg| / max |g| {g_err!r} (limit "
              f"{MESH_GRAD_TOL})", flush=True)
        check(l_err <= MESH_LOSS_TOL and s_err <= MESH_LOSS_TOL
              and g_err <= MESH_GRAD_TOL,
              "the EP train step differs from the dense one")
        counts = {name: n + train_counts[name] for name, n in counts.items()}
        del params, state
        _free()
    finally:
        dist.destroy_process_group()
    return counts


def _card_rank() -> None:
    """A gloo rank's settings on the card: float32 products without
    TF32, as the one-process checks run them."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def spawn_world(fn, world: int, root: pathlib.Path, *args) -> list:
    """``fn(rank, *args)`` on ``world`` spawned gloo ranks sharing the
    card (``run_world``); their results in rank order.  A rank's
    exception, a rank still running MESH_DEADLINE_S after the spawn, or
    one that does not join within MESH_TIMEOUT_S fails the phase."""
    from repro_torch.launch.mesh import run_world

    try:
        return run_world(fn, world, root, *args, backend="gloo",
                         device=DEVICE, threads=2,      # 8 cores, 4 ranks
                         timeout_s=MESH_TIMEOUT_S,
                         deadline_s=MESH_DEADLINE_S)
    except RuntimeError as exc:
        fail(f"mesh {fn.__name__}: {exc}")


def _probe_collectives(mesh) -> dict:
    """Which of the port's collectives gloo takes on CUDA tensors."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    x = torch.arange(8, dtype=torch.float32, device=DEVICE) + dist.get_rank()
    calls = {
        "all_reduce SUM": lambda: dist.all_reduce(x.clone()),
        "all_reduce MAX": lambda: dist.all_reduce(
            x.clone(), op=dist.ReduceOp.MAX),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * world, device=DEVICE), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(8, device=DEVICE), x),
        "broadcast": lambda: dist.broadcast(x.clone(), 0)}
    out = {}
    for name in MESH_COLLECTIVES:
        try:
            calls[name]()
            torch.cuda.synchronize()
            out[name] = "takes"
        except RuntimeError as exc:
            out[name] = f"refuses ({str(exc).splitlines()[0][:80]})"
    return out


def _compressed_cuda_vs_cpu(mesh) -> dict:
    """``compressed_psum`` in each mode on CUDA and on CPU tensors over
    the ``"data"`` group: (int8 equal; bf16 and none within the rounding
    of two orders of an n-term sum in the wire's dtype, n - 1 units in
    the last place of the sum of the terms' magnitudes)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.train.grad_compress import compressed_psum

    world = dist.get_world_size()
    scales = (1.0, 3.0, 0.01, 50.0)
    terms = [torch.randn(4096, generator=torch.Generator().manual_seed(r))
             * scales[r % len(scales)] for r in range(world)]
    g = terms[dist.get_rank()]
    out = {}
    for mode in ("int8", "bf16", "none"):
        card = compressed_psum(g.to(DEVICE), mesh.group("data"),
                               mode=mode).cpu()
        host = compressed_psum(g, mesh.group("data"), mode=mode)
        if mode == "int8":
            out[mode] = bool(torch.equal(card, host))
            continue
        wire = torch.stack(terms)
        if mode == "bf16":
            wire = wire.bfloat16()
        mag = wire.double().abs().sum(0).float().numpy()
        spacing = np.spacing(mag).astype(np.float64)
        if mode == "bf16":
            spacing = spacing * 2.0 ** 16
        out[mode] = bool((np.abs(card.numpy().astype(np.float64)
                                 - host.numpy()) <= (world - 1) * spacing
                          ).all())
    return out


def _broadcast_routes(routes: list, t: int, k: int, n_calls: int) -> list:
    """Rank 0's recorded routes (``n_calls`` ``[t, k]`` tensors) on every
    rank."""
    import torch
    import torch.distributed as dist

    out = []
    for i in range(n_calls):
        idx = routes[i].contiguous() if routes else torch.empty(
            (t, k), dtype=torch.int64, device=DEVICE)
        dist.broadcast(idx, 0)
        out.append(idx)
    return out


def _ep_rank(rank: int) -> dict:
    """(a) on the (2,2) mesh: the EP block and forward_train's loss and
    gradients against rank 0's one-process dense path, routes replayed,
    at a capacity factor that drops nothing."""
    import torch

    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import (
        Placement,
        gather_tree,
        make_mesh,
        shard_tree,
    )
    from repro_torch.models import moe
    from repro_torch.models.transformer import (
        Runtime,
        layer_params,
        param_placements,
    )
    from repro_torch.train._tree import leaves, unflatten
    from repro_torch.train.trainer import reduce_grads, value_and_grad

    mesh = make_mesh((2, 2), device=DEVICE)
    rt = Runtime(mesh)
    cfg, dense, full = _deepseek_ep(MESH_EP_LAYERS)
    e, k, d = cfg.n_experts, cfg.moe_top_k, cfg.d_model
    rows, seq = MESH_EP_BATCH
    t = rows * seq
    shards = mesh.shape["data"]
    i = mesh.coord("data")
    x = torch.randn((rows, seq, d), device=DEVICE,
                    generator=torch.Generator(device=DEVICE).manual_seed(1))
    lp = layer_params(full, 0)
    dims = moe.MoeDims(e, k, d, cfg.d_ff_expert)
    rec: list = []
    want_y = None
    if rank == 0:
        with torch.no_grad(), moe_routes(record=rec):
            want_y = moe.moe_ffn_dense(x.view(-1, d), lp["router"],
                                       lp["ew1"], lp["ew3"], lp["ew2"],
                                       dims).view(rows, seq, d)
    block_routes = _broadcast_routes(rec, t, k, 1)
    host = _lm_batch(cfg.vocab_size, rows, seq, 3)
    rec = []
    if rank == 0:
        on_card = {key: torch.from_numpy(v).to(DEVICE)
                   for key, v in host.items()}
        with moe_routes(record=rec):
            loss_d, grads_d = value_and_grad(full, dense, on_card)
    routes = _broadcast_routes(rec, t, k, cfg.n_layers)
    cf = no_drop_cf(block_routes + routes, e, k, shards)
    pl = param_placements(cfg, rt)
    params = shard_tree(full, pl)
    del full, lp
    _free()

    # the block: this rank's rows of x through its expert slices
    mine = slice(i * (rows // shards), (i + 1) * (rows // shards))
    lp = layer_params(params, 0)
    dims_ep = moe.MoeDims(e, k, d, cfg.d_ff_expert, cf)
    with torch.no_grad(), moe_routes(replay=[
            r.view(shards, -1, k)[i] for r in block_routes]):
        y = moe.moe_ffn_ep(x[mine], lp["router"], lp["ew1"], lp["ew3"],
                           lp["ew2"], dims_ep, mesh, batch_axes=("data",))
    y = Placement(mesh, ("data",)).gather(y)
    out = {"cf": cf}
    if rank == 0:
        out["block"] = float((y - want_y).abs().max()) \
            / float(want_y.abs().max())
    del y, want_y

    # forward_train's loss and gradients, routes replayed
    ep = dataclasses.replace(cfg, capacity_factor=cf)
    _reset_counts()
    with moe_routes(replay=[r.view(shards, -1, k)[i] for r in routes]):
        loss, grads = value_and_grad(
            params, ep, make_global_batch(host, mesh), rt)
    grads = reduce_grads(grads, pl)
    full_g = leaves(gather_tree(unflatten(params, grads), pl))
    out["counts"] = _counts()
    del grads
    if rank != 0:
        del full_g
    # the other ranks' cached blocks go back to the card before rank 0
    # compares its full gradients
    _free()
    torch.distributed.barrier()
    if rank == 0:
        out["loss"] = abs(float(loss) - float(loss_d)) / abs(float(loss_d))
        out["grads"] = _grad_err(full_g, grads_d)
        del full_g, grads_d
    _free()
    out["engine"] = _engine_rank(ep, params, rt)
    return out


def _engine_rank(cfg, params, rt) -> dict:
    """The serving engine with ``rt``: three requests, then two more one
    step later (a slot refilled mid-batch on each rank's shard); every
    request's tokens, the launch counts and the wall."""
    import torch

    from repro_torch.serve.engine import EngineConfig, ServingEngine

    slots, cache, new = MESH_ENGINE
    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch=slots, cache_len=cache, max_new_tokens=new,
        eos_token=-1), rt)
    gen = torch.Generator().manual_seed(5)
    prompts = [torch.randint(1, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in MESH_ENGINE_PROMPTS]
    _reset_counts()
    tic = time.perf_counter()
    for prompt in prompts[:3]:
        engine.submit(prompt)
    engine.step()
    for prompt in prompts[3:]:
        engine.submit(prompt)
    done = engine.run_to_completion()
    return {"tokens": {r.rid: r.generated for r in done},
            "truncated": any(r.truncated for r in done),
            "vocab": cfg.vocab_size, "counts": _counts(),
            "s": time.perf_counter() - tic}


def _dp_rank(rank: int, mesh) -> dict:
    """(b) tinyllama-1.1b at full width (MESH_DP_LAYERS, float32) on
    ``mesh``, a ``"data"`` mesh of 4: MESH_DP_STEPS steps with ZeRO-2,
    then without, against rank 0's one-process step on the same global
    batches."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMStream
    from repro_torch.launch.mesh import shard_tree
    from repro_torch.models.transformer import Runtime, init_params
    from repro_torch.train._tree import leaves
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import (
        TrainConfig,
        make_train_step,
        train_placements,
    )

    rt = Runtime(mesh)
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32",
                              n_layers=MESH_DP_LAYERS)
    rows, seq = MESH_DP_BATCH
    stream = SyntheticLMStream(DataConfig(vocab_size=cfg.vocab_size,
                                          seq_len=seq, global_batch=rows))
    batches = [stream.batch(s) for s in range(MESH_DP_STEPS)]

    def run(zero: bool, runtime):
        tcfg = TrainConfig(optimizer=AdamWConfig(
            lr=3e-5, warmup_steps=1, total_steps=MESH_DP_STEPS,
            zero_shard=zero))
        params = init_params(cfg, torch.Generator(device=DEVICE)
                             .manual_seed(0), DEVICE)
        if runtime is None:
            state = adamw_init(params, tcfg.optimizer)
        else:
            pl = train_placements(cfg, tcfg, runtime)
            params = shard_tree(params, pl["params"])
            state = adamw_init(params, tcfg.optimizer,
                               placements=pl["params"])
        step = make_train_step(cfg, tcfg, runtime)
        losses, walls = [], []
        for batch in batches:
            torch.cuda.synchronize()
            tic = time.perf_counter()
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
            walls.append(time.perf_counter() - tic)
        moments = leaves(state["m"]) + leaves(state["v"])
        nbytes = sum(m.numel() * m.element_size() for m in moments)
        return losses, [p.cpu() for p in leaves(params)], nbytes, walls

    on = run(True, rt)
    off = run(False, rt)
    out = {"moment_bytes": (on[2], off[2]), "walls": on[3],
           "bit_identical": on[0] == off[0] and all(
               torch.equal(a, b) for a, b in zip(on[1], off[1]))}
    del off
    if rank == 0:
        ref = run(False, None)
        out["loss"] = max(abs(a - b) / abs(b) for a, b in zip(on[0], ref[0]))
        out["params"] = _grad_err(on[1], ref[1])
        out["walls_one"] = ref[3]
    return out


def _drill_rank(rank: int, ckpt: str, shape: tuple, crash_at) -> dict:
    """(c) run_elastic on a ``"data"`` mesh of ``shape`` (reduced
    tinyllama, ZeRO on), crashing after ``crash_at`` where given."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.transformer import Runtime
    from repro_torch.train.elastic import (
        CrashRequested,
        ElasticRun,
        run_elastic,
    )
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig

    _card_rank()
    total, _, every = MESH_DRILL
    cfg = get_config(ARCH).reduced()
    run = ElasticRun(
        cfg=cfg, tcfg=TrainConfig(optimizer=AdamWConfig(
            lr=1e-3, warmup_steps=2, total_steps=total, zero_shard=True)),
        data=DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                        global_batch=8),
        ckpt_dir=pathlib.Path(ckpt), ckpt_every=every)
    rt = Runtime(make_mesh(shape, device=DEVICE))
    try:
        res = run_elastic(run, total_steps=total, rt=rt, crash_at=crash_at)
    except CrashRequested:
        return {"crashed": True}
    return {"history": res["history"], "resumed_from": res["resumed_from"]}


def _held(*trees) -> int:
    """Bytes of the distinct storages under ``trees``."""
    from repro_torch.launch._count import tensors_of

    seen = {}
    for t in tensors_of(trees):
        st = t.untyped_storage()
        seen[st.data_ptr(), st.nbytes()] = st.nbytes()
    return sum(seen.values())


def _tp_exact(rank: int, mesh, models: dict = MESH_TP_CONFIGS,
              kinds: tuple = ("train", "prefill", "decode")) -> dict:
    """(d), (e), (f) on (2,2): one step of each kind of ``kinds`` of
    each model of ``models`` (arch → config overrides) at MESH_TP_EXACT,
    each under a collective log: {(arch, kind): (log, bytes held)}."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import log_collectives, shard_tree
    from repro_torch.models import transformer as tf
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.trainer import TrainConfig, make_train_step

    rt = tf.Runtime(mesh)
    rows, seq = MESH_TP_EXACT
    out = {}
    for arch, overrides in models.items():
        cfg = dataclasses.replace(get_config(arch), **overrides)
        pls = tf.param_placements(cfg, rt)
        params = shard_tree(tf.init_params(
            cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE), pls)
        host = _lm_batch(cfg.vocab_size, rows, seq, 5)
        if "train" in kinds:
            ocfg = dryrun.train_optimizer(cfg, mesh)
            opt = adamw_init(params, ocfg, placements=pls)
            step = make_train_step(cfg, TrainConfig(optimizer=ocfg), rt)
            held = _held(params, opt)   # the step cuts its rows from host
            with log_collectives() as log:
                step(params, opt, host)
            out[arch, "train"] = (list(log), held)
            del opt
        batch = make_global_batch(host, mesh)
        batch.pop("labels")
        if "prefill" in kinds:
            held = _held(params, batch)
            with torch.no_grad(), log_collectives() as log:
                tf.prefill(params, cfg, batch, cache_len=seq, rt=rt)
            out[arch, "prefill"] = (list(log), held)
        with torch.no_grad():
            _, state = tf.prefill(params, cfg,
                                  {"tokens": batch["tokens"][:, :4]},
                                  cache_len=seq, rt=rt)
            tokens = batch["tokens"][:, 0].contiguous()
            held = _held(params, state, tokens)
            with log_collectives() as log:
                tf.decode_step(params, cfg, state, tokens,
                               live=[True] * tokens.shape[0], rt=rt)
        out[arch, "decode"] = (list(log), held)
        del params, state
        _free()
    return out


def tp_counted(models: dict = MESH_TP_CONFIGS,
               kinds: tuple = ("train", "prefill", "decode"),
               coords: tuple | None = None) -> dict:
    """The dry-run counter's collectives and argument bytes of the
    ``_tp_exact`` cells on an abstract (2,2) mesh (``meta``, this
    process), as its rank 0 or the rank at ``coords``."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun

    rows, seq = MESH_TP_EXACT
    out = {}
    for arch, overrides in models.items():
        for kind in kinds:
            res = dryrun.count_cell(arch, ShapeCell(kind, seq, rows, kind),
                                    overrides, "pod2x2", coords)
            out[arch, kind] = (res["collective_log"],
                               res["memory"]["argument_bytes"])
    return out


def _tp_rank(rank: int) -> dict:
    """(d) tensor parallelism: tinyllama-1.1b (full width,
    MESH_TP_LAYERS, float32) on each mesh of MESH_TP_MESHES against rank
    0's one process: prefill and decode logits (gathered over the batch
    axes and the vocab), the loss and the gathered, reduced gradients of
    one batch, the serving engine's tokens; then ``_tp_exact``."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import (
        batch_axes,
        gather_tree,
        make_mesh,
        shard_tree,
    )
    from repro_torch.models import transformer as tf
    from repro_torch.train._tree import leaves, unflatten
    from repro_torch.train.trainer import reduce_grads, value_and_grad

    cfg = dataclasses.replace(get_config(ARCH), **MESH_TP_CONFIGS[ARCH])
    full = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                          DEVICE)
    n, length, steps = MESH_TP_PARITY
    toks = _tokens(cfg, n, length)
    feed = _tokens(cfg, steps, n, seed=3)
    host = _lm_batch(cfg.vocab_size, *MESH_TP_TRAIN, 4)
    want = None
    if rank == 0:
        want, _ = _path(cfg, full, {"tokens": toks}, length + steps, steps,
                        [], feed=feed)
        loss_1, grads_1 = value_and_grad(
            full, cfg, {k: torch.from_numpy(v).to(DEVICE)
                        for k, v in host.items()})
        engine_1 = _engine_rank(cfg, full, tf.Runtime())["tokens"]
    out = {}
    for shape in MESH_TP_MESHES:
        tic = time.perf_counter()
        mesh = make_mesh(shape, device=DEVICE)
        rt = tf.Runtime(mesh)
        pl = tf.param_placements(cfg, rt)
        params = shard_tree(full, pl)
        plan = tf.tp_plan(cfg, rt)
        have = (batch_axes(mesh), "model" if plan.vocab else None)

        def rows(t):
            return make_global_batch({"t": t}, mesh)["t"]

        _reset_counts()
        got, _ = _path(cfg, params, {"tokens": rows(toks)}, length + steps,
                       steps, [], feed=[rows(t) for t in feed], rt=rt)
        got = [tf.constrain(x, rt, None, None, have=have) for x in got]
        loss, grads = value_and_grad(params, cfg,
                                     make_global_batch(host, mesh), rt)
        grads = reduce_grads(grads, pl)
        g_full = leaves(gather_tree(unflatten(params, grads), pl))
        res = {"counts": _counts(),
               "heads": (cfg.n_heads // plan.size, plan.kv_heads(cfg)),
               "engine": _engine_rank(cfg, params, rt)}
        del grads
        if rank == 0:
            res["logits"] = _rel(want, got)
            res["loss"] = abs(float(loss) - float(loss_1)) \
                / abs(float(loss_1))
            res["grads"] = _grad_err(g_full, grads_1)
            res["engine_one"] = engine_1
        del got, g_full, params
        _free()
        res["s"] = time.perf_counter() - tic
        out[shape] = res
        if shape == (2, 2):
            del full
            _free()
            out["exact"] = _tp_exact(rank, mesh)
    return out


def _main_rank(rank: int, ckpt: str) -> dict:
    """The four-rank world's work in order: the collectives gloo takes,
    the compressed all-reduce, (a), (b), (d) and the clean drill."""
    from repro_torch.launch.mesh import make_mesh

    _card_rank()
    mesh = make_mesh((4, 1), device=DEVICE)
    out = {"collectives": _probe_collectives(mesh),
           "compressed": _compressed_cuda_vs_cpu(mesh)}
    tic = time.perf_counter()
    out["ep"] = _ep_rank(rank)
    _free()
    out["ep_s"] = time.perf_counter() - tic
    tic = time.perf_counter()
    out["dp"] = _dp_rank(rank, mesh)
    _free()
    out["dp_s"] = time.perf_counter() - tic
    tic = time.perf_counter()
    out["tp"] = _tp_rank(rank)
    _free()
    out["tp_s"] = time.perf_counter() - tic
    out["clean"] = _drill_rank(rank, ckpt, (4, 1), None)
    return out


def mesh_gloo(root: pathlib.Path) -> dict:
    """Four gloo ranks sharing the card: which collectives gloo takes on
    CUDA tensors, the compressed all-reduce on CUDA vs CPU tensors, (a)
    expert parallelism on (2,2), (b) ZeRO-2 data-parallel training on a
    ``"data"`` mesh of 4, (c) the 4 → 2 mesh-change drill.  Returns the
    (a) run's launch counts on rank 0.  gloo stages CUDA tensors
    through host memory: its times are no performance figure."""
    tic = time.perf_counter()
    main = spawn_world(_main_rank, 4, root / "main", str(root / "clean_ckpt"))
    first = main[0]
    print(f"mesh gloo: 4 ranks on one card, collectives on CUDA tensors: "
          f"{json.dumps(first['collectives'])}", flush=True)
    check(all(v == "takes" for res in main
              for v in res["collectives"].values()),
          "gloo refuses a collective the port uses on CUDA tensors")
    print(f"mesh gloo: compressed_psum CUDA vs CPU tensors (int8 equal, "
          f"bf16 / none within n - 1 ulp of the terms' magnitude): "
          f"{json.dumps([res['compressed'] for res in main])}", flush=True)
    check(all(all(res["compressed"].values()) for res in main),
          "compressed_psum on CUDA tensors differs from CPU tensors")
    ep = first["ep"]
    print(f"mesh gloo (a): {DEEPSEEK} {MESH_EP_LAYERS} layers float32 on "
          f"(2,2), {MESH_EP_BATCH[0]} x {MESH_EP_BATCH[1]} tokens, "
          f"capacity factor {ep['cf']!r} (no drop), routes replayed: EP "
          f"block max |dy| / max |y| {ep['block']!r} (limit "
          f"{MESH_BLOCK_TOL}); loss rel err {ep['loss']!r} (limit "
          f"{MESH_LOSS_TOL}); gradients max |dg| / max |g| "
          f"{ep['grads']!r} (limit {MESH_GRAD_TOL}); launches by rank "
          f"{json.dumps([res['ep']['counts'] for res in main])}; "
          f"{first['ep_s']:.3f} s (gloo through host memory: no "
          "performance figure)", flush=True)
    check(ep["block"] <= MESH_BLOCK_TOL and ep["loss"] <= MESH_LOSS_TOL
          and ep["grads"] <= MESH_GRAD_TOL,
          "expert parallelism on (2,2) differs from the dense path")
    check(all(res["ep"]["counts"][name] > 0 for res in main
              for name in ("flash_attention", "flash_attention_bwd")),
          "a rank's EP run launched no attention kernel")
    served = [res["ep"]["engine"] for res in main]
    tokens = served[0]["tokens"]
    print(f"mesh gloo (a): ServingEngine(rt) on (2,2), "
          f"{len(MESH_ENGINE_PROMPTS)} requests on {MESH_ENGINE[0]} slots "
          f"(two refilled mid-batch), {MESH_ENGINE[2]} tokens each: "
          f"{json.dumps(tokens)}; the same on every rank: "
          f"{all(e['tokens'] == tokens for e in served)}; launches by rank "
          f"{json.dumps([e['counts'] for e in served])}; "
          f"{served[0]['s']:.3f} s (gloo: no performance figure)",
          flush=True)
    check(all(e["tokens"] == tokens and not e["truncated"] for e in served)
          and sorted(tokens) == list(range(len(MESH_ENGINE_PROMPTS)))
          and all(len(t) == MESH_ENGINE[2] and all(
              0 <= x < served[0]["vocab"] for x in t)
              for t in tokens.values()),
          "the serving engine on the mesh gave different or malformed "
          "tokens")
    check(all(e["counts"][name] > 0 for e in served
              for name in MLA_KERNELS),
          "a rank's serving engine launched no prefill or MLA decode "
          "kernel")
    dp = first["dp"]
    moments = [res["dp"]["moment_bytes"] for res in main]
    print(f"mesh gloo (b): {ARCH} {MESH_DP_LAYERS} layers float32 on a "
          f"data mesh of 4, {MESH_DP_STEPS} steps of {MESH_DP_BATCH[0]} x "
          f"{MESH_DP_BATCH[1]} tokens, ZeRO-2 vs one process: loss rel err "
          f"{dp['loss']!r} (limit {MESH_LOSS_TOL}), parameters max |dp| / "
          f"max |p| {dp['params']!r} (limit {MESH_PARAM_TOL}); ZeRO on vs "
          f"off bit-identical on every rank: "
          f"{all(res['dp']['bit_identical'] for res in main)}; moment "
          f"bytes by rank (ZeRO on, off) {json.dumps(moments)}; step "
          f"walls (s, gloo: no "
          f"performance figure) {json.dumps(dp['walls'])}, one process "
          f"{json.dumps(dp['walls_one'])}", flush=True)
    check(dp["loss"] <= MESH_LOSS_TOL and dp["params"] <= MESH_PARAM_TOL,
          "ZeRO-2 data-parallel training differs from one process")
    check(all(res["dp"]["bit_identical"] for res in main),
          "ZeRO on and off give different parameters")
    check(all(on < off for on, off in moments),
          "ZeRO-2 did not shrink a rank's moments")
    tp_check(main, first)
    total, crash_at, every = MESH_DRILL
    ckpt = root / "drill_ckpt"
    crashed = spawn_world(_drill_rank, 4, root / "crash", str(ckpt), (4, 1),
                          crash_at)
    check(all(res.get("crashed") for res in crashed),
          "the drill's 4 ranks did not crash")
    resumed = spawn_world(_drill_rank, 2, root / "resume", str(ckpt), (2, 1),
                          None)
    clean = {h["step"]: h["loss"] for h in first["clean"]["history"]}
    worst = max(abs(h["loss"] - clean[h["step"]]) / abs(clean[h["step"]])
                for res in resumed for h in res["history"])
    starts = {res["resumed_from"] for res in resumed}
    print(f"mesh gloo (c): 4 ranks crash after step {crash_at}, 2 ranks "
          f"resume at {sorted(starts)}: loss rel err vs the clean 4-rank "
          f"run {worst!r} (limit {MESH_DRILL_TOL})", flush=True)
    check(starts == {crash_at} and worst <= MESH_DRILL_TOL,
          "the mesh-change drill diverged")
    print(f"phase mesh gloo: {time.perf_counter() - tic:.3f} s", flush=True)
    return first["ep"]["counts"]


def tp_check(main: list, first: dict) -> None:
    """(d)'s lines and checks: parity with one process, the engine, the
    local heads' launches, and the collectives and held bytes against
    the dry-run counter's."""
    n, length, steps = MESH_TP_PARITY
    for shape in MESH_TP_MESHES:
        res = first["tp"][shape]
        engines = [r["tp"][shape]["engine"] for r in main]
        tokens = engines[0]["tokens"]
        q, kv = res["heads"]
        print(f"mesh gloo (d): {ARCH} {MESH_TP_LAYERS} layers float32 on "
              f"{shape}, {q} query heads over {kv} KV head(s) a rank: "
              f"prefill {n} x {length} + {steps} decode steps, max "
              f"|dlogits| / max |logits| {res['logits']!r} (limit "
              f"{MESH_LOGIT_TOL}); loss rel err {res['loss']!r} (limit "
              f"{MESH_LOSS_TOL}); gradients max |dg| / max |g| "
              f"{res['grads']!r} (limit {MESH_GRAD_TOL}); engine tokens "
              f"{json.dumps(tokens)}, the same on every rank "
              f"{all(e['tokens'] == tokens for e in engines)} and as one "
              f"process {tokens == res['engine_one']}; launches by rank "
              f"{json.dumps([r['tp'][shape]['counts'] for r in main])}; "
              f"{res['s']:.3f} s (gloo: no performance figure)", flush=True)
        check(res["logits"] <= MESH_LOGIT_TOL
              and res["loss"] <= MESH_LOSS_TOL
              and res["grads"] <= MESH_GRAD_TOL,
              f"tensor parallelism on {shape} differs from one process")
        check(all(e["tokens"] == tokens and not e["truncated"]
                  for e in engines) and tokens == res["engine_one"],
              f"the tensor-parallel engine on {shape} served other tokens")
        check(all(r["tp"][shape]["counts"][name] > 0 for r in main
                  for name in ("flash_attention", "flash_decode",
                               "flash_attention_bwd")),
              f"a rank of {shape} launched no attention kernel at its "
              "local head counts")
    exact_check("(d)", tp_counted(), [r["tp"]["exact"] for r in main])


def exact_check(tag: str, want: dict, ranks: list) -> None:
    """Each rank's logged collectives and held bytes of each counted
    cell equal to the dry-run counter's, exactly."""
    for key, (log, held) in sorted(want.items()):
        got = [r[key] for r in ranks]
        kinds = collections.Counter(k for k, _, _ in log)
        print(f"mesh gloo {tag} exact: {key[0]} {key[1]} on (2,2): "
              f"{len(log)} collectives {dict(kinds)}, "
              f"{sum(b for _, _, b in log)} B; every rank's log equal "
              f"{all(g[0] == log for g in got)}; held bytes {held} equal "
              f"{all(g[1] == held for g in got)}", flush=True)
        check(all(g[0] == log and g[1] == held for g in got),
              f"the dry-run counter's {key} differs from the ranks'")


# (e) the KV cache cut by sequence over "model" (shard_kv_seq) in a world
# of four gloo ranks: tinyllama-1.1b (MESH_TP_LAYERS) and
# deepseek-v2-lite (MLA's latent cache, MESH_EP_LAYERS, its experts on
# the dense path so that both runs route alike) at full width, float32,
# on each mesh of MESH_TP_MESHES against one process: a prefill of
# max(MESH_SEQ_LENGTHS) tokens a row into a cache of MESH_SEQ_CACHE
# rows, each row's length then set to one of MESH_SEQ_LENGTHS (the
# state of a prefill of that many tokens: the layers are causal), and
# MESH_SEQ_STEPS decode steps (one write crosses a slice's boundary;
# some ranks hold no valid row of a sequence): logits within
# MESH_LOGIT_TOL; tinyllama's engine tokens identical; on (2,2) one
# decode step of each model counted exactly
MESH_SEQ_CACHE = 2048
MESH_SEQ_LENGTHS = (100, 505, 700, 1500)
MESH_SEQ_STEPS = 8
MESH_SEQ_CONFIGS = {ARCH: {"dtype": "float32", "n_layers": MESH_TP_LAYERS,
                           "shard_kv_seq": True},
                    DEEPSEEK: {"dtype": "float32",
                               "n_layers": MESH_EP_LAYERS,
                               "moe_impl": "dense", "remat": False,
                               "shard_kv_seq": True}}
# (f) xLSTM's mixers cut by heads: xlstm-350m at full width cut to
# MESH_SSM_LAYERS (its one sLSTM block the last), float32, on each mesh
# of MESH_TP_MESHES against one process: a prefill of (rows, tokens)
# and decode steps (logits within MESH_LOGIT_TOL), a train batch of
# (rows, tokens) (loss within MESH_LOSS_TOL, the reduced gradients,
# gathered, within MESH_GRAD_TOL); on (2,2) a train, a prefill and a
# decode step counted exactly
MESH_SSM_LAYERS = 8
MESH_SSM_CONFIGS = {XLSTM: {"dtype": "float32",
                            "n_layers": MESH_SSM_LAYERS}}
MESH_SSM_PARITY = (4, 512, 8)
MESH_SSM_TRAIN = (4, 256)
# the gradients' limit, fixed before the first run: MESH_GRAD_TOL, or
# MESH_SSM_FLOOR_FACTOR x the floor where that is larger; the floor is
# one process's gradients moved by the weights times (1 + 1e-7 N(0, 1))
# (a rounding's worth): with random weights the mLSTM's gradients are
# ill-conditioned (its normalizer max(|q.n|, exp(-m))), and a cut mixer
# rounds its sums in another order.  CPU rehearsal, reduced xlstm at 8
# layers: floor 4.66e-4, (1,4) 1.56e-3, (2,2) 8.4e-4 (PERF.md section 2)
MESH_SSM_WEIGHT_NOISE = 1e-7
MESH_SSM_FLOOR_FACTOR = 8
# (g) hymba's attention and Mamba heads cut over "model" in blocks of
# whole heads of unequal size: hymba-1.5b at full width (25 query heads
# over 5 KV heads, 25 Mamba heads, window 1024) cut to
# MESH_HYBRID_LAYERS, float32, on each mesh of MESH_TP_MESHES against
# one process: a prefill of (rows, tokens) past the window (the rings
# wrap) and decode steps (logits within MESH_LOGIT_TOL), the serving
# engine's tokens (identical), a train batch of (rows, tokens) past the
# window (loss within MESH_LOSS_TOL, the reduced gradients, gathered,
# within the limit below); on (1,4) a planted fault the logits limit
# must fail (the uneven gather keeps the Mamba blocks in reverse order);
# on (2,2) a train, a prefill and a decode step counted exactly, each
# rank against the counter at its own "model" coordinate (its blocks)
MESH_HYBRID_LAYERS = 4
MESH_HYBRID_CONFIGS = {HYMBA: {"dtype": "float32",
                               "n_layers": MESH_HYBRID_LAYERS}}
MESH_HYBRID_PARITY = (2, 1536, 8)
MESH_HYBRID_TRAIN = (2, 1280)
# the gradients' limit, fixed before the first run: MESH_GRAD_TOL, or
# MESH_HYBRID_FLOOR_FACTOR x the floor (one process's gradients under
# weights x (1 + MESH_SSM_WEIGHT_NOISE N(0, 1)), measured in the same
# run) where that is larger (``repro_torch.launch.grad_floor``).  On
# the CPU, this config in one process (``python -m
# repro_torch.launch.grad_floor --arch hymba-1.5b --layers 4 --rows 2
# --seq 1280 --device cpu``): floor 2.709e-05 at ma_log, so the limit is
# expected at 2.2e-4 (PERF.md section 6)
MESH_HYBRID_FLOOR_FACTOR = 8


def _seq_path(cfg, params, toks, lengths, feed, rt) -> list:
    """(e)'s run: the prefill, the lengths set, the decode steps; every
    step's logits (float32)."""
    import torch

    from repro_torch.models.transformer import decode_step, prefill

    with torch.no_grad():
        logits, st = prefill(params, cfg, {"tokens": toks}, MESH_SEQ_CACHE,
                             rt=rt)
        st["lengths"] = lengths.clone()
        out = [logits.float()]
        for tok in feed:
            logits, st = decode_step(params, cfg, st, tok, rt=rt)
            out.append(logits.float())
        torch.cuda.synchronize()
    return out


def _full_logits(cfg, rt, logits: list) -> list:
    """Every row's logits over the whole vocab from this rank's."""
    from repro_torch.launch.mesh import batch_axes
    from repro_torch.models import transformer as tf

    vocab = "model" if tf.tp_plan(cfg, rt).vocab else None
    have = (batch_axes(rt.mesh), vocab)
    return [tf.constrain(x, rt, None, None, have=have) for x in logits]


def _seq_rank(rank: int) -> dict:
    """(e) on one rank: each MESH_SEQ_CONFIGS model on each mesh of
    MESH_TP_MESHES against rank 0's one process, then the exact
    counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import make_mesh, shard_tree
    from repro_torch.models import transformer as tf

    _card_rank()
    out = {}
    n = len(MESH_SEQ_LENGTHS)
    for arch, overrides in MESH_SEQ_CONFIGS.items():
        cfg = dataclasses.replace(get_config(arch), **overrides)
        full = tf.init_params(
            cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
        toks = _tokens(cfg, n, max(MESH_SEQ_LENGTHS))
        feed = _tokens(cfg, MESH_SEQ_STEPS, n, seed=3)
        lengths = torch.tensor(MESH_SEQ_LENGTHS, dtype=torch.int32,
                               device=DEVICE)
        if rank == 0:
            want = _seq_path(cfg, full, toks, lengths, feed, None)
            if arch == ARCH:
                engine_1 = _engine_rank(cfg, full, tf.Runtime())["tokens"]
        for shape in MESH_TP_MESHES:
            tic = time.perf_counter()
            mesh = make_mesh(shape, device=DEVICE)
            rt = tf.Runtime(mesh)
            params = shard_tree(full, tf.param_placements(cfg, rt))

            def rows(t):
                return make_global_batch({"t": t}, mesh)["t"]

            _reset_counts()
            got = _seq_path(cfg, params, rows(toks), rows(lengths),
                            [rows(t) for t in feed], rt)
            res = {"counts": _counts()}
            got = _full_logits(cfg, rt, got)
            if rank == 0:
                res["logits"] = _rel(want, got)
            if arch == ARCH:
                res["engine"] = _engine_rank(cfg, params, rt)
                if rank == 0:
                    res["engine_one"] = engine_1
            del got, params
            _free()
            res["s"] = time.perf_counter() - tic
            out[shape, arch] = res
            if shape == (2, 2):
                out.setdefault("exact", {}).update(_tp_exact(
                    rank, mesh, {arch: overrides}, ("decode",)))
        del full
        _free()
    return out


def _ssm_rank(rank: int) -> dict:
    """(f) on one rank: xlstm-350m on each mesh of MESH_TP_MESHES
    against rank 0's one process, then the exact counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.grad_floor import grad_floor
    from repro_torch.launch.mesh import gather_tree, make_mesh, shard_tree
    from repro_torch.models import transformer as tf
    from repro_torch.train._tree import leaves, unflatten
    from repro_torch.train.trainer import reduce_grads, value_and_grad

    _card_rank()
    cfg = dataclasses.replace(get_config(XLSTM), **MESH_SSM_CONFIGS[XLSTM])
    full = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                          DEVICE)
    n, length, steps = MESH_SSM_PARITY
    toks = _tokens(cfg, n, length)
    feed = _tokens(cfg, steps, n, seed=3)
    host = _lm_batch(cfg.vocab_size, *MESH_SSM_TRAIN, 4)
    floor = None
    if rank == 0:
        want, _ = _path(cfg, full, {"tokens": toks}, length + steps, steps,
                        [], feed=feed)
        one = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
        loss_1, grads_1, floor, _ = grad_floor(full, cfg, one,
                                               MESH_SSM_WEIGHT_NOISE)
    out = {"floor": floor}
    for shape in MESH_TP_MESHES:
        tic = time.perf_counter()
        mesh = make_mesh(shape, device=DEVICE)
        rt = tf.Runtime(mesh)
        pl = tf.param_placements(cfg, rt)
        params = shard_tree(full, pl)

        def rows(t):
            return make_global_batch({"t": t}, mesh)["t"]

        got, _ = _path(cfg, params, {"tokens": rows(toks)}, length + steps,
                       steps, [], feed=[rows(t) for t in feed], rt=rt)
        got = _full_logits(cfg, rt, got)
        loss, grads = value_and_grad(params, cfg,
                                     make_global_batch(host, mesh), rt)
        grads = reduce_grads(grads, pl)
        g_full = leaves(gather_tree(unflatten(params, grads), pl))
        res = {"heads": tf.tp_plan(cfg, rt).mix_heads(cfg)}
        if rank == 0:
            res["logits"] = _rel(want, got)
            res["loss"] = abs(float(loss) - float(loss_1)) \
                / abs(float(loss_1))
            res["grads"] = _grad_err(g_full, grads_1)
        del got, grads, g_full, params
        _free()
        res["s"] = time.perf_counter() - tic
        out[shape] = res
        if shape == (2, 2):
            del full
            _free()
            out["exact"] = _tp_exact(rank, mesh, MESH_SSM_CONFIGS)
    return out


@contextlib.contextmanager
def uneven_order_fault():
    """The planted fault of (g): the uneven gather keeps the distinct
    blocks in reverse order, so each Mamba head's columns come from
    another rank's heads."""
    import torch

    from repro_torch.launch import mesh

    inner = mesh._keep_blocks

    def reversed_blocks(full, entry, i):
        pieces = []
        for c in entry.firsts:
            a, b = entry.bounds[c]
            pieces.insert(0, full.select(i, c).narrow(i, 0, b - a))
        return torch.cat(pieces, dim=i)

    mesh._keep_blocks = reversed_blocks
    try:
        yield
    finally:
        mesh._keep_blocks = inner


def _hybrid_rank(rank: int) -> dict:
    """(g) on one rank: hymba-1.5b on each mesh of MESH_TP_MESHES
    against rank 0's one process, the planted fault on (1,4), then the
    exact counts."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.grad_floor import grad_floor
    from repro_torch.launch.mesh import gather_tree, make_mesh, shard_tree
    from repro_torch.models import transformer as tf
    from repro_torch.train._tree import leaves, unflatten
    from repro_torch.train.trainer import reduce_grads, value_and_grad

    _card_rank()
    cfg = dataclasses.replace(get_config(HYMBA),
                              **MESH_HYBRID_CONFIGS[HYMBA])
    full = tf.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0),
                          DEVICE)
    n, length, steps = MESH_HYBRID_PARITY
    toks = _tokens(cfg, n, length)
    feed = _tokens(cfg, steps, n, seed=3)
    host = _lm_batch(cfg.vocab_size, *MESH_HYBRID_TRAIN, 4)
    floor = None
    if rank == 0:
        want, _ = _path(cfg, full, {"tokens": toks}, length + steps, steps,
                        [], feed=feed)
        one = {k: torch.from_numpy(v).to(DEVICE) for k, v in host.items()}
        loss_1, grads_1, floor, _ = grad_floor(full, cfg, one,
                                               MESH_SSM_WEIGHT_NOISE)
        engine_1 = _engine_rank(cfg, full, tf.Runtime())["tokens"]
    out = {"floor": floor}
    for shape in MESH_TP_MESHES:
        tic = time.perf_counter()
        mesh = make_mesh(shape, device=DEVICE)
        rt = tf.Runtime(mesh)
        pl = tf.param_placements(cfg, rt)
        params = shard_tree(full, pl)
        plan = tf.tp_plan(cfg, rt)

        def rows(t):
            return make_global_batch({"t": t}, mesh)["t"]

        _reset_counts()
        got, _ = _path(cfg, params, {"tokens": rows(toks)}, length + steps,
                       steps, [], feed=[rows(t) for t in feed], rt=rt)
        got = _full_logits(cfg, rt, got)
        loss, grads = value_and_grad(params, cfg,
                                     make_global_batch(host, mesh), rt)
        grads = reduce_grads(grads, pl)
        g_full = leaves(gather_tree(unflatten(params, grads), pl))
        c = plan.coord
        res = {"counts": _counts(),
               "heads": tuple(b - a for a, b in (
                   plan.q_blocks[c], plan.kv_blocks[c],
                   plan.mamba_blocks[c])),
               "engine": _engine_rank(cfg, params, rt)}
        del grads
        if shape == (1, 4):
            wrong, _ = _path(cfg, params, {"tokens": rows(toks)},
                             length + steps, steps, [uneven_order_fault()],
                             feed=[rows(t) for t in feed], rt=rt)
            wrong = _full_logits(cfg, rt, wrong)
        if rank == 0:
            res["logits"] = _rel(want, got)
            res["loss"] = abs(float(loss) - float(loss_1)) \
                / abs(float(loss_1))
            res["grads"] = _grad_err(g_full, grads_1)
            res["engine_one"] = engine_1
            if shape == (1, 4):
                res["fault"] = _rel(want, wrong)
        if shape == (1, 4):
            del wrong
        del got, g_full, params
        _free()
        res["s"] = time.perf_counter() - tic
        out[shape] = res
        if shape == (2, 2):
            del full
            _free()
            out["exact"] = _tp_exact(rank, mesh, MESH_HYBRID_CONFIGS)
            out["coords"] = mesh.coords
    return out


def hybrid_check(main: list) -> None:
    """(g)'s lines and checks: parity with one process, the engine, the
    planted fault, the local heads' launches, and the exact counts."""
    first = main[0]["hybrid"]
    n, length, steps = MESH_HYBRID_PARITY
    floor = first["floor"]
    grad_tol = max(MESH_GRAD_TOL, MESH_HYBRID_FLOOR_FACTOR * floor)
    print(f"mesh gloo (g): one process's gradients under weights x (1 + "
          f"{MESH_SSM_WEIGHT_NOISE} N(0, 1)): max |dg| / max |g| {floor!r} "
          f"(the floor); gradient limit {grad_tol!r}", flush=True)
    for shape in MESH_TP_MESHES:
        res = first[shape]
        engines = [r["hybrid"][shape]["engine"] for r in main]
        tokens = engines[0]["tokens"]
        heads = [r["hybrid"][shape]["heads"] for r in main]
        print(f"mesh gloo (g): {HYMBA} {MESH_HYBRID_LAYERS} layers float32 "
              f"on {shape}, (query, KV, Mamba) heads by rank "
              f"{json.dumps(heads)}: prefill {n} x {length} (window "
              f"1024: the rings wrap) + {steps} decode steps, max |dlogits| "
              f"/ max |logits| {res['logits']!r} (limit {MESH_LOGIT_TOL}); "
              f"train {MESH_HYBRID_TRAIN[0]} x {MESH_HYBRID_TRAIN[1]}: loss "
              f"rel err {res['loss']!r} (limit {MESH_LOSS_TOL}); gradients "
              f"max |dg| / max |g| {res['grads']!r} (limit {grad_tol!r}); "
              f"engine tokens {json.dumps(tokens)}, the same on every rank "
              f"{all(e['tokens'] == tokens for e in engines)} and as one "
              f"process {tokens == res['engine_one']}; launches by rank "
              f"{json.dumps([r['hybrid'][shape]['counts'] for r in main])};"
              f" {res['s']:.3f} s (gloo: no performance figure)", flush=True)
        check(res["logits"] <= MESH_LOGIT_TOL
              and res["loss"] <= MESH_LOSS_TOL
              and res["grads"] <= grad_tol,
              f"hymba's mixers cut on {shape} differ from one process")
        check(all(e["tokens"] == tokens and not e["truncated"]
                  for e in engines) and tokens == res["engine_one"],
              f"hymba's tensor-parallel engine on {shape} served other "
              "tokens")
        check(all(r["hybrid"][shape]["counts"][name] > 0 for r in main
                  for name in ("flash_attention", "flash_decode",
                               "flash_attention_bwd")),
              f"a rank of {shape} launched no attention kernel at hymba's "
              "local head counts")
        if "fault" in res:
            print(f"mesh gloo (g): planted fault on {shape} (the uneven "
                  f"gather keeps the Mamba blocks in reverse order): max "
                  f"|dlogits| / max |logits| {res['fault']!r} against the "
                  f"limit {MESH_LOGIT_TOL}", flush=True)
            check(res["fault"] > MESH_LOGIT_TOL,
                  "the logits limit passes an uneven gather whose blocks "
                  "are out of order")
    # each rank against the counter at its own "model" coordinate: its
    # held bytes are its blocks'; the forward's collectives are the same
    # on every rank (the uneven gather pads each block to the largest),
    # the train step's gradient sums over "data" carry its own blocks
    by_coord = {c: tp_counted(MESH_HYBRID_CONFIGS, coords=(0, c))
                for c in (0, 1)}
    check(all(by_coord[0][key][0] == by_coord[1][key][0]
              for key in by_coord[0] if key[1] != "train"),
          "the counter's forward collectives differ between \"model\" "
          "coordinates")
    for c, want in by_coord.items():
        exact_check(f"(g) \"model\" {c}", want,
                    [r["hybrid"]["exact"] for r in main
                     if r["hybrid"]["coords"][1] == c])


def _seq_ssm_rank(rank: int) -> dict:
    """The second four-rank world: (e), (f), then (g)."""
    out = {"seq": _seq_rank(rank)}
    _free()
    out["ssm"] = _ssm_rank(rank)
    _free()
    tic = time.perf_counter()
    out["hybrid"] = _hybrid_rank(rank)
    out["hybrid_s"] = time.perf_counter() - tic
    return out


def seq_ssm_gloo(root: pathlib.Path) -> dict:
    """(e), (f) and (g) in a world of four gloo ranks sharing the card;
    returns rank 0's launches of the kernels (e) runs, by kernel."""
    tic = time.perf_counter()
    main = spawn_world(_seq_ssm_rank, 4, root / "seq_ssm")
    first = main[0]
    launches = collections.Counter()
    for arch, kernel in ((ARCH, "flash_decode"),
                         (DEEPSEEK, "flash_decode_mla")):
        for shape in MESH_TP_MESHES:
            res = first["seq"][shape, arch]
            counts = [r["seq"][shape, arch]["counts"] for r in main]
            launches[kernel] += res["counts"][kernel]
            print(f"mesh gloo (e): {arch} float32 on {shape}, the cache of "
                  f"{MESH_SEQ_CACHE} rows cut by sequence "
                  f"({MESH_SEQ_CACHE // shape[1]} a rank), lengths "
                  f"{MESH_SEQ_LENGTHS} + {MESH_SEQ_STEPS} decode steps: max "
                  f"|dlogits| / max |logits| {res['logits']!r} (limit "
                  f"{MESH_LOGIT_TOL}); launches by rank {json.dumps(counts)};"
                  f" {res['s']:.3f} s (gloo: no performance figure)",
                  flush=True)
            check(res["logits"] <= MESH_LOGIT_TOL,
                  f"kvseq decode of {arch} on {shape} differs from one "
                  "process")
            check(all(c[kernel] > 0 and c["flash_attention"] > 0
                      for c in counts),
                  f"a rank of {shape} launched no {kernel} with its lse or "
                  "no prefill kernel")
            if arch == ARCH:
                engines = [r["seq"][shape, arch]["engine"] for r in main]
                tokens = engines[0]["tokens"]
                print(f"mesh gloo (e): ServingEngine(rt) kvseq on {shape}: "
                      f"{json.dumps(tokens)}, the same on every rank "
                      f"{all(e['tokens'] == tokens for e in engines)} and as "
                      f"one process {tokens == res['engine_one']}",
                      flush=True)
                check(all(e["tokens"] == tokens and not e["truncated"]
                          for e in engines) and tokens == res["engine_one"],
                      f"the kvseq engine on {shape} served other tokens")
    exact_check("(e)", tp_counted(MESH_SEQ_CONFIGS, ("decode",)),
                [r["seq"]["exact"] for r in main])
    n, length, steps = MESH_SSM_PARITY
    floor = first["ssm"]["floor"]
    grad_tol = max(MESH_GRAD_TOL, MESH_SSM_FLOOR_FACTOR * floor)
    print(f"mesh gloo (f): one process's gradients under weights x (1 + "
          f"{MESH_SSM_WEIGHT_NOISE} N(0, 1)): max |dg| / max |g| {floor!r} "
          f"(the floor); gradient limit {grad_tol!r}", flush=True)
    for shape in MESH_TP_MESHES:
        res = first["ssm"][shape]
        print(f"mesh gloo (f): {XLSTM} {MESH_SSM_LAYERS} layers float32 on "
              f"{shape}, {res['heads']} head(s) a rank: prefill {n} x "
              f"{length} + {steps} decode steps, max |dlogits| / max "
              f"|logits| {res['logits']!r} (limit {MESH_LOGIT_TOL}); loss "
              f"rel err {res['loss']!r} (limit {MESH_LOSS_TOL}); gradients "
              f"max |dg| / max |g| {res['grads']!r} (limit {grad_tol!r}); "
              f"{res['s']:.3f} s (gloo: no performance figure)", flush=True)
        check(res["logits"] <= MESH_LOGIT_TOL
              and res["loss"] <= MESH_LOSS_TOL
              and res["grads"] <= grad_tol,
              f"xLSTM's mixers cut on {shape} differ from one process")
    exact_check("(f)", tp_counted(MESH_SSM_CONFIGS),
                [r["ssm"]["exact"] for r in main])
    hybrid_check(main)
    print(f"phase mesh gloo (g): {first['hybrid_s']:.3f} s of the world",
          flush=True)
    print(f"phase mesh gloo (e, f, g): {time.perf_counter() - tic:.3f} s",
          flush=True)
    return dict(launches)


def mesh_phase() -> dict:
    """The world of one on NCCL, then four gloo ranks sharing the card,
    then (e), (f) and (g) in a second world of four; the main path's kernels
    must launch in each.  Returns (e)'s launches of the decode kernels
    with their lse, by kernel (rank 0)."""
    with tempfile.TemporaryDirectory() as tmp:
        root = pathlib.Path(tmp)
        tic = time.perf_counter()
        counts = mesh_nccl(root)
        print(f"mesh nccl: launches {json.dumps(counts)}", flush=True)
        check(all(counts[name] > 0 for name in
                  ("flash_attention", "flash_decode_mla",
                   "flash_attention_bwd")),
              "the world of one's EP runs did not launch every kernel of "
              "the path")
        print(f"phase mesh nccl: {time.perf_counter() - tic:.3f} s",
              flush=True)
        _free()
        mesh_gloo(root)
        _free()
        return seq_ssm_gloo(root)


def mesh_only() -> int:
    """``--mesh``: build the prefill, backward, decode and MLA-decode
    libraries and run the mesh phase; no result line."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    import torch

    libs = (fa.LIBRARY, fa.WGMMA_LIBRARY, fa.BWD_LIBRARY,
            fa.BWD_WGMMA_LIBRARY, fd.LIBRARY, fd.MLA_LIBRARY)
    tic = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for path in pool.map(lambda lib: lib.build(), libs):
            print(f"build: {path.name}", flush=True)
    for lib in libs:
        lib.load()
    print(f"build: all in {time.perf_counter() - tic:.2f} s", flush=True)
    tic = time.perf_counter()
    lse_rows({}, torch.Generator(device=DEVICE).manual_seed(0))
    print(f"phase lse rows: {time.perf_counter() - tic:.3f} s", flush=True)
    tic = time.perf_counter()
    print(f"mesh: (e) launches {json.dumps(mesh_phase())}", flush=True)
    print(f"phase mesh: {time.perf_counter() - tic:.3f} s", flush=True)
    return 0


# ------------------------------------------------------- dryrun phase

DRYRUN_JOBS = 8                # processes of the meta dry-run's passes
#: tinyllama-1.1b's bf16 decode step at the serving shape: batch, cache
#: rows, prompt tokens before the timed steps
DRYRUN_STEP = (ARCH, 16, 2048, 512)
DRYRUN_STEPS = 10
#: the adapter's cell, its layers, rails and deadlines (x the memory
#: floor), as benchmarks/tpu_orchestration.py drives the reference's
ADAPTER_CELL = ("qwen2-7b", "decode_32k", 28)
ADAPTER_RAILS = (0.7, 0.85, 1.0)
ADAPTER_SLACK = (1.2, 2.0, 4.0)
POWER_SECONDS = 3.0            # each power condition, sampled every 100 ms
POWER_GEMM = 8192              # bf16 GEMM of POWER_GEMM^3
POWER_COPY_BYTES = 4 << 30     # device-to-device copy
#: the cells dry-run on the one card (all 40 are counted on the CPU by
#: tests/test_torch_dryrun.py and `python -m repro_torch.launch.dryrun
#: --all`): the adapter's cell and tinyllama's decode and train cells
DRYRUN_CARD_CELLS = (("qwen2-7b", "decode_32k"),
                     ("tinyllama-1.1b", "decode_32k"),
                     ("tinyllama-1.1b", "train_4k"))
#: the cells dry-run on the production meshes (every cell of them is
#: counted on the CPU: PERF.md); kimi-k2's train cell takes ZeRO;
#: xlstm-350m's train cell cuts its mixers by heads (each held by 4
#: ranks).  Their passes run on DRYRUN_JOBS processes (xLSTM's per-token
#: sLSTM loop takes the longest)
DRYRUN_POD_CELLS = (("tinyllama-1.1b", "decode_32k"),
                    ("tinyllama-1.1b", "train_4k"),
                    ("deepseek-v2-lite-16b", "train_4k"),
                    ("kimi-k2-1t-a32b", "train_4k"),
                    ("xlstm-350m", "train_4k"))
#: the cells dry-run on the production meshes with the KV cache cut by
#: sequence over "model" (the variant kvseq)
DRYRUN_SEQ_CELLS = (("qwen2-7b", "decode_32k"),)


def dryrun_cells() -> dict:
    """DRYRUN_CARD_CELLS dry-run on ``meta``, fresh; the card's HBM
    size; then the production-mesh cells."""
    import torch

    from repro_torch.hw.gpu import H100_SXM
    from repro_torch.launch import dryrun, roofline

    total = torch.cuda.get_device_properties(0).total_memory
    print(f"dryrun: {torch.cuda.get_device_name(0)} total_memory {total} "
          f"B; H100_SXM.hbm_bytes {H100_SXM.hbm_bytes} B", flush=True)
    check(total == H100_SXM.hbm_bytes,
          f"H100_SXM.hbm_bytes {H100_SXM.hbm_bytes} != the card's "
          f"total_memory {total}")
    cells = list(DRYRUN_CARD_CELLS)
    tic = time.perf_counter()
    records = dryrun.run_cells(cells, force=True)
    wall = time.perf_counter() - tic
    for (arch, shape), rec in zip(cells, records):
        check(rec["status"] == "OK",
              f"dry-run {arch} {shape}: {rec['status']} (want OK) "
              f"{rec.get('error', '')} {rec.get('traceback', '')}")
        row = roofline.analyze_record(rec)
        print(f"dryrun cell: {arch} {shape}: OK peak "
              f"{row['peak_gib']:.2f} GiB fits "
              f"{'yes' if row['fits_hbm'] else 'NO'} compute "
              f"{row['t_compute_s']:.6f} s memory {row['t_memory_s']:.6f} s "
              f"dominant {row['dominant']} (memory pass {rec['run_s']} s)",
              flush=True)
    print(f"dryrun: {len(cells)} cells in {wall:.3f} s in this process",
          flush=True)
    pod_cells(roofline)
    seq_cells(roofline)
    return {(r["arch"], r["shape"]): r for r in records}


def pod_cells(roofline) -> None:
    """DRYRUN_POD_CELLS on both production meshes: rank 0's step on an
    abstract mesh, per device, with the port's own collectives."""
    from repro_torch.launch import dryrun

    tic = time.perf_counter()
    meshes = ("pod16x16", "pod2x16x16")
    records = dryrun.run_cells(list(DRYRUN_POD_CELLS), force=True,
                               meshes=meshes, jobs=DRYRUN_JOBS)
    for rec in records:
        name = f"{rec['arch']} {rec['shape']} {rec['mesh']}"
        check(rec["status"] == "OK",
              f"dry-run {name}: {rec['status']} {rec.get('error', '')} "
              f"{rec.get('traceback', '')}")
        row = roofline.analyze_record(rec)
        coll = rec["collectives_raw"]
        print(f"dryrun pod cell: {name}: per device peak "
              f"{row['peak_gib']:.2f} GiB fits "
              f"{'yes' if row['fits_hbm'] else 'NO'}; collectives "
              f"{json.dumps(coll['counts'])} "
              f"{json.dumps(coll['bytes_per_device_by_op'])} B; layer-"
              f"differenced {rec['cost']['collective_bytes_per_device']} "
              f"B; compute {row['t_compute_s']:.6f} s memory "
              f"{row['t_memory_s']:.6f} s collective "
              f"{row['t_collective_s']:.6f} s; {rec['cost']['method']}",
              flush=True)
        check(coll["bytes_per_device_total"] > 0,
              f"dry-run {name} counted no collective")
        zero = rec["arch"] == "kimi-k2-1t-a32b"
        check(("ZeRO" in rec["cost"]["method"]) == zero,
              f"dry-run {name}: ZeRO where the reference has it not")
    print(f"dryrun: {len(records)} production-mesh records in "
          f"{time.perf_counter() - tic:.3f} s on {DRYRUN_JOBS} processes",
          flush=True)


def seq_cells(roofline) -> None:
    """DRYRUN_SEQ_CELLS on both production meshes with the variant
    kvseq, beside the baseline: a device's cache bytes must be the whole
    cache's over (batch shards x "model" ranks) and the record's
    argument bytes the parameters', state's and tokens' blocks, exactly."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import specs as sp
    from repro_torch.models.module import param_bytes

    tic = time.perf_counter()
    meshes = ("pod16x16", "pod2x16x16")
    base = dryrun.run_cells(list(DRYRUN_SEQ_CELLS), force=True,
                            meshes=meshes)
    seq = dryrun.run_cells(list(DRYRUN_SEQ_CELLS), force=True,
                           meshes=meshes, variant="kvseq")
    for rec, was in zip(seq, base):
        name = f"{rec['arch']} {rec['shape']} {rec['mesh']} kvseq"
        check(rec["status"] == "OK" and was["status"] == "OK",
              f"dry-run {name}: {rec['status']} {rec.get('error', '')} "
              f"{rec.get('traceback', '')}")
        grid = dryrun.mesh_named(rec["mesh"])
        cell = SHAPES[rec["shape"]]
        cfg = dataclasses.replace(get_config(rec["arch"]),
                                  **dryrun.variant_overrides("kvseq"))
        whole = sp._decode_state(cfg, cell, grid)
        state, _ = sp.decode_state_specs(cfg, cell, grid)
        params, _ = sp.abstract_model(cfg, grid)
        tokens, _ = sp.decode_token_specs(cell, grid)
        keys = ("ckv", "krope") if cfg.is_mla else ("k", "v")
        cache = sum(param_bytes(state[k]) for k in keys)
        cache_whole = sum(param_bytes(whole[k]) for k in keys)
        shards = grid.size // grid.shape["model"]    # the batch axes
        if cell.global_batch % shards:
            shards = 1
        held = (param_bytes(params) + param_bytes(state)
                + tokens.numel() * tokens.element_size())
        row, row_was = (roofline.analyze_record(rec),
                        roofline.analyze_record(was))
        print(f"dryrun kvseq cell: {name}: per device peak "
              f"{row['peak_gib']:.2f} GiB (without kvseq "
              f"{row_was['peak_gib']:.2f}); cache {cache} B a device of "
              f"{cache_whole} B over {shards} batch shards x "
              f"{grid.shape['model']}; argument bytes "
              f"{rec['memory']['argument_bytes']} (parameters, state and "
              f"tokens {held}); collectives "
              f"{json.dumps(rec['collectives_raw']['counts'])}", flush=True)
        check(cache * shards * grid.shape["model"] == cache_whole
              and rec["memory"]["argument_bytes"] == held,
              f"dry-run {name}: a device's cache or arguments are not the "
              "whole's cut by sequence and batch")
    print(f"dryrun: {len(seq)} kvseq records in "
          f"{time.perf_counter() - tic:.3f} s", flush=True)


def dryrun_step() -> None:
    """tinyllama-1.1b's decode step dry-run, then run on the card."""
    import torch

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.hw.gpu import H100_SXM
    from repro_torch.launch import dryrun
    from repro_torch.models import module
    from repro_torch.models import transformer as tf

    arch, batch, cache, prompt = DRYRUN_STEP
    cfg = get_config(arch)
    res = dryrun.count_cell(arch, ShapeCell("serve", cache, batch,
                                            "decode"))
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = tf.init_params(cfg, gen, DEVICE)
    with torch.no_grad():
        prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                                generator=gen, device=DEVICE)
        _, state = tf.prefill(params, cfg, {"tokens": prompts},
                              cache_len=cache)
        tok = torch.randint(0, cfg.vocab_size, (batch,), generator=gen,
                            device=DEVICE, dtype=torch.int32)
        real = (module.param_bytes(params) + module.param_bytes(state)
                + tok.numel() * tok.element_size())
        mem = res["memory"]
        print(f"dryrun step: {arch} decode batch {batch} cache {cache}: "
              f"argument bytes {mem['argument_bytes']} (real parameters, "
              f"cache and tokens {real})", flush=True)
        check(mem["argument_bytes"] == real,
              f"dry-run argument bytes {mem['argument_bytes']} != the "
              f"real step's {real}")
        live = [True] * batch
        box = [state]

        def step():
            box[0] = tf.decode_step(params, cfg, box[0], tok, live=live)[1]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        step()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ev = time_ms_b2b(step, DRYRUN_STEPS)
        dev = device_ms(step, DRYRUN_STEPS)
    t_flops = res["flops"] / H100_SXM.peak_flops_bf16 * 1e3
    t_bytes = res["bytes"] / H100_SXM.hbm_bw * 1e3
    print(f"dryrun step: counted {res['flops']} FLOPs {res['bytes']} B: "
          f"{t_flops:.5f} ms at {H100_SXM.peak_flops_bf16:.4g} FLOP/s, "
          f"{t_bytes:.5f} ms at {H100_SXM.hbm_bw:.4g} B/s; the step on the "
          f"card {ev:.5f} ms by events (back-to-back), device "
          f"{_ms(dev)}; dry-run peak {mem['peak_bytes']} B vs "
          f"max_memory_allocated {peak} B", flush=True)
    print(f"dryrun step: kernels {json.dumps(res['kernels'])}", flush=True)
    del params, state, box
    _free()


def adapter_run(records: dict) -> None:
    """The PF-DNN adapter on the port's qwen2-7b decode record, solved on
    the card and on the CPU port."""
    from repro_torch.core import refine_candidates, solve_lambda_dp
    from repro_torch.core.gpu_adapter import (
        build_gpu_problem,
        layer_costs_from_dryrun,
    )
    from repro_torch.hw.gpu import H100_SXM

    arch, shape, n_layers = ADAPTER_CELL
    rec = records[arch, shape]
    layers = layer_costs_from_dryrun(rec, n_layers)
    floor = rec["cost"]["bytes_per_device"] / H100_SXM.hbm_bw
    check(H100_SXM.v_min <= min(ADAPTER_RAILS)
          and max(ADAPTER_RAILS) <= H100_SXM.v_max, "rails off the chip")
    print(f"adapter: {arch} {shape} {n_layers} layers, rails "
          f"{ADAPTER_RAILS}, memory floor {floor * 1e3:.4f} ms; "
          "deadline_x_floor,policy,energy_j_per_step,t_step_ms", flush=True)
    for slack in ADAPTER_SLACK:
        deadline = floor * slack
        prob = build_gpu_problem(layers, ADAPTER_RAILS, deadline,
                                 name="qwen2-decode")
        out = {}
        for device in (DEVICE, "cpu"):
            _reset_counts()
            tic = time.perf_counter()
            best, cands, _ = solve_lambda_dp(prob, backend=device)
            check(best is not None, f"adapter {slack}x: infeasible")
            refined, moves = refine_candidates(prob, cands)
            wall = time.perf_counter() - tic
            out[device] = (best, cands, refined, moves, _counts(), wall)
        (best, cands, refined, moves, counts, wall) = out[DEVICE]
        cpu = out["cpu"]
        for key in ("path", "e_total", "t_infer"):
            check(best[key] == cpu[0][key] and refined[key] == cpu[2][key],
                  f"adapter {slack}x: {key} differs between card and CPU")
        check([c["path"] for c in cands] == [c["path"] for c in cpu[1]]
              and [c["e_total"] for c in cands]
              == [c["e_total"] for c in cpu[1]],
              f"adapter {slack}x: candidates differ between card and CPU")
        check(moves == cpu[3], f"adapter {slack}x: refinement differs")
        check(refined["t_infer"] <= deadline,
              f"adapter {slack}x: misses its deadline")
        for name in ("dp_multi_stacked", "kbest_multi_stacked"):
            check(counts[name] > 0, f"adapter {slack}x: {name} never "
                  "launched")
        static = prob.evaluate([
            next(i for i, st in enumerate(states)
                 if st.voltages == (1.0, 1.0, 1.0))
            for states in prob.layer_states])
        print(f"{slack},static_vmax,{static['e_total']:.4f},"
              f"{static['t_infer'] * 1e3:.3f}", flush=True)
        print(f"{slack},pfdnn,{refined['e_total']:.4f},"
              f"{refined['t_infer'] * 1e3:.3f}", flush=True)
        print(f"#   saving {(1 - refined['e_total'] / static['e_total']) * 100:.1f}%"
              f" at {slack}x deadline slack; card solve {wall:.3f} s "
              f"(CPU port {cpu[5]:.3f} s), launches "
              f"{json.dumps({k: counts[k] for k in DP_KERNELS})}; equal to "
              "the CPU port", flush=True)


def _power_draws(work) -> list[float]:
    """Power draws (W) ``nvidia-smi`` reads every 100 ms while ``work``
    runs for ``POWER_SECONDS``."""
    import torch

    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=power.draw", "--format=csv,noheader,"
         "nounits", "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        end = time.perf_counter() + POWER_SECONDS
        while time.perf_counter() < end:
            work()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=10)
    draws = []
    for line in out.splitlines():
        try:
            draws.append(float(line.strip()))
        except ValueError:
            continue
    return draws


def power_readings(smi: str) -> None:
    """The card's own draw idle, under a bf16 GEMM loop and under a
    device-copy loop, beside the chip model's nominal powers."""
    import torch

    from repro_torch.hw.gpu import H100_SXM as chip

    n = POWER_GEMM
    a = torch.randn(n, n, device=DEVICE, dtype=torch.bfloat16)
    b = torch.randn(n, n, device=DEVICE, dtype=torch.bfloat16)
    src = torch.empty(POWER_COPY_BYTES, dtype=torch.uint8, device=DEVICE)
    dst = torch.empty_like(src)

    def gemm():
        for _ in range(20):
            torch.mm(a, b)

    def copy():
        for _ in range(10):
            dst.copy_(src)

    model = {"idle": chip.p_leak_total * 1.2,
             "gemm": chip.p_sm_dyn_nom + chip.p_leak_total,
             "copy": chip.p_hbm_dyn_nom + chip.p_leak_total}
    what = {"idle": "p_idle = 1.2 x leakage",
            "gemm": "SM dynamic + leakage at v_nom",
            "copy": "HBM dynamic + leakage at v_nom"}
    print(f"power: {smi}; model: SM {chip.p_sm_dyn_nom} W, HBM "
          f"{chip.p_hbm_dyn_nom} W, NVLink {chip.p_nvlink_dyn_nom} W "
          f"dynamic, {chip.p_leak_total} W leakage", flush=True)
    for label, work in (("idle", lambda: time.sleep(0.05)), ("gemm", gemm),
                        ("copy", copy)):
        draws = _power_draws(work)
        check(len(draws) > 0, f"power {label}: nvidia-smi read nothing")
        print(f"power {label}: {len(draws)} readings, median "
              f"{statistics.median(draws):.2f} W, max {max(draws):.2f} W "
              f"(model {model[label]:.1f} W: {what[label]})", flush=True)
    del a, b, src, dst
    _free()


def dryrun_phase(smi: str) -> None:
    tic = time.perf_counter()
    records = dryrun_cells()
    dryrun_step()
    adapter_run(records)
    power_readings(smi)
    print(f"phase dryrun: {time.perf_counter() - tic:.3f} s", flush=True)


def dryrun_only(smi: str) -> int:
    """``--dryrun``: build the prefill bf16, decode and rail-sweep
    libraries and run the dryrun phase; no result line."""
    from repro_torch.kernels import dp_sweep as ks
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    libs = (fa.WGMMA_LIBRARY, fd.LIBRARY, ks.LIBRARY)
    tic = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for path in pool.map(lambda lib: lib.build(), libs):
            print(f"build: {path.name}", flush=True)
    for lib in libs:
        lib.load()
    print(f"build: all in {time.perf_counter() - tic:.2f} s", flush=True)
    dryrun_phase(smi)
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
    if argv == ["--service"]:
        return service_only()
    if argv == ["--control"]:
        return control_only()
    if argv == ["--lm-families"]:
        return lm_families_only()
    if argv == ["--mla-decode"]:
        return mla_decode_only()
    if argv == ["--train"]:
        return train_only()
    if argv == ["--dryrun"]:
        return dryrun_only(smi)
    if argv == ["--mesh"]:
        return mesh_only()
    if argv:
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2

    start = time.perf_counter()
    build_all()
    print(f"phase build: {time.perf_counter() - start:.3f} s", flush=True)
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
    tic = time.perf_counter()
    serve_counts = serve_phase()
    print(f"phase serve: {time.perf_counter() - tic:.3f} s", flush=True)
    tic = time.perf_counter()
    family_counts = {"hybrid": hybrid_phase()}
    print(f"phase hybrid: {time.perf_counter() - tic:.3f} s", flush=True)
    tic = time.perf_counter()
    ssm_phase()
    print(f"phase ssm: {time.perf_counter() - tic:.3f} s", flush=True)
    tic = time.perf_counter()
    family_counts.update(families_phase())
    print(f"phase families: {time.perf_counter() - tic:.3f} s", flush=True)
    tic = time.perf_counter()
    train_rows, train_counts = train_phase()
    rows += train_rows
    print(f"phase train: {time.perf_counter() - tic:.3f} s", flush=True)
    tic = time.perf_counter()
    int8_counts = int8_path_phase()
    print(f"phase int8: {time.perf_counter() - tic:.3f} s", flush=True)
    tic = time.perf_counter()
    policy_phase()
    print(f"phase policy: {time.perf_counter() - tic:.3f} s", flush=True)
    with tempfile.TemporaryDirectory() as keep:
        tic = time.perf_counter()
        service_phase(pathlib.Path(keep))
        print(f"phase service: {time.perf_counter() - tic:.3f} s",
              flush=True)
        tic = time.perf_counter()
        control_phase()
        print(f"phase control: {time.perf_counter() - tic:.3f} s",
              flush=True)
        analysis_phase(pathlib.Path(keep))
    dryrun_phase(smi)
    tic = time.perf_counter()
    seq_counts = mesh_phase()
    print(f"phase mesh: {time.perf_counter() - tic:.3f} s", flush=True)
    for row in rows:
        name = row["name"]
        if name in SEQ_ROWS:
            row["launches"] = seq_counts[SEQ_ROWS[name]]
        elif name in FAMILY_ROWS:
            run, counter = FAMILY_ROWS[name]
            row["launches"] = family_counts[run][counter]
        elif name == "flash_attention_bwd":
            row["launches"] = train_counts[name]
        else:
            row["launches"] = (serve_counts if name.startswith("flash")
                               else int8_counts if name == "int8_matmul"
                               else counts)[name]
    profiler_check("end")
    print(f"compile walls (s): {json.dumps(walls)}", flush=True)
    print(f"run: {time.perf_counter() - start:.3f} s from the build on",
          flush=True)
    # the card again, near the end: a caller that keeps only the tail of
    # the output still sees which card and power limit the numbers had
    print(smi, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
