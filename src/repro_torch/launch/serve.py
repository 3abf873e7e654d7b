"""Serving launcher: batched generation + PF-DNN power orchestration.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
        --requests 8 --max-new 16 --rate 30 --policy pfdnn

Runs the continuous-batching engine on any LM of ``configs/`` (full
width, random weights from seed 0; ``--reduced`` for the small
same-family config; whisper's encoder sees zero frames, as the
reference's engine gives them)
AND compiles a PF-DNN power schedule for the co-hosted edge workload at
the target inference rate, executing it on the power runtime for 10
periods: the JAX package's ``repro.launch.serve`` with the same prints.
Everything runs on ``--device`` (``cuda`` by default, which raises
without a card; ``cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import OrchestratorConfig, compile_power_schedule
from repro_torch.hw.edge40nm import EDGE40NM_DEFAULT
from repro_torch.models.edge_cnn import edge_network
from repro_torch.models.transformer import init_params
from repro_torch.perfmodel import characterize_network, plan_banks
from repro_torch.serve import (
    EngineConfig,
    PeriodicScheduler,
    PowerRuntime,
    ServingEngine,
)


def main(argv: list[str] | None = None) -> dict:
    """Run the launcher; returns what it served and replayed
    (``{"done": [Request], "schedule": PowerSchedule | None, "replay":
    dict | None}``) for callers that drive it in-process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--edge-net", default="squeezenet1.1")
    ap.add_argument("--rate", type=float, default=30.0)
    ap.add_argument("--policy", default="pfdnn")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine and the power "
                         "compile (cuda, or cpu for the plain versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.serve: CUDA is not "
                           "available; pass --device cpu to run the "
                           "plain versions on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    generator = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, generator, device)
    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch=4, cache_len=96, max_new_tokens=args.max_new,
        eos_token=-1))

    rng = np.random.default_rng(0)
    for _ in range(args.requests):
        n = int(rng.integers(4, 17))
        engine.submit(list(rng.integers(1, cfg.vocab_size, n)))
    done = engine.run_to_completion()
    total_tokens = sum(len(r.generated) for r in done)
    print(f"[engine] served {len(done)} requests, "
          f"{total_tokens} tokens generated")

    # PF-DNN power schedule for the deadline-constrained periodic side
    specs = edge_network(args.edge_net)
    sched = compile_power_schedule(
        specs, args.rate,
        cfg=OrchestratorConfig(policy=args.policy, device=args.device),
        network=args.edge_net)
    if sched is None:
        print(f"[power] rate {args.rate} Hz infeasible for "
              f"{args.edge_net}")
        return {"done": done, "schedule": None, "replay": None}
    print("[power]", sched.summary())
    costs = characterize_network(specs, EDGE40NM_DEFAULT)
    plan = plan_banks(costs, EDGE40NM_DEFAULT)
    runtime = PowerRuntime(sched, costs, plan, EDGE40NM_DEFAULT)
    result = PeriodicScheduler(runtime, args.rate).run(n_intervals=10)
    print(f"[power] 10 intervals: avg "
          f"{result['avg_interval_energy_uj']:.2f} uJ/interval, "
          f"{result['avg_power_mw']:.3f} mW, "
          f"misses={result['deadline_misses']}")
    return {"done": done, "schedule": sched, "replay": result}


if __name__ == "__main__":
    main()
