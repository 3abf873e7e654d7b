"""Training launcher, the JAX package's ``repro.launch.train`` with the
same flags and prints:

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --batch 8 --seq 2048 --steps 6

trains at full width on the card (random weights from ``--seed``, the
synthetic token stream, AdamW with 5 warmup steps, ``--ckpt-dir`` for
atomic checkpoints every ``--ckpt-every`` steps and a resume from the
latest).  ``--reduced`` takes the small same-family config; ``--device``
is ``cuda`` by default, which raises without a card, or ``cpu`` for the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import pathlib

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.models.transformer import init_params
from repro_torch.train.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
)
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.trainer import TrainConfig, train_loop


def main(argv: list[str] | None = None) -> dict:
    """Run the launcher; returns ``train_loop``'s result (``params``,
    ``opt_state``, ``history``) for callers that drive it in-process."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized same-family config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain "
                         "versions)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch.launch.train: CUDA is not "
                           "available; pass --device cpu to run the "
                           "plain versions on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr=args.lr, warmup_steps=5, total_steps=args.steps))

    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        args.seed), device)
    opt_state = adamw_init(params, tcfg.optimizer)

    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    stream = SyntheticLMStream(data)

    start = 0
    hooks = []
    if args.ckpt_dir:
        ckpt_dir = pathlib.Path(args.ckpt_dir)
        last = latest_step(ckpt_dir)
        if last is not None:
            state = {"params": params, "opt": opt_state}
            state, meta = restore_checkpoint(ckpt_dir, last, state,
                                             device=device)
            params, opt_state = state["params"], state["opt"]
            start = int(meta["next_step"])
            print(f"resumed from step {last} → continuing at {start}")
        ckpt = AsyncCheckpointer(ckpt_dir, every_steps=args.ckpt_every)
        hooks.append(lambda step, p, o, m: ckpt.maybe_save(
            step, {"params": p, "opt": o}, meta={"next_step": step + 1}))

    def batches():
        for step in range(start, args.steps):
            yield stream.batch(step)

    out = train_loop(cfg, tcfg, params, opt_state, batches(), hooks=hooks)
    if args.ckpt_dir:
        ckpt.wait()
    for m in out["history"]:
        print(f"step {m['step']:4d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.3f}  {m['step_time_s']*1e3:.0f} ms")
    if out["history"]:
        first, last_m = out["history"][0], out["history"][-1]
        print(f"loss: {first['loss']:.4f} → {last_m['loss']:.4f}")
    return out


if __name__ == "__main__":
    main()
