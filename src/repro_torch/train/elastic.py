"""Elastic / fault-tolerant training runs, as ``repro.train.elastic``
makes them on one device: restore the last committed checkpoint, seek the
stateless data stream to the step after it, and train on.  A restarted
run must reproduce an uninterrupted one: the same losses and the same
final parameters, because checkpoints are atomic and CRC-checked, the
data stream is a pure function of (seed, step), and every kernel of
the step (attention's backward included) sums in a fixed order.

``run_elastic`` is the single-process embodiment the drill uses: it
injects a crash after a given step and restarts from the checkpoint.
Restoring onto a different mesh waits for the four-card item
(``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
import pathlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.models.transformer import init_params
from repro_torch.train.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
)
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.trainer import TrainConfig, make_train_step


@dataclasses.dataclass
class ElasticRun:
    cfg: ModelConfig
    tcfg: TrainConfig
    data: DataConfig
    ckpt_dir: pathlib.Path
    ckpt_every: int = 5


class CrashRequested(Exception):
    """Raised by the crash hook in the fault-injection drill."""


def run_elastic(run: ElasticRun, *, total_steps: int,
                crash_at: int | None = None, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """(Re)start training: restore the latest checkpoint if present,
    seek the data stream, train to ``total_steps`` on ``device``.

    ``crash_at``: inject a crash after that step commits (tests).
    """
    device = torch.device(device)
    stream = SyntheticLMStream(run.data)
    step_fn = make_train_step(run.cfg, run.tcfg)

    params = init_params(run.cfg, torch.Generator(
        device=device).manual_seed(seed), device)
    opt_state = adamw_init(params, run.tcfg.optimizer)

    start = 0
    last = latest_step(run.ckpt_dir)
    if last is not None:
        state = {"params": params, "opt": opt_state}
        state, meta = restore_checkpoint(run.ckpt_dir, last, state,
                                         device=device)
        params, opt_state = state["params"], state["opt"]
        start = int(meta["next_step"])

    ckpt = AsyncCheckpointer(run.ckpt_dir, every_steps=run.ckpt_every)
    history = []
    for step in range(start, total_steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             stream.batch(step))
        history.append({"step": step, "loss": float(metrics["loss"])})
        ckpt.maybe_save(step, {"params": params, "opt": opt_state},
                        meta={"next_step": step + 1})
        if crash_at is not None and step == crash_at:
            ckpt.wait()
            raise CrashRequested(f"injected crash after step {step}")
    ckpt.wait()
    return {"params": params, "opt_state": opt_state,
            "history": history, "resumed_from": start}
