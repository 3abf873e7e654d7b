"""Elastic / fault-tolerant training runs, as ``repro.train.elastic``
makes them on one device: restore the last committed checkpoint, seek the
stateless data stream to the step after it, and train on.  A restarted
run must reproduce an uninterrupted one: the same losses and the same
final parameters, because checkpoints are atomic and CRC-checked, the
data stream is a pure function of (seed, step), and every kernel of
the step (attention's backward included) sums in a fixed order.

``run_elastic`` is the embodiment the drill uses: it injects a crash
after a given step and restarts from the checkpoint.  With ``rt`` (a
:class:`~repro_torch.models.transformer.Runtime` over a mesh of ranks;
every rank calls it) it trains data-parallel, and it resumes on a mesh
other than the one that saved: the checkpoint holds the full arrays,
and each rank of the new mesh cuts its blocks from them
(``restore_checkpoint(placements=)``).
"""

from __future__ import annotations

import dataclasses
import pathlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLMStream
from repro_torch.launch.mesh import shard_tree
from repro_torch.models.transformer import Runtime, init_params
from repro_torch.train.checkpoint import (
    AsyncCheckpointer,
    latest_step,
    restore_checkpoint,
)
from repro_torch.train.optimizer import adamw_init
from repro_torch.train.trainer import (
    TrainConfig,
    make_train_step,
    train_placements,
)


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
                rt: Runtime | None = None,
                crash_at: int | None = None, seed: int = 0,
                device: str | torch.device = "cuda") -> dict:
    """(Re)start training: restore the latest checkpoint if present,
    seek the data stream, train to ``total_steps`` on ``device`` (on a
    mesh: its device).

    ``crash_at``: inject a crash after that step commits (tests).
    """
    rt = rt or Runtime()
    mesh = rt.mesh
    device = mesh.device if mesh is not None else torch.device(device)
    stream = SyntheticLMStream(run.data)
    step_fn = make_train_step(run.cfg, run.tcfg, rt)

    params = init_params(run.cfg, torch.Generator(
        device=device).manual_seed(seed), device)
    placements = None
    if mesh is not None:
        placements = train_placements(run.cfg, run.tcfg, rt)
        params = shard_tree(params, placements["params"])
        opt_state = adamw_init(params, run.tcfg.optimizer,
                               placements=placements["params"])
    else:
        opt_state = adamw_init(params, run.tcfg.optimizer)

    start = 0
    last = latest_step(run.ckpt_dir)
    if last is not None:
        state = {"params": params, "opt": opt_state}
        state, meta = restore_checkpoint(run.ckpt_dir, last, state,
                                         device=device,
                                         placements=placements)
        params, opt_state = state["params"], state["opt"]
        start = int(meta["next_step"])

    ckpt = AsyncCheckpointer(run.ckpt_dir, every_steps=run.ckpt_every,
                             placements=placements)
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
