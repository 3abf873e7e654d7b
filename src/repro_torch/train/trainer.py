"""Training step and loop, as ``repro.train.trainer`` runs them: loss
and gradients → clip → AdamW, with optional gradient accumulation over
microbatches and activation remat (configured per model by
``ModelConfig.remat``).

The port runs eagerly: there is no ``jit`` (the reference's
``train_loop(jit=...)`` keyword is dropped) and a step's gradients come
from ``torch.autograd.grad`` over detached views of the parameter
leaves (the caller's tensors never require grad, so they serve on the
kernels that have no backward right after a step), attention's through
its backward kernel.

With ``rt`` (a :class:`~repro_torch.models.transformer.Runtime` over a
mesh of ranks) the step is data-parallel, as the reference's is under
its mesh: every rank is given the same global batch and takes its rows
(``make_global_batch``; a first axis that does not divide over the
batch axes raises ``ValueError``), the loss is the global NLL sum over
the global count of valid labels, the gradients of the leaves not cut
over ``"data"`` are summed over the batch axes (the routed experts
under expert parallelism are already complete on their rank and are
not), and AdamW updates each rank's blocks (``zero_shard``: ZeRO-2).
The leaves cut over ``"model"`` (tensor parallelism) are summed over
the batch axes only: the loss is the same on every ``"model"`` rank
and is not summed there; a KV block that a group of ``"model"`` ranks
holds (a :class:`~repro_torch.launch.mesh.Part`, or a run of ranks
sharing a block of an :class:`~repro_torch.launch.mesh.Uneven`) sums
its gradient over that group
(:meth:`~repro_torch.launch.mesh.CardMesh.subgroup`).  The
parameters and moments on a mesh are this rank's blocks
(:func:`train_placements`).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import batch_axis, make_global_batch
from repro_torch.launch.mesh import (
    Placement,
    Uneven,
    all_reduce,
    batch_axes,
    mesh_axes,
    part_of,
)
from repro_torch.models.transformer import (
    Runtime,
    forward_train,
    param_placements,
    param_shapes,
)
from repro_torch.train._tree import leaves, unflatten
from repro_torch.train.optimizer import (
    AdamWConfig,
    adamw_update,
    moment_placements,
)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: AdamWConfig = AdamWConfig()
    accum_steps: int = 1        # microbatch accumulation


def loss_fn(params: Any, cfg: ModelConfig, batch: dict,
            rt: Runtime | None = None) -> torch.Tensor:
    return forward_train(params, cfg, batch, rt)


def train_placements(cfg: ModelConfig, tcfg: TrainConfig,
                     rt: Runtime) -> dict:
    """The placements of a train state ``{"params", "opt"}`` on ``rt``'s
    mesh: the parameters' (``param_placements``), the moments'
    (``moment_placements``) and the whole step count; the tree
    ``save_checkpoint`` and ``restore_checkpoint`` take."""
    pp = param_placements(cfg, rt)
    mp = moment_placements(tcfg.optimizer, pp, param_shapes(cfg))
    count = Placement(rt.mesh, ())
    return {"params": pp, "opt": {"m": mp, "v": mp, "count": count}}


def _on_device(batch: dict, device: torch.device) -> dict:
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def value_and_grad(params: Any, cfg: ModelConfig, batch: dict,
                   rt: Runtime | None = None
                   ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """(the detached loss, the gradient of every parameter leaf in
    flatten order) of :func:`loss_fn`, taken through detached views of
    the leaves that require grad, so ``params`` is left as it was."""
    views = [p.detach().requires_grad_(True) for p in leaves(params)]
    loss = loss_fn(unflatten(params, views), cfg, batch, rt)
    return loss.detach(), list(torch.autograd.grad(loss, views))


def reduce_grads(grads: list, placements: Any) -> list:
    """Each gradient (flatten order) of a leaf not cut over a batch axis
    summed over the batch axes' ranks of the placements' mesh, and a
    block that a group of ranks holds (a
    :class:`~repro_torch.launch.mesh.Part`, or a run of an
    :class:`~repro_torch.launch.mesh.Uneven`) over that group (in
    place)."""
    mesh = leaves(placements)[0].mesh
    for g, pl in zip(grads, leaves(placements)):
        cut = {a for e in pl.spec for a in mesh_axes(e)}
        for axis in batch_axes(mesh):
            group = mesh.group(axis)
            if group is not None and axis not in cut:
                all_reduce(g, group)
        for e in pl.spec:
            part = part_of(e)
            if part is not None and part.parts < mesh.shape[part.axis]:
                group = mesh.subgroup(part.axis, part.parts)
            elif isinstance(e, Uneven) and max(e.runs) > 1:
                # made on every rank, held only by runs of several
                group = mesh.subgroup(e.axis, e.runs)
            else:
                continue
            if group is not None:
                all_reduce(g, group)
    return grads


def _rank_rows(batch: dict, mesh) -> dict:
    """This rank's rows of a global batch on its device; raises
    ``ValueError`` when a first axis does not divide over the batch
    axes."""
    n = 1
    for axis in batch_axes(mesh):
        n *= mesh.shape[axis]
    for key, x in batch.items():
        if x.shape[batch_axis(key, x)] % n:
            raise ValueError(f"train_step: {key} of shape "
                             f"{tuple(x.shape)} does not split over {n} "
                             "batch ranks")
    return make_global_batch(batch, mesh)


def _microbatches(batch: dict, n: int) -> list[dict]:
    """``batch`` cut into ``n`` microbatches along the first axis of
    each array, as the reference reshapes it to ``(n, B // n, ...)``;
    raises ``TypeError`` (the reference's reshape error) when a first
    axis does not divide by ``n``."""
    for key, x in batch.items():
        if x.shape[0] % n:
            raise TypeError(f"train_step: cannot cut {key} of shape "
                            f"{tuple(x.shape)} into {n} microbatches of "
                            "equal size")
    return [{key: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
             for key, x in batch.items()} for i in range(n)]


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    rt: Runtime | None = None) -> Callable:
    """The train step: ``(params, opt_state, batch) → (params,
    opt_state, metrics)``, parameters and moments updated in place
    (``adamw_update``); ``metrics`` holds 0-d tensors ``lr``,
    ``grad_norm`` and ``loss``.  With ``accum_steps`` > 1 the batch
    splits into that many microbatches along the first axis of each
    of its arrays, as the reference reshapes them; their gradients
    sum in float32, are divided by ``accum_steps``, and the loss is the
    microbatches' mean; a first axis that does not divide by
    ``accum_steps`` raises ``TypeError`` before any gradient is taken,
    as the reference's reshape does.  On ``rt``'s mesh ``batch`` is the
    global batch (the same on every rank; each microbatch is cut from
    it as the reference cuts it, then split over the batch ranks)."""
    mesh = rt.mesh if rt is not None else None
    placements = moments = None
    if mesh is not None:
        tree = train_placements(cfg, tcfg, rt)
        placements, moments = tree["params"], tree["opt"]["m"]

    def train_step(params, opt_state, batch):
        device = leaves(params)[0].device

        def on_rank(mb):
            if mesh is None:
                return _on_device(mb, device)
            return _rank_rows(mb, mesh)

        n = tcfg.accum_steps
        if n > 1:
            g_acc, losses = None, []
            for mb in _microbatches(batch, n):
                loss_i, g = value_and_grad(params, cfg, on_rank(mb), rt)
                g32 = [x.float() for x in g]
                g_acc = g32 if g_acc is None else [
                    a + b for a, b in zip(g_acc, g32)]
                losses.append(loss_i)
            grads = [g / n for g in g_acc]
            loss = torch.stack(losses).mean()
        else:
            loss, grads = value_and_grad(params, cfg, on_rank(batch), rt)
        if mesh is not None:
            grads = reduce_grads(grads, placements)
        params, opt_state, metrics = adamw_update(
            unflatten(params, list(grads)), opt_state, params,
            tcfg.optimizer, placements, moments)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, params, opt_state,
               batches, *, hooks: list[Callable] | None = None,
               rt: Runtime | None = None) -> dict:
    """Simple loop: iterate batches, run steps, fire hooks.

    ``hooks`` receive (step, params, opt_state, metrics) — used by the
    checkpointer and the fault-tolerance drill; ``metrics`` are floats
    with ``step_time_s`` (the host's clock around the step, which ends
    when the metrics are read back) and ``step``.
    """
    step_fn = make_train_step(cfg, tcfg, rt)
    history = []
    for step, batch in enumerate(batches):
        tic = time.perf_counter()
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_time_s"] = time.perf_counter() - tic
        metrics["step"] = step
        history.append(metrics)
        for hook in hooks or ():
            hook(step, params, opt_state, metrics)
    return {"params": params, "opt_state": opt_state, "history": history}
