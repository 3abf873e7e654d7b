"""Training steps of the port: ``make_train_step`` (loss and gradients
through ``forward_train`` with remat, the flash-attention forward and
backward kernels, the clip and ``adamw_update``) on ``batch`` × ``seq``
tokens a step, each batch drawn from the seed, the loss read back after
every step.

Set-up builds the one train state, and its first ``checked_steps``
steps (through the same step function and feed as the window, on
batches 0, 1, 2) are the steps the check follows: their losses, the
first step's gradient as the optimizer took it (its first moment after
one step over 1 − b1, leaf by leaf) and each leaf's change after them
(against the weights made again from the seed).  They also warm every
shape.  The window then runs steps until ``--seconds`` have passed and
ends with the last; ``train_tokens_per_s`` is every token of its steps
over it.  ``--trace 1`` traces ``trace_steps`` further steps.  The
reference then follows the checked steps from the same weights and
batches, once the program's state is freed.
"""

from __future__ import annotations

import sys
import time

import torch

from portbench import check, flops, generator, profiling, spec, weights
from portbench.reference import model as reference


def _norms(tree: dict, scale: float = 1.0) -> dict:
    return {name: float(torch.linalg.vector_norm(t.float())) * scale
            for name, t in weights.named_leaves(tree)}


def run(ctx) -> dict:
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import TrainConfig, make_train_step

    cell, tr = ctx.cell, ctx.cell.traffic
    sz = weights.sizes(cell.conf)
    opt_cfg = AdamWConfig(**tr["optimizer"])
    params = weights.make(cell.conf, ctx.seed, ctx.device)
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(spec.model_config(cell.conf, cell.traffic),
                           TrainConfig(opt_cfg))

    def feed(i):
        return generator.train_batch(tr, sz["V"], ctx.seed, i, ctx.device)

    prog = {"losses": []}
    for i in range(tr["checked_steps"]):
        params, opt, metrics = step(params, opt, feed(i))
        prog["losses"].append(float(metrics["loss"]))
        if i == 0:
            prog["grad_norms"] = _norms(opt["m"], 1.0 / (1.0 - opt_cfg.b1))
    start_weights = weights.make(cell.conf, ctx.seed, ctx.device)
    prog["change_norms"] = {
        name: float(torch.linalg.vector_norm(p.float() - p0.float()))
        for (name, p), (_, p0) in zip(weights.named_leaves(params),
                                      weights.named_leaves(start_weights))}
    del start_weights
    ctx.sync()
    setup_s = time.time() - ctx.started

    n = tr["checked_steps"]
    start = time.perf_counter()
    steps, end = 0, start
    while end - start < ctx.seconds:
        params, opt, metrics = step(params, opt, feed(n + steps))
        float(metrics["loss"])
        end = time.perf_counter()
        steps += 1
    window = end - start
    tokens = steps * tr["batch"] * tr["seq"]
    out = {"setup_s": setup_s, "attempted": steps, "failed": 0,
           "end_to_end": {"train_tokens_per_s": tokens / window,
                          "setup_s": setup_s},
           "window": {"seconds": window, "steps": steps, "tokens": tokens,
                      "flops": steps * flops.train_step_flops(
                          sz, tr["batch"], tr["seq"])}}
    if ctx.trace:
        first = n + steps
        batches = [feed(first + i) for i in range(tr["trace_steps"])]

        def traced():
            nonlocal params, opt
            for b in batches:
                params, opt, m = step(params, opt, b)
                float(m["loss"])

        out["trace"] = profiling.capture(traced, len(batches),
                                         [(tr["batch"], tr["seq"])]
                                         * len(batches), ctx.device)
    if ctx.device != "cpu":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            ctx.device)
    del params, opt, step, metrics
    if ctx.device != "cpu":
        torch.cuda.empty_cache()

    tick = time.perf_counter()
    print(f"portbench: set-up {setup_s:.3f} s, window {window:.3f} s",
          file=sys.stderr)
    reference.no_tf32()
    w0 = weights.make(cell.conf, ctx.seed, ctx.device)
    batches = [(b["tokens"], b["labels"]) for b in map(feed, range(n))]
    ref = reference.train_steps(w0, sz, batches, tr["optimizer"],
                                dtype=getattr(torch,
                                              cell.conf["torch_dtype"]))
    out["readings"], where = check.train_readings(prog, ref)
    out["checked"] = n
    out["worst"] = where
    print(f"portbench: reference {time.perf_counter() - tick:.3f} s, "
          f"worst at {where}", file=sys.stderr)
    return out
