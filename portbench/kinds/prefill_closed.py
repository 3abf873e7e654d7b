"""A prefill instance under a closed loop: one client sends a prompt,
waits for its first token, and sends the next; the port's
``ServingEngine`` (``max_batch`` slots, ``max_new_tokens`` = 1) prefills
each prompt through ``transformer.prefill`` and emits its first token.

Set-up: the weights from the seed, the engine, and one request at the
shortest and one at the longest replay length (every kernel built, the
allocator's pool at its largest).  The window starts requests until
``--seconds`` have passed and waits for the last; it ends at the last
first token.  ``prefill_tokens_per_s`` is every prompt token of the
window over the window; ``ttft_p90_ms`` the 90th percentile of every
request's time from submit to its first token.

``--trace 1`` then traces ``trace_requests`` further requests (one pass
over the replay set).  The check, once the window has closed and the
engine is freed: a sample of the window's requests drawn from the seed,
the longest among them, up to ``check_tokens`` prompt tokens, each
prompt run through the reference and compared at its last position with
the logits the engine served the token from (``check.served_readings``;
for ``control.py``, the control's logits and first token as well).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from portbench import check, flops, generator, profiling, spec, weights
from portbench.reference import model as reference


def _sample(records: list, budget: int, seed: int) -> list:
    """The longest request, then others in an order drawn from the seed,
    while their prompt tokens stay within ``budget``."""
    longest = max(range(len(records)), key=lambda i: (records[i]["n"], -i))
    rest = [i for i in range(len(records)) if i != longest]
    order = np.random.default_rng(spec.subseed(seed, "check")).permutation(
        len(rest))
    chosen, total = [longest], records[longest]["n"]
    for k in order:
        i = rest[k]
        if total + records[i]["n"] <= budget:
            chosen.append(i)
            total += records[i]["n"]
    return chosen


def run(ctx) -> dict:
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    cell, tr = ctx.cell, ctx.cell.traffic
    sz = weights.sizes(cell.conf)
    params = weights.make(cell.conf, ctx.seed, ctx.device)
    engine = ServingEngine(
        spec.model_config(cell.conf, cell.traffic), params,
        EngineConfig(max_batch=tr["max_batch"], cache_len=tr["cache_len"],
                     max_new_tokens=tr["max_new_tokens"]))
    prompts = generator.Prompts(tr, sz["V"], ctx.seed)

    def serve(prompt) -> tuple[int, np.ndarray]:
        """The first token of ``prompt`` and the engine's host row of
        logits it was taken from (one client: the request holds slot 0)."""
        rid = engine.submit(prompt)
        while True:
            for r, tok in engine.step():
                if r == rid:
                    return tok, engine._logits[0]

    for prompt in prompts.warm():
        serve(prompt)
    ctx.sync()
    setup_s = time.time() - ctx.started

    records = []
    start = time.perf_counter()
    j = 0
    while True:
        prompt = prompts.prompt(j)
        t0 = time.perf_counter()
        if t0 - start >= ctx.seconds:
            break
        tok, logits = serve(prompt)
        t1 = time.perf_counter()
        records.append({"j": j, "n": len(prompt), "t0": t0, "t1": t1,
                        "token": tok, "logits": logits.copy()})
        j += 1
    window = records[-1]["t1"] - start
    tokens = sum(r["n"] for r in records)
    ttft = [(r["t1"] - r["t0"]) * 1e3 for r in records]
    out = {"setup_s": setup_s, "attempted": len(records), "failed": 0,
           "end_to_end": {"prefill_tokens_per_s": tokens / window,
                          "ttft_p90_ms": float(np.percentile(ttft, 90)),
                          "setup_s": setup_s},
           "window": {"seconds": window, "requests": len(records),
                      "tokens": tokens,
                      "flops": sum(flops.prefill_flops(sz, r["n"])
                                   for r in records)}}
    if ctx.trace:
        later = [prompts.prompt(j + i) for i in range(tr["trace_requests"])]
        out["trace"] = profiling.capture(
            lambda: [serve(p) for p in later], len(later),
            [len(p) for p in later], ctx.device)
    if ctx.device != "cpu":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            ctx.device)
    del engine
    if ctx.device != "cpu":
        torch.cuda.empty_cache()

    tick = time.perf_counter()
    print(f"portbench: set-up {setup_s:.3f} s, window {window:.3f} s",
          file=sys.stderr)
    reference.no_tf32()
    rows, control = [], []
    for i in _sample(records, tr["check_tokens"], ctx.seed):
        r = records[i]
        toks = torch.from_numpy(prompts.prompt(r["j"])).to(ctx.device)
        ref = reference.last_logits(params, sz, toks)
        rows.append(check.served_readings(
            ref, torch.from_numpy(r["logits"]), r["token"]))
        if ctx.control:
            ctl = reference.last_logits(params, sz, toks, ctx.control)
            control.append(check.served_readings(ref, ctl,
                                                 int(ctl.argmax())))
    out["readings"] = check.widest(rows)
    if ctx.control:
        out["control_readings"] = check.widest(control)
    out["checked"] = len(rows)
    print(f"portbench: reference {time.perf_counter() - tick:.3f} s, "
          f"requests {rows}", file=sys.stderr)
    return out
