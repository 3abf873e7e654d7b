"""Batched serving engine with continuous batching, on the port's dense
transformer.

Slots model: a fixed decode batch of ``max_batch`` slots; a finished
sequence frees its slot and the next queued request is prefilled into
it *mid-batch* without disturbing the other slots' KV state.  Per-slot
refill prefills the new request as a batch of one and writes its decode
state into the live batch state at the freed slot (cache batch axis 1,
``lengths`` axis 0).

Token flow, exactly the reference's (``repro/serve/engine.py``): each
live slot holds the logits of its *next* token.  A step emits one token
per live slot from those logits (``np.argmax`` first occurrence on a
float32 host copy, then ``% vocab_size``), then advances the whole batch
one decode step with the emitted tokens as inputs, so a freshly
prefilled slot's first token comes from its prefill logits.  A fresh
batch is right-aligned and zero-padded to its longest prompt.
Finished requests retire to ``completed``; ``run_to_completion`` flags
requests still in flight when ``max_steps`` runs out ``truncated``.

The engine keeps every slot's cache length on the host.  A decode step
passes the live slots (those whose request goes on) to ``decode_step``,
so a retired slot past its cache skips its K/V write, as the reference
drops it, and nothing is read back from the device for it.  A live
request whose next token would need a cache row past ``cache_len``
raises ``ValueError`` naming its slot (the reference drops that write
silently).

The engine runs on the device that holds the parameters.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import decode_step, prefill


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    max_batch: int = 8
    cache_len: int = 256
    eos_token: int = 0
    max_new_tokens: int = 64
    greedy: bool = True


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # [S] int32
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # set when run_to_completion exhausted max_steps with this request
    # still in flight: generation is incomplete but not lost
    truncated: bool = False


def _host_logits(logits: torch.Tensor) -> np.ndarray:
    """A float32 host copy (bf16 → f32 is exact)."""
    return np.array(logits.float().cpu())


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: dict, ecfg: EngineConfig):
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.device = params["embed"].device
        self.queue: list[Request] = []
        self.active: dict[int, Request] = {}     # slot → request
        self.completed: list[Request] = []       # finished, un-consumed
        self.state: dict | None = None
        self._logits: np.ndarray | None = None   # [B, V] next-token logits
        # every slot's cache length, as the device state holds it
        self._lengths = np.zeros(ecfg.max_batch, np.int64)
        self._next_rid = 0

    # -- request intake ------------------------------------------------
    def submit(self, prompt: list[int]) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int32)))
        return rid

    # -- internals -----------------------------------------------------
    def _prefill_inputs(self, toks: np.ndarray) -> dict:
        return {"tokens": torch.from_numpy(
            np.ascontiguousarray(toks, np.int64)).to(self.device)}

    def _prefill_batch(self, requests: list[Request]) -> None:
        """Prefill a fresh batch (uniform right-aligned padding)."""
        ec = self.ecfg
        b = ec.max_batch
        max_len = max(len(r.prompt) for r in requests)
        toks = np.zeros((b, max_len), np.int32)
        for slot, r in enumerate(requests):
            toks[slot, max_len - len(r.prompt):] = r.prompt
        logits, state = prefill(self.params, self.cfg,
                                self._prefill_inputs(toks),
                                cache_len=ec.cache_len)
        self.state = state
        self.active = dict(enumerate(requests))
        self._lengths[:] = max_len
        self._logits = _host_logits(logits)

    def _prefill_slot(self, slot: int, r: Request) -> None:
        """Prefill one request as a batch of one and write its decode
        state into the live batch state at ``slot``: the other slots'
        KV caches are untouched."""
        logits, state1 = prefill(self.params, self.cfg,
                                 self._prefill_inputs(r.prompt[None, :]),
                                 cache_len=self.ecfg.cache_len)
        if self.ecfg.max_batch == 1:
            self.state = state1
        else:
            for key in ("k", "v"):                 # [L, B, C, KH, D]
                self.state[key][:, slot] = state1[key][:, 0]
            self.state["lengths"][slot] = state1["lengths"][0]
        self.active[slot] = r
        self._lengths[slot] = len(r.prompt)
        self._logits[slot] = _host_logits(logits)[0]

    def _retire_finished(self) -> None:
        for slot, r in list(self.active.items()):
            if r.done:
                self.completed.append(r)
                del self.active[slot]
        if not self.active:
            # batch fully drained → next intake prefills fresh
            self.state = None
            self._logits = None

    def step(self) -> list[tuple[int, int]]:
        """One engine step; returns [(rid, token)] emitted this step."""
        ec = self.ecfg
        # 1) retire finished sequences and refill their slots mid-batch
        self._retire_finished()
        if self.state is None:
            if not self.queue:
                return []
            take = self.queue[:ec.max_batch]
            self.queue = self.queue[ec.max_batch:]
            self._prefill_batch(take)
        else:
            for slot in range(ec.max_batch):
                if not self.queue:
                    break
                if slot not in self.active:
                    self._prefill_slot(slot, self.queue.pop(0))
        # 2) emit one token per live slot from its next-token logits
        next_tokens = np.argmax(self._logits, axis=-1)
        emitted = []
        feed = np.zeros((ec.max_batch,), np.int64)
        for slot, r in self.active.items():
            tok = int(next_tokens[slot]) % self.cfg.vocab_size
            r.generated.append(tok)
            emitted.append((r.rid, tok))
            feed[slot] = tok
            if (tok == ec.eos_token
                    or len(r.generated) >= ec.max_new_tokens):
                r.done = True
        # 3) advance the cache one decode step for continuing slots
        #    (skipped when every live sequence just finished — done
        #    requests never burn decode work)
        live = [slot in self.active and not self.active[slot].done
                 for slot in range(ec.max_batch)]
        if any(live):
            for slot in np.flatnonzero(live):
                if self._lengths[slot] >= ec.cache_len:
                    r = self.active[slot]
                    raise ValueError(
                        f"engine: request {r.rid} in slot {slot} needs cache "
                        f"row {self._lengths[slot]} (a prompt of "
                        f"{len(r.prompt)} tokens and {len(r.generated)} "
                        f"generated), but its cache ends at {ec.cache_len}")
            logits, self.state = decode_step(
                self.params, self.cfg, self.state,
                torch.from_numpy(feed).to(self.device), live=live)
            self._lengths += 1
            self._logits = _host_logits(logits)
        return emitted

    def run_to_completion(self, max_steps: int = 10_000
                          ) -> list[Request]:
        """Serve until queue and batch drain (or ``max_steps``).

        Returns every finished request, consuming ``completed``.  If
        ``max_steps`` runs out with sequences still in flight, those
        requests are returned too, flagged ``truncated=True`` (their
        partial generations intact) instead of being silently dropped;
        never-started requests remain in ``queue``.
        """
        for _ in range(max_steps):
            if not self.queue and not self.active:
                break
            self.step()
        self._retire_finished()
        done, self.completed = self.completed, []
        if self.active:
            for slot in sorted(self.active):
                r = self.active[slot]
                r.truncated = True
                done.append(r)
            self.active = {}
            self.state = None
            self._logits = None
        return done
