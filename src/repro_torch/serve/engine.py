"""Batched serving engine with continuous batching, on the port's
transformer (every family: dense, moe, vlm, audio, hybrid, ssm).

Slots model: a fixed decode batch of ``max_batch`` slots; a finished
sequence frees its slot and the next queued request is prefilled into
it *mid-batch* without disturbing the other slots' state.  Per-slot
refill prefills the new request as a batch of one and writes every
leaf of its decode state (KV caches or rings, MLA's ``ckv``/``krope``,
whisper's cross cache ``xk``/``xv``, ``lengths``, hybrid ``mamba`` and
ssm per-layer recurrent states) into the live batch state at the freed
slot's batch index, in place (:func:`_scatter_slot`).  The audio family
prefills over zero encoder frames ``[B, encoder_seq, d_model]``, as the
reference's engine gives them.

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
so a retired slot past its cache skips its cache write, as the
reference drops it, and nothing is read back from the device for it.
Where the self-attention cache ends at ``cache_len`` (dense, moe, vlm
and audio), a live request whose next token would need a cache row
past it raises ``ValueError`` naming its slot (the reference drops
that write silently); a hybrid ring wraps and an ssm slot has no
cache, so those never fill.

The engine runs on the device that holds the parameters.  With ``rt``
(a :class:`~repro_torch.models.transformer.Runtime` over a mesh of
ranks), a served MoE takes expert parallelism as the reference's does:
every rank runs the same engine on the same requests, in lock step
(each step's collectives pair up), holding its slice of the expert
leaves, and the cut leaves tensor-parallel over ``"model"``
(``tp_plan``).  The slots are sharded over the mesh's batch axes
(``("pod", "data")``) as the reference's ``shard_map`` shards them:
``max_batch`` must divide by their size, each rank prefills and
decodes its own rows of the slots (``make_global_batch``) and keeps
their decode state (under tensor parallelism, its KV heads' cache),
and the logits are all-gathered over the batch axes and, where the
vocab is cut, over ``"model"``, so every rank holds every slot's next
token.  A refill of one slot runs its request
once on each rank of the batch axes (one row each, so that every
rank's EP block takes part) and only the slot's owner keeps its
state; the reference's ``shard_map`` refuses a batch of one on such a
mesh.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import make_global_batch
from repro_torch.launch.mesh import batch_axes
from repro_torch.models.transformer import (
    Runtime,
    constrain,
    decode_step,
    prefill,
    state_fills,
    tp_plan,
)


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


def _scatter_slot(bleaf, sleaf, slot: int, max_batch: int):
    """Write a batch-of-one state leaf into the batch state at ``slot``
    (in place for tensors; lists and tuples of leaves leaf by leaf).

    The batch axis is identified per leaf as the (unique) axis where
    the full-batch shape and the single-request shape disagree — every
    other dimension of a decode-state leaf is batch-independent, so
    shapes can only differ there.  Leaves with identical shapes carry
    no batch axis (shared constants) and pass through unchanged (with
    ``max_batch == 1`` the single state is the batch state).
    """
    if isinstance(bleaf, (list, tuple)):
        out = [_scatter_slot(b, s, slot, max_batch)
               for b, s in zip(bleaf, sleaf)]
        return type(bleaf)(*out) if hasattr(bleaf, "_fields") \
            else type(bleaf)(out)
    if isinstance(bleaf, dict):
        return {k: _scatter_slot(bleaf[k], sleaf[k], slot, max_batch)
                for k in bleaf}
    if bleaf.shape == sleaf.shape:
        return sleaf if max_batch == 1 else bleaf
    diff = [i for i, (a, b) in enumerate(zip(bleaf.shape, sleaf.shape))
            if a != b]
    if len(diff) != 1 or sleaf.shape[diff[0]] != 1:
        raise ValueError(
            f"cannot identify the batch axis of a decode-state leaf: "
            f"batch shape {tuple(bleaf.shape)} vs single "
            f"{tuple(sleaf.shape)}")
    ax = diff[0]
    bleaf.select(ax, slot).copy_(sleaf.select(ax, 0))
    return bleaf


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params: dict, ecfg: EngineConfig,
                 rt: Runtime | None = None):
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.rt = rt or Runtime()
        self.device = params["embed"].device
        # the slots' shards: this rank holds _rows slots from
        # _index * _rows on
        mesh = self.rt.mesh
        parts, index = 1, 0
        for a in batch_axes(mesh) if mesh is not None else ():
            parts *= mesh.shape[a]
            index = index * mesh.shape[a] + mesh.coord(a)
        if ecfg.max_batch % parts:
            raise ValueError(f"engine: max_batch {ecfg.max_batch} does not "
                             f"divide into the mesh's {parts} batch shards")
        self._parts = parts
        self._rows = ecfg.max_batch // parts
        self._index = index
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
    def _rows_of(self, host: np.ndarray) -> torch.Tensor:
        """This rank's rows of a host array of ``_parts`` x k rows (all
        of them without a mesh) on the engine's device."""
        t = torch.from_numpy(np.ascontiguousarray(host, np.int64))
        if self.rt.mesh is None:
            return t.to(self.device)
        return make_global_batch({"t": t}, self.rt.mesh)["t"]

    def _all_logits(self, logits: torch.Tensor) -> np.ndarray:
        """Every slot's logits over the whole vocab from this rank's rows
        (and, under tensor parallelism, its vocab columns): a collective
        on a mesh, as a float32 host copy."""
        mesh = self.rt.mesh
        if mesh is not None:
            vocab = "model" if tp_plan(self.cfg, self.rt).vocab else None
            logits = constrain(logits, self.rt, None, None,
                               have=(batch_axes(mesh), vocab))
        return _host_logits(logits)

    def _prefill_inputs(self, toks: np.ndarray) -> dict:
        batch = {"tokens": self._rows_of(toks)}
        if self.cfg.family == "audio":
            batch["encoder_frames"] = torch.zeros(
                (batch["tokens"].shape[0], self.cfg.encoder_seq,
                 self.cfg.d_model),
                dtype=self.cfg.torch_dtype, device=self.device)
        return batch

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
                                cache_len=ec.cache_len, rt=self.rt)
        self.state = state
        self.active = dict(enumerate(requests))
        self._lengths[:] = max_len
        self._logits = self._all_logits(logits)

    def _prefill_slot(self, slot: int, r: Request) -> None:
        """Prefill one request as a batch of one (on a mesh, one row on
        each rank of the batch axes) and write its decode state into the
        live batch state at ``slot`` on the rank that holds the slot: the
        other slots' caches and recurrent states are untouched."""
        toks = np.repeat(r.prompt[None, :], self._parts, axis=0)
        logits, state1 = prefill(self.params, self.cfg,
                                 self._prefill_inputs(toks),
                                 cache_len=self.ecfg.cache_len, rt=self.rt)
        owner, local = divmod(slot, self._rows)
        if owner == self._index:
            self.state = _scatter_slot(self.state, state1, local, self._rows)
        self.active[slot] = r
        self._lengths[slot] = len(r.prompt)
        self._logits[slot] = self._all_logits(logits)[owner]

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
                if state_fills(self.cfg) \
                        and self._lengths[slot] >= ec.cache_len:
                    r = self.active[slot]
                    raise ValueError(
                        f"engine: request {r.rid} in slot {slot} needs cache "
                        f"row {self._lengths[slot]} (a prompt of "
                        f"{len(r.prompt)} tokens and {len(r.generated)} "
                        f"generated), but its cache ends at {ec.cache_len}")
            mine = slice(self._index * self._rows,
                         (self._index + 1) * self._rows)
            logits, self.state = decode_step(
                self.params, self.cfg, self.state, self._rows_of(feed),
                live=live[mine], rt=self.rt)
            self._lengths += 1
            self._logits = self._all_logits(logits)
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
