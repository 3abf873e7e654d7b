"""The one generator of inputs: every traffic file's parameters turned
into prompts or training batches, the same for the same seed.

``prompt_lengths`` gives a fixed replay set (the quantiles of a
log-uniform or uniform law between ``min`` and ``max``), and ``order``
shuffles it by the seed; request ``j`` takes length ``order[j % n]``, so
every seed sends the same lengths in another order.  Token ids are drawn
uniformly from the vocabulary, each request from a stream of its own.
A training batch ``i`` is ``batch`` rows of ``seq + 1`` uniform ids
(inputs and next-token labels), drawn on the device from a stream of
its own.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.spec import subseed


def prompt_lengths(lengths: dict) -> list[int]:
    """The replay set: ``quantiles`` lengths at the mid-quantiles
    ``(i + 1/2) / n`` of a law from ``min`` to ``max`` (``spacing``
    ``log``: log-uniform; ``linear``: uniform)."""
    lo, hi, n = lengths["min"], lengths["max"], lengths["quantiles"]
    qs = [(i + 0.5) / n for i in range(n)]
    if lengths["spacing"] == "log":
        return [int(round(lo * (hi / lo) ** q)) for q in qs]
    return [int(round(lo + (hi - lo) * q)) for q in qs]


class Prompts:
    """The requests of one run: request ``j``'s prompt, from ``seed``."""

    def __init__(self, traffic: dict, vocab: int, seed: int):
        self.lengths = prompt_lengths(traffic["lengths"])
        rng = np.random.default_rng(subseed(seed, "order"))
        self.order = [self.lengths[i]
                      for i in rng.permutation(len(self.lengths))]
        self.vocab = vocab
        self.seed = seed

    def length(self, j: int) -> int:
        return self.order[j % len(self.order)]

    def prompt(self, j: int, stream: str = "prompt") -> np.ndarray:
        rng = np.random.default_rng(subseed(self.seed, stream, j))
        return rng.integers(0, self.vocab, size=self.length(j),
                            dtype=np.int32)

    def warm(self) -> list[np.ndarray]:
        """Prompts of the shortest and the longest length, from a stream
        the window never draws."""
        rng = np.random.default_rng(subseed(self.seed, "warm"))
        return [rng.integers(0, self.vocab, size=n, dtype=np.int32)
                for n in (min(self.lengths), max(self.lengths))]


def train_batch(traffic: dict, vocab: int, seed: int, i: int,
                device) -> dict:
    """Batch ``i``: ``tokens`` and ``labels`` ``[batch, seq]`` on
    ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(subseed(seed, "batch", i))
    ids = torch.randint(0, vocab, (traffic["batch"], traffic["seq"] + 1),
                        generator=gen, device=device)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}
