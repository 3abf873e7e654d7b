"""Deterministic synthetic token pipeline, as ``repro.data.pipeline``
makes it (numpy only: ``batch(step)`` is byte-identical to the
reference's for the same config).

Stream properties:
  - stateless addressing: batch ``i`` is a pure function of (seed, i) —
    no iterator state to checkpoint, `skip to step N` is O(1), so a
    restarted job resumes on exactly the batch it crashed on (the drill
    of ``repro_torch.train.elastic``);
  - structured tokens (a mixture of Zipf-ish unigrams and local repeats)
    so language-model losses actually decrease during smoke training.

:func:`make_global_batch` places a host batch on a mesh of ranks: each
rank takes its rows (the reference's addressable shard of the global
array) onto its device.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch.launch.mesh import CardMesh, Placement, batch_axes


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    repeat_prob: float = 0.3      # local bigram-repeat structure
    zipf_a: float = 1.3


class SyntheticLMStream:
    """Stateless, seekable synthetic LM batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # precompute a Zipf-ish unigram distribution once
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = ranks ** (-cfg.zipf_a)
        self._probs = probs / probs.sum()

    def batch(self, step: int) -> dict:
        """Batch for ``step`` — pure function of (seed, step): int32
        ``tokens`` and ``labels`` ``[global_batch, seq_len]``."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        b, s = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(b, s + 1), p=self._probs)
        # structured repeats: with prob p, copy the previous token + 1
        rep = rng.random((b, s)) < cfg.repeat_prob
        toks[:, 1:][rep] = (toks[:, :-1][rep] + 1) % cfg.vocab_size
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def batch_axis(key: str, x) -> int:
    """The batch axis of array ``key`` of a batch: the first, but the
    second of ``"positions"`` (the vlm family's M-RoPE grids ``[3, B,
    S]``)."""
    return 1 if key == "positions" and x.ndim == 3 else 0


def make_global_batch(host_batch: dict, mesh: CardMesh) -> dict:
    """This rank's rows of a host batch (numpy arrays or tensors) as
    tensors on its device: the batch axis split over the mesh's
    ``("pod", "data")`` axes (row-major) when it divides by their
    product, and whole otherwise; its batch axis is
    :func:`batch_axis`'s."""
    axes = batch_axes(mesh)
    n = 1
    for a in axes:
        n *= mesh.shape[a]

    def put(key, x):
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        axis = batch_axis(key, x)
        spec = ((None,) * axis + (axes,)
                if x.dim() and x.shape[axis] % n == 0 else ())
        return Placement(mesh, spec).shard(x)

    return {k: put(k, v) for k, v in host_batch.items()}
