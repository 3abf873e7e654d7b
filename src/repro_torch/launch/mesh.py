"""The mesh the port runs: one card.

:func:`make_host_mesh` is the counterpart of the reference's degenerate
``(1, 1)`` mesh over axes ``("data", "model")``: here a small frozen
description of the one card, which the dry-run's specs place every
tensor on whole.  The production meshes of 256 and 512 devices
(``make_production_mesh``) wait for the four-card item (``ROADMAP.md``,
Queue 1 item 5), with per-leaf partitions and collectives.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class CardMesh:
    """``axis_names`` × ``axis_sizes`` devices on ``device`` (one card:
    every size 1)."""

    device: torch.device
    axis_names: tuple[str, ...] = ("data", "model")
    axis_sizes: tuple[int, ...] = (1, 1)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        """The dry-run records' mesh name, e.g. ``card1x1``."""
        return "card" + "x".join(map(str, self.axis_sizes))


def make_host_mesh(device: str | torch.device = "cuda") -> CardMesh:
    """The one-card ``(1, 1)`` mesh over ``("data", "model")`` on
    ``device``."""
    return CardMesh(torch.device(device))


def batch_axes(mesh: CardMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)
