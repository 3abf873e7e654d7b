"""RRAM bank occupancy analysis → intra-layer gating anchors (paper §3.2).

The compiler analyzes the deterministic weight-address stream (generated
by the DMA engine from the dataflow schedule, §5.1) to find which RRAM
banks hold live weights during each layer.  Banks whose weights are not
accessed during a window can be power-gated; memory-access phases are the
fine-grained scheduling anchors.

Weights are placed sequentially bank by bank (the paper's DMA stream is
deterministic, so placement is static).  During layer i, the awake set is
the banks holding layer i's weights plus — for ping-pong prefetch — the
banks of layer i+1.  Everything else can be gated when gating is enabled.
Bank wake events (gated → awake) cost ``t_wake``/``e_wake`` each; the
``pg_manager`` executes this schedule at run time (§3.3).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.hw.edge40nm import Edge40nmAccelerator
from repro_torch.perfmodel.layer_costs import LayerCost


@dataclasses.dataclass(frozen=True)
class BankPlan:
    """Static RRAM bank plan for one network."""

    n_banks: int
    bank_bytes: int
    # per layer: (first_bank, last_bank) inclusive span of its weights;
    # (-1, -1) for weightless layers.
    spans: tuple[tuple[int, int], ...]

    def awake_banks(self, layer: int, gating: bool,
                    prefetch: bool = True) -> int:
        """Number of awake banks during ``layer`` under the given policy."""
        if not gating:
            return self.n_banks
        live = set()
        for li in (layer, layer + 1) if prefetch else (layer,):
            if 0 <= li < len(self.spans):
                lo, hi = self.spans[li]
                if lo >= 0:
                    live.update(range(lo, hi + 1))
        return max(len(live), 1)  # pg_manager bank always on

    def wake_events(self, layer: int, gating: bool) -> int:
        """Banks that must wake at the start of ``layer`` (prefetch of
        layer+1 happens during layer i, so wakes are charged here)."""
        if not gating or layer + 1 >= len(self.spans):
            return 0
        lo_n, hi_n = self.spans[layer + 1]
        if lo_n < 0:
            return 0
        cur = set()
        for li in (layer - 1, layer):
            if 0 <= li < len(self.spans):
                lo, hi = self.spans[li]
                if lo >= 0:
                    cur.update(range(lo, hi + 1))
        return len(set(range(lo_n, hi_n + 1)) - cur)


def plan_banks(costs: Sequence[LayerCost],
               acc: Edge40nmAccelerator) -> BankPlan:
    """Sequential weight placement over fixed-size RRAM banks."""
    bank_bytes = acc.rram_bank_bytes
    spans: list[tuple[int, int]] = []
    offset = 0
    for c in costs:
        wb = c.weight_bytes
        if wb == 0:
            spans.append((-1, -1))
            continue
        first = offset // bank_bytes
        last = (offset + wb - 1) // bank_bytes
        spans.append((first, last))
        offset += wb
    n_banks = max(1, -(-offset // bank_bytes))
    return BankPlan(n_banks=n_banks, bank_bytes=bank_bytes,
                    spans=tuple(spans))
