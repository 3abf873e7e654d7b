"""Per-layer cycle + event-count characterization (paper §5.1).

The paper uses a cycle-accurate performance model validated against RTL,
plus per-event energy lookups from gate-level power analysis.  We
reproduce the *interface* with an analytic dataflow model of the same
accelerator: an 8×8 output-stationary PE array with weight-tile reuse,
ping-pong SRAM buffers, and an RRAM weight store clocked in its own
domain (Fig 4).

Cycle model (output stationary, 8×8 tile of [output-pixel × output-channel]):

  conv    : ceil(P/8) · ceil(Cout/8) · Cin · K²       cycles (compute dom.)
  dwconv  : ceil(P/8) · ceil(C/8)    · K²             (channel-parallel rows)
  fc      : ceil(Cout/8) · ceil(Cin/8) · 8            (P = 1)
  attn    : MACs/64 · 1.15                            (matmul chain, 15%
                                                       pipeline overhead)
  pool/elt: P·C/64 ALU cycles

  feeder  : (act_in + act_out + weight) bytes / 8 B-per-cycle
  rram    : weight bytes / 8 B-per-cycle (streamed once; ping-pong prefetch)

Event counts (→ dynamic energy at v_nom):
  MACs; lane-buffer bytes ≈ MACs/8 (input reuse across the 8 channel PEs);
  weight-buffer bytes ≈ MACs/8 (weight reuse across the 8 pixel PEs);
  RRAM bytes = weight bytes; feeder bytes as above.

These choices make conv layers compute-energy-dominant, FC layers
RRAM/weight-dominant, and depthwise layers feeder-dominant — the
layer-dependent energy composition of paper Fig. 1.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from repro_torch.hw.edge40nm import (
    D_COMPUTE,
    D_FEEDER,
    D_RRAM,
    Edge40nmAccelerator,
)


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """Workload description of one network layer (INT8 weights/acts)."""

    name: str
    kind: str                 # conv | dwconv | fc | attn | pool | eltwise
    macs: int
    weight_bytes: int
    act_in_bytes: int
    act_out_bytes: int
    # tiling-relevant dims (0 when not applicable)
    p_out: int = 0            # output spatial positions
    c_out: int = 0
    c_in: int = 0
    kernel: int = 1


def conv_spec(name: str, h: int, w: int, c_in: int, c_out: int, k: int,
              stride: int = 1) -> LayerSpec:
    ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    p = ho * wo
    return LayerSpec(
        name=name, kind="conv",
        macs=p * c_out * c_in * k * k,
        weight_bytes=c_out * c_in * k * k,
        act_in_bytes=h * w * c_in,
        act_out_bytes=p * c_out,
        p_out=p, c_out=c_out, c_in=c_in, kernel=k,
    )


def dwconv_spec(name: str, h: int, w: int, c: int, k: int,
                stride: int = 1) -> LayerSpec:
    ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    p = ho * wo
    return LayerSpec(
        name=name, kind="dwconv",
        macs=p * c * k * k,
        weight_bytes=c * k * k,
        act_in_bytes=h * w * c,
        act_out_bytes=p * c,
        p_out=p, c_out=c, c_in=1, kernel=k,
    )


def fc_spec(name: str, c_in: int, c_out: int) -> LayerSpec:
    return LayerSpec(
        name=name, kind="fc",
        macs=c_in * c_out,
        weight_bytes=c_in * c_out,
        act_in_bytes=c_in,
        act_out_bytes=c_out,
        p_out=1, c_out=c_out, c_in=c_in, kernel=1,
    )


def attention_spec(name: str, tokens: int, d_model: int, n_heads: int,
                   d_ff: int = 0) -> LayerSpec:
    """One transformer block: QKV + scores + AV + out-proj (+ optional FFN)."""
    proj = 4 * tokens * d_model * d_model
    scores = 2 * tokens * tokens * d_model
    ffn = 2 * tokens * d_model * d_ff
    w_bytes = 4 * d_model * d_model + 2 * d_model * d_ff
    return LayerSpec(
        name=name, kind="attn",
        macs=proj + scores + ffn,
        weight_bytes=w_bytes,
        act_in_bytes=tokens * d_model,
        act_out_bytes=tokens * d_model,
        p_out=tokens, c_out=d_model, c_in=d_model, kernel=1,
    )


def pool_spec(name: str, h: int, w: int, c: int, k: int,
              stride: int = 2) -> LayerSpec:
    ho, wo = math.ceil(h / stride), math.ceil(w / stride)
    return LayerSpec(
        name=name, kind="pool",
        macs=0,
        weight_bytes=0,
        act_in_bytes=h * w * c,
        act_out_bytes=ho * wo * c,
        p_out=ho * wo, c_out=c, c_in=c, kernel=k,
    )


def eltwise_spec(name: str, h: int, w: int, c: int) -> LayerSpec:
    return LayerSpec(
        name=name, kind="eltwise",
        macs=0,
        weight_bytes=0,
        act_in_bytes=2 * h * w * c,
        act_out_bytes=h * w * c,
        p_out=h * w, c_out=c, c_in=c, kernel=1,
    )


@dataclasses.dataclass(frozen=True)
class LayerCost:
    """Characterized cost of one layer at the nominal voltage point."""

    spec: LayerSpec
    cycles: tuple[int, int, int]        # per domain (compute, feeder, rram)
    dyn_energy_nom: tuple[float, float, float]  # per domain [J] at v_nom

    @property
    def weight_bytes(self) -> int:
        return self.spec.weight_bytes


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def characterize_layer(spec: LayerSpec,
                       acc: Edge40nmAccelerator) -> LayerCost:
    rows = acc.pe_rows * acc.pe_cols  # 64 MACs / cycle peak

    if spec.kind == "conv":
        c_cycles = (_ceil_div(spec.p_out, acc.pe_rows)
                    * _ceil_div(spec.c_out, acc.pe_cols)
                    * spec.c_in * spec.kernel * spec.kernel)
    elif spec.kind == "dwconv":
        c_cycles = (_ceil_div(spec.p_out, acc.pe_rows)
                    * _ceil_div(spec.c_out, acc.pe_cols)
                    * spec.kernel * spec.kernel)
    elif spec.kind == "fc":
        c_cycles = (_ceil_div(spec.c_out, acc.pe_cols)
                    * _ceil_div(spec.c_in, acc.pe_rows) * acc.pe_rows)
    elif spec.kind == "attn":
        c_cycles = int(spec.macs / rows * 1.15) + 1
    else:  # pool / eltwise: ALU work
        c_cycles = _ceil_div(spec.p_out * spec.c_out, rows)

    moved = spec.act_in_bytes + spec.act_out_bytes + spec.weight_bytes
    f_cycles = _ceil_div(moved, 8)
    r_cycles = _ceil_div(spec.weight_bytes, 8)

    # dynamic event energies at v_nom
    lane_bytes = spec.macs / 8 + spec.act_in_bytes + spec.act_out_bytes
    wbuf_bytes = spec.macs / 8
    e_compute = (spec.macs * acc.e_mac
                 + lane_bytes * acc.e_sram_lane
                 + wbuf_bytes * acc.e_sram_weight)
    e_feeder = moved * acc.e_feeder_byte
    e_rram = spec.weight_bytes * acc.e_rram_read

    return LayerCost(
        spec=spec,
        cycles=(int(c_cycles), int(f_cycles), int(r_cycles)),
        dyn_energy_nom=(float(e_compute), float(e_feeder), float(e_rram)),
    )


def characterize_network(specs: Sequence[LayerSpec],
                         acc: Edge40nmAccelerator) -> list[LayerCost]:
    return [characterize_layer(s, acc) for s in specs]


def nominal_latency(cost: LayerCost, acc: Edge40nmAccelerator) -> float:
    """Layer latency with every domain at the nominal voltage [s]."""
    fs = (acc.dvfs(D_COMPUTE).freq(acc.v_nom),
          acc.dvfs(D_FEEDER).freq(acc.v_nom),
          acc.dvfs(D_RRAM).freq(acc.v_nom))
    return max(c / f for c, f in zip(cost.cycles, fs))
