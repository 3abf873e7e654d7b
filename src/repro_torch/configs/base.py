"""Model/config system: one frozen dataclass drives every architecture.

``ModelConfig`` covers all 10 assigned LM-family architectures (dense,
MoE, MLA, SSM, hybrid, enc-dec audio, VLM).  Each ``configs/<arch>.py``
instantiates the exact published configuration; ``reduced()`` derives the
CPU-smoke-test variant of the same family.  The fields are the JAX
package's, field for field; ``torch_dtype`` takes the place of its
``jnp_dtype``.  The port's transformer runs every family
(``repro_torch.models.transformer``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 → d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e6
    mrope_sections: tuple[int, ...] = ()   # vlm: (t, h, w) freq split
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "swiglu"               # swiglu | gelu
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0
    rope_head_dim: int = 64
    # --- SSM / hybrid ---
    ssm_state: int = 16
    slstm_every: int = 8              # xLSTM: every Nth block is sLSTM
    window: int = 0                   # sliding-window attention (hymba)
    proj_factor: int = 2              # xLSTM inner expansion
    # --- encoder-decoder (whisper) ---
    n_encoder_layers: int = 0
    encoder_seq: int = 1500           # stub frame-embedding length
    # --- numerics / lowering knobs ---
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True          # False → unrolled python loop
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    gls_chunk: int = 128
    moe_impl: str = "auto"            # auto | dense | ep
    moe_dispatch_dtype: str = "native"   # native | int8 (EP wire format)
    # distribution hints (perf hillclimb knobs)
    shard_kv_seq: bool = False        # flash-decode seq-sharded KV cache
    causal_block_skip: bool = False   # skip masked-out attention blocks
    # cost-model lowering: unroll inner scans so compiled.cost_analysis()
    # counts every iteration (XLA prices while-loop bodies once)
    inner_unroll: bool = False

    # ------------------------------------------------------------------
    def __post_init__(self) -> None:
        assert self.family in FAMILIES, self.family

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 16 for TP-sharded embeddings."""
        return -(-self.vocab_size // 16) * 16

    @property
    def torch_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "float16": torch.float16}[self.dtype]

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    def n_params(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6·N·D)."""
        d, hd = self.d_model, self.hd
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "hybrid", "audio"):
            if self.is_mla:
                r, dr = self.kv_lora_rank, self.rope_head_dim
                attn = (d * self.n_heads * (hd + dr)       # q
                        + d * (r + dr)                      # compressed kv
                        + r * self.n_kv_heads * hd * 2      # k/v up-proj
                        + self.n_heads * hd * d)            # out
            else:
                attn = (d * self.n_heads * hd
                        + 2 * d * self.n_kv_heads * hd
                        + self.n_heads * hd * d)
            if self.is_moe:
                ffn = (d * self.n_experts                  # router
                       + 3 * d * self.d_ff_expert *
                       (self.n_experts + self.n_shared_experts))
            else:
                ffn = 3 * d * self.d_ff if self.act == "swiglu" \
                    else 2 * d * self.d_ff
            per_layer = attn + ffn + 2 * d
            if self.family == "hybrid":
                di = self.n_heads * hd
                per_layer += (2 * d * self.n_heads * self.ssm_state
                              + d * di + d * self.n_heads + di * d)
            if self.family == "audio":    # decoder has cross-attn too
                per_layer += attn
        elif self.family == "ssm":
            di = d * self.proj_factor
            mlstm = (2 * d * di + 3 * di * di // 4 * 0  # q,k,v within inner
                     + 3 * di * di + 2 * di * self.n_heads + di * d + d * di)
            per_layer = mlstm + 2 * d
        n = emb + self.n_layers * per_layer
        if self.family == "audio":
            enc_attn = 2 * (d * self.n_heads * hd
                            + 2 * d * self.n_kv_heads * hd
                            + self.n_heads * hd * d)
            enc_ffn = 2 * d * self.d_ff
            n += self.n_encoder_layers * (enc_attn // 2 + enc_ffn + 2 * d)
        return int(n)

    def active_params(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if not self.is_moe:
            return self.n_params()
        full = self.n_params()
        routed_all = (3 * self.d_model * self.d_ff_expert
                      * self.n_experts * self.n_layers)
        routed_active = (3 * self.d_model * self.d_ff_expert
                         * (self.moe_top_k + self.n_shared_experts)
                         * self.n_layers)
        return int(full - routed_all + routed_active)

    def reduced(self, **overrides: Any) -> "ModelConfig":
        """Small same-family variant for CPU smoke tests."""
        base = dict(
            n_layers=min(self.n_layers, 2 if self.family != "ssm" else 3),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            head_dim=16,
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            encoder_seq=8 if self.n_encoder_layers else 1500,
            n_experts=8 if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            d_ff_expert=32 if self.d_ff_expert else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            rope_head_dim=8 if self.kv_lora_rank else 64,
            window=min(self.window, 8) if self.window else 0,
            mrope_sections=(2, 3, 3) if self.mrope_sections else (),
            ssm_state=min(self.ssm_state, 8),
            attn_q_chunk=16,
            attn_kv_chunk=16,
            gls_chunk=16,
            dtype="float32",
            remat=False,
            moe_impl="dense",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell for an architecture."""

    name: str            # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# sub-quadratic-only cells (skip for pure full-attention archs)
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")
