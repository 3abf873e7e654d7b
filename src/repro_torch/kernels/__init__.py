"""Hand-written CUDA kernels of the port, each with its wrapper, plain
PyTorch version and launch count:

  - :mod:`~repro_torch.kernels.dp_sweep` — the subset-stacked rail
    sweep's three solver kernels (``csrc/dp_sweep.cu``);
  - :mod:`~repro_torch.kernels.flash_attention` — prefill attention
    (``csrc/flash_attention_wgmma.cu`` in bf16,
    ``csrc/flash_attention.cu`` in float32) and its backward
    (``csrc/flash_attention_bwd_wgmma.cu`` in bf16,
    ``csrc/flash_attention_bwd.cu`` in float32, through a
    ``torch.autograd.Function``);
  - :mod:`~repro_torch.kernels.flash_decode` — decode attention over
    the KV cache (``csrc/flash_decode.cu``), and MLA's absorbed decode
    over its latent cache (``csrc/flash_decode_mla.cu``: bf16 on the
    tensor cores, float32 on the CUDA cores);
  - :mod:`~repro_torch.kernels.int8_matmul` — the int8 × int8 → int32
    product with its float32 dequantization (``csrc/int8_matmul.cu``);
  - :mod:`~repro_torch.kernels.ops` — the model-layout wrappers the
    transformer calls (:func:`attention_bshd`, :func:`decode_bshd`),
    and the int8 linear layer (:func:`quantize_int8`,
    :func:`int8_linear`).

Each source builds into its own library at first use
(:mod:`~repro_torch.kernels._nvcc`).
"""

from repro_torch.kernels.ops import (
    attention_bshd,
    decode_bshd,
    int8_linear,
    quantize_int8,
)

__all__ = ["attention_bshd", "decode_bshd", "int8_linear", "quantize_int8"]
