"""Hand-written CUDA kernels of the port, each with its wrapper, plain
PyTorch version and launch count:

  - :mod:`~repro_torch.kernels.dp_sweep` — the subset-stacked rail
    sweep's three solver kernels (``csrc/dp_sweep.cu``);
  - :mod:`~repro_torch.kernels.flash_attention` — prefill attention
    (``csrc/flash_attention.cu``);
  - :mod:`~repro_torch.kernels.flash_decode` — decode attention over
    the KV cache (``csrc/flash_decode.cu``);
  - :mod:`~repro_torch.kernels.ops` — the model-layout wrappers the
    transformer calls.

Each source builds into its own library at first use
(:mod:`~repro_torch.kernels._nvcc`).
"""
