"""PowerFlow-DNN on PyTorch and CUDA, ported from the JAX package
``repro``: the power-schedule compiler's main path (``pfdnn`` on the
edge CNNs, slice 1) with the three solver kernels of the subset-stacked
rail sweep written by hand in CUDA C++ for Hopper
(``csrc/dp_sweep.cu``), and the LM serving entry point
(``repro_torch.launch.serve``: the dense transformer and the
continuous-batching engine, slice 2) with its prefill and decode
attention in two more hand-written kernels (``csrc/flash_attention.cu``,
``csrc/flash_decode.cu``).

The package imports ``torch`` and numpy and nothing of ``repro``.
Modules sit at the reference's relative paths and keep its public
names (``repro_torch.core.backend`` ↔ ``repro.core.backend``).  Entry
points run on the card (``device="cuda"``) unless the caller asks for
the CPU, where every kernel wrapper takes its plain PyTorch version.
"""
