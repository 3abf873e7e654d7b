"""PowerFlow-DNN on PyTorch and CUDA: the power-schedule compiler's
main path (``pfdnn`` on the edge CNNs) ported from the JAX package
``repro``, with the three solver kernels of the subset-stacked rail
sweep written by hand in CUDA C++ for Hopper (``csrc/dp_sweep.cu``).

The package imports ``torch`` and numpy and nothing of ``repro``.
Modules sit at the reference's relative paths and keep its public
names (``repro_torch.core.backend`` ↔ ``repro.core.backend``).  Entry
points run on the card (``device="cuda"``) unless the caller asks for
the CPU, where every kernel wrapper takes its plain PyTorch version.
"""
