"""Hand-written CUDA kernels of the subset-stacked rail sweep (see
:mod:`repro_torch.kernels.dp_sweep`)."""
