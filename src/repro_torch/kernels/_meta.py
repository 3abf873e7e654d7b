"""The kernels' work on ``meta`` tensors, for the dry-run.

Only the dry-run (:mod:`repro_torch.launch.dryrun`) hands the model
``meta`` tensors.  A kernel wrapper given them launches nothing and
computes nothing: it returns empty ``meta`` outputs of the kernel's
shapes and reports the kernel's work here, to the counter entered last
(:class:`repro_torch.launch._count.CostCounter`), if one is active:

  - FLOPs as the kernel table's bound counts them (``PERF.md``): 4·D a
    kept (query, key) pair for ``flash_attention``, 10·D for its
    backward, 4·D a cache row for ``flash_decode`` (every row of the
    cache: a dry-run cell is priced with every row full), 2·(R + DR) +
    2·R a cache row for ``flash_decode_mla``, 2·M·N·K for
    ``int8_matmul``;
  - bytes as every input read once plus every output written once.

The counters form one stack for the process (a dry-run runs one cell at
a time), so a backward pass that autograd runs on another thread
reports to the same counter.
"""

from __future__ import annotations

import torch

_COUNTERS: list = []


def report(name: str, flops: int, nbytes: int) -> None:
    """Add one kernel call's work to the active counter, if any."""
    if _COUNTERS:
        _COUNTERS[-1].add_kernel(name, flops, nbytes)


def push(counter) -> None:
    _COUNTERS.append(counter)


def pop(counter) -> None:
    if not _COUNTERS or _COUNTERS[-1] is not counter:
        raise RuntimeError("kernel work counters left out of order")
    _COUNTERS.pop()


def nbytes(*tensors: torch.Tensor | None) -> int:
    """Bytes of the given tensors (None counts 0)."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)
