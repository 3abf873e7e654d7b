"""Analysis of the compiler itself.

  - :mod:`repro_torch.analysis.lockcheck` — opt-in runtime
    lock-acquisition instrumentation (``PFDNN_LOCKCHECK=1``) recording
    the cross-module acquisition graph, failing on cycles and on locks
    held across the ``compile_many`` dispatch barrier, plus a static
    ``with``-nesting companion cross-checked against the recorded
    graph.

This ``__init__`` stays import-light on purpose: ``repro_torch.core``
and ``repro_torch.service`` construct their locks through
``repro_torch.analysis.lockcheck.make_lock``, so importing the package
must pull nothing else into that import chain.
"""

from __future__ import annotations

_SUBMODULES = ("lockcheck",)


def __getattr__(name: str):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
