"""Independent verification layer: schedule certification and
static/runtime analysis of the compiler itself.

Three coordinated pieces (see ``python -m repro_torch.analysis --help``):

  - :mod:`repro_torch.analysis.certify` — an intentionally independent
    re-derivation of every :class:`PowerSchedule` claim plus a
    λ-envelope dual lower bound on the schedule's energy and an audit
    of the port's content-addressed disk tier.  It shares *no* solver
    code with ``repro_torch.core`` — only the hardware spec
    (``repro_torch.hw``), the performance model
    (``repro_torch.perfmodel``) and the artifact dataclass
    (``repro_torch.core.schedule``).
  - :mod:`repro_torch.analysis.lint_determinism` — AST determinism
    linter over the source tree with inline ``# pfdnn: allow(<rule>)``
    suppressions and a committed baseline.
  - :mod:`repro_torch.analysis.lockcheck` — opt-in runtime
    lock-acquisition instrumentation (``PFDNN_LOCKCHECK=1``) recording
    the cross-module acquisition graph, failing on cycles and on locks
    held across the ``compile_many`` dispatch barrier, plus a static
    ``with``-nesting companion cross-checked against the recorded
    graph.

This ``__init__`` stays import-light on purpose: ``repro_torch.core``
and ``repro_torch.service`` construct their locks through
``repro_torch.analysis.lockcheck.make_lock``, so importing the package
must never pull the certifier (which imports
``repro_torch.core.schedule``) into that import chain.
"""

from __future__ import annotations

_SUBMODULES = ("certify", "lint_determinism", "lockcheck")


def __getattr__(name: str):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
