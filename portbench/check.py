"""The numbers that decide ``correct``, each against its limit from
``limits/<cell>.json``.

Serving, for each request of the sample, at its prompt's last position,
in units of the standard deviation of the reference's logits there (σ):
the root mean square over the vocabulary of the gap between the logits
the program served its token from and the reference's
(``served_logits_rms``); how far the served token's logit lies below the
largest of those same logits (``served_own_gap``: 0 for a greedy token);
and how far it lies below the reference's best (``served_logit_gap``).
The widest of each over the sample is the reading.

Training: the loss of each checked step (relative to the reference's);
the norm of the first step's clipped gradient, leaf by leaf; the norm of
each leaf's change over the checked steps.  A leaf's gap is the gap
between the two norms over the larger of the reference's norm of that
leaf and of the median leaf, and the worst leaf is compared.  Leaves
whose reference gradient is under a thousandth of the median leaf's
(a key's bias under softmax) move by rounding alone and are left out of
the change.
"""

from __future__ import annotations

import statistics

import torch

GRAD_FLOOR = 1e-3


def logit_gap(ref: torch.Tensor, token: int) -> float:
    """How far the served token's logit lies below the reference's best,
    over the reference's standard deviation at that position."""
    ref = ref.float()
    return float((ref.max() - ref[token]) / ref.std())


def served_readings(ref: torch.Tensor, got: torch.Tensor,
                    token: int) -> dict:
    """A served request's numbers from the reference's logits ``ref``,
    the logits ``got`` the token was served from, and the token."""
    ref, got = ref.float(), got.float().to(ref.device)
    sd = ref.std()
    return {"served_logits_rms": float((got - ref).pow(2).mean().sqrt()
                                       / sd),
            "served_own_gap": float((got.max() - got[token]) / sd),
            "served_logit_gap": logit_gap(ref, token)}


def widest(rows: list) -> dict:
    """Each number's largest over the sampled requests."""
    return {name: max(row[name] for row in rows) for name in rows[0]}


def leaf_gap(got: dict, want: dict, names=None) -> tuple[float, str]:
    """The worst leaf's ``|‖got‖ − ‖want‖| / max(‖want‖, median)``, and
    its name, over ``names`` (default: every leaf of ``want``)."""
    names = list(want if names is None else names)
    median = statistics.median(want[n] for n in names)
    worst, where = 0.0, ""
    for n in names:
        gap = abs(got[n] - want[n]) / max(want[n], median, 1e-30)
        if gap > worst:
            worst, where = gap, n
    return worst, where


def moving_leaves(grad_norms: dict) -> list:
    """The leaves whose reference gradient is at least ``GRAD_FLOOR`` of
    the median leaf's."""
    median = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g >= GRAD_FLOOR * median]


def train_readings(prog: dict, ref: dict) -> tuple[dict, dict]:
    """The compared numbers of a training cell from the program's and
    the reference's losses, first gradients and changes, and the leaf
    (or step) where each is worst."""
    steps = [abs(a - b) / abs(b) for a, b in zip(prog["losses"],
                                                  ref["losses"])]
    loss = max(steps)
    grad, grad_at = leaf_gap(prog["grad_norms"], ref["grad_norms"])
    change, change_at = leaf_gap(prog["change_norms"], ref["change_norms"],
                                 moving_leaves(ref["grad_norms"]))
    return ({"loss_gap": loss, "grad_norm_gap": grad,
             "change_norm_gap": change},
            {"loss_gap": f"step {steps.index(loss) + 1}",
             "grad_norm_gap": grad_at, "change_norm_gap": change_at})


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """(every compared reading within its limit, ``{name: {"value",
    "limit"}}`` of the compared readings).  A reading that the limits
    file names under ``not_compared`` (with the reason) is left out; any
    other reading without a limit fails."""
    checks = {}
    ok = True
    for name, value in readings.items():
        if name in limits.get("not_compared", {}):
            continue
        limit = limits.get(name)
        checks[name] = {"value": value, "limit": limit}
        if limit is None or not value <= limit:
            ok = False
    return ok, checks
