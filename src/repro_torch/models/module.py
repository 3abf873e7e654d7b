"""Parameter initialisers and the numerics helpers the models share.

Parameters are nested dicts of tensors, as in the JAX package (no
``nn.Module``).  An :class:`Initializer` holds a leaf's shape and the
function that draws it; :func:`materialize` draws every leaf from one
explicit ``torch.Generator`` on one device, in float32, and casts it to
the model dtype.  The draws are not the JAX package's (``jax.random``
and ``torch`` give different numbers from one seed): tests that compare
the two packages hand the reference's parameters to the port through
:func:`repro_torch.convert.lm_params_from_numpy`.

The helpers keep the reference's float32 upcast points
(``repro/models/module.py``): the norms compute in float32 and cast back
before the gain; ``swiglu`` computes in the input dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.train._tree import leaves

#: draw(generator, shape, device) → float32 tensor
InitFn = Callable[[torch.Generator, tuple, torch.device], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Initializer:
    """Deferred parameter: shape + init function + the reference's
    partition spec (one entry a tensor axis: ``None`` or mesh axis
    names; ``()`` replicated)."""

    shape: tuple[int, ...]
    init: InitFn
    spec: tuple = ()

    def materialize(self, generator: torch.Generator, device,
                    dtype: torch.dtype) -> torch.Tensor:
        return self.init(generator, self.shape, device).to(dtype)


def normal_init(stddev: float) -> InitFn:
    def fn(generator, shape, device):
        # scaled in place: one float32 copy of the leaf at a time (a
        # routed-expert leaf of kimi-k2 is 22.5 GB in float32)
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32).mul_(stddev)
    return fn


def zeros_init() -> InitFn:
    def fn(generator, shape, device):
        return torch.zeros(shape, device=device, dtype=torch.float32)
    return fn


def ones_init() -> InitFn:
    def fn(generator, shape, device):
        return torch.ones(shape, device=device, dtype=torch.float32)
    return fn


def fan_in_init(fan_in: int) -> InitFn:
    return normal_init(1.0 / math.sqrt(fan_in))


def dense(name: str, shape: tuple[int, ...], spec: tuple = (),
          fan_in: int | None = None) -> dict[str, Initializer]:
    fi = fan_in if fan_in is not None else shape[0]
    return {name: Initializer(shape, fan_in_init(fi), spec)}


def stacked(init: Initializer, n_layers: int) -> Initializer:
    """The same leaf for ``n_layers`` layers along a leading (unsharded)
    axis, drawn in one call."""
    return Initializer((n_layers, *init.shape), init.init,
                       (None, *init.spec))


def stack_layer_inits(layer_fn: Callable[[], dict], n_layers: int) -> dict:
    """Every leaf of one layer's Initializers (``layer_fn()``) stacked
    for ``n_layers`` layers along a leading layer axis
    (:func:`stacked`)."""
    return _map_inits(lambda init: stacked(init, n_layers), layer_fn())


def _map_inits(fn: Callable[[Initializer], object], tree):
    """``fn`` over the Initializers of a (nested) dict or list."""
    if isinstance(tree, list):
        return [_map_inits(fn, val) for val in tree]
    if isinstance(tree, dict):
        return {key: _map_inits(fn, val) for key, val in tree.items()}
    return fn(tree)


def abstract_params(tree, dtype: torch.dtype = torch.bfloat16):
    """Stand-ins for a dry-run: every Initializer of ``tree`` as an
    empty ``meta`` tensor of its shape in ``dtype``; nothing is
    allocated or drawn.  (The reference also returns partition specs;
    the dry-run's one card places every leaf whole, and
    ``transformer.param_specs`` gives the specs.)"""
    return _map_inits(
        lambda init: torch.empty(init.shape, dtype=dtype, device="meta"),
        tree)


def param_count(params) -> int:
    """Elements over the leaves of a tree of tensors (meta included)."""
    return sum(x.numel() for x in leaves(params))


def param_bytes(params) -> int:
    """Bytes over the leaves of a tree of tensors (meta included)."""
    return sum(x.numel() * x.element_size() for x in leaves(params))


def materialize(tree, generator: torch.Generator, device,
                dtype: torch.dtype):
    """Draw every leaf of a (nested) dict or list of Initializers, in
    the dict's (list's) order."""
    return _map_inits(
        lambda init: init.materialize(generator, device, dtype), tree)


# ---- numerics helpers shared across models ---------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * gamma


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * gamma + beta


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up
