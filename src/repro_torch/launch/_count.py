"""The dry-run's counter: FLOPs, bytes and the peak of live memory of
a run on ``meta`` tensors, one ``TorchDispatchMode``.

Inside :class:`CostCounter` every aten operation on ``meta`` tensors
(what the port's step runs on a card, with nothing allocated and no
value computed) is counted three ways:

  - **FLOPs** of the products, as ``torch.utils.flop_counter`` counts
    them (``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolutions: 2·M·N·K
    a product), plus the work each hand-written kernel reports from its
    ``meta`` branch (:mod:`repro_torch.kernels._meta`).  Elementwise
    operations count no FLOPs, as in the flop counter.
  - **Bytes**: each operation reads every tensor it takes once and
    writes every tensor it returns once, each by its own size (a view's
    elements, not its storage's).  Exceptions, so that no operation is
    charged for memory it does not touch:

      * a view (an output that aliases an input: ``view``, ``slice``,
        ``transpose``, ``expand``, ``detach`` …) moves nothing, and nor
        does an allocation without values (``empty``, ``empty_like``,
        ``empty_strided``, ``new_empty``);
      * an in-place operation reads the tensor it overwrites and writes
        it once, except ``copy_``, ``fill_`` and ``zero_``, which only
        write it;
      * a gather (``embedding``, ``index``, ``index_select``,
        ``gather``) reads the rows it returns and its indices, not the
        whole table;
      * a scatter into a tensor (``index_put_``, ``index_copy_``) reads
        its values and indices and writes the values' bytes (a KV-cache
        row write is charged one row, not the cache);

    and the kernels report inputs read once plus outputs written once.
  - **Peak memory**: the bytes of the live ``meta`` storages, raised
    when an operation returns a tensor on a new storage and lowered when
    that storage is released (a ``weakref.finalize`` on it); storages
    alive before the run (the step's arguments) are entered with
    :meth:`CostCounter.hold`.

**Collectives** (on an abstract mesh, where the port's collectives are
logged and not made: :func:`repro_torch.launch.mesh.log_collectives`)
are kept apart from the aten counts: ``collectives`` lists each one's
``(kind, group size, operand bytes)`` in call order, and
:func:`collective_totals` sums them in the reference's schema (operand
bytes per device, by the reference's op names).  A collective moves no
HBM bytes in ``bytes``.

Operations that touch no ``meta`` tensor (a host scalar such as a
rounded ``1/sqrt(d)``) pass through uncounted.  An operation that
neither writes an input nor returns an alias is run once per distinct
(operation, input shapes, strides, dtypes, other arguments): its
outputs, FLOPs and bytes are cached and later calls return fresh
``meta`` tensors of the cached layout, since ``meta`` elementwise
operations are slow to run and every layer repeats the same shapes.
"""

from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _meta
from repro_torch.launch.mesh import log_collectives

_EMPTY = frozenset({"aten::empty", "aten::empty_like", "aten::empty_strided",
                    "aten::new_empty", "aten::new_empty_strided"})
_PURE_WRITES = frozenset({"aten::copy_", "aten::fill_", "aten::zero_"})
_GATHERS = frozenset({"aten::embedding", "aten::index",
                      "aten::index_select", "aten::gather"})
_SCATTERS = frozenset({"aten::index_put_", "aten::_index_put_impl_",
                       "aten::index_copy_"})


def _size(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(x, out: list) -> None:
    """Append the tensors of ``x`` (nested lists, tuples and dicts) to
    ``out``."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)


def tensors_of(tree) -> list[torch.Tensor]:
    """The tensors of a tree of nested lists, tuples and dicts."""
    out: list = []
    _tensors(tree, out)
    return out


def _scan(x, out: list):
    """A hashable description of an argument (a tensor by its layout),
    collecting its tensors into ``out``; raises ``TypeError`` for an
    argument that is not hashable."""
    if isinstance(x, torch.Tensor):
        out.append(x)
        return (x.shape, x.stride(), x.dtype, x.device.type)
    if isinstance(x, (list, tuple)):
        key = [type(x)]
        for y in x:
            key.append(_scan(y, out))
        return tuple(key)
    hash(x)
    return x


def _layout(x):
    """The cached form of an output: tensors as (shape, stride, dtype)."""
    if isinstance(x, torch.Tensor):
        return ("t", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(_layout(y) for y in x)
    raise TypeError("not a tensor output")


def _rebuild(layout):
    if layout[0] == "t":
        _, shape, stride, dtype = layout
        return torch.empty_strided(shape, stride, dtype=dtype,
                                   device="meta")
    items = [_rebuild(y) for y in layout[1:]]
    return items if layout[0] == "list" else tuple(items)


class _Op:
    """What the counter knows of one aten operation's schema."""

    __slots__ = ("name", "writes", "aliases", "flops")

    # ``aliases`` starts from the schema and turns true when an output
    # is found on an input's storage

    def __init__(self, func):
        schema = func._schema
        self.name = schema.name
        # positions of the arguments the operation writes
        self.writes = tuple(
            i for i, a in enumerate(schema.arguments)
            if a.alias_info is not None and a.alias_info.is_write)
        self.aliases = any(r.alias_info is not None for r in schema.returns)
        self.flops = flop_registry.get(func.overloadpacket)


class CostCounter(TorchDispatchMode):
    """FLOPs, bytes and live-memory peak of the ``meta`` operations run
    inside it (see the module docstring for the rules).

    ``flops`` and ``bytes`` are the totals; ``kernels`` maps each
    hand-written kernel's name to its ``[calls, flops, bytes]``;
    ``live`` and ``peak`` are bytes of ``meta`` storages, with the
    storages given to :meth:`hold` counted from the start;
    ``collectives`` the collectives logged inside it.
    """

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: dict[str, list[int]] = collections.defaultdict(
            lambda: [0, 0, 0])
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}
        self._ops: dict = {}
        self._cache: dict = {}
        self.collectives: list = []
        self._log = None

    # ---- memory -------------------------------------------------------

    def hold(self, *trees) -> int:
        """Count the storages of the tensors in ``trees`` (nested dicts,
        lists and tuples) as live; returns the bytes newly counted."""
        before = self.live
        for t in tensors_of(trees):
            self._track(t)
        return self.live - before

    def _track(self, t: torch.Tensor) -> None:
        if not t.is_meta:
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key)

    def _release(self, key: int) -> None:
        self.live -= self._storages.pop(key, 0)

    # ---- kernels ------------------------------------------------------

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        row = self.kernels[name]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        self.flops += flops
        self.bytes += nbytes

    def __enter__(self):
        _meta.push(self)
        self._log = log_collectives()
        self.collectives = self._log.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._log.__exit__(None, None, None)
            _meta.pop(self)

    # ---- aten operations ----------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = self._ops.get(func)
        if op is None:
            op = self._ops[func] = _Op(func)
        if op.aliases and not op.writes:
            return func(*args, **kwargs)          # a view: nothing moves
        ins: list = []
        try:
            key = (func, _scan(args, ins),
                   _scan(tuple(sorted(kwargs.items())), ins))
        except TypeError:
            key = None
            ins = tensors_of((args, kwargs))
        device = kwargs.get("device")
        if not any(t.is_meta for t in ins) and \
                getattr(device, "type", device) != "meta":
            return func(*args, **kwargs)
        hit = None
        if key is not None and not op.writes and not op.aliases:
            hit = self._cache.get(key)
        if hit is not None:
            layout, flops, nbytes = hit
            out = _rebuild(layout)
        else:
            out = func(*args, **kwargs)
            if not op.writes and _shares_storage(out, ins):
                op.aliases = True            # an unannotated view
                return out
            flops, nbytes = self._work(op, args, kwargs, ins, out)
            if key is not None and not op.writes and not op.aliases:
                try:
                    self._cache[key] = (_layout(out), flops, nbytes)
                except TypeError:
                    pass
        self.flops += flops
        self.bytes += nbytes
        if not op.aliases:
            for t in tensors_of(out):
                self._track(t)
        return out

    def _work(self, op: _Op, args, kwargs, ins: list, out) -> tuple[int, int]:
        flops = 0
        if op.flops is not None:
            flops = int(op.flops(*args, **kwargs, out_val=out))
        name = op.name
        if name in _EMPTY or (op.aliases and not op.writes):
            return flops, 0                       # a view or an allocation
        outs = tensors_of(out)
        if name in _GATHERS:
            written = sum(_size(t) for t in outs)
            return flops, 2 * written + sum(_size(t) for t in ins[1:])
        if name in _SCATTERS:
            values = _size(ins[-1])
            read = sum(_size(t) for t in ins[1:])
            return flops, read + values
        written_args = [args[i] for i in op.writes if i < len(args)]
        read = sum(_size(t) for t in ins
                   if not any(t is w for w in written_args))
        if name not in _PURE_WRITES:
            read += sum(_size(t) for t in written_args
                        if isinstance(t, torch.Tensor))
        return flops, read + sum(_size(t) for t in outs)


def collective_totals(log: list) -> dict:
    """A log of ``(kind, group size, operand bytes)`` in the reference's
    ``collectives_raw`` schema: operand bytes per device by op,
    ``counts`` by op, and their total.  A group of one rank exchanges
    nothing and counts nothing."""
    by_op: dict[str, float] = {}
    counts: dict[str, int] = {}
    for kind, size, nbytes in log:
        if size <= 1:
            continue
        by_op[kind] = by_op.get(kind, 0.0) + float(nbytes)
        counts[kind] = counts.get(kind, 0) + 1
    return {"bytes_per_device_by_op": by_op, "counts": counts,
            "bytes_per_device_total": float(sum(by_op.values()))}


def _shares_storage(out, ins: list) -> bool:
    """Whether an output lies on an input's storage (``_unsafe_view``
    returns such a view without saying so in its schema)."""
    outs = tensors_of(out)
    if not outs or not ins:
        return False
    held = {id(t.untyped_storage()) for t in ins}
    return any(id(t.untyped_storage()) in held for t in outs)
