"""Meshes of ``torch.distributed`` ranks.

:func:`make_mesh` is the counterpart of the reference's ``jax.make_mesh``
calls (``tests/test_sharding.py``): a grid of the ranks of an
initialised default process group over named axes (``("data",
"model")`` by default), one device a rank.  Its :class:`CardMesh` holds
one process group an axis (from a
``torch.distributed.device_mesh.DeviceMesh``: the ranks that differ
only in that axis's coordinate, in coordinate order) and this rank's
coordinates.  :func:`make_host_mesh` is the degenerate ``(1, 1)`` mesh
of one card with no process group, which the dry-run's specs place
every tensor on whole.

:func:`make_production_mesh` is the reference's production mesh,
``(16, 16)`` over ``("data", "model")`` or ``(2, 16, 16)`` over
``("pod", "data", "model")``, as an *abstract* mesh
(:func:`abstract_mesh`): no process group, this rank at coordinate 0
of every axis, device ``meta``.  The dry-run builds one rank's step on
it.  Its groups are :class:`AbstractGroup`\\ s, never ``None``: an
abstract mesh of 256 is never taken for one card.

A :class:`Placement` is the counterpart of a ``NamedSharding``: a mesh
and a spec (one entry a tensor axis: ``None``, an axis name, a tuple
of axis names, or a :class:`Part`) that say which block of a full
tensor this rank holds.  A :class:`Part` cuts a tensor axis into fewer
blocks than its mesh axis has ranks, each block held by a group of
consecutive ranks (the KV heads that several ranks' query heads read);
:meth:`CardMesh.subgroup` is that group.  A :class:`Strided` entry views
a tensor axis as ``[outer, n]`` and cuts ``n`` (sLSTM's gate columns,
four gate kinds × d, cut by heads).  An :class:`Uneven` entry gives
each coordinate its own range of the tensor axis: blocks of whole
heads of unequal size, a block held by a run of consecutive ranks
where there are fewer blocks than ranks (hymba's 25 heads on a
``"model"`` axis of 2, 4 or 16).

Every collective of the port goes through :func:`all_reduce`,
:func:`all_gather_axis` or :func:`all_to_all`.  Each call is appended
to every log that :func:`log_collectives` has opened (its kind in the
reference's HLO names, its group's size and its operand's bytes); on
an abstract mesh it is only logged, and raises for a tensor that is not
on ``meta``.  The port makes no other collective: no broadcast, no
reduce-scatter.  The collectives that need their own backward are
``torch.autograd.Function``\\ s: :func:`reduce_sum` (an all-reduce
whose backward is the identity: a row-parallel product's partial sums
over ``"model"``, the loss over the batch axes), :func:`copy_to`
(the identity whose backward all-reduces: a value replicated over a
group that each member uses for its own part) and :func:`gather_to`
(a block gathered over its placement, whose backward sums the full
gradient over the group and keeps this rank's block).  The port uses only
collectives that NCCL and gloo both take on CUDA tensors:
``all_reduce`` (SUM, MAX), ``all_gather_into_tensor`` and
``all_to_all_single``.

:func:`run_world` spawns a world of ranks on one host
(``torch.multiprocessing``'s ``spawn``), each joined to the process
group over a ``FileStore`` under a given directory (so worlds started at
once never share a port), and returns what a function gave on each.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import pathlib
import pickle
import time
import traceback
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.train._tree import tree_map


@dataclasses.dataclass(frozen=True)
class AbstractGroup:
    """The group along ``axis`` of an abstract mesh, of ``size`` ranks:
    a collective over it is logged, not made."""

    axis: str
    size: int


@dataclasses.dataclass(frozen=True)
class CardMesh:
    """``axis_names`` × ``axis_sizes`` ranks, this one on ``device``;
    ``groups`` maps an axis name to the process group along it (and
    ``(axis, parts)`` to the groups of :meth:`subgroup`) and ``coords``
    is this rank's coordinate on each axis (one card: every size 1, no
    groups).  ``abstract``: a mesh of no process group whose
    collectives are only logged (:func:`abstract_mesh`)."""

    device: torch.device
    axis_names: tuple[str, ...] = ("data", "model")
    axis_sizes: tuple[int, ...] = (1, 1)
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     hash=False, repr=False)
    coords: tuple[int, ...] = ()
    abstract: bool = False

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        """The dry-run records' mesh name: ``card1x1``, or ``pod16x16``
        and ``pod2x16x16`` for the abstract production meshes."""
        return ("pod" if self.abstract else "card") \
            + "x".join(map(str, self.axis_sizes))

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on one card)."""
        return self.coords[self.axis_names.index(axis)] if self.coords \
            else 0

    def group(self, axis: str):
        """The process group along ``axis`` (``None`` on a mesh without
        process groups: one card, nothing to exchange; an
        :class:`AbstractGroup` on an abstract mesh).  An axis of size 1
        has its group of one rank, so a world of one still runs every
        collective."""
        if self.abstract:
            return AbstractGroup(axis, self.shape[axis])
        return self.groups.get(axis)

    def subgroup(self, axis: str, parts):
        """The group of the ranks that hold the same block of a tensor
        axis cut over ``axis``: with ``parts`` an int, the blocks of a
        :class:`Part` (``size // parts`` ranks of consecutive
        coordinates on ``axis``, alike on every other axis; ``parts`` 1:
        the axis's group); with ``parts`` a tuple, the lengths of the
        runs of consecutive coordinates that share a block
        (:attr:`Uneven.runs`), this rank's run, or ``None`` where it is
        a run of one (nothing to exchange).  The groups of ``(axis,
        parts)`` are made at its first call, which is collective: every
        rank makes the same first calls, in the same order, whatever its
        own run."""
        size = self.shape[axis]
        if isinstance(parts, tuple):
            runs = tuple(int(n) for n in parts)
            if sum(runs) != size or min(runs) < 1:
                raise ValueError(f"subgroup: runs {runs} do not cover axis "
                                 f"{axis!r} of size {size}")
            mine = _run_of(runs, self.coord(axis))
            if self.abstract:
                return AbstractGroup(axis, mine) if mine > 1 else None
        else:
            if parts < 1 or size % parts:
                raise ValueError(f"subgroup: {parts} blocks do not divide "
                                 f"axis {axis!r} of size {size}")
            if parts == 1:
                return self.group(axis)
            if self.abstract:
                return AbstractGroup(axis, size // parts)
            runs = (size // parts,) * parts
        if not self.groups:
            return None
        if (axis, parts) not in self.groups:
            self.groups[axis, parts] = _subgroup(
                self.axis_sizes, self.axis_names, axis, runs)
        return self.groups[axis, parts]

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes what the mesh writes once (global
        rank 0, or the one card)."""
        return not self.coords or all(c == 0 for c in self.coords)


def _run_of(runs: tuple[int, ...], coord: int) -> int:
    """The length of the run of ``runs`` that holds ``coord``."""
    start = 0
    for n in runs:
        if coord < start + n:
            return n
        start += n
    raise ValueError(f"coordinate {coord} past the runs {runs}")


def _subgroup(sizes: tuple[int, ...], names: tuple[str, ...], axis: str,
              runs: tuple[int, ...]):
    """This rank's process group of :meth:`CardMesh.subgroup`: each
    line of ranks along ``axis`` cut into ``runs`` of consecutive
    coordinates, a group of each run of more than one rank.
    ``new_group`` is collective: every rank makes every group, in this
    order."""
    i = names.index(axis)
    grid = torch.arange(math.prod(sizes)).reshape(sizes)
    # axis i last, one line of ranks a row
    lines = torch.movedim(grid, i, -1).reshape(-1, sizes[i])
    mine = None
    for line in lines.tolist():
        start = 0
        for n in runs:
            ranks = line[start:start + n]
            start += n
            if n == 1:
                continue
            group = dist.new_group(ranks)
            if dist.get_rank() in ranks:
                mine = group
    return mine


def make_mesh(axis_sizes: tuple[int, ...],
              axis_names: tuple[str, ...] = ("data", "model"),
              device: str | torch.device = "cuda") -> CardMesh:
    """The mesh of ``axis_sizes`` over ``axis_names`` on the ranks of the
    initialised default process group (its world size must be the
    mesh's size; rank r sits at the row-major coordinates of r), this
    rank on ``device``.  Every rank calls it, in the same order as its
    other group creations."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the default process "
                           "group first (torch.distributed."
                           "init_process_group)")
    sizes = tuple(int(s) for s in axis_sizes)
    if len(sizes) != len(axis_names):
        raise ValueError(f"make_mesh: {len(sizes)} sizes for axes "
                         f"{axis_names}")
    world = dist.get_world_size()
    if math.prod(sizes) != world:
        raise ValueError(f"make_mesh: a {sizes} mesh needs "
                         f"{math.prod(sizes)} ranks, the world has {world}")
    from torch.distributed.device_mesh import DeviceMesh

    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    grid = DeviceMesh(device.type, torch.arange(world).reshape(sizes),
                      mesh_dim_names=tuple(axis_names))
    groups = {name: grid.get_group(name) for name in axis_names}
    return CardMesh(device, tuple(axis_names), sizes, groups,
                    tuple(grid.get_coordinate()))


def make_host_mesh(device: str | torch.device = "cuda") -> CardMesh:
    """The one-card ``(1, 1)`` mesh over ``("data", "model")`` on
    ``device``."""
    return CardMesh(torch.device(device))


def abstract_mesh(axis_sizes: tuple[int, ...],
                  axis_names: tuple[str, ...] = ("data", "model"),
                  coords: tuple[int, ...] | None = None) -> CardMesh:
    """An abstract mesh of ``axis_sizes`` over ``axis_names``: rank 0 of
    it (coordinate 0 on every axis; or the rank at ``coords``) on
    ``meta``, with no process group; its collectives are logged, never
    made."""
    sizes = tuple(int(s) for s in axis_sizes)
    if len(sizes) != len(axis_names):
        raise ValueError(f"abstract_mesh: {len(sizes)} sizes for axes "
                         f"{axis_names}")
    coords = (0,) * len(sizes) if coords is None else tuple(coords)
    if len(coords) != len(sizes) or not all(
            0 <= c < n for c, n in zip(coords, sizes)):
        raise ValueError(f"abstract_mesh: coordinates {coords} outside "
                         f"{sizes}")
    return CardMesh(torch.device("meta"), tuple(axis_names), sizes,
                    coords=coords, abstract=True)


def make_production_mesh(*, multi_pod: bool = False) -> CardMesh:
    """The reference's production mesh as an abstract mesh: ``(16,
    16)`` over ``("data", "model")`` (one pod of 256 devices), or ``(2,
    16, 16)`` over ``("pod", "data", "model")`` (two pods, 512)."""
    if multi_pod:
        return abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    return abstract_mesh((16, 16), ("data", "model"))


def batch_axes(mesh: CardMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


# ---------------------------------------------------------- placements

@dataclasses.dataclass(frozen=True)
class Part:
    """A spec entry: the tensor axis cut into ``parts`` blocks over the
    mesh axis ``axis`` (whose size ``parts`` divides), block ``c //
    (size // parts)`` held by the rank at coordinate ``c``: each block
    by ``size // parts`` ranks of consecutive coordinates.  ``Part(a,
    size)`` is the entry ``a``; ``Part(a, 1)`` leaves the axis whole."""

    axis: str
    parts: int


@dataclasses.dataclass(frozen=True)
class Strided:
    """A spec entry: the tensor axis viewed as ``[outer, n]`` (``outer``
    blocks of ``n`` in a row), ``n`` cut by ``entry`` (an axis name or a
    :class:`Part`); a rank holds its block of each of the ``outer``
    blocks, in their order (sLSTM's ``w_gates`` columns ``[z|i|f|o] ×
    d``, cut by heads within each gate kind)."""

    outer: int
    entry: Any


@dataclasses.dataclass(frozen=True)
class Uneven:
    """A spec entry: the tensor axis cut over the mesh axis ``axis``,
    the rank at coordinate ``c`` holding the half-open range
    ``bounds[c]`` of it (one pair a coordinate).  The blocks follow one
    another from 0 and may differ in size; consecutive coordinates with
    equal bounds share a block (a run).  Where every block has the same
    size it places a tensor as the entry ``axis`` or a :class:`Part`
    does.  Not inside a :class:`Strided`."""

    axis: str
    bounds: tuple

    def __post_init__(self):
        bounds = tuple((int(a), int(b)) for a, b in self.bounds)
        object.__setattr__(self, "bounds", bounds)
        end = 0
        for c, (a, b) in enumerate(bounds):
            if c and (a, b) == bounds[c - 1]:
                continue
            if a != end or b <= a:
                raise ValueError(f"Uneven: {bounds} are not consecutive, "
                                 "non-empty blocks from 0")
            end = b

    @property
    def size(self) -> int:
        """The tensor axis's full length."""
        return self.bounds[-1][1]

    @property
    def runs(self) -> tuple[int, ...]:
        """The lengths of the runs of coordinates that share a block, in
        order."""
        out = [1]
        for c in range(1, len(self.bounds)):
            if self.bounds[c] == self.bounds[c - 1]:
                out[-1] += 1
            else:
                out.append(1)
        return tuple(out)

    @property
    def firsts(self) -> tuple[int, ...]:
        """The first coordinate of each run."""
        return tuple(c for c in range(len(self.bounds))
                     if c == 0 or self.bounds[c] != self.bounds[c - 1])

    def share(self, coord: int) -> int:
        """How many ranks hold the block of ``coord``."""
        return self.bounds.count(self.bounds[coord])

    def scaled(self, width: int) -> "Uneven":
        """The same cut of an axis of ``width`` elements an item (a
        head's columns)."""
        return Uneven(self.axis, tuple((a * width, b * width)
                                       for a, b in self.bounds))


def mesh_axes(entry) -> tuple[str, ...]:
    """A spec entry's axis names (``None`` → none)."""
    if entry is None:
        return ()
    if isinstance(entry, Strided):
        return mesh_axes(entry.entry)
    if isinstance(entry, (Part, Uneven)):
        return (entry.axis,)
    return (entry,) if isinstance(entry, str) else tuple(entry)


def part_of(entry) -> Part | None:
    """The :class:`Part` of a spec entry (itself, or a
    :class:`Strided` entry's), else ``None``."""
    if isinstance(entry, Strided):
        entry = entry.entry
    return entry if isinstance(entry, Part) else None


@dataclasses.dataclass(frozen=True)
class Placement:
    """A full tensor's block on this rank of ``mesh``: tensor axis i is
    cut over the mesh axes of ``spec[i]`` (row-major over several; a
    :class:`Part` into fewer blocks than its axis has ranks; an
    :class:`Uneven` into blocks of its own bounds), each rank holding
    the block at its coordinates; axes past the spec's end and ``None``
    entries stay whole."""

    mesh: CardMesh
    spec: tuple

    def _cuts(self, ndim: int):
        """(tensor axis, parts, this rank's part, outer blocks, the
        :class:`Uneven` entry or ``None``) for each cut axis."""
        out = []
        for i, entry in enumerate(tuple(self.spec)[:ndim]):
            outer = 1
            if isinstance(entry, Strided):
                outer, entry = entry.outer, entry.entry
            if isinstance(entry, Uneven):
                if outer != 1:
                    raise ValueError(f"placement {self.spec}: an Uneven "
                                     "entry inside a Strided one")
                if len(entry.bounds) != self.mesh.shape[entry.axis]:
                    raise ValueError(
                        f"placement {self.spec}: {len(entry.bounds)} "
                        f"bounds for axis {entry.axis!r} of "
                        f"{self.mesh.shape[entry.axis]} ranks")
                if len(entry.runs) > 1:
                    out.append((i, len(entry.runs), None, 1, entry))
                continue
            if isinstance(entry, Part):
                size = self.mesh.shape[entry.axis]
                if size % entry.parts:
                    raise ValueError(f"placement {self.spec}: {entry} does "
                                     f"not divide an axis of {size}")
                parts = entry.parts
                index = self.mesh.coord(entry.axis) // (size // parts)
            else:
                parts, index = 1, 0
                for name in mesh_axes(entry):
                    size = self.mesh.shape[name]
                    parts *= size
                    index = index * size + self.mesh.coord(name)
            if parts > 1:
                out.append((i, parts, index, outer, None))
        return out

    def _range(self, i: int, parts: int, index, outer: int, uneven,
               length: int) -> tuple[int, int]:
        """(start, length) of this rank's block of each of the ``outer``
        blocks of a full axis ``i`` of ``length``; raises
        ``ValueError`` where it does not divide."""
        if uneven is not None:
            if length != uneven.size:
                raise ValueError(f"placement {self.spec}: axis {i} of "
                                 f"length {length} is not the {uneven.size} "
                                 "its bounds cover")
            a, b = uneven.bounds[self.mesh.coord(uneven.axis)]
            return a, b - a
        if length % (parts * outer):
            raise ValueError(f"placement {self.spec}: axis {i} of length "
                             f"{length} does not divide into "
                             f"{parts * outer}")
        n = length // (parts * outer)
        return index * n, n

    def local_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The block's shape of a full tensor of ``shape``; raises
        ``ValueError`` where a cut axis does not divide (or an
        :class:`Uneven` axis is not the length its bounds cover)."""
        out = list(shape)
        for i, parts, index, outer, uneven in self._cuts(len(shape)):
            out[i] = self._range(i, parts, index, outer, uneven,
                                 shape[i])[1] * outer
        return tuple(out)

    def global_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The full tensor's shape of a block of ``shape``."""
        out = list(shape)
        for i, parts, _, _, uneven in self._cuts(len(shape)):
            out[i] = uneven.size if uneven is not None else shape[i] * parts
        return tuple(out)

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full``, a view."""
        block = full
        for i, parts, index, outer, uneven in self._cuts(full.dim()):
            start, n = self._range(i, parts, index, outer, uneven,
                                   full.shape[i])
            block = block.unflatten(i, (outer, -1)).narrow(
                i + 1, start, n).flatten(i, i + 1)
        return block

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a copy on the mesh's
        device)."""
        return self.block(full).to(self.mesh.device, copy=True).contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block (a collective: every
        rank of the mesh calls it with its block)."""
        full = local
        for i, *_ in reversed(self._cuts(local.dim())):
            full = _gather_entry(full, self.mesh, self.spec[i], i)
        return full.contiguous()


def _keep_blocks(full: torch.Tensor, entry: Uneven, i: int) -> torch.Tensor:
    """Axis ``i`` of ``full`` ``[..., ranks, width, ...]`` (every rank's
    block padded to ``width``) → each distinct block once, unpadded, in
    order."""
    pieces = []
    for c in entry.firsts:
        a, b = entry.bounds[c]
        pieces.append(full.select(i, c).narrow(i, 0, b - a))
    return torch.cat(pieces, dim=i)


def _gather_entry(x: torch.Tensor, mesh: CardMesh, entry, i: int
                  ) -> torch.Tensor:
    """Axis ``i`` of every rank's block of one spec entry, gathered
    (a collective).  An :class:`Uneven` block is padded to the largest
    block, so that every rank sends (and logs) the same bytes in one
    all-gather."""
    if isinstance(entry, Uneven):
        size = mesh.shape[entry.axis]
        width = max(b - a for a, b in entry.bounds)
        if x.shape[i] < width:
            pad = list(x.shape)
            pad[i] = width - x.shape[i]
            x = torch.cat([x, x.new_zeros(pad)], dim=i)
        full = all_gather_axis(x, mesh.group(entry.axis), size, i)
        return _keep_blocks(full.unflatten(i, (size, width)), entry, i)
    outer = 1
    if isinstance(entry, Strided):
        outer, entry = entry.outer, entry.entry
    n = x.shape[i] // outer                 # this rank's block of each
    if isinstance(entry, Part):
        size = mesh.shape[entry.axis]
        full = all_gather_axis(x, mesh.group(entry.axis), size, i)
        # each block came from size // parts ranks: keep one
        full = full.unflatten(i, (entry.parts, size // entry.parts,
                                  outer * n)).select(i + 1, 0)
        parts = entry.parts
    else:
        parts = 1
        full = x.unflatten(i, (1, outer * n))
        for name in reversed(mesh_axes(entry)):
            size = mesh.shape[name]
            full = all_gather_axis(full.flatten(i, i + 1), mesh.group(name),
                                   size, i).unflatten(
                                       i, (size * parts, outer * n))
            parts *= size
    # [parts, outer * n] → [outer, parts, n] along axis i
    full = full.unflatten(i + 1, (outer, n)).transpose(i, i + 1)
    return full.flatten(i, i + 2)


# --------------------------------------------------------- collectives

#: the logs that :func:`log_collectives` has opened
_LOGS: list[list] = []


@contextlib.contextmanager
def log_collectives():
    """A list that receives ``(kind, group size, operand bytes)`` for
    each collective made (or, on an abstract mesh, logged) while it is
    open, in call order; ``kind`` is the reference's HLO name
    (``all-reduce``, ``all-gather``, ``all-to-all``)."""
    log: list = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def _collective(kind: str, t: torch.Tensor, group) -> bool:
    """Log one collective of operand ``t`` over ``group``; whether to
    make it (not on an abstract mesh, where ``t`` must be on
    ``meta``)."""
    abstract = isinstance(group, AbstractGroup)
    if abstract and not t.is_meta:
        raise RuntimeError(f"a {kind} over the abstract mesh's "
                           f"{group.axis!r} axis of {group.size} ranks "
                           f"got a tensor on {t.device}: an abstract mesh "
                           "holds no data; run the step on meta tensors")
    if _LOGS:
        size = group.size if abstract else dist.get_world_size(group)
        entry = (kind, size, t.numel() * t.element_size())
        for log in _LOGS:
            log.append(entry)
    return not abstract


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """``t`` reduced (``"sum"`` or ``"max"``) over ``group`` in place;
    returns ``t``."""
    if _collective("all-reduce", t, group):
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=group)
    return t


def all_to_all(t: torch.Tensor, group) -> torch.Tensor:
    """``t [n, ...]``: block i goes to the i-th rank of ``group`` and
    block i of the result came from it."""
    t = t.contiguous()
    out = torch.empty_like(t)
    if _collective("all-to-all", t, group):
        dist.all_to_all_single(out, t, group=group)
    return out


def all_gather_axis(t: torch.Tensor, group, parts: int,
                    axis: int) -> torch.Tensor:
    """``parts`` ranks' tensors of ``group`` concatenated along ``axis``
    in group order (``all_gather_into_tensor`` on axis 0)."""
    if parts == 1:
        return t
    front = torch.movedim(t, axis, 0).contiguous()
    out = torch.empty((parts * front.shape[0], *front.shape[1:]),
                      dtype=t.dtype, device=t.device)
    if _collective("all-gather", front, group):
        dist.all_gather_into_tensor(out, front, group=group)
    return torch.movedim(out, 0, axis)


def spec_placements(specs: Any, mesh: CardMesh,
                    keep=lambda path: True) -> Any:
    """A tree of :class:`Placement` over ``mesh`` from a tree of spec
    tuples (``param_specs``), a spec replaced by ``()`` (whole) where
    ``keep(path)`` is false; ``path`` is the leaf's key path."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return Placement(mesh, tuple(node) if keep(path) else ())
    return walk(specs, ())


def shard_tree(tree: Any, placements: Any) -> Any:
    """Each full leaf of ``tree`` cut to this rank's block by its
    placement (on the placement's device)."""
    return tree_map(lambda t, pl: pl.shard(t), tree, placements)


def gather_tree(tree: Any, placements: Any) -> Any:
    """Each leaf's full tensor from every rank's block (a collective)."""
    return tree_map(lambda t, pl: pl.gather(t), tree, placements)


# ------------------------------------------- collectives with a backward

class _ReduceSum(torch.autograd.Function):
    """All-reduce (SUM) over a group; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    """The identity; the gradient is all-reduced (SUM) over a group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (every member gets the sum); its
    backward is the identity (``None``: one rank, nothing to sum)."""
    return x if group is None else _ReduceSum.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient is summed over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


class _GatherTo(torch.autograd.Function):
    """Axis ``i`` of every rank's block gathered (``entry``, one
    spec entry); the gradient is summed over the entry's ranks (where
    ``reduce``) and cut to this rank's block, ``1 / k`` of it where
    ``k`` ranks hold the block (a :class:`Part`, or a run of an
    :class:`Uneven`)."""

    @staticmethod
    def forward(ctx, x, mesh, entry, i, reduce):
        ctx.mesh, ctx.entry, ctx.i, ctx.reduce = mesh, entry, i, reduce
        return _gather_entry(x.contiguous(), mesh, entry, i)

    @staticmethod
    def backward(ctx, g):
        mesh, entry, i = ctx.mesh, ctx.entry, ctx.i
        g = g.contiguous().clone()
        if ctx.reduce:
            for name in mesh_axes(entry):
                all_reduce(g, mesh.group(name))
        g = Placement(mesh, (None,) * i + (entry,)).block(g)
        part = part_of(entry)
        if part is not None:
            g = g * (part.parts / mesh.shape[part.axis])
        elif isinstance(entry, Uneven) and entry.share(
                mesh.coord(entry.axis)) > 1:
            g = g * (1.0 / entry.share(mesh.coord(entry.axis)))
        return g.contiguous(), None, None, None, None


def gather_to(x: torch.Tensor, mesh: CardMesh | None, entry,
              axis: int, reduce: bool = True) -> torch.Tensor:
    """Axis ``axis`` of ``x``, this rank's block of a tensor cut by the
    spec entry ``entry`` (an axis name, a :class:`Part`, a
    :class:`Strided` or an :class:`Uneven`), gathered over ``mesh`` (a
    collective), with the backward of :class:`_GatherTo`; ``x`` as it
    is where ``entry`` is ``None`` or there is no mesh.  ``reduce``:
    whether the gradient that reaches the gathered tensor is each rank's
    part of it, to be summed (a product that each rank makes with its
    own columns), or, ``False``, already the whole gradient on every
    rank (a use that every rank makes alike), which is only cut."""
    if entry is None or mesh is None:
        return x
    return _GatherTo.apply(x, mesh, entry, axis, reduce)


# ------------------------------------------------------ worlds of ranks

def _rank_main(rank: int, world: int, root: str, fn, args, backend: str,
               device: str | None, threads: int, timeout_s: float) -> None:
    """One spawned rank: join the process group, run ``fn(rank, *args)``
    and write its result (or its traceback) for the parent."""
    out = pathlib.Path(root) / f"rank{rank}.pkl"
    try:
        torch.set_num_threads(threads)
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device).index or 0)
        dist.init_process_group(
            backend, store=dist.FileStore(str(pathlib.Path(root) / "store"),
                                          world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            result = ("ok", fn(rank, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:                   # reported by the parent
        result = ("error", traceback.format_exc())
    out.write_bytes(pickle.dumps(result))


def run_world(fn, world: int, root, *args, backend: str = "gloo",
              device: str | None = None, threads: int = 1,
              timeout_s: float = 60, deadline_s: float = 180) -> list:
    """``fn(rank, *args)`` on ``world`` spawned ranks of a ``backend``
    process group (``fn`` and ``args`` picklable; ``device``: the card
    each rank sets, or ``None``), their results in rank order.  The
    process group's timeout and each join are ``timeout_s``; a rank's
    exception, a rank that dies without a result, or one still running
    ``deadline_s`` after the spawn raises ``RuntimeError`` with every
    rank's traceback, after every rank has stopped."""
    import torch.multiprocessing as mp

    root = pathlib.Path(root)
    root.mkdir(parents=True, exist_ok=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, str(root), fn, args, backend,
                               device, threads, timeout_s))
             for r in range(world)]
    for p in procs:
        p.start()
    files = [root / f"rank{r}.pkl" for r in range(world)]
    # wait (in polls, not by the clock) until every rank has written or
    # one has died without writing
    for _ in range(max(1, math.ceil(deadline_s / 0.2))):
        if all(f.exists() for f in files) or not all(
                p.is_alive() or f.exists() for p, f in zip(procs, files)):
            break
        time.sleep(0.2)
    for p in procs:
        p.join(timeout_s)
    stuck = [r for r, p in enumerate(procs) if p.is_alive()]
    for r in stuck:
        procs[r].kill()
        procs[r].join()
    results, errors = [], []
    for r, f in enumerate(files):
        if not f.exists():
            errors.append(f"rank {r}: no result (exit {procs[r].exitcode})")
            continue
        status, value = pickle.loads(f.read_bytes())
        f.unlink()
        if status != "ok":
            errors.append(f"rank {r}:\n{value}")
        results.append(value)
    if stuck or errors:
        raise RuntimeError(f"a world of {world} ranks failed; ranks "
                           f"{stuck} still running\n" + "\n".join(errors))
    return results
