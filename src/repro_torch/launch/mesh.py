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

A :class:`Placement` is the counterpart of a ``NamedSharding``: a mesh
and a spec (one entry a tensor axis: ``None``, an axis name, or a
tuple of axis names) that say which block of a full tensor this rank
holds.

The collectives that need their own backward are
``torch.autograd.Function``\\ s: :func:`reduce_sum` (an all-reduce
whose backward is the identity: the sum of the expert block's partial
products over ``"model"``, the loss over the batch axes) and
:func:`copy_to` (the identity whose backward all-reduces: a value
replicated over a group that each member uses for its own part).  The
port uses only collectives that NCCL and gloo both take on CUDA
tensors: ``all_reduce`` (SUM, MAX), ``all_gather_into_tensor``,
``all_to_all_single`` and ``broadcast``.

:func:`run_world` spawns a world of ranks on one host
(``torch.multiprocessing``'s ``spawn``), each joined to the process
group over a ``FileStore`` under a given directory (so worlds started at
once never share a port), and returns what a function gave on each.

The production meshes of 256 and 512 devices (``make_production_mesh``)
wait for Queue 1 item 5b (``ROADMAP.md``).
"""

from __future__ import annotations

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
class CardMesh:
    """``axis_names`` × ``axis_sizes`` ranks, this one on ``device``;
    ``groups`` maps an axis name to the process group along it and
    ``coords`` is this rank's coordinate on each axis (one card: every
    size 1, no groups)."""

    device: torch.device
    axis_names: tuple[str, ...] = ("data", "model")
    axis_sizes: tuple[int, ...] = (1, 1)
    groups: dict = dataclasses.field(default_factory=dict, compare=False,
                                     hash=False, repr=False)
    coords: tuple[int, ...] = ()

    @property
    def shape(self) -> dict[str, int]:
        """Axis name → size, as a JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    @property
    def name(self) -> str:
        """The dry-run records' mesh name, e.g. ``card1x1``."""
        return "card" + "x".join(map(str, self.axis_sizes))

    def coord(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (0 on one card)."""
        return self.coords[self.axis_names.index(axis)] if self.coords \
            else 0

    def group(self, axis: str):
        """The process group along ``axis`` (``None`` on a mesh without
        process groups: one card, nothing to exchange).  An axis of size
        1 has its group of one rank, so a world of one still runs every
        collective."""
        return self.groups.get(axis)

    @property
    def is_writer(self) -> bool:
        """Whether this rank writes what the mesh writes once (global
        rank 0, or the one card)."""
        return not self.coords or all(c == 0 for c in self.coords)


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


def batch_axes(mesh: CardMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


# ---------------------------------------------------------- placements

def mesh_axes(entry) -> tuple[str, ...]:
    """A spec entry's axis names (``None`` → none)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A full tensor's block on this rank of ``mesh``: tensor axis i is
    cut over the mesh axes of ``spec[i]`` (row-major over several),
    each rank holding the block at its coordinates; axes past the
    spec's end and ``None`` entries stay whole."""

    mesh: CardMesh
    spec: tuple

    def _cuts(self, ndim: int):
        """(tensor axis, parts, this rank's part) for each cut axis."""
        out = []
        for i, entry in enumerate(tuple(self.spec)[:ndim]):
            names = mesh_axes(entry)
            parts, index = 1, 0
            for name in names:
                size = self.mesh.shape[name]
                parts *= size
                index = index * size + self.mesh.coord(name)
            if parts > 1:
                out.append((i, parts, index))
        return out

    def local_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The block's shape of a full tensor of ``shape``; raises
        ``ValueError`` where a cut axis does not divide."""
        out = list(shape)
        for i, parts, _ in self._cuts(len(shape)):
            if shape[i] % parts:
                raise ValueError(f"placement {self.spec}: axis {i} of "
                                 f"{tuple(shape)} does not divide into "
                                 f"{parts}")
            out[i] = shape[i] // parts
        return tuple(out)

    def global_shape(self, shape: tuple[int, ...]) -> tuple[int, ...]:
        """The full tensor's shape of a block of ``shape``."""
        out = list(shape)
        for i, parts, _ in self._cuts(len(shape)):
            out[i] = shape[i] * parts
        return tuple(out)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a copy on the mesh's
        device)."""
        self.local_shape(tuple(full.shape))
        block = full
        for i, parts, index in self._cuts(full.dim()):
            n = full.shape[i] // parts
            block = block.narrow(i, index * n, n)
        return block.to(self.mesh.device, copy=True).contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block (a collective: every
        rank of the mesh calls it with its block)."""
        full = local
        for i, parts, _ in reversed(self._cuts(local.dim())):
            names = mesh_axes(self.spec[i])
            for name in reversed(names):
                full = all_gather_axis(full, self.mesh.groups[name],
                                       self.mesh.shape[name], i)
        return full


def all_gather_axis(t: torch.Tensor, group, parts: int,
                    axis: int) -> torch.Tensor:
    """``parts`` ranks' tensors of ``group`` concatenated along ``axis``
    in group order (``all_gather_into_tensor`` on axis 0)."""
    if parts == 1:
        return t
    front = torch.movedim(t, axis, 0).contiguous()
    out = torch.empty((parts * front.shape[0], *front.shape[1:]),
                      dtype=t.dtype, device=t.device)
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
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

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
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (every member gets the sum); its
    backward is the identity (``None``: one rank, nothing to sum)."""
    return x if group is None else _ReduceSum.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` as it is; its gradient is summed over ``group``."""
    return x if group is None else _CopyTo.apply(x, group)


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
