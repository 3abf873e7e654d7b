"""Integrity-checked, async checkpointing, in ``repro.train.checkpoint``'s
layout, so that each package restores the other's checkpoints:

    step_000123/
      manifest.json      tree structure, shapes, dtypes, CRCs, step, meta
      arrays.npz         flattened leaves, each as its raw bytes (uint8)
      COMMITTED          sentinel written last — a directory without it is
                         torn and ignored on restore (crash-safe)

Leaves are stored in JAX's flatten order (dict keys sorted, lists in
order) under the reference's keys (``leaf_00000`` …), dtype names
(``"bfloat16"``, ``"float32"``, ``"int32"``) and CRC32s over the same
raw bytes; a bf16 leaf needs no numpy dtype of its own (its bytes are
read back through a torch view).

Fault-tolerance contract (the drill of ``repro_torch.train.elastic``):
  - save is atomic (tmp dir + rename, sentinel last);
  - restore verifies each leaf's CRC32 and the leaf count;
  - ``AsyncCheckpointer`` copies the tree to the host before it returns
    (a blocking copy: the optimizer updates the card's tensors in
    place) and serializes on one background thread, at most one save in
    flight.

On a mesh of ranks (``placements``: a tree of
:class:`~repro_torch.launch.mesh.Placement` matching the saved tree),
``save_checkpoint`` gathers each leaf's blocks into the full array of
the reference's format (a collective: every rank calls it) and one rank
writes; ``restore_checkpoint(placements=)`` reads the full arrays and
cuts each rank's blocks for its mesh, which may differ from the one
that saved (elastic restart; the reference's ``shardings=``).

Deliberate differences: the manifest's ``"treedef"`` is the port's own
text of the tree (JAX's ``PyTreeDef`` repr cannot be written without
JAX; neither package's restore reads it), and ``restore_checkpoint``
takes a ``device`` for the leaves without a mesh.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import zlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.mesh import all_reduce, gather_tree, shard_tree
from repro_torch.train._tree import describe, leaves, tree_map, unflatten

_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16, "float64": torch.float64,
                 "int32": torch.int32, "int64": torch.int64,
                 "int8": torch.int8, "uint8": torch.uint8,
                 "bool": torch.bool}
_NAMES = {dt: name for name, dt in _TORCH_DTYPES.items()}


def _host(leaf: Any) -> torch.Tensor:
    """A host copy of one leaf (a tensor, numpy array or number) that
    later in-place updates of the leaf do not reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.from_numpy(np.array(leaf))


def _raw(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(the tensor's bytes as a flat uint8 array, its dtype name)."""
    if t.dtype not in _NAMES:
        raise TypeError(f"checkpoint: no stored name for dtype {t.dtype}")
    flat = t.contiguous().reshape(-1)
    if t.dtype == torch.bool:
        flat = flat.to(torch.uint8)
    return flat.view(torch.uint8).numpy(), _NAMES[t.dtype]


def _mesh_of(placements: Any):
    return leaves(placements)[0].mesh


def _commit_point(mesh) -> None:
    """Every rank of ``mesh`` waits here for the writer (an all-reduce
    over the world)."""
    flag = torch.zeros(1, device=mesh.device)
    all_reduce(flag, dist.group.WORLD)


def save_checkpoint(directory: str | pathlib.Path, step: int, tree: Any,
                    *, meta: dict | None = None,
                    placements: Any = None) -> pathlib.Path:
    """Atomic synchronous save; returns the committed directory.  With
    ``placements`` (a collective) the leaves' blocks are gathered, the
    mesh's writer rank writes, and every rank returns once the
    directory is committed."""
    if placements is not None:
        mesh = _mesh_of(placements)
        full = gather_tree(tree, placements)
        path = pathlib.Path(directory) / f"step_{step:08d}"
        if mesh.is_writer:
            path = save_checkpoint(directory, step, full, meta=meta)
        if mesh.size > 1:
            _commit_point(mesh)
        return path
    directory = pathlib.Path(directory)
    final = directory / f"step_{step:08d}"
    tmp = directory / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    arrays = {}
    manifest: dict = {"step": step, "treedef": describe(tree),
                      "meta": meta or {}, "leaves": []}
    for i, leaf in enumerate(leaves(tree)):
        t = _host(leaf)
        raw, dtype = _raw(t)
        key = f"leaf_{i:05d}"
        arrays[key] = raw
        manifest["leaves"].append({
            "key": key,
            "shape": list(t.shape),
            "dtype": dtype,
            "crc32": zlib.crc32(raw.tobytes()),
        })
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / "COMMITTED").write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


class CheckpointCorruption(RuntimeError):
    pass


def latest_step(directory: str | pathlib.Path) -> int | None:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.iterdir()
             if p.name.startswith("step_") and (p / "COMMITTED").exists()]
    return max(steps) if steps else None


def restore_checkpoint(directory: str | pathlib.Path, step: int,
                       example_tree: Any, *,
                       device: str | torch.device = "cpu",
                       placements: Any = None) -> tuple[Any, dict]:
    """Restore ``step`` into the structure of ``example_tree`` (its
    leaves' values and dtypes are not read), each leaf a tensor of its
    stored dtype and shape on ``device``, or, with ``placements``, this
    rank's block of it on the placement's mesh (re-sharding onto a mesh
    other than the one that saved); returns (tree, meta)."""
    path = pathlib.Path(directory) / f"step_{step:08d}"
    if not (path / "COMMITTED").exists():
        raise CheckpointCorruption(f"{path} has no COMMITTED sentinel")
    manifest = json.loads((path / "manifest.json").read_text())
    values = []
    with np.load(path / "arrays.npz") as data:
        for entry in manifest["leaves"]:
            raw = np.ascontiguousarray(data[entry["key"]])
            if zlib.crc32(raw.tobytes()) != entry["crc32"]:
                raise CheckpointCorruption(
                    f"CRC mismatch for {entry['key']} in {path}")
            dtype = _TORCH_DTYPES.get(entry["dtype"])
            if dtype is None:
                raise CheckpointCorruption(
                    f"{entry['key']} in {path} has dtype "
                    f"{entry['dtype']!r}, which the port does not read")
            t = torch.from_numpy(raw.view(np.uint8).copy())
            t = t.view(dtype) if dtype != torch.bool else t.bool()
            t = t.reshape(entry["shape"])
            values.append(t if placements is not None else t.to(device))
    try:
        tree = unflatten(example_tree, values)
    except ValueError as exc:
        raise CheckpointCorruption(f"{path}: {exc}") from None
    if placements is not None:
        tree = shard_tree(tree, placements)
    return tree, manifest["meta"]


def prune_old(directory: str | pathlib.Path, keep: int = 3) -> None:
    directory = pathlib.Path(directory)
    steps = sorted(int(p.name.split("_")[1]) for p in directory.iterdir()
                   if p.name.startswith("step_")
                   and (p / "COMMITTED").exists())
    for s in steps[:-keep]:
        shutil.rmtree(directory / f"step_{s:08d}")


class AsyncCheckpointer:
    """At-most-one-in-flight background checkpointer.

    ``maybe_save`` copies the tree to the host (blocking) before it
    returns, then serializes on a worker thread so the train loop keeps
    stepping; ``wait()`` joins before process exit.  With
    ``placements`` (a mesh of ranks) ``maybe_save`` gathers the leaves'
    blocks first (a collective: every rank calls it) and only the
    mesh's writer rank serializes; ``wait()`` then returns on every rank
    once the writer has committed.
    """

    def __init__(self, directory: str | pathlib.Path, *,
                 every_steps: int = 100, keep: int = 3,
                 placements: Any = None):
        self.directory = pathlib.Path(directory)
        self.every_steps = every_steps
        self.keep = keep
        self.placements = placements
        self._pending = False
        self._thread: threading.Thread | None = None
        self.saved_steps: list[int] = []

    def maybe_save(self, step: int, tree: Any,
                   meta: dict | None = None) -> bool:
        if step % self.every_steps != 0:
            return False
        self.wait()
        if self.placements is not None:
            tree = gather_tree(tree, self.placements)
            self._pending = _mesh_of(self.placements).size > 1
            if not _mesh_of(self.placements).is_writer:
                self.saved_steps.append(step)
                return True
        host_tree = tree_map(_host, tree)

        def work():
            save_checkpoint(self.directory, step, host_tree, meta=meta)
            prune_old(self.directory, self.keep)
            self.saved_steps.append(step)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            _commit_point(_mesh_of(self.placements))
