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

Deliberate differences: the manifest's ``"treedef"`` is the port's own
text of the tree (JAX's ``PyTreeDef`` repr cannot be written without
JAX; neither package's restore reads it), and ``restore_checkpoint``
takes a ``device`` for the leaves in place of the reference's mesh
``shardings`` (re-sharding onto a mesh waits for the four-card item).
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


def save_checkpoint(directory: str | pathlib.Path, step: int, tree: Any,
                    *, meta: dict | None = None) -> pathlib.Path:
    """Atomic synchronous save; returns the committed directory."""
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
                       device: str | torch.device = "cpu"
                       ) -> tuple[Any, dict]:
    """Restore ``step`` into the structure of ``example_tree`` (its
    leaves' values and dtypes are not read), each leaf a tensor of its
    stored dtype and shape on ``device``; returns (tree, meta)."""
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
            values.append(t.reshape(entry["shape"]).to(device))
    try:
        tree = unflatten(example_tree, values)
    except ValueError as exc:
        raise CheckpointCorruption(f"{path}: {exc}") from None
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
    stepping; ``wait()`` joins before process exit.
    """

    def __init__(self, directory: str | pathlib.Path, *,
                 every_steps: int = 100, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.every_steps = every_steps
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.saved_steps: list[int] = []

    def maybe_save(self, step: int, tree: Any,
                   meta: dict | None = None) -> bool:
        if step % self.every_steps != 0:
            return False
        self.wait()
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
