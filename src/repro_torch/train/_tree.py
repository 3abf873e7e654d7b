"""Parameter and optimizer trees (nested dicts, lists and tuples of
tensors) in JAX's flatten order: dict keys sorted, lists and tuples in
order, ``None`` an empty subtree.  The checkpoint's leaf order, the
optimizer's norm and the train step's gradients all follow it, so that
a checkpoint written by either package restores in the other."""

from __future__ import annotations

from typing import Any, Callable


def leaves(tree: Any, tuples: bool = False) -> list:
    """The tree's leaves in JAX's flatten order (with ``tuples``, a
    tuple is a leaf: the trees of shapes and partition specs)."""
    out: list = []
    _collect(tree, out, tuple if tuples else ())
    return out


def _collect(tree: Any, out: list, leaf_types) -> None:
    if tree is None:
        return
    if isinstance(tree, leaf_types):
        out.append(tree)
    elif isinstance(tree, dict):
        for key in sorted(tree):
            _collect(tree[key], out, leaf_types)
    elif isinstance(tree, (list, tuple)):
        for node in tree:
            _collect(node, out, leaf_types)
    else:
        out.append(tree)


def unflatten(example: Any, values: list) -> Any:
    """A tree of ``example``'s structure holding ``values`` (in flatten
    order) at its leaves; raises if the counts differ."""
    it = iter(values)
    tree = _rebuild(example, it)
    if next(it, _END) is not _END:
        raise ValueError("unflatten: more values than the tree has leaves")
    return tree


_END = object()


def _rebuild(node: Any, it) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        rebuilt = {key: _rebuild(node[key], it) for key in sorted(node)}
        return {key: rebuilt[key] for key in node}
    if isinstance(node, (list, tuple)):
        items = [_rebuild(n, it) for n in node]
        return items if isinstance(node, list) else tuple(items)
    value = next(it, _END)
    if value is _END:
        raise ValueError("unflatten: fewer values than the tree has leaves")
    return value


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    others = [leaves(t) for t in rest]
    return unflatten(tree, [fn(*args) for args in
                            zip(leaves(tree), *others)])


def describe(tree: Any) -> str:
    """The tree's structure as text, leaves as ``*`` (the checkpoint
    manifest's ``treedef``; no reader parses it)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{key!r}: {describe(tree[key])}"
                               for key in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(describe(n) for n in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(describe(n) for n in tree) + ")"
    return "*"
