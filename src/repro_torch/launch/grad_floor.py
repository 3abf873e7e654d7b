"""The gradient floor of a configuration: how far float32 rounding
alone moves its gradients.

One process's gradients of a seeded batch are taken twice: with the
weights as drawn, and with each weight times ``(1 + noise · N(0, 1))``
(``noise`` 1e-7, a rounding's worth).  The floor is the larger, over
the leaves, of max |Δg| / max |g|.  A check that holds a tensor-parallel
run's gradients against one process's cannot be tighter than this; the
mesh checks of ``chip_smoke.py`` set their gradient limit from it,
measured in the same run.

    python -m repro_torch.launch.grad_floor --arch hymba-1.5b --layers 4 \\
        --rows 2 --seq 1280 [--device cpu]

prints ``floor <value> at <leaf>`` (full width in float32, cut to
``--layers``; seed-0 weights, the batch from ``--seed``).  Without
``--device cpu`` it runs on the card.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import transformer as tf
from repro_torch.train._tree import leaves, tree_map
from repro_torch.train.trainer import value_and_grad


def lm_batch(vocab: int, rows: int, seq: int, seed: int) -> dict:
    """int32 tokens and labels (the first row's first 8 ignored) as
    numpy, from ``seed``."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, vocab, (rows, seq + 1))
    labels = toks[:, 1:].astype(np.int32)
    labels[0, :8] = -1
    return {"tokens": toks[:, :-1].astype(np.int32), "labels": labels}


def grad_err(a: list, b: list) -> float:
    """Max over leaves of max |a - b| / max |b| (the difference in
    float64; a NaN counts as infinite)."""
    def err(x, y):
        diff = (x.to(torch.float64) - y.to(torch.float64)).abs()
        return float(torch.nan_to_num(diff, nan=float("inf")).max())

    return max(err(x, y) / max(float(y.abs().max()), 1e-30)
               for x, y in zip(a, b))


def grad_floor(params, cfg, batch: dict, noise: float = 1e-7,
               seed: int = 5) -> tuple:
    """(loss, gradients in flatten order, floor, the leaf index where
    the floor is) of ``batch`` (tensors on the parameters' device)."""
    loss, grads = value_and_grad(params, cfg, batch)
    device = leaves(params)[0].device
    gen = torch.Generator(device=device).manual_seed(seed)
    noisy = tree_map(lambda t: t * (1 + noise * torch.randn(
        t.shape, generator=gen, device=device)), params)
    moved = value_and_grad(noisy, cfg, batch)[1]
    errs = [grad_err([x], [y]) for x, y in zip(moved, grads)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    return loss, grads, errs[worst], worst


def _leaf_names(tree, path: str = "") -> list[str]:
    """The leaves' key paths in flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{path}/{i}")]
    return [path]


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, required=True)
    ap.add_argument("--rows", type=int, default=2)
    ap.add_argument("--seq", type=int, default=1280)
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("grad_floor: no CUDA card; pass --device cpu")
    cfg = dataclasses.replace(get_config(args.arch), dtype="float32",
                              n_layers=args.layers)
    params = tf.init_params(
        cfg, torch.Generator(device=args.device).manual_seed(0), args.device)
    host = lm_batch(cfg.vocab_size, args.rows, args.seq, args.seed)
    batch = {k: torch.from_numpy(v).to(args.device) for k, v in host.items()}
    loss, _, floor, at = grad_floor(params, cfg, batch)
    print(f"{cfg.name} {args.layers} layers float32, {args.rows} x "
          f"{args.seq} tokens on {args.device}: loss {float(loss)!r}; "
          f"floor {floor!r} at {_leaf_names(params)[at]}", flush=True)


if __name__ == "__main__":
    main()
