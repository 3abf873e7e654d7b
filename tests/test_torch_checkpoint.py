"""The port's checkpoints and its crash-restart drill on the CPU: the
reference's checkpoint tests (tests/test_fault_tolerance.py) on
``repro_torch.train.checkpoint``; checkpoints restored across the two
packages both ways with bf16 leaves (leaf keys, shapes, dtypes and CRCs
equal to the reference's own save of the same tree); the async
checkpointer's host copy, which in-place updates after ``maybe_save``
must not reach; and the crash-at-7 drill of ``run_elastic`` at the
reference's tolerances (losses 1e-5 relative, parameters rtol 1e-5 /
atol 1e-6).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.train import checkpoint as ref_ckpt
from repro_torch.configs import get_config
from repro_torch.data import DataConfig
from repro_torch.train._tree import leaves
from repro_torch.train.checkpoint import (
    AsyncCheckpointer,
    CheckpointCorruption,
    latest_step,
    prune_old,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.train.elastic import CrashRequested, ElasticRun, run_elastic
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import TrainConfig


def _tree():
    """A parameter-and-optimizer-shaped tree with bf16, float32 and int32
    leaves, keys out of sorted order and a list."""
    rng = np.random.default_rng(0)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "b": rng.standard_normal((5,)).astype(np.float32)
                       .astype(ml_dtypes.bfloat16),
                       "layers": [rng.standard_normal((2, 2))
                                  .astype(np.float32) for _ in range(2)]},
            "opt": {"count": np.array(7, np.int32),
                    "m": rng.standard_normal((2, 3)).astype(np.float32)
                    .astype(ml_dtypes.bfloat16)}}


def _port_tree(tree):
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
        return torch.from_numpy(x.copy())
    return conv(tree)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.float().numpy().astype(ml_dtypes.bfloat16)
    return t.numpy()


def test_checkpoint_roundtrip_bitwise(tmp_path):
    tree = {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.bfloat16)}}
    save_checkpoint(tmp_path, 7, tree, meta={"next_step": 8})
    assert latest_step(tmp_path) == 7
    restored, meta = restore_checkpoint(tmp_path, 7, tree)
    assert meta["next_step"] == 8
    for a, b in zip(leaves(tree), leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_corruption_detected(tmp_path):
    tree = {"w": torch.ones((4, 4))}
    path = save_checkpoint(tmp_path, 1, tree)
    f = path / "arrays.npz"
    raw = bytearray(f.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    f.write_bytes(bytes(raw))
    with pytest.raises((CheckpointCorruption, Exception)):
        restore_checkpoint(tmp_path, 1, tree)


def test_checkpoint_crc_and_leaf_count_are_checked(tmp_path):
    """A leaf whose bytes no longer match its CRC, and a tree of another
    leaf count, are refused with ``CheckpointCorruption``."""
    tree = {"w": torch.ones((4, 4)), "v": torch.zeros(3)}
    path = save_checkpoint(tmp_path, 1, tree)
    manifest = json.loads((path / "manifest.json").read_text())
    manifest["leaves"][0]["crc32"] ^= 1
    (path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(CheckpointCorruption, match="CRC"):
        restore_checkpoint(tmp_path, 1, tree)
    save_checkpoint(tmp_path, 2, tree)
    with pytest.raises(CheckpointCorruption, match="leaves"):
        restore_checkpoint(tmp_path, 2, {"w": tree["w"]})
    with pytest.raises(CheckpointCorruption, match="COMMITTED"):
        restore_checkpoint(tmp_path, 3, tree)


def test_torn_checkpoint_ignored(tmp_path):
    tree = {"w": torch.ones((2,))}
    save_checkpoint(tmp_path, 5, tree)
    torn = tmp_path / "step_00000009"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert latest_step(tmp_path) == 5


def test_prune_old_keeps_latest(tmp_path):
    tree = {"w": torch.ones((2,))}
    for s in (1, 2, 3, 4):
        save_checkpoint(tmp_path, s, tree)
    prune_old(tmp_path, keep=2)
    assert latest_step(tmp_path) == 4
    assert not (tmp_path / "step_00000001").exists()


def test_async_checkpointer_overlaps_and_commits(tmp_path):
    ckpt = AsyncCheckpointer(tmp_path, every_steps=2, keep=2)
    tree = {"w": torch.ones((8,))}
    for step in range(6):
        ckpt.maybe_save(step, tree, meta={"next_step": step + 1})
    ckpt.wait()
    assert latest_step(tmp_path) == 4
    assert ckpt.saved_steps == [0, 2, 4]


def test_async_save_is_not_torn_by_in_place_updates(tmp_path):
    """``maybe_save`` copies to the host before it returns: the
    optimizer's in-place update of the next step (here at once, before
    the writer thread can have run) does not reach the checkpoint."""
    ckpt = AsyncCheckpointer(tmp_path, every_steps=1)
    w = torch.arange(1 << 16, dtype=torch.float32)
    for step in range(3):
        ckpt.maybe_save(step, {"w": w}, meta={"next_step": step + 1})
        w.add_(1.0)
    ckpt.wait()
    for step in (1, 2):
        got, _ = restore_checkpoint(tmp_path, step, {"w": w})
        assert torch.equal(got["w"], torch.arange(1 << 16,
                                                  dtype=torch.float32)
                           + step)


def _manifest(path: pathlib.Path) -> dict:
    return json.loads((path / "manifest.json").read_text())


def test_checkpoints_cross_restore_with_the_reference(tmp_path):
    """The same tree saved by each package: equal leaf keys, shapes,
    dtypes and CRCs (in JAX's flatten order); each package restores the
    other's checkpoint to equal values and dtypes, bf16 included."""
    tree = _tree()
    ref_path = ref_ckpt.save_checkpoint(tmp_path / "ref", 3,
                                        jax.tree.map(jnp.asarray, tree),
                                        meta={"next_step": 4})
    port_path = save_checkpoint(tmp_path / "port", 3, _port_tree(tree),
                                meta={"next_step": 4})
    a, b = _manifest(ref_path), _manifest(port_path)
    assert a["leaves"] == b["leaves"]
    assert a["meta"] == b["meta"] and a["step"] == b["step"]
    assert [e["dtype"] for e in b["leaves"]] == [
        "int32", "bfloat16", "bfloat16", "float32", "float32", "float32"]

    got, meta = restore_checkpoint(tmp_path / "ref", 3, _port_tree(tree))
    assert meta == {"next_step": 4}
    for g, want in zip(leaves(got), jax.tree.leaves(tree)):
        assert str(g.dtype).endswith(str(want.dtype))
        assert _as_numpy(g).tobytes() == np.asarray(want).tobytes()

    ref_got, meta = ref_ckpt.restore_checkpoint(
        tmp_path / "port", 3, jax.tree.map(jnp.asarray, tree))
    assert meta == {"next_step": 4}
    for g, want in zip(jax.tree.leaves(ref_got), jax.tree.leaves(tree)):
        assert g.dtype == want.dtype
        assert np.asarray(g).tobytes() == np.asarray(want).tobytes()


def _make_run(tmp_path: pathlib.Path) -> ElasticRun:
    cfg = get_config("tinyllama-1.1b").reduced()
    return ElasticRun(
        cfg=cfg,
        tcfg=TrainConfig(optimizer=AdamWConfig(
            lr=1e-3, warmup_steps=2, total_steps=12)),
        data=DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                        global_batch=4),
        ckpt_dir=tmp_path / "ckpt",
        ckpt_every=3,
    )


def test_crash_restart_reproduces_uninterrupted_run(tmp_path):
    """The fault-tolerance drill on the port: crash after step 7,
    restart, and compare the trajectory and the final parameters with
    a clean run (the reference's tolerances; on the CPU the two runs
    agree bit for bit)."""
    clean = run_elastic(_make_run(tmp_path / "a"), total_steps=12,
                        device="cpu")
    run_b = _make_run(tmp_path / "b")
    with pytest.raises(CrashRequested):
        run_elastic(run_b, total_steps=12, crash_at=7, device="cpu")
    resumed = run_elastic(run_b, total_steps=12, device="cpu")
    assert resumed["resumed_from"] == 7  # ckpt at step 6 → next_step 7

    clean_losses = {h["step"]: h["loss"] for h in clean["history"]}
    for h in resumed["history"]:
        assert clean_losses[h["step"]] == pytest.approx(
            h["loss"], rel=1e-5), f"diverged at step {h['step']}"
    for a, b in zip(leaves(clean["params"]), leaves(resumed["params"])):
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.detach().float().numpy(),
                                   rtol=1e-5, atol=1e-6)
    for a, b in zip(leaves([clean["params"], clean["opt_state"]]),
                    leaves([resumed["params"], resumed["opt_state"]])):
        assert torch.equal(a, b)
