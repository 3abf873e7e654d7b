"""The port's training path on the CPU, against the JAX package: reduced
tinyllama-1.1b's ``forward_train`` loss and every gradient leaf (weights
carried across with ``lm_params_from_numpy``), with remat on and off;
``chunked_softmax_xent`` on a ragged last chunk with ignored labels;
AdamW steps from the same gradients and state (``opt_state_from_numpy``)
with float32 and bf16 moments; the train step with gradient
accumulation; the synthetic data stream byte for byte; and
error-feedback compression.

Tolerances (float32 throughout; the two packages sum in other orders):
loss within 1e-5 relative; each gradient leaf within 1e-4 x its largest
|value| (the measured worst over the reduced configs is ~2e-6, xlstm's
sLSTM recurrence aside: see test_torch_train_families.py); AdamW's new
parameters within 1e-6 x max |p| and moments within 1e-5 x their max
(the bias corrections' ``pow`` and the update's ``sqrt`` may differ by
an ulp between XLA and PyTorch); a bf16 moment within one bf16 ulp of
its value (2^-7 relative: the same float32 value can round either way
after an ulp of difference); after a whole train step, whose gradients
the two packages compute, parameters within 1e-2 x lr (an element whose
gradient is near AdamW's eps turns a 1e-6 gradient difference into a
part of its update).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.data.pipeline import DataConfig as RefDataConfig
from repro.data.pipeline import SyntheticLMStream as RefStream
from repro.models.transformer import Runtime
from repro.models.transformer import chunked_softmax_xent as ref_xent
from repro.models.transformer import forward_train as ref_forward_train
from repro.models.transformer import init_params as ref_init_params
from repro.train import grad_compress as ref_gc
from repro.train import optimizer as ref_opt
from repro.train.trainer import TrainConfig as RefTrainConfig
from repro.train.trainer import make_train_step as ref_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, opt_state_from_numpy
from repro_torch.data import DataConfig, SyntheticLMStream
from repro_torch.launch import train as launch_train
from repro_torch.models.transformer import chunked_softmax_xent, \
    forward_train
from repro_torch.train import grad_compress as gc
from repro_torch.train import optimizer as opt
from repro_torch.train._tree import leaves
from repro_torch.train.trainer import TrainConfig, make_train_step

RT = Runtime()
ARCH = "tinyllama-1.1b"
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    """(reference config, reference params, numpy tree): seed-0
    reference weights with norm gains perturbed so they matter."""
    rcfg = ref_get_config(arch).reduced()
    params, _ = ref_init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(1)
    for key, arr in tree["layers"].items():
        if key.endswith("_g"):
            tree["layers"][key] = (1 + 0.1 * rng.standard_normal(
                arr.shape)).astype(np.float32)
    return rcfg, tree


def _batch(rcfg, b: int = 2, s: int = 24, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, rcfg.vocab_size, (b, s)).astype(np.int32)
    labels[0, -3:] = -1
    return {"tokens": rng.integers(0, rcfg.vocab_size, (b, s))
            .astype(np.int32), "labels": labels}


def _port_params(tree, cfg):
    return lm_params_from_numpy(tree, cfg, "cpu")


def _assert_tree_close(got, want_tree, cfg, tol):
    want = leaves(lm_params_from_numpy(want_tree, cfg, "cpu"))
    got = leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g.float() - w.float()).abs().max()) <= tol * scale


def _loss_and_grads(params, cfg, batch):
    params_l = leaves(params)
    for p in params_l:
        p.requires_grad_(True)
    loss = forward_train(params, cfg, {k: torch.from_numpy(v)
                                       for k, v in batch.items()})
    return loss, torch.autograd.grad(loss, params_l)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_train_loss_and_grads_match_the_reference(remat):
    rcfg, tree = _weights(ARCH)
    batch = _batch(rcfg)
    ref_loss, ref_grads = jax.value_and_grad(ref_forward_train)(
        jax.tree.map(jnp.asarray, tree), rcfg,
        {k: jnp.asarray(v) for k, v in batch.items()}, RT)
    cfg = get_config(ARCH).reduced(remat=remat)
    loss, grads = _loss_and_grads(_port_params(tree, cfg), cfg, batch)
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_TOL)
    _assert_tree_close(grads, jax.tree.map(np.asarray, ref_grads), cfg,
                       GRAD_TOL)


def test_remat_gives_the_same_loss_and_grads():
    """Activation checkpointing recomputes the same operations: equal
    bits."""
    rcfg, tree = _weights(ARCH)
    batch = _batch(rcfg, seed=3)
    out = {}
    for remat in (False, True):
        cfg = get_config(ARCH).reduced(remat=remat)
        out[remat] = _loss_and_grads(_port_params(tree, cfg), cfg, batch)
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("s,chunk", [(24, 10), (24, 24), (7, 1024)])
def test_chunked_softmax_xent_matches_the_reference(s, chunk):
    rcfg, tree = _weights(ARCH)
    cfg = get_config(ARCH).reduced()
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, rcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, rcfg.vocab_size, (2, s)).astype(np.int32)
    labels[1, ::3] = -1
    want = ref_xent(jax.tree.map(jnp.asarray, tree), rcfg, jnp.asarray(x),
                    jnp.asarray(labels), RT, chunk=chunk)
    got = chunked_softmax_xent(_port_params(tree, cfg), cfg,
                               torch.from_numpy(x), torch.from_numpy(labels),
                               chunk=chunk)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=LOSS_TOL)
    # every label ignored: the sum over a count clamped at 1
    none = chunked_softmax_xent(_port_params(tree, cfg), cfg,
                                torch.from_numpy(x),
                                torch.full((2, s), -1), chunk=chunk)
    assert float(none) == 0.0


def _grads_tree(rcfg, tree, seed):
    """Reference gradients (numpy) at a seeded batch."""
    _, g = jax.value_and_grad(ref_forward_train)(
        jax.tree.map(jnp.asarray, tree), rcfg,
        {k: jnp.asarray(v) for k, v in _batch(rcfg, seed=seed).items()}, RT)
    return jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_the_reference(moment_dtype):
    """Three AdamW steps from the same parameters, gradients and state
    (the first from zero moments, the later from moments carried across
    with ``opt_state_from_numpy``), with clipping active."""
    rcfg, tree = _weights(ARCH)
    cfg = get_config(ARCH).reduced()
    rc = ref_opt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=5,
                             grad_clip=0.5, moment_dtype=moment_dtype)
    pc = opt.AdamWConfig(**{f.name: getattr(rc, f.name)
                            for f in dataclasses.fields(opt.AdamWConfig)})
    params = jax.tree.map(jnp.asarray, tree)
    state, _ = ref_opt.adamw_init(params, None, rc)
    for step in range(3):
        grads_np = _grads_tree(rcfg, jax.tree.map(np.asarray, params), step)
        p_port = _port_params(jax.tree.map(np.asarray, params), cfg)
        s_port = opt_state_from_numpy(jax.tree.map(np.asarray, state), cfg,
                                      "cpu")
        g_port = lm_params_from_numpy(grads_np, cfg, "cpu")
        params, state, metrics = ref_opt.adamw_update(
            jax.tree.map(jnp.asarray, grads_np), state, params, rc)
        p_new, s_new, m_port = opt.adamw_update(g_port, s_port, p_port, pc)
        assert p_new is p_port                  # updated in place
        assert float(m_port["grad_norm"]) == pytest.approx(
            float(metrics["grad_norm"]), rel=1e-6)
        assert float(m_port["lr"]) == pytest.approx(float(metrics["lr"]),
                                                    rel=1e-6)
        assert int(s_new["count"]) == int(state["count"]) == step + 1
        _assert_tree_close(p_new, jax.tree.map(np.asarray, params), cfg,
                           1e-6)
        for key in ("m", "v"):
            tol = 2 ** -7 if moment_dtype == "bfloat16" else 1e-5
            want = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                state[key])
            for g, w in zip(leaves(s_new[key]), leaves(
                    lm_params_from_numpy(want, cfg, "cpu"))):
                assert g.dtype == (torch.bfloat16 if moment_dtype
                                   == "bfloat16" else torch.float32)
                diff = (g.float() - w.float()).abs()
                assert bool((diff <= tol * w.float().abs()
                             + 1e-6 * float(w.abs().max())).all())


def test_adamw_config_and_schedule_match_the_reference():
    """The port's AdamWConfig has the reference's fields, ``zero_shard``
    (ZeRO-2 over a mesh's ``"data"`` ranks) among them, with the same
    defaults; the schedule's values."""
    ref_fields = {f.name: f.default
                  for f in dataclasses.fields(ref_opt.AdamWConfig)}
    assert {f.name: f.default for f in dataclasses.fields(
        opt.AdamWConfig)} == ref_fields
    assert opt.AdamWConfig(zero_shard=True).zero_shard
    rc = ref_opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=20)
    pc = opt.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=20)
    for step in (0, 1, 4, 5, 6, 13, 20, 25):
        want = float(ref_opt.lr_schedule(rc, jnp.float32(step)))
        got = float(opt.lr_schedule(pc, torch.tensor(float(step))))
        assert got == pytest.approx(want, rel=1e-6)


def test_train_step_with_accumulation_matches_the_reference():
    rcfg, tree = _weights(ARCH)
    cfg = get_config(ARCH).reduced()
    rc = ref_opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    pc = opt.AdamWConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    batch = _batch(rcfg, b=4, seed=7)
    params = jax.tree.map(jnp.asarray, tree)
    state, _ = ref_opt.adamw_init(params, None, rc)
    ref_step = jax.jit(ref_make_train_step(
        rcfg, RefTrainConfig(optimizer=rc, accum_steps=2), RT))
    want_p, _, want_m = ref_step(params, state,
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    p_port = _port_params(tree, cfg)
    step = make_train_step(cfg, TrainConfig(optimizer=pc, accum_steps=2))
    got_p, got_s, got_m = step(p_port, opt.adamw_init(p_port, pc), batch)
    assert float(got_m["loss"]) == pytest.approx(float(want_m["loss"]),
                                                 rel=LOSS_TOL)
    assert float(got_m["grad_norm"]) == pytest.approx(
        float(want_m["grad_norm"]), rel=1e-5)
    # the two packages' gradients differ by ~1e-6 relative; where an
    # element's gradient is near AdamW's eps that moves its update by a
    # part of lr (the measured worst is 5.4e-4 x lr)
    for g, w in zip(leaves(got_p), leaves(lm_params_from_numpy(
            jax.tree.map(np.asarray, want_p), cfg, "cpu"))):
        assert float((g.detach() - w).abs().max()) <= 1e-2 * pc.lr
    assert int(got_s["count"]) == 1


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_data_stream_is_byte_identical(seed):
    kw = dict(vocab_size=32000, seq_len=33, global_batch=3, seed=seed)
    ref, port = RefStream(RefDataConfig(**kw)), SyntheticLMStream(
        DataConfig(**kw))
    for step in (0, 1, 7, 1000):
        a, b = ref.batch(step), port.batch(step)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes()
    it = port.iterate(5)
    assert next(it)["tokens"].tobytes() == ref.batch(5)["tokens"].tobytes()


def test_error_feedback_matches_the_reference():
    rng = np.random.default_rng(0)
    shapes = {"a": (17, 5), "b": {"c": (64,)}}
    grads_seq = [jax.tree.map(
        lambda s: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 2))
        .astype(np.float32), shapes, is_leaf=lambda s: isinstance(s, tuple))
        for _ in range(3)]
    ref_ef = ref_gc.ErrorFeedback(jax.tree.map(jnp.asarray, grads_seq[0]))
    ef = gc.ErrorFeedback(jax.tree.map(torch.from_numpy, grads_seq[0]))
    for g in grads_seq:
        want, ref_ef = ref_ef.compress(jax.tree.map(jnp.asarray, g))
        got, ef = ef.compress(jax.tree.map(torch.from_numpy, g))
        for x, y in zip(leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-6,
                                       atol=1e-7)
        for x, y in zip(leaves(ef.residual), jax.tree.leaves(
                ref_ef.residual)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                       atol=1e-6)
    # round half to even, as jnp.round
    q, scale = gc._quantize(torch.tensor([127.0, 0.5, 1.5, -2.5]))
    rq, rscale = ref_gc._quantize(jnp.asarray([127.0, 0.5, 1.5, -2.5]))
    assert q.tolist() == np.asarray(rq).tolist()
    assert float(scale) == float(rscale)


def test_launcher_prints_the_reference_lines(capsys):
    """``python -m repro_torch.launch.train --reduced --device cpu``:
    the reference launcher's per-step and summary lines, a falling
    loss; without a card the default device raises."""
    out = launch_train.main(["--arch", ARCH, "--reduced", "--steps", "4",
                             "--batch", "2", "--seq", "16", "--device",
                             "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[:2] for ln in lines[:4]] == [
        ["step", str(i)] for i in range(4)]
    assert lines[-1].startswith("loss: ")
    hist = out["history"]
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert set(hist[0]) == {"lr", "grad_norm", "loss", "step_time_s",
                            "step"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            launch_train.main(["--arch", ARCH, "--reduced"])
