"""``forward_train``'s loss and every gradient leaf for each config of
``configs/`` other than tinyllama-1.1b (test_torch_train.py holds that
one; test_torch_train_hybrid.py holds whisper, hymba and xlstm with
this file's check), reduced, against ``jax.value_and_grad`` of the reference's
``forward_train`` with the same weights (``lm_params_from_numpy``) and
batch: the dense (qwen2's QKV bias, phi3, deepseek-7b), moe (kimi-k2;
deepseek-v2-lite with MLA, whose V is padded to the 192-wide head),
vlm (qwen2-vl with M-RoPE grids of a stub image block), audio (whisper:
encoder frames, cross-attention), hybrid (hymba: the window and the
Mamba heads) and ssm (xlstm: mLSTM and sLSTM blocks) families, with
remat on for each (the reduced configs turn it off; the reference's
``jax.checkpoint`` changes no value).

Tolerances: the loss within 1e-5 relative; each gradient leaf within
1e-4 x its largest |value| (the measured worst is ~2.3e-6, MLA), except
xlstm at 1e-3: the mLSTM divides by ``max(|q·n|, exp(-2μ))``, so the
float32 rounding of the two packages' forwards (1e-7) grows through
that division's derivative; the measured worst is 1.0e-4 over three
seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.transformer import Runtime
from repro.models.transformer import forward_train as ref_forward_train
from repro.models.transformer import init_params as ref_init_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.transformer import forward_train
from repro_torch.train._tree import leaves

RT = Runtime()
#: the families of test_torch_train_hybrid.py (one file each, to keep
#: a file's time short on one test worker)
HEAVY = ("whisper-large-v3", "hymba-1.5b", "xlstm-350m")
ARCHS = [a for a in ARCH_IDS if a != "tinyllama-1.1b" and a not in HEAVY]
LOSS_TOL = 1e-5
GRAD_TOL = {"xlstm-350m": 1e-3}


@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    rcfg = ref_get_config(arch).reduced()
    params, _ = ref_init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(1)
    layers = tree["layers"]
    for lp in (layers if isinstance(layers, list) else [layers]):
        for key, arr in lp.items():
            if key.endswith("_g"):
                lp[key] = (1 + 0.1 * rng.standard_normal(arr.shape)
                           ).astype(np.float32)
            elif key in ("bq", "bk", "bv"):
                lp[key] = (0.1 * rng.standard_normal(arr.shape)
                           ).astype(np.float32)
    return rcfg, tree


def _batch(rcfg, b: int = 2, s: int = 24) -> dict:
    rng = np.random.default_rng(5)
    labels = rng.integers(0, rcfg.vocab_size, (b, s)).astype(np.int32)
    labels[1, :4] = -1
    batch = {"tokens": rng.integers(0, rcfg.vocab_size, (b, s))
             .astype(np.int32), "labels": labels}
    if rcfg.family == "audio":
        batch["encoder_frames"] = rng.standard_normal(
            (b, rcfg.encoder_seq, rcfg.d_model)).astype(np.float32)
    if rcfg.mrope_sections:
        # text, then a 4 x 4 image block at one temporal position, text
        t = np.arange(s)
        h, w = t.copy(), t.copy()
        img = slice(4, 20)
        t[img], h[img], w[img] = 4, 4 + np.arange(16) // 4, \
            4 + np.arange(16) % 4
        t[20:] = h[20:] = w[20:] = np.arange(8, 8 + s - 20)
        batch["positions"] = np.broadcast_to(
            np.stack([t, h, w])[:, None], (3, b, s)).astype(np.int32)
    return batch


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_the_reference(arch):
    check_arch(arch)


def check_arch(arch: str) -> None:
    """Loss and every gradient leaf of ``arch`` against the reference."""
    rcfg, tree = _weights(arch)
    batch = _batch(rcfg)
    ref_loss, ref_grads = jax.value_and_grad(ref_forward_train)(
        jax.tree.map(jnp.asarray, tree), rcfg,
        {k: jnp.asarray(v) for k, v in batch.items()}, RT)
    cfg = get_config(arch).reduced(remat=True)
    params = lm_params_from_numpy(tree, cfg, "cpu")
    params_l = leaves(params)
    for p in params_l:
        p.requires_grad_(True)
    loss = forward_train(params, cfg, {k: torch.from_numpy(np.array(v))
                                       for k, v in batch.items()})
    grads = torch.autograd.grad(loss, params_l)
    assert float(loss) == pytest.approx(float(ref_loss), rel=LOSS_TOL)
    want = leaves(lm_params_from_numpy(jax.tree.map(np.asarray, ref_grads),
                                       cfg, "cpu"))
    assert len(grads) == len(want)
    tol = GRAD_TOL.get(arch, 1e-4)
    for g, w in zip(grads, want):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((g - w).abs().max()) <= tol * scale
