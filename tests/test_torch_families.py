"""The port's moe (deepseek-v2-lite-16b: MLA and routed + shared
experts; kimi-k2-1t-a32b: GQA and routed + shared experts), vlm
(qwen2-vl-72b: M-RoPE) and audio (whisper-large-v3: encoder, sinusoidal
positions, cross-attention) families on the CPU, against the JAX
package, at their ``.reduced()`` configs: ``lm_params_from_numpy``;
``prefill`` and 4 decode steps (logits and every state leaf: ``k``/``v``
or MLA's ``ckv``/``krope``, whisper's ``xk``/``xv``, ``lengths``);
decode against the full forward; ``ServingEngine`` with a mid-batch
refill against the reference engine; ``_scatter_slot`` on the new state
leaves; the launcher's lines; ``apply_mrope`` on non-trivial grids; and
tied embeddings.

Both packages compute with the same weights: the reference's
``init_params`` tree, its norm gains and biases perturbed with numpy so
that every parameter matters, handed to the port as numpy.  The reduced
configs are float32.  Tolerance: ``TOL = 1e-5`` absolute, as
``tests/test_torch_lm.py`` (attention and the expert products sum in
another order); decode against the full forward within the reference's
own 2e-3 (``tests/test_models.py``); engine tokens and launcher lines
identical.
"""

import contextlib
import dataclasses
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_launch
from repro.models import transformer as ref_tf
from repro.models.layers import apply_mrope as ref_apply_mrope
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.models import transformer as tf
from repro_torch.models.layers import apply_mrope, apply_rope
from repro_torch.serve import EngineConfig, ServingEngine
from repro_torch.serve.engine import _scatter_slot

ARCHS = ["deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "qwen2-vl-72b",
         "whisper-large-v3"]
RT = ref_tf.Runtime()
TOL = 1e-5


def _perturb(tree: dict, rng) -> None:
    """Norm gains to 1 ± 0.1, norm and projection biases to ±0.1."""
    for key, arr in tree.items():
        if isinstance(arr, dict):
            _perturb(arr, rng)
        elif key.endswith("_g"):
            tree[key] = (1 + 0.1 * rng.standard_normal(arr.shape)
                         ).astype(np.float32)
        elif key.endswith("_b") or key in ("bq", "bk", "bv"):
            tree[key] = (0.1 * rng.standard_normal(arr.shape)
                         ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    """(reference config, numpy tree, port config, port params)."""
    rcfg = ref_get_config(arch).reduced()
    params, _ = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    _perturb(tree, np.random.default_rng(1))
    if rcfg.family == "audio":
        # whisper adds sinusoidal positions of size ~1 to embeddings of
        # size ~0.02: scaled up, the prompt decides the tokens too
        tree["embed"] = tree["embed"] * 50
    cfg = get_config(arch).reduced()
    return rcfg, tree, cfg, lm_params_from_numpy(tree, cfg, "cpu")


def _ref_params(tree):
    return jax.tree.map(jnp.asarray, tree)


_ref_prefill = jax.jit(ref_tf.prefill, static_argnums=(1, 3, 4))
_ref_decode = jax.jit(ref_tf.decode_step, static_argnums=(1, 4))


def _err(got, want) -> float:
    return float(np.max(np.abs(got.float().numpy()
                               - np.asarray(want, np.float32))))


def _vlm_grid(b: int, s: int) -> np.ndarray:
    """M-RoPE grids [3, B, S]: a 2 x 3 patch block (one temporal step,
    distinct heights and widths) after one text token, then text
    continuing from the block's largest position."""
    t = np.zeros((3, s), np.int64)
    t[:, 0] = 0
    hw = [(i, j) for i in range(2) for j in range(3)]
    for n, (i, j) in enumerate(hw, start=1):
        t[:, n] = (1, 1 + i, 1 + j)
    nxt = 1 + len(hw)
    start = int(t[:, :nxt].max()) + 1
    t[:, nxt:] = start + np.arange(s - nxt)
    return np.broadcast_to(t[:, None], (3, b, s)).copy()


def _batches(cfg, toks: np.ndarray, rng):
    """The same prefill inputs for both packages."""
    ref = {"tokens": jnp.asarray(toks)}
    got = {"tokens": torch.from_numpy(toks.astype(np.int64))}
    b, s = toks.shape
    if cfg.family == "audio":
        frames = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)
                                     ).astype(np.float32)
        ref["encoder_frames"] = jnp.asarray(frames)
        got["encoder_frames"] = torch.from_numpy(frames)
    if cfg.family == "vlm":
        grid = _vlm_grid(b, s)
        ref["positions"] = jnp.asarray(grid.astype(np.int32))
        got["positions"] = torch.from_numpy(grid)
    return ref, got


# ------------------------------------------------------------ params

@pytest.mark.parametrize("arch", ARCHS)
def test_lm_params_from_numpy_shapes(arch):
    rcfg, tree, cfg, params = _weights(arch)
    want = tf.param_shapes(cfg)
    assert set(params) == set(want) == set(tree)
    for group in ("layers", "enc_layers"):
        if group not in want:
            assert cfg.family != "audio"
            continue
        assert set(params[group]) == set(want[group]) == set(tree[group])
        for key, shape in want[group].items():
            assert params[group][key].shape == shape \
                == tree[group][key].shape
            assert params[group][key].dtype == torch.float32
    if cfg.is_moe:
        assert want["layers"]["ew1"] == (cfg.n_layers, cfg.n_experts,
                                         cfg.d_model, cfg.d_ff_expert)
    if cfg.is_mla:
        assert want["layers"]["wdkv"] == (
            cfg.n_layers, cfg.d_model, cfg.kv_lora_rank + cfg.rope_head_dim)
    if cfg.family == "audio":
        assert want["enc_layers"]["wq"][0] == cfg.n_encoder_layers
        assert want["layers"]["xwq"] == want["layers"]["wq"]
        assert "enc_lnf_b" in params


# ---------------------------------------------------- prefill / decode

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    rcfg, tree, cfg, params = _weights(arch)
    rparams = _ref_params(tree)
    rng = np.random.default_rng(2)
    b, s, cache = 3, 21, 32
    toks = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    rbatch, batch = _batches(cfg, toks, rng)
    want_logits, want = _ref_prefill(rparams, rcfg, rbatch, RT, cache)
    got_logits, got = tf.prefill(params, cfg, batch, cache)
    assert set(got) == set(want)
    keys = {"deepseek-v2-lite-16b": {"lengths", "ckv", "krope"},
            "whisper-large-v3": {"lengths", "k", "v", "xk", "xv"}}
    assert set(got) == keys.get(arch, {"lengths", "k", "v"})
    assert _err(got_logits, want_logits) <= TOL
    for step in range(4):
        for key in sorted(got):
            assert got[key].shape == want[key].shape, (step, key)
            assert _err(got[key], want[key]) <= TOL, (step, key)
        feed = rng.integers(1, cfg.vocab_size, b).astype(np.int32)
        want_logits, want = _ref_decode(rparams, rcfg, want,
                                        jnp.asarray(feed), RT)
        got_logits, got = tf.decode_step(params, cfg, got,
                                         torch.from_numpy(feed))
        assert _err(got_logits, want_logits) <= TOL, step
    assert list(got["lengths"]) == [s + 4] * b


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_full_forward(arch):
    """prefill(S tokens) + decode(token S) equals prefill(S + 1 tokens)
    at the last position (the caches hold what the forward computes)."""
    _, _, cfg, params = _weights(arch)
    rng = np.random.default_rng(3)
    b, s, cache = 2, 16, 24
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    _, full_batch = _batches(cfg, toks, np.random.default_rng(4))
    _, head_batch = _batches(cfg, toks[:, :s], np.random.default_rng(4))
    if cfg.family == "vlm":                      # text-only grids
        del full_batch["positions"], head_batch["positions"]
    full, _ = tf.prefill(params, cfg, full_batch, cache)
    _, state = tf.prefill(params, cfg, head_batch, cache)
    dec, _ = tf.decode_step(params, cfg, state,
                            torch.from_numpy(toks[:, s]))
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_mla_decode_past_the_cache_raises_naming_the_slot():
    _, _, cfg, params = _weights("deepseek-v2-lite-16b")
    toks = torch.ones((2, 5), dtype=torch.int64)
    _, state = tf.prefill(params, cfg, {"tokens": toks}, cache_len=6)
    _, state = tf.decode_step(params, cfg, state, torch.ones(2))
    with pytest.raises(ValueError, match="slot 0"):
        tf.decode_step(params, cfg, state, torch.ones(2))


# ------------------------------------------------------------- M-RoPE

def test_apply_mrope_matches_reference_on_image_grids():
    rng = np.random.default_rng(6)
    b, s, h, d = 2, 11, 3, 16
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    grid = rng.integers(0, 40, (3, b, s))
    for sections in ((2, 3, 3), (4, 2, 2)):
        got = apply_mrope(torch.from_numpy(x), torch.from_numpy(grid),
                          sections, 1e6)
        want = ref_apply_mrope(jnp.asarray(x), jnp.asarray(grid), sections,
                               1e6)
        assert _err(got, want) <= TOL
    # text-only grids (three equal) are plain RoPE, exactly
    text = np.broadcast_to(grid[0], (3, b, s)).copy()
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(text),
                      (2, 3, 3), 1e6)
    assert torch.equal(got, apply_rope(torch.from_numpy(x),
                                       torch.from_numpy(grid[0]), 1e6))
    with pytest.raises(ValueError, match="sections"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(grid), (2, 2, 2))


# ------------------------------------------------------------- engine

PROMPTS = [list(np.random.default_rng(0).integers(1, 256, n))
           for n in (5, 16, 9, 4, 12, 7)]


def _serve(engine):
    refills = []
    orig = engine._prefill_slot

    def spy(slot, r):
        refills.append(slot)
        return orig(slot, r)

    engine._prefill_slot = spy
    for p in PROMPTS:
        engine.submit(p)
    done = engine.run_to_completion()
    return ({r.rid: (r.generated, r.truncated) for r in done}, refills,
            len(engine.queue))


@functools.lru_cache(maxsize=None)
def _engine_runs(arch: str, eos: int):
    rcfg, tree, cfg, params = _weights(arch)
    ecfg = dict(max_batch=4, cache_len=32, max_new_tokens=8,
                eos_token=eos)
    ref = _serve(RefEngine(rcfg, _ref_params(tree),
                           RefEngineConfig(**ecfg)))
    got = _serve(ServingEngine(cfg, params, EngineConfig(**ecfg)))
    return ref, got


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference_with_mid_batch_refill(arch):
    """An end token that request 0 emits second: it finishes early and
    its slot is refilled while the others run on."""
    (ref, _, _), _ = _engine_runs(arch, -1)
    ref, got = _engine_runs(arch, ref[0][0][1])
    assert got[1], "no mid-batch refill happened"
    assert got == ref
    tokens, _, queued = got
    assert sorted(tokens) == list(range(len(PROMPTS))) and queued == 0


def _leaves(state):
    return [state[k] for k in sorted(state)]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b",
                                  "whisper-large-v3"])
def test_scatter_slot_writes_the_new_leaves_at_their_slot(arch):
    _, _, cfg, params = _weights(arch)
    engine = ServingEngine(cfg, params, EngineConfig(max_batch=3,
                                                     cache_len=12))
    rng = np.random.default_rng(5)
    toks = rng.integers(1, cfg.vocab_size, (3, 10))
    _, batch = tf.prefill(params, cfg, engine._prefill_inputs(toks), 12)
    before = [t.clone() for t in _leaves(batch)]
    one = rng.integers(1, cfg.vocab_size, (1, 7))
    _, single = tf.prefill(params, cfg, engine._prefill_inputs(one), 12)
    out = _scatter_slot(batch, single, 1, 3)
    after = _leaves(out)
    assert all(a is b for a, b in zip(after, _leaves(batch)))  # in place
    for b0, a, s1 in zip(before, after, _leaves(single)):
        ax = [i for i, (m, n) in enumerate(zip(a.shape, s1.shape))
              if m != n][0]
        for slot in (0, 2):
            assert torch.equal(a.select(ax, slot), b0.select(ax, slot))
        assert torch.equal(a.select(ax, 1), s1.select(ax, 0))
    if cfg.family == "audio":
        frames = engine._prefill_inputs(toks)["encoder_frames"]
        assert frames.shape == (3, cfg.encoder_seq, cfg.d_model)
        assert not frames.any()


# ----------------------------------------------------------- launcher

@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_prints_the_reference_lines(arch, monkeypatch):
    argv = ["--arch", arch, "--reduced", "--requests", "5", "--max-new",
            "6"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = launch_serve.main(argv + ["--device", "cpu"])
    got = out.getvalue().splitlines()
    ref_out = io.StringIO()
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    with contextlib.redirect_stdout(ref_out):
        ref_launch.main()
    assert got == ref_out.getvalue().splitlines()
    assert got[0] == "[engine] served 5 requests, 30 tokens generated"
    assert [len(r.generated) for r in result["done"]] == [6] * 5


# ---------------------------------------------------- tied embeddings

def test_tied_embeddings_match_reference_and_ep_is_refused():
    """Tied embeddings (no config ties them) read the embedding's
    transpose, as the reference does; the expert-parallel MoE path
    without a mesh of ranks is the one setting the port refuses (every
    config initialises and prefills: ``tests/test_torch_lm.py`` and
    ``tests/test_torch_ssm.py``; on a mesh: ``tests/test_torch_ep.py``)."""
    rcfg = dataclasses.replace(ref_get_config("tinyllama-1.1b").reduced(),
                               tie_embeddings=True)
    rparams, _ = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, rparams)
    cfg = dataclasses.replace(get_config("tinyllama-1.1b").reduced(),
                              tie_embeddings=True)
    params = lm_params_from_numpy(tree, cfg, "cpu")
    assert "head" not in params
    toks = np.arange(1, 8, dtype=np.int32)[None]
    want, _ = _ref_prefill(_ref_params(tree), rcfg,
                           {"tokens": jnp.asarray(toks)}, RT, 8)
    got, _ = tf.prefill(params, cfg, {"tokens": torch.from_numpy(toks)}, 8)
    assert _err(got, want) <= TOL
    with pytest.raises(NotImplementedError, match="mesh"):
        tf.check_supported(dataclasses.replace(
            get_config("kimi-k2-1t-a32b").reduced(), moe_impl="ep"))
