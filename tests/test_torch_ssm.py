"""The port's recurrent mixers and its hybrid (hymba) and ssm (xLSTM)
families on the CPU, against the JAX package: ``gated_linear_scan``,
``gls_decode_step`` and ``slstm_scan``; the mLSTM, sLSTM and hybrid
blocks on the same inputs; reduced hymba-1.5b and xlstm-350m through
``prefill`` and 4 decode steps; the engine with a mid-batch refill;
the windowed prefill attention's plain version against
``flash_attention_jnp``; ``lm_params_from_numpy`` on mixed layers; and
the launcher's lines.

Both packages compute with the same weights: the reference's
``init_params`` tree, its norm gains (and hymba's ``ma_log`` and
``mdt_bias``) perturbed with numpy so that every parameter matters.
The reduced configs are float32.  Tolerances: the mixers, each block
on the same inputs, windowed attention and reduced hymba end to end
within 1e-5 (relative to the largest reference value where that
exceeds 1: the unnormalized scan returns values near 10); reduced xlstm end to end within 1e-4 × max
|logits|: each of its blocks holds 1e-5 on the same inputs (the block
tests here), but float32 summation-order noise grows through the
normalized mLSTM readouts and the sLSTM recurrence to ~2e-5 relative
over three layers and five steps.  Engine tokens identical per
request.
"""

import contextlib
import dataclasses
import functools
import importlib.util
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.launch import serve as ref_launch
from repro.models import ssm as ref_ssm
from repro.models import transformer as ref_tf
from repro.models.layers import flash_attention_jnp
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.ops import attention_bshd
from repro_torch.launch import serve as launch_serve
from repro_torch.models import ssm
from repro_torch.models import transformer as tf
from repro_torch.serve import EngineConfig, ServingEngine
from repro_torch.serve.engine import _scatter_slot

ROOT = pathlib.Path(__file__).resolve().parent.parent
RT = ref_tf.Runtime()
TOL = 1e-5
SSM_REL = 1e-4
#: reduced configs: hymba's window is 8; xlstm with an sLSTM every
#: second layer (the reduced default of 3 layers has none)
ARCHS = {"hymba-1.5b": {}, "xlstm-350m": {"slstm_every": 2}}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_tiled", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def _err(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got.float().numpy()
                                          if isinstance(got, torch.Tensor)
                                          else got)
                               - np.asarray(want, np.float32))))


def _close(got, want, tol=TOL) -> bool:
    """Within ``tol`` of the reference, relative to its largest value
    where that exceeds 1."""
    return _err(got, want) <= tol * max(
        1.0, float(np.abs(np.asarray(want, np.float32)).max()))


# ------------------------------------------------------------- mixers

def _gls_inputs(seed, b=2, s=37, hd=3, dk=8, dv=6):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hd, dk)).astype(np.float32)
    k = rng.standard_normal((b, s, hd, dk)).astype(np.float32)
    v = rng.standard_normal((b, s, hd, dv)).astype(np.float32)
    log_a = -np.abs(rng.standard_normal((b, s, hd))).astype(np.float32)
    log_i = rng.standard_normal((b, s, hd)).astype(np.float32)
    return q, k, v, log_a, log_i


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_gated_linear_scan_matches_reference(normalized, chunk):
    """37 steps: a ragged last chunk at 8 and 16, one chunk at 64; the
    final state carries into a second scan as ``initial``."""
    args = _gls_inputs(0)
    want_y, want_st = ref_ssm.gated_linear_scan(
        *map(jnp.asarray, args), chunk=chunk, normalized=normalized)
    got_y, got_st = ssm.gated_linear_scan(*map(_t, args), chunk=chunk,
                                          normalized=normalized)
    assert got_y.shape == want_y.shape and got_y.dtype == torch.float32
    assert _close(got_y, want_y)
    for g, w in zip(got_st, want_st):
        assert _close(g, w)
    more = _gls_inputs(1, s=11)
    want_y2, _ = ref_ssm.gated_linear_scan(
        *map(jnp.asarray, more), chunk=chunk, normalized=normalized,
        initial=want_st)
    got_y2, _ = ssm.gated_linear_scan(*map(_t, more), chunk=chunk,
                                      normalized=normalized,
                                      initial=got_st)
    assert _close(got_y2, want_y2)


@pytest.mark.parametrize("normalized", [False, True])
def test_gls_decode_step_matches_reference(normalized):
    q, k, v, log_a, log_i = _gls_inputs(2)
    state = ref_ssm.init_gls_state(2, 3, 8, 6)
    got_state = ssm.init_gls_state(2, 3, 8, 6)
    for t in range(6):
        step = [x[:, t] for x in (q, k, v, log_a, log_i)]
        want_y, state = ref_ssm.gls_decode_step(
            state, *map(jnp.asarray, step), normalized=normalized)
        got_y, got_state = ssm.gls_decode_step(
            got_state, *map(_t, step), normalized=normalized)
        assert _close(got_y, want_y), t
    for g, w in zip(got_state, state):
        assert _close(g, w)


def test_slstm_scan_matches_reference():
    rng = np.random.default_rng(3)
    b, s, d, h = 2, 9, 16, 4
    gates = rng.standard_normal((b, s, 4, d)).astype(np.float32)
    r = (0.3 * rng.standard_normal((4, h, d // h, d // h))).astype(np.float32)
    want_y, want_st = ref_ssm.slstm_scan(jnp.asarray(gates), jnp.asarray(r),
                                         n_heads=h)
    got_y, got_st = ssm.slstm_scan(_t(gates), _t(r), n_heads=h)
    assert _close(got_y, want_y)
    for g, w in zip(got_st, want_st):
        assert _close(g, w)
    # the state carries on, as a decode step feeds it back
    more = rng.standard_normal((b, 1, 4, d)).astype(np.float32)
    want_y2, _ = ref_ssm.slstm_scan(jnp.asarray(more), jnp.asarray(r),
                                    n_heads=h, initial=want_st)
    got_y2, _ = ssm.slstm_scan(_t(more), _t(r), n_heads=h, initial=got_st)
    assert _close(got_y2, want_y2)
    fresh = ssm.init_slstm_state(2, 4)
    assert len({t.data_ptr() for t in fresh}) == 4     # no shared leaves


# ------------------------------------------------------------ weights

@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    """(reference config, numpy tree, port config, port params)."""
    kw = ARCHS[arch]
    rcfg = ref_get_config(arch).reduced(**kw)
    params, _ = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(1)

    def perturb(layer):
        for key, arr in layer.items():
            if key.endswith("_g"):
                layer[key] = (1 + 0.1 * rng.standard_normal(arr.shape)
                              ).astype(np.float32)
            elif key in ("ma_log", "mdt_bias"):
                layer[key] = (0.3 * rng.standard_normal(arr.shape)
                              ).astype(np.float32)

    layers = tree["layers"]
    for layer in (layers if isinstance(layers, list) else [layers]):
        perturb(layer)
    tree["lnf_g"] = (1 + 0.1 * rng.standard_normal(tree["lnf_g"].shape)
                     ).astype(np.float32)
    cfg = get_config(arch).reduced(**kw)
    return rcfg, tree, cfg, lm_params_from_numpy(tree, cfg, "cpu")


def _ref_params(tree):
    return jax.tree.map(jnp.asarray, tree)


_ref_prefill = jax.jit(ref_tf.prefill, static_argnums=(1, 3, 4))
_ref_decode = jax.jit(ref_tf.decode_step, static_argnums=(1, 4))


def test_lm_params_from_numpy_takes_mixed_layers():
    rcfg, tree, cfg, params = _weights("xlstm-350m")
    kinds = [tf._is_slstm(cfg, i) for i in range(cfg.n_layers)]
    assert kinds == [False, True, False]
    shapes = tf.param_shapes(cfg)
    assert isinstance(params["layers"], list)
    for i, layer in enumerate(params["layers"]):
        assert set(layer) == set(tree["layers"][i]) == set(shapes["layers"][i])
        assert ("r_gates" in layer) == kinds[i]
        for key, t in layer.items():
            assert tuple(t.shape) == tuple(shapes["layers"][i][key])
            assert np.array_equal(t.numpy(), tree["layers"][i][key])
    # the port's own draws have the same layout, and convert back
    mine = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    back = lm_params_from_numpy(
        jax.tree.map(lambda t: t.numpy(), mine,
                     is_leaf=lambda x: isinstance(x, torch.Tensor)),
        cfg, "cpu")
    for a, b in zip(mine["layers"], back["layers"]):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="list of 3 layers"):
        lm_params_from_numpy(dict(tree, layers=tree["layers"][:2]), cfg,
                             "cpu")
    with pytest.raises(ValueError, match="names"):
        swapped = [tree["layers"][1], tree["layers"][0], tree["layers"][2]]
        lm_params_from_numpy(dict(tree, layers=swapped), cfg, "cpu")
    # hymba's tree is stacked, with the mamba leaves
    _, htree, hcfg, hparams = _weights("hymba-1.5b")
    assert hparams["layers"]["mB"].shape == htree["layers"]["mB"].shape
    assert {"anorm_g", "mnorm_g", "ma_log"} <= set(hparams["layers"])


# ------------------------------------------------------------- blocks

@pytest.mark.parametrize("kind", ["mlstm", "slstm", "hybrid"])
def test_blocks_match_reference_on_the_same_inputs(kind):
    arch = "hymba-1.5b" if kind == "hybrid" else "xlstm-350m"
    rcfg, tree, cfg, params = _weights(arch)
    rng = np.random.default_rng(4)
    b, s = 2, 13
    x = (0.5 * rng.standard_normal((b, s, cfg.d_model))).astype(np.float32)
    if kind == "hybrid":
        lp = {k: v[0] for k, v in tree["layers"].items()}
        pos = np.broadcast_to(np.arange(s), (b, s))
        want, wx = ref_tf.decoder_block(_ref_params(lp), rcfg,
                                        jnp.asarray(x), jnp.asarray(pos),
                                        RT, return_kv=True)
        got, gx = tf.decoder_block(tf.layer_params(params, 0), cfg, _t(x),
                                   torch.from_numpy(pos.copy()),
                                   return_kv=True)
        assert _err(got, want) <= TOL
        for g, w in zip(gx["kv"], wx["kv"]):
            assert _err(g, w) <= TOL
        for g, w in zip(gx["mamba_state"], wx["mamba_state"]):
            assert _err(g, w) <= TOL * max(1.0, float(np.abs(w).max()))
        return
    i = 1 if kind == "slstm" else 0
    ref_block = ref_tf.slstm_block if kind == "slstm" else ref_tf.mlstm_block
    block = tf.slstm_block if kind == "slstm" else tf.mlstm_block
    rp = _ref_params(tree["layers"][i])
    want, wst = ref_block(rp, rcfg, jnp.asarray(x), RT)
    got, gst = block(params["layers"][i], cfg, _t(x))
    assert _err(got, want) <= TOL
    x1 = (0.5 * rng.standard_normal((b, 1, cfg.d_model))).astype(np.float32)
    want, _ = ref_block(rp, rcfg, jnp.asarray(x1), RT, state=wst,
                        decode=True)
    st = type(gst)(*map(_t, wst))
    got, _ = block(params["layers"][i], cfg, _t(x1), state=st, decode=True)
    assert _err(got, want) <= TOL


# --------------------------------------------------- prefill / decode

def _leaves(state: dict) -> list:
    """The state's tensors in the reference's tree order."""
    out = []
    for key in sorted(state):
        val = state[key]
        if isinstance(val, list):
            for st in val:
                out.extend(st)
        elif isinstance(val, tuple):
            out.extend(val)
        else:
            out.append(val)
    return out


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_match_reference(arch):
    """A 13-token prompt (the reduced window is 8, so the window cuts
    prefill attention and the ring has wrapped) and 4 decode steps."""
    rcfg, tree, cfg, params = _weights(arch)
    rparams = _ref_params(tree)
    rng = np.random.default_rng(2)
    b, s, cache = 3, 13, 16
    toks = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    want_logits, want = _ref_prefill(rparams, rcfg,
                                     {"tokens": jnp.asarray(toks)}, RT,
                                     cache)
    got_logits, got = tf.prefill(params, cfg,
                                 {"tokens": torch.from_numpy(toks)}, cache)
    assert set(got) == set(want)
    if arch == "hymba-1.5b":
        assert got["k"].shape == (cfg.n_layers, b, cfg.window,
                                  cfg.n_kv_heads, cfg.hd)
        assert isinstance(got["mamba"], ssm.GlsState)
        tol = TOL
    else:
        assert [type(st) for st in got["layers"]] == [
            ssm.GlsState, ssm.SlstmState, ssm.GlsState]
        tol = SSM_REL * float(np.abs(np.asarray(want_logits)).max())
    assert _err(got_logits, want_logits) <= tol
    for step in range(4):
        wl, gl = jax.tree.leaves(want), _leaves(got)
        assert len(wl) == len(gl)
        for g, w in zip(gl, wl):
            assert g.shape == w.shape, step
            scale = max(1.0, float(np.abs(np.asarray(w, np.float32)).max()))
            assert _err(g, w) <= (tol if arch == "hymba-1.5b"
                                  else SSM_REL) * scale, step
        feed = rng.integers(1, cfg.vocab_size, b).astype(np.int32)
        want_logits, want = _ref_decode(rparams, rcfg, want,
                                        jnp.asarray(feed), RT)
        got_logits, got = tf.decode_step(params, cfg, got,
                                         torch.from_numpy(feed))
        if arch != "hymba-1.5b":
            tol = SSM_REL * float(np.abs(np.asarray(want_logits)).max())
        assert _err(got_logits, want_logits) <= tol, step
    assert list(got["lengths"]) == [s + 4] * b


def test_hybrid_and_ssm_never_fill_a_cache():
    """Deliberate difference of the dense family only: a hybrid ring
    wraps and an ssm state has no rows, so a prompt longer than
    ``cache_len`` and decoding past it both run."""
    for arch in ARCHS:
        _, _, cfg, params = _weights(arch)
        toks = torch.ones((2, 6), dtype=torch.int64)
        _, state = tf.prefill(params, cfg, {"tokens": toks}, cache_len=4)
        for _ in range(3):
            _, state = tf.decode_step(params, cfg, state, torch.ones(2))
        assert list(state["lengths"]) == [9, 9]


def test_families_still_to_port_are_refused():
    """No family is left to port: all ten configs of ``configs/``
    initialise and prefill, hymba with tied embeddings too (the
    embedding's transpose is its head); only ``moe_impl="ep"`` without
    a mesh of ranks to shard the experts over is refused."""
    from repro_torch.configs import ARCH_IDS

    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        params = tf.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        batch = {"tokens": torch.full((1, 9), 3, dtype=torch.int64)}
        if cfg.family == "audio":
            batch["encoder_frames"] = torch.ones(
                (1, cfg.encoder_seq, cfg.d_model))
        logits, _ = tf.prefill(params, cfg, batch, 12)
        assert bool(torch.isfinite(logits).all()), arch
    tied = dataclasses.replace(get_config("hymba-1.5b").reduced(),
                               tie_embeddings=True)
    tf.check_supported(tied)
    params = tf.init_params(tied, torch.Generator().manual_seed(1), "cpu")
    assert "head" not in params
    logits, _ = tf.prefill(params, tied, {"tokens": torch.ones(
        (1, 9), dtype=torch.int64)}, 12)
    assert logits.shape == (1, tied.padded_vocab)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.check_supported(dataclasses.replace(
            get_config("kimi-k2-1t-a32b").reduced(), moe_impl="ep"))


# ------------------------------------------------------------- engine

PROMPTS = [list(np.random.default_rng(0).integers(1, 256, n))
           for n in (5, 16, 9, 4, 12, 7)]


def _serve(engine, max_steps=10_000):
    refills = []
    orig = engine._prefill_slot

    def spy(slot, r):
        refills.append(slot)
        return orig(slot, r)

    engine._prefill_slot = spy
    for p in PROMPTS:
        engine.submit(p)
    done = engine.run_to_completion(max_steps)
    return ({r.rid: (r.generated, r.truncated) for r in done}, refills,
            len(engine.queue))


@functools.lru_cache(maxsize=None)
def _engine_runs(arch: str, eos: int):
    rcfg, tree, cfg, params = _weights(arch)
    ecfg = dict(max_batch=4, cache_len=12, max_new_tokens=8,
                eos_token=eos)
    ref = _serve(RefEngine(rcfg, _ref_params(tree),
                           RefEngineConfig(**ecfg)))
    got = _serve(ServingEngine(cfg, params, EngineConfig(**ecfg)))
    return ref, got


@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_matches_reference_with_mid_batch_refill(arch):
    """An end token that request 0 emits second: it finishes early and
    its slot is refilled (a 9-token prompt, past the window of 8 and the
    cache_len of 12 with its new tokens) while the others run on."""
    (ref, _, _), _ = _engine_runs(arch, -1)
    eos = ref[0][0][1]
    ref, got = _engine_runs(arch, eos)
    assert got[1], "no mid-batch refill happened"
    assert got == ref
    tokens, _, queued = got
    assert sorted(tokens) == list(range(len(PROMPTS))) and queued == 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_scatter_slot_writes_only_its_slot(arch):
    _, _, cfg, params = _weights(arch)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(1, cfg.vocab_size, (3, 10)))
    _, batch = tf.prefill(params, cfg, {"tokens": toks}, 12)
    before = [t.clone() for t in _leaves(batch)]
    one = torch.from_numpy(rng.integers(1, cfg.vocab_size, (1, 7)))
    _, single = tf.prefill(params, cfg, {"tokens": one}, 12)
    out = _scatter_slot(batch, single, 1, 3)
    after = _leaves(out)
    assert all(a is b for a, b in zip(after, _leaves(batch)))  # in place
    for b0, a, s1 in zip(before, after, _leaves(single)):
        ax = [i for i, (m, n) in enumerate(zip(a.shape, s1.shape))
              if m != n][0]
        for slot in (0, 2):
            assert torch.equal(a.select(ax, slot), b0.select(ax, slot))
        assert torch.equal(a.select(ax, 1), s1.select(ax, 0))
    # a batch of one is replaced by the single state, leaf for leaf
    _, other = tf.prefill(params, cfg, {"tokens": one + 1}, 12)
    whole = _scatter_slot(single, other, 0, 1)
    assert all(a is b for a, b in zip(_leaves(whole), _leaves(other)))


# ---------------------------------------------------- windowed attention

@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,window", [
    (2, 4, 2, 37, 37, 16, True, 8),
    (1, 10, 2, 40, 40, 32, True, 1),       # group 5, the row alone
    (1, 10, 2, 40, 40, 32, True, 64),      # window >= Sk: plain causal
    (2, 5, 1, 25, 70, 16, True, 13),       # q_offset 45
    (1, 4, 4, 33, 33, 16, False, 7),       # no causal mask, window only
])
def test_windowed_plain_attention_matches_flash_attention_jnp(
        b, h, kh, sq, sk, d, causal, window):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, kh, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, kh, d)).astype(np.float32)
    q_offset = sk - sq
    want = flash_attention_jnp(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal,
                               q_offset=q_offset, window=window)
    got = flash_attention_plain(
        _t(q).transpose(1, 2), _t(k).transpose(1, 2), _t(v).transpose(1, 2),
        causal=causal, q_offset=q_offset, window=window).transpose(1, 2)
    assert _err(got, want) <= TOL
    if causal:
        assert _err(attention_bshd(_t(q), _t(k), _t(v), window=window),
                    want) <= TOL
    if window >= sk:
        plain = flash_attention_plain(
            _t(q).transpose(1, 2), _t(k).transpose(1, 2),
            _t(v).transpose(1, 2), causal=causal, q_offset=q_offset)
        assert torch.equal(got.transpose(1, 2), plain)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal,window", [
    (2, 10, 2, 200, 200, 64, True, 77),
    (1, 4, 4, 130, 300, 32, True, 0),
    (1, 4, 2, 100, 100, 16, False, 0),
])
def test_tiled_plain_attention_is_flash_attention_jnp_on_64_key_chunks(
        dtype, b, h, kh, sq, sk, d, causal, window):
    """The kernels' algorithm in plain PyTorch (``chip_smoke.py``'s
    ``tiled_plain_attention``, the floor of its parity runs) rounds p
    where the reference's chunked attention does at a KV chunk of 64:
    float32 within 1e-5, bf16 within 2^-8 (an ulp of an output in
    [1, 2))."""
    from repro.models.layers import AttnChunks
    tiled_plain_attention = _chip_smoke().tiled_plain_attention

    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d))]
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    q_offset = sk - sq if causal else 0
    got = tiled_plain_attention(
        *(torch.from_numpy(a).to(tdt).transpose(1, 2) for a in arrs),
        causal=causal, q_offset=q_offset, window=window).transpose(1, 2)
    want = flash_attention_jnp(*(jnp.asarray(a).astype(jdt) for a in arrs),
                               causal=causal, q_offset=q_offset,
                               window=window, chunks=AttnChunks(64, 64))
    assert got.dtype == tdt
    assert _err(got, np.asarray(want.astype(jnp.float32))) <= (
        TOL if dtype == "float32" else 2.0 ** -8)


def test_windowed_attention_refuses_a_negative_window():
    from repro_torch.kernels.flash_attention import flash_attention
    x = torch.zeros((1, 2, 4, 16))
    with pytest.raises(ValueError, match="window"):
        flash_attention(x, x, x, window=-1)


# ----------------------------------------------------------- launcher

@pytest.mark.parametrize("arch", list(ARCHS))
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
