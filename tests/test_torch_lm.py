"""The port's LM serving slice on the CPU, against the JAX package:
parameters carried across with ``lm_params_from_numpy``, ``prefill`` and
``decode_step`` of the dense transformer, the continuous-batching
``ServingEngine``, the ``repro_torch.launch.serve`` entry point and the
back-compat ``compile_power_schedule``.

Both packages compute with the same weights: the reference's
``init_params`` tree, its norm gains and QKV biases perturbed with numpy
so that every parameter matters, handed to the port as numpy.
Tolerance: logits and every ``k``/``v``/``lengths`` leaf within 1e-5
absolute in float32 (the reduced configs are float32; attention sums in
another order); engine tokens identical per request.
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
from repro.core import OrchestratorConfig as RefConfig
from repro.core import compile_power_schedule as ref_compile_schedule
from repro.models.edge_cnn import edge_network as ref_network
from repro.models.transformer import Runtime
from repro.models.transformer import decode_step as ref_decode_step
from repro.models.transformer import init_params as ref_init_params
from repro.models.transformer import prefill as ref_prefill
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core import OrchestratorConfig, compile_power_schedule
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer as tf
from repro_torch.models.edge_cnn import edge_network
from repro_torch.models.transformer import (
    decode_step,
    init_params,
    param_shapes,
    prefill,
)
from repro_torch.serve import EngineConfig, ServingEngine

ARCHS = ["tinyllama-1.1b", "qwen2-7b"]      # qwen2: QKV bias
RT = Runtime()
TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _weights(arch: str):
    """(reference config, numpy tree, port config, port params)."""
    rcfg = ref_get_config(arch).reduced()
    params, _ = ref_init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(1)
    for key, arr in tree["layers"].items():
        if key.endswith("_g"):
            tree["layers"][key] = (1 + 0.1 * rng.standard_normal(arr.shape)
                                   ).astype(np.float32)
        elif key in ("bq", "bk", "bv"):
            tree["layers"][key] = (0.1 * rng.standard_normal(arr.shape)
                                   ).astype(np.float32)
    tree["lnf_g"] = (1 + 0.1 * rng.standard_normal(tree["lnf_g"].shape)
                     ).astype(np.float32)
    cfg = get_config(arch).reduced()
    return rcfg, tree, cfg, lm_params_from_numpy(tree, cfg, "cpu")


def _ref_params(tree):
    return jax.tree.map(jnp.asarray, tree)


_ref_prefill = jax.jit(ref_prefill, static_argnums=(1, 3, 4))
_ref_decode = jax.jit(ref_decode_step, static_argnums=(1, 4))


def _close(got: torch.Tensor, want) -> float:
    return float(np.max(np.abs(got.float().numpy()
                               - np.asarray(want, np.float32))))


# ------------------------------------------------------------ params

def test_lm_params_from_numpy_shapes_and_dtypes():
    rcfg, tree, cfg, params = _weights("qwen2-7b")
    want = param_shapes(cfg)
    assert set(params) == set(want) == set(tree)
    assert set(params["layers"]) == set(want["layers"])
    for key, shape in want["layers"].items():
        t = params["layers"][key]
        assert t.shape == shape == tree["layers"][key].shape
        assert t.dtype == torch.float32 and t.is_contiguous()
    assert params["embed"].shape == (cfg.padded_vocab, cfg.d_model)
    # the model dtype is taken on conversion; bf16 rounding is exact
    bf = lm_params_from_numpy(tree, dataclasses.replace(
        cfg, dtype="bfloat16"), "cpu")
    assert bf["head"].dtype == torch.bfloat16
    assert torch.equal(bf["head"], params["head"].to(torch.bfloat16))
    # the reference's unscanned layout (a list of layers) is stacked
    per_layer = [{k: v[i] for k, v in tree["layers"].items()}
                 for i in range(cfg.n_layers)]
    listed = lm_params_from_numpy(dict(tree, layers=per_layer), cfg, "cpu")
    assert torch.equal(listed["layers"]["wq"], params["layers"]["wq"])
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_numpy(dict(tree, embed=tree["embed"][:-1]), cfg,
                             "cpu")
    with pytest.raises(ValueError, match="names"):
        lm_params_from_numpy({k: v for k, v in tree.items()
                              if k != "head"}, cfg, "cpu")


def test_init_params_shapes_and_seeded_draws():
    cfg = get_config("tinyllama-1.1b").reduced()
    a = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    b = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    bf = init_params(dataclasses.replace(cfg, dtype="bfloat16"),
                     torch.Generator().manual_seed(0), "cpu")
    shapes = param_shapes(cfg)
    assert a["embed"].shape == shapes["embed"]
    assert {k: v.shape for k, v in a["layers"].items()} == shapes["layers"]
    assert torch.equal(a["layers"]["w2"], b["layers"]["w2"])
    # one seed, one set of draws: bf16 weights are the f32 ones rounded
    assert torch.equal(bf["layers"]["w2"],
                       a["layers"]["w2"].to(torch.bfloat16))
    assert torch.all(a["layers"]["ln1_g"] == 1)


def test_families_other_than_dense_are_still_to_port():
    """None is left: every config of ``configs/`` (dense, moe with and
    without MLA, vlm, audio, hybrid, ssm) initialises and prefills on the
    CPU; the expert-parallel MoE path initialises as the reference's does
    and runs on a mesh alone (``tests/test_torch_families.py`` holds the
    new families against the reference, ``tests/test_torch_ep.py`` the
    expert-parallel path)."""
    families = set()
    for arch in ARCH_IDS:
        cfg = get_config(arch).reduced()
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        batch = {"tokens": torch.ones((2, 4), dtype=torch.int64)}
        if cfg.family == "audio":
            batch["encoder_frames"] = torch.zeros(
                (2, cfg.encoder_seq, cfg.d_model))
        logits, state = prefill(params, cfg, batch, 6)
        assert logits.shape == (2, cfg.padded_vocab), arch
        assert list(state["lengths"]) == [4, 4]
        families.add(cfg.family)
    assert families == {"dense", "moe", "vlm", "audio", "hybrid", "ssm"}
    ep = dataclasses.replace(get_config("deepseek-v2-lite-16b").reduced(),
                             moe_impl="ep")
    params = init_params(ep, torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.ones((2, 4), dtype=torch.int64)}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        prefill(params, ep, batch, 6)
    logits, _ = prefill(params, ep, batch, 6,
                        rt=tf.Runtime(make_host_mesh("cpu")))
    assert bool(torch.isfinite(logits).all())


# ---------------------------------------------------- prefill / decode

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch):
    rcfg, tree, cfg, params = _weights(arch)
    rparams = _ref_params(tree)
    rng = np.random.default_rng(2)
    b, s, cache = 3, 21, 32                 # S spans two 16-key chunks
    toks = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    want_logits, want = _ref_prefill(rparams, rcfg,
                                     {"tokens": jnp.asarray(toks)}, RT,
                                     cache)
    got_logits, got = prefill(params, cfg,
                              {"tokens": torch.from_numpy(toks)}, cache)
    assert list(got) == ["lengths", "k", "v"] and set(want) == set(got)
    assert got["k"].shape == want["k"].shape == (cfg.n_layers, b, cache,
                                                 cfg.n_kv_heads, cfg.hd)
    assert _close(got_logits, want_logits) <= TOL
    for step in range(4):
        for key in ("k", "v"):
            assert _close(got[key], want[key]) <= TOL, (step, key)
        assert np.array_equal(got["lengths"].numpy(),
                              np.asarray(want["lengths"]))
        feed = rng.integers(1, cfg.vocab_size, b).astype(np.int32)
        want_logits, want = _ref_decode(rparams, rcfg, want,
                                        jnp.asarray(feed), RT)
        got_logits, got = decode_step(params, cfg, got,
                                      torch.from_numpy(feed))
        assert _close(got_logits, want_logits) <= TOL, step
    for key in ("k", "v"):
        assert _close(got[key], want[key]) <= TOL, key
    assert got["lengths"].dtype == torch.int32
    assert list(got["lengths"]) == [s + 4] * b


def test_decode_past_the_cache_raises_naming_the_slot():
    """Deliberate difference: JAX drops an out-of-range cache write
    silently, the port refuses it."""
    _, _, cfg, params = _weights("tinyllama-1.1b")
    toks = torch.ones((2, 5), dtype=torch.int64)
    _, state = prefill(params, cfg, {"tokens": toks}, cache_len=6)
    _, state = decode_step(params, cfg, state, torch.ones(2))
    with pytest.raises(ValueError, match="slot 0"):
        decode_step(params, cfg, state, torch.ones(2))
    with pytest.raises(ValueError, match="do not fit"):
        prefill(params, cfg, {"tokens": toks}, cache_len=4)


# ------------------------------------------------------------- engine

PROMPTS = [list(np.random.default_rng(0).integers(1, 256, n))
           for n in (5, 16, 9, 4, 12, 7)]


def _serve(engine, max_steps=10_000):
    """Run ``engine`` over PROMPTS; per rid (tokens, truncated), the
    number of mid-batch slot refills and the requests left queued."""
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
def _engine_runs(eos: int, max_steps: int):
    rcfg, tree, cfg, params = _weights("tinyllama-1.1b")
    ecfg = dict(max_batch=4, cache_len=64, max_new_tokens=8,
                eos_token=eos)
    ref = _serve(RefEngine(rcfg, _ref_params(tree),
                           RefEngineConfig(**ecfg)), max_steps)
    got = _serve(ServingEngine(cfg, params, EngineConfig(**ecfg)),
                 max_steps)
    return ref, got


def _refill_eos() -> int:
    """An end token that request 0 emits second: it finishes early and
    its slot is refilled while the others run on."""
    (ref, _, _), _ = _engine_runs(-1, 10_000)
    return ref[0][0][1]


def test_engine_matches_reference_with_mid_batch_refill():
    ref, got = _engine_runs(_refill_eos(), 10_000)
    assert got[1], "no mid-batch refill happened"
    assert got == ref
    tokens, refills, queued = got
    assert sorted(tokens) == list(range(len(PROMPTS))) and queued == 0
    assert not any(trunc for _, trunc in tokens.values())


def test_engine_truncation_matches_reference():
    ref, got = _engine_runs(_refill_eos(), 3)
    assert got == ref
    tokens, _, queued = got
    assert any(trunc for _, trunc in tokens.values())
    assert all(len(gen) < 8 for gen, trunc in tokens.values() if trunc)
    assert queued == len(PROMPTS) - len(tokens)


# ------------------------------------------------- launcher / schedule

def test_launcher_prints_the_reference_lines():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = launch_serve.main(
            ["--arch", "tinyllama-1.1b", "--reduced", "--device", "cpu",
             "--requests", "5", "--max-new", "6"])
    lines = out.getvalue().splitlines()
    assert lines[0] == "[engine] served 5 requests, 30 tokens generated"
    assert lines[1].startswith("[power] PowerSchedule[pfdnn] squeezenet1.1")
    assert lines[2].startswith("[power] 10 intervals: avg ")
    assert lines[2].endswith("misses=0") and len(lines) == 3
    assert [len(r.generated) for r in result["done"]] == [6] * 5
    assert result["replay"]["deadline_misses"] == 0


def test_launcher_on_cuda_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", "tinyllama-1.1b", "--reduced"])


@pytest.mark.parametrize("rate", [30.0, 1e6])
def test_compile_power_schedule_matches_reference(rate):
    net = "squeezenet1.1"
    got = compile_power_schedule(edge_network(net), rate,
                                 cfg=OrchestratorConfig(device="cpu"),
                                 network=net)
    want = ref_compile_schedule(ref_network(net), rate,
                                cfg=RefConfig(backend="numpy"), network=net)
    if rate == 1e6:
        assert got is None and want is None
        return
    assert got.summary() == want.summary()
    assert (got.e_total, got.t_infer, got.rails, got.layer_voltages) == \
        (want.e_total, want.t_infer, want.rails, want.layer_voltages)
