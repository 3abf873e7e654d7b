"""The port's serving engine with retired slots, against the JAX
package's engine on the CPU.

A slot whose request has finished keeps advancing with the batch until
it is refilled, so its length can pass the cache.  The reference drops
that slot's out-of-range K/V write; the port's engine passes its live
slots to ``decode_step``, which skips the write of a slot outside them.
A live request that would need a cache row past ``cache_len`` raises
naming its slot (the reference drops that write too; the port refuses).

Weights: the reference's seeded ``init_params`` of reduced tinyllama-1.1b,
handed to the port as numpy.  Tolerance: engine tokens identical; logits
and cache leaves within 1e-5 absolute (float32, attention summed in
another order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models.transformer import Runtime
from repro.models.transformer import decode_step as ref_decode_step
from repro.models.transformer import init_params as ref_init_params
from repro.models.transformer import prefill as ref_prefill
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.transformer import decode_step, prefill
from repro_torch.serve import EngineConfig, ServingEngine

ARCH = "tinyllama-1.1b"
TOL = 1e-5
# ROADMAP's probe: three requests on two slots; token 55 is request 0's
# second token, so request 0 retires after 2 tokens and request 2 takes
# its slot while request 1 runs on to the end of its cache
PROBE = dict(max_batch=2, cache_len=18, max_new_tokens=6, eos_token=55)
PROBE_LENGTHS = (12, 12, 2)


@functools.lru_cache(maxsize=None)
def _weights():
    """(reference config, numpy tree, port config, port params)."""
    rcfg = ref_get_config(ARCH).reduced()
    params, _ = ref_init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    cfg = get_config(ARCH).reduced()
    return rcfg, tree, cfg, lm_params_from_numpy(tree, cfg, "cpu")


def _prompts(lengths):
    rng = np.random.default_rng(0)
    return [list(rng.integers(1, 200, n)) for n in lengths]


def _serve(engine, prompts):
    for p in prompts:
        engine.submit(p)
    return {r.rid: r.generated for r in engine.run_to_completion()}


def test_retired_slot_past_its_cache_serves_like_the_reference():
    rcfg, tree, cfg, params = _weights()
    prompts = _prompts(PROBE_LENGTHS)
    ref = _serve(RefEngine(rcfg, jax.tree.map(jnp.asarray, tree),
                           RefEngineConfig(**PROBE)), prompts)
    got = _serve(ServingEngine(cfg, params, EngineConfig(**PROBE)), prompts)
    assert [len(ref[rid]) for rid in range(3)] == [2, 6, 6]
    assert got == ref


def test_live_request_overrunning_its_cache_raises_naming_the_slot():
    """A 12-token prompt in a 14-row cache has room for 2 decode steps;
    the third would write row 14."""
    _, _, cfg, params = _weights()
    engine = ServingEngine(cfg, params, EngineConfig(
        max_batch=2, cache_len=14, max_new_tokens=6, eos_token=-1))
    engine.submit(_prompts((12,))[0])
    engine.step()
    engine.step()
    with pytest.raises(ValueError, match="slot 0"):
        engine.step()


def test_decode_step_skips_the_write_of_a_slot_outside_live():
    """Slot 1 sits at the end of its cache and is not live: no raise, its
    cache rows stay as they were, and slot 0's logits and cache match
    the reference, which drops slot 1's write."""
    rcfg, tree, cfg, params = _weights()
    toks = np.asarray(_prompts((5, 5)), np.int64)
    cache_len = 6
    _, state = prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                       cache_len)
    _, rstate = ref_prefill(jax.tree.map(jnp.asarray, tree), rcfg,
                            {"tokens": jnp.asarray(toks)}, Runtime(),
                            cache_len)
    lengths = np.array([5, cache_len], np.int32)
    state["lengths"] = torch.from_numpy(lengths)
    rstate = dict(rstate, lengths=jnp.asarray(lengths))
    before = state["k"][:, 1].clone(), state["v"][:, 1].clone()
    feed = np.array([7, 9], np.int64)
    logits, state = decode_step(params, cfg, state, torch.from_numpy(feed),
                                live=[True, False])
    rlogits, rstate = ref_decode_step(jax.tree.map(jnp.asarray, tree), rcfg,
                                      rstate, jnp.asarray(feed), Runtime())
    assert torch.equal(state["k"][:, 1], before[0])
    assert torch.equal(state["v"][:, 1], before[1])
    np.testing.assert_allclose(logits[0].numpy(), np.asarray(rlogits)[0],
                               atol=TOL, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(state[key].numpy(),
                                   np.asarray(rstate[key]), atol=TOL, rtol=0)
    assert state["lengths"].tolist() == [6, cache_len + 1]
