"""Tensor parallelism of xLSTM's mLSTM and sLSTM mixers over "model" on
gloo ranks of the CPU (``repro_torch.launch.mesh.run_world``, one world
of 4 ranks): reduced xlstm with an sLSTM block every second layer, its
4 heads on the (1,4) and (2,2) meshes (one or two heads a rank), and
with 2 heads on (1,4) (each head held by a group of two ranks, a
``Part``, as xlstm-350m's 4 heads are on a "model" axis of 16).

Held against the reference's single-device functions (logits of a
prefill and ``STEPS`` decode steps within ``SSM_REL`` x max |logits|,
``tests/test_torch_ssm.py``'s) and against the port in one process
(logits within ``TOL`` x max |logits|, the loss within ``TOL``
relative, each leaf's reduced and gathered gradient within
``GRAD_TOL`` x its max |g|); the mixer leaves' blocks on the abstract
pod16x16 mesh (``Part("model", 4)`` groups; ``w_gates``' block the four
gate kinds of the rank's head); and the dry-run counter's collectives
and held bytes against every rank's on (2,2) for a train, a prefill
and a decode step, exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as ref_tf
from repro_torch import configs
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import lm_params_from_numpy, shard_lm_params
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (
    CardMesh,
    Part,
    Placement,
    Strided,
    run_world,
)
from repro_torch.models import transformer as tf

ARCH = "xlstm-350m"
MESHES = ((1, 4), (2, 2))
#: the reduced configs: 4 heads (even blocks on both meshes) and 2 (on
#: (1,4) each head held by two ranks); an sLSTM block every second layer
VARIANTS = {"h4": {"slstm_every": 2, "n_layers": 4},
            "h2": {"slstm_every": 2, "n_layers": 4, "n_heads": 2}}
B, S, CACHE, STEPS = 4, 8, 16, 8
TOL = 1e-5
#: against the reference, x max |logits| (tests/test_torch_ssm.py)
SSM_REL = 1e-4
#: each leaf's gradient, x its max |g|: the mLSTM's gradients move by
#: ~6e-5 of their max under a 1e-7 relative change of the weights
#: (its normalizer max(|q·n|, exp(-m)) with random weights), and a cut
#: mixer sums its products in another order
GRAD_TOL = 1e-4
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}


def _perturb(tree, rng) -> None:
    if isinstance(tree, list):
        for v in tree:
            _perturb(v, rng)
        return
    for key, arr in list(tree.items()):
        if isinstance(arr, (dict, list)):
            _perturb(arr, rng)
        elif key.endswith("_g"):
            tree[key] = (1 + 0.1 * rng.standard_normal(arr.shape)
                         ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights(variant: str):
    over = VARIANTS[variant]
    rcfg = ref_get_config(ARCH).reduced(**over)
    params, _ = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    _perturb(tree, np.random.default_rng(1))
    return rcfg, tree, get_config(ARCH).reduced(**over)


def _inputs(variant: str) -> dict:
    _, _, cfg = _weights(variant)
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    batch["labels"][0, :2] = -1
    feed = rng.integers(1, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    return {"batch": batch, "feed": feed}


def _forward(params, cfg, inp, rt):
    """(loss, [prefill logits, decode logits...]) as numpy, the logits
    of every row over the whole vocab."""
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import batch_axes

    def rows(batch):
        if rt is None:
            return {k: torch.from_numpy(v) for k, v in batch.items()}
        return make_global_batch(batch, rt.mesh)

    def full(logits):
        if rt is None:
            return logits.numpy()
        vocab = "model" if tf.tp_plan(cfg, rt).vocab else None
        return tf.constrain(logits, rt, None, None,
                            have=(batch_axes(rt.mesh), vocab)).numpy()

    batch = rows(inp["batch"])
    with torch.no_grad():
        loss = float(tf.forward_train(params, cfg, batch, rt))
        batch.pop("labels")
        logits, state = tf.prefill(params, cfg, batch, CACHE, rt=rt)
        out = [full(logits)]
        for tok in inp["feed"]:
            logits, state = tf.decode_step(params, cfg, state,
                                           rows({"t": tok})["t"], rt=rt)
            out.append(full(logits))
    return loss, out


def _grads(params, cfg, batch, rt):
    """Every leaf's full gradient of one global batch, in flatten order,
    as numpy (on a mesh reduced and gathered)."""
    from repro_torch.launch.mesh import gather_tree
    from repro_torch.train._tree import leaves, unflatten
    from repro_torch.train.trainer import (
        _rank_rows,
        reduce_grads,
        value_and_grad,
    )

    if rt is None:
        rows = {k: torch.from_numpy(v) for k, v in batch.items()}
        return [g.numpy() for g in value_and_grad(params, cfg, rows)[1]]
    _, grads = value_and_grad(params, cfg, _rank_rows(batch, rt.mesh), rt)
    pl = tf.param_placements(cfg, rt)
    grads = reduce_grads(grads, pl)
    return [g.numpy() for g in leaves(gather_tree(unflatten(params, grads),
                                                  pl))]


def _held(*trees) -> int:
    from repro_torch.launch._count import tensors_of

    seen = {}
    for t in tensors_of(trees):
        st = t.untyped_storage()
        seen[st.data_ptr(), st.nbytes()] = st.nbytes()
    return sum(seen.values())


def _exact(rt) -> dict:
    """{kind: (collective log, bytes held)} of one train, prefill and
    decode step of the 4-head config (random weights) at the counted
    cells' shapes."""
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import log_collectives, shard_tree
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.trainer import TrainConfig, make_train_step

    cfg = get_config(ARCH).reduced(**VARIANTS["h4"])
    pls = tf.param_placements(cfg, rt)
    params = shard_tree(tf.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), pls)
    ocfg = dryrun.train_optimizer(cfg, rt.mesh)
    opt = adamw_init(params, ocfg, placements=pls)
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab_size, (B, S + 1))
    host = {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
    step = make_train_step(cfg, TrainConfig(optimizer=ocfg), rt)
    out = {}
    held = _held(params, opt)
    with log_collectives() as log:
        step(params, opt, host)
    out["train"] = (list(log), held)
    batch = make_global_batch(host, rt.mesh)
    batch.pop("labels")
    held = _held(params, batch)
    with torch.no_grad(), log_collectives() as log:
        tf.prefill(params, cfg, batch, cache_len=S, rt=rt)
    out["prefill"] = (list(log), held)
    with torch.no_grad():
        _, state = tf.prefill(params, cfg,
                              {"tokens": batch["tokens"][:, :4]},
                              cache_len=S, rt=rt)
        tokens = batch["tokens"][:, 0].contiguous()
        held = _held(params, state, tokens)
        with log_collectives() as log:
            tf.decode_step(params, cfg, state, tokens,
                           live=[True] * tokens.shape[0], rt=rt)
    out["decode"] = (list(log), held)
    return out


def _ssm_rank(rank: int, jobs: dict) -> dict:
    from repro_torch.launch.mesh import make_mesh

    out = {}
    for shape in MESHES:
        mesh = make_mesh(shape, device="cpu")
        rt = tf.Runtime(mesh)
        for variant, job in jobs.items():
            cfg = get_config(ARCH).reduced(**VARIANTS[variant])
            params = shard_lm_params(job["tree"], cfg, rt)
            out[shape, variant] = {
                "forward": _forward(params, cfg, job, rt),
                "grads": _grads(params, cfg, job["batch"], rt),
                "heads": tf.tp_plan(cfg, rt).mix_heads(cfg)}
        if shape == (2, 2):
            out["exact"] = _exact(rt)
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jobs = {v: {"tree": _weights(v)[1], **_inputs(v)} for v in VARIANTS}
    return run_world(_ssm_rank, 4, tmp_path_factory.mktemp("tp_ssm"), jobs,
                     deadline_s=600, timeout_s=120)


@functools.lru_cache(maxsize=None)
def _one_process(variant: str) -> dict:
    """The port in one process, on one thread (as each rank runs)."""
    _, tree, cfg = _weights(variant)
    params = lm_params_from_numpy(tree, cfg, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inp = _inputs(variant)
        return {"forward": _forward(params, cfg, inp, None),
                "grads": _grads(params, cfg, inp["batch"], None)}
    finally:
        torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _reference(variant: str) -> tuple:
    rcfg, tree, _ = _weights(variant)
    inp = _inputs(variant)
    params = jax.tree.map(jnp.asarray, tree)
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    rt = ref_tf.Runtime()
    loss = float(jax.jit(lambda p, b: ref_tf.forward_train(
        p, rcfg, b, rt))(params, batch))
    batch.pop("labels")
    logits, state = jax.jit(ref_tf.prefill, static_argnums=(1, 3, 4))(
        params, rcfg, batch, rt, CACHE)
    out = [np.asarray(logits)]
    dec = jax.jit(ref_tf.decode_step, static_argnums=(1, 4))
    for tok in inp["feed"]:
        logits, state = dec(params, rcfg, state, jnp.asarray(tok), rt)
        out.append(np.asarray(logits))
    return loss, out


CASES = [(shape, variant) for shape in MESHES for variant in VARIANTS]
IDS = [f"{v}-{s[0]}x{s[1]}" for s, v in CASES]


@pytest.mark.parametrize("shape,variant", CASES, ids=IDS)
def test_xlstm_tp_matches_the_reference(world, shape, variant):
    want_loss, want = _reference(variant)
    for res in world:
        loss, got = res[shape, variant]["forward"]
        assert abs(loss - want_loss) <= TOL * abs(want_loss)
        for g, w in zip(got, want, strict=True):
            w = np.asarray(w, np.float32)
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= SSM_REL * np.abs(w).max()


@pytest.mark.parametrize("shape,variant", CASES, ids=IDS)
def test_xlstm_tp_matches_one_process(world, shape, variant):
    want_loss, want = _one_process(variant)["forward"]
    for res in world:
        loss, got = res[shape, variant]["forward"]
        assert abs(loss - want_loss) <= TOL * abs(want_loss)
        for g, w in zip(got, want, strict=True):
            assert np.abs(g - w).max() <= TOL * np.abs(w).max()


@pytest.mark.parametrize("shape,variant", CASES, ids=IDS)
def test_xlstm_tp_gradients_match_one_process(world, shape, variant):
    want = _one_process(variant)["grads"]
    for res in world:
        got = res[shape, variant]["grads"]
        for g, w in zip(got, want, strict=True):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max()


@pytest.mark.parametrize("shape,variant", CASES, ids=IDS)
def test_each_rank_runs_its_heads(world, shape, variant):
    heads = get_config(ARCH).reduced(**VARIANTS[variant]).n_heads
    want = max(1, heads // shape[1])
    assert all(res[shape, variant]["heads"] == want for res in world)


# ------------------------------------------------------------ placements

def test_mixer_blocks_on_pod16x16_are_held_by_groups_of_four():
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(ARCH)
    rt = tf.Runtime(make_production_mesh())
    plan = tf.tp_plan(cfg, rt)
    assert plan.mix and plan.mix_parts == 4 and plan.mix_rep == 4
    e = Part("model", 4)
    pl = tf.param_placements(cfg, rt)["layers"]
    shapes = tf.param_shapes(cfg)["layers"]
    m, s = pl[0], pl[7]                   # an mLSTM and the sLSTM block
    assert tf._is_slstm(cfg, 7) and not tf._is_slstm(cfg, 0)
    for key in ("w_gate", "wq", "wk", "wv", "wi", "wf"):
        assert m[key].spec == (None, e)
    assert m["hnorm_g"].spec == (e,) and m["w_down"].spec == (e, None)
    assert m["w_up"].spec == (None, None)
    assert m["wq"].local_shape(shapes[0]["wq"]) == (2048, 512)
    assert s["w_gates"].spec == (None, Strided(4, e))
    assert s["w_gates"].local_shape(shapes[7]["w_gates"]) == (1024, 1024)
    assert s["r_gates"].spec == (None, e, None, None)
    assert s["w_out"].spec == (None, "model")
    assert s["w_down"].spec == ("model", None)


@pytest.mark.parametrize("coord", [0, 5, 15])
def test_w_gates_block_holds_the_four_gate_kinds_of_its_head(coord):
    """The block of rank ``coord`` on "model" = 16: head ``coord // 4``'s
    256 columns of each of z, i, f, o, in that order."""
    cfg = get_config(ARCH)
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    mesh = CardMesh(torch.device("cpu"), ("data", "model"), (16, 16),
                    coords=(0, coord))
    block = Placement(mesh, (None, Strided(4, Part("model", 4)))).shard(
        torch.arange(4 * d)[None])[0]
    head = coord // 4
    want = torch.cat([g * d + head * dh + torch.arange(dh)
                      for g in range(4)])
    assert torch.equal(block, want)


def test_ssm_decode_states_are_cut_by_heads_on_pod16x16():
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import make_production_mesh

    cfg = get_config(ARCH)
    state, _ = sp.decode_state_specs(cfg, configs.SHAPES["decode_32k"],
                                     make_production_mesh())
    gls, sl = state["layers"][0], state["layers"][7]
    di = cfg.d_model * cfg.proj_factor
    assert gls.h.shape == (8, 1, di // 4, di // 4)
    assert gls.m.shape == (8, 1)
    assert sl.c.shape == (8, cfg.d_model // 4)


# ------------------------------------------------------- exact counts

@pytest.fixture(scope="module")
def counted():
    real = configs.get_config
    configs.get_config = lambda arch: real(arch).reduced(**VARIANTS["h4"])
    try:
        return {kind: dryrun.count_cell(
            ARCH, ShapeCell(KINDS[kind], S, B, kind), None, "pod2x2")
            for kind in KINDS}
    finally:
        configs.get_config = real


@pytest.mark.parametrize("kind", list(KINDS))
def test_counter_equals_the_ranks_on_2x2(world, counted, kind):
    want = counted[kind]
    assert want["collective_log"]
    for res in world:
        log, held = res["exact"][kind]
        assert log == want["collective_log"]
        assert held == want["memory"]["argument_bytes"]
    kinds = {k for k, _, _ in want["collective_log"]}
    # the head-norms' and products' sums; sLSTM's y over the heads
    assert {"all-reduce", "all-gather"} <= kinds


# ------------------------------------------------ F8: the scan's gradient

def test_scan_gradients_stay_finite_where_masked_pairs_overflow():
    """F8: with 128-position chunks (xlstm-350m's) the intra-chunk pairs
    s > t that the mask drops reach exponents past float32's range; the
    reference exponentiates them before masking, so its gradients hold
    NaN (0 · inf), as the port's did.  The port masks them before the
    exponential: its loss is the reference's, its gradients are finite
    and equal to those of 16-position chunks (the same function, no
    overflow) within GRAD_TOL x max |g|."""
    from repro_torch.train.trainer import value_and_grad

    over = {"slstm_every": 0, "n_layers": 2, "gls_chunk": 128}
    rcfg = ref_get_config(ARCH).reduced(**over)
    params, _ = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    cfg = get_config(ARCH).reduced(**over)
    rng = np.random.default_rng(0)
    toks = rng.integers(1, cfg.vocab_size, (2, 257))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    ref_loss, ref_grads = jax.value_and_grad(
        lambda p: ref_tf.forward_train(
            p, rcfg, {k: jnp.asarray(v) for k, v in batch.items()},
            ref_tf.Runtime()))(params)
    assert any(np.isnan(np.asarray(g)).any()
               for g in jax.tree.leaves(ref_grads))
    port = lm_params_from_numpy(tree, cfg, "cpu")
    rows = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, grads = value_and_grad(port, cfg, rows)
    assert abs(float(loss) - float(ref_loss)) <= TOL * abs(float(ref_loss))
    assert all(torch.isfinite(g).all() for g in grads)
    small = get_config(ARCH).reduced(**dict(over, gls_chunk=16))
    _, want = value_and_grad(port, small, rows)
    for g, w in zip(grads, want, strict=True):
        assert (g - w).abs().max() <= GRAD_TOL * w.abs().max()
