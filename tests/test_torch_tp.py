"""Tensor parallelism over "model" on gloo ranks of the CPU
(``repro_torch.launch.mesh.run_world``): reduced tinyllama
(``n_kv_heads = 2``), qwen2 (QKV bias), deepseek-v2-lite (MLA, shared
experts, expert parallelism with tensor parallelism on (2,2)), qwen2-vl
(M-RoPE), whisper (encoder and cross attention), hymba (its attention
and Mamba heads cut in blocks of whole heads, its vocab and FFN cut) and
xlstm (its mLSTM mixers cut by heads, its vocab cut) on the (1,2), (1,4)
and (2,2) meshes: ``forward_train``'s loss, the prefill logits and 4
decode steps' logits against the port in one process and against the
reference's single-device functions; two train steps with ZeRO-2
against one process; a checkpoint saved on (2,2) restored onto (1,2)
and (1,4); the serving engine's tokens; and every parameter's block
shape on (2,4) against the reference's ``NamedSharding`` shard shape
(a subprocess with 8 host devices, as tests/test_sharding.py runs it).

Both packages compute with the same weights (the reference's
``init_params``, norm gains and biases perturbed with numpy).  The
logits are gathered over the batch axes and the vocab
(``constrain``).  Tolerances: against one process, logits within 1e-5
x max |logits| and the loss within 1e-5 relative (a row-parallel
product sums its partial products in another order); against the
reference, logits within 1e-5 absolute (``tests/test_torch_lm.py``;
xlstm within 1e-4 x max |logits|, ``tests/test_torch_ssm.py``) and
the loss within 1e-5 relative (``tests/test_torch_train.py``); each
leaf's gradient within 1e-5 x its max |g|, and its parameters after two
train steps (AdamW with ``TRAIN_EPS``) within 1e-5 x max |p|; a
restored checkpoint and the engines' tokens exactly.
"""

import dataclasses
import functools
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as ref_tf
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch.mesh import abstract_mesh, run_world
from repro_torch.models import transformer as tf

REPO = pathlib.Path(__file__).resolve().parents[1]
MESHES = ((2, 2), (1, 4), (1, 2))       # (2,2) first: it saves the drill
#: the reduced configs' overrides (deepseek: expert parallelism at a
#: capacity factor that drops nothing, so it computes the dense oracle)
ARCHS = {"tinyllama-1.1b": {}, "qwen2-7b": {},
         "deepseek-v2-lite-16b": {"moe_impl": "ep",
                                  "capacity_factor": 8.0},
         "qwen2-vl-72b": {}, "whisper-large-v3": {},
         # hymba: attention and Mamba heads by blocks of whole heads,
         # vocab and FFN cut; xlstm: mixers by heads, vocab cut
         "hymba-1.5b": {}, "xlstm-350m": {}}
TRAIN_ARCHS = ("tinyllama-1.1b", "deepseek-v2-lite-16b")
B, S, CACHE, STEPS = 4, 8, 16, 4
TOL = 1e-5
#: reduced xlstm end to end against the reference, x max |logits|
#: (tests/test_torch_ssm.py: float32 noise grows through its recurrences)
SSM_REL = 1e-4
#: AdamW's eps in the train checks: the elementwise m / sqrt(v) turns an
#: element whose gradient is rounding noise (1e-6 x max |g| between the
#: mesh and one process) into a step of up to lr; an eps well above
#: that noise keeps such steps linear in the gradient, so two steps
#: compare at TOL (the gradients themselves are held at TOL first)
TRAIN_EPS = 0.1
ENGINE = {"max_batch": 4, "cache_len": 24, "max_new_tokens": 4,
          "eos_token": -1}
PROMPTS = ([5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 6, 2, 9, 1, 7],
           [2, 13], [6, 1, 1, 5])


def _mesh_id(shape):
    return f"{shape[0]}x{shape[1]}"


def _perturb(tree: dict, rng) -> None:
    for key, arr in list(tree.items()):
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
    """(reference config, numpy tree, port config) of the reduced
    config."""
    rcfg = ref_get_config(arch).reduced()
    params, _ = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    _perturb(tree, np.random.default_rng(1))
    if rcfg.family == "audio":
        tree["embed"] = tree["embed"] * 50
    return rcfg, tree, get_config(arch).reduced(**ARCHS[arch])


def _inputs(arch: str) -> dict:
    """The batch (tokens, labels, the family's extras) and the decode
    feed, as numpy."""
    _, _, cfg = _weights(arch)
    rng = np.random.default_rng(7)
    toks = rng.integers(1, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    batch["labels"][0, :2] = -1
    if cfg.family == "audio":
        batch["encoder_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        t = np.zeros((3, S), np.int32)
        for n, (i, j) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1)), 1):
            t[:, n] = (1, 1 + i, 1 + j)
        t[:, 5:] = 3 + np.arange(S - 5)
        batch["positions"] = np.broadcast_to(t[:, None], (3, B, S)).copy()
    feed = rng.integers(1, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    return {"batch": batch, "feed": feed}


def _serve(engine):
    for prompt in PROMPTS[:3]:
        engine.submit(prompt)
    engine.step()
    for prompt in PROMPTS[3:]:
        engine.submit(prompt)
    return {r.rid: list(r.generated) for r in engine.run_to_completion()}


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
            mine = rows({"t": tok})["t"]
            logits, state = tf.decode_step(params, cfg, state, mine, rt=rt)
            out.append(full(logits))
    return loss, out


def _train(params, cfg, batches, rt):
    """Two AdamW steps (ZeRO-2 on a mesh); the full parameters after
    them, in flatten order, as numpy."""
    from repro_torch.launch.mesh import gather_tree
    from repro_torch.train._tree import leaves
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import (
        TrainConfig,
        make_train_step,
        train_placements,
    )

    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr=1e-3, eps=TRAIN_EPS, warmup_steps=1, total_steps=4,
        zero_shard=True))
    pl = None
    if rt is None:
        state = adamw_init(params, tcfg.optimizer)
    else:
        pl = train_placements(cfg, tcfg, rt)
        state = adamw_init(params, tcfg.optimizer,
                           placements=pl["params"])
    step = make_train_step(cfg, tcfg, rt)
    for batch in batches:
        params, state, _ = step(params, state, batch)
    if pl is not None:
        full = gather_tree(params, pl["params"])
        return [p.numpy() for p in leaves(full)], params, state, pl
    return [p.numpy() for p in leaves(params)], params, state, pl


def _grads(params, cfg, batch, rt):
    """Every parameter's full gradient of one global batch, in flatten
    order, as numpy (on a mesh reduced and gathered)."""
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


def _tp_rank(rank: int, shape: tuple, inp: dict, ckpt: str) -> dict:
    """One rank of a ``shape`` world: every arch's forward, two train
    steps, the engine; (2,2) saves its tinyllama train state, the other
    meshes restore it."""
    from repro_torch.convert import shard_lm_params
    from repro_torch.launch.mesh import gather_tree, make_mesh
    from repro_torch.serve.engine import EngineConfig, ServingEngine
    from repro_torch.train._tree import leaves
    from repro_torch.train.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    mesh = make_mesh(shape, device="cpu")
    rt = tf.Runtime(mesh)
    out = {"coords": mesh.coords}
    for arch, job in inp.items():
        cfg = get_config(arch).reduced(**ARCHS[arch])
        params = shard_lm_params(job["tree"], cfg, rt)
        res = {"forward": _forward(params, cfg, job, rt)}
        if arch in TRAIN_ARCHS:
            res["grads"] = _grads(params, cfg, job["train"][0], rt)
            full, p2, s2, pl = _train(params, cfg, job["train"], rt)
            res["train"] = full
            res["engine"] = _serve(ServingEngine(
                cfg, p2, EngineConfig(**ENGINE), rt))
            if arch == "tinyllama-1.1b":
                state = {"params": p2, "opt": s2}
                res["moments"] = [t.numpy() for t in leaves(
                    gather_tree(s2, pl["opt"]))]
                if shape == (2, 2):
                    save_checkpoint(ckpt, 2, state, placements=pl)
                else:
                    back, _ = restore_checkpoint(ckpt, 2, state,
                                                 placements=pl)
                    res["restored"] = [t.numpy() for t in leaves(
                        gather_tree(back, pl))]
        out[arch] = res
    return out


def _train_batches(arch: str) -> list:
    _, _, cfg = _weights(arch)
    rng = np.random.default_rng(11)
    out = []
    for _ in range(2):
        toks = rng.integers(1, cfg.vocab_size, (B, S + 1))
        out.append({"tokens": toks[:, :-1].astype(np.int32),
                    "labels": toks[:, 1:].astype(np.int32)})
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{mesh shape: every rank's results}; the (2,2) world first."""
    root = tmp_path_factory.mktemp("tp")
    inp = {}
    for arch in ARCHS:
        job = {"tree": _weights(arch)[1], **_inputs(arch)}
        if arch in TRAIN_ARCHS:
            job["train"] = _train_batches(arch)
        inp[arch] = job
    ckpt = str(root / "ckpt")
    return {shape: run_world(_tp_rank, shape[0] * shape[1],
                             root / _mesh_id(shape), shape, inp, ckpt,
                             deadline_s=600, timeout_s=120)
            for shape in MESHES}


@functools.lru_cache(maxsize=None)
def _one_process(arch: str) -> dict:
    """The port in one process (experts on the dense path)."""
    _, tree, cfg = _weights(arch)
    cfg = dataclasses.replace(cfg, moe_impl="dense")
    params = lm_params_from_numpy(tree, cfg, "cpu")
    out = {"forward": _forward(params, cfg, _inputs(arch), None)}
    if arch in TRAIN_ARCHS:
        from repro_torch.serve.engine import EngineConfig, ServingEngine

        out["grads"] = _grads(params, cfg, _train_batches(arch)[0], None)
        out["train"], trained, _, _ = _train(params, cfg,
                                             _train_batches(arch), None)
        out["engine"] = _serve(ServingEngine(cfg, trained,
                                             EngineConfig(**ENGINE)))
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch: str) -> tuple:
    """The reference's single-device loss and logits."""
    rcfg, tree, _ = _weights(arch)
    inp = _inputs(arch)
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


CASES = [(arch, shape) for arch in ARCHS for shape in MESHES]
IDS = [f"{arch}-{_mesh_id(shape)}" for arch, shape in CASES]


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_tp_matches_one_process(worlds, arch, shape):
    want_loss, want = _one_process(arch)["forward"]
    for res in worlds[shape]:
        loss, got = res[arch]["forward"]
        assert abs(loss - want_loss) <= TOL * abs(want_loss)
        for g, w in zip(got, want, strict=True):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= TOL * np.abs(w).max()


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_tp_matches_the_reference(worlds, arch, shape):
    want_loss, want = _reference(arch)
    for res in worlds[shape]:
        loss, got = res[arch]["forward"]
        assert abs(loss - want_loss) <= TOL * abs(want_loss)
        for g, w in zip(got, want, strict=True):
            w = np.asarray(w, np.float32)
            tol = SSM_REL * np.abs(w).max() if arch == "xlstm-350m" else TOL
            assert np.abs(g - w).max() <= tol


TRAIN_CASES = [(arch, shape) for arch in TRAIN_ARCHS for shape in MESHES]
TRAIN_IDS = [f"{arch}-{_mesh_id(shape)}" for arch, shape in TRAIN_CASES]


@pytest.mark.parametrize("arch,shape", TRAIN_CASES, ids=TRAIN_IDS)
def test_tp_gradients_match_one_process(worlds, arch, shape):
    """Each leaf's reduced gradient, gathered, within TOL x its largest
    |value|."""
    want = _one_process(arch)["grads"]
    for res in worlds[shape]:
        for g, w in zip(res[arch]["grads"], want, strict=True):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= TOL * np.abs(w).max()


@pytest.mark.parametrize("arch,shape", TRAIN_CASES, ids=TRAIN_IDS)
def test_two_tp_zero2_train_steps_match_one_process(worlds, arch, shape):
    want = _one_process(arch)["train"]
    for res in worlds[shape]:
        got = res[arch]["train"]
        for g, w in zip(got, want, strict=True):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= TOL * max(np.abs(w).max(), 1e-30)


@pytest.mark.parametrize("arch,shape", TRAIN_CASES, ids=TRAIN_IDS)
def test_tp_engine_serves_the_same_tokens_on_every_rank(worlds, arch,
                                                        shape):
    want = _one_process(arch)["engine"]
    assert sorted(want) == list(range(len(PROMPTS)))
    for res in worlds[shape]:
        assert res[arch]["engine"] == want


@pytest.mark.parametrize("shape", [(1, 4), (1, 2)], ids=_mesh_id)
def test_tp_checkpoint_restores_onto_another_mesh(worlds, shape):
    """The (2,2) world's tinyllama state after two steps, restored onto
    ``shape``: the parameters, moments and step count, bit for bit."""
    saved = worlds[(2, 2)][0]["tinyllama-1.1b"]
    # flatten order: "opt" (count, m, v), then "params"
    want = saved["moments"] + saved["train"]
    for res in worlds[shape]:
        got = res["tinyllama-1.1b"]["restored"]
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and np.array_equal(g, w)


# ------------------------------------------------------ placement shapes

SHARD_SCRIPT = textwrap.dedent("""
    import pickle, sys, warnings
    warnings.filterwarnings("ignore")
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.models import transformer as tf

    mesh = jax.make_mesh((2, 4), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    for arch in sys.argv[2:]:
        params, specs = tf.abstract(get_config(arch).reduced())
        out[arch] = jax.tree.map(
            lambda x, s: tuple(NamedSharding(mesh, s).shard_shape(x.shape)),
            params, specs, is_leaf=lambda s: isinstance(s, P))
    pickle.dump(out, open(sys.argv[1], "wb"))
""")

#: the leaves whose block on (2,4) deliberately differs from the
#: reference's shard: the KV heads' blocks (2 KV heads on 4 ranks: each
#: rank holds the head its query heads read; the reference cuts the
#: columns through heads) and ``bk``/``bv`` (the reference keeps them
#: whole); the routed experts of the dense MoE path (whole on each rank
#: without expert parallelism); the hybrid family's leaves of
#: HYBRID_DIFFER: ``wk``/``wv`` by whole KV heads (2 KV heads on 4
#: ranks: one a rank, each held by a run of two) and ``mdt``, ``ma_log``
#: and ``mdt_bias`` by Mamba heads (one of the 4 a rank) where the
#: reference keeps them whole (its other mixer leaves are head-aligned
#: on (2,4) and follow the reference's shard); and the xLSTM leaves of
#: SSM_DIFFER: ``w_up`` whole (its ``u`` feeds every head), ``wi``/``wf``,
#: ``hnorm_g`` and ``r_gates`` cut by heads where the reference keeps
#: them whole, ``w_gates`` by heads within each gate kind where the
#: reference cuts its columns evenly (the other xLSTM leaves are
#: head-aligned and follow the reference's shard)
KV_DIFFER = {"wk", "wv", "bk", "bv", "xwk", "xwv", "wuk", "wuv"}
EXPERTS_DIFFER = {"ew1", "ew2", "ew3"}
FOLLOWED = {"embed", "head", "w1", "w2", "w3"}
SSM_DIFFER = {"w_up", "wi", "wf", "hnorm_g", "w_gates", "r_gates"}
HYBRID_DIFFER = {"wk", "wv", "mdt", "ma_log", "mdt_bias"}


@pytest.fixture(scope="module")
def ref_shards(tmp_path_factory):
    out = tmp_path_factory.mktemp("shards") / "shards.pkl"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(REPO / "src")
    subprocess.run([sys.executable, "-c", SHARD_SCRIPT, str(out),
                    *ARCH_IDS], env=env, check=True, timeout=300)
    return pickle.loads(out.read_bytes())


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _walk(v, path + (k,))
    elif isinstance(tree, list) and tree and isinstance(tree[0], dict):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (i,))
    else:
        yield path, tree


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_block_shapes_on_2x4_follow_the_reference(ref_shards, arch):
    cfg = get_config(arch).reduced()
    rt = tf.Runtime(abstract_mesh((2, 4)))
    placements = tf.param_placements(cfg, rt)
    shapes = tf.param_shapes(cfg)
    same = 0
    for path, shape in _walk(shapes):
        got = _at(placements, path).local_shape(tuple(shape))
        want = tuple(_at(ref_shards[arch], path))
        if cfg.family in tf.WHOLE_FAMILIES and path[-1] not in FOLLOWED:
            assert got == tuple(shape), path
            same += got == want
        elif cfg.family == "hybrid" and path[-1] in HYBRID_DIFFER:
            # the rank's one KV head of the 2, its one Mamba head of the 4
            width = cfg.hd if path[-1] in ("wk", "wv") else 1
            assert got[:-1] == tuple(shape)[:-1], path
            assert got[-1] == width, path
            assert got != want, path
        elif cfg.family == "ssm" and path[-1] in SSM_DIFFER:
            # w_up whole; the rest hold this rank's one head of the 4
            if path[-1] == "w_up":
                assert got == tuple(shape), path
            else:
                axis = {"wi": 1, "wf": 1, "hnorm_g": 0, "w_gates": 1,
                        "r_gates": 1}[path[-1]]
                assert got[axis] == shape[axis] // cfg.n_heads, path
        elif path[-1] in KV_DIFFER and cfg.family != "ssm":
            # whole KV heads: the rank's one head of the 2
            assert got[:-1] == tuple(shape)[:-1], path
            assert got[-1] == cfg.hd, path
        elif path[-1] in EXPERTS_DIFFER:
            assert got == tuple(shape), path
        else:
            same += 1
            assert got == want, path
    assert same > 0


def test_kv_heads_held_by_a_group_of_ranks():
    """tinyllama at full width on "model" = 16: 2 query heads and the
    one KV head they read a rank, each KV head's block held by 4
    consecutive ranks; qwen2-7b's 28 heads and whisper's 20 do not
    divide by 16, so their attention leaves stay whole; hymba's heads
    are cut in blocks of whole heads of unequal size."""
    from repro_torch.launch.mesh import Part, make_production_mesh

    rt = tf.Runtime(make_production_mesh())
    cfg = get_config("tinyllama-1.1b")
    plan = tf.tp_plan(cfg, rt)
    assert (plan.attn, plan.kv_parts, plan.kv_heads(cfg)) == (True, 4, 1)
    pl = tf.param_placements(cfg, rt)["layers"]
    assert pl["wk"].spec[-1] == Part("model", 4)
    assert pl["wq"].local_shape((22, 2048, 2048)) == (22, 2048, 128)
    assert pl["wk"].local_shape((22, 2048, 256)) == (22, 2048, 64)
    for arch in ("qwen2-7b", "whisper-large-v3"):
        plan = tf.tp_plan(get_config(arch), rt)
        assert not plan.attn and plan.ffn and plan.vocab
    plan = tf.tp_plan(get_config("xlstm-350m"), rt)
    assert not plan.attn and plan.vocab
    # xlstm's 4 heads on 16 ranks: each head held by 4 (item 5c)
    assert plan.mix and plan.mix_entry() == Part("model", 4)
    # hymba's 25 query heads over 5 KV heads on 16 ranks: runs of 4, 3,
    # 3, 3, 3 ranks share a KV head and cut its 5 query heads; its 25
    # Mamba heads 2 a rank on nine ranks, 1 on seven (item 5d)
    plan = tf.tp_plan(get_config("hymba-1.5b"), rt)
    assert plan.attn and plan.vocab and plan.ffn and not plan.mix
    assert [b - a for a, b in plan.q_blocks] == [2, 1, 1, 1] + [2, 2, 1] * 4
    assert [a for a, _ in plan.kv_blocks] == sum(
        ([j] * n for j, n in enumerate((4, 3, 3, 3, 3))), [])
    assert [b - a for a, b in plan.mamba_blocks] == [2] * 9 + [1] * 7
    pl = tf.param_placements(get_config("hymba-1.5b"), rt)["layers"]
    assert pl["wq"].local_shape((32, 1600, 1600)) == (32, 1600, 128)
    assert pl["wk"].local_shape((32, 1600, 320)) == (32, 1600, 64)
    assert pl["mX"].local_shape((32, 1600, 1600)) == (32, 1600, 128)


def test_constrain_is_the_identity_off_a_mesh():
    x = torch.randn(2, 3, 4)
    assert tf.constrain(x, None, ("pod", "data"), None, "model",
                        have=(None, None, None)) is x
    assert tf.constrain(x, tf.Runtime(), None, None, None,
                        have=(None, None, "model")) is x
