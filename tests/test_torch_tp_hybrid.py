"""Tensor parallelism of hymba's attention and Mamba heads over "model"
in blocks of whole heads of unequal size, on gloo ranks of the CPU
(``repro_torch.launch.mesh.run_world``: a world of 4 ranks, (1,4) then
(2,2) in it, and a world of 2 on (1,2)).

Config A is hymba-1.5b's head layout at a narrow width: 25 query heads
over 5 KV heads and 25 Mamba heads (head_dim 8, d_model 200, ssm_state
4, window 8, 2 layers), so that "model" <= n_kv_heads: 3 + 2 KV heads
on 2 ranks, 2 + 1 + 1 + 1 on 4, and the Mamba heads 13 + 12 and 7 + 6
+ 6 + 6.  Config B has 9 query heads over 3 KV heads: on 4 ranks the
ranks form runs of 2, 1, 1 that each hold one KV head (the run of two
shares its block and cuts its 3 query heads 2 + 1; the others hold 3
each), and its 9 Mamba heads are cut 3 + 2 + 2 + 2.

Each is held against the port in one process and against the
reference's single-device functions on the same numpy weights (through
``shard_lm_params``): the logits of a prefill past the window and
``STEPS`` decode steps within ``TOL`` x max |logits|, the loss within
``TOL`` relative, each leaf's reduced and gathered gradient within
``GRAD_TOL`` x its max |g|; the engine's tokens on (2,2) equal to one
process's; and every rank's collectives and held bytes of a train, a
prefill and a decode step on (2,2) equal to the dry-run counter's on
an abstract (2,2) mesh at that rank's coordinates, exactly; config A's
blocks saved from (1,4) and restored onto (2,2), bit for bit.  A planted
fault must fail: config B's gradients without the sum over the run of
ranks that shares a KV head.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import transformer as ref_tf
from repro.serve.engine import EngineConfig as RefEngineConfig
from repro.serve.engine import ServingEngine as RefEngine
from repro_torch import configs
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.convert import lm_params_from_numpy, shard_lm_params
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import CardMesh, Uneven, run_world
from repro_torch.models import transformer as tf

ARCH = "hymba-1.5b"
#: the configs' overrides of the reduced hymba
VARIANTS = {"A": {"n_heads": 25, "n_kv_heads": 5, "head_dim": 8,
                  "d_model": 200, "ssm_state": 4, "window": 8,
                  "n_layers": 2},
            "B": {"n_heads": 9, "n_kv_heads": 3, "head_dim": 8,
                  "d_model": 72, "ssm_state": 4, "window": 8,
                  "n_layers": 2}}
WORLDS = {4: ((1, 4), (2, 2)), 2: ((1, 2),)}
#: prompts past the window of 8, so that the rings wrap
B, S, CACHE, STEPS = 4, 12, 16, 4
TOL = 1e-5
GRAD_TOL = 1e-4
ENGINE = {"max_batch": 4, "cache_len": 24, "max_new_tokens": 4,
          "eos_token": -1}
PROMPTS = ([5, 9, 2, 7, 1, 3, 3, 8, 11, 4], [3, 3, 8],
           [11, 4, 6, 2, 9, 1, 7, 5, 5, 2, 13, 6], [2, 13],
           [6, 1, 1, 5, 9, 9, 12, 4, 3])
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
#: the exact counts' configs: head_dim 16, the least the attention
#: kernels' meta branch (the dry-run's) takes
EXACT = {v: dict(over, head_dim=16, d_model=16 * over["n_heads"])
         for v, over in VARIANTS.items()}


def _mesh_id(shape):
    return f"{shape[0]}x{shape[1]}"


def _perturb(tree: dict, rng) -> None:
    for key, arr in list(tree.items()):
        if isinstance(arr, dict):
            _perturb(arr, rng)
        elif key.endswith("_g"):
            tree[key] = (1 + 0.1 * rng.standard_normal(arr.shape)
                         ).astype(np.float32)
        elif key in ("ma_log", "mdt_bias"):
            tree[key] = (0.3 * rng.standard_normal(arr.shape)
                         ).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _weights(variant: str):
    """(reference config, numpy tree, port config)."""
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


def _without_run_sums(params, cfg, batch, rt):
    """The planted fault: :func:`_grads` with the blocks that a run of
    ranks shares left unsummed over the run."""
    real = CardMesh.subgroup

    def no_runs(self, axis, parts):
        if isinstance(parts, tuple):
            return None
        return real(self, axis, parts)

    CardMesh.subgroup = no_runs
    try:
        return _grads(params, cfg, batch, rt)
    finally:
        CardMesh.subgroup = real


def _held(*trees) -> int:
    from repro_torch.launch._count import tensors_of

    seen = {}
    for t in tensors_of(trees):
        st = t.untyped_storage()
        seen[st.data_ptr(), st.nbytes()] = st.nbytes()
    return sum(seen.values())


def _exact(rt, variant: str) -> dict:
    """{kind: (collective log, bytes held)} of one train, prefill and
    decode step (random weights) at the counted cells' shapes."""
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import log_collectives, shard_tree
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.trainer import TrainConfig, make_train_step

    cfg = get_config(ARCH).reduced(**EXACT[variant])
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


def _checkpoint(params, cfg, rt, ckpt: str, save: bool):
    """Save this mesh's blocks (``save``), or restore the checkpoint onto
    this mesh's blocks and return the gathered leaves, as numpy."""
    from repro_torch.launch.mesh import gather_tree
    from repro_torch.train._tree import leaves
    from repro_torch.train.checkpoint import (
        restore_checkpoint,
        save_checkpoint,
    )

    pl = tf.param_placements(cfg, rt)
    if save:
        save_checkpoint(ckpt, 1, params, placements=pl)
        return None
    back, _ = restore_checkpoint(ckpt, 1, params, placements=pl)
    return [t.numpy() for t in leaves(gather_tree(back, pl))]


def _hybrid_rank(rank: int, meshes: tuple, jobs: dict, ckpt: str) -> dict:
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    out = {}
    for shape in meshes:
        mesh = make_mesh(shape, device="cpu")
        rt = tf.Runtime(mesh)
        for variant, job in jobs.items():
            cfg = get_config(ARCH).reduced(**VARIANTS[variant])
            params = shard_lm_params(job["tree"], cfg, rt)
            plan = tf.tp_plan(cfg, rt)
            if variant == "A" and len(meshes) > 1:
                # saved from the first mesh's blocks, restored onto the
                # second's
                restored = _checkpoint(params, cfg, rt, ckpt,
                                       save=shape == meshes[0])
            res = {"forward": _forward(params, cfg, job, rt),
                   "grads": _grads(params, cfg, job["batch"], rt),
                   "heads": (plan.q_blocks[plan.coord],
                             plan.kv_blocks[plan.coord],
                             plan.mamba_blocks[plan.coord]),
                   "local": (params["layers"]["wq"].shape[-1],
                             params["layers"]["mX"].shape[-1])}
            if shape == (2, 2):
                res["engine"] = _serve(ServingEngine(
                    cfg, params, EngineConfig(**ENGINE), rt))
                res["exact"] = _exact(rt, variant)
                res["coords"] = mesh.coords
            if variant == "B" and shape == (1, 4):
                res["fault"] = _without_run_sums(params, cfg, job["batch"],
                                                 rt)
            if variant == "A" and len(meshes) > 1 and shape != meshes[0]:
                res["restored"] = restored
            out[shape, variant] = res
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{mesh shape: every rank's results}."""
    jobs = {v: {"tree": _weights(v)[1], **_inputs(v)} for v in VARIANTS}
    out = {}
    for n, meshes in WORLDS.items():
        root = tmp_path_factory.mktemp(f"tp_hybrid{n}")
        ranks = run_world(_hybrid_rank, n, root, meshes, jobs,
                          str(root / "ckpt"), deadline_s=600, timeout_s=120)
        for shape in meshes:
            out[shape] = [{v: r[shape, v] for v in VARIANTS} for r in ranks]
    return out


@functools.lru_cache(maxsize=None)
def _one_process(variant: str) -> dict:
    """The port in one process, on one thread (as each rank runs)."""
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    _, tree, cfg = _weights(variant)
    params = lm_params_from_numpy(tree, cfg, "cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        inp = _inputs(variant)
        return {"forward": _forward(params, cfg, inp, None),
                "grads": _grads(params, cfg, inp["batch"], None),
                "engine": _serve(ServingEngine(cfg, params,
                                               EngineConfig(**ENGINE)))}
    finally:
        torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _reference(variant: str) -> dict:
    """The reference's single-device loss, logits, gradients (the port's
    layout, in flatten order) and engine tokens."""
    from repro_torch.train._tree import leaves

    rcfg, tree, cfg = _weights(variant)
    inp = _inputs(variant)
    params = jax.tree.map(jnp.asarray, tree)
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    rt = ref_tf.Runtime()
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_tf.forward_train(p, rcfg, b, rt)))(params, batch)
    grads = [g.numpy() for g in leaves(lm_params_from_numpy(
        jax.tree.map(np.asarray, grads), cfg, "cpu"))]
    batch.pop("labels")
    logits, state = jax.jit(ref_tf.prefill, static_argnums=(1, 3, 4))(
        params, rcfg, batch, rt, CACHE)
    out = [np.asarray(logits)]
    dec = jax.jit(ref_tf.decode_step, static_argnums=(1, 4))
    for tok in inp["feed"]:
        logits, state = dec(params, rcfg, state, jnp.asarray(tok), rt)
        out.append(np.asarray(logits))
    engine = _serve(RefEngine(rcfg, params, RefEngineConfig(**ENGINE)))
    return {"forward": (float(loss), out), "grads": grads, "engine": engine}


MESHES = [shape for meshes in WORLDS.values() for shape in meshes]
CASES = [(shape, variant) for shape in MESHES for variant in VARIANTS]
IDS = [f"{v}-{_mesh_id(s)}" for s, v in CASES]


@pytest.mark.parametrize("shape,variant", CASES, ids=IDS)
@pytest.mark.parametrize("against", ["one_process", "reference"])
def test_hybrid_tp_logits_and_loss(worlds, shape, variant, against):
    want = (_one_process(variant) if against == "one_process"
            else _reference(variant))
    want_loss, want_logits = want["forward"]
    for res in worlds[shape]:
        loss, got = res[variant]["forward"]
        assert abs(loss - want_loss) <= TOL * abs(want_loss)
        for g, w in zip(got, want_logits, strict=True):
            w = np.asarray(w, np.float32)
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= TOL * np.abs(w).max()


@pytest.mark.parametrize("shape,variant", CASES, ids=IDS)
@pytest.mark.parametrize("against", ["one_process", "reference"])
def test_hybrid_tp_gradients(worlds, shape, variant, against):
    want = (_one_process(variant) if against == "one_process"
            else _reference(variant))["grads"]
    for res in worlds[shape]:
        got = res[variant]["grads"]
        for g, w in zip(got, want, strict=True):
            assert g.shape == w.shape
            assert np.abs(g - w).max() <= GRAD_TOL * np.abs(w).max()


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_hybrid_tp_engine_serves_the_same_tokens_on_2x2(worlds, variant):
    want = _one_process(variant)["engine"]
    assert want == _reference(variant)["engine"]
    assert sorted(want) == list(range(len(PROMPTS)))
    for res in worlds[(2, 2)]:
        assert res[variant]["engine"] == want


@pytest.mark.parametrize("shape,variant", CASES, ids=IDS)
def test_each_rank_holds_its_blocks_of_whole_heads(worlds, shape, variant):
    """The ranks' blocks cover every head once, in order (a KV head
    shared by a run of ranks counted once), and each rank's leaves hold
    its blocks' columns."""
    cfg = get_config(ARCH).reduced(**VARIANTS[variant])
    blocks = [res[variant]["heads"] for res in worlds[shape]]
    line = blocks[:shape[1]]             # data 0, "model" 0, 1, ...
    for which, n in ((0, cfg.n_heads), (1, cfg.n_kv_heads),
                     (2, cfg.n_heads)):
        seen = []
        for b in (x[which] for x in line):
            if not seen or seen[-1] != b:
                seen.append(b)
        assert [a for a, _ in seen] == [0] + [b for _, b in seen[:-1]]
        assert seen[-1][1] == n
    for res in worlds[shape]:
        (qa, qb), _, (ma, mb) = res[variant]["heads"]
        assert res[variant]["local"] == ((qb - qa) * cfg.hd,
                                         (mb - ma) * cfg.hd)


def test_checkpoint_saved_on_1x4_restores_onto_2x2(worlds):
    """Config A's blocks on (1,4) (2 + 1 + 1 + 1 KV heads, 7 + 6 + 6 + 6
    Mamba heads) saved, restored onto (2,2)'s (3 + 2, 13 + 12): every
    leaf bit for bit."""
    from repro_torch.train._tree import leaves

    _, tree, cfg = _weights("A")
    want = [t.numpy() for t in leaves(lm_params_from_numpy(tree, cfg,
                                                           "cpu"))]
    for res in worlds[(2, 2)]:
        got = res["A"]["restored"]
        for g, w in zip(got, want, strict=True):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_planted_fault_without_the_kv_runs_sum_fails(worlds):
    """Config B on (1,4): ranks 0 and 1 share KV head 0, so their blocks
    of ``wk``/``wv`` each hold half of its gradient; left unsummed, the
    gathered gradient is off by far more than GRAD_TOL."""
    cfg = get_config(ARCH).reduced(**VARIANTS["B"])
    plan = tf.tp_plan(cfg, tf.Runtime(CardMesh(
        torch.device("cpu"), ("data", "model"), (1, 4), coords=(0, 0))))
    assert Uneven("model", plan.kv_blocks).runs == (2, 1, 1)
    want = _one_process("B")["grads"]
    worst = max(np.abs(g - w).max() / np.abs(w).max()
                for res in worlds[(1, 4)]
                for g, w in zip(res["B"]["fault"], want, strict=True))
    assert worst > 100 * GRAD_TOL


# ------------------------------------------------------- exact counts

@pytest.fixture(scope="module")
def counted():
    """{(variant, kind, "model" coordinate): the counter's run} on an
    abstract (2,2) mesh at that coordinate."""
    real = configs.get_config
    out = {}
    try:
        for variant, over in EXACT.items():
            configs.get_config = lambda arch, over=over: real(arch).reduced(
                **over)
            for kind in KINDS:
                for coord in (0, 1):
                    out[variant, kind, coord] = dryrun.count_cell(
                        ARCH, ShapeCell(KINDS[kind], S, B, kind), None,
                        "pod2x2", coords=(0, coord))
    finally:
        configs.get_config = real
    return out


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("kind", list(KINDS))
def test_counter_equals_the_ranks_on_2x2(worlds, counted, variant, kind):
    """Every rank's collectives and held bytes are the counter's at its
    own "model" coordinate (rank 0's, the dry-run's record, holds the
    largest blocks).  The forward's collectives are the same at every
    coordinate (the uneven gather pads each block to the largest, so
    every rank sends the same bytes); the train step's gradient sums
    over "data" carry each rank's own blocks."""
    for res in worlds[(2, 2)]:
        log, held = res[variant]["exact"][kind]
        want = counted[variant, kind, res[variant]["coords"][1]]
        assert want["collective_log"]
        assert log == want["collective_log"]
        assert held == want["memory"]["argument_bytes"]
    assert (counted[variant, kind, 0]["memory"]["argument_bytes"]
            > counted[variant, kind, 1]["memory"]["argument_bytes"])
    if kind != "train":
        assert (counted[variant, kind, 0]["collective_log"]
                == counted[variant, kind, 1]["collective_log"])
