"""The KV cache cut by sequence over "model" (``shard_kv_seq``, the
dry-run's ``kvseq``) on gloo ranks of the CPU
(``repro_torch.launch.mesh.run_world``): reduced tinyllama (GQA, heads
cut over "model"), qwen2-vl (M-RoPE) and deepseek-v2-lite (MLA's
latent cache, expert parallelism at a capacity factor that drops
nothing) on the (1,4) and (2,2) meshes, in one world of 4 ranks.

Each rank holds every KV head of its ``CACHE / m`` positions.  After a
prefill of ``S`` tokens each row's length is set to one of ``LENGTHS``
(the state after a prefill of ``S`` tokens, read up to ``n``, is the
state after a prefill of the first ``n``: the layers are causal), so
that ``STEPS`` decode steps write rows that cross the slices'
boundaries while some ranks hold no valid row of a sequence.  Held
against the port in one process and the reference's ``decode_step``
on the same state: logits within ``TOL`` x max |logits|.  Also: the
serving engine's tokens, a capacity that does not divide, the full-cache
raise, the decode kernels' log-sum-exp against a float64 one of the
scores, and the dry-run counter's collectives and held bytes against
every rank's on (2,2), exactly.
"""

import dataclasses
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
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import run_world
from repro_torch.models import transformer as tf

MESHES = ((1, 4), (2, 2))
#: the reduced configs' overrides (deepseek as tests/test_torch_tp.py
#: runs it: expert parallelism that drops nothing computes the dense
#: oracle)
ARCHS = {"tinyllama-1.1b": {},
         "qwen2-vl-72b": {},
         "deepseek-v2-lite-16b": {"moe_impl": "ep", "capacity_factor": 8.0}}
B, S, CACHE, STEPS = 4, 24, 32, 8
#: each row's length after the prefill: on (1,4) (8 rows a rank) row 0
#: leaves ranks 1-3 empty and then crosses into rank 1, row 1 starts on
#: a boundary, row 3 ends at the cache's last row
LENGTHS = (3, 8, 13, 24)
TOL = 1e-5
ENGINE = {"max_batch": 4, "cache_len": 24, "max_new_tokens": 4,
          "eos_token": -1}
PROMPTS = ([5, 9, 2, 7, 1], [3, 3, 8], [11, 4, 6, 2, 9, 1, 7],
           [2, 13], [6, 1, 1, 5])
KINDS = {"prefill": "prefill_32k", "decode": "decode_32k"}
#: the exact-count cells' configs (deepseek: a head dim of 16 + 16, one
#: the attention kernel's meta branch takes), with random weights
EXACT = {arch: dict(over, **({"rope_head_dim": 16} if "deepseek" in arch
                             else {}))
         for arch, over in ARCHS.items()}


def _seq(cfg):
    return dataclasses.replace(cfg, shard_kv_seq=True)


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
    """(reference config, numpy tree, port config with shard_kv_seq)."""
    rcfg = ref_get_config(arch).reduced()
    params, _ = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    _perturb(tree, np.random.default_rng(1))
    return rcfg, tree, _seq(get_config(arch).reduced(**ARCHS[arch]))


def _inputs(arch: str) -> dict:
    _, _, cfg = _weights(arch)
    rng = np.random.default_rng(7)
    batch = {"tokens": rng.integers(1, cfg.vocab_size, (B, S)).astype(
        np.int32)}
    if cfg.family == "vlm":
        t = np.zeros((3, S), np.int32)
        for n, (i, j) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1)), 1):
            t[:, n] = (1, 1 + i, 1 + j)
        t[:, 5:] = 3 + np.arange(S - 5)
        batch["positions"] = np.broadcast_to(t[:, None], (3, B, S)).copy()
    feed = rng.integers(1, cfg.vocab_size, (STEPS, B)).astype(np.int32)
    return {"batch": batch, "feed": feed}


def _decode(params, cfg, inp, rt):
    """[prefill logits, decode logits...] as numpy over every row and the
    whole vocab, each row's length set to LENGTHS after the prefill;
    then the message of a step with every row's cache full (None: no
    raise)."""
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

    with torch.no_grad():
        logits, state = tf.prefill(params, cfg, rows(inp["batch"]), CACHE,
                                   rt=rt)
        out = [full(logits)]
        state["lengths"] = rows({"n": np.asarray(LENGTHS, np.int32)})["n"]
        for tok in inp["feed"]:
            logits, state = tf.decode_step(params, cfg, state,
                                           rows({"t": tok})["t"], rt=rt)
            out.append(full(logits))
        state["lengths"] = torch.full_like(state["lengths"], CACHE)
        try:
            tf.decode_step(params, cfg, state, rows({"t": tok})["t"], rt=rt)
            raised = None
        except ValueError as e:
            raised = str(e)
    return out, raised


def _serve(cfg, params, rt):
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    engine = ServingEngine(cfg, params, EngineConfig(**ENGINE), rt)
    for prompt in PROMPTS[:3]:
        engine.submit(prompt)
    engine.step()
    for prompt in PROMPTS[3:]:
        engine.submit(prompt)
    return {r.rid: list(r.generated) for r in engine.run_to_completion()}


def _held(*trees) -> int:
    from repro_torch.launch._count import tensors_of

    seen = {}
    for t in tensors_of(trees):
        st = t.untyped_storage()
        seen[st.data_ptr(), st.nbytes()] = st.nbytes()
    return sum(seen.values())


def _exact(arch: str, rt) -> dict:
    """{kind: (collective log, bytes held)} of one prefill and one decode
    step of ``arch``'s EXACT config at the counted cells' shapes."""
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import log_collectives, shard_tree

    cfg = _seq(get_config(arch).reduced(**EXACT[arch]))
    params = shard_tree(tf.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"),
        tf.param_placements(cfg, rt))
    rng = np.random.default_rng(3)
    host = {"tokens": rng.integers(1, cfg.vocab_size, (B, CACHE)).astype(
        np.int32)}
    if cfg.family == "vlm":
        host["positions"] = np.broadcast_to(
            np.arange(CACHE, dtype=np.int32), (3, B, CACHE)).copy()
    batch = make_global_batch(host, rt.mesh)
    out = {}
    held = _held(params, batch)
    with torch.no_grad(), log_collectives() as log:
        tf.prefill(params, cfg, batch, cache_len=CACHE, rt=rt)
    out["prefill"] = (list(log), held)
    with torch.no_grad():
        _, state = tf.prefill(params, cfg,
                              {"tokens": batch["tokens"][:, :4]},
                              cache_len=CACHE, rt=rt)
        tokens = batch["tokens"][:, 0].contiguous()
        held = _held(params, state, tokens)
        with log_collectives() as log:
            tf.decode_step(params, cfg, state, tokens,
                           live=[True] * tokens.shape[0], rt=rt)
    out["decode"] = (list(log), held)
    return out


def _kvseq_rank(rank: int, jobs: dict) -> dict:
    """Every arch on each mesh of MESHES: the decode run, the engine
    (tinyllama), the non-dividing capacity, and on (2,2) the exact
    counts."""
    from repro_torch.launch.mesh import make_mesh

    out = {}
    for shape in MESHES:
        mesh = make_mesh(shape, device="cpu")
        rt = tf.Runtime(mesh)
        for arch, job in jobs.items():
            cfg = _seq(get_config(arch).reduced(**ARCHS[arch]))
            params = shard_lm_params(job["tree"], cfg, rt)
            res = {"decode": _decode(params, cfg, job, rt)}
            if arch == "tinyllama-1.1b":
                res["engine"] = _serve(cfg, params, rt)
                try:
                    tf.prefill(params, cfg, {"tokens": torch.ones(
                        (B // shape[0], 5), dtype=torch.int32)}, 31, rt=rt)
                    res["odd"] = None
                except ValueError as e:
                    res["odd"] = str(e)
            if shape == (2, 2):
                res["exact"] = _exact(arch, rt)
            out[shape, arch] = res
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    jobs = {arch: {"tree": _weights(arch)[1], **_inputs(arch)}
            for arch in ARCHS}
    return run_world(_kvseq_rank, 4, tmp_path_factory.mktemp("kvseq"),
                     jobs, deadline_s=600, timeout_s=120)


@functools.lru_cache(maxsize=None)
def _one_process(arch: str):
    _, tree, cfg = _weights(arch)
    cfg = dataclasses.replace(cfg, moe_impl="dense")
    params = lm_params_from_numpy(tree, cfg, "cpu")
    out = {"decode": _decode(params, cfg, _inputs(arch), None)}
    if arch == "tinyllama-1.1b":
        out["engine"] = _serve(cfg, params, None)
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch: str) -> list:
    """The reference's single-device logits on the same states."""
    rcfg, tree, _ = _weights(arch)
    inp = _inputs(arch)
    params = jax.tree.map(jnp.asarray, tree)
    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    rt = ref_tf.Runtime()
    logits, state = jax.jit(ref_tf.prefill, static_argnums=(1, 3, 4))(
        params, rcfg, batch, rt, CACHE)
    out = [np.asarray(logits)]
    state = dict(state, lengths=jnp.asarray(LENGTHS, jnp.int32))
    dec = jax.jit(ref_tf.decode_step, static_argnums=(1, 4))
    for tok in inp["feed"]:
        logits, state = dec(params, rcfg, state, jnp.asarray(tok), rt)
        out.append(np.asarray(logits))
    return out


CASES = [(arch, shape) for arch in ARCHS for shape in MESHES]
IDS = [f"{arch}-{shape[0]}x{shape[1]}" for arch, shape in CASES]


def _close(got: list, want: list) -> None:
    for g, w in zip(got, want, strict=True):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= TOL * np.abs(w).max()


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_kvseq_decode_matches_one_process(world, arch, shape):
    want, want_raised = _one_process(arch)["decode"]
    for res in world:
        got, raised = res[shape, arch]["decode"]
        _close(got, want)
        assert raised == want_raised


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_kvseq_decode_matches_the_reference(world, arch, shape):
    want = _reference(arch)
    for res in world:
        _close(res[shape, arch]["decode"][0], want)


@pytest.mark.parametrize("arch,shape", CASES, ids=IDS)
def test_the_full_cache_still_raises_naming_the_slot(world, arch, shape):
    """A step without ``live`` whose every row's cache is full raises
    on every rank for its first slot, naming the whole cache's end, cut
    by sequence or not."""
    for res in world:
        raised = res[shape, arch]["decode"][1]
        assert raised is not None and "slot 0" in raised
        assert f"ends at {CACHE}" in raised


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_kvseq_engine_serves_the_tokens_of_one_process(world, shape):
    want = _one_process("tinyllama-1.1b")["engine"]
    assert sorted(want) == list(range(len(PROMPTS)))
    for res in world:
        assert res[shape, "tinyllama-1.1b"]["engine"] == want


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_a_capacity_that_does_not_divide_raises(world, shape):
    for res in world:
        msg = res[shape, "tinyllama-1.1b"]["odd"]
        assert msg is not None and "31 rows" in msg
        assert f"{shape[1]} ranks" in msg


# ------------------------------------------------------- exact counts

@pytest.fixture(scope="module")
def counted():
    real = configs.get_config
    configs.get_config = lambda arch: real(arch).reduced(**EXACT[arch])
    try:
        return {(arch, kind): dryrun.count_cell(
            arch, ShapeCell(KINDS[kind], CACHE, B, kind),
            {"shard_kv_seq": True}, "pod2x2")
            for arch in ARCHS for kind in KINDS}
    finally:
        configs.get_config = real


EXACT_CASES = [(arch, kind) for arch in ARCHS for kind in KINDS]


@pytest.mark.parametrize("arch,kind", EXACT_CASES,
                         ids=[f"{a}-{k}" for a, k in EXACT_CASES])
def test_counter_equals_the_ranks_on_2x2(world, counted, arch, kind):
    want = counted[arch, kind]
    for res in world:
        log, held = res[(2, 2), arch]["exact"][kind]
        assert log == want["collective_log"]
        assert held == want["memory"]["argument_bytes"]
    if kind == "decode":
        kinds = [k for k, _, _ in want["collective_log"]]
        assert "all-reduce" in kinds and "all-gather" in kinds


def test_kvseq_cache_bytes_a_device_on_pod16x16():
    """tinyllama's, qwen2-7b's and whisper's self-attention caches and
    deepseek's latent cache at decode_32k: the whole cache over (batch
    shards x 16) a device, exactly; whisper's cross cache keeps its
    cut."""
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    cell = configs.SHAPES["decode_32k"]
    for arch in ("tinyllama-1.1b", "qwen2-7b", "whisper-large-v3",
                 "deepseek-v2-lite-16b"):
        cfg = _seq(get_config(arch))
        whole = sp._decode_state(cfg, cell, mesh)
        local, _ = sp.decode_state_specs(cfg, cell, mesh)
        keys = ("ckv", "krope") if cfg.is_mla else ("k", "v")
        for key in keys:
            n = whole[key].numel() * whole[key].element_size()
            got = local[key].numel() * local[key].element_size()
            assert got * 16 * 16 == n, (arch, key)
        if "xk" in whole:
            assert local["xk"].shape == whole["xk"].shape[:1] + (
                whole["xk"].shape[1] // 16,) + whole["xk"].shape[2:]


# ------------------------------------------------ the kernels' lse

def _lse64(q, k, length, scale) -> np.ndarray:
    """float64 log-sum-exp of ``q · k`` times ``scale`` over each row's
    valid positions (``-1e30`` for none)."""
    qd, kd = q.double(), k.double()
    g = q.shape[1] // k.shape[2]
    kd = kd.repeat_interleave(g, dim=2)             # [B, S, H, D]
    s = torch.einsum("bhd,bshd->bhs", qd, kd) * scale
    out = np.full(q.shape[:2], -1e30)
    for b, n in enumerate(length.tolist()):
        n = min(n, k.shape[1])
        if n:
            out[b] = torch.logsumexp(s[b, :, :n], dim=-1).numpy()
    return out


@pytest.mark.parametrize("n_split", [1, 3, 8])
def test_decode_lse_matches_a_float64_log_sum_exp(n_split):
    gen = torch.Generator().manual_seed(0)
    b, s, kh, h, d = 5, 200, 2, 8, 32
    q = torch.randn(b, h, d, generator=gen)
    k = torch.randn(b, s, kh, d, generator=gen)
    v = torch.randn(b, s, kh, d, generator=gen)
    length = torch.tensor([200, 1, 64, 0, 333], dtype=torch.int32)
    want = _lse64(q, k, length, fd.softmax_scale(d))
    split = functools.partial(fd.flash_decode_split_plain, n_split=n_split)
    for fn in (split, fd.flash_decode_plain):
        out, lse = fn(q, k, v, length, with_lse=True)
        assert lse.dtype == torch.float32 and lse.shape == (b, h)
        live = length.numpy() > 0
        err = np.abs(lse.numpy()[live] - want[live])
        assert err.max() <= 1e-5 * np.abs(want[live]).max()
        assert np.all(lse.numpy()[~live] == np.float32(fd.NEG_INF))
        # the output is the one without lse, bit for bit
        assert torch.equal(out, fn(q, k, v, length))


def test_mla_decode_lse_matches_a_float64_log_sum_exp():
    gen = torch.Generator().manual_seed(1)
    b, s, h, r, dr = 4, 300, 6, 32, 8
    q_lat, q_rope = torch.randn(b, h, r, generator=gen), \
        torch.randn(b, h, dr, generator=gen)
    ckv, krope = torch.randn(b, s, r, generator=gen), \
        torch.randn(b, s, dr, generator=gen)
    length = torch.tensor([300, 0, 33, 129], dtype=torch.int32)
    q, k, _ = fd.mla_operands(q_lat, q_rope, ckv, krope)
    want = _lse64(q, k, length, fd.softmax_scale(r + dr))
    live = length.numpy() > 0
    for out, lse in (fd.flash_decode_mla_split_plain(
            q_lat, q_rope, ckv, krope, length, 132, with_lse=True),
            fd.flash_decode_mla(q_lat, q_rope, ckv, krope, length,
                                with_lse=True)):
        err = np.abs(lse.numpy()[live] - want[live])
        assert err.max() <= 1e-5 * np.abs(want[live]).max()
        assert np.all(lse.numpy()[~live] == np.float32(fd.NEG_INF))


def test_merged_slices_equal_the_whole_cache():
    """Four slices' outputs merged by their lse equal one decode over the
    whole cache; a row that no slice holds gives zeros."""
    gen = torch.Generator().manual_seed(2)
    b, s, kh, h, d, m = 4, 64, 2, 8, 16, 4
    q = torch.randn(b, h, d, generator=gen)
    k = torch.randn(b, s, kh, d, generator=gen)
    v = torch.randn(b, s, kh, d, generator=gen)
    length = torch.tensor([64, 5, 0, 33], dtype=torch.int32)
    rows = s // m
    parts = [fd.flash_decode(q, k[:, r * rows:(r + 1) * rows],
                             v[:, r * rows:(r + 1) * rows],
                             (length - r * rows).clamp(0, rows).to(
                                 torch.int32), with_lse=True)
             for r in range(m)]
    outs = torch.stack([o for o, _ in parts])
    lses = torch.stack([x for _, x in parts])
    top = lses.amax(0)
    w = torch.exp(lses - top)[..., None]
    want = fd.flash_decode(q, k, v, length)
    got = fd.merge_partials(outs[0], lses[0], lambda t: top,
                            lambda t: torch.cat([(outs.float() * w).sum(0),
                                                 w.sum(0)], dim=-1))
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()
    assert torch.all(got[2] == 0)


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("variant", ["kvseq", "kvseqdonate"])
def test_kvseq_records_at_full_width(variant, mesh, tmp_path, monkeypatch):
    """``run_cell(..., variant=)`` at decode_32k: an OK record under the
    variant's own name whose argument bytes are the parameters', the
    state's (the cache cut by sequence) and the tokens' blocks; its
    cache a device the whole cache over (batch shards x 16)."""
    from repro_torch.launch import specs as sp
    from repro_torch.models.module import param_bytes

    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    arch = "tinyllama-1.1b"
    rec = dryrun.run_cell(arch, "decode_32k", mesh=mesh, variant=variant)
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["variant"] == variant and rec["mesh"] == mesh
    grid = dryrun.mesh_named(mesh)
    cell = configs.SHAPES["decode_32k"]
    cfg = _seq(get_config(arch))
    state, _ = sp.decode_state_specs(cfg, cell, grid)
    whole = sp._decode_state(cfg, cell, grid)
    params, _ = sp.abstract_model(cfg, grid)
    tokens, _ = sp.decode_token_specs(cell, grid)
    assert rec["memory"]["argument_bytes"] == (
        param_bytes(params) + param_bytes(state)
        + tokens.numel() * tokens.element_size())
    shards = grid.size // 16
    for key in ("k", "v"):
        assert param_bytes(state[key]) * shards * 16 == \
            param_bytes(whole[key])
    assert rec["collectives_raw"]["counts"]["all-gather"] > 0
