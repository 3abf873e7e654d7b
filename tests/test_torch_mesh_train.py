"""Data-parallel training over a mesh of ranks, on 4 (and 2) gloo ranks
(``repro_torch.launch.mesh.run_world``), against the reference:
``param_specs`` and ``_zero_spec`` on every family's reduced tree;
``make_global_batch`` (each rank's rows against that device's
addressable shard) and the compressed all-reduces (``compressed_psum``, ``make_compressed_allreduce``)
against the reference on a 4-device host mesh (one subprocess with
``--xla_force_host_platform_device_count=4``); the ZeRO-2 train step
(tinyllama-1.1b on a ``"data"`` mesh of 4; deepseek-v2-lite expert-
parallel on (2,2) at a capacity factor that drops nothing) against the
reference's one-device train step with the same global batches, ZeRO on
and off bit for bit; a checkpoint saved on (2,2) restored onto a mesh of
2; and the crash-at-7 drill resumed on 2 ranks against a clean 4-rank
run.

Tolerances: the int8 all-reduce bit for bit; bf16 and ``none`` within
the rounding of an n-term sum in the wire's dtype taken in another
order, n - 1 units in the last place of the sum of the terms'
magnitudes (the backend and XLA each pick their order); train losses within 1e-5
relative and parameters within 1e-4 x max |p| of the reference; the
drill's losses within 1e-5 relative (the reference drill's).
"""

import dataclasses
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
from repro.train import optimizer as ref_opt
from repro.train import trainer as ref_trainer
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import run_world
from repro_torch.models.transformer import param_specs
from repro_torch.train import optimizer as opt

REPO = pathlib.Path(__file__).resolve().parents[1]
DP_STEPS, DP_BATCH, DP_SEQ = 4, 8, 16
EP_CF = 8.0                     # no (token, choice) pair drops
EP_LR = 1e-3
MODES = ("int8", "bf16", "none")

REF_SCRIPT = textwrap.dedent("""
    import pickle, sys, warnings
    warnings.filterwarnings("ignore")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.data.pipeline import make_global_batch
    from repro.train.grad_compress import (compressed_psum,
                                           make_compressed_allreduce)

    inp = pickle.load(open(sys.argv[1], "rb"))
    out = {"batch": {}, "psum": {}, "tree": {}}

    def by_coords(mesh, arr):
        got = {}
        for idx in np.ndindex(mesh.devices.shape):
            dev = mesh.devices[idx]
            shard = [s for s in arr.addressable_shards if s.device == dev]
            got[idx] = np.asarray(shard[0].data)
        return got

    for names, shape in inp["batch_meshes"]:
        mesh = jax.make_mesh(shape, names,
                             axis_types=(jax.sharding.AxisType.Auto,)
                             * len(names))
        placed = make_global_batch(inp["batch"], mesh)
        out["batch"][(names, shape)] = {
            k: by_coords(mesh, v) for k, v in placed.items()}

    for shape in ((2, 2), (4, 1)):
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        n = shape[0]
        for mode in inp["modes"]:
            g = inp["grads"][:n].reshape(-1, *inp["grads"].shape[2:])
            f = shard_map(lambda b: compressed_psum(b, "data", mode=mode),
                          mesh=mesh, in_specs=P("data", None),
                          out_specs=P("data", None), check_rep=False)
            out["psum"][(shape, mode)] = np.asarray(jax.jit(f)(g))
            reduce = make_compressed_allreduce(mesh, axis="data", mode=mode)
            cat = {k: np.concatenate(v[:n]) for k, v in
                   inp["tree_reduced"].items()}
            # (a 0-d leaf raises IndexError in the reference's rule, which
            # reads shape[0] before ndim; the port leaves it as it is)
            got = jax.jit(reduce)(cat)
            out["tree"][(shape, mode)] = {
                k: np.asarray(v) for k, v in got.items()}
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _tuple_tree(tree):
    """A reference spec tree with each ``P`` as a tuple."""
    if isinstance(tree, dict):
        return {k: _tuple_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tuple_tree(v) for v in tree]
    return tuple(tree)


def _ref_abstract(arch):
    rcfg = ref_get_config(arch).reduced()
    shapes, specs = ref_tf.abstract(rcfg)
    return shapes, specs


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch):
    _, specs = _ref_abstract(arch)
    assert param_specs(get_config(arch).reduced()) == _tuple_tree(specs)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero_spec_matches_the_reference(arch):
    shapes, specs = _ref_abstract(arch)
    flat_shapes = jax.tree.leaves(shapes)
    flat_specs = jax.tree.leaves(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert len(flat_shapes) == len(flat_specs)
    for sd, spec in zip(flat_shapes, flat_specs):
        for data in (2, 4, 16):
            want = ref_opt._zero_spec(spec, sd.shape, data)
            got = opt._zero_spec(tuple(spec), sd.shape, data)
            assert got == tuple(want), (spec, sd.shape, data)


# ------------------------------------------------------------ the ranks

def _collective_rank(rank, inp):
    """make_global_batch on every batch mesh; compressed_psum and
    make_compressed_allreduce over ``"data"`` on (2,2) and (4,1)."""
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.grad_compress import (
        compressed_psum,
        make_compressed_allreduce,
    )

    out = {"batch": {}, "psum": {}, "tree": {}}
    for names, shape in inp["batch_meshes"]:
        mesh = make_mesh(shape, names, device="cpu")
        rows = make_global_batch(inp["batch"], mesh)
        out["batch"][(names, shape)] = (
            mesh.coords, {k: v.numpy() for k, v in rows.items()})
    for shape in ((2, 2), (4, 1)):
        mesh = make_mesh(shape, device="cpu")
        i = mesh.coord("data")
        for mode in inp["modes"]:
            g = torch.from_numpy(inp["grads"][i])
            out["psum"][(shape, mode)] = (
                mesh.coords, compressed_psum(g, mesh.group("data"),
                                             mode=mode).numpy())
            reduce = make_compressed_allreduce(mesh, axis="data", mode=mode)
            mine = {k: torch.from_numpy(v[i])
                    for k, v in inp["tree_reduced"].items()}
            scalar = torch.tensor(2.5)
            out["tree"][(shape, mode)] = (
                mesh.coords,
                {k: v.numpy() for k, v in reduce(mine).items()},
                reduce({"e": scalar})["e"] is scalar)
    return out


def _train_rank(rank, inp):
    """The ZeRO-2 step on 4 ranks, ZeRO on and off: tinyllama on a
    ``"data"`` mesh of 4, deepseek-v2-lite expert-parallel on (2,2);
    the losses, the full parameters and each rank's moment bytes; then
    a checkpoint of the deepseek state saved from (2,2)."""
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_lm_params
    from repro_torch.launch.mesh import gather_tree, make_mesh
    from repro_torch.models.transformer import Runtime
    from repro_torch.train._tree import leaves
    from repro_torch.train.checkpoint import save_checkpoint
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import (
        TrainConfig,
        make_train_step,
        train_placements,
    )

    out = {}
    for name, shape in (("dense", (4, 1)), ("ep", (2, 2))):
        job = inp[name]
        cfg = dataclasses.replace(get_config(job["arch"]).reduced(),
                                  **job["overrides"])
        mesh = make_mesh(shape, device="cpu")
        rt = Runtime(mesh)
        for zero in (True, False):
            tcfg = TrainConfig(optimizer=AdamWConfig(
                lr=job["lr"], warmup_steps=1, total_steps=DP_STEPS,
                zero_shard=zero))
            pl = train_placements(cfg, tcfg, rt)
            params = shard_lm_params(job["params"], cfg, rt)
            state = adamw_init(params, tcfg.optimizer,
                               placements=pl["params"])
            step = make_train_step(cfg, tcfg, rt)
            losses = []
            for batch in job["batches"]:
                params, state, metrics = step(params, state, batch)
                losses.append(float(metrics["loss"]))
            full = gather_tree(params, pl["params"])
            moments = leaves(state["m"]) + leaves(state["v"])
            out[(name, zero)] = {
                "losses": losses,
                "params": [p.numpy() for p in leaves(full)],
                "moment_bytes": sum(m.numel() * m.element_size()
                                    for m in moments)}
            if name == "ep" and zero:
                tree = {"params": params, "opt": state}
                save_checkpoint(inp["ckpt"], 1, tree, meta={"k": 1},
                                placements=pl)
                out["saved"] = [t.numpy() for t in leaves(
                    gather_tree(tree, pl))]
    return out


def _restore_rank(rank, inp):
    """The deepseek state saved from (2,2), restored onto a ``"data"``
    mesh of 2: this rank's blocks and the full arrays they gather to."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import gather_tree, make_mesh
    from repro_torch.models.transformer import Runtime, init_params
    from repro_torch.train._tree import leaves
    from repro_torch.train.checkpoint import restore_checkpoint
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.trainer import TrainConfig, train_placements

    job = inp["ep"]
    cfg = dataclasses.replace(get_config(job["arch"]).reduced(),
                              **job["overrides"])
    rt = Runtime(make_mesh((2, 1), device="cpu"))
    tcfg = TrainConfig(optimizer=AdamWConfig(zero_shard=True))
    pl = train_placements(cfg, tcfg, rt)
    example = {"params": init_params(cfg, torch.Generator(), "cpu")}
    example["opt"] = adamw_init(example["params"], tcfg.optimizer)
    tree, meta = restore_checkpoint(inp["ckpt"], 1, example,
                                    placements=pl)
    return {"meta": meta, "coords": rt.mesh.coords,
            "blocks": [t.numpy() for t in leaves(tree)],
            "full": [t.numpy() for t in leaves(gather_tree(tree, pl))]}


def _drill_rank(rank, inp, shape, crash_at):
    """run_elastic on a ``"data"`` mesh of ``shape`` (ZeRO on), crashing
    after ``crash_at`` where given."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.launch.mesh import gather_tree, make_mesh
    from repro_torch.models.transformer import Runtime
    from repro_torch.train._tree import leaves
    from repro_torch.train.elastic import (
        CrashRequested,
        ElasticRun,
        run_elastic,
    )
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, train_placements

    cfg = get_config("tinyllama-1.1b").reduced()
    tcfg = TrainConfig(optimizer=AdamWConfig(
        lr=1e-3, warmup_steps=2, total_steps=12, zero_shard=True))
    run = ElasticRun(cfg=cfg, tcfg=tcfg,
                     data=DataConfig(vocab_size=cfg.vocab_size,
                                     seq_len=16, global_batch=8),
                     ckpt_dir=pathlib.Path(inp["dir"]), ckpt_every=3)
    rt = Runtime(make_mesh(shape, device="cpu"))
    try:
        res = run_elastic(run, total_steps=12, rt=rt, crash_at=crash_at,
                          device="cpu")
    except CrashRequested:
        return "crashed"
    pl = train_placements(cfg, tcfg, rt)["params"]
    return {"history": res["history"], "resumed_from": res["resumed_from"],
            "params": [p.numpy() for p in leaves(
                gather_tree(res["params"], pl))]}


# ------------------------------------------------------------- fixtures

def _ref_weights(arch, overrides):
    rcfg = dataclasses.replace(ref_get_config(arch).reduced(), **overrides)
    params, specs = ref_tf.init_params(rcfg, jax.random.PRNGKey(0))
    return rcfg, params, specs, jax.tree.map(np.asarray, params)


def _ref_train(rcfg, params, specs, batches, lr):
    """The reference's one-device train step over ``batches``."""
    ocfg = ref_opt.AdamWConfig(lr=lr, warmup_steps=1,
                               total_steps=DP_STEPS)
    state, _ = ref_opt.adamw_init(params, specs, ocfg)
    step = jax.jit(ref_trainer.make_train_step(
        rcfg, ref_trainer.TrainConfig(optimizer=ocfg), ref_tf.Runtime()))
    losses = []
    for b in batches:
        params, state, metrics = step(params, state,
                                      {k: jnp.asarray(v) for k, v in
                                       b.items()})
        losses.append(float(metrics["loss"]))
    return losses, [np.asarray(p) for p in jax.tree.leaves(params)]


def _batches(vocab, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(DP_STEPS):
        toks = rng.integers(0, vocab, (DP_BATCH, DP_SEQ + 1))
        labels = toks[:, 1:].astype(np.int32)
        labels[1, :3] = -1
        out.append({"tokens": toks[:, :-1].astype(np.int32),
                    "labels": labels})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_train")
    rng = np.random.default_rng(0)
    coll = {
        "batch_meshes": [(("data", "model"), (2, 2)),
                         (("data", "model"), (4, 1)),
                         (("data", "model"), (1, 4)),
                         (("pod", "data", "model"), (2, 2, 1))],
        "batch": {"tokens": rng.integers(0, 99, (8, 5)).astype(np.int32),
                  "odd": rng.standard_normal((6, 3)).astype(np.float32)},
        "modes": MODES,
        "grads": (rng.standard_normal((4, 8, 5)) * np.array(
            [1.0, 3.0, 0.01, 50.0])[:, None, None]).astype(np.float32),
        # a rank's block of each leaf (the first axis): every one is
        # reduced, whether or not its own first axis divides by n
        "tree_reduced": {
            "a": rng.standard_normal((4, 8, 3)).astype(np.float32),
            "b": rng.standard_normal((4, 4)).astype(np.float32),
            "c": rng.standard_normal((4, 3, 5)).astype(np.float32),
            "d": rng.standard_normal((4, 5, 2)).astype(np.float32),
            "f": rng.standard_normal((4, 1, 4)).astype(np.float32)}}
    (root / "in.pkl").write_bytes(pickle.dumps(coll))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = str(REPO / "src")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(root / "in.pkl"),
         str(root / "ref.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        jobs = {}
        ref_train = {}
        for name, arch, overrides, lr in (
                ("dense", "tinyllama-1.1b", {}, 1e-2),
                ("ep", "deepseek-v2-lite-16b",
                 {"moe_impl": "ep", "capacity_factor": EP_CF}, EP_LR)):
            rcfg, params, specs, tree = _ref_weights(arch, overrides)
            batches = _batches(rcfg.vocab_size, 11)
            jobs[name] = {"arch": arch, "overrides": overrides,
                          "params": tree, "batches": batches, "lr": lr}
            dense = dataclasses.replace(rcfg, moe_impl="dense") \
                if rcfg.is_moe else rcfg
            ref_train[name] = _ref_train(dense, params, specs, batches, lr)
        jobs["ckpt"] = str(root / "ckpt")
        port = {
            "coll": run_world(_collective_rank, 4,
                                           root / "coll", coll),
            "train": run_world(_train_rank, 4, root / "train",
                                            jobs),
            "restore": run_world(_restore_rank, 2,
                                              root / "restore", jobs)}
        drill = {"dir": str(root / "drill_clean")}
        port["clean"] = run_world(
            _drill_rank, 4, root / "clean", drill, (4, 1), None)
        drill = {"dir": str(root / "drill")}
        port["crash"] = run_world(
            _drill_rank, 4, root / "crash", drill, (4, 1), 7)
        port["resume"] = run_world(
            _drill_rank, 2, root / "resume", drill, (2, 1), None)
        _, err = ref_proc.communicate(timeout=300)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.wait()
    assert ref_proc.returncode == 0, err[-3000:]
    ref = pickle.loads((root / "ref.pkl").read_bytes())
    return ref, coll, ref_train, port


def _sum_close(got, want, terms, mode, scale=1.0):
    """``got`` and ``want``, two sums of ``terms`` (``[n, ...]``) in the
    wire's dtype (bf16 for ``mode="bf16"``) times ``scale``, within the
    rounding of two orders of summation: each order rounds n - 1 partial
    sums, each by at most half a unit in the last place of the sum of
    the terms' magnitudes, so they differ by at most n - 1 such units."""
    wire = torch.from_numpy(np.ascontiguousarray(terms))
    if mode == "bf16":
        wire = wire.bfloat16()
    mag = wire.double().abs().sum(0).float().numpy()
    spacing = np.spacing(mag).astype(np.float64)
    if mode == "bf16":
        spacing *= 2.0 ** 16                # bf16 keeps 8 of float32's 24
    bound = (len(terms) - 1) * spacing * scale
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    return bool((diff <= bound).all())


@pytest.mark.parametrize("mesh", range(4))
def test_make_global_batch_matches_the_addressable_shards(runs, mesh):
    ref, coll, _, port = runs
    key = coll["batch_meshes"][mesh]
    want = ref["batch"][key]
    for res in port["coll"]:
        coords, rows = res["batch"][key]
        for name, arr in rows.items():
            exp = want[name][coords]
            assert arr.dtype == exp.dtype and arr.shape == exp.shape
            assert np.array_equal(arr, exp), (name, coords)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_compressed_psum_matches_the_reference(runs, shape, mode):
    ref, coll, _, port = runs
    want = ref["psum"][(shape, mode)]
    m = coll["grads"].shape[1]
    terms = coll["grads"][:shape[0]]
    for res in port["coll"]:
        coords, got = res["psum"][(shape, mode)]
        exp = want[coords[0] * m:(coords[0] + 1) * m]
        if mode == "int8":
            assert np.array_equal(got.view(np.uint32), exp.view(np.uint32))
        else:
            assert _sum_close(got, exp, terms, mode), \
                float(np.abs(got - exp).max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", [(2, 2), (4, 1)])
def test_compressed_allreduce_matches_the_reference(runs, shape, mode):
    ref, coll, _, port = runs
    reduced = ref["tree"][(shape, mode)]
    n = shape[0]
    for res in port["coll"]:
        coords, got, kept = res["tree"][(shape, mode)]
        assert kept                              # a 0-d leaf stays
        assert set(got) == set(reduced)
        for k, v in got.items():
            m = coll["tree_reduced"][k].shape[1]
            exp = reduced[k][coords[0] * m:(coords[0] + 1) * m]
            # every rank's block was reduced: it is no longer its input
            assert not np.array_equal(v, coll["tree_reduced"][k][coords[0]])
            if mode == "int8":
                assert np.array_equal(v.view(np.uint32),
                                      exp.view(np.uint32)), k
            else:
                assert _sum_close(v, exp, coll["tree_reduced"][k][:n],
                                  mode, 1.0 / n), k


@pytest.mark.parametrize("name", ["dense", "ep"])
def test_zero2_train_steps_match_the_reference(runs, name):
    """4 steps on 4 ranks against the reference's one-device step, and
    ZeRO on and off bit for bit; the moments take less memory a rank."""
    _, _, ref_train, port = runs
    want_losses, want_params = ref_train[name]
    for res in port["train"]:
        on, off = res[(name, True)], res[(name, False)]
        for got in (on, off):
            for a, b in zip(got["losses"], want_losses):
                assert a == pytest.approx(b, rel=1e-5)
            assert len(got["params"]) == len(want_params)
            for p, w in zip(got["params"], want_params):
                tol = 1e-4 * float(np.abs(w).max())
                assert float(np.abs(p - w).max()) <= tol
        assert on["losses"] == off["losses"]
        for p, q in zip(on["params"], off["params"]):
            assert np.array_equal(p.view(np.uint8), q.view(np.uint8))
        assert on["moment_bytes"] < off["moment_bytes"]


def test_restore_onto_another_mesh(runs):
    """A checkpoint of the expert-parallel ZeRO state saved from (2,2)
    restores onto a mesh of 2: each rank's blocks gather back to the
    arrays that were saved, bit for bit."""
    _, _, _, port = runs
    saved = port["train"][0]["saved"]
    for res in port["restore"]:
        assert res["meta"] == {"k": 1}
        assert len(res["full"]) == len(saved)
        for got, want in zip(res["full"], saved):
            assert got.dtype == want.dtype and np.array_equal(got, want)
        assert sum(b.size for b in res["blocks"]) < \
            sum(w.size for w in saved)


def test_mesh_change_drill(runs):
    """4 ranks crash after step 7, 2 ranks resume at 7: the losses and
    the final parameters of a clean 4-rank run."""
    _, _, _, port = runs
    assert port["crash"] == ["crashed"] * 4
    clean = port["clean"][0]
    for res in port["resume"]:
        assert res["resumed_from"] == 7
        want = {h["step"]: h["loss"] for h in clean["history"]}
        assert [h["step"] for h in res["history"]] == list(range(7, 12))
        for h in res["history"]:
            assert h["loss"] == pytest.approx(want[h["step"]], rel=1e-5)
        for p, w in zip(res["params"], clean["params"]):
            np.testing.assert_allclose(p, w, rtol=1e-5, atol=1e-6)
