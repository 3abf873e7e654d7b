"""Expert parallelism over a mesh of ranks: the port's ``moe_ffn_ep`` on
4 gloo ranks (``repro_torch.launch.mesh.run_world``) against the
reference's ``moe_ffn_ep`` on a 4-device host mesh (one subprocess with
``--xla_force_host_platform_device_count=4``, as tests/test_sharding.py
runs it), on the (2,2), (4,1) and (1,4) meshes, at capacity factors 8
(no drop), 1.0 and 0.5 (drops), for the native and the int8 wire; and
reduced deepseek-v2-lite with ``moe_impl="ep"`` on (2,2): the loss, every
gradient leaf, prefill and decode logits against the reference under
``Runtime(mesh)``; and the serving engine with ``rt`` on (2,2): its
tokens against the reference's engine under ``Runtime(mesh)``, and,
with a slot refilled mid-batch (which the reference's ``shard_map``
refuses on such a mesh), against the reference's one-device dense
engine at a capacity factor that drops nothing.

Tolerances: the native wire's output within 1e-5 x max |y|; the int8
wire's dispatched codes and scales bit for bit, its output within 1e-5
x max |y| plus one step of the combine wire's largest scale (a partial
product that rounds to the other side of a step); every gradient within
1e-4 x its largest |value| (both wires); the model's loss within 1e-5
relative, its gradients within 1e-4 x max |g|, its logits within 1e-4
x max |logits|; the engines' tokens identical.
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
from repro.models import moe as ref_moe
from repro.models.transformer import init_params as ref_init_params
from repro_torch.launch.mesh import run_world
from repro_torch.models import moe

REPO = pathlib.Path(__file__).resolve().parents[1]
MESHES = ((2, 2), (4, 1), (1, 4))
CFS = (8.0, 1.0, 0.5)
WIRES = ("native", "int8")
E, K, D, F, B, S = 8, 2, 16, 32, 4, 8
ARCH = "deepseek-v2-lite-16b"
TOKENS_B, TOKENS_S, CACHE, DECODE = 4, 12, 16, 2
INT8_CF = 8.0                               # the model's int8 wire drops nothing
ENGINE = {"max_batch": 4, "cache_len": 24, "max_new_tokens": 5,
          "eos_token": -1}                  # no token ends a request early


def serve(engine, waves):
    """Submit each wave of prompts, one engine step apart, and serve to
    the end: ``{rid: tokens}``."""
    for wave_index, wave in enumerate(waves):
        if wave_index:
            engine.step()
        for prompt in wave:
            engine.submit(prompt)
    return {r.rid: list(r.generated) for r in engine.run_to_completion()}


REF_SCRIPT = textwrap.dedent("""
    import dataclasses, pickle, sys, warnings
    warnings.filterwarnings("ignore")
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P, NamedSharding
    from repro.configs import get_config
    from repro.models import moe as moe_lib
    from repro.models import transformer as tf

    inp = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    records = []
    a2a = jax.lax.all_to_all

    def recording(t, axis_name, *args, **kw):
        call = len(calls)
        calls.append(call)
        jax.debug.callback(
            lambda v, i, j: records.append((call, int(i), int(j),
                                            np.asarray(v))),
            t, jax.lax.axis_index("data"), jax.lax.axis_index("model"))
        return a2a(t, axis_name, *args, **kw)

    m = inp["moe"]
    for shape in m["meshes"]:
        mesh = jax.make_mesh(shape, ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        for cf in m["cfs"]:
            for wire in m["wires"]:
                dims = moe_lib.MoeDims(m["E"], m["K"], m["D"], m["F"],
                                       capacity_factor=cf,
                                       dispatch_dtype=wire)

                def ep(x, wr, w1, w3, w2):
                    return moe_lib.moe_ffn_ep(x, wr, w1, w3, w2, dims, mesh,
                                              batch_axes=("data",))

                def loss(x, wr, w1, w3, w2):
                    return jnp.sum(ep(x, wr, w1, w3, w2) * m["r"])

                args = [m[k] for k in ("x", "wr", "w1", "w3", "w2")]
                with mesh:
                    y = jax.jit(ep)(*args)
                    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
                        *args)
                    res = {"y": np.asarray(y),
                           "g": [np.asarray(t) for t in g]}
                    if wire == "int8":
                        calls, records[:] = [], []
                        jax.lax.all_to_all = recording
                        try:
                            jax.block_until_ready(jax.jit(
                                lambda *a: moe_lib.moe_ffn_ep(
                                    *a, dims, mesh, batch_axes=("data",)))(
                                *args))
                        finally:
                            jax.lax.all_to_all = a2a
                        res["wire"] = list(records)
                out[(tuple(shape), cf, wire)] = res

    d = inp["model"]
    cfg = dataclasses.replace(get_config(d["arch"]).reduced(),
                              moe_impl="ep")
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rt = tf.Runtime(mesh=mesh)
    params = jax.tree.map(jnp.asarray, d["params"])
    batch = {k: jnp.asarray(v) for k, v in d["batch"].items()}
    with mesh:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: tf.forward_train(p, cfg, b, rt)))(params, batch)
        logits, state = jax.jit(lambda p, b: tf.prefill(
            p, cfg, b, rt, d["cache"]))(params, {"tokens": batch["tokens"]})
        steps = [np.asarray(logits)]
        dec = jax.jit(lambda p, s, t: tf.decode_step(p, cfg, s, t, rt))
        for tok in d["feed"]:
            logits, state = dec(params, state, jnp.asarray(tok))
            steps.append(np.asarray(logits))
    out["model"] = {"loss": float(loss),
                    "grads": jax.tree.map(np.asarray, grads),
                    "logits": steps}

    cfg8 = dataclasses.replace(cfg, moe_dispatch_dtype="int8",
                               capacity_factor=d["int8_cf"])
    with mesh:
        loss8 = jax.jit(lambda p, b: tf.forward_train(p, cfg8, b, rt))(
            params, batch)
        calls, records[:] = [], []
        jax.lax.all_to_all = recording
        try:
            logits8, _ = jax.jit(lambda p, b: tf.prefill(
                p, cfg8, b, rt, d["cache"]))(params,
                                             {"tokens": batch["tokens"]})
            jax.block_until_ready(logits8)
        finally:
            jax.lax.all_to_all = a2a
    out["int8"] = {"loss": float(loss8), "logits": np.asarray(logits8),
                   "wire": list(records)}

    from repro.serve.engine import EngineConfig, ServingEngine
    from test_torch_ep import serve

    ecfg = EngineConfig(**d["engine"])
    with mesh:
        out["engine"] = serve(ServingEngine(cfg, params, ecfg, rt),
                              [d["prompts"]])
    dense = dataclasses.replace(cfg, moe_impl="dense")
    out["refill"] = serve(ServingEngine(dense, params, ecfg), d["waves"])
    pickle.dump(out, open(sys.argv[2], "wb"))
""")


def _moe_inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {"meshes": MESHES, "cfs": CFS, "wires": WIRES,
            "E": E, "K": K, "D": D, "F": F,
            "x": rng.standard_normal((B, S, D)).astype(f32),
            "wr": (0.1 * rng.standard_normal((D, E))).astype(f32),
            "w1": rng.standard_normal((E, D, F)).astype(f32),
            "w3": rng.standard_normal((E, D, F)).astype(f32),
            "w2": rng.standard_normal((E, F, D)).astype(f32),
            "r": rng.standard_normal((B, S, D)).astype(f32)}


def _model_inputs() -> dict:
    rcfg = ref_get_config(ARCH).reduced()
    params, _ = ref_init_params(rcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(3)
    toks = rng.integers(1, rcfg.vocab_size, (TOKENS_B, TOKENS_S)) \
        .astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[0, :3] = -1
    prompts = [rng.integers(1, rcfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 3, 7, 4)]
    return {"arch": ARCH, "cache": CACHE, "int8_cf": INT8_CF,
            "params": jax.tree.map(np.asarray, params),
            "batch": {"tokens": toks, "labels": labels},
            "feed": [rng.integers(1, rcfg.vocab_size, TOKENS_B)
                     .astype(np.int32) for _ in range(DECODE)],
            "engine": ENGINE, "prompts": prompts[:4],
            # three slots, then two more: slot 3 and later slot 0 are
            # refilled while the others decode
            "waves": [prompts[:3], prompts[3:]]}


# ------------------------------------------------------------ the ranks

def _moe_rank(rank, inp):
    """Every (mesh, capacity factor, wire) on this rank: its output
    rows, its gradients and the payloads its all-to-alls were given."""
    from repro_torch.launch.mesh import Placement, make_mesh

    out = {}
    for shape in inp["meshes"]:
        mesh = make_mesh(shape, device="cpu")
        coords = (mesh.coord("data"), mesh.coord("model"))
        specs = {"x": ("data", None, None), "wr": (),
                 "w1": ("data", None, "model"),
                 "w3": ("data", None, "model"),
                 "w2": ("data", "model", None),
                 "r": ("data", None, None)}
        local = {k: Placement(mesh, spec).shard(torch.from_numpy(inp[k]))
                 for k, spec in specs.items()}
        for cf in inp["cfs"]:
            for wire in inp["wires"]:
                dims = moe.MoeDims(E, K, D, F, capacity_factor=cf,
                                   dispatch_dtype=wire)
                args = [local[k].clone().requires_grad_(True)
                        for k in ("x", "wr", "w1", "w3", "w2")]
                records = []
                inner = moe._all_to_all

                def recording(t, group):
                    records.append(t.detach().clone().numpy())
                    return inner(t, group)

                moe._all_to_all = recording
                try:
                    y = moe.moe_ffn_ep(*args, dims, mesh,
                                       batch_axes=("data",))
                    n_fwd = len(records)
                    grads = torch.autograd.grad(
                        (y * local["r"]).sum(), args)
                finally:
                    moe._all_to_all = inner
                out[(tuple(shape), cf, wire)] = {
                    "coords": coords, "y": y.detach().numpy(),
                    "g": [g.numpy() for g in grads],
                    "wire": records[:n_fwd]}
    return out


def _model_rank(rank, inp):
    """Reduced deepseek-v2-lite with EP on (2,2): the loss and the full
    gradients (summed over the batch axes, the expert blocks gathered)
    on every rank; this rank's prefill and decode logits; the serving
    engine's tokens, at the configuration's capacity factor and, with
    refills, at one that drops nothing."""
    from repro_torch.configs import get_config
    from repro_torch.convert import shard_lm_params
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import Placement, gather_tree, make_mesh
    from repro_torch.models.transformer import (
        Runtime,
        decode_step,
        param_placements,
        prefill,
    )
    from repro_torch.serve.engine import EngineConfig, ServingEngine
    from repro_torch.train._tree import leaves, unflatten
    from repro_torch.train.trainer import reduce_grads, value_and_grad

    cfg = dataclasses.replace(get_config(inp["arch"]).reduced(),
                              moe_impl="ep")
    mesh = make_mesh((2, 2), device="cpu")
    rt = Runtime(mesh)
    params = shard_lm_params(inp["params"], cfg, rt)
    batch = make_global_batch(inp["batch"], mesh)
    loss, grads = value_and_grad(params, cfg, batch, rt)
    placements = param_placements(cfg, rt)
    grads = reduce_grads(grads, placements)
    full = gather_tree(unflatten(params, grads), placements)
    logits, state = prefill(params, cfg, {"tokens": batch["tokens"]},
                            inp["cache"], rt=rt)
    # this rank's rows, over the vocab columns of every "model" rank
    vocab = Placement(mesh, (None, "model"))
    steps = [vocab.gather(logits).numpy()]
    for tok in inp["feed"]:
        mine = make_global_batch({"t": tok}, mesh)["t"]
        logits, state = decode_step(params, cfg, state, mine, rt=rt)
        steps.append(vocab.gather(logits).numpy())
    ecfg = EngineConfig(**inp["engine"])
    nodrop = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    return {"coords": (mesh.coord("data"), mesh.coord("model")),
            "int8": _int8_model(params, cfg, batch, inp, rt, vocab),
            "loss": float(loss),
            "grads": [g.numpy() for g in leaves(full)],
            "logits": steps,
            "engine": serve(ServingEngine(cfg, params, ecfg, rt),
                            [inp["prompts"]]),
            "refill": serve(ServingEngine(nodrop, params, ecfg, rt),
                            inp["waves"])}


def _int8_model(params, cfg, batch, inp, rt, vocab):
    """The int8 wire on the model at ``INT8_CF``: the loss, this rank's
    prefill logits over every vocab column, and the payloads prefill's
    all-to-alls were given (four a MoE layer: the dispatch's codes and
    scales, then the combine's)."""
    from repro_torch.models.transformer import forward_train, prefill

    cfg8 = dataclasses.replace(cfg, moe_dispatch_dtype="int8",
                               capacity_factor=inp["int8_cf"])
    with torch.no_grad():
        loss = forward_train(params, cfg8, batch, rt)
        records = []
        inner = moe._all_to_all

        def recording(t, group):
            records.append(t.detach().clone().numpy())
            return inner(t, group)

        moe._all_to_all = recording
        try:
            logits, _ = prefill(params, cfg8, {"tokens": batch["tokens"]},
                                inp["cache"], rt=rt)
        finally:
            moe._all_to_all = inner
    return {"loss": float(loss), "logits": vocab.gather(logits).numpy(),
            "wire": records}


# ------------------------------------------------------------- fixtures

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference results, port results by rank) of both worlds; the
    reference subprocess runs while the ranks do."""
    root = tmp_path_factory.mktemp("ep")
    inp = {"moe": _moe_inputs(), "model": _model_inputs()}
    (root / "in.pkl").write_bytes(pickle.dumps(inp))
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.pathsep.join((str(REPO / "src"),
                                         str(REPO / "tests")))
    ref = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(root / "in.pkl"),
         str(root / "ref.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        port_moe = run_world(_moe_rank, 4, root / "moe",
                                          inp["moe"])
        port_model = run_world(_model_rank, 4, root / "model",
                                            inp["model"])
        _, err = ref.communicate(timeout=300)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.wait()
    assert ref.returncode == 0, err[-3000:]
    return (pickle.loads((root / "ref.pkl").read_bytes()), inp,
            port_moe, port_model)


def _assemble(port, key, which, index=None):
    """The full array of output ``which`` (``"y"``) or gradient
    ``index`` from the ranks' blocks."""
    rows = {}
    for res in port:
        r = res[key]
        i, j = r["coords"]
        rows[(i, j)] = r[which] if index is None else r[which][index]
    ni = 1 + max(i for i, _ in rows)
    nj = 1 + max(j for _, j in rows)
    return ni, nj, rows


CASES = [(m, cf, w) for m in MESHES for cf in CFS for w in WIRES]


def _case_id(case):
    (a, b), cf, w = case
    return f"{a}x{b}-cf{cf:g}-{w}"


def _wire_step(records, calls):
    """The largest scale of the given all-to-all calls (0 for none)."""
    return max((float(np.max(v)) for c, _, _, v in records if c in calls),
               default=0.0)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_moe_ffn_ep_output_matches_reference(runs, case):
    ref, inp, port, _ = runs
    want = ref[case]["y"]
    ni, nj, blocks = _assemble(port, case, "y")
    for (i, j), y in blocks.items():
        rows = slice(i * (B // ni), (i + 1) * (B // ni))
        tol = 1e-5 * float(np.abs(want).max())
        if case[2] == "int8":
            tol += _wire_step(ref[case]["wire"], (3,))
        assert float(np.abs(y - want[rows]).max()) <= tol, (i, j)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_moe_ffn_ep_gradients_match_reference(runs, case):
    ref, inp, port, _ = runs
    names = ("x", "wr", "w1", "w3", "w2")
    specs = {"x": ("data", None, None), "wr": (),
             "w1": ("data", None, "model"), "w3": ("data", None, "model"),
             "w2": ("data", "model", None)}
    for n, name in enumerate(names):
        want = ref[case]["g"][n]
        tol = 1e-4 * float(np.abs(want).max())
        ni, nj, blocks = _assemble(port, case, "g", n)
        if name == "wr":
            # each rank's router gradient is its rows' share
            got = sum(blocks[(i, 0)] for i in range(ni))
            assert float(np.abs(got - want).max()) <= tol, name
            continue
        for (i, j), g in blocks.items():
            idx = []
            for axis, entry in enumerate(specs[name]):
                parts, at = {"data": (ni, i), "model": (nj, j),
                             None: (1, 0)}[entry]
                n_ax = want.shape[axis] // parts
                idx.append(slice(at * n_ax, (at + 1) * n_ax))
            assert float(np.abs(g - want[tuple(idx)]).max()) <= tol, \
                (name, i, j)


@pytest.mark.parametrize("case", [c for c in CASES if c[2] == "int8"],
                         ids=_case_id)
def test_int8_wire_payloads_are_bit_equal(runs, case):
    """The codes and scales each rank hands the dispatch all-to-all
    (calls 0 and 1 of the forward) are the reference's, bit for bit."""
    ref, _, port, _ = runs
    want = {(c, i, j): v for c, i, j, v in ref[case]["wire"]}
    for res in port:
        r = res[case]
        i, j = r["coords"]
        assert len(r["wire"]) == 4
        for call in (0, 1):
            got = r["wire"][call]
            exp = want[(call, i, j)]
            assert got.dtype == exp.dtype and got.shape == exp.shape
            assert np.array_equal(got.view(np.uint8), exp.view(np.uint8)), \
                (call, i, j)


def test_dispatch_indices_bit_equal_on_ties():
    """Routes full of repeated experts (every rank and drop decided by
    the stable order) give the reference's expert, rank and valid
    arrays."""
    rng = np.random.default_rng(7)
    for t, k, e, cap in ((32, 2, 4, 3), (17, 6, 8, 1), (64, 1, 2, 40),
                         (5, 3, 16, 2)):
        idx = rng.integers(0, max(2, e // 3), (t, k)).astype(np.int32)
        dims = moe.MoeDims(e, k, 8, 8)
        rdims = ref_moe.MoeDims(e, k, 8, 8)
        got = moe._dispatch_indices(torch.from_numpy(idx).long(), dims, cap)
        want = ref_moe._dispatch_indices(jnp.asarray(idx), rdims, cap)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


def test_deepseek_ep_loss_and_gradients_match_reference(runs):
    ref, inp, _, port = runs
    want = ref["model"]
    from repro_torch.train._tree import leaves

    wl = [np.asarray(w) for w in leaves(want["grads"])]
    for res in port:
        assert res["loss"] == pytest.approx(want["loss"], rel=1e-5)
        assert len(res["grads"]) == len(wl)
        for g, w in zip(res["grads"], wl):
            assert g.shape == w.shape
            tol = 1e-4 * float(np.abs(w).max())
            assert float(np.abs(g - w).max()) <= tol


def test_deepseek_ep_prefill_and_decode_match_reference(runs):
    ref, inp, _, port = runs
    want = ref["model"]["logits"]
    half = TOKENS_B // 2
    for res in port:
        i, _ = res["coords"]
        for step, (got, exp) in enumerate(zip(res["logits"], want)):
            exp = exp[i * half:(i + 1) * half]
            tol = 1e-4 * float(np.abs(exp).max())
            assert float(np.abs(got - exp).max()) <= tol, step


@pytest.mark.parametrize("which", ["engine", "refill"])
def test_deepseek_ep_serving_engine_matches_reference(runs, which):
    """``engine``: every request at once, against the reference's engine
    on the same mesh; ``refill``: slots refilled mid-batch on the mesh
    at a capacity factor that drops nothing, against the reference's
    one-device dense engine."""
    ref, inp, _, port = runs
    want = ref[which]
    assert sorted(want) == list(range(len(want)))
    for res in port:
        assert res[which] == want


def test_engine_on_a_mesh_needs_slots_that_divide():
    """The slots are sharded over the batch axes: ``max_batch`` must
    divide by their size, as the reference's ``shard_map`` requires of
    the batch."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import CardMesh
    from repro_torch.models.transformer import Runtime
    from repro_torch.serve.engine import EngineConfig, ServingEngine

    cfg = dataclasses.replace(get_config(ARCH).reduced(), moe_impl="ep")
    mesh = CardMesh(torch.device("cpu"), ("data", "model"), (2, 2))
    params = {"embed": torch.zeros(1)}
    with pytest.raises(ValueError, match="max_batch 3"):
        ServingEngine(cfg, params, EngineConfig(max_batch=3), Runtime(mesh))
    engine = ServingEngine(cfg, params, EngineConfig(max_batch=4),
                           Runtime(mesh))
    assert engine._rows == 2



def test_deepseek_int8_wire_on_ep_and_tp_matches_reference(runs):
    """The int8 wire under EP + TP on (2,2), where the shared experts
    are cut over "model": the loss and prefill logits match the
    reference's; every int8 code prefill hands an all-to-all is the
    reference's bit for bit and every scale within 1e-5 relative (the
    rows they quantize differ by rounding); and each combine payload is
    the same on both "model" ranks of a data line, since the wire
    quantizes the sum over "model", not each rank's partial."""
    ref, inp, _, port = runs
    want = ref["int8"]
    half = TOKENS_B // 2
    ref_wire = {}
    for call, i, j, v in want["wire"]:      # the layers in order
        ref_wire.setdefault((call, i, j), []).append(v)
    by_coords = {}
    for res in port:
        got = res["int8"]
        i, j = res["coords"]
        by_coords[i, j] = got["wire"]
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        exp = want["logits"][i * half:(i + 1) * half]
        tol = 1e-4 * float(np.abs(exp).max())
        assert float(np.abs(got["logits"] - exp).max()) <= tol
        assert len(got["wire"]) == 4 * len(ref_wire[0, i, j])
        for n, payload in enumerate(got["wire"]):
            exp = ref_wire[n % 4, i, j][n // 4]
            assert payload.dtype == exp.dtype and \
                payload.shape == exp.shape, n
            if payload.dtype == np.int8:
                assert np.array_equal(payload, exp), (n, i, j)
            else:
                np.testing.assert_allclose(payload, exp, rtol=1e-5,
                                           atol=0, err_msg=str((n, i, j)))
    for (i, j), wire in by_coords.items():
        for n in range(2, len(wire), 4):     # the combine's codes, scales
            for payload, other in zip(wire[n:n + 2],
                                      by_coords[i, 1 - j][n:n + 2]):
                assert np.array_equal(payload.view(np.uint8),
                                      other.view(np.uint8)), (n, i, j)


def test_unreduced_partial_needs_the_native_wire():
    """Only the native wire hands back a partial sum over the tp axis:
    the int8 wire must quantize the sum, as the reference's does."""
    from repro_torch.launch.mesh import CardMesh

    mesh = CardMesh(torch.device("cpu"), ("data", "model"), (1, 1))
    dims = moe.MoeDims(E, K, D, F, dispatch_dtype="int8")
    args = [torch.zeros(shape) for shape in
            ((B, S, D), (D, E), (E, D, F), (E, D, F), (E, F, D))]
    with pytest.raises(ValueError, match="native wire"):
        moe.moe_ffn_ep(*args, dims, mesh, reduce=False)
