"""The dry-run on the production meshes: ``make_production_mesh`` against
the reference's (a subprocess with 512 host devices), the abstract
mesh's collectives (logged, never made; a real tensor raises), the
collective counter against the collectives that gloo ranks make, and
the records of full-width cells on ``pod16x16`` and ``pod2x16x16``.

Exactness: on a gloo (2,2) world each rank runs one reduced train,
prefill and decode step of tinyllama, deepseek-v2-lite (expert and
tensor parallelism) and whisper with every collective logged
(``log_collectives``); the dry-run counts the same cells on an
abstract (2,2) mesh.  Each rank's log equals the counter's (kind, group
size and operand bytes, call by call) and the bytes each rank holds
(its parameters, optimizer state, batch or decode state) equal the
record's ``argument_bytes``, exactly.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.configs.base import ShapeCell
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import (
    AbstractGroup,
    Placement,
    abstract_mesh,
    all_gather_axis,
    all_reduce,
    all_to_all,
    log_collectives,
    make_production_mesh,
    reduce_sum,
    run_world,
)
from repro_torch.models import transformer as tf

REPO = pathlib.Path(__file__).resolve().parents[1]
#: the reduced configs of the exact-count worlds (deepseek: a head dim of
#: 16 + 16, one the attention kernel's meta branch takes)
EXACT = {"tinyllama-1.1b": {},
         "deepseek-v2-lite-16b": {"moe_impl": "ep", "rope_head_dim": 16},
         "whisper-large-v3": {}}
B, S = 4, 16
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}


_GET_CONFIG = configs.get_config


def _cfg(arch: str):
    return _GET_CONFIG(arch).reduced(**EXACT[arch])


# ------------------------------------------------------ production meshes

MESH_SCRIPT = textwrap.dedent("""
    import json, warnings
    warnings.filterwarnings("ignore")
    from repro.launch.mesh import make_production_mesh
    out = []
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        out.append([list(m.axis_names), [m.shape[a] for a in m.axis_names],
                    m.size])
    print(json.dumps(out))
""")


def test_production_meshes_match_the_reference():
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    env["PYTHONPATH"] = str(REPO / "src")
    out = subprocess.run([sys.executable, "-c", MESH_SCRIPT], env=env,
                         check=True, timeout=300, capture_output=True,
                         text=True).stdout
    want = json.loads(out.strip().splitlines()[-1])
    for (names, sizes, size), multi in zip(want, (False, True)):
        mesh = make_production_mesh(multi_pod=multi)
        assert list(mesh.axis_names) == names
        assert list(mesh.axis_sizes) == sizes
        assert mesh.size == size
        assert mesh.name == ("pod2x16x16" if multi else "pod16x16")
        assert mesh.abstract and mesh.device == torch.device("meta")
        assert mesh.coords == (0,) * len(names)


def test_an_abstract_mesh_is_never_one_card():
    mesh = make_production_mesh()
    assert tf.Runtime(mesh).distributed
    for axis in ("data", "model"):
        assert mesh.group(axis) == AbstractGroup(axis, 16)
    assert mesh.subgroup("model", 4) == AbstractGroup("model", 4)
    assert mesh.subgroup("model", 1) == mesh.group("model")
    with pytest.raises(ValueError, match="divide"):
        mesh.subgroup("model", 3)


@pytest.mark.parametrize("op", ["all_reduce", "reduce_sum", "all_to_all",
                                "all_gather", "placement"])
def test_a_collective_on_a_real_tensor_over_an_abstract_mesh_raises(op):
    mesh = make_production_mesh(multi_pod=True)
    group = mesh.group("model")
    x = torch.ones(32, 4)
    calls = {"all_reduce": lambda: all_reduce(x, group),
             "reduce_sum": lambda: reduce_sum(x, group),
             "all_to_all": lambda: all_to_all(x, group),
             "all_gather": lambda: all_gather_axis(x, group, 16, 0),
             "placement": lambda: Placement(mesh, ("model",)).gather(x)}
    with pytest.raises(RuntimeError, match="abstract mesh"):
        calls[op]()


def test_collectives_on_meta_are_logged_not_made():
    mesh = abstract_mesh((2, 4))
    x = torch.empty(8, 3, device="meta")
    with log_collectives() as log:
        all_reduce(x, mesh.group("model"), "max")
        y = all_gather_axis(x, mesh.group("data"), 2, 1)
        z = all_to_all(x, mesh.group("model"))
    assert y.shape == (8, 6) and y.is_meta and z.shape == x.shape
    assert log == [("all-reduce", 4, 96), ("all-gather", 2, 96),
                   ("all-to-all", 4, 96)]
    assert Placement(mesh, (None, "data")).gather(x).shape == (8, 6)


# ------------------------------------------------------------ exactness

def _held(*trees) -> int:
    """Bytes of the distinct storages under ``trees``."""
    from repro_torch.launch._count import tensors_of

    seen = {}
    for t in tensors_of(trees):
        st = t.untyped_storage()
        seen[st.data_ptr(), st.nbytes()] = st.nbytes()
    return sum(seen.values())


def _batch(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    if cfg.family == "audio":
        batch["encoder_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def _exact_rank(rank: int) -> dict:
    """Each arch's train, prefill and decode step on this rank of a gloo
    (2,2) world, each under a collective log: {(arch, kind): (log,
    bytes held)}."""
    from repro_torch.data.pipeline import make_global_batch
    from repro_torch.launch.mesh import make_mesh, shard_tree
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.trainer import TrainConfig, make_train_step

    mesh = make_mesh((2, 2), device="cpu")
    rt = tf.Runtime(mesh)
    out = {}
    for arch in EXACT:
        cfg = _cfg(arch)
        pls = tf.param_placements(cfg, rt)
        params = shard_tree(tf.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"), pls)
        ocfg = dryrun.train_optimizer(cfg, mesh)
        opt = adamw_init(params, ocfg, placements=pls)
        host = _batch(cfg, 3)
        step = make_train_step(cfg, TrainConfig(optimizer=ocfg), rt)
        held = _held(params, opt)       # the step cuts its rows from host
        with log_collectives() as log:
            step(params, opt, host)
        out[arch, "train"] = (list(log), held)

        batch = make_global_batch(host, mesh)
        batch.pop("labels")
        held = _held(params, batch)
        with torch.no_grad(), log_collectives() as log:
            _, state = tf.prefill(params, cfg, batch, cache_len=S, rt=rt)
        out[arch, "prefill"] = (list(log), held)

        with torch.no_grad():
            _, state = tf.prefill(params, cfg,
                                  {**batch, "tokens": batch["tokens"][:, :4]},
                                  cache_len=S, rt=rt)
        tokens = batch["tokens"][:, 0].contiguous()
        held = _held(params, state, tokens)
        with torch.no_grad(), log_collectives() as log:
            tf.decode_step(params, cfg, state, tokens,
                           live=[True] * tokens.shape[0], rt=rt)
        out[arch, "decode"] = (list(log), held)
    return out


@pytest.fixture(scope="module")
def gloo_logs(tmp_path_factory):
    return run_world(_exact_rank, 4, tmp_path_factory.mktemp("exact"),
                     deadline_s=400, timeout_s=120)


@pytest.fixture(scope="module")
def counted():
    """The dry-run's counts of the same cells on an abstract (2,2)
    mesh."""
    real = configs.get_config
    configs.get_config = _cfg
    try:
        return {(arch, kind): dryrun.count_cell(
            arch, ShapeCell(KINDS[kind], S, B, kind), None, "pod2x2")
            for arch in EXACT for kind in KINDS}
    finally:
        configs.get_config = real


CASES = [(arch, kind) for arch in EXACT for kind in KINDS]
IDS = [f"{arch}-{kind}" for arch, kind in CASES]


@pytest.mark.parametrize("arch,kind", CASES, ids=IDS)
def test_counted_collectives_equal_the_ranks_logs(gloo_logs, counted, arch,
                                                  kind):
    want = counted[arch, kind]["collective_log"]
    assert want
    for res in gloo_logs:
        assert res[arch, kind][0] == want
    kinds = {k for k, _, _ in want}
    assert "all-reduce" in kinds
    if arch == "deepseek-v2-lite-16b":
        assert "all-to-all" in kinds


@pytest.mark.parametrize("arch,kind", CASES, ids=IDS)
def test_held_bytes_equal_the_argument_bytes(gloo_logs, counted, arch,
                                             kind):
    want = counted[arch, kind]["memory"]["argument_bytes"]
    for res in gloo_logs:
        assert res[arch, kind][1] == want


# -------------------------------------------------------------- records

@pytest.fixture
def reduced(monkeypatch, tmp_path):
    monkeypatch.setattr(configs, "get_config", _cfg)
    monkeypatch.setitem(configs.SHAPES, "decode_32k",
                        ShapeCell("decode_32k", S, B, "decode"))
    monkeypatch.setitem(configs.SHAPES, "train_4k",
                        ShapeCell("train_4k", S, B, "train"))
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    return tmp_path


@pytest.mark.parametrize("variant", ["cap10", "int8disp", "cap10int8"])
def test_expert_parallel_variants_run(reduced, variant):
    arch = "deepseek-v2-lite-16b"
    base = dryrun.run_cell(arch, "train_4k", mesh="pod2x2")
    rec = dryrun.run_cell(arch, "train_4k", mesh="pod2x2", variant=variant)
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["variant"] == variant
    got = rec["collectives_raw"]["bytes_per_device_by_op"]["all-to-all"]
    was = base["collectives_raw"]["bytes_per_device_by_op"]["all-to-all"]
    assert got < was
    assert (reduced / f"{arch}_train_4k_pod2x2_{variant}.json").exists()


@pytest.mark.parametrize("variant,why", [("kvseq", "5c"),
                                         ("kvseqdonate", "5c"),
                                         ("bigchunk", "tile"),
                                         ("donate", "in place")])
def test_dropped_variants_raise_naming_their_reason(reduced, variant, why):
    """``bigchunk`` and ``donate`` raise naming their reason; ``kvseq``
    and ``kvseqdonate`` (Queue 1 item 5c, ported) run on pod2x2: the
    cache cut by sequence over "model", the decode's merge of partial
    softmaxes among the collectives, each record under its own name."""
    arch = "tinyllama-1.1b"
    if variant in dryrun.DROPPED_VARIANTS:
        with pytest.raises(ValueError, match=why):
            dryrun.run_cell(arch, "decode_32k", mesh="pod2x2",
                            variant=variant)
        return
    base = dryrun.run_cell(arch, "decode_32k", mesh="pod2x2")
    rec = dryrun.run_cell(arch, "decode_32k", mesh="pod2x2",
                          variant=variant)
    assert rec["status"] == "OK", rec.get("traceback")
    assert rec["variant"] == variant
    assert (reduced / f"{arch}_decode_32k_pod2x2_{variant}.json").exists()
    counts = rec["collectives_raw"]["counts"]
    assert counts["all-reduce"] > base["collectives_raw"]["counts"][
        "all-reduce"]
    # the reduced cache: every KV head of S / 2 positions a device, not
    # one of the two KV heads of S positions: equal bytes, cut otherwise
    assert rec["memory"]["argument_bytes"] == \
        base["memory"]["argument_bytes"]


def test_mesh_names():
    assert dryrun.mesh_named("card1x1").name == "card1x1"
    assert dryrun.mesh_named("pod2x16x16").axis_names == ("pod", "data",
                                                          "model")
    assert dryrun.mesh_named("pod2x4").shape == {"data": 2, "model": 4}
    with pytest.raises(ValueError, match="unknown"):
        dryrun.mesh_named("tpu16")


FULL_WIDTH = [("tinyllama-1.1b", "decode_32k"),
              ("tinyllama-1.1b", "train_4k"),
              ("deepseek-v2-lite-16b", "train_4k"),
              ("kimi-k2-1t-a32b", "train_4k"),
              ("whisper-large-v3", "prefill_32k"),
              ("qwen2-vl-72b", "train_4k"),
              ("hymba-1.5b", "long_500k")]


@pytest.mark.parametrize("mesh", ["pod16x16", "pod2x16x16"])
@pytest.mark.parametrize("arch,shape", FULL_WIDTH)
def test_full_width_records_on_the_production_meshes(arch, shape, mesh,
                                                     tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    rec = dryrun.run_cell(arch, shape, mesh=mesh)
    assert rec["status"] == "OK", rec.get("traceback")
    grid = dryrun.mesh_named(mesh)
    assert (rec["mesh"], rec["devices"]) == (mesh, grid.size)
    cfg = configs.get_config(arch)
    coll = rec["collectives_raw"]
    assert coll["bytes_per_device_total"] == sum(
        coll["bytes_per_device_by_op"].values())
    # a leaf or the batch is cut: every step exchanges something, by
    # layer too (the hybrid's batch of one too: its mixers are cut)
    assert coll["bytes_per_device_total"] > 0
    assert rec["cost"]["collective_bytes_per_device"] > 0
    # per device: the parameters' blocks, not the model
    params = sum(int(np.prod(s)) for s in _shapes(tf.param_shapes(cfg)))
    assert rec["memory"]["argument_bytes"] < 2 * params
    zero = cfg.n_params() > 5e10 and shape == "train_4k"
    assert ("ZeRO" in rec["cost"]["method"]) == zero
    if zero:
        assert "all-gather" in coll["counts"]


def _shapes(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _shapes(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _shapes(v)
    else:
        yield tree


def test_roofline_reads_the_production_records(tmp_path, monkeypatch):
    from repro_torch.hw.gpu import H100_SXM
    from repro_torch.launch import roofline

    monkeypatch.setattr(dryrun, "ARTIFACTS", tmp_path)
    for mesh in ("card1x1", "pod16x16", "pod2x16x16"):
        dryrun.run_cell("tinyllama-1.1b", "decode_32k", mesh=mesh)
    for mesh in ("pod16x16", "pod2x16x16"):
        (row,) = roofline.load_all(mesh, directory=tmp_path)
        rec = json.loads((tmp_path / f"tinyllama-1.1b_decode_32k_{mesh}"
                          ".json").read_text())
        assert row["mesh"] == mesh
        assert row["t_collective_s"] == \
            rec["cost"]["collective_bytes_per_device"] \
            / H100_SXM.nvlink_bw_per_link > 0
