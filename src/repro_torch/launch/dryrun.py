"""Dry-run of every (architecture × input shape) cell on the one-card
mesh and on the reference's production meshes: the port's own step
(train, prefill or decode) run on ``meta`` tensors at full width and
depth, so nothing is allocated and no kernel is launched, under the
counter of :mod:`repro_torch.launch._count`.

A mesh is named as its records are: ``card1x1`` (the one card, every
leaf whole, no collective), ``pod16x16`` and ``pod2x16x16``
(:func:`repro_torch.launch.mesh.make_production_mesh`: 256 and 512
devices), or any ``pod<sizes>`` (an abstract mesh over ``("data",
"model")``, or ``("pod", "data", "model")`` for three sizes).  On an
abstract mesh the step is rank 0's, with its blocks as arguments
(:mod:`repro_torch.launch.specs`: tensor parallelism over ``"model"``,
expert parallelism, ZeRO and the batch cut over the batch axes), and
its collectives are logged instead of made: every number of the record
is per device.

Per cell the record keeps the reference's schema
(``repro.launch.dryrun``):

  - ``memory``: ``argument_bytes`` (the step's parameters, state and
    batch), ``output_bytes`` (what the step returns on storages of its
    own; the port updates parameters, moments and caches in place),
    ``peak_bytes`` (the most ``meta`` storage alive at once, arguments
    included) and ``temp_bytes`` (the peak less arguments and outputs);
  - ``cost_raw``: FLOPs and bytes counted over the full-depth run;
  - ``collectives_raw``: the port's own collectives of the full-depth
    run (:func:`~repro_torch.launch._count.collective_totals`, the
    counterpart of the reference's ``parse_collective_bytes``: operand
    bytes per device by the reference's op names, counts, total), and
    the collective terms of ``cost`` by the same layer differencing; 0
    on one card, exactly, since one card runs no collective;
  - ``model_flops_global`` = 6·N_active·tokens (train) or 2·N_active·B
    (decode), ``n_params``, ``n_active_params``, ``tokens``;
  - ``cost``: :func:`corrected_costs`, the reference's layer
    differencing (L = 1 and 2), with its sLSTM layer costed apart and
    its linear scaling of ssm and hybrid cells longer than 4096 tokens.

The port runs its layers in a Python loop, so a forward's counts are
linear in L and the differenced cost equals the full-depth count; the
method is kept so that the records compare with the reference's.  The
counting passes of many cells can run on a pool of processes
(:func:`run_cells`, ``--jobs``); xLSTM's train cell, whose per-token
sLSTM loop runs 4096 steps a layer forward and back on ``meta``, takes
the longest.  A train cell uses
:class:`~repro_torch.train.optimizer.AdamWConfig` as the reference's
dry-run does: bf16 moments when ``n_params() > 5e10``, and on a
production mesh ZeRO with them (one card has no ``"data"`` axis to cut
the moments over).

Records go to ``artifacts/dryrun_torch/<arch>_<shape>_<mesh>.json``
at the repo root.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
      [--mesh pod16x16 | --multi-pod]
  python -m repro_torch.launch.dryrun --all [--force] [--jobs 8]
      [--single-pod-only | --multi-pod-only]
  python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import torch

ARTIFACTS = (pathlib.Path(__file__).resolve().parents[3] / "artifacts"
             / "dryrun_torch")

#: cells of the ssm and hybrid families longer than this (not decode)
#: are costed at this length and scaled linearly, as the reference does
SCALE_SEQ = 4096

# Named config variants: each changes one knob the port's step reads
# (the expert-parallel ones and the KV cache cut by sequence on a
# production mesh; on one card the dense MoE path reads neither, and a
# cache cut over no "model" axis is whole)
VARIANTS: dict[str, dict] = {
    "cap10": {"capacity_factor": 1.0},      # MoE capacity 1.25 → 1.0
    "int8disp": {"moe_dispatch_dtype": "int8"},   # int8 EP wire format
    "cap10int8": {"capacity_factor": 1.0,
                  "moe_dispatch_dtype": "int8"},
    "noremat": {"remat": False},            # trade memory for recompute
    "kvseq": {"shard_kv_seq": True},        # KV cache cut by sequence
    # the reference's kvseq with the decode state donated; the port's
    # decode step always updates its state in place, so it runs as kvseq
    # (its records keep their own variant name)
    "kvseqdonate": {"shard_kv_seq": True},
}

#: the reference's other variants, and why the port's step does not
#: read their knobs
DROPPED_VARIANTS: dict[str, str] = {
    "bigchunk": "attn_q_chunk and attn_kv_chunk tile the reference's jnp "
                "attention; the port's attention kernels take no tile "
                "size",
    "donate": "the port's decode step always updates its state in place",
}

#: the dry-run's meshes: the one card and the production meshes
MESHES = ("card1x1", "pod16x16", "pod2x16x16")


def mesh_named(name: str, coords: tuple[int, ...] | None = None):
    """The mesh of a record's name: ``card1x1`` the one card; ``pod``
    and sizes joined by ``x`` an abstract mesh (two sizes over
    ``("data", "model")``, three over ``("pod", "data", "model")``), as
    its rank 0, or the rank at ``coords``."""
    from repro_torch.launch.mesh import abstract_mesh, make_host_mesh

    if name == "card1x1":
        return make_host_mesh()
    if name.startswith("pod"):
        sizes = tuple(int(n) for n in name[3:].split("x"))
        names = {2: ("data", "model"), 3: ("pod", "data", "model")}
        if len(sizes) in names:
            return abstract_mesh(sizes, names[len(sizes)], coords)
    raise ValueError(f"unknown dry-run mesh {name!r}; one of {MESHES} or "
                     "pod<sizes>")


def variant_overrides(variant: str) -> dict:
    """The config overrides of a named variant ("" → none); a variant
    whose knob the port does not read raises ``ValueError`` naming it."""
    if not variant:
        return {}
    if variant in DROPPED_VARIANTS:
        raise ValueError(f"dry-run variant {variant!r} is not ported: "
                         f"{DROPPED_VARIANTS[variant]}")
    if variant not in VARIANTS:
        raise ValueError(f"unknown dry-run variant {variant!r}; one of "
                         f"{sorted(VARIANTS)}")
    return dict(VARIANTS[variant])


def train_optimizer(cfg, mesh):
    """The dry-run's optimizer for ``cfg`` on ``mesh``, as the
    reference's: bf16 moments above 5e10 parameters, with ZeRO on a
    production mesh."""
    from repro_torch.train.optimizer import AdamWConfig

    big = cfg.n_params() > 5e10
    return AdamWConfig(moment_dtype="bfloat16" if big else "float32",
                       zero_shard=big and mesh.abstract)


def _build_cell(arch: str, cell, cfg_overrides: dict | None = None,
                mesh_name: str = "card1x1",
                coords: tuple[int, ...] | None = None):
    """(mesh, cfg, step, arguments): ``step(*arguments)`` runs the step
    of ``cell`` (a :class:`~repro_torch.configs.ShapeCell`) on ``meta``
    stand-ins: on an abstract mesh rank 0's step on its blocks (a train
    step's batch the global one on the host, which the record's
    ``argument_bytes`` leaves out, as a rank's step takes it)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs as sp
    from repro_torch.models import transformer as tf
    from repro_torch.train.trainer import TrainConfig, make_train_step

    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    mesh = mesh_named(mesh_name, coords)
    rt = tf.Runtime(mesh) if mesh.abstract else None
    params, params_pl = sp.abstract_model(cfg, mesh)

    if cell.kind == "train":
        ocfg = train_optimizer(cfg, mesh)
        opt, _ = sp.abstract_opt_state(params, params_pl, ocfg, mesh)
        if mesh.abstract:       # the step cuts its rows from the host's
            batch = sp.host_train_batch(cfg, cell)
        else:
            batch, _ = sp.train_batch_specs(cfg, cell, mesh)
        step = make_train_step(cfg, TrainConfig(optimizer=ocfg), rt)
        return mesh, cfg, step, (params, opt, batch)

    if cell.kind == "prefill":
        batch, _ = sp.train_batch_specs(cfg, cell, mesh)
        batch.pop("labels")

        def prefill_fn(params, batch):
            return tf.prefill(params, cfg, batch, cache_len=cell.seq_len,
                              rt=rt)

        return mesh, cfg, prefill_fn, (params, batch)

    state, _ = sp.decode_state_specs(cfg, cell, mesh)
    tokens, _ = sp.decode_token_specs(cell, mesh)
    live = [True] * tokens.shape[0]     # every row full: no host read

    def decode_fn(params, state, tokens):
        return tf.decode_step(params, cfg, state, tokens, live=live, rt=rt)

    return mesh, cfg, decode_fn, (params, state, tokens)


def _storages(tree) -> dict[int, int]:
    """id → bytes of the ``meta`` storages under ``tree``."""
    from repro_torch.launch._count import tensors_of

    return {id(t.untyped_storage()): t.untyped_storage().nbytes()
            for t in tensors_of(tree) if t.is_meta}


def _run(step, args):
    """Run ``step(*args)`` under a fresh counter → (counter, memory)."""
    from repro_torch.launch._count import CostCounter

    counter = CostCounter()
    argument_bytes = counter.hold(args)
    held = _storages(args)
    with counter:
        out = step(*args)
    output_bytes = sum(n for key, n in _storages(out).items()
                       if key not in held)
    peak = counter.peak
    memory = {"argument_bytes": argument_bytes,
              "output_bytes": output_bytes,
              "temp_bytes": max(peak - argument_bytes - output_bytes, 0),
              "peak_bytes": peak}
    return counter, memory


def count_cell(arch: str, cell, overrides: dict | None = None,
               mesh: str = "card1x1",
               coords: tuple[int, ...] | None = None) -> dict:
    """One ``meta`` run of ``arch``'s step (config ``overrides``) at
    ``cell``, any :class:`~repro_torch.configs.ShapeCell`, on the mesh
    named ``mesh`` (rank 0's step, or, on an abstract mesh, the rank's
    at ``coords``: blocks of unequal size differ between ranks): its
    FLOPs, bytes, memory, the kernels' ``[calls, flops, bytes]``, the
    collectives' log (``(kind, group size, operand bytes)`` in call
    order) and their totals."""
    from repro_torch.launch._count import collective_totals

    _, _, step, args = _build_cell(arch, cell, overrides, mesh, coords)
    counter, memory = _run(step, args)
    return {"flops": counter.flops, "bytes": counter.bytes,
            "memory": memory, "kernels": dict(counter.kernels),
            "collective_log": list(counter.collectives),
            "collectives": collective_totals(counter.collectives)}


def count_pass(arch: str, shape: str, overrides: dict | None = None,
               seq: int | None = None, mesh: str = "card1x1") -> dict:
    """:func:`count_cell` at the cell named ``shape``, its length cut to
    ``seq``."""
    from repro_torch.configs import SHAPES

    cell = SHAPES[shape]
    if seq is not None:
        cell = dataclasses.replace(cell, seq_len=seq)
    return count_cell(arch, cell, overrides, mesh)


def _scaled_seq(cfg, cell) -> bool:
    return (cfg.family in ("ssm", "hybrid") and cell.kind != "decode"
            and cell.seq_len > SCALE_SEQ)


def cell_plan(arch: str, shape: str, overrides: dict | None = None,
              mesh: str = "card1x1") -> dict:
    """The counting passes of one applicable cell on the mesh named
    ``mesh``, each ``(arch, shape, overrides, seq, mesh)`` for
    :func:`count_pass`: ``"memory"`` (the full run) and ``"a"``,
    ``"b"`` (and ``"special"``: one sLSTM layer) of
    :func:`corrected_costs`, with ``"scale"``, the cost passes' linear
    length scale."""
    from repro_torch.configs import SHAPES, get_config

    overrides = dict(overrides or {})
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape]
    plan: dict = {"memory": (arch, shape, overrides, None, mesh)}
    # layer differencing (the reference keeps one- and two-layer
    # variants pure-mLSTM for xLSTM and costs its sLSTM layer apart)
    ovr_a: dict = {**overrides, "n_layers": 1}
    ovr_b: dict = {**overrides, "n_layers": 2}
    if cfg.family == "audio":
        ovr_a["n_encoder_layers"] = 1
        ovr_b["n_encoder_layers"] = 2
    if cfg.family == "ssm":
        ovr_a["slstm_every"] = 0
        ovr_b["slstm_every"] = 0
    seq = SCALE_SEQ if _scaled_seq(cfg, cell) else None
    plan["scale"] = cell.seq_len / SCALE_SEQ if seq else 1.0
    plan["a"] = (arch, shape, ovr_a, seq, mesh)
    plan["b"] = (arch, shape, ovr_b, seq, mesh)
    if cfg.family == "ssm" and cfg.slstm_every > 0:
        plan["special"] = (arch, shape,
                           {**overrides, "n_layers": 1, "slstm_every": 1},
                           seq, mesh)
    return plan


def _plan_passes(plan: dict) -> list[tuple]:
    return [plan[k] for k in ("memory", "a", "b", "special") if k in plan]


def corrected_costs(arch: str, shape: str,
                    variant_overrides: dict | None = None,
                    counts: dict | None = None,
                    mesh: str = "card1x1") -> dict:
    """Layer-differencing cost model, as the reference computes it:

        total(L) = base + L · per_layer,  per_layer = cost(2) − cost(1)

    from two (three for xLSTM's mixed blocks: an sLSTM layer costed
    apart) one- and two-layer counts; whisper's encoder layers go 1 and
    2 with its decoder's.  ssm and hybrid cells longer than 4096 tokens
    (not decode) are counted at 4096 and scaled linearly.  ``counts``
    maps a pass of :func:`cell_plan` to its :func:`count_pass` result
    (passes missing from it are run here).  The collective bytes
    (``coll``, and by op ``coll_by_op``) are differenced the same way.

    The port runs its layers in a Python loop, so a forward's counts are
    linear in L and this equals the full-depth count; a train step's
    gradient of each stacked parameter sums one full-size buffer a
    layer (``select_backward``), bytes that grow as L², which the
    differenced total leaves out."""
    from repro_torch.configs import get_config

    plan = cell_plan(arch, shape, variant_overrides, mesh)
    counts = dict(counts or {})

    def count(key):
        p = plan[key]
        tag = _pass_tag(p)
        if tag not in counts:
            counts[tag] = count_pass(*p)
        res = counts[tag]
        s = plan["scale"]
        coll = res["collectives"]
        return {"flops": float(res["flops"]) * s,
                "bytes": float(res["bytes"]) * s,
                "coll": coll["bytes_per_device_total"] * s,
                "coll_by_op": {k: v * s for k, v in
                               coll["bytes_per_device_by_op"].items()}}

    cfg = get_config(arch)
    if variant_overrides:
        cfg = dataclasses.replace(cfg, **variant_overrides)
    L = cfg.n_layers
    a, b = count("a"), count("b")
    special = count("special") if "special" in plan else None
    n_special = L // cfg.slstm_every if special is not None else 0
    out = {}
    for key in ("flops", "bytes", "coll"):
        per_layer = b[key] - a[key]
        base = a[key] - per_layer
        total = base + L * per_layer
        if special is not None:
            s_layer = special[key] - base
            total = base + (L - n_special) * per_layer \
                + n_special * s_layer
        out[key] = max(total, 0.0)
    by_op = {}
    for op in sorted(set(a["coll_by_op"]) | set(b["coll_by_op"])):
        va, vb = a["coll_by_op"].get(op, 0.0), b["coll_by_op"].get(op, 0.0)
        by_op[op] = max(2 * va - vb + L * (vb - va), 0.0)
    out["coll_by_op"] = by_op
    return out


def _pass_tag(p: tuple) -> str:
    arch, shape, overrides, seq, mesh = p
    return json.dumps([arch, shape, sorted(overrides.items()), seq, mesh])


def _assemble(arch: str, shape: str, variant: str, plan: dict,
              counts: dict, run_s: float, cost_s: float,
              mesh: str = "card1x1") -> dict:
    """The OK record of a cell from its passes' counts (``run_s``: the
    memory pass's seconds, ``cost_s``: the cost passes')."""
    from repro_torch.configs import SHAPES, get_config

    grid = mesh_named(mesh)
    overrides = variant_overrides(variant)
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cell = SHAPES[shape]
    raw = counts[_pass_tag(plan["memory"])]
    tokens = cell.tokens if cell.kind != "decode" else cell.global_batch
    n_active = cfg.active_params()
    model_flops = (6 if cell.kind == "train" else 2) * n_active * tokens
    cc = corrected_costs(arch, shape, overrides or None, counts, mesh)
    if grid.abstract:
        zero = " + ZeRO" if train_optimizer(cfg, grid).zero_shard \
            and cell.kind == "train" else ""
        method = (f"layer-differencing (L=1,2) of rank 0's meta runs on "
                  f"the abstract {grid.name} mesh{zero}")
    else:
        method = "layer-differencing (L=1,2) of meta runs on one card"
    return {
        "arch": arch, "shape": shape, "mesh": grid.name,
        "variant": variant or "baseline",
        "status": "OK",
        "run_s": round(run_s, 2),
        "devices": grid.size,
        "memory": raw["memory"],
        "cost_raw": {"flops_per_device": float(raw["flops"]),
                     "bytes_per_device": float(raw["bytes"])},
        "collectives_raw": raw["collectives"],
        "model_flops_global": float(model_flops),
        "n_params": int(cfg.n_params()),
        "n_active_params": int(n_active),
        "tokens": int(tokens),
        "cost": {
            "flops_per_device": cc["flops"],
            "bytes_per_device": cc["bytes"],
            "collective_bytes_per_device": cc["coll"],
            "collective_by_op_per_device": cc["coll_by_op"],
            "method": method,
            "cost_pass_s": round(cost_s, 2),
        },
    }


def _pass_job(p: tuple):
    """A pool worker's pass: ("ok", counts, seconds) or ("err", text)."""
    # the seconds are reported in the record only
    t0 = time.perf_counter()  # pfdnn: allow(wall-clock)
    try:
        return ("ok", count_pass(*p),
                time.perf_counter() - t0)  # pfdnn: allow(wall-clock)
    except Exception as e:  # noqa: BLE001 — the cell records it
        return "err", f"{type(e).__name__}: {e}", traceback.format_exc()


def _record_path(arch: str, shape: str, variant: str,
                 mesh: str = "card1x1") -> pathlib.Path:
    tag = f"{arch}_{shape}_{mesh}" + (f"_{variant}" if variant else "")
    return ARTIFACTS / f"{tag}.json"


def run_cells(cells: list[tuple[str, str]], *, force: bool = False,
              variant: str = "", jobs: int = 1,
              meshes: tuple[str, ...] = ("card1x1",)) -> list[dict]:
    """The records of ``cells`` ((arch, shape) pairs) on each mesh of
    ``meshes`` (cell by cell, each cell's meshes in order), each read
    from its file unless ``force``, else run on ``meta`` and written to
    ``ARTIFACTS``: every counting pass of every cell, on ``jobs``
    spawned processes (longest first) when ``jobs`` > 1.  A failed pass
    gives its cell a ``FAIL`` record with the traceback."""
    from repro_torch.configs import cell_applicable, get_config

    variant_overrides(variant)
    todo = [(arch, shape, mesh) for arch, shape in cells
            for mesh in meshes]
    records: dict = {}
    plans: dict = {}
    for arch, shape, mesh in todo:
        mesh_named(mesh)
        path = _record_path(arch, shape, variant, mesh)
        if path.exists() and not force:
            records[arch, shape, mesh] = json.loads(path.read_text())
            continue
        ok, why = cell_applicable(get_config(arch), shape)
        if not ok:
            records[arch, shape, mesh] = {
                "arch": arch, "shape": shape, "mesh": mesh,
                "variant": variant or "baseline", "status": "SKIP",
                "reason": why}
            _save(path, records[arch, shape, mesh])
            continue
        plans[arch, shape, mesh] = cell_plan(
            arch, shape, variant_overrides(variant), mesh)
    passes = {}
    for plan in plans.values():
        for p in _plan_passes(plan):
            passes[_pass_tag(p)] = p
    results = _run_passes(passes, jobs)
    for (arch, shape, mesh), plan in plans.items():
        tags = [_pass_tag(p) for p in _plan_passes(plan)]
        failed = [results[t] for t in tags if results[t][0] == "err"]
        if failed:
            record = {"arch": arch, "shape": shape, "mesh": mesh,
                      "variant": variant or "baseline", "status": "FAIL",
                      "error": failed[0][1],
                      "traceback": failed[0][2][-4000:]}
        else:
            counts = {t: results[t][1] for t in tags}
            run_s = results[tags[0]][2]
            cost_s = sum(results[t][2] for t in tags[1:])
            record = _assemble(arch, shape, variant, plan, counts, run_s,
                               cost_s, mesh)
        records[arch, shape, mesh] = record
        _save(_record_path(arch, shape, variant, mesh), record)
    return [records[key] for key in todo]


#: a pool starts the passes of these kinds first (after xLSTM's
#: per-token loops, then the deepest and widest), since they run longest
_SLOW = {"train": 3, "prefill": 1, "decode": 0}


def _run_passes(passes: dict, jobs: int) -> dict:
    """tag → :func:`_pass_job` result for every pass."""
    if jobs <= 1 or len(passes) <= 1:
        return {tag: _pass_job(p) for tag, p in passes.items()}
    import concurrent.futures
    import multiprocessing

    from repro_torch.configs import SHAPES, get_config

    def weight(p):
        arch, shape, overrides, seq, _ = p
        cfg = dataclasses.replace(get_config(arch), **overrides)
        kind = SHAPES[shape].kind
        seq = seq or SHAPES[shape].seq_len
        # sLSTM steps a pass runs one by one (3 a token in training:
        # forward, recompute, backward)
        loop = 0
        if cfg.family == "ssm" and cfg.slstm_every and kind != "decode":
            loop = (cfg.n_layers // cfg.slstm_every) * seq * (
                3 if kind == "train" else 1)
        work = cfg.n_layers * (1 + cfg.n_experts) * seq
        return loop, _SLOW[kind], work

    order = sorted(passes, key=lambda t: weight(passes[t]), reverse=True)
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(jobs, mp_context=ctx) \
            as pool:
        futures = {tag: pool.submit(_pass_job, passes[tag])
                   for tag in order}
        return {tag: fut.result() for tag, fut in futures.items()}


def run_cell(arch: str, shape: str, *, force: bool = False,
             variant: str = "", mesh: str = "card1x1") -> dict:
    """One cell's record on the mesh named ``mesh`` (:func:`run_cells`
    in this process)."""
    return run_cells([(arch, shape)], force=force, variant=variant,
                     meshes=(mesh,))[0]


def _save(path: pathlib.Path, record: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(record, indent=2))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="card1x1",
                    help="one cell's mesh: " + ", ".join(MESHES))
    ap.add_argument("--multi-pod", action="store_true",
                    help="one cell on pod2x16x16")
    ap.add_argument("--all", action="store_true",
                    help="every cell on " + ", ".join(MESHES))
    ap.add_argument("--single-pod-only", action="store_true",
                    help="--all on pod16x16 alone")
    ap.add_argument("--multi-pod-only", action="store_true",
                    help="--all on pod2x16x16 alone")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--variant", default="",
                    help="named config variant: " + ",".join(VARIANTS))
    ap.add_argument("--jobs", type=int, default=1,
                    help="processes that run the counting passes")
    args = ap.parse_args(argv)

    from repro_torch.configs import all_cells

    if args.list:
        for arch, shape, ok, why in all_cells():
            print(f"{arch:24s} {shape:12s} "
                  f"{'RUN' if ok else 'SKIP(' + why[:40] + ')'}")
        return

    if args.all:
        todo = [(arch, shape) for arch, shape, _, _ in all_cells()]
        meshes = (("pod16x16",) if args.single_pod_only
                  else ("pod2x16x16",) if args.multi_pod_only else MESHES)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        todo = [(args.arch, args.shape)]
        meshes = ("pod2x16x16" if args.multi_pod else args.mesh,)

    for rec in run_cells(todo, force=args.force, variant=args.variant,
                         jobs=args.jobs, meshes=meshes):
        arch, shape = rec["arch"], rec["shape"]
        mem = rec.get("memory", {})
        print(f"{rec['status']:5s} {arch:24s} {shape:12s} "
              f"{rec['mesh']:10s} "
              f"peak={mem.get('peak_bytes', 0)/2**30:7.2f}GiB "
              f"run={rec.get('run_s', 0):7.1f}s "
              f"{rec.get('reason', rec.get('error', ''))[:60]}",
              flush=True)


if __name__ == "__main__":
    main()
