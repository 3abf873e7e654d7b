"""The ``Uneven`` placement entry (``repro_torch.launch.mesh``): blocks
of a tensor axis of unequal size, one ``(start, stop)`` a coordinate,
consecutive coordinates with equal bounds sharing a block.

On the CPU: its blocks and shapes at every coordinate against the
plain slices (and, where every block has the same size, against the
entries ``"model"`` and ``Part``); its validation; the abstract mesh's
run groups; ``tp_plan``'s blocks for hymba-1.5b on "model" = 2, 4 and
16 (abstract meshes).  On four gloo ranks of the CPU (``run_world``):
``shard`` then ``gather`` gives the tensor back; ``gather_to``'s
backward, summed over the runs as ``reduce_grads`` sums them, equals
autograd's gradient of the same function in one process (each rank's
part summed, or, with ``reduce=False``, one use alike on every rank);
``global_norm`` counts each block once though the runs differ in
length; ``reduce_grads`` sums a shared block over its run only.
"""

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.launch.mesh import (
    AbstractGroup,
    CardMesh,
    Part,
    Placement,
    Uneven,
    abstract_mesh,
    run_world,
)
from repro_torch.models import transformer as tf

#: bounds on a "model" axis of 4: blocks of unequal size; a run of two
#: then two blocks of one rank each; every block the same size
BOUNDS = {"uneven": ((0, 3), (3, 5), (5, 7), (7, 9)),
          "runs": ((0, 2), (0, 2), (2, 3), (3, 4)),
          "even": ((0, 2), (2, 4), (4, 6), (6, 8))}


def _mesh(coord: int, m: int = 4) -> CardMesh:
    return CardMesh(torch.device("cpu"), ("data", "model"), (1, m),
                    coords=(0, coord))


def _full(n: int) -> torch.Tensor:
    return torch.arange(3 * n * 2, dtype=torch.float32).reshape(3, n, 2)


@pytest.mark.parametrize("case", list(BOUNDS))
@pytest.mark.parametrize("coord", range(4))
def test_block_and_local_shape_at_every_coordinate(case, coord):
    entry = Uneven("model", BOUNDS[case])
    a, b = BOUNDS[case][coord]
    full = _full(entry.size)
    pl = Placement(_mesh(coord), (None, entry))
    assert pl.local_shape(tuple(full.shape)) == (3, b - a, 2)
    assert pl.global_shape((3, b - a, 2)) == tuple(full.shape)
    assert torch.equal(pl.shard(full), full[:, a:b])
    with pytest.raises(ValueError, match="bounds cover"):
        pl.local_shape((3, entry.size + 1, 2))


@pytest.mark.parametrize("coord", range(4))
def test_equal_blocks_place_as_model_and_part(coord):
    full = _full(8)
    even = Placement(_mesh(coord), (None, Uneven("model", BOUNDS["even"])))
    model = Placement(_mesh(coord), (None, "model"))
    assert torch.equal(even.shard(full), model.shard(full))
    assert even.local_shape((3, 8, 2)) == model.local_shape((3, 8, 2))
    pair = Uneven("model", ((0, 4), (0, 4), (4, 8), (4, 8)))
    part = Placement(_mesh(coord), (None, Part("model", 2)))
    assert torch.equal(Placement(_mesh(coord), (None, pair)).shard(full),
                       part.shard(full))


def test_runs_firsts_and_shares():
    e = Uneven("model", BOUNDS["runs"])
    assert (e.size, e.runs, e.firsts) == (4, (2, 1, 1), (0, 2, 3))
    assert [e.share(c) for c in range(4)] == [2, 2, 1, 1]
    assert e.scaled(8).bounds == ((0, 16), (0, 16), (16, 24), (24, 32))
    # one block held by every rank: the tensor axis stays whole
    whole = Placement(_mesh(1), (Uneven("model", ((0, 5),) * 4),))
    assert whole.local_shape((5,)) == (5,)


@pytest.mark.parametrize("bounds", [((0, 2), (3, 4)), ((1, 2), (2, 4)),
                                    ((0, 2), (2, 2)),
                                    ((0, 2), (2, 3), (0, 2))])
def test_blocks_must_follow_one_another_from_zero(bounds):
    with pytest.raises(ValueError, match="consecutive"):
        Uneven("model", bounds)


def test_bounds_must_match_the_axis():
    pl = Placement(_mesh(0), (Uneven("model", ((0, 1), (1, 2))),))
    with pytest.raises(ValueError, match="2 bounds"):
        pl.local_shape((2,))


def test_abstract_run_groups():
    """On an abstract mesh the run group is rank 0's run (or the given
    coordinate's), none for a block that one rank holds alone."""
    runs = Uneven("model", BOUNDS["runs"]).runs
    assert abstract_mesh((1, 4)).subgroup("model", runs) == \
        AbstractGroup("model", 2)
    assert abstract_mesh((1, 4), coords=(0, 3)).subgroup(
        "model", runs) is None
    with pytest.raises(ValueError, match="do not cover"):
        abstract_mesh((1, 4)).subgroup("model", (2, 1))


def test_zero_cuts_another_axis_beside_an_uneven_one():
    """ZeRO-2 takes the Uneven axis as cut over "model" and cuts the
    first whole axis that divides over "data"."""
    from repro_torch.train.optimizer import _zero_spec

    e = Uneven("model", BOUNDS["uneven"])
    assert _zero_spec((None, e), (4, 9), 2) == ("data", e)
    assert _zero_spec((e, None), (9, 4), 2) == (e, "data")
    assert _zero_spec((e,), (9,), 2) == (e,)


#: hymba-1.5b's blocks by "model" size: (KV heads, query heads, Mamba
#: heads) a rank
HYMBA = {2: ([3, 2], [15, 10], [13, 12]),
         4: ([2, 1, 1, 1], [10, 5, 5, 5], [7, 6, 6, 6]),
         16: ([1] * 16, [2, 1, 1, 1] + [2, 2, 1] * 4, [2] * 9 + [1] * 7)}


@pytest.mark.parametrize("m", list(HYMBA))
def test_hymba_blocks_on_the_model_axis(m):
    cfg = get_config("hymba-1.5b")
    plan = tf.tp_plan(cfg, tf.Runtime(abstract_mesh((256 // m, m))))
    kv, q, mamba = HYMBA[m]
    assert plan.attn
    assert [b - a for a, b in plan.kv_blocks] == kv
    assert [b - a for a, b in plan.q_blocks] == q
    assert [b - a for a, b in plan.mamba_blocks] == mamba
    # every query head reads its own KV head (g = 5)
    for (qa, qb), (ka, kb) in zip(plan.q_blocks, plan.kv_blocks):
        assert (qa // 5, -(-qb // 5)) == (ka, kb)
    runs = Uneven("model", plan.kv_blocks).runs
    assert runs == ((4, 3, 3, 3, 3) if m == 16 else (1,) * m)
    # rank 0 holds the largest blocks: the dry-run records the fullest
    assert plan.kv_heads(cfg) == max(kv)


def test_a_run_longer_than_its_query_heads_keeps_attention_whole():
    """9 query heads over 3 KV heads (g = 3) on "model" = 16: runs of 6,
    5, 5 ranks, more than 3 query heads to cut; the Mamba heads are
    still cut (runs of two ranks on the first seven heads)."""
    assert tf.hybrid_blocks(9, 3, 16) is None
    assert tf.hybrid_blocks(9, 3, 9) is not None
    assert tf.head_blocks(9, 16)[:3] == ((0, 1), (0, 1), (1, 2))


# ------------------------------------------------- four gloo ranks

def _uneven_rank(rank: int) -> dict:
    from repro_torch.launch.mesh import all_reduce, gather_to, make_mesh
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.trainer import reduce_grads

    mesh = make_mesh((1, 4), device="cpu")
    out = {}
    for case, bounds in BOUNDS.items():
        entry = Uneven("model", bounds)
        pl = Placement(mesh, (None, entry))
        full = torch.randn(3, entry.size, 2,
                           generator=torch.Generator().manual_seed(0))
        out[case, "round"] = pl.gather(pl.shard(full))
        for reduce in (True, False):
            # each rank's own weights (its part of a sum), or the same
            seed = 10 + (rank if reduce else 0)
            w = torch.randn(full.shape,
                            generator=torch.Generator().manual_seed(seed))
            x = pl.shard(full).requires_grad_(True)
            y = gather_to(x, mesh, entry, 1, reduce=reduce)
            (y * w).sum().backward()
            g = x.grad.clone()
            if max(entry.runs) > 1:
                group = mesh.subgroup("model", entry.runs)
                if group is not None:
                    all_reduce(g, group)
            out[case, "grad", reduce] = (y.detach(), pl.gather(g))
        whole = Placement(mesh, ())
        out[case, "norm"] = float(global_norm(
            [pl.shard(full), torch.ones(5)], [pl, whole]))
        # a partial gradient of this rank's block: rank r's is r + 1
        part = torch.full(pl.local_shape(tuple(full.shape)), rank + 1.0)
        out[case, "reduced"] = reduce_grads([part], [pl])[0]
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world(_uneven_rank, 4, tmp_path_factory.mktemp("uneven"),
                     deadline_s=300, timeout_s=120)


def _full_of(bounds) -> torch.Tensor:
    return torch.randn(3, Uneven("model", bounds).size, 2,
                       generator=torch.Generator().manual_seed(0))


@pytest.mark.parametrize("case", list(BOUNDS))
def test_shard_then_gather_round_trips(world, case):
    full = _full_of(BOUNDS[case])
    for res in world:
        assert torch.equal(res[case, "round"], full)


@pytest.mark.parametrize("reduce", [True, False], ids=["summed", "alike"])
@pytest.mark.parametrize("case", list(BOUNDS))
def test_gather_to_backward_matches_one_process(world, case, reduce):
    """One process: ``f(x) = sum_r (x * w_r).sum()`` where each rank
    contributes its part (``reduce``), else ``(x * w).sum()`` run alike
    on every rank; the ranks' gradients, summed over each run and
    gathered, are autograd's of ``f``."""
    full = _full_of(BOUNDS[case]).requires_grad_(True)
    ranks = range(4) if reduce else [0]
    f = sum((full * torch.randn(full.shape, generator=torch.Generator()
                                .manual_seed(10 + r))).sum() for r in ranks)
    (want,) = torch.autograd.grad(f, full)
    for res in world:
        y, g = res[case, "grad", reduce]
        assert torch.equal(y, full.detach())
        assert torch.allclose(g, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", list(BOUNDS))
def test_global_norm_counts_each_block_once(world, case):
    full = _full_of(BOUNDS[case])
    want = float(torch.sqrt(torch.sum(torch.square(full)) + 5))
    for res in world:
        assert res[case, "norm"] == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("case", list(BOUNDS))
def test_reduce_grads_sums_a_shared_block_over_its_run(world, case):
    """Ranks 0 and 1 share a block under "runs": each then holds 1 + 2;
    a block one rank holds keeps its own part."""
    bounds = BOUNDS[case]
    for rank, res in enumerate(world):
        got = res[case, "reduced"]
        run = [r for r in range(4) if bounds[r] == bounds[rank]]
        assert torch.equal(got, torch.full_like(got, float(
            sum(r + 1 for r in run))))
    values = [float(r[case, "reduced"].max()) for r in world]
    assert values == ([3.0, 3.0, 3.0, 4.0] if case == "runs"
                      else [1.0, 2.0, 3.0, 4.0])
