"""The port's process groups and data-parallel step
(``graphflow_tpu_torch/parallel/mesh.py``, ``data_parallel.py``) against
the JAX package's mesh and ``make_dp_train_step`` on its 8 virtual CPU
devices (``tests/test_multihost.py``), in float64.

One world of eight CPU ranks (gloo, spawned, ``file://`` rendezvous) runs
every port-side computation once (``_rank``): the coordinates and groups of
a data x graph mesh and of a host x data hybrid mesh, sums over their
groups, and one data-parallel Adam step of SMP_omega over both hybrid axes.
The spawned ranks import this module, so JAX is imported only inside the
parent's fixtures.  Values hold to 1e-9 * max(1, scale); replicas must be
equal bit for bit.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from graphflow_tpu_torch import parallel
from graphflow_tpu_torch.models import SMP2D, SMP2DConfig
from graphflow_tpu_torch.utils.convert import flatten, params_from_jax
from graphflow_tpu_torch.utils.datasets import toy_molecules

torch.set_num_threads(1)

RTOL = 1e-9
WORLD = 8
# tests/test_multihost.py:65-66's model, in float64.
CFG = dict(max_nVertices=8, max_receptive_field=3, nLevels=1, nChanels=4,
           nFeatures=4, nDepth=2, dtype="float64")
LR = 0.001


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _toy(n):
    graphs, targets = toy_molecules()
    return [graphs[i % 4] for i in range(n)], [targets[i % 4]
                                               for i in range(n)]


def _group_sum(value, group):
    x = torch.tensor([float(value)], dtype=torch.float64)
    dist.all_reduce(x, group=group)
    return float(x)


def _rank(rank, device, payload):
    out = {}
    grid = parallel.make_mesh({"data": 2, "graph": 4})
    out["grid"] = {
        "coords": grid.coords, "ranks": grid.ranks.copy(),
        "slices": {a: grid.slice_ranks(a) for a in
                   ("data", "graph", ("data", "graph"), ("graph", "data"))},
        "index": {a: grid.index(a) for a in ("data", "graph",
                                             ("data", "graph"))},
        "sums": {a: _group_sum(rank, grid.group(a))
                 for a in ("data", "graph", ("data", "graph"))},
        "share": parallel.data_sharding(grid, 8, "data"),
    }
    hybrid = parallel.make_hybrid_mesh({"host": 2}, {"data": 4})
    out["hybrid"] = {
        "names": hybrid.axis_names, "shape": hybrid.shape,
        "coords": hybrid.coords, "ranks": hybrid.ranks.copy(),
        "row": _group_sum(rank, hybrid.group("data")),
        "both": _group_sum(rank, hybrid.group(("host", "data"))),
    }

    model = SMP2D(SMP2DConfig(**CFG), device=device)
    # Every rank but the first starts from other weights: replicate() must
    # hand all of them the first rank's.
    model.load_params({k: v + rank for k, v in
                       params_from_jax(payload["params"]).items()})
    axis = ("host", "data")
    step = parallel.make_dp_train_step(model._loss, model.opt, hybrid, axis)
    batch = parallel.shard_batch(model._stack(*_toy(WORLD)), hybrid, axis)
    params = parallel.replicate(model.param_dict(), hybrid)
    params, state, loss = step(params, model.opt_state, batch, LR)
    out["dp"] = (float(loss), int(batch["vmask"].shape[0]), state["t"],
                 {k: v.detach().numpy().copy() for k, v in params.items()})
    return out


@pytest.fixture(scope="module")
def jax_side():
    """JAX's weights and its data-parallel step on the 2 x 4 hybrid mesh
    of virtual CPU devices (tests/test_multihost.py:62-79)."""
    import jax
    from graphflow_tpu import parallel as jparallel
    from graphflow_tpu.models import SMP2D as JSMP2D
    from graphflow_tpu.models import SMP2DConfig as JCfg
    from graphflow_tpu.utils.datasets import toy_molecules as jtoy

    model = JSMP2D(JCfg(**CFG, use_fused_kernel=False), seed=0)
    params0 = jax.tree_util.tree_map(np.asarray, model.params)
    mesh = jparallel.make_hybrid_mesh({"host": 2}, {"data": 4},
                                      devices=jax.devices("cpu"))
    axis = ("host", "data")
    step = jparallel.make_dp_train_step(model._loss, model.opt, mesh,
                                        axis=axis)
    graphs, targets = jtoy()
    batch = model._stack([graphs[i % 4] for i in range(WORLD)],
                         [targets[i % 4] for i in range(WORLD)])
    params, _, loss = step(jparallel.replicate(model.params, mesh),
                           jparallel.replicate(model.opt_state, mesh),
                           jparallel.shard_batch(batch, mesh, axis=axis), LR)
    return {"params0": params0, "loss": float(loss),
            "params": jax.tree_util.tree_map(np.asarray, params)}


@pytest.fixture(scope="module")
def ranks(jax_side):
    return parallel.run_ranks(_rank, WORLD,
                              ({"params": jax_side["params0"]},),
                              device="cpu")


def test_init_distributed_single_process_noop(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert parallel.init_distributed() == 1
    assert parallel.init_distributed() == 1
    assert not dist.is_initialized()
    mesh = parallel.make_mesh()
    assert mesh.axis_names == ("data",) and mesh.shape == (1,)
    assert mesh.group("data") is None and mesh.index("data") == 0


def test_mesh_coordinates_and_groups(ranks):
    """Ranks lie on the data x graph mesh in row-major order, as the JAX
    package reshapes its devices; each group is this rank's slice."""
    grid = np.arange(WORLD).reshape(2, 4)
    for r, out in enumerate(ranks):
        m = out["grid"]
        d, g = divmod(r, 4)
        assert np.array_equal(m["ranks"], grid)
        assert m["coords"] == {"data": d, "graph": g}
        assert m["slices"]["data"] == tuple(grid[:, g])
        assert m["slices"]["graph"] == tuple(grid[d])
        assert m["slices"][("data", "graph")] == tuple(range(WORLD))
        assert m["slices"][("graph", "data")] == tuple(grid.T.reshape(-1))
        assert m["index"] == {"data": d, "graph": g, ("data", "graph"): r}
        assert m["sums"] == {"data": float(grid[:, g].sum()),
                             "graph": float(grid[d].sum()),
                             ("data", "graph"): float(grid.sum())}
        assert m["share"] == slice(4 * d, 4 * d + 4)


def test_hybrid_mesh_shape_and_axis_order(ranks):
    """tests/test_multihost.py:29-37: the host axis leads and the ranks of
    one host are contiguous, so a card axis never crosses hosts."""
    flat = np.arange(WORLD).reshape(2, 4)
    for r, out in enumerate(ranks):
        h = out["hybrid"]
        assert h["names"] == ("host", "data") and h["shape"] == (2, 4)
        assert np.array_equal(h["ranks"], flat)
        assert h["coords"] == {"host": r // 4, "data": r % 4}


def test_hybrid_mesh_collectives(ranks):
    """tests/test_multihost.py:40-59: a sum over the card axis stays within
    a host row (0+1+2+3 = 6, 4+5+6+7 = 22); over both axes it is the
    global sum."""
    assert [out["hybrid"]["row"] for out in ranks] == [6.0] * 4 + [22.0] * 4
    assert [out["hybrid"]["both"] for out in ranks] == [28.0] * WORLD


def test_hybrid_mesh_refuses_a_shared_axis():
    with pytest.raises(ValueError, match="both host and card"):
        parallel.make_hybrid_mesh({"data": 1}, {"data": 1})


def test_dp_step_matches_jax_and_batch_learn(ranks, jax_side):
    """One DP Adam step over both hybrid axes, one graph per rank: its loss
    and post-step parameters equal JAX's ``make_dp_train_step`` and the
    port's single-process ``BatchLearn`` on the whole batch, the same
    weights and the nBatch schedule."""
    model = SMP2D(SMP2DConfig(**CFG), device="cpu")
    model.load_params(params_from_jax(jax_side["params0"]))
    loss_before, _ = model.BatchLearn(*_toy(WORLD), LR)
    single = {k: v.detach().numpy() for k, v in model.param_dict().items()}
    ref = flatten(jax_side["params"])
    for out in ranks:
        loss, shard, t, params = out["dp"]
        assert shard == 1 and t == 1
        _close(loss, jax_side["loss"])
        _close(loss, loss_before)
        assert set(params) == set(ref)
        for k in ref:
            _close(params[k], ref[k])
            _close(params[k], single[k])


def test_replicas_stay_bit_identical(ranks):
    """Every rank started from other weights; after replicate() and a
    step, all hold the same bits."""
    first = ranks[0]["dp"][3]
    for out in ranks[1:]:
        assert all(np.array_equal(out["dp"][3][k], first[k]) for k in first)
