"""The port's vertex-partitioned SMP2D (``graphflow_tpu_torch/parallel/
partition.py``) against the JAX package's on its 8 virtual CPU devices, in
float64: the plan bit for bit, the partitioned forward with both halos at
2 and 4 shards, Adam and classification train steps on a data x graph
mesh, the 4/10/50-case contractions, a step whose gradients would be S
times too large if ``_PartialSum`` all-reduced in its backward, and blocks
left empty by the interior-first order.

One world of four CPU ranks (gloo, spawned, ``file://`` rendezvous) runs
every port-side computation of the module once (``_rank``); the tests
compare what each rank returns.  The S = 2 cases run on a data 2 x graph 2
mesh with the batch whole on each data row.  The spawned ranks import
this module, so JAX is imported only inside the parent's fixtures.

Every comparison holds to 1e-9 * max(1, scale) (float64 on both sides;
the shards sum in another order than one process).
"""

import numpy as np
import pytest
import torch

from graphflow_tpu_torch import parallel
from graphflow_tpu_torch.core import batching, prep
from graphflow_tpu_torch.models.smp2d import SMP2DConfig, smp2d_forward
from graphflow_tpu_torch.optim import make_optimizer
from graphflow_tpu_torch.utils.convert import (flatten, params_from_jax,
                                               unflatten)
from graphflow_tpu_torch.utils.datasets import random_graph

torch.set_num_threads(1)

RTOL = 1e-9
WORLD = 4
# tests/test_partition.py:24-37: V = 24, P = 4, C = 6, two levels.
CFG = dict(max_nVertices=24, max_receptive_field=4, nLevels=2, nChanels=6,
           nFeatures=4, nDepth=3, dtype="float64")
SMALL = dict(max_nVertices=16, max_receptive_field=4, nLevels=1,
             nChanels=4, nFeatures=4, nDepth=2, dtype="float64")
TRAIN_SEEDS = (5, 6, 7, 8)
LR = 0.01
# SGD's step shows the gradient itself (Adam's m / sqrt(v) hides a scale).
SGD_LR = 0.05


def _close(got, ref, rtol=RTOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _prepare(g, cfg):
    return prep.prepare_graph(g, cfg["nLevels"], cfg["max_nVertices"],
                              cfg["max_receptive_field"], cfg["nDepth"],
                              dtype=np.float64)


def _block_graph(V, S):
    """Edges only inside each shard's block of V / S vertices: nothing
    crosses, so every vertex is interior and the boundary block is
    empty."""
    from graphflow_tpu_torch.core.graph import DenseGraph

    Vs = V // S
    rng = np.random.default_rng(3)
    edges = [(u, v) for u in range(V) for v in range(u + 1, V)
             if u // Vs == v // Vs and rng.random() < 0.4]
    return DenseGraph.from_edges(V, 4, edges, np.eye(4)[rng.integers(
        0, 4, size=V)])


def _cross_graph(V, S):
    """A path inside each shard's block, and each vertex of an even block
    matched to the same place in the next block: every vertex references
    another shard at the first level, so no vertex is interior."""
    from graphflow_tpu_torch.core.graph import DenseGraph

    Vs = V // S
    edges = [(v, v + 1) for v in range(V - 1) if (v + 1) % Vs]
    edges += [(v, v + Vs) for v in range(V) if (v // Vs) % 2 == 0]
    feats = np.eye(4)[np.random.default_rng(4).integers(0, 4, size=V)]
    return DenseGraph.from_edges(V, 4, edges, feats)


# The graphs of each case, by name: (cfg, graphs, S).
def _cases():
    g24 = [random_graph(24, 0.25, seed=5)]
    return {
        "forward": (CFG, g24, None),
        "train": (CFG, [random_graph(24, 0.25, seed=s) for s in TRAIN_SEEDS],
                  2),
        "classify": (dict(SMALL, nClasses=3),
                     [random_graph(16, 0.3, seed=s) for s in (1, 2)], 2),
        "contraction": (SMALL, [random_graph(16, 0.3, seed=11)], 4),
        "no_interior": (CFG, [_cross_graph(24, 4)], 4),
        "no_boundary": (CFG, [_block_graph(24, 2)], 2),
    }


def _rank(rank, device, payload):
    """Every port-side computation of the module on one rank of four."""
    out = {}
    cases = _cases()
    grid = parallel.make_mesh({"data": 2, "graph": 2})
    ring = parallel.make_mesh({"graph": WORLD})

    def params_of(tree):
        return params_from_jax(tree)

    def forward(cfg, plan, mesh, halo, params, data_axis):
        fwd = parallel.make_partitioned_forward(SMP2DConfig(**cfg), plan,
                                                mesh, halo=halo,
                                                device=device)
        inputs = parallel.shard_inputs(plan, mesh, device=device,
                                       data_axis=data_axis)
        pred, feat = fwd(unflatten(params), inputs)
        return pred.detach().numpy(), feat.detach().numpy()

    cfg, graphs, _ = cases["forward"]
    pg = _prepare(graphs[0], cfg)
    params = params_of(payload["forward"])
    for S, mesh in ((2, grid), (WORLD, ring)):
        plan = parallel.plan_partition(pg, S)
        for halo in ("targeted", "all_gather"):
            out[("forward", S, halo)] = forward(cfg, plan, mesh, halo,
                                                params, None)

    for name in ("no_interior", "no_boundary"):
        cfg, graphs, S = cases[name]
        plan = parallel.plan_partition(_prepare(graphs[0], cfg), S)
        for halo in ("targeted", "all_gather"):
            out[(name, halo)] = (plan.n_interior, forward(
                cfg, plan, grid if S == 2 else ring, halo, params, None))

    cfg, graphs, _ = cases["contraction"]
    plan = parallel.plan_partition(_prepare(graphs[0], cfg), WORLD)
    for k in (4, 10, 50):
        out[("contraction", k)] = forward(
            dict(cfg, contraction=k), plan, ring, "targeted",
            params_of(payload[("contraction", k)]), None)

    for name, opt_name, lr in (("train", "adam", LR),
                               ("classify", "adam", LR),
                               ("sgd", "sgd", SGD_LR)):
        cfg, graphs, _ = cases["classify" if name == "classify"
                               else "train"]
        plan = parallel.plan_partition_batch(
            [_prepare(g, cfg) for g in graphs], 2)
        opt = make_optimizer(opt_name)
        step = parallel.make_partitioned_train_step(
            SMP2DConfig(**cfg), plan, opt, grid, device=device)
        params = {k: v.clone().requires_grad_()
                  for k, v in params_of(payload[name]).items()}
        params, _, loss = step(params, opt.init(params),
                               parallel.shard_inputs(plan, grid,
                                                     device=device),
                               payload[(name, "targets")], lr)
        out[name] = (float(loss), {k: v.detach().numpy()
                                   for k, v in params.items()})
    return out


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's results of every case, and the weights the ranks
    get (JAX's draws, as NumPy arrays)."""
    import jax
    import jax.numpy as jnp
    from graphflow_tpu.core import batching as jbatching
    from graphflow_tpu.core import prep as jprep
    from graphflow_tpu.models.smp2d import SMP2DConfig as JCfg
    from graphflow_tpu.models.smp2d import init_smp2d_params
    from graphflow_tpu.models.smp2d import smp2d_forward as jforward
    from graphflow_tpu.ops import losses as jlosses
    from graphflow_tpu.optim.optimizers import make_optimizer as jmake_opt
    from graphflow_tpu.parallel import mesh as jmesh
    from graphflow_tpu.parallel import partition as jpart

    cpus = jax.devices("cpu")

    def jprepare(g, cfg):
        return jprep.prepare_graph(g, cfg["nLevels"], cfg["max_nVertices"],
                                   cfg["max_receptive_field"], cfg["nDepth"],
                                   dtype=np.float64)

    def jgraphs(graphs):
        # The same draws in the JAX package's own DenseGraph.
        from graphflow_tpu.core.graph import DenseGraph as JDense
        return [JDense.from_edges(g.nVertices, g.nFeatures,
                                  np.argwhere(np.triu(g.adj, 1)), g.feature)
                for g in graphs]

    def numpy_tree(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    res, payload = {}, {}
    cases = _cases()

    def jforward_part(cfg, pg, S, halo, params):
        plan = jpart.plan_partition(pg, S)
        m = jmesh.make_mesh({"graph": S}, devices=cpus)
        fwd = jpart.make_partitioned_forward(JCfg(**cfg), plan, m, halo=halo)
        pred, feat = fwd(params, jpart.shard_inputs(plan))
        return np.asarray(pred), np.asarray(feat)

    def junsharded(cfg, pg, params):
        g0 = jax.tree_util.tree_map(lambda x: x[0],
                                    jbatching.stack_graphs([pg]))
        pred, feat = jforward(params, g0, JCfg(**cfg))
        return np.asarray(pred), np.asarray(feat)

    cfg, graphs, _ = cases["forward"]
    params = init_smp2d_params(jax.random.PRNGKey(0), JCfg(**cfg))
    payload["forward"] = numpy_tree(params)
    pg = jprepare(jgraphs(graphs)[0], cfg)
    res["unsharded"] = junsharded(cfg, pg, params)
    for S in (2, WORLD):
        for halo in ("targeted", "all_gather"):
            res[("forward", S, halo)] = jforward_part(cfg, pg, S, halo,
                                                      params)
    for name in ("no_interior", "no_boundary"):
        cfg, graphs, S = cases[name]
        pg = jprepare(jgraphs(graphs)[0], cfg)
        res[(name, "unsharded")] = junsharded(cfg, pg, params)
        for halo in ("targeted", "all_gather"):
            res[(name, halo)] = jforward_part(cfg, pg, S, halo, params)

    cfg, graphs, _ = cases["contraction"]
    pg = jprepare(jgraphs(graphs)[0], cfg)
    for k in (4, 10, 50):
        kcfg = dict(cfg, contraction=k)
        kparams = init_smp2d_params(jax.random.PRNGKey(2), JCfg(**kcfg))
        payload[("contraction", k)] = numpy_tree(kparams)
        res[("contraction", k)] = jforward_part(kcfg, pg, WORLD, "targeted",
                                                kparams)

    for name, key, opt_name, lr in (("train", 0, "adam", LR),
                                    ("classify", 3, "adam", LR),
                                    ("sgd", 0, "sgd", SGD_LR)):
        cfg, graphs, _ = cases["classify" if name == "classify"
                               else "train"]
        jcfg = JCfg(**cfg)
        params = init_smp2d_params(jax.random.PRNGKey(key), jcfg)
        payload[name] = numpy_tree(params)
        pgs = [jprepare(g, cfg) for g in jgraphs(graphs)]
        targets = (np.array([0, 2], np.int32) if cfg.get("nClasses")
                   else np.array([float(g.nVertices) for g in graphs]))
        payload[(name, "targets")] = targets
        plan = jpart.plan_partition_batch(pgs, 2)
        m = jmesh.make_mesh({"data": 2, "graph": 2}, devices=cpus[:4])
        opt = jmake_opt(opt_name)
        step = jpart.make_partitioned_train_step(jcfg, plan, opt, m)
        new, _, loss = step(params, opt.init(params),
                            jpart.shard_inputs(plan), jnp.asarray(targets),
                            lr)
        res[name] = (float(loss), numpy_tree(new))
        # The single-process step: the batch loss's own gradients.
        batch = jbatching.stack_graphs(pgs, targets.astype(np.float64))

        def batch_loss(p):
            def one(g, t):
                out, _ = jforward(p, g, jcfg)
                if cfg.get("nClasses"):
                    return jlosses.log_loss(out, t.astype(jnp.int32))
                return jlosses.squared_loss(out, t)
            return jax.vmap(one)(batch, batch["target"]).sum()

        loss_s, grads = jax.value_and_grad(batch_loss)(params)
        ref, _ = jmake_opt(opt_name).update(params, opt.init(params), grads,
                                            lr, nBatch=len(graphs))
        res[(name, "single")] = (float(loss_s), numpy_tree(ref))
    return res, payload


@pytest.fixture(scope="module")
def ranks(jax_side):
    _, payload = jax_side
    return parallel.run_ranks(_rank, WORLD, (payload,), device="cpu")


# -- the plan ----------------------------------------------------------------

PLAN_CASES = [(24, 0.25, 5, S) for S in (2, 4, 8)] + [(21, 0.3, 9, 8)]


@pytest.mark.parametrize("V,p,seed,S", PLAN_CASES)
def test_plan_equals_jax_bit_for_bit(V, p, seed, S):
    """Every array of the plan, its shapes, scalars and per-level counts
    equal the JAX plan's; V = 21 on 8 shards pads to 24."""
    from graphflow_tpu.core.graph import DenseGraph as JDense
    from graphflow_tpu.core import prep as jprep
    from graphflow_tpu.parallel import partition as jpart

    g = random_graph(V, p, seed=seed)
    jg = JDense.from_edges(V, 4, np.argwhere(np.triu(g.adj, 1)), g.feature)
    args = (2, V, 4, 3)
    got = parallel.plan_partition(prep.prepare_graph(g, *args), S)
    ref = jpart.plan_partition(jprep.prepare_graph(jg, *args), S)
    assert got.Vs * S == -(-V // S) * S
    for f in ("n_shards", "Vs", "H", "n_interior", "shift_sizes",
              "rows_targeted", "rows_allgather", "comm_per_level", "batch"):
        assert getattr(got, f) == getattr(ref, f), f
    for f in ("exp_idx", "exp_mask", "nbr_loc", "nbr_ag", "pos", "radj",
              "smask", "wl_feat", "vmask"):
        a, b = getattr(got, f), getattr(ref, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for a, b in zip(got.send_idx + got.send_mask, ref.send_idx + ref.send_mask):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got.comm_table(row_bytes=4 * 5 * 5 * 6) == ref.comm_table(
        row_bytes=4 * 5 * 5 * 6)


def test_batch_plan_equals_jax_bit_for_bit():
    from graphflow_tpu.core.graph import DenseGraph as JDense
    from graphflow_tpu.core import prep as jprep
    from graphflow_tpu.parallel import partition as jpart

    graphs = [random_graph(24, 0.25, seed=s) for s in TRAIN_SEEDS]
    args = (2, 24, 4, 3)
    got = parallel.plan_partition_batch(
        [prep.prepare_graph(g, *args) for g in graphs], 4)
    ref = jpart.plan_partition_batch(
        [jprep.prepare_graph(JDense.from_edges(
            24, 4, np.argwhere(np.triu(g.adj, 1)), g.feature), *args)
         for g in graphs], 4)
    assert got.shift_sizes == ref.shift_sizes and got.batch == 4
    for f in ("nbr_loc", "nbr_ag", "pos", "radj", "smask", "wl_feat",
              "vmask", "exp_idx", "exp_mask"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    for a, b in zip(got.send_idx + got.send_mask, ref.send_idx + ref.send_mask):
        assert np.array_equal(a, b)


def test_targeted_halo_is_smaller():
    """The per-pair exchange receives fewer rows than the all_gather
    broadcast and than the vertex set (tests/test_partition.py:54-61)."""
    pg = prep.prepare_graph(random_graph(24, 0.25, seed=5), 2, 24, 4, 3)
    plan = parallel.plan_partition(pg, 8)
    assert plan.rows_targeted < plan.rows_allgather
    assert plan.rows_targeted < pg.vmask.shape[0]
    for row in plan.comm_per_level:
        assert row["targeted_max"] <= row["allgather"]
        assert 0 <= row["targeted_mean"] <= row["targeted_max"]
    assert "KiB" in plan.comm_table(row_bytes=4 * 5 * 5 * 6)


# -- the ranks ---------------------------------------------------------------

@pytest.mark.parametrize("halo", ["targeted", "all_gather"])
@pytest.mark.parametrize("S", [2, WORLD])
def test_partitioned_forward_matches_jax_and_unsharded(ranks, jax_side, S,
                                                       halo):
    res, payload = jax_side
    params = params_from_jax(payload["forward"])
    pg = _prepare(random_graph(24, 0.25, seed=5), CFG)
    pred_s, feat_s = smp2d_forward(unflatten(params),
                                   batching.stack_graphs([pg]),
                                   SMP2DConfig(**CFG))
    _close(pred_s.detach()[0], res["unsharded"][0])
    for out in ranks:
        pred, feat = out[("forward", S, halo)]
        for ref in (res[("forward", S, halo)], res["unsharded"]):
            _close(pred, ref[0])
            _close(feat, ref[1])
        _close(feat, feat_s.detach()[0])


@pytest.mark.parametrize("halo", ["targeted", "all_gather"])
@pytest.mark.parametrize("name", ["no_interior", "no_boundary"])
def test_empty_block(ranks, jax_side, name, halo):
    """Blocks with no vertex: the interior block when every vertex looks
    across shards, the boundary block when none does.  Nothing is launched
    for them and the forward still equals JAX's and the unsharded one."""
    res, _ = jax_side
    Vs = 24 // _cases()[name][2]
    for out in ranks:
        n_interior, (pred, feat) = out[(name, halo)]
        assert n_interior == (0 if name == "no_interior" else Vs)
        for ref in (res[(name, halo)], res[(name, "unsharded")]):
            _close(pred, ref[0])
            _close(feat, ref[1])


@pytest.mark.parametrize("k", [4, 10, 50])
def test_partitioned_forward_other_contractions(ranks, jax_side, k):
    res, _ = jax_side
    for out in ranks:
        for got, ref in zip(out[("contraction", k)], res[("contraction", k)]):
            _close(got, ref)


def _close_tree(got, ref_tree):
    ref = flatten(ref_tree)
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k])


@pytest.mark.parametrize("name", ["train", "classify"])
def test_partitioned_train_step_matches_jax(ranks, jax_side, name):
    """One Adam step on data x graph = 2 x 2 (the squared loss, and the log
    loss over summed class scores), on every rank: the loss equals JAX's
    partitioned step's and the single-process step's, and every post-step
    parameter the single-process step's.  JAX's partitioned step takes
    its gradients twice as large here (see the next test), which Adam's
    m / sqrt(v) cancels but where |g| is near its epsilon: there its
    parameters differ from the single-process step's by up to 1e-3."""
    res, _ = jax_side
    for out in ranks:
        loss, params = out[name]
        _close(loss, res[name][0])
        _close(loss, res[(name, "single")][0])
        _close_tree(params, res[(name, "single")][1])


def test_partial_sum_backward_is_the_identity(ranks, jax_side):
    """An SGD step's change is lr * gradient / nBatch, so it shows the
    gradient's scale: an all-reduce in ``_PartialSum``'s backward would
    make each shard's cotangent, and so every gradient, twice as large on
    this 2-shard graph axis.  The step must equal the single-process
    one."""
    res, payload = jax_side
    start = flatten(payload["sgd"])
    for out in ranks:
        loss, params = out["sgd"]
        _close(loss, res[("sgd", "single")][0])
        _close_tree(params, res[("sgd", "single")][1])
        moved = max(float(np.abs(params[k] - start[k]).max()) for k in start)
        assert moved > 1e-4


def test_jax_partitioned_step_takes_gradients_s_times_too_large(jax_side):
    """The JAX package's partitioned train step, at S = 2 shards, moves
    every parameter twice as far as its single-process step under SGD: the
    transpose of its ``psum`` over the graph axis sums the replicated
    cotangent (``graphflow_tpu/parallel/partition.py:558``).  Pinned so
    the disagreement stays visible; the port follows the single-process
    step (the test above)."""
    res, payload = jax_side
    start = flatten(payload["sgd"])
    part, single = flatten(res["sgd"][1]), flatten(res[("sgd", "single")][1])
    for k in start:
        moved = np.asarray(single[k]) - start[k]
        _close(np.asarray(part[k]) - start[k], 2 * moved)


def test_replicas_stay_identical(ranks):
    for name in ("train", "classify", "sgd"):
        first = ranks[0][name][1]
        for out in ranks[1:]:
            assert all(np.array_equal(out[name][1][k], first[k])
                       for k in first)
