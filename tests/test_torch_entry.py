"""The port's entry module and examples (``graphflow_tpu_torch/entry.py``,
``graphflow_tpu_torch/examples/``) on the CPU: ``entry()`` against the JAX
package's ``__graft_entry__.entry()`` on the same weights in float64, the
three modes of ``dryrun_multichip`` on four CPU ranks, each example's
``main`` for one or two epochs, and the device rule: without ``device``
every new entry point takes the card, or raises where there is none."""

import jax
import numpy as np
import pytest
import torch

from graphflow_tpu_torch import entry as port_entry
from graphflow_tpu_torch import parallel
from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.examples import (multichip_data_parallel,
                                          partitioned_training,
                                          permutation_invariance,
                                          train_mnist_cnn, train_smp_omega)
from graphflow_tpu_torch.models.smp2d import SMP2DConfig
from graphflow_tpu_torch.optim import make_optimizer
from graphflow_tpu_torch.utils.convert import params_from_jax
from graphflow_tpu_torch.utils.datasets import random_graph

torch.set_num_threads(1)

RTOL = 1e-9


def test_entry_matches_jax_entry():
    """The forward of SMP_omega(10, 4, 2, 16, 4, 5) on the four toy
    molecules, both packages on JAX's weights cast to float64 (the batches'
    float fields are 0/1 masks and small integers, exact in either
    type)."""
    import __graft_entry__ as jentry

    jfn, (jparams, jbatch) = jentry.entry()
    jparams = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float64),
                                     jparams)
    ref = np.asarray(jax.jit(jfn)(jparams, jbatch))

    fn, (params, batch) = port_entry.entry(device="cpu")
    assert set(params_from_jax(jparams)) == {
        "H", "W", "levels/0/K", "levels/0/b", "levels/1/K", "levels/1/b"}
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()}
    for k in ("wl_feat", "vmask", "nbr", "pos", "radj", "smask"):
        assert np.array_equal(batch[k].numpy(), np.asarray(jbatch[k])), k
    from graphflow_tpu_torch.utils.convert import unflatten
    got = fn(unflatten(params_from_jax(jparams)), batch).detach().numpy()
    assert got.shape == (4,)
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=RTOL * max(1.0, np.abs(ref).max()))


def test_dryrun_multichip_on_cpu_ranks():
    """The three modes on four ranks: each rank checks its numbers against
    one process (a DP step, a partitioned forward, a data x graph train
    step) and raises on a mismatch; on the CPU no kernel launches."""
    reports = port_entry.dryrun_multichip(4, device="cpu")
    assert len(reports) == 4
    for r in reports:
        assert set(r) == {"dp", "forward", "train", "launches"}
        for got, ref in (r["dp"], r["forward"], r["train"]):
            assert np.isfinite(got) and abs(got - ref) <= 1e-4 * max(1, abs(ref))
        assert set(r["launches"].values()) == {0}
    assert len({r["dp"] for r in reports}) == 1


def test_examples_run_a_few_epochs():
    losses = train_smp_omega.main(2, device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert losses[0][1] < losses[0][0]
    gaps = permutation_invariance.main(2, device="cpu")
    assert len(gaps) == 2 and max(gaps) < 1e-4
    accuracy = train_mnist_cnn.main(1, mnist_dir="no-such-dir",
                                    device="cpu")
    assert len(accuracy) == 1 and 0.0 <= accuracy[0] <= 1.0


def test_multi_rank_examples_run_a_few_epochs():
    dp = multichip_data_parallel.main(2, n_ranks=2, device="cpu")
    assert len(dp) == 2 and dp[0]["losses"] == dp[1]["losses"]
    assert len(dp[0]["losses"]) == 2
    assert set(dp[0]["launches"].values()) == {0}
    part = partitioned_training.main(2, n_ranks=4, device="cpu")
    assert len(part) == 4 and all(p["losses"] == part[0]["losses"]
                                  for p in part)
    targeted, allgather = part[0]["rows"]
    assert 0 < targeted <= allgather
    assert np.isfinite(part[0]["losses"]).all()


def _partition_args():
    cfg = SMP2DConfig(max_nVertices=8, max_receptive_field=3, nLevels=1,
                      nChanels=4, nFeatures=4, nDepth=2)
    plan = parallel.plan_partition(
        prep.prepare_graph(random_graph(8, 0.3, seed=1), 1, 8, 3, 2), 1)
    return cfg, plan, parallel.make_mesh({"graph": 1})


ENTRY_POINTS = {
    "entry": lambda: port_entry.entry(),
    "dryrun_multichip": lambda: port_entry.dryrun_multichip(2),
    "train_smp_omega": lambda: train_smp_omega.main(1),
    "permutation_invariance": lambda: permutation_invariance.main(1),
    "train_mnist_cnn": lambda: train_mnist_cnn.main(1, "no-such-dir"),
    "multichip_data_parallel": lambda: multichip_data_parallel.main(1),
    "partitioned_training": lambda: partitioned_training.main(1),
    "run_ranks": lambda: parallel.run_ranks(print, 2),
    "shard_inputs": lambda: parallel.shard_inputs(*_partition_args()[1:]),
    "make_partitioned_forward": lambda: parallel.make_partitioned_forward(
        *_partition_args()),
    "make_partitioned_train_step":
        lambda: parallel.make_partitioned_train_step(
            *_partition_args()[:2], make_optimizer("adam"),
            _partition_args()[2], data_axis=None),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_never_lands_on_the_cpu_unasked(name, monkeypatch):
    """Without ``device`` and without a card, every new entry point raises
    before it computes anything (the rule of ``tests/test_torch_smp2d.py``'s
    test of the same name)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("cards,backend,devices", [
    (1, "gloo", ("cuda:0",) * 4),
    (2, "gloo", ("cuda:0",) * 4),
    (4, "nccl", ("cuda:0", "cuda:1", "cuda:2", "cuda:3")),
    (8, "nccl", ("cuda:0", "cuda:1", "cuda:2", "cuda:3"))])
def test_placement_of_ranks(monkeypatch, cards, backend, devices):
    """Four ranks: a card each over NCCL where there are enough cards, else
    all on the first card over gloo; the CPU only when asked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert parallel.placement(4) == (backend, devices)
    assert parallel.placement(4, device="cpu") == ("gloo", ("cpu",) * 4)
