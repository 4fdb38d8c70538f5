"""The port's datasets, checkpoints and profiling helpers
(``graphflow_tpu_torch/utils/{datasets,checkpoint,profiling}.py``) against
the JAX package's on the CPU: the synthetic sets bit for bit from the same
seeds, the MNIST and CIFAR-10 parsers on files this test writes, npz files
written by either package loaded into the other, the ``torch.save`` round
trip, the FLOP count, and the timers' keys."""

import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.models import SMP2D as JSMP2D
from graphflow_tpu.models import SMP2DConfig as JCfg
from graphflow_tpu.utils import checkpoint as jckpt
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu.utils import profiling as jprofiling
from graphflow_tpu_torch.models import SMP2D, SMP2DConfig
from graphflow_tpu_torch.utils import checkpoint, datasets, profiling
from graphflow_tpu_torch.utils.convert import flatten, params_from_jax

torch.set_num_threads(1)

CFG = dict(max_nVertices=10, max_receptive_field=4, nLevels=2, nChanels=6,
           nFeatures=4, nDepth=3)


def _same_graphs(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert (a.nVertices, a.nFeatures) == (b.nVertices, b.nFeatures)
        for f in ("adj", "feature", "coulomb", "distance"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("n,seed", [(1, 0), (37, 3)])
def test_synthetic_mnist_equals_jax(n, seed):
    xs, ys = datasets.synthetic_mnist(n, seed=seed)
    rx, ry = jdatasets.synthetic_mnist(n, seed=seed)
    assert xs.dtype == rx.dtype and ys.dtype == ry.dtype
    assert np.array_equal(xs, rx) and np.array_equal(ys, ry)


@pytest.mark.parametrize("kw", [dict(), dict(seed=7, min_atoms=2,
                                             max_atoms=12, n_types=6,
                                             extra_bond_p=0.6)])
def test_synthetic_molecules_equal_jax(kw):
    graphs, targets = datasets.synthetic_molecules(20, **kw)
    rgraphs, rtargets = jdatasets.synthetic_molecules(20, **kw)
    _same_graphs(graphs, rgraphs)
    assert targets == rtargets
    assert datasets.N_MOLECULE_FEATURES == jdatasets.N_MOLECULE_FEATURES


def _write_idx(tmp_path, images, labels):
    img, lab = tmp_path / "images.idx3-ubyte", tmp_path / "labels.idx1-ubyte"
    n, rows, cols = images.shape
    img.write_bytes(struct.pack(">IIII", 2051, n, rows, cols)
                    + images.tobytes())
    lab.write_bytes(struct.pack(">II", 2049, n) + labels.tobytes())
    return str(img), str(lab)


def test_mnist_parsers_equal_jax(tmp_path):
    rng = np.random.default_rng(1)
    images = rng.integers(0, 256, size=(5, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=5, dtype=np.uint8)
    img, lab = _write_idx(tmp_path, images, labels)
    xs, ys = datasets.load_mnist_images(img), datasets.load_mnist_labels(lab)
    assert xs.shape == (5, 28, 28) and xs.dtype == np.float32
    assert np.array_equal(xs, jdatasets.load_mnist_images(img))
    assert np.array_equal(ys, jdatasets.load_mnist_labels(lab))
    assert np.array_equal(xs * 255, images) and np.array_equal(ys, labels)


def test_mnist_parsers_refuse_a_wrong_magic(tmp_path):
    img, lab = _write_idx(tmp_path, np.zeros((1, 4, 4), np.uint8),
                          np.zeros(8, np.uint8))
    with pytest.raises(ValueError, match="magic 2051"):
        datasets.load_mnist_labels(img)
    with pytest.raises(ValueError, match="magic 2049"):
        datasets.load_mnist_images(lab)


def test_cifar_parser_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    raw = rng.integers(0, 256, size=(4, 3073), dtype=np.uint8)
    path = tmp_path / "data_batch_1.bin"
    path.write_bytes(raw.tobytes())
    xs, ys = datasets.load_cifar10_batch(str(path))
    rx, ry = jdatasets.load_cifar10_batch(str(path))
    assert xs.shape == (4, 32, 32, 3) and xs.dtype == rx.dtype
    assert np.array_equal(xs, rx) and np.array_equal(ys, ry)
    # Channel-major rows: pixel (0, 0) of the green plane is byte 1 + 1024.
    assert xs[0, 0, 0, 1] * 255 == raw[0, 1 + 1024]


@pytest.fixture
def pair():
    """A JAX model's weights and a port model holding them, float64."""
    jmodel = JSMP2D(JCfg(**CFG, dtype="float64"), seed=3)
    model = SMP2D(SMP2DConfig(**CFG, dtype="float64"), device="cpu")
    model.load_params(params_from_jax(jmodel.params))
    return jmodel, model


def test_leaf_order_is_jax_tree_flatten(pair):
    jmodel, model = pair
    paths = ["/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                      for k in path)
             for path, _ in jax.tree_util.tree_leaves_with_path(
                 jmodel.params)]
    order = checkpoint.leaf_order(model.param_dict())
    assert order == paths == ["H", "W", "levels/0/K", "levels/0/b",
                              "levels/1/K", "levels/1/b"]


def test_npz_written_by_jax_loads_into_the_port(pair, tmp_path):
    jmodel, model = pair
    path = str(tmp_path / "jax.npz")
    jckpt.save_npz(path, jmodel.params)
    template = {k: torch.zeros_like(v) for k, v in model.param_dict().items()}
    got = checkpoint.load_npz(path, template)
    ref = flatten(jmodel.params)
    for k in ref:
        assert got[k].dtype == torch.float64
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k]))


def test_npz_written_by_the_port_loads_into_jax(pair, tmp_path):
    jmodel, model = pair
    path = str(tmp_path / "port.npz")
    checkpoint.save_npz(path, model.param_dict())
    template = jax.tree_util.tree_map(jnp.zeros_like, jmodel.params)
    got = flatten(jckpt.load_npz(path, template))
    for k, p in model.param_dict().items():
        assert np.array_equal(np.asarray(got[k]), p.detach().numpy())


def test_npz_refuses_another_model(pair, tmp_path):
    _, model = pair
    path = str(tmp_path / "port.npz")
    checkpoint.save_npz(path, model.param_dict())
    params = model.param_dict()
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_npz(path, {**params, "W": torch.zeros(3)})
    with pytest.raises(ValueError, match="arrays"):
        checkpoint.load_npz(path, {k: v for k, v in params.items()
                                   if k != "W"})


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
def test_torch_save_round_trip(pair, tmp_path, dtype):
    _, model = pair
    params = {k: v.detach().to(dtype) for k, v in model.param_dict().items()}
    path = str(tmp_path / "params.pt")
    checkpoint.save_torch(path, params)
    assert list(torch.load(path, weights_only=True)) == \
        checkpoint.leaf_order(params)
    template = {k: torch.zeros_like(v) for k, v in params.items()}
    got = checkpoint.load_torch(path, template)
    for k in params:
        assert got[k].dtype == dtype and torch.equal(got[k], params[k])
    with pytest.raises(ValueError, match="holds"):
        checkpoint.load_torch(path, {k: v for k, v in template.items()
                                     if k != "H"})


@pytest.mark.parametrize("args", [(4, 16, 32), (256, 16, 32, 16),
                                  (2, 5, 3, 7, False)])
def test_layer_flops_equal_jax(args):
    assert profiling.risi18_layer_flops(*args) == \
        jprofiling.risi18_layer_flops(*args)


def test_timers():
    t = profiling.Timer()
    for _ in range(3):
        with t:
            pass
    assert t.count == 3 and t.total >= 0 and t.mean == t.total / 3
    calls = []
    stats = profiling.time_torch(lambda x: calls.append(x) or x * 2,
                                 torch.ones(3), iters=4, warmup=1)
    assert set(stats) == set(jprofiling.time_jax(lambda: 0, iters=1,
                                                 warmup=0))
    assert len(calls) == 5
    assert 0 <= stats["min"] <= stats["mean"] <= stats["max"]
    step, timer = profiling.step_timer(lambda a: a + 1)
    assert step(1) == 2 and step(2) == 3 and timer.count == 2


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert any("mm" in e.key for e in prof.key_averages())
