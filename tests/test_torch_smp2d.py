"""SMP_omega in the port against the JAX package, with the same weights:
per-level states, Predict, Threaded_Predict and Feature at float64 (rtol
1e-9), the text checkpoint across packages, permutation invariance, the
slice's boundaries, and an import that loads no JAX."""

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from graphflow_tpu.models import SMP2D as JaxSMP2D
from graphflow_tpu.models import SMP2DConfig as JaxSMP2DConfig
from graphflow_tpu.models.smp2d import smp2d_inspect as jax_inspect
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch import models
from graphflow_tpu_torch.models import SMP2D, SMP2DConfig, SMP_omega
from graphflow_tpu_torch.models.smp2d import smp2d_inspect, smp2d_states
from graphflow_tpu_torch.optim.utils import uniform_init
from graphflow_tpu_torch.utils import datasets
from graphflow_tpu_torch.utils.convert import params_from_jax, params_to_numpy

torch.set_num_threads(1)

RTOL = 1e-9
CFG = dict(max_nVertices=10, max_receptive_field=4, nLevels=2, nChanels=6,
           nFeatures=4, nDepth=3)


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=RTOL * scale)


def _jax_tree(model):
    return jax.tree_util.tree_map(np.asarray, model.params)


@pytest.fixture(scope="module")
def pair():
    """A JAX SMP_omega and the port's, float64, sharing the JAX weights."""
    jm = JaxSMP2D(JaxSMP2DConfig(**CFG, dtype="float64"), seed=3)
    tm = SMP2D(SMP2DConfig(**CFG, dtype="float64"), device="cpu")
    tm.load_params(params_from_jax(_jax_tree(jm)))
    return jm, tm


def _graph_pairs():
    jg, _ = jdatasets.toy_molecules()
    tg, _ = datasets.toy_molecules()
    jg += [jdatasets.random_graph(10, 0.3, seed=s) for s in (1, 2)]
    tg += [datasets.random_graph(10, 0.3, seed=s) for s in (1, 2)]
    return jg, tg


@pytest.mark.parametrize("i", range(6))
def test_states_match_jax(pair, i):
    jm, tm = pair
    jg, tg = _graph_pairs()
    ji, ti = jax_inspect(jm, jg[i]), smp2d_inspect(tm, tg[i])
    assert len(ti["states"]) == CFG["nLevels"] + 1
    for a, b in zip(ti["states"], ji["states"]):
        _close(a, b)
    _close(ti["vertex_features"], ji["vertex_features"])
    _close(ti["graph_feature"], ji["graph_feature"])


def test_predict_threaded_predict_feature_match_jax(pair):
    jm, tm = pair
    jg, tg = _graph_pairs()
    _close(tm.Threaded_Predict(tg), jm.Threaded_Predict(jg))
    for a, b in zip(jg, tg):
        _close(tm.Predict(b), jm.Predict(a))
        _close(tm.Feature(b), jm.Feature(a))


def test_jax_text_checkpoint_loads_into_port(tmp_path, pair):
    jm, _ = pair
    fn = str(tmp_path / "omega.dat")
    jm.save_model(fn)
    tm = SMP2D(SMP2DConfig(**CFG, dtype="float64"), seed=99, device="cpu")
    jg, tg = _graph_pairs()
    assert abs(tm.Predict(tg[0]) - jm.Predict(jg[0])) > 1e-6  # other init
    tm.load_model(fn)
    _close(tm.Threaded_Predict(tg), jm.Threaded_Predict(jg))
    # Saved back by the port, the file is byte for byte the JAX one.
    fn2 = str(tmp_path / "omega_port.dat")
    tm.save_model(fn2)
    assert Path(fn2).read_text() == Path(fn).read_text()


def test_convert_round_trip(pair):
    jm, tm = pair
    tree = params_to_numpy(tm.param_dict())
    ref = _jax_tree(jm)
    assert list(tree) == ["H", "levels", "W"]
    for path, t in params_from_jax(ref).items():
        node = tree
        for k in path.split("/"):
            node = node[int(k)] if isinstance(node, list) else node[k]
        np.testing.assert_array_equal(node, t.numpy())


def test_registration_order_and_layouts():
    m = SMP_omega(**CFG, device="cpu")
    order = ["H", "levels/0/K", "levels/0/b", "levels/1/K", "levels/1/b", "W"]
    assert [n for n, _ in m.named_parameters()] == order
    assert m.param_order == order and list(m.state_dict()) == order
    C = CFG["nChanels"]
    feat = CFG["nFeatures"] * (CFG["nDepth"] + 1)
    assert [tuple(p.shape) for p in m.parameters()] == [
        (C, feat), (18 * C, C), (C,), (18 * C, C), (C,), (C,)]


def test_uniform_init_scale_and_seed():
    g = torch.Generator().manual_seed(5)
    w = uniform_init((18, 4), g)
    assert w.dtype == torch.float32 and float(w.abs().max()) <= 0.9 / 18
    assert float(w.abs().max()) > 0.5 * 0.9 / 18
    again = uniform_init((18, 4), torch.Generator().manual_seed(5))
    assert torch.equal(w, again)
    a = SMP_omega(**CFG, seed=1, device="cpu")
    b = SMP_omega(**CFG, seed=1, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))


def test_float32_model_runs_and_tracks_float64():
    m32 = SMP_omega(**CFG, seed=4, device="cpu")
    m64 = SMP2D(SMP2DConfig(**CFG, dtype="float64"), device="cpu")
    m64.load_params({k: v.double() for k, v in m32.param_dict().items()})
    graphs, _ = datasets.toy_molecules()
    p32 = m32.Threaded_Predict(graphs)
    assert p32.dtype == np.float32 and np.isfinite(p32).all()
    np.testing.assert_allclose(p32, m64.Threaded_Predict(graphs),
                               rtol=1e-4, atol=1e-5)


def test_padded_vertices_are_masked(pair):
    """A graph's states do not depend on its batch neighbours, and padded
    vertex rows stay zero (smask)."""
    _, tm = pair
    _, tg = _graph_pairs()
    g = tm._stack(tg)
    states = smp2d_states(tm.params, g, tm.cfg)
    for k, graph in enumerate(tg):
        for s in states:
            assert not s[k, graph.nVertices:].any()
    alone = tm.Threaded_Predict(tg[2:3])
    _close(tm.Threaded_Predict(tg)[2:3], alone)


def test_feature_permutation_invariance():
    m = SMP2D(SMP2DConfig(**{**CFG, "max_nVertices": 8}, dtype="float64"),
              seed=2, device="cpu")
    g = datasets.random_graph(8, 0.4, seed=7)
    f0 = m.Feature(g)
    rng = np.random.default_rng(11)
    for _ in range(3):
        fp = m.Feature(g.permuted(rng.permutation(8)))
        np.testing.assert_allclose(fp, f0, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("kw", [dict(first_order_physics=True),
                                dict(contraction=4, dtype="bfloat16"),
                                dict(contraction=10, dtype="bfloat16"),
                                dict(contraction=50, dtype="bfloat16")])
def test_outside_the_slice_raises(kw):
    """What is still to port says so: the first-order physics tower.
    bfloat16 with the 4-, 10- and 50-case banks was outside and is ported:
    the configuration builds, and the model serves in bfloat16."""
    if kw.get("first_order_physics"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            models.SMP_theta_physics(8, 4, 2, 6, 4, device="cpu")
        return
    cfg = SMP2DConfig(**CFG, **kw)
    m = SMP2D(cfg, seed=1, device="cpu")
    k, C = kw["contraction"], CFG["nChanels"]
    assert m.param_dict()["levels/1/K"].shape == (k * C, C)
    assert all(p.dtype == torch.bfloat16 for p in m.parameters())
    tg, _ = datasets.toy_molecules()
    assert np.isfinite(m.Threaded_Predict(tg)).all()


_REGRESSION = ["SMP_omega", "SMP_gamma", "SMP_2D_ver6", "SMP_2D_ver7",
               "SMP_2D_ver8", "SMP_2D_ver8_thread", "SMP_omega_gpu",
               "SMP_omega_gpu_multistreams"]
_UNCAPPED = ["SMP_beta", "SMP_beta_gpu", "SMP_beta_gpu_multistreams"]
_PHYSICS = ["SMP_omega_physics", "SMP_gamma_physics"]


def _build(name, **kw):
    if name in _REGRESSION:
        return getattr(models, name)(**CFG, **kw)
    if name in _UNCAPPED:
        return getattr(models, name)(8, 2, 6, 4, 3, **kw)
    if name in _PHYSICS:
        return getattr(models, name)(8, 4, 2, 6, 4, **kw)
    if name == "SMP_beta_physics":
        return models.SMP_beta_physics(8, 2, 6, 4, **kw)
    if name == "SMP_2D_ver7_classification":
        return models.SMP_2D_ver7_classification(**CFG, nClasses=3, **kw)
    return SMP2D(SMP2DConfig(**CFG), **kw)


@pytest.mark.parametrize("name", _REGRESSION + _UNCAPPED + _PHYSICS + [
    "SMP_beta_physics", "SMP_2D_ver7_classification", "SMP2D"])
def test_entry_point_never_lands_on_the_cpu_unasked(name, monkeypatch):
    """A model built without ``device`` goes to the CUDA device, and raises
    where there is none; only ``device="cpu"`` builds it on the CPU."""
    asked = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _build(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(
        torch.Tensor, "to", lambda self, *a, **kw: asked.append(
            kw.get("device")) or self)
    _build(name)
    assert asked and all(d == torch.device("cuda") for d in asked)
    monkeypatch.undo()
    assert _build(name, device="cpu").device == torch.device("cpu")


def test_classification_training_raises():
    """A classification head (nClasses, log loss) trains one step on the
    CPU; its Predict raises, as the JAX package's does, since an
    [nClasses] row of scores is no float."""
    m = SMP2D(SMP2DConfig(**CFG, nClasses=3, dtype="float64"), seed=1,
              device="cpu")
    graphs, _ = datasets.toy_molecules()
    labels = [0.0, 2.0, 1.0, 2.0]
    before = {k: p.detach().clone() for k, p in m.param_dict().items()}
    loss0, loss1 = m.BatchLearn(graphs, labels, 1e-4)
    assert np.isfinite([loss0, loss1]).all() and loss1 < loss0
    assert all((p != before[k]).any() for k, p in m.param_dict().items())
    assert m.Threaded_Predict(graphs).shape == (4, 3)
    with pytest.raises(ValueError):
        m.Predict(graphs[0])


def test_prep_cache_is_weak_and_per_graph():
    m = SMP_omega(**CFG, device="cpu")
    g = datasets.toy_molecule("CH4")
    assert m.prepare(g) is m.prepare(g)
    assert len(m._prep_cache) == 1
    del g
    assert len(m._prep_cache) == 0


def test_import_loads_no_jax():
    code = ("import sys, graphflow_tpu_torch, graphflow_tpu_torch.models, "
            "graphflow_tpu_torch.ops.risi_bank, "
            "graphflow_tpu_torch.ops.risi_aligned, "
            "graphflow_tpu_torch.ops.risi_bank_ablate, "
            "graphflow_tpu_torch.models.physics, "
            "graphflow_tpu_torch.tools.ablate_bank, "
            "graphflow_tpu_torch.tools.profile_step, "
            "graphflow_tpu_torch.tools.kernel_digest, "
            "graphflow_tpu_torch.utils.convert, "
            "graphflow_tpu_torch.utils.checkpoint, "
            "graphflow_tpu_torch.runtime.cuda_build\n"
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'graphflow_tpu' "
            "or m.startswith('graphflow_tpu.') or m == 'ml_dtypes']\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
