"""The port's native graph preparation (``runtime/native.py`` over its own
``runtime/csrc/graph_prep.cpp``, built with g++ into ``build/native/``)
against its NumPy path and against the JAX package's ``backend="auto"``,
bit for bit in every field and dtype: the toy molecules under a cap with
and without WL ordering and uncapped, Erdos-Renyi graphs, the Coulomb
adjacency with raw features, float64 arrays and a self loop (the cases of
``tests/test_native_prep.py:27-55`` and more).  Also the routes
``prepare_graph`` counts, and the build: a compile error raises with the
compiler's output, concurrent builds all load a whole library.  No test
here times anything."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from graphflow_tpu.core import prep as jprep
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.runtime import cuda_build, native
from graphflow_tpu_torch.utils import datasets

torch.set_num_threads(1)

FIELDS = [f.name for f in dataclasses.fields(prep.PreparedGraph)]


def _assert_identical(a, b, skip=()):
    """Every field equal bit for bit, with the same dtype and shape."""
    for f in FIELDS:
        if f in skip:
            continue
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            assert x is not None and y is not None, f
            assert x.dtype == y.dtype and x.shape == y.shape, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


def _molecules(mod):
    return [mod.toy_molecule(n) for n in ("CH4", "NH3", "H2O", "C2H4")]


def _coulomb(g, seed):
    c = np.random.default_rng(seed).normal(size=g.coulomb.shape)
    g.coulomb = c + c.T
    return g


def _self_loop(mod):
    g = mod.random_graph(7, 0.4, seed=5)
    g.adj[2, 2] = 1
    return g


# (fixture, graphs, prepare_graph keyword arguments)
CASES = {
    "molecules_cap_wl": (_molecules, dict(
        nLevels=2, max_nVertices=8, max_receptive_field=4, nDepth=3)),
    "molecules_cap_nowl": (_molecules, dict(
        nLevels=2, max_nVertices=8, max_receptive_field=4, nDepth=3,
        has_WL_ordering=False)),
    "molecules_uncapped": (_molecules, dict(
        nLevels=2, max_nVertices=8, max_receptive_field=None, nDepth=3)),
    "random": (lambda mod: [mod.random_graph(12, 0.3, seed=s)
                            for s in range(5)], dict(
        nLevels=3, max_nVertices=12, max_receptive_field=5, nDepth=2)),
    "random_padded_nowl": (lambda mod: [mod.random_graph(9, 0.35, seed=s)
                                        for s in range(3)], dict(
        nLevels=2, max_nVertices=12, max_receptive_field=4, nDepth=2,
        has_WL_ordering=False)),
    "coulomb_raw": (lambda mod: [_coulomb(mod.random_graph(6, 0.5, seed=7),
                                          1)], dict(
        nLevels=2, max_nVertices=6, max_receptive_field=3, nDepth=0,
        use_coulomb=True, use_wl_features=False)),
    "coulomb_raw_features": (lambda mod: [
        _coulomb(mod.random_graph(8, 0.4, nFeatures=3, seed=s), s)
        for s in range(3)], dict(
        nLevels=2, max_nVertices=10, max_receptive_field=4, nDepth=0,
        use_coulomb=True, use_wl_features=False, has_WL_ordering=False)),
    "float64": (lambda mod: [mod.random_graph(10, 0.3, seed=s)
                             for s in range(3)], dict(
        nLevels=2, max_nVertices=10, max_receptive_field=4, nDepth=2,
        dtype=np.float64)),
}


def _raw_features(graphs, seed):
    """Normal raw features in place of the one-hot ones (the physics
    graphs'); used where no WL histogram sums them."""
    rng = np.random.default_rng(seed)
    for g in graphs:
        g.feature = rng.normal(size=g.feature.shape)
    return graphs


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_matches_numpy_path(case):
    make, kw = CASES[case]
    graphs = make(datasets)
    if case == "coulomb_raw_features":
        _raw_features(graphs, 3)
    for g in graphs:
        _assert_identical(prep.prepare_graph(g, **kw),
                          prep.prepare_graph(g, backend="python", **kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_native_matches_jax_auto(case):
    """Field for field against the JAX package's default backend, whose
    native library is present here."""
    make, kw = CASES[case]
    jgraphs, tgraphs = make(jdatasets), make(datasets)
    if case == "coulomb_raw_features":
        _raw_features(jgraphs, 3)
        _raw_features(tgraphs, 3)
    for jg, tg in zip(jgraphs, tgraphs):
        _assert_identical(prep.prepare_graph(tg, **kw),
                          jprep.prepare_graph(jg, backend="auto", **kw))


def test_self_loop_backends_agree():
    """A vertex with a self loop stays 0 hops from itself on both of the
    port's backends.  The JAX package's native library agrees in every
    field it computes; its ``sp`` comes from its NumPy ``floyd_warshall``,
    which sets the looped vertex's diagonal to 1."""
    kw = dict(nLevels=2, max_nVertices=8, max_receptive_field=4, nDepth=2)
    tg, jg = _self_loop(datasets), _self_loop(jdatasets)
    got = prep.prepare_graph(tg, **kw)
    _assert_identical(got, prep.prepare_graph(tg, backend="python", **kw))
    _assert_identical(got, jprep.prepare_graph(jg, backend="auto", **kw),
                      skip=("sp",))
    assert got.sp[2, 2] == 0


def test_routes_are_counted():
    g = datasets.random_graph(6, 0.4, seed=1)
    kw = dict(nLevels=2, max_nVertices=6, max_receptive_field=3, nDepth=1)
    before = prep.ROUTES.copy()
    prep.prepare_graph(g, **kw)
    prep.prepare_graph(g, backend="python", **kw)
    prep.prepare_graph(g, fo_degree=6, **kw)
    diff = prep.ROUTES - before
    assert diff == {"native": 1, "numpy": 1, "numpy_fo_degree": 1}
    with pytest.raises(ValueError):
        prep.prepare_graph(g, backend="cpp", **kw)


def test_native_rejects_too_many_vertices():
    g = datasets.random_graph(9, 0.4, seed=2)
    with pytest.raises(ValueError):
        native.prepare_graph_native(g, 2, 8, 4, 2)


def test_library_is_the_ports_own():
    """Built from runtime/csrc/graph_prep.cpp into build/native, never the
    JAX package's library."""
    assert native.available()
    lib = cuda_build.build_host_library("graph_prep", "graphprep").path
    assert lib == cuda_build.HOST_BUILD_DIR / "libgraphprep.so"
    assert lib.parent.parent.name == "build"
    assert "graphflow_tpu/runtime" not in str(native._load()._name)


def test_compile_error_raises_with_output(tmp_path):
    src = tmp_path / "broken.cpp"
    src.write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as info:
        cuda_build._build(cuda_build.find_gxx, cuda_build.GXX_FLAGS, src,
                          tmp_path / "out" / "libbroken.so", [src])
    assert "error" in str(info.value)
    assert not list((tmp_path / "out").glob("*.so"))


def test_concurrent_builds_load_a_whole_library(tmp_path):
    """Builds racing on one target each compile beside it and rename;
    every one of them ends with a library that loads and answers."""
    src = cuda_build.HOST_CSRC_DIR / "graph_prep.cpp"
    lib = tmp_path / "libgraphprep.so"
    results, errors = [], []

    def build():
        try:
            results.append(cuda_build._build(
                cuda_build.find_gxx, cuda_build.GXX_FLAGS, src, lib, [src]))
        except Exception as e:          # collected, asserted below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(results) == 3
    import ctypes
    assert hasattr(ctypes.CDLL(str(lib)), "gf_prepare_graph")
    assert [p.name for p in tmp_path.iterdir()] == ["libgraphprep.so"]
