"""The port's ``ops/sparse.py`` against ``graphflow_tpu.ops.sparse``: the
host-side constructors array for array, the ELLPACK and COO products and their
gradients on the same inputs in float32 and float64, and the NaN that a
non-finite row leaks into padded slots in both packages (the sentinel is
clamped to the last real row and annihilated by a zero weight,
``graphflow_tpu/ops/sparse.py:139-155``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu.ops import sparse as jsparse
from graphflow_tpu.utils import datasets as jdatasets
from graphflow_tpu_torch.ops import sparse

torch.set_num_threads(1)

RTOL = {np.float32: 1e-6, np.float64: 1e-12}


def _close(got, ref, rtol):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _edges(n, p, seed):
    adj = jdatasets.random_graph(n, p, seed=seed).adj
    return adj, [(int(u), int(v)) for u, v in np.argwhere(np.triu(adj, 1))]


@pytest.mark.parametrize("opts", [dict(), dict(pad_rows=14),
                                  dict(max_degree=9), dict(weighted=True)])
def test_ell_from_adj_matches_jax(opts):
    adj, _ = _edges(11, 0.35, 1)
    kw = dict(opts)
    if kw.pop("weighted", False):
        kw["weights"] = adj * np.random.default_rng(2).random(adj.shape)
    _equal(sparse.ell_from_adj(adj, **kw), jsparse.ell_from_adj(adj, **kw))


@pytest.mark.parametrize("opts", [dict(), dict(pad_rows=12, max_degree=8),
                                  dict(weighted=True), dict(self_loop=True)])
def test_ell_from_edges_matches_jax(opts):
    _, edges = _edges(10, 0.3, 3)
    kw = dict(opts)
    if kw.pop("self_loop", False):
        edges = edges + [(4, 4)]
    if kw.pop("weighted", False):
        kw["weights"] = np.random.default_rng(4).random(len(edges))
    _equal(sparse.ell_from_edges(10, edges, **kw),
           jsparse.ell_from_edges(10, edges, **kw))


@pytest.mark.parametrize("pad_rows", [None, 16])
def test_norm_adj_ell_matches_jax_and_dense(pad_rows):
    g = jdatasets.random_graph(12, 0.3, seed=6)
    edges = [(int(u), int(v)) for u, v in np.argwhere(np.triu(g.adj, 1))]
    got = sparse.norm_adj_ell(12, edges, pad_rows=pad_rows)
    _equal(got, jsparse.norm_adj_ell(12, edges, pad_rows=pad_rows))
    out = sparse.ell_spmm(torch.from_numpy(got[0]), torch.from_numpy(got[1]),
                          torch.eye(pad_rows or 12, dtype=torch.float32))
    dense = np.zeros((pad_rows or 12,) * 2, np.float32)
    dense[:12, :12] = g.norm_adj()
    _close(out, dense, 1e-6)


def test_edges_count_matches_jax():
    adj, _ = _edges(13, 0.3, 7)
    nbr, _ = sparse.ell_from_adj(adj, pad_rows=16)
    assert sparse.edges_count(nbr) == jsparse.edges_count(nbr)
    assert sparse.edges_count(nbr) == int((adj > 0).sum())


def _spmm_case(dtype, pad=False):
    rng = np.random.default_rng(8)
    adj, _ = _edges(9, 0.4, 9)
    W = (adj * rng.random(adj.shape)).astype(dtype)
    nbr, w = sparse.ell_from_adj(W, pad_rows=12 if pad else None)
    h = rng.normal(size=(nbr.shape[0], 5)).astype(dtype)
    return nbr, w, h


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("pad", [False, True])
def test_ell_spmm_matches_jax(dtype, pad):
    nbr, w, h = _spmm_case(dtype, pad)
    th = torch.from_numpy(h).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out = sparse.ell_spmm(torch.from_numpy(nbr), tw, th)
    ref, vjp = jax.vjp(lambda w_, h_: jsparse.ell_spmm(jnp.asarray(nbr), w_,
                                                       h_),
                       jnp.asarray(w), jnp.asarray(h))
    _close(out, ref, RTOL[dtype])
    g = np.random.default_rng(10).normal(size=out.shape).astype(dtype)
    dw, dh = torch.autograd.grad(out, (tw, th), torch.from_numpy(g))
    jdw, jdh = vjp(jnp.asarray(g))
    _close(dw, jdw, RTOL[dtype])
    _close(dh, jdh, RTOL[dtype])


def test_ell_spmm_nan_leak_as_jax():
    """A non-finite value in the last row of h reaches every output whose
    padded slots read it, as in the JAX package; finite h keeps all finite."""
    nbr, w, h = _spmm_case(np.float32)
    h[-1, 0] = np.inf
    got = sparse.ell_spmm(torch.from_numpy(nbr), torch.from_numpy(w),
                          torch.from_numpy(h)).numpy()
    ref = np.asarray(jsparse.ell_spmm(jnp.asarray(nbr), jnp.asarray(w),
                                      jnp.asarray(h)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    padded = (nbr == nbr.shape[0]).any(axis=1)
    assert np.isnan(got[padded, 0]).all() and padded.any()
    assert np.isfinite(got[:, 1:]).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_coo_spmm_matches_jax(dtype):
    adj, _ = _edges(10, 0.3, 11)
    src, dst = np.nonzero(adj)
    rng = np.random.default_rng(12)
    w = rng.random(len(src)).astype(dtype)
    h = rng.normal(size=(10, 4)).astype(dtype)
    got = sparse.coo_spmm(torch.from_numpy(src), torch.from_numpy(dst),
                          torch.from_numpy(w), torch.from_numpy(h), 10)
    ref = jsparse.coo_spmm(jnp.asarray(src), jnp.asarray(dst),
                           jnp.asarray(w), jnp.asarray(h), 10)
    _close(got, ref, RTOL[dtype])
    _close(got, _coo_dense(src, dst, w, 10) @ h, RTOL[dtype])


def _coo_dense(src, dst, w, n):
    A = np.zeros((n, n), w.dtype)
    np.add.at(A, (dst, src), w)
    return A
