"""The port's op library that no model calls (``ops/activations.py``'s
dropout, masking and norm3d; ``ops/linalg.py``; ``ops/reductions.py``;
``ops/losses.py:LOG_ZERO``; ``models/gcn.py:GCNMWConfig``) against the JAX
package on the CPU at float64.

Every function is reached through ``graphflow_tpu_torch.ops`` and
``graphflow_tpu.ops`` under the same name: the values, and the gradients of
every float input (``jax.vjp`` against ``torch.autograd`` with one seeded
cotangent), to 1e-12 * max(1, scale).  A gradient that torch leaves
undefined (a mask only compared) must be zero in JAX.

``matmul`` follows the JAX package's float32 route: in float64 it is held
to the JAX function at 2e-6 * scale and is shown not to be the float64
product; in bfloat16 it is held to the JAX bfloat16 product at 1e-2 *
scale.  Dropout at eval is exact; at train time both packages apply the
same NumPy uniforms, and a seeded draw keeps about the given share.  The
RisiLayer closed forms are held against the reference's loops
(``tests/test_ops.py:11-48``) at n = 5, D = 3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphflow_tpu import ops as jops
from graphflow_tpu.models import gcn as jgcn
from graphflow_tpu.ops import activations as jact
from graphflow_tpu.ops import losses as jlosses
from graphflow_tpu_torch import ops
from graphflow_tpu_torch.models import gcn
from graphflow_tpu_torch.ops import activations, losses

torch.set_num_threads(1)

RTOL = 1e-12
RTOL_MATMUL, RTOL16 = 2e-6, 1e-2


class Const:
    """An input held fixed: neither package differentiates it here."""

    def __init__(self, value):
        self.value = value


def _close(got, ref, rtol=RTOL):
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 0.0)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=rtol * scale)


def _make(spec, rng):
    if isinstance(spec, Const):
        return spec
    if isinstance(spec, tuple):
        return rng.normal(size=spec)
    return np.asarray(spec, dtype=np.float64)


def _check(build, specs, seed=0, rtol=RTOL):
    """build(ops_module) -> a function of the inputs; specs: shapes (float64
    normal draws), arrays, or Const.  Values and the vjp of every non-Const
    input against the JAX package."""
    rng = np.random.default_rng(seed)
    inputs = [_make(s, rng) for s in specs]
    free = [i for i, x in enumerate(inputs) if not isinstance(x, Const)]

    def merged(vals, to):
        out = [to(x.value) if isinstance(x, Const) else None for x in inputs]
        for i, v in zip(free, vals):
            out[i] = v
        return out

    jfn, tfn = build(jops), build(ops)
    jout, vjp = jax.vjp(lambda *v: jfn(*merged(v, jnp.asarray)),
                        *[jnp.asarray(inputs[i]) for i in free])
    leaves = [torch.tensor(inputs[i], requires_grad=True) for i in free]
    tout = tfn(*merged(leaves, torch.as_tensor))
    _close(tout, jout, rtol)
    cot = rng.normal(size=np.shape(jout))
    jgrads = vjp(jnp.asarray(cot))
    tgrads = torch.autograd.grad(tout, leaves, torch.from_numpy(cot),
                                 allow_unused=True)
    for leaf, tg, jg in zip(leaves, tgrads, jgrads):
        _close(torch.zeros_like(leaf) if tg is None else tg, jg, rtol)


MASK = [1.0, 0.0, 1.0, 1.0, 0.0]
CASES = {
    # ops/activations.py
    "masking": (lambda o: o.masking, [(4, 3), [[1, 0, 1], [0, 0, 1],
                                               [1, 1, 0], [-1, 2, 0]]]),
    "norm3d": (lambda o: o.norm3d, [(4, 3, 5)]),
    # ops/linalg.py
    "add": (lambda o: o.add, [(3, 4), (3, 4)]),
    "subtract": (lambda o: o.subtract, [(3, 4), (3, 4)]),
    "multiply": (lambda o: o.multiply, [(3, 4), (3, 4)]),
    "inner_product": (lambda o: o.inner_product, [(3, 4), (3, 4)]),
    "outer_product": (lambda o: o.outer_product, [(5,), (2, 3)]),
    "transpose": (lambda o: o.transpose, [(3, 4)]),
    "transpose_3d": (lambda o: o.transpose, [(2, 3, 4)]),
    "scalar_matmul": (lambda o: o.scalar_matmul, [(), (3, 4)]),
    "scalar_matmul_1_element": (lambda o: o.scalar_matmul, [(1,), (3, 4)]),
    "scalar_matmul_python": (lambda o: lambda m: o.scalar_matmul(0.75, m),
                             [(3, 4)]),
    "mat_vec_mul": (lambda o: o.mat_vec_mul, [(3, 4), (4,)]),
    "mat_tensor_mul": (lambda o: o.mat_tensor_mul, [(3, 4), (4, 5, 2)]),
    "tensor_mat_mul": (lambda o: o.tensor_mat_mul, [(3, 4, 2), (4, 5)]),
    "tensor_mul": (lambda o: o.tensor_mul, [(3, 4, 2), (4, 5, 2)]),
    "tensor4d_tensor3d_mul": (lambda o: o.tensor4d_tensor3d_mul,
                              [(3, 4, 2, 5), (4, 6, 2)]),
    "custom_matmul_tensor": (lambda o: o.custom_matmul_tensor,
                             [(5, 2), (3, 4, 2)]),
    "vector_broadcast_mat": (lambda o: o.vector_broadcast_mat,
                             [(4,), (3, 5)]),
    "mat_broadcast_mat": (lambda o: o.mat_broadcast_mat, [(2, 3), (3, 5)]),
    "vector_add_matrix": (lambda o: o.vector_add_matrix, [(4,), (3, 4)]),
    "vector_add_tensor": (lambda o: o.vector_add_tensor, [(4,), (2, 3, 4)]),
    "linear_gram": (lambda o: o.linear_gram, [(5, 3)]),
    # ops/reductions.py
    "sum_components": (lambda o: o.sum_components, [(3, 4)]),
    "sum_vectors": (lambda o: o.sum_vectors, [(5, 3)]),
    "sum_vectors_masked": (lambda o: o.sum_vectors, [(5, 3), MASK]),
    "average_vectors": (lambda o: o.average_vectors, [(5, 3)]),
    "average_vectors_masked": (lambda o: o.average_vectors, [(5, 3), MASK]),
    "average_vectors_one_kept": (lambda o: o.average_vectors,
                                 [(5, 3), [0.0, 0.0, 1.0, 0.0, 0.0]]),
    "average_vectors_none_kept": (lambda o: o.average_vectors,
                                  [(5, 3), [0.0] * 5]),
    "sum_matrices": (lambda o: o.sum_matrices, [(5, 3, 2)]),
    "sum_matrices_masked": (lambda o: o.sum_matrices, [(5, 3, 2), MASK]),
    "sum_tensor3d": (lambda o: o.sum_tensor3d, [(5, 3, 2, 4)]),
    "sum_tensor3d_masked": (lambda o: o.sum_tensor3d, [(5, 3, 2, 4), MASK]),
    "sum_rows": (lambda o: o.sum_rows, [(3, 4)]),
    "shrink_matrix_0": (lambda o: lambda m: o.shrink_matrix(m, 0), [(3, 4)]),
    "shrink_matrix_1": (lambda o: lambda m: o.shrink_matrix(m, 1), [(3, 4)]),
    "shrink_tensor": (lambda o: o.shrink_tensor, [(3, 4, 5)]),
    "concat": (lambda o: lambda *v: o.concat(v), [(3,), (2, 2), (1, 2, 3)]),
    "matrix_concat": (lambda o: lambda *m: o.matrix_concat(m),
                      [(2, 3), (4, 3)]),
    "tensor3d_concat": (lambda o: lambda *t: o.tensor3d_concat(t),
                        [(2, 3, 1), (2, 3, 4)]),
    "tensor4d_concat": (lambda o: lambda *t: o.tensor4d_concat(t),
                        [(2, 3, 2, 1), (2, 3, 2, 3)]),
    "stack_tensor3d": (lambda o: lambda *t: o.stack_tensor3d(list(t)),
                       [(2, 3, 4), (2, 3, 4), (2, 3, 4)]),
    "stack_tensor3d_tuple": (lambda o: lambda *t: o.stack_tensor3d(t),
                             [(2, 3, 4), (2, 3, 4)]),
    "stack_tensor3d_passes_a_tensor": (lambda o: o.stack_tensor3d,
                                       [(3, 2, 3, 4)]),
    "shuffle_matrix": (lambda o: o.shuffle_matrix,
                       [(5, 3), Const(np.array([4.0, 0.0, 2.0, 2.0]))]),
    "shuffle_matrix_truncates": (lambda o: o.shuffle_matrix,
                                 [(5, 3), Const(np.array([2.7, 0.2, 4.99,
                                                          1.5, -0.5]))]),
    "sort_vector": (lambda o: o.sort_vector, [(7,)]),
    "kmax": (lambda o: lambda v: o.kmax(v, 3), [(7,)]),
    "kmax_all": (lambda o: lambda v: o.kmax(v, 7), [(7,)]),
    "vertex_representation": (
        lambda o: lambda f, w: o.vertex_representation(f, w, 2, 5),
        [(4,), (4,)]),
    "vertex_representation_last": (
        lambda o: lambda f, w: o.vertex_representation(f, w, 4, 5),
        [(4,), (4,)]),
    "risi_layer_1d": (lambda o: o.risi_layer_1d, [(5, 3)]),
    "risi_layer_1d_masked": (lambda o: o.risi_layer_1d, [(5, 3), MASK]),
    "risi_layer_2d": (lambda o: o.risi_layer_2d, [(5, 3)]),
    "risi_layer_2d_masked": (lambda o: o.risi_layer_2d, [(5, 3), MASK]),
    "risi_layer_3d": (lambda o: o.risi_layer_3d, [(5, 3)]),
    "risi_layer_3d_masked": (lambda o: o.risi_layer_3d, [(5, 3), MASK]),
    "reshape2d": (lambda o: lambda x: o.reshape2d(x, 4, 6), [(2, 3, 4)]),
    "reshape3d": (lambda o: lambda x: o.reshape3d(x, 2, 4, 3), [(24,)]),
    "reshape4d": (lambda o: lambda x: o.reshape4d(x, 2, 2, 3, 2), [(4, 6)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_op_matches_jax_values_and_gradients(case):
    build, specs = CASES[case]
    _check(build, specs, seed=sorted(CASES).index(case))


def test_every_jax_op_of_the_library_has_a_case():
    """Each function of ``linalg``/``reductions`` and the three activations
    but matmul and dropout (tested on their own below) has a case above."""
    from graphflow_tpu.ops import linalg, reductions
    names = {n for m in (linalg, reductions) for n in vars(m)
             if callable(getattr(m, n)) and not n.startswith("_")
             and getattr(getattr(m, n), "__module__", "") == m.__name__}
    names |= {"masking", "norm3d"}
    covered = {c for c in names for k in CASES if k == c or
               k.startswith(c + "_")}
    assert names - covered == {"matmul"}


def test_norm3d_uses_range_one_where_min_equals_max():
    x = np.random.default_rng(1).normal(size=(3, 4, 5))
    x[:, :, 2] = 0.7                                 # one constant depth
    _check(lambda o: o.norm3d, [x])
    got = ops.norm3d(torch.from_numpy(x))
    assert torch.equal(got[:, :, 2], torch.zeros(3, 4, dtype=torch.float64))


def test_norm3d_stops_the_gradient_of_min_and_max():
    """The gradient is g / range: min and max are constants."""
    x = torch.tensor(np.random.default_rng(2).normal(size=(3, 4, 2)),
                     requires_grad=True)
    ops.norm3d(x).sum().backward()
    rng = x.detach().amax(dim=(0, 1)) - x.detach().amin(dim=(0, 1))
    torch.testing.assert_close(x.grad, (1.0 / rng).expand(3, 4, 2),
                               rtol=0, atol=0)


@pytest.mark.parametrize("v,k,grad", [
    ([1.0, 3.0, 3.0, 2.0], None, [0.0, 2.0, 3.0, 1.0]),     # sort_vector
    ([1.0, 3.0, 3.0, 2.0], 4, [0.0, 2.0, 3.0, 1.0]),
    ([3.0, 1.0, 3.0, 3.0], 2, [0.0, 0.0, 0.0, 1.0]),
    ([2.0, 2.0, 2.0, 2.0], 3, [0.0, 0.0, 1.0, 2.0]),
])
def test_sort_and_kmax_route_ties_through_a_stable_permutation(v, k, grad):
    """With the cotangent w = 0, 1, ... on the sorted outputs, entry i of
    the gradient is the weight of the place entry i went to, tied entries
    in input order (k None: sort_vector; else kmax)."""
    def build(o):
        return o.sort_vector if k is None else (lambda x: o.kmax(x, k))

    w = np.arange(len(v) if k is None else k, dtype=np.float64)
    jout, vjp = jax.vjp(build(jops), jnp.asarray(v))
    x = torch.tensor(v, dtype=torch.float64, requires_grad=True)
    tout = build(ops)(x)
    _close(tout, jout)
    (tg,) = torch.autograd.grad(tout, x, torch.from_numpy(w))
    _close(tg, vjp(jnp.asarray(w))[0])
    _close(tg, grad)


def test_kmax_returns_the_largest_in_ascending_order():
    v = torch.tensor([5.0, -1.0, 7.0, 2.0, 7.5])
    assert ops.kmax(v, 3).tolist() == [5.0, 7.0, 7.5]


def test_shuffle_matrix_truncates_toward_zero():
    m = torch.arange(15.0).reshape(5, 3)
    got = ops.shuffle_matrix(m, torch.tensor([2.7, 0.2, 4.99, -0.5]))
    assert torch.equal(got, m[[2, 0, 4, 0]])


# ---- the RisiLayer closed forms against the reference's loops -----------

def _risi2d_loop(X):
    n, D = X.shape
    want = np.zeros(D)
    for i in range(D):
        for k in range(D):
            for u in range(n):
                for v in range(u + 1, n):
                    want[i] += X[u, i] * X[v, k] + X[u, k] * X[v, i]
    return want


def _risi3d_loop(X):
    n = X.shape[0]
    want = np.zeros((X.shape[1],) * 3)
    for i in range(n):
        for j in range(n):
            if i == j:
                continue
            for v in range(n):
                if v == i or v == j:
                    continue
                want += np.einsum("x,y,z->xyz", X[i], X[j], X[v])
    return want


@pytest.mark.parametrize("name,loop", [("risi_layer_2d", _risi2d_loop),
                                       ("risi_layer_3d", _risi3d_loop)])
def test_risi_layer_closed_form_matches_the_loop(name, loop):
    X = np.random.default_rng(3).normal(size=(5, 3))
    got = getattr(ops, name)(torch.from_numpy(X))
    _close(got, loop(X))
    mask = np.array(MASK)
    got = getattr(ops, name)(torch.from_numpy(X), torch.from_numpy(mask))
    _close(got, loop(X[mask > 0]))


# ---- matmul: the float32 route -------------------------------------------

def _matmul_inputs(n=8, seed=4):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n, n + 3)), rng.normal(size=(n + 3, n - 2))


def test_matmul_float64_takes_the_jax_float32_route():
    a, b = _matmul_inputs()
    ref = np.asarray(jops.matmul(jnp.asarray(a), jnp.asarray(b)))
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float64 and ref.dtype == np.float64
    _close(got, ref, RTOL_MATMUL)
    # What JAX computes on the CPU: the float64 product rounded once to
    # float32 (neither input is rounded); the port computes the same.
    f32 = (a @ b).astype(np.float32).astype(np.float64)
    np.testing.assert_array_equal(ref, f32)
    np.testing.assert_array_equal(got.numpy(), f32)


def test_matmul_float64_is_not_the_float64_product():
    a, b = _matmul_inputs(4, seed=5)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    err = np.abs(got - a @ b).max()
    assert 1e-9 < err < RTOL_MATMUL * np.abs(a @ b).max()


def test_matmul_gradients_match_jax():
    """JAX transposes its dot on float32 operands; torch's autograd of the
    route rounds the cotangent to float32 and multiplies in float64."""
    _check(lambda o: o.matmul, [(5, 4), (4, 3)], rtol=RTOL_MATMUL)


def test_matmul_bfloat16_matches_jax():
    a, b = _matmul_inputs(16, seed=6)
    ja, jb = (jnp.asarray(x, dtype=jnp.bfloat16) for x in (a, b))
    ref = np.asarray(jops.matmul(ja, jb).astype(jnp.float32))
    ta, tb = (torch.from_numpy(x).to(torch.bfloat16) for x in (a, b))
    got = ops.matmul(ta, tb)
    assert got.dtype == torch.bfloat16
    _close(got.float(), ref, RTOL16)


# ---- dropout -------------------------------------------------------------

def test_dropout_eval_multiplies_by_the_probability():
    x = np.random.default_rng(7).normal(size=(4, 5))
    gen = torch.Generator().manual_seed(0)
    got = ops.dropout(torch.from_numpy(x), gen, 0.3, train=False)
    ref = jops.dropout(jnp.asarray(x), jax.random.PRNGKey(0), 0.3, False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_dropout_train_keeps_where_the_uniform_is_at_most_p():
    """The same uniforms through both packages' masks (JAX's is the line
    after its draw, ``activations.py:86-87``), with the gradient; no
    rescale."""
    rng = np.random.default_rng(8)
    x, u = rng.normal(size=(6, 5)), rng.uniform(size=(6, 5))
    u[0, 0] = 0.4                                   # uniform == p is kept
    p = 0.4

    def jax_train(x):
        return jnp.where(jnp.asarray(u) <= p, x, 0.0)

    jout, vjp = jax.vjp(jax_train, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tout = activations.dropout_apply(tx, torch.from_numpy(u), p)
    np.testing.assert_array_equal(tout.detach().numpy(), np.asarray(jout))
    assert tout[0, 0] == tx[0, 0]
    cot = rng.normal(size=x.shape)
    (tg,) = torch.autograd.grad(tout, tx, torch.from_numpy(cot))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(vjp(cot)[0]))


def test_dropout_train_draw_keeps_about_p():
    x = torch.ones(200, 100, dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    kept = ops.dropout(x, gen, 0.3, train=True)
    assert set(kept.unique().tolist()) <= {0.0, 1.0}
    assert abs(float(kept.mean()) - 0.3) < 0.01
    again = ops.dropout(x, torch.Generator().manual_seed(0), 0.3, True)
    assert torch.equal(kept, again)
    # JAX's own draw keeps the same share.
    jkept = jact.dropout(jnp.ones((200, 100)), jax.random.PRNGKey(0), 0.3,
                         True)
    assert abs(float(jkept.mean()) - 0.3) < 0.01


def test_dropout_draws_from_the_callers_generator_on_the_tensors_device():
    """The uniforms are one ``torch.rand`` of x's shape on x's device from
    the generator given (on the card, a CUDA generator)."""
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(7, 6)))
    got = ops.dropout(x, torch.Generator().manual_seed(3), 0.6, True)
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(3),
                   device=x.device)
    assert torch.equal(got, activations.dropout_apply(x, u, 0.6))


# ---- constants and configs -----------------------------------------------

def test_log_zero_and_gcn_mw_config_match_jax():
    assert losses.LOG_ZERO == jlosses.LOG_ZERO == -1e9
    jfields = [(f.name, f.default) for f in
               dataclasses.fields(jgcn.GCNMWConfig)]
    assert [(f.name, f.default) for f in
            dataclasses.fields(gcn.GCNMWConfig)] == jfields
    model = gcn.GCN_MW(2, 9, 4, 5, 1, momentum_param=0.8, device="cpu")
    assert model.cfg == gcn.GCNMWConfig(2, 9, 4, 5, 1, 0.8)
    jmodel = jgcn.GCN_MW(2, 9, 4, 5, 1, momentum_param=0.8)
    assert dataclasses.asdict(model.cfg) == dataclasses.asdict(jmodel.cfg)
