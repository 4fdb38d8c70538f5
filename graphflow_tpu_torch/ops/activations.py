"""Activations (counterpart of ``graphflow_tpu/ops/activations.py``): the
elementwise ops, the LeakyReLU every model uses, the softmax of the GCN
family with the reference's backward, the per-size parameter gather of
the first-order and steerable models, and the non-inverted dropout,
masking and norm3d that no model calls."""

from __future__ import annotations

import torch


def identity(x: torch.Tensor) -> torch.Tensor:
    """``Identity.h``: y = x."""
    return x


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``Sigmoid.h:29-37``: y = 1 / (1 + exp(-x))."""
    return torch.sigmoid(x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """``Tanh.h``: y = tanh(x)."""
    return torch.tanh(x)


def relu(x: torch.Tensor) -> torch.Tensor:
    """``ReLU.h``: y = max(x, 0); at x = 0 the gradient is split in half,
    as for ``jnp.maximum``."""
    return torch.maximum(x, torch.zeros_like(x))


def leaky_relu(x: torch.Tensor, alpha: float = 0.01) -> torch.Tensor:
    """``LeakyReLU.h``: x where x > 0, else alpha * x (reference default
    alpha = 0.01, ``LeakyReLU.h:31``)."""
    return torch.where(x > 0, x, alpha * x)


class _ReferenceSoftmax(torch.autograd.Function):
    """The softmax forward; the backward g * y * (1 - y)."""

    @staticmethod
    def forward(ctx, x, dim):
        y = torch.softmax(x, dim=dim)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return g * y * (1.0 - y), None


def softmax(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``Softmax.h``: the max-subtracted softmax with the reference's
    backward (``graphflow_tpu/ops/activations.py:47-72``).

    ``Softmax::backward`` (``Softmax.h:57-61``) applies only the diagonal
    of the Jacobian, dL/dx_i = g_i y_i (1 - y_i), as if softmax were an
    elementwise sigmoid: the off-diagonal -y_i y_j terms are missing.
    Every reference Softmax node trains with these gradients, and with the
    true ones GCN_1D's loss curve forks from the reference's from the sixth
    iteration on (``DATASET_r05.json``).  :func:`softmax_exact` is the true
    gradient."""
    return _ReferenceSoftmax.apply(x, dim)


def softmax_exact(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """The softmax with its true Jacobian-vector product."""
    return torch.softmax(x, dim=dim)


def _prefix_count_weights(s: torch.Tensor, depth: int,
                          valid: torch.Tensor = None) -> torch.Tensor:
    """w = C(r + depth - 1, depth) per vertex, where r = #{u <= v : s_u =
    s_v} counts in vertex order within each graph (``s`` [..., V]; with
    ``valid`` [..., V], only the vertices u where it is > 0).  float32, as
    the JAX package computes it; every value is a small integer, exact in
    any dtype."""
    same = s[..., :, None] == s[..., None, :]
    if valid is not None:
        same = same & (valid[..., None, :] > 0)
    V = s.shape[-1]
    tril = torch.ones((V, V), dtype=torch.bool, device=s.device).tril()
    r = (same & tril).sum(dim=-1).to(torch.float32)
    w = r
    for k in range(1, depth):
        w = w * (r + k) / (k + 1)
    return w


class _PersizeGather(torch.autograd.Function):
    """``table[s]`` forward; the backward scatters ``w * g`` into the table
    instead of ``g``."""

    @staticmethod
    def forward(ctx, table, s, w):
        ctx.save_for_backward(s, w)
        ctx.table_shape = table.shape
        return table[s]

    @staticmethod
    def backward(ctx, g):
        s, w = ctx.saved_tensors
        wex = w.reshape(w.shape + (1,) * (g.ndim - w.ndim)).to(g.dtype)
        dtable = g.new_zeros(ctx.table_shape)
        dtable.index_put_((s,), wex * g, accumulate=True)
        return dtable, None, None


def persize_gather_refgrad(table: torch.Tensor, s: torch.Tensor, depth: int,
                           valid: torch.Tensor = None) -> torch.Tensor:
    """Per-size parameter gather with the reference's shared-node backward
    (``graphflow_tpu/ops/activations.py:109-164``).

    The reference wires one filter node per receptive-field size
    (``W_eye[size] = ScalarMatMul(lambda[size], eye)``) but re-adds it to
    the topology once per vertex, so ``GraphFlow::backward`` runs the
    shared node's backward at every occurrence over its accumulating
    gradient buffer: vertex v's contribution to d lambda[s_v] is weighted
    by the number of chains through the shared prefix, w = C(r + depth - 1,
    depth) (:func:`_prefix_count_weights`), where ``depth`` is the number
    of shared nodes on the lambda -> consumer path (SMP_theta and the concat
    variants 1, SMP_1D 3).  The forward is the plain gather ``table[s]``;
    plain autograd of it gives the true gradient, which differs.

    ``s`` [..., V] holds sizes per graph (a batch of graphs on the leading
    axes, each counted on its own), ``table`` [V1, ...]."""
    return _PersizeGather.apply(table, s.long(),
                                _prefix_count_weights(s, depth, valid))


def dropout_apply(x: torch.Tensor, uniforms: torch.Tensor,
                  probability: float) -> torch.Tensor:
    """The train-time mask of :func:`dropout` on given uniforms: x where
    uniform <= probability, else 0 (no rescale)."""
    return torch.where(uniforms <= probability, x, torch.zeros_like(x))


def dropout(x: torch.Tensor, generator: torch.Generator, probability: float,
            train: bool) -> torch.Tensor:
    """``DropOut.h:41-67``: non-inverted dropout.  At train time each entry
    is kept where a uniform draw is <= ``probability`` and is not rescaled;
    at eval time x is multiplied by ``probability``.

    The uniforms are drawn on x's device from ``generator``, which must
    live there (a CUDA tensor takes a CUDA generator; torch raises
    otherwise).  torch's draw is not JAX's: the same seed keeps other
    entries."""
    if not train:
        return probability * x
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return dropout_apply(x, u, probability)


def masking(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``Masking.h``: x where mask > 0, else 0; the gradient is gated the
    same way."""
    return torch.where(mask > 0.0, x, torch.zeros_like(x))


def norm3d(x: torch.Tensor, eps_free: bool = True) -> torch.Tensor:
    """``Norm3D.h``: per-depth min-max normalisation of a [R, Ch, D]
    tensor.  The reference treats min and max as constants in its backward
    (the gradient is g / range), so both are detached; where min equals max
    the range is 1.  ``eps_free`` is accepted and ignored, as in the JAX
    package."""
    mn = x.amin(dim=(0, 1), keepdim=True).detach()
    mx = x.amax(dim=(0, 1), keepdim=True).detach()
    rng = torch.where(mn < mx, mx - mn, torch.ones_like(mn))
    return (x - mn) / rng
