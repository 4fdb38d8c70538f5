"""Arithmetic and linear-algebra ops (counterpart of
``graphflow_tpu/ops/linalg.py``), named after the reference's op headers.

Tensors with channels are laid out [..., spatial..., C], the channel
("depth") axis last, as the reference's Tensor3D indexes (row, column,
depth) with depth fastest (``Tensor3D.h:37``).  Every function computes on
its inputs' device.
"""

from __future__ import annotations

import torch


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Add.h``: elementwise a + b."""
    return a + b


def subtract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Subtract.h``: elementwise a - b."""
    return a - b


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``Multiply.h``: Hadamard product."""
    return a * b


def inner_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``InnerProduct.h``: <a, b> over flattened vectors."""
    return (a * b).sum()


def outer_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``OuterProduct.h``: a b^T of the flattened operands."""
    return torch.outer(a.reshape(-1), b.reshape(-1))


def transpose(m: torch.Tensor) -> torch.Tensor:
    """``Transpose.h``: every axis reversed, as ``.T`` of a JAX array."""
    return m.permute(*reversed(range(m.ndim)))


def scalar_matmul(s, m: torch.Tensor) -> torch.Tensor:
    """``ScalarMatMul.h``: scalar * matrix; s may be a one-element tensor
    of any shape, which multiplies as a scalar."""
    if isinstance(s, torch.Tensor) and s.numel() == 1:
        return s.reshape(()) * m
    return s * m


def mat_vec_mul(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``MatVecMul.h``: [R, C] @ [C] -> [R]."""
    return m @ v


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``MatMul.h:48-67``: the dense product on the JAX package's float32
    route, ``dot(a, b, preferred_element_type=float32).astype(a.dtype)``.

    XLA computes that dot in the inputs' common type, at least float32
    (bfloat16 values are exact in float32), and rounds its result once to
    float32; the cast back to a's dtype is exact.  So a float64 product is
    the float64 one rounded to float32, not the float64 product itself."""
    acc = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                              torch.float32)
    return (a.to(acc) @ b.to(acc)).to(torch.float32).to(a.dtype)


def mat_tensor_mul(m: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``MatTensorMul.h``: m [R, S] times each depth slice of t [S, Cc, D]
    -> [R, Cc, D]."""
    return torch.einsum("rs,scd->rcd", m, t)


def tensor_mat_mul(t: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``TensorMatMul.h``: each depth slice of t [R, S, D] times m [S, Cc]
    -> [R, Cc, D]."""
    return torch.einsum("rsd,sc->rcd", t, m)


def tensor_mul(t1: torch.Tensor, t2: torch.Tensor) -> torch.Tensor:
    """``TensorMul.h``: per-depth product of t1 [R, S, D] and t2 [S, Cc, D]
    -> [R, Cc, D]."""
    return torch.einsum("rsd,scd->rcd", t1, t2)


def tensor4d_tensor3d_mul(t4: torch.Tensor, t3: torch.Tensor) -> torch.Tensor:
    """``Tensor4DTensor3DMul.h``: t4 [R, S, D1, D2] with t3 [S, Cc, D1] ->
    [R, Cc, D2], summing over (s, d1) for each output depth d2."""
    return torch.einsum("rsxy,scx->rcy", t4, t3)


def custom_matmul_tensor(m: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``CustomMatMulTensor.h:46-62``: channel mixing, m [Dout, Din] and
    t [R, Cc, Din] -> [R, Cc, Dout], out[i, j, k] = sum_v m[k, v] t[i, j, v]."""
    return torch.einsum("kv,ijv->ijk", m, t)


def vector_broadcast_mat(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``VectorBroadcastMat.h``: out[:, :, c] = v[c] * m."""
    return m[:, :, None] * v[None, None, :]


def mat_broadcast_mat(weights: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``MatBroadcastMat.h``: out[:, :, i, j] = weights[i, j] * m."""
    return m[:, :, None, None] * weights[None, None, :, :]


def vector_add_matrix(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``VectorAddMatrix.h``: bias v[c] added to every row of m [R, C]."""
    return m + v[None, :]


def vector_add_tensor(v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """``VectorAddTensor.h``: per-channel bias v[d] added to t [R, Cc, D]."""
    return t + v[None, None, :]


def linear_gram(X: torch.Tensor) -> torch.Tensor:
    """``LinearGram.h``: G[x, y] = <X[x], X[y]> of stacked rows."""
    return X @ X.T
