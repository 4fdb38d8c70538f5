"""Reductions, reshapes, stacking and gathers (counterpart of
``graphflow_tpu/ops/reductions.py``), named after the reference's op
headers.

The set-valued ops (SumVectors, the RisiLayers, ...) take their operand set
stacked on a leading axis, with an optional mask [N] for padded slots.
Every function computes on its inputs' device.
"""

from __future__ import annotations

import torch


def _masked(X: torch.Tensor, mask) -> torch.Tensor:
    """X with each member of the set multiplied by its mask entry."""
    if mask is None:
        return X
    return X * mask.reshape(mask.shape + (1,) * (X.ndim - 1))


def sum_components(v: torch.Tensor) -> torch.Tensor:
    """``SumComponents.h``: the sum of all entries."""
    return v.sum()


def sum_vectors(X: torch.Tensor, mask=None) -> torch.Tensor:
    """``SumVectors.h``: the sum of a set of vectors X [N, D]."""
    return _masked(X, mask).sum(dim=0)


def average_vectors(X: torch.Tensor, mask=None) -> torch.Tensor:
    """``AverageVectors.h``: the mean of a set of vectors; with a mask, the
    masked sum over max(sum(mask), 1)."""
    if mask is None:
        return X.mean(dim=0)
    denom = torch.maximum(mask.sum(), torch.ones((), dtype=mask.dtype,
                                                 device=mask.device))
    return _masked(X, mask).sum(dim=0) / denom


def sum_matrices(Ms: torch.Tensor, mask=None) -> torch.Tensor:
    """``SumMatrices.h``: the sum of a set of matrices Ms [N, R, C]."""
    return _masked(Ms, mask).sum(dim=0)


def sum_tensor3d(Ts: torch.Tensor, mask=None) -> torch.Tensor:
    """``SumTensor3D.h``: the sum of a set of 3-D tensors Ts [N, R, C, D]."""
    return _masked(Ts, mask).sum(dim=0)


def sum_rows(m: torch.Tensor) -> torch.Tensor:
    """``SumRows.h``: the vector of row sums."""
    return m.sum(dim=1)


def shrink_matrix(m: torch.Tensor, axis: int) -> torch.Tensor:
    """``ShrinkMatrix.h``: row sum (axis 0) or column sum (axis 1)."""
    return m.sum(dim=axis)


def shrink_tensor(t: torch.Tensor) -> torch.Tensor:
    """``ShrinkTensor.h:37-51``: a vertex tensor [R, Cc, D] summed over rows
    and columns to a channel vector [D]."""
    return t.sum(dim=(0, 1))


def concat(vectors) -> torch.Tensor:
    """``ConCat.h`` / ``ConcatVectors.h``: the flattened operands joined."""
    return torch.cat([v.reshape(-1) for v in vectors])


def matrix_concat(ms) -> torch.Tensor:
    """``MatrixConcat.h``: matrices stacked along rows."""
    return torch.cat(list(ms), dim=0)


def tensor3d_concat(ts) -> torch.Tensor:
    """``Tensor3DConcat.h``: 3-D tensors joined along depth."""
    return torch.cat(list(ts), dim=-1)


def tensor4d_concat(ts) -> torch.Tensor:
    """``Tensor4DConcat.h``: 4-D tensors joined along the last channel
    axis."""
    return torch.cat(list(ts), dim=-1)


def stack_tensor3d(ts):
    """``StackTensor3D.h``: N x [R, C, D] -> [N, R, C, D]; a tensor passes
    through unchanged."""
    if isinstance(ts, (list, tuple)):
        return torch.stack(list(ts), dim=0)
    return ts


def shuffle_matrix(m: torch.Tensor, sequence: torch.Tensor) -> torch.Tensor:
    """``ShuffleMatrix.h``: the rows of m in the order of ``sequence``
    (PATCHY-SAN's input assembly).  Float indices are truncated toward
    zero, as ``astype(int32)`` does (2.7 -> row 2)."""
    return m[sequence.to(torch.int64)]


def sort_vector(v: torch.Tensor) -> torch.Tensor:
    """``Sort.h``: ascending sort.  The gradient goes back through the
    permutation of a stable sort, so tied entries keep their order, as with
    ``jnp.sort``."""
    return torch.sort(v, stable=True).values


def kmax(v: torch.Tensor, k: int) -> torch.Tensor:
    """``KMax.h``: the k largest entries in ascending order; gradients go
    back to their original places (stable, as :func:`sort_vector`)."""
    return sort_vector(v)[-k:]


def vertex_representation(feature: torch.Tensor, weight: torch.Tensor,
                          vertex: int, n: int) -> torch.Tensor:
    """``VertexRepresentation.h``: <feature, weight> in slot ``vertex`` of
    an otherwise zero n-vector."""
    out = torch.zeros((n,), dtype=feature.dtype, device=feature.device)
    index = torch.tensor([vertex], device=feature.device)
    return out.index_put((index,), (feature * weight).sum().reshape(1))


# The CCN neighbour aggregations (the RisiLayer family).

def risi_layer_1d(X: torch.Tensor, mask=None) -> torch.Tensor:
    """``RisiLayer1D.h:38-59``: the elementwise sum of a vector set."""
    return sum_vectors(X, mask)


def risi_layer_2d(X: torch.Tensor, mask=None) -> torch.Tensor:
    """``RisiLayer2D.h:37-51``: the second-order symmetrised aggregation

      y[i] = sum_{u<v} sum_k (x_u[i] x_v[k] + x_u[k] x_v[i])
           = sum_u x_u[i] (S_tot - S_u),   S_u = sum_k x_u[k],

    the closed form of the reference's O(n^2 D^2) loop, in O(n D)."""
    X = _masked(X, mask)
    s = X.sum(dim=1)                                          # [N]
    return (X * (s.sum() - s)[:, None]).sum(dim=0)


def risi_layer_3d(X: torch.Tensor, mask=None) -> torch.Tensor:
    """``RisiLayer3D.h:43-69``: third-order products over ordered distinct
    triples, Y[x,y,z] = sum_{i,j,v distinct} x_i[x] x_j[y] x_v[z] -> [D, D, D].

    By inclusion-exclusion over distinctness instead of the reference's
    O(n^3 D^3) loop: with u = sum_i x_i, the sum over distinct triples is
    u^3 minus the three placements of one repeated index, plus twice the
    sum of x_i^3."""
    X = _masked(X, mask)
    ein = torch.einsum
    u = X.sum(dim=0)                                          # [D]
    return (ein("x,y,z->xyz", u, u, u)
            - ein("ix,iy,z->xyz", X, X, u)                    # i == j
            - ein("ix,y,iz->xyz", X, u, X)                    # i == v
            - ein("x,iy,iz->xyz", u, X, X)                    # j == v
            + 2.0 * ein("ix,iy,iz->xyz", X, X, X))


def reshape2d(x: torch.Tensor, nRows: int, nColumns: int) -> torch.Tensor:
    """``Reshape2D.h``: x as [nRows, nColumns]."""
    return x.reshape(nRows, nColumns)


def reshape3d(x: torch.Tensor, nRows: int, nColumns: int,
              nDepth: int) -> torch.Tensor:
    """``Reshape3D.h``: x as [nRows, nColumns, nDepth] (depth last)."""
    return x.reshape(nRows, nColumns, nDepth)


def reshape4d(x: torch.Tensor, nRows: int, nColumns: int, nChanels1: int,
              nChanels2: int) -> torch.Tensor:
    """``Reshape4D.h``: x as [nRows, nColumns, nChanels1, nChanels2]."""
    return x.reshape(nRows, nColumns, nChanels1, nChanels2)
