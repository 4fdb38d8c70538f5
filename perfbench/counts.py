"""Operations and bytes of the fused SMP level, and the card's peaks: the
yardstick of every roofline and MFU share.

The counts are functions of the configuration and of each batch's present
vertices and slots only, never of the kernel or plan that ran, so a later
change that replaces a kernel is held to the same work.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
# sparsity, at the 700 W power limit).  The port's float32 products run on
# the tensor cores in three TF32 passes, so float32 work is held to the
# TF32 peak: against the 67 TFLOP/s of the CUDA cores a share could pass
# 100 %.
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


# Copied from chip_smoke.py:level_ops.
def level_ops(N, P, C, Cout, elements):
    """Floating-point operations of the fused level, as the function factors
    (ops/risi_level.py:risi18_level_factored_reference): nine [P*P, C] maps
    times a slab of K each, the adjacency applied once to W (2 * P per row
    and output), the vector and scalar cases (four slabs per row x and four
    per vertex), their broadcast with the bias and LeakyReLU (six per
    output), and the shared reductions (about six per present element of
    the gathered slots, ``elements``, and channel)."""
    rows = N * P * P
    return (rows * 9 * C * Cout * 2 + rows * P * Cout * 2
            + (N * P + N) * 4 * C * Cout * 2 + rows * Cout * 6
            + 6 * elements * C)


# Copied from chip_smoke.py:level_backward_ops.
def level_backward_ops(N, P, C, Cout, elements):
    """The level's adjoint as it factors
    (risi18_level_backward_factored_reference): dK's ten map slabs against
    G or G.Ap and the maps' cotangents from K's ten slabs (a product of
    P*P x C x Cout each), G.Ap (2 * P per row and output), G.R, GA, db and
    LeakyReLU' (eight per output), the vector and scalar cases both ways,
    the forward's reductions again (six per present element and channel)
    and dT's assembly from six maps (twelve)."""
    rows = N * P * P
    return (2 * rows * 10 * C * Cout * 2 + rows * P * Cout * 2
            + rows * Cout * 8 + 2 * (N * P + N) * 4 * C * Cout * 2
            + (6 + 12) * elements * C)


def level_bytes(N, P, C, Cout, dtype):
    """Bytes of one forward level, each input read once and the output
    written once (chip_smoke.py's ``nbytes(*args, out)``): state [N,P,P,C],
    nbr [N,P] and pos [N,P,P] int32, radj [N,P,P] float32, K [18C,Cout],
    b [Cout], out [N,P*P,Cout]."""
    e = ELEMENT_BYTES[dtype]
    return (N * P * P * C * e + N * P * 4 + 2 * N * P * P * 4
            + (18 * C * Cout + Cout) * e + N * P * P * Cout * e)


def level_backward_bytes(N, P, C, Cout, dtype):
    """Bytes of one level's backward (chip_smoke.py phase 5): the forward's
    inputs but b, the cotangent and the output read, dstate, dK and db
    written."""
    e = ELEMENT_BYTES[dtype]
    return (2 * N * P * P * C * e + N * P * 4 + 2 * N * P * P * 4
            + 2 * (18 * C * Cout) * e + Cout * e
            + 2 * N * P * P * Cout * e)


def bound_s(n_bytes, ops, dtype):
    """(the least seconds the card could take, by bytes; by operations)."""
    return n_bytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[dtype]


def present_elements(fields_prev, fields):
    """Present elements of the gathered slots of one level of one graph:
    sum over vertices v and w in phi_l(v) of |phi_l(v) & phi_{l-1}(w)|^2,
    from the boolean field matrices [n, n] of the two levels (row v holds
    phi(v)).  Slot w of v has one present position for each vertex in
    both fields, and a present element for each pair of them."""
    import numpy as np

    F = fields.astype(np.int64)
    # inter[v, w] = |phi_l(v) & phi_{l-1}(w)|
    inter = F @ fields_prev.astype(np.int64).T
    return int((F * inter * inter).sum())
