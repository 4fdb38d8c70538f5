"""Operations and bytes of one SMP_2D_ver7 level: the yardstick of
``level50_roofline.predict`` and of the ver7 cells' MFU.

A level is K7's aligned tensor T [N, P, P, P, C], the 50 cases of T
against the reduced adjacency A [N, P, P], the product with K [50C,
Cout], + b and LeakyReLU.  The counts are functions of the shapes alone,
never of the kernel or bank that ran, so that a later change that fuses
the level is held to the same work.  Operations follow the factoring of
``graphflow_tpu_torch/ops/contractions.py:risi_contraction_50_matmul``
(written down here, not read from it): every product as it is taken, K's
zero blocks included; a sum counts one operation per element it reads.
"""

from __future__ import annotations

from perfbench.counts import ELEMENT_BYTES

CASES = 50


def bank_product_ops(N, P, C, Cout):
    """The products of the factored bank, a row at a time: the three slabs
    with their mixed K blocks (2 P^2 C Cout each); the three weighted index
    sums of T (2 * 3 P^3 C each) and their products with K (2 * 3 P^2 C
    Cout each); the six vectors against the R and Rc blocks of K (2 * 2 *
    6 P C Cout); the four one-axis groups, the [P, P, 6C] slabs times a
    [6C, Cout] slab of K (2 * 6 P^2 C Cout each) and then with A (2 P^3
    Cout each); the five scalars' vectors times K (2 * 5 C Cout)."""
    row = (3 * 2 * P * P * C * Cout
           + 3 * (2 * 3 * P ** 3 * C + 2 * 3 * P * P * C * Cout)
           + 2 * 2 * 6 * P * C * Cout
           + 4 * (2 * 6 * P * P * C * Cout + 2 * P ** 3 * Cout)
           + 2 * 5 * C * Cout)
    return N * row


def bank_other_ops(N, P, C, Cout):
    """The rest of the factored bank, a row at a time: the sums of A (S, R,
    Rc: P^2 each; trA: P) and of T (T_ab, T_ac, T_bc: P^3 C each; T_a, T_b,
    T_c and the three diagonal sums over one more index: P^2 C each; T_full,
    the three double diagonal sums and the triple diagonal's: P C each);
    the mixed K blocks (three a slab: two scalings and a sum, C Cout each);
    the outer products (two a group of vectors, P^2 Cout each, and their
    sum); A times the scalars' vectors (P^2 Cout); and the running sum Z,
    eleven additions of a [P, P, Cout] term."""
    row = (3 * P * P + P
           + 3 * P ** 3 * C + 6 * P * P * C + 5 * P * C
           + 3 * 3 * C * Cout
           + 3 * P * P * Cout
           + P * P * Cout
           + 11 * P * P * Cout)
    return N * row


def level_ops(N, P, C, Cout):
    """Operations of one level: the factored bank with K, then + b and
    LeakyReLU (one each an output)."""
    return (bank_product_ops(N, P, C, Cout) + bank_other_ops(N, P, C, Cout)
            + 2 * N * P * P * Cout)


def level_backward_ops(N, P, C, Cout):
    """The level's backward, reckoned as twice its forward: each product's
    adjoint is two products of its size (the operands' cotangents), and
    each sum's adjoint a broadcast of its size or less."""
    return 2 * level_ops(N, P, C, Cout)


def level_bytes(N, P, C, Cout, dtype):
    """Bytes of one level, each input read once and the output written
    once: state [N, P, P, C], nbr [N, P] and pos [N, P, P] int32, radj [N,
    P, P], K [50C, Cout] and b [Cout] in the model's dtype, out [N, P*P,
    Cout].  T is an intermediate and is not counted."""
    e = ELEMENT_BYTES[dtype]
    return (N * P * P * C * e + N * P * 4 + N * P * P * 4 + N * P * P * e
            + (CASES * C * Cout + Cout) * e + N * P * P * Cout * e)


def level_backward_bytes(N, P, C, Cout, dtype):
    """Bytes of the level's backward, reckoned as twice its forward's (the
    forward's inputs and the cotangent read, their cotangents written)."""
    return 2 * level_bytes(N, P, C, Cout, dtype)
