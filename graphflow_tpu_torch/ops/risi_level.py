"""The fused second-order SMP level (counterpart of
``graphflow_tpu/ops/risi_fused_pallas.py:risi18_level``).

One level maps a state [N, P, P, C] to [N, P*P, Cout]:

    T_i = X_i f_{nbr(v,i)} X_i^T          (alignment, SMP_omega.h:641-648)
    Y   = RisiContraction_18(T, radj_v)   (RisiContraction_18.h:73-331)
    Z   = LeakyReLU(reshape(Y) @ K + b)   (SMP_omega.h:653-669)

``risi18_level_reference`` is the plain PyTorch version.  ``risi18_level``
is the wrapper: on CPU tensors it runs the plain version, which torch
autograd differentiates; on CUDA tensors it runs ``_Risi18LevelFn``, whose
forward launches the hand-written kernel ``csrc/risi18_level.cu`` (K1) and
whose backward launches ``csrc/risi18_level_bwd.cu`` (K2), or raises.
``risi18_level_backward`` is the backward's wrapper and
``risi18_level_backward_reference`` its plain version.
``risi18_row_gather_reference`` forms the gathered slots as the cluster
plans' tensor-copy route does (a neighbour's row copied in storage order,
then read through the slot's permutation of its columns), and
``risi18_row_scatter_reference`` its adjoint as K2's staged scatter adds
it (each row's dT in the neighbour's storage order, one add a row);
``risi18_slot_row_sums_reference`` the row sums that route's consumers
read in storage order against a slot's weights, and ``producer_pieces``
the pieces a tile streams there.
``risi18_level_factored_reference`` and
``risi18_level_backward_factored_reference`` are the same two functions in
the algebra the kernels use (nine map products and the adjacency applied
once; dK and the cotangents as products with G, G.Ap, G.R and GA), written
once, for the bank, in ``ops/risi_bank.py``; for the CPU tests.

Dtypes: the kernels take state, K and b in float32 or bfloat16 (one type)
and radj in float32, and sum in float32, as the Pallas kernels do
(``risi_fused_pallas.py:538, 619-626``); the output has the state's dtype
and is rounded once, after the bias and LeakyReLU.  The gradients come
back in the dtype of their parameter: dstate is scattered in float32 and
rounded once, dK and db are summed in float32 and rounded once
(``_v3t_bwd``, ``:1013-1033``).  The plain versions also take float64, for
parity tests.

Index conventions: ``nbr`` values lie in [0, N], where N marks an absent
neighbour; ``pos`` values lie in [0, P], where P marks an absent position.
Both read zeros.  (Prepared graphs mark padding slots by ``pos = P`` with
``nbr = 0``.)
"""

from __future__ import annotations

import ctypes
import functools

import torch

from graphflow_tpu_torch.ops.activations import leaky_relu
from graphflow_tpu_torch.ops.contractions import risi_contraction_18


# Storage dtype -> the dtype the level computes in.
_COMPUTE = {torch.float32: torch.float32, torch.bfloat16: torch.float32,
            torch.float64: torch.float64}


def risi18_level_reference(state, nbr, pos, radj, K, b, negslope=0.01):
    """Plain version of the kernel's function: gather and align, the
    18-case bank, the product with K, b, LeakyReLU, computed in float32
    for a float32 or bfloat16 state (state, radj, K and b cast up; float64
    stays float64) and rounded to the state's dtype once, at the end, which
    is what ``_kernel_v3`` does (``risi_fused_pallas.py:619-626``).  The
    JAX package's XLA composition (``_reference_level``, ``:1043-1056``)
    is the same function in float32 and float64; in bfloat16 it rounds the
    18C bank before the product with K, a different rounding."""
    from graphflow_tpu_torch.ops.risi_aligned import (
        risi18_aligned_t2_reference)

    if state.dtype not in _COMPUTE:
        raise TypeError(f"state has dtype {state.dtype}; the level takes "
                        f"{sorted(str(d) for d in _COMPUTE)}")
    ct = _COMPUTE[state.dtype]
    # The vertices nbr lists (all of the state's, or some of them for a
    # check that runs the plain level a few vertices at a time).
    N, P, C = nbr.shape[0], state.shape[1], state.shape[3]
    # Cast up before the gather: autograd then scatters dstate in ``ct`` and
    # rounds it once, as the kernels do, not once per added slot.
    T = risi18_aligned_t2_reference(state.to(ct), nbr, pos)
    Y = risi_contraction_18(T, radj.to(ct))
    Z = Y.reshape(N, P * P, 18 * C) @ K.to(ct) + b.to(ct)
    return leaky_relu(Z, negslope).to(state.dtype)


def risi18_level_backward_reference(state, nbr, pos, radj, K, b, g,
                                    negslope=0.01):
    """Plain backward: ``torch.autograd.grad`` of
    :func:`risi18_level_reference` with respect to (state, K, b) for the
    cotangent g [N, P*P, Cout] -> (dstate, dK, db), each in the dtype of
    its parameter (the casts inside the plain level round each once)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (state, K, b)]
        out = risi18_level_reference(leaves[0], nbr, pos, radj, leaves[1],
                                     leaves[2], negslope)
        return torch.autograd.grad(out, leaves, g)


def risi18_level_factored_reference(state, nbr, pos, radj, K, b,
                                    negslope=0.01):
    """The level as K1 (``csrc/risi18_level.cu``) factors it, in plain
    PyTorch: the take-gather, then the bank in the factored algebra
    (``ops/risi_bank.py:risi18_bank_factored_reference``: nine products of
    a [P*P, C] map instead of eighteen, and the adjacency applied once),
    then b and LeakyReLU, computed as :func:`risi18_level_reference`
    computes (float32 for a float32 or bfloat16 state, rounded once).  The
    same function as :func:`risi18_level_reference`, in another order of
    sums."""
    from graphflow_tpu_torch.ops.risi_aligned import (
        risi18_aligned_t2_reference)
    from graphflow_tpu_torch.ops.risi_bank import _bank_factored

    ct = _COMPUTE[state.dtype]
    N, P, _, C = state.shape
    T = risi18_aligned_t2_reference(state.to(ct), nbr, pos)
    Z = _bank_factored(T, radj.to(ct), K.to(ct))
    Z = Z.reshape(N, P * P, -1) + b.to(ct)
    return leaky_relu(Z, negslope).to(state.dtype)


def risi18_level_backward_factored_reference(state, nbr, pos, radj, K, b, g,
                                             negslope=0.01):
    """The level's gradients as K2 (``csrc/risi18_level_bwd.cu``) forms
    them, in plain PyTorch, without differentiating the 18 cases: G is the
    cotangent times LeakyReLU', the bank's factored backward
    (``ops/risi_bank.py:risi18_bank_backward_factored_reference``) gives
    dT and dK from G, dT goes back through the gather, and db sums G.
    -> (dstate, dK, db), each in the dtype of its parameter."""
    from graphflow_tpu_torch.ops.risi_aligned import (
        risi18_aligned_t2_reference)
    from graphflow_tpu_torch.ops.risi_bank import _bank_backward_factored

    ct = _COMPUTE[state.dtype]
    N, P, _, C = state.shape
    Cout = K.shape[1]
    out = risi18_level_reference(state, nbr, pos, radj, K, b, negslope)
    G = torch.where(out.to(ct) > 0, g.to(ct), negslope * g.to(ct))
    G = G.reshape(N, P, P, Cout)
    with torch.enable_grad():
        leaf = state.detach().to(ct).requires_grad_()
        T = risi18_aligned_t2_reference(leaf, nbr, pos)
    dT, dK = _bank_backward_factored(T.detach(), radj.to(ct), K.to(ct), G)
    (dstate,) = torch.autograd.grad(T, leaf, dT)
    db = G.sum((0, 1, 2))
    return dstate.to(state.dtype), dK.to(K.dtype), db.to(b.dtype)


def risi18_row_gather_reference(state, nbr, pos, chunk=16):
    """The aligned slots T [V, P, P, P, C] of ``nbr`` [V, P] and ``pos``
    [V, P, P] over ``state`` [N, P, P, C], formed as K1's and K2 kernel 1's
    cluster plans stream them on the tensor-copy route
    (``csrc/risi18_level_common.cuh:stream_rows_producer``,
    ``tile_reductions``), chunk by chunk of ``chunk`` channels (the box's
    width, ncp): row b of slot a is the neighbour's row state[n, p1, :,
    c0:c0+chunk] in storage order (n = nbr[v, a], p1 = pos[v, a, b]), zeros
    past C and for an absent n or p1; column c of it is then the cell
    pos[v, a, c] of that row, zero where the position is absent.  Absent
    means outside [0, N) or [0, P) (the sentinels N and P).  It only
    indexes, so it is :func:`risi_aligned.risi18_aligned_t2_reference`'s T
    bit for bit, in the state's dtype, and autograd scatters its cotangent
    back into the state."""
    N, P, _, C = state.shape
    V = nbr.shape[0]
    n_ok = (nbr >= 0) & (nbr < N)                          # [V, P]
    p_ok = (pos >= 0) & (pos < P)                          # [V, P, P]
    n = torch.where(n_ok, nbr, 0).long()
    p = torch.where(p_ok, pos, 0).long()
    row_ok = (n_ok[:, :, None] & p_ok)[..., None, None]    # [V, a, b, 1, 1]
    cell = p[:, :, None, :, None].expand(V, P, P, P, chunk)
    cell_ok = p_ok[:, :, None, :, None]                    # [V, a, 1, c, 1]
    zero = state.new_zeros(())
    parts = []
    for c0 in range(0, C, chunk):
        box = state[..., c0:c0 + chunk]
        if box.shape[-1] < chunk:      # the box's channels past C: zeros
            box = torch.cat([box, state.new_zeros(
                (N, P, P, chunk - box.shape[-1]))], -1)
        # Rows b of the slots in storage order: [V, a, b, P cells, chunk].
        rows = torch.where(row_ok, box[n[:, :, None], p], zero)
        # Column c read at cell pos[v, a, c] of its row.
        T = torch.where(cell_ok, torch.gather(rows, 3, cell), zero)
        parts.append(T[..., :min(chunk, C - c0)])
    return torch.cat(parts, -1)


def risi18_row_scatter_reference(dT, nbr, pos, N, chunk=16):
    """The adjoint of :func:`risi18_row_gather_reference` as K2 kernel 1's
    staged scatter forms it (``csrc/risi18_backward_block.cuh:
    dT_stage_rows``): dT [V, P, P, P, C] of the gathered slots of ``nbr``
    [V, P] and ``pos`` [V, P, P] -> dstate [N, P, P, C].  Chunk by chunk of
    ``chunk`` channels (the box's width, ncp; zeros past C), the row (a, b)
    of dT is staged in the neighbour's storage order, cell j the sum of
    dT[v, a, b, c] over the columns c with pos[v, a, c] = j (repeats added,
    0 where no column reads the cell), and added into dstate[n, p1, :,
    c0:c0+chunk] (n = nbr[v, a], p1 = pos[v, a, b]; channels past C not
    written); a row whose n or p1 is absent (outside [0, N) or [0, P)) adds
    nothing.  It only adds, so it is the take-gather's cotangent to
    rounding, in dT's dtype."""
    V, P = nbr.shape
    C = dT.shape[-1]
    n_ok = (nbr >= 0) & (nbr < N)                          # [V, P]
    p_ok = (pos >= 0) & (pos < P)                          # [V, P, P]
    n = torch.where(n_ok, nbr, 0).long()
    p = torch.where(p_ok, pos, 0).long()
    row_ok = (n_ok[:, :, None] & p_ok).reshape(-1)         # rows (v, a, b)
    target = (n[:, :, None] * P + p).reshape(-1)[row_ok]   # rows n*P + p1
    # hit[v, a, c, j]: column c of slot a reads cell j of its rows.
    hit = (p_ok[..., None] & (p[..., None] == torch.arange(
        P, device=pos.device))).to(dT.dtype)
    dstate = dT.new_zeros((N * P, P, C))
    for c0 in range(0, C, chunk):
        box = dT[..., c0:c0 + chunk]
        if box.shape[-1] < chunk:      # the box's channels past C: zeros
            box = torch.cat([box, box.new_zeros(
                box.shape[:-1] + (chunk - box.shape[-1],))], -1)
        staged = torch.einsum("vabcf,vacj->vabjf", box, hit)
        rows = staged.reshape(V * P * P, P, chunk)[row_ok]
        width = min(chunk, C - c0)
        dstate[..., c0:c0 + width].index_add_(0, target, rows[..., :width])
    return dstate.reshape(N, P, P, C)


def risi18_slot_weights(pos, R):
    """The weights against which the tensor-copy route's consumers read a
    row of a whole slot in storage order (``csrc/risi18_level_common.cuh:
    tile_reductions``): for pos [V, P, P] and R [V, P], cols[v, a, j] the
    number of columns c with pos[v, a, c] = j and rw[v, a, j] the sum of
    R[v, c] over them, in c's order; zero for a cell that no column reads
    (a position outside [0, P) reads none) -> (cols, rw) [V, P, P] in R's
    dtype."""
    P = pos.shape[-1]
    hit = (pos[..., None] == torch.arange(P, device=pos.device)).to(R.dtype)
    return hit.sum(2), torch.einsum("vacj,vc->vaj", hit, R)


def risi18_slot_row_sums_reference(state, nbr, pos, radj):
    """T_ab[a, b] = sum_c T[a, b, c] and M6[a, b] = sum_c R[c] T[a, b, c]
    of every slot, formed as the tensor-copy route's consumers form them for
    the rows b of a whole slot outside its tile: the neighbour's row
    state[n, p1, :, :] in storage order (zeros for an absent n or p1)
    against the slot's weights (:func:`risi18_slot_weights`), T_ab =
    sum_j cols[a, j] row[j] and M6 = sum_j rw[a, j] row[j], with no index
    a cell -> (tab, m6) [V, P, P, C], computed as
    :func:`risi18_level_reference` computes.  The same values in another
    order of sums."""
    ct = _COMPUTE[state.dtype]
    N, P = state.shape[:2]
    n_ok = (nbr >= 0) & (nbr < N)
    p_ok = (pos >= 0) & (pos < P)
    n = torch.where(n_ok, nbr, 0).long()
    p = torch.where(p_ok, pos, 0).long()
    rows = state.to(ct)[n[:, :, None], p]           # [V, a, b, P(j), C]
    rows = torch.where((n_ok[:, :, None] & p_ok)[..., None, None], rows,
                       rows.new_zeros(()))
    cols, rw = risi18_slot_weights(pos, radj.to(ct).clamp(min=0).sum(-1))
    return (torch.einsum("vabjf,vaj->vabf", rows, cols),
            torch.einsum("vabjf,vaj->vabf", rows, rw))


def producer_pieces(nbr, pos, N, rows, tile):
    """The pieces that tile ``tile`` (rows [x0, x0 + rows) of the field,
    x0 = tile * rows) of one vertex streams on the tensor-copy route, as
    ``csrc/risi18_level_common.cuh:tile_reductions`` lists them before the
    stream (``piece_entry``), for the vertex's nbr [P] and pos [P, P]
    (absent: outside [0, N) and [0, P)): a list of (a, b0, present).
    First the rows from x0 of every listed slot a (its neighbour present
    and a position set: ``list_slots``), then, for each listed slot a in
    the tile, its other row groups b0 = 0, rows, ... in order; ``present``
    has one bool a row b0 + bl < P, whether the row is copied and reduced
    (its neighbour and p1 present).  A tile streams fewer than 2P pieces,
    the words its list takes (``producer_words``)."""
    P = len(nbr)
    nbr, pos = [int(x) for x in nbr], [[int(x) for x in r] for r in pos]
    n_ok = [0 <= x < N for x in nbr]
    p_ok = [[0 <= x < P for x in r] for r in pos]
    slots = [a for a in range(P) if n_ok[a] and any(p_ok[a])]
    x0, nrg = tile * rows, -(-P // rows)
    nx = min(rows, P - x0)
    mine = [a for a in slots if x0 <= a < x0 + nx]
    pieces = [(a, x0) for a in slots]
    pieces += [(a, (r if r < tile else r + 1) * rows) for a in mine
               for r in range(nrg - 1)]
    return [(a, b0, [n_ok[a] and p_ok[a][b] for b in
                     range(b0, min(P, b0 + rows))]) for a, b0 in pieces]



def risi18_level_cluster_reference(state, nbr, pos, radj, K, b, rows,
                                   cluster, negslope=0.01, chunk=16):
    """The level as K1's cluster plan forms it
    (``csrc/risi18_forward_block.cuh:forward_block_cluster``), in plain
    PyTorch: the slots gathered as the tensor-copy route gathers them, in
    chunks of ``chunk`` channels (:func:`risi18_row_gather_reference`),
    then the bank in row tiles of ``rows`` rows over a cluster of
    ``cluster`` blocks (``ops/risi_bank.py:risi18_bank_cluster_reference``:
    each block's tiles, the scalar cases' parts added in rank order; a
    whole slot's rows outside its tile read in storage order against the
    slot's weights, :func:`risi18_slot_row_sums_reference`), then b and
    LeakyReLU, computed as :func:`risi18_level_reference` computes and
    rounded once."""
    from graphflow_tpu_torch.ops.risi_bank import risi18_bank_cluster_reference

    ct = _COMPUTE[state.dtype]
    N, P, _, C = state.shape
    T = risi18_row_gather_reference(state.to(ct), nbr, pos, chunk)
    Z = risi18_bank_cluster_reference(
        T, radj.to(ct), K.to(ct), rows, cluster,
        risi18_slot_row_sums_reference(state, nbr, pos, radj))
    Z = Z.reshape(N, P * P, -1) + b.to(ct)
    return leaky_relu(Z, negslope).to(state.dtype)


def risi18_level_backward_cluster_reference(state, nbr, pos, radj, K, b, g,
                                            rows, cluster, negslope=0.01,
                                            chunk=16):
    """The level's gradients as K2 kernel 1's cluster plan forms them
    (``csrc/risi18_backward_block.cuh:backward_block_cluster``), in plain
    PyTorch: G is the cotangent times LeakyReLU'; the slots gathered as the
    tensor-copy route gathers them (:func:`risi18_row_gather_reference`,
    chunks of ``chunk`` channels); per block of a cluster of ``cluster``,
    its row tiles of ``rows`` rows give its parts of GA, db and dK and dT
    of its rows b (``ops/risi_bank.py:_bank_backward_cluster``; a whole
    slot's rows outside its tile read against the slot's weights,
    :func:`risi18_slot_row_sums_reference`); GA, dK and db are the blocks'
    parts added in rank order, and dT goes back as the staged scatter adds
    it (:func:`risi18_row_scatter_reference`: each gathered row in the
    neighbour's storage order).  -> (dstate, dK, db), each in the dtype of
    its parameter."""
    from graphflow_tpu_torch.ops.risi_bank import _bank_backward_cluster

    ct = _COMPUTE[state.dtype]
    N, P, _, C = state.shape
    Cout = K.shape[1]
    out = risi18_level_reference(state, nbr, pos, radj, K, b, negslope)
    G = torch.where(out.to(ct) > 0, g.to(ct), negslope * g.to(ct))
    G = G.reshape(N, P, P, Cout)
    T = risi18_row_gather_reference(state.detach().to(ct), nbr, pos, chunk)
    dT, dK, db_parts = _bank_backward_cluster(
        T, radj.to(ct), K.to(ct), G, rows, cluster,
        risi18_slot_row_sums_reference(state.detach(), nbr, pos, radj))
    dstate = risi18_row_scatter_reference(dT, nbr, pos, N, chunk)
    db = db_parts[0]
    for part in db_parts[1:]:
        db = db + part
    return dstate.to(state.dtype), dK.to(K.dtype), db.to(b.dtype)


def _bind_min_smem(fn):
    """A library's ``*_min_smem_bytes(P, Cout)``: the least shared memory
    one block of its kernel needs, by the kernel's own layout."""
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong


def _bind_plan(fn):
    """A library's ``*_plan(N, P, C, Cout, bf16, aligned, int plan[])``:
    the plan its launcher takes (see :func:`query_plan`; eleven fields
    forward, thirteen backward)."""
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int


PLAN_KEYS = ("rows", "panel", "chunk", "depth", "smem_bytes", "tiled",
             "pieces", "cluster", "tiles_per_block", "mma", "stream")
# The backward plans' two more fields before ``stream``: kernel 0's float32
# scratch words a vertex, reported as ``scratch_bytes`` for the N vertices,
# and its shared memory; and one after it, how dT reaches its destination.
BACKWARD_PLAN_KEYS = PLAN_KEYS[:-1] + ("scratch_bytes", "sums_smem_bytes",
                                       "stream", "scatter")


# A plan's ``stream`` field -> its name.
STREAMS = ("cp_async", "tma_producer")
# A backward plan's ``scatter`` field -> its name
# (``csrc/risi18_backward_block.cuh``: kScatterAtomic, kScatterTmaReduce,
# kScatterStore).
SCATTERS = ("atomic", "tma_reduce", "store")


def alignment_of(t):
    """The bytes ``t``'s first element's address is a multiple of, up to
    16, as the launchers read it (``csrc/risi18_level_common.cuh:
    alignment_of``)."""
    a = t.data_ptr()
    return 16 if a % 16 == 0 else 8 if a % 8 == 0 else 4 if a % 4 == 0 else 2


def query_plan(fn, N, P, C, Cout, dtype=torch.float32, backward=False,
               aligned=16):
    """The plan a kernel's launcher takes for N vertices of a field of P
    rows, C input and Cout output channels in ``dtype`` (inputs whose state,
    or T, starts at a multiple of ``aligned`` bytes: 16, 8, 4 or 2), from
    the library's ``*_plan`` entry ``fn``: a dict with
    ``rows`` (the rows of a row tile; P for a plan that keeps every row),
    ``panel`` (output channels a block), ``chunk`` (input channels a pass),
    ``depth`` (the ring's buffers), ``smem_bytes``, ``tiled`` (a row-tiled
    block), ``pieces`` (pieces of ``rows`` rows a ring buffer holds),
    ``cluster`` (blocks a cluster of a cluster plan, 0 for one block a
    vertex or vertex group), ``tiles_per_block`` (row tiles a block of the
    cluster takes), ``mma`` (1: the products run on the tensor cores) and
    ``stream`` (``"tma_producer"``: a producer warp copies every gathered
    row with one tensor copy and the other warps only reduce, reading a row
    through the slot's permutation or against its weights, on a cluster
    plan of K1 or K2 whose chunk and C are multiples of 16 bytes over a
    16-byte aligned state and whose row tile has at most 15 rows; else
    ``"cp_async"``, a copy a cell); None where no plan fits.
    N matters to a cluster plan only: a cluster takes fewer blocks where
    the grid of one block a vertex already fills the card
    (``csrc/risi18_level_common.cuh:cluster_shape``).  A backward plan
    (``backward``) adds ``scratch_bytes``, the float32 scratch kernel 0
    fills for N vertices (GAp [N,P,P,Cout] and the row sums [N,3,P,Cout]:
    ``csrc/risi18_backward_block.cuh:backward_sums_kernel``), and
    ``sums_smem_bytes``, kernel 0's shared memory a block; both 0 on a
    plan of no cluster, which launches no kernel 0; and ``scatter``, how
    kernel 1 adds dT into dstate: ``"tma_reduce"`` (K2 on a cluster plan
    whose C is a multiple of 4, whose chunk has more than 4 channels, whose
    row tile has at most 8 rows and whose warps' staging buffers fit over
    G: each gathered row's dT staged in the neighbour's storage order and
    added by one tensor reduce, :func:`risi18_row_scatter_reference`),
    ``"atomic"`` (float32 atomics a cell) or ``"store"`` (K5: dT written).
    Needs the CUDA library (it is built with nvcc), not a card."""
    keys = BACKWARD_PLAN_KEYS if backward else PLAN_KEYS
    plan = (ctypes.c_int * len(keys))()
    if fn(N, P, C, Cout, int(dtype == torch.bfloat16), aligned, plan):
        return None
    got = {k: int(v) for k, v in zip(keys, plan)}
    if backward:
        got["scratch_bytes"] *= 4 * N
    got["stream"] = STREAMS[got["stream"]]
    if backward:
        got["scatter"] = SCATTERS[got["scatter"]]
    return got


@functools.lru_cache(maxsize=None)
def level_plan(N, P, C, Cout, dtype=torch.float32, aligned=16):
    """K1's plan for N vertices (:func:`query_plan`)."""
    return query_plan(_kernel_lib().risi18_level_plan, N, P, C, Cout, dtype,
                      aligned=aligned)


@functools.lru_cache(maxsize=None)
def level_backward_plan(N, P, C, Cout, dtype=torch.float32, aligned=16):
    """K2 kernel 1's plan for N vertices (:func:`query_plan`, with kernel
    0's scratch)."""
    return query_plan(_backward_lib().risi18_level_backward_plan, N, P, C,
                      Cout, dtype, backward=True, aligned=aligned)


@functools.lru_cache(maxsize=None)
def _kernel_lib() -> ctypes.CDLL:
    from graphflow_tpu_torch.runtime.cuda_build import load_library

    lib = load_library("risi18_level")
    ptr = ctypes.c_void_p
    for fn in (lib.risi18_level_forward_f32, lib.risi18_level_forward_bf16):
        fn.argtypes = [ptr] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float, ptr]
        fn.restype = ctypes.c_int
    _bind_min_smem(lib.risi18_level_min_smem_bytes)
    _bind_plan(lib.risi18_level_plan)
    lib.risi18_level_error_string.argtypes = [ctypes.c_int]
    lib.risi18_level_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _backward_lib() -> ctypes.CDLL:
    from graphflow_tpu_torch.runtime.cuda_build import load_library

    lib = load_library("risi18_level_bwd")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.risi18_level_backward_blocks.argtypes = [i32]
    lib.risi18_level_backward_blocks.restype = i32
    for fn in (lib.risi18_level_backward_f32,
               lib.risi18_level_backward_bf16):
        fn.argtypes = [ptr] * 11 + [i32] * 4 + [ctypes.c_float, i32, ptr]
        fn.restype = i32
    for fn in (lib.risi18_level_backward_sums_f32,
               lib.risi18_level_backward_sums_bf16):
        fn.argtypes = [ptr] * 5 + [i32] * 3 + [ctypes.c_float, ptr]
        fn.restype = i32
    lib.risi18_level_backward_reduce_f32.argtypes = (
        [ptr] * 3 + [i32] * 3 + [ptr])
    lib.risi18_level_backward_reduce_f32.restype = i32
    lib.risi18_level_backward_finish_bf16.argtypes = (
        [ptr] * 5 + [ctypes.c_longlong] + [i32] * 3 + [ptr])
    lib.risi18_level_backward_finish_bf16.restype = i32
    _bind_min_smem(lib.risi18_level_backward_min_smem_bytes)
    _bind_plan(lib.risi18_level_backward_plan)
    lib.risi18_level_bwd_error_string.argtypes = [i32]
    lib.risi18_level_bwd_error_string.restype = ctypes.c_char_p
    return lib


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, state on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


# Kernel element type -> the suffix of its C entry points.
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_element_type(name, t):
    if t.dtype not in _SUFFIX:
        raise TypeError(f"{name} has dtype {t.dtype}, the kernels take "
                        f"torch.float32 or torch.bfloat16")


def _entry(lib, stem, dtype):
    """The C entry point ``{stem}_f32`` or ``{stem}_bf16`` of ``lib``."""
    return getattr(lib, f"{stem}_{_SUFFIX[dtype]}")


def _check_level(state, nbr, pos, radj, K):
    """Checks the inputs both kernels share: state and K in one of float32
    and bfloat16, radj float32, nbr and pos int32; returns (N, P, C, Cout)."""
    if state.dim() != 4 or state.shape[1] != state.shape[2]:
        raise ValueError(f"state has shape {tuple(state.shape)}, expected "
                         f"[N, P, P, C]")
    N, P, _, C = state.shape
    Cout = K.shape[1] if K.dim() == 2 else -1
    _check_element_type("state", state)
    dev = state.device
    _check("state", state, state.dtype, (N, P, P, C), dev)
    _check("nbr", nbr, torch.int32, (N, P), dev)
    _check("pos", pos, torch.int32, (N, P, P), dev)
    _check("radj", radj, torch.float32, (N, P, P), dev)
    _check("K", K, state.dtype, (18 * C, Cout), dev)
    return N, P, C, Cout


def _where(N, P, C, Cout, dtype):
    return f"N={N} P={P} C={C} Cout={Cout} {dtype}"


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


# Shared memory one block may take on sm_90 (227 KB), as kMaxSmemBytes of
# ``csrc/risi18_common.cuh``.
SMEM_LIMIT_BYTES = 232448


def check_smem(what, min_smem_bytes, P, Cout):
    """Raises when a block of kernel ``what`` cannot fit its shared memory:
    the kernels keep a vertex's adjacency [P, P] (and the level's blocks
    its positions), and the maps and the output (or cotangent) of a tile of
    its rows for at least four output channels, in one block, so a
    receptive field too large even for tiles of one row is refused, never
    rerouted.  ``min_smem_bytes(P, Cout)`` is the library's own count of
    the bytes its smallest block needs: ``make_forward_plan`` and
    ``make_backward_plan`` of ``csrc/risi18_forward_block.cuh`` and
    ``csrc/risi18_backward_block.cuh`` at a chunk of one float32 channel in
    row tiles of one row (the bank's backward keeps all of Cout in one
    panel)."""
    need = min_smem_bytes(P, Cout)
    if need > SMEM_LIMIT_BYTES:
        raise RuntimeError(
            f"{what}: a receptive field of P={P} at Cout={Cout} needs "
            f"{need} bytes ({need / 1024:.0f} KB) of shared memory in one "
            f"block, and an H100 block has {SMEM_LIMIT_BYTES} bytes "
            f"(227 KB), even in row tiles of one row")


def _raise_on(err, what, lib_error_string, where):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed at {where}: "
                           f"{lib_error_string(err).decode()}")


def _forward_kernel(state, nbr, pos, radj, K, b, negslope):
    """K1: one launch of ``risi18_level_forward_{f32,bf16}``.  A cluster
    plan keeps its pre-activations in float32 until the cluster has summed
    the scalar cases: in ``out`` itself in float32, in a float32 scratch
    [N, P*P, Cout] in bfloat16."""
    N, P, C, Cout = _check_level(state, nbr, pos, radj, K)
    dev, dt = state.device, state.dtype
    _check("b", b, dt, (Cout,), dev)
    lib = _kernel_lib()
    check_smem("risi18_level", lib.risi18_level_min_smem_bytes, P, Cout)
    out = torch.empty((N, P * P, Cout), dtype=dt, device=dev)
    plan = level_plan(N, P, C, Cout, dt, alignment_of(state))
    pre = out
    if dt != torch.float32 and plan is not None and plan["cluster"]:
        pre = torch.empty((N, P * P, Cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry(lib, "risi18_level_forward", dt)(
            state.data_ptr(), nbr.data_ptr(), pos.data_ptr(), radj.data_ptr(),
            K.data_ptr(), b.data_ptr(), out.data_ptr(), pre.data_ptr(), N, P,
            C, Cout, float(negslope), _stream(dev))
    _raise_on(err, "risi18_level", lib.risi18_level_error_string,
              _where(N, P, C, Cout, dt) + (f", plan {plan}" if err else ""))
    risi18_level.launches += 1
    if plan is not None and plan["stream"] == "tma_producer":
        risi18_level.tma_launches += 1
    return out


def _backward_sums_kernel(radj, g, out, negslope):
    """K2, kernel 0 (``risi18_level_backward_sums_{f32,bf16}``): once a
    vertex, GAp and the row sums of geff = g through LeakyReLU' of out, the
    float32 scratch that kernel 1 reads on a cluster plan; returns (gap
    [N,P,P,Cout], sums [N,3,P,Cout]: GR, GAx, GSx), float32."""
    _check_element_type("g", g)
    if g.dim() != 3 or radj.dim() != 3:
        raise ValueError(f"g has shape {tuple(g.shape)} and radj "
                         f"{tuple(radj.shape)}, expected [N, P*P, Cout] and "
                         f"[N, P, P]")
    N, P, Cout = g.shape[0], radj.shape[1], g.shape[2]
    dev, dt = g.device, g.dtype
    _check("radj", radj, torch.float32, (N, P, P), dev)
    _check("g", g, dt, (N, P * P, Cout), dev)
    _check("out", out, dt, (N, P * P, Cout), dev)
    lib = _backward_lib()
    gap = torch.empty((N, P, P, Cout), dtype=torch.float32, device=dev)
    sums = torch.empty((N, 3, P, Cout), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _entry(lib, "risi18_level_backward_sums", dt)(
            radj.data_ptr(), g.data_ptr(), out.data_ptr(), gap.data_ptr(),
            sums.data_ptr(), N, P, Cout, float(negslope), _stream(dev))
    _raise_on(err, "risi18_level_backward sums",
              lib.risi18_level_bwd_error_string,
              f"N={N} P={P} Cout={Cout} {dt}")
    risi18_level_backward.sums_launches += 1
    return gap, sums


def risi18_level_backward_sums_reference(radj, g, out, negslope=0.01):
    """Plain kernel 0 of the level's backward: geff = g where out > 0, else
    negslope g, computed in float32 (float64 stays float64), as
    [N,P,P,Cout], and its sums (``ops/risi_bank.py:
    backward_sums_reference``) -> (gap [N,P,P,Cout], sums [N,3,P,Cout])."""
    from graphflow_tpu_torch.ops.risi_bank import backward_sums_reference

    ct = _COMPUTE[g.dtype]
    N, P = radj.shape[:2]
    G = torch.where(out.to(ct) > 0, g.to(ct), negslope * g.to(ct))
    return backward_sums_reference(G.reshape(N, P, P, -1), radj.to(ct))


def risi18_level_backward_sums(radj, g, out, negslope=0.01):
    """Kernel 0 of the level's backward on a cluster plan: radj [N,P,P],
    g and out [N,P*P,Cout] -> (gap [N,P,P,Cout], sums [N,3,P,Cout]: GR,
    GAx, GSx), float32 (float64 for float64 on the CPU).  CPU tensors run
    :func:`risi18_level_backward_sums_reference`; CUDA tensors launch
    kernel 0 (``csrc/risi18_level_bwd.cu``), or raise."""
    if g.device.type == "cpu":
        return risi18_level_backward_sums_reference(radj, g, out, negslope)
    if g.device.type != "cuda":
        raise ValueError(f"no level kernel for device {g.device}")
    return _backward_sums_kernel(radj, g, out, negslope)


def _backward_main_kernel(state, nbr, pos, radj, K, g, out, negslope,
                          sums=None):
    """K2, kernel 1 (``risi18_level_backward_{f32,bf16}``): dstate (float32
    atomics into float32 zeros, whatever the state's dtype) and one partial
    row of [dK | db] per vertex group; returns (dstate in float32,
    partial).  On a cluster plan kernel 0 (:func:`_backward_sums_kernel`)
    runs first, and kernel 1 reads its scratch (the plan's
    ``scratch_bytes``), or the (gap, sums) that ``sums`` gives (a timing of
    kernel 1 alone)."""
    N, P, C, Cout = _check_level(state, nbr, pos, radj, K)
    dev, dt = state.device, state.dtype
    _check("g", g, dt, (N, P * P, Cout), dev)
    _check("out", out, dt, (N, P * P, Cout), dev)
    lib = _backward_lib()
    check_smem("risi18_level_backward",
               lib.risi18_level_backward_min_smem_bytes, P, Cout)
    nblocks = lib.risi18_level_backward_blocks(N)
    dstate = torch.zeros(state.shape, dtype=torch.float32, device=dev)
    partial = torch.empty((nblocks, 18 * C * Cout + Cout),
                          dtype=torch.float32, device=dev)
    if N == 0:
        return dstate, partial
    plan = level_backward_plan(N, P, C, Cout, dt, alignment_of(state))
    gap = None
    if plan is not None and plan["cluster"]:
        gap, sums = _backward_sums_kernel(radj, g, out, negslope) if sums is None else sums
    else:
        sums = None
    with torch.cuda.device(dev):
        err = _entry(lib, "risi18_level_backward", dt)(
            state.data_ptr(), nbr.data_ptr(), pos.data_ptr(), radj.data_ptr(),
            K.data_ptr(), g.data_ptr(), out.data_ptr(),
            None if gap is None else gap.data_ptr(),
            None if sums is None else sums.data_ptr(), dstate.data_ptr(),
            partial.data_ptr(), N, P, C, Cout, float(negslope), nblocks,
            _stream(dev))
    _raise_on(err, "risi18_level_backward", lib.risi18_level_bwd_error_string,
              _where(N, P, C, Cout, dt) + (f", plan {plan}" if err else ""))
    risi18_level_backward.launches += 1
    if plan is not None and plan["stream"] == "tma_producer":
        risi18_level_backward.tma_launches += 1
    if plan is not None and plan["scatter"] == "tma_reduce":
        risi18_level_backward.scatter_tma_launches += 1
    return dstate, partial


def _check_partial(partial, C, Cout):
    _check("partial", partial, torch.float32,
           (partial.shape[0], 18 * C * Cout + Cout), partial.device)


def _backward_reduce_kernel(partial, C, Cout):
    """K2, kernel 2 in float32: the partial rows summed into (dK [18C,
    Cout], db)."""
    dev = partial.device
    _check_partial(partial, C, Cout)
    lib = _backward_lib()
    dK = torch.empty((18 * C, Cout), dtype=torch.float32, device=dev)
    db = torch.empty((Cout,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.risi18_level_backward_reduce_f32(
            partial.data_ptr(), dK.data_ptr(), db.data_ptr(),
            partial.shape[0], C, Cout, _stream(dev))
    _raise_on(err, "risi18_level_backward reduce",
              lib.risi18_level_bwd_error_string,
              f"{partial.shape[0]} partial rows, C={C} Cout={Cout}")
    risi18_level_backward.reduce_launches += 1
    return dK, db


def _backward_finish_kernel_bf16(partial, dstate32, C, Cout):
    """K2, kernel 2 in bfloat16 (``risi18_level_backward_finish_bf16``):
    one launch sums the partial rows into dK and db and rounds kernel 1's
    float32 ``dstate32`` into dstate, each value once -> (dstate, dK, db),
    all bfloat16."""
    dev, bf16 = partial.device, torch.bfloat16
    _check_partial(partial, C, Cout)
    _check("dstate32", dstate32, torch.float32, tuple(dstate32.shape), dev)
    lib = _backward_lib()
    dstate = torch.empty(dstate32.shape, dtype=bf16, device=dev)
    dK = torch.empty((18 * C, Cout), dtype=bf16, device=dev)
    db = torch.empty((Cout,), dtype=bf16, device=dev)
    with torch.cuda.device(dev):
        err = lib.risi18_level_backward_finish_bf16(
            partial.data_ptr(), dK.data_ptr(), db.data_ptr(),
            dstate32.data_ptr(), dstate.data_ptr(), dstate32.numel(),
            partial.shape[0], C, Cout, _stream(dev))
    _raise_on(err, "risi18_level_backward finish",
              lib.risi18_level_bwd_error_string,
              f"{partial.shape[0]} partial rows, C={C} Cout={Cout}, "
              f"{dstate32.numel()} state elements")
    risi18_level_backward.reduce_launches += 1
    return dstate, dK, db


def risi18_level_backward(state, nbr, pos, radj, K, b, out, g,
                          negslope=0.01):
    """Gradients of the level for the cotangent g [N, P*P, Cout] ->
    (dstate [N,P,P,C], dK [18C, Cout], db [Cout]); nbr, pos and radj get
    none.  ``out`` is the level's output for these inputs.

    CPU tensors run :func:`risi18_level_backward_reference`, which
    recomputes the output.  CUDA tensors launch K2's two kernels
    (``csrc/risi18_level_bwd.cu``) on float32 or bfloat16 inputs, or
    raise.  The gradients have the dtype of their parameter: in bfloat16
    kernel 1 scatters into a float32 buffer, and kernel 2 rounds it, dK and
    db once each.
    """
    if state.device.type == "cpu":
        return risi18_level_backward_reference(state, nbr, pos, radj, K, b, g,
                                               negslope)
    if state.device.type != "cuda":
        raise ValueError(f"no level kernel for device {state.device}")
    dstate, partial = _backward_main_kernel(state, nbr, pos, radj, K, g, out,
                                            negslope)
    C, Cout = state.shape[3], K.shape[1]
    if state.dtype == torch.bfloat16:
        return _backward_finish_kernel_bf16(partial, dstate, C, Cout)
    dK, db = _backward_reduce_kernel(partial, C, Cout)
    return dstate, dK, db


risi18_level_backward.sums_launches = 0     # kernel 0 (cluster plans)
risi18_level_backward.launches = 0          # kernel 1 (dstate, partials)
risi18_level_backward.reduce_launches = 0   # kernel 2 (dK, db; bf16: dstate)
# Of kernel 1's launches, those whose stream took the producer's tensor
# copies (the plan's ``stream`` "tma_producer", for the state's alignment).
risi18_level_backward.tma_launches = 0
# Of kernel 1's launches, those that added dT's staged rows by tensor
# reduces (the plan's ``scatter`` "tma_reduce").
risi18_level_backward.scatter_tma_launches = 0


class _Risi18LevelFn(torch.autograd.Function):
    """The level on CUDA: K1 forward, K2 backward."""

    @staticmethod
    def forward(ctx, state, nbr, pos, radj, K, b, negslope):
        out = _forward_kernel(state, nbr, pos, radj, K, b, negslope)
        ctx.save_for_backward(state, nbr, pos, radj, K, b, out)
        ctx.negslope = negslope
        return out

    @staticmethod
    def backward(ctx, g):
        state, nbr, pos, radj, K, b, out = ctx.saved_tensors
        dstate, dK, db = risi18_level_backward(
            state, nbr, pos, radj, K, b, out, g.contiguous(), ctx.negslope)
        return dstate, None, None, None, dK, db, None


def risi18_level(state, nbr, pos, radj, K, b, negslope=0.01):
    """Fused level: state [N,P,P,C], nbr [N,P], pos [N,P,P], radj [N,P,P],
    K [18C, Cout], b [Cout] -> [N, P*P, Cout], rows (p1 p2).

    CPU tensors run :func:`risi18_level_reference`, differentiated by torch
    autograd.  CUDA tensors run ``_Risi18LevelFn``: the forward launches K1
    and, when a gradient is taken, the backward launches K2, with or
    without grad enabled.  The kernels take state, K and b in float32 or
    bfloat16 (one type), float32 radj, int32 nbr/pos, all contiguous, and
    raise on anything else.
    """
    if state.device.type == "cpu":
        return risi18_level_reference(state, nbr, pos, radj, K, b, negslope)
    if state.device.type != "cuda":
        raise ValueError(f"no level kernel for device {state.device}")
    return _Risi18LevelFn.apply(state, nbr, pos, radj, K, b, float(negslope))


risi18_level.launches = 0
# Of K1's launches, those whose stream took the producer's tensor copies
# (the plan's ``stream`` "tma_producer").
risi18_level.tma_launches = 0
