"""Partitioned-graph execution: vertex sharding and the targeted halo
exchange (counterpart of ``graphflow_tpu/parallel/partition.py``).

The reference has no distributed backend; its "large graph" control is
capping receptive fields.  This module is the scale-out path for graphs too
large for one device: the padded vertex axis is sharded over the ranks of a
mesh axis ("graph"), and each message-passing level exchanges only the
boundary vertex states that some *specific* other shard references.

  * The plan (NumPy, :func:`plan_partition_batch`, the JAX package's own
    algorithm, whose arrays this module reproduces bit for bit) computes,
    per level, the per-PAIR export sets E_l[s][t] = rows shard s owns that
    shard t's receptive fields reference.  At level l each shard sends, for
    every ring shift d = 1..S-1, the buffer E_l[s][(s+d) % S] to shard
    (s+d) % S and receives shard (s-d) % S's: all of a level's shifts are
    one ``dist.batch_isend_irecv`` (``_HaloShift``).  A shard receives
    exactly its own imports (sum_d H_d rows) rather than every shard's
    export union (S*H rows with ``halo="all_gather"``, kept for
    comparison).  ``PartitionPlan.rows_targeted`` / ``rows_allgather``
    count both.

  * Owned vertices are ordered INTERIOR-FIRST (a vertex is interior when
    every neighbour it references at every level is owned by its shard).
    A level exchanges its halo, runs the interior block on local state,
    then the boundary block against ``cat([state, recv_1, ...])``.  The
    order leaves room to overlap the exchange with the interior block; the
    exchange here completes before the interior block starts.

  * Each block is the bank route of the level: the take-gather of the
    aligned slots T (``ops/risi_aligned.py:_gather_neighbor_tensors_take``,
    whose adjoint is an ``index_add_``), then the bank.  For contraction 18
    that is ``ops/risi_bank.py:risi18_bank``: K4 forward and K5 backward on
    CUDA tensors, the plain bank on CPU tensors, as everywhere in the port
    the route follows the tensors' device.  The 4-, 10- and 50-case
    contractions run the banks of ``ops/contractions.py``.

  * A data x graph mesh trains batches of partitioned graphs
    (:func:`make_partitioned_train_step`): per-shard partial losses and
    gradients, all-reduced over BOTH axes, one optimizer step.

Exactness: the head is computed from per-shard partial predictions
(``pred = sum over shards of <local_feat, W>``, ``_PartialSum``), so every
parameter is used only on shard-local paths.  The loss is then the same on
every rank of the graph axis, ``_PartialSum`` passes its cotangent through
unchanged (its backward is the identity), each rank's gradients are its
shard's part of the whole, and their sum over the graph axis is the exact
batch gradient.  An all-reduce in that backward would make every gradient
S times too large.

Transport.  On NCCL (a card per rank) every buffer stays on its card.
Gloo's point-to-point operations read host memory only, so over gloo a
CUDA send or receive buffer is staged through a pinned host tensor; its
collectives take CUDA tensors as they are.  The gather, K4 and K5 run on
the card either way.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from graphflow_tpu_torch.core.prep import PreparedGraph
from graphflow_tpu_torch.models.base import resolve_device
from graphflow_tpu_torch.models.smp2d import SMP2DConfig
from graphflow_tpu_torch.ops.activations import leaky_relu
from graphflow_tpu_torch.ops.contractions import (risi_contraction_4,
                                                  risi_contraction_10_matmul,
                                                  risi_contraction_50_matmul)
from graphflow_tpu_torch.ops.losses import log_loss, squared_loss
from graphflow_tpu_torch.ops.risi_aligned import \
    _gather_neighbor_tensors_take
from graphflow_tpu_torch.ops.risi_bank import risi18_bank
from graphflow_tpu_torch.parallel.data_parallel import all_reduce_sum
from graphflow_tpu_torch.parallel.mesh import Mesh, data_sharding
from graphflow_tpu_torch.utils.convert import unflatten


@dataclasses.dataclass
class PartitionPlan:
    """Host-computed static index arrays for a batch of vertex-sharded graphs.

    Shapes (B = batch, S = n_shards, Vs = V/S, L = levels, Pp = field pad):
      send_idx   list over shifts d=1..S-1 of [B, L, S, H_d] int32 — local
                 row ids shard s sends to shard (s+d) % S at level l (pad 0)
      send_mask  matching [B, L, S, H_d] float32 validity
      nbr_loc    [B, L, S, Vs, Pp] neighbor index into the extended buffer
                 [own block (Vs) ; recv_1 (H_1) ; ... ; recv_{S-1}]
      n_interior common interior-prefix length Vi: rows [0, Vi) of every
                 shard reference only local rows at every level
      exp_idx/exp_mask  [B, S, H] legacy union-export plan (all_gather mode)
      plus per-shard slices of pos/radj/smask/wl_feat/vmask (interior-first
      vertex order within each shard).
    """
    n_shards: int
    Vs: int
    H: int
    n_interior: int
    shift_sizes: tuple
    send_idx: List[np.ndarray]
    send_mask: List[np.ndarray]
    exp_idx: np.ndarray
    exp_mask: np.ndarray
    nbr_loc: np.ndarray
    nbr_ag: np.ndarray    # [B, L, S, Vs, Pp] remap for the all_gather layout
    pos: np.ndarray       # [B, L, S, Vs, Pp, Pp]
    radj: np.ndarray      # [B, L, S, Vs, Pp, Pp]
    smask: np.ndarray     # [B, L+1, S, Vs, Pp, Pp]
    wl_feat: np.ndarray   # [B, S, Vs, FD]
    vmask: np.ndarray     # [B, S, Vs]
    rows_targeted: int    # per-shard per-level received rows (ppermute)
    rows_allgather: int   # per-shard per-level received rows (all_gather)
    # Per-level comm accounting over the REAL (unpadded) export sets:
    # comm_per_level[l] = {"targeted_max", "targeted_mean", "allgather"}
    # rows received per shard at level l.
    comm_per_level: Optional[List[dict]] = None

    @property
    def batch(self) -> int:
        return self.wl_feat.shape[0]

    def comm_table(self, row_bytes: Optional[int] = None) -> str:
        """Human-readable per-level halo-exchange volume table.

        ``row_bytes``: bytes of one exchanged vertex-state row (e.g.
        (P+1)^2 * C * itemsize for the padded SMP2D state); when given,
        volumes are also printed in KiB.
        """
        lines = ["level  targeted_max  targeted_mean  allgather   (rows "
                 "received per shard per level)"]
        for l, row in enumerate(self.comm_per_level or []):
            extra = ""
            if row_bytes:
                extra = (f"   [{row['targeted_max'] * row_bytes / 1024:.0f}"
                         f" KiB vs {row['allgather'] * row_bytes / 1024:.0f}"
                         f" KiB]")
            lines.append(f"{l:5d}  {row['targeted_max']:12d}  "
                         f"{row['targeted_mean']:13.1f}  "
                         f"{row['allgather']:9d}{extra}")
        return "\n".join(lines)


def _pad_prepared(pg: PreparedGraph, Vpad: int) -> PreparedGraph:
    """Extend a PreparedGraph's vertex axis to ``Vpad`` with inert padding
    vertices (vmask 0, sizes 0, pos = sentinel, zero adjacency/masks) so a
    non-divisible V still partitions into equal shards."""
    V = pg.nbr.shape[1]
    if Vpad == V:
        return pg
    e = Vpad - V
    L, Pp = pg.nbr.shape[0], pg.nbr.shape[2]
    return dataclasses.replace(
        pg,
        wl_feat=np.concatenate(
            [pg.wl_feat, np.zeros((e,) + pg.wl_feat.shape[1:],
                                  pg.wl_feat.dtype)], axis=0),
        vmask=np.concatenate([pg.vmask, np.zeros(e, pg.vmask.dtype)]),
        sizes=np.concatenate(
            [pg.sizes, np.zeros((L + 1, e), pg.sizes.dtype)], axis=1),
        nbr=np.concatenate(
            [pg.nbr, np.zeros((L, e, Pp), pg.nbr.dtype)], axis=1),
        pos=np.concatenate(
            [pg.pos, np.full((L, e, Pp, Pp), Pp, pg.pos.dtype)], axis=1),
        radj=np.concatenate(
            [pg.radj, np.zeros((L, e, Pp, Pp), pg.radj.dtype)], axis=1),
        smask=np.concatenate(
            [pg.smask, np.zeros((L + 1, e, Pp, Pp), pg.smask.dtype)],
            axis=1),
    )


def plan_partition_batch(pgs: Sequence[PreparedGraph],
                         n_shards: int) -> PartitionPlan:
    """Plan contiguous-block vertex partitions for a batch of prepared
    graphs with common static shapes (shift sizes and the interior prefix
    are maxed/minned over the batch).  A vertex count not divisible by
    ``n_shards`` is padded up with inert vertices (the last shard carries
    the padding; masks keep them exact zeros)."""
    L, V, Pp = pgs[0].nbr.shape[0], pgs[0].nbr.shape[1], pgs[0].nbr.shape[2]
    Vpad = -(-V // n_shards) * n_shards
    if Vpad != V:
        pgs = [_pad_prepared(pg, Vpad) for pg in pgs]
        V = Vpad
    S, Vs, B = n_shards, V // n_shards, len(pgs)
    owner = np.arange(V) // Vs

    # ---- pass 1: per-graph export sets, interior flags, local orders ----
    per_graph = []
    for pg in pgs:
        assert pg.nbr.shape == (L, V, Pp)
        # E[l][s][t]: rows owned by s that t references at level l.
        E = [[[[] for _ in range(S)] for _ in range(S)] for _ in range(L)]
        Eset = [[[set() for _ in range(S)] for _ in range(S)]
                for _ in range(L)]
        interior = np.ones(V, bool)
        for l in range(L):
            for v in range(V):
                t = owner[v]
                for i in range(int(pg.sizes[l + 1, v])):
                    w = int(pg.nbr[l, v, i])
                    s = owner[w]
                    if s != t:
                        interior[v] = False
                        if w not in Eset[l][s][t]:
                            Eset[l][s][t].add(w)
                            E[l][s][t].append(w)
        for l in range(L):
            for s in range(S):
                for t in range(S):
                    E[l][s][t].sort()
        # interior-first vertex order within each shard
        loc = np.zeros(V, np.int64)
        n_int = np.zeros(S, np.int64)
        for s in range(S):
            block = np.arange(s * Vs, (s + 1) * Vs)
            ordered = ([v for v in block if interior[v]]
                       + [v for v in block if not interior[v]])
            n_int[s] = int(interior[block].sum())
            for j, v in enumerate(ordered):
                loc[v] = j
        per_graph.append((E, loc, n_int))

    # ---- common static shapes ----
    shift_sizes = []
    for d in range(1, S):
        Hd = 0
        for (E, _, _) in per_graph:
            for l in range(L):
                for s in range(S):
                    Hd = max(Hd, len(E[l][s][(s + d) % S]))
        shift_sizes.append(Hd)
    shift_sizes = tuple(shift_sizes)
    Vi = min(int(ni.min()) for (_, _, ni) in per_graph)
    # legacy union exports (all_gather mode + accounting)
    H = 1
    for (E, _, _) in per_graph:
        for s in range(S):
            union = set()
            for l in range(L):
                for t in range(S):
                    union |= set(E[l][s][t])
            H = max(H, len(union))

    # recv-buffer offset of each shift-d block: sum of earlier shift sizes
    off = [0] * S
    acc = 0
    for d in range(1, S):
        off[d] = acc
        acc += shift_sizes[d - 1]

    send_idx = [np.zeros((B, L, S, max(Hd, 1)), np.int32)
                for Hd in shift_sizes]
    send_mask = [np.zeros((B, L, S, max(Hd, 1)), np.float32)
                 for Hd in shift_sizes]
    exp_idx = np.zeros((B, S, H), np.int32)
    exp_mask = np.zeros((B, S, H), np.float32)
    nbr_loc = np.zeros((B, L, S, Vs, Pp), np.int32)
    nbr_ag = np.zeros((B, L, S, Vs, Pp), np.int32)
    pos = np.zeros((B, L, S, Vs, Pp, Pp), pgs[0].pos.dtype)
    radj = np.zeros((B, L, S, Vs, Pp, Pp), pgs[0].radj.dtype)
    smask = np.zeros((B, L + 1, S, Vs, Pp, Pp), pgs[0].smask.dtype)
    wl_feat = np.zeros((B, S, Vs) + pgs[0].wl_feat.shape[1:],
                       pgs[0].wl_feat.dtype)
    vmask = np.zeros((B, S, Vs), pgs[0].vmask.dtype)

    for b, (pg, (E, loc, _)) in enumerate(zip(pgs, per_graph)):
        # per-(level, pair) slot of each import in the shift-d recv block
        slot = [dict() for _ in range(L)]  # (dst_shard, w) -> ext index
        for l in range(L):
            for s in range(S):
                for d in range(1, S):
                    t = (s + d) % S
                    for j, w in enumerate(E[l][s][t]):
                        send_idx[d - 1][b, l, s, j] = loc[w]
                        send_mask[d - 1][b, l, s, j] = 1.0
                        # receiver t sees shift-d rows at off[d] + j
                        slot[l][(t, w)] = Vs + off[d] + j
        # legacy union export layout
        agslot = {}
        for s in range(S):
            union = set()
            for l in range(L):
                for t in range(S):
                    union |= set(E[l][s][t])
            for j, w in enumerate(sorted(union)):
                exp_idx[b, s, j] = loc[w]
                exp_mask[b, s, j] = 1.0
                agslot[w] = s * H + j
        # remapped neighbor ids + reordered per-vertex arrays
        for l in range(L):
            for v in range(V):
                s, lv = owner[v], loc[v]
                for i in range(Pp):
                    w = int(pg.nbr[l, v, i])
                    if i >= pg.sizes[l + 1, v]:
                        nbr_loc[b, l, s, lv, i] = 0  # pos sentinel masks it
                        nbr_ag[b, l, s, lv, i] = 0
                    elif owner[w] == s:
                        nbr_loc[b, l, s, lv, i] = loc[w]
                        nbr_ag[b, l, s, lv, i] = loc[w]
                    else:
                        nbr_loc[b, l, s, lv, i] = slot[l][(s, w)]
                        nbr_ag[b, l, s, lv, i] = Vs + agslot[w]
        for v in range(V):
            s, lv = owner[v], loc[v]
            pos[b, :, s, lv] = pg.pos[:, v]
            radj[b, :, s, lv] = pg.radj[:, v]
            smask[b, :, s, lv] = pg.smask[:, v]
            wl_feat[b, s, lv] = pg.wl_feat[v]
            vmask[b, s, lv] = pg.vmask[v]

    # Per-level exchanged-row accounting over the real export sets: rows
    # RECEIVED by shard t at level l = sum_s |E[l][s][t]|.
    comm_per_level = []
    for l in range(L):
        recv = [sum(len(E[l][s][t]) for s in range(S) if s != t)
                for (E, _, _) in per_graph for t in range(S)]
        comm_per_level.append({
            "targeted_max": int(max(recv)),
            "targeted_mean": float(np.mean(recv)),
            "allgather": int(S * H),
        })

    return PartitionPlan(
        n_shards=S, Vs=Vs, H=H, n_interior=Vi, shift_sizes=shift_sizes,
        send_idx=send_idx, send_mask=send_mask,
        exp_idx=exp_idx, exp_mask=exp_mask,
        nbr_loc=nbr_loc, nbr_ag=nbr_ag, pos=pos, radj=radj, smask=smask,
        wl_feat=wl_feat, vmask=vmask,
        rows_targeted=int(sum(shift_sizes)),
        rows_allgather=int(S * H),
        comm_per_level=comm_per_level,
    )


def plan_partition(pg: PreparedGraph, n_shards: int) -> PartitionPlan:
    """Single-graph convenience wrapper (batch of one)."""
    return plan_partition_batch([pg], n_shards)



# -- the shards' inputs ------------------------------------------------------

# Plan field -> its shard axis ([B, S, ...] or [B, L(+1), S, ...]).
_SHARD_AXIS = {"wl_feat": 1, "vmask": 1, "exp_idx": 1, "exp_mask": 1,
               "nbr_loc": 2, "nbr_ag": 2, "pos": 2, "radj": 2, "smask": 2}


def shard_inputs(plan: PartitionPlan, mesh: Mesh, device=None,
                 data_axis: Optional[str] = "data",
                 graph_axis: str = "graph") -> dict:
    """This rank's shard of the plan's arrays as tensors on ``device``
    (the card unless the caller names another): the shard axis taken at
    this rank's place on ``graph_axis``, the batch axis cut to its share on
    ``data_axis`` where the mesh has that axis, and whole otherwise.  The
    counterpart of the JAX package's ``shard_inputs`` with the slicing of
    its ``_input_specs``."""
    device = resolve_device(device)
    s = mesh.index(graph_axis)
    share = (data_sharding(mesh, plan.batch, data_axis)
             if data_axis in mesh.axis_names else slice(None))

    def put(a, axis):
        return torch.from_numpy(np.ascontiguousarray(
            np.take(a[share], s, axis=axis))).to(device)

    out = {k: put(getattr(plan, k), axis) for k, axis in _SHARD_AXIS.items()}
    out["send_idx"] = [put(x, 2) for x in plan.send_idx]
    out["send_mask"] = [put(x, 2) for x in plan.send_mask]
    return out


# -- the transport -----------------------------------------------------------

class _Ring:
    """The graph axis as the halo exchange sees it: this rank's place s
    among the axis's S ranks, their global ranks, and its process group
    (None for a single shard)."""

    def __init__(self, mesh: Mesh, axis: str):
        self.group = mesh.group(axis)
        self.ranks = mesh.slice_ranks(axis)
        self.s, self.S = mesh.index(axis), len(self.ranks)
        self.gloo = (self.group is not None
                     and dist.get_backend(self.group) == "gloo")

    def shift(self, bufs, shifts, back=False):
        """For each ring shift d of ``shifts``, send that shift's buffer to
        shard (s+d) % S and receive one of the same shape from (s-d) % S
        (the other way round with ``back``), all posted as one batch in
        the same order on every rank.  Returns the received buffers."""
        ops, recvs = [], []
        for d, buf in zip(shifts, bufs):
            to, frm = (self.s + d) % self.S, (self.s - d) % self.S
            if back:
                to, frm = frm, to
            send, recv = buf.contiguous(), torch.empty_like(buf)
            if self.gloo and buf.is_cuda:
                send = _pinned(buf.shape, buf.dtype).copy_(send)
                recv = _pinned(buf.shape, buf.dtype)
            ops += [dist.P2POp(dist.isend, send, self.ranks[to], self.group),
                    dist.P2POp(dist.irecv, recv, self.ranks[frm],
                               self.group)]
            recvs.append(recv)
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return [r.to(b.device) for r, b in zip(recvs, bufs)]

    def all_gather(self, x):
        """[B, n, ...] from every shard, concatenated in shard order on
        axis 1."""
        if self.group is None:
            return x
        parts = [torch.empty_like(x) for _ in range(self.S)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts, dim=1)

    def sum(self, x):
        """The sum of x over the shards, as a new tensor."""
        y = x.contiguous().clone()
        all_reduce_sum([y], self.group)
        return y


def _pinned(shape, dtype):
    return torch.empty(shape, dtype=dtype, pin_memory=True)


class _HaloShift(torch.autograd.Function):
    """The targeted halo exchange of one level: ``apply(ring, shifts,
    *bufs)`` -> the buffers received, one per shift.  The backward runs
    the inverse shifts: the gradient of each received buffer goes back to
    its sender, where the adjoint of the row selection that built the
    buffer adds it into the rows sent."""

    @staticmethod
    def forward(ctx, ring, shifts, *bufs):
        ctx.ring, ctx.shifts = ring, shifts
        return tuple(ring.shift(bufs, shifts))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.ring.shift(grads, ctx.shifts, back=True))


class _AllGatherHalo(torch.autograd.Function):
    """Every shard's export rows, concatenated; the backward is this
    shard's slice of the gradient summed over the shards."""

    @staticmethod
    def forward(ctx, ring, rows):
        ctx.ring, ctx.n = ring, rows.shape[1]
        return ring.all_gather(rows)

    @staticmethod
    def backward(ctx, g):
        s, n = ctx.ring.s, ctx.n
        return None, ctx.ring.sum(g)[:, s * n:(s + 1) * n]


class _PartialSum(torch.autograd.Function):
    """The sum of a per-shard partial over the graph axis.  The backward is
    the identity: the loss is replicated over the graph axis and the
    parameters' gradients are summed over it afterwards (module
    docstring)."""

    @staticmethod
    def forward(ctx, ring, x):
        return ring.sum(x)

    @staticmethod
    def backward(ctx, g):
        return None, g


# -- the per-shard forward ---------------------------------------------------

def _rows(state, idx, mask):
    """state [B, Vs, P, P, C] rows idx [B, n], each times mask [B, n]."""
    B, Vs = state.shape[:2]
    at = idx.long() + torch.arange(B, device=idx.device)[:, None] * Vs
    rows = state.reshape(B * Vs, *state.shape[2:]).index_select(
        0, at.reshape(-1))
    return (rows.reshape(B, idx.shape[1], *state.shape[2:])
            * mask.to(state.dtype)[:, :, None, None, None])


def _bank(cfg: SMP2DConfig, T, radj, K, b):
    """The contraction bank, the product with K, the bias and LeakyReLU of
    n vertex neighbourhoods: T [n, P, P, P, C] -> [n, P, P, Cout]."""
    n, P, C, Cout = T.shape[0], T.shape[1], T.shape[-1], K.shape[1]
    if cfg.contraction == 18:
        A = radj.float() if radj.dtype == torch.bfloat16 else radj
        Z = risi18_bank(T, A.contiguous(), K)
    elif cfg.contraction == 4:
        Z = risi_contraction_4(T).reshape(n, P, P, 4 * C) @ K
    else:
        bank = (risi_contraction_50_matmul if cfg.contraction == 50
                else risi_contraction_10_matmul)
        Z = bank(T, radj, K)
    return leaky_relu(Z.reshape(n, P * P, Cout) + b).reshape(n, P, P, Cout)


def _level_block(cfg: SMP2DConfig, src, nbr, pos, radj, K, b):
    """One level for n vertices of each graph whose slots index ``src``
    [B, rows, P, P, C] (the local state, or it with the halo appended):
    nbr [B, n, P], pos and radj [B, n, P, P] -> [B, n, P, P, Cout].  An
    empty block (n = 0) launches nothing."""
    B, rows, P, _, C = src.shape
    n = nbr.shape[1]
    if n == 0:
        return src.new_zeros((B, 0, P, P, K.shape[1]))
    src_pad = torch.nn.functional.pad(src.reshape(B * rows, P, P, C),
                                      (0, 0, 0, 1, 0, 1))
    at = nbr.long() + torch.arange(B, device=nbr.device)[:, None, None] * rows
    T = _gather_neighbor_tensors_take(src_pad, at.reshape(B * n, P),
                                      pos.reshape(B * n, P, P))
    out = _bank(cfg, T, radj.reshape(B * n, P, P), K, b)
    return out.reshape(B, n, P, P, K.shape[1])


def _per_shard(cfg: SMP2DConfig, plan: PartitionPlan, ring: _Ring, halo: str,
               params, inputs):
    """The vertex-sharded SMP2D forward of this rank's shard ->
    (pred_local [B] or [B, nClasses], local_feat [B, C]): the head's
    per-shard partials, whose sums over the graph axis are the prediction
    and the graph feature."""
    Vs, P = plan.Vs, cfg.P
    dt = params["H"].dtype
    wl_feat, vmask = inputs["wl_feat"].to(dt), inputs["vmask"].to(dt)
    B = wl_feat.shape[0]

    F0 = leaky_relu(wl_feat @ params["H"].T)                 # [B, Vs, C]
    state = F0.new_zeros((B, Vs, P, P, F0.shape[-1]))
    state[:, :, 0, 0, :] = F0 * vmask[..., None]

    for l in range(cfg.nLevels):
        K, b = params["levels"][l]["K"], params["levels"][l]["b"]
        if halo == "targeted":
            # 1. the per-pair halo exchange, one batch of all the shifts
            shifts = tuple(k + 1 for k, Hd in enumerate(plan.shift_sizes)
                           if Hd > 0)
            bufs = [_rows(state, inputs["send_idx"][d - 1][:, l],
                          inputs["send_mask"][d - 1][:, l]) for d in shifts]
            recvs = list(_HaloShift.apply(ring, shifts, *bufs)
                         if shifts else [])
            nbr, lo = inputs["nbr_loc"][:, l], plan.n_interior
        else:
            recvs = [_AllGatherHalo.apply(ring, _rows(
                state, inputs["exp_idx"], inputs["exp_mask"]))]
            nbr, lo = inputs["nbr_ag"][:, l], 0
        pos, radj = inputs["pos"][:, l], inputs["radj"][:, l]
        # 2. the interior block on local state, 3. the boundary block
        # against the halo-extended buffer.
        ext = torch.cat([state] + recvs, dim=1)
        state = torch.cat([
            _level_block(cfg, state, nbr[:, :lo], pos[:, :lo],
                         radj[:, :lo], K, b),
            _level_block(cfg, ext, nbr[:, lo:], pos[:, lo:], radj[:, lo:],
                         K, b)], dim=1)
        state = state * inputs["smask"][:, l + 1].to(dt)[..., None]

    vertex = leaky_relu(state.sum(dim=(2, 3)))                # [B, Vs, C]
    local_feat = (vertex * vmask[..., None]).sum(dim=1)       # [B, C]
    # The head is linear in the graph feature, so the partials sum to the
    # whole; the softmax of the log loss comes after the sum.
    if cfg.nClasses:
        return local_feat @ params["W"].T, local_feat
    return local_feat @ params["W"], local_feat


def _check_built(plan: PartitionPlan, ring: _Ring, halo: str):
    if halo not in ("targeted", "all_gather"):
        raise ValueError(f"halo {halo!r}: 'targeted' or 'all_gather'")
    if ring.S != plan.n_shards:
        raise ValueError(f"a plan of {plan.n_shards} shards on a graph axis "
                         f"of {ring.S} ranks")


def _check_device(inputs, device: torch.device):
    if inputs["wl_feat"].device.type != device.type:
        raise ValueError(f"the shard's inputs lie on "
                         f"{inputs['wl_feat'].device}, the step was built "
                         f"for {device}")


def make_partitioned_forward(cfg: SMP2DConfig, plan: PartitionPlan,
                             mesh: Mesh, axis: str = "graph",
                             halo: str = "targeted", device=None):
    """A vertex-sharded SMP2D forward over the ranks of ``mesh``'s
    ``axis``, on ``device`` (the card unless the caller names another).

    ``halo``: "targeted" (the per-pair exchange) or "all_gather" (every
    shard's export union to every shard).  Returns ``fn(params, inputs) ->
    (prediction, graph_feature)`` for the parameter tree ``params`` and this
    rank's :func:`shard_inputs`, the same on every rank of the axis:
    [B] and [B, C] (class scores [B, nClasses]), or one graph's for a plan
    of one graph."""
    device = resolve_device(device)
    ring = _Ring(mesh, axis)
    _check_built(plan, ring, halo)

    def forward(params, inputs):
        _check_device(inputs, device)
        pred_local, local_feat = _per_shard(cfg, plan, ring, halo, params,
                                            inputs)
        pred = _PartialSum.apply(ring, pred_local)
        feat = _PartialSum.apply(ring, local_feat)
        if plan.batch == 1:
            return pred[0], feat[0]
        return pred, feat

    return forward


def make_partitioned_train_step(cfg: SMP2DConfig, plan: PartitionPlan, opt,
                                mesh: Mesh, data_axis: Optional[str] = "data",
                                graph_axis: str = "graph",
                                halo: str = "targeted", device=None):
    """A train step on a data x graph mesh, on ``device`` (the card unless
    the caller names another): each graph of the batch is vertex-sharded
    over ``graph_axis``, the batch over ``data_axis`` (None: not sharded);
    the per-shard partial gradients are all-reduced over both axes and one
    optimizer step is applied on every rank (the reference's data-parallel
    semantics, ``SMP_omega.h:750-792``).

    Returns ``step(params, opt_state, inputs, targets, lr) -> (params,
    opt_state, total_loss)`` for {path: leaf tensor that requires grad},
    this rank's :func:`shard_inputs` and the whole batch's ``targets``
    (this rank takes its share).  Regression targets are floats (the
    squared loss); with ``cfg.nClasses`` set they are integer labels (the
    log loss over the summed class scores).  nBatch is ``plan.batch``."""
    device = resolve_device(device)
    ring = _Ring(mesh, graph_axis)
    _check_built(plan, ring, halo)
    axes = (data_axis, graph_axis) if data_axis else (graph_axis,)
    grad_group = mesh.group(axes)
    loss_group = mesh.group(data_axis) if data_axis else None
    share = (data_sharding(mesh, plan.batch, data_axis) if data_axis
             else slice(None))

    def step(params, opt_state, inputs, targets, lr):
        _check_device(inputs, device)
        pred_local, _ = _per_shard(cfg, plan, ring, halo, unflatten(params),
                                   inputs)
        pred = _PartialSum.apply(ring, pred_local)
        t = torch.as_tensor(targets)[share].to(pred.device)
        loss = (log_loss(pred, t) if cfg.nClasses
                else squared_loss(pred, t.to(pred.dtype)))
        grads = torch.autograd.grad(loss, list(params.values()))
        # The loss is the same on every rank of the graph axis; the
        # gradients are per-shard partials.
        loss = loss.detach().clone()
        all_reduce_sum([loss], loss_group)
        all_reduce_sum(grads, grad_group)
        params, opt_state = opt.update(params, opt_state,
                                       dict(zip(params, grads)), lr,
                                       nBatch=plan.batch)
        return params, opt_state, loss

    return step
