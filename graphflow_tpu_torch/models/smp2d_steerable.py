"""The steerable second-order SMP family (counterpart of
``graphflow_tpu/models/smp2d_steerable.py``): a vertex's state is a
|phi| x |phi| x C tensor, and the receptive fields are uncapped (P = V).

  SMP_2D               (``SMP_2D.h:523-580``) W[s] = l1[s] I + l2[s] 1
                       with C-vector lambdas per receptive-field size,
                       constant channels, Momentum
  SMP_2D_ver2, ver3    (``SMP_2D_ver2.h:131-177``) matrix lambdas (prevC x
                       prevC), the two filter paths concatenated (channels
                       double); ver3 without the scalar (.) adjacency term
  SMP_2D_ver4, ver5    vector lambdas, the paths concatenated (ver4,
                       channels double) or reduced by K (C x 2C) (ver5)
  Unrestricted_SMP_2D  a full learned W[s] (s x s x C) applied by TensorMul;
                       ver2 a 4-D W[s] (s x s x prevC x C), channels double
  *_classification     the log-loss head

Math per level:
  q_v  = SUM_{w : sp(v,w) <= 1} X f_w X^T  (+ scalar (.) radj_v)
  out  = LeakyReLU(filter(q_v) + b[s])
  head: vertex = LeakyReLU(sum over both positions); graph = SUM_v vertex;
        <graph, W>, or class scores W @ graph

Where the JAX package vmaps one graph, the port runs the batch [B, V, P, P,
C] at once.  The 1-hop quadratic sum scatters each neighbour's tensor into
vertex-id space by index, takes one batched product with the closed
adjacency and gathers back into each receptive field's order
(:class:`_QuadraticSum`, a linear map whose backward is the same map run
the other way, so nothing of its O(B V^3 C) intermediates is stored; the
JAX package does it with one-hot products under ``jax.checkpoint``).  The
as-executed TENSORMUL-cast filters of ver2, ver3 and Unrestricted_ver2
compute their read indices on the device from each vertex's size
(:func:`tensormul_cast_indices`).  No TPU kernel runs on this path in the
JAX package, and none runs here: every step is a torch op.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.core.graph import DenseGraph
from graphflow_tpu_torch.models.base import GraphModel, resolve_device
from graphflow_tpu_torch.ops.activations import (leaky_relu,
                                                 persize_gather_refgrad)
from graphflow_tpu_torch.ops.losses import log_loss, squared_loss
from graphflow_tpu_torch.optim.utils import uniform_init

_FILTERS = ("steerable", "matrix", "concat", "concat_k", "unrestricted",
            "unrestricted4d")
# lambda -> W_eye [-> W]: the shared-node chain's depth (SMP_2D.h:556-570
# and SMP_2D_ver2.h:577-585 two, ver4/ver5 one).
_LAMBDA_DEPTH = {"steerable": 2, "matrix": 2, "concat": 1, "concat_k": 1}


@dataclasses.dataclass
class SMP2DSteerableConfig:
    max_nVertices: int
    nLevels: int
    nChanels: int
    nFeatures: int
    nDepth: int
    # "steerable"      l1 (.) q + l2 (.) 1 q, constant channels (SMP_2D.h)
    # "matrix"         matrix lambdas, the two paths concatenated, channels
    #                  double (SMP_2D_ver2.h / ver3.h)
    # "concat"         vector lambdas over prevC, concatenated, channels
    #                  double, no reducer (SMP_2D_ver4.h:130-180)
    # "concat_k"       vector lambdas, concatenated, K (C x 2C) reducer
    #                  (SMP_2D_ver5.h:127-171)
    # "unrestricted"   a full W[s] (s x s x C) (Unrestricted_SMP_2D.h)
    # "unrestricted4d" a full W[s] (s x s x prevC x C), channels double
    #                  (Unrestricted_SMP_2D_ver2.h:102-137)
    filter: str = "steerable"
    has_WL_ordering: bool = True
    # ver3 drops the scalar (.) reduced-adjacency term (SMP_2D_ver3.h:551).
    add_scalar_adj: bool = True
    # The reduced adjacency's diagonal: prep forces it to 1 (ver4, ver5);
    # False restores the raw adjacency's own diagonal (SMP_2D.h:458-469:
    # SMP_2D, its classification head, ver2, Unrestricted and its ver2).
    radj_self_loops: bool = True
    # ver4 and ver5 divide each row of the reduced adjacency by its sum
    # (SMP_2D_ver4.h:481-502).
    radj_row_normalize: bool = False
    # ver2, ver3 and Unrestricted_ver2 register their 4-D filter apply
    # under the TENSORMUL opcode, and the reference dispatcher runs
    # TensorMul::forward on it (GraphFlow.h:615-620), reading the 4-D
    # filter's buffer through 3-D strides:
    #   out[i,j,d] = SUM_k Wflat[(i*s+k)*prevC + d] * qflat[(k*s+j)*prevC + d]
    # with reads past the view counting as zero.  True reproduces what the
    # reference binaries compute; False the declared Tensor4DTensor3DMul.
    engine_faithful: bool = True
    # The reference's shared-node lambda gradients (True) or the true ones
    # (``ops/activations.py:persize_gather_refgrad``).
    faithful_lambda_grads: bool = True
    nClasses: Optional[int] = None
    optimizer: str = "momentum"
    momentum_param: float = 0.9
    dtype: str = "float32"

    def __post_init__(self):
        if self.filter not in _FILTERS:
            raise ValueError(f"filter {self.filter!r}: one of {_FILTERS}")
        if self.dtype not in ("float32", "float64", "bfloat16"):
            raise NotImplementedError(
                f"dtype {self.dtype} is not ported; the port takes "
                f"float32, float64 and bfloat16")

    @property
    def feat_dim(self) -> int:
        return self.nFeatures * (self.nDepth + 1)

    @property
    def P(self) -> int:
        return self.max_nVertices          # these models are uncapped

    def channels_at(self, l: int) -> int:
        """The level-l state's channels: doubling per level for ver2, ver3,
        ver4 and Unrestricted_ver2 (SMP_2D_ver2.h:131, SMP_2D_ver4.h:130),
        else nChanels."""
        if self.filter in ("matrix", "concat", "unrestricted4d"):
            return self.nChanels * (2 ** l)
        return self.nChanels

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def host_dtype(self) -> np.dtype:
        """float32 for a bfloat16 model (``stack_graphs`` casts on the
        device), else the model's dtype."""
        return np.dtype("float32" if self.dtype == "bfloat16"
                        else self.dtype)

    def level_keys(self):
        """One level's parameters in the JAX package's order: it gives the
        model no registration order, so its text checkpoint follows
        ``jax.tree_util.tree_flatten``, dict keys sorted."""
        keys = ["b"]
        if self.add_scalar_adj:
            keys.append("scalar")
        if self.filter.startswith("unrestricted"):
            keys.append("Wf")
        else:
            keys += ["lambda1", "lambda2"]
        if self.filter == "concat_k":
            keys.append("K")
        return tuple(sorted(keys))


def init_steerable_params(generator: torch.Generator,
                          cfg: SMP2DSteerableConfig, device=None):
    """Fresh parameters as the JAX tree {"H", "levels": [...], "W"} at the
    JAX package's scales (``graphflow_tpu/models/smp2d_steerable.py:
    127-174``): per-size arrays have max_nVertices + 1 rows; lambdas and
    scalars scale by their channel count, the full filters by P.  Weights
    shared with the JAX package come through ``utils/convert.py``."""
    dt, V1, P = cfg.torch_dtype, cfg.max_nVertices + 1, cfg.P

    def draw(shape, fan=None):
        return uniform_init(shape, generator, dt, device, fan=fan)

    H = draw((cfg.nChanels, cfg.feat_dim))
    levels = []
    for l in range(1, cfg.nLevels + 1):
        Cp, C = cfg.channels_at(l - 1), cfg.channels_at(l)
        lev = {}
        if cfg.add_scalar_adj:
            lev["scalar"] = draw((Cp,), Cp)
        if cfg.filter == "unrestricted":
            lev["Wf"] = draw((V1, P, P, C), P)
        elif cfg.filter == "unrestricted4d":
            lev["Wf"] = draw((V1, P, P, Cp, C), P)
        else:
            width = (Cp, Cp) if cfg.filter == "matrix" else (
                (Cp,) if cfg.filter == "concat" else (C,))
            lev["lambda1"] = draw((V1,) + width, width[0])
            lev["lambda2"] = draw((V1,) + width, width[0])
        if cfg.filter == "concat_k":
            lev["K"] = draw((C, 2 * C))
        lev["b"] = draw((V1, C), C)
        levels.append(lev)
    CL = cfg.channels_at(cfg.nLevels)
    W = draw((cfg.nClasses, CL) if cfg.nClasses else (CL,))
    return {"H": H, "levels": levels, "W": W}


def _pair_index(vid: torch.Tensor, V: int) -> torch.Tensor:
    """[B, V, P] vertex ids (sentinel V) -> [B, V, P*P] flat id-space
    positions vid[p] * V + vid[q], or V*V where either is the sentinel."""
    a, b = vid[..., :, None], vid[..., None, :]
    flat = torch.where((a < V) & (b < V), a * V + b, V * V)
    return flat.reshape(*vid.shape[:-1], -1)


def _quadratic_sum_apply(x, vid_in, adj, vid_out):
    """out[b, v, p, q] = SUM_w adj[b, v, w] x[b, w, p', q'] where
    phi_in(w)[p'] = phi_out(v)[p] and phi_in(w)[q'] = phi_out(v)[q]: the
    1-hop quadratic sum X f_w X^T, for x [B, V, P, P, C].

    x is scattered by index into vertex-id space G [B, w, V*V, C] (a
    receptive field holds each vertex once; pairs with a sentinel land in
    the extra row V*V, which is dropped), reduced over w in one batched
    product with adj, and gathered back in phi_out's order (zero where
    either position is the sentinel)."""
    B, V, P, _, C = x.shape
    fin = _pair_index(vid_in, V)[..., None].expand(B, V, P * P, C)
    G = x.new_zeros((B, V, V * V + 1, C))
    G.scatter_(2, fin, x.reshape(B, V, P * P, C))
    M = torch.bmm(adj, G[:, :, :V * V].reshape(B, V, V * V * C))
    fout = _pair_index(vid_out, V)
    keep = (fout < V * V).to(x.dtype)[..., None]
    idx = torch.where(fout < V * V, fout, 0)[..., None].expand(B, V, P * P, C)
    out = torch.gather(M.reshape(B, V, V * V, C), 2, idx) * keep
    return out.reshape(B, V, P, P, C)


class _QuadraticSum(torch.autograd.Function):
    """The 1-hop quadratic sum as a linear map of the state.  Its adjoint
    is the same map from phi_out to phi_in with adj transposed (a scatter
    by unique indices is the adjoint of the gather), so the backward stores
    only the index arrays and adj, as the JAX package's ``jax.checkpoint``
    does (``graphflow_tpu/models/smp2d_steerable.py:365-368``)."""

    @staticmethod
    def forward(ctx, x, vid_in, adj, vid_out):
        ctx.save_for_backward(vid_in, adj, vid_out)
        return _quadratic_sum_apply(x, vid_in, adj, vid_out)

    @staticmethod
    def backward(ctx, g):
        vid_in, adj, vid_out = ctx.saved_tensors
        return (_quadratic_sum_apply(g.contiguous(), vid_out,
                                     adj.transpose(1, 2), vid_in),
                None, None, None)


def quadratic_sum(state, vid_prev, adj1, vid_cur):
    """SUM_{w in the closed 1-hop of v} X f_w X^T for every vertex of a
    batch (``graphflow_tpu/models/smp2d_steerable.py:185-225``): state
    [B, V, P, P, C], vid_prev [B, V, P] and vid_cur [B, V, P] the vertex
    ids of phi_{l-1}(w) and phi_l(v) (sentinel V), adj1 [B, V, V]."""
    return _QuadraticSum.apply(state, vid_prev.long(), adj1, vid_cur.long())


def tensormul_cast_indices(s: torch.Tensor, P: int, prevC: int):
    """The read indices of the TENSORMUL cast
    (``SMP2DSteerableConfig.engine_faithful``) for sizes ``s`` [...],
    each [..., P, P, 2], with the integer arithmetic of
    ``graphflow_tpu/models/smp2d_steerable.py:_tensormul_cast_tables``.

    Output channel d = delta * prevC + c (delta in {0, 1}, c < prevC) of
    position (i, j) reads, for each k, the filter at flat m = e * prevC + c
    and q at flat e * prevC + c, where e = i*s + k + delta (q's axes here
    are (k, j)).  Decoding m in the filter's compact (s, s, prevC, 2 prevC)
    layout gives a = e // 2 = (x*s + y)*prevC + cw and dw = (e % 2) * prevC
    + c, so every index but c depends on (i, k, delta) alone and the D axis
    of the JAX package's tables factors out.  Returned: ``x``, ``y``
    (clipped to P - 1), ``cw``, ``iseye`` (dw < prevC), ``diag`` (x == y
    where iseye, else True), ``a_ok`` (i < s, k < s, x < s), ``q_row``,
    ``q_col`` (clipped) and ``q_ok`` (k < s, j < s, e < s*s)."""
    s = s.long()[..., None, None, None]
    ss = torch.clamp(s, min=1)
    ar = torch.arange(P, device=s.device)
    i, k = ar[:, None, None], ar[None, :, None]
    delta = torch.arange(2, device=s.device)[None, None, :]
    e = i * ss + k + delta
    a = e // 2
    iseye = e % 2 == 0
    xy = a // prevC
    x, y = xy // ss, xy % ss
    inside = (i < s) & (k < s)
    return {"x": torch.clamp(x, max=P - 1), "y": torch.clamp(y, max=P - 1),
            "cw": a % prevC, "iseye": iseye, "diag": ~iseye | (x == y),
            "a_ok": inside & (x < s),
            "q_row": torch.clamp(e // ss, max=P - 1),
            "q_col": torch.clamp(e % ss, max=P - 1),
            "q_ok": inside & (e < s * s)}


def _cast_read_q(q, ix):
    """Qx[b, v, k, j, delta, c] = q[b, v, q_row, q_col, c] * q_ok."""
    B, V, P, _, Cp = q.shape
    bv = torch.arange(B * V, device=q.device).reshape(B, V, 1, 1, 1)
    rows = (bv * P + ix["q_row"]) * P + ix["q_col"]
    Qx = q.reshape(-1, Cp)[rows.reshape(-1)].reshape(B, V, P, P, 2, Cp)
    return Qx * ix["q_ok"].to(q.dtype)[..., None]


def _cast_apply(A, Qx):
    """out[b, v, i, j, d] = SUM_k A[b, v, i, k, d] Qx[b, v, k, j, d], with
    d as (delta, c)."""
    out = torch.einsum("bvikec,bvkjec->bvijec", A, Qx)
    return out.reshape(*out.shape[:4], -1)


def _cast_matrix_filter(q, L1, L2, s):
    """The ver2/ver3 filter as the reference binary runs it: W built from
    the matrix lambdas (W_eye = eye (x) L1, W_one = one (x) L2,
    ``SMP_2D_ver2.h:577-585``) and read through the TENSORMUL cast; the
    lambda read is L1[cw, c] where iseye (times x == y), else L2[cw, c]."""
    B, V, P, _, Cp = q.shape
    ix = tensormul_cast_indices(s, P, Cp)
    L = torch.stack([L1, L2], dim=2)                       # [B,V,2,Cp,Cp]
    bv = torch.arange(B * V, device=q.device).reshape(B, V, 1, 1, 1)
    rows = (bv * 2 + (~ix["iseye"]).long()) * Cp + ix["cw"]
    A = L.reshape(-1, Cp)[rows.reshape(-1)].reshape(B, V, P, P, 2, Cp)
    A = A * (ix["diag"] & ix["a_ok"]).to(q.dtype)[..., None]
    return _cast_apply(A, _cast_read_q(q, ix))


def _cast_full_filter(q, Wf, s):
    """The Unrestricted_ver2 filter as the reference binary runs it: the
    learned per-size W[s] (s, s, prevC, C = 2 prevC) read through the
    TENSORMUL cast at (x, y, cw, dw) (``Unrestricted_SMP_2D_ver2.h:
    531-537``), gathered straight from the [V+1, P, P, prevC, C] table."""
    B, V, P, _, Cp = q.shape
    D = Wf.shape[-1]
    ix = tensormul_cast_indices(s, P, Cp)
    dw0 = (~ix["iseye"]).long() * Cp
    base = ((((s.long()[..., None, None, None] * P + ix["x"]) * P + ix["y"])
             * Cp + ix["cw"]) * D + dw0)
    flat = base[..., None] + torch.arange(Cp, device=q.device)
    A = Wf.reshape(-1)[flat.reshape(-1)].reshape(B, V, P, P, 2, Cp)
    A = A * ix["a_ok"].to(q.dtype)[..., None]
    return _cast_apply(A, _cast_read_q(q, ix))


def steerable_states(params, g, cfg: SMP2DSteerableConfig,
                     collect_presum=None):
    """Per-level vertex tensor states [B, V, P, P, C_l], levels 0..nLevels,
    of a stacked batch ``g`` (``graphflow_tpu/models/smp2d_steerable.py:
    323-433``).  ``collect_presum``: a list to which each level's pre-filter
    aggregate (the reference's ``quadratic_plus_adj[v]``, or bare
    ``sum[v]`` without the scalar term) is appended."""
    B, V = g["vmask"].shape
    P = g["nbr"].shape[-1]
    vmask = g["vmask"]
    F0 = leaky_relu(g["wl_feat"] @ params["H"].T)                # [B, V, C]
    state = F0.new_zeros((B, V, P, P, cfg.channels_at(0)))
    state[:, :, 0, 0, :] = F0 * vmask[..., None]
    states = [state]
    dev = state.device
    vid_prev = torch.full((B, V, P), V, dtype=torch.int64, device=dev)
    vid_prev[:, :, 0] = torch.arange(V, device=dev)              # phi_0(v)
    eye = torch.eye(V, dtype=g["adj"].dtype, device=dev)
    adj1 = torch.clamp(g["adj"] + eye, max=1.0)
    adj1 = (adj1 * vmask[:, :, None] * vmask[:, None, :]).to(state.dtype)

    for l in range(cfg.nLevels):
        lev = params["levels"][l]
        sm = g["smask"][:, l + 1]                                # [B,V,P,P]
        rm = sm[..., 0]                                          # [B, V, P]
        vid_cur = torch.where(rm > 0, g["nbr"][:, l].long(),
                              torch.full_like(vid_prev, V))
        s = g["sizes"][:, l + 1].long()                          # [B, V]
        if "lambda1" in lev:
            if cfg.faithful_lambda_grads:
                depth = _LAMBDA_DEPTH[cfg.filter]
                l1 = persize_gather_refgrad(lev["lambda1"], s, depth)
                l2 = persize_gather_refgrad(lev["lambda2"], s, depth)
            else:
                l1, l2 = lev["lambda1"][s], lev["lambda2"][s]

        q = quadratic_sum(state, vid_prev, adj1, vid_cur)
        if cfg.add_scalar_adj:
            # + scalar (.) reduced adjacency (SMP_2D.h:528-530).
            q = q + g["radj"][:, l][..., None] * lev["scalar"]
        q = q * sm[..., None]
        if collect_presum is not None:
            collect_presum.append(q)
        # 1_s @ q: each column's sum, broadcast down the field's rows.
        ones_q = rm[..., None, None] * q.sum(dim=2)[:, :, None]

        if cfg.filter in ("steerable", "concat", "concat_k"):
            a1, a2 = l1[:, :, None, None], l2[:, :, None, None]
            if cfg.filter == "steerable":
                z = a1 * q + a2 * ones_q
            else:
                z = torch.cat([a1 * q, a2 * ones_q], dim=-1)
                if cfg.filter == "concat_k":
                    z = z @ lev["K"].T                           # K: 2C -> C
        elif cfg.filter == "matrix":
            if cfg.engine_faithful:
                z = _cast_matrix_filter(q, l1, l2, s)
            else:
                z = torch.cat([torch.einsum("bvxyc,bvcd->bvxyd", q, l1),
                               torch.einsum("bvxyc,bvcd->bvxyd", ones_q, l2)],
                              dim=-1)
        elif cfg.filter == "unrestricted":
            z = torch.einsum("bvpqc,bvqrc->bvprc",
                             lev["Wf"][s] * sm[..., None], q)
        elif cfg.engine_faithful:                                # 4-D
            z = _cast_full_filter(q, lev["Wf"], s)
        else:
            # Tensor4DTensor3DMul.h:49-71: out[p,q,d] = SUM_kc W[p,k,c,d]
            # q[k,q,c].
            z = torch.einsum("bvpkcd,bvkqc->bvpqd",
                             lev["Wf"][s] * sm[..., None, None], q)
        z = z + lev["b"][s][:, :, None, None, :]
        state = leaky_relu(z) * sm[..., None]
        states.append(state)
        vid_prev = vid_cur
    return states


def steerable_forward(params, g, cfg: SMP2DSteerableConfig):
    """-> (prediction [B], or class scores [B, nClasses]; graph_feat
    [B, C_L])."""
    state = steerable_states(params, g, cfg)[-1]
    vertex = leaky_relu(state.sum(dim=(2, 3)))                   # [B, V, C]
    graph_feat = (vertex * g["vmask"][..., None]).sum(dim=1)
    if cfg.nClasses:
        return graph_feat @ params["W"].T, graph_feat
    return graph_feat @ params["W"], graph_feat


def strip_radj_self_loops(pg: prep.PreparedGraph,
                          graph: DenseGraph) -> prep.PreparedGraph:
    """The prepared reduced adjacency with its forced-1 diagonal replaced
    by the raw adjacency's own diagonal (the SMP_2D convention,
    ``SMP_2D.h:458-469``; ``graphflow_tpu/models/smp2d_steerable.py:
    445-462``)."""
    radj = np.array(pg.radj)                                     # [L,V,P,P]
    V, P = radj.shape[1], radj.shape[2]
    adiag = np.zeros(V + 1)
    adiag[:graph.nVertices] = np.diagonal(graph.adj)
    idx = np.arange(P)
    valid = idx[None, None, :] < pg.sizes[1:, :, None]           # [L, V, P]
    radj[:, :, idx, idx] = adiag[np.minimum(pg.nbr, V)] * valid
    return dataclasses.replace(pg, radj=radj.astype(pg.radj.dtype))


def row_normalize_radj(pg: prep.PreparedGraph) -> prep.PreparedGraph:
    """Each reduced-adjacency row divided by its sum, the closed degree
    within phi (the ver4/ver5 convention, ``SMP_2D_ver4.h:481-502``), in
    float64 and then cast back, as the JAX package does."""
    radj = np.array(pg.radj, np.float64)
    rowsum = radj.sum(axis=3, keepdims=True)
    radj = np.where(rowsum > 0, radj / np.where(rowsum == 0, 1.0, rowsum),
                    radj)
    return dataclasses.replace(pg, radj=radj.astype(pg.radj.dtype))


class SMP2DSteerable(GraphModel):
    """Config-driven steerable SMP model with the reference API.

    Parameters are registered under the JAX package's paths in the order
    its text checkpoint writes them: H, W, then per level
    :meth:`SMP2DSteerableConfig.level_keys`."""

    # What steerable_states and steerable_forward read.
    batch_fields = ("wl_feat", "vmask", "sizes", "nbr", "radj", "smask",
                    "adj")

    def __init__(self, cfg: SMP2DSteerableConfig, seed: int = 0,
                 device=None):
        super().__init__(optimizer=cfg.optimizer,
                         **({"gamma": cfg.momentum_param}
                            if cfg.optimizer == "momentum" else {}))
        self.cfg = cfg
        self._register(
            init_steerable_params(torch.Generator().manual_seed(seed), cfg,
                                  resolve_device(device)),
            ["H", "W"] + [f"levels/{l}/{k}" for l in range(cfg.nLevels)
                          for k in cfg.level_keys()])

    def _prepare(self, graph: DenseGraph) -> prep.PreparedGraph:
        pg = prep.prepare_graph(
            graph, self.cfg.nLevels, self.cfg.max_nVertices, None,
            self.cfg.nDepth, has_WL_ordering=self.cfg.has_WL_ordering,
            dtype=self.cfg.host_dtype)
        if not self.cfg.radj_self_loops:
            pg = strip_radj_self_loops(pg, graph)
        if self.cfg.radj_row_normalize:
            pg = row_normalize_radj(pg)
        return pg

    def _forward(self, params, batch):
        return steerable_forward(params, batch, self.cfg)

    def _loss(self, params, batch):
        out, _ = steerable_forward(params, batch, self.cfg)
        if self.cfg.nClasses:
            return log_loss(out, batch["target"])
        return squared_loss(out, batch["target"])


def _steerable(filter, max_nVertices, nLevels, nChanels, nFeatures, nDepth,
               momentum_param, seed, device, **more) -> SMP2DSteerable:
    return SMP2DSteerable(SMP2DSteerableConfig(
        max_nVertices, nLevels, nChanels, nFeatures, nDepth, filter=filter,
        momentum_param=momentum_param, **more), seed, device)


def SMP_2D(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
           momentum_param=0.9, has_WL_ordering=True, seed=0,
           device=None) -> SMP2DSteerable:
    """``SMP_2D.h``: the steerable filter, the raw radj diagonal."""
    return _steerable("steerable", max_nVertices, nLevels, nChanels,
                      nFeatures, nDepth, momentum_param, seed, device,
                      has_WL_ordering=has_WL_ordering, radj_self_loops=False)


def SMP_2D_classification(max_nVertices, nLevels, nChanels, nFeatures,
                          nDepth, nClasses, momentum_param=0.9, seed=0,
                          device=None) -> SMP2DSteerable:
    """``SMP_2D_classification.h``: SMP_2D with a log-loss head."""
    return _steerable("steerable", max_nVertices, nLevels, nChanels,
                      nFeatures, nDepth, momentum_param, seed, device,
                      nClasses=nClasses, radj_self_loops=False)


def SMP_2D_ver2(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                momentum_param=0.9, seed=0, device=None) -> SMP2DSteerable:
    """``SMP_2D_ver2.h``: matrix lambdas, channels double, the scalar (.)
    adjacency term, the filter read through the TENSORMUL cast."""
    return _steerable("matrix", max_nVertices, nLevels, nChanels, nFeatures,
                      nDepth, momentum_param, seed, device,
                      radj_self_loops=False)


def SMP_2D_ver3(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                momentum_param=0.9, seed=0, device=None) -> SMP2DSteerable:
    """``SMP_2D_ver3.h``: ver2 without the scalar (.) adjacency term
    (``SMP_2D_ver3.h:551``)."""
    return _steerable("matrix", max_nVertices, nLevels, nChanels, nFeatures,
                      nDepth, momentum_param, seed, device,
                      add_scalar_adj=False)


def SMP_2D_ver4(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                momentum_param=0.9, seed=0, device=None) -> SMP2DSteerable:
    """``SMP_2D_ver4.h:130-180``: vector lambdas, the two branches
    concatenated (channels double), row-normalised radj."""
    return _steerable("concat", max_nVertices, nLevels, nChanels, nFeatures,
                      nDepth, momentum_param, seed, device,
                      radj_row_normalize=True)


def SMP_2D_ver4_classification(max_nVertices, nLevels, nChanels, nFeatures,
                               nDepth, nClasses, momentum_param=0.9, seed=0,
                               device=None) -> SMP2DSteerable:
    """``SMP_2D_ver4_classification.h``: ver4 with a log-loss head."""
    return _steerable("concat", max_nVertices, nLevels, nChanels, nFeatures,
                      nDepth, momentum_param, seed, device,
                      nClasses=nClasses, radj_row_normalize=True)


def SMP_2D_ver5(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                momentum_param=0.9, seed=0, device=None) -> SMP2DSteerable:
    """``SMP_2D_ver5.h:127-171``: vector lambdas, concatenated and then
    reduced by K (C x 2C) (``SMP_2D_ver5.h:599-604``); constant width."""
    return _steerable("concat_k", max_nVertices, nLevels, nChanels,
                      nFeatures, nDepth, momentum_param, seed, device,
                      radj_row_normalize=True)


def Unrestricted_SMP_2D(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
                        momentum_param=0.9, seed=0,
                        device=None) -> SMP2DSteerable:
    """``Unrestricted_SMP_2D.h``: full learned W[s] filters."""
    return _steerable("unrestricted", max_nVertices, nLevels, nChanels,
                      nFeatures, nDepth, momentum_param, seed, device,
                      radj_self_loops=False)


def Unrestricted_SMP_2D_ver2(max_nVertices, nLevels, nChanels, nFeatures,
                             nDepth, momentum_param=0.9, seed=0,
                             device=None) -> SMP2DSteerable:
    """``Unrestricted_SMP_2D_ver2.h``: 4-D W[s] filters, channels double,
    read through the TENSORMUL cast as in ver2."""
    return _steerable("unrestricted4d", max_nVertices, nLevels, nChanels,
                      nFeatures, nDepth, momentum_param, seed, device,
                      radj_self_loops=False)
