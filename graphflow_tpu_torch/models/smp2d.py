"""Second-order Steerable Message Passing (counterpart of
``graphflow_tpu/models/smp2d.py``): SMP_omega, SMP_beta, SMP_gamma,
SMP_2D_ver6, ver7, ver8, the ver6/ver7 classification heads, and the
towers of the physics family (``models/physics.py``).

Math per level (reference ``SMP_omega.h:607-692``):
  level 0:  F_v = LeakyReLU(H @ wl_feat_v)            as a 1x1xC tensor
  level l:  for each w in phi_l(v): gather X f_w X^T  (permutation alignment)
            T = stack of gathered tensors; Y = RisiContraction_k(T, radj)
            Z = reshape(Y) @ K_l + b_l;  F = LeakyReLU(Z), then masked
  head:     vertex = LeakyReLU(sum_{p1,p2} F);  graph = sum_v vertex
            predict = <graph, W>, or class scores W @ graph (nClasses)

Where JAX vmaps the level over the batch, the port flattens B graphs of V
padded vertices into B*V vertex rows and offsets ``nbr`` by b*V, so one
call of the level (one kernel launch on CUDA) covers the batch.

The level's route depends on the contraction k, the same in float32 and
bfloat16 (float64 runs on the CPU, for parity tests):
- k = 18: :func:`risi18_level`, the fused level (K1, K2 on CUDA), which
  gathers its slots inside the kernel and stores no T.  The kernels take
  the state, K and b in the model's dtype and the adjacency in float32 (the
  model hands ``radj.float()``, exact for a 0/1 adjacency); they sum in
  float32 and round once, as the JAX package's fused level does.  On the
  TPU the JAX package sends bfloat16 there only at P a multiple of 16; that
  split follows the TPU's 16-row bfloat16 tile and is not ported.
- k = 10, 50 (ver6, ver7): the aligned neighbour tensor T, then the fused
  bank with K (``risi_contraction_{10,50}_matmul``), bias, LeakyReLU.  For
  inference T comes from :func:`risi18_aligned_t2` (K7 on CUDA); for
  training from its plain version, the take-gather, which torch autograd
  differentiates, as the JAX package does (``smp2d.py:287-299``).
- k = 4 (gamma): the take-gather, ``risi_contraction_4`` (no adjacency),
  then the product with K, bias, LeakyReLU.

:func:`risi18_bank_level` is the bank route of k = 18 over a materialised T
(the take-gather, then :func:`risi18_bank`: K4, K5 on CUDA; bias and
LeakyReLU in the state's dtype, ``graphflow_tpu/models/smp2d.py:297-308``).
No model takes it by default; it is a ``level_fn=`` choice, and K4 and K5
are the kernels of the bank wherever T exists already (the ablation tool,
a partitioned level).

A ``channel_schedule`` gives every level its own channel count (the
physics towers halve it); the kernels take C and Cout apart, so a scheduled
tower runs the same routes.  A ``case_mask`` (the sigma variant's per-case
dropout) multiplies the bank's cases before K, which equals scaling K's
row blocks, so a masked level runs the same routes with the scaled K.

The port covers inference and training (the squared loss of the
regression head, the log loss of the classification head, Adam or
Momentum, ``BatchLearn``), in float32 and bfloat16 for every k.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch.core.graph import DenseGraph
from graphflow_tpu_torch.models.base import GraphModel, resolve_device
from graphflow_tpu_torch.ops.activations import leaky_relu
from graphflow_tpu_torch.ops.contractions import (risi_contraction_4,
                                                  risi_contraction_10,
                                                  risi_contraction_10_matmul,
                                                  risi_contraction_18,
                                                  risi_contraction_50,
                                                  risi_contraction_50_matmul)
from graphflow_tpu_torch.ops.losses import log_loss, squared_loss
from graphflow_tpu_torch.ops.risi_aligned import (risi18_aligned_t2,
                                                  risi18_aligned_t2_reference)
from graphflow_tpu_torch.ops.risi_bank import (risi18_bank,
                                               risi18_bank_reference)
from graphflow_tpu_torch.ops.risi_level import risi18_level
from graphflow_tpu_torch.optim.utils import uniform_init
from graphflow_tpu_torch.utils import profiling
from graphflow_tpu_torch.utils.convert import to_numpy

_CONTRACTIONS = (4, 10, 18, 50)


@dataclasses.dataclass
class SMP2DConfig:
    max_nVertices: int
    max_receptive_field: Optional[int]
    nLevels: int
    nChanels: int
    nFeatures: int
    nDepth: int
    has_WL_ordering: bool = True
    use_coulomb: bool = False
    use_wl_features: bool = True      # False: raw features (physics)
    contraction: int = 18             # 4 | 10 | 18 | 50
    nClasses: Optional[int] = None    # set: classification head, log loss
    optimizer: str = "adam"
    dtype: str = "float32"
    # Per-level channel counts, length nLevels + 1 (the physics towers halve
    # them, ``SMP_omega_physics.h:142-144``); None: nChanels at every level.
    channel_schedule: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.contraction not in _CONTRACTIONS:
            raise ValueError(f"contraction {self.contraction}: the banks "
                             f"have {_CONTRACTIONS} cases")
        if (self.channel_schedule is not None
                and len(self.channel_schedule) != self.nLevels + 1):
            raise ValueError(
                f"channel_schedule {self.channel_schedule} needs "
                f"nLevels + 1 = {self.nLevels + 1} entries")
        if self.dtype not in ("float32", "float64", "bfloat16"):
            raise NotImplementedError(
                f"dtype {self.dtype} is not ported; the port takes "
                f"float32, float64 and bfloat16")

    @property
    def feat_dim(self) -> int:
        return (self.nFeatures * (self.nDepth + 1)
                if self.use_wl_features else self.nFeatures)

    @property
    def P(self) -> int:
        return (self.max_receptive_field
                if self.max_receptive_field is not None else self.max_nVertices)

    def channels_at(self, l: int) -> int:
        if self.channel_schedule is not None:
            return self.channel_schedule[l]
        return self.nChanels

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def host_dtype(self) -> np.dtype:
        """The dtype of the host arrays of ``prepare_graph``.  NumPy has no
        bfloat16, so a bfloat16 model prepares in float32 and
        ``stack_graphs`` casts on the device.  That is exact for the fields
        SMP_omega reads (0/1 masks and adjacency, WL histograms of small
        integers); a Coulomb or distance value may differ from the JAX
        package's by one bfloat16 step, rounded twice (float64 -> float32
        -> bfloat16) where the JAX package rounds once."""
        return np.dtype("float32" if self.dtype == "bfloat16"
                        else self.dtype)


def init_smp2d_params(generator: torch.Generator, cfg: SMP2DConfig,
                      device=None):
    """Fresh parameters as the JAX tree, drawn in the reference's
    registration order (``SMP_omega.h:289-295``): H [C_0, feat], per level
    (K [k C_l, C_{l+1}], b [C_{l+1}]), W ([nClasses, C_L] with a
    classification head, else [C_L]).  Each draw is float64 from
    ``generator``, rounded to the model's dtype (bfloat16 included);
    weights shared with the JAX package come through ``utils/convert.py``
    instead."""
    dt, at = cfg.torch_dtype, cfg.channels_at

    def draw(shape):
        return uniform_init(shape, generator, dt, device)

    H = draw((at(0), cfg.feat_dim))
    levels = [{"K": draw((cfg.contraction * at(l), at(l + 1))),
               "b": draw((at(l + 1),))}
              for l in range(cfg.nLevels)]
    CL = at(cfg.nLevels)
    W = draw((cfg.nClasses, CL) if cfg.nClasses else (CL,))
    return {"H": H, "levels": levels, "W": W}


def _bank_level(bank, state, nbr, pos, radj, K, b, negslope=0.01):
    """The bank route of one level (``graphflow_tpu/models/smp2d.py:
    297-308``): pad the state, take-gather T [N,P,P,P,C], the bank with the
    float32 adjacency, then the bias and LeakyReLU in the state's dtype.
    -> [N, P*P, Cout]."""
    N, P, _, _ = state.shape
    T = risi18_aligned_t2_reference(state, nbr, pos)
    Z = bank(T, radj.float(), K).reshape(N, P * P, K.shape[1]) + b
    return leaky_relu(Z, negslope)


def risi18_bank_level(state, nbr, pos, radj, K, b, negslope=0.01):
    """The level through :func:`risi18_bank` (K4 and K5 on CUDA) over a
    materialised T; a ``level_fn=`` choice.  Arguments as
    :func:`risi18_level`, with ``radj`` in any float dtype."""
    return _bank_level(risi18_bank, state, nbr, pos, radj, K, b, negslope)


def risi18_bank_level_reference(state, nbr, pos, radj, K, b, negslope=0.01):
    """:func:`risi18_bank_level` through the plain bank, on any device."""
    return _bank_level(risi18_bank_reference, state, nbr, pos, radj, K, b,
                       negslope)


def contraction_level(contraction, gather, state, nbr, pos, radj, K, b,
                      negslope=0.01):
    """One level of the 4-, 10- and 50-case variants
    (``graphflow_tpu/models/smp2d.py:309-336``): T = gather(state, nbr,
    pos), the bank with K, + b, LeakyReLU -> [N, P*P, Cout].  ``gather`` is
    :func:`risi18_aligned_t2` (K7 on CUDA; inference only) or
    :func:`risi18_aligned_t2_reference` (the take-gather).

    The gather is the span ``graphflow.level.gather`` and the bank with K
    the span ``graphflow.level.bank``; the counter ``aligned_t.bytes`` adds
    the bytes of each T materialised (``utils/profiling.py``)."""
    N, P, _, C = state.shape
    with profiling.span("graphflow.level.gather"):
        T = gather(state, nbr, pos)
    profiling.count("aligned_t.bytes", T.numel() * T.element_size())
    with profiling.span("graphflow.level.bank"):
        if contraction == 4:
            Z = risi_contraction_4(T).reshape(N, P * P, 4 * C) @ K
        else:
            bank = (risi_contraction_50_matmul if contraction == 50
                    else risi_contraction_10_matmul)
            Z = bank(T, radj, K).reshape(N, P * P, K.shape[1])
    return leaky_relu(Z + b, negslope)


def case_mask_level_reference(contraction, case_mask, state, nbr, pos, radj,
                              K, b, negslope=0.01):
    """One level with a per-case mask as the JAX package computes it
    (``graphflow_tpu/models/smp2d.py:324-336``), in plain PyTorch on any
    device: the take-gather, the whole bank [N, P, P, kC], each case times
    its entry of ``case_mask`` [k], then K, + b, LeakyReLU.  The model's
    own route scales K instead (:func:`smp2d_states`); the two differ by
    the order of one product and the kernels' summation order."""
    N, P, _, C = state.shape
    T = risi18_aligned_t2_reference(state, nbr, pos)
    if contraction == 4:
        Y = risi_contraction_4(T)
    else:
        bank = {10: risi_contraction_10, 18: risi_contraction_18,
                50: risi_contraction_50}[contraction]
        Y = bank(T, radj)
    Y = Y * torch.repeat_interleave(case_mask.to(Y.dtype), C)
    Z = Y.reshape(N, P * P, contraction * C) @ K + b
    return leaky_relu(Z, negslope)


def fused_level(state, nbr, pos, radj, K, b, negslope=0.01):
    """The fused level of a model: :func:`risi18_level` on the float32
    view of a bfloat16 adjacency, which the kernels need
    (``radj.astype(float32)``, ``risi_fused_pallas.py:1107``); a float32 or
    float64 adjacency passes as it is."""
    if radj.dtype == torch.bfloat16:
        radj = radj.float()
    return risi18_level(state, nbr, pos, radj, K, b, negslope)


def default_level_fn(cfg: SMP2DConfig, training: bool):
    """The level step of ``cfg`` (module docstring), the same in every
    dtype.  ``training`` picks the gather of the 10- and 50-case banks: the
    take-gather, which autograd differentiates, when True;
    :func:`risi18_aligned_t2` (K7 on CUDA) when False, as
    ``graphflow_tpu/models/smp2d.py:287-296`` does."""
    if cfg.contraction == 18:
        return fused_level
    gather = (risi18_aligned_t2
              if cfg.contraction in (10, 50) and not training
              else risi18_aligned_t2_reference)
    return functools.partial(contraction_level, cfg.contraction, gather)


def smp2d_states(params, g, cfg: SMP2DConfig, case_mask=None,
                 level_fn=None, training=False):
    """Per-level vertex states [B, V, P, P, C], levels 0..nLevels, of a
    stacked batch ``g``.  ``level_fn`` is the level step, by default
    :func:`default_level_fn` of ``cfg`` and ``training``; a plain version
    may be given for comparison.  The signal for training is the explicit
    ``training`` argument, as in the JAX package (``_loss`` passes True):
    it matters only for the 10- and 50-case banks, whose inference gather
    has no backward.  Elsewhere the wrapper's autograd (K2 or K5 on CUDA)
    gives the gradients.

    ``case_mask`` [k], one multiplier per case of the bank
    (``ops/contractions.py:dropout_case_mask``), is the sigma variant's
    per-case dropout.  The JAX package multiplies the bank by it before K
    (``smp2d.py:328-329``); that equals one product with K whose row blocks
    are scaled, so the level runs its usual route (and kernels) on
    ``repeat(case_mask, C)[:, None] * K``, and autograd carries dK through
    the scaling.  :func:`case_mask_level_reference` is the JAX form.
    """
    if level_fn is None:
        level_fn = default_level_fn(cfg, training)
    B, V = g["vmask"].shape
    P, C = cfg.P, cfg.channels_at(0)

    # Level 0 (SMP_omega.h:616-627): 1x1xC vertex tensors.
    F0 = leaky_relu(g["wl_feat"] @ params["H"].T)                  # [B, V, C]
    state = F0.new_zeros((B, V, P, P, C))
    state[:, :, 0, 0, :] = F0 * g["vmask"][..., None]
    states = [state]

    # Vertex v of graph k is row k*V + v; ids >= V are absent and map to
    # the sentinel row B*V.
    offset = (torch.arange(B, dtype=torch.int32, device=state.device)
              * V)[:, None, None]
    for l in range(cfg.nLevels):
        K, b = params["levels"][l]["K"], params["levels"][l]["b"]
        C = state.shape[-1]
        if case_mask is not None:
            K = torch.repeat_interleave(case_mask.to(K.dtype), C)[:, None] * K
        nbr = g["nbr"][:, l]
        nbr = torch.where(nbr < V, nbr + offset,
                          torch.full_like(nbr, B * V)).reshape(B * V, P)
        pos = g["pos"][:, l].reshape(B * V, P, P).contiguous()
        radj = g["radj"][:, l].reshape(B * V, P, P).contiguous()
        Z = level_fn(state.reshape(B * V, P, P, C), nbr, pos, radj, K, b)
        state = (Z.reshape(B, V, P, P, K.shape[1])
                 * g["smask"][:, l + 1, :, :, :, None])
        states.append(state)
    return states


def _graph_feature(state, vmask):
    """Shrink -> LeakyReLU -> masked vertex sum (SMP_omega.h:674-686)."""
    vertex = leaky_relu(state.sum(dim=(-3, -2)))                   # [B, V, C]
    return (vertex * vmask[..., None]).sum(dim=-2)                 # [B, C]


def smp2d_level_features(params, g, cfg: SMP2DConfig, case_mask=None,
                         level_fn=None, training=False):
    """Per-level graph features of a stacked batch (the physics and
    pairgraph towers collect these at every level,
    ``SMP_omega_pairgraphs.h:640-654``): a list of [B, C_l], levels
    0..nLevels; the channel counts differ under a channel schedule."""
    states = smp2d_states(params, g, cfg, case_mask=case_mask,
                          level_fn=level_fn, training=training)
    return [_graph_feature(s, g["vmask"]) for s in states]


def smp2d_forward(params, g, cfg: SMP2DConfig, level_fn=None,
                  training=False):
    """Forward over a stacked batch -> (prediction [B], or class scores
    [B, nClasses] with a classification head; graph_feat [B, C])."""
    states = smp2d_states(params, g, cfg, level_fn=level_fn,
                          training=training)
    graph_feat = _graph_feature(states[-1], g["vmask"])
    if cfg.nClasses:
        return graph_feat @ params["W"].T, graph_feat
    return graph_feat @ params["W"], graph_feat


class SMP2D(GraphModel):
    """Config-driven second-order SMP model with the reference API.

    Parameters are registered under the JAX package's paths (``"H"``,
    ``"levels/0/K"``, ...) in the reference's order, so
    ``named_parameters()`` and ``state_dict()`` list them as the text
    checkpoint stores them."""

    # What smp2d_states and smp2d_forward read.
    batch_fields = ("wl_feat", "vmask", "nbr", "pos", "radj", "smask")

    def __init__(self, cfg: SMP2DConfig, seed: int = 0, device=None):
        super().__init__(optimizer=cfg.optimizer)
        self.cfg = cfg
        self._register(
            init_smp2d_params(torch.Generator().manual_seed(seed), cfg,
                              resolve_device(device)),
            ["H"] + [f"levels/{l}/{k}" for l in range(cfg.nLevels)
                     for k in ("K", "b")] + ["W"])

    def _prepare(self, graph: DenseGraph,
                 pad_nVertices: Optional[int] = None) -> prep.PreparedGraph:
        """Host arrays of one graph, padded to ``pad_nVertices`` vertices
        (a size bucket, ``models/base.py:fit_bucketed``) or to
        max_nVertices."""
        return prep.prepare_graph(
            graph, self.cfg.nLevels, pad_nVertices or self.cfg.max_nVertices,
            self.cfg.max_receptive_field, self.cfg.nDepth,
            has_WL_ordering=self.cfg.has_WL_ordering,
            use_coulomb=self.cfg.use_coulomb,
            use_wl_features=self.cfg.use_wl_features,
            dtype=self.cfg.host_dtype)

    def _forward(self, params, batch):
        return smp2d_forward(params, batch, self.cfg)

    def _loss(self, params, batch):
        """The batch loss, summed over graphs, through the training route
        (``graphflow_tpu/models/smp2d.py:398-402``): the log loss of the
        class scores against the targets as integer labels, or the squared
        loss."""
        out, _ = smp2d_forward(params, batch, self.cfg, training=True)
        if self.cfg.nClasses:
            return log_loss(out, batch["target"])
        return squared_loss(out, batch["target"])


def SMP_omega(max_nVertices, max_receptive_field, nLevels, nChanels,
              nFeatures, nDepth, has_WL_ordering=True, use_coulomb=False,
              seed=0, device=None) -> SMP2D:
    """``SMP_omega.h:31-113``: contraction 18 + receptive-field cap + Adam."""
    return SMP2D(SMP2DConfig(
        max_nVertices=max_nVertices, max_receptive_field=max_receptive_field,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, has_WL_ordering=has_WL_ordering,
        use_coulomb=use_coulomb), seed, device)


def SMP_beta(max_nVertices, nLevels, nChanels, nFeatures, nDepth,
             use_coulomb=False, seed=0, device=None) -> SMP2D:
    """``SMP_beta.h:199-208``: omega without the receptive-field cap, so
    P = max_nVertices.  Where a vertex's [P*P, Cout] maps do not fit one
    block's shared memory (P >= 36 forward, >= 33 backward at Cout = 32)
    the level kernels walk its rows in tiles; a field too large even for
    tiles of one row is refused (``ops/risi_level.py:check_smem``)."""
    return SMP2D(SMP2DConfig(
        max_nVertices=max_nVertices, max_receptive_field=None,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, use_coulomb=use_coulomb), seed, device)


def _variant(contraction, optimizer, max_nVertices, max_receptive_field,
             nLevels, nChanels, nFeatures, nDepth, nClasses=None, seed=0,
             device=None) -> SMP2D:
    return SMP2D(SMP2DConfig(
        max_nVertices=max_nVertices, max_receptive_field=max_receptive_field,
        nLevels=nLevels, nChanels=nChanels, nFeatures=nFeatures,
        nDepth=nDepth, contraction=contraction, nClasses=nClasses,
        optimizer=optimizer), seed, device)


def SMP_gamma(max_nVertices, max_receptive_field, nLevels, nChanels,
              nFeatures, nDepth, seed=0, device=None) -> SMP2D:
    """``SMP_gamma.h:199-207``: RisiContraction_4 + Adam."""
    return _variant(4, "adam", max_nVertices, max_receptive_field, nLevels,
                    nChanels, nFeatures, nDepth, seed=seed, device=device)


def SMP_2D_ver6(max_nVertices, max_receptive_field, nLevels, nChanels,
                nFeatures, nDepth, seed=0, device=None) -> SMP2D:
    """``SMP_2D_ver6.h:134-141``: RisiContraction_10 + K(10C->C),
    Momentum."""
    return _variant(10, "momentum", max_nVertices, max_receptive_field,
                    nLevels, nChanels, nFeatures, nDepth, seed=seed,
                    device=device)


def SMP_2D_ver7(max_nVertices, max_receptive_field, nLevels, nChanels,
                nFeatures, nDepth, seed=0, device=None) -> SMP2D:
    """``SMP_2D_ver7.h:134-141``: RisiContraction_50 + K(50C->C),
    Momentum."""
    return _variant(50, "momentum", max_nVertices, max_receptive_field,
                    nLevels, nChanels, nFeatures, nDepth, seed=seed,
                    device=device)


def SMP_2D_ver8(max_nVertices, max_receptive_field, nLevels, nChanels,
                nFeatures, nDepth, seed=0, device=None) -> SMP2D:
    """``SMP_2D_ver8.h:134-141``: RisiContraction_18 + K(18C->C),
    Momentum."""
    return _variant(18, "momentum", max_nVertices, max_receptive_field,
                    nLevels, nChanels, nFeatures, nDepth, seed=seed,
                    device=device)


def SMP_2D_ver8_thread(max_nVertices, max_receptive_field, nLevels,
                       nChanels, nFeatures, nDepth, nThreads=None, seed=0,
                       device=None) -> SMP2D:
    """``SMP_2D_ver8_thread.h``: ver8 with the contraction split over
    std::threads (``RisiContraction_18_thread.h:745-781``); one batched
    launch does that work here, so the math is ver8's."""
    return SMP_2D_ver8(max_nVertices, max_receptive_field, nLevels,
                       nChanels, nFeatures, nDepth, seed=seed, device=device)


def SMP_2D_ver6_classification(max_nVertices, max_receptive_field, nLevels,
                               nChanels, nFeatures, nDepth, nClasses, seed=0,
                               device=None) -> SMP2D:
    """``SMP_2D_ver6_classification.h``: ver6 with a log-loss head."""
    return _variant(10, "momentum", max_nVertices, max_receptive_field,
                    nLevels, nChanels, nFeatures, nDepth, nClasses, seed,
                    device)


def SMP_2D_ver7_classification(max_nVertices, max_receptive_field, nLevels,
                               nChanels, nFeatures, nDepth, nClasses, seed=0,
                               device=None) -> SMP2D:
    """``SMP_2D_ver7_classification.h``: ver7 with a log-loss head."""
    return _variant(50, "momentum", max_nVertices, max_receptive_field,
                    nLevels, nChanels, nFeatures, nDepth, nClasses, seed,
                    device)


# The reference's GPU model classes (``GraphFlow_gpu/``) split a model into
# CPU orchestration, per-op CUDA kernels and per-replica streams.  Here every
# model runs on the card through one batched launch per level, so the
# names resolve to the models themselves, as in the JAX package.

def SMP_omega_gpu(*args, **kwargs) -> SMP2D:
    """``GraphFlow_gpu/SMP_omega_gpu.h``: SMP_omega."""
    return SMP_omega(*args, **kwargs)


def SMP_beta_gpu(*args, **kwargs) -> SMP2D:
    """``GraphFlow_gpu/SMP_beta_gpu.h``: SMP_beta."""
    return SMP_beta(*args, **kwargs)


def SMP_omega_gpu_multistreams(*args, nThreads=None, **kwargs) -> SMP2D:
    """``GraphFlow_gpu/SMP_omega_gpu_multistreams.h``: a replica per
    stream; the batch axis of one launch does that work here."""
    return SMP_omega(*args, **kwargs)


def SMP_beta_gpu_multistreams(*args, nThreads=None, **kwargs) -> SMP2D:
    """``GraphFlow_gpu/SMP_beta_gpu_multistreams.h``: see above."""
    return SMP_beta(*args, **kwargs)


@torch.no_grad()
def smp2d_inspect(model: SMP2D, graph: DenseGraph) -> dict:
    """Activation dump (the reference's ``ForDebugging()``,
    ``SMP_2D.h:762-795``): per-level states, vertex features and the graph
    feature as NumPy arrays restricted to real vertices."""
    g = model._stack([graph])
    states = smp2d_states(model.params, g, model.cfg)
    n = graph.nVertices
    vertex = leaky_relu(states[-1].sum(dim=(-3, -2)))
    return {
        "states": [to_numpy(s[0, :n]) for s in states],
        "vertex_features": to_numpy(vertex[0, :n]),
        "graph_feature": to_numpy(_graph_feature(states[-1], g["vmask"])[0]),
    }


# The physics variants (raw features, optional Coulomb adjacency, a
# per-level-features head) live in models/physics.py; re-exported here as
# the JAX package does.
from graphflow_tpu_torch.models.physics import (  # noqa: E402,F401
    SMP_beta_physics, SMP_gamma_physics, SMP_omega_physics)
