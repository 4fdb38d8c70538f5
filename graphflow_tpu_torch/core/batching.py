"""Padded batching (counterpart of ``graphflow_tpu/core/batching.py``).

Graphs are padded to common (max_nVertices, max_receptive_field) shapes by
``prepare_graph`` and stacked here along a leading batch axis, as tensors
on the device the caller names.  ``bucket_by_size`` groups graphs by the
smallest vertex-count boundary that holds them, so that each bucket pads
only to its own size (``models/base.py:fit_bucketed``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from graphflow_tpu_torch.core.prep import PreparedGraph
from graphflow_tpu_torch.utils import profiling

GraphBatch = Dict[str, torch.Tensor]

STACK_FIELDS = ("wl_feat", "vmask", "sizes", "nbr", "pos", "radj", "smask",
                "norm_adj", "adj", "raw_feat", "sp", "dist",
                "ell_nbr", "ell_w", "ell_nbr_a", "ell_w_a", "fo_idx")


def _pad_ell(f: str, vals):
    """ELLPACK structures carry a per-graph max degree D on axis 1; pad
    every graph to the batch's largest, with the sentinel row id V in an
    index field and weight 0 in a weight field, so the extra slots are
    inert (``graphflow_tpu/core/batching.py:31-47``)."""
    D = max(v.shape[1] for v in vals)
    out = []
    for v in vals:
        pad = np.zeros((v.shape[0], D - v.shape[1]), v.dtype)
        if f.startswith("ell_nbr"):
            pad += v.shape[0]
        out.append(np.concatenate([v, pad], axis=1))
    return out


def _stacked_nbytes(f: str, vals) -> int:
    """The bytes of one field's arrays stacked, ELLPACK fields padded to
    the batch's largest degree as :func:`_pad_ell` pads them."""
    if f.startswith("ell_"):
        D = max(v.shape[1] for v in vals)
        return len(vals) * vals[0].shape[0] * D * vals[0].itemsize
    return sum(v.nbytes for v in vals)


def smask_from_sizes(sizes: torch.Tensor, P: int,
                     dtype: torch.dtype) -> torch.Tensor:
    """``PreparedGraph.smask`` from ``sizes`` [..., V] on their device:
    ``smask[..., v, p1, p2] = (p1 < s) & (p2 < s)``, ``s = sizes[..., v]``,
    as ``dtype`` [..., V, P, P]; a padding vertex (size 0) is all zero."""
    m = torch.arange(P, device=sizes.device) < sizes[..., None]
    return (m[..., :, None] & m[..., None, :]).to(dtype)


def stack_graphs(graphs: Sequence[PreparedGraph], targets=None,
                 device=None, dtype=None,
                 fields: Optional[Sequence[str]] = None) -> GraphBatch:
    """Stack prepared graphs into a dict of [B, ...] tensors on ``device``.
    A field absent (None) from any graph is left out.  Index arrays stay
    int32 (sp int64); float arrays keep their prepared dtype, or are cast
    to ``dtype`` on the device (how a bfloat16 model, prepared in float32,
    gets its batch).  Targets are float32.

    ``fields`` names the fields to stack, of ``STACK_FIELDS``, in that
    order; None stacks every field.  Where ``fields`` names ``smask``, the
    host's mask does not cross: ``sizes`` crosses (and stays in the batch)
    and ``smask`` is built from it on ``device`` (:func:`smask_from_sizes`),
    in ``dtype`` or else the prepared mask's, equal to the host's bit for
    bit.  ``nVertices`` and ``target`` are handed over whatever ``fields``
    says.

    Span ``graphflow.stack``: each field's stacking on the host is a
    ``graphflow.stack.host`` span and its hand-over to the device (or the
    mask's build there) a ``graphflow.stack.h2d`` span; the counter
    ``h2d.bytes`` adds the bytes handed over, whatever the device, and
    ``h2d.bytes_avoided`` the bytes of the fields that ``fields=None``
    would have handed over and this batch left on the host."""
    span = profiling.span
    wanted = set(STACK_FIELDS if fields is None else fields)
    if not wanted <= set(STACK_FIELDS):
        raise ValueError(f"fields {sorted(wanted - set(STACK_FIELDS))} "
                         f"are not of STACK_FIELDS")
    # A named smask is built on the device from sizes, which cross for it.
    build_smask = fields is not None and "smask" in wanted
    if build_smask:
        wanted.add("sizes")
    batch: GraphBatch = {}
    nbytes = avoided = 0
    mask = None  # (P, dtype) of a smask to build on the device
    with span("graphflow.stack"):
        for f in STACK_FIELDS:
            vals = [getattr(g, f) for g in graphs]
            if any(v is None for v in vals):
                continue
            if f == "smask" and build_smask:
                avoided += _stacked_nbytes(f, vals)
                mask = (vals[0].shape[-1],
                        dtype or torch.from_numpy(vals[0]).dtype)
                continue
            if f not in wanted:
                avoided += _stacked_nbytes(f, vals)
                continue
            with span("graphflow.stack.host"):
                if (f.startswith("ell_")
                        and len({v.shape[1] for v in vals}) > 1):
                    vals = _pad_ell(f, vals)
                x = torch.from_numpy(np.stack(vals))
            nbytes += x.nbytes
            with span("graphflow.stack.h2d"):
                x = x.to(device)
                if dtype is not None and x.is_floating_point():
                    x = x.to(dtype)
            batch[f] = x
        with span("graphflow.stack.h2d"):
            batch["nVertices"] = torch.tensor([g.nVertices for g in graphs],
                                              dtype=torch.int32,
                                              device=device)
            if targets is not None:
                batch["target"] = torch.as_tensor(
                    np.asarray(targets, dtype=np.float32), device=device)
        # Built after the last copy: a pageable copy waits for the kernels
        # queued before it.
        if mask is not None:
            with span("graphflow.stack.h2d"):
                batch["smask"] = smask_from_sizes(batch["sizes"], *mask)
    profiling.count("h2d.bytes", nbytes + sum(
        batch[k].nbytes for k in ("nVertices", "target") if k in batch))
    profiling.count("h2d.bytes_avoided", avoided)
    return batch


def batch_size(batch: GraphBatch) -> int:
    return int(batch["vmask"].shape[0])


def index_batch(batch: GraphBatch, idx) -> GraphBatch:
    """A sub-batch (e.g. a minibatch slice) along the leading axis."""
    return {k: x[idx] for k, x in batch.items()}


def pad_batch_to(batch: GraphBatch, size: int) -> GraphBatch:
    """Pad the batch's leading axis to ``size`` with all-zero graphs: their
    vmask is 0 everywhere, so they add exactly zero to a loss and its
    gradient."""
    b = batch_size(batch)
    if b == size:
        return batch
    if b > size:
        raise ValueError(f"batch of {b} graphs > size {size}")
    return {k: torch.cat([x, x.new_zeros((size - b, *x.shape[1:]))])
            for k, x in batch.items()}


def bucket_by_size(graphs, targets=None, boundaries=(8, 16, 32, 64, 128)):
    """Group graphs into padded-size buckets: each graph goes to the
    smallest boundary >= its vertex count.  Returns {boundary: (graphs,
    targets)} in the order the buckets are first met, empty buckets left
    out; a graph larger than every boundary raises ``ValueError``."""
    buckets = {}
    for i, g in enumerate(graphs):
        for b in boundaries:
            if g.nVertices <= b:
                gs, ts = buckets.setdefault(b, ([], []))
                gs.append(g)
                if targets is not None:
                    ts.append(targets[i])
                break
        else:
            raise ValueError(
                f"graph with {g.nVertices} vertices exceeds the largest "
                f"bucket boundary {boundaries[-1]}")
    return buckets
