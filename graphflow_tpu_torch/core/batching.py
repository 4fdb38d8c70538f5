"""Padded batching (counterpart of ``graphflow_tpu/core/batching.py``).

Graphs are padded to common (max_nVertices, max_receptive_field) shapes by
``prepare_graph`` and stacked here along a leading batch axis, as tensors
on the device the caller names.  ``bucket_by_size`` groups graphs by the
smallest vertex-count boundary that holds them, so that each bucket pads
only to its own size (``models/base.py:fit_bucketed``).
"""

from __future__ import annotations

from typing import Dict, Sequence

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


def stack_graphs(graphs: Sequence[PreparedGraph], targets=None,
                 device=None, dtype=None) -> GraphBatch:
    """Stack prepared graphs into a dict of [B, ...] tensors on ``device``.
    A field absent (None) from any graph is left out.  Index arrays stay
    int32 (sp int64); float arrays keep their prepared dtype, or are cast
    to ``dtype`` on the device (how a bfloat16 model, prepared in float32,
    gets its batch).  Targets are float32.

    Span ``graphflow.stack``: each field's stacking on the host is a
    ``graphflow.stack.host`` span and its hand-over to the device a
    ``graphflow.stack.h2d`` span; the counter ``h2d.bytes`` adds the bytes
    handed over, whatever the device."""
    span = profiling.span
    batch: GraphBatch = {}
    nbytes = 0
    with span("graphflow.stack"):
        for f in STACK_FIELDS:
            vals = [getattr(g, f) for g in graphs]
            if any(v is None for v in vals):
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
    profiling.count("h2d.bytes", nbytes + sum(
        batch[k].nbytes for k in ("nVertices", "target") if k in batch))
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
