"""Padded batching (counterpart of ``graphflow_tpu/core/batching.py``).

Graphs are padded to common (max_nVertices, max_receptive_field) shapes by
``prepare_graph`` and stacked here along a leading batch axis, as tensors
on the device the caller names.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from graphflow_tpu_torch.core.prep import PreparedGraph

GraphBatch = Dict[str, torch.Tensor]

STACK_FIELDS = ("wl_feat", "vmask", "sizes", "nbr", "pos", "radj", "smask",
                "norm_adj", "adj", "raw_feat", "sp", "dist")


def stack_graphs(graphs: Sequence[PreparedGraph], targets=None,
                 device=None, dtype=None) -> GraphBatch:
    """Stack prepared graphs into a dict of [B, ...] tensors on ``device``.
    Index arrays stay int32 (sp int64); float arrays keep their prepared
    dtype, or are cast to ``dtype`` on the device (how a bfloat16 model,
    prepared in float32, gets its batch).  Targets are float32."""
    batch: GraphBatch = {}
    for f in STACK_FIELDS:
        x = torch.from_numpy(np.stack([getattr(g, f) for g in graphs])
                             ).to(device)
        if dtype is not None and x.is_floating_point():
            x = x.to(dtype)
        batch[f] = x
    batch["nVertices"] = torch.tensor([g.nVertices for g in graphs],
                                      dtype=torch.int32, device=device)
    if targets is not None:
        batch["target"] = torch.as_tensor(
            np.asarray(targets, dtype=np.float32), device=device)
    return batch
