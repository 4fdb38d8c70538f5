"""Host-side graph data: the container, preparation and batching."""

from graphflow_tpu_torch.core import batching, prep
from graphflow_tpu_torch.core.graph import DenseGraph

__all__ = ["DenseGraph", "prep", "batching"]
