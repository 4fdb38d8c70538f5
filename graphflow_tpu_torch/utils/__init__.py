"""Datasets, checkpoints, weight conversion and profiling."""

from graphflow_tpu_torch.utils import checkpoint, datasets

__all__ = ["checkpoint", "datasets"]
