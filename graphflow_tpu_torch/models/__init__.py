"""Models: the reference's GraphModel API and the SMP_omega family."""

from graphflow_tpu_torch.models.base import GraphModel
from graphflow_tpu_torch.models.smp2d import (
    SMP2D, SMP2DConfig, SMP_omega, smp2d_inspect)

__all__ = ["GraphModel", "SMP2D", "SMP2DConfig", "SMP_omega",
           "smp2d_inspect"]
