"""Models: the reference's GraphModel API and the second-order SMP family
(SMP_omega, SMP_gamma, SMP_2D_ver6/7/8 and the classification heads)."""

from graphflow_tpu_torch.models.base import GraphModel
from graphflow_tpu_torch.models.smp2d import (
    SMP2D, SMP2DConfig, SMP_2D_ver6, SMP_2D_ver6_classification, SMP_2D_ver7,
    SMP_2D_ver7_classification, SMP_2D_ver8, SMP_2D_ver8_thread, SMP_gamma,
    SMP_omega, smp2d_inspect)

__all__ = ["GraphModel", "SMP2D", "SMP2DConfig", "SMP_2D_ver6",
           "SMP_2D_ver6_classification", "SMP_2D_ver7",
           "SMP_2D_ver7_classification", "SMP_2D_ver8", "SMP_2D_ver8_thread",
           "SMP_gamma", "SMP_omega", "smp2d_inspect"]
