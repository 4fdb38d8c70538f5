"""Models: the reference's GraphModel API and bucketed training, the
second-order SMP family (SMP_omega, SMP_beta, SMP_gamma, SMP_2D_ver6/7/8,
the classification heads and the names of the reference's GPU model
classes), the first-order SMP family (SMP_theta, SMP_1D and its variants),
the steerable second-order family (SMP_2D, ver2-ver5, Unrestricted), the
GCN family (GCN_1D/2D/3D and _Distance, GCN_MW, NeuralFingerprint) and the
physics family."""

from graphflow_tpu_torch.models.base import GraphModel, fit_bucketed
from graphflow_tpu_torch.models.smp2d import (
    SMP2D, SMP2DConfig, SMP_2D_ver6, SMP_2D_ver6_classification, SMP_2D_ver7,
    SMP_2D_ver7_classification, SMP_2D_ver8, SMP_2D_ver8_thread, SMP_beta,
    SMP_beta_gpu, SMP_beta_gpu_multistreams, SMP_gamma, SMP_omega,
    SMP_omega_gpu, SMP_omega_gpu_multistreams, smp2d_inspect)
from graphflow_tpu_torch.models.smp1d import (
    SMP1D, SMP1DConfig, SMP_1D, SMP_1D_classification, SMP_1D_ver2,
    SMP_1D_ver3, SMP_1D_ver3_classification, SMP_theta, Unrestricted_SMP_1D,
    Unrestricted_SMP_1D_ver2, smp1d_inspect)
from graphflow_tpu_torch.models.smp2d_steerable import (
    SMP2DSteerable, SMP2DSteerableConfig, SMP_2D, SMP_2D_classification,
    SMP_2D_ver2, SMP_2D_ver3, SMP_2D_ver4, SMP_2D_ver4_classification,
    SMP_2D_ver5, Unrestricted_SMP_2D, Unrestricted_SMP_2D_ver2)
from graphflow_tpu_torch.models.gcn import (
    GCN, GCNConfig, GCN_1D, GCN_1D_Distance, GCN_2D, GCN_2D_Distance, GCN_3D,
    GCN_3D_Distance, GCN_MW, NeuralFingerprint, gcn_inspect)
from graphflow_tpu_torch.models.physics import (
    SMPPhysics, SMP_beta_physics, SMP_gamma_physics, SMP_omega_physics,
    SMP_theta_physics)

__all__ = ["GCN", "GCNConfig", "GCN_1D", "GCN_1D_Distance", "GCN_2D",
           "GCN_2D_Distance", "GCN_3D", "GCN_3D_Distance", "GCN_MW",
           "GraphModel", "NeuralFingerprint", "SMP1D", "SMP1DConfig", "SMP2D",
           "SMP2DConfig", "SMP2DSteerable", "SMP2DSteerableConfig", "SMP_2D",
           "SMP_2D_classification", "SMP_2D_ver2", "SMP_2D_ver3",
           "SMP_2D_ver4", "SMP_2D_ver4_classification", "SMP_2D_ver5",
           "SMPPhysics", "SMP_1D", "SMP_1D_classification", "SMP_1D_ver2",
           "SMP_1D_ver3", "SMP_1D_ver3_classification", "SMP_2D_ver6",
           "SMP_2D_ver6_classification", "SMP_2D_ver7",
           "SMP_2D_ver7_classification", "SMP_2D_ver8", "SMP_2D_ver8_thread",
           "SMP_beta", "SMP_beta_gpu", "SMP_beta_gpu_multistreams",
           "SMP_beta_physics", "SMP_gamma", "SMP_gamma_physics", "SMP_omega",
           "SMP_omega_gpu", "SMP_omega_gpu_multistreams",
           "SMP_omega_physics", "SMP_theta", "SMP_theta_physics",
           "Unrestricted_SMP_1D", "Unrestricted_SMP_1D_ver2",
           "Unrestricted_SMP_2D", "Unrestricted_SMP_2D_ver2", "fit_bucketed",
           "gcn_inspect", "smp1d_inspect", "smp2d_inspect"]
