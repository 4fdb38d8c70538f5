"""Models: the reference's GraphModel API and bucketed training, the
second-order SMP family (SMP_omega, SMP_beta, SMP_gamma, SMP_2D_ver6/7/8,
the classification heads and the names of the reference's GPU model
classes), the first-order SMP family (SMP_theta, SMP_1D and its variants),
the steerable second-order family (SMP_2D, ver2-ver5, Unrestricted), the
GCN family (GCN_1D/2D/3D and _Distance, GCN_MW, NeuralFingerprint), the
physics family, the pair-of-graphs models (the SMP pairgraphs, CCN_1D, the
GCN kernels), GRU_GCN, GCA_1D and CGCN, LCNN, and the library models LSTM,
GRU, MLP and CNN."""

from graphflow_tpu_torch.models.base import (GraphModel, ParamModel,
                                            fit_bucketed)
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
from graphflow_tpu_torch.models.pairgraphs import (
    CCN_1D, GCNKernel, GCN_1D_Kernel, GCN_2D_Kernel, GCN_3D_Kernel,
    PairGraphModel, SMPPairGraphs, SMP_beta_pairgraphs, SMP_gamma_pairgraphs,
    SMP_omega_pairgraphs, SMP_sigma_pairgraphs, SMP_theta_pairgraphs)
from graphflow_tpu_torch.models.gru_gcn import (GRU_GCN, GRU_GCN_1D,
                                                GRU_GCN_2D, GRU_GCN_3D)
from graphflow_tpu_torch.models.gca import CGCN, CGCN_1D, CGCN_2D, GCA_1D
from graphflow_tpu_torch.models.lcnn import LCNN
from graphflow_tpu_torch.models.rnn import GRU, LSTM
from graphflow_tpu_torch.models.mlp import CNN, MLP

__all__ = ["CCN_1D", "CGCN", "CGCN_1D", "CGCN_2D", "CNN", "GCA_1D",
           "GCNKernel", "GCN_1D_Kernel", "GCN_2D_Kernel", "GCN_3D_Kernel",
           "GRU", "GRU_GCN", "GRU_GCN_1D", "GRU_GCN_2D", "GRU_GCN_3D",
           "LCNN", "LSTM", "MLP", "PairGraphModel", "ParamModel",
           "SMPPairGraphs", "SMP_beta_pairgraphs", "SMP_gamma_pairgraphs",
           "SMP_omega_pairgraphs", "SMP_sigma_pairgraphs",
           "SMP_theta_pairgraphs",
           "GCN", "GCNConfig", "GCN_1D", "GCN_1D_Distance", "GCN_2D",
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
