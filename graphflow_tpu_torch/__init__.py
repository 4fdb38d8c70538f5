"""GraphFlow on PyTorch and CUDA: the port of ``graphflow_tpu`` to Hopper.

The JAX package ``graphflow_tpu`` is the reference; this package computes
the same functions with plain PyTorch on the host side and hand-written
CUDA kernels where the JAX package runs a Pallas TPU kernel.  Each module
sits at the same path as its JAX counterpart (``core/``, ``ops/``,
``models/``, ``optim/``, ``utils/``, ``runtime/``).

The package imports ``torch`` and NumPy and never ``jax``.  Kernels are
built with ``nvcc`` at their first CUDA launch (``runtime/cuda_build.py``),
and the host library with g++ at its first use, never at import.

The port covers SMP_omega's serving and training paths in float32 and
bfloat16: host preparation, batching, the level-0 embedding, the
second-order level (the fused level ``ops/risi_level.py``, with its
forward kernel ``ops/csrc/risi18_level.cu`` and backward kernel
``ops/csrc/risi18_level_bwd.cu``, in either dtype; the bank over a
materialised T, ``ops/risi_bank.py`` with ``ops/csrc/risi18_bank.cu`` and
``ops/csrc/risi18_bank_bwd.cu``, is a ``level_fn=`` choice), the head,
the squared loss, Adam with the reference's schedule, ``BatchLearn`` and
the text checkpoint.  It also covers the SMP_2D contraction variants in
both dtypes (SMP_gamma, SMP_2D_ver6/7/8 and the classification heads):
the 4/10/50-case banks (``ops/contractions.py``), the aligned neighbour
tensor ``ops/risi_aligned.py`` with its kernel
``ops/csrc/risi_aligned_t2.cu``
for ver6/ver7 serving, the log loss and Momentum; the first-order SMP
family (``models/smp1d.py``: SMP_theta, SMP_1D and its variants, torch ops
with the ELLPACK sum of ``ops/sparse.py``), the steerable second-order
family (``models/smp2d_steerable.py``: SMP_2D, ver2-ver5, Unrestricted) and
the GCN family (``models/gcn.py``: GCN_1D/2D/3D and _Distance, GCN_MW,
NeuralFingerprint), both in torch ops, and the four physics towers; the
pair-of-graphs models (``models/pairgraphs.py``: the SMP pairgraphs, whose
second-order towers run the level kernels, CCN_1D and the GCN kernels),
GRU_GCN, GCA_1D and CGCN, LCNN, LSTM and GRU, MLP and CNN (torch ops, with
the convolutions and pools of ``ops/conv.py``) and the five optimizers;
bucketed training (``models/base.py:fit_bucketed``); and host preparation
through the native C++ library ``runtime/csrc/graph_prep.cpp``, built with
g++ at first use (``runtime/native.py``), or its NumPy twin.  Every model
file of the JAX package has its counterpart.  ``parallel/`` scales out
over ranks (process groups named like a mesh, data-parallel training, the
vertex-partitioned SMP2D whose levels run the bank kernels), ``entry.py``
and ``examples/`` are the counterparts of ``__graft_entry__.py`` and
``examples/``, and ``utils/`` holds the datasets, checkpoints and
profiling.  ``utils/profiling.py`` also holds the program's spans
(``graphflow.batch_learn`` and ``graphflow.predict``, a step and a
request, with ``graphflow.stack``, ``.stack.host``, ``.stack.h2d``,
``.forward``, ``.backward``, ``.optimizer``, ``.optimizer.wait`` and
``.readback`` under them) and the counter ``h2d.bytes``: an active
``torch.profiler`` profile is the spans' only switch,
``profiling.trace(logdir)`` their exporter.
The op library that no model calls is ported too:
``ops/linalg.py``, ``ops/reductions.py``, the non-inverted dropout,
masking and ``norm3d``, the contraction banks' case-table engine
(``risi_contraction_10/18/50_spec``) and the unfused yardstick
``ops/fused.py:risi18_matmul_reference``; ``graphflow_tpu_torch.ops``
exports every op that ``graphflow_tpu.ops`` exports.
"""

from graphflow_tpu_torch.version import __version__
from graphflow_tpu_torch.core.graph import DenseGraph
from graphflow_tpu_torch.core import prep
from graphflow_tpu_torch import ops
from graphflow_tpu_torch import optim
from graphflow_tpu_torch import models

__all__ = ["__version__", "DenseGraph", "prep", "ops", "optim", "models"]
