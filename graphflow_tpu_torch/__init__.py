"""GraphFlow on PyTorch and CUDA: the port of ``graphflow_tpu`` to Hopper.

The JAX package ``graphflow_tpu`` is the reference; this package computes
the same functions with plain PyTorch on the host side and hand-written
CUDA kernels where the JAX package runs a Pallas TPU kernel.  Each module
sits at the same path as its JAX counterpart (``core/``, ``ops/``,
``models/``, ``optim/``, ``utils/``, ``runtime/``).

The package imports ``torch`` and NumPy and never ``jax``.  Kernels are
built with ``nvcc`` at their first CUDA launch (``runtime/cuda_build.py``),
never at import.

The port covers SMP_omega's serving and training paths: host
preparation, batching, the level-0 embedding, the fused second-order level
(``ops/risi_level.py``, with its forward kernel ``ops/csrc/risi18_level.cu``
and backward kernel ``ops/csrc/risi18_level_bwd.cu``), the head, the
squared loss, Adam with the reference's schedule, ``BatchLearn`` and the
text checkpoint.  The rest of the JAX package is queued in ROADMAP.md.
"""

from graphflow_tpu_torch.core.graph import DenseGraph

__version__ = "0.1.0"

__all__ = ["DenseGraph", "__version__"]
