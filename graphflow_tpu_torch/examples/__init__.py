"""The port's counterparts of the JAX package's ``examples/``: each module
has a ``main`` that takes its epoch count (or its trials) as an argument
and runs on the card unless its ``device`` argument names another.

  train_smp_omega          SMP_omega on the toy molecules (K1, K2), then a
                           checkpoint round trip
  permutation_invariance   Feature() under vertex relabelling
  train_mnist_cnn          the CNN on MNIST idx files, or synthetic digits
  multichip_data_parallel  data-parallel SMP_omega over ranks
  partitioned_training     vertex-partitioned SMP2D on a data x graph mesh
                           (K4, K5)

Run one:  python -m graphflow_tpu_torch.examples.<module> [epochs]
"""
