"""Command-line tools of the port (counterparts of the JAX package's
``tools/``): run as ``python -m graphflow_tpu_torch.tools.<name>``."""
