"""Tensor ops: plain PyTorch functions and the hand-written CUDA level,
forward and backward."""
