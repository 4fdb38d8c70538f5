"""Tensor ops: plain PyTorch functions and the hand-written CUDA kernels
(the level, forward and backward; the bank, forward and backward; the
aligned neighbour tensor)."""
