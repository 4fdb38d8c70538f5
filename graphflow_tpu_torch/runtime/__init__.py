"""Native build support for the port's CUDA kernels."""
