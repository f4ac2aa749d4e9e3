"""Ops of the port: the BN/ABN training and eval ops over the CUDA kernels
B1, B2 and B3, the kernel wrappers, losses and metrics."""
