"""Ops of the port: eval-mode fused ABN and the CUDA kernel wrappers."""
