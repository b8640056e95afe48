"""Device ops of the port: plain functions on tensors, each hand-written
CUDA kernel beside its plain PyTorch version (see ``cuda_build``)."""
