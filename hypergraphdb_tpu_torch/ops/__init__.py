"""Device operators of the port: plain PyTorch, plus the CUDA kernels of
``csrc/`` behind wrappers that run their plain version on CPU tensors."""
