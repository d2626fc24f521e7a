"""Hand-written CUDA kernels for Hopper (``csrc/``), their plain PyTorch
versions, and the int8 Winograd convolution composed from them."""
