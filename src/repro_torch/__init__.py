"""PyTorch/CUDA port of the quantized Winograd/Toom-Cook convolution
system, for one NVIDIA H100 (sm_90a).

It mirrors ``src/repro``'s module names and public layouts (NHWC
activations, HWIO weights, ``(T, C, n, n)`` tiles, ``(P, T, Cin)`` Xq,
``(P, Cin, Cout)`` packed weights, ``(P, 1)`` scales) and imports
``torch`` and numpy only: never ``jax`` and nothing of ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
