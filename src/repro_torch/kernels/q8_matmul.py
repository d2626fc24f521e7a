"""w8a8 quantized matmul with the dequant epilogue: the CUDA kernel K5
(``csrc/q8_matmul.cu``) and its plain PyTorch version.

``y = f32(x_q @ w_q) · s_x · s_w[col]`` cast to ``out_dtype``, with
x_q (M, K) int8, w_q (K, N) int8, int32 accumulation, a per-tensor
``s_x`` and a per-output-column ``s_w``: the paper's symmetric int8
scheme applied to transformer projections (``ops.q8_linear``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import q8_matmul_ref

__all__ = ["q8_matmul", "q8_matmul_plain"]

# The kernel's grid puts M / 64 on its y axis (at most 65535 blocks).
_MAX_M = 65535 * 64
_OUT_DTYPES = (torch.float32, torch.bfloat16)


def q8_matmul_plain(x_q: torch.Tensor, w_q: torch.Tensor, s_x: torch.Tensor,
                    s_w: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of K5 (see ``q8_matmul``): the exact integer product
    in float64, then the kernel's epilogue operations in its order."""
    return q8_matmul_ref(x_q, w_q, s_x.reshape(()), s_w, out_dtype)


def q8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, s_x: torch.Tensor,
              s_w: torch.Tensor,
              out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x_q (M,K) int8 · w_q (K,N) int8, s_x one fp32 value (shape () or
    (1,)), s_w (N,) fp32 → (M,N) ``out_dtype`` (fp32 or bf16).

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    which reads ``s_x`` from device memory (no host sync)."""
    M, K = x_q.shape
    K2, N = w_q.shape
    if K != K2:
        raise ValueError(f"x_q {tuple(x_q.shape)} and w_q "
                         f"{tuple(w_q.shape)} do not chain")
    if s_x.numel() != 1 or tuple(s_w.shape) != (N,):
        raise ValueError(f"s_x must hold one value and s_w be ({N},), got "
                         f"{tuple(s_x.shape)} and {tuple(s_w.shape)}")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"out_dtype {out_dtype}: the kernel writes "
                         f"{_OUT_DTYPES}")
    if x_q.device.type == "cpu":
        return q8_matmul_plain(x_q, w_q, s_x, s_w, out_dtype)
    dev = _build.cuda_device(x_q, "q8_matmul")
    if M > _MAX_M:
        raise ValueError(f"M = {M} exceeds the kernel's grid ({_MAX_M})")
    _build.require(x_q, "x_q", torch.int8, (M, K), dev, aligned=True)
    _build.require(w_q, "w_q", torch.int8, (K, N), dev, aligned=True)
    _build.require(s_x.reshape(1), "s_x", torch.float32, (1,), dev)
    _build.require(s_w, "s_w", torch.float32, (N,), dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    I, Pt = _build.INT, _build.PTR
    _build.launch("q8_matmul", "q8_matmul",
                  (Pt, Pt, Pt, Pt, Pt, I, I, I, I, Pt),
                  x_q, w_q, s_x, s_w, out, M, N, K,
                  int(out_dtype == torch.bfloat16), _build.stream(dev))
    _build.LAUNCHES["q8_matmul"] += 1
    return out
