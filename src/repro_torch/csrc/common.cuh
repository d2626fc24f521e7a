// Shared device code of the Winograd kernels: the transform sandwich and
// the quantization steps, written so that every kernel and its plain
// PyTorch version compute each value with the same IEEE operations in the
// same order.
//
// nvcc contracts `acc + x * t` into one FMA by default, and a plain
// PyTorch version never does; an Xq value that sits on a rounding boundary
// would then quantize differently. So every multiply and add here is an
// explicit round-to-nearest intrinsic (__fmul_rn / __fadd_rn, which nvcc
// never contracts), every divide is __fdiv_rn, and every rounding is rintf
// (half to even, as torch.round and jnp.round). Never build with
// --use_fast_math.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

extern "C" const char* repro_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

namespace repro {

// Devices a launcher keeps per-device state for (a kernel's shared-memory
// attribute, set once).
constexpr int kMaxDevices = 64;

// Windows up to this size run the unrolled sandwich; larger windows
// (F(6,3): n = 8) run two contractions, as the JAX kernels do.
constexpr int kUnrollMaxN = 6;

// Floats of shared memory one sandwich operand takes.
//   NI <= 6: the table term[a][b][j][k] = L[a][j] * Rt[b][k];
//   NI  > 6: L (NO x NI) followed by Rt (NO x NI).
template <int NI, int NO>
constexpr int kOperandFloats =
    NI <= kUnrollMaxN ? NO * NO * NI * NI : 2 * NO * NI;

// Fill one sandwich operand in shared memory from the (NO x NI) row-major
// matrices L and Rt in device memory. All threads of the block take part;
// the caller synchronises afterwards.
template <int NI, int NO>
__device__ void load_operand(const float* __restrict__ L,
                             const float* __restrict__ Rt, float* sm) {
  if constexpr (NI <= kUnrollMaxN) {
    for (int i = threadIdx.x; i < NO * NO * NI * NI; i += blockDim.x) {
      const int k = i % NI, j = (i / NI) % NI;
      const int b = (i / (NI * NI)) % NO, a = i / (NI * NI * NO);
      sm[i] = __fmul_rn(L[a * NI + j], Rt[b * NI + k]);
    }
  } else {
    for (int i = threadIdx.x; i < NO * NI; i += blockDim.x) {
      sm[i] = L[i];
      sm[NO * NI + i] = Rt[i];
    }
  }
}

// out[a][b] = sum_{j,k} L[a][j] * x[j][k] * Rt[b][k] over one NI x NI
// window held in registers. For NI <= 6 the sum runs j outer, k inner,
// each term x[j][k] * (L[a][j] * Rt[b][k]) -- the order of the JAX
// kernels' _sandwich_unrolled. For NI > 6 it runs as two contractions,
// t[a][k] = sum_j L[a][j] x[j][k], then out[a][b] = sum_k t[a][k] Rt[b][k],
// each sum in ascending index order.
template <int NI, int NO>
__device__ __forceinline__ void sandwich(const float* __restrict__ sm,
                                         const float (&x)[NI * NI],
                                         float (&out)[NO * NO]) {
  if constexpr (NI <= kUnrollMaxN) {
#pragma unroll
    for (int a = 0; a < NO; ++a) {
#pragma unroll
      for (int b = 0; b < NO; ++b) {
        const float* term = sm + (a * NO + b) * NI * NI;
        float acc = __fmul_rn(x[0], term[0]);
#pragma unroll
        for (int jk = 1; jk < NI * NI; ++jk)
          acc = __fadd_rn(acc, __fmul_rn(x[jk], term[jk]));
        out[a * NO + b] = acc;
      }
    }
  } else {
    const float* L = sm;
    const float* Rt = sm + NO * NI;
    float t[NO * NI];
#pragma unroll
    for (int a = 0; a < NO; ++a) {
#pragma unroll
      for (int k = 0; k < NI; ++k) {
        float acc = __fmul_rn(L[a * NI], x[k]);
#pragma unroll
        for (int j = 1; j < NI; ++j)
          acc = __fadd_rn(acc, __fmul_rn(L[a * NI + j], x[j * NI + k]));
        t[a * NI + k] = acc;
      }
    }
#pragma unroll
    for (int a = 0; a < NO; ++a) {
#pragma unroll
      for (int b = 0; b < NO; ++b) {
        float acc = __fmul_rn(t[a * NI], Rt[b * NI]);
#pragma unroll
        for (int k = 1; k < NI; ++k)
          acc = __fadd_rn(acc, __fmul_rn(t[a * NI + k], Rt[b * NI + k]));
        out[a * NO + b] = acc;
      }
    }
  }
}

// clip(rint(v / s), -qm, qm) -- the symmetric quantizer of the input
// transform (qm = 127) and of the Hadamard requant.
__device__ __forceinline__ float quantize(float v, float s, float qm) {
  return fminf(fmaxf(rintf(__fdiv_rn(v, s)), -qm), qm);
}

// One position's Hadamard requant (wino_gemm.requant_plane): int32
// accumulator -> value on the signed qm-grid. f32(acc) is exact while
// |acc| < 2^24.
__device__ __forceinline__ float requant(int32_t acc, float deq, float rq,
                                         float qm) {
  return quantize(__fmul_rn(static_cast<float>(acc), deq), rq, qm);
}

}  // namespace repro
