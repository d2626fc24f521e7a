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

// Windows up to this size run the sandwich from a term table (j outer,
// k inner, the JAX kernels' unrolled order); larger windows (F(6,3):
// n = 8) run two contractions, as the JAX kernels do.
constexpr int kUnrollMaxN = 6;

// Floats of shared memory one sandwich operand takes.
//   NI <= 6: the table term[j][k][a][b] = L[a][j] * Rt[b][k];
//   NI  > 6: L (NO x NI) followed by Rt (NO x NI).
template <int NI, int NO>
constexpr int kOperandFloats =
    NI <= kUnrollMaxN ? NO * NO * NI * NI : 2 * NO * NI;

// cp.async of `bytes` (4 or 16) that reads `valid` bytes (all or 0) and
// zero-fills the rest; commit closes a group, wait<Pending> returns once
// at most Pending of this thread's groups are still in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Fill one sandwich operand in shared memory from the (NO x NI) row-major
// matrices L and Rt in device memory: for NI <= 6 the table
// term[j][k][a][b] = L[a][j] * Rt[b][k] (K4's wrapper makes the same table
// with torch: fused_serve._terms); for NI > 6 L and Rt as they are. All
// threads of the block take part; the caller synchronises afterwards.
template <int NI, int NO>
__device__ void load_terms(const float* __restrict__ L,
                           const float* __restrict__ Rt, float* sm) {
  if constexpr (NI <= kUnrollMaxN) {
    for (int i = threadIdx.x; i < NO * NO * NI * NI; i += blockDim.x) {
      const int b = i % NO, a = (i / NO) % NO;
      const int k = (i / (NO * NO)) % NI, j = i / (NO * NO * NI);
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
// window held in registers, for the windows too large for the table form
// (NI > 6), as two contractions, as the JAX kernels run them:
// t[a][k] = sum_j L[a][j] x[j][k], then out[a][b] = sum_k t[a][k] Rt[b][k],
// each sum in ascending index order. sm holds L, then Rt (load_terms).
template <int NI, int NO>
__device__ __forceinline__ void sandwich(const float* __restrict__ sm,
                                         const float (&x)[NI * NI],
                                         float (&out)[NO * NO]) {
  static_assert(NI > kUnrollMaxN, "windows up to 6 x 6 take the table form");
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

// out[w][a][b] = sum_{j,k} x[w][j][k] * term[j][k][a][b] for W NI x NI
// windows, from the [j][k][a][b] table of load_terms. Each output's sum
// runs j outer and k inner, each term x[j][k] * (L[a][j] * Rt[b][k]) --
// the order of the JAX kernels' _sandwich_unrolled and of the plain
// version (wino_transform.sandwich), so the result is the same bit for
// bit -- G outputs at a time: for each group of G outputs, (j, k) runs
// outside and the W x G sums inside, so one 16-byte table load feeds
// 4 * W products and only W * G sums are live.
// emit(g, acc) takes group g's sums, acc[w][e] for output g * G + e of
// window w, as soon as they are complete. The loop over groups stays
// rolled: unrolled, one sandwich at n = 6 is ~8,000 instructions, and a
// kernel of two no longer fits the SM's instruction cache.
template <int NI, int NO, int W, int G, class Emit>
__device__ __forceinline__ void sandwich_terms_grouped(
    const float* __restrict__ sm, const float (&x)[W][NI * NI],
    Emit&& emit) {
  static_assert(G % 4 == 0 && (NO * NO) % G == 0, "16-byte groups");
#pragma unroll 1
  for (int g = 0; g < NO * NO / G; ++g) {
    float acc[W][G];
#pragma unroll
    for (int jk = 0; jk < NI * NI; ++jk) {
      const float4* term =
          reinterpret_cast<const float4*>(sm + jk * NO * NO + g * G);
#pragma unroll
      for (int c4 = 0; c4 < G / 4; ++c4) {
        const float4 tv = term[c4];
        const float tab[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
        for (int w = 0; w < W; ++w)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * c4 + e;
            acc[w][i] = jk == 0
                            ? __fmul_rn(x[w][0], tab[e])
                            : __fadd_rn(acc[w][i], __fmul_rn(x[w][jk], tab[e]));
          }
      }
    }
    emit(g, acc);
  }
}

// Whether the Legendre base change C^-T (the L of the first output-
// transform sandwich) can have a nonzero at (a, j): x^j enters the
// Legendre polynomial P_a only for j <= a with a - j even.
__host__ __device__ constexpr bool legendre_nonzero(int a, int j) {
  return j <= a && (a - j) % 2 == 0;
}

// out[a][b] = sum_{j,k} x[j][k] * (L[a][j] * L[b][k]) over the terms
// whose L[a][j] and L[b][k] may be nonzero in the Legendre base change
// (legendre_nonzero), each sum j outer, k inner: at n = 6, 144 of the
// 1,296 terms. The terms are the products that load_terms tabulates,
// made here from l, L's entries held in registers. Leaving out a zero
// term x * (+-0) of a finite x changes no partial sum's value, only,
// where the sum is zero, maybe its sign: an output that is not zero is
// sandwich_terms's bit for bit, and the caller redoes a window with a
// zero output in full.
template <int NI>
__device__ __forceinline__ void sandwich_legendre(const float (&l)[NI * NI],
                                                  const float (&x)[NI * NI],
                                                  float (&out)[NI * NI]) {
#pragma unroll
  for (int a = 0; a < NI; ++a)
#pragma unroll
    for (int b = 0; b < NI; ++b) {
      float acc = 0.f;
      bool first = true;
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int k = 0; k < NI; ++k) {
          if (!legendre_nonzero(a, j) || !legendre_nonzero(b, k)) continue;
          const float p =
              __fmul_rn(x[j * NI + k], __fmul_rn(l[a * NI + j], l[b * NI + k]));
          acc = first ? p : __fadd_rn(acc, p);
          first = false;
        }
      out[a * NI + b] = acc;
    }
}

// out[a][b] = sum_{j,k} x[j][k] * term[j][k][a][b] over one NI x NI
// window, all NO^2 outputs in one group: NO^2 independent add chains in
// flight, and each 16-byte load of the table feeds four products.
template <int NI, int NO>
__device__ __forceinline__ void sandwich_terms(const float* __restrict__ sm,
                                               const float (&x)[NI * NI],
                                               float (&out)[NO * NO]) {
  sandwich_terms_grouped<NI, NO, 1, NO * NO>(
      sm, reinterpret_cast<const float(&)[1][NI * NI]>(x),
      [&](int, const float(&acc)[1][NO * NO]) {
#pragma unroll
        for (int ab = 0; ab < NO * NO; ++ab) out[ab] = acc[0][ab];
      });
}

// One sandwich from an operand that load_terms (or the wrapper) laid out:
// the table form for NI <= 6, the two contractions of repro::sandwich (L
// and Rt as they are) for NI = 8.
template <int NI, int NO>
__device__ __forceinline__ void sandwich_jk(const float* __restrict__ sm,
                                            const float (&x)[NI * NI],
                                            float (&out)[NO * NO]) {
  if constexpr (NI <= kUnrollMaxN)
    sandwich_terms<NI, NO>(sm, x, out);
  else
    sandwich<NI, NO>(sm, x, out);
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
