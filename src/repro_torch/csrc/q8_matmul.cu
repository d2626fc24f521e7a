// w8a8 quantized matmul with the symmetric dequant epilogue (K5) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/q8_matmul.py:q8_matmul
// (_q8_kernel): out = f32(x_q @ w_q) * s_x * s_w[col], cast to the output
// type, with x_q (M,K) int8, w_q (K,N) int8, int32 accumulation over K, a
// per-tensor s_x and a per-output-column s_w. The TPU kernel carries its
// int32 accumulator across a sequential K grid axis in VMEM scratch; here
// each block loops over K itself and keeps the accumulators in registers.
//
// What bounds it on an H100: at the llama3.2-1b projection shapes with a
// prefill M (2048 tokens) the product does 2*M*K*N operations on
// M*K + K*N + 4*M*N bytes, far above the ~590 int8 operations per byte
// where the tensor cores stop being the limit, so operations bound it
// (at the card's int8 tensor rate); at a decode M (8) the weight bytes
// bound it. This kernel, which uses no tensor cores, is bound by its own
// integer issue rate instead.
//
// Design: a plain shared-memory tiled GEMM, the template of wino_gemm.cu.
// Grid (N/64, M/64); each block stages a 64 x 32 slab of x and a 32 x 64
// slab of w (transposed, so four consecutive k of one column form one
// 32-bit word) per K step, with 8-byte global loads where the row length
// allows (K, N multiples of 8) and bounds-checked byte loads elsewhere;
// each of its 256 threads accumulates a 4 x 4 register tile with __dp4a
// (four int8 products summed into int32, exact). Zero padding of ragged
// M, K and N edges is exact in integers. The epilogue is
// fmul_rn(fmul_rn(int2float_rn(acc), s_x), s_w[n]) in the order of the
// plain version, then a round-to-nearest cast for bf16 output, so the
// result equals the plain version bit for bit. s_x is read from device
// memory: the caller never syncs on it. Tensor cores (wgmma s8) and TMA
// are later work.

#include "common.cuh"

#include <cuda_bf16.h>

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 256;
constexpr int kWords = kBK / 4;           // 32-bit words per k slab row
constexpr int kPad = kWords + 1;          // odd row stride: no bank conflicts

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);

template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
q8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ s_x, const float* __restrict__ s_w,
                 OutT* __restrict__ out, int M, int N, int K) {
  __shared__ int32_t sa[kBM][kPad];       // x slab, k-contiguous
  __shared__ int32_t sb[kBN][kPad];       // w slab, transposed
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;  // 16 x 16 threads, 4 x 4 each
  const bool x_vec = (K % 8) == 0;         // rows start 8-byte aligned
  const bool w_vec = (N % 8) == 0;

  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    {  // x slab: row tid / 4, 8 consecutive k
      const int r = tid / 4, kc = (tid % 4) * 8;
      const int m = m0 + r, k = k0 + kc;
      if (x_vec && m < M && k < K) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            x + static_cast<long long>(m) * K + k);
        sa[r][kc / 4] = static_cast<int32_t>(v.x);
        sa[r][kc / 4 + 1] = static_cast<int32_t>(v.y);
      } else {
        int8_t* dst = reinterpret_cast<int8_t*>(&sa[r][0]) + kc;
#pragma unroll
        for (int i = 0; i < 8; ++i)
          dst[i] = (m < M && k + i < K)
                       ? x[static_cast<long long>(m) * K + k + i] : 0;
      }
    }
    {  // w slab: k row tid / 8, 8 consecutive n, stored transposed
      const int kr = tid / 8, nc = (tid % 8) * 8;
      const int k = k0 + kr, nn = n0 + nc;
      int8_t b[8];
      if (w_vec && k < K && nn < N) {
        const uint2 v = *reinterpret_cast<const uint2*>(
            w + static_cast<long long>(k) * N + nn);
#pragma unroll
        for (int i = 0; i < 8; ++i)   // byte i of the little-endian pair
          b[i] = static_cast<int8_t>((i < 4 ? v.x : v.y) >> (8 * (i % 4)));
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          b[i] = (k < K && nn + i < N)
                     ? w[static_cast<long long>(k) * N + nn + i] : 0;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
        reinterpret_cast<int8_t*>(&sb[nc + i][0])[kr] = b[i];
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kWords; ++kw) {
      int a[4], bw[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sa[tm * 4 + i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) bw[j] = sb[tn * 4 + j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float sx = *s_x;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tn * 4 + j;
      if (nn >= N) continue;
      const float v =
          __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), sx), s_w[nn]);
      out[static_cast<long long>(m) * N + nn] = to_out<OutT>(v);
    }
  }
}

template <typename OutT>
int launch(const int8_t* x, const int8_t* w, const float* s_x,
           const float* s_w, void* out, int M, int N, int K,
           cudaStream_t stream) {
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  q8_matmul_kernel<OutT><<<grid, kThreads, 0, stream>>>(
      x, w, s_x, s_w, static_cast<OutT*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) int8, w (K, N) int8, s_x (1) f32, s_w (N) f32 -> out (M, N),
// f32 when out_bf16 == 0, else bf16. x and w are 8-byte aligned (the
// wrapper checks 16). Returns cudaGetLastError().
extern "C" int q8_matmul(const int8_t* x, const int8_t* w, const float* s_x,
                         const float* s_w, void* out, int M, int N, int K,
                         int out_bf16, cudaStream_t stream) {
  if (out_bf16)
    return launch<__nv_bfloat16>(x, w, s_x, s_w, out, M, N, K, stream);
  return launch<float>(x, w, s_x, s_w, out, M, N, K, stream);
}
