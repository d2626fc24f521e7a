// Fused int8 serving kernel (K4) for Hopper (sm_90a): per-position GEMM
// -> Hadamard requant -> output transform in one pass.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/fused_serve.py:fused_gemm_output (_fused_kernel):
// xq (P,T,Cin) int8, u_q (P,Cin,Cout) int8, deq/rq (P) f32
// -> (T,Cout,m,m) f32. For each (t, cout) and position p it accumulates
// acc = sum_k xq[p,t,k] * u_q[p,k,cout] in int32, requantizes it onto the
// 8/9-bit grid (requant_plane) and rescales by rq[p] -- or, with the
// Hadamard stage off, dequantizes by deq[p] -- and once all P positions
// are in, runs the output-transform sandwiches C^-T(.)C^-1 and A_C^T(.)A_C.
// No intermediate reaches device memory.
//
// What bounds it on an H100: memory. It reads Xq and u_q once and writes
// the f32 output once; at B = 256 a 64-channel layer moves ~105 MB for
// ~4.8 GOP of int8 work, well under the 1,979 TOP/s int8 tensor rate per
// byte at 3.35 TB/s. Without tensor cores this kernel is bound by its own
// integer issue rate (__dp4a) instead.
//
// Design: the TPU schedule keeps a (P, bm, bn) int32 accumulator across
// the K grid (2.25 MiB at P = 36), far over the 227 KB a block may hold.
// Here the loop order changes instead: a block owns 8 tiles x 32 output
// channels (one (t, cout) per thread, a warp spans 32 channels of one
// tile) and loops over positions p, with the K loop inside, staging the
// 8 x 64 Xq slab and the 64 x 32 u_q slab of (p, k) in shared memory
// (u_q transposed so four k of one channel form one word for __dp4a).
// Each finished position's requantized value goes to a per-thread column
// of a P x 256 float stash in dynamic shared memory (36 KB at P = 36);
// after the last position each thread runs the sandwiches on its P values
// in registers and writes its m x m outputs with 16-byte stores. The
// requant and the sandwiches are the same IEEE operations in the same
// order as the staged kernels, so the Hadamard plane is exact against the
// staged path and the f32 output equal to it bit for bit.

#include "common.cuh"

namespace {

constexpr int kTT = 8, kTC = 32, kBK = 64;
constexpr int kThreads = kTT * kTC;
constexpr int kWords = kBK / 4;
constexpr int kPad = kWords + 1;

template <int N, int M>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ uq,
             const float* __restrict__ deq, const float* __restrict__ rq,
             const float* __restrict__ cinvt, const float* __restrict__ apt,
             float* __restrict__ out, int T, int K, int Cout, int qm,
             int changes_base) {
  constexpr int P = N * N;
  extern __shared__ float stash[];                   // [P][kThreads]
  __shared__ float sm_base[repro::kOperandFloats<N, N>];
  __shared__ float sm_a[repro::kOperandFloats<N, M>];
  __shared__ int32_t sa[kTT][kPad];
  __shared__ int32_t sb[kTC][kPad];
  if (changes_base) repro::load_operand<N, N>(cinvt, cinvt, sm_base);
  repro::load_operand<N, M>(apt, apt, sm_a);

  const int tid = threadIdx.x;
  const int ty = tid / kTC, tx = tid % kTC;
  const int t0 = blockIdx.x * kTT, c0 = blockIdx.y * kTC;
  const float fqm = static_cast<float>(qm);

  for (int p = 0; p < P; ++p) {
    const int8_t* xp = xq + static_cast<long long>(p) * T * K;
    const int8_t* up = uq + static_cast<long long>(p) * K * Cout;
    int acc = 0;
    for (int k0 = 0; k0 < K; k0 += kBK) {
      {  // Xq slab: 8 tiles x 64 k, 2 bytes a thread
        const int r = tid / 32, kc = (tid % 32) * 2;
        int8_t* dst = reinterpret_cast<int8_t*>(&sa[r][0]) + kc;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int t = t0 + r, k = k0 + kc + i;
          dst[i] = (t < T && k < K) ? xp[static_cast<long long>(t) * K + k]
                                    : 0;
        }
      }
      {  // u_q slab: 64 k x 32 channels, 8 bytes a thread, transposed
        const int kr = tid / 4, cc = (tid % 4) * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int k = k0 + kr, c = c0 + cc + i;
          reinterpret_cast<int8_t*>(&sb[cc + i][0])[kr] =
              (k < K && c < Cout) ? up[static_cast<long long>(k) * Cout + c]
                                  : 0;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < kWords; ++kw)
        acc = __dp4a(sa[ty][kw], sb[tx][kw], acc);
      __syncthreads();
    }
    stash[p * kThreads + tid] =
        qm > 0 ? __fmul_rn(repro::requant(acc, deq[p], rq[p], fqm), rq[p])
               : __fmul_rn(static_cast<float>(acc), deq[p]);
  }

  const int t = t0 + ty, c = c0 + tx;
  if (t >= T || c >= Cout) return;
  float h[P];
#pragma unroll
  for (int p = 0; p < P; ++p) h[p] = stash[p * kThreads + tid];
  float y[M * M];
  if (changes_base) {
    float z[P];
    repro::sandwich<N, N>(sm_base, h, z);
    repro::sandwich<N, M>(sm_a, z, y);
  } else {
    repro::sandwich<N, M>(sm_a, h, y);
  }
  float4* dst = reinterpret_cast<float4*>(
      out + (static_cast<long long>(t) * Cout + c) * M * M);
#pragma unroll
  for (int i = 0; i < M * M / 4; ++i)
    dst[i] = make_float4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
}

template <int N, int M>
int launch(const int8_t* xq, const int8_t* uq, const float* deq,
           const float* rq, const float* cinvt, const float* apt, float* out,
           int T, int K, int Cout, int qm, int changes_base,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * N * N * kThreads;
  cudaError_t e = cudaFuncSetAttribute(
      fused_kernel<N, M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((T + kTT - 1) / kTT, (Cout + kTC - 1) / kTC);
  fused_kernel<N, M><<<grid, kThreads, smem, stream>>>(
      xq, uq, deq, rq, cinvt, apt, out, T, K, Cout, qm, changes_base);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xq (P, T, K) int8, uq (P, K, Cout) int8, deq/rq (P) f32, cinvt (n, n),
// apt (m, n) f32 -> out (T, Cout, m, m) f32, with P = n*n and m = n - 2.
// qm > 0 turns on the Hadamard requant onto the +-qm grid; qm = 0 leaves
// it off (rq is then unused). Returns cudaGetLastError().
extern "C" int fused_gemm_output(const int8_t* xq, const int8_t* uq,
                                 const float* deq, const float* rq,
                                 const float* cinvt, const float* apt,
                                 float* out, int n, int T, int K, int Cout,
                                 int qm, int changes_base,
                                 cudaStream_t stream) {
  if (T == 0 || Cout == 0) return static_cast<int>(cudaGetLastError());
  switch (n) {
    case 4:
      return launch<4, 2>(xq, uq, deq, rq, cinvt, apt, out, T, K, Cout, qm,
                          changes_base, stream);
    case 6:
      return launch<6, 4>(xq, uq, deq, rq, cinvt, apt, out, T, K, Cout, qm,
                          changes_base, stream);
    case 8:
      return launch<8, 6>(xq, uq, deq, rq, cinvt, apt, out, T, K, Cout, qm,
                          changes_base, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
