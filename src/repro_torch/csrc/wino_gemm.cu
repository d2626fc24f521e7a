// Winograd-domain batched int8 GEMM (K2) for Hopper (sm_90a), with the
// optional Hadamard-requant epilogue.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wino_gemm.py:wino_gemm
// (_gemm_kernel, _gemm_requant_kernel): for each of the P = n^2 Winograd
// positions, out[p] = x[p] @ w[p] with x (P,M,K) int8, w (P,K,N) int8 and
// int32 accumulation; with the epilogue, each accumulator becomes
// clip(rint(f32(acc) * deq[p] / rq[p]), +-qm), stored as int32 on that grid.
//
// What bounds it on an H100: at the serving path's shapes (K, N <= 512,
// M = tiles) the int8 work per byte moved is low -- the int32 output alone
// is 4*P*M*N bytes against 2*P*M*N*K operations -- so memory bounds it at
// the card's int8 tensor rate; this kernel, which uses no tensor cores, is
// bound by its own integer issue rate instead.
//
// Design: a plain shared-memory tiled GEMM. Grid (N/64, M/64, P); each
// block stages a 64 x 32 slab of x and a 32 x 64 slab of w (transposed, so
// four consecutive k of one column form one 32-bit word) per K step, and
// each of its 256 threads accumulates a 4 x 4 register tile with __dp4a
// (four int8 products summed into int32, exact). The requant epilogue runs
// on the accumulators after the last K step, with the same IEEE operations
// as requant_plane. Zero padding of ragged edges is exact in integers.
// Tensor cores (wgmma s8) and TMA are later work.

#include "common.cuh"

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kThreads = 256;
constexpr int kWords = kBK / 4;           // 32-bit words per k slab row
constexpr int kPad = kWords + 1;          // odd row stride: no bank conflicts

__global__ void __launch_bounds__(kThreads)
wino_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int32_t* __restrict__ out, int M, int N, int K,
                 const float* __restrict__ deq, const float* __restrict__ rq,
                 int qm) {
  __shared__ int32_t sa[kBM][kPad];       // x slab, k-contiguous
  __shared__ int32_t sb[kBN][kPad];       // w slab, transposed
  const int p = blockIdx.z;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  const int tm = tid / 16, tn = tid % 16;  // 16 x 16 threads, 4 x 4 each
  const int8_t* xp = x + static_cast<long long>(p) * M * K;
  const int8_t* wp = w + static_cast<long long>(p) * K * N;

  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    {  // x slab: row tid / 4, 8 consecutive k
      const int r = tid / 4, kc = (tid % 4) * 8;
      int8_t* dst = reinterpret_cast<int8_t*>(&sa[r][0]) + kc;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + r, k = k0 + kc + i;
        dst[i] = (m < M && k < K) ? xp[static_cast<long long>(m) * K + k] : 0;
      }
    }
    {  // w slab: k row tid / 8, 8 consecutive n, stored transposed
      const int kr = tid / 8, nc = (tid % 8) * 8;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = k0 + kr, nn = n0 + nc + i;
        reinterpret_cast<int8_t*>(&sb[nc + i][0])[kr] =
            (k < K && nn < N) ? wp[static_cast<long long>(k) * N + nn] : 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kWords; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sa[tm * 4 + i][kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = sb[tn * 4 + j][kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  int32_t* op = out + static_cast<long long>(p) * M * N;
  const float fqm = static_cast<float>(qm);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int nn = n0 + tn * 4 + j;
      if (nn >= N) continue;
      int32_t v = acc[i][j];
      if (qm > 0)
        v = static_cast<int32_t>(repro::requant(v, deq[p], rq[p], fqm));
      op[static_cast<long long>(m) * N + nn] = v;
    }
  }
}

}  // namespace

// x (P, M, K) int8, w (P, K, N) int8 -> out (P, M, N) int32. With qm > 0
// the requant epilogue runs with deq/rq (P) f32 (may be null otherwise).
// Returns cudaGetLastError().
extern "C" int wino_gemm(const int8_t* x, const int8_t* w, int32_t* out,
                         int P, int M, int N, int K, const float* deq,
                         const float* rq, int qm, cudaStream_t stream) {
  if (P == 0 || M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, P);
  wino_gemm_kernel<<<grid, kThreads, 0, stream>>>(x, w, out, M, N, K, deq,
                                                   rq, qm);
  return static_cast<int>(cudaGetLastError());
}
