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
// What bounds it on an H100: not the int8 product. At B = 256 a layer
// moves 3-30 MB (Xq and u_q read once, the f32 output written once), so
// bytes bound it at 7-31 us a layer; but the epilogue's sandwiches, kept
// in the staged kernels' exact order of non-fused fp32 multiplies and
// adds (3,728 per (t, cout) at F(4,3) with the base change, the rq scale
// included), need about 30 G fp32 instructions per forward: ~0.9 ms at
// 33.5 T/s, above the byte bound. So the design keeps the GEMM and the staging out of the
// epilogue's way and feeds the epilogue its terms with vector loads.
//
// Design:
// * A block owns a BT x BC tile of (tiles, output channels), 8 warps
//   (4 for the 16 x 32 tile), and loops over "slabs" (p, 64-deep k) of
//   all P positions. The GEMM runs on the int8 tensor cores, mma.sync
//   m16n8k32 s8.s8.s32 (each warp owns a 16 x WC piece: WC/8 fragments).
//   wgmma is not used: its 64-row warpgroup tile times P positions of
//   stash would not fit shared memory, and the tensor rate is not what
//   bounds this kernel. Registers are capped at 128 a thread, so 16
//   warps share an SM and one block's staging overlaps another's math.
// * The GEMM phase is the mainloop of int8_mma.cuh, which K2 shares:
//   a 4-stage cp.async ring of 64-deep slabs, u_q turned K-major in
//   shared memory with __byte_perm 4 x 4 transposes, a byte path for
//   unaligned rows (the stem's Cin = 3) and zero-filled ragged edges.
// * A finished position is requantized in registers (common.cuh's
//   requant) and parked in a shared stash: as int16 grid values with the
//   Hadamard stage on (|q| <= 255), as f32 acc * deq[p] with it off. The
//   host picks (BT, BC) per shape so that the stash fits and the grid
//   fills 132 SMs (kernels/fused_serve.py:fused_tile).
// * The sandwich term tables L[a][j] * Rt[b][k] come from the wrapper,
//   made once a call by two small torch multiplies (the same IEEE
//   products as __fmul_rn) instead of by every block, laid out
//   [j][k][a][b]; each block copies them in with 16-byte loads.
// * The epilogue runs each (t, cout) in one thread. Every output's sum
//   keeps the staged kernels' order (j outer, k inner; two contractions
//   at n = 8), so the output equals the staged path and the plain
//   version bit for bit, but the loops interleave all outputs' sums, so
//   the fp32 pipes see many independent add chains, and one 16-byte term
//   load feeds four products. It writes the m x m outputs with 16-byte
//   stores.

#include "int8_mma.cuh"

namespace {

// Shared memory layout: term tables, deq, rq | the mainloop's staging
// (int8_mma.cuh) | stash[P][BT][BC] (int16 with the requant on, f32 with
// it off).
template <int N, int M>
__host__ __device__ constexpr int table_bytes() {
  return repro::round16(4 * (repro::kOperandFloats<N, N> +
                             repro::kOperandFloats<N, M> + 2 * N * N));
}

template <int N, int M, int BT, int BC, int NT>
__host__ __device__ constexpr int smem_bytes(bool requant) {
  return table_bytes<N, M>() + repro::mainloop_bytes<BT, BC, NT>() +
         N * N * BT * BC * (requant ? 2 : 4);
}

// WGT warps along the tiles, WGC along the channels; 16 warps an SM
// (at most 128 registers a thread) for n <= 6. At n = 8 the 64-value
// windows need more registers than that.
template <int N, int M, int BT, int BC, int WGT, int WGC,
          int NT = 32 * WGT * WGC>
__global__ void
__launch_bounds__(NT, N <= repro::kUnrollMaxN ? 512 / NT : 1)
fused_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ uq,
             const float* __restrict__ deq, const float* __restrict__ rq,
             const float* __restrict__ tbase, const float* __restrict__ ta,
             float* __restrict__ out, int T, int K, int Cout, int qm,
             int changes_base) {
  constexpr int P = N * N;
  using W = repro::WarpTiling<BT, BC, WGT, WGC>;
  constexpr int WT = W::WT, WC = W::WC, FM = W::FM, FN = W::FN;
  constexpr int FB = repro::kOperandFloats<N, N>;
  constexpr int FA = repro::kOperandFloats<N, M>;
  static_assert(FB % 4 == 0 && FA % 4 == 0, "16-byte table copies");
  constexpr int TILE = BT * BC;
  static_assert(TILE % NT == 0, "epilogue split");

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tb = reinterpret_cast<float*>(smem);
  float* s_ta = s_tb + FB;
  float* s_deq = s_ta + FA;
  float* s_rq = s_deq + P;
  unsigned char* staging = smem + table_bytes<N, M>();
  unsigned char* stash = staging + repro::mainloop_bytes<BT, BC, NT>();
  int16_t* stash_q = reinterpret_cast<int16_t*>(stash);
  float* stash_f = reinterpret_cast<float*>(stash);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wt = warp / WGC, wc = warp % WGC;
  const int t0 = blockIdx.x * BT, c0 = blockIdx.y * BC;
  const float fqm = static_cast<float>(qm);

  if (changes_base)
    for (int i = tid; i < FB / 4; i += NT)
      reinterpret_cast<float4*>(s_tb)[i] =
          reinterpret_cast<const float4*>(tbase)[i];
  for (int i = tid; i < FA / 4; i += NT)
    reinterpret_cast<float4*>(s_ta)[i] = reinterpret_cast<const float4*>(ta)[i];
  for (int i = tid; i < P; i += NT) {
    s_deq[i] = deq[i];
    s_rq[i] = rq[i];
  }

  // the GEMM phase; a finished position is requantized and stashed
  repro::gemm_slabs<BT, BC, WGT, WGC>(
      staging, xq, uq, T, K, Cout, P, t0, c0,
      [&](int p, const int(&acc)[FM][FN][4]) {
        const float dq = s_deq[p], r = s_rq[p];
#pragma unroll
        for (int fm = 0; fm < FM; ++fm)
#pragma unroll
          for (int fn = 0; fn < FN; ++fn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = wt * WT + fm * 16 + lane / 4 + 8 * (e / 2);
              const int col = wc * WC + fn * 8 + (lane % 4) * 2 + e % 2;
              const int idx = (p * BT + row) * BC + col;
              if (qm > 0)
                stash_q[idx] = static_cast<int16_t>(
                    repro::requant(acc[fm][fn][e], dq, r, fqm));
              else
                stash_f[idx] = __fmul_rn(
                    static_cast<float>(acc[fm][fn][e]), dq);
            }
      });

  for (int i = tid; i < TILE; i += NT) {
    float h[P];
#pragma unroll
    for (int p = 0; p < P; ++p)
      h[p] = qm > 0 ? __fmul_rn(static_cast<float>(stash_q[p * TILE + i]),
                                s_rq[p])
                    : stash_f[p * TILE + i];
    float y[M * M];
    if (changes_base) {
      float z[P];
      repro::sandwich_jk<N, N>(s_tb, h, z);
      repro::sandwich_jk<N, M>(s_ta, z, y);
    } else {
      repro::sandwich_jk<N, M>(s_ta, h, y);
    }
    const int t = t0 + i / BC, c = c0 + i % BC;
    if (t >= T || c >= Cout) continue;
    float4* dst = reinterpret_cast<float4*>(
        out + (static_cast<long long>(t) * Cout + c) * M * M);
#pragma unroll
    for (int v = 0; v < M * M / 4; ++v)
      dst[v] = make_float4(y[4 * v], y[4 * v + 1], y[4 * v + 2],
                           y[4 * v + 3]);
  }
}

template <int N, int M, int BT, int BC, int WGT, int WGC>
int launch(const int8_t* xq, const int8_t* uq, const float* deq,
           const float* rq, const float* tbase, const float* ta, float* out,
           int T, int K, int Cout, int qm, int changes_base,
           cudaStream_t stream) {
  constexpr int NT = 32 * WGT * WGC;
  const int smem = smem_bytes<N, M, BT, BC, NT>(qm > 0);
  // the largest size set so far, per device (setting it is a host call
  // that costs about as much as a small launch)
  static int smem_set[repro::kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= repro::kMaxDevices)
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidDevice);
  if (smem > smem_set[dev]) {
    e = cudaFuncSetAttribute(fused_kernel<N, M, BT, BC, WGT, WGC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = smem;
  }
  const dim3 grid((T + BT - 1) / BT, (Cout + BC - 1) / BC);
  fused_kernel<N, M, BT, BC, WGT, WGC><<<grid, NT, smem, stream>>>(
      xq, uq, deq, rq, tbase, ta, out, T, K, Cout, qm, changes_base);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int M>
int launch_tile(int bt, int bc, const int8_t* xq, const int8_t* uq,
                const float* deq, const float* rq, const float* tbase,
                const float* ta, float* out, int T, int K, int Cout, int qm,
                int changes_base, cudaStream_t stream) {
  if (bt == 32 && bc == 32)
    return launch<N, M, 32, 32, 2, 4>(xq, uq, deq, rq, tbase, ta, out, T, K,
                                      Cout, qm, changes_base, stream);
  if (bt == 16 && bc == 32)
    return launch<N, M, 16, 32, 1, 4>(xq, uq, deq, rq, tbase, ta, out, T, K,
                                      Cout, qm, changes_base, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// xq (P, T, K) int8, uq (P, K, Cout) int8, deq/rq (P) f32 -> out
// (T, Cout, m, m) f32, with P = n*n and m = n - 2. tbase / ta are the
// sandwich operands of the base change (n x n) and of A (m x n): for
// n <= 6 the products L[a][j] * L[b][k] laid out [j][k][a][b], for n = 8
// L twice (tbase unused when changes_base is 0). qm > 0 turns on the Hadamard requant onto the +-qm grid (qm <= 255);
// qm = 0 leaves it off (rq is then unused). (bt, bc) is the block tile,
// one of (32, 32), (16, 32). Returns cudaGetLastError().
extern "C" int fused_gemm_output(const int8_t* xq, const int8_t* uq,
                                 const float* deq, const float* rq,
                                 const float* tbase, const float* ta,
                                 float* out, int n, int T, int K, int Cout,
                                 int qm, int changes_base, int bt, int bc,
                                 cudaStream_t stream) {
  if (T == 0 || Cout == 0) return static_cast<int>(cudaGetLastError());
  if (qm < 0 || qm > 32767) return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    case 4:
      return launch_tile<4, 2>(bt, bc, xq, uq, deq, rq, tbase, ta, out, T,
                               K, Cout, qm, changes_base, stream);
    case 6:
      return launch_tile<6, 4>(bt, bc, xq, uq, deq, rq, tbase, ta, out, T,
                               K, Cout, qm, changes_base, stream);
    case 8:
      return launch_tile<8, 6>(bt, bc, xq, uq, deq, rq, tbase, ta, out, T,
                               K, Cout, qm, changes_base, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
