// Winograd-domain batched int8 GEMM (K2) for Hopper (sm_90a), with the
// optional Hadamard-requant epilogue.
//
// Replaces the Pallas TPU kernel src/repro/kernels/wino_gemm.py:wino_gemm
// (_gemm_kernel, _gemm_requant_kernel): for each of the P = n^2 Winograd
// positions, out[p] = x[p] @ w[p] with x (P,M,K) int8, w (P,K,N) int8 and
// int32 accumulation; with the epilogue, each accumulator becomes
// clip(rint(f32(acc) * deq[p] / rq[p]), +-qm), stored as int32 on that grid.
//
// What bounds it on an H100: memory. At the serving path's shapes (K, N
// <= 512, M = tiles) the int32 output alone is 4*P*M*N bytes, about 80 %
// of what the kernel must move, against 2*P*M*N*K int8 operations: a few
// microseconds at the tensor cores' rate, tens of microseconds of bytes.
//
// Design:
// * A block owns a 128 x 64 tile of (rows, columns) at PB consecutive
//   positions, 8 warps, and runs the int8 tensor-core mainloop it shares
//   with K4 (int8_mma.cuh: mma.sync m16n8k32 s8, a 4-stage cp.async ring
//   of 64-deep slabs, u_q turned K-major with __byte_perm transposes, a
//   byte path for unaligned rows such as the stem's Cin = 3, zero-filled
//   ragged edges) over the 1 to 8 slabs of K of each position in turn.
//   The ring runs on across positions, so the next position's slabs land
//   while this one's rows are stored: at Cin <= 64 (one slab a
//   position) a block of one position would wait out a whole load before
//   its only product.
// * The grid puts the column tiles of one row tile next to each other,
//   so blocks that run together share their x rows in L2; the groups of
//   positions are the grid's y. The host picks PB per shape: up to four
//   slabs a block, as long as the grid fills the card
//   (kernels/wino_gemm.py:gemm_positions). A 64 x 64 tile was slower at
//   every main-path shape.
// * The epilogue runs in registers: the requant (common.cuh's requant,
//   the IEEE operations of requant_plane), then one shuffle between lane
//   pairs turns each thread's two 8-byte fragment rows into one 16-byte
//   row piece, stored whole, so each store instruction fills whole
//   32-byte sectors. Several blocks share an SM, so one block's stores
//   overlap another's loads.

#include "int8_mma.cuh"

namespace {

template <int BT, int BC, int WGT, int WGC,
          int NT = repro::WarpTiling<BT, BC, WGT, WGC>::NT>
__global__ void __launch_bounds__(NT, 2)
wino_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 int32_t* __restrict__ out, int P, int M, int N, int K,
                 const float* __restrict__ deq, const float* __restrict__ rq,
                 int qm, int pb) {
  using W = repro::WarpTiling<BT, BC, WGT, WGC>;
  constexpr int WT = W::WT, WC = W::WC, FM = W::FM, FN = W::FN;
  extern __shared__ __align__(16) unsigned char smem[];

  const int p0 = blockIdx.y * pb;
  const int np = P - p0 < pb ? P - p0 : pb;
  const int col_tiles = (N + BC - 1) / BC;
  const int t0 = static_cast<int>(blockIdx.x / col_tiles) * BT;
  const int c0 = static_cast<int>(blockIdx.x % col_tiles) * BC;
  const int8_t* xp = x + static_cast<long long>(p0) * M * K;
  const int8_t* wp = w + static_cast<long long>(p0) * K * N;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wt = warp / WGC, wc = warp % WGC;
  const float fqm = static_cast<float>(qm);
  const bool o_vec = (N % 4) == 0;
  // lane q = lane % 4 holds columns 2q, 2q+1 of rows lane/4 and lane/4 + 8;
  // after the swap with lane q ^ 1, even q holds 4 columns of the first
  // row, odd q 4 columns of the second
  const int q = lane % 4;
  const bool even = (q & 1) == 0;
  const int row_in = lane / 4 + (even ? 0 : 8);
  const int col_in = (q & 2) * 2;

  repro::gemm_slabs<BT, BC, WGT, WGC>(
      smem, xp, wp, M, K, N, np, t0, c0,
      [&](int p, const int(&acc)[FM][FN][4]) {
        int32_t* op = out + static_cast<long long>(p0 + p) * M * N;
        const float dq = qm > 0 ? deq[p0 + p] : 0.f;
        const float r = qm > 0 ? rq[p0 + p] : 1.f;
#pragma unroll
        for (int fm = 0; fm < FM; ++fm) {
          const int row = t0 + wt * WT + fm * 16 + row_in;
#pragma unroll
          for (int fn = 0; fn < FN; ++fn) {
            int v[4];
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[e] = qm > 0 ? static_cast<int>(repro::requant(
                                  acc[fm][fn][e], dq, r, fqm))
                            : acc[fm][fn][e];
            const int s0 = __shfl_xor_sync(0xffffffffu, even ? v[2] : v[0], 1);
            const int s1 = __shfl_xor_sync(0xffffffffu, even ? v[3] : v[1], 1);
            const int4 o = even ? make_int4(v[0], v[1], s0, s1)
                                : make_int4(s0, s1, v[2], v[3]);
            const int col = c0 + wc * WC + fn * 8 + col_in;
            if (row >= M || col >= N) continue;
            int32_t* dst = op + static_cast<long long>(row) * N + col;
            if (o_vec) {          // N % 4 == 0: col + 4 <= N, 16-byte aligned
              *reinterpret_cast<int4*>(dst) = o;
            } else {
              dst[0] = o.x;
              if (col + 1 < N) dst[1] = o.y;
              if (col + 2 < N) dst[2] = o.z;
              if (col + 3 < N) dst[3] = o.w;
            }
          }
        }
      });
}

template <int BT, int BC, int WGT, int WGC>
int launch(const int8_t* x, const int8_t* w, int32_t* out, int P, int M,
           int N, int K, const float* deq, const float* rq, int qm, int pb,
           cudaStream_t stream) {
  constexpr int NT = repro::WarpTiling<BT, BC, WGT, WGC>::NT;
  constexpr int smem = repro::mainloop_bytes<BT, BC, NT>();
  // set once per device (a host call that costs about a small launch)
  static bool smem_set[repro::kMaxDevices] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= repro::kMaxDevices)
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(wino_gemm_kernel<BT, BC, WGT, WGC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
  const long long blocks =
      static_cast<long long>((M + BT - 1) / BT) * ((N + BC - 1) / BC);
  const int groups = (P + pb - 1) / pb;
  if (blocks > 0x7fffffffLL || groups > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(static_cast<unsigned>(blocks), groups);
  wino_gemm_kernel<BT, BC, WGT, WGC><<<grid, NT, smem, stream>>>(
      x, w, out, P, M, N, K, deq, rq, qm, pb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (P, M, K) int8, w (P, K, N) int8 -> out (P, M, N) int32, K >= 1. With
// qm > 0 the requant epilogue runs with deq/rq (P) f32 (may be null
// otherwise). pb is the positions a block takes in turn. Returns
// cudaGetLastError().
extern "C" int wino_gemm(const int8_t* x, const int8_t* w, int32_t* out,
                         int P, int M, int N, int K, const float* deq,
                         const float* rq, int qm, int pb,
                         cudaStream_t stream) {
  if (P == 0 || M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  if (K < 1 || qm < 0 || pb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<128, 64, 4, 2>(x, w, out, P, M, N, K, deq, rq, qm, pb,
                               stream);
}
