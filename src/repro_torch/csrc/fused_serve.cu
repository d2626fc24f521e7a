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
// * Staging is a 4-stage ring with one barrier per slab, three slabs in
//   flight: the Xq slab (K-major already) lands through 16-byte
//   cp.async; the u_q slab is N-major, and mma wants B K-major, so each
//   thread cp.asyncs its own 4 x 4 byte blocks (4 rows x 4 channels),
//   and once they are in, turns them with __byte_perm transposes into a
//   double-buffered K-major slab. Rows that are not 16-byte aligned (the
//   stem's Cin = 3, ragged Cin) are read byte by byte into registers one
//   slab ahead; ragged T, Cin and Cout edges are zero-filled, exact in
//   integers. Shared rows are padded to 80 bytes, so fragment loads hit
//   32 banks.
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

#include "common.cuh"

namespace {

constexpr int kBK = 64;          // k bytes per slab
constexpr int kRow = kBK + 16;   // padded shared row, bytes
constexpr int kStages = 4;       // slabs in flight

__host__ __device__ constexpr int round16(int b) { return (b + 15) / 16 * 16; }

// Shared memory layout: term tables, deq, rq | sA[kStages][BT] Xq slabs |
// sU[kStages] raw u_q words, each thread its own | sB[2][BC] K-major u_q
// slabs | stash[P][BT][BC] (int16 with the requant on, f32 with it off).
template <int N, int M>
__host__ __device__ constexpr int table_bytes() {
  return round16(4 * (repro::kOperandFloats<N, N> +
                      repro::kOperandFloats<N, M> + 2 * N * N));
}

// 4 x 4 byte blocks of one u_q slab per thread of NT.
template <int BC, int NT>
__host__ __device__ constexpr int u_blocks() {
  return ((kBK / 4) * (BC / 4) + NT - 1) / NT;
}

template <int N, int M, int BT, int BC, int NT>
__host__ __device__ constexpr int smem_bytes(bool requant) {
  return table_bytes<N, M>() + kStages * BT * kRow +
         kStages * u_blocks<BC, NT>() * NT * 16 + 2 * BC * kRow +
         N * N * BT * BC * (requant ? 2 : 4);
}

// cp.async of `bytes` (4 or 16) that reads `valid` bytes (all or 0) and
// zero-fills the rest.
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

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// r[i] holds bytes (row i, columns 0..3); on return r[j] holds bytes
// (rows 0..3, column j).
__device__ __forceinline__ void transpose4x4(uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// out[a][b] = sum_{j,k} x[j][k] * term[j][k][a][b] over one NI x NI
// window. Each output's sum runs j outer and k inner (repro::sandwich's
// unrolled order, so the result is the same bit for bit), but the loop
// nest puts (j, k) outside and the NO^2 outputs inside: NO^2 independent
// add chains in flight, and each 16-byte load of the [j][k][a][b] table
// feeds four products.
template <int NI, int NO>
__device__ __forceinline__ void sandwich_terms(const float* __restrict__ sm,
                                               const float (&x)[NI * NI],
                                               float (&out)[NO * NO]) {
#pragma unroll
  for (int jk = 0; jk < NI * NI; ++jk) {
    const float4* term = reinterpret_cast<const float4*>(sm + jk * NO * NO);
#pragma unroll
    for (int c4 = 0; c4 < NO * NO / 4; ++c4) {
      const float4 tv = term[c4];
      const float tab[4] = {tv.x, tv.y, tv.z, tv.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ab = 4 * c4 + e;
        out[ab] = jk == 0 ? __fmul_rn(x[0], tab[e])
                          : __fadd_rn(out[ab], __fmul_rn(x[jk], tab[e]));
      }
    }
  }
}

// One sandwich: the table form for NI <= 6, the two contractions of
// repro::sandwich (L and Rt as they are) for NI = 8.
template <int NI, int NO>
__device__ __forceinline__ void sandwich_k4(const float* __restrict__ sm,
                                            const float (&x)[NI * NI],
                                            float (&out)[NO * NO]) {
  if constexpr (NI <= repro::kUnrollMaxN)
    sandwich_terms<NI, NO>(sm, x, out);
  else
    repro::sandwich<NI, NO>(sm, x, out);
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
  constexpr int WT = BT / WGT, WC = BC / WGC;
  constexpr int FM = WT / 16, FN = WC / 8;
  static_assert(FM >= 1 && FN >= 1, "warp tiling");
  constexpr int FB = repro::kOperandFloats<N, N>;
  constexpr int FA = repro::kOperandFloats<N, M>;
  static_assert(FB % 4 == 0 && FA % 4 == 0, "16-byte table copies");
  constexpr int UB = (kBK / 4) * (BC / 4);   // 4 x 4 blocks of a u slab
  constexpr int UPT = u_blocks<BC, NT>();
  constexpr int XC = BT * (kBK / 16);        // 16-byte chunks of an Xq slab
  constexpr int XPT = (XC + NT - 1) / NT;
  constexpr int TILE = BT * BC;
  static_assert(TILE % NT == 0, "epilogue split");

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_tb = reinterpret_cast<float*>(smem);
  float* s_ta = s_tb + FB;
  float* s_deq = s_ta + FA;
  float* s_rq = s_deq + P;
  int8_t* sA = reinterpret_cast<int8_t*>(smem + table_bytes<N, M>());
  uint32_t* sU = reinterpret_cast<uint32_t*>(sA + kStages * BT * kRow);
  int8_t* sB = reinterpret_cast<int8_t*>(sU + kStages * UPT * NT * 4);
  unsigned char* stash = reinterpret_cast<unsigned char*>(sB + 2 * BC * kRow);
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

  const int nk = (K + kBK - 1) / kBK;
  const int S = P * nk;
  const bool x_vec = (K % 16) == 0;
  const bool u_vec = (Cout % 4) == 0;

  // Slab s goes to ring slot s % kStages. Xq rows and u_q words that are
  // aligned go by cp.async (zero-filled past the edges); unaligned Xq rows
  // are read byte by byte into registers and deposited at the end of the
  // next iteration (deposit_x), so their latency hides behind the product
  // too.
  // Each thread copies its own 4 x 4 u_q blocks, so after its own
  // wait_group it can transpose them with no barrier (turn_u).
  uint32_t xr0[XPT][4], xr1[XPT][4];   // unaligned Xq bytes, slabs in turn
  // the next slab to issue: its k0 and its position's planes
  int ik0 = 0;
  const int8_t* ixp = xq;
  const int8_t* iup = uq;
  auto issue = [&](int s, uint32_t(&xr)[XPT][4]) {
    const int slot = s % kStages;
    const int k0 = ik0;
    const int8_t* xp = ixp;
    const int8_t* up = iup;
    ik0 += kBK;
    if (ik0 >= K) {
      ik0 = 0;
      ixp += static_cast<long long>(T) * K;
      iup += static_cast<long long>(K) * Cout;
    }
#pragma unroll
    for (int v = 0; v < XPT; ++v) {
      const int i = tid + v * NT;
      if (i >= XC) break;
      const int r = i / (kBK / 16), kc = (i % (kBK / 16)) * 16;
      const int t = t0 + r, k = k0 + kc;
      const bool in = t < T && k < K;
      const int8_t* src = in ? xp + static_cast<long long>(t) * K + k : xq;
      if (x_vec) {
        cp_async16(sA + (slot * BT + r) * kRow + kc, src, in);
      } else {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          uint32_t word = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (in && k + 4 * w + j < K)
              word |= static_cast<uint32_t>(
                          static_cast<uint8_t>(src[4 * w + j]))
                      << (8 * j);
          xr[v][w] = word;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      const int i = tid + u * NT;
      if (i >= UB) break;
      const int kg = i / (BC / 4), cw = i % (BC / 4);
      const int c = c0 + cw * 4;
      uint32_t* dst = sU + ((slot * UPT + u) * NT + tid) * 4;
      const int8_t* row = up + static_cast<long long>(k0 + kg * 4) * Cout + c;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = k0 + kg * 4 + r;
        const bool in = k < K && c < Cout;
        const int8_t* src = in ? row + r * Cout : uq;
        if (u_vec) {
          cp_async4(dst + r, src, in);
        } else {
          uint32_t v = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (in && c + j < Cout)
              v |= static_cast<uint32_t>(static_cast<uint8_t>(src[j]))
                   << (8 * j);
          dst[r] = v;
        }
      }
    }
  };
  auto deposit_x = [&](int s, const uint32_t(&xr)[XPT][4]) {
    if (x_vec) return;
    const int slot = s % kStages;
#pragma unroll
    for (int v = 0; v < XPT; ++v) {
      const int i = tid + v * NT;
      if (i >= XC) break;
      const int r = i / (kBK / 16), kc = (i % (kBK / 16)) * 16;
      *reinterpret_cast<uint4*>(sA + (slot * BT + r) * kRow + kc) =
          make_uint4(xr[v][0], xr[v][1], xr[v][2], xr[v][3]);
    }
  };
  auto turn_u = [&](int s, int buf) {
    const int slot = s % kStages;
#pragma unroll
    for (int u = 0; u < UPT; ++u) {
      const int i = tid + u * NT;
      if (i >= UB) break;
      const int kg = i / (BC / 4), cw = i % (BC / 4);
      const uint4 w4 = *reinterpret_cast<const uint4*>(
          sU + ((slot * UPT + u) * NT + tid) * 4);
      uint32_t r[4] = {w4.x, w4.y, w4.z, w4.w};
      transpose4x4(r);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(sB + (buf * BC + cw * 4 + j) * kRow +
                                     kg * 4) = r[j];
    }
  };

  int acc[FM][FN][4];
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[fm][fn][e] = 0;

  // slab s's unaligned Xq bytes are read into xr0 (s even) or xr1 (s odd)
  // and deposited two iterations later
  static_assert(kStages == 4, "the xr0 / xr1 turns assume 4 stages");
  if (S > 0) {
    issue(0, xr0);
    deposit_x(0, xr0);
  }
  cp_async_commit();
  if (S > 1) {
    issue(1, xr1);
    deposit_x(1, xr1);
  }
  cp_async_commit();
  if (S > 2) issue(2, xr0);
  cp_async_commit();
  cp_async_wait<kStages - 2>();     // slab 0 is in (this thread's copies)
  turn_u(0, 0);
  __syncthreads();

  for (int s = 0, p = 0, k0 = 0; s < S; ++s) {   // slab s = (p, k0)
    const int buf = s & 1;
    const int slot = s % kStages;
    const bool ahead = s + kStages - 1 < S;
    if (ahead) {                       // into the slot slab s-1 freed
      if (s & 1) issue(s + 3, xr0);
      else issue(s + 3, xr1);
    }
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      if (k0 + kk >= K) break;
      uint32_t a[FM][4], b[FN][2];
#pragma unroll
      for (int fm = 0; fm < FM; ++fm) {
        const int8_t* base = sA + (slot * BT + wt * WT + fm * 16 + lane / 4) *
                                      kRow + kk + (lane % 4) * 4;
        a[fm][0] = *reinterpret_cast<const uint32_t*>(base);
        a[fm][1] = *reinterpret_cast<const uint32_t*>(base + 8 * kRow);
        a[fm][2] = *reinterpret_cast<const uint32_t*>(base + 16);
        a[fm][3] = *reinterpret_cast<const uint32_t*>(base + 8 * kRow + 16);
      }
#pragma unroll
      for (int fn = 0; fn < FN; ++fn) {
        const int8_t* base = sB + (buf * BC + wc * WC + fn * 8 + lane / 4) *
                                      kRow + kk + (lane % 4) * 4;
        b[fn][0] = *reinterpret_cast<const uint32_t*>(base);
        b[fn][1] = *reinterpret_cast<const uint32_t*>(base + 16);
      }
#pragma unroll
      for (int fm = 0; fm < FM; ++fm)
#pragma unroll
        for (int fn = 0; fn < FN; ++fn) mma_s8(acc[fm][fn], a[fm], b[fn]);
    }
    if (k0 + kBK >= K) {  // position p is complete: requant, stash
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
              stash_f[idx] = __fmul_rn(static_cast<float>(acc[fm][fn][e]),
                                       dq);
            acc[fm][fn][e] = 0;
          }
    }
    if (s + 2 < S) {                   // issued one iteration ago
      if (s & 1) deposit_x(s + 2, xr1);
      else deposit_x(s + 2, xr0);
    }
    cp_async_wait<kStages - 2>();     // slab s + 1 is in
    if (s + 1 < S) turn_u(s + 1, buf ^ 1);
    __syncthreads();
    k0 += kBK;
    if (k0 >= K) {
      k0 = 0;
      ++p;
    }
  }

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
      sandwich_k4<N, N>(s_tb, h, z);
      sandwich_k4<N, M>(s_ta, z, y);
    } else {
      sandwich_k4<N, M>(s_ta, h, y);
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
