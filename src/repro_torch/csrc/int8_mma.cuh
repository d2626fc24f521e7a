// The int8 tensor-core GEMM mainloop that K4 (fused_serve.cu) and K2
// (wino_gemm.cu) share: per-position products xq[p] (T, K) int8, K-major,
// times uq[p] (K, Cout) int8, N-major, accumulated exactly in int32.
//
// A block owns a BT x BC tile of (rows, columns) and walks "slabs" (p,
// 64-deep k) over P positions; WGT x WGC warps each own a WT x WC piece,
// mma.sync m16n8k32 s8.s8.s32 fragments (FM x FN of them).
// * Staging is a 4-stage ring with one barrier per slab, three slabs in
//   flight: the Xq slab (K-major already) lands through 16-byte cp.async;
//   the u_q slab is N-major, and mma wants B K-major, so each thread
//   cp.asyncs its own 4 x 4 byte blocks (4 rows x 4 channels) and, once
//   they are in, turns them with __byte_perm transposes into a
//   double-buffered K-major slab -- after its own wait_group, so no
//   barrier guards the turn. Rows that are not 16-byte aligned (the
//   stem's Cin = 3, ragged Cin) are read byte by byte into registers one
//   slab ahead; ragged T, K and Cout edges are zero-filled, exact in
//   integers. Shared rows are padded to 80 bytes, so fragment loads hit
//   32 banks.
// * When a position's last slab is in, the mainloop hands its
//   accumulators to the caller's epilogue, done(p, acc), and zeroes them.
#pragma once

#include "common.cuh"

namespace repro {

constexpr int kBK = 64;          // k bytes per slab
constexpr int kRow = kBK + 16;   // padded shared row, bytes
constexpr int kStages = 4;       // slabs in flight

__host__ __device__ constexpr int round16(int b) { return (b + 15) / 16 * 16; }

// 4 x 4 byte blocks of one u_q slab per thread of NT.
template <int BC, int NT>
__host__ __device__ constexpr int u_blocks() {
  return ((kBK / 4) * (BC / 4) + NT - 1) / NT;
}

// Shared memory of the mainloop: sA[kStages][BT] Xq slabs | sU[kStages]
// raw u_q words, each thread its own | sB[2][BC] K-major u_q slabs.
template <int BT, int BC, int NT>
__host__ __device__ constexpr int mainloop_bytes() {
  return kStages * BT * kRow + kStages * u_blocks<BC, NT>() * NT * 16 +
         2 * BC * kRow;
}

// The warp tiling of a BT x BC block tile over WGT x WGC warps.
template <int BT, int BC, int WGT, int WGC>
struct WarpTiling {
  static constexpr int NT = 32 * WGT * WGC;
  static constexpr int WT = BT / WGT, WC = BC / WGC;
  static constexpr int FM = WT / 16, FN = WC / 8;
  static_assert(FM >= 1 && FN >= 1, "warp tiling");
};

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

// The mainloop of one block: rows t0.. of xq and columns c0.. of uq over
// P positions, each K deep (planes T x K and K x Cout, one after another).
// `smem` holds mainloop_bytes<BT, BC, NT>() bytes, 16-byte aligned. Calls
// done(p, acc) with acc[FM][FN][4] (mma's s32 fragment layout) once
// position p is complete; every thread of the block calls it together.
template <int BT, int BC, int WGT, int WGC, class Done>
__device__ __forceinline__ void gemm_slabs(unsigned char* smem,
                                           const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ uq,
                                           int T, int K, int Cout, int P,
                                           int t0, int c0, Done&& done) {
  using W = WarpTiling<BT, BC, WGT, WGC>;
  constexpr int NT = W::NT, WT = W::WT, WC = W::WC, FM = W::FM, FN = W::FN;
  constexpr int UB = (kBK / 4) * (BC / 4);   // 4 x 4 blocks of a u slab
  constexpr int UPT = u_blocks<BC, NT>();
  constexpr int XC = BT * (kBK / 16);        // 16-byte chunks of an Xq slab
  constexpr int XPT = (XC + NT - 1) / NT;

  int8_t* sA = reinterpret_cast<int8_t*>(smem);
  uint32_t* sU = reinterpret_cast<uint32_t*>(sA + kStages * BT * kRow);
  int8_t* sB = reinterpret_cast<int8_t*>(sU + kStages * UPT * NT * 4);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wt = warp / WGC, wc = warp % WGC;

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
    if (k0 + kBK >= K) {  // position p is complete: hand it over, restart
      done(p, acc);
#pragma unroll
      for (int fm = 0; fm < FM; ++fm)
#pragma unroll
        for (int fn = 0; fn < FN; ++fn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[fm][fn][e] = 0;
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
}

}  // namespace repro
