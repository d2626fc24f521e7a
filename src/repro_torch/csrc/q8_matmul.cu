// w8a8 quantized matmul with the symmetric dequant epilogue (K5) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/q8_matmul.py:q8_matmul
// (_q8_kernel): out = f32(x_q @ w_q) * s_x * s_w[col], cast to the output
// type, with x_q (M,K) int8, w_q (K,N) int8, int32 accumulation over K, a
// per-tensor s_x and a per-output-column s_w. The TPU kernel carries its
// int32 accumulator across a sequential K grid axis in VMEM scratch; here
// each block loops over its K range itself and keeps the accumulators in
// registers.
//
// What bounds it on an H100: at the llama3.2-1b projection shapes with a
// prefill M (2048 tokens) the product does 2*M*K*N operations on
// M*K + K*N + 4*M*N bytes, far above the ~590 int8 operations per byte
// where the tensor cores stop being the limit, so operations bound it,
// at the card's 1,979 TOP/s int8 tensor rate; at a decode M (8) the
// weight bytes bound it.
//
// Design: a warp-specialised wgmma kernel on a 128 x 128 block tile,
// 128 deep per stage.
// * One producer warp keeps a 4-stage shared-memory ring full with TMA
//   (cp.async.bulk.tensor): the x tile lands K-major in the 128-byte
//   swizzled layout wgmma reads; the w tile lands as it lies, N-major,
//   in a staging buffer. Full/empty mbarriers pace the ring.
// * Int8 wgmma takes B only K-major (its transpose bits exist for 16-bit
//   types alone), and q8_matmul's contract is w (K, N). So the two
//   consumer warpgroups turn each landed w tile into a K-major, 128-byte
//   swizzled copy with 4 x 4 byte transposes (__byte_perm) while the
//   previous stage's wgmma runs, then issue
//   wgmma.mma_async m64n128k32 s32.s8.s8 (four per stage, each warpgroup
//   64 rows of the 128). The producer warpgroup hands registers to the
//   consumers (setmaxnreg: 56 and 224 a thread instead of 168 each), so
//   a consumer's 64 accumulators and its epilogue need no spill.
// * TMA needs 16-byte row strides. Where K or N is not a multiple of 16
//   (the ragged 130 x 100 x 70 case), the producer warp fills the same
//   layouts with predicated byte loads and zero fill instead; zero
//   padding of ragged M, K and N edges is exact in integers.
// * Small grids: where the M x N grid has too few blocks for 132 SMs (a
//   decode M <= 64, or N = 512), the host splits K across blocks (grid
//   z). int32 partial sums are exact and atomicAdd on them is order-free,
//   so the sum stays bit for bit; the last block of a tile to arrive (a
//   per-tile counter) takes the sums out with atomicExch, which leaves
//   the workspace zero for the next call, and runs the epilogue once: no
//   memset, no second kernel.
// The epilogue is fmul_rn(fmul_rn(int2float_rn(acc), s_x), s_w[n]) in the
// order of the plain version, then a round-to-nearest cast for bf16
// output, so the result equals the plain version bit for bit. s_x is
// read from device memory: the caller never syncs on it. TMA descriptors
// come from cuTensorMapEncodeTiled, taken through
// cudaGetDriverEntryPointByVersion (CUDA 12.5+), so the library needs no
// -lcuda.

#include "common.cuh"

#include <cuda.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBM = 128, kBN = 128, kBK = 128;
constexpr int kStages = 4;
constexpr int kTile = kBM * kBK;                  // bytes of one tile
constexpr int kStageBytes = 3 * kTile;            // A, w staging, B
constexpr int kThreads = 384;                     // producer wg + 2 consumer wgs
constexpr int kSmem = kStages * kStageBytes + 1024 + 64;

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);

template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }

template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float dequant(int acc, float sx, float sw) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of (row, k) in a tile of 128-byte rows in the 128-byte
// swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B, wgmma's layout type 1): the
// 16-byte chunk index is XORed with the row's index within its 8-row atom.
__device__ __forceinline__ int swz(int row, int k) {
  return row * 128 + ((((k >> 4) ^ (row & 7))) << 4) + (k & 15);
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: 8-row atoms
// 1024 bytes apart (SBO), leading offset unused (1).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  const uint64_t a = smem_addr(p);
  return ((a & 0x3FFFF) >> 4) | (uint64_t{1} << 16) |
         (uint64_t{1024 >> 4} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 128 s32, this warpgroup's fragment) += A (64 x 32) . B (32 x 128).
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
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

// The landed w tile (128 k rows x 128 n bytes) -> K-major swizzled B
// (128 n rows x 128 k bytes), by the 256 consumer threads. A warp takes
// 4 k-groups x 8 n-words at a time (4-way bank conflicts on both sides).
__device__ __forceinline__ void transpose_tile(const uint8_t* __restrict__ w,
                                               uint8_t* __restrict__ b,
                                               int ct) {
  const int warp = ct / 32, lane = ct % 32;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int tile = warp + 8 * j;                 // 32 tiles of 4 x 8 blocks
    const int kg = (tile / 4) * 4 + lane / 8;      // k-group: 4 k rows
    const int nw = (tile % 4) * 8 + lane % 8;      // n-word: 4 n columns
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = *reinterpret_cast<const uint32_t*>(w + (kg * 4 + i) * kBN +
                                                nw * 4);
    transpose4x4(r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<uint32_t*>(b + swz(nw * 4 + i, kg * 4)) = r[i];
  }
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
q8_wgmma_kernel(__grid_constant__ const CUtensorMap map_x,
                __grid_constant__ const CUtensorMap map_w,
                const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                const float* __restrict__ s_x, const float* __restrict__ s_w,
                OutT* __restrict__ out, int* __restrict__ ws,
                int* __restrict__ counters, int M, int N,
                int K, int k_steps, int use_tma) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (K + kBK - 1) / kBK;
  const int kb = blockIdx.z * k_steps;
  const int ke = min(nk, kb + k_steps);
  const int steps = max(0, ke - kb);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {  // producer warpgroup: warp 0 loads, the rest idle
    // give registers to the consumers (128 x 56 + 256 x 224 = 384 x 168)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n" ::: "memory");
    if (tid >= 32) return;
    const int lane = tid;
    for (int it = 0; it < steps; ++it) {
      const int s = it % kStages;
      uint8_t* sa = smem + s * kStageBytes;
      uint8_t* sw = sa + kTile;
      const int k0 = (kb + it) * kBK;
      if (lane == 0) mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
      __syncwarp();
      if (use_tma) {
        if (lane == 0) {
          mbar_expect_tx(&full[s], 2 * kTile);
          tma_load_2d(sa, &map_x, &full[s], k0, m0);
          tma_load_2d(sw, &map_w, &full[s], n0, k0);
        }
        continue;
      }
      // predicated path: 16-byte chunks built from byte loads, zero fill
      for (int c = lane; c < 2 * kBM * (kBK / 16); c += 32) {
        const bool is_x = c < kBM * (kBK / 16);
        const int cc = is_x ? c : c - kBM * (kBK / 16);
        const int row = cc / (kBK / 16), col = (cc % (kBK / 16)) * 16;
        alignas(16) int8_t v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (is_x) {  // x row m0 + row, k0 + col + j
            const int m = m0 + row, k = k0 + col + j;
            v[j] = (m < M && k < K) ? x[static_cast<long long>(m) * K + k] : 0;
          } else {     // w row k0 + row, n0 + col + j
            const int k = k0 + row, n = n0 + col + j;
            v[j] = (k < K && n < N) ? w[static_cast<long long>(k) * N + n] : 0;
          }
        }
        uint8_t* dst = is_x ? sa + swz(row, col) : sw + row * kBN + col;
        *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(v);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&full[s]);
    }
    return;
  }

  // consumers: 256 threads, warpgroup g owns rows 64 g .. 64 g + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n" ::: "memory");
  const int ct = tid - 128;
  const int g = ct / 128;
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;

  if (steps > 0) {
    mbar_wait(&full[0], 0);
    transpose_tile(smem + kTile, smem + 2 * kTile, ct);
    fence_proxy_async();
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  for (int it = 0; it < steps; ++it) {
    const int s = it % kStages;
    uint8_t* sa = smem + s * kStageBytes;
    uint8_t* sb = sa + 2 * kTile;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32)
      wgmma_s8(acc, desc_sw128(sa + g * 64 * 128 + kk),
               desc_sw128(sb + kk));
    wgmma_commit();
    if (it + 1 < steps) {  // turn the next w tile while the product runs
      const int s1 = (it + 1) % kStages;
      mbar_wait(&full[s1], ((it + 1) / kStages) & 1);
      uint8_t* sa1 = smem + s1 * kStageBytes;
      transpose_tile(sa1 + kTile, sa1 + 2 * kTile, ct);
      fence_proxy_async();
    }
    wgmma_wait0();
    if (ct % 128 == 0) mbar_arrive(&empty[s]);
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
  }

  // accumulator fragment: register r of thread (warp wq, lane l) holds
  // row 16 wq + l / 4 + 8 ((r / 2) % 2), column 8 (r / 4) + 2 (l % 4) + r % 2
  const int wq = (ct % 128) / 32, l = ct % 32;
  auto offset = [&](int r, int& m, int& n) {
    m = m0 + 64 * g + 16 * wq + l / 4 + 8 * ((r / 2) % 2);
    n = n0 + 8 * (r / 4) + 2 * (l % 4);
    return static_cast<long long>(m) * N + n;
  };
  if (ws != nullptr) {
    // Split K: every block adds its partial sums into ws; the last block
    // of the tile to arrive takes the full sums out (leaving ws zero for
    // the next call) and runs the epilogue.
    __shared__ int s_last;
#pragma unroll
    for (int r = 0; r < 64; r += 2) {
      int m, n;
      const long long o = offset(r, m, n);
      if (m >= M) continue;
      if (n < N) atomicAdd(ws + o, acc[r]);
      if (n + 1 < N) atomicAdd(ws + o + 1, acc[r + 1]);
    }
    __threadfence();
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    if (ct == 0)
      s_last = atomicAdd(counters + tile, 1) ==
               static_cast<int>(gridDim.z) - 1;
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    if (!s_last) return;
    __threadfence();
#pragma unroll
    for (int r = 0; r < 64; r += 2) {
      int m, n;
      const long long o = offset(r, m, n);
      if (m >= M) continue;
      if (n < N) acc[r] = atomicExch(ws + o, 0);
      if (n + 1 < N) acc[r + 1] = atomicExch(ws + o + 1, 0);
    }
    if (ct == 0) counters[tile] = 0;
  }
  const float sx = *s_x;
#pragma unroll
  for (int r = 0; r < 64; r += 2) {
    int m, n;
    const long long o = offset(r, m, n);
    if (m >= M) continue;
    if (n < N) out[o] = to_out<OutT>(dequant(acc[r], sx, s_w[n]));
    if (n + 1 < N)
      out[o + 1] = to_out<OutT>(dequant(acc[r + 1], sx, s_w[n + 1]));
  }
}

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);

EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeFn>(p);
  }
  return fn;
}

// A (rows, cols) row-major int8 matrix as a TMA map of 128 x 128 boxes.
bool make_map(CUtensorMap* map, const void* base, int rows, int cols,
              CUtensorMapSwizzle swizzle) {
  EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols)};
  const cuuint32_t box[2] = {128, 128};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename OutT>
int launch(const int8_t* x, const int8_t* w, const float* s_x,
           const float* s_w, void* out, int* ws, int* counters, int M,
           int N, int K, int splits, cudaStream_t stream) {
  const int nk = (K + kBK - 1) / kBK;
  const int k_steps = splits > 1 ? (nk + splits - 1) / splits : nk;
  const int use_tma = (K % 16 == 0) && (N % 16 == 0);
  CUtensorMap map_x{}, map_w{};
  if (use_tma &&
      (!make_map(&map_x, x, M, K, CU_TENSOR_MAP_SWIZZLE_128B) ||
       !make_map(&map_w, w, K, N, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool smem_set[repro::kMaxDevices] = {};  // per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= repro::kMaxDevices)
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    e = cudaFuncSetAttribute(q8_wgmma_kernel<OutT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set[dev] = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM,
                  splits > 1 ? (nk + k_steps - 1) / k_steps : 1);
  q8_wgmma_kernel<OutT><<<grid, kThreads, kSmem, stream>>>(
      map_x, map_w, x, w, s_x, s_w, static_cast<OutT*>(out),
      splits > 1 ? ws : nullptr, counters, M, N, K, k_steps, use_tma);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) int8, w (K, N) int8, s_x (1) f32, s_w (N) f32 -> out (M, N),
// f32 when out_bf16 == 0, else bf16. x and w are 16-byte aligned. With
// splits > 1 the K range is split over that many blocks per output tile:
// ws (at least M * N int32) and counters (one int32 per 128 x 128 output
// tile) must be zero on entry, and the call leaves them zero; with
// splits = 1 both are unused. Returns cudaGetLastError().
extern "C" int q8_matmul(const int8_t* x, const int8_t* w, const float* s_x,
                         const float* s_w, void* out, int* ws, int* counters,
                         int M, int N, int K, int splits, int out_bf16,
                         cudaStream_t stream) {
  if (M == 0 || N == 0) return static_cast<int>(cudaGetLastError());
  if (splits > 1 && (ws == nullptr || counters == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_bf16)
    return launch<__nv_bfloat16>(x, w, s_x, s_w, out, ws, counters, M, N, K,
                                 splits, stream);
  return launch<float>(x, w, s_x, s_w, out, ws, counters, M, N, K, splits,
                       stream);
}
