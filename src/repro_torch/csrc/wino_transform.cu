// Winograd input and output transforms (K1, K3) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/wino_transform.py:
//   input_transform  (_input_kernel)   tiles (T,C,n,n) f32 -> C^-T X C^-1
//       (when the base changes) -> B_C^T (.) B_C -> / s[p] -> rint -> clip
//       +-127 -> Xq (n^2,T,C) int8, position-major for the GEMM;
//   output_transform (_output_kernel)  H (n^2,T,C) int32 -> f32(H) * s[p]
//       -> C^-T (.) C^-1 (when the base changes) -> A_C^T (.) A_C
//       -> (T,C,m,m) f32.
//
// What bounds them on an H100. Bytes: per (t, c) tile the input transform
// reads n^2 floats and writes n^2 bytes; the output transform reads n^2
// int32 and writes m^2 floats. But both keep the JAX kernels' unrolled
// sandwich order (Xq is held exact against JAX), each product and sum a
// separate rounded fp32 operation: 2 * 36 * 71 = 5,112 of them per (t, c)
// for the input transform at F(4,3) with the base change. At 33.5 T fp32
// instructions/s that order, not the bytes, sets the input transform's
// floor; the output transform leaves out the base change's zero terms.
//
// Design of the input transform (K1):
// * A persistent grid (as many blocks as fit the card at once: four
//   128-thread blocks an SM at n <= 6) walks chunks of consecutive (t, c)
//   windows. A chunk's windows are contiguous in memory; the block stages
//   them with 16-byte cp.async, neighbouring threads on neighbouring
//   addresses. Windows sit in shared memory at a stride of an odd number
//   of 16-byte pieces, so each thread's 16-byte reads of its own windows
//   are free of bank conflicts. A value's arithmetic never depends on T
//   or C.
// * Each block builds its term tables once, laid out [j][k][a][b]
//   (load_terms). A thread computes two windows at once, four outputs at a
//   time (sandwich_terms_grouped): (j, k) runs outside, so every output
//   keeps its j-outer, k-inner order, and one 16-byte table load feeds
//   eight products. The loop over groups of outputs stays rolled: fully
//   unrolled, the kernel was ~16,000 SASS instructions, more than the
//   SM's instruction cache holds, and ran at less than half this speed on
//   an H100. n = 8 runs two contractions, one window a thread.
// * Each sandwich's sums go back into the thread's own window slots; the
//   quantize runs apart from the sandwiches (the IEEE divide's slow path
//   is a call, which spilled with the windows live), staging each
//   position's int8 row in shared memory for 16-byte stores (byte
//   stores where T*C is not a multiple of 16, which leaves the rows
//   unaligned). Then the next chunk is issued, and lands while the rows
//   go out and the SM's other blocks compute.
// * Registers stay within 128 a thread at n <= 6, with no spill.
//
// Design of the output transform (K3). Its full order is 3,728 separate
// fp32 operations per (t, c) at F(4,3) with the base change (the scale of
// each position and both sandwiches) against 144 bytes read and 64
// written, 0.89 ms a staged forward at 33.5 T/s. But 1,152 of the base
// change's 1,296 terms L[a][j] * L[b][k] are zero: the Legendre C^-T has
// x^j in row a only for j <= a with a - j even. Leaving a zero term out
// changes no nonzero value (see sandwich_legendre), so K3 runs 1,568
// operations per (t, c) (the 144 terms' own products included), and the
// bytes come near to bounding it.
// * A persistent grid of 128-thread blocks (three an SM at n <= 6, up
//   to 168 registers a thread) walks chunks of 128 consecutive (t, c)
//   windows. H is position-major, so a chunk is n^2 rows of consecutive
//   int32, staged with 16-byte cp.async where every row starts 16-byte
//   aligned (T*C a multiple of 4), else with 4-byte copies. A thread
//   reads its window, one column of the rows (no bank conflicts), into
//   registers, and the block issues the next chunk at once, so its copy
//   overlaps the sandwiches.
// * One window a thread, in registers from H to its outputs. Where C^-T
//   has the Legendre zeros (checked per block, with every scale finite),
//   the base change runs over its 144 nonzero terms, made from C^-T held
//   in registers (sandwich_legendre); else it runs in full from the term
//   table, four outputs at a time with the group loop rolled
//   (sandwich_terms_grouped). The A sandwich runs from its table, all
//   outputs at once (sandwich_terms, K4's epilogue); the tables are built
//   once per block in the [j][k][a][b] layout. A window with a zero
//   output is redone in full from H, since a left-out term can only
//   change the sign of a zero. At n = 8 two contractions, as in the JAX
//   kernel.
// * The (m x m) outputs are staged in their own room, window by window as
//   they lie in device memory, and leave in coalesced 16-byte stores (the
//   ragged tail included). At m = 4 a window's four 16-byte pieces are
//   swizzled so that staging and reading are both free of bank conflicts.
// The transform matrices are runtime operands (flex makes them
// learnable), so they are read per launch, never baked in: a C^-T
// without the Legendre zeros takes the full order. Tensor cores have no
// role: their products round differently.

#include "common.cuh"

namespace {

// Threads of a block of either transform.
constexpr int kThreads = 128;

// Windows a thread computes: two where the table form runs (one 16-byte
// table load then feeds eight products), one at n = 8.
template <int N>
__host__ __device__ constexpr int windows_per_thread() {
  return N <= repro::kUnrollMaxN ? 2 : 1;
}

// Windows a block stages and computes at once.
template <int N>
__host__ __device__ constexpr int chunk() {
  return kThreads * windows_per_thread<N>();
}

// Floats between windows in shared memory: an odd number of 16-byte pieces.
template <int N>
__host__ __device__ constexpr int window_stride() {
  return (N * N / 4) % 2 ? N * N : N * N + 4;
}

// Dynamic shared memory of the input transform: the two term tables, the
// scales, one chunk of windows and the chunk's int8 output rows.
template <int N>
__host__ __device__ constexpr int input_smem_bytes() {
  return 4 * (2 * repro::kOperandFloats<N, N> + N * N) +
         chunk<N>() * (window_stride<N>() * 4 + N * N);
}

template <int N>
__global__ void
__launch_bounds__(kThreads, N <= repro::kUnrollMaxN ? 4 : 1)
input_transform_kernel(const float* __restrict__ tiles,
                       const float* __restrict__ cinvt,
                       const float* __restrict__ bpt,
                       const float* __restrict__ scale,
                       int8_t* __restrict__ out, long long TC,
                       int changes_base) {
  constexpr int NN = N * N, FO = repro::kOperandFloats<N, N>;
  constexpr int W = windows_per_thread<N>(), CH = chunk<N>();
  constexpr int WS = window_stride<N>(), PIECES = NN / 4;
  constexpr int G = 4;                  // outputs a thread sums at once
  static_assert(FO % 4 == 0 && NN % 4 == 0, "16-byte table and window reads");
  extern __shared__ __align__(16) float smem_f[];
  float* s_base = smem_f;
  float* s_b = s_base + FO;
  float* s_s = s_b + FO;
  float* s_win = s_s + NN;
  int8_t* s_out = reinterpret_cast<int8_t*>(s_win + CH * WS);

  const int tid = threadIdx.x;
  if (changes_base) repro::load_terms<N, N>(cinvt, cinvt, s_base);
  repro::load_terms<N, N>(bpt, bpt, s_b);
  for (int i = tid; i < NN; i += kThreads) s_s[i] = scale[i];

  const long long chunks = (TC + CH - 1) / CH;
  // the chunk's windows in 16-byte pieces, thread i on pieces i, i + 128,
  // ... (coalesced; zero-filled past the last window)
  auto issue = [&](long long c) {
    const long long w0 = c * CH;
    const float* src = tiles + w0 * NN;
#pragma unroll
    for (int j = 0; j < W * PIECES; ++j) {
      const int i = tid + j * kThreads;
      const int w = i / PIECES, piece = i % PIECES;
      const bool in = w0 + w < TC;
      repro::cp_async16(s_win + w * WS + piece * 4, in ? src + 4 * i : tiles,
                        in);
    }
  };
  // this thread's windows (tid, tid + 128): their slots hold the window,
  // then the sums of each sandwich in turn
  auto own = [&](int w) {
    return reinterpret_cast<float4*>(s_win + (w * kThreads + tid) * WS);
  };
  auto load_own = [&](float (&v)[W][NN]) {
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int i = 0; i < PIECES; ++i) {
        const float4 f = own(w)[i];
        v[w][4 * i] = f.x; v[w][4 * i + 1] = f.y; v[w][4 * i + 2] = f.z;
        v[w][4 * i + 3] = f.w;
      }
  };
  auto store_own = [&](int g, const float(&acc)[W][G]) {
#pragma unroll
    for (int w = 0; w < W; ++w)
#pragma unroll
      for (int e = 0; e < G; e += 4)
        own(w)[(g * G + e) / 4] = make_float4(acc[w][e], acc[w][e + 1],
                                              acc[w][e + 2], acc[w][e + 3]);
  };

  // T*C a multiple of 16: every position's row of a chunk starts 16-byte
  // aligned, and goes out in 16-byte stores from s_out
  const bool vec_out = (TC % 16) == 0;
  long long c = blockIdx.x;
  if (c < chunks) issue(c);
  repro::cp_async_commit();
  for (; c < chunks; c += gridDim.x) {
    const long long w0 = c * CH;
    repro::cp_async_wait<0>();
    __syncthreads();                     // the chunk is in
    // both sandwiches; their sums go back into the thread's own slots
    if constexpr (N <= repro::kUnrollMaxN) {
      if (changes_base) {
        float x[W][NN];
        load_own(x);
        repro::sandwich_terms_grouped<N, N, W, G>(s_base, x, store_own);
      }
      float y[W][NN];
      load_own(y);
      repro::sandwich_terms_grouped<N, N, W, G>(s_b, y, store_own);
    } else {
      float y[W][NN], v[NN];
      load_own(y);
      if (changes_base) {
        float x[NN];
#pragma unroll
        for (int i = 0; i < NN; ++i) x[i] = y[0][i];
        repro::sandwich<N, N>(s_base, x, y[0]);
      }
      repro::sandwich<N, N>(s_b, y[0], v);
#pragma unroll
      for (int i = 0; i < PIECES; ++i)
        own(0)[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                v[4 * i + 3]);
    }
    // quantize apart from the sandwiches: the IEEE divide's slow path is a
    // call, and few values are live here
#pragma unroll 1
    for (int w = 0; w < W; ++w) {
      const long long idx = w0 + w * kThreads + tid;
#pragma unroll 1
      for (int i = 0; i < PIECES; ++i) {
        const float4 f = own(w)[i];
        const float v[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = 4 * i + e;
          const int8_t q =
              static_cast<int8_t>(repro::quantize(v[e], s_s[p], 127.f));
          if (vec_out)
            s_out[p * CH + w * kThreads + tid] = q;
          else if (idx < TC)
            out[p * TC + idx] = q;
        }
      }
    }
    __syncthreads();          // rows staged; every thread done with its slots
    if (c + gridDim.x < chunks) issue(c + gridDim.x);
    repro::cp_async_commit();            // lands while the rows go out
    if (vec_out) {
      for (int i = tid; i < NN * (CH / 16); i += kThreads) {
        const int p = i / (CH / 16), piece = i % (CH / 16);
        const long long o = w0 + piece * 16;
        if (o < TC)
          *reinterpret_cast<uint4*>(out + p * TC + o) =
              *reinterpret_cast<const uint4*>(s_out + p * CH + piece * 16);
      }
    }
  }
}

// Windows a block of the output transform stages and computes at once:
// one a thread, each held in registers from H to its outputs.
constexpr int kOutChunk = kThreads;

// Dynamic shared memory of the output transform: the two term tables,
// the scales, one chunk of H (n^2 rows of kOutChunk int32) and the
// chunk's outputs (kOutChunk x m x m floats).
template <int N, int M>
__host__ __device__ constexpr int output_smem_bytes() {
  return 4 * (repro::kOperandFloats<N, N> + repro::kOperandFloats<N, M> +
              N * N) +
         4 * (N * N + M * M) * kOutChunk;
}

// Which 16-byte piece of window i's staged outputs holds its piece v. At
// m = 4 (four pieces, 64 bytes a window) neighbouring threads' windows
// would sit on the same banks, so the pieces are turned by bits 1-2 of
// the window; at m = 2 and 6 (one and nine pieces) they stay in order.
template <int M>
__device__ __forceinline__ int out_piece(int i, int v) {
  return M * M == 16 ? v ^ ((i >> 1) & 3) : v;
}

template <int N, int M>
__global__ void
__launch_bounds__(kThreads, N <= repro::kUnrollMaxN ? 3 : 1)
output_transform_kernel(const int32_t* __restrict__ h,
                        const float* __restrict__ scale,
                        const float* __restrict__ cinvt,
                        const float* __restrict__ apt,
                        float* __restrict__ out, long long TC,
                        int changes_base, int vec_in) {
  constexpr int NN = N * N, MM = M * M, CH = kOutChunk;
  constexpr int FB = repro::kOperandFloats<N, N>;
  constexpr int FA = repro::kOperandFloats<N, M>;
  constexpr int OP = MM / 4;            // 16-byte pieces of a window's outputs
  static_assert(FB % 4 == 0 && FA % 4 == 0 && (FB + FA + NN) % 4 == 0 &&
                    MM % 4 == 0 && MM <= NN,
                "16-byte tables, rows and output pieces");
  static_assert((NN * CH / 4) % kThreads == 0, "whole 16-byte copies");
  extern __shared__ __align__(16) float smem_f[];
  float* s_base = smem_f;
  float* s_a = s_base + FB;
  float* s_s = s_a + FA;
  int32_t* s_h = reinterpret_cast<int32_t*>(s_s + NN);  // n^2 rows of CH
  float* s_out = s_s + NN + NN * CH;     // the chunk's outputs

  const int tid = threadIdx.x;
  if (changes_base) repro::load_terms<N, N>(cinvt, cinvt, s_base);
  repro::load_terms<N, M>(apt, apt, s_a);
  for (int i = tid; i < NN; i += kThreads) s_s[i] = scale[i];
  // The base change leaves out its zero terms (sandwich_legendre) where
  // C^-T has the Legendre base's zeros and every x = f32(h) * s is finite
  // (|h| <= 2^31; an x * 0 of an infinite x would be NaN).
  bool sparse = false;
  float l[NN];                           // C^-T for sandwich_legendre
  if constexpr (N <= repro::kUnrollMaxN) {
    if (changes_base) {
      bool off = false;
      for (int i = tid; i < NN; i += kThreads)
        off |= !(repro::legendre_nonzero(i / N, i % N) || cinvt[i] == 0.f) ||
               !(fabsf(scale[i]) <= 1e29f);
      sparse = !__syncthreads_or(off);
#pragma unroll
      for (int i = 0; i < NN; ++i)
        l[i] = repro::legendre_nonzero(i / N, i % N) ? cinvt[i] : 0.f;
    }
  }

  const long long chunks = (TC + CH - 1) / CH;
  // position p's CH values of the chunk into row p, zero-filled past the
  // last window: 16-byte pieces, thread i on pieces i, i + 128, ...
  // (coalesced), or single values where the rows are not 16-byte aligned
  auto issue = [&](long long c) {
    const long long w0 = c * CH;
    if (vec_in) {
#pragma unroll
      for (int j = 0; j < NN * CH / 4 / kThreads; ++j) {
        const int i = tid + j * kThreads;
        const int p = i / (CH / 4), w = 4 * (i % (CH / 4));
        const bool in = w0 + w < TC;
        repro::cp_async16(s_h + p * CH + w, in ? h + p * TC + w0 + w : h, in);
      }
    } else {
#pragma unroll 4
      for (int i = tid; i < NN * CH; i += kThreads) {
        const int p = i / CH, w = i % CH;
        const bool in = w0 + w < TC;
        repro::cp_async4(s_h + i, in ? h + p * TC + w0 + w : h, in);
      }
    }
  };

  long long c = blockIdx.x;
  if (c < chunks) issue(c);
  repro::cp_async_commit();
  for (; c < chunks; c += gridDim.x) {
    const long long w0 = c * CH, idx = w0 + tid;
    repro::cp_async_wait<0>();
    __syncthreads();                     // the chunk is in
    // this thread's window, from its column of the rows
    float x[NN];
#pragma unroll
    for (int p = 0; p < NN; ++p)
      x[p] = __fmul_rn(static_cast<float>(s_h[p * CH + tid]), s_s[p]);
    __syncthreads();                     // windows in registers: rows free
    if (c + gridDim.x < chunks) issue(c + gridDim.x);
    repro::cp_async_commit();
    float y[MM];
    for (bool skip = sparse;; skip = false) {
      if (changes_base) {
        float z[NN];
        if constexpr (N <= repro::kUnrollMaxN) {
          if (skip) {
            repro::sandwich_legendre<N>(l, x, z);
          } else {
            // the full order, four outputs at a time with the group loop
            // rolled (off the Legendre path, so kept small)
            float zl[NN];
            repro::sandwich_terms_grouped<N, N, 1, 4>(
                s_base, reinterpret_cast<const float(&)[1][NN]>(x),
                [&](int g, const float(&acc)[1][4]) {
#pragma unroll
                  for (int e = 0; e < 4; ++e) zl[4 * g + e] = acc[0][e];
                });
#pragma unroll
            for (int p = 0; p < NN; ++p) z[p] = zl[p];
          }
        } else {
          repro::sandwich_jk<N, N>(s_base, x, z);
        }
        repro::sandwich_jk<N, M>(s_a, z, y);
      } else {
        repro::sandwich_jk<N, M>(s_a, x, y);
      }
      bool zero = false;
#pragma unroll
      for (int q = 0; q < MM; ++q) zero |= y[q] == 0.f;
      if (!skip || !zero || idx >= TC) break;
      // a zero's sign may differ from the full order's: redo the window
      // in full, from H in device memory
#pragma unroll
      for (int p = 0; p < NN; ++p)
        x[p] = __fmul_rn(static_cast<float>(h[p * TC + idx]), s_s[p]);
    }
#pragma unroll
    for (int v = 0; v < OP; ++v)
      reinterpret_cast<float4*>(s_out + tid * MM)[out_piece<M>(tid, v)] =
          make_float4(y[4 * v], y[4 * v + 1], y[4 * v + 2], y[4 * v + 3]);
    __syncthreads();                     // the chunk's outputs are staged
    // the chunk's outputs lie contiguous in device memory
    const long long left = TC - w0;
    const int pieces = (left < CH ? static_cast<int>(left) : CH) * OP;
    float4* dst = reinterpret_cast<float4*>(out + w0 * MM);
    for (int r = tid; r < pieces; r += kThreads)
      dst[r] = reinterpret_cast<const float4*>(s_out + (r / OP) * MM)
          [out_piece<M>(r / OP, r % OP)];
  }
}

// Blocks of a persistent grid: as many as the card holds at once (found
// once per device, with `smem` bytes of dynamic shared memory a block),
// or one per chunk where there are fewer. Returns a cudaError_t.
template <class Kernel>
int persistent_grid(Kernel kernel, int smem, long long chunks,
                    int (&resident)[repro::kMaxDevices], int* grid) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= repro::kMaxDevices)
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = sms * per_sm;
  }
  *grid = static_cast<int>(chunks < resident[dev] ? chunks : resident[dev]);
  return static_cast<int>(cudaSuccess);
}

template <int N>
int launch_input(const float* tiles, const float* cinvt, const float* bpt,
                 const float* scale, int8_t* out, long long TC,
                 int changes_base, cudaStream_t stream) {
  constexpr int smem = input_smem_bytes<N>();
  static int resident[repro::kMaxDevices] = {};   // blocks, 0 = not yet found
  int grid = 0;
  const int e = persistent_grid(input_transform_kernel<N>, smem,
                                (TC + chunk<N>() - 1) / chunk<N>(),
                                resident, &grid);
  if (e != cudaSuccess) return e;
  input_transform_kernel<N><<<grid, kThreads, smem, stream>>>(
      tiles, cinvt, bpt, scale, out, TC, changes_base);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int M>
int launch_output(const int32_t* h, const float* scale, const float* cinvt,
                  const float* apt, float* out, long long TC,
                  int changes_base, cudaStream_t stream) {
  constexpr int smem = output_smem_bytes<N, M>();
  static int resident[repro::kMaxDevices] = {};   // blocks, 0 = not yet found
  int grid = 0;
  const int e = persistent_grid(output_transform_kernel<N, M>, smem,
                                (TC + kOutChunk - 1) / kOutChunk, resident,
                                &grid);
  if (e != cudaSuccess) return e;
  // 16-byte copies of H where every row of a chunk starts 16-byte aligned
  const int vec_in =
      TC % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  output_transform_kernel<N, M><<<grid, kThreads, smem, stream>>>(
      h, scale, cinvt, apt, out, TC, changes_base, vec_in);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tiles (T, C, n, n) f32, cinvt/bpt (n, n) f32, scale (n*n) f32
// -> out (n*n, T, C) int8. n in {4, 6, 8}. Returns cudaGetLastError().
extern "C" int wino_input_transform(const float* tiles, const float* cinvt,
                                    const float* bpt, const float* scale,
                                    int8_t* out, long long T, long long C,
                                    int n, int changes_base,
                                    cudaStream_t stream) {
  const long long TC = T * C;
  if (TC == 0) return static_cast<int>(cudaGetLastError());
  switch (n) {
    case 4:
      return launch_input<4>(tiles, cinvt, bpt, scale, out, TC, changes_base,
                             stream);
    case 6:
      return launch_input<6>(tiles, cinvt, bpt, scale, out, TC, changes_base,
                             stream);
    case 8:
      return launch_input<8>(tiles, cinvt, bpt, scale, out, TC, changes_base,
                             stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// h (n*n, T, C) int32, scale (n*n) f32, cinvt (n, n), apt (m, n) f32
// -> out (T, C, m, m) f32, with m = n - 2. Returns cudaGetLastError().
extern "C" int wino_output_transform(const int32_t* h, const float* scale,
                                     const float* cinvt, const float* apt,
                                     float* out, long long T, long long C,
                                     int n, int changes_base,
                                     cudaStream_t stream) {
  const long long TC = T * C;
  if (TC == 0) return static_cast<int>(cudaGetLastError());
  switch (n) {
    case 4:
      return launch_output<4, 2>(h, scale, cinvt, apt, out, TC, changes_base,
                                 stream);
    case 6:
      return launch_output<6, 4>(h, scale, cinvt, apt, out, TC, changes_base,
                                 stream);
    case 8:
      return launch_output<8, 6>(h, scale, cinvt, apt, out, TC, changes_base,
                                 stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
