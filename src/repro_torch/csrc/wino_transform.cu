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
// instructions/s that order, not the bytes, sets the floor.
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
// The output transform (K3) keeps its first design: one thread per (t, c)
// and term tables built per block in the [a][b][j][k] layout. The
// transform matrices are runtime operands (flex makes them learnable), so
// they are read per launch, never baked in. Tensor cores have no role at
// 6x6.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Threads of an input-transform block; four blocks share an SM at n <= 6.
constexpr int kInThreads = 128;

// Windows a thread of the input transform computes: two where the table
// form runs (one 16-byte table load then feeds eight products), one at
// n = 8.
template <int N>
__host__ __device__ constexpr int windows_per_thread() {
  return N <= repro::kUnrollMaxN ? 2 : 1;
}

// Windows a block stages and computes at once.
template <int N>
__host__ __device__ constexpr int chunk() {
  return kInThreads * windows_per_thread<N>();
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
__launch_bounds__(kInThreads, N <= repro::kUnrollMaxN ? 4 : 1)
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
  for (int i = tid; i < NN; i += kInThreads) s_s[i] = scale[i];

  const long long chunks = (TC + CH - 1) / CH;
  // the chunk's windows in 16-byte pieces, thread i on pieces i, i + 128,
  // ... (coalesced; zero-filled past the last window)
  auto issue = [&](long long c) {
    const long long w0 = c * CH;
    const float* src = tiles + w0 * NN;
#pragma unroll
    for (int j = 0; j < W * PIECES; ++j) {
      const int i = tid + j * kInThreads;
      const int w = i / PIECES, piece = i % PIECES;
      const bool in = w0 + w < TC;
      repro::cp_async16(s_win + w * WS + piece * 4, in ? src + 4 * i : tiles,
                        in);
    }
  };
  // this thread's windows (tid, tid + 128): their slots hold the window,
  // then the sums of each sandwich in turn
  auto own = [&](int w) {
    return reinterpret_cast<float4*>(s_win + (w * kInThreads + tid) * WS);
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
      const long long idx = w0 + w * kInThreads + tid;
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
            s_out[p * CH + w * kInThreads + tid] = q;
          else if (idx < TC)
            out[p * TC + idx] = q;
        }
      }
    }
    __syncthreads();          // rows staged; every thread done with its slots
    if (c + gridDim.x < chunks) issue(c + gridDim.x);
    repro::cp_async_commit();            // lands while the rows go out
    if (vec_out) {
      for (int i = tid; i < NN * (CH / 16); i += kInThreads) {
        const int p = i / (CH / 16), piece = i % (CH / 16);
        const long long o = w0 + piece * 16;
        if (o < TC)
          *reinterpret_cast<uint4*>(out + p * TC + o) =
              *reinterpret_cast<const uint4*>(s_out + p * CH + piece * 16);
      }
    }
  }
}

template <int N, int M>
__global__ void __launch_bounds__(kThreads)
output_transform_kernel(const int32_t* __restrict__ h,
                        const float* __restrict__ scale,
                        const float* __restrict__ cinvt,
                        const float* __restrict__ apt,
                        float* __restrict__ out, long long TC,
                        int changes_base) {
  __shared__ float sm_base[repro::kOperandFloats<N, N>];
  __shared__ float sm_a[repro::kOperandFloats<N, M>];
  __shared__ float sm_s[N * N];
  if (changes_base) repro::load_operand<N, N>(cinvt, cinvt, sm_base);
  repro::load_operand<N, M>(apt, apt, sm_a);
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) sm_s[i] = scale[i];
  __syncthreads();

  const long long idx = blockIdx.x * static_cast<long long>(kThreads) +
                        threadIdx.x;
  if (idx >= TC) return;

  float x[N * N];
#pragma unroll
  for (int p = 0; p < N * N; ++p)
    x[p] = __fmul_rn(static_cast<float>(h[p * TC + idx]), sm_s[p]);
  float y[M * M];
  if (changes_base) {
    float z[N * N];
    repro::sandwich<N, N>(sm_base, x, z);
    repro::sandwich<N, M>(sm_a, z, y);
  } else {
    repro::sandwich<N, M>(sm_a, x, y);
  }
  float4* dst = reinterpret_cast<float4*>(out + idx * M * M);
#pragma unroll
  for (int i = 0; i < M * M / 4; ++i)
    dst[i] = make_float4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
}

int blocks_for(long long TC) {
  return static_cast<int>((TC + kThreads - 1) / kThreads);
}

// The input transform's persistent grid: as many blocks as the card holds
// at once (found once per device), or one per chunk where there are fewer.
template <int N>
int launch_input(const float* tiles, const float* cinvt, const float* bpt,
                 const float* scale, int8_t* out, long long TC,
                 int changes_base, cudaStream_t stream) {
  constexpr int smem = input_smem_bytes<N>();
  static int resident[repro::kMaxDevices] = {};   // blocks, 0 = not yet found
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev >= repro::kMaxDevices)
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidDevice);
  if (resident[dev] == 0) {
    e = cudaFuncSetAttribute(input_transform_kernel<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, input_transform_kernel<N>, kInThreads, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[dev] = sms * per_sm;
  }
  const long long chunks = (TC + chunk<N>() - 1) / chunk<N>();
  const int grid = static_cast<int>(
      chunks < resident[dev] ? chunks : resident[dev]);
  input_transform_kernel<N><<<grid, kInThreads, smem, stream>>>(
      tiles, cinvt, bpt, scale, out, TC, changes_base);
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
  const dim3 grid(blocks_for(TC));
  switch (n) {
    case 4:
      output_transform_kernel<4, 2><<<grid, kThreads, 0, stream>>>(
          h, scale, cinvt, apt, out, TC, changes_base);
      break;
    case 6:
      output_transform_kernel<6, 4><<<grid, kThreads, 0, stream>>>(
          h, scale, cinvt, apt, out, TC, changes_base);
      break;
    case 8:
      output_transform_kernel<8, 6><<<grid, kThreads, 0, stream>>>(
          h, scale, cinvt, apt, out, TC, changes_base);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
