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
// What bounds them on an H100: memory. Per (t, c) tile the input transform
// reads n^2 floats and writes n^2 bytes; its two n x n sandwiches cost
// ~2*2*n^3 flops in their separable form, far below the card's fp32 rate
// per byte moved. The output transform reads n^2 int32 and writes m^2
// floats.
//
// Design: one thread per (t, c) tile, so a value's arithmetic never
// depends on T or C (the contract the TPU kernel's >= 2-step grid rule
// served). The window is loaded with 16-byte vector loads into registers,
// both sandwiches run in registers against term tables in shared memory
// (the transform matrices are runtime operands -- flex makes them
// learnable -- so they are read per launch, never baked in), and the
// int8 outputs for position p go to out[p][t][c], coalesced along c.
// Tensor cores have no role at 6x6.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <int N>
__global__ void __launch_bounds__(kThreads)
input_transform_kernel(const float* __restrict__ tiles,
                       const float* __restrict__ cinvt,
                       const float* __restrict__ bpt,
                       const float* __restrict__ scale,
                       int8_t* __restrict__ out, long long TC,
                       int changes_base) {
  __shared__ float sm_base[repro::kOperandFloats<N, N>];
  __shared__ float sm_b[repro::kOperandFloats<N, N>];
  __shared__ float sm_s[N * N];
  if (changes_base) repro::load_operand<N, N>(cinvt, cinvt, sm_base);
  repro::load_operand<N, N>(bpt, bpt, sm_b);
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) sm_s[i] = scale[i];
  __syncthreads();

  const long long idx = blockIdx.x * static_cast<long long>(kThreads) +
                        threadIdx.x;                    // t * C + c
  if (idx >= TC) return;

  float x[N * N];
  const float4* src = reinterpret_cast<const float4*>(tiles + idx * N * N);
#pragma unroll
  for (int i = 0; i < N * N / 4; ++i) {
    const float4 v = src[i];
    x[4 * i] = v.x; x[4 * i + 1] = v.y; x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
  float v[N * N];
  if (changes_base) {
    float y[N * N];
    repro::sandwich<N, N>(sm_base, x, y);
    repro::sandwich<N, N>(sm_b, y, v);
  } else {
    repro::sandwich<N, N>(sm_b, x, v);
  }
#pragma unroll
  for (int p = 0; p < N * N; ++p)
    out[p * TC + idx] =
        static_cast<int8_t>(repro::quantize(v[p], sm_s[p], 127.f));
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
  const dim3 grid(blocks_for(TC));
  switch (n) {
    case 4:
      input_transform_kernel<4><<<grid, kThreads, 0, stream>>>(
          tiles, cinvt, bpt, scale, out, TC, changes_base);
      break;
    case 6:
      input_transform_kernel<6><<<grid, kThreads, 0, stream>>>(
          tiles, cinvt, bpt, scale, out, TC, changes_base);
      break;
    case 8:
      input_transform_kernel<8><<<grid, kThreads, 0, stream>>>(
          tiles, cinvt, bpt, scale, out, TC, changes_base);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
