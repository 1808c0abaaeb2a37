// Per-channel moment reductions of training BatchNorm over a channels-last
// [rows, C] input (rows = N*H*W), float32 accumulation:
//
//   s2a_channel_moments    x    -> (sum x, sum x^2)    the BN forward
//   s2a_grad_channel_sums  g, x -> (sum g, sum g*x)    the BN backward
//
// Replace the TPU kernels s2anet_tpu/ops/pallas/moments.py::_moments_kernel
// and ::_pair_kernel. Those ran a sequential grid that carried one [1, C]
// sum in VMEM from step to step, and folded narrow channels (C < 128) into
// full 128-lane rows; both are TPU layout matters. Here blocks run in
// parallel, so the sum is a two-pass reduction: a 2-D grid over row chunks x
// channel vectors writes each block's partial sums to a [chunks, 2, C]
// float32 workspace, and a second small kernel adds the chunks in a fixed
// order. There are no atomics, so the statistics are the same from run to
// run.
//
// What bounds them on an H100: memory. Each input element is read once and
// costs 3 float32 operations; the stem BN of R-50 at 1024^2, batch 8 reads
// 2.1 M rows x 64 channels. Each thread loads 16-byte vectors (8 bf16 or 4
// float32 channels) of consecutive rows in a chunk, 4 rows in flight; a
// warp's loads cover whole 128-byte row segments. The chunk count (from the
// wrapper) gives about 8 blocks of 256 threads per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block
constexpr int RU = 4;    // rows in flight per thread

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
  union {
    uint4 u;
    T v[N];
  };
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// block (TX, TY): threadIdx.x walks channel vectors, threadIdx.y rows.
// PAIR = false: a = x, b = x*x over input x; PAIR = true: a = g, b = g*x.
template <typename T, bool PAIR>
__global__ void __launch_bounds__(NT)
partial_sums(const T* __restrict__ x, const T* __restrict__ gr,
             float* __restrict__ ws, int rows, int C, int rows_per_chunk) {
  constexpr int V = Vec<T>::N;
  __shared__ float s_a[NT * V];
  __shared__ float s_b[NT * V];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int nvec = C / V;
  const int cv = blockIdx.y * TX + tx;
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long r1 = r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;

  float a[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
  if (cv < nvec) {
    const long long col = (long long)cv * V;
    for (long long r = r0 + ty; r < r1; r += (long long)TY * RU) {
      Vec<T> xv[RU], gv[RU];
#pragma unroll
      for (int u = 0; u < RU; ++u) {
        const long long rr = r + (long long)u * TY;
        xv[u].u = rr < r1 ? *reinterpret_cast<const uint4*>(x + rr * C + col)
                          : make_uint4(0u, 0u, 0u, 0u);
        if (PAIR)
          gv[u].u = rr < r1 ? *reinterpret_cast<const uint4*>(gr + rr * C + col)
                            : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < RU; ++u) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xf = to_f32(xv[u].v[k]);
          if (PAIR) {
            const float gf = to_f32(gv[u].v[k]);
            a[k] += gf;
            b[k] += gf * xf;
          } else {
            a[k] += xf;
            b[k] += xf * xf;
          }
        }
      }
    }
  }
  // fixed-order sum over the TY row lanes
  const int slot = ty * TX + tx;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s_a[slot * V + k] = a[k];
    s_b[slot * V + k] = b[k];
  }
  __syncthreads();
  if (ty == 0 && cv < nvec) {
    for (int y = 1; y < TY; ++y) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a[k] += s_a[(y * TX + tx) * V + k];
        b[k] += s_b[(y * TX + tx) * V + k];
      }
    }
    float* wa = ws + (long long)blockIdx.x * 2 * C + (long long)cv * V;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      wa[k] = a[k];
      wa[C + k] = b[k];
    }
  }
}

// grid ceil(C/32), block (32, 8): channel c sums its chunks in a fixed order
__global__ void finish_sums(const float* __restrict__ ws, float* __restrict__ out_a,
                            float* __restrict__ out_b, int C, int chunks) {
  __shared__ float s_a[8][32];
  __shared__ float s_b[8][32];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * 32 + tx;
  float a = 0.f, b = 0.f;
  if (c < C) {
    for (int k = ty; k < chunks; k += 8) {
      a += ws[(long long)k * 2 * C + c];
      b += ws[(long long)k * 2 * C + C + c];
    }
  }
  s_a[ty][tx] = a;
  s_b[ty][tx] = b;
  __syncthreads();
  if (ty == 0 && c < C) {
    for (int y = 1; y < 8; ++y) {
      a += s_a[y][tx];
      b += s_b[y][tx];
    }
    out_a[c] = a;
    out_b[c] = b;
  }
}

template <typename T, bool PAIR>
int launch(const void* x, const void* g, void* out_a, void* out_b, void* ws,
           int rows, int C, int chunks, cudaStream_t s) {
  constexpr int V = Vec<T>::N;
  if (C % V != 0 || chunks < 1) return (int)cudaErrorInvalidValue;
  const int nvec = C / V;
  const int tx = nvec < 32 ? nvec : 32;
  dim3 block(tx, NT / tx);
  const int per = (rows + chunks - 1) / chunks;
  dim3 grid((unsigned)((rows + per - 1) / per), (unsigned)((nvec + tx - 1) / tx));
  partial_sums<T, PAIR><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<float*>(ws), rows, C, per);
  finish_sums<<<(C + 31) / 32, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(out_a),
      static_cast<float*>(out_b), C, (int)grid.x);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, C] (channels last, 16-byte aligned; dtype 0 = float32, C % 4 == 0,
// 1 = bfloat16, C % 8 == 0) -> sum [C], sumsq [C] float32. ws: float32
// [chunks, 2, C] scratch. Returns the launches' cudaError_t.
int s2a_channel_moments(const void* x, void* sum, void* sumsq, void* ws, int rows,
                        int C, int chunks, int dtype, void* stream) {
  if (rows == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, false>(x, nullptr, sum, sumsq, ws, rows, C, chunks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, false>(x, nullptr, sum, sumsq, ws, rows, C, chunks, s);
  return (int)cudaErrorInvalidValue;
}

// g, x [rows, C], one type (as above) -> sum_g [C], sum_gx [C] float32.
int s2a_grad_channel_sums(const void* g, const void* x, void* sum_g, void* sum_gx,
                          void* ws, int rows, int C, int chunks, int dtype,
                          void* stream) {
  if (rows == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, true>(x, g, sum_g, sum_gx, ws, rows, C, chunks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, true>(x, g, sum_g, sum_gx, ws, rows, C, chunks, s);
  return (int)cudaErrorInvalidValue;
}

const char* s2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
