// Training BatchNorm over a channels-last [rows, C] activation (rows =
// N*H*W), float32 statistics, for bfloat16 and float32 inputs:
//
//   s2a_channel_moments    x    -> (sum x, sum x^2), and with gamma given
//                                  mean, var, rstd, mul = gamma*rstd and the
//                                  running statistics, updated in place
//   s2a_bn_apply           x    -> y = cast((x - mean)*mul + beta)
//   s2a_grad_channel_sums  g, x -> (sum g, sum g*x), and with mean given
//                                  dgamma, a = dbeta/n, b = rstd*dgamma/n
//   s2a_bn_dx              g, x -> dx = cast(mul*((g - a) - (x - mean)*b))
//
// Replace the TPU kernels s2anet_tpu/ops/pallas/moments.py::_moments_kernel
// (:43) and ::_pair_kernel (:60), and the jnp expressions around them that
// XLA fuses into single passes on the TPU: the normalise
// (s2anet_tpu/models/bn.py:108) and the closed-form dx (:137-140). The
// Pallas kernels ran a sequential grid that carried one [1, C] sum in VMEM
// from step to step, and folded narrow channels (C < 128) into full
// 128-lane rows; both are TPU layout matters. PyTorch has no such fusion,
// so the normalise and dx are kernels here: as float32 PyTorch passes they
// moved about 36 bytes per element forward and 62 backward, and took some
// 40 launches per BN layer.
//
// What bounds them on an H100: memory. Per element the forward reads x
// twice and writes y once (6 bytes in bf16), the backward reads g and x
// twice and writes dx once (10 bytes). The two global reductions still
// cost a pass each before the pass that needs their result: no SM holds a
// layer-1 activation (8 x 256 x 256 x 256 bf16, 268 MB), and the 50 MB L2
// holds only the later layers' inputs.
//
// The sums are a two-pass reduction with no atomics, so the statistics are
// the same from run to run: a 2-D grid over row chunks x channel vectors
// writes each block's partial sums to a [chunks, 2, C] float32 workspace,
// and a second small kernel adds the chunks in a fixed order and then
// finishes the per-channel vectors the elementwise pass needs. The
// finishing step and the elementwise kernels round each operation on its
// own (__fadd_rn, __fmul_rn, ..., never contracted into an FMA) in the order
// of the plain PyTorch expressions, so given the same per-channel vectors
// they give the plain version's bits; the partial sums keep their FMAs.
//
// Every kernel walks 16-byte vectors (8 bf16 or 4 float32 channels) of
// consecutive rows, threadIdx.x over channel vectors and threadIdx.y over
// rows, 4 rows in flight per thread; a warp's loads cover whole 128-byte
// row segments. The sum chunk count (from the wrapper) gives about 8 blocks
// of 256 threads per SM; the elementwise kernels launch one resident wave
// (from the occupancy calculator) that strides over the rows, each thread
// holding its channels' vectors in registers.

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

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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

// What the finishing step computes after the sums.
enum Finish { SUMS = 0, STATS = 1, GRAD = 2 };

struct FinishArgs {
  const float* gamma;  // STATS: gamma [C]
  float* run_mean;     // STATS: running statistics [C], updated in place
  float* run_var;
  long long* count;    // STATS: batches tracked, one added
  const float* mean;   // GRAD: the forward's mean and rstd [C]
  const float* rstd;
  float inv_n;         // 1/n rounded to float32, as PyTorch forms tensor / n
  float eps;
  float keep;          // running = keep*running + take*batch (flax momentum)
  float take;
};

// grid ceil(C/32), block (32, 8): channel c sums its chunks in a fixed order
// into out[0:2, c], then finishes:
//   STATS: out[2:6, c] = mean, var, rstd, mul; running statistics updated,
//          one added to the count of batches
//   GRAD:  out[2:5, c] = dgamma, a, b (dbeta = out[0, c])
template <int MODE>
__global__ void finish_sums(const float* __restrict__ ws, float* __restrict__ out,
                            int C, int chunks, FinishArgs f) {
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
  if (ty != 0 || c >= C) return;
  for (int y = 1; y < 8; ++y) {
    a += s_a[y][tx];
    b += s_b[y][tx];
  }
  out[c] = a;
  out[C + c] = b;
  if (MODE == STATS) {
    // mean = s/n; var = max(q/n - mean^2, 0); rstd = rsqrt(var + eps)
    const float mean = __fmul_rn(a, f.inv_n);
    const float d = __fsub_rn(__fmul_rn(b, f.inv_n), __fmul_rn(mean, mean));
    const float var = d < 0.f ? 0.f : d;  // NaN stays NaN, as clamp_min
    const float rstd = rsqrtf(__fadd_rn(var, f.eps));
    out[2 * C + c] = mean;
    out[3 * C + c] = var;
    out[4 * C + c] = rstd;
    out[5 * C + c] = __fmul_rn(f.gamma[c], rstd);
    f.run_mean[c] = __fadd_rn(__fmul_rn(f.keep, f.run_mean[c]), __fmul_rn(f.take, mean));
    f.run_var[c] = __fadd_rn(__fmul_rn(f.keep, f.run_var[c]), __fmul_rn(f.take, var));
    if (c == 0) *f.count += 1;
  } else if (MODE == GRAD) {
    // dgamma = (sum gx - mean*sum g)*rstd; a = dbeta/n; b = rstd*dgamma/n
    const float rstd = f.rstd[c];
    const float dgamma = __fmul_rn(__fsub_rn(b, __fmul_rn(f.mean[c], a)), rstd);
    out[2 * C + c] = dgamma;
    out[3 * C + c] = __fmul_rn(a, f.inv_n);
    out[4 * C + c] = __fmul_rn(__fmul_rn(rstd, dgamma), f.inv_n);
  }
}

template <typename T, bool PAIR, int MODE>
int launch_sums(const void* x, const void* g, void* out, void* ws, int rows, int C,
                int chunks, const FinishArgs& f, cudaStream_t s) {
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
  finish_sums<MODE><<<(C + 31) / 32, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), C, (int)grid.x, f);
  return (int)cudaGetLastError();
}

// Per-channel vectors of the elementwise kernels: V consecutive channels
// from col, loaded once per thread (scalar loads: no alignment asked of the
// parameter tensors).
template <int V>
__device__ __forceinline__ void load_channels(float (&dst)[V], const float* __restrict__ src,
                                              long long col) {
#pragma unroll
  for (int k = 0; k < V; ++k) dst[k] = src[col + k];
}

// y = cast((x - mean)*mul + beta): one read of x, one write of y.
template <typename T>
__global__ void __launch_bounds__(NT)
bn_apply(const T* __restrict__ x, const float* __restrict__ mean,
         const float* __restrict__ mul, const float* __restrict__ beta,
         T* __restrict__ y, long long rows, int C) {
  constexpr int V = Vec<T>::N;
  const int TY = blockDim.y;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= C / V) return;
  const long long col = (long long)cv * V;
  float m[V], k[V], bt[V];
  load_channels<V>(m, mean, col);
  load_channels<V>(k, mul, col);
  load_channels<V>(bt, beta, col);
  const long long step = (long long)gridDim.x * TY * RU;
  for (long long r = (long long)blockIdx.x * TY * RU + threadIdx.y; r < rows; r += step) {
    Vec<T> xv[RU];
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      const long long rr = r + (long long)u * TY;
      if (rr < rows) xv[u].u = *reinterpret_cast<const uint4*>(x + rr * C + col);
    }
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      const long long rr = r + (long long)u * TY;
      if (rr >= rows) break;
      Vec<T> yv;
#pragma unroll
      for (int j = 0; j < V; ++j)
        yv.v[j] = from_f32<T>(__fadd_rn(
            __fmul_rn(__fsub_rn(to_f32(xv[u].v[j]), m[j]), k[j]), bt[j]));
      *reinterpret_cast<uint4*>(y + rr * C + col) = yv.u;
    }
  }
}

// dx = cast(mul*((g - a) - (x - mean)*b)): one read of g and x, one write.
template <typename T>
__global__ void __launch_bounds__(NT)
bn_dx(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ mean,
      const float* __restrict__ mul, const float* __restrict__ ca,
      const float* __restrict__ cb, T* __restrict__ dx, long long rows, int C) {
  constexpr int V = Vec<T>::N;
  const int TY = blockDim.y;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= C / V) return;
  const long long col = (long long)cv * V;
  float m[V], k[V], av[V], bv[V];
  load_channels<V>(m, mean, col);
  load_channels<V>(k, mul, col);
  load_channels<V>(av, ca, col);
  load_channels<V>(bv, cb, col);
  const long long step = (long long)gridDim.x * TY * RU;
  for (long long r = (long long)blockIdx.x * TY * RU + threadIdx.y; r < rows; r += step) {
    Vec<T> xv[RU], gv[RU];
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      const long long rr = r + (long long)u * TY;
      if (rr < rows) {
        xv[u].u = *reinterpret_cast<const uint4*>(x + rr * C + col);
        gv[u].u = *reinterpret_cast<const uint4*>(g + rr * C + col);
      }
    }
#pragma unroll
    for (int u = 0; u < RU; ++u) {
      const long long rr = r + (long long)u * TY;
      if (rr >= rows) break;
      Vec<T> dv;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = __fsub_rn(
            __fsub_rn(to_f32(gv[u].v[j]), av[j]),
            __fmul_rn(__fsub_rn(to_f32(xv[u].v[j]), m[j]), bv[j]));
        dv.v[j] = from_f32<T>(__fmul_rn(k[j], t));
      }
      *reinterpret_cast<uint4*>(dx + rr * C + col) = dv.u;
    }
  }
}

// Block (TX, NT/TX) over channel vectors x rows, and a grid of one resident
// wave: grid.y covers the channel vectors, grid.x strides over the rows.
// The wave (SMs x resident blocks of this kernel) is asked once per kernel.
template <typename K>
int elementwise_grid(K kernel, int V, long long rows, int C, dim3* grid, dim3* block) {
  static int wave = 0;
  if (wave == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, 0);
    if (e != cudaSuccess) return (int)e;
    wave = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int nvec = C / V;
  const int tx = nvec < 32 ? nvec : 32;
  *block = dim3(tx, NT / tx);
  const int gy = (nvec + tx - 1) / tx;
  const long long tiles = (rows + (long long)block->y * RU - 1) / ((long long)block->y * RU);
  long long gx = (wave + gy - 1) / gy;
  if (gx > tiles) gx = tiles;
  *grid = dim3((unsigned)(gx > 0 ? gx : 1), (unsigned)gy);
  return 0;
}

template <typename T>
int launch_apply(const void* x, const void* mean, const void* mul, const void* beta,
                 void* y, int rows, int C, cudaStream_t s) {
  if (C % Vec<T>::N != 0) return (int)cudaErrorInvalidValue;
  dim3 grid, block;
  const int e = elementwise_grid(bn_apply<T>, Vec<T>::N, rows, C, &grid, &block);
  if (e != 0) return e;
  bn_apply<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(mul), static_cast<const float*>(beta),
      static_cast<T*>(y), rows, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dx(const void* g, const void* x, const void* mean, const void* mul,
              const void* a, const void* b, void* dx, int rows, int C, cudaStream_t s) {
  if (C % Vec<T>::N != 0) return (int)cudaErrorInvalidValue;
  dim3 grid, block;
  const int e = elementwise_grid(bn_dx<T>, Vec<T>::N, rows, C, &grid, &block);
  if (e != 0) return e;
  bn_dx<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(mul), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<T*>(dx), rows, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [rows, C] (channels last, 16-byte aligned; dtype 0 = float32, C % 4 == 0,
// 1 = bfloat16, C % 8 == 0); out float32, ws float32 [chunks, 2, C] scratch.
// With gamma null: out [2, C] = sum, sum of squares. Otherwise out [6, C] =
// sum, sum of squares, mean, var, rstd, mul = gamma*rstd;
// run_mean / run_var [C] become keep*running + take*(mean / var) and the
// int64 count gains one. Returns the launches' cudaError_t.
int s2a_channel_moments(const void* x, void* out, void* ws, int rows, int C, int chunks,
                        int dtype, const void* gamma, void* run_mean, void* run_var,
                        void* count, float eps, float keep, float take, void* stream) {
  if (rows == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FinishArgs f{static_cast<const float*>(gamma), static_cast<float*>(run_mean),
               static_cast<float*>(run_var), static_cast<long long*>(count), nullptr,
               nullptr, 1.0f / (float)rows, eps, keep, take};
  if (gamma == nullptr) {
    if (dtype == 0) return launch_sums<float, false, SUMS>(x, nullptr, out, ws, rows, C, chunks, f, s);
    if (dtype == 1)
      return launch_sums<__nv_bfloat16, false, SUMS>(x, nullptr, out, ws, rows, C, chunks, f, s);
  } else {
    if (dtype == 0) return launch_sums<float, false, STATS>(x, nullptr, out, ws, rows, C, chunks, f, s);
    if (dtype == 1)
      return launch_sums<__nv_bfloat16, false, STATS>(x, nullptr, out, ws, rows, C, chunks, f, s);
  }
  return (int)cudaErrorInvalidValue;
}

// g, x [rows, C], one type (as above); out float32. With mean null:
// out [2, C] = sum g, sum g*x. Otherwise out [5, C] = sum g (= dbeta),
// sum g*x, dgamma, a = dbeta/n, b = rstd*dgamma/n, from the forward's mean
// and rstd [C].
int s2a_grad_channel_sums(const void* g, const void* x, void* out, void* ws, int rows,
                          int C, int chunks, int dtype, const void* mean,
                          const void* rstd, void* stream) {
  if (rows == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FinishArgs f{nullptr, nullptr, nullptr, nullptr, static_cast<const float*>(mean),
               static_cast<const float*>(rstd), 1.0f / (float)rows, 0.f, 0.f, 0.f};
  if (mean == nullptr) {
    if (dtype == 0) return launch_sums<float, true, SUMS>(x, g, out, ws, rows, C, chunks, f, s);
    if (dtype == 1)
      return launch_sums<__nv_bfloat16, true, SUMS>(x, g, out, ws, rows, C, chunks, f, s);
  } else {
    if (dtype == 0) return launch_sums<float, true, GRAD>(x, g, out, ws, rows, C, chunks, f, s);
    if (dtype == 1)
      return launch_sums<__nv_bfloat16, true, GRAD>(x, g, out, ws, rows, C, chunks, f, s);
  }
  return (int)cudaErrorInvalidValue;
}

// x, y [rows, C] (as above); mean, mul, beta float32 [C].
int s2a_bn_apply(const void* x, const void* mean, const void* mul, const void* beta,
                 void* y, int rows, int C, int dtype, void* stream) {
  if (rows == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_apply<float>(x, mean, mul, beta, y, rows, C, s);
  if (dtype == 1) return launch_apply<__nv_bfloat16>(x, mean, mul, beta, y, rows, C, s);
  return (int)cudaErrorInvalidValue;
}

// g, x, dx [rows, C] (as above); mean, mul, a, b float32 [C].
int s2a_bn_dx(const void* g, const void* x, const void* mean, const void* mul,
              const void* a, const void* b, void* dx, int rows, int C, int dtype,
              void* stream) {
  if (rows == 0 || C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dx<float>(g, x, mean, mul, a, b, dx, rows, C, s);
  if (dtype == 1) return launch_dx<__nv_bfloat16>(g, x, mean, mul, a, b, dx, rows, C, s);
  return (int)cudaErrorInvalidValue;
}

const char* s2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
