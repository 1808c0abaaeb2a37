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
//   s2a_bn_apply_finish    x, (sum x, sum x^2) -> the forward's finishing
//                                  step and y, one launch
//   s2a_bn_dx_finish       g, x, (sum g, sum g*x) -> the backward's finishing
//                                  step and dx, one launch
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
// The sums and their finishing step are one launch per layer and
// direction (channel_sums; redesigned for Hopper). The grid is one resident
// wave (the wrapper sizes it from cudaOccupancyMaxActiveClusters): channel
// groups x blocks along the rows, in thread block clusters of 8 along the
// rows, each block striding over tiles of rows (4 rows in flight a thread,
// 2 in the pair kernel, which reads two inputs). Each thread sums its rows;
// the block adds its row lanes value by value in a fixed order; the cluster
// adds its 8 block partials through distributed shared memory in rank
// order and writes one [2, C] partial per cluster to a workspace. After a
// cluster barrier, rank 0 draws a ticket for its channel group (an atomic
// add with release and acquire semantics at device scope, which orders the
// whole cluster's writes: no fence in every thread). The cluster that draws
// the last ticket adds the cluster partials, each rank a fixed range of them
// in a fixed order, pushes its sums into rank 0's shared memory, and rank 0
// adds the ranks in rank order and runs the finishing step, a thread a
// channel, on inputs it loaded at the start; then it sets the ticket back
// to 0, so one persistent buffer of tickets serves every launch and every
// CUDA-graph replay, with no memset. Which cluster finishes last changes no
// addition: the statistics are the same bits from run to run. One wave
// leaves no partly filled second wave, and one launch no second kernel
// whose few blocks walk every partial.
//
// What bounds it on an H100: reading the input once (2 bytes a bf16
// element, 4 for the pair); on the small layers of R-50's stages 3-4 (8-17
// MB) the fixed cost of a launch and of the last cluster's tail (the
// ticket, the workspace reads, the finishing) is of the order of the read.
//
// Data-parallel training adds the sums over the ranks between the sums and
// the finishing step: each rank launches the sums kernel without its
// finishing step (SUMS), the [2, C] sums are all-reduced, and the kernel
// that reads the finishing step's result does the finishing itself, so it
// costs no launch of its own: s2a_bn_apply_finish is bn_apply whose threads
// first run finish<STATS>'s arithmetic on the global sums for their V
// channels (1/n from the global row count) and s2a_bn_dx_finish is bn_dx
// with finish<GRAD>'s. Each thread finishes in registers; the threads of
// block column 0, row lane 0, which hold every channel vector once, also
// write the outputs of finish<MODE> (statistics, running statistics and
// count; dgamma, dbeta, the dx coefficients). On equal sums they write the
// bits the one-launch sums kernel and bn_apply / bn_dx would. About 30
// operations and a few loads a channel a thread, against a pass over the
// rows. A rank without rows (sampled statistics whose prefix ends on an
// earlier rank) contributes zero sums; its dx takes a = b = 0 on rows at or
// past stat_rows, as the one-process dx's second range.

// The finishing step and the elementwise kernels round each operation on
// its own (__fadd_rn, __fmul_rn, ..., never contracted into an FMA) in the
// order of the plain PyTorch expressions, so given the same per-channel
// vectors they give the plain version's bits; the partial sums keep their
// FMAs.
//
// Every kernel walks 16-byte vectors (8 bf16 or 4 float32 channels) of
// consecutive rows, threadIdx.x over channel vectors and threadIdx.y over
// rows, 4 rows in flight per thread; a warp's loads cover whole 128-byte
// row segments. The elementwise kernels launch one resident wave (from the
// occupancy calculator) that strides over the rows, each thread holding its
// channels' vectors in registers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int NT = 256;  // threads per block
constexpr int RU = 4;    // rows in flight per thread of the elementwise kernels
constexpr int CL = 8;    // blocks per cluster of the sums kernel

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

// The per-channel inputs of the finishing step for channel c, loaded before
// the sums so that their latency is off the kernel's tail:
//   STATS: gamma, running mean, running var; GRAD: mean, rstd
template <int MODE>
__device__ __forceinline__ void finish_inputs(int c, const FinishArgs& f, float (&in)[3]) {
  in[0] = in[1] = in[2] = 0.f;
  if (MODE == STATS) {
    in[0] = f.gamma[c];
    in[1] = f.run_mean[c];
    in[2] = f.run_var[c];
  } else if (MODE == GRAD) {
    in[0] = f.mean[c];
    in[1] = f.rstd[c];
  }
}

// The forward's finishing arithmetic from (sum x, sum x^2) over 1/inv_n rows:
// mean = s/n; var = max(q/n - mean^2, 0); rstd = rsqrt(var + eps); mul =
// gamma*rstd.
struct Stats {
  float mean, var, rstd, mul;
};
__device__ __forceinline__ Stats stats_of(float s, float q, float gamma, float inv_n, float eps) {
  Stats r;
  r.mean = __fmul_rn(s, inv_n);
  const float d = __fsub_rn(__fmul_rn(q, inv_n), __fmul_rn(r.mean, r.mean));
  r.var = d < 0.f ? 0.f : d;  // NaN stays NaN, as clamp_min
  r.rstd = rsqrtf(__fadd_rn(r.var, eps));
  r.mul = __fmul_rn(gamma, r.rstd);
  return r;
}

// The backward's, from (sum g, sum g*x) and the forward's mean and rstd:
// dgamma = (sum gx - mean*sum g)*rstd; a = dbeta/n; b = rstd*dgamma/n.
struct Coef {
  float dgamma, a, b;
};
__device__ __forceinline__ Coef coef_of(float sg, float sgx, float mean, float rstd, float inv_n) {
  Coef r;
  r.dgamma = __fmul_rn(__fsub_rn(sgx, __fmul_rn(mean, sg)), rstd);
  r.a = __fmul_rn(sg, inv_n);
  r.b = __fmul_rn(__fmul_rn(rstd, r.dgamma), inv_n);
  return r;
}

// Channel c's sums (a, b) go to out[0:2, c], then
//   STATS: out[2:6, c] = mean, var, rstd, mul; running statistics updated,
//          one added to the count of batches (by channel 0)
//   GRAD:  out[2:5, c] = dgamma, a, b (dbeta = out[0, c])
template <int MODE>
__device__ __forceinline__ void finish(float a, float b, int c, int C, float* __restrict__ out,
                                       const FinishArgs& f, const float (&in)[3]) {
  out[c] = a;
  out[C + c] = b;
  if (MODE == STATS) {
    const Stats st = stats_of(a, b, in[0], f.inv_n, f.eps);
    out[2 * C + c] = st.mean;
    out[3 * C + c] = st.var;
    out[4 * C + c] = st.rstd;
    out[5 * C + c] = st.mul;
    f.run_mean[c] = __fadd_rn(__fmul_rn(f.keep, in[1]), __fmul_rn(f.take, st.mean));
    f.run_var[c] = __fadd_rn(__fmul_rn(f.keep, in[2]), __fmul_rn(f.take, st.var));
    if (c == 0) *f.count += 1;
  } else if (MODE == GRAD) {
    const Coef k = coef_of(a, b, in[0], in[1], f.inv_n);
    out[2 * C + c] = k.dgamma;
    out[3 * C + c] = k.a;
    out[4 * C + c] = k.b;
  }
}

// The sums and their finishing step, one launch. Grid (chunks, groups) in
// clusters of CL blocks along the chunks (chunks a multiple of CL), block
// (TX, TY), TX*TY <= NT: threadIdx.x walks the channel vectors of group
// blockIdx.y (TX*V channels); threadIdx.y the rows of the tiles of TY*R
// rows that fall to block blockIdx.x, tile blockIdx.x + k*chunks.
// PAIR = false: a = x, b = x*x over input x; PAIR = true: a = g, b = g*x.
// ws holds one [2, C] partial per cluster; tickets[groups] are 0 between
// launches (the last cluster of each group sets its ticket back to 0).
// At most 64 registers (four blocks an SM, whose loads keep the memory busy):
// left to itself, ptxas picks 48 for the float32 moments and spills.
template <typename T, bool PAIR, int MODE>
__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT, 4)
channel_sums(const T* __restrict__ x, const T* __restrict__ gr, float* __restrict__ ws,
             float* __restrict__ out, unsigned* __restrict__ tickets, int rows, int C,
             FinishArgs f) {
  constexpr int V = Vec<T>::N;
  constexpr int R = PAIR ? 2 : 4;  // rows in flight a thread (moments.sums_rows)
  __shared__ float s_a[NT * V];
  __shared__ float s_b[NT * V];
  __shared__ float s_part[2 * 32 * V];     // the block's partial: [a | b]
  __shared__ float s_fin[CL * 2 * 32 * V];  // rank 0: the ranks' sums, pushed to it
  __shared__ int s_last;
  cg::cluster_group cluster = cg::this_cluster();
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int TX = blockDim.x, TY = blockDim.y;
  const int tid = ty * TX + tx, nt = TX * TY;   // nt >= W >= wc
  const int nvec = C / V;
  const int cv = blockIdx.y * TX + tx;
  const int W = TX * V;                         // channels of a whole group
  const int c0 = blockIdx.y * W;                // the group's first channel
  const int wc = C - c0 < W ? C - c0 : W;       // the channels it holds
  const int nv = 2 * wc;                        // its values: wc sums a, wc sums b
  const int rank = (int)cluster.block_rank();
  // rank 0 thread j < wc finishes channel c0 + j if its cluster ends up
  // last: its inputs are loaded now, off the kernel's tail
  float fin[3];
  finish_inputs<MODE>(c0 + (rank == 0 && tid < wc ? tid : 0), f, fin);

  // 1. this thread's sums over its rows of the block's tiles
  float a[V], b[V];
#pragma unroll
  for (int k = 0; k < V; ++k) a[k] = b[k] = 0.f;
  if (cv < nvec) {
    const long long col = (long long)cv * V;
    const long long step = (long long)gridDim.x * TY * R;
    for (long long r = (long long)blockIdx.x * TY * R + ty; r < rows; r += step) {
      Vec<T> xv[R], gv[R];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const long long rr = r + (long long)u * TY;
        xv[u].u = rr < rows ? *reinterpret_cast<const uint4*>(x + rr * C + col)
                            : make_uint4(0u, 0u, 0u, 0u);
        if (PAIR)
          gv[u].u = rr < rows ? *reinterpret_cast<const uint4*>(gr + rr * C + col)
                              : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < R; ++u) {
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
  // 2. the block's partial: each value over the TY row lanes, in order
  // (thread (tx, ty) holds channel j = tx*V + k at s_[ty*W + j])
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s_a[tid * V + k] = a[k];
    s_b[tid * V + k] = b[k];
  }
  __syncthreads();
  for (int v = tid; v < nv; v += nt) {
    const float* src = v < wc ? s_a : s_b;
    const int j = v < wc ? v : v - wc;
    float acc = 0.f;
    for (int y = 0; y < TY; ++y) acc += src[y * W + j];
    s_part[v] = acc;
  }
  cluster.sync();
  // 3. the cluster's partial: the CL blocks' partials, added in rank order
  // through distributed shared memory, to the workspace
  const long long wrow = (long long)(blockIdx.x / CL) * 2 * C;
  for (int v = rank * nt + tid; v < nv; v += CL * nt) {
    float acc = 0.f;
    for (int q = 0; q < CL; ++q) acc += cluster.map_shared_rank(s_part, q)[v];
    ws[wrow + (v < wc ? c0 + v : C + c0 + v - wc)] = acc;
  }
  // every partial read (each block's shared memory may go) and written; the
  // barrier orders the cluster's writes before rank 0's release below
  cluster.sync();
  // 4. a ticket per group (release and acquire at device scope): the
  // cluster that draws the last one adds up the cluster partials. Which
  // cluster that is does not change the order of any addition below.
  const int P = gridDim.x / CL;
  if (rank == 0 && tid == 0) {
    unsigned drawn;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(drawn) : "l"(tickets + blockIdx.y) : "memory");
    const int last = drawn == (unsigned)(P - 1);
    for (int q = 0; q < CL; ++q) *cluster.map_shared_rank(&s_last, q) = last;
  }
  cluster.sync();
  if (!s_last) return;
  // rank q adds the cluster partials [q*P/CL, (q+1)*P/CL), each value in S
  // ranges when the block's threads outnumber the values, and pushes its
  // sums to rank 0
  const int lo = rank * P / CL, hi = (rank + 1) * P / CL;
  const int S = nt / nv > 1 ? nt / nv : 1;
  for (int i = tid; i < nv * S; i += nt) {
    const int v = i % nv, s = i / nv;
    const int plo = lo + (hi - lo) * s / S, phi = lo + (hi - lo) * (s + 1) / S;
    const long long col = v < wc ? c0 + v : C + c0 + v - wc;
    float acc = 0.f;
#pragma unroll 8
    for (int p = plo; p < phi; ++p) acc += __ldcg(ws + (long long)p * 2 * C + col);
    s_a[i] = acc;
  }
  __syncthreads();
  float* to0 = cluster.map_shared_rank(s_fin, 0) + rank * nv;
  for (int v = tid; v < nv; v += nt) {
    float acc = 0.f;
    for (int s = 0; s < S; ++s) acc += s_a[s * nv + v];
    to0[v] = acc;
  }
  cluster.sync();
  if (rank != 0) return;
  // 5. rank 0: the ranks' sums in rank order, then the finishing step, a
  // thread a channel
  if (tid < wc) {
    float sa = 0.f, sb = 0.f;
    for (int q = 0; q < CL; ++q) {
      sa += s_fin[q * nv + tid];
      sb += s_fin[q * nv + wc + tid];
    }
    finish<MODE>(sa, sb, c0 + tid, C, out, f, fin);
  }
  if (tid == 0) tickets[blockIdx.y] = 0u;  // ready for the next launch
}

// No rows: zero sums in out[0:2] (a data-parallel rank whose statistics'
// prefix ends on an earlier rank adds these); nothing to finish over.
int zero_sums(void* out, int C, bool finishing, cudaStream_t s) {
  if (finishing) return (int)cudaErrorInvalidValue;
  return (int)cudaMemsetAsync(out, 0, 2 * (size_t)C * sizeof(float), s);
}

template <typename T, bool PAIR, int MODE>
int launch_sums(const void* x, const void* g, void* out, void* ws, void* tickets, int rows,
                int C, int chunks, const FinishArgs& f, cudaStream_t s) {
  constexpr int V = Vec<T>::N;
  if (C % V != 0 || chunks < CL || chunks % CL != 0) return (int)cudaErrorInvalidValue;
  const int nvec = C / V;
  const int tx = nvec < 32 ? nvec : 32;
  dim3 block(tx, NT / tx);
  dim3 grid((unsigned)chunks, (unsigned)((nvec + tx - 1) / tx));
  channel_sums<T, PAIR, MODE><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<float*>(ws),
      static_cast<float*>(out), static_cast<unsigned*>(tickets), rows, C, f);
  return (int)cudaGetLastError();
}

// Blocks of one resident wave of the sums kernel (whole clusters).
template <typename T, bool PAIR, int MODE>
int sums_wave(int* blocks) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  int clusters = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &clusters, reinterpret_cast<const void*>(&channel_sums<T, PAIR, MODE>), &cfg);
  *blocks = clusters * CL;
  return (int)e;
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

// y = cast((x - mean)*mul + beta) over the rows of this thread's channel
// vector at col: one read of x, one write of y.
template <typename T, int V>
__device__ __forceinline__ void apply_rows(const T* __restrict__ x, T* __restrict__ y,
                                           const float (&m)[V], const float (&k)[V],
                                           const float (&bt)[V], long long rows, int C,
                                           long long col) {
  const int TY = blockDim.y;
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

// dx = cast(mul*((g - a) - (x - mean)*b)) over the rows of this thread's
// channel vector: one read of g and x, one write. SPLIT: rows at or past
// stat_rows take a = b = 0 (dx = mul*((g - 0) - (x - mean)*0), the bits of a
// launch given zero vectors).
template <typename T, int V, bool SPLIT>
__device__ __forceinline__ void dx_rows(const T* __restrict__ g, const T* __restrict__ x,
                                        T* __restrict__ dx, const float (&m)[V],
                                        const float (&k)[V], const float (&av)[V],
                                        const float (&bv)[V], long long rows,
                                        long long stat_rows, int C, long long col) {
  const int TY = blockDim.y;
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
      const bool st = !SPLIT || rr < stat_rows;
      Vec<T> dv;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float t = __fsub_rn(
            __fsub_rn(to_f32(gv[u].v[j]), st ? av[j] : 0.f),
            __fmul_rn(__fsub_rn(to_f32(xv[u].v[j]), m[j]), st ? bv[j] : 0.f));
        dv.v[j] = from_f32<T>(__fmul_rn(k[j], t));
      }
      *reinterpret_cast<uint4*>(dx + rr * C + col) = dv.u;
    }
  }
}

// y = cast((x - mean)*mul + beta), mean and mul given.
template <typename T>
__global__ void __launch_bounds__(NT)
bn_apply(const T* __restrict__ x, const float* __restrict__ mean,
         const float* __restrict__ mul, const float* __restrict__ beta,
         T* __restrict__ y, long long rows, int C) {
  constexpr int V = Vec<T>::N;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= C / V) return;
  const long long col = (long long)cv * V;
  float m[V], k[V], bt[V];
  load_channels<V>(m, mean, col);
  load_channels<V>(k, mul, col);
  load_channels<V>(bt, beta, col);
  apply_rows<T, V>(x, y, m, k, bt, rows, C, col);
}

// The threads that write a fused kernel's per-channel outputs: block column
// 0, row lane 0. grid.y x threadIdx.x span the channel vectors, so each
// channel has exactly one writer.
__device__ __forceinline__ bool channel_writer() {
  return blockIdx.x == 0 && threadIdx.y == 0;
}

// bn_apply whose mean and mul come from the global sums [2, C] (sum x, sum
// x^2): each thread runs finish<STATS>'s arithmetic for its V channels; the
// writers also write out [6, C], the running statistics and the count, as
// finish<STATS> does.
template <typename T>
__global__ void __launch_bounds__(NT)
bn_apply_finish(const T* __restrict__ x, const float* __restrict__ sums,
                const float* __restrict__ beta, float* __restrict__ out, T* __restrict__ y,
                long long rows, int C, FinishArgs f) {
  constexpr int V = Vec<T>::N;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= C / V) return;
  const long long col = (long long)cv * V;
  const bool writer = channel_writer();
  float m[V], k[V], bt[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = (int)col + j;
    const float s = sums[c], q = sums[C + c];
    const Stats st = stats_of(s, q, f.gamma[c], f.inv_n, f.eps);
    m[j] = st.mean;
    k[j] = st.mul;
    bt[j] = beta[c];
    if (writer) {
      float in[3];
      finish_inputs<STATS>(c, f, in);
      finish<STATS>(s, q, c, C, out, f, in);
    }
  }
  apply_rows<T, V>(x, y, m, k, bt, rows, C, col);
}

// a, b, mean and mul given.
template <typename T>
__global__ void __launch_bounds__(NT)
bn_dx(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ mean,
      const float* __restrict__ mul, const float* __restrict__ ca,
      const float* __restrict__ cb, T* __restrict__ dx, long long rows, int C) {
  constexpr int V = Vec<T>::N;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= C / V) return;
  const long long col = (long long)cv * V;
  float m[V], k[V], av[V], bv[V];
  load_channels<V>(m, mean, col);
  load_channels<V>(k, mul, col);
  load_channels<V>(av, ca, col);
  load_channels<V>(bv, cb, col);
  dx_rows<T, V, false>(g, x, dx, m, k, av, bv, rows, rows, C, col);
}

// bn_dx whose a and b come from the global sums [2, C] (sum g, sum g*x) and
// the forward's mean and rstd (finish<GRAD>'s arithmetic, each thread for
// its V channels); a = b = 0 on rows at or past stat_rows. The writers also
// write out [5, C] as finish<GRAD> does.
template <typename T>
__global__ void __launch_bounds__(NT)
bn_dx_finish(const T* __restrict__ g, const T* __restrict__ x, const float* __restrict__ sums,
             const float* __restrict__ mul, float* __restrict__ out, T* __restrict__ dx,
             long long rows, long long stat_rows, int C, FinishArgs f) {
  constexpr int V = Vec<T>::N;
  const int cv = blockIdx.y * blockDim.x + threadIdx.x;
  if (cv >= C / V) return;
  const long long col = (long long)cv * V;
  const bool writer = channel_writer();
  float m[V], k[V], av[V], bv[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int c = (int)col + j;
    const float sg = sums[c], sgx = sums[C + c];
    float in[3] = {f.mean[c], f.rstd[c], 0.f};
    const Coef cf = coef_of(sg, sgx, in[0], in[1], f.inv_n);
    m[j] = in[0];
    k[j] = mul[c];
    av[j] = cf.a;
    bv[j] = cf.b;
    if (writer) finish<GRAD>(sg, sgx, c, C, out, f, in);
  }
  dx_rows<T, V, true>(g, x, dx, m, k, av, bv, rows, stat_rows, C, col);
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
int launch_apply_finish(const void* x, const void* sums, const void* beta, void* out, void* y,
                        int rows, int C, const FinishArgs& f, cudaStream_t s) {
  if (C % Vec<T>::N != 0) return (int)cudaErrorInvalidValue;
  dim3 grid, block;
  const int e = elementwise_grid(bn_apply_finish<T>, Vec<T>::N, rows, C, &grid, &block);
  if (e != 0) return e;
  bn_apply_finish<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const float*>(sums),
      static_cast<const float*>(beta), static_cast<float*>(out), static_cast<T*>(y), rows, C,
      f);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dx_finish(const void* g, const void* x, const void* sums, const void* mul,
                     void* out, void* dx, int rows, int stat_rows, int C, const FinishArgs& f,
                     cudaStream_t s) {
  if (C % Vec<T>::N != 0) return (int)cudaErrorInvalidValue;
  dim3 grid, block;
  const int e = elementwise_grid(bn_dx_finish<T>, Vec<T>::N, rows, C, &grid, &block);
  if (e != 0) return e;
  bn_dx_finish<T><<<grid, block, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(x), static_cast<const float*>(sums),
      static_cast<const float*>(mul), static_cast<float*>(out), static_cast<T*>(dx), rows,
      stat_rows, C, f);
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
// 1 = bfloat16, C % 8 == 0); out float32; ws float32 [chunks/8, 2, C]
// scratch; tickets uint32 [ceil(C/(32*V))], zero (and left zero) by every
// launch; chunks (blocks along the rows) a multiple of 8. With gamma null: out [2, C] = sum, sum of
// squares. Otherwise out [6, C] = sum, sum of squares, mean, var, rstd,
// mul = gamma*rstd; run_mean / run_var [C] become keep*running +
// take*(mean / var) and the int64 count gains one. One launch; returns its
// cudaError_t. rows = 0: out [2, C] = 0 with gamma null (no launch), an
// error otherwise.
int s2a_channel_moments(const void* x, void* out, void* ws, void* tickets, int rows, int C,
                        int chunks, int dtype, const void* gamma, void* run_mean,
                        void* run_var, void* count, float eps, float keep, float take,
                        void* stream) {
  if (C == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return zero_sums(out, C, gamma != nullptr, s);
  FinishArgs f{static_cast<const float*>(gamma), static_cast<float*>(run_mean),
               static_cast<float*>(run_var), static_cast<long long*>(count), nullptr,
               nullptr, 1.0f / (float)rows, eps, keep, take};
  const bool stats = gamma != nullptr;
  if (dtype == 0)
    return stats ? launch_sums<float, false, STATS>(x, nullptr, out, ws, tickets, rows, C, chunks, f, s)
                 : launch_sums<float, false, SUMS>(x, nullptr, out, ws, tickets, rows, C, chunks, f, s);
  if (dtype == 1)
    return stats ? launch_sums<__nv_bfloat16, false, STATS>(x, nullptr, out, ws, tickets, rows, C,
                                                            chunks, f, s)
                 : launch_sums<__nv_bfloat16, false, SUMS>(x, nullptr, out, ws, tickets, rows, C,
                                                           chunks, f, s);
  return (int)cudaErrorInvalidValue;
}

// g, x [rows, C], one type; ws, tickets and chunks as above; out float32.
// With mean null: out [2, C] = sum g, sum g*x. Otherwise out [5, C] = sum g
// (= dbeta), sum g*x, dgamma, a = dbeta/n, b = rstd*dgamma/n, from the
// forward's mean and rstd [C]; n, the rows the forward's statistics came
// from, is rows for full-batch statistics and fewer for sampled ones (the
// sums still run over all rows). rows = 0: as s2a_channel_moments.
int s2a_grad_channel_sums(const void* g, const void* x, void* out, void* ws, void* tickets,
                          int rows, int C, int chunks, int dtype, const void* mean,
                          const void* rstd, int n, void* stream) {
  if (C == 0) return 0;
  if (mean != nullptr && n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows == 0) return zero_sums(out, C, mean != nullptr, s);
  FinishArgs f{nullptr, nullptr, nullptr, nullptr, static_cast<const float*>(mean),
               static_cast<const float*>(rstd), 1.0f / (float)n, 0.f, 0.f, 0.f};
  const bool grad = mean != nullptr;
  if (dtype == 0)
    return grad ? launch_sums<float, true, GRAD>(x, g, out, ws, tickets, rows, C, chunks, f, s)
                : launch_sums<float, true, SUMS>(x, g, out, ws, tickets, rows, C, chunks, f, s);
  if (dtype == 1)
    return grad ? launch_sums<__nv_bfloat16, true, GRAD>(x, g, out, ws, tickets, rows, C, chunks, f, s)
                : launch_sums<__nv_bfloat16, true, SUMS>(x, g, out, ws, tickets, rows, C, chunks, f, s);
  return (int)cudaErrorInvalidValue;
}

// *blocks = the blocks of one resident wave of the sums kernel for dtype
// (as above) and pair (0: moments, 1: g, x pairs), in whole clusters of 8.
int s2a_sums_wave(int dtype, int pair, void* blocks) {
  int* n = static_cast<int*>(blocks);
  if (dtype == 0) return pair ? sums_wave<float, true, GRAD>(n) : sums_wave<float, false, STATS>(n);
  if (dtype == 1)
    return pair ? sums_wave<__nv_bfloat16, true, GRAD>(n) : sums_wave<__nv_bfloat16, false, STATS>(n);
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

// x, y [rows, C] (as above); sums float32 [2, C] = (sum x, sum x^2) over n
// rows, added up over the ranks (n: the statistics' rows of every rank);
// gamma, beta float32 [C]; out float32 [6, C], run_mean, run_var, count,
// eps, keep and take as s2a_channel_moments with gamma given, which writes
// the same out and running statistics from the same sums; y as s2a_bn_apply
// from out's mean and mul. One launch (also over rows = 0: the statistics
// are written).
int s2a_bn_apply_finish(const void* x, const void* sums, const void* gamma, const void* beta,
                        void* out, void* run_mean, void* run_var, void* count, void* y,
                        int rows, int C, int n, int dtype, float eps, float keep, float take,
                        void* stream) {
  if (C == 0) return 0;
  if (n <= 0 || rows < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FinishArgs f{static_cast<const float*>(gamma), static_cast<float*>(run_mean),
               static_cast<float*>(run_var), static_cast<long long*>(count), nullptr,
               nullptr, 1.0f / (float)n, eps, keep, take};
  if (dtype == 0) return launch_apply_finish<float>(x, sums, beta, out, y, rows, C, f, s);
  if (dtype == 1) return launch_apply_finish<__nv_bfloat16>(x, sums, beta, out, y, rows, C, f, s);
  return (int)cudaErrorInvalidValue;
}

// g, x, dx [rows, C] (as above); sums float32 [2, C] = (sum g, sum g*x) over
// all rows, added up over the ranks; mean, rstd, mul float32 [C] from the
// forward; out float32 [5, C] as s2a_grad_channel_sums with mean given (n
// the statistics' rows over all ranks); dx as s2a_bn_dx from out's a and b
// on rows [0, stat_rows) (this rank's statistics rows) and from a = b = 0
// on rows [stat_rows, rows). One launch, whatever stat_rows.
int s2a_bn_dx_finish(const void* g, const void* x, const void* sums, const void* mean,
                     const void* rstd, const void* mul, void* out, void* dx, int rows, int C,
                     int n, int stat_rows, int dtype, void* stream) {
  if (C == 0) return 0;
  if (n <= 0 || rows < 0 || stat_rows < 0 || stat_rows > rows) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  FinishArgs f{nullptr, nullptr, nullptr, nullptr, static_cast<const float*>(mean),
               static_cast<const float*>(rstd), 1.0f / (float)n, 0.f, 0.f, 0.f};
  if (dtype == 0)
    return launch_dx_finish<float>(g, x, sums, mul, out, dx, rows, stat_rows, C, f, s);
  if (dtype == 1)
    return launch_dx_finish<__nv_bfloat16>(g, x, sums, mul, out, dx, rows, stat_rows, C, f, s);
  return (int)cudaErrorInvalidValue;
}

const char* s2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
