// AlignConv: 3x3 deformable convolution, stride 1, 'same' padding, one
// deformable group, NHWC -- forward and backward.
//
// Replaces the TPU kernels s2anet_tpu/ops/pallas/deform_kernel.py::_fwd_kernel
// (and its DMA-window twin _fwd_kernel_dma) and ::_bwd_kernel. Those kernels
// had no gather, so they built each tap's bilinear "hat" matrix over a window
// of the map and rode the matrix unit; the backward turned the dx scatter
// into a transposed hat product over the window and overlap-added the
// windows (_fold_windows). Hopper gathers and scatters natively, so these
// kernels sample directly: exact for every offset, with neither the window
// nor the window predicate and gather fallback that guarded the TPU kernels.
//
//   out[b,h,w,:] = sum_t bilinear(x[b], h+ky_t+dy, w+kx_t+dx) @ W[t]
//
// with t = ky*3 + kx and (dy, dx) = offsets[b,h,w,t,:]. Each of the 4
// bilinear corners contributes max(0, 1-|p-r|) times its value only when it
// lies inside the image (zero padding). Sample coordinates are float32 for
// every input type; each sample is rounded to the input type before the
// product with W (as the TPU kernel does), and products accumulate in
// float32. A sample is summed over its corners with separately rounded
// multiplies and adds (no fused multiply-add), in the plain version's order,
// so kernel and plain version form the same samples bit for bit.
//
// bfloat16 (the serving and training type; C and Cout multiples of 8) runs
// three warp-specialised Hopper kernels (sm_90a): 384 threads, two consumer
// warpgroups that multiply with wgmma (bf16 operands in 128-byte-swizzled
// shared memory, float32 accumulators in registers) and one producer
// warpgroup, joined by a ring of stages with full/empty mbarriers.
//
//   * Forward: an implicit GEMM, M = B*H*W cells, N = Cout, K = 9*C. A block
//     owns 128 cells x 256 output channels; K walks 64-channel slices, and
//     the 9 taps inside each slice, through a 3-stage ring of 48 KB (A:
//     128 x 64 samples, B: the 64 x 256 slice of W[t], MN-major). The
//     producer warpgroup computes the corners of all 9 taps of its 128
//     cells once, then per stage gathers A (16-byte loads of the four
//     corners, issued together without branches, the plain version's
//     rounded multiply-adds, stored at the swizzled position) while one of
//     its threads loads B by TMA; the consumers' wgmma (m64n256k16) of one
//     stage runs while the next is gathered. bf16 output leaves through
//     shared memory in 16-byte rows. What bounds it: not the tensor cores
//     (2*9*C*Cout FLOP per cell, 0.21 ms for P3-P7 of a batch of 8) but the
//     gather: 9 taps x 4 corners x 2*C bytes per cell, about 3.2 GB of
//     L1/L2 reads over P3-P7, and the producer's instructions that turn
//     them into samples: pointing the gather at one address makes the
//     kernel much faster, dropping the B loads changes nothing. Walking the
//     taps of one slice in a row keeps neighbouring rows of x in L1.
//   * dW[t] = sum over cells of sample_t (x) g: M = C (per tap), N = Cout,
//     K = cells. A block owns one tap, 128 input channels, 256 output
//     channels and a chunk of cells (chunks x blocks fill one wave of 132
//     SMs). Per 64-cell stage the producer gathers the samples as the
//     forward does (A, read MN-major; the next stage's offsets are loaded a
//     stage ahead) and loads g by TMA (B, MN-major). Each block writes its
//     float32 tile to a [chunks, 9, C, Cout] workspace, and the finishing
//     pass adds the chunks in a fixed order: dW is the same bit for bit
//     from run to run. Bound, as the forward, by the gather.
//   * dx: per tap, dsamp = g @ W[t]^T, scattered to the sample's four
//     corners. A block owns 128 cells; their 128 x 256 g tile arrives by
//     TMA once and stays for all 9 taps, while W[t]^T streams through a
//     5-stage ring in 128-channel halves (K-major, by TMA). Each consumer
//     keeps two 64 x 128 accumulators: the wgmma of one half (and of the
//     next tap's first half) runs while the other half is scattered. The
//     scatter stages the half in shared memory so that one warp adds one
//     cell's 128 channels, four whole 128-byte lines, per vector float32
//     reduction (atomicAdd(float4*), red.v4.f32), skipping corners outside
//     the image or with zero weight. Those reductions into the float32 dx
//     workspace bound this kernel (whole lines per instruction beat the
//     register layout's half lines); their order, and so dx's last bits,
//     vary from run to run. A map with few 128-cell
//     blocks (P5-P7) splits the 9 taps over 3 or 9 blocks, whose
//     reductions add into the same dx, so small levels still fill the SMs.
//   * Finish: one pass sums the dW chunks and casts dx to bfloat16. The
//     bf16 backward is four launches: a memset of the dx workspace, dW,
//     dx and the finishing pass.
//
// float32 (off the main path; the exactness reference on the card) keeps
// the first port's kernels: a block owns 64 cells and up to 256 output
// channels and multiplies on the CUDA cores in an 8x8 register tile, so
// float32 results stay exact to float32 rounding (tensor cores would round
// to TF32); its dW adds each block's tile with atomics, its dx scatters
// scalar atomics.
//
// Offsets get no gradient: AlignConv's come from detached anchors, as in
// the TPU kernel's VJP.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BP = 64;   // float32 kernels: output cells per block
constexpr int BN = 256;  // float32 kernels: output channels per block
constexpr int NT = 256;  // float32 kernels: threads per block (8 warps)

// Corner rows (in x viewed as [B*H*W, C], -1 = outside) and weights of cell
// p for tap t, whose offset is (dy, dx) (none for p at or past P; the bf16
// entry points hold P below 2^31).
__device__ __forceinline__ void cell_corners_at(long long p, long long P, int H, int W,
                                                int t, float dy, float dx, int idx[4],
                                                float cw[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    idx[q] = -1;
    cw[q] = 0.f;
  }
  if (p >= P) return;
  const int pi = (int)p;
  const int w = pi % W;
  const int h = (pi / W) % H;
  const int b = pi / (W * H);
  const float py = (float)(h + t / 3 - 1) + dy;
  const float px = (float)(w + t % 3 - 1) + dx;
  const float fy = floorf(py), fx = floorf(px);
  const float ly = py - fy, lx = px - fx;
  // far-off samples: skip before the int conversion can overflow
  if (fy > -2.f && fy < (float)H && fx > -2.f && fx < (float)W) {
    const int y0 = (int)fy, x0 = (int)fx;
    const float wy[2] = {1.f - ly, ly};
    const float wx[2] = {1.f - lx, lx};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int y = y0 + (q >> 1), xx = x0 + (q & 1);
      if (y >= 0 && y < H && xx >= 0 && xx < W) {
        idx[q] = (b * H + y) * W + xx;
        cw[q] = wy[q >> 1] * wx[q & 1];
      }
    }
  }
}

// (dy, dx) of cell p, tap t (zeros past P)
__device__ __forceinline__ float2 tap_offset(const float* __restrict__ off, long long p,
                                             long long P, int t) {
  return p < P ? *reinterpret_cast<const float2*>(off + p * 18 + t * 2) : make_float2(0.f, 0.f);
}

// Corner rows and weights of the NC cells p0 .. p0+NC-1 for tap t into
// shared tables (the float32 kernels); threads 0..NC-1 each fill one cell.
template <int NC>
__device__ __forceinline__ void tap_corners(const float* __restrict__ off,
                                            long long p0, long long P, int H,
                                            int W, int t, int (*s_idx)[4],
                                            float (*s_cw)[4]) {
  const int tid = threadIdx.x;
  if (tid >= NC) return;
  const long long p = p0 + tid;
  int idx[4] = {-1, -1, -1, -1};
  float cw[4] = {0.f, 0.f, 0.f, 0.f};
  if (p < P) {
    const int w = (int)(p % W);
    const int h = (int)((p / W) % H);
    const int b = (int)(p / ((long long)W * H));
    const float py = (float)(h + t / 3 - 1) + off[p * 18 + t * 2];
    const float px = (float)(w + t % 3 - 1) + off[p * 18 + t * 2 + 1];
    const float fy = floorf(py), fx = floorf(px);
    const float ly = py - fy, lx = px - fx;
    // far-off samples: skip before the int conversion can overflow
    if (fy > -2.f && fy < (float)H && fx > -2.f && fx < (float)W) {
      const int y0 = (int)fy, x0 = (int)fx;
      const float wy[2] = {1.f - ly, ly};
      const float wx[2] = {1.f - lx, lx};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int y = y0 + (q >> 1), xx = x0 + (q & 1);
        if (y >= 0 && y < H && xx >= 0 && xx < W) {
          idx[q] = (b * H + y) * W + xx;
          cw[q] = wy[q >> 1] * wx[q & 1];
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    s_idx[tid][q] = idx[q];
    s_cw[tid][q] = cw[q];
  }
}

// ---------------------------------------------------------------- float32
constexpr int KC32 = 32;  // input channels per slice

__global__ void __launch_bounds__(NT)
deform_fwd_f32(const float* __restrict__ x, const float* __restrict__ off,
               const float* __restrict__ wt, float* __restrict__ out, int B,
               int H, int W, int C, int Cout) {
  __shared__ float s_samp[KC32][BP + 1];  // +1: conflict-free column writes
  __shared__ __align__(16) float s_w[KC32][BN];
  __shared__ int s_idx[BP][4];
  __shared__ float s_cw[BP][4];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long P = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * BP;
  const int n0 = blockIdx.y * BN;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < 9; ++t) {
    __syncthreads();  // the previous tap's readers of s_idx/s_cw are done
    tap_corners<BP>(off, p0, P, H, W, t, s_idx, s_cw);
    __syncthreads();
    for (int c0 = 0; c0 < C; c0 += KC32) {
      // 64 x 32 samples; consecutive threads read consecutive channels
#pragma unroll
      for (int i = 0; i < (BP * KC32) / NT; ++i) {
        const int e = tid + i * NT;
        const int cell = e / KC32;
        const int c = e % KC32;
        float v = 0.f;
        if (c0 + c < C) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = s_idx[cell][q];
            if (r >= 0)
              v = __fadd_rn(v, __fmul_rn(s_cw[cell][q], x[(long long)r * C + c0 + c]));
          }
        }
        s_samp[c][cell] = v;
      }
#pragma unroll 4
      for (int i = 0; i < (KC32 * BN) / NT; ++i) {
        const int e = tid + i * NT;
        const int k = e / BN;
        const int n = e % BN;
        s_w[k][n] = (c0 + k < C && n0 + n < Cout)
                        ? wt[((long long)t * C + c0 + k) * Cout + n0 + n]
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC32; ++k) {
        float a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = s_samp[k][warp * 8 + i];
        const float4 b0 = *reinterpret_cast<const float4*>(&s_w[k][lane * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&s_w[k][128 + lane * 4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * bv[j];
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long p = p0 + warp * 8 + i;
    if (p >= P) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? lane * 4 + j : 128 + lane * 4 + (j - 4));
      if (n < Cout) out[p * Cout + n] = acc[i][j];
    }
  }
}

// ------------------------------------------------------ dW, float32
// grid (chunks, 9 * ceil(C/64), ceil(Cout/256)); the block's 64 x 256 tile
// of dW[t] is an 8x8 register tile per thread, summed over 32-cell steps.
constexpr int KP32 = 32;  // cells per step
constexpr int MC = 64;    // input channels per dW block

__global__ void __launch_bounds__(NT)
deform_bwd_dw_f32(const float* __restrict__ x, const float* __restrict__ off,
                  const float* __restrict__ g, float* __restrict__ dw, int B,
                  int H, int W, int C, int Cout, long long chunk) {
  __shared__ float s_samp[KP32][MC];               // [cell][channel]
  __shared__ __align__(16) float s_g[KP32][BN];    // [cell][output channel]
  __shared__ int s_idx[KP32][4];
  __shared__ float s_cw[KP32][4];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long P = (long long)B * H * W;
  const int n_cs = (C + MC - 1) / MC;
  const int t = blockIdx.y / n_cs;
  const int c0 = (blockIdx.y % n_cs) * MC;
  const int n0 = blockIdx.z * BN;
  const long long pbeg = (long long)blockIdx.x * chunk;
  const long long pend = pbeg + chunk < P ? pbeg + chunk : P;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (long long p0 = pbeg; p0 < pend; p0 += KP32) {
    __syncthreads();  // the previous step's readers are done
    tap_corners<KP32>(off, p0, pend, H, W, t, s_idx, s_cw);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < (KP32 * MC) / NT; ++i) {
      const int e = tid + i * NT;
      const int cell = e / MC;
      const int c = e % MC;
      float v = 0.f;
      if (c0 + c < C) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = s_idx[cell][q];
          if (r >= 0)
            v = __fadd_rn(v, __fmul_rn(s_cw[cell][q], x[(long long)r * C + c0 + c]));
        }
      }
      s_samp[cell][c] = v;
    }
#pragma unroll 4
    for (int i = 0; i < (KP32 * BN) / NT; ++i) {
      const int e = tid + i * NT;
      const int cell = e / BN;
      const int n = e % BN;
      s_g[cell][n] = (p0 + cell < pend && n0 + n < Cout)
                         ? g[(p0 + cell) * Cout + n0 + n]
                         : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < KP32; ++k) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = s_samp[k][warp * 8 + i];
      const float4 b0 = *reinterpret_cast<const float4*>(&s_g[k][lane * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&s_g[k][128 + lane * 4]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * bv[j];
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = c0 + warp * 8 + i;
    if (c >= C) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + (j < 4 ? lane * 4 + j : 128 + lane * 4 + (j - 4));
      if (n < Cout) atomicAdd(&dw[((long long)t * C + c) * Cout + n], acc[i][j]);
    }
  }
}

// ------------------------------------------------------ dx, float32
// grid (ceil(P/64), ceil(C/256)); per tap the block's 64 cells x 256 input
// channels of g @ W[t]^T (8x8 register tile per thread), then the scatter.
__global__ void __launch_bounds__(NT)
deform_bwd_dx_f32(const float* __restrict__ off, const float* __restrict__ wt,
                  const float* __restrict__ g, float* __restrict__ dx, int B,
                  int H, int W, int C, int Cout) {
  __shared__ float s_g[KC32][BP + 1];              // [out ch.][cell]
  __shared__ __align__(16) float s_w[KC32][BN];    // [out ch.][in ch.]
  __shared__ int s_idx[BP][4];
  __shared__ float s_cw[BP][4];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long P = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * BP;
  const int n0 = blockIdx.y * BN;

  for (int t = 0; t < 9; ++t) {
    __syncthreads();  // the previous tap's scatter has read s_idx/s_cw
    tap_corners<BP>(off, p0, P, H, W, t, s_idx, s_cw);
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < Cout; k0 += KC32) {
#pragma unroll
      for (int i = 0; i < (BP * KC32) / NT; ++i) {
        const int e = tid + i * NT;
        const int cell = e / KC32;
        const int k = e % KC32;
        s_g[k][cell] = (p0 + cell < P && k0 + k < Cout)
                           ? g[(p0 + cell) * Cout + k0 + k]
                           : 0.f;
      }
#pragma unroll 4
      for (int i = 0; i < (KC32 * BN) / NT; ++i) {
        const int e = tid + i * NT;
        const int k = e / BN;
        const int n = e % BN;
        s_w[k][n] = (k0 + k < Cout && n0 + n < C)
                        ? wt[((long long)t * C + n0 + n) * Cout + k0 + k]
                        : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < KC32; ++k) {
        float a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = s_g[k][warp * 8 + i];
        const float4 b0 = *reinterpret_cast<const float4*>(&s_w[k][lane * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&s_w[k][128 + lane * 4]);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * bv[j];
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int cell = warp * 8 + i;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = s_idx[cell][q];
        if (r < 0) continue;
        const float cw = s_cw[cell][q];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + (j < 4 ? lane * 4 + j : 128 + lane * 4 + (j - 4));
          if (n < C) atomicAdd(&dx[(long long)r * C + n], cw * acc[i][j]);
        }
      }
    }
  }
}

// ================================================ Hopper building blocks
union Vec8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival, and `bytes` more expected from TMA copies on this phase
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// generic-proxy shared stores made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands: rows
// of 64 bf16 along K, 8-row groups `sbo` bytes apart (`lbo` unused).
// MN-major operands: rows of 64 bf16 along M or N, one row per K index,
// 8-row K groups `sbo` bytes apart and 64-wide M/N atoms `lbo` bytes apart.
// Every tile starts on a 1024-byte boundary, so the swizzle phase is 0.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// Byte offset of the 16-byte chunk `chunk` (0..7) of row `row` in a tile of
// 128-byte rows with the 128-byte swizzle (what TMA's SWIZZLE_128B writes).
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, float32 accumulators; TA/TB
// 0 = K-major, 1 = MN-major; scale_d 0 overwrites D. Accumulator layout:
// thread (warp w, lane l) holds, for each 8-column chunk j, rows
// 16w + l/4 and 16w + l/4 + 8 at columns 8j + 2(l%4) and +1, as
// d[4j], d[4j+1] (first row) and d[4j+2], d[4j+3] (second row).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// ================================================= bfloat16, Hopper kernels
constexpr int HT = 384;              // threads: consumer warpgroups 0, 1; producer 2
constexpr int PRODUCER_REGS = 120;   // setmaxnreg: the gather warpgroup
constexpr int CONSUMER_REGS = 192;   // 128 accumulators and addressing
constexpr int TILE = 8192;           // one 64 x 64 bf16 swizzled tile
constexpr int STAGES = 3;            // forward and dW ring
constexpr int STAGE_A = 2 * TILE;    // forward: 128 cells x 64 channels; dW: 64 cells x 128
constexpr int STAGE_B = 4 * TILE;    // forward: 64 x 256 of W[t]; dW: 64 cells x 256 of g
constexpr int STAGE = STAGE_A + STAGE_B;
constexpr int GATHER_BATCH = 2;      // items whose corner loads are in flight together

// shared memory: the ring, full[], empty[], then the corner tables (forward:
// all 9 taps of the block's 128 cells; dW: two stages of 64 cells)
constexpr int RING_SMEM = STAGES * STAGE + 2 * STAGES * 8;
constexpr int FWD_SMEM = 1024 + RING_SMEM + 9 * 2 * 128 * 16;
constexpr int DW_SMEM = 1024 + RING_SMEM + 2 * 2 * 64 * 16;

// 1024-byte aligned start of the dynamic shared memory
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_u32(raw);
  return raw + (((a + 1023u) & ~1023u) - a);
}

// Bilinear samples of 8 channels c .. c+7 for each of the items' cells from
// the corner tables (ti/tc: [cell][4]), rounded to bf16 and stored at
// dst[item] (shared). Channels at or past C are zero. Every corner is loaded
// without a branch (a corner outside the image or past C reads x's first
// vector and counts as zero, which adds exactly nothing), so all 4 x N
// loads are in flight together.
template <int N>
__device__ __forceinline__ void gather_items(const __nv_bfloat16* __restrict__ x,
                                             const int* ti, const float* tc,
                                             const int* cell, int c, int C,
                                             uint8_t* const* dst) {
  uint4 v[N][4];
  int4 r[N];
  float4 w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    r[i] = *reinterpret_cast<const int4*>(ti + cell[i] * 4);
    w[i] = *reinterpret_cast<const float4*>(tc + cell[i] * 4);
    const int rr[4] = {r[i].x, r[i].y, r[i].z, r[i].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const long long at = (c < C && rr[q] >= 0) ? (long long)rr[q] * C + c : 0;
      v[i][q] = __ldg(reinterpret_cast<const uint4*>(x + at));
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    // a corner outside the image has weight 0; x's values are finite, so
    // 0 * value adds exactly nothing
    const float ww[4] = {c < C ? w[i].x : 0.f, c < C ? w[i].y : 0.f,
                         c < C ? w[i].z : 0.f, c < C ? w[i].w : 0.f};
    float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      Vec8 in;
      in.u = v[i][q];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        s[k] = __fadd_rn(s[k], __fmul_rn(ww[q], __bfloat162float(in.h[k])));
    }
    Vec8 o;
#pragma unroll
    for (int k = 0; k < 8; ++k) o.h[k] = __float2bfloat16(s[k]);
    *reinterpret_cast<uint4*>(dst[i]) = o.u;
  }
}

// ---------------------------------------------------------------- forward
// grid (ceil(P/128), ceil(Cout/256)); wmap: W as [9][C][Cout], box 64 x 64.
__global__ void __launch_bounds__(HT, 1)
deform_fwd_bf16_sm90(const __grid_constant__ CUtensorMap wmap,
                     const __nv_bfloat16* __restrict__ x, const float* __restrict__ off,
                     __nv_bfloat16* __restrict__ out, int B, int H, int W, int C,
                     int Cout) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  int* s_idx = reinterpret_cast<int*>(empty + STAGES);  // [9][128][4]
  float* s_cw = reinterpret_cast<float*>(s_idx + 9 * 128 * 4);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const long long P = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * 128;
  const int n0 = blockIdx.y * 256;
  const int nslices = (C + 63) / 64;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 129);  // the gather arrivals + the TMA one
      mbar_init(smem_u32(&empty[s]), 2);   // one per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: gather A, TMA B
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = tid - 256;
    const int vec = pt & 7;  // 16-byte vector of the 64-channel slice
    int stage = 0;
    uint32_t phase = 0;
    auto one_stage = [&](int t, int cs, const int* ti, const float* tc) {
      mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
      uint8_t* a_tile = smem + stage * STAGE;
      const uint32_t fb = smem_u32(&full[stage]);
      if (pt == 0) {
        mbar_arrive_tx(fb, STAGE_B);
        const uint32_t b_tile = smem_u32(a_tile + STAGE_A);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tma_load_3d(b_tile + j * TILE, &wmap, fb, n0 + 64 * j, cs * 64, t);
      }
      // 128 cells x 8 vectors: cells pt/8 + 16 i
#pragma unroll
      for (int i0 = 0; i0 < 8; i0 += GATHER_BATCH) {
        int cell[GATHER_BATCH];
        uint8_t* dst[GATHER_BATCH];
#pragma unroll
        for (int i = 0; i < GATHER_BATCH; ++i) {
          cell[i] = (pt >> 3) + 16 * (i0 + i);
          dst[i] = a_tile + swz(cell[i], vec);
        }
        gather_items<GATHER_BATCH>(x, ti, tc, cell, cs * 64 + vec * 8, C, dst);
      }
      fence_proxy_async();
      mbar_arrive(fb);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    };
    // the corners of all 9 taps of cell pt; then K walks channel slices
    // outermost, so the 9 taps of one slice (neighbouring rows of x) follow
    // each other and share L1
    if (pt < 128) {
      float2 d[9];
#pragma unroll
      for (int t = 0; t < 9; ++t) d[t] = tap_offset(off, p0 + pt, P, t);
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        int idx[4];
        float cw[4];
        cell_corners_at(p0 + pt, P, H, W, t, d[t].x, d[t].y, idx, cw);
        *reinterpret_cast<int4*>(s_idx + t * 512 + pt * 4) = make_int4(idx[0], idx[1], idx[2], idx[3]);
        *reinterpret_cast<float4*>(s_cw + t * 512 + pt * 4) = make_float4(cw[0], cw[1], cw[2], cw[3]);
      }
    }
    named_bar_sync(1, 128);
    for (int cs = 0; cs < nslices; ++cs)
      for (int t = 0; t < 9; ++t) one_stage(t, cs, s_idx + t * 512, s_cw + t * 512);
  } else {
    // ---- consumers: warpgroup wg owns cells p0 + 64 wg .. + 63
    setmaxnreg_inc<CONSUMER_REGS>();
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    const uint32_t sbase = smem_u32(smem);
    const int nsteps = 9 * nslices;
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int s = 0; s < nsteps; ++s) {
      mbar_wait(smem_u32(&full[stage]), phase);
      const uint32_t a = sbase + stage * STAGE + wg * TILE;
      const uint64_t da = gmma_desc(a, 16, 1024);                    // K-major
      const uint64_t db = gmma_desc(sbase + stage * STAGE + STAGE_A,  // MN-major
                                    TILE, 1024);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)  // 16 channels: +32 bytes in A, +16 rows in B
        wgmma_n256<0, 1>(acc, da + 2 * k, db + 128 * k, (s | k) != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (s > 0 && (tid & 127) == 0) mbar_arrive(smem_u32(&empty[prev]));
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);

    // epilogue: bf16 tile through shared memory (rows padded to 264), then
    // 16-byte rows to out
    named_bar_sync(2, 256);  // both warpgroups are done reading the ring
    constexpr int LDO = 264;
    __nv_bfloat16* tile = reinterpret_cast<__nv_bfloat16*>(smem) + wg * 64 * LDO;
    const int lt = tid & 127;
    const int r = (lt >> 5) * 16 + ((lt & 31) >> 2);
    const int cc = (lt & 3) * 2;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(tile + r * LDO + j * 8 + cc) =
          __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(tile + (r + 8) * LDO + j * 8 + cc) =
          __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
    named_bar_sync(3 + wg, 128);
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int e = lt + 128 * i;
      const int row = e >> 5;
      const int ch = (e & 31) * 8;
      const long long p = p0 + wg * 64 + row;
      if (p < P && n0 + ch < Cout)
        *reinterpret_cast<uint4*>(out + p * Cout + n0 + ch) =
            *reinterpret_cast<const uint4*>(tile + row * LDO + ch);
    }
  }
}

// ------------------------------------------------------------- backward dW
// grid (chunks, 9 * ceil(C/128), ceil(Cout/256)); gmap: g as [P][Cout], box
// 64 x 64. Block (chunk, tap t, channels c0..c0+127, outputs n0..n0+255)
// writes ws[chunk][t][c][n] (float32).
__global__ void __launch_bounds__(HT, 1)
deform_bwd_dw_bf16_sm90(const __grid_constant__ CUtensorMap gmap,
                        const __nv_bfloat16* __restrict__ x, const float* __restrict__ off,
                        float* __restrict__ ws, int B, int H, int W, int C, int Cout,
                        int chunk) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * STAGE);
  uint64_t* empty = full + STAGES;
  int* s_idx = reinterpret_cast<int*>(empty + STAGES);  // [2][64][4]
  float* s_cw = reinterpret_cast<float*>(s_idx + 2 * 64 * 4);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const long long P = (long long)B * H * W;
  const int n_cb = (C + 127) / 128;
  const int t = blockIdx.y / n_cb;
  const int c0 = (blockIdx.y % n_cb) * 128;
  const int n0 = blockIdx.z * 256;
  const long long pbeg = (long long)blockIdx.x * chunk;
  const long long pend = pbeg + chunk < P ? pbeg + chunk : P;
  const int nsteps = (int)((pend - pbeg + 63) / 64);

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 129);
      mbar_init(smem_u32(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: samples (A) gathered, g (B) by TMA
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = tid - 256;
    const int vec = pt & 15;  // 16-byte vector of the 128 channels
    int stage = 0;
    uint32_t phase = 0;
    float2 dnext = tap_offset(off, pbeg + pt, pend, t);  // prefetched a stage ahead
    for (int s = 0; s < nsteps; ++s) {
      const long long ps = pbeg + 64LL * s;
      int* ti = s_idx + (s & 1) * 256;
      float* tc = s_cw + (s & 1) * 256;
      if (pt < 64) {
        int idx[4];
        float cw[4];
        const float2 d = dnext;
        dnext = tap_offset(off, ps + 64 + pt, pend, t);
        cell_corners_at(ps + pt, pend, H, W, t, d.x, d.y, idx, cw);
        *reinterpret_cast<int4*>(ti + pt * 4) = make_int4(idx[0], idx[1], idx[2], idx[3]);
        *reinterpret_cast<float4*>(tc + pt * 4) = make_float4(cw[0], cw[1], cw[2], cw[3]);
      }
      named_bar_sync(1, 128);
      mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
      uint8_t* a_tile = smem + stage * STAGE;
      const uint32_t fb = smem_u32(&full[stage]);
      if (pt == 0) {
        mbar_arrive_tx(fb, STAGE_B);
        const uint32_t b_tile = smem_u32(a_tile + STAGE_A);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          tma_load_2d(b_tile + j * TILE, &gmap, fb, n0 + 64 * j, (int)ps);
      }
      // 64 cells x 16 vectors: cells pt/16 + 8 i; vectors 0-7 in the first
      // 64-channel tile, 8-15 in the second
#pragma unroll
      for (int i0 = 0; i0 < 8; i0 += GATHER_BATCH) {
        int cell[GATHER_BATCH];
        uint8_t* dst[GATHER_BATCH];
#pragma unroll
        for (int i = 0; i < GATHER_BATCH; ++i) {
          cell[i] = (pt >> 4) + 8 * (i0 + i);
          dst[i] = a_tile + (vec >> 3) * TILE + swz(cell[i], vec & 7);
        }
        gather_items<GATHER_BATCH>(x, ti, tc, cell, c0 + vec * 8, C, dst);
      }
      fence_proxy_async();
      mbar_arrive(fb);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns channels c0 + 64 wg .. + 63
    setmaxnreg_inc<CONSUMER_REGS>();
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;
    const uint32_t sbase = smem_u32(smem);
    int stage = 0, prev = 0;
    uint32_t phase = 0;
    for (int s = 0; s < nsteps; ++s) {
      mbar_wait(smem_u32(&full[stage]), phase);
      const uint64_t da = gmma_desc(sbase + stage * STAGE + wg * TILE, TILE, 1024);
      const uint64_t db = gmma_desc(sbase + stage * STAGE + STAGE_A, TILE, 1024);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)  // 16 cells: +16 rows in both (MN-major)
        wgmma_n256<1, 1>(acc, da + 128 * k, db + 128 * k, (s | k) != 0);
      wgmma_commit();
      wgmma_wait<1>();
      if (s > 0 && (tid & 127) == 0) mbar_arrive(smem_u32(&empty[prev]));
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    const int lt = tid & 127;
    const int r = (lt >> 5) * 16 + ((lt & 31) >> 2);
    const int c = c0 + wg * 64 + r;
    float* base = ws + ((long long)blockIdx.x * 9 + t) * C * Cout;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int n = n0 + j * 8 + (lt & 3) * 2;
      if (n < Cout) {
        if (c < C)
          *reinterpret_cast<float2*>(base + (long long)c * Cout + n) =
              make_float2(acc[4 * j], acc[4 * j + 1]);
        if (c + 8 < C)
          *reinterpret_cast<float2*>(base + (long long)(c + 8) * Cout + n) =
              make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
  }
}

// ------------------------------------------------------------- backward dx
// grid (ceil(P/128), ceil(C/256), ceil(Cout/256) * groups); gmap: g as
// [P][Cout], box 64 x 128; wmap: W as [9][C][Cout], box 64 x 128. Block
// (cells p0..p0+127, input channels n0..n0+255, output channels k0..k0+255,
// taps t0..t0+9/groups-1) adds its share of dx into dx32 (float32).
constexpr int DX_RING = 5;            // stages of 128 input x 64 output channels
constexpr int DX_G = 4 * 2 * TILE;    // g: 4 tiles of 128 cells x 64 output channels
constexpr int DX_LDS = 136;           // staged dsamp rows (floats; conflict-free)
constexpr int DX_STG = 64 * DX_LDS * 4;
constexpr int DX_SMEM = 1024 + DX_G + DX_RING * 2 * TILE + 2 * DX_STG + 2 * 64 * 32 +
                        (1 + 2 * DX_RING) * 8;

__global__ void __launch_bounds__(HT, 1)
deform_bwd_dx_bf16_sm90(const __grid_constant__ CUtensorMap gmap,
                        const __grid_constant__ CUtensorMap wmap,
                        const float* __restrict__ off, float* __restrict__ dx, int B,
                        int H, int W, int C, int Cout, int groups) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* ring = smem + DX_G;
  float* stg_all = reinterpret_cast<float*>(ring + DX_RING * 2 * TILE);
  int* tab_all = reinterpret_cast<int*>(stg_all + 2 * 64 * DX_LDS);  // [2][64][8]
  uint64_t* gbar = reinterpret_cast<uint64_t*>(tab_all + 2 * 64 * 8);
  uint64_t* full = gbar + 1;
  uint64_t* empty = full + DX_RING;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const long long P = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * 128;
  const int n0 = blockIdx.y * 256;
  const int k0 = (blockIdx.z / groups) * 256;
  const int t0 = (blockIdx.z % groups) * (9 / groups);
  const int t1 = t0 + 9 / groups;

  if (tid == 0) {
    mbar_init(smem_u32(gbar), 1);
    for (int s = 0; s < DX_RING; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    setmaxnreg_dec<40>();
    if (tid == 256) {
      const uint32_t gb = smem_u32(gbar);
      mbar_arrive_tx(gb, DX_G);
#pragma unroll
      for (int kb = 0; kb < 4; ++kb)
        tma_load_2d(smem_u32(smem) + kb * 2 * TILE, &gmap, gb, k0 + 64 * kb, (int)p0);
      int stage = 0;
      uint32_t phase = 0;
      for (int t = t0; t < t1; ++t)
        for (int h = 0; h < 2; ++h)
          for (int kb = 0; kb < 4; ++kb) {
            mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
            const uint32_t fb = smem_u32(&full[stage]);
            mbar_arrive_tx(fb, 2 * TILE);
            tma_load_3d(smem_u32(ring) + stage * 2 * TILE, &wmap, fb, k0 + 64 * kb,
                        n0 + 128 * h, t);
            if (++stage == DX_RING) {
              stage = 0;
              phase ^= 1;
            }
          }
    }
  } else {
    setmaxnreg_inc<232>();
    const int lt = tid & 127;
    const int warp = lt >> 5, lane = lt & 31;
    const uint32_t gbase = smem_u32(smem) + wg * TILE;
    const uint32_t rbase = smem_u32(ring);
    float* stg = stg_all + wg * 64 * DX_LDS;
    int* tab = tab_all + wg * 64 * 8;  // [cell][4 rows, 4 weights]
    const int bar = 3 + wg;
    float acc0[64], acc1[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      acc0[i] = 0.f;
      acc1[i] = 0.f;
    }
    int stage = 0;
    uint32_t phase = 0;
    auto issue = [&](float (&acc)[64]) {
      const int first = stage;
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        mbar_wait(smem_u32(&full[stage]), phase);
        const uint64_t da = gmma_desc(gbase + kb * 2 * TILE, 16, 1024);
        const uint64_t db = gmma_desc(rbase + stage * 2 * TILE, 16, 1024);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_n128<0, 0>(acc, da + 2 * k, db + 2 * k, (kb | k) != 0);
        if (++stage == DX_RING) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_commit();
      return first;
    };
    auto release = [&](int first) {
      if (lt == 0)
#pragma unroll
        for (int i = 0; i < 4; ++i) mbar_arrive(smem_u32(&empty[(first + i) % DX_RING]));
    };
    // stage a 64 x 128 half in shared memory, then each warp adds 16 rows:
    // one row (128 channels, 4 full 128-byte lines) per vector reduction
    auto scatter = [&](float (&acc)[64], int col0) {
      named_bar_sync(bar, 128);  // staging free; corner table written
      const int r = warp * 16 + (lane >> 2);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int c = j * 8 + (lane & 3) * 2;
        *reinterpret_cast<float2*>(stg + r * DX_LDS + c) = make_float2(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<float2*>(stg + (r + 8) * DX_LDS + c) =
            make_float2(acc[4 * j + 2], acc[4 * j + 3]);
      }
      named_bar_sync(bar, 128);
      const int col = col0 + 4 * lane;
      if (col < C) {
#pragma unroll 4
        for (int i = 0; i < 16; ++i) {
          const int row = warp * 16 + i;
          const int4 ri = *reinterpret_cast<const int4*>(tab + row * 8);
          const float4 wi = *reinterpret_cast<const float4*>(tab + row * 8 + 4);
          const float4 v = *reinterpret_cast<const float4*>(stg + row * DX_LDS + 4 * lane);
          const int rr[4] = {ri.x, ri.y, ri.z, ri.w};
          const float ww[4] = {wi.x, wi.y, wi.z, wi.w};
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (rr[q] >= 0 && ww[q] != 0.f)
              atomicAdd(reinterpret_cast<float4*>(dx + (long long)rr[q] * C + col),
                        make_float4(ww[q] * v.x, ww[q] * v.y, ww[q] * v.z, ww[q] * v.w));
        }
      }
    };

    const long long pc = p0 + wg * 64 + (lt & 63);  // threads 0-63: one cell each
    float2 dnext = tap_offset(off, pc, P, t0);        // prefetched a tap ahead
    mbar_wait(smem_u32(gbar), 0);
    int st0 = issue(acc0);
    for (int t = t0; t < t1; ++t) {
      const float2 d = dnext;
      if (t + 1 < t1) dnext = tap_offset(off, pc, P, t + 1);
      named_bar_sync(bar, 128);  // the previous tap's scatter is done with the table
      if (lt < 64) {
        int idx[4];
        float cw[4];
        cell_corners_at(pc, P, H, W, t, d.x, d.y, idx, cw);
        *reinterpret_cast<int4*>(tab + lt * 8) = make_int4(idx[0], idx[1], idx[2], idx[3]);
        *reinterpret_cast<float4*>(tab + lt * 8 + 4) = make_float4(cw[0], cw[1], cw[2], cw[3]);
      }
      wgmma_wait<0>();  // first half of tap t
      fence_acc(acc0);
      release(st0);
      const int st1 = issue(acc1);  // second half runs during the first's scatter
      scatter(acc0, n0);
      wgmma_wait<0>();
      fence_acc(acc1);
      release(st1);
      if (t + 1 < t1) st0 = issue(acc0);  // next tap's first half runs during this scatter
      scatter(acc1, n0 + 128);
    }
  }
}


// ------------------------------------------------------- backward, finish
// dw[i] = sum over chunks k (in order) of ws[k][i]; dx = bf16(dx32)
__global__ void deform_bwd_finish_bf16(const float* __restrict__ ws, int chunks,
                                       long long nw, float* __restrict__ dw,
                                       const float* __restrict__ dx32,
                                       __nv_bfloat16* __restrict__ dx, long long nx4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nw + nx4;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < nw) {
      float s = 0.f;
      for (int k = 0; k < chunks; ++k) s += ws[k * nw + i];
      dw[i] = s;
    } else {
      const long long j = i - nw;
      const float4 v = reinterpret_cast<const float4*>(dx32)[j];
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 u;
      u.x = *reinterpret_cast<uint32_t*>(&lo);
      u.y = *reinterpret_cast<uint32_t*>(&hi);
      reinterpret_cast<uint2*>(dx)[j] = u;
    }
  }
}

}  // namespace

namespace {

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda)
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// bf16 tensor map over a row-major array with dims (innermost first) of the
// given rank (2 or 3), boxes of box0 x box1 (x 1), 128-byte swizzle; reads
// past an edge give zeros
bool bf16_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
              uint32_t box0, uint32_t box1) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t gdim[3] = {dims[0], dims[1], rank == 3 ? dims[2] : 1};
  cuuint64_t gstride[2] = {dims[0] * 2, dims[0] * dims[1] * 2};
  cuuint32_t box[3] = {box0, box1, 1};
  cuuint32_t estride[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(ptr),
            gdim, gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace

extern "C" {

// x [B,H,W,C], offsets [B,H,W,9,2] float32 (dy, dx), weight [3,3,C,Cout]
// (HWIO), out [B,H,W,Cout]; x, weight and out share one type:
// dtype 0 = float32, 1 = bfloat16 (C and Cout multiples of 8, 16-byte
// aligned rows). Returns the launch's cudaError_t.
int s2a_deform_conv2d_fwd(const void* x, const void* offsets, const void* weight,
                          void* out, int B, int H, int W, int C, int Cout,
                          int dtype, void* stream) {
  const long long P = (long long)B * H * W;
  if (P == 0 || Cout == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  if (dtype == 0) {
    dim3 grid((unsigned)((P + BP - 1) / BP), (unsigned)((Cout + BN - 1) / BN));
    deform_fwd_f32<<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), off, static_cast<const float*>(weight),
        static_cast<float*>(out), B, H, W, C, Cout);
  } else if (dtype == 1) {
    // cells are int32 TMA coordinates
    if (C % 8 != 0 || Cout % 8 != 0 || P > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    CUtensorMap wmap;
    const uint64_t wdims[3] = {(uint64_t)Cout, (uint64_t)C, 9};
    if (!bf16_map(&wmap, weight, 3, wdims, 64, 64)) return (int)cudaErrorInvalidValue;
    cudaError_t err = allow_smem(deform_fwd_bf16_sm90, FWD_SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((P + 127) / 128), (unsigned)((Cout + 255) / 256));
    deform_fwd_bf16_sm90<<<grid, HT, FWD_SMEM, s>>>(
        wmap, static_cast<const __nv_bfloat16*>(x), off,
        static_cast<__nv_bfloat16*>(out), B, H, W, C, Cout);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Backward of s2a_deform_conv2d_fwd for the same x, offsets and weight and
// the output gradient grad [B,H,W,Cout] (x's type). dx32 [B,H,W,C] float32
// is zeroed here and summed into; dw [3,3,C,Cout] float32. The dW reduction
// runs in `chunks` chunks of `chunk` cells (whole 64-cell steps for
// bfloat16, 32 for float32). float32: pass dx == dx32; dW is summed in
// place with atomics (ws unused). bfloat16: ws [chunks,9,C,Cout] float32
// takes each chunk's partial dW, and the finishing pass writes dw (chunks
// added in order) and dx (bfloat16) from dx32. Returns the launches'
// cudaError_t.
int s2a_deform_conv2d_bwd(const void* x, const void* offsets, const void* weight,
                          const void* grad, void* dx32, void* dx, void* dw, void* ws,
                          int B, int H, int W, int C, int Cout, int chunks, int chunk,
                          int dtype, void* stream) {
  const long long P = (long long)B * H * W;
  if (P == 0 || C == 0 || Cout == 0) return 0;
  if (chunks < 1 || chunk < 1 || (long long)chunks * chunk < P)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  float* dxf = static_cast<float*>(dx32);
  float* dwf = static_cast<float*>(dw);
  cudaError_t err = cudaMemsetAsync(dxf, 0, (size_t)P * C * sizeof(float), s);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 0) {
    err = cudaMemsetAsync(dwf, 0, (size_t)9 * C * Cout * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(weight);
    const float* gf = static_cast<const float*>(grad);
    dim3 grid_dw((unsigned)chunks, (unsigned)(9 * ((C + 63) / 64)),
                 (unsigned)((Cout + BN - 1) / BN));
    dim3 grid_dx((unsigned)((P + BP - 1) / BP), (unsigned)((C + BN - 1) / BN));
    deform_bwd_dw_f32<<<grid_dw, NT, 0, s>>>(xf, off, gf, dwf, B, H, W, C, Cout,
                                             (long long)chunk);
    deform_bwd_dx_f32<<<grid_dx, NT, 0, s>>>(off, wf, gf, dxf, B, H, W, C, Cout);
  } else if (dtype == 1) {
    if (C % 8 != 0 || Cout % 8 != 0 || chunk % 64 != 0 || P > 0x7fffffffLL)
      return (int)cudaErrorInvalidValue;
    CUtensorMap g_dw, g_dx, w_dx;
    const uint64_t gdims[2] = {(uint64_t)Cout, (uint64_t)P};
    const uint64_t wdims[3] = {(uint64_t)Cout, (uint64_t)C, 9};
    if (!bf16_map(&g_dw, grad, 2, gdims, 64, 64) || !bf16_map(&g_dx, grad, 2, gdims, 64, 128) ||
        !bf16_map(&w_dx, weight, 3, wdims, 64, 128))
      return (int)cudaErrorInvalidValue;
    if ((err = allow_smem(deform_bwd_dw_bf16_sm90, DW_SMEM)) != cudaSuccess ||
        (err = allow_smem(deform_bwd_dx_bf16_sm90, DX_SMEM)) != cudaSuccess)
      return (int)err;
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    dim3 grid_dw((unsigned)chunks, (unsigned)(9 * ((C + 127) / 128)),
                 (unsigned)((Cout + 255) / 256));
    deform_bwd_dw_bf16_sm90<<<grid_dw, HT, DW_SMEM, s>>>(
        g_dw, xb, off, static_cast<float*>(ws), B, H, W, C, Cout, chunk);
    // a map with few 128-cell blocks splits the 9 taps over 3 or 9 blocks
    // (their reductions add into the same dx), so small levels fill the SMs
    const long long dx_blocks = (P + 127) / 128 * ((C + 255) / 256) * ((Cout + 255) / 256);
    const int groups = dx_blocks * 9 <= 2 * 132 ? 9 : dx_blocks * 3 <= 2 * 132 ? 3 : 1;
    dim3 grid_dx((unsigned)((P + 127) / 128), (unsigned)((C + 255) / 256),
                 (unsigned)((Cout + 255) / 256 * groups));
    deform_bwd_dx_bf16_sm90<<<grid_dx, HT, DX_SMEM, s>>>(g_dx, w_dx, off, dxf, B, H, W, C,
                                                         Cout, groups);
    const long long nw = 9LL * C * Cout, nx4 = P * C / 4;
    const long long blocks = (nw + nx4 + 255) / 256 < 1056 ? (nw + nx4 + 255) / 256 : 1056;
    deform_bwd_finish_bf16<<<(unsigned)blocks, 256, 0, s>>>(
        static_cast<const float*>(ws), chunks, nw, dwf, dxf,
        static_cast<__nv_bfloat16*>(dx), nx4);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* s2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
