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
// Forward. What bounds it on an H100: 9*C*Cout multiply-adds per output
// cell (P3 at batch 8: 77 GMAC) against 9*4*C gathered corner values per
// cell, which mostly hit L2. A block owns 64 output cells and up to 256
// output channels; per tap and per slice of input channels it gathers the
// 64 cells' samples and the slice of W[t] into shared memory, then
// multiplies:
//   * bfloat16 (the serving type): 64-channel slices, 16-byte vector
//     gathers, and the product on the tensor cores (WMMA bf16 16x16x16,
//     float32 accumulators; each warp owns a 16x128 output tile). Needs C
//     and Cout to be multiples of 8.
//   * float32: 32-channel slices and the product on the CUDA cores, an 8x8
//     float32 register tile per thread, so float32 results stay exact to
//     float32 rounding (tensor cores would round to TF32).
//
// Backward (offsets get no gradient: AlignConv's come from detached
// anchors, as in the TPU kernel's VJP). Twice the forward's products, and
// two reductions over all B*H*W cells:
//   * dW[t] = sum over cells of sample_t (x) g. A block owns one tap, a
//     64-channel slice of C, up to 256 output channels and a chunk of
//     cells; it gathers the samples as the forward does (rounded to the
//     input type), multiplies them with the chunk's g on the tensor cores
//     (bf16) or CUDA cores (f32), and adds its float32 tile into dW with one
//     atomic add per element per block. The chunk count (wrapper) gives
//     about 4 blocks per SM, so the atomics are few.
//   * dx: per tap, dsamp = g @ W[t]^T for a block of 64 cells x 256 input
//     channels (the forward's product with W transposed, float32 result),
//     then each value is scattered to the sample's inside corners with
//     float32 atomic adds into a float32 dx workspace, which a last pass
//     casts to bfloat16 for bf16 inputs. The scatter is the reference's
//     col2im design; its atomics (4 per cell, tap and channel) bound this
//     pass, and they make the float32 sums' order vary from run to run.
// wgmma, TMA, a persistent schedule and a scatter-free dx are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BP = 64;   // output cells per block
constexpr int BN = 256;  // output channels per block
constexpr int NT = 256;  // threads per block (8 warps)

// Corner rows (in x viewed as [B*H*W, C], -1 = outside) and weights of the
// NC cells p0 .. p0+NC-1 for tap t (cells at or past P get none); threads
// 0..NC-1 each fill one cell.
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

// --------------------------------------------------------------- bfloat16
constexpr int KC16 = 64;        // input channels per slice
constexpr int LDA = KC16 + 8;   // padded rows (elements) of the sample tile
constexpr int LDB = BN + 8;     // padded rows (elements) of the W slice

union Vec8 {
  uint4 u;
  __nv_bfloat16 h[8];
};

__global__ void __launch_bounds__(NT)
deform_fwd_bf16(const __nv_bfloat16* __restrict__ x, const float* __restrict__ off,
                const __nv_bfloat16* __restrict__ wt, __nv_bfloat16* __restrict__ out,
                int B, int H, int W, int C, int Cout) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 s_samp[BP * LDA];  // A: 64 x 64
  __shared__ __align__(128) __nv_bfloat16 s_w[KC16 * LDB];   // B: 64 x 256
  __shared__ int s_idx[BP][4];
  __shared__ float s_cw[BP][4];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long P = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * BP;
  const int n0 = blockIdx.y * BN;
  const int row0 = (warp & 3) * 16;    // warp's 16 cells
  const int col0 = (warp >> 2) * 128;  // warp's 128 output channels

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (int t = 0; t < 9; ++t) {
    __syncthreads();
    tap_corners<BP>(off, p0, P, H, W, t, s_idx, s_cw);
    __syncthreads();
    for (int c0 = 0; c0 < C; c0 += KC16) {
      // 64 cells x 8 vectors of 8 channels: 2 vector samples per thread
#pragma unroll
      for (int i = 0; i < (BP * KC16 / 8) / NT; ++i) {
        const int e = tid + i * NT;
        const int cell = e >> 3;
        const int c = (e & 7) * 8;
        float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        if (c0 + c < C) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = s_idx[cell][q];
            if (r >= 0) {
              Vec8 in;
              in.u = *reinterpret_cast<const uint4*>(x + (long long)r * C + c0 + c);
              const float cw = s_cw[cell][q];
#pragma unroll
              for (int k = 0; k < 8; ++k)
                v[k] = __fadd_rn(v[k], __fmul_rn(cw, __bfloat162float(in.h[k])));
            }
          }
        }
        Vec8 o;
#pragma unroll
        for (int k = 0; k < 8; ++k) o.h[k] = __float2bfloat16(v[k]);
        *reinterpret_cast<uint4*>(&s_samp[cell * LDA + c]) = o.u;
      }
      // the 64 x 256 slice of W[t], 8 vectors per thread
#pragma unroll
      for (int i = 0; i < (KC16 * BN / 8) / NT; ++i) {
        const int e = tid + i * NT;
        const int k = e >> 5;
        const int n = (e & 31) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (c0 + k < C && n0 + n < Cout)
          v = *reinterpret_cast<const uint4*>(
              wt + ((long long)t * C + c0 + k) * Cout + n0 + n);
        *reinterpret_cast<uint4*>(&s_w[k * LDB + n]) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC16; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, &s_samp[row0 * LDA + kk], LDA);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
          wmma::load_matrix_sync(b, &s_w[kk * LDB + col0 + j * 16], LDB);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }
  }

  // epilogue: each warp stages one 16x16 float tile at a time in the (now
  // free) sample buffer, then writes 8 bf16 outputs per lane
  float* stage = reinterpret_cast<float*>(s_samp) + warp * 256;
  const int r = lane >> 1;
  const int cc = (lane & 1) * 8;
  const long long p = p0 + row0 + r;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    const int n = n0 + col0 + j * 16 + cc;
    if (p < P && n < Cout) {
      Vec8 o;
#pragma unroll
      for (int k = 0; k < 8; ++k) o.h[k] = __float2bfloat16(stage[r * 16 + cc + k]);
      *reinterpret_cast<uint4*>(out + p * Cout + n) = o.u;
    }
    __syncwarp();
  }
}


// =============================================================== backward
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

// ----------------------------------------------------- dW, bfloat16
// Same blocks; per 64-cell step the samples (A, stored cell-major = column
// major for the channel x cell operand) and g (B) are staged in shared memory
// and multiplied on the tensor cores; each warp owns a 16 x 128 tile of dW.
__global__ void __launch_bounds__(NT)
deform_bwd_dw_bf16(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ off,
                   const __nv_bfloat16* __restrict__ g, float* __restrict__ dw,
                   int B, int H, int W, int C, int Cout, long long chunk) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 s_samp[BP * LDA];  // [cell][channel]
  __shared__ __align__(128) __nv_bfloat16 s_g[BP * LDB];     // [cell][out ch.]
  __shared__ int s_idx[BP][4];
  __shared__ float s_cw[BP][4];

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
  const int row0 = (warp & 3) * 16;    // warp's 16 input channels
  const int col0 = (warp >> 2) * 128;  // warp's 128 output channels

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);

  for (long long p0 = pbeg; p0 < pend; p0 += BP) {
    __syncthreads();
    tap_corners<BP>(off, p0, pend, H, W, t, s_idx, s_cw);
    __syncthreads();
    // 64 cells x 8 vectors of 8 channels: 2 vector samples per thread
#pragma unroll
    for (int i = 0; i < (BP * MC / 8) / NT; ++i) {
      const int e = tid + i * NT;
      const int cell = e >> 3;
      const int c = (e & 7) * 8;
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (c0 + c < C) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = s_idx[cell][q];
          if (r >= 0) {
            Vec8 in;
            in.u = *reinterpret_cast<const uint4*>(x + (long long)r * C + c0 + c);
            const float cw = s_cw[cell][q];
#pragma unroll
            for (int k = 0; k < 8; ++k)
              v[k] = __fadd_rn(v[k], __fmul_rn(cw, __bfloat162float(in.h[k])));
          }
        }
      }
      Vec8 o;
#pragma unroll
      for (int k = 0; k < 8; ++k) o.h[k] = __float2bfloat16(v[k]);
      *reinterpret_cast<uint4*>(&s_samp[cell * LDA + c]) = o.u;
    }
    // g of the 64 cells, 256 output channels: 8 vectors per thread
#pragma unroll
    for (int i = 0; i < (BP * BN / 8) / NT; ++i) {
      const int e = tid + i * NT;
      const int cell = e >> 5;
      const int n = (e & 31) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (p0 + cell < pend && n0 + n < Cout)
        v = *reinterpret_cast<const uint4*>(g + (p0 + cell) * Cout + n0 + n);
      *reinterpret_cast<uint4*>(&s_g[cell * LDB + n]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BP; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major> a;
      wmma::load_matrix_sync(a, &s_samp[kk * LDA + row0], LDA);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b;
        wmma::load_matrix_sync(b, &s_g[kk * LDB + col0 + j * 16], LDB);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
  }

  __syncthreads();  // every warp is done with s_samp: reuse it as staging
  float* stage = reinterpret_cast<float*>(s_samp) + warp * 256;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane + 32 * i;
      const int c = c0 + row0 + (e >> 4);
      const int n = n0 + col0 + j * 16 + (e & 15);
      if (c < C && n < Cout) atomicAdd(&dw[((long long)t * C + c) * Cout + n], stage[e]);
    }
    __syncwarp();
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

// ----------------------------------------------------- dx, bfloat16
// As the float32 version, with g (A) and W[t] (B, stored input-channel-major
// = column major) staged in 64-channel slices of Cout and multiplied on the
// tensor cores; each warp owns 16 cells x 128 input channels.
constexpr int LDK = KC16 + 8;  // padded rows (elements) of the g and W tiles

__global__ void __launch_bounds__(NT)
deform_bwd_dx_bf16(const float* __restrict__ off,
                   const __nv_bfloat16* __restrict__ wt,
                   const __nv_bfloat16* __restrict__ g, float* __restrict__ dx,
                   int B, int H, int W, int C, int Cout) {
  using namespace nvcuda;
  __shared__ __align__(128) __nv_bfloat16 s_g[BP * LDK];  // [cell][out ch.]
  __shared__ __align__(128) __nv_bfloat16 s_w[BN * LDK];  // [in ch.][out ch.]
  __shared__ int s_idx[BP][4];
  __shared__ float s_cw[BP][4];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long P = (long long)B * H * W;
  const long long p0 = (long long)blockIdx.x * BP;
  const int n0 = blockIdx.y * BN;
  const int row0 = (warp & 3) * 16;    // warp's 16 cells
  const int col0 = (warp >> 2) * 128;  // warp's 128 input channels

  for (int t = 0; t < 9; ++t) {
    __syncthreads();  // the previous tap's scatter has read s_g, s_idx, s_cw
    tap_corners<BP>(off, p0, P, H, W, t, s_idx, s_cw);
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.f);
    for (int k0 = 0; k0 < Cout; k0 += KC16) {
      // g: 64 cells x 8 vectors of 8 output channels, 2 per thread
#pragma unroll
      for (int i = 0; i < (BP * KC16 / 8) / NT; ++i) {
        const int e = tid + i * NT;
        const int cell = e >> 3;
        const int k = (e & 7) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (p0 + cell < P && k0 + k < Cout)
          v = *reinterpret_cast<const uint4*>(g + (p0 + cell) * Cout + k0 + k);
        *reinterpret_cast<uint4*>(&s_g[cell * LDK + k]) = v;
      }
      // W[t]: 256 input channels x 8 vectors of 8 output channels, 8 per thread
#pragma unroll
      for (int i = 0; i < (BN * KC16 / 8) / NT; ++i) {
        const int e = tid + i * NT;
        const int n = e >> 3;
        const int k = (e & 7) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + n < C && k0 + k < Cout)
          v = *reinterpret_cast<const uint4*>(
              wt + ((long long)t * C + n0 + n) * Cout + k0 + k);
        *reinterpret_cast<uint4*>(&s_w[n * LDK + k]) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC16; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
        wmma::load_matrix_sync(a, &s_g[row0 * LDK + kk], LDK);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
          wmma::load_matrix_sync(b, &s_w[(col0 + j * 16) * LDK + kk], LDK);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
      __syncthreads();
    }
    // scatter: each warp stages one 16x16 float tile at a time in s_g
    float* stage = reinterpret_cast<float*>(s_g) + warp * 256;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      wmma::store_matrix_sync(stage, acc[j], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int e = lane + 32 * i;
        const int cell = row0 + (e >> 4);
        const int n = n0 + col0 + j * 16 + (e & 15);
        if (n >= C) continue;
        const float v = stage[e];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = s_idx[cell][q];
          if (r >= 0) atomicAdd(&dx[(long long)r * C + n], s_cw[cell][q] * v);
        }
      }
      __syncwarp();
    }
  }
}

__global__ void cast_to_bf16(const float* __restrict__ src,
                             __nv_bfloat16* __restrict__ dst, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    dst[i] = __float2bfloat16(src[i]);
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
  dim3 grid((unsigned)((P + BP - 1) / BP), (unsigned)((Cout + BN - 1) / BN));
  if (dtype == 0) {
    deform_fwd_f32<<<grid, NT, 0, s>>>(
        static_cast<const float*>(x), off, static_cast<const float*>(weight),
        static_cast<float*>(out), B, H, W, C, Cout);
  } else if (dtype == 1) {
    if (C % 8 != 0 || Cout % 8 != 0) return (int)cudaErrorInvalidValue;
    deform_fwd_bf16<<<grid, NT, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), off,
        static_cast<const __nv_bfloat16*>(weight),
        static_cast<__nv_bfloat16*>(out), B, H, W, C, Cout);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Backward of s2a_deform_conv2d_fwd for the same x, offsets and weight and
// the output gradient grad [B,H,W,Cout] (x's type). dx32 [B,H,W,C] and
// dw [3,3,C,Cout] are float32 and must be zero on entry; for bfloat16, dx
// [B,H,W,C] receives dx32 cast to bfloat16 (for float32 pass dx == dx32).
// chunks: cell chunks of the dW reduction. Returns the launches'
// cudaError_t.
int s2a_deform_conv2d_bwd(const void* x, const void* offsets, const void* weight,
                          const void* grad, void* dx32, void* dx, void* dw,
                          int B, int H, int W, int C, int Cout, int chunks,
                          int dtype, void* stream) {
  const long long P = (long long)B * H * W;
  if (P == 0 || C == 0 || Cout == 0) return 0;
  if (chunks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* off = static_cast<const float*>(offsets);
  const long long step = dtype == 1 ? BP : KP32;
  const long long per = (P + chunks - 1) / chunks;
  const long long chunk = (per + step - 1) / step * step;
  dim3 grid_dw((unsigned)((P + chunk - 1) / chunk),
               (unsigned)(9 * ((C + MC - 1) / MC)), (unsigned)((Cout + BN - 1) / BN));
  dim3 grid_dx((unsigned)((P + BP - 1) / BP), (unsigned)((C + BN - 1) / BN));
  float* dxf = static_cast<float*>(dx32);
  float* dwf = static_cast<float*>(dw);
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(weight);
    const float* gf = static_cast<const float*>(grad);
    deform_bwd_dw_f32<<<grid_dw, NT, 0, s>>>(xf, off, gf, dwf, B, H, W, C, Cout, chunk);
    deform_bwd_dx_f32<<<grid_dx, NT, 0, s>>>(off, wf, gf, dxf, B, H, W, C, Cout);
  } else if (dtype == 1) {
    if (C % 8 != 0 || Cout % 8 != 0) return (int)cudaErrorInvalidValue;
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
    const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(weight);
    const __nv_bfloat16* gb = static_cast<const __nv_bfloat16*>(grad);
    deform_bwd_dw_bf16<<<grid_dw, NT, 0, s>>>(xb, off, gb, dwf, B, H, W, C, Cout, chunk);
    deform_bwd_dx_bf16<<<grid_dx, NT, 0, s>>>(off, wb, gb, dxf, B, H, W, C, Cout);
    const long long n = P * C;
    const long long blocks = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
    cast_to_bf16<<<(unsigned)blocks, 256, 0, s>>>(dxf, static_cast<__nv_bfloat16*>(dx), n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* s2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
