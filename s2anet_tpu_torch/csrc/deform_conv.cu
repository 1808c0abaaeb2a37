// AlignConv forward: 3x3 deformable convolution, stride 1, 'same' padding,
// one deformable group, NHWC.
//
// Replaces the TPU kernel s2anet_tpu/ops/pallas/deform_kernel.py::_fwd_kernel
// (and its DMA-window twin _fwd_kernel_dma). That kernel had no gather, so it
// built each tap's bilinear "hat" matrix over a window of the map and rode
// the matrix unit. Hopper gathers natively, so this kernel samples directly:
// it is exact for every offset and needs neither the window nor the window
// predicate and gather fallback that guarded the TPU kernel.
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
// What bounds it on an H100: 9*C*Cout multiply-adds per output cell (P3 at
// batch 8: 77 GMAC) against 9*4*C gathered corner values per cell, which
// mostly hit L2. A block owns 64 output cells and up to 256 output
// channels; per tap and per slice of input channels it gathers the 64 cells'
// samples and the slice of W[t] into shared memory, then multiplies:
//   * bfloat16 (the serving type): 64-channel slices, 16-byte vector
//     gathers, and the product on the tensor cores (WMMA bf16 16x16x16,
//     float32 accumulators; each warp owns a 16x128 output tile). Needs C
//     and Cout to be multiples of 8.
//   * float32: 32-channel slices and the product on the CUDA cores, an 8x8
//     float32 register tile per thread, so float32 results stay exact to
//     float32 rounding (tensor cores would round to TF32).
// wgmma, TMA and a persistent schedule are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BP = 64;   // output cells per block
constexpr int BN = 256;  // output channels per block
constexpr int NT = 256;  // threads per block (8 warps)

// Corner rows (in x viewed as [B*H*W, C], -1 = outside) and weights of the
// block's 64 cells for tap t; threads 0..63 each fill one cell.
__device__ __forceinline__ void tap_corners(const float* __restrict__ off,
                                            long long p0, long long P, int H,
                                            int W, int t, int (*s_idx)[4],
                                            float (*s_cw)[4]) {
  const int tid = threadIdx.x;
  if (tid >= BP) return;
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
    tap_corners(off, p0, P, H, W, t, s_idx, s_cw);
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
    tap_corners(off, p0, P, H, W, t, s_idx, s_cw);
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

const char* s2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
