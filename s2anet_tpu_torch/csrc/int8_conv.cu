// int8 post-training-quantised convolution for serving: the activation
// quantiser and the int8 implicit-GEMM convolution.
//
//   s2a_quantize_act   x (bf16 or f32) -> int8 clip(rint(x / s) + zp, +-127)
//   s2a_int8_conv2d    xq int8 [B,H,W,Cin] (*) wq int8 [Cout,kh,kw,Cin]
//                      -> y [B,Ho,Wo,Cout] (bf16 or f32) =
//                      cast((acc - corr) * (s*sw)) (+ cast(bias))
//
// Replace the int8 path of s2anet_tpu/ops/quant.py::int8_conv (:151): the
// activation quantisation (an elementwise XLA fusion on the TPU), the
// zero-point padding, the int8 x int8 -> int32 lax.conv_general_dilated
// (preferred_element_type=int32, XLA's MXU convolution) and the
// dequantising epilogue. Neither is a Pallas kernel in the JAX package.
//
// Numerics, equal bit for bit to the plain PyTorch versions
// (ops/quant.py::quantize_act_plain, ::int8_conv2d_plain):
//   * the quantiser divides (IEEE __fdiv_rn, not a product with 1/s) and
//     rounds half to even (rintf), as jnp.round(x / s) does; s and zp are
//     float32 scalars on the device, so no launch waits for the host;
//   * the convolution sums exactly in int32 (|acc| <= K * 127 * 127 < 2^31
//     for K = kh*kw*Cin <= 9 * 2048); taps outside the input read the zero
//     point zp while the tile is gathered, the zppad form of the JAX
//     package (pad with zp, then corr = zp * sum(wq) per output channel),
//     with no padded copy of the input;
//   * the epilogue converts acc - corr to float32 (round to nearest),
//     multiplies by s*sw with __fmul_rn, rounds to the output type, and
//     then adds the bias as the JAX order has it: both rounded to the
//     output type, added in float32 (__fadd_rn), rounded again.
//
// What bounds them on an H100. The quantiser: memory, reading 2 (bf16) or
// 4 (f32) bytes and writing 1 an element; each thread moves 16 elements
// with 16-byte loads and one 16-byte store. About half of a post-ReLU
// activation is exactly 0, a dividend that sends IEEE division down its
// slow path, so zeros are kept out of the division (on an H100 that lifts
// the kernel from under half of its byte bound to about three quarters on
// such data; chip_smoke.py phase 13 times it per shape). The convolution: at R-50's
// shapes, int8 operations (2*M*N*K over 1,979 TOPS) bound the 3x3 convs and
// bytes the 1x1 ones of stages 1-2. This first version computes on the
// tensor cores with mma.sync.m16n8k32.s8.s8.s32 (a warp-level instruction;
// the full int8 rate needs wgmma fed by TMA, later work). A block of 256
// threads (8 warps, 4 along M x 2 along N) takes 128 output pixels x BN
// output channels (BN = 128, or 64 when Cout <= 64), 64 bytes of K a stage,
// in a ring of 4 stages filled by cp.async: each thread gathers 16-byte
// segments of the implicit im2col rows (a segment never straddles two taps,
// since Cin % 16 == 0) and writes the zero point (st.shared) where a tap
// falls outside the input. Shared rows of 64 bytes are XOR-swizzled by
// 16-byte segment, so the ldmatrix reads of the fragments are free of bank
// conflicts. The epilogue stages the block's outputs in shared memory (the
// ring's space) and writes whole rows in 16-byte vectors, masked for
// ragged M; a Cout that is not a multiple of the vector (the prediction
// heads' 5 and num_classes) is written element by element.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int QT = 256;      // threads of the quantiser
constexpr int QV = 16;       // elements a thread per step
constexpr int CT = 256;      // threads of the convolution
constexpr int BM = 128;      // output pixels a block
constexpr int BK = 64;       // bytes of K a stage
constexpr int STAGES = 4;    // ring of shared-memory stages
constexpr int CPAD = 8;      // padding of an output tile row, in elements

__device__ __forceinline__ int quant1(float v, float s, float zp) {
  // a zero dividend (half of a post-ReLU activation) would take the
  // division's slow path: divide 1 instead and keep the signed zero, whose
  // code rint(+-0) + zp = zp is the same
  const float d = __fdiv_rn(v == 0.f ? 1.f : v, s);
  float q = rintf(v == 0.f ? v : d) + zp;  // zp is an integer: exact
  q = fminf(fmaxf(q, -127.f), 127.f);
  return __float2int_rn(q);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) | ((uint32_t)(c & 0xff) << 16) |
         ((uint32_t)(d & 0xff) << 24);
}

__device__ __forceinline__ void load16(const float* p, float v[QV]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 t = q[i];
    v[4 * i] = t.x;
    v[4 * i + 1] = t.y;
    v[4 * i + 2] = t.z;
    v[4 * i + 3] = t.w;
  }
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float v[QV]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 t = q[i];
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[8 * i + 2 * j] = __uint_as_float(w[j] << 16);
      v[8 * i + 2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
}

__device__ __forceinline__ uint32_t quant4(const float* v, float s, float zp) {
  return pack4(quant1(v[0], s, zp), quant1(v[1], s, zp), quant1(v[2], s, zp),
               quant1(v[3], s, zp));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(QT)
quantize_act_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    const float* __restrict__ sp, const float* __restrict__ zpp,
                    long long nv, long long n) {
  const float s = *sp, zp = *zpp;
  const long long step = (long long)gridDim.x * QT;
  for (long long i = (long long)blockIdx.x * QT + threadIdx.x; i < nv; i += step) {
    float v[QV];
    load16(x + i * QV, v);
    reinterpret_cast<uint4*>(q)[i] =
        make_uint4(quant4(v, s, zp), quant4(v + 4, s, zp), quant4(v + 8, s, zp),
                   quant4(v + 12, s, zp));
  }
  if (blockIdx.x == 0)  // the tail past the last whole vector
    for (long long j = nv * QV + threadIdx.x; j < n; j += QT)
      q[j] = (int8_t)quant1(to_f32(x[j]), s, zp);
}

template <typename T>
int launch_quantize(const void* x, void* q, const void* s, const void* zp, long long n,
                    cudaStream_t stream) {
  const long long nv = n / QV;
  long long blocks = (nv + QT - 1) / QT;
  if (blocks > 132 * 16) blocks = 132 * 16;  // two waves, then each thread strides
  if (blocks < 1) blocks = 1;
  quantize_act_kernel<T><<<(unsigned)blocks, QT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<const float*>(s),
      static_cast<const float*>(zp), nv, n);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- conv

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst), "r"(v) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t& r0, uint32_t& r1,
                                            uint32_t& r2, uint32_t& r3) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte offset of 16-byte segment `seg` (0..3) of row `row` in a [rows][64]
// tile: segments are XOR-swizzled by (row / 2) % 4, so the 8 rows of an
// ldmatrix phase fall on 8 distinct groups of 4 banks
__device__ __forceinline__ uint32_t tile_off(int row, int seg) {
  return (uint32_t)(row * BK + ((seg ^ ((row >> 1) & 3)) << 4));
}

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  const float* mul;
  const int* corr;
  const float* bias;
  const float* zp;
  void* y;
  int B, H, W, Cin, Cout, kh, kw, stride, pad, Ho, Wo;
  long long M;
  int K;
};

// y = cast((acc - corr) * mul), then + cast(bias), the sum rounded to the
// output type (by the store)
template <typename OutT>
__device__ __forceinline__ float epilogue(int acc, int corr, float mul, const float* bias, int n) {
  float v = __fmul_rn(__int2float_rn(acc - corr), mul);
  if constexpr (std::is_same<OutT, float>::value) {
    if (bias != nullptr) v = __fadd_rn(v, bias[n]);
  } else {
    v = __bfloat162float(__float2bfloat16_rn(v));
    if (bias != nullptr) v = __fadd_rn(v, __bfloat162float(__float2bfloat16_rn(bias[n])));
  }
  return v;
}

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v) {
  if constexpr (std::is_same<OutT, float>::value)
    return v;
  else
    return __float2bfloat16_rn(v);
}

template <typename OutT, int BN>
__global__ void __launch_bounds__(CT, 2) int8_conv_kernel(const ConvArgs a) {
  constexpr int WN = BN / 2;    // output channels a warp
  constexpr int NT = WN / 8;    // n8 tiles a warp
  constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
  constexpr int B_ROWS = BN / 64;  // weight rows a thread loads a stage
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base = smem_addr(smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int seg = tid & 3;

  const int zpi = __float2int_rn(*a.zp);
  const uint32_t zp_splat = (uint32_t)(zpi & 0xff) * 0x01010101u;

  // this thread's two im2col rows: the image's base and the top-left tap
  const int8_t* xrow[2];
  int iy0[2], ix0[2];
  bool mok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + (tid >> 2) + 64 * i;
    mok[i] = m < a.M;
    const long long mm = mok[i] ? m : 0;
    const int hw = a.Ho * a.Wo;
    const int b = (int)(mm / hw);
    const int r = (int)(mm - (long long)b * hw);
    const int oy = r / a.Wo, ox = r - (r / a.Wo) * a.Wo;
    iy0[i] = oy * a.stride - a.pad;
    ix0[i] = ox * a.stride - a.pad;
    xrow[i] = a.x + (long long)b * a.H * a.W * a.Cin;
  }

  auto load_stage = [&](int stage, int kc) {
    const uint32_t sa = base + stage * (A_BYTES + B_BYTES);
    const uint32_t sb = sa + A_BYTES;
    const int k = kc * BK + seg * 16;
    const bool kok = k < a.K;
    const int tap = kok ? k / a.Cin : 0;
    const int ci = k - tap * a.Cin;
    const int ky = tap / a.kw, kx = tap - (tap / a.kw) * a.kw;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = (tid >> 2) + 64 * i;
      const int iy = iy0[i] + ky, ix = ix0[i] + kx;
      const uint32_t dst = sa + tile_off(row, seg);
      if (kok && mok[i] && iy >= 0 && iy < a.H && ix >= 0 && ix < a.W)
        cp_async16(dst, xrow[i] + ((long long)iy * a.W + ix) * a.Cin + ci);
      else
        st_shared16(dst, kok ? zp_splat : 0u);
    }
#pragma unroll
    for (int i = 0; i < B_ROWS; ++i) {
      const int row = (tid >> 2) + 64 * i;
      const int n = n0 + row;
      const uint32_t dst = sb + tile_off(row, seg);
      if (kok && n < a.Cout)
        cp_async16(dst, a.w + (long long)n * a.K + k);
      else
        st_shared16(dst, 0u);
    }
  };

  int acc[2][NT][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (a.K + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  const int q = lane >> 3, r8 = lane & 7;
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nxt = kc + STAGES - 1;
    if (nxt < nk) load_stage(nxt % STAGES, nxt);
    cp_async_commit();

    const uint32_t sa = base + (kc % STAGES) * (A_BYTES + B_BYTES);
    const uint32_t sb = sa + A_BYTES;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {  // two k32 steps a stage
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // matrices: rows 0-7 / 8-15 x bytes 0-15, then x bytes 16-31
        const int row = wm * 32 + mt * 16 + r8 + ((q & 1) << 3);
        ldmatrix_x4(sa + tile_off(row, 2 * kk + (q >> 1)), af[mt][0], af[mt][1], af[mt][2],
                    af[mt][3]);
      }
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        // matrices: n tile 2jp (k 0-15, 16-31), then n tile 2jp + 1
        const int row = wn * WN + jp * 16 + ((q >> 1) << 3) + r8;
        uint32_t b0, b1, b2, b3;
        ldmatrix_x4(sb + tile_off(row, 2 * kk + (q & 1)), b0, b1, b2, b3);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma_s8(acc[mt][2 * jp], af[mt], b0, b1);
          mma_s8(acc[mt][2 * jp + 1], af[mt], b2, b3);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring: it becomes the output tile

  // the epilogue's values into a [BM][BN + CPAD] tile of the output type
  // (rows padded so the fragment writes and the row reads are free of bank
  // conflicts), then whole rows out in 16-byte vectors
  OutT* cs = reinterpret_cast<OutT*>(smem);
  constexpr int LDC = BN + CPAD;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int nl = wn * WN + nt * 8 + t4 * 2 + e;
      const int n = n0 + nl;
      const bool nok = n < a.Cout;
      const float mul = nok ? a.mul[n] : 0.f;
      const int corr = nok ? a.corr[n] : 0;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ml = wm * 32 + mt * 16 + g + 8 * h;
          cs[ml * LDC + nl] =
              to_out<OutT>(nok ? epilogue<OutT>(acc[mt][nt][2 * h + e], corr, mul, a.bias, n)
                               : 0.f);
        }
      }
    }
  }
  __syncthreads();
  constexpr int V = 16 / sizeof(OutT);  // elements a vector
  constexpr int CPR = BN / V;           // vectors a tile row
  OutT* y = static_cast<OutT*>(a.y);
  const bool vec = a.Cout % V == 0;     // rows start 16-byte aligned
  for (int i = tid; i < BM * CPR; i += CT) {
    const int r = i / CPR, c = i - (i / CPR) * CPR;
    const long long m = m0 + r;
    const int n = n0 + c * V;
    if (m >= a.M || n >= a.Cout) continue;
    const OutT* src = cs + r * LDC + c * V;
    OutT* dst = y + m * a.Cout + n;
    if (vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int j = 0; j < V && n + j < a.Cout; ++j) dst[j] = src[j];
    }
  }
}

template <typename OutT, int BN>
int launch_conv(const ConvArgs& a, cudaStream_t stream) {
  const int ring = STAGES * (BM + BN) * BK, tile = BM * (BN + CPAD) * (int)sizeof(OutT);
  const int smem = ring > tile ? ring : tile;
  static bool attr = false;  // opt in to more than 48 KB once
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(int8_conv_kernel<OutT, BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const long long mt = (a.M + BM - 1) / BM;
  if (mt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)mt, (unsigned)((a.Cout + BN - 1) / BN));
  int8_conv_kernel<OutT, BN><<<grid, CT, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_conv_n(const ConvArgs& a, cudaStream_t stream) {
  return a.Cout <= 64 ? launch_conv<OutT, 64>(a, stream) : launch_conv<OutT, 128>(a, stream);
}

}  // namespace

extern "C" {

// x [n] (dtype 0 = float32, 1 = bfloat16; 16-byte aligned), q int8 [n];
// scale and zp float32 scalars on the device
int s2a_quantize_act(const void* x, void* q, const void* scale, const void* zp, long long n,
                     int dtype, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_quantize<float>(x, q, scale, zp, n, s);
  if (dtype == 1) return launch_quantize<__nv_bfloat16>(x, q, scale, zp, n, s);
  return (int)cudaErrorInvalidValue;
}

// xq int8 [B,H,W,Cin], wq int8 [Cout,kh,kw,Cin] (Cin % 16 == 0, both
// 16-byte aligned); mul float32 [Cout] = s*sw; corr int32 [Cout] =
// zp*sum(wq); bias float32 [Cout] or null; zp the float32 zero point on the
// device (the value of taps outside the input); y [B,Ho,Wo,Cout] in
// out_dtype (0 = float32, 1 = bfloat16). Symmetric padding `pad`.
int s2a_int8_conv2d(const void* xq, const void* wq, const void* mul, const void* corr,
                    const void* bias, const void* zp, void* y, int B, int H, int W, int Cin,
                    int Cout, int kh, int kw, int stride, int pad, int Ho, int Wo,
                    int out_dtype, void* stream) {
  if (B == 0 || Ho == 0 || Wo == 0 || Cout == 0) return 0;
  if (Cin % 16 != 0 || Cin == 0 || stride < 1 || (long long)Cout > 65535LL * 64)
    return (int)cudaErrorInvalidValue;
  ConvArgs a{static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
             static_cast<const float*>(mul), static_cast<const int*>(corr),
             static_cast<const float*>(bias), static_cast<const float*>(zp), y,
             B, H, W, Cin, Cout, kh, kw, stride, pad, Ho, Wo,
             (long long)B * Ho * Wo, kh * kw * Cin};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) return launch_conv_n<float>(a, s);
  if (out_dtype == 1) return launch_conv_n<__nv_bfloat16>(a, s);
  return (int)cudaErrorInvalidValue;
}

const char* s2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
