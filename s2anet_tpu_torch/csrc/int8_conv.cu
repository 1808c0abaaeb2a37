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
//     for K = kh*kw*Cin <= 9 * 2048, in every partial sum and in the
//     total); taps outside the input read the zero point zp while the tile
//     is gathered, the zppad form of the JAX package (pad with zp, then
//     corr = zp * sum(wq) per output channel), with no padded copy of the
//     input. int32 addition is exact and associative, so K split over
//     blocks gives the same bits in any order;
//   * the epilogue converts acc - corr to float32 (round to nearest),
//     multiplies by s*sw with __fmul_rn, rounds to the output type, and
//     then adds the bias as the JAX order has it: both rounded to the
//     output type, added in float32 (__fadd_rn), rounded again.
//
// The quantiser is bound by memory, reading 2 (bf16) or 4 (f32) bytes and
// writing 1 an element; each thread moves 16 elements with 16-byte loads
// and one 16-byte store. About half of a post-ReLU activation is exactly 0,
// a dividend that sends IEEE division down its slow path, so zeros are kept
// out of the division.
//
// The convolution is an implicit GEMM, M = B*Ho*Wo output pixels, N = Cout,
// K = kh*kw*Cin, with int8 operands K-major on both sides (the NHWC im2col
// rows and wq [Cout, K]), as 8-bit wgmma needs. One kernel (sm_90a), 384
// threads: two consumer warpgroups multiply with
// wgmma.mma_async.m64nNk32.s32.s8.s8 (N = the tile's BN, 64, 128 or 256)
// on swizzled shared tiles, int32 accumulators in registers; one producer
// warpgroup (its registers lowered by setmaxnreg) fills a ring of stages of
// KB bytes of K (A: 128 pixels, B: BN channels), joined to the consumers by
// full and empty mbarriers, with no block barrier in the main loop. The
// tiles, KB, the K split and the persistent grid come from the host
// (ops/quant.py::conv_plan). W arrives by TMA (a 2-D tensor map over
// [Cout, K], boxes of 64 rows; reads past K or Cout are zeros, so whatever
// the A tail holds adds nothing). A arrives in one of three ways:
//   1. a 1x1 stride-1 conv is a plain [M, Cin] x [Cin, Cout] product: TMA
//      over [M, Cin];
//   2. a stride-1 conv whose 128-pixel tiles are boxes of the output (a
//      piece of a row, whole rows or whole images: every shape of R-50 at
//      1024^2): one 4-D TMA box of x a stage, shifted by the stage's tap
//      (KB = 128, or 64 / 32 with the matching swizzle when Cin is 64 or
//      32, so a stage lies in one tap). TMA fills pixels outside the image
//      with zeros; where a box leaves the image, the TMA lands on a second
//      barrier and three producer warps write the zero point over those
//      rows before they arrive, so the sums stay those of the zppad form;
//   3. otherwise (stride 2, odd shapes) the producer gathers 16-byte
//      segments with cp.async (Cin % 16 == 0: a segment never straddles
//      two taps), writes zp (st.shared) where a tap leaves the image, and
//      arrives twice: once for its stores, and by
//      cp.async.mbarrier.arrive.noinc once its copies land, so it never
//      waits for its own loads. The consumers fence the generic-proxy
//      writes (fence.proxy.async) before their wgmma reads them.
//
// What bounds each class of R-50's shapes on an H100, and what the design
// does about it:
//   * large 3x3 convs (the P3 and P4 head stacks, layers 2-3): int8
//     operations (2*M*N*K over 1,979 TOPS). 128 x 256 tiles, every k32
//     step issued without a condition, A by TMA (the cp.async gather
//     could not keep more than about 16 KB a microsecond in flight on an
//     SM), a ring of 4 stages: the loads of later stages run under the
//     products of the current one. The epilogue does not overlap the
//     products; it is the next gap.
//   * small M (P5-P7 stacks, the FPN's P6 and P7 convs): latency. Their
//     tile grid is under one wave of 132 SMs, so K is split over blocks
//     (`splits` ranges of `kper` stages). Each block stores its int32
//     partial tile to a workspace in a layout private to the kernel (one
//     16-byte vector a thread, coalesced); a ticket per tile, drawn after
//     a __threadfence, picks the last block to arrive, which adds the
//     others' partials to its registers, runs the epilogue once on the
//     total and sets the ticket back to 0, so one persistent buffer of
//     tickets serves every launch on a stream. A conv stays one launch.
//   * 1x1 convs of layers 1-2 (bytes: the bf16 output is most of them):
//     persistent blocks (at most one wave) walk the output tiles, so the
//     producer loads the next tiles while the consumers finish one. The
//     epilogue's type conversions (int32 -> float32 and the bf16 roundings,
//     a quarter of the FP32 rate) bound it: the per-channel constants sit
//     in shared memory once per tile column, the bf16 roundings are packed
//     two a conversion, and each 64-channel slice of the tile is staged in
//     shared memory (rows padded for conflict-free writes) and leaves in
//     whole 16-byte row vectors, masked for ragged M, element by element
//     where Cout is not a multiple of the vector (the prediction heads' 5
//     and num_classes). Slicing the staging keeps room for the ring.

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int QT = 256;      // threads of the quantiser
constexpr int QV = 16;       // elements a thread per step

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}

// an arrival on the mbarrier once every cp.async this thread issued so far
// has landed (counted in the barrier's expected arrivals)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint32_t v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %1, %1, %1};\n" ::"r"(dst), "r"(v) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// `bytes` more expected from TMA copies on this phase, no arrival
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// generic-proxy shared writes (st.shared, cp.async) made visible to the
// async proxy (wgmma)
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
__device__ __forceinline__ void fence_acc(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory descriptor of a K-major operand with the KB-byte
// swizzle (KB = 128, 64 or 32: what TMA's SWIZZLE_<KB>B writes): rows of
// KB bytes of K, 8-row groups 8*KB bytes apart. Every tile starts on a
// 1024-byte boundary; a k32 step adds 32 bytes to the start address (+2 in
// the descriptor's 16-byte units).
template <int KB>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  constexpr uint64_t layout = KB == 128 ? 1 : KB == 64 ? 2 : 3;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(8 * KB >> 4) << 32) | (layout << 62);
}

// byte offset of the 16-byte segment `seg` (0..7) of row `row` in a tile of
// 128-byte rows with the 128-byte swizzle (what TMA's SWIZZLE_128B writes)
__device__ __forceinline__ uint32_t swz(int row, int seg) {
  return (uint32_t)(row * 128 + ((seg ^ (row & 7)) << 4));
}

// D[64 x N] (+)= A[64 x 32] B[32 x N], s8 in, s32 accumulators, both
// operands K-major in shared memory; scale_d 0 overwrites D. Thread (warp w
// of the warpgroup, lane l) holds, for each 8-column chunk j, rows
// 16w + l/4 and 16w + l/4 + 8 at columns 8j + 2(l%4) and +1, as d[4j],
// d[4j+1] (first row) and d[4j+2], d[4j+3] (second row).
template <int N>
__device__ __forceinline__ void wgmma_s8(int (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8<64>(int (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<128>(int (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8<256>(int (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}

constexpr int HT = 384;             // threads: consumer warpgroups 0, 1; producer 2
constexpr int PRODUCER_REGS = 120;  // setmaxnreg: the gather warpgroup
constexpr int CONSUMER_REGS = 192;  // up to 128 accumulators and addressing
constexpr int BM = 128;             // output pixels a tile (64 a consumer warpgroup)
constexpr int BK = 128;             // bytes of K a stage (KB: 128, or 64 / 32 for Cin 64 / 32)
constexpr int SL = 64;              // output channels of a staged slice
constexpr int CPAD = 8;             // padding of a staged output row, in elements
constexpr int SMEM_MAX = 232448;    // a block's shared memory on an H100

// the ring's depth and the shared memory of a (output type, BN) pair: the
// ring, the staged slice of 64 output channels of the tile, each consumer
// warpgroup's per-channel constants (mul, corr, bias) of its tile's BN
// channels, the barriers
template <typename OutT, int BN, int KB>
struct Cfg {
  static constexpr int A_BYTES = BM * KB;  // one stage of A
  static constexpr int B_BOX = 64 * KB;    // one TMA box of W: 64 channels x KB bytes
  static constexpr int STAGE = A_BYTES + BN * KB;
  static constexpr int LDC = SL + CPAD;
  static constexpr int OUT = BM * LDC * (int)sizeof(OutT);
  static constexpr int CONSTS = 2 * 3 * BN * 4;
  static constexpr int FIT = (SMEM_MAX - 1024 - 256 - OUT - CONSTS) / STAGE;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = 1024 + STAGES * STAGE + OUT + CONSTS + 3 * STAGES * 8 + 16;
  static_assert(STAGES >= 3, "the ring needs three stages");
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

struct ConvArgs {
  const int8_t* x;
  const float* mul;
  const int* corr;
  const float* bias;
  const float* zp;
  void* y;
  int4* ws;            // split-K partials (splits > 1)
  unsigned* tickets;   // one a tile, 0 between launches (splits > 1)
  int H, W, Cin, Cout, kw, stride, pad, Ho, Wo;
  int M, K;
  int bw, bh;          // AMODE 2: a tile is bw x bh x (128 / (bw*bh)) pixels of (W, H, B)
  int nk;              // stages of K
  int kper;            // stages a split
  int splits;
  int ntn;             // tiles along N
  int units;           // tiles x splits
};

// Two neighbouring outputs of a row: y = cast((acc - corr) * mul), then
// + bias (bias already rounded to the output type, as a float), the sum
// rounded to the output type; stored at p. Type conversions run at a
// quarter of the FP32 rate and, with the int32 -> float32 one, bound the
// epilogue, so the bf16 rounding is packed (cvt.rn.bf16x2.f32) and the
// bias is added in bf16x2 (one rounding of the exact sum: the float32 sum
// of two bf16 values is exact, or too far from a bf16 tie for its own
// rounding to matter, so this equals the float32 add then the rounding).
__device__ __forceinline__ void epilogue2(float* p, int a0, int a1, int2 corr, float2 mul,
                                          float2 bias, bool has_bias) {
  float v0 = __fmul_rn(__int2float_rn(a0 - corr.x), mul.x);
  float v1 = __fmul_rn(__int2float_rn(a1 - corr.y), mul.y);
  if (has_bias) {
    v0 = __fadd_rn(v0, bias.x);
    v1 = __fadd_rn(v1, bias.y);
  }
  *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

__device__ __forceinline__ void epilogue2(__nv_bfloat16* p, int a0, int a1, int2 corr,
                                          float2 mul, __nv_bfloat162 bias, bool has_bias) {
  const float v0 = __fmul_rn(__int2float_rn(a0 - corr.x), mul.x);
  const float v1 = __fmul_rn(__int2float_rn(a1 - corr.y), mul.y);
  __nv_bfloat162 r = __floats2bfloat162_rn(v0, v1);
  if (has_bias) r = __hadd2(r, bias);
  *reinterpret_cast<__nv_bfloat162*>(p) = r;
}

// the bias of two neighbouring channels as epilogue2 adds it
__device__ __forceinline__ float2 bias2(const float* s_bias, int c, float*) {
  return *reinterpret_cast<const float2*>(s_bias + c);
}
__device__ __forceinline__ __nv_bfloat162 bias2(const float* s_bias, int c, __nv_bfloat16*) {
  return __floats2bfloat162_rn(s_bias[c], s_bias[c + 1]);  // exact: already bf16 values
}

// the bias as the epilogue adds it: rounded to the output type
__device__ __forceinline__ float bias_as(float b, float*) { return b; }
__device__ __forceinline__ float bias_as(float b, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(b));
}

// unit u of the launch: tile (m0, n0) and the split's stages [s0, s1)
struct Unit {
  int m0, n0, tile, split, s0, s1;
};

__device__ __forceinline__ Unit unit_at(const ConvArgs& a, int u, int bn) {
  Unit t;
  t.tile = u / a.splits;
  t.split = u - t.tile * a.splits;
  const int mt = t.tile / a.ntn;
  t.m0 = mt * BM;
  t.n0 = (t.tile - mt * a.ntn) * bn;
  t.s0 = t.split * a.kper;
  t.s1 = t.s0 + a.kper < a.nk ? t.s0 + a.kper : a.nk;
  return t;
}

// 1024-byte aligned start of the dynamic shared memory
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t s = smem_u32(raw);
  return raw + (((s + 1023u) & ~1023u) - s);
}

// grid: persistent blocks (at most one resident wave) walking the units
// u = blockIdx.x, + gridDim.x, ...; unit u is tile u / splits, split
// u % splits; tile t is M tile t / ntn, N tile t % ntn. AMODE 0: A gathered
// (cp.async, zp outside the input); 1: A by TMA from amap over [M, Cin]
// (1x1, stride 1, no padding).
template <typename OutT, int BN, int AMODE, int KB>
__global__ void __launch_bounds__(HT, 1)
int8_conv_sm90(const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap amap,
               const ConvArgs a) {
  static_assert(KB == 128 || AMODE == 2, "gathered and 2-D A tiles are 128 bytes of K");
  using C = Cfg<OutT, BN, KB>;
  constexpr int A_BYTES = C::A_BYTES, B_BOX = C::B_BOX;
  constexpr int STAGES = C::STAGES;
  constexpr int NACC = BN / 2;  // int32 accumulators a consumer thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  OutT* staging = reinterpret_cast<OutT*>(smem + STAGES * C::STAGE);
  float* consts = reinterpret_cast<float*>(smem + STAGES * C::STAGE + C::OUT);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * C::STAGE + C::OUT + C::CONSTS);
  uint64_t* empty = full + STAGES;
  uint64_t* landed = empty + STAGES;  // AMODE 2: A of a stage to patch has landed
  volatile int* s_last = reinterpret_cast<volatile int*>(landed + STAGES);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      // AMODE 0: two arrivals of each of the 128 gathering threads (its
      // stores, its copies) + the TMA one; 1, 2: one (TMA, or the patch)
      mbar_init(smem_u32(&full[s]), AMODE == 0 ? 257 : 1);
      mbar_init(smem_u32(&empty[s]), 2);  // one per consumer warpgroup
      mbar_init(smem_u32(&landed[s]), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---------------------------------------------------------- producer
    setmaxnreg_dec<PRODUCER_REGS>();
    const int pt = tid - 256;
    if (AMODE == 1 && pt != 0) return;
    if (AMODE == 2 && pt != 0 && pt < 32) return;  // thread 0 loads; warps 1-3 patch
    const int seg = pt & 7;  // 16-byte segment of the stage's 128 bytes of K
    const int r0 = pt >> 3;  // rows r0 + 16 i of the tile, i < 8
    const int zpi = __float2int_rn(*a.zp);
    const uint32_t zp_splat = (uint32_t)(zpi & 0xff) * 0x01010101u;
    const uint32_t sbase = smem_u32(smem);
    int stage = 0;
    uint32_t phase = 0;
    uint32_t lpar = 0;  // AMODE 2: the parity of each stage's landed barrier
    for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
      const Unit t = unit_at(a, u, BN);
      const int nbox = (a.Cout - t.n0 + 63) / 64 < BN / 64 ? (a.Cout - t.n0 + 63) / 64 : BN / 64;
      // AMODE 2: the tile's first pixel (the box's origin before the tap)
      const int hw = a.Ho * a.Wo;
      const int b0 = t.m0 / hw;
      const int oy0 = (t.m0 - b0 * hw) / a.Wo;
      const int ox0 = t.m0 - b0 * hw - oy0 * a.Wo;
      // this thread's 8 im2col rows: the image's base and the top-left tap
      const int8_t* xb[8];
      int iy0[8], ix0[8];
      unsigned mok = 0;
      if (AMODE == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int m = t.m0 + r0 + 16 * i;
          const int mm = m < a.M ? m : 0;
          mok |= (unsigned)(m < a.M) << i;
          const int b = mm / hw;
          const int r = mm - b * hw;
          const int oy = r / a.Wo;
          iy0[i] = oy * a.stride - a.pad;
          ix0[i] = (r - oy * a.Wo) * a.stride - a.pad;
          xb[i] = a.x + (long long)b * a.H * a.W * a.Cin;
        }
      }
      for (int s = t.s0; s < t.s1; ++s) {
        const uint32_t sa = sbase + stage * C::STAGE;
        const uint32_t fb = smem_u32(&full[stage]);
        const int k0 = s * KB;
        if (AMODE == 2) {
          // A: one 4-D box of x per stage (a stage lies in one tap, Cin % KB
          // == 0), shifted by the tap; TMA zero-fills pixels outside the
          // input, which the patching warps then set to the zero point
          const int tap = k0 / a.Cin;
          const int ky = tap / a.kw;
          const int x0 = ox0 + tap - ky * a.kw - a.pad, y0 = oy0 + ky - a.pad;
          const bool patch = x0 < 0 || x0 + a.bw > a.W || y0 < 0 || y0 + a.bh > a.H;
          const uint32_t lb = smem_u32(&landed[stage]);
          if (pt == 0) {
            mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
            if (patch) {  // the patching warps arrive once the zero points are in
              mbar_expect_tx(fb, nbox * B_BOX);
              mbar_arrive_tx(lb, A_BYTES);
            } else {
              mbar_arrive_tx(fb, nbox * B_BOX + A_BYTES);
            }
            tma_load_4d(sa, &amap, patch ? lb : fb, k0 - tap * a.Cin, x0, y0, b0);
            for (int j = 0; j < nbox; ++j)
              tma_load_2d(sa + A_BYTES + j * B_BOX, &wmap, fb, k0, t.n0 + 64 * j);
          } else if (patch) {
            mbar_wait(lb, (lpar >> stage) & 1u);
            for (int r = pt - 32; r < BM; r += 96) {  // box rows (pixels) r
              const int xi = x0 + r % a.bw, yi = y0 + (r / a.bw) % a.bh;
              if ((unsigned)xi >= (unsigned)a.W || (unsigned)yi >= (unsigned)a.H) {
#pragma unroll
                for (int q = 0; q < KB / 16; ++q)  // the whole row: the swizzle moves nothing
                  st_shared16(sa + r * KB + q * 16, zp_splat);
              }
            }
            fence_proxy_async();
            named_bar_sync(4, 96);
            if (pt == 32) mbar_arrive(fb);
          }
          if (patch) lpar ^= 1u << stage;
        } else {
          mbar_wait(smem_u32(&empty[stage]), phase ^ 1);
          if (pt == 0) {
            mbar_arrive_tx(fb, nbox * B_BOX + (AMODE == 1 ? A_BYTES : 0));
            if (AMODE == 1) tma_load_2d(sa, &amap, fb, k0, t.m0);
            for (int j = 0; j < nbox; ++j)
              tma_load_2d(sa + A_BYTES + j * B_BOX, &wmap, fb, k0, t.n0 + 64 * j);
          }
        }
        if (AMODE == 0) {
          const int k = k0 + seg * 16;
          if (k < a.K) {  // past K: B is zero there
            const int tap = k / a.Cin;
            const int ci = k - tap * a.Cin;
            const int ky = tap / a.kw;
            const int kx = tap - ky * a.kw;
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              if (!((mok >> i) & 1u)) continue;  // past M: never stored
              const int iy = iy0[i] + ky, ix = ix0[i] + kx;
              const uint32_t dst = sa + swz(r0 + 16 * i, seg);
              if ((unsigned)iy < (unsigned)a.H && (unsigned)ix < (unsigned)a.W)
                cp_async16(dst, xb[i] + ((long long)iy * a.W + ix) * a.Cin + ci);
              else
                st_shared16(dst, zp_splat);
            }
          }
          mbar_arrive(fb);      // its zero-point stores are done (release)
          cp_async_arrive(fb);  // its copies, once they land; the thread goes on
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  setmaxnreg_inc<CONSUMER_REGS>();
  const int lt = tid & 127;
  const uint32_t sbase = smem_u32(smem);
  OutT* stile = staging + wg * 64 * C::LDC;  // this warpgroup's 64 rows
  float* s_mul = consts + wg * 3 * BN;       // its tile's channel constants
  int* s_corr = reinterpret_cast<int*>(s_mul + BN);
  float* s_bias = s_mul + 2 * BN;
  const bool has_bias = a.bias != nullptr;
  int n_cached = -1;                         // the channels in s_mul ...
  const int w = lt >> 5, l = lt & 31;
  const int er = 16 * w + (l >> 2);  // accumulator rows er, er + 8
  const int ec = 2 * (l & 3);        // and columns 8j + ec, + 1
  int stage = 0;
  uint32_t phase = 0;
  int acc[NACC];
  for (int u = blockIdx.x; u < a.units; u += gridDim.x) {
    const Unit t = unit_at(a, u, BN);
    int prev = -1;
    for (int s = t.s0; s < t.s1; ++s) {
      mbar_wait(smem_u32(&full[stage]), phase);
      if (AMODE == 0) fence_proxy_async();  // the gathered A, written by the generic proxy
      const uint32_t sa = sbase + stage * C::STAGE;
      const uint64_t da = gmma_desc<KB>(sa + wg * (A_BYTES / 2));
      const uint64_t db = gmma_desc<KB>(sa + A_BYTES);
      // every k32 step of the stage, also past K: B is zero there (a step
      // skipped on a condition would cost the tensor cores more than it saves)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KB / 32; ++kk)
        wgmma_s8<BN>(acc, da + 2 * kk, db + 2 * kk, (s != t.s0) || kk != 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (prev >= 0 && lt == 0) mbar_arrive(smem_u32(&empty[prev]));
      prev = stage;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (lt == 0) mbar_arrive(smem_u32(&empty[prev]));

    if (a.splits > 1) {
      // split K: every block stores its partial; the last to draw the
      // tile's ticket adds the others' to its own and finishes the tile
      int4* part = a.ws + (long long)u * (NACC / 4) * 256 + tid;
#pragma unroll
      for (int q = 0; q < NACC / 4; ++q)
        part[q * 256] = make_int4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2], acc[4 * q + 3]);
      __threadfence();
      named_bar_sync(3, 256);
      if (tid == 0) {
        const unsigned drawn = atomicAdd(a.tickets + t.tile, 1u);
        *s_last = drawn == (unsigned)(a.splits - 1);
      }
      named_bar_sync(3, 256);
      if (!*s_last) continue;  // (rewritten only after the next tile's first barrier)
      __threadfence();
      for (int sp = 0; sp < a.splits; ++sp) {
        if (sp == t.split) continue;
        const int4* other = a.ws + (long long)(u - t.split + sp) * (NACC / 4) * 256 + tid;
#pragma unroll
        for (int q = 0; q < NACC / 4; ++q) {
          const int4 v = __ldcg(other + q * 256);
          acc[4 * q] += v.x;
          acc[4 * q + 1] += v.y;
          acc[4 * q + 2] += v.z;
          acc[4 * q + 3] += v.w;
        }
      }
      if (tid == 0) a.tickets[t.tile] = 0u;  // ready for the next launch
    }

    // epilogue: the output values of this warpgroup's 64 rows into the
    // staged slice, then whole slice rows out in 16-byte vectors
    named_bar_sync(1 + wg, 128);  // the previous tile's rows have left
    if (t.n0 != n_cached) {       // the tile's channel constants, once per n0
      n_cached = t.n0;
      for (int c = lt; c < BN; c += 128) {
        const int n = t.n0 + c;
        const bool nok = n < a.Cout;
        s_mul[c] = nok ? a.mul[n] : 0.f;
        s_corr[c] = nok ? a.corr[n] : 0;
        s_bias[c] = nok && has_bias ? bias_as(a.bias[n], stile) : 0.f;
      }
      named_bar_sync(1 + wg, 128);
    }
    constexpr int V = 16 / sizeof(OutT);  // elements a vector
    constexpr int CPR = SL / V;           // vectors a slice row
    OutT* y = static_cast<OutT*>(a.y);
    const bool vec = a.Cout % V == 0;     // rows start 16-byte aligned
    const int mw = t.m0 + 64 * wg;
#pragma unroll
    for (int sl = 0; sl < BN / SL; ++sl) {  // 64 channels at a time
      if (sl > 0) named_bar_sync(1 + wg, 128);  // the previous slice has left
#pragma unroll
      for (int jj = 0; jj < SL / 8; ++jj) {
        const int j = sl * (SL / 8) + jj;
        const int c = 8 * j + ec;
        const float2 mul = *reinterpret_cast<const float2*>(s_mul + c);
        const int2 corr = *reinterpret_cast<const int2*>(s_corr + c);
        const auto bias = bias2(s_bias, c, stile);
        OutT* row = stile + er * C::LDC + 8 * jj + ec;
        epilogue2(row, acc[4 * j], acc[4 * j + 1], corr, mul, bias, has_bias);
        epilogue2(row + 8 * C::LDC, acc[4 * j + 2], acc[4 * j + 3], corr, mul, bias, has_bias);
      }
      named_bar_sync(1 + wg, 128);
#pragma unroll
      for (int i = lt; i < 64 * CPR; i += 128) {
        const int r = i / CPR, c = (i - (i / CPR) * CPR) * V;
        const int m = mw + r;
        const int n = t.n0 + sl * SL + c;
        if (m >= a.M || n >= a.Cout) continue;
        const OutT* src = stile + r * C::LDC + c;
        OutT* dst = y + (long long)m * a.Cout + n;
        if (vec) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int e = 0; e < V && n + e < a.Cout; ++e) dst[e] = src[e];
        }
      }
    }
  }
}

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

CUtensorMapSwizzle swizzle_of(int kb) {
  return kb == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : kb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                    : CU_TENSOR_MAP_SWIZZLE_32B;
}

// int8 tensor map over a row-major [rows, cols] array (cols % 16 == 0),
// boxes of kb bytes x box_rows rows, kb-byte swizzle; reads past an edge
// give zeros
cudaError_t int8_map(CUtensorMap* map, const void* ptr, long long rows, long long cols,
                     int box_rows, int kb) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t gdim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t gstride[1] = {(cuuint64_t)cols};
  cuuint32_t box[2] = {(cuuint32_t)kb, (cuuint32_t)box_rows};
  cuuint32_t estride[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), gdim, gstride, box,
            estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(kb),
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// int8 tensor map over x [B, H, W, C] (C % 16 == 0) with boxes of kb
// bytes of C x bw x bh x (128 / (bw*bh)) pixels, kb-byte swizzle; pixels
// outside the input read zeros
cudaError_t int8_map_4d(CUtensorMap* map, const void* ptr, int B, int H, int W, int C, int bw,
                        int bh, int kb) {
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t gdim[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
  cuuint64_t gstride[3] = {(cuuint64_t)C, (cuuint64_t)W * C, (cuuint64_t)H * W * C};
  cuuint32_t box[4] = {(cuuint32_t)kb, (cuuint32_t)bw, (cuuint32_t)bh,
                       (cuuint32_t)(BM / (bw * bh))};
  cuuint32_t estride[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr), gdim, gstride, box,
            estride, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(kb),
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <typename OutT, int BN, int AMODE, int KB>
int launch_conv(const CUtensorMap& wmap, const CUtensorMap& amap, const ConvArgs& a, int grid,
                cudaStream_t stream) {
  constexpr int smem = Cfg<OutT, BN, KB>::SMEM;
  static bool attr = false;  // opt in to more than 48 KB once
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(int8_conv_sm90<OutT, BN, AMODE, KB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  int8_conv_sm90<OutT, BN, AMODE, KB><<<grid, HT, smem, stream>>>(wmap, amap, a);
  return (int)cudaGetLastError();
}

template <typename OutT, int BN>
int launch_conv_mode(const CUtensorMap& wmap, const CUtensorMap& amap, const ConvArgs& a,
                     int amode, int kb, int grid, cudaStream_t s) {
  if constexpr (std::is_same<OutT, __nv_bfloat16>::value) {
    if (amode == 2)
      return kb == 128  ? launch_conv<OutT, BN, 2, 128>(wmap, amap, a, grid, s)
             : kb == 64 ? launch_conv<OutT, BN, 2, 64>(wmap, amap, a, grid, s)
                        : launch_conv<OutT, BN, 2, 32>(wmap, amap, a, grid, s);
  }
  return amode == 1 ? launch_conv<OutT, BN, 1, 128>(wmap, amap, a, grid, s)
                    : launch_conv<OutT, BN, 0, 128>(wmap, amap, a, grid, s);
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

// The TMA tensor map (CUtensorMap, 128 bytes, written to `out`, host
// memory) of the int8 weights wq [Cout, K] (K % 16 == 0, 16-byte aligned)
// that s2a_int8_conv2d reads with stages of kb bytes of K (the plan's kb);
// a function of (wq, Cout, K, kb) alone, so the caller may keep it as long
// as wq lives.
int s2a_int8_weight_map(const void* wq, int Cout, int K, int kb, void* out) {
  if (Cout < 1 || K < 16 || K % 16 != 0 || (kb != 128 && kb != 64 && kb != 32))
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  const cudaError_t e = int8_map(&map, wq, Cout, K, 64, kb);
  if (e == cudaSuccess) memcpy(out, &map, sizeof(map));
  return (int)e;
}

// xq int8 [B,H,W,Cin], wq int8 [Cout,kh,kw,Cin] (Cin % 16 == 0, both
// 16-byte aligned); mul float32 [Cout] = s*sw; corr int32 [Cout] =
// zp*sum(wq); bias float32 [Cout] or null; zp the float32 zero point on the
// device (the value of taps outside the input); y [B,Ho,Wo,Cout] in
// out_dtype (0 = float32, 1 = bfloat16). Symmetric padding `pad`.
// wmap: s2a_int8_weight_map's 128 bytes for wq (host memory), or null to
// encode it here. dims: 20 ints in host memory, {B, H, W, Cin, Cout, kh,
// kw, stride, pad, Ho, Wo, out_dtype, bn, amode, bw, bh, kb, splits, kper,
// grid} (one array a shape, kept by the caller: fewer arguments to pass).
// The plan (ops/quant.py::conv_plan): bn (64, 128, 256;
// float32 output at most 128), amode (1: A by TMA as [M, Cin], 1x1 stride 1
// without padding only; 2: A by TMA as boxes of bw x bh x (128 / (bw*bh))
// pixels of (Wo, Ho, B), one a tap, zero points patched in: stride 1,
// Cin % kb == 0, bf16 output, boxes that tile the output exactly; 0:
// gathered), kb the bytes of K a stage (128; 64 or 32 with amode 2), K
// split into `splits` ranges of `kper` stages, `grid` persistent blocks. splits > 1 needs ws,
// int32 [tiles * splits * 128 * bn], and tickets, uint32 [tiles], zero
// (and left zero by the launch); launches that share them must not run
// concurrently.
int s2a_int8_conv2d(const void* xq, const void* wq, const void* mul, const void* corr,
                    const void* bias, const void* zp, void* y, const void* wmap, void* ws,
                    void* tickets, const int* dims, void* stream) {
  const int B = dims[0], H = dims[1], W = dims[2], Cin = dims[3], Cout = dims[4], kh = dims[5],
            kw = dims[6], stride = dims[7], pad = dims[8], Ho = dims[9], Wo = dims[10],
            out_dtype = dims[11], bn = dims[12], amode = dims[13], bw = dims[14], bh = dims[15],
            kb = dims[16], splits = dims[17], kper = dims[18];
  int grid = dims[19];
  if (B == 0 || Ho == 0 || Wo == 0 || Cout == 0) return 0;
  const long long M = (long long)B * Ho * Wo, K = (long long)kh * kw * Cin;
  if (Cin % 16 != 0 || Cin == 0 || stride < 1 || M > 0x7fffffffLL || K > 0x7fffffffLL ||
      (bn != 64 && bn != 128 && bn != 256) || (out_dtype == 0 && bn > 128) ||
      (out_dtype != 0 && out_dtype != 1) || grid < 1 || splits < 1 || kper < 1)
    return (int)cudaErrorInvalidValue;
  if (amode == 1 && (kh != 1 || kw != 1 || stride != 1 || pad != 0)) return (int)cudaErrorInvalidValue;
  if (amode == 2) {  // the boxes tile the output, one tile each
    const int bb = bw > 0 && bh > 0 ? BM / (bw * bh) : 0;
    if (stride != 1 || Cin % kb != 0 || out_dtype != 1 || bb < 1 || bw * bh * bb != BM ||
        Wo % bw != 0 || Ho % bh != 0 || B % bb != 0 || (bw < Wo && bh * bb != 1) ||
        (bh < Ho && bb != 1) || bw > 256 || bh > 256)
      return (int)cudaErrorInvalidValue;
  }
  if (amode < 0 || amode > 2 || (kb != 128 && (amode != 2 || (kb != 64 && kb != 32))))
    return (int)cudaErrorInvalidValue;
  const int nk = (int)((K + kb - 1) / kb);
  if ((long long)kper * splits < nk || (long long)kper * (splits - 1) >= nk)
    return (int)cudaErrorInvalidValue;  // every split has a stage, every stage a split
  if (splits > 1 && (ws == nullptr || tickets == nullptr)) return (int)cudaErrorInvalidValue;
  const int ntn = (Cout + bn - 1) / bn;
  const long long units = (M + BM - 1) / BM * ntn * splits;
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap w_map, a_map;
  cudaError_t e;
  if (wmap != nullptr) {
    memcpy(&w_map, wmap, sizeof(w_map));
  } else if ((e = int8_map(&w_map, wq, Cout, K, 64, kb)) != cudaSuccess) {
    return (int)e;
  }
  if (amode == 1) {
    if ((e = int8_map(&a_map, xq, M, Cin, BM, BK)) != cudaSuccess) return (int)e;
  } else if (amode == 2) {
    if ((e = int8_map_4d(&a_map, xq, B, H, W, Cin, bw, bh, kb)) != cudaSuccess) return (int)e;
  } else {
    a_map = w_map;  // unused
  }
  ConvArgs a{static_cast<const int8_t*>(xq), static_cast<const float*>(mul),
             static_cast<const int*>(corr), static_cast<const float*>(bias),
             static_cast<const float*>(zp), y, static_cast<int4*>(ws),
             static_cast<unsigned*>(tickets), H, W, Cin, Cout, kw, stride, pad, Ho, Wo,
             (int)M, (int)K, bw, bh, nk, kper, splits, ntn, (int)units};
  if (grid > a.units) grid = a.units;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) {
    return bn == 64 ? launch_conv_mode<float, 64>(w_map, a_map, a, amode, kb, grid, s)
                    : launch_conv_mode<float, 128>(w_map, a_map, a, amode, kb, grid, s);
  }
  return bn == 64    ? launch_conv_mode<__nv_bfloat16, 64>(w_map, a_map, a, amode, kb, grid, s)
         : bn == 128 ? launch_conv_mode<__nv_bfloat16, 128>(w_map, a_map, a, amode, kb, grid, s)
                     : launch_conv_mode<__nv_bfloat16, 256>(w_map, a_map, a, amode, kb, grid, s);
}

const char* s2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
