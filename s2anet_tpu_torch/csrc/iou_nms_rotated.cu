// Rotated-box IoU and the rotated NMS built on it.
//
// Replaces the TPU kernel s2anet_tpu/ops/pallas/iou_kernel.py::_kernel (the
// pairwise IoU of box_iou_rotated_pallas) and, for serving, the XLA greedy
// sweep s2anet_tpu/ops/nms_rotated.py::_greedy_sweep_fused. One pair
// routine (box_extent, box_corners, may_overlap, iou_clip) mirrors
// ops/iou_rotated.py::iou_pairs term for term: the sort-free boundary tally
// (2*area = sum over the 8 edges of (t1 - t0) * cross(p, d), each edge
// clipped to the other box), pair-midpoint centering, the _SIDE_EPS
// tie-breaks (+eps in pass A, -eps in pass B, -eps for opposite-direction
// twins), the _PARALLEL_TOL2 test and the area < 1e-14 rule. A
// bounding-circle test gives 0 first; that is exact, since boxes whose
// circumscribed circles are apart cannot overlap.
//
// Build with --fmad=false: the degenerate-geometry tie-breaks rely on
// crosses that are exactly zero when computed as separately rounded
// products, and a fused multiply-add leaves a residual far above _SIDE_EPS.
//
// Three kernels:
//   s2a_box_iou_rotated     [N,5] x [M,5] -> [N,M] float32, a thread a pair
//   s2a_nms_rotated_mask    per image, bit (i, j) of K score-sorted
//                           candidates: j > i, both valid, equal labels,
//                           IoU > thr (strict)
//   s2a_nms_rotated_sweep   per image, one block walks the rows in order and
//                           ORs the mask rows of survivors into the removed
//                           set (the reference's nms_rotated_cuda design)
//
// The mask kernel, redesigned for Hopper. One block of 128 threads takes
// one 64 x 64 tile of (row, column) candidates on or above the diagonal,
// found from a triangular tile index, so no block launches below it:
//   1. The tile stages the geometry of its 128 boxes in shared memory, one
//      array per field: centre, the centred corners p0 and p1 (p2 = -p0,
//      p3 = -p1), sqrt(w^2 + h^2) and the area. cosf, sinf and sqrtf run
//      once per box and tile, not once per pair. A tile whose rows hold no
//      valid candidate exits at once (a ballot over the valid bytes, which
//      need not form a prefix); one whose columns hold none writes its rows'
//      zero words.
//   2. Each thread runs the cheap tests on 32 of the 4096 pairs: later
//      column, both valid, equal labels, bounding circles meet, both areas
//      above 1e-14, and (for thr > 0, sides of at least 0.5) an area
//      bound: IoU <= min/max of the two areas, so a pair whose areas differ
//      by more than 1/thr, with margins far above any rounding of the clip
//      passes, cannot suppress. A warp ballot and a popc prefix append the
//      survivors to a list in shared memory.
//   3. Every thread takes pairs off that list and runs the two clip passes,
//      so no lane idles on a pair the cheap tests rejected, as it would if
//      a warp's lanes walked their own rows. Bits go into the tile's row
//      words in shared memory (atomicOr), and each word is written to
//      device memory once.
// What bounds it on an H100: the clip passes of the surviving pairs, ~300
// float32 operations with 32 IEEE divisions each, on the CUDA cores, then
// the cheap tests (~20 operations) over all of a tile's pairs. The bits did
// not move: the per-pair part keeps iou_pair's expressions in their order
// (the shift by the pair midpoint, the edges after the shift, the clip
// passes, 0.5f * (r1 + r2), the strict >), and each staged value is
// computed by the same expression as before, so with no FMA contraction
// every rounding is the same.
//
// Words the mask kernel leaves unwritten, all never used by the sweep: the
// words left of each row's own word (below the diagonal), and every word of
// a tile whose rows are all invalid. The sweep reads word nb of each row of
// block nb but ORs in only those of rows still alive, which are valid, and
// it reads words right of the diagonal only for alive rows.
//
// The sweep is sequential per image and pays two block barriers per 64
// rows; images run in parallel blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kParallelTol2 = 1e-12f;
constexpr float kSideEps = 1e-6f;
constexpr int kMaskBits = 64;      // candidates per mask word and per tile side
constexpr int kMaskThreads = 128;  // threads of a mask tile

// The per-box values of the pair routine: centre, the centred corners p0
// and p1 (p2 = -p0, p3 = -p1), the bounding diameter sqrt(w^2 + h^2) and
// the area.
struct BoxGeom {
  float x, y, p0x, p0y, p1x, p1y, diam, area;
};

// the values the bounding-circle test reads
__device__ __forceinline__ void box_extent(float x, float y, float w, float h, BoxGeom& g) {
  g.x = x;
  g.y = y;
  g.diam = sqrtf(w * w + h * h);
  g.area = w * h;
}

// from w, h and cos a, sin a (the same products as iou_pairs' corners)
__device__ __forceinline__ void box_corners(float w, float h, float ca, float sa, BoxGeom& g) {
  const float c2 = ca * 0.5f;
  const float s2 = sa * 0.5f;
  g.p0x = -s2 * h - c2 * w;
  g.p0y = c2 * h - s2 * w;
  g.p1x = s2 * h - c2 * w;
  g.p1y = -c2 * h - s2 * w;
}

// false where iou_pairs gives 0 without clipping: the bounding circles are
// apart, or an area is not above 1e-14 (a NaN compares false too)
__device__ __forceinline__ bool may_overlap(const BoxGeom& a, const BoxGeom& b) {
  const float dxc = a.x - b.x;
  const float dyc = a.y - b.y;
  const float rr = 0.5f * (a.diam + b.diam);
  return dxc * dxc + dyc * dyc <= rr * rr && a.area > 1e-14f && b.area > 1e-14f;
}

struct Quad {
  float px[4], py[4];  // corners
  float ex[4], ey[4];  // directed edges p[k+1] - p[k]
};

__device__ __forceinline__ void make_quad(const BoxGeom& g, float sx, float sy, Quad& q) {
  q.px[0] = g.p0x + sx;  q.py[0] = g.p0y + sy;
  q.px[1] = g.p1x + sx;  q.py[1] = g.p1y + sy;
  q.px[2] = -g.p0x + sx; q.py[2] = -g.p0y + sy;
  q.px[3] = -g.p1x + sx; q.py[3] = -g.p1y + sy;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q.ex[k] = q.px[(k + 1) & 3] - q.px[k];
    q.ey[k] = q.py[(k + 1) & 3] - q.py[k];
  }
}

// sum of cross(p, d) * (t1 - t0) over P's edges clipped to Q's half-planes,
// summed left to right as in iou_pairs
__device__ __forceinline__ float clip_pass(const Quad& P, const Quad& Q,
                                           float eps) {
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float px = P.px[k], py = P.py[k];
    const float dx = P.ex[k], dy = P.ey[k];
    const float d2 = dx * dx + dy * dy;
    float lo = 0.f, hi = 1.f;
    bool ok = true;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float ex = Q.ex[m], ey = Q.ey[m];
      const float qx = Q.px[m], qy = Q.py[m];
      const float c1 = ex * dy - ey * dx;
      const float tie = (ex * dx + ey * dy > 0.f) ? eps : -kSideEps;
      const float c0 = ex * (py - qy) - ey * (px - qx) + tie;
      const bool para = c1 * c1 <= kParallelTol2 * (ex * ex + ey * ey) * d2;
      const float t = -c0 / (para ? 1.f : c1);
      if (!para && c1 > 0.f) lo = fmaxf(lo, t);
      if (!para && c1 < 0.f) hi = fminf(hi, t);
      ok = ok && (!para || c0 >= 0.f);
    }
    const float dt = ok ? fmaxf(hi - lo, 0.f) : 0.f;
    acc = acc + dt * (px * dy - py * dx);
  }
  return acc;
}

// IoU of a pair that may overlap, both boxes centred on the pair midpoint
__device__ __forceinline__ float iou_clip(const BoxGeom& a, const BoxGeom& b) {
  const float sx = (a.x - b.x) * 0.5f;
  const float sy = (a.y - b.y) * 0.5f;
  Quad qa, qb;
  make_quad(a, sx, sy, qa);
  make_quad(b, -sx, -sy, qb);
  // the two passes are summed apart, then added: the association of
  // iou_pairs, so the plain version and these kernels agree bit for bit
  const float acc = clip_pass(qa, qb, kSideEps) + clip_pass(qb, qa, -kSideEps);
  const float inter = 0.5f * fabsf(acc);
  const float uni = a.area + b.area - inter;
  return inter / (uni > 0.f ? uni : 1.f);
}

__device__ float iou_pair(const float* b1, const float* b2) {
  BoxGeom ga, gb;
  box_extent(b1[0], b1[1], b1[2], b1[3], ga);
  box_extent(b2[0], b2[1], b2[2], b2[3], gb);
  if (!may_overlap(ga, gb)) return 0.f;
  box_corners(b1[2], b1[3], cosf(b1[4]), sinf(b1[4]), ga);
  box_corners(b2[2], b2[3], cosf(b2[4]), sinf(b2[4]), gb);
  return iou_clip(ga, gb);
}

__global__ void box_iou_rotated_kernel(const float* __restrict__ b1,
                                       const float* __restrict__ b2,
                                       float* __restrict__ out, int N, int M) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= N || j >= M) return;
  out[(long long)i * M + j] = iou_pair(b1 + (long long)i * 5, b2 + (long long)j * 5);
}

// The staged geometry of a mask tile, one array per BoxGeom field.
enum { GX, GY, GP0X, GP0Y, GP1X, GP1Y, GDIAM, GAREA, GFIELDS };

// True when IoU <= thr follows from the areas alone (IoU <= min/max area),
// with margins far above the clip passes' rounding for sides of at least 0.5
__device__ __forceinline__ bool below_by_area(float a, float b, float thr) {
  const float lo = a < b ? a : b, hi = a < b ? b : a;
  return lo + 1e-3f * hi + 1e-3f < thr * hi;
}

__device__ __forceinline__ BoxGeom staged(const float (*g)[kMaskBits], int q) {
  return BoxGeom{g[GX][q],   g[GY][q],   g[GP0X][q],  g[GP0Y][q],
                 g[GP1X][q], g[GP1Y][q], g[GDIAM][q], g[GAREA][q]};
}

// grid (tiles, B) with tiles = col_blocks*(col_blocks + 1)/2, 128 threads
// (8 blocks an SM): tile t = cb*(cb + 1)/2 + rb (0 <= rb <= cb) writes word
// cb of the rows rb*64 ... rb*64 + 63 (see the note at the head of the file).
__global__ void __launch_bounds__(kMaskThreads, 8)
nms_mask_kernel(const float* __restrict__ boxes, const int* __restrict__ labels,
                const uint8_t* __restrict__ valid, float thr,
                unsigned long long* __restrict__ mask, int K) {
  const long long t = blockIdx.x;
  long long cb = (long long)((sqrt(8.0 * (double)t + 1.0) - 1.0) * 0.5);
  while (cb * (cb + 1) / 2 > t) --cb;
  while ((cb + 1) * (cb + 2) / 2 <= t) ++cb;
  const int rb = (int)(t - cb * (cb + 1) / 2);
  const int img = blockIdx.y;
  const int col_blocks = (K + kMaskBits - 1) / kMaskBits;
  boxes += (long long)img * K * 5;
  labels += (long long)img * K;
  valid += (long long)img * K;
  mask += (long long)img * K * col_blocks;

  __shared__ float s_geom[2][GFIELDS][kMaskBits];  // [0] the rows, [1] the columns
  __shared__ int s_lab[2][kMaskBits];
  __shared__ uint8_t s_ok[2][kMaskBits];
  __shared__ unsigned s_bits[kMaskBits][2];  // the rows' words, low and high halves
  __shared__ unsigned short s_list[kMaskBits * kMaskBits];
  __shared__ int s_count;

  // 1. stage the geometry of the tile's rows and columns
  const int tid = threadIdx.x;
  bool ok = false;
  if (tid < 2 * kMaskBits) {
    const int side = tid / kMaskBits, q = tid % kMaskBits;
    const int i = (side ? (int)cb : rb) * kMaskBits + q;
    ok = i < K && valid[i];
    BoxGeom g{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    int lab = 0;
    uint8_t flag = ok;  // 2: a box whose sides are at least 0.5, for the area test
    if (ok) {  // an invalid box's fields may be anything: no cosf of those
      const float* b = boxes + (long long)i * 5;
      const float w = b[2], h = b[3];
      box_extent(b[0], b[1], w, h, g);
      box_corners(w, h, cosf(b[4]), sinf(b[4]), g);
      lab = labels[i];
      if (w >= 0.5f && h >= 0.5f && w < 1e30f && h < 1e30f) flag = 2;
    }
    float* dst = &s_geom[side][0][q];
    dst[GX * kMaskBits] = g.x;
    dst[GY * kMaskBits] = g.y;
    dst[GP0X * kMaskBits] = g.p0x;
    dst[GP0Y * kMaskBits] = g.p0y;
    dst[GP1X * kMaskBits] = g.p1x;
    dst[GP1Y * kMaskBits] = g.p1y;
    dst[GDIAM * kMaskBits] = g.diam;
    dst[GAREA * kMaskBits] = g.area;
    s_lab[side][q] = lab;
    s_ok[side][q] = flag;
    s_bits[q][side] = 0u;
  }
  if (tid == 0) s_count = 0;
  if (!__syncthreads_or(tid < kMaskBits && ok)) return;  // no valid row
  if (__syncthreads_or(tid >= kMaskBits && ok)) {
    // 2. the cheap tests; a warp takes one row and 32 consecutive columns.
    // A pair they reject gets the bit 0 > thr (IoU 0), except one rejected
    // by its areas (IoU <= thr), which only arises for thr > 0: no bit.
    const bool zero_hit = 0.f > thr;
    const bool diag = cb == rb;
    const int lane = tid % 32;
    for (int p = tid; p < kMaskBits * kMaskBits; p += kMaskThreads) {
      const int r = p / kMaskBits, c = p % kMaskBits;
      const bool cand = s_ok[0][r] && s_ok[1][c] && s_lab[0][r] == s_lab[1][c] &&
                        (!diag || c > r);
      bool full = cand && may_overlap(staged(s_geom[0], r), staged(s_geom[1], c));
      if (full && thr > 0.f && s_ok[0][r] == 2 && s_ok[1][c] == 2 &&
          below_by_area(s_geom[0][GAREA][r], s_geom[1][GAREA][c], thr))
        full = false;
      const unsigned take = __ballot_sync(0xffffffffu, full);
      if (take) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&s_count, __popc(take));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (full) s_list[base + __popc(take & ((1u << lane) - 1u))] = (unsigned short)p;
      }
      if (zero_hit) {
        const unsigned hit = __ballot_sync(0xffffffffu, cand && !full);
        if (lane == 0 && hit) atomicOr(&s_bits[r][c / 32], hit);
      }
    }
    __syncthreads();
    // 3. the clip passes of the listed pairs, every thread busy
    const int n = s_count;
    for (int q = tid; q < n; q += kMaskThreads) {
      const int p = s_list[q];
      const int r = p / kMaskBits, c = p % kMaskBits;
      if (iou_clip(staged(s_geom[0], r), staged(s_geom[1], c)) > thr)
        atomicOr(&s_bits[r][c / 32], 1u << (c % 32));
    }
    __syncthreads();
  }
  if (tid < kMaskBits) {
    const int row = rb * kMaskBits + tid;
    if (row < K)
      mask[(long long)row * col_blocks + cb] =
          ((unsigned long long)s_bits[tid][1] << 32) | s_bits[tid][0];
  }
}

// one block per image; dynamic shared memory holds the removed set
__global__ void nms_sweep_kernel(const unsigned long long* __restrict__ mask,
                                 const uint8_t* __restrict__ valid,
                                 uint8_t* __restrict__ keep, int K) {
  extern __shared__ unsigned long long removed[];
  const int col_blocks = (K + kMaskBits - 1) / kMaskBits;
  const int img = blockIdx.x;
  const int tid = threadIdx.x;
  mask += (long long)img * K * col_blocks;
  valid += (long long)img * K;
  keep += (long long)img * K;

  // invalid candidates start removed: they never suppress and are never kept
  for (int wd = tid; wd < col_blocks; wd += blockDim.x) {
    unsigned long long bits = 0ULL;
    for (int q = 0; q < kMaskBits; ++q) {
      const int i = wd * kMaskBits + q;
      if (i >= K || !valid[i]) bits |= 1ULL << q;
    }
    removed[wd] = bits;
  }

  // Rows go in blocks of 64. Whether a row of block nb survives depends only
  // on word nb of the removed set, so each block is two steps:
  //   1. every thread walks the 64 rows on word nb alone (the rows' own
  //      words nb staged in shared memory), giving the block's survivors;
  //   2. each thread ORs the survivors' rows into the later words it owns,
  //      with up to 8 mask loads in flight at a time.
  // Step 1 waits on no global load and no barrier; a block costs two
  // barriers.
  __shared__ unsigned long long s_diag[kMaskBits];
  for (int nb = 0; nb < col_blocks; ++nb) {
    __syncthreads();  // the previous block's updates and readers are done
    const int r = nb * kMaskBits + tid;  // blockDim.x == kMaskBits
    s_diag[tid] = r < K ? mask[(long long)r * col_blocks + nb] : 0ULL;
    __syncthreads();
    unsigned long long rv = removed[nb];
    unsigned long long alive = 0ULL;
    for (int q = 0; q < kMaskBits; ++q) {
      if (!((rv >> q) & 1ULL)) {  // rows past K start removed
        alive |= 1ULL << q;
        rv |= s_diag[q];
      }
    }
    if (r < K) keep[r] = (alive >> tid) & 1ULL;
    const unsigned long long* rows = mask + (long long)nb * kMaskBits * col_blocks;
    for (int wd = nb + 1 + tid; wd < col_blocks; wd += blockDim.x) {
      unsigned long long acc = removed[wd];
      unsigned long long todo = alive;
      while (todo) {
        unsigned long long v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          v[u] = 0ULL;
          if (todo) {
            const int q = __ffsll((long long)todo) - 1;
            todo &= todo - 1;
            v[u] = rows[(long long)q * col_blocks + wd];
          }
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) acc |= v[u];
      }
      removed[wd] = acc;
    }
  }
}

}  // namespace

extern "C" {

// boxes1 [N,5], boxes2 [M,5], out [N,M], all float32
int s2a_box_iou_rotated(const void* boxes1, const void* boxes2, void* out,
                        int N, int M, void* stream) {
  if (N == 0 || M == 0) return 0;
  dim3 block(32, 8);
  dim3 grid((M + 31) / 32, (N + 7) / 8);
  box_iou_rotated_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes1), static_cast<const float*>(boxes2),
      static_cast<float*>(out), N, M);
  return (int)cudaGetLastError();
}

// boxes [B,K,5] float32, labels [B,K] int32, valid [B,K] bool (one byte),
// mask [B,K,ceil(K/64)] uint64
int s2a_nms_rotated_mask(const void* boxes, const void* labels,
                         const void* valid, float iou_thr, void* mask, int B,
                         int K, void* stream) {
  if (B == 0 || K == 0) return 0;
  const long long col_blocks = (K + kMaskBits - 1) / kMaskBits;
  const long long tiles = col_blocks * (col_blocks + 1) / 2;
  if (tiles > 0x7fffffffLL || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)tiles, (unsigned)B);
  nms_mask_kernel<<<grid, kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const int*>(labels),
      static_cast<const uint8_t*>(valid), iou_thr,
      static_cast<unsigned long long*>(mask), K);
  return (int)cudaGetLastError();
}

// mask from s2a_nms_rotated_mask, valid [B,K], keep [B,K] bool (one byte)
int s2a_nms_rotated_sweep(const void* mask, const void* valid, void* keep,
                          int B, int K, void* stream) {
  if (B == 0 || K == 0) return 0;
  const int col_blocks = (K + kMaskBits - 1) / kMaskBits;
  const size_t smem = sizeof(unsigned long long) * col_blocks;
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  nms_sweep_kernel<<<B, kMaskBits, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), K);
  return (int)cudaGetLastError();
}

const char* s2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
