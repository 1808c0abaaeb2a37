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
//   s2a_box_iou_rotated     [N,5] or [B,N,5] x [B,M,5] -> [B,N,M] float32,
//                           one launch for the batch (below)
//   s2a_nms_rotated_mask    per image, bit (i, j) of K score-sorted
//                           candidates: j > i, both valid, equal labels,
//                           IoU > thr (strict)
//   s2a_nms_rotated_sweep   per image, the greedy keep from the mask: one
//                           warp decides the blocks of 64 rows in rounds,
//                           four apply each decided block a step later
//                           (below)
//
// The IoU kernel, built for the H100 (replaces one launch a thread a pair
// and one call per image). One 128-thread block takes one image and a tile
// of 64 rows of boxes1 (anchors), and the image's boxes2 (gts) 64 at a
// time:
//   1. the tile's 64 rows and the 64 columns are staged once in shared
//      memory (box_extent, box_corners), so cosf, sinf and sqrtf run once a
//      box and block, not once a pair; boxes1 shared by the batch are read
//      with a batch stride of 0 (no copy);
//   2. the cheap tests (bounding circles, areas > 1e-14) run on all
//      64 x 64 pairs, a lane per column with its extent in registers, a
//      warp over every other row: each pair's 0 goes out at once, 32
//      consecutive words a warp (a row of [B,N,M] is contiguous), and a
//      ballot and a popc prefix append survivors to a list;
//   3. every thread clips listed pairs (iou_clip) and writes their IoU over
//      the 0 (the block barrier orders the two stores).
// Padded gt slots are zero boxes, which the area test rejects. What bounds
// it on an H100: the bytes of the output, 4 * B * N * M, over device
// memory, then the ~15 instructions of the cheap test a pair; the clip
// passes of the few overlapping pairs are far below both. The bits did not
// move: the same expressions in the same order as iou_pair before, so it
// equals the plain version exactly.
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
// a tile whose rows are all invalid. The sweep loads words of valid rows
// only, from the row's own word on.
//
// The sweep, redesigned for the H100 (replaces one 64-thread block per
// image that, per 64-row block, waited on a global load of the diagonal
// words, two block barriers and a 64-step walk, then on global loads of the
// survivors' rows). One block of 160 threads per image, over the 64-row
// blocks up to the image's last valid candidate (an image with none writes
// keep = 0 and stops), one step and one block barrier a block. In step c:
//   - warp 0, the chain, decides block c in rounds, lane l taking rows l
//     and l + 32: a row is alive once every unblocked row that suppresses it
//     is dead, dead once one of them is alive (blocked: invalid, or removed
//     by earlier blocks). Each round is a few integer operations and four
//     ballots and decides at least the first open row, so a block costs a
//     few rounds, not 64 dependent steps. Its diagonal words, loaded a step
//     ahead, are transposed with shuffles (bit i of column j: row i
//     suppresses row j); it ORs the alive rows' next word in registers (the
//     carry) and lists the alive rows in shared memory;
//   - 4 helper warps OR block c - 1's alive rows into the removed words from
//     c + 1 on, a lane a word, the loads of 8 rows in flight.
// No global load sits on the chain: a step lasts the longer of the chain's
// rounds and the helpers' one round trip to L2, then the barrier.

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

// the geometry of box b (x, y, w, h, angle) into slot q; zeros for no box
__device__ __forceinline__ void stage_box(const float* b, float (*g)[kMaskBits], int q) {
  BoxGeom v{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (b) {
    box_extent(b[0], b[1], b[2], b[3], v);
    box_corners(b[2], b[3], cosf(b[4]), sinf(b[4]), v);
  }
  g[GX][q] = v.x;
  g[GY][q] = v.y;
  g[GP0X][q] = v.p0x;
  g[GP0Y][q] = v.p0y;
  g[GP1X][q] = v.p1x;
  g[GP1Y][q] = v.p1y;
  g[GDIAM][q] = v.diam;
  g[GAREA][q] = v.area;
}

// grid (ceil(N/64), B), 128 threads (see the note at the head of the file).
// b1 is [B,N,5] with b1_stride = N*5, or [N,5] shared with b1_stride = 0.
__global__ void __launch_bounds__(kMaskThreads, 8)
box_iou_rotated_kernel(const float* __restrict__ b1, long long b1_stride,
                       const float* __restrict__ b2, float* __restrict__ out, int N,
                       int M) {
  const int img = blockIdx.y;
  const int row0 = blockIdx.x * kMaskBits;
  const int rows = min(kMaskBits, N - row0);
  b1 += img * b1_stride + (long long)row0 * 5;
  b2 += (long long)img * M * 5;
  out += ((long long)img * N + row0) * M;

  __shared__ float s_rows[GFIELDS][kMaskBits];
  __shared__ float4 s_ext[kMaskBits];  // the rows' x, y, diameter, area
  __shared__ float s_cols[GFIELDS][kMaskBits];
  __shared__ unsigned short s_list[kMaskBits * kMaskBits];
  __shared__ int s_count;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  if (tid < kMaskBits) {
    stage_box(tid < rows ? b1 + tid * 5 : nullptr, s_rows, tid);
    s_ext[tid] = make_float4(s_rows[GX][tid], s_rows[GY][tid], s_rows[GDIAM][tid],
                             s_rows[GAREA][tid]);
  }
  // a warp takes 32 columns (lanes) and every other row: warps 0 and 1 the
  // even rows, 2 and 3 the odd ones
  const int c = (tid / 32) % 2 * 32 + lane;
  const int r_first = tid / kMaskBits;
  for (int col0 = 0; col0 < M; col0 += kMaskBits) {
    const int cols = min(kMaskBits, M - col0);
    if (tid < kMaskBits)
      stage_box(tid < cols ? b2 + (long long)(col0 + tid) * 5 : nullptr, s_cols, tid);
    if (tid == 0) s_count = 0;
    __syncthreads();
    // 2. the cheap tests, the column's extent in registers; every pair gets
    // its 0 (a rejected pair's IoU), 32 consecutive words a warp
    const BoxGeom gc{s_cols[GX][c], s_cols[GY][c], 0.f, 0.f, 0.f, 0.f,
                     s_cols[GDIAM][c], s_cols[GAREA][c]};
    const bool col_ok = c < cols;
    float* orow = out + col0 + c;
    for (int r = r_first; r < rows; r += kMaskThreads / kMaskBits) {
      const float4 e = s_ext[r];
      const BoxGeom gr{e.x, e.y, 0.f, 0.f, 0.f, 0.f, e.z, e.w};
      const bool full = col_ok && may_overlap(gr, gc);
      if (col_ok) orow[(long long)r * M] = 0.f;
      const unsigned take = __ballot_sync(0xffffffffu, full);
      if (take) {
        int base = 0;
        if (lane == 0) base = atomicAdd(&s_count, __popc(take));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (full)
          s_list[base + __popc(take & ((1u << lane) - 1u))] = (unsigned short)(r * kMaskBits + c);
      }
    }
    __syncthreads();
    // 3. the clip passes of the listed pairs, every thread busy; they
    // overwrite their zeros (ordered after them by the barrier)
    const int n = s_count;
    for (int q = tid; q < n; q += kMaskThreads) {
      const int p = s_list[q];
      const int pr = p / kMaskBits, pc = p % kMaskBits;
      out[(long long)pr * M + col0 + pc] = iou_clip(staged(s_rows, pr), staged(s_cols, pc));
    }
    __syncthreads();  // the next columns overwrite s_cols and s_list
  }
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
    int lab = 0;
    uint8_t flag = ok;  // 2: a box whose sides are at least 0.5, for the area test
    // an invalid box's fields may be anything: no cosf of those
    const float* b = ok ? boxes + (long long)i * 5 : nullptr;
    stage_box(b, s_geom[side], q);
    if (ok) {
      const float w = b[2], h = b[3];
      lab = labels[i];
      if (w >= 0.5f && h >= 0.5f && w < 1e30f && h < 1e30f) flag = 2;
    }
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

// ---------------------------------------------------------------- sweep
constexpr int kSweepHelpers = 4;  // warps that OR a decided block's later words
constexpr int kSweepThreads = 32 * (1 + kSweepHelpers);
constexpr int kRowsAtOnce = 8;    // rows a helper lane loads before reducing

__device__ __forceinline__ unsigned long long warp_or(unsigned long long x) {
  const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)x);
  const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(x >> 32));
  return ((unsigned long long)hi << 32) | lo;
}

__device__ __forceinline__ unsigned long long ballot64(bool lo, bool hi) {
  return ((unsigned long long)__ballot_sync(0xffffffffu, hi) << 32) |
         __ballot_sync(0xffffffffu, lo);
}

// a 32 x 32 bit matrix, row `lane` in x (bit j: column j), transposed
// across the warp: lane j gets column j. Five stages swap the off-diagonal
// k x k blocks of each 2k x 2k block with the partner lane ^ k.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  constexpr unsigned kLow[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u,
                                0x55555555u};
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int k = 16 >> s;
    const unsigned m = kLow[s];
    const unsigned y = __shfl_xor_sync(0xffffffffu, x, k);
    x = (lane & k) ? (x & ~m) | ((y & ~m) >> k) : (x & m) | ((y & m) << k);
  }
  return x;
}

// words c (diagonal) and c + 1 of rows lane and lane + 32 of block c; 0 for
// an invalid row or a word past the last
struct BlockRows {
  unsigned long long diag_lo, diag_hi, next_lo, next_hi;
};

__device__ __forceinline__ BlockRows load_block(const unsigned long long* mask, int stride,
                                                unsigned long long valid, int c, int chunks,
                                                int lane) {
  const unsigned long long* row = mask + ((long long)c * kMaskBits + lane) * stride + c;
  const bool v_lo = (valid >> lane) & 1ULL, v_hi = (valid >> (lane + 32)) & 1ULL;
  const bool more = c + 1 < chunks;
  return BlockRows{v_lo ? row[0] : 0ULL, v_hi ? row[32LL * stride] : 0ULL,
                   v_lo && more ? row[1] : 0ULL, v_hi && more ? row[32LL * stride + 1] : 0ULL};
}

// The alive rows' words first .. chunks - 1 ORed into removed, by `warps`
// warps (this one is `w` of them): lane l takes the words first + l and
// first + 32 + l, ... of the listed rows, kRowsAtOnce rows' loads in flight.
__device__ __forceinline__ void or_later_words(const unsigned long long* block_rows, int stride,
                                               const unsigned char* list, int n, int first,
                                               int chunks, int w, int warps,
                                               unsigned long long* removed, int lane) {
  for (int w0 = first; w0 < chunks; w0 += 64) {
    const int wa = w0 + lane, wb = w0 + 32 + lane;
    unsigned long long acc_a = 0ULL, acc_b = 0ULL;
    for (int i0 = w; i0 < n; i0 += warps * kRowsAtOnce) {
      unsigned long long va[kRowsAtOnce], vb[kRowsAtOnce];
#pragma unroll
      for (int k = 0; k < kRowsAtOnce; ++k) {
        const int i = i0 + k * warps;
        const unsigned long long* row = block_rows + (long long)(i < n ? list[i] : 0) * stride;
        va[k] = i < n && wa < chunks ? row[wa] : 0ULL;
        vb[k] = i < n && wb < chunks ? row[wb] : 0ULL;
      }
#pragma unroll
      for (int k = 0; k < kRowsAtOnce; ++k) {
        acc_a |= va[k];
        acc_b |= vb[k];
      }
    }
    if (acc_a) atomicOr(&removed[wa], acc_a);
    if (acc_b) atomicOr(&removed[wb], acc_b);
  }
}

// one block of kSweepThreads per image (see the note at the head of the file)
__global__ void __launch_bounds__(kSweepThreads, 1)
nms_sweep_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
                 uint8_t* __restrict__ keep, int K) {
  extern __shared__ unsigned long long smem[];  // valid, removed, alive: stride words each
  __shared__ unsigned char s_list[2][kMaskBits];  // a block's alive rows, by parity
  __shared__ int s_count[2];
  __shared__ int s_chunks;
  const int stride = (K + kMaskBits - 1) / kMaskBits;  // words a mask row
  const int img = blockIdx.x;
  mask += (long long)img * K * stride;
  valid += (long long)img * K;
  keep += (long long)img * K;
  unsigned long long* s_valid = smem;
  unsigned long long* s_removed = s_valid + stride;
  unsigned long long* s_alive = s_removed + stride;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int i = tid; i < 3 * stride; i += kSweepThreads) smem[i] = 0ULL;
  if (tid == 0) s_chunks = 0;
  __syncthreads();
  // valid rows per block of 64 and the last: 16 flags a thread, their
  // loads all in flight
  int last = -1;
  for (int i0 = tid * 16; i0 < K; i0 += kSweepThreads * 16) {
    unsigned bits = 0u;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (i0 + j < K && valid[i0 + j]) bits |= 1u << j;
    if (bits) {
      atomicOr(&s_valid[i0 / kMaskBits], (unsigned long long)bits << (i0 % kMaskBits));
      last = i0 + 31 - __clz(bits);
    }
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0 && last >= 0) atomicMax(&s_chunks, last / kMaskBits + 1);
  __syncthreads();
  const int chunks = s_chunks;  // 64-row blocks up to the last valid row

  // Step c: warp 0 decides block c, the helpers OR block c - 1's alive rows
  // into the words from c + 1 on; one barrier a step. Block c - 1's word c
  // is the chain's own carry, so the chain never waits on device memory.
  BlockRows pre{};
  if (warp == 0 && chunks > 0) pre = load_block(mask, stride, s_valid[0], 0, chunks, lane);
  unsigned long long carry = 0ULL;
  for (int c = 0; c <= chunks; ++c) {
    if (warp == 0 && c < chunks) {
      const BlockRows cur = pre;
      if (c + 1 < chunks) pre = load_block(mask, stride, s_valid[c + 1], c + 1, chunks, lane);
      // the 64 x 64 transpose of the diagonal words as four 32 x 32 ones:
      // [[P, Q], [R, S]] (rows lane: P | Q << 32, rows lane + 32: R | S << 32)
      // becomes [[P', R'], [Q', S']]; bit i of column j: row i suppresses j
      const unsigned pt = transpose32((unsigned)cur.diag_lo, lane);
      const unsigned qt = transpose32((unsigned)(cur.diag_lo >> 32), lane);
      const unsigned rt = transpose32((unsigned)cur.diag_hi, lane);
      const unsigned st = transpose32((unsigned)(cur.diag_hi >> 32), lane);
      // blocked rows: invalid, or removed by earlier blocks; they are never
      // alive and suppress nothing
      const unsigned long long blocked = ~s_valid[c] | s_removed[c] | carry;
      // Rounds over the block, lane l deciding rows l and l + 32: a row is
      // alive once every unblocked row that suppresses it is dead, dead once
      // one of them is alive. Each round decides at least the first open
      // row, and the result is the greedy sweep's.
      const unsigned long long sup_lo = (((unsigned long long)rt << 32) | pt) & ~blocked;
      const unsigned long long sup_hi = (((unsigned long long)st << 32) | qt) & ~blocked;
      unsigned long long alive = 0ULL, dead = blocked;
      bool open_lo = !((blocked >> lane) & 1ULL), open_hi = !((blocked >> (lane + 32)) & 1ULL);
      while (__any_sync(0xffffffffu, open_lo || open_hi)) {
        const bool a_lo = open_lo && !(sup_lo & ~dead), a_hi = open_hi && !(sup_hi & ~dead);
        const bool d_lo = open_lo && (sup_lo & alive), d_hi = open_hi && (sup_hi & alive);
        alive |= ballot64(a_lo, a_hi);
        dead |= ballot64(d_lo, d_hi);
        open_lo = open_lo && !a_lo && !d_lo;
        open_hi = open_hi && !a_hi && !d_hi;
      }
      // the carry: the alive rows' word c + 1; the list of alive rows
      const bool a_lo = (alive >> lane) & 1ULL, a_hi = (alive >> (lane + 32)) & 1ULL;
      carry = warp_or((a_lo ? cur.next_lo : 0ULL) | (a_hi ? cur.next_hi : 0ULL));
      const unsigned long long below = (1ULL << lane) - 1ULL;
      if (a_lo) s_list[c & 1][__popcll(alive & below)] = (unsigned char)lane;
      if (a_hi) s_list[c & 1][__popcll(alive & (below << 32 | 0xffffffffULL))] =
          (unsigned char)(lane + 32);
      if (lane == 0) {
        s_alive[c] = alive;
        s_count[c & 1] = __popcll(alive);
      }
    } else if (warp > 0 && c > 0) {
      const int b = c - 1;
      or_later_words(mask + (long long)b * kMaskBits * stride, stride, s_list[b & 1],
                     s_count[b & 1], c + 1, chunks, warp - 1, kSweepHelpers, s_removed, lane);
    }
    __syncthreads();
  }
  for (int i = tid; i < K; i += kSweepThreads)
    keep[i] = i < chunks * kMaskBits && ((s_alive[i / kMaskBits] >> (i % kMaskBits)) & 1ULL);
}

}  // namespace

extern "C" {

// boxes1 [B,N,5] (or [N,5] shared by the batch: shared1 = 1), boxes2
// [B,M,5], out [B,N,M], all float32
int s2a_box_iou_rotated(const void* boxes1, const void* boxes2, void* out, int B, int N,
                        int M, int shared1, void* stream) {
  if (B == 0 || N == 0 || M == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((N + kMaskBits - 1) / kMaskBits, B);
  box_iou_rotated_kernel<<<grid, kMaskThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes1), shared1 ? 0LL : (long long)N * 5,
      static_cast<const float*>(boxes2), static_cast<float*>(out), N, M);
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
int s2a_nms_rotated_sweep(const void* mask, const void* valid, void* keep, int B, int K,
                          void* stream) {
  if (B == 0 || K == 0) return 0;
  // dynamic shared memory: the valid, removed and alive words; with the
  // static arrays within the 48 KB a block gets without opting in
  const size_t smem = sizeof(unsigned long long) * 3 * ((K + kMaskBits - 1) / kMaskBits);
  const size_t fixed = 2 * kMaskBits + 16;
  if (smem + fixed > 48 * 1024) return (int)cudaErrorInvalidValue;
  nms_sweep_kernel<<<B, kSweepThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(mask), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), K);
  return (int)cudaGetLastError();
}

const char* s2a_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
