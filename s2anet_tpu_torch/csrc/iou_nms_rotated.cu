// Rotated-box IoU and the rotated NMS built on it.
//
// Replaces the TPU kernel s2anet_tpu/ops/pallas/iou_kernel.py::_kernel (the
// pairwise IoU of box_iou_rotated_pallas) and, for serving, the XLA greedy
// sweep s2anet_tpu/ops/nms_rotated.py::_greedy_sweep_fused. One device
// routine, iou_pair, mirrors ops/iou_rotated.py::iou_pairs term for term:
// the sort-free boundary tally (2*area = sum over the 8 edges of
// (t1 - t0) * cross(p, d), each edge clipped to the other box), pair-midpoint
// centering, the _SIDE_EPS tie-breaks (+eps in pass A, -eps in pass B, -eps
// for opposite-direction twins), the _PARALLEL_TOL2 test and the
// area < 1e-14 rule. A bounding-circle test returns 0 first; that is exact,
// since boxes whose circumscribed circles are apart cannot overlap.
//
// Build with --fmad=false: the degenerate-geometry tie-breaks rely on
// crosses that are exactly zero when computed as separately rounded
// products, and a fused multiply-add leaves a residual far above _SIDE_EPS.
//
// Three kernels:
//   s2a_box_iou_rotated     [N,5] x [M,5] -> [N,M] float32
//   s2a_nms_rotated_mask    per image, bit (i, j) of K score-sorted
//                           candidates: j > i, both valid, equal labels,
//                           IoU > thr (strict)
//   s2a_nms_rotated_sweep   per image, one block walks the rows in order and
//                           ORs the mask rows of survivors into the removed
//                           set (the reference's nms_rotated_cuda design)
//
// What bounds them on an H100: the pair geometry is ~300 float32 operations
// with divisions, on the CUDA cores; score-ordered NMS candidates are
// spatially shuffled, so the circle test rejects most pairs of a trained
// model's crowded chips only partly. The mask holds K*K bits (2 MB per
// image at K = 4096). The sweep is sequential per image and pays two block
// barriers per 64 rows; images run in parallel blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kParallelTol2 = 1e-12f;
constexpr float kSideEps = 1e-6f;
constexpr int kMaskBits = 64;

struct Quad {
  float px[4], py[4];  // corners
  float ex[4], ey[4];  // directed edges p[k+1] - p[k]
};

__device__ __forceinline__ void make_quad(float w, float h, float a, float sx,
                                          float sy, Quad& q) {
  const float c2 = cosf(a) * 0.5f;
  const float s2 = sinf(a) * 0.5f;
  const float p0x = -s2 * h - c2 * w;
  const float p0y = c2 * h - s2 * w;
  const float p1x = s2 * h - c2 * w;
  const float p1y = -c2 * h - s2 * w;
  q.px[0] = p0x + sx;  q.py[0] = p0y + sy;
  q.px[1] = p1x + sx;  q.py[1] = p1y + sy;
  q.px[2] = -p0x + sx; q.py[2] = -p0y + sy;
  q.px[3] = -p1x + sx; q.py[3] = -p1y + sy;
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

__device__ float iou_pair(const float* b1, const float* b2) {
  const float x1 = b1[0], y1 = b1[1], w1 = b1[2], h1 = b1[3], a1 = b1[4];
  const float x2 = b2[0], y2 = b2[1], w2 = b2[2], h2 = b2[3], a2 = b2[4];
  const float dxc = x1 - x2;
  const float dyc = y1 - y2;
  const float rr = 0.5f * (sqrtf(w1 * w1 + h1 * h1) + sqrtf(w2 * w2 + h2 * h2));
  const float area1 = w1 * h1;
  const float area2 = w2 * h2;
  if (!(dxc * dxc + dyc * dyc <= rr * rr) || !(area1 > 1e-14f) ||
      !(area2 > 1e-14f))
    return 0.f;
  const float sx = dxc * 0.5f;
  const float sy = dyc * 0.5f;
  Quad qa, qb;
  make_quad(w1, h1, a1, sx, sy, qa);
  make_quad(w2, h2, a2, -sx, -sy, qb);
  // the two passes are summed apart, then added: the association of
  // iou_pairs, so the plain version and this kernel agree bit for bit
  const float acc = clip_pass(qa, qb, kSideEps) + clip_pass(qb, qa, -kSideEps);
  const float inter = 0.5f * fabsf(acc);
  const float uni = area1 + area2 - inter;
  return inter / (uni > 0.f ? uni : 1.f);
}

__global__ void box_iou_rotated_kernel(const float* __restrict__ b1,
                                       const float* __restrict__ b2,
                                       float* __restrict__ out, int N, int M) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= N || j >= M) return;
  out[(long long)i * M + j] = iou_pair(b1 + (long long)i * 5, b2 + (long long)j * 5);
}

// grid (col_blocks, col_blocks, B), 64 threads: thread r of block (cb, rb)
// writes word cb of row rb*64 + r. Blocks below the diagonal write nothing:
// the sweep never reads those words.
__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                const int* __restrict__ labels,
                                const uint8_t* __restrict__ valid, float thr,
                                unsigned long long* __restrict__ mask, int K) {
  const int cb = blockIdx.x, rb = blockIdx.y, img = blockIdx.z;
  if (cb < rb) return;
  const int col_blocks = (K + kMaskBits - 1) / kMaskBits;
  boxes += (long long)img * K * 5;
  labels += (long long)img * K;
  valid += (long long)img * K;
  mask += (long long)img * K * col_blocks;

  __shared__ float s_box[kMaskBits * 5];
  __shared__ int s_lab[kMaskBits];
  __shared__ uint8_t s_ok[kMaskBits];
  const int tid = threadIdx.x;
  const int col = cb * kMaskBits + tid;
  if (col < K) {
#pragma unroll
    for (int k = 0; k < 5; ++k) s_box[tid * 5 + k] = boxes[(long long)col * 5 + k];
    s_lab[tid] = labels[col];
    s_ok[tid] = valid[col];
  } else {
    s_ok[tid] = 0;
  }
  __syncthreads();

  const int row = rb * kMaskBits + tid;
  if (row >= K) return;
  unsigned long long bits = 0ULL;
  if (valid[row]) {
    float b[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) b[k] = boxes[(long long)row * 5 + k];
    const int lab = labels[row];
    const int start = (cb == rb) ? tid + 1 : 0;
    for (int j = start; j < kMaskBits; ++j) {
      if (s_ok[j] && s_lab[j] == lab && iou_pair(b, s_box + j * 5) > thr)
        bits |= 1ULL << j;
    }
  }
  mask[(long long)row * col_blocks + cb] = bits;
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
  const int col_blocks = (K + kMaskBits - 1) / kMaskBits;
  dim3 grid(col_blocks, col_blocks, B);
  nms_mask_kernel<<<grid, kMaskBits, 0, static_cast<cudaStream_t>(stream)>>>(
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
