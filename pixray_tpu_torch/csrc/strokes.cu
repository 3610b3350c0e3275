// Bézier-stroke rasterizer kernels for Hopper (sm_90a): the forward (K4),
// the forward that also stores each chunk's entry canvas (K4s), and the
// backward (K5).
//
// Replaces the Pallas TPU kernels of pixray_tpu/ops/pallas_strokes.py:
//   strokes_fwd_kernel<false>  <- _fwd_kernel        (launched by _run_fwd:334)
//   strokes_fwd_kernel<true>   <- _fwd_store_kernel  (launched by _run_fwd:342)
//   strokes_bwd_kernel         <- _bwd_kernel        (launched by _run_bwd:371)
//
// The function (ops/strokes.py is its plain version): N strokes, each a
// polyline of P samples (P-1 segments) with a width and a straight RGBA
// colour, painted in order over a premultiplied (4, H, W) canvas.  Pixel
// centres sit at +0.5; coverage = clip(width/2 + 0.5 - sqrt(min_j d2_j +
// 1e-12), 0, 1); a = coverage * alpha; canvas = colour*a + (1-a)*canvas.
//
// What bounds them on this card: arithmetic and block-level reductions, not
// bytes.  At the clipdraw flagship (1024 strokes, P = 25, 216x384) the
// canvas is 1.3 MB and the strokes 0.2 MB; each (pixel, stroke) pair that
// the bounding-box test keeps costs ~24 segment distances (~20 flops each).
// The backward adds, per kept pair, a block reduction of the 5 per-stroke
// scalars and shared-memory atomics for the point gradients of the pixels
// on the anti-aliasing ramp.  K4s writes n_chunks x 1.3 MB of chunk-entry
// canvases (85 MB at the flagship), K5 reads them back.
//
// Design: one thread per pixel of a 16x16 tile, the canvas in registers.
// Strokes stream through shared memory 16 at a time (one "chunk"); the
// bounding-box test (width/2 + 1 margin, as _pack_meta) is uniform over the
// block, so a stroke that misses the tile costs no divergent work.
// Backward, per tile: walk the chunks from the top down carrying the suffix
// transmittance S = prod(1 - a) of everything above; inside a chunk, pass A
// computes each stroke's alpha, pass B each stroke's suffix transmittance,
// pass C (ascending, from the stored entry canvas, never by un-compositing)
// the cotangents.  Ties in the segment minimum split the gradient evenly;
// the distance uses round-to-nearest intrinsics so that nvcc cannot contract
// it into FMAs and every recomputation is bitwise equal (ties are detected
// by equality).  Unlike the TPU kernel, the backward does not skip strokes
// whose alpha is <= 0: such a stroke still has d/dalpha = sum(da * cov).
// Gradients reach the (N, P, 2) and (N, 5) outputs by one global atomic per
// block and value, so their summation order varies from run to run.
// All pointers are device pointers; nothing is allocated here.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileW = 16;
constexpr int kTileH = 16;
constexpr int kThreads = kTileW * kTileH;
constexpr int kChunk = 16;   // strokes per chunk: shared staging and K4s prefixes
constexpr int kMetaW = 9;    // meta row: [width, r, g, b, a, bx0, by0, bx1, by1]
constexpr int kDMetaW = 5;   // dmeta row: [dwidth, dr, dg, db, dalpha]
constexpr int kDefaultSmem = 48 * 1024;

// Squared distance from the pixel centre to segment a->b; t and the offset
// e = p - closest point come back for the backward.  Same formula and
// eps as the plain version.
__device__ __forceinline__ float seg_d2(float px, float py, const float* a,
                                        float* t_out, float* ex_out, float* ey_out) {
  const float abx = __fsub_rn(a[2], a[0]);
  const float aby = __fsub_rn(a[3], a[1]);
  const float ab2 = __fadd_rn(__fadd_rn(__fmul_rn(abx, abx), __fmul_rn(aby, aby)), 1e-8f);
  const float num = __fadd_rn(__fmul_rn(__fsub_rn(px, a[0]), abx),
                              __fmul_rn(__fsub_rn(py, a[1]), aby));
  const float t = fminf(fmaxf(__fdiv_rn(num, ab2), 0.f), 1.f);
  const float ex = __fsub_rn(px, __fadd_rn(a[0], __fmul_rn(t, abx)));
  const float ey = __fsub_rn(py, __fadd_rn(a[1], __fmul_rn(t, aby)));
  *t_out = t;
  *ex_out = ex;
  *ey_out = ey;
  return __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
}

__device__ __forceinline__ float min_d2(float px, float py, const float* sp, int p) {
  float t, ex, ey;
  float d2min = seg_d2(px, py, sp, &t, &ex, &ey);
  for (int j = 1; j < p - 1; ++j) d2min = fminf(d2min, seg_d2(px, py, sp + 2 * j, &t, &ex, &ey));
  return d2min;
}

__device__ __forceinline__ float dist_of(float d2min) {
  return __fsqrt_rn(__fadd_rn(d2min, 1e-12f));
}

__device__ __forceinline__ float coverage_of(float width, float dist) {
  return fminf(fmaxf(__fsub_rn(__fadd_rn(__fmul_rn(width, 0.5f), 0.5f), dist), 0.f), 1.f);
}

// Does the stroke's margined bbox meet the tile [tx0, tx0+16] x [ty0, ty0+16]?
__device__ __forceinline__ bool bbox_hit(const float* m, float tx0, float ty0) {
  return m[5] <= tx0 + kTileW && m[7] >= tx0 && m[6] <= ty0 + kTileH && m[8] >= ty0;
}

__device__ __forceinline__ void stage_chunk(float* s_meta, float* s_samp,
                                            const float* __restrict__ meta,
                                            const float* __restrict__ samples,
                                            int s0, int cn, int p, int tid) {
  for (int i = tid; i < cn * kMetaW; i += kThreads) s_meta[i] = meta[(size_t)s0 * kMetaW + i];
  for (int i = tid; i < cn * p * 2; i += kThreads) s_samp[i] = samples[(size_t)s0 * p * 2 + i];
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// samples (N, P, 2), meta (N, 9), bg (4, H, W) premultiplied -> out (4, H, W);
// STORE: also prefixes (ceil(N/16), 4, H, W), the canvas at each chunk's entry.
template <bool STORE>
__global__ void __launch_bounds__(kThreads)
strokes_fwd_kernel(const float* __restrict__ samples, const float* __restrict__ meta,
                   const float* __restrict__ bg, float* __restrict__ out,
                   float* __restrict__ prefixes, int n, int p, int h, int w) {
  extern __shared__ float smem[];
  float* s_meta = smem;                    // kChunk * kMetaW
  float* s_samp = smem + kChunk * kMetaW;  // kChunk * p * 2
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  const bool inside = x < w && y < h;
  const size_t plane = (size_t)h * w;
  const size_t pix = (size_t)y * w + x;
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;
  const float tx0 = (float)(blockIdx.x * kTileW), ty0 = (float)(blockIdx.y * kTileH);

  float c[4];
  for (int k = 0; k < 4; ++k) c[k] = inside ? bg[k * plane + pix] : 0.f;
  const int n_chunks = (n + kChunk - 1) / kChunk;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int s0 = ci * kChunk;
    const int cn = min(kChunk, n - s0);
    if (STORE && inside)
      for (int k = 0; k < 4; ++k) prefixes[((size_t)ci * 4 + k) * plane + pix] = c[k];
    __syncthreads();  // the previous chunk is done with shared memory
    stage_chunk(s_meta, s_samp, meta, samples, s0, cn, p, tid);
    __syncthreads();
    for (int s = 0; s < cn; ++s) {
      const float* m = s_meta + s * kMetaW;
      // alpha == 0 paints nothing (a = 0 exactly); uniform over the block
      if (m[4] == 0.f || !bbox_hit(m, tx0, ty0)) continue;
      const float a = coverage_of(m[0], dist_of(min_d2(px, py, s_samp + s * p * 2, p))) * m[4];
      const float one_m = 1.f - a;
      c[0] = m[1] * a + one_m * c[0];
      c[1] = m[2] * a + one_m * c[1];
      c[2] = m[3] * a + one_m * c[2];
      c[3] = a + one_m * c[3];
    }
  }
  if (inside)
    for (int k = 0; k < 4; ++k) out[k * plane + pix] = c[k];
}

// g (4, H, W) cotangent of the premultiplied canvas; prefixes from K4s.
// dsamples (N, P, 2) and dmeta (N, 5) zeroed by the caller; dbg (4, H, W)
// is the cotangent of the premultiplied background.
__global__ void __launch_bounds__(kThreads)
strokes_bwd_kernel(const float* __restrict__ g, const float* __restrict__ samples,
                   const float* __restrict__ meta, const float* __restrict__ prefixes,
                   float* __restrict__ dsamples, float* __restrict__ dmeta,
                   float* __restrict__ dbg, int n, int p, int h, int w) {
  extern __shared__ float smem[];
  const int acc_w = kDMetaW + 2 * p;          // per stroke: 5 scalars, then P (x, y)
  float* s_meta = smem;                       // kChunk * kMetaW
  float* s_acc = s_meta + kChunk * kMetaW;    // kChunk * acc_w
  float* s_a = s_acc + kChunk * acc_w;        // kChunk * kThreads: alpha per pixel
  float* s_sfx = s_a + kChunk * kThreads;     // kChunk * kThreads: transmittance above
  float* s_samp = s_sfx + kChunk * kThreads;  // kChunk * p * 2
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int lane = tid & 31;
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  const bool inside = x < w && y < h;
  const size_t plane = (size_t)h * w;
  const size_t pix = (size_t)y * w + x;
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;
  const float tx0 = (float)(blockIdx.x * kTileW), ty0 = (float)(blockIdx.y * kTileH);

  // pixels outside the canvas carry g = 0 and canvas 0: every term they add is 0
  float gv[4];
  for (int k = 0; k < 4; ++k) gv[k] = inside ? g[k * plane + pix] : 0.f;
  float S = 1.f;  // transmittance of every stroke above the current chunk
  const int n_chunks = (n + kChunk - 1) / kChunk;
  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int s0 = ci * kChunk;
    const int cn = min(kChunk, n - s0);
    __syncthreads();  // the previous chunk's flush is done with shared memory
    stage_chunk(s_meta, s_samp, meta, samples, s0, cn, p, tid);
    for (int i = tid; i < cn * acc_w; i += kThreads) s_acc[i] = 0.f;
    __syncthreads();

    // pass A (ascending): each stroke's alpha at this pixel
    for (int s = 0; s < cn; ++s) {
      const float* m = s_meta + s * kMetaW;
      float a = 0.f;
      if (bbox_hit(m, tx0, ty0))
        a = coverage_of(m[0], dist_of(min_d2(px, py, s_samp + s * p * 2, p))) * m[4];
      s_a[s * kThreads + tid] = a;
    }
    // pass B (descending): transmittance of everything above each stroke
    float suffix = S;
    for (int s = cn - 1; s >= 0; --s) {
      s_sfx[s * kThreads + tid] = suffix;
      suffix *= 1.f - s_a[s * kThreads + tid];
    }
    // pass C (ascending): cotangents, with c = the canvas below the stroke
    float c[4];
    for (int k = 0; k < 4; ++k) c[k] = inside ? prefixes[((size_t)ci * 4 + k) * plane + pix] : 0.f;
    for (int s = 0; s < cn; ++s) {
      const float* m = s_meta + s * kMetaW;
      if (!bbox_hit(m, tx0, ty0)) continue;  // uniform over the block
      const float* sp = s_samp + s * p * 2;
      const float width = m[0], alpha = m[4];
      const float d2min = min_d2(px, py, sp, p);
      const float dist = dist_of(d2min);
      const float cov = coverage_of(width, dist);
      const float ramp = (cov > 0.f && cov < 1.f) ? 1.f : 0.f;
      const float a = s_a[s * kThreads + tid];
      const float sfx = s_sfx[s * kThreads + tid];
      const float u0 = gv[0] * sfx, u1 = gv[1] * sfx, u2 = gv[2] * sfx, u3 = gv[3] * sfx;
      const float da = u0 * (m[1] - c[0]) + u1 * (m[2] - c[1]) + u2 * (m[3] - c[2]) +
                       u3 * (1.f - c[3]);
      const float dcov = da * alpha;
      const float ddist = -dcov * ramp;

      float* acc = s_acc + s * acc_w;
      const float vals[kDMetaW] = {-0.5f * ddist, u0 * a, u1 * a, u2 * a, da * cov};
      for (int k = 0; k < kDMetaW; ++k) {
        const float v = warp_sum(vals[k]);
        if (lane == 0 && v != 0.f) atomicAdd(acc + k, v);
      }
      // point gradients (envelope form): only pixels on the anti-aliasing ramp
      const float base = ddist / (2.f * dist);
      if (base != 0.f) {
        int ties = 0;
        float t, ex, ey;
        for (int j = 0; j < p - 1; ++j) ties += seg_d2(px, py, sp + 2 * j, &t, &ex, &ey) == d2min;
        const float dd2 = base / (float)ties;
        float* accp = acc + kDMetaW;
        for (int j = 0; j < p - 1; ++j) {
          if (seg_d2(px, py, sp + 2 * j, &t, &ex, &ey) != d2min) continue;
          const float gx = dd2 * (-2.f * ex), gy = dd2 * (-2.f * ey);
          atomicAdd(accp + 2 * j, gx * (1.f - t));
          atomicAdd(accp + 2 * j + 1, gy * (1.f - t));
          atomicAdd(accp + 2 * j + 2, gx * t);
          atomicAdd(accp + 2 * j + 3, gy * t);
        }
      }
      const float one_m = 1.f - a;
      c[0] = m[1] * a + one_m * c[0];
      c[1] = m[2] * a + one_m * c[1];
      c[2] = m[3] * a + one_m * c[2];
      c[3] = a + one_m * c[3];
    }
    S = suffix;
    __syncthreads();
    // flush the chunk's block sums: one global atomic per nonzero value
    for (int i = tid; i < cn * acc_w; i += kThreads) {
      const float v = s_acc[i];
      if (v == 0.f) continue;
      const int s = i / acc_w, r = i % acc_w;
      if (r < kDMetaW)
        atomicAdd(dmeta + (size_t)(s0 + s) * kDMetaW + r, v);
      else
        atomicAdd(dsamples + (size_t)(s0 + s) * p * 2 + (r - kDMetaW), v);
    }
  }
  if (inside)
    for (int k = 0; k < 4; ++k) dbg[k * plane + pix] = gv[k] * S;
}

size_t fwd_smem(int p) { return sizeof(float) * (kChunk * kMetaW + kChunk * p * 2); }

size_t bwd_smem(int p) {
  return sizeof(float) * (kChunk * kMetaW + kChunk * (kDMetaW + 2 * p) +
                          2 * kChunk * kThreads + kChunk * p * 2);
}

// Above 48 KB a kernel must opt in; past the block limit (227 KB, P > ~770
// samples) the attribute call fails and its error is returned to the caller.
template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

}  // namespace

extern "C" int strokes_chunk() { return kChunk; }

// prefixes == nullptr: K4; otherwise K4s.
extern "C" int strokes_fwd(const float* samples, const float* meta, const float* bg,
                           float* out, float* prefixes, int n, int p, int h, int w,
                           void* stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  const dim3 block(kTileW, kTileH);
  const size_t smem = fwd_smem(p);
  int err;
  if (prefixes == nullptr) {
    if ((err = set_smem(strokes_fwd_kernel<false>, smem))) return err;
    strokes_fwd_kernel<false><<<grid, block, smem, (cudaStream_t)stream>>>(
        samples, meta, bg, out, nullptr, n, p, h, w);
  } else {
    if ((err = set_smem(strokes_fwd_kernel<true>, smem))) return err;
    strokes_fwd_kernel<true><<<grid, block, smem, (cudaStream_t)stream>>>(
        samples, meta, bg, out, prefixes, n, p, h, w);
  }
  return (int)cudaGetLastError();
}

extern "C" int strokes_bwd(const float* g, const float* samples, const float* meta,
                           const float* prefixes, float* dsamples, float* dmeta, float* dbg,
                           int n, int p, int h, int w, void* stream) {
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  const dim3 block(kTileW, kTileH);
  const size_t smem = bwd_smem(p);
  int err;
  if ((err = set_smem(strokes_bwd_kernel, smem))) return err;
  strokes_bwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      g, samples, meta, prefixes, dsamples, dmeta, dbg, n, p, h, w);
  return (int)cudaGetLastError();
}
