// Bézier-stroke rasterizer kernels for Hopper (sm_90a): the forward (K4),
// the forward that also saves each tile's stroke list and the tile's canvas
// at the entry of each chunk of that list (K4s), and the backward (K5).
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
// What bounds them on this card.  Bytes are few: the 1.3 MB canvas, 0.2 MB
// of strokes and the saved tile state (2.0 MB at the clipdraw flagship,
// 1024 strokes, P = 25, 216x384).  The operations are those of the (pixel,
// stroke) pairs whose margined bbox holds the pixel: the distances to the
// segments whose margined box holds it (~20 flops each, an IEEE division
// among them), the coverage and the over; the backward computes each
// distance once and adds per pair the transmittance, the cotangents and
// their warp sums, and on the anti-aliasing ramp the point gradients and
// their atomics.  Every block of the grid is resident at once, so the time
// is that of the slowest block (PERF.md).
//
// Design: one block per 16 x 8 pixel tile (8 rows measured faster than 16
// and 4, PERF.md), one thread per pixel, the canvas in registers.  A block
// first lists the strokes that can touch its tile: rounds of one stroke
// per thread test the stroke's margined bbox (width/2 + 1, as
// ops/strokes.py pack_meta, computed here from the samples' box), and
// __ballot_sync / __popc and a prefix over the warps append the hits in
// ascending stroke order (painter order is the function).  The block then
// walks only its list, a chunk of C strokes at a time through shared
// memory, staged with each segment's geometry and its bbox grown by the
// stroke's margin.  C is 16 where K5's chunk fits shared memory (P <= 294)
// and smaller above (chunk_for), down to 1 at P = 5,247.  Three exact skips
// cut the distances: a pixel outside the stroke's margined bbox has
// coverage 0 (the ramp ends 0.5 px inside the margin); a segment whose
// margined bbox misses every pixel of a warp is left out of the warp's
// minimum, found by one ballot (where it would hold the minimum, coverage
// is 0 either way); and the projection's division runs only where the clip
// does not decide it.  K4s writes the list and, at each chunk's entry, the
// 16 x 8 x 4 tile canvas into tile-local slots: a stroke off the list
// paints a = 0 on the tile and leaves it bitwise unchanged, so that is the
// full canvas there.  K5, per tile, walks the same chunks from the top down
// carrying the suffix transmittance S = prod(1 - a) of everything above;
// inside a chunk, pass A keeps each stroke's squared distance, its segment
// argmin and tie count, pass B each stroke's suffix transmittance (alpha
// from that distance), pass C (ascending, from the saved entry canvas,
// never by un-compositing) the cotangents, skipping warps the stroke cannot
// reach: the 5 per-stroke scalars go through warp reductions only where a
// lane of the warp has coverage, and the point gradients (envelope form)
// come from the anti-aliasing ramp's pixels, recomputing the one segment at
// the minimum (every tied one at a tie; ties split the gradient evenly).
// The distance uses round-to-nearest intrinsics so that nvcc cannot
// contract it into FMAs and every recomputation is bitwise equal (ties are
// found by equality).  Unlike the TPU kernel, the backward does not skip
// strokes whose alpha is <= 0: such a stroke still has d/dalpha =
// sum(da * cov).  Gradients reach the (N, P, 2) and (N, 5) outputs by one
// global atomic per block and nonzero value, so their summation order
// varies from run to run.  All pointers are device pointers; nothing is
// allocated here.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileW = 16;
constexpr int kTileH = 8;
constexpr int kThreads = kTileW * kTileH;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 16;  // most strokes per chunk of a tile's list: shared staging, K4s slots
constexpr int kMetaW = 9;      // staged row: [width, r, g, b, a, bx0, by0, bx1, by1]
constexpr int kDMetaW = 5;     // dmeta row: [dwidth, dr, dg, db, dalpha]
constexpr int kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // shared memory a block can use on sm_90

// Squared distance from the pixel centre to segment a->b, given as
// geo = (ax, ay, bx - ax, by - ay) and ab2 = |b - a|^2 + 1e-8 (staged once
// per chunk by stage_chunk); t and the offset e = p - closest point come
// back for the backward.  Same formula and eps as the plain version.
__device__ __forceinline__ float seg_d2(float px, float py, float4 geo, float ab2,
                                        float* t_out, float* ex_out, float* ey_out) {
  const float abx = geo.z, aby = geo.w;
  const float num = __fadd_rn(__fmul_rn(__fsub_rn(px, geo.x), abx),
                              __fmul_rn(__fsub_rn(py, geo.y), aby));
  // t = clip(num / ab2, 0, 1); ab2 > 0, so the clip alone decides t where
  // num <= 0 or num >= ab2, and the division runs only between
  float t;
  if (num <= 0.f)
    t = 0.f;
  else if (num >= ab2)
    t = 1.f;
  else
    t = fminf(fmaxf(__fdiv_rn(num, ab2), 0.f), 1.f);
  const float ex = __fsub_rn(px, __fadd_rn(geo.x, __fmul_rn(t, abx)));
  const float ey = __fsub_rn(py, __fadd_rn(geo.y, __fmul_rn(t, aby)));
  *t_out = t;
  *ex_out = ex;
  *ey_out = ey;
  return __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
}

// Do boxes a and b, each (x0, y0, x1, y1), meet?
__device__ __forceinline__ bool boxes_meet(float4 a, float4 b) {
  return a.x <= b.z && a.z >= b.x && a.y <= b.w && a.w >= b.y;
}

// The warp's near segments among [base, base + 32): bit j - base is set
// where segment j's box (sbox: its bbox with the stroke's margin) meets
// strip, the box of the warp's pixel centres.  Each lane tests one segment;
// every lane of the warp must call it.
__device__ __forceinline__ unsigned near_segments(float4 strip, const float4* sbox, int base, int segs) {
  const int j = base + (threadIdx.y * kTileW + threadIdx.x) % 32;
  return __ballot_sync(0xffffffffu, j < segs && boxes_meet(sbox[j], strip));
}

// The minimum over a stroke's segs segments, of the warp's near ones; inf
// if there are none, or where the lane is not live.  A segment that is not
// near is farther than the margin (width/2 + 1) from every pixel of the
// warp: where it would hold the minimum, coverage is 0 either way, and
// where coverage is above 0 the minimum and every segment that ties it are
// near.  Also the first segment that reaches the minimum and the number
// that do: *tied = argmin | count << 16 (0 where the minimum is inf).
// Every lane of the warp must call it.
__device__ __forceinline__ float min_d2(float px, float py, bool live, float4 strip, const float4* geo,
                                        const float* ab2, const float4* sbox, int segs, int* tied) {
  float t, ex, ey;
  float best = INFINITY;
  int arg = 0, ties = 0;
  for (int base = 0; base < segs; base += 32) {
    unsigned near = near_segments(strip, sbox, base, segs);
    for (; live && near; near &= near - 1) {
      const int j = base + __ffs(near) - 1;
      const float d2 = seg_d2(px, py, geo[j], ab2[j], &t, &ex, &ey);
      if (d2 < best) {
        best = d2;
        arg = j;
        ties = 1;
      } else if (d2 == best) {
        ++ties;
      }
    }
  }
  *tied = arg | (ties << 16);
  return best;
}

__device__ __forceinline__ float dist_of(float d2min) {
  return __fsqrt_rn(__fadd_rn(d2min, 1e-12f));
}

__device__ __forceinline__ float coverage_of(float width, float dist) {
  return fminf(fmaxf(__fsub_rn(__fadd_rn(__fmul_rn(width, 0.5f), 0.5f), dist), 0.f), 1.f);
}

// The stroke's bbox with the anti-aliasing margin, [bx0, by0, bx1, by1], as
// pack_meta computes it in f32 from the samples' box lo, hi (N, 2).
__device__ __forceinline__ void stroke_box(const float* __restrict__ widths, const float* __restrict__ lo,
                                           const float* __restrict__ hi, int s, float* box) {
  const float margin = __fadd_rn(__fmul_rn(widths[s], 0.5f), 1.f);
  box[0] = __fsub_rn(lo[2 * s], margin);
  box[1] = __fsub_rn(lo[2 * s + 1], margin);
  box[2] = __fadd_rn(hi[2 * s], margin);
  box[3] = __fadd_rn(hi[2 * s + 1], margin);
}

// Does the box meet the tile [tx0, tx0 + 16] x [ty0, ty0 + 8]?
__device__ __forceinline__ bool box_meets_tile(const float* box, float tx0, float ty0) {
  return box[0] <= tx0 + kTileW && box[2] >= tx0 && box[1] <= ty0 + kTileH && box[3] >= ty0;
}

__device__ __forceinline__ bool box_holds(const float* box, float px, float py) {
  return px >= box[0] && px <= box[2] && py >= box[1] && py <= box[3];
}

// Stage the strokes idx[0..cn) of a tile's list: their meta rows, the
// geometry of their P - 1 segments (see seg_d2) and the segments' boxes
// with the stroke's margin (see min_d2), from each stroke's samples (one
// contiguous 8·P-byte row).
__device__ __forceinline__ void stage_chunk(float* s_meta, float4* s_geo, float* s_ab2, float4* s_sbox,
                                            const int* idx, int cn, int p,
                                            const float* __restrict__ samples, const float* __restrict__ widths,
                                            const float* __restrict__ colors, const float* __restrict__ lo,
                                            const float* __restrict__ hi, int tid) {
  if (tid < cn) {
    const int s = idx[tid];
    float* m = s_meta + tid * kMetaW;
    m[0] = widths[s];
    for (int k = 0; k < 4; ++k) m[1 + k] = colors[4 * s + k];
    stroke_box(widths, lo, hi, s, m + 5);
  }
  const int segs = p - 1;
  for (int i = tid; i < cn * segs; i += kThreads) {
    const int k = i / segs;
    const float* a = samples + ((size_t)idx[k] * p + (i - k * segs)) * 2;
    const float ax = a[0], ay = a[1];
    const float abx = __fsub_rn(a[2], ax), aby = __fsub_rn(a[3], ay);
    s_geo[i] = make_float4(ax, ay, abx, aby);
    s_ab2[i] = __fadd_rn(__fadd_rn(__fmul_rn(abx, abx), __fmul_rn(aby, aby)), 1e-8f);
    const float margin = __fadd_rn(__fmul_rn(widths[idx[k]], 0.5f), 1.f);
    s_sbox[i] = make_float4(fminf(ax, a[2]) - margin, fminf(ay, a[3]) - margin, fmaxf(ax, a[2]) + margin,
                            fmaxf(ay, a[3]) + margin);
  }
}

// The box of the pixel centres of the thread's warp: 32 / 16 rows of the tile.
__device__ __forceinline__ float4 warp_strip(int tid) {
  constexpr int kRows = 32 / kTileW;
  const float x0 = (float)(blockIdx.x * kTileW) + 0.5f;
  const float y0 = (float)(blockIdx.y * kTileH + (tid / 32) * kRows) + 0.5f;
  return make_float4(x0, y0, x0 + (kTileW - 1), y0 + (kRows - 1));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// samples (N, P, 2), widths (N), colors (N, 4), lo / hi (N, 2) the samples'
// box, bg (4, H, W) premultiplied -> out (4, H, W); chunk strokes per chunk
// of a list (chunk_for(P)).  STORE (K4s): also counts (T) and lists (T, N),
// the tile's list, and canvases (T, ceil(N/chunk), 4, 8, 16), the tile
// canvas at each list chunk's entry; T = the tiles, row-major.  Only the
// first counts[t] entries and ceil(counts[t]/chunk) slots of tile t are
// written.
template <bool STORE>
__global__ void __launch_bounds__(kThreads)
strokes_fwd_kernel(const float* __restrict__ samples, const float* __restrict__ widths,
                   const float* __restrict__ colors, const float* __restrict__ lo,
                   const float* __restrict__ hi, const float* __restrict__ bg, float* __restrict__ out,
                   int* __restrict__ counts, int* __restrict__ lists, float* __restrict__ canvases,
                   int n, int p, int h, int w, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int segs = p - 1;
  float4* s_geo = reinterpret_cast<float4*>(smem);      // chunk * segs
  float4* s_sbox = s_geo + chunk * segs;                // chunk * segs
  float* s_ab2 = smem + 8 * chunk * segs;               // chunk * segs
  float* s_meta = s_ab2 + chunk * segs;                 // chunk * kMetaW
  int* s_list = (int*)(s_meta + chunk * kMetaW);        // kThreads + chunk: pending list entries
  __shared__ int s_warp[kWarps];
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  const bool inside = x < w && y < h;
  const size_t plane = (size_t)h * w;
  const size_t pix = (size_t)y * w + x;
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;
  const float tx0 = (float)(blockIdx.x * kTileW), ty0 = (float)(blockIdx.y * kTileH);
  const float4 strip = warp_strip(tid);
  const int slots = (n + chunk - 1) / chunk;

  float c[4];
  for (int k = 0; k < 4; ++k) c[k] = inside ? bg[k * plane + pix] : 0.f;
  int pending = 0;  // list entries in s_list not yet painted
  int listed = 0;   // list entries found so far
  int painted = 0;  // chunks of the list painted so far
  for (int base = 0; base < n; base += kThreads) {
    // one build round: thread tid tests stroke base + tid
    bool hit = false;
    if (base + tid < n) {
      float box[4];
      stroke_box(widths, lo, hi, base + tid, box);
      hit = box_meets_tile(box, tx0, ty0);
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, found = 0;
    for (int v = 0; v < kWarps; ++v) {
      const int cnt = s_warp[v];
      before += v < warp ? cnt : 0;
      found += cnt;
    }
    if (hit) s_list[pending + before + __popc(ballot & ((1u << lane) - 1u))] = base + tid;
    __syncthreads();
    if (STORE)
      for (int i = tid; i < found; i += kThreads) lists[(size_t)tile * n + listed + i] = s_list[pending + i];
    listed += found;
    pending += found;

    // paint every full chunk of the pending entries (the last round: all of them)
    const bool last = base + kThreads >= n;
    int head = 0;
    while (pending - head >= chunk || (last && pending > head)) {
      const int cn = min(chunk, pending - head);
      if (STORE)
        for (int k = 0; k < 4; ++k)
          canvases[(((size_t)tile * slots + painted) * 4 + k) * kThreads + tid] = c[k];
      stage_chunk(s_meta, s_geo, s_ab2, s_sbox, s_list + head, cn, p, samples, widths, colors, lo, hi, tid);
      __syncthreads();
      for (int s = 0; s < cn; ++s) {
        const float* m = s_meta + s * kMetaW;
        // alpha == 0 paints nothing (a = 0 exactly): uniform over the block
        if (m[4] == 0.f) continue;
        // past the canvas, or outside the stroke's box, a = 0 too
        const bool live = inside && box_holds(m + 5, px, py);
        int tied;
        const float d2 =
            min_d2(px, py, live, strip, s_geo + s * segs, s_ab2 + s * segs, s_sbox + s * segs, segs, &tied);
        if (!live) continue;
        const float a = coverage_of(m[0], dist_of(d2)) * m[4];
        const float one_m = 1.f - a;
        c[0] = m[1] * a + one_m * c[0];
        c[1] = m[2] * a + one_m * c[1];
        c[2] = m[3] * a + one_m * c[2];
        c[3] = a + one_m * c[3];
      }
      __syncthreads();  // done with the staged chunk
      head += cn;
      ++painted;
    }
    // the remainder (< chunk entries) moves to the front of s_list
    const int rest = pending - head;
    const int keep = tid < rest ? s_list[head + tid] : 0;
    __syncthreads();
    if (tid < rest) s_list[tid] = keep;
    pending = rest;
    __syncthreads();
  }
  if (STORE && tid == 0) counts[tile] = listed;
  if (inside)
    for (int k = 0; k < 4; ++k) out[k * plane + pix] = c[k];
}

// g (4, H, W) cotangent of the premultiplied canvas; counts, lists and
// canvases from K4s at the same chunk.  dsamples (N, P, 2) and dmeta (N, 5)
// zeroed by the caller; dbg (4, H, W) is the cotangent of the premultiplied
// background.
__global__ void __launch_bounds__(kThreads)
strokes_bwd_kernel(const float* __restrict__ g, const float* __restrict__ samples,
                   const float* __restrict__ widths, const float* __restrict__ colors,
                   const float* __restrict__ lo, const float* __restrict__ hi,
                   const int* __restrict__ counts, const int* __restrict__ lists,
                   const float* __restrict__ canvases, float* __restrict__ dsamples,
                   float* __restrict__ dmeta, float* __restrict__ dbg, int n, int p, int h, int w, int chunk) {
  extern __shared__ __align__(16) float smem[];
  const int segs = p - 1;
  const int acc_w = kDMetaW + 2 * p;          // per stroke: 5 scalars, then P (x, y)
  float4* s_geo = reinterpret_cast<float4*>(smem);  // chunk * segs
  float4* s_sbox = s_geo + chunk * segs;      // chunk * segs
  float* s_ab2 = smem + 8 * chunk * segs;     // chunk * segs
  float* s_meta = s_ab2 + chunk * segs;       // chunk * kMetaW
  float* s_acc = s_meta + chunk * kMetaW;     // chunk * acc_w
  float* s_sfx = s_acc + chunk * acc_w;       // chunk * kThreads: transmittance above
  float* s_d2 = s_sfx + chunk * kThreads;     // chunk * kThreads: min squared distance
  int* s_tie = (int*)(s_d2 + chunk * kThreads);  // chunk * kThreads: argmin | ties << 16
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  const int lane = tid & 31;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int x = blockIdx.x * kTileW + threadIdx.x;
  const int y = blockIdx.y * kTileH + threadIdx.y;
  const bool inside = x < w && y < h;
  const size_t plane = (size_t)h * w;
  const size_t pix = (size_t)y * w + x;
  const float px = (float)x + 0.5f, py = (float)y + 0.5f;
  const float4 strip = warp_strip(tid);
  const int slots = (n + chunk - 1) / chunk;
  const int* list = lists + (size_t)tile * n;

  // pixels outside the canvas carry g = 0, a = 0 and canvas 0: every term they add is 0
  float gv[4];
  for (int k = 0; k < 4; ++k) gv[k] = inside ? g[k * plane + pix] : 0.f;
  float S = 1.f;  // transmittance of every stroke above the current chunk
  const int listed = n > 0 ? counts[tile] : 0;
  for (int ci = (listed + chunk - 1) / chunk - 1; ci >= 0; --ci) {
    const int k0 = ci * chunk;
    const int cn = min(chunk, listed - k0);
    __syncthreads();  // the previous chunk's flush is done with shared memory
    stage_chunk(s_meta, s_geo, s_ab2, s_sbox, list + k0, cn, p, samples, widths, colors, lo, hi, tid);
    for (int i = tid; i < cn * acc_w; i += kThreads) s_acc[i] = 0.f;
    __syncthreads();

    // pass A (ascending): each stroke's squared distance and ties at this
    // pixel; inf past the canvas and outside the stroke's box (coverage 0)
    for (int s = 0; s < cn; ++s) {
      const float* m = s_meta + s * kMetaW;
      int tied;
      const float d2 = min_d2(px, py, inside && box_holds(m + 5, px, py), strip, s_geo + s * segs,
                              s_ab2 + s * segs, s_sbox + s * segs, segs, &tied);
      s_d2[s * kThreads + tid] = d2;
      s_tie[s * kThreads + tid] = tied;
    }
    // pass B (descending): transmittance of everything above each stroke;
    // alpha from the kept distance, as the forward computes it (a = 0 where
    // the distance is inf, which leaves the transmittance as it is)
    float suffix = S;
    for (int s = cn - 1; s >= 0; --s) {
      const float* m = s_meta + s * kMetaW;
      const float d2 = s_d2[s * kThreads + tid];
      s_sfx[s * kThreads + tid] = suffix;
      if (d2 < INFINITY) suffix *= 1.f - coverage_of(m[0], dist_of(d2)) * m[4];
    }
    // pass C (ascending): cotangents, with c = the canvas below the stroke
    float c[4];
    for (int k = 0; k < 4; ++k) c[k] = canvases[(((size_t)tile * slots + ci) * 4 + k) * kThreads + tid];
    for (int s = 0; s < cn; ++s) {
      const float* m = s_meta + s * kMetaW;
      const float4* geo = s_geo + s * segs;
      const float* ab2 = s_ab2 + s * segs;
      const float4* sbox = s_sbox + s * segs;
      const float width = m[0], alpha = m[4];
      const float d2min = s_d2[s * kThreads + tid];
      // a warp none of whose pixels the stroke can reach (every distance
      // inf: a = 0) adds no term and leaves its canvas as it is
      if (!__any_sync(0xffffffffu, d2min < INFINITY)) continue;
      const float dist = dist_of(d2min);  // inf outside the stroke's box: cov 0
      const float cov = coverage_of(width, dist);
      const float ramp = (cov > 0.f && cov < 1.f) ? 1.f : 0.f;
      const float a = cov * alpha;
      const float sfx = s_sfx[s * kThreads + tid];
      const float u0 = gv[0] * sfx, u1 = gv[1] * sfx, u2 = gv[2] * sfx, u3 = gv[3] * sfx;
      const float da = u0 * (m[1] - c[0]) + u1 * (m[2] - c[1]) + u2 * (m[3] - c[2]) +
                       u3 * (1.f - c[3]);
      const float dcov = da * alpha;
      const float ddist = -dcov * ramp;

      float* acc = s_acc + s * acc_w;
      // where cov = 0 (a = 0, ramp = 0) all five terms are 0: a warp with no
      // covered pixel skips the reductions
      if (__any_sync(0xffffffffu, cov > 0.f)) {
        const float vals[kDMetaW] = {-0.5f * ddist, u0 * a, u1 * a, u2 * a, da * cov};
        for (int k = 0; k < kDMetaW; ++k) {
          const float v = warp_sum(vals[k]);
          if (lane == 0 && v != 0.f) atomicAdd(acc + k, v);
        }
      }
      // point gradients (envelope form): only pixels on the anti-aliasing ramp
      const float base = ramp != 0.f ? ddist / (2.f * dist) : 0.f;
      if (base != 0.f) {
        const int tied = s_tie[s * kThreads + tid];
        const int ties = tied >> 16;
        const float dd2 = base / (float)ties;
        float* accp = acc + kDMetaW;
        for (int j = ties == 1 ? (tied & 0xffff) : 0; j < segs; ++j) {
          float t, ex, ey;
          if (!boxes_meet(sbox[j], strip) || seg_d2(px, py, geo[j], ab2[j], &t, &ex, &ey) != d2min) continue;
          const float gx = dd2 * (-2.f * ex), gy = dd2 * (-2.f * ey);
          atomicAdd(accp + 2 * j, gx * (1.f - t));
          atomicAdd(accp + 2 * j + 1, gy * (1.f - t));
          atomicAdd(accp + 2 * j + 2, gx * t);
          atomicAdd(accp + 2 * j + 3, gy * t);
          if (ties == 1) break;
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
      const int stroke = list[k0 + s];
      if (r < kDMetaW)
        atomicAdd(dmeta + (size_t)stroke * kDMetaW + r, v);
      else
        atomicAdd(dsamples + (size_t)stroke * p * 2 + (r - kDMetaW), v);
    }
  }
  if (inside)
    for (int k = 0; k < 4; ++k) dbg[k * plane + pix] = gv[k] * S;
}

size_t fwd_smem(int p, int chunk) {
  return sizeof(float) * (9 * chunk * (p - 1) + chunk * kMetaW) + sizeof(int) * (kThreads + chunk);
}

size_t bwd_smem(int p, int chunk) {
  return sizeof(float) * (9 * chunk * (p - 1) + chunk * kMetaW + chunk * (kDMetaW + 2 * p) + 3 * chunk * kThreads);
}

// Strokes per chunk at P samples: the most, up to 16, whose K5 chunk (the
// staged segments, the accumulators, the per-pixel planes) fits shared
// memory; 0 where not even one stroke fits.  K4s and K5 take the same.
int chunk_for(int p) {
  for (int chunk = kMaxChunk; chunk > 0; --chunk)
    if (bwd_smem(p, chunk) <= kMaxSmem) return chunk;
  return 0;
}

// Above 48 KB a kernel must opt in; past the block limit (227 KB) the
// attribute call fails and its error is returned to the caller.
template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)kDefaultSmem) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" int strokes_tile_h() { return kTileH; }

extern "C" int strokes_chunk(int p) { return p >= 2 ? chunk_for(p) : 0; }

// The most samples per stroke the kernels take: one stroke per chunk.
extern "C" int strokes_max_samples() {
  int p = 2;
  while (bwd_smem(p + 1, 1) <= kMaxSmem) ++p;
  return p;
}

// counts == nullptr: K4; otherwise K4s.
extern "C" int strokes_fwd(const float* samples, const float* widths, const float* colors, const float* lo,
                           const float* hi, const float* bg, float* out, int* counts, int* lists,
                           float* canvases, int n, int p, int h, int w, void* stream) {
  const int chunk = strokes_chunk(p);
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  const dim3 block(kTileW, kTileH);
  const size_t smem = fwd_smem(p, chunk);
  const cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (counts == nullptr) {
    if ((err = set_smem(strokes_fwd_kernel<false>, smem))) return err;
    strokes_fwd_kernel<false><<<grid, block, smem, st>>>(samples, widths, colors, lo, hi, bg, out, nullptr,
                                                         nullptr, nullptr, n, p, h, w, chunk);
  } else {
    if ((err = set_smem(strokes_fwd_kernel<true>, smem))) return err;
    strokes_fwd_kernel<true><<<grid, block, smem, st>>>(samples, widths, colors, lo, hi, bg, out, counts, lists,
                                                        canvases, n, p, h, w, chunk);
  }
  return (int)cudaGetLastError();
}

extern "C" int strokes_bwd(const float* g, const float* samples, const float* widths, const float* colors,
                           const float* lo, const float* hi, const int* counts, const int* lists,
                           const float* canvases, float* dsamples, float* dmeta, float* dbg, int n, int p,
                           int h, int w, void* stream) {
  const int chunk = strokes_chunk(p);
  if (chunk == 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH);
  const dim3 block(kTileW, kTileH);
  const size_t smem = bwd_smem(p, chunk);
  int err;
  if ((err = set_smem(strokes_bwd_kernel, smem))) return err;
  strokes_bwd_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(g, samples, widths, colors, lo, hi, counts, lists,
                                                                  canvases, dsamples, dmeta, dbg, n, p, h, w, chunk);
  return (int)cudaGetLastError();
}
