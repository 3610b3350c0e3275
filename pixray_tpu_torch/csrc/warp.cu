// Cutout-bank kernels for Hopper (sm_90a): the whole bank of one perceptor
// in one launch each way.  K1 (bank_fwd_kernel) warps every cut of the bank
// from the work canvas and applies the epilogue (compute-dtype rounding,
// hue/saturation jitter, noise); K2 (bank_bwd_kernel) takes the bank's
// cotangent through the epilogue's adjoint and the warp's adjoint into the
// canvas gradient.
//
// Replaces, from the JAX package:
//   bank_fwd_kernel <- pixray_tpu/ops/pallas_warp.py _fwd_kernel_multi_T
//                      (launched by _run_fwd_multi_T), the separable matmul
//                      route of the axis-aligned cuts, and the epilogue XLA
//                      fused around them (pixray_tpu/engine/cutouts.py:397-425)
//   bank_bwd_kernel <- _bwd_kernel_multi_TB (launched by _run_bwd_multi_TB)
//                      and that epilogue's adjoint
// and, because both take a padding mode per cut and compute the full
// (unbanded) adjoint, every other kernel body of pallas_warp.py.
//
// What bounds them on this card: bytes, by the count.  The TPU kernels
// contract dense bilinear "hat" matrices on the matrix unit; here a cut is a
// 4-tap gather (~40 flops per pixel) and the jitter ~60 more.  At the
// flagship (224x224x3 f32 canvas, 64 cuts of 224x224, bf16) the forward
// reads the 0.6 MB canvas (L2-resident) and 19.3 MB of noise planes and
// writes the 19.3 MB bank plus the pre-jitter bank of the jittered cuts
// (14.2 MB at 47 of 64), which the backward needs; the backward reads the
// 19.3 MB cotangent and that saved bank and writes the 0.6 MB gradient.  What the design does about it: every
// intermediate of the epilogue (the f32 bank, its bf16 copy, the HSV
// planes, the jittered planes, the noise product) stays in registers, and
// each thread moves 8 bytes per load and store (4 bf16 pixels; 16 bytes
// and 8 pixels measured slower).  The canvas gradient is the one scatter:
// each backward block owns one cut x one 16x16 output tile, finds the
// canvas footprint of its taps (min/max after each mode's remap), sums into
// shared memory with shared-memory atomics when the footprint fits (then
// one global atomic per touched canvas element), and adds straight to
// device memory otherwise (extreme perspective, reflection folds,
// zoomed-out cuts).  The order of a float sum therefore varies from run to
// run.  What holds them above the byte bound on the card (PERF.md): the
// per-pixel arithmetic (IEEE divisions the bitwise contract below keeps,
// two in the coordinates and four in the HSV state, twelve in the jitter's
// adjoint) and, in the backward, the atomics of a scatter that all 64 cuts
// aim at one 0.6 MB canvas.
//
// Exactness.  The coordinates, taps, bilinear value and fill composite are
// written with __fmul_rn / __fadd_rn / __fdiv_rn (never contracted into an
// FMA) in the order of the plain version (ops/warp_batch.py
// warp_modes_plain, as eager PyTorch runs it), so the rounded pre-jitter bank
// equals the plain one bitwise: the jitter's gradient depends on its exact
// gray ties (delta <= 1e-6, maxc == r, maxc == g).  The jitter mirrors
// ops/color.py op by op in f32 (a division by the Python scalar 6.0 is a
// product with its f32 reciprocal, as PyTorch's CUDA division by a scalar
// is), and the noise rounds where eager bf16 rounds: t = bf16(fac * z), then
// bf16(p + t).  The backward recomputes the forward's HSV state from the
// saved bank and evaluates ops/color.py jitter_planes_adjoint (autograd's
// tie rules), then rounds to the compute dtype where the .float() of the
// jitter does.
//
// Precision rungs (the JAX package's PIXRAY_TPU_WARP_PREC / _WARP_BWD_PREC):
// besides the exact warp above (bank_fwd_kernel, bank_bwd_kernel), each
// kernel has one variant per rung of pallas_warp.py, with a name of its own
// so that a profiler tells them apart.  They compute the Pallas branches'
// functions in tap form, with the JAX hats max(0, 1 - |t - u|) of the two
// taps per axis (not the exact warp's 1 - frac), and none of the TPU
// kernels' hat-matrix blocking:
//   bank_fwd_bf16_kernel / _high_kernel <- _fwd_kernel_multi_T through _mm:
//     per x tap, sum over the y taps of bf16(work) bf16(hat_y) in f32 (high:
//     hi.hi + lo.hi + hi.lo of the bf16 split, in that order), then
//     sum over the x taps of that times hat_x, plus the fill; bodies of
//     their own, each behind a pack pass (see "K1-bf16 and K1-high" below);
//   bank_fwd_int8_kernel <- the int8 branch (:571-579 with :821-826, :650):
//     the canvas quantized (round(work / s_w * 127) as s8, s_w =
//     max(max|work|, 1e-6), ops/warp_batch.py quantize_canvas), y hats
//     round(hat * 127), an int32 sum per x tap, then f32 times hat_x, plus
//     the fill over the dequant scale, times s_w / 127^2; a body of its
//     own, designed for this card, behind two small passes (see "K1-int8
//     and K2-bf16" below);
//   bank_bwd_bf16_kernel <- _bwd_kernel_multi_TB through _mm_nt: per tap
//     bf16(hat_y) bf16(hat_x g) into the canvas; a body of its own (below);
//   bank_bwd_high_kernel <- the same through _mm_nt's hi/lo form: per tap
//     bf16(a) bf16(b g) + lo(a) bf16(b g) + bf16(a) lo(b g); a body of its
//     own (see "K2-int8 and K2-high" below);
//   bank_bwd_int8_kernel <- the int8 branch (:718-743, :777-782): with
//     s_g = max|g| over the whole bank's post-epilogue cotangent, per tap
//     round(hat_y g / s_g 127) round(hat_x 127) summed in int64 (exact, so
//     the sum is order-free and deterministic), then float(sum) s_g /
//     127^2; a body of its own behind a cotangent pass, before a finish
//     pass (below).
// The epilogue and its adjoint are the exact kernels' in every rung, and
// each backward is the adjoint of the exact warp (straight-through), as the
// JAX package's custom VJP has it.
//
// Per-cut parameters come in one f32 row of kParamStride per cut:
// inverse matrix (9), mode, hue shift, saturation factor, apply, noise
// factor, fill, at the offsets bank_layout() exports.  The fill travels in
// the row, not as a kernel argument, so that a captured CUDA graph of the
// step reads each step's gray from the parameter rows it is given.  Modes: 0 reflection (with the -1e-6 of the reference), 1 border
// clamp, 2 zeros, 3 zeros composited over `fill` by the closed-form coverage
// at the raw coordinates.  All pointers are device pointers; nothing is
// allocated here.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <type_traits>

namespace {

namespace cg = cooperative_groups;

constexpr int kParamStride = 16;
constexpr int kMode = 9, kHue = 10, kSat = 11, kApply = 12, kFac = 13, kFill = 14;  // after the 9 of the matrix
constexpr int kThreads = 256;
constexpr int kTile = 16;            // backward output tile, kTile x kTile = kThreads pixels
constexpr int kSmemFloats = 2048;    // backward footprint budget: 8 KB, a 26 x 26 canvas patch
static_assert(kTile * kTile == kThreads, "one backward pixel per thread");
constexpr float kInv6 = 1.0f / 6.0f;
constexpr float kQ = 127.f;
constexpr float kDequant = 127.f * 127.f;
enum Prec { kHighest = 0, kBf16 = 1, kHigh = 2, kInt8 = 3 };  // as ops/cuda_warp.py _PREC_CODES

using bf16 = __nv_bfloat16;

struct Cut {
  float m[9];
  int mode;
  float hue, sat, fac, fill;
  bool apply;
};

__device__ __forceinline__ Cut load_cut(const float* __restrict__ params, int n) {
  const float* p = params + (long)n * kParamStride;
  Cut c;
#pragma unroll
  for (int k = 0; k < 9; ++k) c.m[k] = __ldg(p + k);
  c.mode = (int)__ldg(p + kMode);
  c.hue = __ldg(p + kHue);
  c.sat = __ldg(p + kSat);
  c.apply = __ldg(p + kApply) != 0.f;
  c.fac = __ldg(p + kFac);
  c.fill = __ldg(p + kFill);
  return c;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) { return __float2bfloat16_rn(x); }
// rounding to the compute dtype, kept in f32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// torch.remainder(x, y) for y > 0: fmod, then shift a negative remainder
__device__ __forceinline__ float rem_pos(float x, float y) {
  if (x >= 0.f && x < y) return x;  // what fmod returns there, without its loop
  float r = fmodf(x, y);
  if (r != 0.f && r < 0.f) r = __fadd_rn(r, y);
  return r;
}

// torch.remainder(x, 1): x - floor(x) is the one rounding of the value
// fmod-then-shift rounds (they differ only in the sign of a zero result,
// which nothing downstream reads)
__device__ __forceinline__ float rem_one(float x) { return __fsub_rn(x, floorf(x)); }

__device__ __forceinline__ float clamp01(float x) { return fminf(fmaxf(x, 0.f), 1.f); }

__device__ __forceinline__ float reflect_coord(float x, int size) {
  const float span = 2.f * (float)size;
  x = rem_pos(__fadd_rn(x, 0.5f), span);
  if (x >= (float)size) x = __fsub_rn(__fsub_rn(span, x), 1e-6f);
  return __fsub_rn(x, 0.5f);
}

// Bilinear taps of output pixel (i, j) of a cut, as warp_modes_plain forms them.
struct Taps {
  int x0, y0;           // top-left tap, clamped to [-2, size + 1] like the plain gather
  float ax, wx, ay, wy; // (1 - wx), wx, (1 - wy), wy
  float tx, ty;         // the padded source coordinates
  float fill_add;
  unsigned valid;       // bit k: tap k (00, 01, 10, 11) lies on the canvas
};

__device__ __forceinline__ Taps compute_taps(const Cut& c, int i, int j, int h, int w, float fill) {
  const float* m = c.m;
  const float fi = (float)i, fj = (float)j;
  const float nx = __fadd_rn(__fadd_rn(__fmul_rn(fj, m[0]), __fmul_rn(fi, m[1])), m[2]);
  const float ny = __fadd_rn(__fadd_rn(__fmul_rn(fj, m[3]), __fmul_rn(fi, m[4])), m[5]);
  const float den = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(fj, m[6]), __fmul_rn(fi, m[7])), m[8]), 1e-8f);
  const float sx = __fdiv_rn(nx, den), sy = __fdiv_rn(ny, den);
  float tx = sx, ty = sy;
  if (c.mode == 0) {
    tx = reflect_coord(sx, w);
    ty = reflect_coord(sy, h);
  } else if (c.mode == 1) {
    tx = fminf(fmaxf(sx, 0.f), (float)(w - 1));
    ty = fminf(fmaxf(sy, 0.f), (float)(h - 1));
  }
  Taps tp;
  tp.tx = tx;
  tp.ty = ty;
  const float fx0 = floorf(tx), fy0 = floorf(ty);
  tp.wx = __fsub_rn(tx, fx0);
  tp.wy = __fsub_rn(ty, fy0);
  tp.ax = __fsub_rn(1.f, tp.wx);
  tp.ay = __fsub_rn(1.f, tp.wy);
  // far outside (or non-finite): the clamped taps all fall off the canvas
  tp.x0 = (int)fminf(fmaxf(fx0, -2.f), (float)(w + 1));
  tp.y0 = (int)fminf(fmaxf(fy0, -2.f), (float)(h + 1));
  const bool vx0 = tp.x0 >= 0 && tp.x0 < w, vx1 = tp.x0 + 1 >= 0 && tp.x0 + 1 < w;
  const bool vy0 = tp.y0 >= 0 && tp.y0 < h, vy1 = tp.y0 + 1 >= 0 && tp.y0 + 1 < h;
  tp.valid = (unsigned)(vy0 && vx0) | ((unsigned)(vy0 && vx1) << 1) |
             ((unsigned)(vy1 && vx0) << 2) | ((unsigned)(vy1 && vx1) << 3);
  tp.fill_add = 0.f;
  if (c.mode == 3) {
    const float cx = clamp01(fminf(__fadd_rn(sx, 1.f), __fsub_rn((float)w, sx)));
    const float cy = clamp01(fminf(__fadd_rn(sy, 1.f), __fsub_rn((float)h, sy)));
    tp.fill_add = __fmul_rn(__fsub_rn(1.f, __fmul_rn(cx, cy)), fill);
  }
  return tp;
}

// The f32 bank value of one channel: ((v00 ax) ay + (v01 wx) ay) + (v10 ax) wy) + (v11 wx) wy + fill
__device__ __forceinline__ float bilinear(const float* __restrict__ work, const Taps& tp, int w, int ci) {
  const long r0 = ((long)tp.y0 * w + tp.x0) * 3 + ci;
  const long r1 = r0 + (long)w * 3;
  const float v00 = (tp.valid & 1u) ? __ldg(work + r0) : 0.f;
  const float v01 = (tp.valid & 2u) ? __ldg(work + r0 + 3) : 0.f;
  const float v10 = (tp.valid & 4u) ? __ldg(work + r1) : 0.f;
  const float v11 = (tp.valid & 8u) ? __ldg(work + r1 + 3) : 0.f;
  float acc = __fmul_rn(__fmul_rn(v00, tp.ax), tp.ay);
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v01, tp.wx), tp.ay));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v10, tp.ax), tp.wy));
  acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(v11, tp.wx), tp.wy));
  return __fadd_rn(acc, tp.fill_add);
}

// The rungs' hats, as the JAX kernels build them: max(0, 1 - |t - u|) at
// u = floor(t) and floor(t) + 1 (ops/warp_batch.py _rung_taps).
struct Hats {
  float x0, x1, y0, y1;
};

__device__ __forceinline__ float hat(float t, float u) { return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(t, u)))); }

__device__ __forceinline__ Hats jax_hats(const Taps& tp) {
  const float fx0 = floorf(tp.tx), fy0 = floorf(tp.ty);
  return {hat(tp.tx, fx0), hat(tp.tx, __fadd_rn(fx0, 1.f)), hat(tp.ty, fy0), hat(tp.ty, __fadd_rn(fy0, 1.f))};
}

__device__ __forceinline__ float bfr(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float lo_part(float x) { return bfr(__fsub_rn(x, bfr(x))); }

// The jitter's forward state (ops/color.py jitter_planes, op by op in f32).
struct Hsv {
  float R, G, B, m1, maxc, n1, minc, md, s_raw, sd, rc, gc, bc, x, s2, f;
  int sector;
  bool gray, dark, on_r, on_g;
};

__device__ __forceinline__ Hsv hsv_state(float r, float g, float b, float hue, float sat) {
  Hsv q;
  q.R = clamp01(r);
  q.G = clamp01(g);
  q.B = clamp01(b);
  q.m1 = fmaxf(q.R, q.G);
  q.maxc = fmaxf(q.m1, q.B);
  q.n1 = fminf(q.R, q.G);
  q.minc = fminf(q.n1, q.B);
  const float delta = __fsub_rn(q.maxc, q.minc);
  q.gray = delta <= 1e-6f;
  q.dark = q.maxc <= 1e-6f;
  q.md = q.dark ? 1.f : q.maxc;
  q.s_raw = __fdiv_rn(delta, q.md);
  const float s = q.dark ? 0.f : q.s_raw;
  q.sd = q.gray ? 1.f : delta;
  q.rc = __fdiv_rn(__fsub_rn(q.maxc, q.R), q.sd);
  q.gc = __fdiv_rn(__fsub_rn(q.maxc, q.G), q.sd);
  q.bc = __fdiv_rn(__fsub_rn(q.maxc, q.B), q.sd);
  q.on_r = q.maxc == q.R;
  q.on_g = !q.on_r && q.maxc == q.G;
  float h = q.on_r ? __fsub_rn(q.bc, q.gc)
                   : (q.on_g ? __fsub_rn(__fadd_rn(2.f, q.rc), q.bc) : __fsub_rn(__fadd_rn(4.f, q.gc), q.rc));
  h = q.gray ? 0.f : rem_one(__fmul_rn(h, kInv6));
  h = rem_one(__fadd_rn(h, hue));
  q.x = __fmul_rn(s, sat);
  q.s2 = clamp01(q.x);
  const float h6 = __fmul_rn(h, 6.f);
  const float fl = floorf(h6);
  q.f = __fsub_rn(h6, fl);
  int sec = ((int)fl) % 6;
  q.sector = sec < 0 ? sec + 6 : sec;
  return q;
}

__device__ __forceinline__ void jitter_fwd(const Hsv& q, float& ro, float& go, float& bo) {
  const float v = q.maxc;
  const float p = __fmul_rn(v, __fsub_rn(1.f, q.s2));
  const float qq = __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(q.s2, q.f)));
  const float t = __fmul_rn(v, __fsub_rn(1.f, __fmul_rn(q.s2, __fsub_rn(1.f, q.f))));
  switch (q.sector) {
    case 0: ro = v; go = t; bo = p; break;
    case 1: ro = qq; go = v; bo = p; break;
    case 2: ro = p; go = v; bo = t; break;
    case 3: ro = p; go = qq; bo = v; break;
    case 4: ro = t; go = p; bo = v; break;
    default: ro = v; go = p; bo = qq; break;
  }
}

// gradient of maximum(a, b) to (a, b): halves at a tie
__device__ __forceinline__ void split_max(float a, float b, float g, float& ga, float& gb) {
  ga = a == b ? __fmul_rn(g, 0.5f) : (a > b ? g : 0.f);
  gb = a == b ? __fmul_rn(g, 0.5f) : (a < b ? g : 0.f);
}

// gradient of minimum(maximum(x, 0), 1) to x: halves at x == 0 and at x == 1
__device__ __forceinline__ float clip01_adjoint(float x, float g) {
  const float y = fmaxf(x, 0.f);
  const float gy = y == 1.f ? __fmul_rn(g, 0.5f) : (y < 1.f ? g : 0.f);
  return x == 0.f ? __fmul_rn(gy, 0.5f) : (x > 0.f ? gy : 0.f);
}

// ops/color.py jitter_planes_adjoint for one pixel, op by op in its order
// (before the inputs' clip): the gradients of the clipped R, G, B.
__device__ void jitter_adjoint(const Hsv& q, float sat, float gr, float gg, float gb,
                               float& dr, float& dg, float& db) {
  const float v = q.maxc;
  float g_v, g_p, g_q = 0.f, g_t = 0.f;
  switch (q.sector) {
    case 0: g_v = gr; g_t = gg; g_p = gb; break;
    case 1: g_q = gr; g_v = gg; g_p = gb; break;
    case 2: g_p = gr; g_v = gg; g_t = gb; break;
    case 3: g_p = gr; g_q = gg; g_v = gb; break;
    case 4: g_t = gr; g_p = gg; g_v = gb; break;
    default: g_v = gr; g_p = gg; g_q = gb; break;
  }
  const float s2 = q.s2, f = q.f;
  const float one_m_f = __fsub_rn(1.f, f);
  const float g_w = -__fmul_rn(g_q, v);
  const float g_u = -__fmul_rn(g_t, v);
  g_v = __fadd_rn(__fadd_rn(__fadd_rn(g_v, __fmul_rn(g_p, __fsub_rn(1.f, s2))),
                            __fmul_rn(g_q, __fsub_rn(1.f, __fmul_rn(s2, f)))),
                  __fmul_rn(g_t, __fsub_rn(1.f, __fmul_rn(s2, one_m_f))));
  const float g_s2 = __fadd_rn(__fadd_rn(-__fmul_rn(g_p, v), __fmul_rn(g_w, f)), __fmul_rn(g_u, one_m_f));
  const float g_f = __fsub_rn(__fmul_rn(g_w, s2), __fmul_rn(g_u, s2));
  const float g_h0 = __fmul_rn(q.gray ? 0.f : __fmul_rn(g_f, 6.f), kInv6);
  const bool on_b = !q.on_r && !q.on_g;
  const float g_rc = __fsub_rn(q.on_g ? g_h0 : 0.f, on_b ? g_h0 : 0.f);
  const float g_gc = __fsub_rn(on_b ? g_h0 : 0.f, q.on_r ? g_h0 : 0.f);
  const float g_bc = __fsub_rn(q.on_r ? g_h0 : 0.f, q.on_g ? g_h0 : 0.f);
  const float q_r = __fdiv_rn(g_rc, q.sd), q_g = __fdiv_rn(g_gc, q.sd), q_b = __fdiv_rn(g_bc, q.sd);
  float g_max = __fadd_rn(__fadd_rn(q_r, q_g), q_b);
  const float g_sd = __fsub_rn(__fsub_rn(__fmul_rn(-g_rc, __fdiv_rn(q.rc, q.sd)),
                                         __fmul_rn(g_gc, __fdiv_rn(q.gc, q.sd))),
                               __fmul_rn(g_bc, __fdiv_rn(q.bc, q.sd)));
  float g_delta = q.gray ? 0.f : g_sd;
  const float g_s = q.dark ? 0.f : __fmul_rn(clip01_adjoint(q.x, g_s2), sat);
  g_delta = __fadd_rn(g_delta, __fdiv_rn(g_s, q.md));
  const float g_sm = q.dark ? 0.f : __fmul_rn(-g_s, __fdiv_rn(q.s_raw, q.md));
  g_max = __fadd_rn(__fadd_rn(__fadd_rn(g_max, g_sm), g_delta), g_v);
  const float g_min = -g_delta;
  float g_m1, g_b3, g_r1, g_g1, g_n1, g_b4, g_r2, g_g2;
  split_max(q.m1, q.B, g_max, g_m1, g_b3);
  split_max(q.R, q.G, g_m1, g_r1, g_g1);
  split_max(q.B, q.n1, g_min, g_n1, g_b4);  // minimum(n1, B): the smaller takes it
  split_max(q.G, q.R, g_n1, g_r2, g_g2);    // minimum(R, G)
  dr = __fadd_rn(__fadd_rn(-q_r, g_r1), g_r2);
  dg = __fadd_rn(__fadd_rn(-q_g, g_g1), g_g2);
  db = __fadd_rn(__fadd_rn(-q_b, g_b3), g_b4);
}

// Each thread of K1 moves 8 bytes per load and store: 4 bf16 or 2 f32 pixels.
template <typename T> struct Vec {
  static constexpr int kN = 8 / sizeof(T);
};

template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ src, T (&dst)[Vec<T>::kN], bool vec, int count) {
  if (vec) {
    *reinterpret_cast<uint2*>(dst) = __ldg(reinterpret_cast<const uint2*>(src));
  } else {
#pragma unroll
    for (int k = 0; k < Vec<T>::kN; ++k)
      if (k < count) dst[k] = src[k];
  }
}

template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ dst, const T (&src)[Vec<T>::kN], bool vec, int count) {
  if (vec) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
  } else {
#pragma unroll
    for (int k = 0; k < Vec<T>::kN; ++k)
      if (k < count) dst[k] = src[k];
  }
}

// work (H, W, 3) f32; params (N, kParamStride) f32; z0..z2 (N, S, S) noise planes or null;
// out (N, 3, S, S); pre (N, 3, S, S) the rounded pre-jitter bank, written
// for the jittered cuts only (the backward reads no other), or null.  Each
// thread makes kN consecutive pixels of one cut.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bank_fwd_kernel(const float* __restrict__ work, const float* __restrict__ params, const T* __restrict__ z0,
                const T* __restrict__ z1, const T* __restrict__ z2, T* __restrict__ out, T* __restrict__ pre, int h,
                int w, int s, bool vec) {
  constexpr int kN = Vec<T>::kN;
  const int k = s * s;
  const int n = blockIdx.y;
  const int t0 = (blockIdx.x * blockDim.x + threadIdx.x) * kN;
  if (t0 >= k) return;
  const int count = min(kN, k - t0);
  const Cut c = load_cut(params, n);
  const bool noise = z0 != nullptr;
  const long plane = (long)n * k + t0;
  alignas(8) T zr[kN], zg[kN], zb[kN];
  if (noise) {
    load_vec(z0 + plane, zr, vec, count);
    load_vec(z1 + plane, zg, vec, count);
    load_vec(z2 + plane, zb, vec, count);
  }
  alignas(8) T o[3][kN], p[3][kN];
  int i = t0 / s, j = t0 - i * s;  // the first pixel, then stepped along the row
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    if (e >= count) break;
    const Taps tp = compute_taps(c, i, j, h, w, c.fill);
    float v[3];
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) {
      v[ci] = round_to<T>(bilinear(work, tp, w, ci));
      p[ci][e] = from_float<T>(v[ci]);
    }
    if (c.apply) {
      float jr, jg, jb;
      jitter_fwd(hsv_state(v[0], v[1], v[2], c.hue, c.sat), jr, jg, jb);
      v[0] = round_to<T>(jr);
      v[1] = round_to<T>(jg);
      v[2] = round_to<T>(jb);
    }
    if (noise) {
      const float zs[3] = {to_float(zr[e]), to_float(zg[e]), to_float(zb[e])};
#pragma unroll
      for (int ci = 0; ci < 3; ++ci)
        v[ci] = round_to<T>(__fadd_rn(v[ci], round_to<T>(__fmul_rn(c.fac, zs[ci]))));
    }
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) o[ci][e] = from_float<T>(v[ci]);
    if (++j == s) {
      j = 0;
      ++i;
    }
  }
  const long base = (long)n * 3 * k + t0;
#pragma unroll
  for (int ci = 0; ci < 3; ++ci) {
    store_vec(out + base + (long)ci * k, o[ci], vec, count);
    if (pre != nullptr && c.apply) store_vec(pre + base + (long)ci * k, p[ci], vec, count);
  }
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The post-epilogue cotangent of output pixel (i, j) of cut n: g, or for
// a jittered cut the jitter's adjoint (from the saved pre-jitter bank),
// then the inputs' clip and the rounding of the forward's .float().
template <typename T>
__device__ __forceinline__ void cotangent(const T* __restrict__ g, const T* __restrict__ pre, const Cut& c, long at,
                                          int k, float (&gv)[3]) {
#pragma unroll
  for (int ci = 0; ci < 3; ++ci) gv[ci] = to_float(g[at + (long)ci * k]);
  if (c.apply) {
    const float r = to_float(pre[at]), gr = to_float(pre[at + k]), b = to_float(pre[at + 2 * k]);
    float dr, dg, db;
    jitter_adjoint(hsv_state(r, gr, b, c.hue, c.sat), c.sat, gv[0], gv[1], gv[2], dr, dg, db);
    gv[0] = round_to<T>(clip01_adjoint(r, dr));
    gv[1] = round_to<T>(clip01_adjoint(gr, dg));
    gv[2] = round_to<T>(clip01_adjoint(b, db));
  }
}

// The float contribution of one tap at rung P (kHighest, kBf16, kHigh):
// a = the y weight, b = the x weight, gc the channel's cotangent.
template <int P>
__device__ __forceinline__ float tap_contrib(float a, float b, float gc) {
  if (P == kHighest) return __fmul_rn(__fmul_rn(gc, a), b);  // autograd's order for ((v b) a): (g a) b
  const float gb = __fmul_rn(b, gc);
  const float c = __fmul_rn(bfr(a), bfr(gb));
  if (P == kBf16) return c;
  return __fadd_rn(__fadd_rn(c, __fmul_rn(lo_part(a), bfr(gb))), __fmul_rn(bfr(a), lo_part(gb)));
}

// a signed int64 atomic sum: the two's complement of an unsigned one
__device__ __forceinline__ void add_to(unsigned long long* p, long long v) { atomicAdd(p, (unsigned long long)v); }

// The block's footprint on the canvas: the least and greatest x and y of
// its threads' taps on the canvas (xmax < xmin where none lies on it),
// uniform over the block.  red: 4 x (kThreads / 32) ints of shared memory;
// one barrier, which also publishes what the threads wrote before it.
struct Box {
  int xmin, ymin, xmax, ymax;
};

__device__ __forceinline__ Box block_box(const Taps& tp, int (*red)[kThreads / 32]) {
  Box b = {INT_MAX, INT_MAX, INT_MIN, INT_MIN};
  if (tp.valid) {
    b.xmin = (tp.valid & 0b0101u) ? tp.x0 : tp.x0 + 1;
    b.xmax = (tp.valid & 0b1010u) ? tp.x0 + 1 : tp.x0;
    b.ymin = (tp.valid & 0b0011u) ? tp.y0 : tp.y0 + 1;
    b.ymax = (tp.valid & 0b1100u) ? tp.y0 + 1 : tp.y0;
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  b.xmin = warp_min(b.xmin);
  b.ymin = warp_min(b.ymin);
  b.xmax = warp_max(b.xmax);
  b.ymax = warp_max(b.ymax);
  if (lane == 0) {
    red[0][wid] = b.xmin;
    red[1][wid] = b.ymin;
    red[2][wid] = b.xmax;
    red[3][wid] = b.ymax;
  }
  __syncthreads();
  b = {red[0][0], red[1][0], red[2][0], red[3][0]};
#pragma unroll
  for (int q = 1; q < kThreads / 32; ++q) {
    b.xmin = min(b.xmin, red[0][q]);
    b.ymin = min(b.ymin, red[1][q]);
    b.xmax = max(b.xmax, red[2][q]);
    b.ymax = max(b.ymax, red[3][q]);
  }
  return b;
}

// g (N, 3, S, S) cotangent; pre (N, 3, S, S) saved pre-jitter bank (read
// only for jittered cuts); dwork (H, W, 3) f32, zeroed by the caller;
// branches (2,) int or null: blocks that summed in shared memory, blocks
// that added to device memory, counted when given (a check, not the main
// path).  One block: one cut x one kTile x kTile output tile, one pixel per
// thread.  Eight blocks per SM (32 registers a thread) hide the atomics'
// latency best.
template <typename T>
__device__ __forceinline__ void bank_bwd_body(const T* __restrict__ g, const T* __restrict__ pre,
                                              const float* __restrict__ params, float* __restrict__ dwork,
                                              int* __restrict__ branches, int h, int w, int s) {
  __shared__ float acc[kSmemFloats];
  __shared__ int red[4][kThreads / 32];
  const int tiles_x = (s + kTile - 1) / kTile;
  const int i = (blockIdx.x / tiles_x) * kTile + threadIdx.x / kTile;
  const int j = (blockIdx.x % tiles_x) * kTile + threadIdx.x % kTile;
  const int n = blockIdx.y;
  const int k = s * s;
  const Cut c = load_cut(params, n);

  Taps tp;
  tp.valid = 0u;
  float gv[3];
  if (i < s && j < s) {
    tp = compute_taps(c, i, j, h, w, 0.f);
    cotangent(g, pre, c, (long)n * 3 * k + (long)i * s + j, k, gv);
  }
  const Box box = block_box(tp, red);
  if (box.xmax < box.xmin) return;  // no tap of this tile lies on the canvas (uniform over the block)
  const int fw = box.xmax - box.xmin + 1, fh = box.ymax - box.ymin + 1;
  const bool local = (long)fw * fh * 3 <= kSmemFloats;
  if (branches != nullptr && threadIdx.x == 0) atomicAdd(branches + (local ? 0 : 1), 1);
  if (local) {
    for (int q = threadIdx.x; q < fw * fh * 3; q += kThreads) acc[q] = 0.f;
    __syncthreads();
  }

  if (tp.valid) {
    const float wa[4] = {tp.ay, tp.ay, tp.wy, tp.wy}, wb[4] = {tp.ax, tp.wx, tp.ax, tp.wx};  // per tap: y, x weight
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      if (!(tp.valid & (1u << tap))) continue;
      const int x = tp.x0 + (tap & 1), y = tp.y0 + (tap >> 1);
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) {
        if (gv[ci] == 0.f) continue;
        const float contrib = tap_contrib<kHighest>(wa[tap], wb[tap], gv[ci]);
        if (local)
          atomicAdd(acc + ((y - box.ymin) * fw + (x - box.xmin)) * 3 + ci, contrib);
        else
          atomicAdd(dwork + ((long)y * w + x) * 3 + ci, contrib);
      }
    }
  }
  if (local) {
    __syncthreads();
    for (int q = threadIdx.x; q < fw * fh * 3; q += kThreads) {
      const float a = acc[q];
      if (a != 0.f) {
        const int cell = q / 3, ci = q - cell * 3;
        atomicAdd(dwork + ((long)(box.ymin + cell / fw) * w + (box.xmin + cell % fw)) * 3 + ci, a);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 8)
bank_bwd_kernel(const T* __restrict__ g, const T* __restrict__ pre, const float* __restrict__ params,
                float* __restrict__ dwork, int* __restrict__ branches, int h, int w, int s) {
  bank_bwd_body<T>(g, pre, params, dwork, branches, h, w, s);
}

// ------------------------------------------------------------------------
// K1-int8 and K2-bf16, designed for this card: the JAX package's default
// warp rungs (PIXRAY_TPU_WARP_PREC=int8 runs K1-int8 and, through
// norm_prec, K2-bf16; K2-bf16 also takes K1-bf16's saved bank).  They compute
// the same functions as the rungs' plain twins (ops/warp_batch.py
// warp_modes_rung "int8", warp_adjoint_rung "bf16") with the exact kernels'
// epilogue and its adjoint, but share no body with the exact kernels.
//
// bank_int8_scale_kernel + bank_int8_pack_kernel + bank_fwd_int8_kernel <-
// pallas_warp.py's int8 branch of _fwd_kernel_multi_T (:571-579), the canvas
// quantize of _run_fwd_multi_T (:821-827) and _finish_fwd's dequant (:650).
//   Bound: bytes, as K1's (the bank, the pre-jitter bank of the jittered
//   cuts, the noise planes); in practice the per-pixel arithmetic, as K1's.
//   What held the first version (the exact forward's body at this rung)
//   back: six eager kernels quantized the canvas in front of it, and each
//   output pixel made 12 scattered byte loads (four taps times three
//   interleaved channels).  The design: a scale pass takes max|work| as
//   kScaleBlocks partial maxima (no zeroed scalar, so no fill kernel in
//   front of it); a pack pass reduces them to s_w and quantizes the canvas
//   once, with quantize_canvas's operations in its order (a true division
//   by s_w, the product with 127, round-half-even), into one packed 32-bit
//   texel per canvas pixel (r, g, b as s8, a zero byte; 0.2 MB at 224x224,
//   L1- and L2-resident); K1-int8 then loads one texel per tap for all
//   three channels, 4 loads per output pixel instead of 12.  The y-hat
//   integer sums, the dequant and the epilogue are that version's
//   arithmetic, so the pre-jitter bank stays bitwise the plain twin's.
//   (Measured and dropped, PERF.md §6: each block quantizing its own canvas
//   footprint into shared memory, 2-D output tiles included, which
//   quantizes each canvas value some 20 times over and ran slower than the
//   first version.)
//
// bank_bwd_rows_kernel + bank_bwd_bf16_kernel + bank_bwd_sum_kernel <-
// _bwd_kernel_multi_TB through _mm_nt (:754-760), launched by
// _run_bwd_multi_TB (:764-806), whose band plan (_chunk_band_plan, :480) the
// row table takes the place of.
//   Bound: bytes, as K2's (the cotangent, the saved bank, the 0.6 MB
//   gradient).  What held the first version (the exact backward's body at
//   this rung) above it: every (cut, 16x16 tile) block summed in shared
//   memory and then issued one float atomicAdd to device memory per touched
//   canvas element, 64 cuts aiming at one canvas.
//   The TPU kernel has no such race: one dwork block is carried across its
//   sequential grid.  The design gives each part of the gradient one owner
//   again: the canvas is cut into bands of band_rows rows, and a pixel
//   belongs to the band of its upper tap row on the canvas, so its
//   cotangent (the epilogue's adjoint) is evaluated once.  A block owns one
//   band for a set of cuts: it keeps an f32 copy of the band, plus the row
//   below it (the halo), in shared memory, walks the output rows of its
//   cuts that can hold pixels of the band (from the row table: per cut and
//   output row, the least and the greatest canvas row that a tap on the
//   canvas reads, exact for every mode, since it comes from the same tap
//   code), and adds each pixel's four taps with shared-memory atomics.  A
//   thread block cluster of `cluster` blocks holds the band for `cluster`
//   cut sets: after a cluster barrier each block sums one slice of the band
//   over the cluster's copies (distributed shared memory, rank order) and
//   writes it with plain stores into its cluster's partial canvas; the sum
//   pass adds the `groups` partial canvases and the halo rows in a fixed
//   order.  No global atomic: each element of a partial canvas and of dwork
//   is written once, dwork is not zeroed first.
//   What it costs, measured (PERF.md §6, port_rungs.py): this kernel is
//   slower than that first version, more than twice at the flagship.  A
//   pixel's chain (the cotangent's loads, the adjoint's twelve IEEE
//   divisions, twelve shared-memory float atomics, which are
//   compare-and-swap loops on this card) is some thousands of cycles long;
//   the first version keeps one pixel per thread and 2,048 threads per SM,
//   these blocks walk their pixels in loops at 1,024 threads per SM; output
//   rows whose taps span several bands are walked by each (the row visits);
//   and the work of a band is uneven (a border cut clamped at the canvas
//   edge puts thousands of pixels on one band and one row of words).  Band
//   height, cluster size and groups: kBandRows, kBandCluster, kBandGroups,
//   from a sweep at the flagship and at 384 (PERF.md §6: more blocks per
//   band beat larger clusters; 16 groups against 32 were 3% slower at the
//   flagship and 6% faster at 384, with half the partial canvases' scratch,
//   10.8 MB at the flagship); a per-warp queue of the owned pixels,
//   warp-aggregated atomics, runs of rows as work units and a whole block
//   on one output row at a time each measured slower and were not kept.
//   The band is shrunk where it and its halo row would not fit
//   kBandSmemMax.
// ------------------------------------------------------------------------

constexpr int kScaleBlocks = 256;            // K1-int8's scale pass: blocks, one partial maximum each
constexpr int kBandRows = 8;                 // K2-bf16: canvas rows per band
constexpr int kBandCluster = 2;              // K2-bf16: blocks per cluster (up to the portable 8)
constexpr int kBandGroups = 16;              // K2-bf16: clusters (cut groups, partial canvases) per band
constexpr int kBandSmemMax = 200 * 1024;     // K2-bf16: the largest band copy a block keeps
static_assert(kScaleBlocks <= kThreads, "one partial maximum per thread of K1-int8");

__device__ __forceinline__ float warp_fmax(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// K1-int8's first pass: partial[b] = max |work| over block b's grid-stride
// share of the canvas (count floats, 16 bytes a load where aligned);
// kScaleBlocks blocks.
__global__ void __launch_bounds__(kThreads)
bank_int8_scale_kernel(const float* __restrict__ work, float* __restrict__ partial, long count) {
  __shared__ float red[kThreads / 32];
  const long first = (long)blockIdx.x * kThreads + threadIdx.x, stride = (long)gridDim.x * kThreads;
  const long quads = ((uintptr_t)work & 15u) == 0 ? count / 4 : 0;
  float m = 0.f;
  for (long q = first; q < quads; q += stride) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(work) + q);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  for (long q = quads * 4 + first; q < count; q += stride) m = fmaxf(m, fabsf(__ldg(work + q)));
  m = warp_fmax(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 1; q < kThreads / 32; ++q) m = fmaxf(m, red[q]);
    partial[blockIdx.x] = m;
  }
}

// one canvas value's s8 code, as quantize_canvas computes it: round(v / s_w * 127)
__device__ __forceinline__ unsigned quant_byte(float v, float s_w) {
  return (unsigned)((int)rintf(__fmul_rn(__fdiv_rn(v, s_w), kQ)) & 0xff);
}

// one canvas pixel's packed texel: the codes of r, g, b in bytes 0, 1, 2 (ops/warp_batch.py pack_texels)
__device__ __forceinline__ unsigned pack_texel(const float* __restrict__ px, float s_w) {
  return quant_byte(__ldg(px), s_w) | (quant_byte(__ldg(px + 1), s_w) << 8) | (quant_byte(__ldg(px + 2), s_w) << 16);
}

__device__ __forceinline__ int texel_code(unsigned t, int ci) { return (int)(signed char)(t >> (8 * ci)); }

// K1-int8's second pass: the canvas quantized once, as packed texels
// (texels[p] = pack_texel of canvas pixel p), with s_w = max(max|work|,
// 1e-6) from the first pass's partial maxima, which it also stores in
// scale[kScaleBlocks] for K1-int8.  One pixel per thread.
__global__ void __launch_bounds__(kThreads)
bank_int8_pack_kernel(const float* __restrict__ work, float* __restrict__ scale, unsigned* __restrict__ texels,
                      long pixels) {
  __shared__ float sred[kThreads / 32];
  float m = warp_fmax(threadIdx.x < kScaleBlocks ? scale[threadIdx.x] : 0.f);
  if ((threadIdx.x & 31) == 0) sred[threadIdx.x >> 5] = m;
  __syncthreads();
  m = sred[0];
#pragma unroll
  for (int r = 1; r < kThreads / 32; ++r) m = fmaxf(m, sred[r]);
  const float s_w = fmaxf(m, 1e-6f);
  if (blockIdx.x == 0 && threadIdx.x == 0) scale[kScaleBlocks] = s_w;
  const long p = (long)blockIdx.x * kThreads + threadIdx.x;
  if (p < pixels) texels[p] = pack_texel(work + p * 3, s_w);
}

// texels (H, W) the packed canvas and scale[kScaleBlocks] its s_w, from
// bank_int8_pack_kernel; params, z0..z2, out, pre, vec as bank_fwd_kernel.
// Each thread makes kN consecutive pixels of one cut, as bank_fwd_kernel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bank_fwd_int8_kernel(const unsigned* __restrict__ texels, const float* __restrict__ scale_src,
                     const float* __restrict__ params, const T* __restrict__ z0, const T* __restrict__ z1,
                     const T* __restrict__ z2, T* __restrict__ out, T* __restrict__ pre, int h, int w, int s,
                     bool vec) {
  constexpr int kN = Vec<T>::kN;
  const int k = s * s;
  const int n = blockIdx.y;
  const int t0 = (blockIdx.x * blockDim.x + threadIdx.x) * kN;
  if (t0 >= k) return;
  const int count = min(kN, k - t0);
  const Cut c = load_cut(params, n);
  const float scale = __fdiv_rn(__ldg(scale_src + kScaleBlocks), kDequant);  // s_w / 127^2 (:824-826)
  const float fillq = __fdiv_rn(c.fill, scale);                             // the fill over it
  const bool noise = z0 != nullptr;
  const long plane = (long)n * k + t0;
  alignas(8) T zr[kN], zg[kN], zb[kN];
  if (noise) {
    load_vec(z0 + plane, zr, vec, count);
    load_vec(z1 + plane, zg, vec, count);
    load_vec(z2 + plane, zb, vec, count);
  }
  alignas(8) T o[3][kN], p[3][kN];
  int i = t0 / s, j = t0 - i * s;  // the first pixel, then stepped along the row
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    if (e >= count) break;
    const Taps tp = compute_taps(c, i, j, h, w, fillq);
    const Hats ht = jax_hats(tp);
    const int a0 = (int)rintf(__fmul_rn(ht.y0, kQ)), a1 = (int)rintf(__fmul_rn(ht.y1, kQ));
    const long at = (long)tp.y0 * w + tp.x0;  // one load per tap for all three channels
    const unsigned v00 = (tp.valid & 1u) ? __ldg(texels + at) : 0u;
    const unsigned v01 = (tp.valid & 2u) ? __ldg(texels + at + 1) : 0u;
    const unsigned v10 = (tp.valid & 4u) ? __ldg(texels + at + w) : 0u;
    const unsigned v11 = (tp.valid & 8u) ? __ldg(texels + at + w + 1) : 0u;
    float v[3];
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) {
      const float c0 = (float)(a0 * texel_code(v00, ci) + a1 * texel_code(v10, ci));
      const float c1 = (float)(a0 * texel_code(v01, ci) + a1 * texel_code(v11, ci));
      const float acc = __fadd_rn(__fadd_rn(__fmul_rn(c0, ht.x0), __fmul_rn(c1, ht.x1)), tp.fill_add);
      v[ci] = round_to<T>(__fmul_rn(acc, scale));
      p[ci][e] = from_float<T>(v[ci]);
    }
    if (c.apply) {
      float jr, jg, jb;
      jitter_fwd(hsv_state(v[0], v[1], v[2], c.hue, c.sat), jr, jg, jb);
      v[0] = round_to<T>(jr);
      v[1] = round_to<T>(jg);
      v[2] = round_to<T>(jb);
    }
    if (noise) {
      const float zs[3] = {to_float(zr[e]), to_float(zg[e]), to_float(zb[e])};
#pragma unroll
      for (int ci = 0; ci < 3; ++ci)
        v[ci] = round_to<T>(__fadd_rn(v[ci], round_to<T>(__fmul_rn(c.fac, zs[ci]))));
    }
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) o[ci][e] = from_float<T>(v[ci]);
    if (++j == s) {
      j = 0;
      ++i;
    }
  }
  const long base = (long)n * 3 * k + t0;
#pragma unroll
  for (int ci = 0; ci < 3; ++ci) {
    store_vec(out + base + (long)ci * k, o[ci], vec, count);
    if (pre != nullptr && c.apply) store_vec(pre + base + (long)ci * k, p[ci], vec, count);
  }
}

// K2-bf16's first pass: rows[n * S + i] = (least, greatest) canvas row that
// a tap on the canvas of output row i of cut n reads, (INT_MAX, INT_MIN) for
// a row with none (ops/warp_batch.py tap_row_ranges).  One warp per row.
__global__ void __launch_bounds__(kThreads)
bank_bwd_rows_kernel(const float* __restrict__ params, int2* __restrict__ rows, int n, int h, int w, int s) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= n * s) return;  // a whole warp
  const int cn = row / s, i = row - cn * s;
  const Cut c = load_cut(params, cn);
  int lo = INT_MAX, hi = INT_MIN;
  for (int j = lane; j < s; j += 32) {
    const Taps tp = compute_taps(c, i, j, h, w, 0.f);
    if (tp.valid) {
      lo = min(lo, (tp.valid & 0b0011u) ? tp.y0 : tp.y0 + 1);
      hi = max(hi, (tp.valid & 0b1100u) ? tp.y0 + 1 : tp.y0);
    }
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  if (lane == 0) rows[row] = make_int2(lo, hi);
}

// g, pre, params as bank_bwd_body; rows the row table; partial (groups,
// H + bands, W, 3) f32: rows 0..H-1 of partial[k] the sums of cut group k
// over the canvas, row H + b the sums its band b adds to the row below the
// band (the halo row); bank_bwd_sum_kernel adds them up.  branches (2,)
// int or null: row visits and pixel visits.  Grid: per band of band_rows
// canvas rows, `groups` clusters of cluster.num_blocks() blocks; block r
// of cluster k takes the cuts k C + r, k C + r + groups C, ... (C the
// cluster size).  Dynamic shared memory: (band_rows + 1) x W x 3 floats.
// A pixel belongs to the band of its upper tap row on the canvas, so its
// cotangent is computed once; its lower taps may land in the halo row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bank_bwd_bf16_kernel(const T* __restrict__ g, const T* __restrict__ pre, const float* __restrict__ params,
                     const int2* __restrict__ rows, float* __restrict__ partial, int* __restrict__ branches, int n,
                     int h, int w, int s, int band_rows, int groups) {
  extern __shared__ float band_acc[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int cid = blockIdx.x / csize;
  const int band = cid / groups, group = cid - band * groups;
  const int bands = (h + band_rows - 1) / band_rows;
  const int lo = band * band_rows;
  const int hi = min(lo + band_rows, h) - 1;
  const int inner = (hi - lo + 1) * w * 3, elems = inner + w * 3;
  for (int q = threadIdx.x; q < elems; q += kThreads) band_acc[q] = 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = s * s;
  int visits = 0, pixels = 0;
  for (int cn = group * csize + rank; cn < n; cn += groups * csize) {
    const Cut c = load_cut(params, cn);
    // warp `warp` takes the rows warp, warp + 8, ... of the cut that touch the band, 32 at a time
    for (int first = warp; first < s; first += 32 * (kThreads / 32)) {
      const int i0 = first + (kThreads / 32) * lane;
      bool hit = false;
      if (i0 < s) {
        const int2 r = __ldg(rows + (long)cn * s + i0);
        hit = r.x <= hi && r.y >= lo;
      }
      unsigned mask = __ballot_sync(0xffffffffu, hit);
      while (mask) {
        const int b = __ffs(mask) - 1;
        mask &= mask - 1;
        const int i = first + (kThreads / 32) * b;
        ++visits;
        for (int j = lane; j < s; j += 32) {
          const Taps tp = compute_taps(c, i, j, h, w, 0.f);
          const int own = (tp.valid & 0b0011u) ? tp.y0 : tp.y0 + 1;
          if (!tp.valid || own < lo || own > hi) continue;
          ++pixels;
          float gv[3];
          cotangent(g, pre, c, (long)cn * 3 * k + (long)i * s + j, k, gv);
          const Hats ht = jax_hats(tp);
#pragma unroll
          for (int tap = 0; tap < 4; ++tap) {
            if (!(tp.valid & (1u << tap))) continue;
            const int x = tp.x0 + (tap & 1), y = tp.y0 + (tap >> 1);
            const float wa = (tap >> 1) ? ht.y1 : ht.y0, wb = (tap & 1) ? ht.x1 : ht.x0;
            float* cell = band_acc + ((y - lo) * w + x) * 3;
#pragma unroll
            for (int ci = 0; ci < 3; ++ci)
              if (gv[ci] != 0.f) atomicAdd(cell + ci, tap_contrib<kBf16>(wa, wb, gv[ci]));
          }
        }
      }
    }
  }
  if (branches != nullptr) {
    pixels = warp_sum(pixels);
    if (lane == 0) {
      atomicAdd(branches, visits);
      atomicAdd(branches + 1, pixels);
    }
  }
  cluster.sync();
  // each block sums one slice of the band (and its halo row) over the cluster's copies, in rank order
  float* dst = partial + (long)group * (h + bands) * w * 3;
  const int per = (elems + csize - 1) / csize;
  const int q0 = rank * per, q1 = min(elems, q0 + per);
  for (int q = q0 + threadIdx.x; q < q1; q += kThreads) {
    float sum = 0.f;
    for (int r = 0; r < csize; ++r) sum = __fadd_rn(sum, cluster.map_shared_rank(band_acc, r)[q]);
    dst[q < inner ? (long)lo * w * 3 + q : (long)(h + band) * w * 3 + (q - inner)] = sum;
  }
  cluster.sync();  // no block leaves while a peer still reads its copy
}

// K2-bf16's last pass: dwork = the sum over the cut groups' partial canvases
// and, on the first row of each band but the first, the halo rows of the
// band above, in a fixed order.  One canvas element per thread.
__global__ void __launch_bounds__(kThreads)
bank_bwd_sum_kernel(const float* __restrict__ partial, float* __restrict__ dwork, int groups, int h, int w,
                    int band_rows) {
  const long row = (long)w * 3;
  const long q = (long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= h * row) return;
  const int y = (int)(q / row);
  const long stride = (long)(h + (h + band_rows - 1) / band_rows) * row;
  const bool halo = y > 0 && y % band_rows == 0;
  const long from = (long)(h + y / band_rows - 1) * row + (q - y * row);
  float sum = 0.f;
  for (int kk = 0; kk < groups; ++kk) {
    sum = __fadd_rn(sum, __ldg(partial + kk * stride + q));
    if (halo) sum = __fadd_rn(sum, __ldg(partial + kk * stride + from));
  }
  dwork[q] = sum;
}

// ------------------------------------------------------------------------
// K2-int8 and K2-high, designed for this card: the rung backwards that
// first ran on the exact backward's body (bank_bwd_body at kInt8 and
// kHigh).  Same functions as their plain twins (ops/warp_batch.py
// warp_adjoint_rung "int8" and "high", from the exact kernels' cotangent).
//
// bank_bwd_cot_kernel + bank_bwd_int8_kernel + bank_bwd_int8_finish_kernel
// <- pallas_warp.py's int8 branch of _bwd_kernel_multi_TB (:718-743), the
// per-tensor cotangent scale of _run_bwd_multi_TB (:777-782) and its
// dequant (:803-804).
//   Bound: bytes, as K2's (the cotangent, the saved bank, the gradient)
//   for the three passes; the scatter's own: the cotangent bank or g, the
//   partial maxima and the int64 canvas.  What held the first version
//   back: a max pass evaluated the whole
//   post-epilogue cotangent (the jitter's adjoint, twelve IEEE divisions a
//   pixel) only to take max|g|, and the scatter evaluated it a second time;
//   two fill kernels zeroed the int64 canvas and the maximum in front of
//   them.  The design: the cotangent pass evaluates it once per pixel,
//   writes it in the bank's dtype for the jittered cuts (the others'
//   cotangent is g itself, already in memory; bf16 holds the rounded value
//   exactly) and leaves kCotBlocks partial maxima (no zeroed scalar); it
//   also zeroes the int64 canvas, so no fill kernel runs.  Its blocks each
//   take one contiguous run of the bank's pixels; kCotBlocks and the
//   32-register cap were measured against 256 to 4096 blocks and 40 or 48
//   registers (PERF.md §6: more blocks than the card holds at once, so that
//   the last wave is short).  The scatter reads 6 bytes a pixel (the
//   cotangent bank or g), reduces the partial maxima to s_g in every block
//   (block 0 stores it for the last pass), and sums integers: in shared
//   memory with native 32-bit integer atomics for footprints of up to
//   kInt8SmemInts values (integer atomics need no compare-and-swap loop, so
//   the budget can be larger than the float body's kSmemFloats; 6,144
//   measured against 2,048, 10,240 and none), then one int64 atomic per
//   touched element; int64 atomics to device memory otherwise.  Integer
//   sums are exact, so the result is order-free and bitwise the plain
//   twin's.  The finish pass writes float(sum) s_g / 127^2.
//
// bank_bwd_high_kernel + bank_bwd_high_pack_kernel <- _bwd_kernel_multi_TB
// through _mm_nt's hi/lo form (:930-944).
//   Bound: bytes, as K2's.  What held the first version back: per pixel
//   twelve shared-memory float atomics (compare-and-swap loops on this card,
//   retried when neighbouring pixels of a zoomed-in cut hit one texel), the
//   block-wide footprint reduction and barriers around them, and 32
//   registers a thread (spills).  The design drops shared memory: each tap
//   adds its three channels with one vector reduction
//   (red.global.add.v4.f32, sm_90) into an (H, W, 4) f32 canvas whose
//   fourth lane takes 0, which L2 performs without a loop; the pack pass
//   writes its first three lanes to dwork.  One pixel per thread, no
//   barrier, at most 40 registers (6 blocks per SM).  Measured and dropped
//   (PERF.md §6): a v2 and a scalar reduction a tap straight into dwork,
//   summing the taps of a run of lanes on one texel with warp shuffles
//   first, and caps of 32 and 255 registers.
// ------------------------------------------------------------------------

constexpr int kCotBlocks = 2048;      // K2-int8's cotangent pass: blocks, one partial maximum each
constexpr int kCotBlocksPerSm = 8;    // ... at most 32 registers a thread (spills, but faster: PERF.md §6)
constexpr int kInt8SmemInts = 6144;   // K2-int8's footprint budget: 24 KB of int32 sums, a 45 x 45 canvas patch
constexpr int kHighBlocksPerSm = 6;   // K2-high: at most 40 registers a thread (PERF.md §6)

// K2-int8's first pass: cot (N, 3, S, S) the post-epilogue cotangent of
// the jittered cuts (rows of other cuts left unwritten; null when no cut is
// jittered), partial[b] = max |cotangent| over block b's share of the bank
// (every pixel, on the canvas or not), and acc (acc_count int64) zeroed.
// kCotBlocks blocks; block b takes one contiguous run of the bank's pixels.
template <typename T>
__global__ void __launch_bounds__(kThreads, kCotBlocksPerSm)
bank_bwd_cot_kernel(const T* __restrict__ g, const T* __restrict__ pre, const float* __restrict__ params,
                    T* __restrict__ cot, float* __restrict__ partial, unsigned long long* __restrict__ acc,
                    long acc_count, int n, int s) {
  const long tid = (long)blockIdx.x * kThreads + threadIdx.x, stride = (long)gridDim.x * kThreads;
  for (long q = tid; q < acc_count / 2; q += stride) reinterpret_cast<ulonglong2*>(acc)[q] = make_ulonglong2(0, 0);
  if (tid == 0 && (acc_count & 1)) acc[acc_count - 1] = 0;
  __shared__ float red[kThreads / 32];
  const int k = s * s, total = n * k;  // the caller keeps n S^2 below 2^31
  const int per = (total + kCotBlocks - 1) / kCotBlocks, last = min(total, (int)(blockIdx.x + 1) * per);
  int p = blockIdx.x * per + threadIdx.x;
  int cn = p / k, q = p - cn * k;  // the pixel's cut and its offset in the plane, then stepped
  float m = 0.f;
  for (; p < last; p += kThreads, q += kThreads) {
    while (q >= k) {
      q -= k;
      ++cn;
    }
    const Cut c = load_cut(params, cn);
    const long at = (long)cn * 3 * k + q;
    float gv[3];
    cotangent(g, pre, c, at, k, gv);
    if (c.apply) {
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) cot[at + (long)ci * k] = from_float<T>(gv[ci]);
    }
    m = fmaxf(m, fmaxf(fmaxf(fabsf(gv[0]), fabsf(gv[1])), fabsf(gv[2])));
  }
  m = warp_fmax(m);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 1; q < kThreads / 32; ++q) m = fmaxf(m, red[q]);
    partial[blockIdx.x] = m;
  }
}

// g, params as bank_bwd_body; cot the first pass's cotangent bank (read
// for the jittered cuts, g for the others); partial (kCotBlocks + 1) its
// partial maxima, s_g stored after them; acc (H, W, 3) int64, zeroed by the
// first pass; branches as bank_bwd_body.  Grid and tiles as bank_bwd_body.
template <typename T>
__global__ void __launch_bounds__(kThreads, 8)
bank_bwd_int8_kernel(const T* __restrict__ g, const T* __restrict__ cot, const float* __restrict__ params,
                     float* __restrict__ partial, unsigned long long* __restrict__ acc, int* __restrict__ branches,
                     int h, int w, int s) {
  __shared__ int sums[kInt8SmemInts];
  __shared__ int red[4][kThreads / 32];
  __shared__ float mred[kThreads / 32];
  float m = 0.f;
  for (int q = threadIdx.x; q < kCotBlocks; q += kThreads) m = fmaxf(m, __ldg(partial + q));
  const int tiles_x = (s + kTile - 1) / kTile;
  const int i = (blockIdx.x / tiles_x) * kTile + threadIdx.x / kTile;
  const int j = (blockIdx.x % tiles_x) * kTile + threadIdx.x % kTile;
  const int n = blockIdx.y;
  const int k = s * s;
  const Cut c = load_cut(params, n);
  Taps tp;
  tp.valid = 0u;
  float gv[3] = {0.f, 0.f, 0.f};
  if (i < s && j < s) {
    tp = compute_taps(c, i, j, h, w, 0.f);
    if (tp.valid) {
      const T* src = c.apply ? cot : g;
      const long at = (long)n * 3 * k + (long)i * s + j;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) gv[ci] = to_float(src[at + (long)ci * k]);
    }
  }
  m = warp_fmax(m);
  if ((threadIdx.x & 31) == 0) mred[threadIdx.x >> 5] = m;
  const Box box = block_box(tp, red);  // its barrier also publishes mred
  m = mred[0];
#pragma unroll
  for (int q = 1; q < kThreads / 32; ++q) m = fmaxf(m, mred[q]);
  const float sg = fmaxf(m, 1e-20f);
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) partial[kCotBlocks] = sg;
  if (box.xmax < box.xmin) return;  // no tap of this tile lies on the canvas (uniform over the block)
  const int fw = box.xmax - box.xmin + 1, fh = box.ymax - box.ymin + 1;
  const bool local = (long)fw * fh * 3 <= kInt8SmemInts;
  if (branches != nullptr && threadIdx.x == 0) atomicAdd(branches + (local ? 0 : 1), 1);
  if (local) {
    for (int q = threadIdx.x; q < fw * fh * 3; q += kThreads) sums[q] = 0;
    __syncthreads();
  }
  if (tp.valid) {
    const Hats ht = jax_hats(tp);
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) gv[ci] = __fdiv_rn(gv[ci], sg);
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      if (!(tp.valid & (1u << tap))) continue;
      const int x = tp.x0 + (tap & 1), y = tp.y0 + (tap >> 1);
      const float wa = (tap >> 1) ? ht.y1 : ht.y0, wb = (tap & 1) ? ht.x1 : ht.x0;
      const int bq = (int)rintf(__fmul_rn(wb, kQ));
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) {
        if (gv[ci] == 0.f) continue;
        const int contrib = (int)rintf(__fmul_rn(__fmul_rn(wa, gv[ci]), kQ)) * bq;
        if (local)
          atomicAdd(sums + ((y - box.ymin) * fw + (x - box.xmin)) * 3 + ci, contrib);
        else
          add_to(acc + ((long)y * w + x) * 3 + ci, (long long)contrib);
      }
    }
  }
  if (local) {
    __syncthreads();
    for (int q = threadIdx.x; q < fw * fh * 3; q += kThreads) {
      const int a = sums[q];
      if (a != 0) {
        const int cell = q / 3, ci = q - cell * 3;
        add_to(acc + ((long)(box.ymin + cell / fw) * w + (box.xmin + cell % fw)) * 3 + ci, (long long)a);
      }
    }
  }
}

// K2-int8's last pass: dwork = float(acc) * (s_g / 127^2), s_g from partial[kCotBlocks].
__global__ void __launch_bounds__(kThreads)
bank_bwd_int8_finish_kernel(const long long* __restrict__ acc, const float* __restrict__ partial,
                            float* __restrict__ dwork, long count) {
  const long q = (long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= count) return;
  const float scale = __fdiv_rn(__ldg(partial + kCotBlocks), kDequant);
  dwork[q] = __fmul_rn(__ll2float_rn(acc[q]), scale);
}

// one vector reduction (sm_90) of a texel's three channels, and 0 in the fourth lane, into 16-byte aligned
// device memory
__device__ __forceinline__ void red_add_texel(float* p, float r, float g, float b) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(r), "f"(g), "f"(b), "f"(0.f) : "memory");
}

// g, pre, params as bank_bwd_body; acc (H, W, 4) f32, zeroed by the caller.
// Grid (ceil(S^2 / kThreads), N): one output pixel of one cut per thread,
// row-major.
template <typename T>
__global__ void __launch_bounds__(kThreads, kHighBlocksPerSm)
bank_bwd_high_kernel(const T* __restrict__ g, const T* __restrict__ pre, const float* __restrict__ params,
                     float* __restrict__ acc, int h, int w, int s) {
  const int k = s * s, n = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= k) return;
  const int i = p / s, j = p - i * s;
  const Cut c = load_cut(params, n);
  const Taps tp = compute_taps(c, i, j, h, w, 0.f);
  if (!tp.valid) return;
  float gv[3];
  cotangent(g, pre, c, (long)n * 3 * k + p, k, gv);
  if (gv[0] == 0.f && gv[1] == 0.f && gv[2] == 0.f) return;
  const Hats ht = jax_hats(tp);
#pragma unroll
  for (int tap = 0; tap < 4; ++tap) {
    if (!(tp.valid & (1u << tap))) continue;
    const long cell = (long)(tp.y0 + (tap >> 1)) * w + tp.x0 + (tap & 1);
    const float wa = (tap >> 1) ? ht.y1 : ht.y0, wb = (tap & 1) ? ht.x1 : ht.x0;
    red_add_texel(acc + cell * 4, tap_contrib<kHigh>(wa, wb, gv[0]), tap_contrib<kHigh>(wa, wb, gv[1]),
                  tap_contrib<kHigh>(wa, wb, gv[2]));
  }
}

// K2-high's last pass: dwork (H, W, 3) = the first three lanes of acc (H, W, 4).
__global__ void __launch_bounds__(kThreads)
bank_bwd_high_pack_kernel(const float4* __restrict__ acc, float* __restrict__ dwork, long pixels) {
  const long q = (long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= pixels) return;
  const float4 v = __ldg(acc + q);
  dwork[q * 3] = v.x;
  dwork[q * 3 + 1] = v.y;
  dwork[q * 3 + 2] = v.z;
}

// ------------------------------------------------------------------------
// K1-bf16 and K1-high, designed for this card: the forward rungs that first
// ran on the exact forward's body (its loop with the taps of a rung in place
// of bilinear).  Same functions as their plain twins (ops/warp_batch.py
// warp_modes_rung "bf16" and "high") with the exact kernel's epilogue.
//
// bank_bf16_pack_kernel + bank_fwd_bf16_kernel, bank_high_pack_kernel +
// bank_fwd_high_kernel <- pallas_warp.py's float branch of
// _fwd_kernel_multi_T (:586-589) through _mm (:61-77) at "bf16" and
// "high", launched by _run_fwd_multi_T (:808); through norm_prec,
// K1-bf16 is also the single-mode warp's forward (_fwd_kernel, :188) at
// the bf16 and int8 rungs.
//   Bound: bytes, as K1's (the bank, the pre-jitter bank of the jittered
//   cuts, the noise planes; the f32 canvas read once); in practice the
//   per-pixel arithmetic, as K1's.  What held the first version back: each
//   output pixel made 12 scattered f32 loads (four taps times three
//   interleaved channels) and split every tap value to bf16 in the hot
//   loop (12 splits a pixel for bf16; 24 for high, whose lo part is a
//   subtraction and two conversions more), at 64 and 68 registers (the
//   bf16 bank's: 3 blocks an SM, not 4).  The design: a pack pass splits
//   the canvas once, as _mm splits its a into a_hi and a_lo
//   (ops/warp_batch.py pack_bf16_texels), into one texel per canvas pixel
//   (bf16: 8 bytes, bf16(r), bf16(g), bf16(b), 0; high: 16 bytes, those
//   three, then lo = bf16(x - bf16(x)) of each channel, then two zeros;
//   0.4 / 0.8 MB at 224x224, L2-resident); the kernel loads one texel per
//   tap for all three channels (4 vector loads a pixel instead of 12),
//   splits each y hat once a pixel for the three channels, and forms each
//   column's sum of two bf16 products with one FMA: such a product is exact
//   in f32 (16 significant bits; while it stays above 2^-134, i.e. for
//   canvas values of magnitude 2^-110 and above, or 0), so fmaf(a, b, c d)
//   rounds once where a b + c d did.  The x-hat products, the fill term and
//   high's (d1 + d2) + d3 keep their order and their roundings (those
//   products are not exact), so the pre-jitter bank stays bitwise the plain
//   twin's.  kBf16FwdBlocksPerSm and kHighFwdBlocksPerSm from a sweep (PERF.md §6).
// ------------------------------------------------------------------------

constexpr int kBf16FwdBlocksPerSm = 4;  // K1-bf16: at most 64 registers a thread (60 / 62, no spill)
constexpr int kHighFwdBlocksPerSm = 5;  // K1-high: at most 48 (spills 12 / 20 B; at 64 none, but slower)

template <int P> using RungTexel = std::conditional_t<P == kHigh, uint4, uint2>;

__device__ __forceinline__ unsigned bf16_bits(float x) { return __bfloat16_as_ushort(__float2bfloat16_rn(x)); }

// word q of a texel
__device__ __forceinline__ unsigned texel_word(const uint2& t, int q) { return q == 0 ? t.x : t.y; }
__device__ __forceinline__ unsigned texel_word(const uint4& t, int q) {
  return q == 0 ? t.x : (q == 1 ? t.y : (q == 2 ? t.z : t.w));
}

// bf16 k of a texel (k = ci the hi part of channel ci, 3 + ci its lo part), widened to f32
template <typename V> __device__ __forceinline__ float texel_value(const V& t, int k) {
  const unsigned word = texel_word(t, k >> 1);
  return __uint_as_float((k & 1) ? (word & 0xffff0000u) : (word << 16));
}

// canvas pixel p's texel at rung P (ops/warp_batch.py pack_bf16_texels)
template <int P>
__device__ __forceinline__ RungTexel<P> rung_texel(const float* __restrict__ px) {
  const float r = __ldg(px), g = __ldg(px + 1), b = __ldg(px + 2);
  const unsigned hr = bf16_bits(r), hg = bf16_bits(g), hb = bf16_bits(b);
  if constexpr (P == kBf16) {
    return make_uint2(hr | (hg << 16), hb);
  } else {
    const unsigned lr = bf16_bits(__fsub_rn(r, __uint_as_float(hr << 16)));
    const unsigned lg = bf16_bits(__fsub_rn(g, __uint_as_float(hg << 16)));
    const unsigned lb = bf16_bits(__fsub_rn(b, __uint_as_float(hb << 16)));
    return make_uint4(hr | (hg << 16), hb | (lr << 16), lg | (lb << 16), 0u);
  }
}

// K1-bf16's and K1-high's pass: texels[p] = the texel of canvas pixel p.  One pixel per thread.
__global__ void __launch_bounds__(kThreads)
bank_bf16_pack_kernel(const float* __restrict__ work, uint2* __restrict__ texels, long pixels) {
  const long p = (long)blockIdx.x * kThreads + threadIdx.x;
  if (p < pixels) texels[p] = rung_texel<kBf16>(work + p * 3);
}

__global__ void __launch_bounds__(kThreads)
bank_high_pack_kernel(const float* __restrict__ work, uint4* __restrict__ texels, long pixels) {
  const long p = (long)blockIdx.x * kThreads + threadIdx.x;
  if (p < pixels) texels[p] = rung_texel<kHigh>(work + p * 3);
}

// a b + c d, both exact products of bf16 values (see the note above): one rounding
__device__ __forceinline__ float dot2(float a, float b, float c, float d) { return fmaf(a, b, __fmul_rn(c, d)); }

// texels (H, W) of the pack pass; params, z0..z2, out, pre, vec as
// bank_fwd_kernel.  Each thread makes kN consecutive pixels of one cut, as
// bank_fwd_kernel.
template <typename T, int P>
__device__ __forceinline__ void bank_fwd_rung_body(const RungTexel<P>* __restrict__ texels,
                                                   const float* __restrict__ params, const T* __restrict__ z0,
                                                   const T* __restrict__ z1, const T* __restrict__ z2,
                                                   T* __restrict__ out, T* __restrict__ pre, int h, int w, int s,
                                                   bool vec) {
  constexpr int kN = Vec<T>::kN;
  const int k = s * s;
  const int n = blockIdx.y;
  const int t0 = (blockIdx.x * blockDim.x + threadIdx.x) * kN;
  if (t0 >= k) return;
  const int count = min(kN, k - t0);
  const Cut c = load_cut(params, n);
  const bool noise = z0 != nullptr;
  const long plane = (long)n * k + t0;
  alignas(8) T zr[kN], zg[kN], zb[kN];
  if (noise) {
    load_vec(z0 + plane, zr, vec, count);
    load_vec(z1 + plane, zg, vec, count);
    load_vec(z2 + plane, zb, vec, count);
  }
  alignas(8) T o[3][kN], p[3][kN];
  int i = t0 / s, j = t0 - i * s;  // the first pixel, then stepped along the row
#pragma unroll
  for (int e = 0; e < kN; ++e) {
    if (e >= count) break;
    const Taps tp = compute_taps(c, i, j, h, w, c.fill);
    const Hats ht = jax_hats(tp);
    // the y hats split once, for the three channels
    const float by0 = bfr(ht.y0), by1 = bfr(ht.y1);
    const float ly0 = P == kHigh ? lo_part(ht.y0) : 0.f, ly1 = P == kHigh ? lo_part(ht.y1) : 0.f;
    const long at = (long)tp.y0 * w + tp.x0;  // one load per tap for all three channels
    const RungTexel<P> none = {};
    const RungTexel<P> t00 = (tp.valid & 1u) ? __ldg(texels + at) : none;
    const RungTexel<P> t01 = (tp.valid & 2u) ? __ldg(texels + at + 1) : none;
    const RungTexel<P> t10 = (tp.valid & 4u) ? __ldg(texels + at + w) : none;
    const RungTexel<P> t11 = (tp.valid & 8u) ? __ldg(texels + at + w + 1) : none;
    float v[3];
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) {
      const float a0 = texel_value(t00, ci), b0 = texel_value(t10, ci);
      const float a1 = texel_value(t01, ci), b1 = texel_value(t11, ci);
      float c0 = dot2(a0, by0, b0, by1), c1 = dot2(a1, by0, b1, by1);
      if constexpr (P == kHigh) {
        c0 = __fadd_rn(__fadd_rn(c0, dot2(texel_value(t00, 3 + ci), by0, texel_value(t10, 3 + ci), by1)),
                       dot2(a0, ly0, b0, ly1));
        c1 = __fadd_rn(__fadd_rn(c1, dot2(texel_value(t01, 3 + ci), by0, texel_value(t11, 3 + ci), by1)),
                       dot2(a1, ly0, b1, ly1));
      }
      v[ci] = round_to<T>(__fadd_rn(__fadd_rn(__fmul_rn(c0, ht.x0), __fmul_rn(c1, ht.x1)), tp.fill_add));
      p[ci][e] = from_float<T>(v[ci]);
    }
    if (c.apply) {
      float jr, jg, jb;
      jitter_fwd(hsv_state(v[0], v[1], v[2], c.hue, c.sat), jr, jg, jb);
      v[0] = round_to<T>(jr);
      v[1] = round_to<T>(jg);
      v[2] = round_to<T>(jb);
    }
    if (noise) {
      const float zs[3] = {to_float(zr[e]), to_float(zg[e]), to_float(zb[e])};
#pragma unroll
      for (int ci = 0; ci < 3; ++ci)
        v[ci] = round_to<T>(__fadd_rn(v[ci], round_to<T>(__fmul_rn(c.fac, zs[ci]))));
    }
#pragma unroll
    for (int ci = 0; ci < 3; ++ci) o[ci][e] = from_float<T>(v[ci]);
    if (++j == s) {
      j = 0;
      ++i;
    }
  }
  const long base = (long)n * 3 * k + t0;
#pragma unroll
  for (int ci = 0; ci < 3; ++ci) {
    store_vec(out + base + (long)ci * k, o[ci], vec, count);
    if (pre != nullptr && c.apply) store_vec(pre + base + (long)ci * k, p[ci], vec, count);
  }
}

// one __global__ per rung, so that each has a name of its own
template <typename T>
__global__ void __launch_bounds__(kThreads, kBf16FwdBlocksPerSm)
bank_fwd_bf16_kernel(const uint2* __restrict__ texels, const float* __restrict__ params, const T* __restrict__ z0,
                     const T* __restrict__ z1, const T* __restrict__ z2, T* __restrict__ out, T* __restrict__ pre,
                     int h, int w, int s, bool vec) {
  bank_fwd_rung_body<T, kBf16>(texels, params, z0, z1, z2, out, pre, h, w, s, vec);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kHighFwdBlocksPerSm)
bank_fwd_high_kernel(const uint4* __restrict__ texels, const float* __restrict__ params, const T* __restrict__ z0,
                     const T* __restrict__ z1, const T* __restrict__ z2, T* __restrict__ out, T* __restrict__ pre,
                     int h, int w, int s, bool vec) {
  bank_fwd_rung_body<T, kHigh>(texels, params, z0, z1, z2, out, pre, h, w, s, vec);
}

bool aligned8(const void* p) { return p == nullptr || ((uintptr_t)p & 7u) == 0; }

template <typename T>
int launch_fwd(const void* work, const float* scale, const float* params, const void* z0, const void* z1,
               const void* z2, void* out, void* pre, int prec, int n, int h, int w, int s, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  const int k = s * s;
  const bool vec = k % kN == 0 && aligned8(z0) && aligned8(z1) && aligned8(z2) && aligned8(out) && aligned8(pre);
  const int groups = (k + kN - 1) / kN;
  dim3 grid((groups + kThreads - 1) / kThreads, n);
  const T *zr = (const T*)z0, *zg = (const T*)z1, *zb = (const T*)z2;
  switch (prec) {
    case kHighest:
      bank_fwd_kernel<T><<<grid, kThreads, 0, stream>>>((const float*)work, params, zr, zg, zb, (T*)out, (T*)pre, h,
                                                        w, s, vec);
      break;
    case kBf16:
      bank_fwd_bf16_kernel<T><<<grid, kThreads, 0, stream>>>((const uint2*)work, params, zr, zg, zb, (T*)out, (T*)pre,
                                                             h, w, s, vec);
      break;
    case kHigh:
      bank_fwd_high_kernel<T><<<grid, kThreads, 0, stream>>>((const uint4*)work, params, zr, zg, zb, (T*)out, (T*)pre,
                                                             h, w, s, vec);
      break;
    case kInt8:
      if (scale == nullptr) return (int)cudaErrorInvalidValue;
      bank_fwd_int8_kernel<T><<<grid, kThreads, 0, stream>>>((const unsigned*)work, scale, params, zr, zg, zb,
                                                             (T*)out, (T*)pre, h, w, s, vec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K2-bf16: bands of kBandRows canvas rows (shrunk until a band and its
// halo row fit kBandSmemMax), up to kBandGroups clusters of kBandCluster
// blocks per band (no more groups than the cuts fill), then the sum pass.
struct BandPlan {
  int band_rows, cluster, groups;
  bool ok() const { return band_rows >= 1; }
};

BandPlan band_plan(int n, int w) {
  BandPlan b;
  b.cluster = kBandCluster;
  b.groups = std::max(1, std::min(kBandGroups, (n + kBandCluster - 1) / kBandCluster));
  const long fit = (long)kBandSmemMax / ((long)w * 3 * (long)sizeof(float)) - 1;  // a band and its halo row
  b.band_rows = (int)std::min((long)kBandRows, fit);
  return b;
}

template <typename T>
int launch_bwd_bands(const T* g, const T* pre, const float* params, const int2* rows, float* dwork, float* partial,
                     int* branches, int n, int h, int w, int s, BandPlan plan, cudaStream_t stream) {
  if (rows == nullptr || partial == nullptr || !plan.ok()) return (int)cudaErrorInvalidValue;
  const int band_rows = plan.band_rows, cluster = plan.cluster, groups = plan.groups;
  const int smem = (int)((band_rows + 1) * (long)w * 3 * (long)sizeof(float));
  // dynamic shared memory past 48 KB: an attribute of the current device, set once on each
  static std::atomic<unsigned long long> opted_in{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(opted_in.load() & bit)) {
    err = cudaFuncSetAttribute(bank_bwd_bf16_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kBandSmemMax);
    if (err != cudaSuccess) return (int)err;
    opted_in.fetch_or(bit);
  }
  const int bands = (h + band_rows - 1) / band_rows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(bands * groups * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, bank_bwd_bf16_kernel<T>, g, pre, params, rows, partial, branches, n, h, w, s,
                           band_rows, groups);
  if (err != cudaSuccess) return (int)err;
  const long count = (long)h * w * 3;
  bank_bwd_sum_kernel<<<(unsigned)((count + kThreads - 1) / kThreads), kThreads, 0, stream>>>(partial, dwork, groups,
                                                                                               h, w, band_rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const void* pre, const float* params, float* dwork, void* acc, const int* rows,
               float* partial, int* branches, int prec, int n, int h, int w, int s, cudaStream_t stream) {
  const int tiles = ((s + kTile - 1) / kTile) * ((s + kTile - 1) / kTile);
  dim3 grid(tiles, n);
  const T *gt = (const T*)g, *pt = (const T*)pre;
  const long count = (long)h * w * 3;
  switch (prec) {
    case kHighest:
      bank_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(gt, pt, params, dwork, branches, h, w, s);
      break;
    case kBf16: {
      const int code = launch_bwd_bands<T>(gt, pt, params, (const int2*)rows, dwork, partial, branches, n, h, w, s,
                                           band_plan(n, w), stream);
      if (code != 0) return code;
      break;
    }
    case kHigh:
      if (acc == nullptr) return (int)cudaErrorInvalidValue;
      bank_bwd_high_kernel<T><<<dim3((s * s + kThreads - 1) / kThreads, n), kThreads, 0, stream>>>(
          gt, pt, params, (float*)acc, h, w, s);
      bank_bwd_high_pack_kernel<<<(unsigned)((h * (long)w + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
          (const float4*)acc, dwork, (long)h * w);
      break;
    case kInt8:
      if (acc == nullptr || partial == nullptr) return (int)cudaErrorInvalidValue;
      bank_bwd_int8_kernel<T><<<grid, kThreads, 0, stream>>>(gt, pt, params, partial, (unsigned long long*)acc,
                                                             branches, h, w, s);
      bank_bwd_int8_finish_kernel<<<(unsigned)((count + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
          (const long long*)acc, partial, dwork, count);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K1-int8's scale and pack passes: scale (kScaleBlocks + 1,) f32 (the
// partial maxima, then s_w) and texels (H, W) int32 from the (H, W, 3) f32
// canvas.
extern "C" int bank_int8_scale(const float* work, float* scale, long long pixels, void* stream) {
  bank_int8_scale_kernel<<<kScaleBlocks, kThreads, 0, (cudaStream_t)stream>>>(work, scale, (long)pixels * 3);
  return (int)cudaGetLastError();
}

extern "C" int bank_int8_pack(const float* work, float* scale, int* texels, long long pixels, void* stream) {
  bank_int8_pack_kernel<<<(unsigned)((pixels + kThreads - 1) / kThreads), kThreads, 0, (cudaStream_t)stream>>>(
      work, scale, (unsigned*)texels, (long)pixels);
  return (int)cudaGetLastError();
}

// K1-bf16's and K1-high's pack pass: texels (H, W, 4) bf16 for prec 1
// (bf16), (H, W, 8) for prec 2 (high), from the (H, W, 3) f32 canvas.
extern "C" int bank_bf16_pack(const float* work, void* texels, long long pixels, int prec, void* stream) {
  const unsigned blocks = (unsigned)((pixels + kThreads - 1) / kThreads);
  if (prec == kBf16)
    bank_bf16_pack_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(work, (uint2*)texels, (long)pixels);
  else if (prec == kHigh)
    bank_high_pack_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(work, (uint4*)texels, (long)pixels);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// dtype: 0 float32, 1 bfloat16 (out, pre and the noise planes share it).
// prec: 0 highest, 1 bf16, 2 high, 3 int8.  work: (H, W, 3) f32; for bf16
// and high the texels of bank_bf16_pack; for int8 the packed texels (H, W)
// int32 of bank_int8_pack, with scale its scale buffer (null otherwise).
extern "C" int bank_fwd(const void* work, const float* scale, const float* params, const void* z0,
                        const void* z1, const void* z2, void* out, void* pre, int dtype, int prec, int n, int h,
                        int w, int s, void* stream) {
  if (dtype == 1)
    return launch_fwd<bf16>(work, scale, params, z0, z1, z2, out, pre, prec, n, h, w, s, (cudaStream_t)stream);
  return launch_fwd<float>(work, scale, params, z0, z1, z2, out, pre, prec, n, h, w, s, (cudaStream_t)stream);
}

// K2-bf16's row table: rows (N, S, 2) int32.
extern "C" int bank_bwd_rows(const float* params, int* rows, int n, int h, int w, int s, void* stream) {
  const int blocks = (n * s + kThreads / 32 - 1) / (kThreads / 32);
  bank_bwd_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(params, (int2*)rows, n, h, w, s);
  return (int)cudaGetLastError();
}

// K2-bf16's partial canvases: floats for (groups, H + bands, W, 3).
extern "C" long long bank_bwd_partial_floats(int n, int h, int w) {
  const BandPlan b = band_plan(n, w);
  if (!b.ok()) return -1;
  return (long long)b.groups * (h + (h + b.band_rows - 1) / b.band_rows) * w * 3;
}

// K2-int8's cotangent pass: cot (N, 3, S, S) in the bank's dtype (the
// jittered cuts' rows; null with pre), partial (kCotBlocks + 1,) f32 (the
// partial maxima; the scatter stores s_g last), acc (H, W, 3) int64, zeroed.
extern "C" int bank_bwd_cot(const void* g, const void* pre, const float* params, void* cot, float* partial,
                            void* acc, int dtype, int n, int h, int w, int s, void* stream) {
  if ((long)n * s * s >= INT_MAX) return (int)cudaErrorInvalidValue;
  const long count = (long)h * w * 3;
  auto* a = (unsigned long long*)acc;
  if (dtype == 1)
    bank_bwd_cot_kernel<bf16><<<kCotBlocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const bf16*)g, (const bf16*)pre, params, (bf16*)cot, partial, a, count, n, s);
  else
    bank_bwd_cot_kernel<float><<<kCotBlocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)g, (const float*)pre, params, (float*)cot, partial, a, count, n, s);
  return (int)cudaGetLastError();
}

// int8 (prec 3): pre is the cotangent bank of bank_bwd_cot, partial its
// partial maxima and acc its zeroed int64 canvas; two launches (scatter,
// finish); dwork need not be zeroed.  high (prec 2): acc (H, W, 4) f32,
// zeroed by the caller; two launches (scatter, pack); dwork need not be
// zeroed.  bf16 (prec 1): rows, the row table of bank_bwd_rows, and
// partial, bank_bwd_partial_floats of f32 scratch; dwork need not be
// zeroed; two launches (bands, sum); branches counts row and pixel visits.
// highest (prec 0): dwork zeroed by the caller.  Null where a rung takes
// none.
extern "C" int bank_bwd(const void* g, const void* pre, const float* params, float* dwork, void* acc,
                        const int* rows, float* partial, int* branches, int dtype, int prec, int n, int h, int w,
                        int s, void* stream) {
  if (dtype == 1)
    return launch_bwd<bf16>(g, pre, params, dwork, acc, rows, partial, branches, prec, n, h, w, s,
                            (cudaStream_t)stream);
  return launch_bwd<float>(g, pre, params, dwork, acc, rows, partial, branches, prec, n, h, w, s,
                           (cudaStream_t)stream);
}

// the per-cut row's layout: stride, then the offsets of mode, hue, saturation, apply, noise factor, fill
extern "C" void bank_layout(int* out) {
  const int layout[7] = {kParamStride, kMode, kHue, kSat, kApply, kFac, kFill};
  for (int k = 0; k < 7; ++k) out[k] = layout[k];
}

// K1-int8's count of partial maxima, K2-bf16's band rows, cluster size and most cut groups, K2-int8's
// count of partial maxima
extern "C" void bank_scratch(int* out) {
  out[0] = kScaleBlocks;
  out[1] = kBandRows;
  out[2] = kBandCluster;
  out[3] = kBandGroups;
  out[4] = kCotBlocks;
}
