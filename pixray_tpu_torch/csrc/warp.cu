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
//     sum over the x taps of that times hat_x, plus the fill;
//   bank_fwd_int8_kernel <- the int8 branch (:571-579 with :821-826, :650):
//     the canvas arrives quantized (round(work / s_w * 127) as s8, s_w =
//     max(max|work|, 1e-6) on the device, ops/warp_batch.py quantize_canvas),
//     y hats round(hat * 127), an int32 sum per x tap, then f32 times hat_x,
//     plus the fill over the dequant scale, times s_w / 127^2;
//   bank_bwd_bf16_kernel / _high_kernel <- _bwd_kernel_multi_TB through
//     _mm_nt: per tap bf16(hat_y) bf16(hat_x g) (or its hi/lo form) into
//     the canvas, float atomics as the exact backward;
//   bank_bwd_int8_kernel <- the int8 branch (:718-743, :777-782): after
//     bank_bwd_max_kernel has taken s_g = max|g| over the whole bank's
//     post-epilogue cotangent (recomputed, nothing bank-sized written), per
//     tap round(hat_y g / s_g 127) round(hat_x 127) summed in int64 (exact,
//     so the sum is order-free and deterministic), and
//     bank_bwd_int8_finish_kernel writes float(sum) s_g / 127^2.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// the four taps of one channel (0 off the canvas): v00, v01, v10, v11
template <typename S>
__device__ __forceinline__ void tap_values(const S* __restrict__ src, const Taps& tp, int w, int ci, S (&v)[4]) {
  const long r0 = ((long)tp.y0 * w + tp.x0) * 3 + ci;
  const long r1 = r0 + (long)w * 3;
  v[0] = (tp.valid & 1u) ? __ldg(src + r0) : S(0);
  v[1] = (tp.valid & 2u) ? __ldg(src + r0 + 3) : S(0);
  v[2] = (tp.valid & 4u) ? __ldg(src + r1) : S(0);
  v[3] = (tp.valid & 8u) ? __ldg(src + r1 + 3) : S(0);
}

// one x tap's column of a float rung: the sum over its two y taps
template <int P>
__device__ __forceinline__ float rung_column(float top, float bot, const Hats& ht) {
  const float by0 = bfr(ht.y0), by1 = bfr(ht.y1);
  const float d1 = __fadd_rn(__fmul_rn(bfr(top), by0), __fmul_rn(bfr(bot), by1));
  if (P == kBf16) return d1;
  const float d2 = __fadd_rn(__fmul_rn(lo_part(top), by0), __fmul_rn(lo_part(bot), by1));
  const float d3 = __fadd_rn(__fmul_rn(bfr(top), lo_part(ht.y0)), __fmul_rn(bfr(bot), lo_part(ht.y1)));
  return __fadd_rn(__fadd_rn(d1, d2), d3);
}

// The f32 bank value of one channel at rung P (work: f32, or the s8 canvas
// for kInt8, whose fill_add is already over the dequant scale `scale`).
template <int P>
__device__ __forceinline__ float bank_value(const void* __restrict__ work, const Taps& tp, int w, int ci, float scale) {
  if (P == kHighest) return bilinear((const float*)work, tp, w, ci);
  const Hats ht = jax_hats(tp);
  float t0, t1;
  if (P == kInt8) {
    int8_t q[4];
    tap_values((const int8_t*)work, tp, w, ci, q);
    const int a0 = (int)rintf(__fmul_rn(ht.y0, kQ)), a1 = (int)rintf(__fmul_rn(ht.y1, kQ));
    t0 = (float)(a0 * q[0] + a1 * q[2]);
    t1 = (float)(a0 * q[1] + a1 * q[3]);
  } else {
    float v[4];
    tap_values((const float*)work, tp, w, ci, v);
    t0 = rung_column<P>(v[0], v[2], ht);
    t1 = rung_column<P>(v[1], v[3], ht);
  }
  const float acc = __fadd_rn(__fadd_rn(__fmul_rn(t0, ht.x0), __fmul_rn(t1, ht.x1)), tp.fill_add);
  return P == kInt8 ? __fmul_rn(acc, scale) : acc;
}

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

// work (H, W, 3) f32, or s8 for kInt8 with `scale_src` the device scalar
// s_w; params (N, kParamStride) f32; z0..z2 (N, S, S) noise planes or null;
// out (N, 3, S, S); pre (N, 3, S, S) the rounded pre-jitter bank, written
// for the jittered cuts only (the backward reads no other), or null.  Each
// thread makes kN consecutive pixels of one cut.
template <typename T, int P>
__device__ __forceinline__ void bank_fwd_body(const void* __restrict__ work, const float* __restrict__ scale_src,
                                              const float* __restrict__ params, const T* __restrict__ z0,
                                              const T* __restrict__ z1, const T* __restrict__ z2, T* __restrict__ out,
                                              T* __restrict__ pre, int h, int w, int s, bool vec) {
  constexpr int kN = Vec<T>::kN;
  const int k = s * s;
  const int n = blockIdx.y;
  const int t0 = (blockIdx.x * blockDim.x + threadIdx.x) * kN;
  if (t0 >= k) return;
  const int count = min(kN, k - t0);
  Cut c = load_cut(params, n);
  // int8: the dequant scale s_w / 127^2, and the fill pre-divided by it (:824-826)
  const float scale = P == kInt8 ? __fdiv_rn(__ldg(scale_src), kDequant) : 1.f;
  if (P == kInt8) c.fill = __fdiv_rn(c.fill, scale);
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
      v[ci] = round_to<T>(bank_value<P>(work, tp, w, ci, scale));
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
#define BANK_FWD_KERNEL(NAME, P)                                                                              \
  template <typename T>                                                                                       \
  __global__ void __launch_bounds__(kThreads)                                                                 \
  NAME(const void* __restrict__ work, const float* __restrict__ scale_src, const float* __restrict__ params,  \
       const T* __restrict__ z0, const T* __restrict__ z1, const T* __restrict__ z2, T* __restrict__ out,     \
       T* __restrict__ pre, int h, int w, int s, bool vec) {                                                  \
    bank_fwd_body<T, P>(work, scale_src, params, z0, z1, z2, out, pre, h, w, s, vec);                         \
  }
BANK_FWD_KERNEL(bank_fwd_kernel, kHighest)
BANK_FWD_KERNEL(bank_fwd_bf16_kernel, kBf16)
BANK_FWD_KERNEL(bank_fwd_high_kernel, kHigh)
BANK_FWD_KERNEL(bank_fwd_int8_kernel, kInt8)
#undef BANK_FWD_KERNEL

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

__device__ __forceinline__ void add_to(float* p, float v) { atomicAdd(p, v); }
__device__ __forceinline__ void add_to(int* p, int v) { atomicAdd(p, v); }
__device__ __forceinline__ void add_to(unsigned long long* p, long long v) {
  atomicAdd(p, (unsigned long long)v);  // two's complement: the signed sum
}

// g (N, 3, S, S) cotangent; pre (N, 3, S, S) saved pre-jitter bank (read
// only for jittered cuts); dwork (H, W, 3) f32, zeroed by the caller (kInt8:
// acc (H, W, 3) int64, zeroed, and gmax the bank's max|g| from
// bank_bwd_max_kernel); branches (2,) int or null: blocks that summed in
// shared memory, blocks that added to device memory, counted when given (a
// check, not the main path).  One block: one cut x one kTile x kTile output
// tile, one pixel per thread.  Eight blocks per SM (32 registers a thread)
// hide the atomics' latency best.
template <typename T, int P>
__device__ __forceinline__ void bank_bwd_body(const T* __restrict__ g, const T* __restrict__ pre,
                                              const float* __restrict__ params, float* __restrict__ dwork,
                                              unsigned long long* __restrict__ acc_q, const float* __restrict__ gmax,
                                              int* __restrict__ branches, int h, int w, int s, void* smem) {
  using Acc = typename std::conditional<P == kInt8, int, float>::type;
  Acc* acc = (Acc*)smem;
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
  int xmin = INT_MAX, ymin = INT_MAX, xmax = INT_MIN, ymax = INT_MIN;
  if (i < s && j < s) {
    tp = compute_taps(c, i, j, h, w, 0.f);
    cotangent(g, pre, c, (long)n * 3 * k + (long)i * s + j, k, gv);
    if (tp.valid) {
      xmin = (tp.valid & 0b0101u) ? tp.x0 : tp.x0 + 1;
      xmax = (tp.valid & 0b1010u) ? tp.x0 + 1 : tp.x0;
      ymin = (tp.valid & 0b0011u) ? tp.y0 : tp.y0 + 1;
      ymax = (tp.valid & 0b1100u) ? tp.y0 + 1 : tp.y0;
    }
  }

  // the block's footprint on the canvas
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  xmin = warp_min(xmin);
  ymin = warp_min(ymin);
  xmax = warp_max(xmax);
  ymax = warp_max(ymax);
  if (lane == 0) {
    red[0][wid] = xmin;
    red[1][wid] = ymin;
    red[2][wid] = xmax;
    red[3][wid] = ymax;
  }
  __syncthreads();
  xmin = red[0][0];
  ymin = red[1][0];
  xmax = red[2][0];
  ymax = red[3][0];
#pragma unroll
  for (int q = 1; q < kThreads / 32; ++q) {
    xmin = min(xmin, red[0][q]);
    ymin = min(ymin, red[1][q]);
    xmax = max(xmax, red[2][q]);
    ymax = max(ymax, red[3][q]);
  }
  if (xmax < xmin) return;  // no tap of this tile lies on the canvas (uniform over the block)
  const int fw = xmax - xmin + 1, fh = ymax - ymin + 1;
  const bool local = (long)fw * fh * 3 <= kSmemFloats;
  if (branches != nullptr && threadIdx.x == 0) atomicAdd(branches + (local ? 0 : 1), 1);
  if (local) {
    for (int q = threadIdx.x; q < fw * fh * 3; q += kThreads) acc[q] = Acc(0);
    __syncthreads();
  }

  if (tp.valid) {
    float wa[4], wb[4];  // per tap: the y weight, the x weight
    if (P == kHighest) {
      wa[0] = wa[1] = tp.ay;
      wa[2] = wa[3] = tp.wy;
      wb[0] = wb[2] = tp.ax;
      wb[1] = wb[3] = tp.wx;
    } else {
      const Hats ht = jax_hats(tp);
      wa[0] = wa[1] = ht.y0;
      wa[2] = wa[3] = ht.y1;
      wb[0] = wb[2] = ht.x0;
      wb[1] = wb[3] = ht.x1;
    }
    float sg = 1.f;
    if (P == kInt8) {
      sg = fmaxf(__ldg(gmax), 1e-20f);
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) gv[ci] = __fdiv_rn(gv[ci], sg);
    }
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      if (!(tp.valid & (1u << tap))) continue;
      const int x = tp.x0 + (tap & 1), y = tp.y0 + (tap >> 1);
      const int bq = P == kInt8 ? (int)rintf(__fmul_rn(wb[tap], kQ)) : 0;
#pragma unroll
      for (int ci = 0; ci < 3; ++ci) {
        if (gv[ci] == 0.f) continue;
        const long cell = ((long)y * w + x) * 3 + ci;
        if (P == kInt8) {
          const int contrib = (int)rintf(__fmul_rn(__fmul_rn(wa[tap], gv[ci]), kQ)) * bq;
          if (local)
            add_to((int*)acc + ((y - ymin) * fw + (x - xmin)) * 3 + ci, contrib);
          else
            add_to(acc_q + cell, (long long)contrib);
        } else {
          const float contrib = tap_contrib<P>(wa[tap], wb[tap], gv[ci]);
          if (local)
            add_to((float*)acc + ((y - ymin) * fw + (x - xmin)) * 3 + ci, contrib);
          else
            add_to(dwork + cell, contrib);
        }
      }
    }
  }
  if (local) {
    __syncthreads();
    for (int q = threadIdx.x; q < fw * fh * 3; q += kThreads) {
      const Acc a = acc[q];
      if (a != Acc(0)) {
        const int cell = q / 3, ci = q - cell * 3;
        const long at = ((long)(ymin + cell / fw) * w + (xmin + cell % fw)) * 3 + ci;
        if (P == kInt8)
          add_to(acc_q + at, (long long)a);
        else
          add_to(dwork + at, (float)a);
      }
    }
  }
}

#define BANK_BWD_KERNEL(NAME, P)                                                                              \
  template <typename T>                                                                                       \
  __global__ void __launch_bounds__(kThreads, 8)                                                              \
  NAME(const T* __restrict__ g, const T* __restrict__ pre, const float* __restrict__ params,                  \
       float* __restrict__ dwork, unsigned long long* __restrict__ acc_q, const float* __restrict__ gmax,     \
       int* __restrict__ branches, int h, int w, int s) {                                                     \
    extern __shared__ __align__(8) unsigned char smem[];                                                      \
    bank_bwd_body<T, P>(g, pre, params, dwork, acc_q, gmax, branches, h, w, s, smem);                         \
  }
BANK_BWD_KERNEL(bank_bwd_kernel, kHighest)
BANK_BWD_KERNEL(bank_bwd_bf16_kernel, kBf16)
BANK_BWD_KERNEL(bank_bwd_high_kernel, kHigh)
BANK_BWD_KERNEL(bank_bwd_int8_kernel, kInt8)
#undef BANK_BWD_KERNEL

// K2-int8's first pass: gmax = max |g| over the whole bank's post-epilogue
// cotangent (every pixel, on the canvas or not), a float's bits through an
// integer atomicMax (non-negative floats order as their bits do); gmax
// zeroed by the caller.  Same grid as the backward.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bank_bwd_max_kernel(const T* __restrict__ g, const T* __restrict__ pre, const float* __restrict__ params,
                    float* __restrict__ gmax, int s) {
  __shared__ float red[kThreads / 32];
  const int tiles_x = (s + kTile - 1) / kTile;
  const int i = (blockIdx.x / tiles_x) * kTile + threadIdx.x / kTile;
  const int j = (blockIdx.x % tiles_x) * kTile + threadIdx.x % kTile;
  const int n = blockIdx.y;
  const int k = s * s;
  float m = 0.f;
  if (i < s && j < s) {
    float gv[3];
    cotangent(g, pre, load_cut(params, n), (long)n * 3 * k + (long)i * s + j, k, gv);
    m = fmaxf(fmaxf(fabsf(gv[0]), fabsf(gv[1])), fabsf(gv[2]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int q = 1; q < kThreads / 32; ++q) m = fmaxf(m, red[q]);
    atomicMax((int*)gmax, __float_as_int(m));
  }
}

// K2-int8's last pass: dwork = float(acc) * (max(gmax, 1e-20) / 127^2).
__global__ void __launch_bounds__(kThreads)
bank_bwd_int8_finish_kernel(const long long* __restrict__ acc_q, const float* __restrict__ gmax,
                            float* __restrict__ dwork, long count) {
  const long q = (long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= count) return;
  const float scale = __fdiv_rn(fmaxf(__ldg(gmax), 1e-20f), kDequant);
  dwork[q] = __fmul_rn(__ll2float_rn(acc_q[q]), scale);
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
      bank_fwd_kernel<T><<<grid, kThreads, 0, stream>>>(work, scale, params, zr, zg, zb, (T*)out, (T*)pre, h, w, s, vec);
      break;
    case kBf16:
      bank_fwd_bf16_kernel<T><<<grid, kThreads, 0, stream>>>(work, scale, params, zr, zg, zb, (T*)out, (T*)pre, h, w,
                                                             s, vec);
      break;
    case kHigh:
      bank_fwd_high_kernel<T><<<grid, kThreads, 0, stream>>>(work, scale, params, zr, zg, zb, (T*)out, (T*)pre, h, w,
                                                             s, vec);
      break;
    case kInt8:
      bank_fwd_int8_kernel<T><<<grid, kThreads, 0, stream>>>(work, scale, params, zr, zg, zb, (T*)out, (T*)pre, h, w,
                                                             s, vec);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* g, const void* pre, const float* params, float* dwork, void* acc_q, float* gmax,
               int* branches, int prec, int n, int h, int w, int s, cudaStream_t stream) {
  const int smem = kSmemFloats * (int)sizeof(float);
  const int tiles = ((s + kTile - 1) / kTile) * ((s + kTile - 1) / kTile);
  dim3 grid(tiles, n);
  const T *gt = (const T*)g, *pt = (const T*)pre;
  unsigned long long* acc = (unsigned long long*)acc_q;
  switch (prec) {
    case kHighest:
      bank_bwd_kernel<T><<<grid, kThreads, smem, stream>>>(gt, pt, params, dwork, acc, gmax, branches, h, w, s);
      break;
    case kBf16:
      bank_bwd_bf16_kernel<T><<<grid, kThreads, smem, stream>>>(gt, pt, params, dwork, acc, gmax, branches, h, w, s);
      break;
    case kHigh:
      bank_bwd_high_kernel<T><<<grid, kThreads, smem, stream>>>(gt, pt, params, dwork, acc, gmax, branches, h, w, s);
      break;
    case kInt8: {
      if (acc == nullptr || gmax == nullptr) return (int)cudaErrorInvalidValue;
      bank_bwd_max_kernel<T><<<grid, kThreads, 0, stream>>>(gt, pt, params, gmax, s);
      bank_bwd_int8_kernel<T><<<grid, kThreads, smem, stream>>>(gt, pt, params, dwork, acc, gmax, branches, h, w, s);
      const long count = (long)h * w * 3;
      bank_bwd_int8_finish_kernel<<<(unsigned)((count + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
          (const long long*)acc, gmax, dwork, count);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (out, pre and the noise planes share it).
// prec: 0 highest, 1 bf16, 2 high, 3 int8.  work: (H, W, 3) f32, or s8 for
// int8 with scale the device scalar s_w (null otherwise).
extern "C" int bank_fwd(const void* work, const float* scale, const float* params, const void* z0,
                        const void* z1, const void* z2, void* out, void* pre, int dtype, int prec, int n, int h,
                        int w, int s, void* stream) {
  if (dtype == 1)
    return launch_fwd<bf16>(work, scale, params, z0, z1, z2, out, pre, prec, n, h, w, s, (cudaStream_t)stream);
  return launch_fwd<float>(work, scale, params, z0, z1, z2, out, pre, prec, n, h, w, s, (cudaStream_t)stream);
}

// int8 (prec 3): acc (H, W, 3) int64 and gmax (1,) f32, both zeroed by the
// caller; three launches (max, scatter, finish).  Null for the other rungs.
extern "C" int bank_bwd(const void* g, const void* pre, const float* params, float* dwork, void* acc, float* gmax,
                        int* branches, int dtype, int prec, int n, int h, int w, int s, void* stream) {
  if (dtype == 1)
    return launch_bwd<bf16>(g, pre, params, dwork, acc, gmax, branches, prec, n, h, w, s, (cudaStream_t)stream);
  return launch_bwd<float>(g, pre, params, dwork, acc, gmax, branches, prec, n, h, w, s, (cudaStream_t)stream);
}

// the per-cut row's layout: stride, then the offsets of mode, hue, saturation, apply, noise factor, fill
extern "C" void bank_layout(int* out) {
  const int layout[7] = {kParamStride, kMode, kHue, kSat, kApply, kFac, kFill};
  for (int k = 0; k < 7; ++k) out[k] = layout[k];
}
