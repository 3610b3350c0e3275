// Cutout-bank warp kernels for Hopper (sm_90a): the mixed-mode bilinear
// homography warp (forward) and its adjoint (backward).
//
// Replaces the Pallas TPU kernels of pixray_tpu/ops/pallas_warp.py:
//   warp_modes_fwd_kernel  <- _fwd_kernel_multi_T  (launched by _run_fwd_multi_T)
//   warp_modes_bwd_kernel  <- _bwd_kernel_multi_TB (launched by _run_bwd_multi_TB)
// and, because both take a padding mode per cut and compute the full
// (unbanded) adjoint, every other kernel body of that file as well.
//
// What bounds them on this card: bytes, not arithmetic.  The TPU kernels
// build dense bilinear "hat" matrices and contract them on the matrix unit
// (2*H*W*S*S flops per cut and channel, ~0.68 TFLOP per flagship forward)
// because gathers and scatters are slow there.  On Hopper the same function
// is a 4-tap gather: ~40 flops per output pixel.  At the flagship shapes
// (224x224x3 canvas, 45 cuts of 224x224) the forward reads a 600 KB canvas
// that stays in L2 and writes 27 MB; the backward reads the 27 MB cotangent
// and issues ~27 M float atomics into a 600 KB gradient canvas.
//
// Design: one thread per output pixel (cut n, pixel t), looping over the
// channels.  Coordinates follow the JAX kernels exactly: inverse homography
// with the +1e-8 denominator, per-cut remap (0 reflection with the -1e-6 of
// the reference, 1 border clamp, 2 zeros, 3 zeros + fill), taps outside
// [0,H-1]x[0,W-1] weigh 0 (the hat sum over the canvas), and for mode 3 the
// closed-form coverage (1 - cx*cy)*fill taken at the raw coordinates.
// Output writes are coalesced along t; canvas reads hit L2.  The backward
// accumulates with atomicAdd into a float32 (H, W, C) canvas that the
// caller zeroes; summation order therefore varies from run to run.
// All pointers are device pointers; nothing is allocated here.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float jnp_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.f && r < 0.f) r += y;
  return r;
}

__device__ __forceinline__ float reflect_coord(float x, int size) {
  const float span = 2.f * (float)size;
  x = jnp_mod(x + 0.5f, span);
  if (x >= (float)size) x = span - x - 1e-6f;
  return x - 0.5f;
}

struct Taps {
  int x0, y0;
  float w00, w01, w10, w11;
  bool v00, v01, v10, v11;
  float fill_add;
};

// Source position and bilinear taps of output pixel t of cut n.
__device__ __forceinline__ Taps compute_taps(const float* __restrict__ inv,
                                             const int* __restrict__ modes,
                                             float fill, int n, int t, int h,
                                             int w, int s) {
  const float* m = inv + n * 9;
  const int mode = modes[n];
  const int i = t / s;
  const int j = t - i * s;
  const float fi = (float)i, fj = (float)j;
  const float den = fj * m[6] + fi * m[7] + m[8] + 1e-8f;
  const float rx = (fj * m[0] + fi * m[1] + m[2]) / den;
  const float ry = (fj * m[3] + fi * m[4] + m[5]) / den;
  float sx = rx, sy = ry;
  if (mode == 0) {
    sx = reflect_coord(sx, w);
    sy = reflect_coord(sy, h);
  } else if (mode == 1) {
    sx = fminf(fmaxf(sx, 0.f), (float)(w - 1));
    sy = fminf(fmaxf(sy, 0.f), (float)(h - 1));
  }
  Taps tp;
  tp.fill_add = 0.f;
  if (mode == 3) {
    const float cx = fminf(fmaxf(fminf(rx + 1.f, (float)w - rx), 0.f), 1.f);
    const float cy = fminf(fmaxf(fminf(ry + 1.f, (float)h - ry), 0.f), 1.f);
    tp.fill_add = (1.f - cx * cy) * fill;
  }
  // far outside the canvas (or non-finite): every tap weighs zero
  if (!(sx > -2.f && sx < (float)w + 1.f && sy > -2.f && sy < (float)h + 1.f)) {
    tp.x0 = tp.y0 = 0;
    tp.w00 = tp.w01 = tp.w10 = tp.w11 = 0.f;
    tp.v00 = tp.v01 = tp.v10 = tp.v11 = false;
    return tp;
  }
  const float fx0 = floorf(sx), fy0 = floorf(sy);
  const float wx = sx - fx0, wy = sy - fy0;
  tp.x0 = (int)fx0;
  tp.y0 = (int)fy0;
  tp.w00 = (1.f - wx) * (1.f - wy);
  tp.w01 = wx * (1.f - wy);
  tp.w10 = (1.f - wx) * wy;
  tp.w11 = wx * wy;
  const bool vx0 = tp.x0 >= 0 && tp.x0 < w;
  const bool vx1 = tp.x0 + 1 >= 0 && tp.x0 + 1 < w;
  const bool vy0 = tp.y0 >= 0 && tp.y0 < h;
  const bool vy1 = tp.y0 + 1 >= 0 && tp.y0 + 1 < h;
  tp.v00 = vy0 && vx0;
  tp.v01 = vy0 && vx1;
  tp.v10 = vy1 && vx0;
  tp.v11 = vy1 && vx1;
  return tp;
}

// work (H, W, C) f32; inv (N, 3, 3) f32; modes (N,) i32; out (N, C, S*S) f32.
__global__ void __launch_bounds__(kThreads)
warp_modes_fwd_kernel(const float* __restrict__ work, const float* __restrict__ inv,
                      const int* __restrict__ modes, float fill,
                      float* __restrict__ out, int h, int w, int c, int s) {
  const int k = s * s;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (t >= k) return;
  const Taps tp = compute_taps(inv, modes, fill, n, t, h, w, s);
  const long row0 = ((long)tp.y0 * w + tp.x0) * c;
  const long row1 = row0 + (long)w * c;
  float* o = out + (long)n * c * k + t;
  for (int ci = 0; ci < c; ++ci) {
    const float v00 = tp.v00 ? __ldg(work + row0 + ci) : 0.f;
    const float v01 = tp.v01 ? __ldg(work + row0 + c + ci) : 0.f;
    const float v10 = tp.v10 ? __ldg(work + row1 + ci) : 0.f;
    const float v11 = tp.v11 ? __ldg(work + row1 + c + ci) : 0.f;
    o[(long)ci * k] = v00 * tp.w00 + v01 * tp.w01 + v10 * tp.w10 + v11 * tp.w11 + tp.fill_add;
  }
}

// g (N, C, S*S) f32; dwork (H, W, C) f32, zeroed by the caller.
__global__ void __launch_bounds__(kThreads)
warp_modes_bwd_kernel(const float* __restrict__ g, const float* __restrict__ inv,
                      const int* __restrict__ modes, float* __restrict__ dwork,
                      int h, int w, int c, int s) {
  const int k = s * s;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = blockIdx.y;
  if (t >= k) return;
  const Taps tp = compute_taps(inv, modes, 0.f, n, t, h, w, s);
  const long row0 = ((long)tp.y0 * w + tp.x0) * c;
  const long row1 = row0 + (long)w * c;
  const float* gp = g + (long)n * c * k + t;
  for (int ci = 0; ci < c; ++ci) {
    const float gv = __ldg(gp + (long)ci * k);
    if (gv == 0.f) continue;
    if (tp.v00) atomicAdd(dwork + row0 + ci, gv * tp.w00);
    if (tp.v01) atomicAdd(dwork + row0 + c + ci, gv * tp.w01);
    if (tp.v10) atomicAdd(dwork + row1 + ci, gv * tp.w10);
    if (tp.v11) atomicAdd(dwork + row1 + c + ci, gv * tp.w11);
  }
}

}  // namespace

extern "C" int warp_modes_fwd(const float* work, const float* inv, const int* modes,
                              float fill, float* out, int n, int h, int w, int c,
                              int s, void* stream) {
  const int k = s * s;
  dim3 grid((k + kThreads - 1) / kThreads, n);
  warp_modes_fwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      work, inv, modes, fill, out, h, w, c, s);
  return (int)cudaGetLastError();
}

extern "C" int warp_modes_bwd(const float* g, const float* inv, const int* modes,
                              float* dwork, int n, int h, int w, int c, int s,
                              void* stream) {
  const int k = s * s;
  dim3 grid((k + kThreads - 1) / kThreads, n);
  warp_modes_bwd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      g, inv, modes, dwork, h, w, c, s);
  return (int)cudaGetLastError();
}
