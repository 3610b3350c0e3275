// Fused multi-head attention for the CLIP and SLIP towers on Hopper (sm_90a):
// softmax(Q K^T * hd^-0.5) V over the packed in_proj output, forward
// (attn_fwd_kernel) and input gradient (attn_bwd_kernel).
//
// Replaces no Pallas kernel.  It is the counterpart of the JAX towers'
// default attention, jax.nn.dot_product_attention
// (pixray_tpu/models/clip/model.py, MultiHeadAttention, PIXRAY_TPU_CLIP_ATTN
// "fused"), whose einsum form keeps the scores in float32.  Without it the
// port ran attention as plain matmul + softmax: per layer a copy of q, k and
// v into head-major layout, the (B, H, T, T) scores written in bf16, cast to
// f32, scaled, softmaxed and cast back, a copy of the output back to (B, T,
// D), each pass again in the backward, and a cat of the three head
// gradients.
//
// What bounds it on this card: bytes.  At the towers' sizes (T 50 to 577,
// head dim 64) attention is below the ridge; its least time is the bytes it
// must move at 3.35 TB/s: the forward reads q, k, v and writes O and the
// log-sum-exp (LSE, B*H*T f32), the backward reads q, k, v, O, dO and the
// LSE and writes dq, dk, dv.  ViT-B/16 at 64 cuts (T 197, 12 heads): 78 MB
// forward and 160 MB backward a layer.  What the design does about it: no
// S, P or dS tile and no head transpose goes to device memory.  Each block
// reads its rows of q, k and v straight from the packed (B, T, 3D) buffer
// (head h at columns h*hd, q, k, v at offsets 0, D, 2D) into shared memory
// with cp.async, writes O in (B, T, D) for out_proj and dq, dk, dv into one
// (B, T, 3D) gradient, so no transpose, chunk or cat copy remains.  The
// products run on mma.sync m16n8k16 bf16 with f32 sums, operands from
// swizzled shared memory by ldmatrix; a product's f32 result becomes the
// next product's bf16 operand in registers.
//
// Tiling follows the sequence length.  The forward runs one block per (b,
// h), a warp per 16 queries up to 8 warps, with every row of q, k and v in
// shared memory (T <= 592 at head dim 64), each warp walking 16-row query
// tiles.  With T <= 64
// (ViT-B/32's 50) a row's scores fit one 64-key chunk, so the softmax is
// exact in one pass; longer rows take two passes over 64-key chunks (and
// 16-key tails): the row max and sum, then P = 2^(S - LSE) and PV, so O is
// never rescaled.  The backward recomputes S and dP from the LSE in two
// kinds of task: a dQ task owns 16 queries and walks the keys, a dK/dV task
// owns 16 keys and walks the queries (32-row chunks and 16-row tails).
// Where two blocks holding all of a (b, h)'s q, k, v and dO fit an SM (T <=
// 208: ViT-B/16's 197, the text towers' 77), one block per (b, h) loads
// them once and its 8 warps take every task; longer sequences split into
// 128-query dQ blocks that hold all keys and 128-key dK/dV blocks that hold
// all queries.  Blocks of 8 warps run two an SM, at most 128 registers a
// thread.  Each warp owns its rows' sums in registers, so there is no
// float atomic and two runs give the same bits; Delta = rowsum(dO o O) comes
// from one routine in every block.
//
// Numerics (ops/attention.py's plain version does the same arithmetic):
// S = QK^T summed in f32, the scale applied in f32 (with log2(e), so the
// softmax runs in base 2 on ex2), softmax in f32 with the LSE saved; P
// rounded to bf16 only as PV's operand; O rounded once.  Backward: P
// recomputed from the LSE, dP = dO V^T in f32, dS = P o (dP - Delta) in
// f32, rounded to bf16 only as the operand of the dQ and dK products, P
// likewise of dV; dq and dk scaled in f32, then rounded.
//
// Head dim is a compile-time constant: 64 (every CLIP and SLIP tower's) and
// 32 (the tiny test towers); the wrapper refuses others.  A causal flag masks
// keys after the query (text towers).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;   // eight warps of 16-row tasks, two blocks an SM (at most 128 registers a thread)
constexpr int kOneChunk = 64;   // keys of the forward's one-pass chunk
constexpr int kSplitRows = 128; // the rows a backward block owns when a (b, h) does not fit one block
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may opt in to
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ unsigned smem_addr(const void* p) { return (unsigned)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 f32
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// 2^x (ex2.approx: 2 ulp; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// A tile of rows of hd bf16 in shared memory.  Each 16-byte chunk of a row
// is XORed with the row's place among the eight rows one ldmatrix reads, so
// those eight land in distinct banks.
template <int HD>
struct Tile {
  static constexpr int kChunks = HD / 8;        // 16-byte chunks in a row
  static constexpr int kPerLine = 8 / kChunks;  // rows in a 128-byte line
  __device__ static __forceinline__ int at(int row, int chunk) {
    return row * HD + ((chunk ^ ((row / kPerLine) & (kChunks - 1))) << 3);
  }
};

// rows [r0, r0 + n) of a row-major bf16 matrix (row 0 at src, `stride`
// elements apart) into a tile, zeros from row T on
template <int HD>
__device__ void load_rows(bf16* dst, const bf16* src, long stride, int r0, int n, int T) {
  for (int i = threadIdx.x; i < n * Tile<HD>::kChunks; i += blockDim.x) {
    const int r = i / Tile<HD>::kChunks, c = i % Tile<HD>::kChunks;
    bf16* d = dst + Tile<HD>::at(r, c);
    if (r0 + r < T)
      cp_async16(d, src + (long)(r0 + r) * stride + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// the A operand (16 rows from row0 of a tile, all hd columns) in registers
template <int HD>
__device__ __forceinline__ void load_a(unsigned (&a)[HD / 16][4], const bf16* tile, int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(a[kk], tile + Tile<HD>::at(row0 + (lane & 15), kk * 2 + (lane >> 4)));
}

// acc[j] = A (16 x hd) times the transpose of tile rows r0 + 8j .. r0 + 8j + 7
template <int HD, int NT>
__device__ __forceinline__ void times_rows_t(float (&acc)[NT][4], const unsigned (&a)[HD / 16][4], const bf16* x,
                                             int r0, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int m = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      unsigned b[4];
      ldsm_x4(b, x + Tile<HD>::at(r0 + j * 16 + (lane & 7) + ((m >> 1) << 3), kk * 2 + (m & 1)));
      mma(acc[2 * j], a[kk], b[0], b[1]);
      mma(acc[2 * j + 1], a[kk], b[2], b[3]);
    }
  }
}

// acc (16 x hd) += P (16 x 8NT, as A fragments) times tile rows r0 .. r0 + 8NT - 1
template <int HD, int NT>
__device__ __forceinline__ void times_rows(float (&acc)[HD / 8][4], const unsigned (&p)[NT / 2][4], const bf16* x,
                                           int r0, int lane) {
  const int m = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      unsigned b[4];
      ldsm_x4_t(b, x + Tile<HD>::at(r0 + kk * 16 + (lane & 7) + ((m & 1) << 3), j * 2 + (m >> 1)));
      mma(acc[2 * j], p[kk], b[0], b[1]);
      mma(acc[2 * j + 1], p[kk], b[2], b[3]);
    }
  }
}

// an f32 product's fragments (16 x 8NT) as the bf16 A operand of the next product
template <int NT>
__device__ __forceinline__ void to_a(unsigned (&a)[NT / 2][4], const float (&c)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// scores times c = scale log2(e) (base-2 logits), -inf where masked: past
// T, or a key after its query under `causal`.  Fragment rows are queries
// (KEYS_ARE_ROWS false) or keys, from row0; columns from col0.  A chunk that
// no mask reaches only takes the scale.
template <int NT, bool KEYS_ARE_ROWS>
__device__ __forceinline__ void scale_mask(float (&s)[NT][4], float c, int row0, int col0, int T, int causal,
                                           int lane) {
  const int last_key = KEYS_ARE_ROWS ? row0 + 15 : col0 + 8 * NT - 1;
  const int first_query = KEYS_ARE_ROWS ? col0 : row0;
  if (col0 + 8 * NT <= T && !(causal && last_key > first_query)) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= c;
    return;
  }
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + g + ((e >> 1) << 3), col = col0 + 8 * j + 2 * t + (e & 1);
      const int key = KEYS_ARE_ROWS ? row : col, query = KEYS_ARE_ROWS ? col : row;
      const bool off = col >= T || (causal && key > query);
      s[j][e] = off ? -INFINITY : s[j][e] * c;
    }
  }
}

// the running max m and sum l of 2^(s - m) of the thread's two rows (the
// four threads of a quad share each row and its max)
template <int NT>
__device__ __forceinline__ void row_stats(const float (&s)[NT][4], float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m[r], mx);
    const float base = mn == -INFINITY ? 0.f : mn;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) sum += exp2_approx(s[j][2 * r] - base) + exp2_approx(s[j][2 * r + 1] - base);
    l[r] = l[r] * exp2_approx(m[r] - base) + sum;
    m[r] = mn;
  }
}

// o += 2^(s - lse) V over the chunk's rows of V from k0 (s and lse base-2)
template <int HD, int NT>
__device__ __forceinline__ void probs_pv(float (&s)[NT][4], const float (&lse)[2], const bf16* sV, int k0,
                                         float (&o)[HD / 8][4], int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = exp2_approx(s[j][e] - lse[e >> 1]);
  unsigned p[NT / 2][4];
  to_a<NT>(p, s);
  times_rows<HD, NT>(o, p, sV, k0, lane);
}

template <int HD, int NT>
__device__ __forceinline__ void fwd_stats(const unsigned (&qa)[HD / 16][4], const bf16* sK, int k0, int r0, int T,
                                          int causal, float c, float (&m)[2], float (&l)[2], int lane) {
  float s[NT][4];
  times_rows_t<HD, NT>(s, qa, sK, k0, lane);
  scale_mask<NT, false>(s, c, r0, k0, T, causal, lane);
  row_stats<NT>(s, m, l);
}

template <int HD, int NT>
__device__ __forceinline__ void fwd_pv(const unsigned (&qa)[HD / 16][4], const bf16* sK, const bf16* sV, int k0,
                                       int r0, int T, int causal, float c, const float (&lse)[2],
                                       float (&o)[HD / 8][4], int lane) {
  float s[NT][4];
  times_rows_t<HD, NT>(s, qa, sK, k0, lane);
  scale_mask<NT, false>(s, c, r0, k0, T, causal, lane);
  probs_pv<HD, NT>(s, lse, sV, k0, o, lane);
}

// a warp's 16 rows of a product (f32 times `mul`) as bf16 into a row-major matrix, rows below T
template <int HD>
__device__ __forceinline__ void store_rows(bf16* dst, long stride, const float (&acc)[HD / 8][4], float mul, int r0,
                                           int T, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= T) continue;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<unsigned*>(dst + (long)row * stride + 8 * j + 2 * t) =
          pack_bf16(acc[j][2 * r] * mul, acc[j][2 * r + 1] * mul);
  }
}

// the row sums over the quad, then the base-2 LSE m + log2(l)
__device__ __forceinline__ void finish_lse(const float (&m)[2], float (&l)[2], float (&ls)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    ls[r] = m[r] + log2f(l[r]);
  }
}

// one block per (b, h), grid (B * H): every row of q, k and v in shared
// memory, each warp walking 16-row tiles of queries; ONE: T <= 64
template <int HD, bool ONE>
__global__ void __launch_bounds__(kThreads, 2) attn_fwd_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ out,
                                                            float* __restrict__ lse, int T, int H, int causal,
                                                            float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = ONE ? kOneChunk : (T + 15) & ~15;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + rows * HD;
  bf16* sV = sK + rows * HD;
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H, D = H * HD;
  const long stride = 3L * D;
  const bf16* src = qkv + (long)b * T * stride + h * HD;
  load_rows<HD>(sQ, src, stride, 0, rows, T);
  load_rows<HD>(sK, src + D, stride, 0, rows, T);
  load_rows<HD>(sV, src + 2 * D, stride, 0, rows, T);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const float c = scale * kLog2e;
  bf16* dst = out + (long)b * T * D + h * HD;
  for (int r0 = warp * 16; r0 < T; r0 += 16 * (blockDim.x / 32)) {
    unsigned qa[HD / 16][4];
    load_a<HD>(qa, sQ, r0, lane);
    const int kend = ((causal ? min(T, r0 + 16) : T) + 15) & ~15;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, ls[2];  // base 2
    float o[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    if constexpr (ONE) {
      float s[8][4];
      times_rows_t<HD, 8>(s, qa, sK, 0, lane);
      scale_mask<8, false>(s, c, r0, 0, T, causal, lane);
      row_stats<8>(s, m, l);
      finish_lse(m, l, ls);
      probs_pv<HD, 8>(s, ls, sV, 0, o, lane);
    } else {
      int k0 = 0;
      for (; k0 + 64 <= kend; k0 += 64) fwd_stats<HD, 8>(qa, sK, k0, r0, T, causal, c, m, l, lane);
      for (; k0 < kend; k0 += 16) fwd_stats<HD, 2>(qa, sK, k0, r0, T, causal, c, m, l, lane);
      finish_lse(m, l, ls);
      for (k0 = 0; k0 + 64 <= kend; k0 += 64) fwd_pv<HD, 8>(qa, sK, sV, k0, r0, T, causal, c, ls, o, lane);
      for (; k0 < kend; k0 += 16) fwd_pv<HD, 2>(qa, sK, sV, k0, r0, T, causal, c, ls, o, lane);
    }
    store_rows<HD>(dst, D, o, 1.f, r0, T, lane);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (r0 + g + 8 * r < T) lse[(long)bh * T + r0 + g + 8 * r] = ls[r] * kLn2;
    }
  }
}

// Delta = rowsum(dO o O) in f32 for rows [r0, r0 + n), 0 from row T on; the
// dQ and the dK/dV blocks both take it from here, so they read the same bits
template <int HD>
__device__ void delta_rows(float* sD, const bf16* o, const bf16* dout, long stride, int r0, int n, int T) {
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    float acc = 0.f;
    if (r0 + r < T) {
      const uint4* x = reinterpret_cast<const uint4*>(o + (long)(r0 + r) * stride);
      const uint4* y = reinterpret_cast<const uint4*>(dout + (long)(r0 + r) * stride);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        const uint4 xv = x[c], yv = y[c];
        const bf16* xs = reinterpret_cast<const bf16*>(&xv);
        const bf16* ys = reinterpret_cast<const bf16*>(&yv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc = fmaf(__bfloat162float(xs[e]), __bfloat162float(ys[e]), acc);
      }
    }
    sD[r] = acc;
  }
}

// a dQ task, one chunk of keys from k0: dq += dS K, dS = P o (dP - Delta)
template <int HD, int NT>
__device__ __forceinline__ void dq_chunk(const unsigned (&qa)[HD / 16][4], const unsigned (&da)[HD / 16][4],
                                         const bf16* sK, const bf16* sV, int k0, int r0, int T, int causal,
                                         float c, const float (&ls)[2], const float (&dl)[2],
                                         float (&dq)[HD / 8][4], int lane) {
  float s[NT][4], dp[NT][4];
  times_rows_t<HD, NT>(s, qa, sK, k0, lane);
  scale_mask<NT, false>(s, c, r0, k0, T, causal, lane);
  times_rows_t<HD, NT>(dp, da, sV, k0, lane);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = exp2_approx(s[j][e] - ls[e >> 1]) * (dp[j][e] - dl[e >> 1]);
  unsigned a[NT / 2][4];
  to_a<NT>(a, s);
  times_rows<HD, NT>(dq, a, sK, k0, lane);
}

// a dK/dV task, one chunk of queries from q0: dv += P^T dO, dk += dS^T Q
// (the task's K and V rows are read from shared memory each chunk: held in
// registers beside dk and dv they would pass the 128 a thread has)
template <int HD, int NT>
__device__ __forceinline__ void dkv_chunk(const bf16* sK, const bf16* sV, int lr, const bf16* sQ, const bf16* sdO,
                                          const float* sL, const float* sDl, int q0, int r0, int T, int causal,
                                          float c, float (&dk)[HD / 8][4], float (&dv)[HD / 8][4], int lane) {
  float s[NT][4], dp[NT][4];
  {
    unsigned ka[HD / 16][4];
    load_a<HD>(ka, sK, lr, lane);
    times_rows_t<HD, NT>(s, ka, sQ, q0, lane);
  }
  scale_mask<NT, true>(s, c, r0, q0, T, causal, lane);
  {
    unsigned va[HD / 16][4];
    load_a<HD>(va, sV, lr, lane);
    times_rows_t<HD, NT>(dp, va, sdO, q0, lane);
  }
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int q = q0 + 8 * j + 2 * t;
    const float2 ls = *reinterpret_cast<const float2*>(sL + q), dl = *reinterpret_cast<const float2*>(sDl + q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = exp2_approx(s[j][e] - ((e & 1) ? ls.y : ls.x));
      dp[j][e] = s[j][e] * (dp[j][e] - ((e & 1) ? dl.y : dl.x));
    }
  }
  unsigned pa[NT / 2][4], da[NT / 2][4];
  to_a<NT>(pa, s);
  to_a<NT>(da, dp);
  times_rows<HD, NT>(dv, pa, sdO, q0, lane);
  times_rows<HD, NT>(dk, da, sQ, q0, lane);
}

// The backward's blocks: with `whole`, one per (b, h) (grid (1, B * H)), holding every row of q, k, v and dO,
// its warps walking the 16-row dQ tasks and then the dK/dV tasks; otherwise (grid (2 ceil(T / 128), B * H))
// blocks [0, tiles) own 128 queries each (dQ tasks) and hold every key, the rest own 128 keys each (dK/dV tasks)
// and hold every query.  Shared memory: the block's queries of Q and dO, its keys of K and V, the queries'
// base-2 LSE (+inf past T) and Delta.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2) attn_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ o,
                                                            const bf16* __restrict__ dout,
                                                            const float* __restrict__ lse, bf16* __restrict__ dqkv,
                                                            int T, int H, int causal, float scale, int whole) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Tp = (T + 15) & ~15;
  int q_lo = 0, nq = Tp, k_lo = 0, nk = Tp;
  bool dq_tasks = true, dkv_tasks = true;
  if (!whole) {
    const int tiles = (T + kSplitRows - 1) / kSplitRows;
    if ((int)blockIdx.x < tiles) {
      q_lo = blockIdx.x * kSplitRows, nq = kSplitRows, dkv_tasks = false;
    } else {
      k_lo = (blockIdx.x - tiles) * kSplitRows, nk = kSplitRows, dq_tasks = false;
    }
  }
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H, D = H * HD;
  const long stride = 3L * D;
  const bf16* src = qkv + (long)b * T * stride + h * HD;
  const bf16* dsrc = dout + (long)b * T * D + h * HD;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + nq * HD;
  bf16* sK = sdO + nq * HD;
  bf16* sV = sK + nk * HD;
  float* sL = reinterpret_cast<float*>(sV + nk * HD);
  float* sDl = sL + nq;
  load_rows<HD>(sQ, src, stride, q_lo, nq, T);
  load_rows<HD>(sdO, dsrc, D, q_lo, nq, T);
  load_rows<HD>(sK, src + D, stride, k_lo, nk, T);
  load_rows<HD>(sV, src + 2 * D, stride, k_lo, nk, T);
  const float* lrow = lse + (long)bh * T;
  for (int r = threadIdx.x; r < nq; r += blockDim.x) sL[r] = q_lo + r < T ? lrow[q_lo + r] * kLog2e : INFINITY;
  delta_rows<HD>(sDl, o + (long)b * T * D + h * HD, dsrc, D, q_lo, nq, T);
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const float c = scale * kLog2e;
  bf16* dst = dqkv + (long)b * T * stride + h * HD;
  const int n_dq = dq_tasks ? (min(T - q_lo, nq) + 15) / 16 : 0;
  const int n_dkv = dkv_tasks ? (min(T - k_lo, nk) + 15) / 16 : 0;
  for (int task = warp; task < n_dq + n_dkv; task += blockDim.x / 32) {
    float acc0[HD / 8][4], acc1[HD / 8][4];
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc0[j][e] = acc1[j][e] = 0.f;
    if (task < n_dq) {  // 16 queries from r0; every key of the (b, h) is in sK, sV
      const int r0 = q_lo + 16 * task, lr = r0 - q_lo;
      unsigned qa[HD / 16][4], da[HD / 16][4];
      load_a<HD>(qa, sQ, lr, lane);
      load_a<HD>(da, sdO, lr, lane);
      const float ls[2] = {sL[lr + g], sL[lr + g + 8]};
      const float dl[2] = {sDl[lr + g], sDl[lr + g + 8]};
      const int kend = ((causal ? min(T, r0 + 16) : T) + 15) & ~15;
      int k0 = 0;
      for (; k0 + 32 <= kend; k0 += 32) dq_chunk<HD, 4>(qa, da, sK, sV, k0, r0, T, causal, c, ls, dl, acc0, lane);
      for (; k0 < kend; k0 += 16) dq_chunk<HD, 2>(qa, da, sK, sV, k0, r0, T, causal, c, ls, dl, acc0, lane);
      store_rows<HD>(dst, stride, acc0, scale, r0, T, lane);
    } else {  // 16 keys from r0; every query of the (b, h) is in sQ, sdO
      const int r0 = k_lo + 16 * (task - n_dq), lr = r0 - k_lo;
      int q0 = causal ? r0 : 0;
      for (; q0 + 32 <= Tp; q0 += 32)
        dkv_chunk<HD, 4>(sK, sV, lr, sQ, sdO, sL, sDl, q0, r0, T, causal, c, acc0, acc1, lane);
      for (; q0 < Tp; q0 += 16) dkv_chunk<HD, 2>(sK, sV, lr, sQ, sdO, sL, sDl, q0, r0, T, causal, c, acc0, acc1, lane);
      store_rows<HD>(dst + D, stride, acc0, scale, r0, T, lane);
      store_rows<HD>(dst + 2 * D, stride, acc1, 1.f, r0, T, lane);
    }
  }
}

size_t fwd_smem(int T, int hd) {
  const int rows = T <= kOneChunk ? kOneChunk : (T + 15) & ~15;
  return (size_t)3 * rows * hd * sizeof(bf16);
}

// a block holding nq queries (Q, dO, LSE, Delta) and nk keys (K, V)
size_t bwd_block_smem(int nq, int nk, int hd) {
  return (size_t)(2 * nq + 2 * nk) * hd * sizeof(bf16) + 2 * (size_t)nq * sizeof(float);
}

// one backward block per (b, h) where two fit an SM, else 64-row blocks of either side
bool bwd_whole(int T, int hd) {
  const int Tp = (T + 15) & ~15;
  return 2 * bwd_block_smem(Tp, Tp, hd) <= (size_t)kMaxSmem;
}

size_t bwd_smem(int T, int hd) {
  const int Tp = (T + 15) & ~15;
  return bwd_whole(T, hd) ? bwd_block_smem(Tp, Tp, hd) : bwd_block_smem(Tp, kSplitRows, hd);
}

// dynamic shared memory past 48 KB: an attribute of the current device, set once on each
template <typename Kernel>
int opt_in(Kernel kernel, std::atomic<unsigned long long>& done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(done.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    done.fetch_or(bit);
  }
  return 0;
}

template <int HD, bool ONE>
int launch_fwd(const bf16* qkv, bf16* out, float* lse, int B, int T, int H, int causal, float scale,
               cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  const int err = opt_in(attn_fwd_kernel<HD, ONE>, done);
  if (err) return err;
  // a warp per 16 queries, up to eight
  const int threads = std::min(kThreads, 32 * ((T + 15) / 16));
  attn_fwd_kernel<HD, ONE><<<B * H, threads, fwd_smem(T, HD), stream>>>(qkv, out, lse, T, H, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bwd(const bf16* qkv, const bf16* o, const bf16* dout, const float* lse, bf16* dqkv, int B, int T, int H,
               int causal, float scale, cudaStream_t stream) {
  static std::atomic<unsigned long long> done{0};
  const int err = opt_in(attn_bwd_kernel<HD>, done);
  if (err) return err;
  const int whole = bwd_whole(T, HD);
  const dim3 grid(whole ? 1 : 2 * ((T + kSplitRows - 1) / kSplitRows), B * H);
  attn_bwd_kernel<HD><<<grid, kThreads, bwd_smem(T, HD), stream>>>(qkv, o, dout, lse, dqkv, T, H, causal, scale,
                                                                    whole);
  return (int)cudaGetLastError();
}

bool fits(int B, int T, int H, int hd) {
  return (hd == 32 || hd == 64) && T > 0 && B > 0 && H > 0 && (long)B * H <= 65535 &&
         bwd_smem(T, hd) <= (size_t)kMaxSmem && fwd_smem(T, hd) <= (size_t)kMaxSmem;
}

}  // namespace

// qkv (B, T, 3 H hd) bf16 -> out (B, T, H hd) bf16 and lse (B, H, T) f32
extern "C" int attn_fwd(const void* qkv, void* out, float* lse, int B, int T, int H, int hd, int causal, float scale,
                        void* stream) {
  if (!fits(B, T, H, hd)) return (int)cudaErrorInvalidValue;
  const bf16* x = static_cast<const bf16*>(qkv);
  bf16* y = static_cast<bf16*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64)
    return T <= kOneChunk ? launch_fwd<64, true>(x, y, lse, B, T, H, causal, scale, s)
                      : launch_fwd<64, false>(x, y, lse, B, T, H, causal, scale, s);
  return T <= kOneChunk ? launch_fwd<32, true>(x, y, lse, B, T, H, causal, scale, s)
                    : launch_fwd<32, false>(x, y, lse, B, T, H, causal, scale, s);
}

// qkv, out, dout (B, T, H hd), lse -> dqkv (B, T, 3 H hd) bf16: dq, dk, dv at offsets 0, H hd, 2 H hd
extern "C" int attn_bwd(const void* qkv, const void* out, const void* dout, const float* lse, void* dqkv, int B, int T,
                        int H, int hd, int causal, float scale, void* stream) {
  if (!fits(B, T, H, hd)) return (int)cudaErrorInvalidValue;
  const bf16* x = static_cast<const bf16*>(qkv);
  const bf16* o = static_cast<const bf16*>(out);
  const bf16* d = static_cast<const bf16*>(dout);
  bf16* y = static_cast<bf16*>(dqkv);
  cudaStream_t s = (cudaStream_t)stream;
  if (hd == 64) return launch_bwd<64>(x, o, d, lse, y, B, T, H, causal, scale, s);
  return launch_bwd<32>(x, o, d, lse, y, B, T, H, causal, scale, s);
}

// the longest sequence the kernels take at head dim hd (0: a head dim they do not take)
extern "C" int attn_max_tokens(int hd) {
  if (hd != 32 && hd != 64) return 0;
  int t = 16;
  while (bwd_smem(t + 16, hd) <= (size_t)kMaxSmem && fwd_smem(t + 16, hd) <= (size_t)kMaxSmem) t += 16;
  return t;
}
