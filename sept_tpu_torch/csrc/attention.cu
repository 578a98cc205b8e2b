// WavLM's gated-bias attention core, forward and backward, for Hopper
// (sm_90a): scores -> gated position bias -> softmax -> dropout -> P V.
//
// Replaces no Pallas kernel: the JAX package has no WavLM.  The port's
// WavLM (models/wavlm.py) ran the core as a chain of ~15 PyTorch operations
// over f32 (B, heads, T, T) tensors (the plain version, ops/attention.py),
// and autograd ran about twice as many backward, with the (B, T, 3 hidden)
// gradient of q, k and v zero-filled and copied three times.
//
// What they compute, in the composition's arithmetic and roundings: for a
// query row i and key j of one (batch b, head h), with q, k, v read from
// the QKV product's own (B, T, 3, heads, hd) bf16 output,
//   s_ij = bf16(q_i . k_j) * scale + gate[b, i, h] * bias[h, i, j]
// (the product summed in f32; the scale multiply, the gate multiply and the
// add rounded one by one, no FMA contraction); p = softmax_j(s) in f32
// (max, expf(s - max), the sum, a division); in train mode
// pd = keep-mask ? p * (1 / keep) : 0, the mask drawn outside (DropoutDraws)
// and 1 / keep rounded to f32 as torch's division by a scalar does on the
// card; ctx_i = bf16(sum_j bf16(pd_ij) v_j), summed in f32, written straight
// into (B, T, hidden).  The backward recomputes s and p with the same
// instructions (the same bits), then as autograd through the composition:
// dP = bf16(dctx_i . v_j); dPs = mask ? dP * (1 / keep) : 0; gp = dPs * p;
// D_i = sum_j gp; dscore = gp - p * D_i (softmax's backward); dgate[b, i, h]
// = sum_j dscore * bias_ij; dS = bf16(dscore * scale); dq = dS k, dk = dS^T
// q, dv = bf16(pd)^T dctx, each summed in f32 and stored bf16 into one
// (B, T, 3 hidden) gradient; where the bias needs a gradient, each (b, h)
// writes its f32 partial dscore * gate[b, i, h] and a second launch sums
// the partials over the batch in order (no atomics: the step stays
// deterministic).  Sums over keys run in another order than torch's
// kernels on the card, so values move by a unit where a sum lands next to a
// rounding boundary.
//
// What bounds them on the H100: by bytes, ~10 us forward at the benchmark's
// shape (B 32, 16 heads, T 99, hd 64: q, k, v 19.5 MB, the mask 5 MB, ctx
// 6.5 MB at 3.35 TB/s) and ~16 us backward; the products take ~1 and ~3 us
// at the bf16 peak.  What binds first is the elementwise chain between the
// products, for each of the 12,544 scores of a block: the exact roundings,
// expf and an IEEE division forward, and more backward (on an H100 the
// forward without its softmax ran in 0.028 ms of 0.049).  The composition
// moved ~20 MB f32 tensors through device memory some 15 times a
// forward and more backward (0.23 ms forward, 0.63 ms forward + backward
// with the bias gradient, on an H100).
//
// Design:
// - The fast path (T <= 128, hd <= 128): one block per (b, h).  q, k, v
//   (and the backward's dctx), the head's bias and the (b, h) keep-mask are
//   copied into shared memory at the start, all at once (cp.async, 16 bytes
//   a copy; the tiles padded with zeros to 16 rows and 16 dims), so that the
//   softmax reads no device memory.  Products are mma.sync m16n8k16 bf16 ->
//   f32 from ldmatrix fragments.
// - Forward: one warp per 16 query rows, two blocks an SM (128 registers).
//   S and P never leave the registers: the row softmax runs in the
//   accumulators' layout (a row's keys over a quad of lanes) and P is packed
//   in place into the A fragments of P V.  Tiles: 112 keys for the 99 frames
//   of a 2 s window, else 128; head dims 16, 64 or 128.
// - Backward: two warps per 16 query rows, each holding 64 of the keys, so
//   that a block runs 14 warps at T 99 in 128 registers each (one warp a row
//   tile held a row's 112 keys in 228 registers, 7 warps an SM, and took
//   1.6x as long on an H100).  The two warps of a row tile meet at a named
//   barrier to combine each row's max, sum, D and dgate; the forward sums
//   its rows in the same two halves (each in key order over its quad of
//   lanes, then half 0 + half 1), so both compute the same bits.  dP is kept
//   as bf16 pairs (it is rounded there anyway) and gp recomputed where
//   needed; once every warp is past the bias and the mask, bf16(pd) and dS
//   go over them in shared memory, and each warp takes half the head dims of
//   its row tile's dq, and of its 16 keys' dk and dv (ldmatrix.trans of the
//   tiles' transposes).
// - The general path (T > 128 or hd > 128): one warp per query row, exact
//   two passes over the keys (the max, then the sum) before the
//   probabilities, products by FMA over the head dimension in order (the
//   bf16 products are exact in f32, so an FMA is the product then the add);
//   the backward's second launch takes dk and dv one warp per key row from
//   the rows' max, sum and D (a scratch buffer the wrapper allocates).
//   Forward and backward choose the path from the same shape, so both
//   compute the same bits.
// - Nothing is allocated and nothing synchronises with the host: the
//   launches run on the caller's stream and are safe in a CUDA graph
//   capture.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int FAST_MAX_T = 128;   // the fast path: a row's keys in one tile
constexpr int FAST_MAX_HD = 128;  // and a head's dims in one tile
constexpr int PAD = 8;            // bf16 elements a shared row is padded by
constexpr int GEN_WARPS = 8;      // warps a block on the general path
constexpr int GEN_DPL = 4;        // head dims a lane accumulates on the general path
constexpr float NEG_INF = -INFINITY;


__device__ __forceinline__ float bfr(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float* d, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(unsigned* r, const bf16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned* r, const bf16* p) {
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a bf16 pair at p, each element stored where its flag is set
__device__ __forceinline__ void st2(bf16* p, float v0, float v1, bool ok0, bool ok1) {
  if (ok0 && ok1 && !(reinterpret_cast<uintptr_t>(p) & 3)) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  if (ok0) p[0] = __float2bfloat16_rn(v0);
  if (ok1) p[1] = __float2bfloat16_rn(v1);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Args {
  const bf16* qkv;       // (B, T, 3 hidden): q, k, v, each (heads, hd)
  const float* gate;     // (B, T, heads)
  const float* bias;     // (heads, T, T)
  const uint8_t* mask;   // (B, heads, T, T) keep-mask, or null: no dropout
  const bf16* dctx;      // (B, T, hidden), the backward's
  bf16* out;             // forward: ctx (B, T, hidden); backward: dqkv (B, T, 3 hidden)
  float* dgate;          // (B, T, heads), the backward's
  float* dbias_part;     // (B, heads, T, T) partials, or null: no bias gradient
  float* stats;          // (B, heads, T, 3): the general path's row max, sum and D
  int B, T, heads, hd;
  float scale, inv_keep;
};

// s_ij, from the f32 sum of q_i . k_j
__device__ __forceinline__ float score(float qk, float scale, float g, float bias) {
  return __fadd_rn(__fmul_rn(bfr(qk), scale), __fmul_rn(g, bias));
}

// dropout of a probability (or of its gradient): kept * (1 / keep), or 0
__device__ __forceinline__ float dropped(float v, const uint8_t* mask, long long at, float inv) {
  if (mask == nullptr) return v;
  return mask[at] ? __fmul_rn(v, inv) : 0.f;
}

// ---------------------------------------------------------------------------
// the fast path: a (b, h) a block

// rows [0, rows_pad) x columns [0, cols_pad) of a shared bf16 tile (row
// stride ld) from rows src + r * stride, r < rows, of which `cols` columns
// are read; the rest 0
__device__ __forceinline__ void load_tile(bf16* dst, int ld, const bf16* src, long long stride,
                                          int rows, int rows_pad, int cols, int cols_pad) {
  const bool vec = !(reinterpret_cast<uintptr_t>(src) & 15) && !(stride & 7) && !(cols & 7);
  const int chunks = cols_pad / 8;
  for (int idx = threadIdx.x; idx < rows_pad * chunks; idx += blockDim.x) {
    const int r = idx / chunks, c8 = (idx % chunks) * 8;
    bf16* d = dst + r * ld + c8;
    const bf16* s = src + r * stride + c8;
    if (vec && r < rows && c8 < cols) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (r < rows && c8 + e < cols) ? s[e] : __float2bfloat16_rn(0.f);
    }
  }
}

// `bytes` bytes at src (any alignment) into shared memory at dst (16-byte
// aligned, round16(bytes) + 32 bytes of room) by 16-byte copies of the
// aligned granules that hold them (a granule never crosses a page, so the
// few bytes read around the span cannot fault); returns where src[0] landed
__device__ __forceinline__ const unsigned char* stage_bytes(unsigned char* dst, const void* src,
                                                            long long bytes) {
  const uintptr_t s = reinterpret_cast<uintptr_t>(src), s0 = s & ~uintptr_t(15);
  const long long n = (long long)(((s + bytes + 15) & ~uintptr_t(15)) - s0);
  for (long long i = 16LL * threadIdx.x; i < n; i += 16LL * blockDim.x)
    cp_async16(dst + i, reinterpret_cast<const void*>(s0 + i));
  return dst + (s - s0);
}

// shared bytes stage_bytes takes for `bytes`
__host__ __device__ __forceinline__ size_t staged(long long bytes) {
  return (size_t)((bytes + 15) & ~15LL) + 32;
}

// acc (NT n-tiles of 8 keys from key k0) = the warp's 16 rows of A (from
// row m0 of a shared tile) times B^T (B's rows the keys), summed over HD in
// order: q k^T, and the backward's dctx v^T.  Key tiles past T are skipped.
template <int HD, int NT>
__device__ __forceinline__ void rows_by_keys(float (&acc)[NT][4], const bf16* A, const bf16* Bt,
                                             int ld, int m0, int k0, int T, int lane) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    unsigned a[4];
    ldsm_x4(a, A + (m0 + (lane & 15)) * ld + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      if (k0 + np * 16 < T) {
        unsigned b[4];
        ldsm_x4(b, Bt + (k0 + np * 16 + r + 8 * (q >> 1)) * ld + kk * 16 + 8 * (q & 1));
        mma16816(acc[2 * np], a, b[0], b[1]);
        mma16816(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// What a lane holds of a warp's 16-row tile of keys from k0: rows r0 = m0 +
// lane / 4 and r0 + 8; in n-tile n the keys k0 + 8n + 2 (lane % 4) and the
// next; element e of the accumulator is (row r0 + 8 (e / 2), key k0 + c0 +
// 8n + e % 2).
struct Lane {
  int r0, c0, k0;
  bool row_ok[2];
  float g[2];
  __device__ Lane(const Args& a, int b, int h, int m0, int k0_, int lane)
      : r0(m0 + (lane >> 2)), c0(2 * (lane & 3)), k0(k0_) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = r0 + 8 * hr;
      row_ok[hr] = row < a.T;
      g[hr] = row_ok[hr] ? a.gate[((long long)b * a.T + row) * a.heads + h] : 0.f;
    }
  }
  __device__ int row(int e) const { return r0 + 8 * (e >> 1); }
  __device__ int col(int n, int e) const { return k0 + c0 + 8 * n + (e & 1); }
  __device__ bool ok(int n, int e, int T) const { return row_ok[e >> 1] && col(n, e) < T; }
};

// The softmax's arithmetic, in place from the scores q k^T in acc (0 outside
// T x T), with the head's bias (T x T) from shared memory.  A row's max, and
// its sum as two halves of 64 keys, each summed in key order by the quad of
// lanes that holds it and reduced over the quad, then half 0 + half 1: the
// forward holds both halves in one warp; the backward's two warps of a row
// tile hold one each and meet in shared memory (exchange), with the same
// bits.
__device__ __forceinline__ float score_at(float qk, const float* bias, const Args& a,
                                          const Lane& L, int n, int e) {
  return score(qk, a.scale, L.g[e >> 1], bias[L.row(e) * a.T + L.col(n, e)]);
}

// the scores to s (NEG_INF outside) and each row's max over this warp's keys
template <int NT>
__device__ __forceinline__ void scores_max(float (&acc)[NT][4], const float* bias, const Args& a,
                                           const Lane& L, float (&mx)[2]) {
  mx[0] = mx[1] = NEG_INF;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = NEG_INF;
      if (L.ok(n, e, a.T)) {
        s = score_at(acc[n][e], bias, a, L, n, e);
        mx[e >> 1] = fmaxf(mx[e >> 1], s);
      }
      acc[n][e] = s;
    }
  mx[0] = quad_max(mx[0]);
  mx[1] = quad_max(mx[1]);
}

// exp(s - max) in place, the rows' sums over n-tiles [n0, n1) in key order
template <int NT>
__device__ __forceinline__ void exps_sum(float (&acc)[NT][4], const float (&mx)[2], int n0,
                                         int n1, float (&sum)[2]) {
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    if (n < n0 || n >= n1) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = acc[n][e] == NEG_INF ? 0.f : expf(__fsub_rn(acc[n][e], mx[e >> 1]));
      sum[e >> 1] = __fadd_rn(sum[e >> 1], x);
      acc[n][e] = x;
    }
  }
  sum[0] = quad_sum(sum[0]);
  sum[1] = quad_sum(sum[1]);
}

template <int NT>
__device__ __forceinline__ void divide(float (&acc)[NT][4], const Lane& L, const float (&sum)[2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n][e] = L.row_ok[e >> 1] ? __fdiv_rn(acc[n][e], sum[e >> 1]) : 0.f;
}

// the forward's: one warp, both halves (NT up to 16)
template <int NT>
__device__ __forceinline__ void probs(float (&acc)[NT][4], const float* bias, const Args& a,
                                      const Lane& L) {
  float mx[2], s0[2], s1[2], sum[2];
  scores_max<NT>(acc, bias, a, L, mx);
  exps_sum<NT>(acc, mx, 0, 8, s0);
  exps_sum<NT>(acc, mx, 8, NT, s1);
  sum[0] = __fadd_rn(s0[0], s1[0]);
  sum[1] = __fadd_rn(s0[1], s1[1]);
  divide<NT>(acc, L, sum);
}

// The two warps of a row tile (64 threads) meet at named barrier 1 + tile.
__device__ __forceinline__ void pair_sync(int tile) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + tile) : "memory");
}

// A per-row value of each of a row tile's two warps, combined: each warp's
// lane 0 of a quad writes its rows' value into ex[half][16], both read both.
struct Exchange {
  float* ex;  // [2][16] of this row tile
  int tile, half;
  __device__ void put(const Lane& L, const float (&v)[2], int m0) const {
    if ((threadIdx.x & 3) == 0) {
      ex[16 * half + L.r0 - m0] = v[0];
      ex[16 * half + L.r0 - m0 + 8] = v[1];
    }
    pair_sync(tile);
  }
  __device__ float get(const Lane& L, int hr, int h, int m0) const {
    return ex[16 * h + L.r0 - m0 + 8 * hr];
  }
};

// acc's keys in pairs of n-tiles as bf16 A fragments, k-step kk
template <int NT>
__device__ __forceinline__ void to_a(unsigned (&fr)[NT / 2][4], const float (&acc)[NT][4]) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    fr[kk][0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
    fr[kk][1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
    fr[kk][2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
    fr[kk][3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
  }
}

// out rows (the lane's two) = fr (16 rows x keys, bf16) times the shared
// tile Bs (keys x HD, row-major), summed over the keys in order; stored bf16
// at out + row * stride for dims under hd
template <int HD, int NT>
__device__ __forceinline__ void rows_times_tile(const unsigned (&fr)[NT / 2][4], const bf16* Bs,
                                                int ld, int T, int hd, const Lane& L, bf16* out,
                                                long long stride, int lane) {
  const int q = lane >> 3, r = lane & 7;
#pragma unroll
  for (int dp = 0; dp < HD / 16; ++dp) {
    if (dp * 16 >= hd) break;
    float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      if (kk * 16 < T) {
        unsigned b[4];
        ldsm_x4_trans(b, Bs + (kk * 16 + r + 8 * (q & 1)) * ld + dp * 16 + 8 * (q >> 1));
        mma16816(o[0], fr[kk], b[0], b[1]);
        mma16816(o[1], fr[kk], b[2], b[3]);
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int d = dp * 16 + 8 * t + L.c0;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (L.row_ok[hr])
          st2(out + (long long)(L.r0 + 8 * hr) * stride + d, o[t][2 * hr], o[t][2 * hr + 1],
              d < hd, d + 1 < hd);
    }
  }
}

// out rows m0.. (16, the lane's two) of A B, A from a shared (rows x keys)
// tile (when TRANS, At holds its transpose, keys x rows), B a shared (keys x
// HD) tile; summed over the T16 keys in order, for the dim pairs (16 dims)
// half, half + 2, ... under hd; stored bf16 at out + row * stride
template <int HD, bool TRANS>
__device__ __forceinline__ void tile_times_tile(const bf16* At, int lda, const bf16* Bs, int ld,
                                                int m0, int T16, int hd, int half, const Lane& L,
                                                bf16* out, long long stride, int lane) {
  constexpr int NDP = (HD / 16 + 1) / 2;  // dim pairs of one warp of the pair
  const int q = lane >> 3, r = lane & 7;
  float o[2 * NDP][4];
#pragma unroll
  for (int n = 0; n < 2 * NDP; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  for (int kk = 0; kk < T16 / 16; ++kk) {
    unsigned a[4];
    if (TRANS)
      ldsm_x4_trans(a, At + (kk * 16 + r + 8 * (q >> 1)) * lda + m0 + 8 * (q & 1));
    else
      ldsm_x4(a, At + (m0 + (lane & 15)) * lda + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int j = 0; j < NDP; ++j) {
      const int dp = half + 2 * j;
      if (dp < HD / 16 && dp * 16 < hd) {
        unsigned b[4];
        ldsm_x4_trans(b, Bs + (kk * 16 + r + 8 * (q & 1)) * ld + dp * 16 + 8 * (q >> 1));
        mma16816(o[2 * j], a, b[0], b[1]);
        mma16816(o[2 * j + 1], a, b[2], b[3]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < 2 * NDP; ++n) {
    const int d = 16 * (half + 2 * (n >> 1)) + 8 * (n & 1) + L.c0;
    if (d < hd)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        if (L.row_ok[hr])
          st2(out + (long long)(L.r0 + 8 * hr) * stride + d, o[n][2 * hr], o[n][2 * hr + 1],
              true, d + 1 < hd);
  }
}

// the shared memory of a fast forward: q, k, v tiles, then the head's bias
// and the (b, h) keep-mask as stage_bytes leaves them
__host__ __device__ __forceinline__ size_t tiles_bytes(int T, int HD, int n) {
  return (size_t)n * ((T + 15) & ~15) * (HD + PAD) * sizeof(bf16);
}

template <int HD, int KT>
__global__ void __launch_bounds__(2 * KT, 2) attn_fwd_fast(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, T = a.T, T16 = (T + 15) & ~15, ld = HD + PAD;
  const int hidden = a.heads * a.hd;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + T16 * ld;
  bf16* Vs = Ks + T16 * ld;
  unsigned char* rest = smem + tiles_bytes(T, HD, 3);
  const long long rs = 3LL * hidden, tt = (long long)T * T;
  const bf16* base = a.qkv + (long long)b * T * rs + (long long)h * a.hd;
  load_tile(Qs, ld, base, rs, T, T16, a.hd, HD);
  load_tile(Ks, ld, base + hidden, rs, T, T16, a.hd, HD);
  load_tile(Vs, ld, base + 2 * hidden, rs, T, T16, a.hd, HD);
  const float* bias =
      reinterpret_cast<const float*>(stage_bytes(rest, a.bias + h * tt, 4 * tt));
  const uint8_t* mask =
      a.mask == nullptr ? nullptr
                        : stage_bytes(rest + staged(4 * tt), a.mask + ((long long)b * a.heads + h) * tt, tt);
  cp_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31, m0 = (threadIdx.x >> 5) * 16;
  const Lane L(a, b, h, m0, 0, lane);
  float acc[KT / 8][4];
  rows_by_keys<HD, KT / 8>(acc, Qs, Ks, ld, m0, 0, T, lane);
  probs<KT / 8>(acc, bias, a, L);
  if (mask != nullptr) {
#pragma unroll
    for (int n = 0; n < KT / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (L.ok(n, e, T))
          acc[n][e] = dropped(acc[n][e], mask, L.row(e) * T + L.col(n, e), a.inv_keep);
  }
  unsigned pa[KT / 16][4];
  to_a<KT / 8>(pa, acc);
  rows_times_tile<HD, KT / 8>(pa, Vs, ld, T, a.hd, L, a.out + (long long)b * T * hidden +
                              (long long)h * a.hd, hidden, lane);
}

// bf16 pairs of a warp's 16-row tile of keys from L.k0, packed as to_a packs
// them, into a shared (rows x keys) tile (row stride ldp) at the lane's
// places, keys under T16
template <int NT>
__device__ __forceinline__ void store_tile(bf16* dst, int ldp, const unsigned (&fr)[NT / 2][4],
                                           const Lane& L, int T16) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    if (L.k0 + 16 * kk >= T16) break;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *reinterpret_cast<unsigned*>(dst + (L.r0 + 8 * (i & 1)) * ldp + L.k0 + 16 * kk +
                                   8 * (i >> 1) + L.c0) = fr[kk][i];
  }
}

// the shared memory of a fast backward: q, k, v and dctx tiles, then either
// the staged bias and mask (while the probabilities' gradients are taken)
// or bf16(pd) and dS (from then on), then the row tiles' exchanges
constexpr int EXCHANGES = 4;  // the max, the sum, D, dgate
__host__ __device__ __forceinline__ size_t bwd_rest_bytes(int T) {
  const long long tt = (long long)T * T;
  const int T16 = (T + 15) & ~15;
  const size_t staged_bytes = staged(4 * tt) + staged(tt);
  const size_t pd_ds = 2 * (size_t)T16 * (T16 + PAD) * sizeof(bf16);
  return staged_bytes > pd_ds ? staged_bytes : pd_ds;
}

__host__ __device__ __forceinline__ size_t exchange_bytes(int T) {
  return (size_t)EXCHANGES * ((T + 15) / 16) * 2 * 16 * sizeof(float);
}

// Two warps a 16-row tile, each holding 64 keys (keys 64 half + ...): at
// most 16 warps.
template <int HD>
__global__ void __launch_bounds__(512) attn_bwd_fast(const Args a) {
  constexpr int NT = 8;  // n-tiles of a warp's half of the keys
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x, b = blockIdx.y, T = a.T, T16 = (T + 15) & ~15, ld = HD + PAD;
  const int ldp = T16 + PAD, hidden = a.heads * a.hd, tiles = T16 / 16;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + T16 * ld;
  bf16* Vs = Ks + T16 * ld;
  bf16* Os = Vs + T16 * ld;  // dctx
  unsigned char* rest = smem + tiles_bytes(T, HD, 4);
  bf16* Ps = reinterpret_cast<bf16*>(rest);  // bf16(pd), (query, key), after the bias
  bf16* Ss = Ps + T16 * ldp;  // dS, (query, key)
  float* ex = reinterpret_cast<float*>(rest + bwd_rest_bytes(T));
  const long long rs = 3LL * hidden, tt = (long long)T * T, bh = (long long)b * a.heads + h;
  const bf16* base = a.qkv + (long long)b * T * rs + (long long)h * a.hd;
  load_tile(Qs, ld, base, rs, T, T16, a.hd, HD);
  load_tile(Ks, ld, base + hidden, rs, T, T16, a.hd, HD);
  load_tile(Vs, ld, base + 2 * hidden, rs, T, T16, a.hd, HD);
  load_tile(Os, ld, a.dctx + (long long)b * T * hidden + (long long)h * a.hd, hidden, T, T16,
            a.hd, HD);
  const float* bias =
      reinterpret_cast<const float*>(stage_bytes(rest, a.bias + h * tt, 4 * tt));
  const uint8_t* mask =
      a.mask == nullptr ? nullptr : stage_bytes(rest + staged(4 * tt), a.mask + bh * tt, tt);
  cp_wait_all();
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = warp >> 1, half = warp & 1, m0 = 16 * tile;
  const Lane L(a, b, h, m0, 64 * half, lane);
  Exchange xch[EXCHANGES];
#pragma unroll
  for (int k = 0; k < EXCHANGES; ++k) xch[k] = {ex + (k * tiles + tile) * 32, tile, half};
  // dP = bf16(dctx v^T), kept as bf16 pairs (e 0-1, e 2-3 of each n-tile)
  unsigned dpk[NT][2];
  {
    float dp[NT][4];
    rows_by_keys<HD, NT>(dp, Os, Vs, ld, m0, L.k0, T, lane);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      dpk[n][0] = pack_bf16(dp[n][0], dp[n][1]);
      dpk[n][1] = pack_bf16(dp[n][2], dp[n][3]);
    }
  }
  // p, the two warps' halves of each row meeting for its max and its sum
  float p[NT][4];
  rows_by_keys<HD, NT>(p, Qs, Ks, ld, m0, L.k0, T, lane);
  {
    float mx[2], sum[2];
    scores_max<NT>(p, bias, a, L, mx);
    xch[0].put(L, mx, m0);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) mx[hr] = fmaxf(xch[0].get(L, hr, 0, m0), xch[0].get(L, hr, 1, m0));
    exps_sum<NT>(p, mx, 0, NT, sum);
    xch[1].put(L, sum, m0);
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      sum[hr] = __fadd_rn(xch[1].get(L, hr, 0, m0), xch[1].get(L, hr, 1, m0));
    divide<NT>(p, L, sum);
  }

  // gp = dPs * p, from p and the bf16 dP (again wherever it is needed)
  auto gp = [&](int n, int e, int at) {
    const float2 d = unpack_bf16(dpk[n][e >> 1]);
    return __fmul_rn(dropped((e & 1) ? d.y : d.x, mask, at, a.inv_keep), p[n][e]);
  };
  // bf16(pd) as A fragments; the rows' sums D of gp
  unsigned pa[NT / 2][4];
  float dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float pd[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = L.row(e) * T + L.col(n, e);
      const bool ok = L.ok(n, e, T);
      pd[e] = ok ? dropped(p[n][e], mask, at, a.inv_keep) : 0.f;
      if (ok) dsum[e >> 1] = __fadd_rn(dsum[e >> 1], gp(n, e, at));
    }
    pa[n >> 1][2 * (n & 1)] = pack_bf16(pd[0], pd[1]);
    pa[n >> 1][2 * (n & 1) + 1] = pack_bf16(pd[2], pd[3]);
  }
  dsum[0] = quad_sum(dsum[0]);
  dsum[1] = quad_sum(dsum[1]);
  xch[2].put(L, dsum, m0);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    dsum[hr] = __fadd_rn(xch[2].get(L, hr, 0, m0), xch[2].get(L, hr, 1, m0));

  // dscore = gp - p D; dgate; the bias partials; dS = bf16(dscore * scale)
  float dg[2] = {0.f, 0.f};
  float* part = a.dbias_part == nullptr ? nullptr : a.dbias_part + bh * tt;
  unsigned sa[NT / 2][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1, at = L.row(e) * T + L.col(n, e);
      ds[e] = 0.f;
      if (L.ok(n, e, T)) {
        ds[e] = __fmaf_rn(-p[n][e], dsum[hr], gp(n, e, at));
        dg[hr] = __fadd_rn(dg[hr], __fmul_rn(ds[e], bias[at]));
        if (part != nullptr) part[at] = __fmul_rn(ds[e], L.g[hr]);
      }
    }
    sa[n >> 1][2 * (n & 1)] = pack_bf16(__fmul_rn(ds[0], a.scale), __fmul_rn(ds[1], a.scale));
    sa[n >> 1][2 * (n & 1) + 1] =
        pack_bf16(__fmul_rn(ds[2], a.scale), __fmul_rn(ds[3], a.scale));
  }
  dg[0] = quad_sum(dg[0]);
  dg[1] = quad_sum(dg[1]);
  xch[3].put(L, dg, m0);
  if (half == 0 && (lane & 3) == 0)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if (L.row_ok[hr])
        a.dgate[((long long)b * T + L.r0 + 8 * hr) * a.heads + h] =
            __fadd_rn(xch[3].get(L, hr, 0, m0), xch[3].get(L, hr, 1, m0));

  // bf16(pd) and dS into shared memory over the bias and the mask
  __syncthreads();
  store_tile<NT>(Ps, ldp, pa, L, T16);
  store_tile<NT>(Ss, ldp, sa, L, T16);
  __syncthreads();

  // dq = dS k for this row tile; dv = bf16(pd)^T dctx and dk = dS^T q for
  // its 16 keys; each warp of the pair half the dim pairs
  bf16* dq = a.out + (long long)b * T * rs + (long long)h * a.hd;
  tile_times_tile<HD, false>(Ss, ldp, Ks, ld, m0, T16, a.hd, half, L, dq, rs, lane);
  tile_times_tile<HD, true>(Ps, ldp, Os, ld, m0, T16, a.hd, half, L, dq + 2 * hidden, rs, lane);
  tile_times_tile<HD, true>(Ss, ldp, Qs, ld, m0, T16, a.hd, half, L, dq + hidden, rs, lane);
}

// ---------------------------------------------------------------------------
// the general path: a row (or a key) a warp

struct Gen {
  const Args& a;
  int b, h, hidden;
  long long rs;
  __device__ Gen(const Args& a_, int b_, int h_)
      : a(a_), b(b_), h(h_), hidden(a_.heads * a_.hd), rs(3LL * a_.heads * a_.hd) {}
  __device__ const bf16* q(int i) const {
    return a.qkv + ((long long)b * a.T + i) * rs + (long long)h * a.hd;
  }
  __device__ const bf16* k(int j) const { return q(j) + hidden; }
  __device__ const bf16* v(int j) const { return q(j) + 2 * hidden; }
  __device__ const bf16* o(int i) const {
    return a.dctx + ((long long)b * a.T + i) * hidden + (long long)h * a.hd;
  }
  __device__ float gate(int i) const { return a.gate[((long long)b * a.T + i) * a.heads + h]; }
  __device__ long long at(int i, int j) const {
    return (((long long)b * a.heads + h) * a.T + i) * a.T + j;
  }
  __device__ float s(int i, int j, float g) const {
    return score(dot(q(i), k(j)), a.scale, g, a.bias[((long long)h * a.T + i) * a.T + j]);
  }
  __device__ float dot(const bf16* x, const bf16* y) const {
    float acc = 0.f;
    for (int d = 0; d < a.hd; ++d)
      acc = __fmaf_rn(__bfloat162float(x[d]), __bfloat162float(y[d]), acc);
    return acc;
  }
  // the row's max and sum: two exact passes over the keys
  __device__ float2 stats(int i, float g, int lane) const {
    float mx = NEG_INF;
    for (int j = lane; j < a.T; j += 32) mx = fmaxf(mx, s(i, j, g));
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < a.T; j += 32) sum = __fadd_rn(sum, expf(__fsub_rn(s(i, j, g), mx)));
    return make_float2(mx, warp_sum(sum));
  }
  __device__ float p(int i, int j, float g, float2 st) const {
    return __fdiv_rn(expf(__fsub_rn(s(i, j, g), st.x)), st.y);
  }
  __device__ float pd(float pv, int i, int j) const {
    return dropped(pv, a.mask, at(i, j), a.inv_keep);
  }
  // gp = dPs * p
  __device__ float gp(float pv, int i, int j) const {
    return __fmul_rn(dropped(bfr(dot(o(i), v(j))), a.mask, at(i, j), a.inv_keep), pv);
  }
  __device__ void store(bf16* out, long long stride, int row, const float* acc, int d0,
                        int lane) const {
    bf16* dst = out + ((long long)b * a.T + row) * stride + (long long)h * a.hd;
#pragma unroll
    for (int r = 0; r < GEN_DPL; ++r) {
      const int d = d0 + lane + 32 * r;
      if (d < a.hd) dst[d] = __float2bfloat16_rn(acc[r]);
    }
  }
};

// acc[r] (dims d0 + lane + 32 r) += x_jj * rows(jj)[d] for the 32 broadcast x
template <typename Rows>
__device__ __forceinline__ void accumulate(float* acc, float x, int n, Rows rows, int d0, int hd,
                                           int lane) {
  for (int jj = 0; jj < n; ++jj) {
    const float xj = __shfl_sync(0xffffffffu, x, jj);
    const bf16* row = rows(jj);
#pragma unroll
    for (int r = 0; r < GEN_DPL; ++r) {
      const int d = d0 + lane + 32 * r;
      if (d < hd) acc[r] = __fmaf_rn(xj, __bfloat162float(row[d]), acc[r]);
    }
  }
}

// the warp's (b, h, row) on the general path, or false past the last row
__device__ __forceinline__ bool gen_row(const Args& a, int& b, int& h, int& i) {
  const long long w = (long long)blockIdx.x * GEN_WARPS + (threadIdx.x >> 5);
  if (w >= (long long)a.B * a.heads * a.T) return false;
  i = (int)(w % a.T);
  h = (int)((w / a.T) % a.heads);
  b = (int)(w / ((long long)a.T * a.heads));
  return true;
}

__global__ void __launch_bounds__(32 * GEN_WARPS) attn_fwd_general(const Args a) {
  int b, h, i;
  if (!gen_row(a, b, h, i)) return;
  const int lane = threadIdx.x & 31;
  const Gen G(a, b, h);
  const float g = G.gate(i);
  const float2 st = G.stats(i, g, lane);
  for (int d0 = 0; d0 < a.hd; d0 += 32 * GEN_DPL) {
    float acc[GEN_DPL] = {};
    for (int j0 = 0; j0 < a.T; j0 += 32) {
      const int j = j0 + lane;
      const float x = j < a.T ? bfr(G.pd(G.p(i, j, g, st), i, j)) : 0.f;
      accumulate(acc, x, min(32, a.T - j0), [&](int jj) { return G.v(j0 + jj); }, d0, a.hd,
                 lane);
    }
    G.store(a.out, G.hidden, i, acc, d0, lane);
  }
}

// the backward's rows: D, dq, dgate, the bias partials, and the row stats
__global__ void __launch_bounds__(32 * GEN_WARPS) attn_bwd_general_rows(const Args a) {
  int b, h, i;
  if (!gen_row(a, b, h, i)) return;
  const int lane = threadIdx.x & 31;
  const Gen G(a, b, h);
  const float g = G.gate(i);
  const float2 st = G.stats(i, g, lane);
  float dsum = 0.f;
  for (int j = lane; j < a.T; j += 32) dsum = __fadd_rn(dsum, G.gp(G.p(i, j, g, st), i, j));
  dsum = warp_sum(dsum);
  if (lane == 0) {
    float* out = a.stats + (((long long)b * a.heads + h) * a.T + i) * 3;
    out[0] = st.x;
    out[1] = st.y;
    out[2] = dsum;
  }
  float dg = 0.f;
  const float* bias = a.bias + ((long long)h * a.T + i) * a.T;
  for (int d0 = 0; d0 < a.hd; d0 += 32 * GEN_DPL) {
    float acc[GEN_DPL] = {};
    for (int j0 = 0; j0 < a.T; j0 += 32) {
      const int j = j0 + lane;
      float x = 0.f;
      if (j < a.T) {
        const float pv = G.p(i, j, g, st);
        const float ds = __fmaf_rn(-pv, dsum, G.gp(pv, i, j));
        if (d0 == 0) {
          dg = __fadd_rn(dg, __fmul_rn(ds, bias[j]));
          if (a.dbias_part != nullptr) a.dbias_part[G.at(i, j)] = __fmul_rn(ds, g);
        }
        x = bfr(__fmul_rn(ds, a.scale));
      }
      accumulate(acc, x, min(32, a.T - j0), [&](int jj) { return G.k(j0 + jj); }, d0, a.hd,
                 lane);
    }
    G.store(a.out, G.rs, i, acc, d0, lane);
  }
  dg = warp_sum(dg);
  if (lane == 0) a.dgate[((long long)b * a.T + i) * a.heads + h] = dg;
}

// the backward's keys: dk and dv of key j from the rows' stats
__global__ void __launch_bounds__(32 * GEN_WARPS) attn_bwd_general_keys(const Args a) {
  int b, h, j;
  if (!gen_row(a, b, h, j)) return;
  const int lane = threadIdx.x & 31;
  const Gen G(a, b, h);
  const float* stats = a.stats + ((long long)b * a.heads + h) * a.T * 3;
  for (int d0 = 0; d0 < a.hd; d0 += 32 * GEN_DPL) {
    float dk[GEN_DPL] = {}, dv[GEN_DPL] = {};
    for (int i0 = 0; i0 < a.T; i0 += 32) {
      const int i = i0 + lane;
      float x = 0.f, y = 0.f;
      if (i < a.T) {
        const float2 st = make_float2(stats[3 * i], stats[3 * i + 1]);
        const float pv = G.p(i, j, G.gate(i), st);
        x = bfr(G.pd(pv, i, j));
        y = bfr(__fmul_rn(__fmaf_rn(-pv, stats[3 * i + 2], G.gp(pv, i, j)), a.scale));
      }
      const int n = min(32, a.T - i0);
      accumulate(dv, x, n, [&](int ii) { return G.o(i0 + ii); }, d0, a.hd, lane);
      accumulate(dk, y, n, [&](int ii) { return G.q(i0 + ii); }, d0, a.hd, lane);
    }
    G.store(a.out + G.hidden, G.rs, j, dk, d0, lane);
    G.store(a.out + 2 * G.hidden, G.rs, j, dv, d0, lane);
  }
}

// dbias = the partials summed over the batch, in order
__global__ void bias_sum_kernel(const float* part, float* out, int B, long long n) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += (long long)gridDim.x * blockDim.x) {
    float s = part[idx];
    for (int b = 1; b < B; ++b) s = __fadd_rn(s, part[b * n + idx]);
    out[idx] = s;
  }
}

// ---------------------------------------------------------------------------
// launches

bool fast(int T, int hd) { return T <= FAST_MAX_T && hd <= FAST_MAX_HD; }

size_t fwd_smem(int T, int HD, bool mask) {
  const long long tt = (long long)T * T;
  return tiles_bytes(T, HD, 3) + staged(4 * tt) + (mask ? staged(tt) : 0);
}

size_t bwd_smem(int T, int HD) {
  return tiles_bytes(T, HD, 4) + bwd_rest_bytes(T) + exchange_bytes(T);
}

template <typename Kernel>
int launch_kernel(Kernel kernel, const Args& a, size_t smem, int threads, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(a.heads, a.B), threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// the fast forward's tiles: 112 keys where a head of 64 has 97 to 112 (a 2
// s window's 99 frames), else 128; one warp a 16-row tile
template <int HD>
int launch_fwd(const Args& a, cudaStream_t stream) {
  const size_t smem = fwd_smem(a.T, HD, a.mask != nullptr);
  const int threads = 2 * ((a.T + 15) & ~15);
  if constexpr (HD == 64)
    if (((a.T + 15) & ~15) == 112)
      return launch_kernel(attn_fwd_fast<HD, 112>, a, smem, threads, stream);
  return launch_kernel(attn_fwd_fast<HD, 128>, a, smem, threads, stream);
}

// the fast backward: two warps a 16-row tile
template <int HD>
int launch_bwd(const Args& a, cudaStream_t stream) {
  return launch_kernel(attn_bwd_fast<HD>, a, bwd_smem(a.T, HD), 4 * ((a.T + 15) & ~15), stream);
}

// the fast path's head dims: 16, 64 or 128
int launch(const Args& a, bool backward, cudaStream_t stream) {
  if (fast(a.T, a.hd)) {
    if (a.hd <= 16) return backward ? launch_bwd<16>(a, stream) : launch_fwd<16>(a, stream);
    if (a.hd <= 64) return backward ? launch_bwd<64>(a, stream) : launch_fwd<64>(a, stream);
    return backward ? launch_bwd<128>(a, stream) : launch_fwd<128>(a, stream);
  }
  const long long rows = (long long)a.B * a.heads * a.T;
  const unsigned blocks = (unsigned)((rows + GEN_WARPS - 1) / GEN_WARPS);
  if (!backward) {
    attn_fwd_general<<<blocks, 32 * GEN_WARPS, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  attn_bwd_general_rows<<<blocks, 32 * GEN_WARPS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_general_keys<<<blocks, 32 * GEN_WARPS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

bool bad(int B, int T, int heads, int hd) { return B < 1 || T < 1 || heads < 1 || hd < 1; }

}  // namespace

extern "C" {

const char* sept_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The f32 scratch a backward takes (the general path's row max, sum and D:
// B * heads * T * 3), 0 on the fast path (pass null).
long long sept_attn_stats_floats(int B, int T, int heads, int hd) {
  return fast(T, hd) ? 0 : 3LL * B * heads * T;
}

// The forward: qkv (B, T, 3 heads hd) bf16, gate (B, T, heads) f32, bias
// (heads, T, T) f32, mask (B, heads, T, T) bool or null; writes ctx (B, T,
// heads hd) bf16.  scale = f32(1 / sqrt(hd)); inv_keep = 1 / keep in f32.
int sept_attn_fwd(const void* qkv, const float* gate, const float* bias, const void* mask,
                  void* ctx, int B, int T, int heads, int hd, float scale, float inv_keep,
                  void* stream) {
  if (bad(B, T, heads, hd)) return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(qkv), gate, bias, static_cast<const uint8_t*>(mask),
               nullptr, static_cast<bf16*>(ctx), nullptr, nullptr, nullptr, B, T, heads, hd,
               scale, inv_keep};
  return launch(a, false, (cudaStream_t)stream);
}

// The backward: the forward's inputs and dctx (B, T, heads hd) bf16; writes
// dqkv (B, T, 3 heads hd) bf16 and dgate (B, T, heads) f32; where dbias is
// not null, dbias_part (B, heads, T, T) f32 is the partials' scratch and
// dbias (heads, T, T) f32 their sum over the batch; stats the scratch of
// sept_attn_stats_floats (null where that is 0).
int sept_attn_bwd(const void* qkv, const float* gate, const float* bias, const void* mask,
                  const void* dctx, void* dqkv, float* dgate, float* dbias_part, float* dbias,
                  float* stats, int B, int T, int heads, int hd, float scale, float inv_keep,
                  void* stream) {
  if (bad(B, T, heads, hd) || (dbias == nullptr) != (dbias_part == nullptr) ||
      (stats == nullptr) != (sept_attn_stats_floats(B, T, heads, hd) == 0))
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const bf16*>(qkv), gate, bias, static_cast<const uint8_t*>(mask),
               static_cast<const bf16*>(dctx), static_cast<bf16*>(dqkv), dgate, dbias_part,
               stats, B, T, heads, hd, scale, inv_keep};
  const int err = launch(a, true, (cudaStream_t)stream);
  if (err || dbias == nullptr) return err;
  const long long n = (long long)heads * T * T;
  const unsigned blocks = (unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  bias_sum_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(dbias_part, dbias, B, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
