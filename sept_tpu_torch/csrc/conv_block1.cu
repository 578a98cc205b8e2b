// First conv block of Conv2dBiRNN, forward and backward, for Hopper (sm_90a).
//
// Replaces the kernels of sept_tpu/ops/pallas_conv.py:
//   K1 _k1_conv_stats -> sept_conv_stats: conv 5x5, 1 -> C channels, SAME,
//      + bias, stored NCHW, and the per-channel sum of y and of y^2 over the
//      batch (the BatchNorm batch moments) of the stored values;
//   K2 _k2_norm_pool  -> sept_norm_pool: y * a[c] + b[c] (BatchNorm folded to
//      one scale and shift), ReLU, 2x2 stride-2 max pool, NCHW out;
//   K3 _k3_route -> sept_route: recompute z = relu(y * a[c] + b[c]) exactly
//      as K2 rounds it, route each pooled cotangent to the FIRST maximum of
//      its 2x2 window in row-major order, apply the ReLU mask (gradient 0
//      where the BN output is <= 0), store dy NCHW, and reduce per channel
//      sum(dy) and sum(dy * xhat) with xhat = (y - mean[c]) * inv[c];
//   K4 _k4_grads -> sept_weight_grads: dconv = ga[c] * (dy - m1[c] -
//      xhat * m2[c]) recomputed in registers (never stored), dW[c, dh, dw] =
//      sum over batch and space of x(h + dh - 2, w + dw - 2) * dconv(h, w)
//      and db[c] = sum dconv (weight_grads_kernel; weight_grads_mma_kernel
//      in bf16 on the tensor cores);
//   K5 _k5_dx -> sept_input_grad: dx(h, w) = sum_c sum_taps W[c, dh, dw] *
//      dconv(c, h - dh + 2, w - dw + 2), SAME borders: the correlation of
//      dconv with the flipped kernel.
//
// Two modes, the TPU kernels' cdtype.  f32 (sept_*): every tensor f32.  bf16
// (sept_*_bf16): the conv output, the pooled values and dy are stored in
// bf16, and the operands of the products are rounded to bf16 where the TPU
// kernels cast them: x and the weights in K1, x and dconv in K4 (db sums the
// unrounded f32 dconv), dconv and the weights in K5.  K2 rounds z before its
// max, K3 compares the same rounded z.  A product of two bf16 values is exact
// in f32, so f32 FMAs over rounded operands are the numerics class of the
// MXU's bf16 x bf16 -> f32: the bf16 mode shares the f32 kernels' tiling,
// templated on the storage type.  Sums, moments, dW, db and dx stay f32.
//
// What bounds them on the H100: bytes.  K1 does 25 multiply-adds per output
// element but writes C = 32 values for every input float it reads, and K2
// reads those back to write a quarter of them; at the serving shapes the
// conv output (B, 32, 200, 128) is 3.3 MB a window in f32, 1.6 MB in bf16,
// so both kernels sit on the memory-rate floor long before the f32 rate.
// K3-K5 each read the conv output, and K4 and K5 also read dy, a tensor of
// the same size; at the training shapes (32, 32, 200, 128) each is 104.9 MB
// in f32 and 52.4 MB in bf16, against at most 26 multiply-adds per element.
// The bf16 mode halves those bytes.
//
// Design:
// - The TPU kernel turned the conv into one banded GEMM and rolled rows to
//   fit Mosaic's (8, 128) tiling; none of that carries over.  Here a block
//   stages a (32+4) x (32+4) input tile with its zero halo (the SAME padding)
//   in shared memory, each thread keeps the 8 x 5 input patch of its four
//   vertically adjacent output pixels in registers, and loops over the C
//   channels with the 25 weights of each read as float4 broadcasts from
//   shared memory.  Every store is a 32-value coalesced row segment.
// - On the TPU the grid ran in order and the kernels carried their sums from
//   one item to the next (pl.when(b == 0)).  Blocks here run in any order,
//   so K1, K3 and K4 each write per-block partial sums to scratch, and one
//   second pass (reduce_partials_kernel) adds each row in double:
//   deterministic (no float atomics), so two runs give the same moments and
//   gradients bit for bit.
// - K2 is elementwise over pooled outputs; it rounds y * a + b as torch's
//   separate multiply and add do (no FMA contraction), so it agrees with its
//   plain version bit for bit.  K3 recomputes z with the same rounding, and
//   K4 and K5 compute dconv in the plain version's order, uncontracted, so
//   that the bf16 rounding of dconv sees the plain version's f32 value.
// - K3 is one thread per 2x2 cell; neighbouring threads read neighbouring
//   pixel pairs.  Cells past the pooled grid (odd H or W, floored as K2
//   floors them) write dy = 0.
// - K4 accumulates over a block's whole pixel range before it reduces.  A
//   block takes one slot -- a row band of at most 25 rows, as even as H
//   allows (H = 200: 8 bands of 25, no ragged tail), and a 128-column tile
//   of one item -- and stages x with its zero halo in shared memory once.
//   f32 mode (and bf16 at widths that are not a multiple of 16): each warp
//   owns one channel of a group of 8, each lane four adjacent columns; the
//   lane slides a 5 x 8 input window down the band (a ring of five staged
//   rows, the row loop unrolled so that nothing moves), reads y and dy as
//   one 16-byte (f32) or 8-byte (bf16) vector a row, two rows ahead of the
//   multiplies, and sums its 25 taps and the bias over all of them; the
//   warp reduces its 26 sums once.  bf16 mode at widths that are a multiple
//   of 16 (the training windows' 128): an implicit GEMM on the tensor cores,
//   mma.sync m16n8k16 bf16 -> f32, taps (25, padded to 32 with zeros) x the
//   block's 32 channels over 16-pixel k-steps; each warp takes a 16-column
//   segment down the band and builds the B fragment (dconv, rounded to bf16)
//   from y and dy and the A fragment (the patches) from the staged tile, and
//   the block sums its 8 warps' tiles once through shared memory.  Either
//   way one slot of partial sums leaves the block, rows ordered dW (C, 25)
//   then db (C,), for reduce_partials_kernel.  What bounds K4: bytes (y and
//   dy, 104.9 MB in f32 and 52.4 MB in bf16 at (32, 32, 200, 128)).  The
//   FMA path issues 100 multiply-adds a lane for every row of four pixels,
//   so in bf16 it was issue-bound and ran no faster than in f32 on the H100:
//   the tensor cores take the products off the CUDA cores.
//   The banded-matrix extraction of the TPU kernel was a Mosaic workaround
//   and is gone.
// - K5 uses K1's geometry: a 32 x 32 output tile, 4 rows a thread, the
//   flipped weights as float4 broadcasts from shared memory; per channel the
//   block stages dconv of the 36 x 36 halo tile in shared memory.
// - Any H and W are taken, in both modes; the pool floors odd sizes as
//   max_pool2d does.  The fixed 200 x 128 geometry of the TPU path and its
//   rule that only the bf16 mode fits its VMEM do not apply here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int TW = 32;                // tile columns (one warp lane each)
constexpr int TH = 32;                // tile rows
constexpr int RPT = 4;                // rows per thread
constexpr int WARPS = TH / RPT;       // 8
constexpr int THREADS = 32 * WARPS;   // 256
constexpr int WPAD = 28;              // 25 taps padded to 7 float4
constexpr int HALO_W = TW + 4, HALO_H = TH + 4;
constexpr int NT = 26;                // K4 sums a channel: 25 taps + bias
constexpr int K4_WARPS = WARPS;       // K4 channels a block, one warp each
constexpr int K4_COLS = 128;          // K4 tile columns, 4 a lane
constexpr int K4_MAX_ROWS = 25;       // K4 rows a band, at most
constexpr int K4_TSTRIDE = K4_COLS + 4;  // floats a staged K4 row (16-byte aligned)

using bf16 = __nv_bfloat16;

// T is the storage type of the conv output, the pooled values and dy: float
// in the f32 mode, bf16 in the bf16 mode.  to_f reads a stored value,
// from_f rounds to the storage type (to nearest even), rnd rounds an operand
// to it and back.
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }

template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// z before the ReLU as K2 and K3 round it: a separate multiply and add, as
// torch's plain version does (no FMA contraction)
__device__ __forceinline__ float bn_affine(float y, float a, float b) {
  return __fadd_rn(__fmul_rn(y, a), b);
}

// the pre-BN cotangent, as _dconv of the TPU kernels, in the plain version's
// order without contraction: xhat = (y - mu) * iv, ga * ((dy - m1) - xhat * m2)
__device__ __forceinline__ float dconv_of(float y, float dy, float ga, float mu, float iv,
                                          float m1, float m2) {
  const float xhat = __fmul_rn(__fsub_rn(y, mu), iv);
  return __fmul_rn(ga, __fsub_rn(__fsub_rn(dy, m1), __fmul_rn(xhat, m2)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

size_t conv_smem_bytes(int C) {
  return sizeof(float) * ((size_t)C * WPAD + C + HALO_H * HALO_W + 2 * WARPS * C);
}

long long conv_blocks(int B, int H, int W) {
  return (long long)((W + TW - 1) / TW) * ((H + TH - 1) / TH) * B;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_stats_kernel(const float* __restrict__ x,     // (B, 1, H, W)
                  const float* __restrict__ w,     // (C, 1, 5, 5)
                  const float* __restrict__ bias,  // (C,)
                  T* __restrict__ y,               // (B, C, H, W)
                  float* __restrict__ partials,    // (2, C, n_blocks)
                  int H, int W, int C, int tiles_x, int tiles_y) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);  // C x WPAD
  float* sb = sw + C * WPAD;                     // C
  float* tile = sb + C;                          // HALO_H x HALO_W
  float* red = tile + HALO_H * HALO_W;           // 2 x WARPS x C

  // one flat grid over (item, row tile, column tile): no 65535 cap on items
  const long long blk = blockIdx.x;
  const int bx = (int)(blk % tiles_x), by = (int)(blk / tiles_x % tiles_y);
  const long long b = blk / ((long long)tiles_x * tiles_y);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c0 = bx * TW, r0 = by * TH;
  const float* xb = x + (long long)b * H * W;

  // operands rounded to the storage type (bf16 mode), the bias not
  for (int i = threadIdx.x; i < C * WPAD; i += THREADS) {
    const int c = i / WPAD, k = i % WPAD;
    sw[i] = k < 25 ? rnd<T>(w[c * 25 + k]) : 0.f;
  }
  for (int i = threadIdx.x; i < C; i += THREADS) sb[i] = bias[i];
  for (int i = threadIdx.x; i < HALO_H * HALO_W; i += THREADS) {
    const int gr = r0 + i / HALO_W - 2, gc = c0 + i % HALO_W - 2;
    tile[i] = (gr >= 0 && gr < H && gc >= 0 && gc < W) ? rnd<T>(xb[(long long)gr * W + gc])
                                                        : 0.f;
  }
  __syncthreads();

  float p[RPT + 4][5];
#pragma unroll
  for (int i = 0; i < RPT + 4; ++i)
#pragma unroll
    for (int j = 0; j < 5; ++j) p[i][j] = tile[(ty * RPT + i) * HALO_W + tx + j];

  const int col = c0 + tx, row0 = r0 + ty * RPT;
  for (int c = 0; c < C; ++c) {
    float wk[WPAD];
    const float4* wc = reinterpret_cast<const float4*>(sw + c * WPAD);
#pragma unroll
    for (int q = 0; q < WPAD / 4; ++q) {
      const float4 v = wc[q];
      wk[4 * q] = v.x; wk[4 * q + 1] = v.y; wk[4 * q + 2] = v.z; wk[4 * q + 3] = v.w;
    }
    const float bc = sb[c];
    T* yc = y + ((long long)b * C + c) * H * W;
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float acc = 0.f;
#pragma unroll
      for (int dh = 0; dh < 5; ++dh)
#pragma unroll
        for (int dw = 0; dw < 5; ++dw) acc = fmaf(p[i + dh][dw], wk[dh * 5 + dw], acc);
      acc += bc;
      if (col < W && row0 + i < H) {
        // the moments are of the stored (rounded) value
        const T st = from_f<T>(acc);
        yc[(long long)(row0 + i) * W + col] = st;
        const float r = to_f(st);
        s += r;
        ss = fmaf(r, r, ss);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      ss += __shfl_xor_sync(0xffffffffu, ss, o);
    }
    if (tx == 0) {
      red[ty * C + c] = s;
      red[(WARPS + ty) * C + c] = ss;
    }
  }
  __syncthreads();

  const long long n_blocks = gridDim.x;
  for (int i = threadIdx.x; i < 2 * C; i += THREADS) {
    const int st = i / C, c = i % C;
    float v = 0.f;
    for (int g = 0; g < WARPS; ++g) v += red[(st * WARPS + g) * C + c];
    partials[(long long)i * n_blocks + blk] = v;
  }
}

// sums[i] = sum over the n values of row i of partials, added in double;
// one block a row.
__global__ void __launch_bounds__(THREADS)
reduce_partials_kernel(const float* __restrict__ partials, float* __restrict__ sums,
                       long long n) {
  __shared__ double buf[THREADS];
  const float* row = partials + (long long)blockIdx.x * n;
  double v = 0.0;
  for (long long j = threadIdx.x; j < n; j += THREADS) v += row[j];
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int o = THREADS / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) buf[threadIdx.x] += buf[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[blockIdx.x] = (float)buf[0];
}

// the max of the four rounded z equals the rounding of the max of the four
// f32 z (rounding to nearest is monotone), so one rounding at the store
template <typename T>
__global__ void __launch_bounds__(THREADS)
norm_pool_kernel(const T* __restrict__ y,          // (B, C, H, W)
                 const float* __restrict__ scale,  // (C,)
                 const float* __restrict__ shift,  // (C,)
                 T* __restrict__ out,              // (B, C, H/2, W/2)
                 int C, int H, int W, int Ho, int Wo, long long total) {
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * THREADS) {
    const int j = (int)(idx % Wo);
    const long long r = idx / Wo;
    const int i = (int)(r % Ho);
    const long long bc = r / Ho;
    const int c = (int)(bc % C);
    const T* q = y + (bc * H + 2 * i) * W + 2 * j;
    const float a = __ldg(scale + c), sh = __ldg(shift + c);
    float m = bn_affine(to_f(q[0]), a, sh);
    m = fmaxf(m, bn_affine(to_f(q[1]), a, sh));
    m = fmaxf(m, bn_affine(to_f(q[W]), a, sh));
    m = fmaxf(m, bn_affine(to_f(q[W + 1]), a, sh));
    out[idx] = from_f<T>(fmaxf(m, 0.f));
  }
}

// ---------------------------------------------------------------------------
// K3

template <typename T>
__global__ void __launch_bounds__(THREADS)
route_kernel(const T* __restrict__ y,           // (B, C, H, W)
             const T* __restrict__ dp,          // (B, C, H/2, W/2)
             const float* __restrict__ scale,   // (C,)
             const float* __restrict__ shift,   // (C,)
             const float* __restrict__ mean,    // (C,)
             const float* __restrict__ inv,     // (C,)
             T* __restrict__ dy,                // (B, C, H, W)
             float* __restrict__ partials,      // (2, C, B * tiles)
             int C, int H, int W, int tiles) {
  __shared__ float red[2][WARPS];
  const long long blk = blockIdx.x;
  const long long plane = blk / tiles;          // b * C + c
  const int tile = (int)(blk % tiles);
  const int c = (int)(plane % C);
  const long long b = plane / C;
  const int Ho = H / 2, Wo = W / 2, Hc = (H + 1) / 2, Wc = (W + 1) / 2;
  const int cell = tile * THREADS + threadIdx.x;
  float s1 = 0.f, s2 = 0.f;
  if (cell < Hc * Wc) {
    const int i = cell / Wc, j = cell % Wc;
    const T* yp = y + plane * H * W;
    T* dyp = dy + plane * H * W;
    const float a = __ldg(scale + c), sh = __ldg(shift + c);
    const float mu = __ldg(mean + c), iv = __ldg(inv + c);
    float v[4], g[4];
    bool in[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int h = 2 * i + k / 2, w = 2 * j + k % 2;
      in[k] = h < H && w < W;
      v[k] = in[k] ? to_f(yp[(long long)h * W + w]) : 0.f;
      g[k] = 0.f;
    }
    if (i < Ho && j < Wo) {
      // first maximum of relu(bn), rounded as K2 stores it, in row-major
      // order (max_pool2d's choice); rounding makes ties common in bf16
      float bn[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) bn[k] = bn_affine(v[k], a, sh);
      int best = 0;
      float m = rnd<T>(fmaxf(bn[0], 0.f));
#pragma unroll
      for (int k = 1; k < 4; ++k) {
        const float z = rnd<T>(fmaxf(bn[k], 0.f));
        if (z > m) { m = z; best = k; }
      }
      const float d = to_f(dp[(plane * Ho + i) * Wo + j]);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (k == best && bn[k] > 0.f) g[k] = d;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (in[k]) {
        const int h = 2 * i + k / 2, w = 2 * j + k % 2;
        dyp[(long long)h * W + w] = from_f<T>(g[k]);  // exact: g is 0 or a stored value
        s1 += g[k];
        s2 += g[k] * ((v[k] - mu) * iv);
      }
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { red[0][warp] = s1; red[1][warp] = s2; }
  __syncthreads();
  if (threadIdx.x < 2) {
    float v = 0.f;
    for (int g = 0; g < WARPS; ++g) v += red[threadIdx.x][g];
    const long long n_slots = gridDim.x / C;   // B * tiles
    const long long slot = b * tiles + tile;
    partials[((long long)threadIdx.x * C + c) * n_slots + slot] = v;
  }
}

// ---------------------------------------------------------------------------
// K4

// the block geometry: row bands of at most K4_MAX_ROWS rows, as even as H
// allows (H = 200 gives 8 bands of 25), column tiles of K4_COLS, and channel
// groups of K4_WARPS; one slot of partial sums per (item, band, tile)
struct K4Geometry {
  int bands, rows, tiles_x, groups;
  K4Geometry(int C, int H, int W) {
    bands = (H + K4_MAX_ROWS - 1) / K4_MAX_ROWS;
    rows = (H + bands - 1) / bands;
    tiles_x = (W + K4_COLS - 1) / K4_COLS;
    groups = (C + K4_WARPS - 1) / K4_WARPS;
  }
  long long slots(int B) const { return (long long)B * bands * tiles_x; }
};

size_t weight_grads_fma_smem_bytes() {
  return sizeof(float) * (size_t)(K4_MAX_ROWS + 4) * K4_TSTRIDE;
}

// four stored values from p on: one 16-byte (f32) or 8-byte (bf16) load
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load4(const bf16* p, float* v) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// the four pixels from column w0 on of a row: vector loads when W is a
// multiple of 4 (then a lane's four columns are all in or all out), else
// one load a column; zeros past W
template <bool VEC, typename T>
__device__ __forceinline__ void load_px(const T* p, int w0, int W, float* v) {
  if (VEC) {
    if (w0 < W) {
      load4(p, v);
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = w0 + j < W ? to_f(p[j]) : 0.f;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
weight_grads_kernel(const float* __restrict__ x,     // (B, 1, H, W)
                    const T* __restrict__ y,         // (B, C, H, W)
                    const T* __restrict__ dy,        // (B, C, H, W)
                    const float* __restrict__ ga,    // (C,) gamma * inv
                    const float* __restrict__ mean,
                    const float* __restrict__ inv,
                    const float* __restrict__ m1,
                    const float* __restrict__ m2,
                    float* __restrict__ partials,    // (C * 25 + C, n_slots)
                    int C, int H, int W, int rows, int bands, int tiles_x, int groups) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);     // (rows + 4) x K4_TSTRIDE

  // one flat grid over (slot, channel group), the group fastest so the
  // blocks sharing an x tile run together
  const long long blk = blockIdx.x;
  const int grp = (int)(blk % groups);
  const long long slot = blk / groups;               // (b * bands + band) * tiles_x + tx
  const int tx = (int)(slot % tiles_x), band = (int)(slot / tiles_x % bands);
  const long long b = slot / tiles_x / bands;
  const int r0 = band * rows, c0 = tx * K4_COLS;
  const int nrows = min(rows, H - r0);
  const float* xb = x + b * H * W;

  // x with its zero halo (SAME padding), rounded as the dW products take it
  for (int i = threadIdx.x; i < (nrows + 4) * K4_TSTRIDE; i += THREADS) {
    const int gr = r0 + i / K4_TSTRIDE - 2, gc = c0 + i % K4_TSTRIDE - 2;
    tile[i] = (gr >= 0 && gr < H && gc >= 0 && gc < W) ? rnd<T>(xb[(long long)gr * W + gc])
                                                        : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = grp * K4_WARPS + warp;
  if (c >= C) return;  // past the only barrier
  const float g = __ldg(ga + c), mu = __ldg(mean + c), iv = __ldg(inv + c);
  const float a1 = __ldg(m1 + c), a2 = __ldg(m2 + c);
  const int w0 = c0 + 4 * lane;  // this lane's four columns
  const long long base = ((b * C + c) * H + r0) * W + w0;

  float acc[NT];
#pragma unroll
  for (int k = 0; k < NT; ++k) acc[k] = 0.f;
  // the 5 x 8 input window of the lane's four pixels, five staged rows kept
  // as a ring: row i of the band reads ring slots (i + dh) % 5, so with the
  // row loop unrolled by 5 every slot index is a constant and nothing moves
  float win[5][8];
  const float* tp = tile + 4 * lane;
  auto stage_row = [&](int slot, int r) {
    const float4 lo = *reinterpret_cast<const float4*>(tp + r * K4_TSTRIDE);
    const float4 hi = *reinterpret_cast<const float4*>(tp + r * K4_TSTRIDE + 4);
    win[slot][0] = lo.x; win[slot][1] = lo.y; win[slot][2] = lo.z; win[slot][3] = lo.w;
    win[slot][4] = hi.x; win[slot][5] = hi.y; win[slot][6] = hi.z; win[slot][7] = hi.w;
  };
#pragma unroll
  for (int r = 0; r < 4; ++r) stage_row(r, r);
  // y and dy of rows i + 1 and i + 2 are in flight while row i multiplies
  float py[2][4], pdy[2][4];
  load_px<VEC>(y + base, w0, W, py[0]);
  load_px<VEC>(dy + base, w0, W, pdy[0]);
  if (nrows > 1) {
    load_px<VEC>(y + base + W, w0, W, py[1]);
    load_px<VEC>(dy + base + W, w0, W, pdy[1]);
  }
  for (int i0 = 0; i0 < nrows; i0 += 10) {
#pragma unroll
    for (int u = 0; u < 10; ++u) {
      const int i = i0 + u;
      if (i >= nrows) break;
      float cy[4], cdy[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) { cy[j] = py[u % 2][j]; cdy[j] = pdy[u % 2][j]; }
      if (i + 2 < nrows) {
        load_px<VEC>(y + base + (long long)(i + 2) * W, w0, W, py[u % 2]);
        load_px<VEC>(dy + base + (long long)(i + 2) * W, w0, W, pdy[u % 2]);
      }
      stage_row((u + 4) % 5, i + 4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float d = w0 + j < W ? dconv_of(cy[j], cdy[j], g, mu, iv, a1, a2) : 0.f;
        const float dc = rnd<T>(d);  // the dW products take dconv rounded, db does not
        acc[25] += d;
#pragma unroll
        for (int dh = 0; dh < 5; ++dh)
#pragma unroll
          for (int dw = 0; dw < 5; ++dw)
            acc[dh * 5 + dw] = fmaf(win[(u + dh) % 5][j + dw], dc, acc[dh * 5 + dw]);
      }
    }
  }
  // one reduction a block: the warp's 32 lanes, then one slot of partials
#pragma unroll
  for (int k = 0; k < NT; ++k) acc[k] = warp_sum(acc[k]);
  if (lane == 0) {
    const long long n_slots = gridDim.x / groups;
#pragma unroll
    for (int k = 0; k < NT; ++k) {
      const long long r = k < 25 ? (long long)c * 25 + k : (long long)C * 25 + c;  // dW, then db
      partials[r * n_slots + slot] = acc[k];
    }
  }
}

// K4's bf16 mode on the tensor cores: dW as an implicit GEMM, taps (25,
// padded to 32: two m-tiles of 16) x channels (32: four n-tiles of 8) over
// the pixels, one mma.sync m16n8k16 bf16 -> f32 k-step per 16 pixels of a
// row.  A warp takes a 16-column segment of the block's 128-column tile
// down the band: each k-step it computes the B fragment (dconv of its
// pixels, rounded to bf16 as the plain version rounds it) from y and dy,
// gathers the A fragment (the patches of x) from the staged tile, and runs
// 8 MMAs.  Needs W a multiple of 16; other widths take weight_grads_kernel.
constexpr int K4M_SEG = 16;   // pixels a k-step
constexpr int K4M_CH = 32;    // channels a block
constexpr int K4M_TAPS = 32;  // taps, padded

size_t weight_grads_mma_smem_bytes() {
  return sizeof(float) * ((size_t)(K4_MAX_ROWS + 4) * K4_TSTRIDE
                          + (size_t)WARPS * (K4M_TAPS + 1) * K4M_CH);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float* d, const unsigned* a, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS, 2)
weight_grads_mma_kernel(const float* __restrict__ x,    // (B, 1, H, W)
                        const bf16* __restrict__ y,     // (B, C, H, W)
                        const bf16* __restrict__ dy,    // (B, C, H, W)
                        const float* __restrict__ ga,
                        const float* __restrict__ mean,
                        const float* __restrict__ inv,
                        const float* __restrict__ m1,
                        const float* __restrict__ m2,
                        float* __restrict__ partials,   // (C * 25 + C, n_slots)
                        int C, int H, int W, int rows, int bands, int tiles_x, int groups) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);             // (rows + 4) x K4_TSTRIDE
  float* red = tile + (K4_MAX_ROWS + 4) * K4_TSTRIDE;        // WARPS x (taps + db) x channels

  const long long blk = blockIdx.x;
  const int grp = (int)(blk % groups);
  const long long slot = blk / groups;
  const int tx = (int)(slot % tiles_x), band = (int)(slot / tiles_x % bands);
  const long long b = slot / tiles_x / bands;
  const int r0 = band * rows, c0 = tx * K4_COLS;
  const int nrows = min(rows, H - r0);
  const float* xb = x + b * H * W;
  for (int i = threadIdx.x; i < (nrows + 4) * K4_TSTRIDE; i += THREADS) {
    const int gr = r0 + i / K4_TSTRIDE - 2, gc = c0 + i % K4_TSTRIDE - 2;
    tile[i] = (gr >= 0 && gr < H && gc >= 0 && gc < W)
                  ? rnd<bf16>(xb[(long long)gr * W + gc]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int seg0 = warp * K4M_SEG;           // the warp's columns in the tile
  const bool active = c0 + seg0 < W;         // a segment lies wholly in or out
  // this lane's taps g, g + 8, g + 16, g + 24 (rows of the A fragments) as
  // offsets into the tile; taps past 24 are zero
  int toff[4];
  bool tval[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int t = g + 8 * m;
    tval[m] = t < 25;
    toff[m] = tval[m] ? (t / 5) * K4_TSTRIDE + t % 5 : 0;
  }
  // this lane's channels: g of each n-tile (its B fragments' column)
  float pg[4], pmu[4], piv[4], pa1[4], pa2[4];
  bool cval[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = grp * K4M_CH + nt * 8 + g;
    cval[nt] = active && c < C;
    const int cc = c < C ? c : 0;
    pg[nt] = __ldg(ga + cc); pmu[nt] = __ldg(mean + cc); piv[nt] = __ldg(inv + cc);
    pa1[nt] = __ldg(m1 + cc); pa2[nt] = __ldg(m2 + cc);
  }
  // the lane's pixels of its n-tile-0 channel; n-tile nt is nt * 8 planes on
  const long long off0 = ((b * C + grp * K4M_CH + g) * H + r0) * W + c0 + seg0 + 2 * q;
  const long long nt_stride = 8LL * H * W;
  float acc[2][4][4];
  float dbs[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    dbs[nt] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][nt][e] = acc[1][nt][e] = 0.f;
  }
  // y and dy of the lane's pixels (2q, 2q+1) and (2q+8, 2q+9), one row ahead
  unsigned ny[4][2], ndy[4][2];
  auto load_row = [&](int i) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (cval[nt]) {
        const long long o = off0 + nt * nt_stride + (long long)i * W;
        ny[nt][0] = __ldg(reinterpret_cast<const unsigned*>(y + o));
        ny[nt][1] = __ldg(reinterpret_cast<const unsigned*>(y + o + 8));
        ndy[nt][0] = __ldg(reinterpret_cast<const unsigned*>(dy + o));
        ndy[nt][1] = __ldg(reinterpret_cast<const unsigned*>(dy + o + 8));
      } else {
        ny[nt][0] = ny[nt][1] = ndy[nt][0] = ndy[nt][1] = 0u;
      }
    }
  };
  if (active) load_row(0);
  for (int i = 0; active && i < nrows; ++i) {
    unsigned cy[4][2], cdy[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) { cy[nt][h] = ny[nt][h]; cdy[nt][h] = ndy[nt][h]; }
    if (i + 1 < nrows) load_row(i + 1);
    // A: the patches of the 16 pixels, taps as rows
    unsigned lo[4], hi[4];
    const float* tr = tile + i * K4_TSTRIDE + seg0 + 2 * q;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float* pp = tr + toff[m];
      lo[m] = tval[m] ? pack_bf16(pp[0], pp[1]) : 0u;
      hi[m] = tval[m] ? pack_bf16(pp[8], pp[9]) : 0u;
    }
    const unsigned a0[4] = {lo[0], lo[1], hi[0], hi[1]};  // taps 0..15
    const unsigned a1[4] = {lo[2], lo[3], hi[2], hi[3]};  // taps 16..31
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float d[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 yv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cy[nt][h]));
        const float2 dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&cdy[nt][h]));
        d[2 * h] = cval[nt] ? dconv_of(yv.x, dv.x, pg[nt], pmu[nt], piv[nt], pa1[nt], pa2[nt]) : 0.f;
        d[2 * h + 1] = cval[nt] ? dconv_of(yv.y, dv.y, pg[nt], pmu[nt], piv[nt], pa1[nt], pa2[nt]) : 0.f;
      }
      dbs[nt] += d[0];
      dbs[nt] += d[1];
      dbs[nt] += d[2];
      dbs[nt] += d[3];
      // B: dconv rounded to bf16, pixels as rows
      const unsigned b0 = pack_bf16(d[0], d[1]), b1 = pack_bf16(d[2], d[3]);
      mma16816(acc[0][nt], a0, b0, b1);
      mma16816(acc[1][nt], a1, b0, b1);
    }
  }
  // one reduction a block: each warp's tiles to shared memory, summed over
  // the warps in order
  float* rw = red + (size_t)warp * (K4M_TAPS + 1) * K4M_CH;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        rw[(mt * 16 + g + 8 * (e >> 1)) * K4M_CH + nt * 8 + 2 * q + (e & 1)] = acc[mt][nt][e];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    float v = dbs[nt];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    if (q == 0) rw[K4M_TAPS * K4M_CH + nt * 8 + g] = v;
  }
  __syncthreads();
  const long long n_slots = gridDim.x / groups;
  for (int i = threadIdx.x; i < 26 * K4M_CH; i += THREADS) {
    const int k = i / K4M_CH, ch = i % K4M_CH, c = grp * K4M_CH + ch;
    if (c >= C) continue;
    const int src = (k < 25 ? k : K4M_TAPS) * K4M_CH + ch;
    float v = 0.f;
    for (int w = 0; w < WARPS; ++w) v += red[(size_t)w * (K4M_TAPS + 1) * K4M_CH + src];
    const long long r = k < 25 ? (long long)c * 25 + k : (long long)C * 25 + c;  // dW, then db
    partials[r * n_slots + slot] = v;
  }
}

// ---------------------------------------------------------------------------
// K5

size_t input_grad_smem_bytes(int C) {
  return sizeof(float) * ((size_t)C * WPAD + (size_t)HALO_H * HALO_W);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
input_grad_kernel(const T* __restrict__ y,         // (B, C, H, W)
                  const T* __restrict__ dy,        // (B, C, H, W)
                  const float* __restrict__ w,     // (C, 1, 5, 5)
                  const float* __restrict__ ga,
                  const float* __restrict__ mean,
                  const float* __restrict__ inv,
                  const float* __restrict__ m1,
                  const float* __restrict__ m2,
                  float* __restrict__ dx,          // (B, 1, H, W)
                  int C, int H, int W, int tiles_x, int tiles_y) {
  extern __shared__ float4 smem4[];
  float* swf = reinterpret_cast<float*>(smem4);    // C x WPAD, flipped taps
  float* dt = swf + C * WPAD;                       // HALO_H x HALO_W

  const long long blk = blockIdx.x;
  const int bx = (int)(blk % tiles_x), by = (int)(blk / tiles_x % tiles_y);
  const long long b = blk / ((long long)tiles_x * tiles_y);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c0 = bx * TW, r0 = by * TH;

  // dx(h, w) = sum over taps of wf[dh][dw] * dconv(h + dh - 2, w + dw - 2)
  // with wf[dh][dw] = W[4 - dh][4 - dw]
  for (int i = threadIdx.x; i < C * WPAD; i += THREADS) {
    const int c = i / WPAD, k = i % WPAD;
    swf[i] = k < 25 ? rnd<T>(w[c * 25 + 24 - k]) : 0.f;
  }

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  for (int c = 0; c < C; ++c) {
    const float g = __ldg(ga + c), mu = __ldg(mean + c), iv = __ldg(inv + c);
    const float a1 = __ldg(m1 + c), a2 = __ldg(m2 + c);
    const long long base = (b * C + c) * H * W;
    __syncthreads();  // the previous channel's tile is consumed
    for (int i = threadIdx.x; i < HALO_H * HALO_W; i += THREADS) {
      const int gr = r0 + i / HALO_W - 2, gc = c0 + i % HALO_W - 2;
      float d = 0.f;
      if (gr >= 0 && gr < H && gc >= 0 && gc < W) {
        const long long idx = base + (long long)gr * W + gc;
        d = rnd<T>(dconv_of(to_f(y[idx]), to_f(dy[idx]), g, mu, iv, a1, a2));
      }
      dt[i] = d;
    }
    __syncthreads();
    float wk[WPAD];
    const float4* wc = reinterpret_cast<const float4*>(swf + c * WPAD);
#pragma unroll
    for (int q = 0; q < WPAD / 4; ++q) {
      const float4 v = wc[q];
      wk[4 * q] = v.x; wk[4 * q + 1] = v.y; wk[4 * q + 2] = v.z; wk[4 * q + 3] = v.w;
    }
    float p[RPT + 4][5];
#pragma unroll
    for (int i = 0; i < RPT + 4; ++i)
#pragma unroll
      for (int j = 0; j < 5; ++j) p[i][j] = dt[(ty * RPT + i) * HALO_W + tx + j];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int dh = 0; dh < 5; ++dh)
#pragma unroll
        for (int dw = 0; dw < 5; ++dw) acc[i] = fmaf(p[i + dh][dw], wk[dh * 5 + dw], acc[i]);
  }
  const int col = c0 + tx;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int h = r0 + ty * RPT + i;
    if (col < W && h < H) dx[(b * H + h) * W + col] = acc[i];
  }
}

// ---------------------------------------------------------------------------
// launches, one per mode each

template <typename T>
int conv_stats(const float* x, const float* w, const float* bias, T* y, float* sums,
               float* scratch, int B, int C, int H, int W, void* stream) {
  const size_t smem = conv_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      conv_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long n_blocks = conv_blocks(B, H, W);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  conv_stats_kernel<T><<<(unsigned)n_blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, w, bias, y, scratch, H, W, C, tiles_x, tiles_y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<2 * C, THREADS, 0, (cudaStream_t)stream>>>(scratch, sums, n_blocks);
  return (int)cudaGetLastError();
}

template <typename T>
int norm_pool(const T* y, const float* scale, const float* shift, T* out, int B, int C,
              int H, int W, void* stream) {
  const int Ho = H / 2, Wo = W / 2;
  const long long total = (long long)B * C * Ho * Wo;
  const long long blocks = (total + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < (1LL << 20) ? blocks : (1LL << 20));
  norm_pool_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(y, scale, shift, out, C, H,
                                                                 W, Ho, Wo, total);
  return (int)cudaGetLastError();
}

long long route_scratch_floats(int B, int C, int H, int W) {
  const long long cells = (long long)((H + 1) / 2) * ((W + 1) / 2);
  return 2LL * C * B * ((cells + THREADS - 1) / THREADS);
}

template <typename T>
int route(const T* y, const T* dp, const float* scale, const float* shift, const float* mean,
          const float* inv, T* dy, float* sums, float* scratch, int B, int C, int H, int W,
          void* stream) {
  const long long cells = (long long)((H + 1) / 2) * ((W + 1) / 2);
  const int tiles = (int)((cells + THREADS - 1) / THREADS);
  const long long n_blocks = (long long)B * C * tiles;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  route_kernel<T><<<(unsigned)n_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      y, dp, scale, shift, mean, inv, dy, scratch, C, H, W, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<2 * C, THREADS, 0, (cudaStream_t)stream>>>(
      scratch, sums, (long long)B * tiles);
  return (int)cudaGetLastError();
}

size_t weight_grads_smem_bytes(int) {
  return std::max(weight_grads_fma_smem_bytes(), weight_grads_mma_smem_bytes());
}

template <typename T, bool VEC>
int launch_weight_grads(const float* x, const T* y, const T* dy, const float* ga,
                        const float* mean, const float* inv, const float* m1, const float* m2,
                        float* scratch, int B, int C, int H, int W, void* stream) {
  const size_t smem = weight_grads_fma_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      weight_grads_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const K4Geometry geo(C, H, W);
  const long long n_blocks = geo.slots(B) * geo.groups;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  weight_grads_kernel<T, VEC><<<(unsigned)n_blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, y, dy, ga, mean, inv, m1, m2, scratch, C, H, W, geo.rows, geo.bands, geo.tiles_x,
      geo.groups);
  return (int)cudaGetLastError();
}

int launch_weight_grads_mma(const float* x, const bf16* y, const bf16* dy, const float* ga,
                            const float* mean, const float* inv, const float* m1,
                            const float* m2, float* scratch, int B, int C, int H, int W,
                            void* stream) {
  const size_t smem = weight_grads_mma_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      weight_grads_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  K4Geometry geo(C, H, W);
  geo.groups = (C + K4M_CH - 1) / K4M_CH;
  const long long n_blocks = geo.slots(B) * geo.groups;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  weight_grads_mma_kernel<<<(unsigned)n_blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, y, dy, ga, mean, inv, m1, m2, scratch, C, H, W, geo.rows, geo.bands, geo.tiles_x,
      geo.groups);
  return (int)cudaGetLastError();
}

template <typename T>
int weight_grads(const float* x, const T* y, const T* dy, const float* ga, const float* mean,
                 const float* inv, const float* m1, const float* m2, float* grads,
                 float* scratch, int B, int C, int H, int W, void* stream) {
  // vector loads need every row start on a 4-element boundary
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(y) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % (4 * sizeof(T)) == 0;
  const int err = sizeof(T) == 2 && W % K4M_SEG == 0 && vec
      ? launch_weight_grads_mma(x, reinterpret_cast<const bf16*>(y),
                                reinterpret_cast<const bf16*>(dy), ga, mean, inv, m1, m2,
                                scratch, B, C, H, W, stream)
      : vec
      ? launch_weight_grads<T, true>(x, y, dy, ga, mean, inv, m1, m2, scratch, B, C, H, W, stream)
      : launch_weight_grads<T, false>(x, y, dy, ga, mean, inv, m1, m2, scratch, B, C, H, W,
                                      stream);
  if (err) return err;
  reduce_partials_kernel<<<C * NT, THREADS, 0, (cudaStream_t)stream>>>(
      scratch, grads, K4Geometry(C, H, W).slots(B));
  return (int)cudaGetLastError();
}

template <typename T>
int input_grad(const T* y, const T* dy, const float* w, const float* ga, const float* mean,
               const float* inv, const float* m1, const float* m2, float* dx, int B, int C,
               int H, int W, void* stream) {
  const size_t smem = input_grad_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      input_grad_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long n_blocks = (long long)tiles_x * tiles_y * B;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  input_grad_kernel<T><<<(unsigned)n_blocks, THREADS, smem, (cudaStream_t)stream>>>(
      y, dy, w, ga, mean, inv, m1, m2, dx, C, H, W, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

}  // namespace

// Entry points: sept_<kernel> takes f32 storage, sept_<kernel>_bf16 bf16
// storage (the pointers typed void* are bf16 tensors).
extern "C" {

const char* sept_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Floats of scratch sept_conv_stats needs for its per-block partial sums.
long long sept_conv_stats_scratch_floats(int B, int C, int H, int W) {
  return 2LL * C * conv_blocks(B, H, W);
}

long long sept_conv_stats_smem_bytes(int C) { return (long long)conv_smem_bytes(C); }

int sept_conv_stats(const float* x, const float* w, const float* bias, float* y,
                    float* sums, float* scratch, int B, int C, int H, int W,
                    void* stream) {
  return conv_stats(x, w, bias, y, sums, scratch, B, C, H, W, stream);
}

int sept_conv_stats_bf16(const float* x, const float* w, const float* bias, void* y,
                         float* sums, float* scratch, int B, int C, int H, int W,
                         void* stream) {
  return conv_stats(x, w, bias, static_cast<bf16*>(y), sums, scratch, B, C, H, W, stream);
}

int sept_norm_pool(const float* y, const float* scale, const float* shift, float* out,
                   int B, int C, int H, int W, void* stream) {
  return norm_pool(y, scale, shift, out, B, C, H, W, stream);
}

int sept_norm_pool_bf16(const void* y, const float* scale, const float* shift, void* out,
                        int B, int C, int H, int W, void* stream) {
  return norm_pool(static_cast<const bf16*>(y), scale, shift, static_cast<bf16*>(out), B, C,
                   H, W, stream);
}

long long sept_route_scratch_floats(int B, int C, int H, int W) {
  return route_scratch_floats(B, C, H, W);
}

int sept_route(const float* y, const float* dp, const float* scale, const float* shift,
               const float* mean, const float* inv, float* dy, float* sums, float* scratch,
               int B, int C, int H, int W, void* stream) {
  return route(y, dp, scale, shift, mean, inv, dy, sums, scratch, B, C, H, W, stream);
}

int sept_route_bf16(const void* y, const void* dp, const float* scale, const float* shift,
                    const float* mean, const float* inv, void* dy, float* sums,
                    float* scratch, int B, int C, int H, int W, void* stream) {
  return route(static_cast<const bf16*>(y), static_cast<const bf16*>(dp), scale, shift, mean,
               inv, static_cast<bf16*>(dy), sums, scratch, B, C, H, W, stream);
}

long long sept_weight_grads_scratch_floats(int B, int C, int H, int W) {
  return (long long)C * NT * K4Geometry(C, H, W).slots(B);
}

long long sept_weight_grads_smem_bytes(int C) { return (long long)weight_grads_smem_bytes(C); }

// grads: dW (C, 1, 5, 5) then db (C,), C * 26 floats.
int sept_weight_grads(const float* x, const float* y, const float* dy, const float* ga,
                      const float* mean, const float* inv, const float* m1, const float* m2,
                      float* grads, float* scratch, int B, int C, int H, int W,
                      void* stream) {
  return weight_grads(x, y, dy, ga, mean, inv, m1, m2, grads, scratch, B, C, H, W, stream);
}

int sept_weight_grads_bf16(const float* x, const void* y, const void* dy, const float* ga,
                           const float* mean, const float* inv, const float* m1,
                           const float* m2, float* grads, float* scratch, int B, int C, int H,
                           int W, void* stream) {
  return weight_grads(x, static_cast<const bf16*>(y), static_cast<const bf16*>(dy), ga, mean,
                      inv, m1, m2, grads, scratch, B, C, H, W, stream);
}

long long sept_input_grad_smem_bytes(int C) { return (long long)input_grad_smem_bytes(C); }

int sept_input_grad(const float* y, const float* dy, const float* w, const float* ga,
                    const float* mean, const float* inv, const float* m1, const float* m2,
                    float* dx, int B, int C, int H, int W, void* stream) {
  return input_grad(y, dy, w, ga, mean, inv, m1, m2, dx, B, C, H, W, stream);
}

int sept_input_grad_bf16(const void* y, const void* dy, const float* w, const float* ga,
                         const float* mean, const float* inv, const float* m1,
                         const float* m2, float* dx, int B, int C, int H, int W,
                         void* stream) {
  return input_grad(static_cast<const bf16*>(y), static_cast<const bf16*>(dy), w, ga, mean,
                    inv, m1, m2, dx, B, C, H, W, stream);
}

}  // extern "C"
