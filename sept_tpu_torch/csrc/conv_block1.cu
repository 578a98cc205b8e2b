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
//      and db[c] = sum dconv;
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
// - K4 stages a (64 + 4) x (32 + 4) input tile with its zero halo in shared
//   memory once and loops over the channels: each thread slides a 5 x 5
//   input patch down its 8 rows in registers and accumulates the 25 taps
//   and the bias, then each warp reduces its 26 sums with shuffles.  Its
//   partial rows are ordered so that the reduced sums are dW (C, 25) followed
//   by db (C,).  The banded-matrix extraction of the TPU kernel was a Mosaic
//   workaround and is gone.
// - K5 uses K1's geometry: a 32 x 32 output tile, 4 rows a thread, the
//   flipped weights as float4 broadcasts from shared memory; per channel the
//   block stages dconv of the 36 x 36 halo tile in shared memory.
// - Any H and W are taken, in both modes; the pool floors odd sizes as
//   max_pool2d does.  The fixed 200 x 128 geometry of the TPU path and its
//   rule that only the bf16 mode fits its VMEM do not apply here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;                // tile columns (one warp lane each)
constexpr int TH = 32;                // tile rows
constexpr int RPT = 4;                // rows per thread
constexpr int WARPS = TH / RPT;       // 8
constexpr int THREADS = 32 * WARPS;   // 256
constexpr int WPAD = 28;              // 25 taps padded to 7 float4
constexpr int HALO_W = TW + 4, HALO_H = TH + 4;
constexpr int NT = 26;                // K4 sums a channel: 25 taps + bias
constexpr int K4_RPW = 8;             // K4 rows a warp
constexpr int K4_ROWS = WARPS * K4_RPW;  // 64

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

size_t weight_grads_smem_bytes(int C) {
  return sizeof(float) * ((size_t)(K4_ROWS + 4) * HALO_W + (size_t)WARPS * C * NT);
}

long long weight_grads_blocks(int B, int H, int W) {
  return (long long)((W + TW - 1) / TW) * ((H + K4_ROWS - 1) / K4_ROWS) * B;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
weight_grads_kernel(const float* __restrict__ x,     // (B, 1, H, W)
                    const T* __restrict__ y,         // (B, C, H, W)
                    const T* __restrict__ dy,        // (B, C, H, W)
                    const float* __restrict__ ga,    // (C,) gamma * inv
                    const float* __restrict__ mean,
                    const float* __restrict__ inv,
                    const float* __restrict__ m1,
                    const float* __restrict__ m2,
                    float* __restrict__ partials,    // (C * 25 + C, n_blocks)
                    int C, int H, int W, int tiles_x, int tiles_y) {
  extern __shared__ float smem[];
  float* tile = smem;                                // (K4_ROWS + 4) x HALO_W
  float* red = tile + (K4_ROWS + 4) * HALO_W;        // WARPS x C x NT

  const long long blk = blockIdx.x;
  const int bx = (int)(blk % tiles_x), by = (int)(blk / tiles_x % tiles_y);
  const long long b = blk / ((long long)tiles_x * tiles_y);
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int c0 = bx * TW, r0 = by * K4_ROWS;
  const float* xb = x + b * H * W;

  for (int i = threadIdx.x; i < (K4_ROWS + 4) * HALO_W; i += THREADS) {
    const int gr = r0 + i / HALO_W - 2, gc = c0 + i % HALO_W - 2;
    tile[i] = (gr >= 0 && gr < H && gc >= 0 && gc < W) ? rnd<T>(xb[(long long)gr * W + gc])
                                                        : 0.f;
  }
  __syncthreads();

  const int col = c0 + tx, row0 = r0 + ty * K4_RPW;
  const float* tp = tile + ty * K4_RPW * HALO_W + tx;
  for (int c = 0; c < C; ++c) {
    const float g = __ldg(ga + c), mu = __ldg(mean + c), iv = __ldg(inv + c);
    const float a1 = __ldg(m1 + c), a2 = __ldg(m2 + c);
    const long long base = (b * C + c) * H * W;
    float acc[NT];
#pragma unroll
    for (int k = 0; k < NT; ++k) acc[k] = 0.f;
    float p[5][5];
#pragma unroll
    for (int dh = 0; dh < 4; ++dh)
#pragma unroll
      for (int dw = 0; dw < 5; ++dw) p[dh + 1][dw] = tp[dh * HALO_W + dw];
#pragma unroll
    for (int i = 0; i < K4_RPW; ++i) {
#pragma unroll
      for (int dh = 0; dh < 4; ++dh)
#pragma unroll
        for (int dw = 0; dw < 5; ++dw) p[dh][dw] = p[dh + 1][dw];
#pragma unroll
      for (int dw = 0; dw < 5; ++dw) p[4][dw] = tp[(i + 4) * HALO_W + dw];
      const int h = row0 + i;
      float d = 0.f;
      if (col < W && h < H) {
        const long long idx = base + (long long)h * W + col;
        d = dconv_of(to_f(y[idx]), to_f(dy[idx]), g, mu, iv, a1, a2);
      }
      const float dc = rnd<T>(d);  // the dW products take dconv rounded, db does not
#pragma unroll
      for (int dh = 0; dh < 5; ++dh)
#pragma unroll
        for (int dw = 0; dw < 5; ++dw) acc[dh * 5 + dw] = fmaf(p[dh][dw], dc, acc[dh * 5 + dw]);
      acc[25] += d;
    }
#pragma unroll
    for (int k = 0; k < NT; ++k) acc[k] = warp_sum(acc[k]);
    if (tx == 0) {
#pragma unroll
      for (int k = 0; k < NT; ++k) red[(ty * C + c) * NT + k] = acc[k];
    }
  }
  __syncthreads();

  const long long n_blocks = gridDim.x;
  for (int i = threadIdx.x; i < C * NT; i += THREADS) {
    float v = 0.f;
    for (int w = 0; w < WARPS; ++w) v += red[w * C * NT + i];
    const int c = i / NT, k = i % NT;   // rows: dW (C, 25), then db (C,)
    const long long r = k < 25 ? (long long)c * 25 + k : (long long)C * 25 + c;
    partials[r * n_blocks + blk] = v;
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

template <typename T>
int weight_grads(const float* x, const T* y, const T* dy, const float* ga, const float* mean,
                 const float* inv, const float* m1, const float* m2, float* grads,
                 float* scratch, int B, int C, int H, int W, void* stream) {
  const size_t smem = weight_grads_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      weight_grads_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + K4_ROWS - 1) / K4_ROWS;
  const long long n_blocks = weight_grads_blocks(B, H, W);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  weight_grads_kernel<T><<<(unsigned)n_blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, y, dy, ga, mean, inv, m1, m2, scratch, C, H, W, tiles_x, tiles_y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<C * NT, THREADS, 0, (cudaStream_t)stream>>>(
      scratch, grads, n_blocks);
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
  return (long long)C * NT * weight_grads_blocks(B, H, W);
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
