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
// templated on the storage type, except where it runs on the tensor cores
// (K1, K4 and K5 at the training windows' shapes, mma.sync).  Sums, moments, dW, db and dx stay f32.
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
//   fit Mosaic's (8, 128) tiling; none of that carries over.  K1, K4 and K5
//   share one geometry: a block takes one slot -- a row band of at most 25
//   rows, as even as H allows (H = 200: 8 bands of 25, no idle rows), and a
//   128-column tile of one item -- and a lane takes four adjacent columns.
// - K1 stages x with its zero halo (the SAME padding) in shared memory once.
//   f32 mode (and bf16 at widths that are not a multiple of 8): each warp
//   owns channels warp, warp + 8, ...; the lane slides a 5 x 8 input window
//   down the band (a ring of five staged rows) with the channel's 25
//   weights in registers, stores each row's four outputs as one 16-byte
//   (f32) or 8-byte (bf16) vector, and keeps the channel's sum of y and of
//   y^2 in registers over the band: one warp reduction a channel and band.
//   bf16 mode at widths that are a multiple of 8: an implicit GEMM on the
//   tensor cores (mma.sync m16n8k16 bf16 -> f32), pixels x taps (25, padded
//   to 32 with zeros) x 32 channels; a warp takes 64 pixels of a row as
//   four m-tiles whose rows are pixels 8g + 2t and 8g + 2t + 1, so each lane
//   ends holding 8 adjacent pixels of 8 channels and stores each as one
//   16-byte vector; the bias is added in f32 and y rounded once.  What
//   bounds K1: the bytes of y (52.4 MB in bf16, 104.9 in f32 at (32, 32,
//   200, 128)); in bf16 the 25 multiply-adds an output on the CUDA cores
//   alone would take longer than those bytes, hence the tensor cores.
// - On the TPU the grid ran in order and the kernels carried their sums from
//   one item to the next (pl.when(b == 0)).  Blocks here run in any order,
//   so K1, K3 and K4 each write per-block partial sums to scratch, and one
//   second pass (reduce_partials_kernel) adds each row in double:
//   deterministic (no float atomics), so two runs give the same moments and
//   gradients bit for bit.
// - K2 rounds y * a + b as torch's separate multiply and add do (no FMA
//   contraction), so it agrees with its plain version bit for bit.  It
//   shares K3's geometry: a thread takes a run of adjacent pooled cells (8
//   in bf16, 4 in f32: 16 bytes of output) where W is a multiple of twice
//   the run and the tensors are 16-byte aligned, reads y's two rows as
//   16-byte vectors and loads its next run before it pools the current one;
//   a block takes a band of pooled rows of one (item, channel), so scale
//   and shift are read once a block.  What bounded the first design (one
//   pooled cell a thread, four 2-byte loads, 64-bit divisions for every
//   element) in bf16: instructions, not bytes (0.46 of its bound at (32,
//   32, 200, 128) on the H100).  K3 recomputes z with the same rounding, and
//   K4 and K5 compute dconv in the plain version's order, uncontracted, so
//   that the bf16 rounding of dconv sees the plain version's f32 value.
// - K3 takes runs of 8 adjacent 2x2 cells a thread where W is a multiple
//   of 16: y's two rows and dp as 16-byte loads, dy as 16-byte stores, the
//   next run's loads issued before the current one is routed; one block a
//   band of cell rows of one (item, channel), sized so that the threads'
//   slots are nearly all used, so one partial-sum slot a band (in bf16 one
//   a plane at 200 x 128, where the first design, one thread a cell, wrote
//   25; in f32, with twice the bytes a run, 7 smaller bands a plane ran
//   faster on the H100).  What
//   bounded that design in bf16: instructions and latency, not bytes (2-byte
//   scalar loads, 25,600 blocks at (32, 32, 200, 128), each ending in a
//   block reduction): it ran no faster than in f32.  Other widths go one
//   cell a thread, as that design did.  Cells past the pooled grid (odd H
//   or W, floored as K2 floors them) write dy = 0.
// - K4 accumulates over a block's whole pixel range before it reduces.  A
//   block takes one slot and a group of channels, and stages x with its zero
//   halo in shared memory once.
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
// - K5 computes each dconv element once and writes dx once, without
//   atomics.  FMA mode (f32, and bf16 off the conditions below): each warp
//   owns channels warp, warp + 8, ...; the lane streams y and dy of its four
//   columns as one 16-byte (f32) or 8-byte (bf16) vector a row, two rows
//   ahead, takes the two dconv columns on each side from its neighbour
//   lanes by shuffles, slides a ring of five dconv rows down the band and
//   adds each output row's 100 products into its warp's partial dx in
//   shared memory; the block sums the eight partials in order once.  bf16
//   mode at C = 32 and widths that are a multiple of 16 up to 128: an
//   implicit GEMM on the tensor cores, P[h, w, dw] = sum over (c, dh) of
//   dconv(c, h + dh - 2, w) * wf[c, dh, dw] (M = pixels, K = 160 in ten
//   k-steps of (dh, 16 channels), N = dw padded from 5 to 8), then the
//   shift-sum dx(h, w) = sum over dw of P[h, w + dw - 2, dw] from shared
//   memory.  What bounds K5: bytes (y and dy); the design it replaces staged
//   a 36 x 36 halo tile a channel between two barriers, with no load in
//   flight during the products, and took the same time in both modes.
// - Any H and W are taken, in both modes; the pool floors odd sizes as
//   max_pool2d does.  The fixed 200 x 128 geometry of the TPU path and its
//   rule that only the bf16 mode fits its VMEM do not apply here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int WARPS = 8;              // warps a block
constexpr int THREADS = 32 * WARPS;   // 256
constexpr int WPAD = 28;              // 25 taps padded to 7 float4
constexpr int NT = 26;                // K4 sums a channel: 25 taps + bias
constexpr int K4_WARPS = WARPS;       // K4 channels a block, one warp each
constexpr int K4_COLS = 128;          // tile columns of K1, K4, K5: 4 a lane
constexpr int K4_MAX_ROWS = 25;       // rows a band, at most
constexpr int K4_TSTRIDE = K4_COLS + 4;  // floats a staged row (16-byte aligned)
constexpr int MMA_CH = 32;            // channels of the mma.sync paths of K1 and K5

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

// the block geometry of K1, K4 and K5: row bands of at most K4_MAX_ROWS
// rows, as even as H allows (H = 200 gives 8 bands of 25), column tiles of
// K4_COLS, and channel groups of K4_WARPS (K4); one slot per (item, band,
// tile)
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

// four results from column w0 on of a row, rounded to the storage type: one
// 16-byte (f32) or 8-byte (bf16) store when W is a multiple of 4, else one
// store a column
__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]), b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 q;
  q.x = *reinterpret_cast<unsigned*>(&a);
  q.y = *reinterpret_cast<unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = q;
}
template <bool VEC, typename T>
__device__ __forceinline__ void store_px(T* p, int w0, int W, const float* v) {
  if (VEC) {
    if (w0 < W) store4(p, v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (w0 + j < W) p[j] = from_f<T>(v[j]);
  }
}

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

// x of one slot with its zero halo (SAME padding), rounded as the products
// take it: (nrows + 4) rows of K4_TSTRIDE floats, column j at c0 + j - 2.
// Every load of a thread is issued before the first store, so the block
// waits for one load latency, not one a loop trip.
template <typename T>
__device__ __forceinline__ void stage_x(float* tile, const float* xb, int r0, int c0, int nrows,
                                        int H, int W) {
  constexpr int PER = ((K4_MAX_ROWS + 4) * K4_TSTRIDE + THREADS - 1) / THREADS;
  const int n = (nrows + 4) * K4_TSTRIDE;
  float v[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS;
    const int gr = r0 + i / K4_TSTRIDE - 2, gc = c0 + i % K4_TSTRIDE - 2;
    v[k] = (i < n && gr >= 0 && gr < H && gc >= 0 && gc < W)
               ? __ldg(xb + (long long)gr * W + gc) : 0.f;
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS;
    if (i < n) tile[i] = rnd<T>(v[k]);
  }
}

// ---------------------------------------------------------------------------
// K1

size_t conv_smem_bytes(int C) {
  return sizeof(float) * ((size_t)C * WPAD + C + (size_t)(K4_MAX_ROWS + 4) * K4_TSTRIDE);
}

// One block a slot (item, band, 128-column tile): x staged once, each warp
// owns channels warp, warp + 8, ...; each lane four adjacent columns, a
// 5 x 8 input window sliding down the band (a ring of five staged rows),
// one 16-byte (f32) or 8-byte (bf16) store a row, and the channel's sum of
// y and of y^2 over the band in registers, reduced once.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
conv_stats_kernel(const float* __restrict__ x,     // (B, 1, H, W)
                  const float* __restrict__ w,     // (C, 1, 5, 5)
                  const float* __restrict__ bias,  // (C,)
                  T* __restrict__ y,               // (B, C, H, W)
                  float* __restrict__ partials,    // (2, C, n_slots)
                  int H, int W, int C, int rows, int bands, int tiles_x) {
  extern __shared__ float4 smem4[];
  float* sw = reinterpret_cast<float*>(smem4);  // C x WPAD
  float* sb = sw + C * WPAD;                     // C
  float* tile = sb + C;                          // (rows + 4) x K4_TSTRIDE

  const long long slot = blockIdx.x;              // (b * bands + band) * tiles_x + tx
  const int tx = (int)(slot % tiles_x), band = (int)(slot / tiles_x % bands);
  const long long b = slot / tiles_x / bands;
  const int r0 = band * rows, c0 = tx * K4_COLS;
  const int nrows = min(rows, H - r0);

  // operands rounded to the storage type (bf16 mode), the bias not
  for (int i = threadIdx.x; i < C * WPAD; i += THREADS) {
    const int c = i / WPAD, k = i % WPAD;
    sw[i] = k < 25 ? rnd<T>(w[c * 25 + k]) : 0.f;
  }
  for (int i = threadIdx.x; i < C; i += THREADS) sb[i] = bias[i];
  stage_x<T>(tile, x + b * H * W, r0, c0, nrows, H, W);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = c0 + 4 * lane;  // this lane's four columns
  const float* tp = tile + 4 * lane;
  const long long n_slots = gridDim.x;
  for (int c = warp; c < C; c += WARPS) {
    float wk[WPAD];
    const float4* wc = reinterpret_cast<const float4*>(sw + c * WPAD);
#pragma unroll
    for (int q = 0; q < WPAD / 4; ++q) {
      const float4 v = wc[q];
      wk[4 * q] = v.x; wk[4 * q + 1] = v.y; wk[4 * q + 2] = v.z; wk[4 * q + 3] = v.w;
    }
    const float bc = sb[c];
    T* yc = y + ((b * C + c) * H + r0) * W + w0;
    // the ring: row i of the band reads slots (i + dh) % 5; the row loop is
    // unrolled by 5, so every slot index is a constant
    float win[5][8];
    auto stage_row = [&](int s, int r) {
      const float4 lo = *reinterpret_cast<const float4*>(tp + r * K4_TSTRIDE);
      const float4 hi = *reinterpret_cast<const float4*>(tp + r * K4_TSTRIDE + 4);
      win[s][0] = lo.x; win[s][1] = lo.y; win[s][2] = lo.z; win[s][3] = lo.w;
      win[s][4] = hi.x; win[s][5] = hi.y; win[s][6] = hi.z; win[s][7] = hi.w;
    };
#pragma unroll
    for (int r = 0; r < 4; ++r) stage_row(r, r);
    float s = 0.f, ss = 0.f;
    for (int i0 = 0; i0 < nrows; i0 += 5) {
#pragma unroll
      for (int u = 0; u < 5; ++u) {
        const int i = i0 + u;
        if (i >= nrows) break;
        stage_row((u + 4) % 5, i + 4);
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int dh = 0; dh < 5; ++dh)
#pragma unroll
            for (int dw = 0; dw < 5; ++dw)
              acc = fmaf(win[(u + dh) % 5][j + dw], wk[dh * 5 + dw], acc);
          v[j] = rnd<T>(acc + bc);  // the moments are of the stored value
          if (w0 + j < W) {
            s += v[j];
            ss = fmaf(v[j], v[j], ss);
          }
        }
        store_px<VEC>(yc + (long long)i * W, w0, W, v);
      }
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      partials[(long long)c * n_slots + slot] = s;
      partials[((long long)C + c) * n_slots + slot] = ss;
    }
  }
}

// K1's bf16 mode on the tensor cores: the conv as an implicit GEMM, pixels
// x taps (25, padded to 32 with zeros: two k-steps of 16) x the 32
// channels (four n-tiles of 8), mma.sync m16n8k16 bf16 -> f32.  A warp
// takes a 64-pixel segment of a row as four m-tiles; m-tile t's rows g and
// g + 8 are pixels 8g + 2t and 8g + 2t + 1, so after the four a lane holds
// 8 adjacent pixels of each of its 8 channels: one 16-byte store each.  The
// A fragments (the patches) are gathered from the staged x tile, the B
// fragments (the weights) stay in registers.  The bias is added in f32 and
// y rounded once; the moments are of the rounded values, in registers over
// the block's rows, reduced once.  Needs C = 32 and W a multiple of 8.
size_t conv_stats_mma_smem_bytes() {
  return sizeof(float) * ((size_t)(K4_MAX_ROWS + 4) * K4_TSTRIDE + 2 * WARPS * MMA_CH);
}

__global__ void __launch_bounds__(THREADS, 2)
conv_stats_mma_kernel(const float* __restrict__ x,     // (B, 1, H, W)
                      const float* __restrict__ w,     // (32, 1, 5, 5)
                      const float* __restrict__ bias,  // (32,)
                      bf16* __restrict__ y,            // (B, 32, H, W)
                      float* __restrict__ partials,    // (2, 32, n_slots)
                      int H, int W, int rows, int bands, int tiles_x) {
  extern __shared__ float4 smem4[];
  float* tile = reinterpret_cast<float*>(smem4);          // (rows + 4) x K4_TSTRIDE
  float* red = tile + (K4_MAX_ROWS + 4) * K4_TSTRIDE;     // 2 x WARPS x 32

  const long long slot = blockIdx.x;
  const int tx = (int)(slot % tiles_x), band = (int)(slot / tiles_x % bands);
  const long long b = slot / tiles_x / bands;
  const int r0 = band * rows, c0 = tx * K4_COLS;
  const int nrows = min(rows, H - r0);
  stage_x<bf16>(tile, x + b * H * W, r0, c0, nrows, H, W);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  // B: taps 16 ks + 2q, +1 (b0) and + 8, + 9 (b1) of channel 8 nt + g
  unsigned bw[4][2][2];
  float bs[4][2];  // the bias of this lane's channels 8 nt + 2q + e
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const float* wc = w + (8 * nt + g) * 25;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 16 * ks + 8 * h + 2 * q;
        bw[nt][ks][h] = pack_bf16(k < 25 ? wc[k] : 0.f, k + 1 < 25 ? wc[k + 1] : 0.f);
      }
    bs[nt][0] = bias[8 * nt + 2 * q];
    bs[nt][1] = bias[8 * nt + 2 * q + 1];
  }
  // this lane's taps as offsets into the tile: 16 ks + 8 h + 2q + e
  int toff[2][2][2];
  bool tval[2][2][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 16 * ks + 8 * h + 2 * q + e;
        tval[ks][h][e] = k < 25;
        toff[ks][h][e] = k < 25 ? (k / 5) * K4_TSTRIDE + k % 5 : 0;
      }
  float s[4][2], ss[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) s[nt][0] = s[nt][1] = ss[nt][0] = ss[nt][1] = 0.f;
  __syncthreads();

  // work items: (row, 64-pixel segment) of the band, warp, warp + 8, ...
  const int segs = 2;
  for (int it = warp; it < nrows * segs; it += WARPS) {
    const int i = it / segs, p0 = 64 * (it % segs) + 8 * g;  // the lane's pixels, tile-relative
    const bool in = c0 + p0 < W;  // 8 pixels all in or all out (W % 8 == 0)
    unsigned pk[4][2][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float* tr = tile + i * K4_TSTRIDE + p0 + 2 * t;  // pixel 8g + 2t
      float acc[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        unsigned a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float* p = tr + toff[ks][h][0];
          const float* pn = tr + toff[ks][h][1];
          const float lo0 = tval[ks][h][0] ? p[0] : 0.f, lo1 = tval[ks][h][1] ? pn[0] : 0.f;
          const float hi0 = tval[ks][h][0] ? p[1] : 0.f, hi1 = tval[ks][h][1] ? pn[1] : 0.f;
          a[2 * h] = pack_bf16(lo0, lo1);      // row g: pixel 8g + 2t
          a[2 * h + 1] = pack_bf16(hi0, hi1);  // row g + 8: pixel 8g + 2t + 1
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma16816(acc[nt], a, bw[nt][ks][0], bw[nt][ks][1]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v0 = rnd<bf16>(acc[nt][e] + bs[nt][e]);      // pixel 8g + 2t
          const float v1 = rnd<bf16>(acc[nt][2 + e] + bs[nt][e]);  // pixel 8g + 2t + 1
          if (in) {
            s[nt][e] += v0;
            ss[nt][e] = fmaf(v0, v0, ss[nt][e]);
            s[nt][e] += v1;
            ss[nt][e] = fmaf(v1, v1, ss[nt][e]);
          }
          pk[nt][e][t] = pack_bf16(v0, v1);
        }
    }
    if (in) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long o = ((b * MMA_CH + 8 * nt + 2 * q + e) * H + r0 + i) * W + c0 + p0;
          *reinterpret_cast<uint4*>(y + o) =
              make_uint4(pk[nt][e][0], pk[nt][e][1], pk[nt][e][2], pk[nt][e][3]);
        }
    }
  }
  // one reduction a block: over the 8 lanes of each channel, then the warps
  // in order
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float a = s[nt][e], c = ss[nt][e];
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        c += __shfl_xor_sync(0xffffffffu, c, o);
      }
      if (g == 0) {
        red[warp * MMA_CH + 8 * nt + 2 * q + e] = a;
        red[(WARPS + warp) * MMA_CH + 8 * nt + 2 * q + e] = c;
      }
    }
  __syncthreads();
  if (threadIdx.x < 2 * MMA_CH) {
    const int st = threadIdx.x / MMA_CH, ch = threadIdx.x % MMA_CH;
    float v = 0.f;
    for (int wp = 0; wp < WARPS; ++wp) v += red[(st * WARPS + wp) * MMA_CH + ch];
    partials[((long long)st * MMA_CH + ch) * gridDim.x + slot] = v;
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

// ---------------------------------------------------------------------------
// K3

// One block per (item, channel, band of cell rows); a cell is a 2x2 window
// of y (cells past the pooled grid, odd H or W, route nothing and write dy
// = 0).  Vector path (W a multiple of 2 * run, 16-byte aligned tensors):
// a thread takes a run of adjacent cells of one cell row, 8 in bf16 and 4
// in f32 (16 bytes of dp) -- y's two rows as two 16-byte loads each, dp as
// one, dy stored the same way -- and loads its next run before it routes
// the current one.  Per-cell path (any other width): one cell at a time, as
// K3's first design did.  A thread sums its runs in f32; the block reduces
// once and writes one slot of partial sums (rows sum dy, then sum dy *
// xhat, per channel) for reduce_partials_kernel.
template <typename T> __host__ __device__ constexpr int run_of() { return 16 / (int)sizeof(T); }  // cells a run
// runs (or cells) a band, at most: a plane a block in bf16 at 200 x 128;
// the f32 mode, with twice the bytes a run, ran faster in smaller blocks
// (8 a plane there) on the H100
template <typename T> constexpr int band_max() { return sizeof(T) == 2 ? 1024 : 256; }

// the block geometry of K3: bands of cell rows as even as the cell rows
// allow, each at most band_max runs (cells), and the thread count (a
// multiple of 32, 64-256) that leaves the fewest idle slots for a band
struct K3Geometry {
  bool vec;
  int Hc, Wc, per_row, bands, rows, threads;
  K3Geometry(int H, int W, bool aligned, int run, int band_max) {
    vec = aligned && W % (2 * run) == 0;
    Hc = (H + 1) / 2;
    Wc = (W + 1) / 2;
    per_row = vec ? Wc / run : Wc;
    const long long items = (long long)Hc * per_row;
    bands = (int)std::max(1LL, std::min((long long)Hc, (items + band_max - 1) / band_max));
    rows = (Hc + bands - 1) / bands;
    bands = (Hc + rows - 1) / rows;
    const int per_band = rows * per_row;
    threads = 256;
    long long best = -1;
    for (int it = std::max(1, (per_band + 255) / 256); it <= std::max(1, (per_band + 63) / 64);
         ++it) {
      const int t = std::max(64, ((per_band + it - 1) / it + 31) / 32 * 32);
      const long long waste = (long long)it * t - per_band;
      if (best < 0 || waste < best) { best = waste; threads = t; }
    }
  }
};

// raw 16-byte words as stored values (4 f32 or 8 bf16), and back
__device__ __forceinline__ void unpack16(const uint4& q, float* v) {  // f32
  v[0] = __uint_as_float(q.x); v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z); v[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack16_bf16(const uint4& q, float* v) {
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}
template <typename T, int N>
__device__ __forceinline__ void unpack(const uint4* q, float* v) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (sizeof(T) == 4) unpack16(q[i], v + 4 * i);
    else unpack16_bf16(q[i], v + 8 * i);
  }
}
__device__ __forceinline__ uint4 pack16(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack16_bf16(const float* v) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the first maximum of a cell's relu(bn), rounded as K2 stores it, in
// row-major order (max_pool2d's choice; rounding makes ties common in
// bf16), takes d where its bn is > 0; v: the cell's four y, g: its dy
template <typename T>
__device__ __forceinline__ void route_cell(const float* v, float d, float a, float sh,
                                           float* g) {
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
#pragma unroll
  for (int k = 0; k < 4; ++k) g[k] = k == best && bn[k] > 0.f ? d : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
route_kernel(const T* __restrict__ y,           // (B, C, H, W)
             const T* __restrict__ dp,          // (B, C, H/2, W/2)
             const float* __restrict__ scale,   // (C,)
             const float* __restrict__ shift,   // (C,)
             const float* __restrict__ mean,    // (C,)
             const float* __restrict__ inv,     // (C,)
             T* __restrict__ dy,                // (B, C, H, W)
             float* __restrict__ partials,      // (2, C, B * bands)
             int C, int H, int W, int bands, int rows, int per_row, bool vec) {
  __shared__ float red[2][WARPS];
  const long long plane = blockIdx.x / bands;   // b * C + c
  const int band = (int)(blockIdx.x % bands);
  const int c = (int)(plane % C);
  const long long b = plane / C;
  const int Ho = H / 2, Wo = W / 2, Hc = (H + 1) / 2, Wc = (W + 1) / 2;
  const int i0 = band * rows, i1 = min(Hc, i0 + rows);
  const int n_items = (i1 - i0) * per_row;
  const T* yp = y + plane * H * W;
  const T* dpp = dp + plane * Ho * Wo;
  T* dyp = dy + plane * H * W;
  const float a = __ldg(scale + c), sh = __ldg(shift + c);
  const float mu = __ldg(mean + c), iv = __ldg(inv + c);
  float s1 = 0.f, s2 = 0.f;
  if (vec) {
    // 16-byte words a run: y's two rows, dp; W is even here, so only a cell
    // row past the pooled grid (odd H) is ragged: it routes nothing
    constexpr int RUN = run_of<T>();
    constexpr int YW = 2 * RUN * sizeof(T) / 16, DW = RUN * sizeof(T) / 16;
    uint4 cy[2 * YW], cd[DW], ny[2 * YW], nd[DW];
    auto fetch = [&](int r, uint4 (&qy)[2 * YW], uint4 (&qd)[DW]) {
      const int i = i0 + r / per_row, j0 = (r % per_row) * RUN;
      if (i < Ho) {
        const uint4* p0 = reinterpret_cast<const uint4*>(yp + (long long)2 * i * W + 2 * j0);
        const uint4* p1 = reinterpret_cast<const uint4*>(yp + (long long)(2 * i + 1) * W + 2 * j0);
        const uint4* pd = reinterpret_cast<const uint4*>(dpp + (long long)i * Wo + j0);
#pragma unroll
        for (int k = 0; k < YW; ++k) {
          qy[k] = __ldg(p0 + k);
          qy[YW + k] = __ldg(p1 + k);
        }
#pragma unroll
        for (int k = 0; k < DW; ++k) qd[k] = __ldg(pd + k);
      }
    };
    const int step = blockDim.x;
    int r = threadIdx.x;
    if (r < n_items) fetch(r, cy, cd);
    for (; r < n_items; r += step) {
      // the next run's loads are in flight while this one is routed
      if (r + step < n_items) fetch(r + step, ny, nd);
      const int i = i0 + r / per_row, j0 = (r % per_row) * RUN;
      float out0[2 * RUN], out1[2 * RUN];
      if (i < Ho) {
        float y0[2 * RUN], y1[2 * RUN], d[RUN];
        unpack<T, YW>(cy, y0);
        unpack<T, YW>(cy + YW, y1);
        unpack<T, DW>(cd, d);
        float r1 = 0.f, r2 = 0.f;
#pragma unroll
        for (int j = 0; j < RUN; ++j) {
          const float v[4] = {y0[2 * j], y0[2 * j + 1], y1[2 * j], y1[2 * j + 1]};
          float g[4];
          route_cell<T>(v, d[j], a, sh, g);
          out0[2 * j] = g[0]; out0[2 * j + 1] = g[1];
          out1[2 * j] = g[2]; out1[2 * j + 1] = g[3];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            r1 += g[k];
            r2 += g[k] * ((v[k] - mu) * iv);
          }
        }
        s1 += r1;
        s2 += r2;
      } else {
#pragma unroll
        for (int k = 0; k < 2 * RUN; ++k) out0[k] = out1[k] = 0.f;
      }
      // exact: each value is 0 or a stored dp value
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (2 * i + h >= H) break;
        uint4* q = reinterpret_cast<uint4*>(dyp + (long long)(2 * i + h) * W + 2 * j0);
        const float* o = h ? out1 : out0;
#pragma unroll
        for (int k = 0; k < YW; ++k)
          q[k] = sizeof(T) == 4 ? pack16(o + 4 * k) : pack16_bf16(o + 8 * k);
      }
#pragma unroll
      for (int k = 0; k < 2 * YW; ++k) cy[k] = ny[k];
#pragma unroll
      for (int k = 0; k < DW; ++k) cd[k] = nd[k];
    }
  } else {
    for (int r = threadIdx.x; r < n_items; r += blockDim.x) {
      const int i = i0 + r / Wc, j = r % Wc;
      float v[4], g[4] = {0.f, 0.f, 0.f, 0.f};
      bool in[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int h = 2 * i + k / 2, w = 2 * j + k % 2;
        in[k] = h < H && w < W;
        v[k] = in[k] ? to_f(yp[(long long)h * W + w]) : 0.f;
      }
      if (i < Ho && j < Wo) route_cell<T>(v, to_f(dpp[(long long)i * Wo + j]), a, sh, g);
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
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) { red[0][warp] = s1; red[1][warp] = s2; }
  __syncthreads();
  if (threadIdx.x < 2) {
    float v = 0.f;
    for (int g = 0; g < (int)(blockDim.x >> 5); ++g) v += red[threadIdx.x][g];
    const long long n_slots = gridDim.x / C;   // B * bands
    const long long slot = b * bands + band;
    partials[((long long)threadIdx.x * C + c) * n_slots + slot] = v;
  }
}

// ---------------------------------------------------------------------------
// K2

// One block per (item, channel, band of pooled rows), in K3's geometry over
// the pooled grid (odd H or W floored: the last row or column of y is not
// read).  Vector path (W a multiple of 2 * run, 16-byte aligned tensors): a
// thread takes a run of adjacent pooled cells of one row, 8 in bf16 and 4
// in f32 (16 bytes of output) -- y's two rows as two 16-byte loads each --
// and loads its next run before it pools the current one.  Per-cell path
// (any other width or alignment): one cell at a time.  scale[c] and
// shift[c] are read once a block.  The max of the four rounded z equals the
// rounding of the max of the four f32 z (rounding to nearest is monotone),
// so one rounding at the store.
template <typename T>
__global__ void __launch_bounds__(THREADS)
norm_pool_kernel(const T* __restrict__ y,          // (B, C, H, W)
                 const float* __restrict__ scale,  // (C,)
                 const float* __restrict__ shift,  // (C,)
                 T* __restrict__ out,              // (B, C, H/2, W/2)
                 int C, int H, int W, int bands, int rows, int per_row, bool vec) {
  const long long plane = blockIdx.x / bands;   // b * C + c
  const int band = (int)(blockIdx.x % bands);
  const int c = (int)(plane % C);
  const int Ho = H / 2, Wo = W / 2;
  const int i0 = band * rows, i1 = min(Ho, i0 + rows);
  const int n_items = (i1 - i0) * per_row;
  const T* yp = y + plane * H * W;
  T* op = out + plane * Ho * Wo;
  const float a = __ldg(scale + c), sh = __ldg(shift + c);
  if (vec) {
    constexpr int RUN = run_of<T>();
    constexpr int YW = 2 * RUN * sizeof(T) / 16;  // 16-byte words a run of one y row
    uint4 cy[2 * YW], ny[2 * YW];
    auto fetch = [&](int r, uint4 (&qy)[2 * YW]) {
      const int i = i0 + r / per_row, j0 = (r % per_row) * RUN;
      const uint4* p0 = reinterpret_cast<const uint4*>(yp + (long long)2 * i * W + 2 * j0);
      const uint4* p1 = reinterpret_cast<const uint4*>(yp + (long long)(2 * i + 1) * W + 2 * j0);
#pragma unroll
      for (int k = 0; k < YW; ++k) {
        qy[k] = __ldg(p0 + k);
        qy[YW + k] = __ldg(p1 + k);
      }
    };
    const int step = blockDim.x;
    int r = threadIdx.x;
    if (r < n_items) fetch(r, cy);
    for (; r < n_items; r += step) {
      // the next run's loads are in flight while this one is pooled
      if (r + step < n_items) fetch(r + step, ny);
      const int i = i0 + r / per_row, j0 = (r % per_row) * RUN;
      float y0[2 * RUN], y1[2 * RUN], o[RUN];
      unpack<T, YW>(cy, y0);
      unpack<T, YW>(cy + YW, y1);
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        float m = bn_affine(y0[2 * j], a, sh);
        m = fmaxf(m, bn_affine(y0[2 * j + 1], a, sh));
        m = fmaxf(m, bn_affine(y1[2 * j], a, sh));
        m = fmaxf(m, bn_affine(y1[2 * j + 1], a, sh));
        o[j] = fmaxf(m, 0.f);
      }
      uint4 v;
      if constexpr (sizeof(T) == 4) v = pack16(o);
      else v = pack16_bf16(o);
      *reinterpret_cast<uint4*>(op + (long long)i * Wo + j0) = v;
#pragma unroll
      for (int k = 0; k < 2 * YW; ++k) cy[k] = ny[k];
    }
  } else {
    for (int r = threadIdx.x; r < n_items; r += blockDim.x) {
      const int i = i0 + r / Wo, j = r % Wo;
      const T* q = yp + (long long)2 * i * W + 2 * j;
      float m = bn_affine(to_f(q[0]), a, sh);
      m = fmaxf(m, bn_affine(to_f(q[1]), a, sh));
      m = fmaxf(m, bn_affine(to_f(q[W]), a, sh));
      m = fmaxf(m, bn_affine(to_f(q[W + 1]), a, sh));
      op[(long long)i * Wo + j] = from_f<T>(fmaxf(m, 0.f));
    }
  }
}

// ---------------------------------------------------------------------------
// K4

size_t weight_grads_fma_smem_bytes() {
  return sizeof(float) * (size_t)(K4_MAX_ROWS + 4) * K4_TSTRIDE;
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
  stage_x<T>(tile, xb, r0, c0, nrows, H, W);
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
  stage_x<bf16>(tile, xb, r0, c0, nrows, H, W);
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

size_t input_grad_fma_smem_bytes(int C) {
  return sizeof(float) * ((size_t)C * WPAD + (size_t)WARPS * K4_MAX_ROWS * K4_COLS);
}

// One block a slot (item, band, 128-column tile), no atomics: each warp
// owns channels warp, warp + 8, ...; each lane four adjacent output columns.
// Per channel the lane streams y and dy of its columns as one 16-byte
// (f32) or 8-byte (bf16) vector a row, two rows ahead, computes each dconv
// element once, and takes the two columns on each side from its neighbour
// lanes by shuffles (lanes 0 and 31 compute the tile's halo columns
// themselves); a ring of five dconv rows slides down the band.  Each warp
// keeps its partial dx of the band in shared memory (its own region, one
// 16-byte read-modify-write a lane a row and channel), and the block sums
// the eight partials in order once and writes dx once.
template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS, 2)
input_grad_kernel(const T* __restrict__ y,         // (B, C, H, W)
                  const T* __restrict__ dy,        // (B, C, H, W)
                  const float* __restrict__ w,     // (C, 1, 5, 5)
                  const float* __restrict__ ga,
                  const float* __restrict__ mean,
                  const float* __restrict__ inv,
                  const float* __restrict__ m1,
                  const float* __restrict__ m2,
                  float* __restrict__ dx,          // (B, 1, H, W)
                  int C, int H, int W, int rows, int bands, int tiles_x) {
  extern __shared__ float4 smem4[];
  float* swf = reinterpret_cast<float*>(smem4);    // C x WPAD, flipped taps
  float* part = swf + C * WPAD;                     // WARPS x rows x K4_COLS

  const long long slot = blockIdx.x;
  const int tx = (int)(slot % tiles_x), band = (int)(slot / tiles_x % bands);
  const long long b = slot / tiles_x / bands;
  const int r0 = band * rows, c0 = tx * K4_COLS;
  const int nrows = min(rows, H - r0);

  // dx(h, w) = sum over taps of wf[dh][dw] * dconv(h + dh - 2, w + dw - 2)
  // with wf[dh][dw] = W[4 - dh][4 - dw]
  for (int i = threadIdx.x; i < C * WPAD; i += THREADS) {
    const int c = i / WPAD, k = i % WPAD;
    swf[i] = k < 25 ? rnd<T>(w[c * 25 + 24 - k]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w0 = c0 + 4 * lane;
  // the halo columns lane 0 (c0 - 2, c0 - 1) or lane 31 (c0 + 128, + 129) computes
  const int hc = lane == 0 ? c0 - 2 : c0 + K4_COLS;
  const bool halo = lane == 0 || lane == 31;
  float* pw = part + (size_t)warp * K4_MAX_ROWS * K4_COLS + 4 * lane;
  bool first = true;
  for (int c = warp; c < C; c += WARPS) {
    const float g = __ldg(ga + c), mu = __ldg(mean + c), iv = __ldg(inv + c);
    const float a1 = __ldg(m1 + c), a2 = __ldg(m2 + c);
    float wk[WPAD];
    const float4* wc = reinterpret_cast<const float4*>(swf + c * WPAD);
#pragma unroll
    for (int q = 0; q < WPAD / 4; ++q) {
      const float4 v = wc[q];
      wk[4 * q] = v.x; wk[4 * q + 1] = v.y; wk[4 * q + 2] = v.z; wk[4 * q + 3] = v.w;
    }
    const long long base = (b * C + c) * H * W;
    // y and dy of input row r0 - 2 + q, two rows ahead of their use
    float py[2][4], pdy[2][4], hy[2][2], hdy[2][2];
    bool pv[2];
    auto fetch = [&](int q, int buf) {
      const int r = r0 - 2 + q;
      pv[buf] = q < nrows + 4 && r >= 0 && r < H;
      if (pv[buf]) {
        const long long o = base + (long long)r * W;
        load_px<VEC>(y + o + w0, w0, W, py[buf]);
        load_px<VEC>(dy + o + w0, w0, W, pdy[buf]);
        if (halo) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const bool in = hc + j >= 0 && hc + j < W;
            hy[buf][j] = in ? to_f(y[o + hc + j]) : 0.f;
            hdy[buf][j] = in ? to_f(dy[o + hc + j]) : 0.f;
          }
        }
      }
    };
    // the 8-column dconv window (w0 - 2 .. w0 + 5) of a fetched row into a
    // ring slot: dconv rounded as the products take it, 0 outside the image
    float win[5][8];
    auto stage = [&](int s, int buf) {
      float d[4], h[2];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        d[j] = pv[buf] && w0 + j < W
                   ? rnd<T>(dconv_of(py[buf][j], pdy[buf][j], g, mu, iv, a1, a2)) : 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        h[j] = halo && pv[buf] && hc + j >= 0 && hc + j < W
                   ? rnd<T>(dconv_of(hy[buf][j], hdy[buf][j], g, mu, iv, a1, a2)) : 0.f;
      const float l0 = __shfl_up_sync(0xffffffffu, d[2], 1);
      const float l1 = __shfl_up_sync(0xffffffffu, d[3], 1);
      const float u0 = __shfl_down_sync(0xffffffffu, d[0], 1);
      const float u1 = __shfl_down_sync(0xffffffffu, d[1], 1);
      win[s][0] = lane == 0 ? h[0] : l0;
      win[s][1] = lane == 0 ? h[1] : l1;
#pragma unroll
      for (int j = 0; j < 4; ++j) win[s][2 + j] = d[j];
      win[s][6] = lane == 31 ? h[0] : u0;
      win[s][7] = lane == 31 ? h[1] : u1;
    };
    fetch(0, 0);
    fetch(1, 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      stage(q, q % 2);
      fetch(q + 2, q % 2);
    }
    // output row i reads input rows i .. i + 4 (ring slots (i + dh) % 5);
    // unrolled by 10 so ring slots and fetch buffers are constants
    for (int i0 = 0; i0 < nrows; i0 += 10) {
#pragma unroll
      for (int u = 0; u < 10; ++u) {
        const int i = i0 + u;
        if (i >= nrows) break;
        stage((u + 4) % 5, u % 2);
        fetch(i + 6, u % 2);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int dh = 0; dh < 5; ++dh)
#pragma unroll
            for (int dw = 0; dw < 5; ++dw)
              acc[j] = fmaf(win[(u + dh) % 5][j + dw], wk[dh * 5 + dw], acc[j]);
        float4* pp = reinterpret_cast<float4*>(pw + i * K4_COLS);
        if (first) {
          *pp = make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else {
          const float4 o = *pp;
          *pp = make_float4(o.x + acc[0], o.y + acc[1], o.z + acc[2], o.w + acc[3]);
        }
      }
    }
    first = false;
  }
  if (first)  // a warp without a channel (C < 8) adds nothing
    for (int i = 0; i < nrows; ++i)
      *reinterpret_cast<float4*>(pw + i * K4_COLS) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  // the warps' partials summed in order, dx written once
  for (int idx = threadIdx.x; idx < nrows * 32; idx += THREADS) {
    const int i = idx / 32, l = idx % 32, wc = c0 + 4 * l;
    if (wc >= W) continue;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
    for (int wp = 0; wp < WARPS; ++wp) {
      const float4 p = *reinterpret_cast<const float4*>(
          part + ((size_t)wp * K4_MAX_ROWS + i) * K4_COLS + 4 * l);
      v[0] += p.x; v[1] += p.y; v[2] += p.z; v[3] += p.w;
    }
    store_px<VEC>(dx + (b * H + r0 + i) * W + wc, wc, W, v);
  }
}

// K5's bf16 mode on the tensor cores: P[h, w, dw] = sum over c, dh of
// dconv_bf16(c, h + dh - 2, w) * wf[c, dh, dw], an implicit GEMM with M =
// pixels, K = 32 channels x 5 row taps (ten k-steps of 16: (dh, channel
// half)), N = dw (5, padded to 8), on mma.sync m16n8k16 bf16 -> f32; then
// dx(h, w) = sum over dw of P[h, w + dw - 2, dw].  A warp takes a 16-column
// segment down the band; m-tile rows g and g + 8 are pixels 2g and 2g + 1,
// so a lane reads y and dy of its 8 channels as one 4-byte pair each, and
// computes each dconv element of its segment once into a ring of five rows
// of A fragments.  The B fragments (flipped weights) stay in registers.  P
// goes to shared memory, and after the band the block takes the shift-sum
// and writes dx once.  Needs C = 32, W a multiple of 16 and at most 128
// (one column tile: the shift-sum's halo is the zero border).
size_t input_grad_mma_smem_bytes() {
  return sizeof(float) * ((size_t)5 * MMA_CH + (size_t)K4_MAX_ROWS * K4_COLS * 5);
}

__global__ void __launch_bounds__(THREADS, 2)
input_grad_mma_kernel(const bf16* __restrict__ y,      // (B, 32, H, W)
                      const bf16* __restrict__ dy,     // (B, 32, H, W)
                      const float* __restrict__ w,     // (32, 1, 5, 5)
                      const float* __restrict__ ga,
                      const float* __restrict__ mean,
                      const float* __restrict__ inv,
                      const float* __restrict__ m1,
                      const float* __restrict__ m2,
                      float* __restrict__ dx,          // (B, 1, H, W)
                      int H, int W, int rows, int bands) {
  extern __shared__ float4 smem4[];
  float* prm = reinterpret_cast<float*>(smem4);  // ga, mean, inv, m1, m2 x 32
  float* ps = prm + 5 * MMA_CH;                  // rows x K4_COLS x 5: P[h, w, dw]

  const long long slot = blockIdx.x;  // b * bands + band
  const int band = (int)(slot % bands);
  const long long b = slot / bands;
  const int r0 = band * rows;
  const int nrows = min(rows, H - r0);
  if (threadIdx.x < MMA_CH) {
    const int c = threadIdx.x;
    prm[c] = ga[c]; prm[MMA_CH + c] = mean[c]; prm[2 * MMA_CH + c] = inv[c];
    prm[3 * MMA_CH + c] = m1[c]; prm[4 * MMA_CH + c] = m2[c];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int seg0 = warp * 16;
  if (seg0 < W) {
    // k column 2q + e (+ 8) of channel half hf is channel 16 hf + 2q + e (+ 8):
    // this lane's channels ch[hf][m], m = (e, + 8) in the order 2q, 2q+1, 2q+8, 2q+9
    // B: b0 = taps (dh, channels 16 hf + 2q, +1) at dw = g, b1 = channels + 8
    unsigned bw[5][2][2];
#pragma unroll
    for (int dh = 0; dh < 5; ++dh)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = 16 * hf + 8 * h + 2 * q;
          // wf[c, dh, dw] = W[c, 4 - dh, 4 - dw]
          bw[dh][hf][h] = g < 5 ? pack_bf16(w[c * 25 + (4 - dh) * 5 + 4 - g],
                                            w[(c + 1) * 25 + (4 - dh) * 5 + 4 - g]) : 0u;
        }
    // y and dy of the lane's pixels (2g, 2g + 1) and 8 channels, one row ahead
    const long long px = b * MMA_CH * H * W + seg0 + 2 * g;
    unsigned ny[8], ndy[8];
    bool nv;
    auto fetch = [&](int qr) {
      const int r = r0 - 2 + qr;
      nv = qr < nrows + 4 && r >= 0 && r < H;
      if (nv) {
#pragma unroll
        for (int m = 0; m < 8; ++m) {
          const int c = 16 * (m >> 2) + 2 * q + (m & 1) + 8 * ((m >> 1) & 1);
          const long long o = px + ((long long)c * H + r) * W;
          ny[m] = __ldg(reinterpret_cast<const unsigned*>(y + o));
          ndy[m] = __ldg(reinterpret_cast<const unsigned*>(dy + o));
        }
      }
    };
    // the A fragments of a row: a[hf] = {(2g; c, c+1), (2g+1; c, c+1),
    // (2g; c+8, c+9), (2g+1; c+8, c+9)} with c = 16 hf + 2q, dconv rounded
    unsigned ring[5][2][4];
    auto stage = [&](int s) {
      float d[8][2];
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int c = 16 * (m >> 2) + 2 * q + (m & 1) + 8 * ((m >> 1) & 1);
        const float2 yv = unpack_bf16(ny[m]), dv = unpack_bf16(ndy[m]);
        const float gg = prm[c], mu = prm[MMA_CH + c], iv = prm[2 * MMA_CH + c];
        const float a1 = prm[3 * MMA_CH + c], a2 = prm[4 * MMA_CH + c];
        d[m][0] = nv ? dconv_of(yv.x, dv.x, gg, mu, iv, a1, a2) : 0.f;
        d[m][1] = nv ? dconv_of(yv.y, dv.y, gg, mu, iv, a1, a2) : 0.f;
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int m = 4 * hf;  // channels c, c+1 are m, m+1; c+8, c+9 are m+2, m+3
        ring[s][hf][0] = pack_bf16(d[m][0], d[m + 1][0]);
        ring[s][hf][1] = pack_bf16(d[m][1], d[m + 1][1]);
        ring[s][hf][2] = pack_bf16(d[m + 2][0], d[m + 3][0]);
        ring[s][hf][3] = pack_bf16(d[m + 2][1], d[m + 3][1]);
      }
    };
    fetch(0);
#pragma unroll
    for (int qr = 0; qr < 4; ++qr) {
      stage(qr);
      fetch(qr + 1);
    }
    for (int i0 = 0; i0 < nrows; i0 += 5) {
#pragma unroll
      for (int u = 0; u < 5; ++u) {
        const int i = i0 + u;
        if (i >= nrows) break;
        stage((u + 4) % 5);
        fetch(i + 5);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int dh = 0; dh < 5; ++dh)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            mma16816(acc, ring[(u + dh) % 5][hf], bw[dh][hf][0], bw[dh][hf][1]);
        // acc: (pixel 2g; dw 2q, 2q+1), (pixel 2g+1; dw 2q, 2q+1)
        float* pr = ps + ((size_t)i * K4_COLS + seg0 + 2 * g) * 5;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (2 * q + e < 5) {
            pr[2 * q + e] = acc[e];
            pr[5 + 2 * q + e] = acc[2 + e];
          }
      }
    }
  }
  __syncthreads();
  // the shift-sum, dx written once: P past the image's columns is 0
  for (int idx = threadIdx.x; idx < nrows * W; idx += THREADS) {
    const int i = idx / W, wc = idx % W;
    float v = 0.f;
#pragma unroll
    for (int dw = 0; dw < 5; ++dw) {
      const int p = wc + dw - 2;
      if (p >= 0 && p < W) v += ps[((size_t)i * K4_COLS + p) * 5 + dw];
    }
    dx[(b * H + r0 + i) * W + wc] = v;
  }
}

// ---------------------------------------------------------------------------
// launches, one per mode each

template <typename T, bool VEC>
int launch_conv_stats(const float* x, const float* w, const float* bias, T* y, float* scratch,
                      int B, int C, int H, int W, void* stream) {
  const size_t smem = conv_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      conv_stats_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const K4Geometry geo(C, H, W);
  const long long n_blocks = geo.slots(B);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  conv_stats_kernel<T, VEC><<<(unsigned)n_blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, w, bias, y, scratch, H, W, C, geo.rows, geo.bands, geo.tiles_x);
  return (int)cudaGetLastError();
}

int launch_conv_stats_mma(const float* x, const float* w, const float* bias, bf16* y,
                          float* scratch, int B, int H, int W, void* stream) {
  const size_t smem = conv_stats_mma_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      conv_stats_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const K4Geometry geo(MMA_CH, H, W);
  const long long n_blocks = geo.slots(B);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  conv_stats_mma_kernel<<<(unsigned)n_blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, w, bias, y, scratch, H, W, geo.rows, geo.bands, geo.tiles_x);
  return (int)cudaGetLastError();
}

// the bf16 mode on the tensor cores for the model's 32 channels at widths
// that are a multiple of 8 (16-byte stores), else the FMA kernel (vector
// stores when W is a multiple of 4)
template <typename T>
int conv_stats(const float* x, const float* w, const float* bias, T* y, float* sums,
               float* scratch, int B, int C, int H, int W, void* stream) {
  const int err = sizeof(T) == 2 && C == MMA_CH && W % 8 == 0
      ? launch_conv_stats_mma(x, w, bias, reinterpret_cast<bf16*>(y), scratch, B, H, W, stream)
      : W % 4 == 0 ? launch_conv_stats<T, true>(x, w, bias, y, scratch, B, C, H, W, stream)
                   : launch_conv_stats<T, false>(x, w, bias, y, scratch, B, C, H, W, stream);
  if (err) return err;
  reduce_partials_kernel<<<2 * C, THREADS, 0, (cudaStream_t)stream>>>(
      scratch, sums, K4Geometry(C, H, W).slots(B));
  return (int)cudaGetLastError();
}

// K2 in K3's geometry over the pooled grid: 2 * (H/2) x 2 * (W/2) of y
template <typename T>
int norm_pool(const T* y, const float* scale, const float* shift, T* out, int B, int C,
              int H, int W, void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(out)) &
                        15) == 0 && W % (2 * run_of<T>()) == 0;
  const K3Geometry geo(H / 2 * 2, W / 2 * 2, aligned, run_of<T>(), band_max<T>());
  const long long n_blocks = (long long)B * C * geo.bands;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  norm_pool_kernel<T><<<(unsigned)n_blocks, geo.threads, 0, (cudaStream_t)stream>>>(
      y, scale, shift, out, C, H, W, geo.bands, geo.rows, geo.per_row, geo.vec);
  return (int)cudaGetLastError();
}

// K3's scratch: one slot of partial sums a block, for either path (the
// vector path needs 16-byte aligned tensors, known only at the launch)
long long route_scratch_floats(int B, int C, int H, int W) {
  int bands = 0;
  for (bool aligned : {true, false}) {
    bands = std::max(bands, K3Geometry(H, W, aligned, run_of<float>(), band_max<float>()).bands);
    bands = std::max(bands, K3Geometry(H, W, aligned, run_of<bf16>(), band_max<bf16>()).bands);
  }
  return 2LL * C * B * bands;
}

template <typename T>
int route(const T* y, const T* dp, const float* scale, const float* shift, const float* mean,
          const float* inv, T* dy, float* sums, float* scratch, int B, int C, int H, int W,
          void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(dp) |
                         reinterpret_cast<uintptr_t>(dy)) & 15) == 0;
  const K3Geometry geo(H, W, aligned, run_of<T>(), band_max<T>());
  const long long n_blocks = (long long)B * C * geo.bands;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  route_kernel<T><<<(unsigned)n_blocks, geo.threads, 0, (cudaStream_t)stream>>>(
      y, dp, scale, shift, mean, inv, dy, scratch, C, H, W, geo.bands, geo.rows, geo.per_row,
      geo.vec);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<2 * C, THREADS, 0, (cudaStream_t)stream>>>(
      scratch, sums, (long long)B * geo.bands);
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

size_t input_grad_smem_bytes(int C) {
  return std::max(input_grad_fma_smem_bytes(C), input_grad_mma_smem_bytes());
}

template <typename T, bool VEC>
int launch_input_grad(const T* y, const T* dy, const float* w, const float* ga,
                      const float* mean, const float* inv, const float* m1, const float* m2,
                      float* dx, int B, int C, int H, int W, void* stream) {
  const size_t smem = input_grad_fma_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      input_grad_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const K4Geometry geo(C, H, W);
  const long long n_blocks = geo.slots(B);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  input_grad_kernel<T, VEC><<<(unsigned)n_blocks, THREADS, smem, (cudaStream_t)stream>>>(
      y, dy, w, ga, mean, inv, m1, m2, dx, C, H, W, geo.rows, geo.bands, geo.tiles_x);
  return (int)cudaGetLastError();
}

int launch_input_grad_mma(const bf16* y, const bf16* dy, const float* w, const float* ga,
                          const float* mean, const float* inv, const float* m1,
                          const float* m2, float* dx, int B, int H, int W, void* stream) {
  const size_t smem = input_grad_mma_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      input_grad_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const K4Geometry geo(MMA_CH, H, W);
  const long long n_blocks = (long long)B * geo.bands;
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  input_grad_mma_kernel<<<(unsigned)n_blocks, THREADS, smem, (cudaStream_t)stream>>>(
      y, dy, w, ga, mean, inv, m1, m2, dx, H, W, geo.rows, geo.bands);
  return (int)cudaGetLastError();
}

// the bf16 mode on the tensor cores for the model's 32 channels at widths
// that are a multiple of 16 up to one column tile (the training windows'
// 128), else the FMA kernel (vector loads and stores when W is a multiple
// of 4 and y, dy start on a 4-element boundary)
template <typename T>
int input_grad(const T* y, const T* dy, const float* w, const float* ga, const float* mean,
               const float* inv, const float* m1, const float* m2, float* dx, int B, int C,
               int H, int W, void* stream) {
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(y) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(dy) % (4 * sizeof(T)) == 0;
  if (sizeof(T) == 2 && C == MMA_CH && W % 16 == 0 && W <= K4_COLS && vec)
    return launch_input_grad_mma(reinterpret_cast<const bf16*>(y),
                                 reinterpret_cast<const bf16*>(dy), w, ga, mean, inv, m1, m2,
                                 dx, B, H, W, stream);
  return vec ? launch_input_grad<T, true>(y, dy, w, ga, mean, inv, m1, m2, dx, B, C, H, W, stream)
             : launch_input_grad<T, false>(y, dy, w, ga, mean, inv, m1, m2, dx, B, C, H, W,
                                           stream);
}

}  // namespace

// Entry points: sept_<kernel> takes f32 storage, sept_<kernel>_bf16 bf16
// storage (the pointers typed void* are bf16 tensors).
extern "C" {

const char* sept_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Floats of scratch sept_conv_stats needs for its per-block partial sums.
long long sept_conv_stats_scratch_floats(int B, int C, int H, int W) {
  return 2LL * C * K4Geometry(C, H, W).slots(B);
}

long long sept_conv_stats_smem_bytes(int C) {
  return (long long)std::max(conv_smem_bytes(C), conv_stats_mma_smem_bytes());
}

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
