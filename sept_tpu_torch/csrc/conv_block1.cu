// First conv block of Conv2dBiRNN, forward, for Hopper (sm_90a).
//
// Replaces the forward pair of sept_tpu/ops/pallas_conv.py:
//   K1 _k1_conv_stats -> sept_conv_stats: conv 5x5, 1 -> C channels, SAME,
//      + bias, stored NCHW f32, and the per-channel sum of y and of y^2 over
//      the batch (the BatchNorm batch moments);
//   K2 _k2_norm_pool  -> sept_norm_pool: y * a[c] + b[c] (BatchNorm folded to
//      one scale and shift), ReLU, 2x2 stride-2 max pool, NCHW out.
// The backward kernels K3-K5 are not ported yet.
//
// What bounds them on the H100: bytes.  K1 does 25 multiply-adds per output
// element but writes C = 32 floats for every input float it reads, and K2
// reads those back to write a quarter of them; at the serving shapes the
// conv output (B, 32, 200, 128) f32 is 3.3 MB a window, so both kernels sit
// on the memory-rate floor long before the f32 rate.
//
// Design:
// - The TPU kernel turned the conv into one banded GEMM and rolled rows to
//   fit Mosaic's (8, 128) tiling; none of that carries over.  Here a block
//   stages a (32+4) x (32+4) input tile with its zero halo (the SAME padding)
//   in shared memory, each thread keeps the 8 x 5 input patch of its four
//   vertically adjacent output pixels in registers, and loops over the C
//   channels with the 25 weights of each read as float4 broadcasts from
//   shared memory.  Every store is a 32-float coalesced row segment.
// - On the TPU the grid ran in order and K1 carried the moments from one item
//   to the next (pl.when(b == 0)).  Blocks here run in any order, so each
//   block writes its per-channel partial sums to scratch, and a second pass
//   adds them per channel in double: deterministic, and exact to f32 for the
//   rel 1e-5 moment tolerance.
// - K2 is elementwise over pooled outputs; it rounds y * a + b as torch's
//   separate multiply and add do (no FMA contraction), so it agrees with its
//   plain version bit for bit.
// - Any H and W are taken; the pool floors odd sizes as max_pool2d does.  The
//   fixed 200 x 128 geometry and the bf16-only rule of the TPU path were
//   limits of its VMEM and do not apply.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;                // tile columns (one warp lane each)
constexpr int TH = 32;                // tile rows
constexpr int RPT = 4;                // rows per thread
constexpr int WARPS = TH / RPT;       // 8
constexpr int THREADS = 32 * WARPS;   // 256
constexpr int WPAD = 28;              // 25 taps padded to 7 float4
constexpr int HALO_W = TW + 4, HALO_H = TH + 4;

size_t conv_smem_bytes(int C) {
  return sizeof(float) * ((size_t)C * WPAD + C + HALO_H * HALO_W + 2 * WARPS * C);
}

long long conv_blocks(int B, int H, int W) {
  return (long long)((W + TW - 1) / TW) * ((H + TH - 1) / TH) * B;
}

__global__ void __launch_bounds__(THREADS)
conv_stats_kernel(const float* __restrict__ x,     // (B, 1, H, W)
                  const float* __restrict__ w,     // (C, 1, 5, 5)
                  const float* __restrict__ bias,  // (C,)
                  float* __restrict__ y,           // (B, C, H, W)
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

  for (int i = threadIdx.x; i < C * WPAD; i += THREADS) {
    const int c = i / WPAD, k = i % WPAD;
    sw[i] = k < 25 ? w[c * 25 + k] : 0.f;
  }
  for (int i = threadIdx.x; i < C; i += THREADS) sb[i] = bias[i];
  for (int i = threadIdx.x; i < HALO_H * HALO_W; i += THREADS) {
    const int gr = r0 + i / HALO_W - 2, gc = c0 + i % HALO_W - 2;
    tile[i] = (gr >= 0 && gr < H && gc >= 0 && gc < W) ? xb[(long long)gr * W + gc] : 0.f;
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
    float* yc = y + ((long long)b * C + c) * H * W;
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
        yc[(long long)(row0 + i) * W + col] = acc;
        s += acc;
        ss = fmaf(acc, acc, ss);
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

// sums[i] = sum over blocks of partials[i, :], one block per (stat, channel).
__global__ void __launch_bounds__(THREADS)
reduce_partials_kernel(const float* __restrict__ partials, float* __restrict__ sums,
                       long long n_blocks) {
  __shared__ double buf[THREADS];
  const float* row = partials + (long long)blockIdx.x * n_blocks;
  double v = 0.0;
  for (long long j = threadIdx.x; j < n_blocks; j += THREADS) v += row[j];
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int o = THREADS / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) buf[threadIdx.x] += buf[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) sums[blockIdx.x] = (float)buf[0];
}

__global__ void __launch_bounds__(THREADS)
norm_pool_kernel(const float* __restrict__ y,      // (B, C, H, W)
                 const float* __restrict__ scale,  // (C,)
                 const float* __restrict__ shift,  // (C,)
                 float* __restrict__ out,          // (B, C, H/2, W/2)
                 int C, int H, int W, int Ho, int Wo, long long total) {
  for (long long idx = (long long)blockIdx.x * THREADS + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * THREADS) {
    const int j = (int)(idx % Wo);
    const long long r = idx / Wo;
    const int i = (int)(r % Ho);
    const long long bc = r / Ho;
    const int c = (int)(bc % C);
    const float* q = y + (bc * H + 2 * i) * W + 2 * j;
    const float a = __ldg(scale + c), sh = __ldg(shift + c);
    float m = __fadd_rn(__fmul_rn(q[0], a), sh);
    m = fmaxf(m, __fadd_rn(__fmul_rn(q[1], a), sh));
    m = fmaxf(m, __fadd_rn(__fmul_rn(q[W], a), sh));
    m = fmaxf(m, __fadd_rn(__fmul_rn(q[W + 1], a), sh));
    out[idx] = fmaxf(m, 0.f);
  }
}

}  // namespace

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
  const size_t smem = conv_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(
      conv_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const long long n_blocks = conv_blocks(B, H, W);
  if (n_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  conv_stats_kernel<<<(unsigned)n_blocks, THREADS, smem, (cudaStream_t)stream>>>(
      x, w, bias, y, scratch, H, W, C, tiles_x, tiles_y);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<2 * C, THREADS, 0, (cudaStream_t)stream>>>(scratch, sums, n_blocks);
  return (int)cudaGetLastError();
}

int sept_norm_pool(const float* y, const float* scale, const float* shift, float* out,
                   int B, int C, int H, int W, void* stream) {
  const int Ho = H / 2, Wo = W / 2;
  const long long total = (long long)B * C * Ho * Wo;
  const long long blocks = (total + THREADS - 1) / THREADS;
  const int grid = (int)(blocks < (1LL << 20) ? blocks : (1LL << 20));
  norm_pool_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(y, scale, shift, out, C, H, W,
                                                              Ho, Wo, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
