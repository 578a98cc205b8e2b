// Fused log-mel spectrogram of the frontend, for Hopper (sm_90a), in two
// modes: f32 (this part) and bf16 (bfk::mel_bf16_kernel, further down).
//
// Replaces: sept_tpu/ops/pallas_frontend.py::_mel_kernel (f32 mode), launched
// there by pallas_mel_spectrogram.  Computes, for each frame t of each
// reflect-padded waveform b,
//
//     out[b, t, m] = 10 * log10(max(sum_f P[t, f] * fb[f, m], 1e-10))
//     P[t, f]      = |sum_n x[t, n] exp(-2 pi i f n / n_fft)|^2
//     x[t, n]      = wave[b, t * hop + n] * hann[n]
//
// What bounds it on the H100: the function is cheap.  A real FFT of 800 taps
// is ~2.5 * 800 * log2(800) ~ 19k flops a frame and the sparse mel bank ~1.6k
// (791 nonzeros at n_fft 800), against 4 bytes of waveform read per hop and
// 512 bytes of dB written per frame, so the least time is about equally set
// by those operations and by the bytes.  An earlier design computed the DFT
// as a dense product (2 * n_fft * (n_fft/2 + 1) multiply-adds a frame, ~65x
// the FFT) and the bank as a dense product, and wrote per-frequency-tile
// partial sums to scratch for a second kernel: its own operations set its
// time (0.408 ms at the serving shape, (8, 96640) -> 600 frames, NVIDIA
// H100 80GB HBM3, 700 W; PERF.md).
// This design does the FFT's operations, in one launch.
//
// Why the FFT runs in float64: the kernel is held cell by cell against the
// plain version's dense f32 DFT, and where the two part, against a float64
// chain.  On bands 60-110 dB under their frame's peak (the mfcc's gradient
// streams) an FFT in f32 parts from the truth by up to 9e-3 dB, farther
// than the dense DFT on some cells (PERF.md).  In float64 the FFT's rounding
// drops out: the windowed frame is exact (a product of two f32 values), and
// the roundings left are X to f32, the f32 power and the f32 bank sums,
// ~1e-5 dB.  The H100 runs float64 at half the f32 rate, and the buffers
// take twice the shared memory.
//
// Design:
// - One kernel a call, writing (B, T, n_mels) dB directly: no scratch.
// - Framing happens inside the kernel.  A block takes TF consecutive frames
//   of one row and stages their raw samples ((TF-1)*hop + n_fft floats,
//   zeros past the row's end) in shared memory once, beside the window and
//   one complex float64 buffer pair per warp.  The twiddles stay in device
//   memory, read through the read-only cache (every warp reads the same).
// - One warp owns one frame at a time (two for an odd n_fft; WP warps).  For
//   an even n_fft the real FFT is a complex FFT of M = n_fft/2 on z[n] =
//   x[2n] + i x[2n+1] (the window applied as the frame is packed), then the
//   split post-pass
//       X[k] = E + W^k O,  X[M-k] = conj(E - W^k O),  W = exp(-2 pi i / n_fft)
//       E = (Z[k] + conj(Z[M-k])) / 2,  O = -i (Z[k] - conj(Z[M-k])) / 2
//   for k = 0..M/2 (Z[M] = Z[0], so k = 0 gives bins 0 and M).  An odd
//   n_fft has no half-length packing: a warp takes two frames at once, z[n]
//   = x1[n] + i x2[n], a complex FFT of M = n_fft, and X1[k] = E, X2[k] = O
//   for k = 0..n_fft/2.
// - The complex FFT is a Stockham autosort FFT (no bit-reversal pass) in the
//   order of the plan ops/mel.py builds per n_fft: radix-4, 2, 5 and 3
//   passes.  A pass of radix R over q already-combined points maps input
//   i + r*M/R to output (i - i%q)*R + i%q + s*q after the twiddles
//   exp(-2 pi i r (i%q) / (q R)) and a length-R DFT on the R inputs of a
//   butterfly in registers; the twiddles come from tables computed in
//   float64.  Where M has a prime factor above 5 (n_fft 802: M = 401; odd
//   799 = 17 * 47) M's DFT runs as Bluestein's cyclic convolution of a
//   2-3-5-smooth length F >= 2M - 1: X[k] = w[k] (a * h)[k] with the chirp
//   w[n] = exp(-pi i n^2 / M), a = x w zero-padded to F and h = conj(w)
//   wrapped; two FFTs of F (the inverse as the forward FFT of the
//   conjugate) with the filter's spectrum FFT(h) / F from the plan's table.
//   So one path takes every M off the 2-3-5 rule, at O(F log F).  Passes
//   ping-pong between the warp's two buffers with __syncwarp between them.
// - The plan's radices are staged in shared memory once a block, and the
//   kernel takes a budget of 128 registers (__maxnreg__): with the radices
//   read from the kernel's parameter space in the stage loop, and the 64
//   registers ptxas picks on its own (spilling), the kernel ran slower at
//   every n_fft (PERF.md).
// - X rounds to f32 and the power |X|^2 is f32 with no contraction
//   (__fmul_rn, __fadd_rn), as the plain version rounds it, into the warp's
//   free buffer.
// - The mel bank is sparse: per band its first bin, its bin count and an
//   offset into a flat weight array (each band's nonzeros are contiguous),
//   taken from the dense melscale_fbanks table.  Each lane sums its bands'
//   bins in ascending order in f32 (the dense product adds exact zeros
//   elsewhere), takes 10*log10(max(., 1e-10)), and the warp writes the
//   frame's n_mels floats as one coalesced row.
// - No TF32 anywhere.
// - Shared memory grows with n_fft and hop (two buffers of F complex
//   float64 values a warp, F = M or the Bluestein length); the block takes
//   8 warps and 32 frames, or the largest (warps, frames) of 8, 4, 2, 1
//   warps and 32 ... 1 frames (never fewer frames than warps) that fits the
//   card's 227 KB: n_fft 1600 at hop 160 takes 8 warps and 16 frames (~222
//   KB), n_fft 2048 4 warps, n_fft 2042 (F = 2048) 2 warps, n_fft 2047 (F =
//   4096) 1 warp.  Every n_fft from 2 to 2048 at hop 160 fits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int WARPS = 8;              // most warps a block, one frame each at a time
constexpr int MAX_STAGES = 24;        // radix passes of the plan
constexpr int SMEM_LIMIT = 232448;    // shared memory a block may opt into on Hopper

// The Stockham passes of one complex FFT of length len (the product of the
// radices, each 2-5); n_tables: complex values of their twiddle tables.
struct FftPlan {
  int n_stages, len, n_tables;
  int radix[MAX_STAGES];
};

__device__ __forceinline__ double2 cmul(double2 a, double2 b) {
  return make_double2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}
__device__ __forceinline__ double2 cadd(double2 a, double2 b) { return make_double2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ double2 csub(double2 a, double2 b) { return make_double2(a.x - b.x, a.y - b.y); }
// -i * a and +i * a
__device__ __forceinline__ double2 mul_mi(double2 a) { return make_double2(a.y, -a.x); }
__device__ __forceinline__ double2 mul_pi(double2 a) { return make_double2(-a.y, a.x); }
__device__ __forceinline__ double2 cscale(double2 a, double s) { return make_double2(a.x * s, a.y * s); }

// in-register DFT of length R, u'[s] = sum_r u[r] exp(-2 pi i r s / R)
template <int R> __device__ __forceinline__ void dft(double2* u);

template <> __device__ __forceinline__ void dft<2>(double2* u) {
  const double2 a = u[0], b = u[1];
  u[0] = cadd(a, b);
  u[1] = csub(a, b);
}

template <> __device__ __forceinline__ void dft<4>(double2* u) {
  const double2 t0 = cadd(u[0], u[2]), t1 = csub(u[0], u[2]);
  const double2 t2 = cadd(u[1], u[3]), t3 = csub(u[1], u[3]);
  u[0] = cadd(t0, t2);
  u[2] = csub(t0, t2);
  u[1] = cadd(t1, mul_mi(t3));
  u[3] = cadd(t1, mul_pi(t3));
}

template <> __device__ __forceinline__ void dft<3>(double2* u) {
  const double s3 = 0.866025403784438647;  // sin(2 pi / 3)
  const double2 t = cadd(u[1], u[2]), d = csub(u[1], u[2]);
  const double2 m = csub(u[0], cscale(t, 0.5));
  const double2 r = cscale(mul_mi(d), s3);
  u[0] = cadd(u[0], t);
  u[1] = cadd(m, r);
  u[2] = csub(m, r);
}

template <> __device__ __forceinline__ void dft<5>(double2* u) {
  const double c1 = 0.309016994374947424;   // cos(2 pi / 5)
  const double c2 = -0.809016994374947424;  // cos(4 pi / 5)
  const double s1 = 0.951056516295153572;   // sin(2 pi / 5)
  const double s2 = 0.587785252292473129;   // sin(4 pi / 5)
  const double2 a = u[0];
  const double2 t1 = cadd(u[1], u[4]), d1 = csub(u[1], u[4]);
  const double2 t2 = cadd(u[2], u[3]), d2 = csub(u[2], u[3]);
  const double2 m1 = cadd(a, cadd(cscale(t1, c1), cscale(t2, c2)));
  const double2 m2 = cadd(a, cadd(cscale(t1, c2), cscale(t2, c1)));
  const double2 r1 = mul_mi(cadd(cscale(d1, s1), cscale(d2, s2)));
  const double2 r2 = mul_mi(csub(cscale(d1, s2), cscale(d2, s1)));
  u[0] = cadd(a, cadd(t1, t2));
  u[1] = cadd(m1, r1);
  u[4] = csub(m1, r1);
  u[2] = cadd(m2, r2);
  u[3] = csub(m2, r2);
}

// One Stockham pass of radix R over a warp's buffer: p points already
// combined, tw the pass's p x (R-1) twiddles (device memory, read through
// the read-only cache: every warp of the block reads the same ones).
template <int R>
__device__ __forceinline__ void fft_pass(const double2* __restrict__ in, double2* __restrict__ out,
                                         int M, int p, const double2* __restrict__ tw, int lane) {
  const int nb = M / R;
  for (int i = lane; i < nb; i += 32) {
    const int k = i % p;
    double2 u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) u[r] = in[i + r * nb];
#pragma unroll
    for (int r = 1; r < R; ++r) u[r] = cmul(u[r], __ldg(tw + k * (R - 1) + r - 1));
    dft<R>(u);
    const int j = (i - k) * R + k;
#pragma unroll
    for (int s = 0; s < R; ++s) out[j + s * p] = u[s];
  }
}

// The plan's passes over a warp's two buffers, __syncwarp after each;
// returns the buffer that holds the result.
__device__ double2* stockham(double2* src, double2* dst, const int* radix, int n_stages,
                             int F, const double2* __restrict__ twiddles, int lane) {
  const double2* twp = twiddles;
  int p = 1;
  for (int s = 0; s < n_stages; ++s) {
    const int r = radix[s];
    switch (r) {
      case 4: fft_pass<4>(src, dst, F, p, twp, lane); break;
      case 2: fft_pass<2>(src, dst, F, p, twp, lane); break;
      case 5: fft_pass<5>(src, dst, F, p, twp, lane); break;
      case 3: fft_pass<3>(src, dst, F, p, twp, lane); break;
    }
    twp += p * (r - 1);
    p *= r;
    double2* sw = src; src = dst; dst = sw;
    __syncwarp();
  }
  return src;
}

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// the complex FFT's length: n_fft / 2 (the half-length packing) for an even
// n_fft, n_fft itself for an odd one
__host__ __device__ inline int fft_len(int n_fft) { return n_fft % 2 ? n_fft : n_fft / 2; }

// shared memory, in bytes: the segment of tf frames, the window, two
// buffers of F complex float64 values (F the plan's length) for each of wp
// warps, and the plan's radices
struct MelLayout {
  size_t seg, win, buf, rad, total;
  __host__ __device__ MelLayout(int n_fft, int hop, int F, int tf, int wp) {
    seg = 0;
    win = align16(seg + ((size_t)(tf - 1) * hop + n_fft) * 4);
    buf = align16(win + (size_t)n_fft * 4);
    rad = align16(buf + (size_t)wp * 2 * F * 16);
    total = align16(rad + (size_t)MAX_STAGES * 4);
  }
};

// (frames, warps) of a block: 8 warps and the most frames of 32, 16, 8 that
// fit; else the same with 4, 2, then 1 warp (frames >= warps).  Nothing may
// fit (1 warp, 1 frame): the wrapper refuses that shape by its size.
struct MelConfig {
  int tf, wp;
  MelLayout lay;
  MelConfig(int n_fft, int hop, int F) : tf(1), wp(1), lay(n_fft, hop, F, 1, 1) {
    for (int w = WARPS; w >= 1; w /= 2)
      for (int f = 32; f >= w; f /= 2)
        if (MelLayout(n_fft, hop, F, f, w).total <= (size_t)SMEM_LIMIT) {
          tf = f;
          wp = w;
          lay = MelLayout(n_fft, hop, F, f, w);
          return;
        }
  }
};

__global__ void __maxnreg__(128)
mel_fft_kernel(const float* __restrict__ wave,      // (B, L)
               const float* __restrict__ window,    // (n_fft,)
               const double2* __restrict__ twiddles,  // (n_tw,) complex float64
               const int* __restrict__ bank_idx,    // (3, n_mels): first bin, count, offset
               const float* __restrict__ bank_w,    // flat band weights
               float* __restrict__ out,             // (B, T, n_mels)
               int L, int T, int n_fft, int hop, int n_mels, int tf, int wp, int n_ttiles,
               FftPlan plan) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const int F = plan.len;
  const MelLayout lay(n_fft, hop, F, tf, wp);
  float* seg = reinterpret_cast<float*>(smem + lay.seg);
  float* win = reinterpret_cast<float*>(smem + lay.win);
  int* radix = reinterpret_cast<int*>(smem + lay.rad);
  const bool odd = n_fft % 2;
  const int M = fft_len(n_fft);
  const bool blue = F != M;  // Bluestein: M's DFT as a cyclic convolution of length F
  // after the plan's tables: the split post-pass's twiddles (even n_fft),
  // then for Bluestein the chirp w[n] = exp(-pi i n^2 / M), n < M, and the
  // filter's spectrum FFT_F(conj w, wrapped) / F
  const double2* post = twiddles + plan.n_tables;
  const double2* chirp = post + (odd ? 0 : n_fft / 4 + 1);
  const double2* filt = chirp + M;
  const int nthreads = 32 * wp;

  const int tid = threadIdx.x;
  const int tt = blockIdx.x % n_ttiles;
  const int b = blockIdx.x / n_ttiles;
  const int t0 = tt * tf;
  const int seg_len = (tf - 1) * hop + n_fft;
  const long long base = (long long)b * L + (long long)t0 * hop;
  const long long avail = (long long)L - (long long)t0 * hop;
  for (int i = tid; i < seg_len; i += nthreads) seg[i] = i < avail ? wave[base + i] : 0.f;
  for (int i = tid; i < n_fft; i += nthreads) win[i] = window[i];
  if (tid < plan.n_stages) radix[tid] = plan.radix[tid];
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  double2* buf0 = reinterpret_cast<double2*>(smem + lay.buf) + (size_t)warp * 2 * F;
  double2* buf1 = buf0 + F;
  const int* first = bank_idx;
  const int* count = bank_idx + n_mels;
  const int* offset = bank_idx + 2 * n_mels;

  // an odd n_fft has no half-length packing: a warp takes two frames at
  // once as the real and imaginary parts of one complex FFT of n_fft
  const int step = odd ? 2 : 1;
  const int nb = n_fft / 2 + 1;  // bins
  for (int f = warp * step; f < tf; f += wp * step) {
    const int t = t0 + f;
    if (t >= T) break;
    const bool two = odd && f + 1 < tf && t + 1 < T;
    const float* x = seg + f * hop;
    const float* x2 = x + hop;
    __syncwarp();  // the previous frame's mel stage is done with the buffers
    // pack the windowed frame (a product of two f32 values is exact in
    // float64): z[n] = x[2n] + i x[2n+1] for an even n_fft, x[n] + i x2[n]
    // (x2 the next frame, or 0) for an odd one; for Bluestein times the
    // chirp, zeros from M to F
    for (int n = lane; n < F; n += 32) {
      double2 z = make_double2(0.0, 0.0);
      if (n < M) {
        z = odd ? make_double2((double)x[n] * (double)win[n],
                               two ? (double)x2[n] * (double)win[n] : 0.0)
                : make_double2((double)x[2 * n] * (double)win[2 * n],
                               (double)x[2 * n + 1] * (double)win[2 * n + 1]);
        if (blue) z = cmul(z, __ldg(chirp + n));
      }
      buf0[n] = z;
    }
    __syncwarp();
    double2* src = stockham(buf0, buf1, radix, plan.n_stages, F, twiddles, lane);
    if (blue) {
      // times the filter's spectrum, then the inverse FFT as the forward one
      // of the conjugate: Z[k] = w[k] conj(FFT(conj(A Hf)))[k] for k < M
      for (int k = lane; k < F; k += 32) {
        const double2 v = cmul(src[k], __ldg(filt + k));
        src[k] = make_double2(v.x, -v.y);
      }
      __syncwarp();
      src = stockham(src, src == buf0 ? buf1 : buf0, radix, plan.n_stages, F, twiddles,
                     lane);
      for (int k = lane; k < M; k += 32) {
        const double2 v = src[k];
        src[k] = cmul(__ldg(chirp + k), make_double2(v.x, -v.y));
      }
      __syncwarp();
    }
    // Z in src; the power of bins 0..n_fft/2 into dst (an odd n_fft's
    // second frame after the first's).  X rounds to f32 and the power is
    // f32 with no contraction, as the plain version computes it
    float* power = reinterpret_cast<float*>(src == buf0 ? buf1 : buf0);
    if (odd) {
      // X1[k] = (Z[k] + conj(Z[M-k])) / 2, X2[k] = -i (Z[k] - conj(Z[M-k])) / 2
      for (int k = lane; k < nb; k += 32) {
        const double2 zk = src[k], zm = src[k == 0 ? 0 : M - k];
        const double2 zc = make_double2(zm.x, -zm.y);
        const double2 x1 = cscale(cadd(zk, zc), 0.5), x2 = cscale(mul_mi(csub(zk, zc)), 0.5);
        const float r1 = (float)x1.x, i1 = (float)x1.y, r2 = (float)x2.x, i2 = (float)x2.y;
        power[k] = __fadd_rn(__fmul_rn(r1, r1), __fmul_rn(i1, i1));
        power[nb + k] = __fadd_rn(__fmul_rn(r2, r2), __fmul_rn(i2, i2));
      }
    } else {
      // the split post-pass
      for (int k = lane; k <= M / 2; k += 32) {
        const double2 zk = src[k], zm = src[k == 0 ? 0 : M - k];
        const double2 zc = make_double2(zm.x, -zm.y);
        const double2 e = cscale(cadd(zk, zc), 0.5);
        const double2 o = cscale(mul_mi(csub(zk, zc)), 0.5);
        const double2 wo = cmul(__ldg(post + k), o);
        const double2 x1 = cadd(e, wo), x2 = csub(e, wo);  // X[k], conj(X[M-k])
        const float r1 = (float)x1.x, i1 = (float)x1.y, r2 = (float)x2.x, i2 = (float)x2.y;
        power[k] = __fadd_rn(__fmul_rn(r1, r1), __fmul_rn(i1, i1));
        if (M - k != k) power[M - k] = __fadd_rn(__fmul_rn(r2, r2), __fmul_rn(i2, i2));
      }
    }
    __syncwarp();
    // the sparse mel bank, each band's bins in ascending order
    for (int u = 0; u < (two ? 2 : 1); ++u) {
      const float* pw = power + u * nb;
      float* orow = out + ((long long)b * T + t + u) * n_mels;
      for (int m = lane; m < n_mels; m += 32) {
        const int f0 = __ldg(first + m), nf = __ldg(count + m);
        const float* w = bank_w + __ldg(offset + m);
        float acc = 0.f;
        for (int q = 0; q < nf; ++q) acc = fmaf(pw[f0 + q], __ldg(w + q), acc);
        orow[m] = 10.f * log10f(fmaxf(acc, 1e-10f));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 mode: the throughput mode of _mel_kernel (pallas_mel_spectrogram with
// bf16=True, launched by device_ingest(frontend="pallas_bf16")).
//
// What it computes: the same chain with the operands rounded to bf16 at the
// TPU kernel's six places -- the waveform, the Hann window, their product
// (one bf16 multiply), the cos/sin tables, the power re^2 + im^2 (computed in
// f32, then rounded) and the mel filterbank -- and every product accumulated
// in f32; the output is f32 dB.  A product of two bf16 values is exact in
// f32, so the tensor cores' bf16 MMA with f32 accumulation computes the same
// function as f32 FMAs on the rounded operands, up to summation order.  The
// DFT stays a dense product: the bf16-rounded basis is part of the function.
//
// What bounds it on the H100: the dense DFT products its bf16 tables fix
// and the bank's nonzero products (~1.3 MFLOP a frame at n_fft 800; ~0.33
// ms at the bf16 tensor-core peak for the ingest's 257k frames).  The table
// traffic from L2 (every 64 frames stream the whole cos/sin table, 1.4 MB
// at n_fft 800) costs little: the kernel without its copies is 2% faster.
// What holds this design above the bound (PERF.md, by the cut variants of
// mel_bf16_variants.py): one block an SM (the frame tile and the ring fill
// shared memory), so the tensor cores idle while a frame tile is built
// (cutting the build saves a fifth of the time) and while each chunk's
// products drain before its power; and the pipeline's own waits and
// barriers (with the products, copies, build and output cut, a third of the
// time is left).
//
// Design (Hopper: wgmma, bulk asynchronous copies, mbarriers):
// - A block takes TF = 64 frames of one row (wgmma's M).  Its 2 consumer
//   warpgroups build the windowed frame tile -- rounding points 1-3 -- once,
//   K-major in the 128-byte swizzled layout wgmma reads, where it fits beside
//   the ring (n_fft <= 1024: 104 KB at n_fft 800), from the block's samples
//   staged once in shared memory as bf16 (each sample read once, by 16-byte
//   loads) where they fit; otherwise both build 64-tap slabs of it into a
//   three-slab buffer as they go.
// - The wrapper lays the cos/sin table out tile by tile in that same
//   swizzled order: per chunk of NC = 64 frequencies and slab of 64 taps,
//   128 rows (cos and sin of a frequency interleaved) of 128 bytes.  So a
//   1-D bulk copy (cp.async.bulk, completion on an mbarrier) brings a tile;
//   no tensor map is needed.  A ring of 4-6 such stages (full/empty
//   mbarrier pairs) is kept full by the four warps of a producer
//   warpgroup, one lane each, each for its own stages (one lane for every
//   stage measures the same at the ingest shape).
// - The blocks are persistent, one an SM, and walk the frame tiles; the
//   ring streams on from one tile to the next, so the next tile's first
//   copies overlap this tile's output and the next frame tile's build.
//   (Two-block clusters that multicast each table tile into both blocks,
//   halving the L2 -> shared traffic, were 11% slower: PERF.md.)
// - Both warpgroups take every chunk, each its half of the 128 columns
//   (split at a multiple of 32): the DFT product is wgmma m64n64k16 (bf16
//   -> f32) over the slabs, two slabs' products in flight a warpgroup, so
//   one warpgroup's waits and releases hide behind the other's products.
// - Cos and sin interleaved put re and im of a frequency in one thread's
//   accumulator pair: the power is computed (no FMA) and rounded to bf16 in
//   registers and stored into the chunk's power tile (64 frames x 64
//   frequencies, K-major, swizzled; two, alternating).  The mel product
//   reads it from shared memory: warpgroup w takes mel columns 64 w ..
//   64 w + 63 over all the chunk's frequencies (wgmma m64n32k16), so no
//   partial sums are added afterwards, and its products run on into the
//   next chunk's DFT.  (With the power as wgmma's A operand from registers
//   the compiler waited for every earlier product before each of them.)
// - The filterbank comes through the same ring, one stage a chunk (128 mels
//   x 64 frequencies), in 32-mel sub-tiles: a sub-tile that is zero for the
//   chunk is neither copied nor multiplied (exact: its products are +0).
// - The last chunk is cut to a multiple of 16 frequencies (wgmma N a
//   multiple of 32 here): 416 computed for 401 at n_fft 800.  Taps pad to a
//   multiple of 64 in the table; k-steps past n_fft are skipped.
// - Mel columns go in passes of 128, as many as n_mels needs (each pass
//   runs the chunks' DFT again); each warpgroup writes 10*log10(max(.,
//   1e-10)) of its 64.

namespace bfk {

constexpr int TF = 64;                 // frames a block (wgmma M)
constexpr int NC = 64;                 // frequencies a chunk: 128 cos/sin columns
constexpr int KS = 64;                 // taps a slab: one 128-byte swizzled row
constexpr int MEL_TILE = 128;          // mel columns a pass
constexpr int MEL_SUB = 32;            // mel columns a sub-tile
constexpr int FREQ_ALIGN = 16;         // the last chunk's frequencies round up to this
constexpr int TILE_BYTES = 2 * NC * KS * 2;   // one ring stage: 16 KB
constexpr int SLAB_BYTES = TF * KS * 2;       // one 64-tap slab of the frame tile: 8 KB
constexpr int SUB_BYTES = MEL_SUB * KS * 2;   // one mel sub-tile of a bank stage: 4 KB
constexpr int CONSUMERS = 2;           // consumer warpgroups
// and a producer warpgroup, one lane of each warp working: launched at 168
// registers a thread (384 threads), the producer gives 128 of each of its
// threads back (setmaxnreg) and the consumers take them, at 232
constexpr int THREADS_B = 128 * (CONSUMERS + 1);
constexpr int STAGES_MIN = 4, STAGES_MAX = 6;
constexpr int PTILE_BYTES = TF * NC * 2;  // a chunk's power tile, bf16: 8 KB
// the samples and window a frame tile is built from, then two power tiles
constexpr int SCRATCH_BYTES = 32768;

__host__ __device__ inline int k_pad_of(int n_fft) { return (n_fft + KS - 1) / KS * KS; }

// shared memory, in bytes from a 1024-byte aligned base: the frame tile
// (whole, or three slabs), the ring, the scratch, the
// barriers; 1 KB more is allocated for the alignment
struct Layout {
  bool resident;
  int stages;
  size_t a, ring, scratch, bars, total;
  __host__ __device__ Layout(int n_fft) {
    const size_t whole = (size_t)TF * k_pad_of(n_fft) * 2;
    const size_t fixed = SCRATCH_BYTES + 2 * STAGES_MAX * 8 + 1024;
    resident = whole + STAGES_MIN * (size_t)TILE_BYTES + fixed <= (size_t)SMEM_LIMIT;
    const size_t a_bytes = resident ? whole : (size_t)3 * SLAB_BYTES;
    stages = (int)((SMEM_LIMIT - a_bytes - fixed) / TILE_BYTES);
    if (stages > STAGES_MAX) stages = STAGES_MAX;
    a = 0;
    ring = a_bytes;
    scratch = ring + (size_t)stages * TILE_BYTES;
    bars = scratch + SCRATCH_BYTES;
    total = bars + 2 * STAGES_MAX * 8 + 1024;
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// bytes (a multiple of 16) from device memory into shared memory, counted
// on the barrier bar
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, int bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator accesses across a wait
template <int N> __device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// a K-major operand tile in the 128-byte swizzle: 8-row groups 1024 bytes
// apart (the stride byte offset), rows of 128 bytes within a group
__device__ __forceinline__ uint64_t desc_sw128(unsigned addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}
// byte offset of the 16-byte group holding taps 8*c8 .. 8*c8 + 7 of row r
// in a swizzled tile
__device__ __forceinline__ unsigned swz(int r, int c8) {
  return (unsigned)(r * 128 + ((c8 ^ (r & 7)) << 4));
}

// d (64 x 32, f32) = A (64 x 16, shared memory) * B (16 x 32, shared memory)
// + (scale ? d : 0)
__device__ __forceinline__ void wgmma_ss_n32(float* d, uint64_t da, uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale));
}

// the same, 64 x 64
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db, int scale) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale));
}


// the 8 samples from pos on of a row (f32, zeros past its end), and the
// window's taps k0 .. k0 + 7 (bf16, zeros past n_fft)
__device__ __forceinline__ void load8(const float* __restrict__ row, long long avail,
                                      long long pos, bool vec, float* x) {
  if (vec && pos + 8 <= avail) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(row + pos));
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + pos + 4));
    x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
    x[4] = v.x; x[5] = v.y; x[6] = v.z; x[7] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = pos + e < avail ? __ldg(row + pos + e) : 0.f;
  }
}
__device__ __forceinline__ uint4 window8(const __nv_bfloat16* __restrict__ window, int k0,
                                         int n_fft) {
  if (k0 + 8 <= n_fft) return __ldg(reinterpret_cast<const uint4*>(window + k0));
  unsigned w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const unsigned lo = k0 + 2 * e < n_fft ? __bfloat16_as_ushort(window[k0 + 2 * e]) : 0u;
    const unsigned hi = k0 + 2 * e + 1 < n_fft ? __bfloat16_as_ushort(window[k0 + 2 * e + 1]) : 0u;
    w[e] = lo | hi << 16;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 b2 = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&b2);
}
// rounding points 1-3: the samples rounded to bf16, times the bf16 window,
// the product rounded to bf16; taps past n_fft are 0
__device__ __forceinline__ uint4 windowed(const float* x, uint4 w, int k0, int n_fft) {
  const unsigned wv[4] = {w.x, w.y, w.z, w.w};
  unsigned o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 wf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&wv[e]));
    const float a = __fmul_rn(__bfloat162float(__float2bfloat16_rn(x[2 * e])), wf.x);
    const float b = __fmul_rn(__bfloat162float(__float2bfloat16_rn(x[2 * e + 1])), wf.y);
    o[e] = pack_bf16(k0 + 2 * e < n_fft ? a : 0.f, k0 + 2 * e + 1 < n_fft ? b : 0.f);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// f32 power of (re, im), uncontracted as the plain version computes it
__device__ __forceinline__ float power_of(float re, float im) {
  return __fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im));
}

template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int scale);
template <>
__device__ __forceinline__ void wgmma_ss<32>(float* d, uint64_t da, uint64_t db, int scale) {
  wgmma_ss_n32(d, da, db, scale);
}
template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da, uint64_t db, int scale) {
  wgmma_ss_n64(d, da, db, scale);
}

// a consumer's place in the ring: the next item's stage and the parity of
// its full barrier's phase, and the stages of the two items before it,
// advanced by increments (a division a step cost more than the step)
struct Pipe {
  int s, ph, prev1, prev2;
  int bank;   // the stage of a bank item whose mel products may still run, or -1
  int pbuf;   // the power tile the next chunk writes
  __device__ __forceinline__ void advance(int stages) {
    prev2 = prev1;
    prev1 = s;
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
};

// i / d and i % d for 0 <= i < 2^16 and 1 <= d <= 2^10 by a float product:
// (i + 1/2) / d lies at least 1/(2d) from an integer, far above the
// product's rounding
__device__ __forceinline__ int div_small(int i, float inv_d) {
  return (int)(((float)i + 0.5f) * inv_d);
}

// what a consumer warpgroup needs of the block
struct Ctx {
  const float* row;                 // the block's waveform row
  long long avail;                  // samples of it from the block's first frame on
  const __nv_bfloat16* window;
  int n_fft, hop, n_slabs, k16, stages, tid;
  bool resident, vec;
  char* smem;                       // the aligned base, generic
  unsigned smem_addr, power;        // its shared address; the power tiles' offset
  unsigned a, ring, full, empty;    // shared addresses
};

// a warpgroup gives stage s back: one arrival from each of its warps on the
// stage's empty barrier
__device__ __forceinline__ void release(const Ctx& cx, int s, int wt) {
  if ((wt & 31) == 0) mbar_arrive(cx.empty + 8 * s);
}

// groups of 8 taps of the windowed frame tile: group i of a (TF x 8*groups)
// tile, into the swizzled slab (i % groups) / 8 at a_off; BATCH groups'
// loads in flight a thread
__device__ __forceinline__ void build_tile(const Ctx& cx, unsigned a_off, int tap0, int groups,
                                           int first) {
  constexpr int STRIDE = 128 * CONSUMERS;
  constexpr int BATCH = 4;
  const int total = TF * groups;
  const float inv = 1.f / (float)groups;
  for (int i0 = first; i0 < total; i0 += STRIDE * BATCH) {
    float x[BATCH][8];
    uint4 w[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * STRIDE;
      if (i < total) {
        const int t = div_small(i, inv), c = i - t * groups, k0 = tap0 + 8 * c;
        load8(cx.row, cx.avail, (long long)t * cx.hop + k0, cx.vec, x[u]);
        w[u] = window8(cx.window, k0, cx.n_fft);
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int i = i0 + u * STRIDE;
      if (i < total) {
        const int t = div_small(i, inv), c = i - t * groups;
        *reinterpret_cast<uint4*>(cx.smem + a_off + (c / 8) * SLAB_BYTES + swz(t, c % 8)) =
            windowed(x[u], w[u], tap0 + 8 * c, cx.n_fft);
      }
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The whole frame tile from the block's samples staged once in shared
// memory (seg, rounding point 1: bf16) beside the window (win, zeros past
// n_fft), where they fit: each sample is read from device memory once, by
// 16-byte loads, instead of once for each frame it falls in.  Threads: the
// 256 consumer threads.
__device__ __forceinline__ void build_tile_staged(const Ctx& cx, __nv_bfloat16* seg, int seg_len,
                                                  __nv_bfloat16* win, int groups, int tid) {
  constexpr int STRIDE = 128 * CONSUMERS;
  for (int c = tid; c < groups; c += STRIDE)
    *reinterpret_cast<uint4*>(win + 8 * c) = window8(cx.window, 8 * c, cx.n_fft);
#pragma unroll 8
  for (int i = 4 * tid; i < seg_len; i += 4 * STRIDE) {
    float x[4];
    if (cx.vec && i + 4 <= cx.avail) {
      const float4 u = __ldg(reinterpret_cast<const float4*>(cx.row + i));
      x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = i + e < cx.avail ? __ldg(cx.row + i + e) : 0.f;
    }
    *reinterpret_cast<uint2*>(seg + i) = make_uint2(pack_bf16(x[0], x[1]), pack_bf16(x[2], x[3]));
  }
  named_sync(1, STRIDE);
  const bool aligned = cx.hop % 8 == 0;
  const float inv = 1.f / (float)groups;
  for (int i = tid; i < TF * groups; i += STRIDE) {
    const int t = div_small(i, inv), c = i - t * groups, k0 = 8 * c;
    const __nv_bfloat16* src = seg + t * cx.hop + k0;
    float x[8];
    if (aligned) {
      const uint4 q = *reinterpret_cast<const uint4*>(src);
      const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e]));
        x[2 * e] = f.x;
        x[2 * e + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = __bfloat162float(src[e]);
    }
    *reinterpret_cast<uint4*>(cx.smem + (c / 8) * SLAB_BYTES + swz(t, c % 8)) =
        windowed(x, *reinterpret_cast<const uint4*>(win + k0), k0, cx.n_fft);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A consumer warpgroup's share of one chunk: NCOLS of its cos/sin columns
// (NCOLS / 2 frequencies) from column col0 on.  The DFT product over the
// slabs (the chunk's first n_slabs ring items), two slabs' products in
// flight; the power of its frequencies into the chunk's power tile; then,
// the tile whole, the mel product of all the chunk's frequencies for the
// warpgroup's 64 mel columns, with the chunk's bank stage (its last item),
// left running into the next chunk.  Both warpgroups take every item and
// give every stage back.  NCOLS 0: the warpgroup has no DFT columns in this
// chunk.  cols: the chunk's columns (both warpgroups').
template <int NCOLS>
__device__ __forceinline__ void chunk(const Ctx& cx, Pipe& pp, unsigned mask, int col0, int cols,
                                      int wt, int wg, float (&mel)[2][16]) {
  // the first product of the chunk overwrites the accumulators (scale 0):
  // no other instruction may define them while the last chunk's mel
  // products still run, or the compiler serializes every wgmma
  constexpr int NA = NCOLS > 0 ? NCOLS / 2 : 1;
  float acc[NA];
  for (int k = 0; k < cx.n_slabs; ++k) {
    const int s = pp.s;
    mbar_wait(cx.full + 8 * s, pp.ph);
    unsigned a_slab = cx.a + k * SLAB_BYTES;
    if (!cx.resident) {
      // slab k of the frame tile, into buffer k % 3 (both warpgroups'
      // products that read slab k - 3 from it finished before the barrier
      // that ended step k - 1); both warpgroups build it, and it serves both
      const unsigned off = (k % 3) * SLAB_BYTES;
      build_tile(cx, off, k * KS, KS / 8, cx.tid);
      named_sync(2, 128 * CONSUMERS);
      a_slab = cx.a + off;
    }
    if constexpr (NCOLS > 0) {
      const unsigned b_tile = cx.ring + s * TILE_BYTES + col0 * 128;
      const int steps = min(KS / 16, cx.k16 - k * (KS / 16));
      wgmma_fence();
#pragma unroll
      for (int u = 0; u < KS / 16; ++u)
        if (u < steps)
          wgmma_ss<NA * 2>(acc, desc_sw128(a_slab + 32 * u), desc_sw128(b_tile + 32 * u),
                           k > 0 || u > 0);
      wgmma_commit();
      wgmma_wait<2>();
      fence_regs<NA>(acc);
    } else if (k == 0) {
      wgmma_wait<0>();
    }
    // the last chunk's mel products are done by now (older than the slab
    // products waited for): its bank stage goes back
    if (k == 1 - (NCOLS == 0) && pp.bank >= 0) {
      release(cx, pp.bank, wt);
      pp.bank = -1;
    }
    // slab k - 2's products are done: its stage goes back to the producers
    if (k > 1) release(cx, pp.prev2, wt);
    if (!cx.resident) named_sync(3, 128 * CONSUMERS);  // both are past slab k - 1's reads
    pp.advance(cx.stages);
  }
  wgmma_wait<0>();
  fence_regs<NA>(acc);
  if (pp.bank >= 0) {
    release(cx, pp.bank, wt);
    pp.bank = -1;
  }
  if (cx.n_slabs > 1) release(cx, pp.prev2, wt);
  release(cx, pp.prev1, wt);

  // rounding point 5: the power of each of the warpgroup's frequencies (re,
  // im in one thread's accumulator pair: column group j holds frequency
  // col0 / 2 + 4 j + q of rows r and r + 8), rounded to bf16, into the
  // chunk's power tile: K-major, the 128-byte swizzle, as wgmma reads A
  char* ptile = cx.smem + cx.power + pp.pbuf * PTILE_BYTES;
  if constexpr (NCOLS > 0) {
    const int lane = wt % 32, r = 16 * (wt / 32) + lane / 4, q = lane % 4;
#pragma unroll
    for (int j = 0; j < NCOLS / 8; ++j) {
      const int f = col0 / 2 + 4 * j + q;
      const unsigned off = ((f >> 3) ^ (r & 7)) << 4 | (f & 7) * 2;
      *reinterpret_cast<__nv_bfloat16*>(ptile + r * 128 + off) =
          __float2bfloat16_rn(power_of(acc[4 * j], acc[4 * j + 1]));
      *reinterpret_cast<__nv_bfloat16*>(ptile + (r + 8) * 128 + off) =
          __float2bfloat16_rn(power_of(acc[4 * j + 2], acc[4 * j + 3]));
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(1, 128 * CONSUMERS);  // the chunk's power tile is whole
  const int s = pp.s;
  mbar_wait(cx.full + 8 * s, pp.ph);
  // the warpgroup's mel sub-tiles 2 wg and 2 wg + 1, over the chunk's
  // frequencies (cols / 32 k-steps), where the bank is not zero
  const unsigned fb = cx.ring + s * TILE_BYTES;
  const unsigned pt = cx.smem_addr + cx.power + pp.pbuf * PTILE_BYTES;
  const int steps = cols / 32;
  wgmma_fence();
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (mask >> (2 * wg + h) & 1) {
#pragma unroll
      for (int q16 = 0; q16 < NC / 16; ++q16)
        if (q16 < steps)
          wgmma_ss<32>(mel[h], desc_sw128(pt + 32 * q16),
                       desc_sw128(fb + (2 * wg + h) * SUB_BYTES + 32 * q16), 1);
    }
  wgmma_commit();
  pp.bank = s;
  pp.pbuf ^= 1;
  pp.advance(cx.stages);
}

__global__ void __launch_bounds__(THREADS_B, 1)
mel_bf16_kernel(const float* __restrict__ wave,             // (B, L)
                const __nv_bfloat16* __restrict__ window,   // (n_fft,)
                const __nv_bfloat16* __restrict__ table,    // swizzled cos/sin tiles
                const __nv_bfloat16* __restrict__ bank,     // swizzled filterbank stages
                const unsigned char* __restrict__ masks,    // (passes, chunks) sub-tiles
                float* __restrict__ out,                    // (B, T, n_mels)
                int L, int T, int n_fft, int hop, int n_mels, int n_chunks, int tail_cols,
                int n_ttiles, int n_blocks, bool vec) {
  extern __shared__ float4 smem4[];
  const Layout lay(n_fft);
  const unsigned raw = smem_u32(smem4);
  const unsigned base = (raw + 1023) & ~1023u;
  const int n_slabs = k_pad_of(n_fft) / KS;
  const int passes = (n_mels + MEL_TILE - 1) / MEL_TILE;
  const int per_chunk = n_slabs + 1;  // ring items a chunk: its slabs, then its bank stage
  const unsigned full = base + (unsigned)lay.bars, empty = full + 8 * STAGES_MAX;
  const int tid = threadIdx.x;
  // rows start 8-byte aligned: two mels a store
  const bool pairs = n_mels % 2 == 0 && (reinterpret_cast<uintptr_t>(out) & 7) == 0;
  // persistent blocks: block k takes the frame tiles k, k + gridDim.x, ...

  if (tid == 0) {
    for (int s = 0; s < lay.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CONSUMERS);  // one arrival from each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();  // the barriers exist before anyone uses them

  // the roles by warp, broadcast so that the compiler sees them uniform
  // (wgmma under a branch it cannot prove uniform is serialized)
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  if (warp_id >= 4 * CONSUMERS) {
    // the producer warpgroup: few registers; lane 0 of warp j streams the
    // ring items of stages j, j + 4, ... in order (up to four chains of
    // waits and copies in flight; one chain a stage, so that no wait runs
    // two phases ahead of its barrier)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid % 32 == 0) {
      const int j = warp_id - 4 * CONSUMERS;
      const int per_tile = passes * n_chunks;
      const int items =
          (n_blocks - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * per_tile * per_chunk;
      // item g: stage s (round parity ph), item i of chunk c, chunk q of
      // the tile's passes
      int s = 0, ph = 0, i = 0, c = 0, q = 0;
      for (int g = 0; g < items; ++g) {
        if ((s & 3) == j) {
          mbar_wait(empty + 8 * s, ph ^ 1);
          const unsigned dst = base + (unsigned)lay.ring + s * TILE_BYTES;
          if (i < n_slabs) {
            const int rows = c == n_chunks - 1 ? tail_cols : 2 * NC;
            const int bytes = rows * KS * 2;
            const char* src = reinterpret_cast<const char*>(table) +
                              (size_t)c * n_slabs * TILE_BYTES + (size_t)i * bytes;
            mbar_expect_tx(full + 8 * s, bytes);
            bulk_copy(dst, src, bytes, full + 8 * s);
          } else {
            const unsigned m = masks[q];
            mbar_expect_tx(full + 8 * s, __popc(m) * SUB_BYTES);
            const char* src = reinterpret_cast<const char*>(bank) + (size_t)q * TILE_BYTES;
            for (int ms = 0; ms < 4; ++ms)
              if (m >> ms & 1)
                bulk_copy(dst + ms * SUB_BYTES, src + ms * SUB_BYTES, SUB_BYTES, full + 8 * s);
          }
        }
        if (++s == lay.stages) {
          s = 0;
          ph ^= 1;
        }
        if (++i == per_chunk) {
          i = 0;
          if (++q == per_tile) q = 0;
          if (++c == n_chunks) c = 0;
        }
      }
    }
    return;
  }

  // the consumer warpgroups: the accumulators' registers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp_id / 4, wt = tid % 128;
  Ctx cx;
  cx.window = window;
  cx.n_fft = n_fft;
  cx.hop = hop;
  cx.n_slabs = n_slabs;
  cx.k16 = (n_fft + 15) / 16;
  cx.stages = lay.stages;
  cx.tid = tid;
  cx.resident = lay.resident;
  cx.vec = vec;
  cx.smem = reinterpret_cast<char*>(smem4) + (base - raw);
  cx.smem_addr = base;
  cx.power = (unsigned)lay.scratch;
  cx.a = base + (unsigned)lay.a;
  cx.ring = base + (unsigned)lay.ring;
  cx.full = full;
  cx.empty = empty;
  const int warp = wt / 32, lane = wt % 32, gq = lane / 4, q = lane % 4;
  Pipe pp = {0, 0, 0, 0, -1, 0};
  for (int tile = blockIdx.x; tile < n_blocks; tile += gridDim.x) {
    const int b = tile / n_ttiles, t0 = tile % n_ttiles * TF;
    cx.row = wave + (long long)b * L + (long long)t0 * hop;
    cx.avail = (long long)L - (long long)t0 * hop;
    if (lay.resident) {
      // the whole windowed frame tile, once: slab k at k * SLAB_BYTES; its
      // samples and the window staged in the scratch (its power tiles not
      // in use yet) where they fit: the samples with the taps past n_fft a
      // frame reads, the window at the scratch's end
      const int seg_len = (TF - 1) * hop + n_fft, k_pad = k_pad_of(n_fft);
      __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(cx.smem + lay.scratch);
      if (seg_len * 2 + 128 + k_pad * 2 <= SCRATCH_BYTES)
        build_tile_staged(cx, stage, seg_len, stage + SCRATCH_BYTES / 2 - k_pad, k_pad / 8, tid);
      else
        build_tile(cx, (unsigned)lay.a, 0, k_pad_of(n_fft) / 8, tid);
      named_sync(1, 128 * CONSUMERS);
    }

    for (int p = 0; p < passes; ++p) {
      float mel[2][16];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 16; ++i) mel[h][i] = 0.f;
      for (int c = 0; c < n_chunks; ++c) {
        const unsigned m = __shfl_sync(0xffffffffu, (unsigned)__ldg(masks + p * n_chunks + c), 0);
        // the chunk's DFT columns split at a multiple of 32: warpgroup 0
        // the first min(64, ...) of them, warpgroup 1 the rest (0, 32 or 64)
        const int cols = c == n_chunks - 1 ? tail_cols : 2 * NC;
        const int cols0 = min(2 * NC / CONSUMERS, (cols / 2 + 31) / 32 * 32);
        const int mine = wg == 0 ? cols0 : cols - cols0;
        const int col0 = wg == 0 ? 0 : cols0;
        switch (mine) {
          case 32: chunk<32>(cx, pp, m, col0, cols, wt, wg, mel); break;
          case 64: chunk<64>(cx, pp, m, col0, cols, wt, wg, mel); break;
          default: chunk<0>(cx, pp, m, col0, cols, wt, wg, mel); break;
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int h = 0; h < 2; ++h) fence_regs<16>(mel[h]);
      if (pp.bank >= 0) {
        release(cx, pp.bank, wt);
        pp.bank = -1;
      }
      // each warpgroup writes the dB of its 64 mel columns, two adjacent
      // mels a store
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          const int t = t0 + 16 * warp + gq + 8 * ((i >> 1) & 1);
          const int m = p * MEL_TILE + (2 * wg + h) * MEL_SUB + 8 * (i >> 2) + 2 * q;
          const float d0 = 10.f * log10f(fmaxf(mel[h][i], 1e-10f));
          const float d1 = 10.f * log10f(fmaxf(mel[h][i + 1], 1e-10f));
          float* o = out + ((long long)b * T + t) * n_mels + m;
          if (t < T) {
            if (pairs && m + 1 < n_mels) {
              *reinterpret_cast<float2*>(o) = make_float2(d0, d1);
            } else {
              if (m < n_mels) o[0] = d0;
              if (m + 1 < n_mels) o[1] = d1;
            }
          }
        }
      named_sync(1, 128 * CONSUMERS);  // both are done with the power tiles
    }
  }
}

}  // namespace bfk

}  // namespace

extern "C" {

const char* sept_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Shared memory one block needs for (n_fft, hop) and a plan of length F
// (the product of its radices); the wrapper refuses shapes above the card's
// per-block limit before launching.
long long sept_mel_db_smem_bytes(int n_fft, int hop, int F) {
  return (long long)MelConfig(n_fft, hop, F).lay.total;
}

// wave (B, L) f32; window (n_fft,) f32; twiddles (n_tw,) complex float64:
// each pass's p x (R-1) table in the plan's order, then, for an even n_fft,
// exp(-2 pi i k / n_fft) for k = 0..n_fft/4, then for Bluestein the chirp
// (M values) and the filter's spectrum (F values); bank_idx (3, n_mels)
// int32 (first bin, bin count, offset into bank_w); radices (n_stages,) on
// the host, each 2-5, whose product F is M = n_fft / 2 (even n_fft) or
// n_fft (odd), or, for Bluestein, at least 2M - 1; out (B, T, n_mels) f32.
int sept_mel_db(const float* wave, const float* window, const double* twiddles,
                const int* bank_idx, const float* bank_w, float* out, int B, int L, int T,
                int n_fft, int hop, int n_mels, int n_tw, const int* radices, int n_stages,
                void* stream) {
  if (n_mels < 1 || hop < 1 || n_fft < 2 || n_stages < 0 ||
      n_stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  FftPlan plan;
  plan.n_stages = n_stages;
  long long prod = 1, n_tables = 0;
  for (int s = 0; s < n_stages; ++s) {
    const int r = radices[s];
    if (r < 2 || r > 5) return (int)cudaErrorInvalidValue;
    plan.radix[s] = r;
    n_tables += prod * (r - 1);
    prod *= r;
  }
  const long long M = fft_len(n_fft);
  if (prod != M && (prod < 2 * M - 1 || prod > 4 * M)) return (int)cudaErrorInvalidValue;
  plan.len = (int)prod;
  plan.n_tables = (int)n_tables;
  const long long n_all = n_tables + (n_fft % 2 ? 0 : n_fft / 4 + 1) + (prod != M ? M + prod : 0);
  if (n_tw != n_all) return (int)cudaErrorInvalidValue;
  const MelConfig cfg(n_fft, hop, plan.len);
  if (cfg.lay.total > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      mel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cfg.lay.total);
  if (err != cudaSuccess) return (int)err;
  const int n_ttiles = (T + cfg.tf - 1) / cfg.tf;
  const long long blocks = (long long)n_ttiles * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  mel_fft_kernel<<<(unsigned)blocks, 32 * cfg.wp, cfg.lay.total, (cudaStream_t)stream>>>(
      wave, window, reinterpret_cast<const double2*>(twiddles), bank_idx, bank_w, out, L, T,
      n_fft, hop, n_mels, cfg.tf, cfg.wp, n_ttiles, plan);
  return (int)cudaGetLastError();
}

// The bf16 mode's table geometry: {frequencies a chunk, taps a slab, mel
// columns a pass, mel columns a sub-tile, the last chunk's frequency
// multiple}; the wrapper lays the cos/sin table, the filterbank and the
// sub-tile masks out with it.
void sept_mel_bf16_geometry(int* out5) {
  out5[0] = bfk::NC;
  out5[1] = bfk::KS;
  out5[2] = bfk::MEL_TILE;
  out5[3] = bfk::MEL_SUB;
  out5[4] = bfk::FREQ_ALIGN;
}

long long sept_mel_bf16_smem_bytes(int n_fft) { return (long long)bfk::Layout(n_fft).total; }

// wave (B, L) f32; window (n_fft,) bf16; table: per chunk of NC frequencies
// (the last cut to a multiple of FREQ_ALIGN) and slab of KS taps, a
// swizzled tile of 2 x (its frequencies) rows (cos, sin interleaved) x KS
// taps, bf16; bank: per pass of MEL_TILE mels and chunk, a swizzled tile of
// MEL_TILE rows x KS frequencies (in the mel product's order), bf16; masks
// (passes, chunks) uint8: bit s set where mel sub-tile s is nonzero; out
// (B, T, n_mels) f32.
int sept_mel_db_bf16(const float* wave, const void* window, const void* table, const void* bank,
                     const void* masks, float* out, int B, int L, int T, int n_fft, int hop,
                     int n_mels, void* stream) {
  if (n_mels < 1 || hop < 1 || n_fft < 2) return (int)cudaErrorInvalidValue;
  const int n_freq = n_fft / 2 + 1;
  const int n_chunks = (n_freq + bfk::NC - 1) / bfk::NC;
  const int tail = n_freq - bfk::NC * (n_chunks - 1);
  const int tail_cols = 2 * ((tail + bfk::FREQ_ALIGN - 1) / bfk::FREQ_ALIGN * bfk::FREQ_ALIGN);
  const bfk::Layout lay(n_fft);
  if (lay.total > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      bfk::mel_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  if ((reinterpret_cast<uintptr_t>(window) | reinterpret_cast<uintptr_t>(table) |
       reinterpret_cast<uintptr_t>(bank)) & 15)
    return (int)cudaErrorMisalignedAddress;
  const int n_ttiles = (T + bfk::TF - 1) / bfk::TF;
  const long long blocks = (long long)n_ttiles * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // persistent: a block an SM, at most one a frame tile
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long grid = std::min<long long>(blocks, std::max(1, sms));
  const bool vec = L % 4 == 0 && hop % 4 == 0 && (reinterpret_cast<uintptr_t>(wave) & 15) == 0;
  bfk::mel_bf16_kernel<<<(unsigned)grid, bfk::THREADS_B, lay.total, (cudaStream_t)stream>>>(
      wave, static_cast<const __nv_bfloat16*>(window), static_cast<const __nv_bfloat16*>(table),
      static_cast<const __nv_bfloat16*>(bank), static_cast<const unsigned char*>(masks), out, L,
      T, n_fft, hop, n_mels, n_chunks, tail_cols, n_ttiles, (int)blocks, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
