// Fused log-mel spectrogram of the frontend, for Hopper (sm_90a), in two
// modes: f32 (this part) and bf16 (mel_bf16_kernel, further down).
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

namespace {

constexpr int WARPS = 8;              // most warps a block, one frame each at a time
constexpr int MEL_MAX = 256;          // widest mel bank taken
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
// function as f32 FMAs on the rounded operands, up to summation order.
//
// What bounds it on the H100: the least work (waves in, dB out, an rFFT) is a
// few hundredths of a millisecond at the ingest's 257k frames; the dense DFT
// + mel products this design does are ~1.4 MFLOP a frame at n_fft 800, which
// the bf16 tensor cores (989 TFLOP/s) could run in ~0.36 ms.  The design
// spends those operations on the tensor cores instead of the f32 design's
// CUDA cores (~5 ms at the f32 peak for the same products).
//
// Design (warp-level mma.sync m16n8k16 bf16 -> f32, written by hand):
// - One block takes TFB = 64 frames of one row.  The raw samples of those
//   frames are staged once in shared memory, rounded to bf16, beside the
//   bf16 window; no im2col array exists.
// - The frequencies go in chunks of FC = 64.  For each chunk the block runs
//   the DFT product over the taps in KCB = 32-tap steps: the windowed frame
//   tile (64 x 32, each element one rounded bf16 multiply) and the chunk's
//   cos and sin rows (128 x 32, from a table laid out [chunk][cos|sin row]
//   [tap], zero-padded) are staged in shared memory; 8 warps, 4 along the
//   frames x 2 along the frequencies, each own 16 frames x 32 frequencies
//   of the real and the imaginary sum (8 MMAs a 16-tap step).
// - The chunk's power is rounded to bf16 into a 64 x 64 tile; the mel
//   product over the chunk's 64 frequencies follows at once (fb chunk
//   128 mels x 64 frequencies, staged), each warp owning 16 frames x 64 mels
//   of the mel sums in registers across all chunks.  So the power never
//   leaves shared memory, and one kernel writes 10*log10(max(., 1e-10)).
// - Row strides of 40 and 72 bf16 (20 and 36 words) make every fragment load
//   hit 32 distinct banks.  Taps pad with zeros to a multiple of 32 (n_fft
//   400 -> 416), frequencies to a multiple of 64 and mels to 128.
// - The k-step tiles are double-buffered: while step s multiplies, cp.async
//   brings step s + 1's cos/sin rows (and, once a chunk, its filterbank
//   rows) and the threads build its windowed frame tile; one barrier a step.
// - Measured (PERF.md): without the double buffers (two barriers a step,
//   the table rows loaded synchronously) the kernel took 3.84 ms at the
//   ingest's 257k frames.  Not yet: TMA, wgmma.

namespace bfk {

constexpr int TFB = 64;        // frames per block
constexpr int FC = 64;         // frequencies per chunk
constexpr int KCB = 32;        // taps per k-step
constexpr int MELS = 128;      // mel columns (zero-padded)
constexpr int THREADS_B = 256;  // 8 warps
constexpr int AS = KCB + 8;    // bf16 row stride of the k-step tiles
constexpr int PS = FC + 8;     // bf16 row stride of the power tile and fb chunk

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// shared memory, in bytes: the bf16 segment and window, two buffers each of
// the k-step tiles, the power tile and the filterbank chunk
struct Layout {
  size_t seg, win, a, b, p, f, total;
  __host__ __device__ Layout(int n_fft, int hop) {
    const size_t seg_len = (size_t)(TFB - 1) * hop + n_fft;
    seg = 0;
    win = align16(seg + seg_len * 2);
    a = align16(win + (size_t)n_fft * 2);
    b = align16(a + (size_t)2 * TFB * AS * 2);
    p = align16(b + (size_t)2 * 2 * FC * AS * 2);
    f = align16(p + (size_t)TFB * PS * 2);
    total = align16(f + (size_t)MELS * PS * 2);
  }
};

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float* d, unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 16-byte copy from device memory to shared memory, asynchronous
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS_B)
mel_bf16_kernel(const float* __restrict__ wave,             // (B, L)
                const __nv_bfloat16* __restrict__ window,   // (n_fft,)
                const __nv_bfloat16* __restrict__ dft,      // (n_chunks, 2*FC, k_pad)
                const __nv_bfloat16* __restrict__ fbt,      // (n_chunks, MELS, FC)
                float* __restrict__ out,                    // (B, T, n_mels)
                int L, int T, int n_fft, int hop, int n_mels, int n_chunks, int k_pad,
                int n_ttiles) {
  extern __shared__ float4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const Layout lay(n_fft, hop);
  __nv_bfloat16* seg = reinterpret_cast<__nv_bfloat16*>(smem + lay.seg);
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem + lay.win);
  __nv_bfloat16* a_t = reinterpret_cast<__nv_bfloat16*>(smem + lay.a);
  __nv_bfloat16* b_t = reinterpret_cast<__nv_bfloat16*>(smem + lay.b);
  __nv_bfloat16* p_t = reinterpret_cast<__nv_bfloat16*>(smem + lay.p);
  __nv_bfloat16* f_t = reinterpret_cast<__nv_bfloat16*>(smem + lay.f);

  const int tid = threadIdx.x;
  const int tt = blockIdx.x % n_ttiles;
  const int b = blockIdx.x / n_ttiles;
  const int t0 = tt * TFB;
  const int seg_len = (TFB - 1) * hop + n_fft;
  const long long base = (long long)b * L + (long long)t0 * hop;
  const long long avail = (long long)L - (long long)t0 * hop;
  // rounding points 1 and 2: the waveform and the window
  for (int i = tid; i < seg_len; i += THREADS_B)
    seg[i] = __float2bfloat16_rn(i < avail ? wave[base + i] : 0.f);
  for (int i = tid; i < n_fft; i += THREADS_B) win[i] = window[i];
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, q = lane & 3;
  const int arow = 16 * wm + g;
  const int n_steps = k_pad / KCB;

  float mel[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) mel[j][0] = mel[j][1] = mel[j][2] = mel[j][3] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    float re[4][4], im[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) re[j][e] = im[j][e] = 0.f;

    const __nv_bfloat16* dft_c = dft + (size_t)c * 2 * FC * k_pad;
    // one k-step's tiles into buffer buf: the chunk's cos (rows 0..FC-1)
    // and sin (FC..2FC-1) rows by cp.async, and the windowed frames --
    // rounding point 3, one bf16 multiply -- two taps a thread
    auto stage = [&](int k0, int buf) {
      __nv_bfloat16* bb = b_t + buf * 2 * FC * AS;
      for (int i = tid; i < 2 * FC * (KCB / 8); i += THREADS_B) {
        const int r = i / (KCB / 8), v = i % (KCB / 8);
        cp_async16(bb + r * AS + v * 8, dft_c + (size_t)r * k_pad + k0 + v * 8);
      }
      cp_async_commit();
      __nv_bfloat16* a = a_t + buf * TFB * AS;
      for (int i = tid; i < TFB * KCB / 2; i += THREADS_B) {
        const int t = i / (KCB / 2), kk = 2 * (i % (KCB / 2)), k = k0 + kk;
        const float v0 = k < n_fft
            ? __fmul_rn(__bfloat162float(seg[t * hop + k]), __bfloat162float(win[k])) : 0.f;
        const float v1 = k + 1 < n_fft
            ? __fmul_rn(__bfloat162float(seg[t * hop + k + 1]), __bfloat162float(win[k + 1]))
            : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(a + t * AS + kk) = __floats2bfloat162_rn(v0, v1);
      }
    };
    // software pipeline: step s + 1's tiles load while step s multiplies
    stage(0, 0);
    cp_async_wait_all();
    __syncthreads();
    // every warp is past the previous chunk's mel stage: its fb chunk goes
    const __nv_bfloat16* fb_c = fbt + (size_t)c * MELS * FC;
    for (int i = tid; i < MELS * (FC / 8); i += THREADS_B) {
      const int m = i / (FC / 8), v = i % (FC / 8);
      cp_async16(f_t + m * PS + v * 8, fb_c + (size_t)m * FC + v * 8);
    }
    cp_async_commit();
    for (int s = 0; s < n_steps; ++s) {
      if (s + 1 < n_steps) stage((s + 1) * KCB, (s + 1) & 1);
      const __nv_bfloat16* a_s = a_t + (s & 1) * TFB * AS;
      const __nv_bfloat16* b_s = b_t + (s & 1) * 2 * FC * AS;
#pragma unroll
      for (int ks = 0; ks < KCB / 16; ++ks) {
        const __nv_bfloat16* ap = a_s + arow * AS + ks * 16 + 2 * q;
        const unsigned a0 = ld32(ap), a1 = ld32(ap + 8 * AS), a2 = ld32(ap + 8),
                       a3 = ld32(ap + 8 * AS + 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat16* bc = b_s + (32 * wn + 8 * j + g) * AS + ks * 16 + 2 * q;
          const __nv_bfloat16* bs = bc + FC * AS;
          mma16816(re[j], a0, a1, a2, a3, ld32(bc), ld32(bc + 8));
          mma16816(im[j], a0, a1, a2, a3, ld32(bs), ld32(bs + 8));
        }
      }
      cp_async_wait_all();
      __syncthreads();
    }

    // rounding point 5: the power, in f32 (no FMA), then to bf16
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float p0 = __fadd_rn(__fmul_rn(re[j][2 * h], re[j][2 * h]),
                                   __fmul_rn(im[j][2 * h], im[j][2 * h]));
        const float p1 = __fadd_rn(__fmul_rn(re[j][2 * h + 1], re[j][2 * h + 1]),
                                   __fmul_rn(im[j][2 * h + 1], im[j][2 * h + 1]));
        *reinterpret_cast<__nv_bfloat162*>(p_t + (arow + 8 * h) * PS + 32 * wn + 8 * j + 2 * q) =
            __floats2bfloat162_rn(p0, p1);
      }
    __syncthreads();  // the power tile is whole (the fb chunk landed in the k loop)
    // the chunk's share of the mel product: warp (wm, wn) owns 16 frames x 64 mels
#pragma unroll
    for (int ks = 0; ks < FC / 16; ++ks) {
      const __nv_bfloat16* ap = p_t + arow * PS + ks * 16 + 2 * q;
      const unsigned a0 = ld32(ap), a1 = ld32(ap + 8 * PS), a2 = ld32(ap + 8),
                     a3 = ld32(ap + 8 * PS + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* bp = f_t + (64 * wn + 8 * j + g) * PS + ks * 16 + 2 * q;
        mma16816(mel[j], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
      }
    }
    // the next chunk writes a_t / b_t buffer 0 first, and f_t and p_t only
    // after a barrier of its k loop, so no barrier is needed here
  }

#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + arow + 8 * h;
      if (t >= T) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 64 * wn + 8 * j + 2 * q + e;
        if (m < n_mels)
          out[((long long)b * T + t) * n_mels + m] = 10.f * log10f(fmaxf(mel[j][2 * h + e], 1e-10f));
      }
    }
}

}  // namespace bfk

}  // namespace

extern "C" {

const char* sept_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Widest mel bank the kernel takes; the wrapper refuses wider ones.
int sept_mel_db_max_mels() { return MEL_MAX; }

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
  if (n_mels > MEL_MAX || n_mels < 1 || hop < 1 || n_fft < 2 || n_stages < 0 ||
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

// The bf16 mode's table geometry: {frequencies a chunk, taps a k-step, mel
// columns}; the wrapper lays the cos/sin and filterbank tables out with it.
void sept_mel_bf16_geometry(int* out3) {
  out3[0] = bfk::FC;
  out3[1] = bfk::KCB;
  out3[2] = bfk::MELS;
}

long long sept_mel_bf16_smem_bytes(int n_fft, int hop) {
  return (long long)bfk::Layout(n_fft, hop).total;
}

// wave (B, L) f32; window (n_fft,) bf16; dft (n_chunks, 2*FC, k_pad) bf16;
// fbt (n_chunks, MELS, FC) bf16; out (B, T, n_mels) f32.
int sept_mel_db_bf16(const float* wave, const void* window, const void* dft, const void* fbt,
                     float* out, int B, int L, int T, int n_fft, int hop, int n_mels,
                     void* stream) {
  const int n_freq = n_fft / 2 + 1;
  const int n_chunks = (n_freq + bfk::FC - 1) / bfk::FC;
  const int k_pad = (n_fft + bfk::KCB - 1) / bfk::KCB * bfk::KCB;
  if (n_mels > bfk::MELS || n_mels < 1 || hop < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = bfk::Layout(n_fft, hop).total;
  cudaError_t err = cudaFuncSetAttribute(
      bfk::mel_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ttiles = (T + bfk::TFB - 1) / bfk::TFB;
  const long long blocks = (long long)n_ttiles * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  bfk::mel_bf16_kernel<<<(unsigned)blocks, bfk::THREADS_B, smem, (cudaStream_t)stream>>>(
      wave, static_cast<const __nv_bfloat16*>(window), static_cast<const __nv_bfloat16*>(dft),
      static_cast<const __nv_bfloat16*>(fbt), out, L, T, n_fft, hop, n_mels, n_chunks, k_pad,
      n_ttiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
