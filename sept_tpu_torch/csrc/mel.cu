// Fused log-mel spectrogram of the frontend, for Hopper (sm_90a), in two
// modes: f32 (this part) and bf16 (mel_bf16_kernel, further down).
//
// Replaces: sept_tpu/ops/pallas_frontend.py::_mel_kernel (f32 mode), launched
// there by pallas_mel_spectrogram.  Computes, for each frame t of each
// reflect-padded waveform b,
//
//     out[b, t, m] = 10 * log10(max(sum_f P[t, f] * fb[f, m], 1e-10))
//     P[t, f]      = (sum_n x[t, n] cos[n, f])^2 + (sum_n x[t, n] sin[n, f])^2
//     x[t, n]      = wave[b, t * hop + n] * hann[n]
//
// What bounds it on the H100: the function itself is cheap.  A real FFT of
// 800 taps takes ~2.5 * 800 * log2(800) ~ 19k flops a frame and the sparse
// mel bank ~1.4k, so at the serving shapes the least time is set about
// equally by those operations and by the bytes (the waveform read once, 128
// floats a frame written).  This design computes the DFT as a dense product,
// 2 * 800 * 401 multiply-adds a frame (~65x the FFT's operations), all in f32
// on the CUDA cores, so its own operation count, not the card, sets its
// time; an FFT-structured kernel is later work (ROADMAP.md).
//
// Design:
// - Framing happens inside the kernel.  The TPU kernel took pre-cut
//   (frames, 800) rows only because Mosaic could not lower a hop-160 overlap;
//   here one block stages the raw samples of TF consecutive frames
//   ((TF-1)*hop + n_fft floats) in shared memory once and reads every frame
//   from there, so the 5x larger im2col array never exists.
// - The real DFT is a tiled f32 product (TF frames x n_fft) @ (n_fft x FT
//   frequencies): the cos/sin tables stream through shared memory in KC-tap
//   chunks (they stay L2-resident across blocks), the windowed frame chunk is
//   staged beside them as [tap][frame], and each thread keeps FPT = 8 frames
//   x 2 frequencies of the real and the imaginary sum in registers, so one
//   k-step costs 4 shared loads (two float4, two float2) for 32 FMAs.
// - One block takes TF = 32 frames of one row and FT = 128 frequencies, so a
//   row of 600 frames spreads over 19 x 4 blocks: a single utterance fills
//   most of the SMs, and a batch of 8 gives 600 blocks for 132 SMs instead of
//   150.  The block's power tile stays in shared memory and its share of the
//   mel product (frequencies in ascending order) goes to a scratch buffer of
//   partial sums; a second, elementwise kernel adds the 4 partials in order
//   and takes 10*log10(max(., 1e-10)).  The bank is dense (its sparse
//   triangles would save ~8% of the work).
// - f32 FMA throughout, no tensor cores: TF32 would break the f32 parity the
//   serving path holds.
// - Measured (PERF.md): earlier versions with one block per 32 frames and all
//   401 frequencies left most SMs idle at one utterance and ran two blocks in
//   turn on some SMs at 8; streaming the tables with cp.async double-buffering
//   gave no gain.  3xTF32 wgmma and TMA-fed tables are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TF = 32;           // frames per block
constexpr int FPT = 8;           // frames per thread in the DFT stage
constexpr int LANES = 64;        // frequency lanes, 2 adjacent frequencies each
constexpr int FT = 2 * LANES;    // frequencies per block
constexpr int KC = 32;           // taps per streamed table chunk
constexpr int THREADS = LANES * (TF / FPT);  // 256: 4 frame groups x 64 lanes
constexpr int AST = TF + 4;      // row stride of the staged frame chunk (float4-aligned)
constexpr int MEL_LANES = 128;   // mel columns per pass
constexpr int MEL_ROWS = TF / (THREADS / MEL_LANES);  // frames per thread, mel stage
constexpr int MEL_PASSES = 2;    // n_mels <= MEL_PASSES * MEL_LANES

int freq_tiles(int n_freq) { return (n_freq + FT - 1) / FT; }

// One block: TF frames of one row x FT frequencies.  Writes that frequency
// tile's share of the mel product, pre-log, to partial[ft, b, t, m].
__global__ void __launch_bounds__(THREADS)
mel_partial_kernel(const float* __restrict__ wave,    // (B, L)
                   const float* __restrict__ window,  // (n_fft,)
                   const float* __restrict__ cos_t,   // (n_fft, n_freq)
                   const float* __restrict__ sin_t,   // (n_fft, n_freq)
                   const float* __restrict__ fb,      // (n_freq, n_mels)
                   float* __restrict__ partial,       // (n_ftiles, B, T, n_mels)
                   int B, int L, int T, int n_fft, int hop, int n_freq, int n_mels,
                   int n_ttiles, int n_ftiles) {
  extern __shared__ float4 smem4[];
  float* a_chunk = reinterpret_cast<float*>(smem4);  // KC x AST windowed samples, [tap][frame]
  float* c_chunk = a_chunk + KC * AST;               // KC x FT
  float* s_chunk = c_chunk + KC * FT;                // KC x FT
  float* win = s_chunk + KC * FT;                    // n_fft
  float* power = win + n_fft;                        // TF x FT
  float* seg = power + TF * FT;                      // (TF-1)*hop + n_fft raw samples

  // one flat grid over (row, frame tile, frequency tile), frequency fastest
  // so the blocks sharing a row segment run together
  const int tid = threadIdx.x;
  const int ft = blockIdx.x % n_ftiles;
  const int tt = blockIdx.x / n_ftiles % n_ttiles;
  const int b = blockIdx.x / n_ftiles / n_ttiles;
  const int t0 = tt * TF, f0 = ft * FT;
  const int seg_len = (TF - 1) * hop + n_fft;
  const long long base = (long long)b * L + (long long)t0 * hop;
  const long long avail = (long long)L - (long long)t0 * hop;
  for (int i = tid; i < seg_len; i += THREADS)
    seg[i] = i < avail ? wave[base + i] : 0.f;
  for (int i = tid; i < n_fft; i += THREADS) win[i] = window[i];
  __syncthreads();

  const int fl = tid % LANES;  // frequencies f0 + 2*fl, f0 + 2*fl + 1
  const int fg = tid / LANES;  // frames fg*FPT .. fg*FPT + FPT-1 (one group per warp)
  // a warp whose 64 frequencies all lie past n_freq only stages
  const bool active = f0 + 2 * (fl & ~31) < n_freq;
  float re[FPT][2], im[FPT][2];
#pragma unroll
  for (int i = 0; i < FPT; ++i) {
    re[i][0] = re[i][1] = 0.f;
    im[i][0] = im[i][1] = 0.f;
  }
  for (int k0 = 0; k0 < n_fft; k0 += KC) {
    for (int i = tid; i < TF * KC; i += THREADS) {
      const int t = i / KC, kk = i % KC, k = k0 + kk;
      a_chunk[kk * AST + t] = k < n_fft ? seg[t * hop + k] * win[k] : 0.f;
    }
    for (int i = tid; i < KC * FT; i += THREADS) {
      const int k = k0 + i / FT, f = f0 + i % FT;
      const bool ok = k < n_fft && f < n_freq;
      const long long off = (long long)k * n_freq + f;
      c_chunk[i] = ok ? __ldg(cos_t + off) : 0.f;
      s_chunk[i] = ok ? __ldg(sin_t + off) : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int kk = 0; kk < KC; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(a_chunk + kk * AST + fg * FPT);
        const float4 a1 = *reinterpret_cast<const float4*>(a_chunk + kk * AST + fg * FPT + 4);
        const float2 cv = *reinterpret_cast<const float2*>(c_chunk + kk * FT + 2 * fl);
        const float2 sv = *reinterpret_cast<const float2*>(s_chunk + kk * FT + 2 * fl);
        const float a[FPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int i = 0; i < FPT; ++i) {
          re[i][0] = fmaf(a[i], cv.x, re[i][0]);
          re[i][1] = fmaf(a[i], cv.y, re[i][1]);
          im[i][0] = fmaf(a[i], sv.x, im[i][0]);
          im[i][1] = fmaf(a[i], sv.y, im[i][1]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < FPT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      power[(fg * FPT + i) * FT + 2 * fl + j] =
          __fadd_rn(__fmul_rn(re[i][j], re[i][j]), __fmul_rn(im[i][j], im[i][j]));
  __syncthreads();

  // this tile's share of the mel product, frequencies in ascending order
  const int nf = min(FT, n_freq - f0);
  const int ml = tid % MEL_LANES;               // mel column
  const int mr = (tid / MEL_LANES) * MEL_ROWS;  // first frame of this thread
#pragma unroll
  for (int p = 0; p < MEL_PASSES; ++p) {
    const int m = ml + p * MEL_LANES;
    if (m >= n_mels) continue;
    float acc[MEL_ROWS];
#pragma unroll
    for (int i = 0; i < MEL_ROWS; ++i) acc[i] = 0.f;
    for (int f = 0; f < nf; ++f) {
      const float w = __ldg(fb + (long long)(f0 + f) * n_mels + m);
#pragma unroll
      for (int i = 0; i < MEL_ROWS; ++i) acc[i] = fmaf(power[(mr + i) * FT + f], w, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < MEL_ROWS; ++i) {
      const int t = t0 + mr + i;
      if (t < T) partial[(((long long)ft * B + b) * T + t) * n_mels + m] = acc[i];
    }
  }
}

// out = 10 * log10(max(sum over frequency tiles of partial, 1e-10)), the tiles
// added in ascending order.
__global__ void __launch_bounds__(THREADS)
mel_log_kernel(const float* __restrict__ partial, float* __restrict__ out,
               long long total, int n_ftiles) {
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (long long)gridDim.x * THREADS) {
    float s = partial[i];
    for (int j = 1; j < n_ftiles; ++j) s += partial[j * total + i];
    out[i] = 10.f * log10f(fmaxf(s, 1e-10f));
  }
}

size_t smem_bytes(int n_fft, int hop) {
  const size_t floats = KC * AST + 2 * KC * FT            // staged chunks
                        + n_fft                           // window
                        + TF * FT                         // power of the tile
                        + (size_t)(TF - 1) * hop + n_fft;  // seg
  return floats * sizeof(float);
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
int sept_mel_db_max_mels() { return MEL_PASSES * MEL_LANES; }

// Shared memory one block needs; the wrapper refuses shapes above the card's
// per-block limit before launching.
long long sept_mel_db_smem_bytes(int n_fft, int hop) {
  return (long long)smem_bytes(n_fft, hop);
}

// Floats of scratch sept_mel_db needs for the per-frequency-tile partial sums.
long long sept_mel_db_scratch_floats(int B, int T, int n_freq, int n_mels) {
  return (long long)freq_tiles(n_freq) * B * T * n_mels;
}

int sept_mel_db(const float* wave, const float* window, const float* cos_t,
                const float* sin_t, const float* fb, float* out, float* scratch, int B,
                int L, int T, int n_fft, int hop, int n_freq, int n_mels, void* stream) {
  if (n_mels > MEL_PASSES * MEL_LANES || n_freq != n_fft / 2 + 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_fft, hop);
  cudaError_t err = cudaFuncSetAttribute(
      mel_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ttiles = (T + TF - 1) / TF, n_ftiles = freq_tiles(n_freq);
  const long long blocks = (long long)n_ttiles * n_ftiles * B;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  mel_partial_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      wave, window, cos_t, sin_t, fb, scratch, B, L, T, n_fft, hop, n_freq, n_mels,
      n_ttiles, n_ftiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)B * T * n_mels;
  const long long log_blocks = (total + THREADS - 1) / THREADS;
  mel_log_kernel<<<(int)(log_blocks < (1LL << 20) ? log_blocks : (1LL << 20)), THREADS, 0,
                   (cudaStream_t)stream>>>(scratch, out, total, n_ftiles);
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
