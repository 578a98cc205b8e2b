// Fused log-mel spectrogram of the serving frontend, for Hopper (sm_90a).
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

}  // extern "C"
