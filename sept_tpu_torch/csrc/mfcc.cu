// top_db floor + DCT-II of the MFCC, for Hopper (sm_90a).
//
// Replaces: sept_tpu/ops/pallas_frontend.py::_floor_dct_kernel, launched
// there by pallas_mfcc.  Computes, for each row r of un-floored mel dB
// (a frame of one utterance),
//
//     out[r, c] = sum_m max(mel[r, m], floor[r]) * dct[m, c]
//
// in f32 FMAs (the TPU kernel ran its product at Precision.HIGHEST; no TF32
// here either).
//
// What bounds it on the H100: bytes.  A row reads 128 floats and its floor
// and writes 40 (676 bytes); the product is 2 * 128 * 40 = 10 kflop a row,
// ~15 flop a byte moved, under the ~20 flop a byte (67 TFLOP/s f32 over
// 3.35 TB/s) at which the CUDA cores would become the limit.
//
// Design: one block takes ROWS = 64 consecutive rows.  The DCT basis (128
// x 40 f32, 20 KB) and the floored row tile (row stride n_mels + 1, so the
// rows a warp reads fall in distinct banks) sit in shared memory; the tile is
// read from device memory in 16-byte loads, consecutive threads on
// consecutive addresses, and floored on the way in.  Each thread keeps RPT = 4 rows x up to CPT = 8
// coefficients (c = lane % 8 + 8 j) in registers over the mel sum, which
// runs in ascending order: 4 + 5 shared loads a mel step for 20 FMAs at
// 40 coefficients (a first version with one row a thread loaded 11 for 10
// and ran slower than cuBLAS).  The block's outputs go through shared memory
// (the tile's space) so that the writes, too, are one contiguous run.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;              // rows per block
constexpr int THREADS = 128;
constexpr int RPT = 4;                // rows a thread
constexpr int CG = 8;                 // coefficient groups: c = cg + CG * j
constexpr int CPT = 8;                // coefficients a thread at most
constexpr int MAX_MFCC = CG * CPT;
static_assert(THREADS / CG * RPT == ROWS, "one row group per thread group");

size_t smem_bytes(int n_mels, int n_mfcc) {
  const size_t tile = (size_t)ROWS * (n_mels + 1), outs = (size_t)ROWS * n_mfcc;
  return sizeof(float) * ((size_t)n_mels * n_mfcc + (tile > outs ? tile : outs) + ROWS);
}

__global__ void __launch_bounds__(THREADS)
floor_dct_kernel(const float* __restrict__ mel,    // (rows, n_mels)
                 const float* __restrict__ floor,  // (rows,)
                 const float* __restrict__ dct,    // (n_mels, n_mfcc)
                 float* __restrict__ out,          // (rows, n_mfcc)
                 int rows, int n_mels, int n_mfcc) {
  extern __shared__ float smem[];
  float* d = smem;                             // n_mels x n_mfcc
  float* m = d + n_mels * n_mfcc;              // ROWS x (n_mels + 1), floored
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * ROWS;
  const int nr = (int)min((long long)ROWS, (long long)rows - r0);
  const int ms = n_mels + 1;

  float* fl = m + ROWS * ms;                   // ROWS floors
  for (int i = tid; i < n_mels * n_mfcc; i += THREADS) d[i] = dct[i];
  for (int i = tid; i < nr; i += THREADS) fl[i] = floor[r0 + i];
  __syncthreads();
  const float* src = mel + r0 * n_mels;
  if (n_mels % 4 == 0 && (reinterpret_cast<size_t>(mel) & 15) == 0) {  // 16-byte loads
    const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll 4
    for (int i = tid; i < nr * n_mels / 4; i += THREADS) {
      const float4 v = __ldg(src4 + i);
      const int r = 4 * i / n_mels, k = 4 * i - r * n_mels;
      const float f = fl[r];
      float* t = m + r * ms + k;
      t[0] = fmaxf(v.x, f);
      t[1] = fmaxf(v.y, f);
      t[2] = fmaxf(v.z, f);
      t[3] = fmaxf(v.w, f);
    }
  } else {
    for (int i = tid; i < nr * n_mels; i += THREADS) {
      const int r = i / n_mels, k = i - r * n_mels;
      m[r * ms + k] = fmaxf(__ldg(src + i), fl[r]);
    }
  }
  __syncthreads();

  const int rg = tid / CG, cg = tid % CG;
  const float* mr = m + rg * RPT * ms;
  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < n_mels; ++k) {
    float v[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) v[i] = mr[i * ms + k];  // rows past nr: unused
    const float* dk = d + k * n_mfcc;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cg + CG * j;
      if (c < n_mfcc) {
        const float w = dk[c];
#pragma unroll
        for (int i = 0; i < RPT; ++i) acc[i][j] = fmaf(v[i], w, acc[i][j]);
      }
    }
  }
  __syncthreads();  // the tile's space takes the outputs
  float* o = m;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg * RPT + i;
    if (r >= nr) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = cg + CG * j;
      if (c < n_mfcc) o[r * n_mfcc + c] = acc[i][j];
    }
  }
  __syncthreads();
  float* dst = out + r0 * n_mfcc;
  for (int i = tid; i < nr * n_mfcc; i += THREADS) dst[i] = o[i];
}

}  // namespace

extern "C" {

const char* sept_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Most coefficients a row the kernel takes; the wrapper refuses more.
int sept_floor_dct_max_mfcc() { return MAX_MFCC; }

// Shared memory one block needs; the wrapper refuses shapes above the card's
// per-block limit before launching.
long long sept_floor_dct_smem_bytes(int n_mels, int n_mfcc) {
  return (long long)smem_bytes(n_mels, n_mfcc);
}

int sept_floor_dct(const float* mel, const float* floor, const float* dct, float* out,
                   int rows, int n_mels, int n_mfcc, void* stream) {
  if (n_mfcc < 1 || n_mfcc > MAX_MFCC || n_mels < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_mels, n_mfcc);
  cudaError_t err = cudaFuncSetAttribute(
      floor_dct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = ((long long)rows + ROWS - 1) / ROWS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  floor_dct_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      mel, floor, dct, out, rows, n_mels, n_mfcc);
  return (int)cudaGetLastError();
}

}  // extern "C"
