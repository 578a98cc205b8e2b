// top_db floor + DCT-II of the MFCC, for Hopper (sm_90a).
//
// Replaces: sept_tpu/ops/pallas_frontend.py::_floor_dct_kernel, launched
// there by pallas_mfcc.  Computes, for each row r of un-floored mel dB
// (a frame of one utterance),
//
//     out[r, c] = sum_m max(mel[r, m], floor[r]) * dct[m, c]
//
// in f32 FMAs (the TPU kernel ran its product at Precision.HIGHEST; no TF32
// here either), the sum over m in ascending order.  Any n_mels and n_mfcc.
//
// What bounds it on the H100: bytes.  A row reads 128 floats and its floor
// and writes 40 (676 bytes); the product is 2 * 128 * 40 = 10 kflop a row,
// ~15 flop a byte moved, under the ~20 flop a byte (67 TFLOP/s f32 over
// 3.35 TB/s) at which the CUDA cores would become the limit -- close enough
// that the products have to run at a good share of the f32 rate, beside the
// copies.  The first design (one block of 64 rows each, 963 blocks at
// 61,632 rows) copied the whole basis into every block, waited for it and
// for its row tile before any product, and read 9 shared words for every 20
// FMAs: 0.21 of its bound.
//
// Design:
// - Persistent blocks, two an SM where shared memory allows (one past 224
//   mels): a block keeps a tile of the basis -- up to CT = 40
//   coefficients (gridDim.y tiles the rest) over up to kr mels -- in
//   shared memory, laid out once by its consumer warps from dct (zeros
//   past n_mels and n_mfcc), and walks row tiles of TILE_ROWS = 256 rows:
//   blocks k, k + gridDim.x, ...  The producer issues the first chunk, then
//   waits for the basis before it issues more, so that the consumers' loads
//   of dct do not queue behind the whole ring's copies.
// - A producer warp streams each row tile through a ring of 2-3 stages in
//   chunks of KT = 32 mels: one 2-D bulk tensor copy (TMA) a stage,
//   128-byte swizzle, completion on the stage's mbarrier; zeros past the
//   last row and the last mel (the copy's out-of-bounds fill).  Where the
//   tensor copy cannot take the tensor (n_mels not a multiple of 4, or mel
//   not 16-byte aligned), the producer warp's lanes load the chunk and
//   store it in the same swizzled layout.  The next chunks arrive while this
//   one's products run.
// - Four consumer warps, 64 rows each.  Lane (rl, g) = (lane % 8, lane / 8)
//   takes rows rl + 8 i (i < 8) of its warp's 64 and coefficients 10 g ..
//   10 g + 9 of the block's tile: 80 accumulators over the mel sum.  A mel
//   row holds one 128-byte line of a chunk, its 16-byte word w at w ^ (row
//   % 8) (the swizzle), so the 8 rows a warp reads at once fall in distinct
//   banks.  A step of 4 mels reads 8 LDS.128 of mel, floored in registers
//   as they are read (a max for every 10 FMAs), and 4 x 3 LDS.128 of the
//   basis (a lane's 10 coefficients padded to 12, adjacent; the 4 groups of
//   a warp in distinct banks) for 320 FMAs: one shared word for every 4
//   FMAs (9 for 20 before).  (Flooring the chunk in place in shared memory
//   first ran 7% slower on the H100: floor_dct_variants.py.)
// - Output: after the tile's last chunk each warp writes 32 rows at a time
//   into its own rows of that stage, then stores them from there: 16-byte
//   stores of one contiguous run where the tile is the whole width, else
//   one coalesced float a lane; then the stage goes back to the producer.
// - n_mels past what fits beside the ring (832 mels with 2 stages) runs in
//   launches of kr mels, each continuing the sums from the output (f32,
//   exact): the same sums in the same order as one launch.

#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr int CONSUMERS = 4;                    // consumer warps
constexpr int THREADS = 32 * (CONSUMERS + 1);   // and a producer warp
constexpr int RPL = 8;                          // rows a lane: rl + 8 i
constexpr int WARP_ROWS = 8 * RPL;              // rows a consumer warp
constexpr int TILE_ROWS = CONSUMERS * WARP_ROWS;  // 256 rows a tile: one tensor copy
static_assert(TILE_ROWS <= 256, "a tensor copy's box takes at most 256 rows");
constexpr int KT = 32;                          // mels a chunk: a 128-byte line a row
constexpr int CPL = 10;                         // coefficients a lane
constexpr int CPAD = 12;                        // ... padded to three 16-byte words
constexpr int GROUPS = 4;                       // lane groups of a warp
constexpr int CT = GROUPS * CPL;                // coefficients a block
constexpr int BASIS_K = GROUPS * CPAD;          // basis floats a mel
constexpr int STAGE_BYTES = TILE_ROWS * KT * 4;   // 32 KB
constexpr int MAX_STAGES = 3;
constexpr int SMEM_LIMIT = 232448;              // shared memory a block may opt into
constexpr int SMEM_HALF = 115712;               // each of two blocks an SM (of 228 KB)
constexpr int FIXED = 1024 + 2 * MAX_STAGES * 8;  // alignment slack and the barriers
// rows of its output a warp stores at once, through its own rows of a stage
constexpr int OUT_ROWS = 32;
static_assert(OUT_ROWS * CT <= WARP_ROWS * KT, "a warp's output rows fit its rows of a stage");

// the tensor copy's 128-byte swizzle: a row of a chunk is one 128-byte
// line, its 16-byte word w stored at w ^ swz(row)
static_assert(KT * 4 == 128, "a chunk's row is one 128-byte line");
__host__ __device__ constexpr int swz(int row) { return row & 7; }

// shared memory, in bytes from a 1024-byte aligned base: the ring, the
// basis tile (kr mels), the barriers.  Two blocks an SM where two stages
// and the whole basis fit in half of it, else one; then 3 stages where the
// whole basis fits beside them, else 2 and the most mels a launch that fit
struct Layout {
  int stages, kr;
  size_t basis, bars, total;
  __host__ __device__ explicit Layout(int n_mels) {
    const int k_pad = (n_mels + KT - 1) / KT * KT;
    const size_t whole = (size_t)k_pad * BASIS_K * 4;
    const size_t limit = 2 * (size_t)STAGE_BYTES + whole + FIXED <= SMEM_HALF ? SMEM_HALF
                                                                              : SMEM_LIMIT;
    stages = MAX_STAGES;
    while (stages > 2 && (size_t)stages * STAGE_BYTES + whole + FIXED > limit) --stages;
    const int fit =
        (int)((limit - FIXED - (size_t)stages * STAGE_BYTES) / (BASIS_K * 4)) / KT * KT;
    kr = k_pad < fit ? k_pad : fit;
    basis = (size_t)stages * STAGE_BYTES;
    bars = basis + (size_t)kr * BASIS_K * 4;
    total = bars + 2 * MAX_STAGES * 8 + 1024;
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
// the box at (mel x, row y) of the tensor map into shared memory at dst
__device__ __forceinline__ void tensor_copy(unsigned dst, const CUtensorMap* map, int x, int y,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__global__ void __launch_bounds__(THREADS, 2)
floor_dct_kernel(const __grid_constant__ CUtensorMap map,  // mel, boxes of KT x TILE_ROWS
                 const float* __restrict__ mel,    // (rows, n_mels)
                 const float* __restrict__ floor,  // (rows,)
                 const float* __restrict__ dct,    // (n_mels, n_mfcc)
                 float* __restrict__ out,          // (rows, n_mfcc)
                 int rows, int n_mels, int n_mfcc, int k0, int n_tiles, bool tma,
                 bool vec_out) {
  extern __shared__ float4 smem4[];
  const Layout lay(n_mels);
  const unsigned raw = smem_u32(smem4);
  const unsigned base = (raw + 1023) & ~1023u;
  char* sm = reinterpret_cast<char*>(smem4) + (base - raw);
  const unsigned full = base + (unsigned)lay.bars, empty = full + 8 * MAX_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.y * CT;
  const int k_end = min(n_mels, k0 + lay.kr);   // this launch's mels: k0 .. k_end - 1
  const int n_chunks = (k_end - k0 + KT - 1) / KT;

  if (tid == 0) {
    for (int s = 0; s < lay.stages; ++s) {
      mbar_init(full + 8 * s, tma ? 1 : 32);     // the tensor copy's lane, or all 32 loading
      mbar_init(empty + 8 * s, CONSUMERS);       // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {
    // the producer: chunk q of tile t into stage s, in the consumers' order;
    // after the first chunk it waits for the basis tile, so that the
    // consumers' loads of dct do not queue behind the whole ring's copies
    int s = 0, ph = 0;
    bool first = true;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int r0 = tile * TILE_ROWS;
      for (int q = 0; q < n_chunks; ++q) {
        const int kc = k0 + q * KT;
        if (lane == 0) mbar_wait(empty + 8 * s, ph ^ 1);
        __syncwarp();
        const unsigned dst = base + (unsigned)s * STAGE_BYTES;
        if (tma) {
          if (lane == 0) {
            mbar_expect_tx(full + 8 * s, STAGE_BYTES);
            tensor_copy(dst, &map, kc, r0, full + 8 * s);
          }
        } else {
          float* st = reinterpret_cast<float*>(sm + (size_t)s * STAGE_BYTES);
          for (int e = lane; e < TILE_ROWS * KT / 4; e += 32) {
            const int r = e / (KT / 4), w = e % (KT / 4);
            const long long row = (long long)r0 + r;
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int k = kc + 4 * w + j;
              v[j] = row < rows && k < k_end ? __ldg(mel + row * n_mels + k) : 0.f;
            }
            *reinterpret_cast<float4*>(st + r * KT + ((w ^ swz(r)) << 2)) =
                make_float4(v[0], v[1], v[2], v[3]);
          }
          mbar_arrive(full + 8 * s);
        }
        if (first) {
          named_sync(1, THREADS);
          first = false;
        }
        if (++s == lay.stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: this lane's floors of its first tile (loads in flight
  // beside the basis tile's), then the basis tile once, basis[k][g][j] =
  // dct[k0 + k, c0 + CPL g + j], zeros past this launch's mels, past n_mfcc
  // and for j >= CPL: warp w takes mels w, w + CONSUMERS, ..., lane l the
  // columns l and l + 32 of a mel's BASIS_K, FILL mels in flight
  const int rl = lane & 7, g = lane >> 3;
  float fl[RPL];
  auto load_floors = [&](int tile) {
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const long long row = (long long)tile * TILE_ROWS + warp * WARP_ROWS + rl + 8 * i;
      fl[i] = tile < n_tiles && row < rows ? __ldg(floor + row) : 0.f;
    }
  };
  load_floors(blockIdx.x);
  float* basis = reinterpret_cast<float*>(sm + lay.basis);
  int src[2];  // a column's coefficient, or -1 for a zero
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int col = lane + 32 * h, j = col % CPAD, c = c0 + col / CPAD * CPL + j;
    src[h] = col < BASIS_K && j < CPL && c < n_mfcc ? c : -1;
  }
  constexpr int FILL = 16;
  const int nk = n_chunks * KT;
  for (int kb = warp; kb < nk; kb += FILL * CONSUMERS) {
    float v[FILL][2];
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int kk = k0 + kb + u * CONSUMERS;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        v[u][h] = kk < k_end && src[h] >= 0 ? __ldg(dct + (long long)kk * n_mfcc + src[h]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < FILL; ++u) {
      const int k = kb + u * CONSUMERS;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (k < nk && lane + 32 * h < BASIS_K) basis[k * BASIS_K + lane + 32 * h] = v[u][h];
    }
  }
  named_sync(1, THREADS);

  const int ct = min(CT, n_mfcc - c0);           // this block's coefficients
  int s = 0, ph = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long wr0 = (long long)tile * TILE_ROWS + warp * WARP_ROWS;  // the warp's rows
    float acc[RPL][CPL];
#pragma unroll
    for (int i = 0; i < RPL; ++i) {
      const long long row = wr0 + rl + 8 * i;
      const bool in = row < rows;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        // a later launch continues the sums of the mels before k0
        const bool mine = in && k0 > 0 && g * CPL + j < ct;
        acc[i][j] = mine ? out[row * n_mfcc + c0 + g * CPL + j] : 0.f;
      }
    }
    for (int q = 0; q < n_chunks; ++q) {
      mbar_wait(full + 8 * s, ph);
      const char* st =
          sm + (size_t)s * STAGE_BYTES + (size_t)(warp * WARP_ROWS + rl) * KT * 4;
      const float* bq = basis + (size_t)q * KT * BASIS_K + g * CPAD;
#pragma unroll 4
      for (int kq = 0; kq < KT / 4; ++kq) {
        float m[RPL][4];
#pragma unroll
        for (int i = 0; i < RPL; ++i) {
          // row rl + 8 i: its line i * 8 lines on, word kq at kq ^ swz(rl);
          // floored as it is read
          const float4 v =
              *reinterpret_cast<const float4*>(st + i * 8 * KT * 4 + ((kq ^ swz(rl)) << 4));
          m[i][0] = fmaxf(v.x, fl[i]);
          m[i][1] = fmaxf(v.y, fl[i]);
          m[i][2] = fmaxf(v.z, fl[i]);
          m[i][3] = fmaxf(v.w, fl[i]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float4* bw = reinterpret_cast<const float4*>(bq + (4 * kq + kk) * BASIS_K);
          const float4 w0 = bw[0], w1 = bw[1], w2 = bw[2];
          const float w[CPL] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x, w2.y};
#pragma unroll
          for (int i = 0; i < RPL; ++i)
#pragma unroll
            for (int j = 0; j < CPL; ++j) acc[i][j] = fmaf(m[i][kk], w[j], acc[i][j]);
        }
      }
      if (q + 1 < n_chunks) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * s);
        if (++s == lay.stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    load_floors(tile + gridDim.x);  // the next tile's, in flight during the stores
    // the outputs, OUT_ROWS rows at a time (rows r0 ..), through this
    // warp's own rows of the last stage
    float* ob = reinterpret_cast<float*>(sm + (size_t)s * STAGE_BYTES +
                                         (size_t)warp * WARP_ROWS * KT * 4);
#pragma unroll
    for (int h = 0; h < WARP_ROWS / OUT_ROWS; ++h) {
      const long long r0 = wr0 + OUT_ROWS * h;
      const int nv = (int)max(0LL, min((long long)OUT_ROWS, (long long)rows - r0));
      __syncwarp();
#pragma unroll
      for (int i = 0; i < OUT_ROWS / 8; ++i)
#pragma unroll
        for (int j = 0; j < CPL; ++j)
          if (g * CPL + j < ct) ob[(rl + 8 * i) * ct + g * CPL + j] = acc[OUT_ROWS / 8 * h + i][j];
      __syncwarp();
      if (vec_out && ct == n_mfcc) {
        // the rows of the whole width are one contiguous run
        const float4* src = reinterpret_cast<const float4*>(ob);
        float4* dst = reinterpret_cast<float4*>(out + r0 * n_mfcc);
        for (int e = lane; e < nv * n_mfcc / 4; e += 32) dst[e] = src[e];
      } else {
        for (int e = lane; e < nv * ct; e += 32) out[(r0 + e / ct) * n_mfcc + c0 + e % ct] = ob[e];
      }
    }
    // the stage goes back to the producer, whose next copy into it runs in
    // the async proxy after these generic writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * s);
    if (++s == lay.stages) {
      s = 0;
      ph ^= 1;
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the CUDA runtime (no link
// to libcuda)
cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* sept_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int sept_floor_dct(const float* mel, const float* floor, const float* dct, float* out,
                   int rows, int n_mels, int n_mfcc, void* stream) {
  if (n_mfcc < 1 || n_mels < 1 || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const Layout lay(n_mels);
  cudaError_t err = cudaFuncSetAttribute(
      floor_dct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.total);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(floor_dct_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  // the tensor copy takes 16-byte aligned rows: n_mels a multiple of 4
  const bool tma = n_mels % 4 == 0 && (reinterpret_cast<uintptr_t>(mel) & 15) == 0;
  CUtensorMap map;
  std::memset(&map, 0, sizeof map);
  if (tma) {
    EncodeTiled encode;
    err = encoder(&encode);
    if (err != cudaSuccess) return (int)err;
    const cuuint64_t dims[2] = {(cuuint64_t)n_mels, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)n_mels * 4};
    const cuuint32_t box[2] = {KT, TILE_ROWS}, steps[2] = {1, 1};
    const CUresult res = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(mel),
                                dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  }
  const bool vec_out = n_mfcc % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, floor_dct_kernel, THREADS,
                                                      lay.total);
  if (err != cudaSuccess) return (int)err;
  const long long n_ct = (n_mfcc + CT - 1) / CT;
  const long long n_tiles = ((long long)rows + TILE_ROWS - 1) / TILE_ROWS;
  if (n_ct > 65535 || n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  // persistent: the blocks the SMs hold, over the coefficient tiles, at most
  // one a row tile
  const long long gx =
      std::max(1LL, std::min(n_tiles, std::max(1LL, (long long)sms * std::max(1, per_sm) / n_ct)));
  for (int k0 = 0; k0 < n_mels; k0 += lay.kr) {
    floor_dct_kernel<<<dim3((unsigned)gx, (unsigned)n_ct), THREADS, lay.total,
                       (cudaStream_t)stream>>>(map, mel, floor, dct, out, rows, n_mels, n_mfcc,
                                               k0, (int)n_tiles, tma, vec_out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
