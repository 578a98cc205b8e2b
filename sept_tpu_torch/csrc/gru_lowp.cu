// The bf16 bidirectional GRU layer of Conv2dBiRNN, forward and backward
// recurrences, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package's recurrence is flax's
// nn.RNN(GRUCell) (sept_tpu/models/backbone.py:78), which XLA compiles into
// a loop.  The port ran the bf16 cell as a Python loop over the time steps
// (models/backbone.py::bigru_layer_lowp, kept as the reference), about a
// dozen small kernels a step and twice as many in autograd's backward:
// some 2,000 launches of a training step at the benchmark's shapes (B 32,
// T 25, H 64, two layers), most of the step's device time and of its graph
// launch.  cuDNN's bf16 GRU keeps a bf16 carry where flax keeps it in f32.
//
// What they compute: exactly bigru_layer_lowp, flax's GRUCell(dtype=bf16)
// in both directions, every rounding of the loop kept.  Per step, for gi =
// x @ W_ih^T of that step (bf16, the wrapper's one product over all steps):
//   gi' = bf16(gi + bf16(b_ih));  gh = bf16(bf16(bf16(h) @ W_hh^T) + bf16(b_hh))
//   r, z = bf16(sigmoid(bf16(gi'_rz + gh_rz)));  n = bf16(tanh(bf16(gi'_n +
//   bf16(r * gh_n))));  h' = bf16(bf16(1 - z) * n) + z * h   (h, h' f32)
// with each f32 operation as torch's elementwise kernels do it (sigmoid as
// 1 / (1 + expf(-x)), no FMA contraction in the carry).  The backward walks
// the steps in reverse with autograd's roundings of the loop: the carry's
// cotangent dh (f32) = the output's + dh_next * z_next + bf16(dgh_next @
// W_hh); dq = bf16(dh); dz = bf16(bf16(dh * h) - bf16(dq * n)); dn =
// bf16(dq * bf16(1 - z)); then tanh_backward and sigmoid_backward rounded
// to bf16 as torch's (a * (1 - b * b), a * (1 - b) * b); it writes each
// step's dgi = (da_r, da_z, da_n) and dgh = (da_r, da_z, bf16(da_n * r)),
// bf16, and bf16(h_{t-1}); the wrapper takes dW_hh, dW_ih, dx and the bias
// sums as one product or sum each over all steps.
//
// What bounds them on the H100: the chain of T dependent steps, not bytes
// or FLOPs.  At B 32, T 25, H 64 a step of one direction is a (32 x 64) .
// (64 x 192) product and its gates, ~0.8 MFLOP; the bytes (gi in, ~0.6 MB,
// the f32 output, 0.4 MB) take ~0.3 us at 3.35 TB/s.  What costs is the
// latency of one step times T: a shared-memory round trip, the products,
// the gate arithmetic and a barrier.
//
// Design:
// - Grid: one block per direction and 16-row batch tile (blockIdx.y the
//   direction), both directions in one launch.  A block keeps everything
//   on chip across the whole sequence and synchronises once a step.
// - A warp owns 8 hidden units j: the three n-tiles (r, z, n) of mma.sync
//   m16n8k16 bf16 -> f32 whose columns are j, H + j, 2H + j, so each lane
//   ends holding r, z and n of the same (row, j) cells and the gate
//   arithmetic runs in registers, no exchange between lanes.  (wgmma's
//   64-row tile would waste most of a 16-row step.)
// - bf16(h) of the current step lives in shared memory (two buffers: one
//   barrier a step), read with ldmatrix as the products' A operand.
// - Up to H = 128 (RES_MAX_H) a warp holds its B fragments of W_hh (bf16,
//   converted once from the f32 parameters) in registers for all T steps
//   and the f32 carry h in registers.  Each thread stages its own inputs of
//   the next STAGES - 1 steps (gi forward; dout, h_{t-1} and the gates
//   backward) in shared memory with cp.async, and issues a step's global
//   stores after the step's barrier: a barrier waits for the thread's
//   outstanding loads and stores, not for its asynchronous copies.  (On an
//   H100, with loads into registers one step ahead and the stores before
//   the barrier, a step took 3.7 us, ~1.5 of it the loads and ~0.7 the
//   stores.)  Above that the same code runs with 16 warps looping over their
//   groups, loading where they use, W_hh read through L2 each step, and
//   the carries in global memory (the output itself in the forward, a
//   scratch buffer the wrapper allocates in the backward).  The two A
//   tiles stay in shared memory up to H = 1024 (SMEM_MAX_H: the backward's
//   (16, 3H) bf16 tiles, 197 KB there); above it they live in a global
//   scratch buffer the wrapper allocates (sept_gru_lowp_tile_elems), read
//   by plain loads in the fragments' layout, so that any H runs.
// - The sums over k of each product run in order, one accumulator, as
//   cuBLAS's products sum them: the loop's outputs come out bit for bit at
//   the benchmark's shapes, and in the backward another order moves some
//   roundings by a unit, which the chain of roundings then spreads.
// - The reverse direction reads gi and writes its rows at reversed time
//   indices: no flip, stack or cat copies; the output (B, T, 2H) f32 is
//   written in place.
// - In train mode the forward stores r, z, n and gh_n of every step (bf16,
//   (2, B, T, 4, H)); the backward reads them and h_{t-1} from the
//   forward's output.  Under no_grad the gates pointer is null and nothing
//   is stored but the output.
// - Padded hidden units (j >= H in a group of 8) have zero weights, gi and
//   biases, so their carry stays 0; rows past B are computed and never
//   stored (the products keep rows apart).  Nothing is allocated and
//   nothing synchronises with the host: the launches are safe inside a
//   CUDA graph capture.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int ROWS = 16;       // batch rows a block: one mma m-tile
constexpr int RES_MAX_H = 128;  // W_hh and the carries in registers up to this H
constexpr int SMEM_MAX_H = 1024;  // the A tiles in shared memory up to this H, else global
constexpr int L2_WARPS = 16;   // warps a block above RES_MAX_H
constexpr int MAX_THREADS = 512;
constexpr int STAGES = 4;      // steps of input staged ahead on the register path: 3 in flight

__device__ __forceinline__ float bfr(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// The A fragment of rows 0..15, columns k0..k0+15 of a bf16 tile in shared
// memory with row stride ld (elements; rows 16-byte aligned).
__device__ __forceinline__ void load_a(unsigned* a, const bf16* tile, int ld, int k0, int lane) {
  const bf16* p = tile + (lane & 15) * ld + k0 + (lane >> 4) * 8;
  const unsigned addr = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr)
               : "memory");
}

// The same fragment by plain loads from a tile anywhere (the L2 path's tiles
// in global memory above SMEM_MAX_H; rows 4-byte aligned).
__device__ __forceinline__ void load_a_plain(unsigned* a, const bf16* tile, int ld, int k0,
                                             int lane) {
  const bf16* p = tile + (lane >> 2) * ld + k0 + (lane & 3) * 2;
  a[0] = *reinterpret_cast<const unsigned*>(p);
  a[1] = *reinterpret_cast<const unsigned*>(p + 8 * ld);
  a[2] = *reinterpret_cast<const unsigned*>(p + 8);
  a[3] = *reinterpret_cast<const unsigned*>(p + 8 * ld + 8);
}

// Either: ldmatrix from shared memory, or plain loads from a global tile.
__device__ __forceinline__ void load_a_any(unsigned* a, const bf16* tile, int ld, int k0,
                                           int lane, bool in_global) {
  if (in_global)
    load_a_plain(a, tile, ld, k0, lane);
  else
    load_a(a, tile, ld, k0, lane);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

template <typename T>
__device__ __forceinline__ bool pair_aligned(const T* p) {
  return !(reinterpret_cast<uintptr_t>(p) & (2 * sizeof(T) - 1));
}

// Two adjacent elements p[0], p[1], each read where its flag is set (0
// elsewhere), as one access where both are set and p is aligned to the pair.
__device__ __forceinline__ float2 ld2(const bf16* p, bool ok0, bool ok1) {
  if (ok0 && ok1 && pair_aligned(p))
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  return make_float2(ok0 ? __bfloat162float(p[0]) : 0.f, ok1 ? __bfloat162float(p[1]) : 0.f);
}

__device__ __forceinline__ float2 ld2(const float* p, bool ok0, bool ok1) {
  if (ok0 && ok1 && pair_aligned(p)) return *reinterpret_cast<const float2*>(p);
  return make_float2(ok0 ? p[0] : 0.f, ok1 ? p[1] : 0.f);
}

__device__ __forceinline__ void st2(bf16* p, float v0, float v1, bool ok0, bool ok1) {
  if (ok0 && ok1 && pair_aligned(p)) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
    return;
  }
  if (ok0) p[0] = __float2bfloat16_rn(v0);
  if (ok1) p[1] = __float2bfloat16_rn(v1);
}

__device__ __forceinline__ void st2(bf16* p, unsigned v, bool ok0, bool ok1) {
  const float2 f = unpack_bf16(v);
  st2(p, f.x, f.y, ok0, ok1);
}

__device__ __forceinline__ void st2(float* p, float v0, float v1, bool ok0, bool ok1) {
  if (ok0 && ok1 && pair_aligned(p)) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
    return;
  }
  if (ok0) p[0] = v0;
  if (ok1) p[1] = v1;
}

// cp.async of N bytes (4 or 8) global -> shared, src_bytes of them read, the
// rest zero; the copies of a thread complete in commit groups
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(N),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// p[0], p[1] into a thread's own slot, 0 where a flag is unset:
// asynchronously where the pair is aligned, else by plain loads (odd H)
__device__ __forceinline__ void stage2(unsigned* dst, const bf16* p, bool ok0, bool ok1) {
  if (pair_aligned(p)) {
    cp_async<4>(dst, p, ok0 ? (ok1 ? 4 : 2) : 0);
  } else {
    const float2 v = ld2(p, ok0, ok1);
    *dst = pack_bf16(v.x, v.y);
  }
}

__device__ __forceinline__ void stage2(float2* dst, const float* p, bool ok0, bool ok1) {
  if (pair_aligned(p))
    cp_async<8>(dst, p, ok0 ? (ok1 ? 8 : 4) : 0);
  else
    *dst = ld2(p, ok0, ok1);
}

// w[r * cols + c] rounded to bf16, 0 outside rows x cols
__device__ __forceinline__ float wv(const float* w, int r, int c, int rows, int cols) {
  return (r < rows && c < cols) ? bfr(__ldg(w + (long long)r * cols + c)) : 0.f;
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// What a lane holds: rows lane/4 and lane/4 + 8 of the tile, hidden units
// j0 = 8g + 2 (lane % 4) and j0 + 1 of group g; cell i is (row i / 2, j0 +
// i % 2), the mma accumulator's order.
struct Cells {
  int r0, j0;
  bool row[2], col[2];
  __device__ Cells(int g, int lane, int b0, int B, int H)
      : r0(lane >> 2), j0(8 * g + (lane & 3) * 2) {
    row[0] = b0 + r0 < B;
    row[1] = b0 + r0 + 8 < B;
    col[0] = j0 < H;
    col[1] = j0 + 1 < H;
  }
  __device__ long long b(int i) const { return r0 + 8 * (i >> 1); }  // row in the tile
  __device__ bool ok(int rr, int cc) const { return row[rr] && col[cc]; }
};

// The order of the steps: step s of direction d is at time t0 + s * dt
// (the forward's s; the backward walks k = T - 1 - s from 0)
__device__ __forceinline__ int first_time(int d, int T, bool backward) {
  return (d != 0) != backward ? T - 1 : 0;
}

// ---------------------------------------------------------------------------
// forward

struct FwdArgs {
  const bf16* gi;      // (B, T, 6H): x @ [W_ih fwd; W_ih rev]^T, no bias
  const float* b_ih[2];  // (3H) each
  const float* w_hh[2];  // (3H, H) each, torch layout
  const float* b_hh[2];
  float* out;          // (B, T, 2H)
  bf16* gates;         // (2, B, T, 4, H): r, z, n, gh_n; null under no_grad
  bf16* tiles;         // the A tiles of every block above SMEM_MAX_H, else null
  int B, T, H;
};

// The lane's pointers at the direction's first step (gi: gate 0, gate q at
// + q * H; gates: r, at + q * H) and how far one step moves each (elements),
// worked out once, not every step.
struct FwdRows {
  const bf16* gi[2];
  float* out[2];
  bf16* gates[2];
  long long d_gi, d_out, d_gates;
  __device__ FwdRows(const FwdArgs& a, const Cells& c, int d, int b0) {
    const int T = a.T, H = a.H, t0 = first_time(d, T, false);
    const long long dt = d ? -1 : 1;
    d_gi = dt * 6 * H;
    d_out = dt * 2 * H;
    d_gates = dt * 4 * H;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long long b = b0 + c.b(2 * rr);
      gi[rr] = a.gi + (b * T + t0) * 6 * H + d * 3 * H + c.j0;
      out[rr] = a.out + (b * T + t0) * 2 * H + d * H + c.j0;
      gates[rr] = a.gates == nullptr
                      ? nullptr
                      : a.gates + (((long long)d * a.B + b) * T + t0) * 4 * H + c.j0;
    }
  }
};

// One cell's step: the product sums m (f32), gi (raw, bf16 values), the
// bf16-rounded biases and the carry h; returns h' and the gates in o.
__device__ __forceinline__ float cell_fwd(const float* m, const float* g, const float* bi,
                                          const float* bh, float h, float* o) {
  const float gr = bfr(g[0] + bi[0]), gz = bfr(g[1] + bi[1]), gn = bfr(g[2] + bi[2]);
  const float ghr = bfr(bfr(m[0]) + bh[0]), ghz = bfr(bfr(m[1]) + bh[1]);
  const float ghn = bfr(bfr(m[2]) + bh[2]);
  const float r = bfr(sigmoid(bfr(gr + ghr)));
  const float z = bfr(sigmoid(bfr(gz + ghz)));
  const float n = bfr(tanhf(bfr(gn + bfr(r * ghn))));
  o[0] = r;
  o[1] = z;
  o[2] = n;
  o[3] = ghn;
  return __fadd_rn(bfr(bfr(1.f - z) * n), __fmul_rn(z, h));
}

// The four cells of a lane through one step: the products m, the gi pairs
// (packed bf16, [row][gate]), the biases [column][gate], the carry h
// (updated); the gates come back packed, [row][gate].
__device__ __forceinline__ void cells_fwd(const float (&acc)[3][4], const unsigned (&g2)[2][3],
                                          const float (&bi)[2][3], const float (&bh)[2][3],
                                          float* h, unsigned (&o2)[2][4]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float o[2][4];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int i = 2 * rr + cc;
      float g[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float2 v = unpack_bf16(g2[rr][q]);
        g[q] = cc ? v.y : v.x;
      }
      const float m[3] = {acc[0][i], acc[1][i], acc[2][i]};
      h[i] = cell_fwd(m, g, bi[cc], bh[cc], h[i], o[cc]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) o2[rr][q] = pack_bf16(o[0][q], o[1][q]);
  }
}

// the biases of the lane's columns, rounded to bf16: [column][gate]
__device__ __forceinline__ void load_bias(float (&bi)[2][3], float (&bh)[2][3],
                                          const FwdArgs& a, const Cells& c, int d) {
#pragma unroll
  for (int cc = 0; cc < 2; ++cc)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      bi[cc][q] = c.col[cc] ? bfr(__ldg(a.b_ih[d] + q * a.H + c.j0 + cc)) : 0.f;
      bh[cc][q] = c.col[cc] ? bfr(__ldg(a.b_hh[d] + q * a.H + c.j0 + cc)) : 0.f;
    }
}

// bf16(h') of the lane's cells into the next step's A tile
__device__ __forceinline__ void put_h(const Cells& c, const float* h, bf16* hnext, int ldh) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    *reinterpret_cast<__nv_bfloat162*>(hnext + c.b(2 * rr) * ldh + c.j0) =
        __floats2bfloat162_rn(h[2 * rr], h[2 * rr + 1]);
}

// the lane's cells of step s to the output and, in train mode, the gates
__device__ __forceinline__ void store_fwd(const FwdRows& rows, const Cells& c, int s, int H,
                                          const float* h, const unsigned (&o2)[2][4]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (!c.row[rr]) continue;
    st2(rows.out[rr] + s * rows.d_out, h[2 * rr], h[2 * rr + 1], c.col[0], c.col[1]);
    if (rows.gates[rr] != nullptr) {
      bf16* g = rows.gates[rr] + s * rows.d_gates;
#pragma unroll
      for (int q = 0; q < 4; ++q) st2(g + q * H, o2[rr][q], c.col[0], c.col[1]);
    }
  }
}

// This block's two A tiles of `cols` columns: its part of the global
// scratch where there is one, else shared memory.
__device__ __forceinline__ bf16* block_tiles(bf16* scratch, unsigned char* smem, int cols) {
  if (scratch == nullptr) return reinterpret_cast<bf16*>(smem);
  return scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * ROWS * cols;
}

// KSM > 0: the register path for H <= 16 * KSM, one group of 8 units a
// warp, each step's gi staged STAGES - 1 steps ahead; KSM == 0: the L2
// path, L2_WARPS warps looping over the groups, loading where they use.
template <int KSM>
__global__ void __launch_bounds__(MAX_THREADS) gru_fwd_kernel(const __grid_constant__ FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = a.H, T = a.T, ks_n = (H + 15) / 16, ldh = ks_n * 16 + 8;
  bf16* hb = block_tiles(a.tiles, smem_raw, ldh);  // [2][ROWS][ldh]: bf16(h) of a step
  const int d = blockIdx.y, b0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* w = a.w_hh[d];
  for (int i = threadIdx.x; i < ROWS * ldh; i += blockDim.x)
    reinterpret_cast<unsigned*>(hb)[i] = 0u;  // both buffers: 2 * ROWS * ldh / 2 words

  if constexpr (KSM > 0) {
    // [STAGES][row * 3 + gate][thread]: the lane's gi pairs of a step
    unsigned* stage = reinterpret_cast<unsigned*>(hb + 2 * ROWS * ldh) + threadIdx.x;
    const int nt = blockDim.x;
    const Cells c(warp, lane, b0, a.B, H);
    const FwdRows rows(a, c, d, b0);
    // B fragments: row n = q * H + 8 warp + lane / 4 of W_hh, k pairs
    unsigned bw[3][KSM][2];
    const int nrow = 8 * warp + (lane >> 2);
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int ks = 0; ks < KSM; ++ks) {
        const int k = ks * 16 + (lane & 3) * 2, n = nrow < H ? q * H + nrow : 3 * H;
        bw[q][ks][0] = pack_bf16(wv(w, n, k, 3 * H, H), wv(w, n, k + 1, 3 * H, H));
        bw[q][ks][1] = pack_bf16(wv(w, n, k + 8, 3 * H, H), wv(w, n, k + 9, 3 * H, H));
      }
    float bi[2][3], bh[2][3];
    load_bias(bi, bh, a, c, d);
    auto stage_gi = [&](int p) {  // step p's gi pairs into slot p % STAGES
      unsigned* slot = stage + (p % STAGES) * 6 * nt;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const bf16* g = rows.gi[rr] + p * rows.d_gi;
#pragma unroll
        for (int q = 0; q < 3; ++q)
          stage2(slot + (rr * 3 + q) * nt, g + q * H, c.ok(rr, 0), c.ok(rr, 1));
      }
    };
#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) {
      if (p < T) stage_gi(p);
      cp_commit();
    }
    float h[4] = {0.f, 0.f, 0.f, 0.f};
    __syncthreads();
    for (int s = 0; s < T; ++s) {
      const bf16* hcur = hb + (s & 1) * ROWS * ldh;
      bf16* hnext = hb + ((s + 1) & 1) * ROWS * ldh;
      if (s + STAGES - 1 < T) stage_gi(s + STAGES - 1);
      cp_commit();
      float acc[3][4] = {};
#pragma unroll
      for (int ks = 0; ks < KSM; ++ks) {
        if (ks < ks_n) {
          unsigned af[4];
          load_a(af, hcur, ldh, ks * 16, lane);
#pragma unroll
          for (int q = 0; q < 3; ++q) mma16816(acc[q], af, bw[q][ks][0], bw[q][ks][1]);
        }
      }
      cp_wait<STAGES - 1>();  // this step's gi has landed
      unsigned g2[2][3], o2[2][4];
      const unsigned* slot = stage + (s % STAGES) * 6 * nt;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
#pragma unroll
        for (int q = 0; q < 3; ++q) g2[rr][q] = slot[(rr * 3 + q) * nt];
      cells_fwd(acc, g2, bi, bh, h, o2);
      put_h(c, h, hnext, ldh);
      __syncthreads();
      // the global stores after the barrier: in flight across the next step
      store_fwd(rows, c, s, H, h, o2);
    }
  } else {
    __syncthreads();
    const int nwarps = blockDim.x >> 5, groups = (H + 7) / 8;
    const bool in_global = a.tiles != nullptr;
    for (int s = 0; s < T; ++s) {
      const bf16* hcur = hb + (s & 1) * ROWS * ldh;
      bf16* hnext = hb + ((s + 1) & 1) * ROWS * ldh;
      for (int grp = warp; grp < groups; grp += nwarps) {
        const Cells c(grp, lane, b0, a.B, H);
        const FwdRows rows(a, c, d, b0);
        const int nrow = 8 * grp + (lane >> 2);
        float acc[3][4] = {};
        for (int ks = 0; ks < ks_n; ++ks) {
          unsigned af[4];
          load_a_any(af, hcur, ldh, ks * 16, lane, in_global);
          const int k = ks * 16 + (lane & 3) * 2;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const int n = nrow < H ? q * H + nrow : 3 * H;
            mma16816(acc[q], af,
                     pack_bf16(wv(w, n, k, 3 * H, H), wv(w, n, k + 1, 3 * H, H)),
                     pack_bf16(wv(w, n, k + 8, 3 * H, H), wv(w, n, k + 9, 3 * H, H)));
          }
        }
        unsigned g2[2][3], o2[2][4];
        float h[4], bi[2][3], bh[2][3];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const bool ok0 = c.ok(rr, 0), ok1 = c.ok(rr, 1);
          const bf16* g = rows.gi[rr] + s * rows.d_gi;
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            const float2 v = ld2(g + q * H, ok0, ok1);
            g2[rr][q] = pack_bf16(v.x, v.y);
          }
          // the carry: this lane's own output of the last step
          const float2 v = s ? ld2(rows.out[rr] + (s - 1) * rows.d_out, ok0, ok1)
                             : make_float2(0.f, 0.f);
          h[2 * rr] = v.x;
          h[2 * rr + 1] = v.y;
        }
        load_bias(bi, bh, a, c, d);
        cells_fwd(acc, g2, bi, bh, h, o2);
        put_h(c, h, hnext, ldh);
        store_fwd(rows, c, s, H, h, o2);
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// backward

struct BwdArgs {
  const float* dout;   // (B, T, 2H)
  const float* out;    // (B, T, 2H): the forward's output, h of every step
  const bf16* gates;   // (2, B, T, 4, H)
  const float* w_hh[2];  // (3H, H) each
  bf16* dgi;           // (B, T, 6H)
  bf16* dgh;           // (2, B, T, 3H)
  bf16* hb;            // (2, B, T, H): bf16(h_{t-1})
  float* carry;        // (2, B, 2, H): the L2 path's carries
  bf16* tiles;         // the A tiles of every block above SMEM_MAX_H, else null
  int B, T, H;
};

// The lane's pointers at the backward's first step k = 0 (s = T - 1) and
// how far one step k moves each (elements; h_{t-1} in the forward's output
// moves as dout), worked out once.
struct BwdRows {
  const float* dout[2];
  const float* hp[2];
  const bf16* gates[2];
  bf16* dgi[2];
  bf16* dgh[2];
  bf16* hb[2];
  long long d_dout, d_gates, d_dgi, d_dgh, d_hb;
  __device__ BwdRows(const BwdArgs& a, const Cells& c, int d, int b0) {
    const int T = a.T, H = a.H, t0 = first_time(d, T, true);
    const long long dt = d ? 1 : -1;
    d_dout = dt * 2 * H;
    d_gates = dt * 4 * H;
    d_dgi = dt * 6 * H;
    d_dgh = dt * 3 * H;
    d_hb = dt * H;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const long long b = b0 + c.b(2 * rr), row = b * T + t0;
      const long long drow = ((long long)d * a.B + b) * T + t0;
      dout[rr] = a.dout + row * 2 * H + d * H + c.j0;
      hp[rr] = a.out + (row + dt) * 2 * H + d * H + c.j0;  // the time one step before
      gates[rr] = a.gates + drow * 4 * H + c.j0;
      dgi[rr] = a.dgi + row * 6 * H + d * 3 * H + c.j0;
      dgh[rr] = a.dgh + drow * 3 * H + c.j0;
      hb[rr] = a.hb + drow * H + c.j0;
    }
  }
};

// What one step of the backward reads of the lane's cells: f32 pairs of
// dout and h_{t-1} a row, bf16 pairs of the gates a row and gate
struct BwdIn {
  float2 dout[2], hp[2];
  unsigned gate[2][4];  // r, z, n, gh_n
};

// One step of the lane's cells: dh from the output's cotangent and the
// carries (ca = dh_next * z_next, cb = bf16(dgh_next @ W_hh), both f32;
// ca is updated); the rows come back packed, [row][gate] (dgi: da_r, da_z,
// da_n; dgh: da_r, da_z, bf16(da_n * r)), and dgh also into the next
// product's A tile.
__device__ __forceinline__ void cells_bwd(const Cells& c, const BwdIn& in, float* ca,
                                          const float* cb, unsigned (&gi2)[2][3],
                                          unsigned (&gh2)[2][3], bf16* tile, int lda, int H) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float dgi[2][3], dgh[2][3];
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int i = 2 * rr + cc;
      float gt[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 v = unpack_bf16(in.gate[rr][q]);
        gt[q] = cc ? v.y : v.x;
      }
      const float r = gt[0], z = gt[1], n = gt[2], ghn = gt[3];
      const float dout = cc ? in.dout[rr].y : in.dout[rr].x;
      const float hp = cc ? in.hp[rr].y : in.hp[rr].x;
      const float dh = __fadd_rn(__fadd_rn(dout, ca[i]), cb[i]);
      const float dq = bfr(dh);
      const float dz = bfr(bfr(__fmul_rn(dh, hp)) - bfr(dq * n));
      const float dn = bfr(dq * bfr(1.f - z));
      const float da_n = bfr(dn * (1.f - n * n));
      const float dr = bfr(da_n * ghn);
      dgh[cc][2] = bfr(da_n * r);
      dgi[cc][0] = dgh[cc][0] = bfr(dr * (1.f - r) * r);
      dgi[cc][1] = dgh[cc][1] = bfr(dz * (1.f - z) * z);
      dgi[cc][2] = da_n;
      ca[i] = __fmul_rn(dh, z);
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      gi2[rr][q] = pack_bf16(dgi[0][q], dgi[1][q]);
      gh2[rr][q] = pack_bf16(dgh[0][q], dgh[1][q]);
      // the next product's A operand, columns q * H + j
      st2(tile + c.b(2 * rr) * lda + q * H + c.j0, dgh[0][q], dgh[1][q], c.col[0], c.col[1]);
    }
  }
}

// the lane's rows of step k: dgi, dgh and bf16(h_{t-1})
__device__ __forceinline__ void store_bwd(const BwdRows& rows, const Cells& c, int k, int H,
                                          const unsigned (&gi2)[2][3],
                                          const unsigned (&gh2)[2][3], const unsigned (&hb2)[2]) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    if (!c.row[rr]) continue;
    bf16* gi = rows.dgi[rr] + k * rows.d_dgi;
    bf16* gh = rows.dgh[rr] + k * rows.d_dgh;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      st2(gi + q * H, gi2[rr][q], c.col[0], c.col[1]);
      st2(gh + q * H, gh2[rr][q], c.col[0], c.col[1]);
    }
    st2(rows.hb[rr] + k * rows.d_hb, hb2[rr], c.col[0], c.col[1]);
  }
}

// cb = bf16(dgh @ W_hh) of the lane's cells, the sum over k in order (as
// cuBLAS's products sum it: another order moves some roundings by a unit,
// which the backward's chain of roundings then spreads)
template <int KSM>
__device__ __forceinline__ void dh_product(float* cb, const bf16* tile, int lda, int ks_n,
                                           unsigned (*bw)[2], const float* w, int grp,
                                           int lane, int H, bool in_global) {
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int ncol = 8 * grp + (lane >> 2);
  if constexpr (KSM > 0) {
#pragma unroll
    for (int ks = 0; ks < 3 * KSM; ++ks) {
      if (ks < ks_n) {
        unsigned af[4];
        load_a(af, tile, lda, ks * 16, lane);
        mma16816(acc, af, bw[ks][0], bw[ks][1]);
      }
    }
  } else {
    for (int ks = 0; ks < ks_n; ++ks) {
      unsigned af[4];
      load_a_any(af, tile, lda, ks * 16, lane, in_global);
      const int k = ks * 16 + (lane & 3) * 2;
      mma16816(acc, af, pack_bf16(wv(w, k, ncol, 3 * H, H), wv(w, k + 1, ncol, 3 * H, H)),
               pack_bf16(wv(w, k + 8, ncol, 3 * H, H), wv(w, k + 9, ncol, 3 * H, H)));
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) cb[i] = bfr(acc[i]);
}

template <int KSM>
__global__ void __launch_bounds__(MAX_THREADS) gru_bwd_kernel(const __grid_constant__ BwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = a.H, T = a.T, ks_n = (3 * H + 15) / 16, lda = ks_n * 16 + 8;
  bf16* tiles = block_tiles(a.tiles, smem_raw, lda);  // [2][ROWS][lda]: dgh of a step
  const int d = blockIdx.y, b0 = blockIdx.x * ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* w = a.w_hh[d];
  for (int i = threadIdx.x; i < ROWS * lda; i += blockDim.x)
    reinterpret_cast<unsigned*>(tiles)[i] = 0u;

  if constexpr (KSM > 0) {
    // [STAGES][dout r0, dout r1, hp r0, hp r1][thread] f32 pairs, then
    // [STAGES][row * 4 + gate][thread] bf16 pairs: the lane's inputs of a step
    const int nt = blockDim.x;
    float2* stage_f = reinterpret_cast<float2*>(tiles + 2 * ROWS * lda) + threadIdx.x;
    unsigned* stage_u =
        reinterpret_cast<unsigned*>(reinterpret_cast<float2*>(tiles + 2 * ROWS * lda) +
                                    STAGES * 4 * nt) + threadIdx.x;
    const Cells c(warp, lane, b0, a.B, H);
    const BwdRows rows(a, c, d, b0);
    // B fragments: column j = 8 warp + lane / 4 of W_hh, rows k (gate rows)
    unsigned bw[3 * KSM][2];
    const int ncol = 8 * warp + (lane >> 2);
#pragma unroll
    for (int ks = 0; ks < 3 * KSM; ++ks) {
      const int k = ks * 16 + (lane & 3) * 2;
      bw[ks][0] = pack_bf16(wv(w, k, ncol, 3 * H, H), wv(w, k + 1, ncol, 3 * H, H));
      bw[ks][1] = pack_bf16(wv(w, k + 8, ncol, 3 * H, H), wv(w, k + 9, ncol, 3 * H, H));
    }
    auto stage_in = [&](int p) {  // the inputs of step k = p into slot p % STAGES
      const int slot = p % STAGES;
      const bool first = p == T - 1;  // s == 0: no h_{t-1}
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const bool ok0 = c.ok(rr, 0), ok1 = c.ok(rr, 1);
        stage2(stage_f + (slot * 4 + rr) * nt, rows.dout[rr] + p * rows.d_dout, ok0, ok1);
        stage2(stage_f + (slot * 4 + 2 + rr) * nt, rows.hp[rr] + p * rows.d_dout,
               ok0 && !first, ok1 && !first);
        const bf16* g = rows.gates[rr] + p * rows.d_gates;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          stage2(stage_u + (slot * 8 + rr * 4 + q) * nt, g + q * H, ok0, ok1);
      }
    };
#pragma unroll
    for (int p = 0; p < STAGES - 1; ++p) {
      if (p < T) stage_in(p);
      cp_commit();
    }
    float ca[4] = {0.f, 0.f, 0.f, 0.f}, cb[4] = {0.f, 0.f, 0.f, 0.f};
    __syncthreads();
    for (int k = 0; k < T; ++k) {
      const int slot = k % STAGES;
      if (k + STAGES - 1 < T) stage_in(k + STAGES - 1);
      cp_commit();
      cp_wait<STAGES - 1>();  // this step's inputs have landed
      BwdIn in;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        in.dout[rr] = stage_f[(slot * 4 + rr) * nt];
        in.hp[rr] = stage_f[(slot * 4 + 2 + rr) * nt];
#pragma unroll
        for (int q = 0; q < 4; ++q) in.gate[rr][q] = stage_u[(slot * 8 + rr * 4 + q) * nt];
      }
      bf16* tile = tiles + (k & 1) * ROWS * lda;
      unsigned gi2[2][3], gh2[2][3];
      const unsigned hb2[2] = {pack_bf16(in.hp[0].x, in.hp[0].y),
                               pack_bf16(in.hp[1].x, in.hp[1].y)};
      cells_bwd(c, in, ca, cb, gi2, gh2, tile, lda, H);
      __syncthreads();
      // the global stores after the barrier: in flight across the product
      store_bwd(rows, c, k, H, gi2, gh2, hb2);
      if (k + 1 < T) dh_product<KSM>(cb, tile, lda, ks_n, bw, w, warp, lane, H, false);
    }
  } else {
    __syncthreads();
    const int nwarps = blockDim.x >> 5, groups = (H + 7) / 8;
    const bool in_global = a.tiles != nullptr;
    for (int k = 0; k < T; ++k) {
      bf16* tile = tiles + (k & 1) * ROWS * lda;
      for (int grp = warp; grp < groups; grp += nwarps) {
        const Cells c(grp, lane, b0, a.B, H);
        const BwdRows rows(a, c, d, b0);
        BwdIn in;
        float ca[4], cb[4];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const bool ok0 = c.ok(rr, 0), ok1 = c.ok(rr, 1);
          in.dout[rr] = ld2(rows.dout[rr] + k * rows.d_dout, ok0, ok1);
          in.hp[rr] = k + 1 < T ? ld2(rows.hp[rr] + k * rows.d_dout, ok0, ok1)
                                : make_float2(0.f, 0.f);
          const bf16* g = rows.gates[rr] + k * rows.d_gates;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 v = ld2(g + q * H, ok0, ok1);
            in.gate[rr][q] = pack_bf16(v.x, v.y);
          }
          // the carries of the step before, none at the first
          const float* cr = a.carry + ((long long)d * a.B + b0 + c.b(2 * rr)) * 2 * H + c.j0;
          const float2 va = ld2(cr, k && ok0, k && ok1), vb = ld2(cr + H, k && ok0, k && ok1);
          ca[2 * rr] = va.x;
          ca[2 * rr + 1] = va.y;
          cb[2 * rr] = vb.x;
          cb[2 * rr + 1] = vb.y;
        }
        unsigned gi2[2][3], gh2[2][3];
        const unsigned hb2[2] = {pack_bf16(in.hp[0].x, in.hp[0].y),
                                 pack_bf16(in.hp[1].x, in.hp[1].y)};
        cells_bwd(c, in, ca, cb, gi2, gh2, tile, lda, H);
        store_bwd(rows, c, k, H, gi2, gh2, hb2);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float* cr = a.carry + ((long long)d * a.B + b0 + c.b(2 * rr)) * 2 * H + c.j0;
          st2(cr, ca[2 * rr], ca[2 * rr + 1], c.ok(rr, 0), c.ok(rr, 1));
        }
      }
      __syncthreads();
      if (k + 1 == T) break;
      for (int grp = warp; grp < groups; grp += nwarps) {
        const Cells c(grp, lane, b0, a.B, H);
        float cb[4];
        dh_product<0>(cb, tile, lda, ks_n, nullptr, w, grp, lane, H, in_global);
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float* cr = a.carry + ((long long)d * a.B + b0 + c.b(2 * rr)) * 2 * H + c.j0 + H;
          st2(cr, cb[2 * rr], cb[2 * rr + 1], c.ok(rr, 0), c.ok(rr, 1));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launches

template <typename Args>
int launch(void (*kernel)(Args), const Args& a, size_t smem, int threads, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.B + ROWS - 1) / ROWS, 2);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// threads a block: one warp a group of 8 units up to RES_MAX_H, else L2_WARPS
int block_threads(int H) { return H <= RES_MAX_H ? 32 * ((H + 7) / 8) : 32 * L2_WARPS; }

// the A tiles' columns: h (H) forward, dgh (3H) backward, padded to 16 plus 8
int tile_cols(int H, bool backward) { return ((backward ? 3 : 1) * H + 15) / 16 * 16 + 8; }

// shared memory: the two A tiles (none above SMEM_MAX_H: they are global),
// and on the register path STAGES steps of `stage_bytes` a thread
size_t smem_bytes(int H, bool backward, int stage_bytes) {
  if (H > SMEM_MAX_H) return 0;
  const size_t tiles = 2 * ROWS * (size_t)tile_cols(H, backward) * sizeof(bf16);
  return H <= RES_MAX_H ? tiles + (size_t)STAGES * stage_bytes * block_threads(H) : tiles;
}

// the global A tiles' bf16 elements, two a block: 0 up to SMEM_MAX_H
long long tile_elems(int B, int H, bool backward) {
  if (H <= SMEM_MAX_H) return 0;
  return 2LL * ((B + ROWS - 1) / ROWS) * 2 * ROWS * tile_cols(H, backward);
}

bool bad_shape(int B, int T, int H) { return B < 1 || T < 1 || H < 1; }

// refuse a missing or a needless tile scratch
bool bad_tiles(const void* tiles, int B, int H, bool backward) {
  return (tiles != nullptr) != (tile_elems(B, H, backward) > 0);
}

}  // namespace

extern "C" {

const char* sept_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// The bf16 elements of the A-tile scratch a launch takes (0: none, pass
// null): above H = 1024 the tiles of every block live in global memory.
long long sept_gru_lowp_tile_elems(int B, int H, int backward) {
  return tile_elems(B, H, backward != 0);
}

// The forward recurrence of both directions.  gi (B, T, 6H) bf16 is x @
// [W_ih fwd; W_ih rev]^T without the bias; out (B, T, 2H) f32; gates
// (2, B, T, 4, H) bf16 or null; tiles the A-tile scratch
// (sept_gru_lowp_tile_elems(B, H, 0) bf16) or null where that is 0.
int sept_gru_lowp_fwd(const void* gi, const float* b_ih_f, const float* b_ih_r,
                      const float* w_hh_f, const float* w_hh_r, const float* b_hh_f,
                      const float* b_hh_r, float* out, void* gates, void* tiles, int B, int T,
                      int H, void* stream) {
  if (bad_shape(B, T, H) || bad_tiles(tiles, B, H, false)) return (int)cudaErrorInvalidValue;
  const FwdArgs a{static_cast<const bf16*>(gi), {b_ih_f, b_ih_r}, {w_hh_f, w_hh_r},
                  {b_hh_f, b_hh_r}, out, static_cast<bf16*>(gates), static_cast<bf16*>(tiles),
                  B, T, H};
  const size_t smem = smem_bytes(H, false, 6 * 4);
  const int threads = block_threads(H);
  if (H <= 64) return launch(gru_fwd_kernel<4>, a, smem, threads, stream);
  if (H <= RES_MAX_H) return launch(gru_fwd_kernel<8>, a, smem, threads, stream);
  return launch(gru_fwd_kernel<0>, a, smem, threads, stream);
}

// The backward recurrence of both directions: dout (B, T, 2H) f32, out and
// gates the forward's; writes dgi (B, T, 6H), dgh (2, B, T, 3H), hb (2, B,
// T, H), all bf16; carry (2, B, 2, H) f32 scratch, used above RES_MAX_H;
// tiles as the forward's (sept_gru_lowp_tile_elems(B, H, 1)).
int sept_gru_lowp_bwd(const float* dout, const float* out, const void* gates,
                      const float* w_hh_f, const float* w_hh_r, void* dgi, void* dgh, void* hb,
                      float* carry, void* tiles, int B, int T, int H, void* stream) {
  if (bad_shape(B, T, H) || bad_tiles(tiles, B, H, true)) return (int)cudaErrorInvalidValue;
  const BwdArgs a{dout, out, static_cast<const bf16*>(gates), {w_hh_f, w_hh_r},
                  static_cast<bf16*>(dgi), static_cast<bf16*>(dgh), static_cast<bf16*>(hb),
                  carry, static_cast<bf16*>(tiles), B, T, H};
  const size_t smem = smem_bytes(H, true, 4 * 8 + 8 * 4);
  const int threads = block_threads(H);
  if (H <= 64) return launch(gru_bwd_kernel<4>, a, smem, threads, stream);
  if (H <= RES_MAX_H) return launch(gru_bwd_kernel<8>, a, smem, threads, stream);
  return launch(gru_bwd_kernel<0>, a, smem, threads, stream);
}

}  // extern "C"
