// Fused RSSM recurrent step for Hopper (sm_90a), all in fp32, and the
// projection of its model-sharded variant (fp32 or bf16 weights).
//
// Replaces sheeprl_tpu/ops/pallas_gru.py::_kernel, the Pallas TPU body that
// _make_fused_step._forward launches through pl.pallas_call:
//
//   feat = silu(LN(x @ W1 + b1; eps1))
//   proj = LN(h @ W2[:H] + feat @ W2[H:]; eps2)     (no concat, no bias)
//   r, c, u = split(proj, 3);  u = sigmoid(u - 1)
//   h' = u * tanh(sigmoid(r) * c) + (1 - u) * h
//
// Shapes: x[B,X] h[B,H] W1[X,D] b1,g1,be1[D] W2[H+D,3H] g2,be2[3H] -> h'[B,H].
//
// What bounds it on an H100: memory. At Dreamer-V3 S (X=1027, D=512, H=512)
// with B=4 the step must read W1 (2.10 MB) and W2 (6.29 MB) once, about
// 8.45 MB in all, which takes at least 2.5 us at 3.35 TB/s; its ~17 MFLOP
// take about 0.25 us at the 67 TFLOP/s fp32 rate. The weights are far larger
// than one block's 227 KB of shared memory, so unlike the TPU kernel (weights
// resident in VMEM, one grid step per batch tile) this design streams each
// weight matrix through many blocks and keeps every weight byte read once:
//
//   1. splitk_matmul: partial1[s, b, :] = x[b, Ks] @ W1[Ks, :]. Each block
//      owns 128 output columns (one per thread) and 16 batch rows, for one
//      chunk Ks of the depth. The depth is split so that enough blocks are in
//      flight to draw on the card's bandwidth (split_plan, below).
//   2. bias_ln_silu: one block per row sums the split partials in a fixed
//      order, adds b1, takes a two-pass LayerNorm and SiLU -> feat[B, D].
//   3. splitk_matmul again, with W2 read as its two row blocks: the depth
//      index runs over h for k < H and over feat for k >= H.
//   4. ln_gru: one block per row sums the partials, takes the two-pass
//      LayerNorm over all 3H columns and applies the gates -> h'[B, H].
//
// The LayerNorm over 3H spans every column block of launch 3, so the
// cross-block reduction is a second pass (launch 4), never atomics: the
// result is deterministic. No launch has a size limit of its own; any X, D,
// H and B are taken. Making the step fast (wgmma, TMA, one persistent launch)
// is later work; this is the simple design that is right first.
//
// The second entry, sharded_proj_forward, replaces
// sheeprl_tpu/ops/pallas_gru.py::_proj_kernel, the Pallas TPU body that
// _make_sharded_proj._forward launches through pl.pallas_call: one model
// rank's slice of the joint projection of the model-sharded step,
//
//   out[B, C] = h[B, H] @ W2s[:H] + feat[B, D] @ W2s[H:]   (no concat, no bias)
//
// with W2s[H+D, C] (C = 3H/mp, gate-major) at its storage type, fp32 or bf16,
// and fp32 sums.
//
// What bounds it on an H100: memory at the acting batch, arithmetic at the
// imagination batch. It reads W2s once, plus h, feat and out:
//   S, mp=1, fp32 [1024, 1536], B=4:        6.3 MB, >= 1.9 us at 3.35 TB/s;
//   L, mp=4, bf16 [2816, 1536], B=16:       8.9 MB, >= 2.7 us;
//   XL, mp=16, bf16 [5120, 768], B=16:      8.2 MB, >= 2.5 us;
//   XL, mp=1, bf16 [5120, 12288], B=16:     126 MB, >= 37.9 us.
// At B=1024 (16 sequences x 64 imagination steps) L/4 does 8.9 GFLOP, which
// take >= 132 us at the 67 TFLOP/s fp32 rate outside the tensor cores.
//
// With fp32 weights it is launch 3 above templated on the weight type
// (splitk_matmul, planned by the same split_plan), then, when the depth is
// split, a pass that sums the split partials in a fixed order into out
// (sum_splits): no atomics, deterministic like the step.
//
// With bf16 weights (C % 8 == 0 and a 16-byte-aligned W2s) it takes the
// tensor cores instead: proj_tc<BM>, which replaces splitk_matmul<bf16>.
// That kernel read one 2-byte weight per thread per depth step and did 16
// fp32 FMAs a weight on the CUDA cores: at B=1024 it ran at a third of the
// fp32 rate, and at B=16 it kept about 48 KB in flight on the card, so a
// 126 MB slice streamed at 11% of the HBM rate. proj_tc<BM> copies W2s
// tiles [32, 128] and the fp32 activation tiles into a 4-stage shared-memory
// ring with 16-byte cp.async copies (two to three tiles in flight a block)
// and multiplies them on the tensor cores (mma.sync m16n8k16 on ldmatrix
// fragments, bf16 in, fp32 sums), 64 rows a block at B >= 64 and 16 rows a
// block below. The activations are fp32 and the result must stay the fp32
// product of the JAX body (held at 1e-5), so each activation tile is split
// into three bf16 planes, a = a0 + a1 + a2 with a0 = bf16(a),
// a1 = bf16(a - a0), a2 = bf16(a - a0 - a1): 24 significant bits, as many as
// fp32 has. The split of tile t + 1 runs while tile t is multiplied (two
// plane buffers, one barrier a tile). A product ai * w of two bf16 values is
// exact in fp32, so three MMAs a fragment give fp32's accuracy. Each 32-deep
// tile is summed apart and added to a running fp32 sum, as splitk_matmul
// does. The depth is split (split_tiles) to fill the card and the split
// partials are summed by sum_splits: no atomics, two calls give the same
// bits.
//
// What bounds proj_tc: bytes at the acting batch; at B=1024 the three bf16
// passes on the tensor cores, 26.6 GFLOP at L/4, >= 26.9 us at 989 TFLOP/s.
// wgmma from shared-memory descriptors and TMA-fed tiles are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;  // output columns per block: one per thread
constexpr int kRows = 16;   // batch rows per block: accumulators per thread
constexpr int kKTile = 32;  // depth of the activation tile staged in smem
constexpr int kRowThreads = 256;  // threads of the per-row LayerNorm blocks

// A weight read through the read-only cache and upcast to fp32.
__device__ __forceinline__ float load_weight(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_weight(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// partial[s, row, col] = sum over k in [s*k_chunk, (s+1)*k_chunk) of
// a(row, k) * w[k, col], where a(row, k) = a1[row, k] for k < k1 and
// a2[row, k - k1] for k >= k1. W is the weights' storage type.
template <typename W>
__global__ void splitk_matmul(const float* __restrict__ a1, int k1,
                              const float* __restrict__ a2, int k2,
                              const W* __restrict__ w, int n, int rows,
                              int k_chunk, float* __restrict__ partial) {
  __shared__ float a_tile[kRows][kKTile];
  const int col = blockIdx.x * kCols + threadIdx.x;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const int k_begin = split * k_chunk;
  const int k_end = min(k_begin + k_chunk, k1 + k2);

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int kt = k_begin; kt < k_end; kt += kKTile) {
    for (int i = threadIdx.x; i < kRows * kKTile; i += blockDim.x) {
      const int r = i / kKTile;
      const int kk = i % kKTile;
      const int row = row0 + r;
      const int k = kt + kk;
      float v = 0.f;
      if (row < rows && k < k_end) {
        v = (k < k1) ? a1[(size_t)row * k1 + k]
                     : a2[(size_t)row * k2 + (k - k1)];
      }
      a_tile[r][kk] = v;
    }
    __syncthreads();
    if (col < n) {
      const int kmax = min(kKTile, k_end - kt);
      const W* wp = w + (size_t)kt * n + col;
      // sum each tile apart, then add it to the running sum: the rounding
      // error grows with depth / kKTile + kKTile, not with the depth
      float part[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[r] = 0.f;
#pragma unroll 8
      for (int kk = 0; kk < kmax; ++kk) {
        const float wv = load_weight(wp + (size_t)kk * n);
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[r] = fmaf(a_tile[r][kk], wv, part[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += part[r];
    }
    __syncthreads();
  }

  if (col < n) {
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row < rows) partial[((size_t)split * rows + row) * n + col] = acc[r];
    }
  }
}

// Sum of v over the block, the same value returned to every thread, in a
// fixed order. red holds 33 floats of shared memory.
__device__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = (lane < nwarps) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (lane == 0) red[32] = t;
  }
  __syncthreads();
  const float total = red[32];
  __syncthreads();  // red may be reused by the next call
  return total;
}

__device__ __forceinline__ float sigmoid_f(float v) { return 1.f / (1.f + expf(-v)); }

// Sums the split partials of one row into split 0 (in place), in split order,
// adding bias when it is given. Returns this thread's share of the row sum.
__device__ float reduce_splits(float* row_ptr, size_t split_stride, int splits,
                               int n, const float* __restrict__ bias) {
  float s = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float v = row_ptr[j];
    for (int sp = 1; sp < splits; ++sp) v += row_ptr[sp * split_stride + j];
    if (bias != nullptr) v += bias[j];
    row_ptr[j] = v;
    s += v;
  }
  return s;
}

// Two-pass LayerNorm statistics of row_ptr[0:n] (already reduced).
__device__ void row_stats(const float* row_ptr, int n, float eps, float s,
                          float* red, float* mean, float* rstd) {
  const float mu = block_sum(s, red) / n;
  float q = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float dv = row_ptr[j] - mu;
    q += dv * dv;
  }
  *mean = mu;
  *rstd = rsqrtf(block_sum(q, red) / n + eps);
}

__global__ void bias_ln_silu(float* partial, int splits, int rows, int d,
                             const float* __restrict__ b1, const float* __restrict__ g1,
                             const float* __restrict__ be1, float eps,
                             float* __restrict__ feat) {
  __shared__ float red[33];
  const int row = blockIdx.x;
  float* pre = partial + (size_t)row * d;
  const float s = reduce_splits(pre, (size_t)rows * d, splits, d, b1);
  float mean, rstd;
  row_stats(pre, d, eps, s, red, &mean, &rstd);
  for (int j = threadIdx.x; j < d; j += blockDim.x) {
    const float v = (pre[j] - mean) * rstd * g1[j] + be1[j];
    feat[(size_t)row * d + j] = v * sigmoid_f(v);
  }
}

__global__ void ln_gru(float* partial, int splits, int rows, int hidden,
                       const float* __restrict__ g2, const float* __restrict__ be2,
                       float eps, const float* __restrict__ h,
                       float* __restrict__ out) {
  __shared__ float red[33];
  const int row = blockIdx.x;
  const int n = 3 * hidden;
  float* proj = partial + (size_t)row * n;
  const float s = reduce_splits(proj, (size_t)rows * n, splits, n, nullptr);
  float mean, rstd;
  // row_stats synchronises the block, so every thread's reduced columns are
  // visible below although each thread reads columns other threads wrote
  row_stats(proj, n, eps, s, red, &mean, &rstd);
  for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
    const int jc = hidden + j;
    const int ju = 2 * hidden + j;
    const float reset = (proj[j] - mean) * rstd * g2[j] + be2[j];
    const float cand = (proj[jc] - mean) * rstd * g2[jc] + be2[jc];
    const float upd = sigmoid_f((proj[ju] - mean) * rstd * g2[ju] + be2[ju] - 1.f);
    const float c = tanhf(sigmoid_f(reset) * cand);
    const float hv = h[(size_t)row * hidden + j];
    out[(size_t)row * hidden + j] = upd * c + (1.f - upd) * hv;
  }
}

// out[row, col] = sum over s of partial[s, row, col], in split order.
__global__ void sum_splits(const float* __restrict__ partial, int splits,
                           size_t elems, float* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < elems;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = partial[i];
    for (int sp = 1; sp < splits; ++sp) v += partial[sp * elems + i];
    out[i] = v;
  }
}

// ---- the tensor-core route of the sharded projection (bf16 weights) ----

constexpr int kTcCols = 128;           // output columns per block
constexpr int kTcStages = 4;           // depth of the cp.async ring, in 32-deep tiles
constexpr int kWLd = kTcCols + 8;      // bf16 row stride of a staged weight tile
constexpr int kALd = kKTile + 8;       // bf16 row stride of an activation plane
constexpr int kPlanes = 3;             // bf16 planes an fp32 activation is split into

// Shapes of proj_tc<BM>: kWarpRows x kWarpCols warps tile the BM x 128
// block, each warp kFragRows 16-row by kNTiles 8-column fragments of
// mma.m16n8k16 (32 x 32 a warp at BM = 64, 16 x 32 at BM = 16). Shared
// memory: the ring (a weight tile and the raw fp32 activation tile per
// stage), then two buffers of the three bf16 planes (one multiplied while
// the next tile's is split into the other).
template <int BM>
struct TcTile {
  static constexpr int kWarpRows = BM >= 32 ? 2 : 1;
  static constexpr int kWarpCols = 4;
  static constexpr int kThreads = 32 * kWarpRows * kWarpCols;
  static constexpr int kBlocksPerSm = BM >= 32 ? 2 : 4;  // as shared memory allows
  static constexpr int kFragRows = BM / kWarpRows / 16;
  static constexpr int kNTiles = kTcCols / kWarpCols / 8;
  static constexpr size_t kWStage = sizeof(__nv_bfloat16) * kKTile * kWLd;
  static constexpr size_t kAStage = sizeof(float) * BM * kKTile;
  static constexpr size_t kPlane = sizeof(__nv_bfloat16) * BM * kALd;
  static constexpr size_t kSmem = kTcStages * (kWStage + kAStage) + 2 * kPlanes * kPlane;
  static_assert(BM % (16 * kWarpRows) == 0 && kNTiles % 2 == 0, "whole fragments per warp");
  static_assert(kWStage % 128 == 0 && kAStage % 128 == 0 && kPlane % 16 == 0,
                "16-byte copies and ldmatrix rows stay aligned");
  static_assert(BM * kKTile % (4 * kThreads) == 0 && kKTile * kTcCols % (8 * kThreads) == 0,
                "every thread copies and splits the same count");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Asynchronous copies global -> shared; with full false the bytes are
// zero-filled and src is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 bf16 matrices from shared memory, one row address per lane
// (lanes 8m..8m+7 give the rows of matrix m); .trans hands each lane a
// column pair instead of a row pair.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a @ b for one m16n8k16 tile: bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a @ b for one m16n8k16 tile, the sums starting from zero.
__device__ __forceinline__ void mma_bf16_first(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
}

// Two bf16 values packed low (x) to high (y), as they lie in memory.
__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The three bf16 planes of x and y: p0 = bf16(v), p1 = bf16(v - p0),
// p2 = bf16(v - p0 - p1); each difference is exact in fp32.
__device__ __forceinline__ void split3(float x, float y, uint32_t (&p)[kPlanes]) {
  const __nv_bfloat162 p0 = __floats2bfloat162_rn(x, y);
  const float2 f0 = __bfloat1622float2(p0);
  const float rx = x - f0.x, ry = y - f0.y;
  const __nv_bfloat162 p1 = __floats2bfloat162_rn(rx, ry);
  const float2 f1 = __bfloat1622float2(p1);
  p[0] = bf16x2_bits(p0);
  p[1] = bf16x2_bits(p1);
  p[2] = bf16x2_bits(__floats2bfloat162_rn(rx - f1.x, ry - f1.y));
}

// partial[s, row, col] as splitk_matmul computes it, for bf16 w with
// n % 8 == 0 and w 16-byte aligned, on the tensor cores: block tile BM rows
// x 128 columns over the depth chunk s, fp32 activations split into three
// bf16 planes, each 32-deep tile summed apart. a_vec: the activations may be
// copied 16 bytes at a time (k1 and k2 multiples of 4, a1 and a2 16-byte
// aligned).
template <int BM>
__global__ void __launch_bounds__(TcTile<BM>::kThreads, TcTile<BM>::kBlocksPerSm)
    proj_tc(const float* __restrict__ a1, int k1, const float* __restrict__ a2, int k2,
            bool a_vec, const __nv_bfloat16* __restrict__ w, int n, int rows, int k_chunk,
            float* __restrict__ partial) {
  using T = TcTile<BM>;
  constexpr int kThreads = T::kThreads;
  constexpr int FM = T::kFragRows;
  constexpr int NT = T::kNTiles;
  constexpr int kPlaneElems = BM * kALd;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* w_ring = reinterpret_cast<__nv_bfloat16*>(smem);
  float* a_ring = reinterpret_cast<float*>(smem + kTcStages * T::kWStage);
  __nv_bfloat16* planes =
      reinterpret_cast<__nv_bfloat16*>(smem + kTcStages * (T::kWStage + T::kAStage));

  const int col0 = blockIdx.x * kTcCols;
  const int split = blockIdx.y;
  const int row0 = blockIdx.z * BM;
  const int k_begin = split * k_chunk;
  const int k_end = min(k_begin + k_chunk, k1 + k2);
  const int tiles = (k_end - k_begin + kKTile - 1) / kKTile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warp_row = (warp / T::kWarpCols) * FM * 16;
  const int warp_col = (warp % T::kWarpCols) * NT * 8;

  // Each thread copies fixed places of every tile: weight rows
  // w_row + kWRowStep it at columns w_col (16 bytes each), and activation
  // rows a_row + a_row_step it at depth a_k (16 bytes each with a_vec, else
  // 4). Offsets are 32-bit and set up once; a tile moves the sources by
  // 32 rows of w and 32 columns of a1 / a2. Outside the chunk, the batch or
  // the columns a stage is zero-filled (no stale or NaN bytes).
  constexpr int kWCopies = kKTile * (kTcCols / 8) / kThreads;
  constexpr int kWRowStep = kThreads / (kTcCols / 8);
  constexpr int kAVecCopies = BM * kKTile / 4 / kThreads;
  constexpr int kACopies = BM * kKTile / kThreads;
  const int w_row = threadIdx.x / (kTcCols / 8);
  const int w_col = (threadIdx.x % (kTcCols / 8)) * 8;
  const bool w_col_in = col0 + w_col < n;
  const __nv_bfloat16* w_src = w + (size_t)(k_begin + w_row) * n + col0 + w_col;
  const int a_width = a_vec ? 4 : 1;
  const int a_row_step = kThreads * a_width / kKTile;
  const int a_row = threadIdx.x * a_width / kKTile;
  const int a_k = threadIdx.x * a_width % kKTile;
  auto load_tile = [&](int t) {
    const int stage = t % kTcStages;
    const int kt = k_begin + t * kKTile;
    __nv_bfloat16* ws = w_ring + stage * (kKTile * kWLd) + w_row * kWLd + w_col;
    const __nv_bfloat16* wsrc = w_src + (size_t)t * kKTile * n;
#pragma unroll
    for (int it = 0; it < kWCopies; ++it) {
      const bool in = w_col_in && kt + w_row + kWRowStep * it < k_end;
      cp_async16(ws + kWRowStep * it * kWLd, in ? wsrc + kWRowStep * it * n : w, in);
    }
    float* as = a_ring + stage * (BM * kKTile) + a_row * kKTile + a_k;
    const int k = kt + a_k;
    const bool k_in = k < k_end;
    const float* src = k < k1 ? a1 + k : a2 + (k - k1);
    const int ld = k < k1 ? k1 : k2;
    const int copies = a_vec ? kAVecCopies : kACopies;
#pragma unroll
    for (int it = 0; it < kACopies; ++it) {
      if (it < copies) {
        const int r = row0 + a_row + a_row_step * it;
        const bool in = k_in && r < rows;
        const float* from = in ? src + r * ld : a1;
        if (a_vec) {  // a 4-group never straddles k1 or k_end then
          cp_async16(as + a_row_step * it * kKTile, from, in);
        } else {
          cp_async4(as + a_row_step * it * kKTile, from, in);
        }
      }
    }
  };

  // the raw activations of tile t into plane buffer t % 2, four at a time
  constexpr int kSplits = BM * kKTile / 4 / kThreads;
  constexpr int kSplitRowStep = kThreads * 4 / kKTile;
  const int s_row = threadIdx.x * 4 / kKTile;
  const int s_k = threadIdx.x * 4 % kKTile;
  auto split_tile = [&](int t) {
    const float* as = a_ring + (t % kTcStages) * (BM * kKTile) + s_row * kKTile + s_k;
    __nv_bfloat16* pl = planes + (t % 2) * (kPlanes * kPlaneElems) + s_row * kALd + s_k;
#pragma unroll
    for (int it = 0; it < kSplits; ++it) {
      const float4 v = *reinterpret_cast<const float4*>(as + it * kSplitRowStep * kKTile);
      uint32_t lo[kPlanes], hi[kPlanes];
      split3(v.x, v.y, lo);
      split3(v.z, v.w, hi);
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        *reinterpret_cast<uint2*>(pl + p * kPlaneElems + it * kSplitRowStep * kALd) =
            make_uint2(lo[p], hi[p]);
      }
    }
  };

  float acc[FM][NT][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // one commit group per tile, empty past the chunk, so that the group count
  // says which tiles have landed
#pragma unroll
  for (int t = 0; t < kTcStages - 1; ++t) {
    if (t < tiles) load_tile(t);
    cp_async_commit();
  }
  cp_async_wait<kTcStages - 2>();  // tile 0
  __syncthreads();
  split_tile(0);

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait<kTcStages - 3>();  // tile t + 1
    // planes of tile t and tile t + 1's copies are visible to all; every
    // warp is done with tile t - 1, so its stage may be refilled
    __syncthreads();
    if (t + kTcStages - 1 < tiles) load_tile(t + kTcStages - 1);
    cp_async_commit();
    if (t + 1 < tiles) split_tile(t + 1);

    const __nv_bfloat16* ws = w_ring + (t % kTcStages) * (kKTile * kWLd);
    const __nv_bfloat16* pl = planes + (t % 2) * (kPlanes * kPlaneElems);
    float part[FM][NT][4];  // the tile's sums, begun by its first MMA
#pragma unroll
    for (int ks = 0; ks < kKTile; ks += 16) {
      // B fragments of two 8-column tiles per ldmatrix: matrices (k 0-7,
      // n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
      uint32_t b[NT / 2][4];
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        const int k = ks + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = warp_col + j * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(b[j], ws + k * kWLd + c);
      }
#pragma unroll
      for (int i = 0; i < FM; ++i) {
        const int r = warp_row + i * 16 + (lane & 15);
        const int k = ks + (lane >> 4) * 8;
#pragma unroll
        for (int p = kPlanes - 1; p >= 0; --p) {  // smallest plane first
          uint32_t a[4];
          ldmatrix_x4(a, pl + p * kPlaneElems + r * kALd + k);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            const uint32_t b0 = b[j / 2][(j % 2) * 2], b1 = b[j / 2][(j % 2) * 2 + 1];
            if (ks == 0 && p == kPlanes - 1) {
              mma_bf16_first(part[i][j], a, b0, b1);
            } else {
              mma_bf16(part[i][j], a, b0, b1);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();

  // accumulator (e0, e1) at row lane / 4, columns 2 (lane % 4) + {0, 1};
  // (e2, e3) eight rows below. n % 8 == 0, so a pair is in or out whole.
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int col = col0 + warp_col + j * 8 + (lane & 3) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + warp_row + i * 16 + (lane >> 2) + h * 8;
        if (row < rows && col < n) {
          *reinterpret_cast<float2*>(partial + ((size_t)split * rows + row) * n + col) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
      }
    }
}

constexpr int kBlocksPerSm = 2;  // blocks in flight per SM that the split aims for

// (splits, chunk) of the depth for a launch of `blocks` blocks a depth chunk:
// enough blocks to give every SM per_sm, no chunk shorter than min_tiles
// staged tiles, and each chunk a whole number of tiles.
int split_tiles(int depth, int blocks, int per_sm, int min_tiles, int sm_count, int* chunk) {
  const int min_chunk = min_tiles * kKTile;
  const int max_splits = (depth + min_chunk - 1) / min_chunk;
  int want = (per_sm * sm_count) / blocks;
  if (want < 1) want = 1;
  const int splits = want < max_splits ? want : max_splits;
  int c = (depth + splits - 1) / splits;
  c = (c + kKTile - 1) / kKTile * kKTile;
  *chunk = c;
  return (depth + c - 1) / c;
}

// The depth split of one splitk_matmul launch over rows x cols.
int split_plan(int depth, int cols, int rows, int sm_count, int* chunk) {
  const int blocks = ((cols + kCols - 1) / kCols) * ((rows + kRows - 1) / kRows);
  return split_tiles(depth, blocks, kBlocksPerSm, 1, sm_count, chunk);
}

// The launch plan of one step on the current device, and where its three
// scratch arrays lie in the one scratch buffer: partial1[split1, B, D],
// feat[B, D], partial2[split2, B, 3H].
struct Plan {
  int split1, chunk1, split2, chunk2;
  size_t feat_offset, partial2_offset, floats;
};

// SM count of the current device.
cudaError_t current_sm_count(int* sm_count) {
  int device;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, device);
}

cudaError_t make_plan(int batch, int in_dim, int dense, int hidden, Plan* p) {
  int sm_count;
  const cudaError_t err = current_sm_count(&sm_count);
  if (err != cudaSuccess) return err;
  p->split1 = split_plan(in_dim, dense, batch, sm_count, &p->chunk1);
  p->split2 = split_plan(hidden + dense, 3 * hidden, batch, sm_count, &p->chunk2);
  p->feat_offset = (size_t)p->split1 * batch * dense;
  p->partial2_offset = p->feat_offset + (size_t)batch * dense;
  p->floats = p->partial2_offset + (size_t)p->split2 * batch * 3 * hidden;
  return cudaSuccess;
}

// Routes of the sharded projection: splitk_matmul on the CUDA cores (fp32
// weights, and bf16 weights the tensor-core copies cannot take), or
// proj_tc<16> / proj_tc<64> on the tensor cores. The numbers are the C ABI's.
constexpr int kRouteSplitK = 0;
constexpr int kRouteTc16 = 1;
constexpr int kRouteTc64 = 2;
constexpr int kTcWideBatch = 64;  // B from which proj_tc takes 64 rows a block
constexpr size_t kSmemPerSm = 227 * 1024;  // shared memory the blocks of one SM may hold
static_assert(TcTile<16>::kBlocksPerSm * TcTile<16>::kSmem <= kSmemPerSm &&
                  TcTile<64>::kBlocksPerSm * TcTile<64>::kSmem <= kSmemPerSm,
              "the blocks the split plans for fit an SM's shared memory");

// The plan of one sharded projection: its route, the depth split and the
// scratch of the split partials (partial[splits, B, C]; none when the depth
// is not split, as the kernel then writes out directly). The tensor-core
// route needs 16-byte weight copies (C % 8 == 0, W2s 16-byte aligned) and
// activation offsets within 32 bits; its split aims for as many blocks on
// each SM as their shared memory allows (4 of proj_tc<16>, 2 of
// proj_tc<64>) and keeps each chunk at least as deep as the ring.
struct ProjPlan {
  int route, splits, chunk;
  size_t floats;
};

ProjPlan plan_proj(int batch, int hidden, int dense, int cols, bool bf16, const void* w2s,
                   int sm_count) {
  ProjPlan p;
  const int depth = hidden + dense;
  const bool tc = bf16 && cols % 8 == 0 && (reinterpret_cast<uintptr_t>(w2s) & 15) == 0 &&
                  (long long)batch * (hidden > dense ? hidden : dense) <= INT_MAX;
  if (!tc) {
    p.route = kRouteSplitK;
    p.splits = split_plan(depth, cols, batch, sm_count, &p.chunk);
  } else {
    const bool wide = batch >= kTcWideBatch;
    const int bm = wide ? 64 : 16;
    const int per_sm = wide ? TcTile<64>::kBlocksPerSm : TcTile<16>::kBlocksPerSm;
    const int blocks = ((cols + kTcCols - 1) / kTcCols) * ((batch + bm - 1) / bm);
    p.route = wide ? kRouteTc64 : kRouteTc16;
    p.splits = split_tiles(depth, blocks, per_sm, kTcStages, sm_count, &p.chunk);
  }
  p.floats = p.splits > 1 ? (size_t)p.splits * batch * cols : 0;
  return p;
}

template <int BM>
cudaError_t launch_tc(const float* h, const float* feat, const __nv_bfloat16* w2s,
                      float* partial, int batch, int hidden, int dense, int cols,
                      const ProjPlan& p, cudaStream_t stream) {
  constexpr int smem = (int)TcTile<BM>::kSmem;
  const cudaError_t err =
      cudaFuncSetAttribute(proj_tc<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const bool a_vec = hidden % 4 == 0 && dense % 4 == 0 &&
                     ((reinterpret_cast<uintptr_t>(h) | reinterpret_cast<uintptr_t>(feat)) & 15) == 0;
  dim3 grid((cols + kTcCols - 1) / kTcCols, p.splits, (batch + BM - 1) / BM);
  proj_tc<BM><<<grid, TcTile<BM>::kThreads, smem, stream>>>(h, hidden, feat, dense, a_vec, w2s, cols,
                                                   batch, p.chunk, partial);
  return cudaGetLastError();
}

cudaError_t launch_proj(const float* h, const float* feat, const void* w2s, bool bf16,
                        float* out, float* scratch, int batch, int hidden, int dense, int cols,
                        const ProjPlan& p, cudaStream_t stream) {
  float* partial = p.splits > 1 ? scratch : out;
  const auto* w_bf16 = static_cast<const __nv_bfloat16*>(w2s);
  cudaError_t err;
  if (p.route == kRouteTc64) {
    err = launch_tc<64>(h, feat, w_bf16, partial, batch, hidden, dense, cols, p, stream);
  } else if (p.route == kRouteTc16) {
    err = launch_tc<16>(h, feat, w_bf16, partial, batch, hidden, dense, cols, p, stream);
  } else {
    dim3 grid((cols + kCols - 1) / kCols, p.splits, (batch + kRows - 1) / kRows);
    if (bf16) {
      splitk_matmul<__nv_bfloat16><<<grid, kCols, 0, stream>>>(h, hidden, feat, dense, w_bf16,
                                                               cols, batch, p.chunk, partial);
    } else {
      splitk_matmul<float><<<grid, kCols, 0, stream>>>(h, hidden, feat, dense,
                                                       static_cast<const float*>(w2s), cols,
                                                       batch, p.chunk, partial);
    }
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || p.splits == 1) return err;
  const size_t elems = (size_t)batch * cols;
  const int blocks = (int)((elems + kRowThreads - 1) / kRowThreads);
  sum_splits<<<blocks, kRowThreads, 0, stream>>>(partial, p.splits, elems, out);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch that fused_gru_forward needs for these sizes on the
// current device, written to *floats; returns a CUDA error code (0 = success).
extern "C" int fused_gru_scratch_floats(int batch, int in_dim, int dense, int hidden,
                                        long long* floats) {
  Plan p;
  const cudaError_t err = make_plan(batch, in_dim, dense, hidden, &p);
  if (err == cudaSuccess) *floats = (long long)p.floats;
  return (int)err;
}

// The depth split of one projection (splits returned, chunk in *chunk), for
// a given SM count: the plan fused_gru_forward follows, open to tests.
extern "C" int fused_gru_split_plan(int depth, int cols, int rows, int sm_count, int* chunk) {
  return split_plan(depth, cols, rows, sm_count, chunk);
}

// Launches the four kernels of one step on `stream` and returns
// cudaGetLastError() (0 on success). scratch holds fused_gru_scratch_floats()
// floats; the caller allocates it and out.
extern "C" int fused_gru_forward(const float* x, const float* h, const float* w1,
                                 const float* b1, const float* g1, const float* be1,
                                 const float* w2, const float* g2, const float* be2,
                                 float* out, float* scratch,
                                 int batch, int in_dim, int dense, int hidden,
                                 float eps1, float eps2, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Plan p;
  cudaError_t err = make_plan(batch, in_dim, dense, hidden, &p);
  if (err != cudaSuccess) return (int)err;
  float* partial1 = scratch;
  float* feat = scratch + p.feat_offset;
  float* partial2 = scratch + p.partial2_offset;
  const int row_tiles = (batch + kRows - 1) / kRows;

  dim3 grid1((dense + kCols - 1) / kCols, p.split1, row_tiles);
  splitk_matmul<float><<<grid1, kCols, 0, stream>>>(x, in_dim, nullptr, 0, w1, dense, batch,
                                             p.chunk1, partial1);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  bias_ln_silu<<<batch, kRowThreads, 0, stream>>>(partial1, p.split1, batch, dense, b1, g1,
                                                 be1, eps1, feat);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  dim3 grid2((3 * hidden + kCols - 1) / kCols, p.split2, row_tiles);
  splitk_matmul<float><<<grid2, kCols, 0, stream>>>(h, hidden, feat, dense, w2, 3 * hidden, batch,
                                             p.chunk2, partial2);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  ln_gru<<<batch, kRowThreads, 0, stream>>>(partial2, p.split2, batch, hidden, g2, be2, eps2,
                                           h, out);
  return (int)cudaGetLastError();
}

// The plan sharded_proj_forward follows for these sizes and this w2s
// (w2s_bf16 = 1 for bf16 storage), on a card of sm_count SMs (the current
// device's when sm_count <= 0): its route (kRouteSplitK, kRouteTc16 or
// kRouteTc64), depth split and chunk, and the floats of scratch it needs.
// Returns a CUDA error code (0 = success).
extern "C" int sharded_proj_plan(int batch, int hidden, int dense, int cols, int w2s_bf16,
                                 const void* w2s, int sm_count, int* route, int* splits,
                                 int* chunk, long long* floats) {
  if (sm_count <= 0) {
    const cudaError_t err = current_sm_count(&sm_count);
    if (err != cudaSuccess) return (int)err;
  }
  const ProjPlan p = plan_proj(batch, hidden, dense, cols, w2s_bf16 != 0, w2s, sm_count);
  *route = p.route;
  *splits = p.splits;
  *chunk = p.chunk;
  *floats = (long long)p.floats;
  return 0;
}

// out[B, C] = h[B, H] @ w2s[:H] + feat[B, D] @ w2s[H:], w2s[H+D, C] fp32
// (w2s_bf16 = 0) or bf16 (w2s_bf16 = 1), on `stream`. Launches one or two
// kernels and returns cudaGetLastError() (0 on success). scratch holds the
// floats sharded_proj_plan() gives; the caller allocates it and out.
extern "C" int sharded_proj_forward(const float* h, const float* feat, const void* w2s,
                                    int w2s_bf16, float* out, float* scratch, int batch,
                                    int hidden, int dense, int cols, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int sm_count;
  const cudaError_t err = current_sm_count(&sm_count);
  if (err != cudaSuccess) return (int)err;
  const ProjPlan p = plan_proj(batch, hidden, dense, cols, w2s_bf16 != 0, w2s, sm_count);
  return (int)launch_proj(h, feat, w2s, w2s_bf16 != 0, out, scratch, batch, hidden, dense, cols,
                          p, stream);
}

// Error text for a code returned above.
extern "C" const char* fused_gru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
