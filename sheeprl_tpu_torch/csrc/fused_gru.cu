// Fused RSSM recurrent step for Hopper (sm_90a), computing in fp32 from an
// fp32 or bf16 x, and the projection of its model-sharded variant (fp32 or
// bf16 weights).
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
// x is fp32 or, under bf16-mixed, bf16: launch A reads it in its own type and
// upcasts it as it stages it (the TPU body's x_ref[:].astype(f32)), so no
// cast runs before the kernel; everything after the staging is fp32.
//
// What bounds it on an H100: memory at the acting batch. At Dreamer-V3 S
// (X=1027, D=512, H=512) with B=4 the step must read W1 (2.10 MB) and W2
// (6.29 MB) once, about 8.45 MB in all, which takes at least 2.5 us at
// 3.35 TB/s; its ~17 MFLOP take about 0.25 us at the 67 TFLOP/s fp32 rate
// (at B=1024 the 4.3 GFLOP take 64 us and bound it instead). The weights are
// far larger than one block's 227 KB of shared memory, so unlike the TPU
// kernel (weights resident in VMEM, one grid step per batch tile) this
// design streams each weight matrix through many blocks and reads every
// weight byte once. Two launches of gru_step:
//
//   A. x @ W1 + b1 and h @ W2[:H], the two products that need nothing from
//      this step, in one grid (5.25 MB of weights at S), each reduced with
//      the LayerNorm statistics of its column tiles.
//   B. a programmatic dependent launch: its blocks start while launch A
//      runs and load their first weights, then wait for launch A
//      (griddepcontrol.wait). feat @ W2[H:] (3.15 MB), with
//      feat = SiLU(LN1(x @ W1 + b1)) computed as each block stages it, added
//      to h @ W2[:H]; then LN2 over all 3H columns and the gates -> h'[B, H].
//
// A block takes one work item (product, row tile of R = 4, 8 or 16 batch
// rows, 128-column tile, depth chunk). Each thread owns 4 adjacent columns
// and reads them with one 16-byte load a depth row (masked scalar loads
// where the columns are not a multiple of 4 or the rows not 16-byte
// aligned); the 8 warps take interleaved depth rows of each step, a step
// being 32 / R loads a thread deep, and the next step's loads are in flight
// while a step is computed. The warps' sums are added in shared memory in
// warp order. The depth chunks of a tile are the blocks of one thread-block
// cluster (make_step_plan: up to 8, as many as let all of a launch's blocks
// fit the card at once, 2 an SM): after the cluster barrier's arrive and
// wait, rank q sums rows q, q + C, ... of the tile over the ranks' shared
// memory (distributed shared memory) in rank order, adds b1 or launch A's
// h @ W2[:H], stores the reduced tile and, per row, the tile's two-pass
// statistics (the sum, then the second moment about the tile's own mean,
// each over one warp). No split partial goes through global memory.
//
// LayerNorm statistics of a row combine its tiles' pairs in tile order:
// the mean, then sum_t [M2_t + n_t (mean_t - mean)^2], which is the row's
// centred second moment. LN1's are taken by every block of launch B for
// its rows, so launch A has no row work. LN2's need every column tile of
// launch B: each block bumps its row tile's counter with an acquire-release
// atomic once its stores are done, and the last to arrive does the row work
// (LN2 and the gates, every thread of the block on its own columns of all
// the tile's rows). Launch A zeroes the counters, so a step is two graph
// nodes. No sum depends on arrival order (ranks and tiles are summed in
// their own order, counters decide only who works), so two calls give the
// same bits. No launch has a size limit of its own; any X, D, H and B are
// taken.
//
// What holds it above its bound at the acting batch (chip_smoke.py phase 2
// and PERF.md): not the bytes but the chain of dependent steps in each
// launch, each a round trip of L2 latency or a barrier: the weight steps of
// the deepest chunk (x @ W1: 1027 rows over 8 ranks), the cluster barrier,
// the LN1 statistics and the counter, and LN2 with the gates on one block.
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
// With fp32 weights it is splitk_matmul (below), a split-depth product
// templated on the weight type and planned by split_plan, then, when the depth is
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kCols = 128;  // output columns per block: one per thread
constexpr int kRows = 16;   // batch rows per block: accumulators per thread
constexpr int kKTile = 32;  // depth of the activation tile staged in smem
constexpr int kRowThreads = 256;  // threads of a sum_splits block

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

// ---- the fused step (B1): two launches of gru_step ----

constexpr int kStepThreads = 256;                     // 8 warps a block
constexpr int kStepWarps = kStepThreads / 32;
constexpr int kStepCols = 128;                        // output columns a block: 4 a lane
constexpr int kStepDepth = 32;                        // depth chunks are whole multiples of this
constexpr int kStepStaged = 256;                      // activations a block stages per step
constexpr int kStepBlocksPerSm = 2;                   // as registers allow (launch bounds)
constexpr int kMaxCluster = 8;   // depth splits of a tile, the blocks of one cluster (portable)
constexpr int kGateCols = 2;     // columns a thread takes at once in the gates
constexpr int kGateRows = 4;     // rows a thread takes at once in the gates
static_assert(kStepBlocksPerSm * sizeof(float) * (kStepWarps * 16 * kStepCols + kStepStaged) <= 227 * 1024,
              "two blocks of the widest row tile fit an SM's shared memory");

// One product a[rows, depth] @ w[depth, n] of a launch: its tiles, depth
// chunk and where its sums go. Scratch rows (out) have ld = n rounded up to
// 4 floats, so every scratch row is 16-byte aligned.
struct StepProduct {
  const float* a;
  int lda;
  const float* w;
  int n, depth;
  int vec;                         // w rows 16-byte aligned: float4 loads, else masked scalars
  int col_tiles, chunk, blocks;    // blocks = row tiles x col_tiles x the launch's cluster
  float* out;                      // the reduced sums [rows, ld]
  int ld;
  const float* bias;               // added to the reduced sums (b1), or null
  float2* stats;                   // [rows, col_tiles]: each tile's (sum, centred M2) of a row, or null
  const __nv_bfloat16* a16;        // launch A's bf16 x, read in place of a and upcast, or null
};

// A LayerNorm: the (sum, centred M2) pairs of a row's column tiles, its
// width, gain, bias and eps.
struct StepNorm {
  const float2* stats;
  int col_tiles, n;
  const float* g;
  const float* be;
  float eps;
};

// One launch. Stage 0 (launch A): prod[0] = x @ W1 + b1 and prod[1] =
// h @ W2[:H], each reduced with its tiles' statistics; it also zeroes launch
// B's row counters. Stage 1 (launch B): prod[0] = feat @ W2[H:] added to
// launch A's h @ W2[:H], with feat = SiLU(LN1(x @ W1 + b1)) taken as the
// activations are staged (norm1); then, by the last block to finish a row
// tile, LN2 over all 3H columns (norm2) and the gates -> h_out.
struct StepLaunch {
  StepProduct prod[2];
  int rows, cluster;
  unsigned* row_count;             // [row tiles]: blocks of launch B finished
  int row_tiles;
  StepNorm norm1, norm2;
  const float* h;
  float* h_out;
  int hidden;
};

// Activation (row, k) of a launch A product: the bf16 x upcast to fp32, or
// the fp32 a (x or h), through the read-only cache.
__device__ __forceinline__ float load_act_a(const StepProduct& P, int row, int k) {
  const size_t i = (size_t)row * P.lda + k;
  return P.a16 != nullptr ? load_weight(P.a16 + i) : __ldg(P.a + i);
}

// Four adjacent weights of row w_row from column col: one 16-byte load when
// the rows are aligned, else four masked scalar loads; zero past n.
__device__ __forceinline__ float4 load_w4(const float* w_row, int n, int col, int vec) {
  if (vec) {
    return col < n ? __ldg(reinterpret_cast<const float4*>(w_row + col)) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float4 v;
  v.x = col < n ? __ldg(w_row + col) : 0.f;
  v.y = col + 1 < n ? __ldg(w_row + col + 1) : 0.f;
  v.z = col + 2 < n ? __ldg(w_row + col + 2) : 0.f;
  v.w = col + 3 < n ? __ldg(w_row + col + 3) : 0.f;
  return v;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The two halves of a cluster barrier, by every thread of every block of
// the cluster: the arrive (releasing this block's shared-memory stores to
// the cluster, or relaxed), and the wait (acquiring the other blocks').
__device__ __forceinline__ void cluster_arrive(bool release) {
  if (release) {
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  } else {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  }
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Sum over the warp, the same value in every lane, in a fixed order.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Thread 0 bumps *count; every thread learns whether that was the last of
// `total`. The bump is an acquire-release atomic at device scope: the
// barrier before it orders every thread's earlier stores before it, and
// release is cumulative, so the last block sees every block's stores (the
// pattern of cooperative groups' grid sync); the barrier after it orders
// the last block's reads after its acquire.
__device__ __forceinline__ bool last_to_arrive(unsigned* count, int total, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned prev;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(prev) : "l"(count) : "memory");
    *flag = prev == (unsigned)(total - 1);
  }
  __syncthreads();
  return *flag;
}

// The LayerNorm statistics of rows row0 .. row0 + rows - 1 into mean_s and
// rstd_s, one warp a row, from their column tiles' (sum, centred M2) pairs
// combined in tile order: the mean, then the row's centred second moment as
// sum_t [M2_t + n_t (mean_t - mean)^2], which equals sum_j (v_j - mean)^2.
// The pairs were written by other blocks: read through L2 (__ldcg), never
// from a stale L1 line. The caller synchronises the block before use.
__device__ void row_stats(const StepNorm& N, int row0, int rows, float* mean_s, float* rstd_s) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < rows; r += kStepWarps) {
    const float2* st = N.stats + (size_t)(row0 + r) * N.col_tiles;
    const float2 first = lane < N.col_tiles ? __ldcg(st + lane) : make_float2(0.f, 0.f);
    float s = first.x;
    for (int t = lane + 32; t < N.col_tiles; t += 32) s += __ldcg(st + t).x;
    const float mu = warp_sum(s) / N.n;
    auto centred = [&](float2 p, int t) {
      const int nt = min(kStepCols, N.n - t * kStepCols);
      const float d = p.x / nt - mu;
      return p.y + nt * d * d;
    };
    float q = lane < N.col_tiles ? centred(first, lane) : 0.f;
    for (int t = lane + 32; t < N.col_tiles; t += 32) q += centred(__ldcg(st + t), t);
    q = warp_sum(q);
    if (lane == 0) {
      mean_s[r] = mu;
      rstd_s[r] = rsqrtf(q / N.n + N.eps);
    }
  }
}

// What the reduced sums of the 4-column group col of a row add to
// themselves: b1 in launch A (prod[0]), launch A's h @ W2[:H] in launch B.
// Loaded before the sums are, as it does not depend on them.
template <int kStage>
__device__ __forceinline__ float4 group_addend(const StepProduct& P, int row, int col, bool in) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!in) return a;
  if (kStage == 1) return __ldcg(reinterpret_cast<const float4*>(P.out + (size_t)row * P.ld + col));
  if (P.bias != nullptr) {
    a.x = __ldg(P.bias + col);
    a.y = col + 1 < P.n ? __ldg(P.bias + col + 1) : 0.f;
    a.z = col + 2 < P.n ? __ldg(P.bias + col + 2) : 0.f;
    a.w = col + 3 < P.n ? __ldg(P.bias + col + 3) : 0.f;
  }
  return a;
}

// The reduced sums v of the 4-column group col of one row of a tile (the
// addend added), called by every lane of the warp that owns the row: stores
// the group and, where the product feeds a LayerNorm, the tile's (sum,
// centred second moment) of the row, each a two-pass sum over the warp.
__device__ void finish_group(const StepLaunch& L, const StepProduct& P, int ct, int row, int col, float4 v) {
  if (row >= L.rows) return;  // warp-uniform
  if (col < P.ld) *reinterpret_cast<float4*>(P.out + (size_t)row * P.ld + col) = v;
  if (P.stats == nullptr) return;
  const int nt = min(kStepCols, P.n - ct * kStepCols);
  const float e[4] = {v.x, v.y, v.z, v.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) s += col + i < P.n ? e[i] : 0.f;
  s = warp_sum(s);
  const float m = s / nt;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) q += col + i < P.n ? (e[i] - m) * (e[i] - m) : 0.f;
  q = warp_sum(q);
  if ((threadIdx.x & 31) == 0) P.stats[(size_t)row * P.col_tiles + ct] = make_float2(s, q);
}

// The step's activations from the fast exponential and reciprocal (a few
// ulps; the step is held to 1e-5): sigmoid, and tanh as 1 - 2 / (e^2v + 1),
// exact to an absolute 1e-6 and saturating to +-1.
__device__ __forceinline__ float sigmoid_f(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }
__device__ __forceinline__ float tanh_f(float v) { return 1.f - __fdividef(2.f, __expf(2.f * v) + 1.f); }

// The row work of launch B for a row tile, by the whole block: LN2 over
// r | c | u and the gates -> h'. Thread t takes columns j = t, t + 256, ...
// of every row, kGateCols columns and kGateRows rows at a time, so g2, be2
// are loaded once a column for all rows; the first batch's loads are issued
// before the statistics are combined.
template <int R>
__device__ void ln2_gates(const StepLaunch& L, const StepProduct& P, int row0, float* __restrict__ mean_s,
                          float* __restrict__ rstd_s) {
  const int rows = min(R, L.rows - row0);
  const int H = L.hidden;
  const StepNorm& N = L.norm2;
  float g[kGateCols][3], b[kGateCols][3];
  float p[kGateRows][kGateCols][3], hv[kGateRows][kGateCols];
  auto load_cols = [&](int j0) {
#pragma unroll
    for (int c = 0; c < kGateCols; ++c) {
      const int j = min(j0 + kStepThreads * c, H - 1);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g[c][k] = __ldg(N.g + k * H + j);
        b[c][k] = __ldg(N.be + k * H + j);
      }
    }
  };
  auto load_rows = [&](int j0, int r0) {
#pragma unroll
    for (int r = 0; r < kGateRows; ++r) {
      const int row = row0 + min(r0 + r, rows - 1);
      const float* v = P.out + (size_t)row * P.ld;
#pragma unroll
      for (int c = 0; c < kGateCols; ++c) {
        const int j = min(j0 + kStepThreads * c, H - 1);
#pragma unroll
        for (int k = 0; k < 3; ++k) p[r][c][k] = __ldcg(v + k * H + j);
        hv[r][c] = __ldg(L.h + (size_t)row * H + j);
      }
    }
  };
  // the batch's statistics are read, and its results computed, before any
  // is stored: no store to h' can then hold up a load
  auto apply = [&](int j0, int r0) {
    float mean[kGateRows], rstd[kGateRows], y[kGateRows][kGateCols];
#pragma unroll
    for (int r = 0; r < kGateRows; ++r) {
      mean[r] = mean_s[min(r0 + r, rows - 1)];
      rstd[r] = rstd_s[min(r0 + r, rows - 1)];
    }
#pragma unroll
    for (int r = 0; r < kGateRows; ++r) {
#pragma unroll
      for (int c = 0; c < kGateCols; ++c) {
        const float reset = (p[r][c][0] - mean[r]) * rstd[r] * g[c][0] + b[c][0];
        const float cand = (p[r][c][1] - mean[r]) * rstd[r] * g[c][1] + b[c][1];
        const float upd = sigmoid_f((p[r][c][2] - mean[r]) * rstd[r] * g[c][2] + b[c][2] - 1.f);
        const float cv = tanh_f(sigmoid_f(reset) * cand);
        y[r][c] = upd * cv + (1.f - upd) * hv[r][c];
      }
    }
#pragma unroll
    for (int r = 0; r < kGateRows; ++r) {
      if (r0 + r >= rows) break;
      float* out = L.h_out + (size_t)(row0 + r0 + r) * H;
#pragma unroll
      for (int c = 0; c < kGateCols; ++c) {
        if (j0 + kStepThreads * c < H) out[j0 + kStepThreads * c] = y[r][c];
      }
    }
  };
  const int j_first = threadIdx.x;
  load_cols(j_first);
  load_rows(j_first, 0);
  row_stats(N, row0, rows, mean_s, rstd_s);
  __syncthreads();
  for (int j0 = j_first; j0 < H; j0 += kStepThreads * kGateCols) {
    if (j0 != j_first) load_cols(j0);
    for (int r0 = 0; r0 < rows; r0 += kGateRows) {
      if (j0 != j_first || r0 != 0) load_rows(j0, r0);
      apply(j0, r0);
    }
  }
}

// One work item (product, row tile, column tile, depth chunk) a block; the
// depth chunks of a tile are the blocks of one cluster. R is the row tile
// (4, 8 or 16 batch rows). Dynamic shared memory: the warps' sums
// red[warp][R][128] (the block's partial tile ends in red[0]), then the
// staged activations a_s[kDepth][R].
template <int R, int kStage>
__global__ void __launch_bounds__(kStepThreads, kStepBlocksPerSm)
    gru_step(const __grid_constant__ StepLaunch L) {
  extern __shared__ __align__(16) float step_smem[];
  float* red = step_smem;
  float* a_s = step_smem + kStepWarps * R * kStepCols;
  __shared__ int flag;
  __shared__ float row_mean[R], row_rstd[R];
  cg::cluster_group cluster = cg::this_cluster();

  // launch B may start as soon as every block of launch A has (programmatic
  // dependent launch): its blocks load their first weights while launch A
  // runs, and wait for launch A's results before they stage feat
  if (kStage == 0) {
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    if (blockIdx.x == 0) {
      for (int i = threadIdx.x; i < L.row_tiles; i += kStepThreads) L.row_count[i] = 0;
    }
  }
  int item = blockIdx.x;
  const int pi = item < L.prod[0].blocks ? 0 : 1;
  const StepProduct& P = L.prod[pi];
  if (pi == 1) item -= L.prod[0].blocks;
  const int C = L.cluster;
  const int split = item % C;  // the block's rank in its cluster
  const int tile = item / C;
  const int ct = tile % P.col_tiles;
  const int rt = tile / P.col_tiles;
  const int row0 = rt * R;
  const int col0 = ct * kStepCols;
  const int k_begin = split * P.chunk;
  const int k_end = min(k_begin + P.chunk, P.depth);  // empty for a trailing rank of a short product
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int col = col0 + 4 * lane;

  // Each lane owns 4 adjacent columns; warp w takes depth rows w, w + 8,
  // w + 16, ... of each step (8 warps read 8 adjacent weight rows at a time,
  // 512 bytes a warp). A step is kLoads = 32 / R 16-byte loads a thread
  // deep (64 depth rows at R = 4, 16 at R = 16), and the next step's loads
  // are in flight while a step is computed, so weights and accumulators take
  // the same registers at every R. Thread t stages activation t of the
  // step's R x kDepth.
  constexpr int kLoads = 32 / R;
  constexpr int kDepth = kStepWarps * kLoads;
  constexpr int kStaged = R * kDepth / kStepThreads;
  static_assert(R * kDepth == kStepStaged, "a step stages kStepStaged activations");
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;

  // a step's weights and activations, loaded into registers
  auto load_weights = [&](int kt, float4(&w)[kLoads]) {
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int k = kt + u * kStepWarps + warp;
      w[u] = k < k_end ? load_w4(P.w + (size_t)k * P.n, P.n, col, P.vec) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto load_acts = [&](int kt, float(&av)[kStaged], float(&gv)[kStaged], float(&bv)[kStaged],
                       bool(&inv)[kStaged]) {
#pragma unroll
    for (int i = 0; i < kStaged; ++i) {
      const int e = threadIdx.x + kStepThreads * i;
      const int row = row0 + e / kDepth;
      const int k = kt + e % kDepth;
      const bool in = row < L.rows && k < k_end;
      inv[i] = in;
      // launch A reads x (fp32 or bf16) or h; launch B reads x @ W1 + b1 as
      // launch A left it (L2, not L1)
      av[i] = in ? (kStage == 0 ? load_act_a(P, row, k) : __ldcg(P.a + (size_t)row * P.lda + k)) : 0.f;
      gv[i] = kStage == 1 && in ? __ldg(L.norm1.g + k) : 0.f;
      bv[i] = kStage == 1 && in ? __ldg(L.norm1.be + k) : 0.f;
    }
  };
  // the registers of a step; the next step's loads are in flight while a
  // step is computed
  struct StepRegs {
    float4 w[kLoads];
    float a[kStaged], g[kStaged], b[kStaged];
    bool in[kStaged];
  };
  auto load_step = [&](int kt, StepRegs& r) {
    load_weights(kt, r.w);
    load_acts(kt, r.a, r.g, r.b, r.in);
  };
  StepRegs cur, next;

  // the first step's weights are in flight before anything else
  if (k_begin < k_end) load_weights(k_begin, cur.w);
  // launch A complete and its stores visible (a no-op without a
  // programmatic launch)
  if (kStage == 1) asm volatile("griddepcontrol.wait;" ::: "memory");
  if (k_begin < k_end) {
    load_acts(k_begin, cur.a, cur.g, cur.b, cur.in);
    if (kStage == 1) {
      row_stats(L.norm1, row0, min(R, L.rows - row0), row_mean, row_rstd);
      __syncthreads();
    }
  }
  for (int kt = k_begin; kt < k_end; kt += kDepth) {
    const bool more = kt + kDepth < k_end;
    if (more) load_step(kt + kDepth, next);
#pragma unroll
    for (int i = 0; i < kStaged; ++i) {
      const int e = threadIdx.x + kStepThreads * i;
      const int r = e / kDepth;
      float a = cur.a[i];
      if (kStage == 1 && cur.in[i]) {  // feat = SiLU(LN1(x @ W1 + b1))
        const float y = (a - row_mean[r]) * row_rstd[r] * cur.g[i] + cur.b[i];
        a = y * sigmoid_f(y);
      }
      a_s[(e % kDepth) * R + r] = a;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const float4 wu = cur.w[u];
      const float4* ap = reinterpret_cast<const float4*>(a_s + (u * kStepWarps + warp) * R);
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 a4v = ap[q];
        const float a4[4] = {a4v.x, a4v.y, a4v.z, a4v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float* c = acc[4 * q + e];
          c[0] = fmaf(a4[e], wu.x, c[0]);
          c[1] = fmaf(a4[e], wu.y, c[1]);
          c[2] = fmaf(a4[e], wu.z, c[2]);
          c[3] = fmaf(a4[e], wu.w, c[3]);
        }
      }
    }
    __syncthreads();
    if (!more) break;
    cur = next;
  }

  // the warps' sums, added in warp order into red[0]: warp w owns rows w,
  // w + 8, a lane the 4-column group col of its row
#pragma unroll
  for (int r = 0; r < R; ++r) {
    *reinterpret_cast<float4*>(red + (warp * R + r) * kStepCols + 4 * lane) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  }
  __syncthreads();
  for (int r = warp; r < R; r += kStepWarps) {
    float4* p = reinterpret_cast<float4*>(red + r * kStepCols + 4 * lane);
    float4 v = *p;
#pragma unroll
    for (int w = 1; w < kStepWarps; ++w) {
      v = add4(v, *reinterpret_cast<const float4*>(red + (w * R + r) * kStepCols + 4 * lane));
    }
    *p = v;
  }

  // the tile's depth chunks, summed across the cluster through distributed
  // shared memory in rank order (never in arrival order: two calls give the
  // same bits); rank q reduces rows q, q + C, ... of the tile, one warp a
  // row, at most two a warp. Each cluster barrier is split into its arrive
  // and its wait, with work that does not need it in between: the addends'
  // loads, then the stores of the reduced tile.
  constexpr int kRowsPerWarp = 2;
  static_assert(R <= kRowsPerWarp * kStepWarps, "a warp reduces at most two rows of a tile");
  cluster_arrive(true);  // this block's partial tile is in red[0]
  float4 sums[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = split + C * (warp + kStepWarps * i);
    sums[i] = group_addend<kStage>(P, row0 + r, col, r < R && row0 + r < L.rows && col < P.ld);
  }
  cluster_wait();  // every rank's partial tile is in its red[0]
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = split + C * (warp + kStepWarps * i);
    if (r >= R) break;
    float4 t[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      t[q] = q < C ? *reinterpret_cast<const float4*>(cluster.map_shared_rank(red, q) + r * kStepCols + 4 * lane)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float4 v = t[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q) v = add4(v, t[q]);
    sums[i] = add4(v, sums[i]);
  }
  cluster_arrive(false);  // done reading the other ranks' shared memory
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = split + C * (warp + kStepWarps * i);
    if (r < R) finish_group(L, P, ct, row0 + r, col, sums[i]);
  }
  // launch B: every block releases its stores with its own bump of the row
  // tile's counter; the last to arrive does the row work
  const bool last = kStage == 1 && last_to_arrive(L.row_count + rt, P.col_tiles * C, &flag);
  cluster_wait();  // no block leaves while another reads its shared memory
  if (last) ln2_gates<R>(L, P, row0, row_mean, row_rstd);
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

// SM count of the current device.
cudaError_t current_sm_count(int* sm_count) {
  int device;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sm_count, cudaDevAttrMultiProcessorCount, device);
}

// The plan of one fused step on a card of sm_count SMs: the row tile, each
// launch's cluster (the depth splits of a tile) and the products' depth
// chunks, and where the scratch arrays lie in the one scratch buffer
// (offsets in floats): launch B's row counters, the reduced x @ W1 + b1
// (launch B takes feat from it as it stages), the reduced projection
// [B, 3H] (launch A writes h @ W2[:H], launch B adds feat @ W2[H:]), and the
// (sum, centred second moment) of each row's column tiles of the two
// LayerNorms.
struct StepPlan {
  int rows_per_tile, row_tiles, col_tiles_d, col_tiles_3h;
  int cluster_a, chunk_x, chunk_h, cluster_b, chunk_f;
  int blocks_a, blocks_b;
  int ld_d, ld_3h;
  size_t counters;  // launch B's row counters, 4 bytes each, at the start of the scratch
  size_t pre1, pre2, stats_a, stats_b, floats;
};

int cdiv(int a, int b) { return (a + b - 1) / b; }

// A launch's cluster over `tiles` tiles: the most depth splits (up to
// kMaxCluster, a power of two) with which all its blocks fit the card at
// once (kStepBlocksPerSm an SM); 1 where even one block a tile does not.
int step_cluster(long long tiles, int sm_count) {
  int c = kMaxCluster;
  while (c > 1 && tiles * c > (long long)kStepBlocksPerSm * sm_count) c /= 2;
  return c;
}

// The depth chunk of one of a cluster's splits: whole 32-deep steps.
int step_chunk(int depth, int cluster) { return cdiv(cdiv(depth, cluster), kStepDepth) * kStepDepth; }

StepPlan make_step_plan(int batch, int in_dim, int dense, int hidden, int sm_count) {
  StepPlan p;
  p.rows_per_tile = batch <= 4 ? 4 : batch <= 32 ? 8 : 16;
  p.row_tiles = cdiv(batch, p.rows_per_tile);
  p.col_tiles_d = cdiv(dense, kStepCols);
  p.col_tiles_3h = cdiv(3 * hidden, kStepCols);
  p.cluster_a = step_cluster((long long)p.row_tiles * (p.col_tiles_d + p.col_tiles_3h), sm_count);
  p.cluster_b = step_cluster((long long)p.row_tiles * p.col_tiles_3h, sm_count);
  p.chunk_x = step_chunk(in_dim, p.cluster_a);
  p.chunk_h = step_chunk(hidden, p.cluster_a);
  p.chunk_f = step_chunk(dense, p.cluster_b);
  p.blocks_a = p.row_tiles * (p.col_tiles_d + p.col_tiles_3h) * p.cluster_a;
  p.blocks_b = p.row_tiles * p.col_tiles_3h * p.cluster_b;
  p.ld_d = cdiv(dense, 4) * 4;
  p.ld_3h = cdiv(3 * hidden, 4) * 4;
  p.counters = cdiv(p.row_tiles, 4) * 4;
  p.pre1 = p.counters;
  p.pre2 = p.pre1 + (size_t)batch * p.ld_d;
  p.stats_a = p.pre2 + (size_t)batch * p.ld_3h;
  p.stats_b = p.stats_a + (size_t)2 * batch * p.col_tiles_d;
  p.floats = p.stats_b + (size_t)2 * batch * p.col_tiles_3h;
  return p;
}

// Launches gru_step<R, kStage> with the launch's cluster; launch B is a
// programmatic dependent launch of launch A: it may begin before launch A
// ends, and waits for it inside (griddepcontrol.wait).
template <int R, int kStage>
cudaError_t launch_step(const StepLaunch& L, int blocks, cudaStream_t stream) {
  const int smem = (int)(sizeof(float) * (kStepWarps * R * kStepCols + kStepStaged));
  cudaError_t err = cudaFuncSetAttribute(gru_step<R, kStage>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kStepThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kStage == 1 ? 2 : 1;
  if ((err = cudaLaunchKernelEx(&cfg, gru_step<R, kStage>, L)) != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kStage>
cudaError_t launch_stage(const StepLaunch& L, int rows_per_tile, int blocks, cudaStream_t stream) {
  if (rows_per_tile == 4) return launch_step<4, kStage>(L, blocks, stream);
  if (rows_per_tile == 8) return launch_step<8, kStage>(L, blocks, stream);
  return launch_step<16, kStage>(L, blocks, stream);
}

bool rows_aligned(const float* w, int n) {
  return n % 4 == 0 && (reinterpret_cast<uintptr_t>(w) & 15) == 0;
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

// The plan fused_gru_forward follows for these sizes on a card of sm_count
// SMs (the current device's when sm_count <= 0), open to tests: plan[0..8]
// = rows a row tile, row tiles, launch A's cluster and depth chunks of
// x @ W1 and h @ W2[:H], launch B's cluster and chunk of feat @ W2[H:], the
// blocks of launch A and of launch B, and the floats of scratch in *floats.
// Returns a CUDA error code (0 = success).
extern "C" int fused_gru_step_plan(int batch, int in_dim, int dense, int hidden, int sm_count,
                                   int* plan, long long* floats) {
  if (sm_count <= 0) {
    const cudaError_t err = current_sm_count(&sm_count);
    if (err != cudaSuccess) return (int)err;
  }
  const StepPlan p = make_step_plan(batch, in_dim, dense, hidden, sm_count);
  const int fields[9] = {p.rows_per_tile, p.row_tiles, p.cluster_a, p.chunk_x, p.chunk_h,
                         p.cluster_b,     p.chunk_f,   p.blocks_a,  p.blocks_b};
  for (int i = 0; i < 9; ++i) plan[i] = fields[i];
  *floats = (long long)p.floats;
  return 0;
}

// The depth split of one splitk_matmul launch (splits returned, chunk in
// *chunk), for a given SM count: the plan of the sharded projection's
// CUDA-core route, open to tests.
extern "C" int fused_gru_split_plan(int depth, int cols, int rows, int sm_count, int* chunk) {
  return split_plan(depth, cols, rows, sm_count, chunk);
}

// One step on `stream`: launches gru_step twice (stage 0: x @ W1 + b1 and
// h @ W2[:H]; stage 1, a programmatic dependent launch: feat = SiLU(LN1(x @
// W1 + b1)) as it is staged, feat @ W2[H:], LN2 and the gates) and returns
// cudaGetLastError() (0 on success). x is fp32 (x_bf16 = 0) or bf16
// (x_bf16 = 1); every other input is fp32. scratch holds the floats
// fused_gru_step_plan() gives; the caller allocates it and out.
extern "C" int fused_gru_forward(const void* x, const float* h, const float* w1,
                                 const float* b1, const float* g1, const float* be1,
                                 const float* w2, const float* g2, const float* be2,
                                 float* out, float* scratch,
                                 int batch, int in_dim, int dense, int hidden, int x_bf16,
                                 float eps1, float eps2, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int sm_count;
  cudaError_t err = current_sm_count(&sm_count);
  if (err != cudaSuccess) return (int)err;
  const StepPlan p = make_step_plan(batch, in_dim, dense, hidden, sm_count);
  unsigned* row_count = reinterpret_cast<unsigned*>(scratch);
  float* pre1 = scratch + p.pre1;
  float* pre2 = scratch + p.pre2;
  float2* stats1 = reinterpret_cast<float2*>(scratch + p.stats_a);
  float2* stats2 = reinterpret_cast<float2*>(scratch + p.stats_b);
  const float* w2f = w2 + (size_t)hidden * 3 * hidden;
  const int n3 = 3 * hidden;

  StepLaunch a = {};
  a.prod[0] = {x_bf16 ? nullptr : static_cast<const float*>(x), in_dim, w1, dense, in_dim,
               rows_aligned(w1, dense), p.col_tiles_d, p.chunk_x,
               p.row_tiles * p.col_tiles_d * p.cluster_a, pre1, p.ld_d, b1, stats1,
               x_bf16 ? static_cast<const __nv_bfloat16*>(x) : nullptr};
  a.prod[1] = {h, hidden, w2, n3, hidden, rows_aligned(w2, n3), p.col_tiles_3h, p.chunk_h,
               p.row_tiles * p.col_tiles_3h * p.cluster_a, pre2, p.ld_3h, nullptr, nullptr};
  a.rows = batch;
  a.cluster = p.cluster_a;
  a.row_count = row_count;
  a.row_tiles = p.row_tiles;
  if ((err = launch_stage<0>(a, p.rows_per_tile, p.blocks_a, stream)) != cudaSuccess) return (int)err;

  StepLaunch b = {};
  b.prod[0] = {pre1, p.ld_d, w2f, n3, dense, rows_aligned(w2f, n3), p.col_tiles_3h, p.chunk_f,
               p.blocks_b, pre2, p.ld_3h, nullptr, stats2};
  b.rows = batch;
  b.cluster = p.cluster_b;
  b.row_count = row_count;
  b.row_tiles = p.row_tiles;
  b.norm1 = {stats1, p.col_tiles_d, dense, g1, be1, eps1};
  b.norm2 = {stats2, p.col_tiles_3h, n3, g2, be2, eps2};
  b.h = h;
  b.h_out = out;
  b.hidden = hidden;
  return (int)launch_stage<1>(b, p.rows_per_tile, p.blocks_b, stream);
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
