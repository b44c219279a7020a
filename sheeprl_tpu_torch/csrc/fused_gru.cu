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
// upcast in registers, and fp32 sums. It is launch 3 above templated on the
// weight type (splitk_matmul, planned by the same split_plan), then, when the
// depth is split, a pass that sums the split partials in a fixed order into
// out (sum_splits): no atomics, deterministic like the step.
//
// What bounds it on an H100: memory at the acting batch, fp32 arithmetic at
// the imagination batch. It reads W2s once, plus h, feat and out:
//   S, mp=1, fp32 [1024, 1536], B=4:        6.3 MB, >= 1.9 us at 3.35 TB/s;
//   L, mp=4, bf16 [2816, 1536], B=16:       8.9 MB, >= 2.7 us;
//   XL, mp=16, bf16 [5120, 768], B=16:      8.2 MB, >= 2.5 us.
// At B=1024 (16 sequences x 64 imagination steps) L/4 does 8.9 GFLOP, which
// take >= 132 us at the 67 TFLOP/s fp32 rate outside the tensor cores.
// Making it fast (wgmma on bf16 tiles, TMA, a weight slice kept resident
// across a scan) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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

constexpr int kBlocksPerSm = 2;  // blocks in flight per SM that the split aims for

// (splits, chunk) of the depth for one splitk_matmul launch over rows x cols:
// enough blocks to give every SM kBlocksPerSm, no chunk shorter than one
// staged tile, and each chunk a whole number of tiles.
int split_plan(int depth, int cols, int rows, int sm_count, int* chunk) {
  const int col_blocks = (cols + kCols - 1) / kCols;
  const int row_tiles = (rows + kRows - 1) / kRows;
  const int max_splits = (depth + kKTile - 1) / kKTile;
  int want = (kBlocksPerSm * sm_count) / (col_blocks * row_tiles);
  if (want < 1) want = 1;
  const int splits = want < max_splits ? want : max_splits;
  int c = (depth + splits - 1) / splits;
  c = (c + kKTile - 1) / kKTile * kKTile;
  *chunk = c;
  return (depth + c - 1) / c;
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

// The plan of one sharded projection on the current device: the depth split
// of its one splitk_matmul and the scratch of the split partials
// (partial[splits, B, C]; none when the depth is not split, as splitk_matmul
// then writes out directly).
struct ProjPlan {
  int splits, chunk;
  size_t floats;
};

cudaError_t make_proj_plan(int batch, int hidden, int dense, int cols, ProjPlan* p) {
  int sm_count;
  const cudaError_t err = current_sm_count(&sm_count);
  if (err != cudaSuccess) return err;
  p->splits = split_plan(hidden + dense, cols, batch, sm_count, &p->chunk);
  p->floats = p->splits > 1 ? (size_t)p->splits * batch * cols : 0;
  return cudaSuccess;
}

template <typename W>
cudaError_t launch_proj(const float* h, const float* feat, const W* w2s, float* out,
                        float* scratch, int batch, int hidden, int dense, int cols,
                        const ProjPlan& p, cudaStream_t stream) {
  float* partial = p.splits > 1 ? scratch : out;
  dim3 grid((cols + kCols - 1) / kCols, p.splits, (batch + kRows - 1) / kRows);
  splitk_matmul<W><<<grid, kCols, 0, stream>>>(h, hidden, feat, dense, w2s, cols, batch,
                                               p.chunk, partial);
  cudaError_t err = cudaGetLastError();
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

// Floats of scratch that sharded_proj_forward needs for these sizes on the
// current device (0 when the depth is not split), written to *floats;
// returns a CUDA error code (0 = success).
extern "C" int sharded_proj_scratch_floats(int batch, int hidden, int dense, int cols,
                                           long long* floats) {
  ProjPlan p;
  const cudaError_t err = make_proj_plan(batch, hidden, dense, cols, &p);
  if (err == cudaSuccess) *floats = (long long)p.floats;
  return (int)err;
}

// out[B, C] = h[B, H] @ w2s[:H] + feat[B, D] @ w2s[H:], w2s[H+D, C] fp32
// (w2s_bf16 = 0) or bf16 (w2s_bf16 = 1), on `stream`. Launches one or two
// kernels and returns cudaGetLastError() (0 on success). scratch holds
// sharded_proj_scratch_floats() floats; the caller allocates it and out.
extern "C" int sharded_proj_forward(const float* h, const float* feat, const void* w2s,
                                    int w2s_bf16, float* out, float* scratch, int batch,
                                    int hidden, int dense, int cols, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  ProjPlan p;
  const cudaError_t err = make_proj_plan(batch, hidden, dense, cols, &p);
  if (err != cudaSuccess) return (int)err;
  if (w2s_bf16) {
    return (int)launch_proj(h, feat, static_cast<const __nv_bfloat16*>(w2s), out, scratch,
                            batch, hidden, dense, cols, p, stream);
  }
  return (int)launch_proj(h, feat, static_cast<const float*>(w2s), out, scratch, batch,
                          hidden, dense, cols, p, stream);
}

// Error text for a code returned above.
extern "C" const char* fused_gru_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
