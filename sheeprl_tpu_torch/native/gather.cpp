// Native data-plane gather for the host replay buffers' sample path (the
// port's copy of sheeprl_tpu/native/gather.cpp).
//
// numpy fancy indexing gathers [batch*L] rows, then reshape+swapaxes leaves a
// non-contiguous array that is copied again before the host->device
// transfer. This kernel fuses the gather and the [n_samples, seq_len, batch,
// item] layout into one multi-threaded pass that writes the final contiguous
// buffer directly, so the copy to the card reads sequential memory.
//
// Layouts (C-contiguous, row-major):
//   src: [buffer_size, n_envs, item]          (the ring buffer)
//   dst: [n_samples, seq_len, batch, item]    (the train-step batch)
// with batch_dim = n_samples * batch sequences, sequence s = (n, b) reading
// src[(starts[s] + t) % buffer_size, envs[s], :] into dst[n, t, b, :].
//
// Built with g++ -O3 -shared -fPIC -std=c++17 -pthread and loaded with
// ctypes (sheeprl_tpu_torch/native/__init__.py). Pure C ABI below.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Returns 0 on success, nonzero on bad arguments.
int gather_sequences(
    const unsigned char* src,   // [buffer_size, n_envs, item_bytes]
    int64_t buffer_size,
    int64_t n_envs,
    int64_t item_bytes,
    const int64_t* starts,      // [batch_dim] start rows in the ring
    const int64_t* envs,        // [batch_dim] env column per sequence
    int64_t batch_dim,          // n_samples * batch
    int64_t seq_len,
    int64_t n_samples,
    int64_t batch,
    int64_t shift,              // 0 for obs, +1 for next-obs windows
    unsigned char* dst,         // [n_samples, seq_len, batch, item_bytes]
    int n_threads) {
  if (buffer_size <= 0 || n_envs <= 0 || item_bytes <= 0 || batch_dim <= 0 ||
      seq_len <= 0 || n_samples <= 0 || batch <= 0 ||
      n_samples * batch != batch_dim) {
    return 1;
  }
  const int64_t src_row = n_envs * item_bytes;       // one ring slot
  const int64_t dst_t = batch * item_bytes;          // one (n, t) row block
  const int64_t dst_n = seq_len * dst_t;             // one sample block

  auto worker = [&](int64_t s_begin, int64_t s_end) {
    for (int64_t s = s_begin; s < s_end; ++s) {
      const int64_t n = s / batch;
      const int64_t b = s % batch;
      const int64_t env_off = envs[s] * item_bytes;
      // euclidean modulo: C++ '%' is negative for negative operands
      int64_t row = (starts[s] + shift) % buffer_size;
      if (row < 0) row += buffer_size;
      unsigned char* out = dst + n * dst_n + b * item_bytes;
      for (int64_t t = 0; t < seq_len; ++t) {
        std::memcpy(out + t * dst_t, src + row * src_row + env_off,
                    static_cast<size_t>(item_bytes));
        ++row;
        if (row == buffer_size) row = 0;
      }
    }
  };

  if (n_threads <= 1 || batch_dim == 1) {
    worker(0, batch_dim);
    return 0;
  }
  const int64_t nt =
      std::min<int64_t>(n_threads, batch_dim);
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(nt));
  const int64_t chunk = (batch_dim + nt - 1) / nt;
  for (int64_t i = 0; i < nt; ++i) {
    const int64_t lo = i * chunk;
    const int64_t hi = std::min(batch_dim, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

// Row gather for the plain ReplayBuffer ([batch] rows, no sequence axis):
// dst[i, :] = src[(rows[i]) % buffer_size, envs[i], :].
int gather_rows(
    const unsigned char* src,
    int64_t buffer_size,
    int64_t n_envs,
    int64_t item_bytes,
    const int64_t* rows,
    const int64_t* envs,
    int64_t count,
    unsigned char* dst,
    int n_threads) {
  if (buffer_size <= 0 || n_envs <= 0 || item_bytes <= 0 || count <= 0) return 1;
  const int64_t src_row = n_envs * item_bytes;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t r = rows[i] % buffer_size;
      if (r < 0) r += buffer_size;
      std::memcpy(dst + i * item_bytes, src + r * src_row + envs[i] * item_bytes,
                  static_cast<size_t>(item_bytes));
    }
  };
  if (n_threads <= 1 || count == 1) {
    worker(0, count);
    return 0;
  }
  const int64_t nt = std::min<int64_t>(n_threads, count);
  std::vector<std::thread> threads;
  threads.reserve(static_cast<size_t>(nt));
  const int64_t chunk = (count + nt - 1) / nt;
  for (int64_t i = 0; i < nt; ++i) {
    const int64_t lo = i * chunk;
    const int64_t hi = std::min(count, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
