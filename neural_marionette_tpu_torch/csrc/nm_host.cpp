// Host-side data library of the PyTorch/CUDA port: a copy of the JAX
// package's native/nm_host.cpp, built by kernels.py (g++ -O3 -std=c++17
// -shared -fPIC -pthread) into _build/ at first use and bound in
// data/native.py. The loader calls it from its worker threads; ctypes
// releases the interpreter lock around each call.
//
//   * nm_voxelize_batch  — scatter (F, N, 3) point frames into (F, G^3)
//                          binary occupancy grids, one thread per frame
//                          (reference semantics: truncating cast, +1e-5
//                          step fudge, [-1,1]^3 bbox, index clamp — an
//                          out-of-range point lands in the border voxel,
//                          where the card's voxelizer drops it)
//   * nm_normalize_episodic — clip-wide bbox normalization into [-1,1]^3
//                          (utils/dataset_utils.py:9-19)
//   * nm_crop_strided   — strided temporal window gather
//
// Exposed with C linkage for ctypes.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

int hardware_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n == 0 ? 4 : static_cast<int>(n);
}

// parallel-for over [0, count) with one task per worker chunk
template <typename F>
void parallel_for(int64_t count, F&& fn, int max_threads = 0) {
  int n_threads = std::min<int64_t>(
      count, max_threads > 0 ? max_threads : hardware_threads());
  if (n_threads <= 1) {
    for (int64_t i = 0; i < count; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= count) return;
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// points: (frames, n_points, 3) float32; out: (frames, G*G*G) float32
// (zeroed here).  Reference semantics (utils/dataset_utils.py:21-31) with
// an index clamp as the out-of-range guard.
void nm_voxelize_batch(const float* points, int64_t frames,
                       int64_t n_points, int grid, float* out) {
  const float bmin = -1.0f;
  const float step = 2.0f / static_cast<float>(grid) + 1e-5f;
  const int64_t cells = static_cast<int64_t>(grid) * grid * grid;

  parallel_for(frames, [&](int64_t f) {
    const float* p = points + f * n_points * 3;
    float* g = out + f * cells;
    std::memset(g, 0, cells * sizeof(float));
    for (int64_t n = 0; n < n_points; ++n) {
      int ix = static_cast<int>((p[n * 3 + 0] - bmin) / step);
      int iy = static_cast<int>((p[n * 3 + 1] - bmin) / step);
      int iz = static_cast<int>((p[n * 3 + 2] - bmin) / step);
      ix = std::clamp(ix, 0, grid - 1);
      iy = std::clamp(iy, 0, grid - 1);
      iz = std::clamp(iz, 0, grid - 1);
      g[(static_cast<int64_t>(ix) * grid + iy) * grid + iz] = 1.0f;
    }
  });
}

// seq: (T, N, 3) float32 normalized in place into [-1, 1]^3 by the
// clip-wide bbox; optional joints (T, K, 3) co-normalized.
// Matches utils/dataset_utils.py:9-19 (incl. the 1e-5 denominator guard).
void nm_normalize_episodic(float* seq, int64_t T, int64_t N, float scale,
                           float x_trans, float z_trans, float* joints,
                           int64_t K) {
  float bmin[3] = {INFINITY, INFINITY, INFINITY};
  float bmax[3] = {-INFINITY, -INFINITY, -INFINITY};
  const int64_t total = T * N;
  for (int64_t i = 0; i < total; ++i) {
    for (int d = 0; d < 3; ++d) {
      const float v = seq[i * 3 + d];
      bmin[d] = std::min(bmin[d], v);
      bmax[d] = std::max(bmax[d], v);
    }
  }
  float blen = std::max({bmax[0] - bmin[0], bmax[1] - bmin[1],
                         bmax[2] - bmin[2]});
  const float inv = scale / (blen + 1e-5f);
  const float trans[3] = {x_trans, 0.0f, z_trans};
  parallel_for(T, [&](int64_t t) {
    float* row = seq + t * N * 3;
    for (int64_t n = 0; n < N; ++n)
      for (int d = 0; d < 3; ++d)
        row[n * 3 + d] =
            (row[n * 3 + d] - bmin[d]) * inv * 2.0f - 1.0f + trans[d];
    if (joints != nullptr) {
      float* jrow = joints + t * K * 3;
      for (int64_t k = 0; k < K; ++k)
        for (int d = 0; d < 3; ++d)
          jrow[k * 3 + d] = (jrow[k * 3 + d] - bmin[d]) * inv * 2.0f - 1.0f;
    }
  });
}

// src: (T_in, N, C) -> dst: (T, N, C) strided window
void nm_crop_strided(const float* src, float* dst, int64_t start, int64_t T,
                     int64_t sample_rate, int64_t frame_elems) {
  parallel_for(T, [&](int64_t t) {
    std::memcpy(dst + t * frame_elems,
                src + (start + t * sample_rate) * frame_elems,
                frame_elems * sizeof(float));
  });
}

int nm_version() { return 1; }

}  // extern "C"
