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
//   * nm_gif_lzw        — the LZW code stream of one GIF frame (viz/
//                          image_files.py writes the blocks around it)
//   * nm_png_unfilter   — undo the per-row filters of an 8-bit PNG
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

// GIF's variable-width LZW (GIF89a, appendix F) of n palette indices with
// minimum code size mcs (2..8): a clear code first, a clear code whenever
// the table reaches 4096 entries, then end-of-information. Codes are packed
// LSB first into out (capacity cap bytes). Returns the bytes written, or
// -1 when cap is too small. The string table is a (prefix, byte) -> code
// array stamped with a generation number, so a clear costs nothing.
int64_t nm_gif_lzw(const uint8_t* idx, int64_t n, int mcs, uint8_t* out,
                   int64_t cap) {
  const int clear = 1 << mcs, eoi = clear + 1;
  std::vector<uint32_t> table(4096 * 256, 0);
  uint32_t gen = 1;
  int next_code = clear + 2, code_size = mcs + 1;
  uint64_t acc = 0;
  int bits = 0;
  int64_t len = 0;
  bool overflow = false;
  auto emit = [&](int code) {
    acc |= static_cast<uint64_t>(code) << bits;
    bits += code_size;
    while (bits >= 8) {
      if (len < cap) out[len] = static_cast<uint8_t>(acc & 0xFF);
      else overflow = true;
      ++len;
      acc >>= 8;
      bits -= 8;
    }
  };
  emit(clear);
  if (n == 0) {
    emit(eoi);
  } else {
    int prefix = idx[0];
    for (int64_t i = 1; i < n; ++i) {
      const int c = idx[i];
      const uint32_t key = static_cast<uint32_t>(prefix) * 256 + c;
      const uint32_t e = table[key];
      if ((e >> 12) == gen) {
        prefix = static_cast<int>(e & 0xFFF);
        continue;
      }
      emit(prefix);
      if (next_code < 4096) {
        table[key] = (gen << 12) | static_cast<uint32_t>(next_code);
        // the decoder adds this entry one code later: widen once the code
        // it will add next no longer fits
        if (next_code == (1 << code_size) && code_size < 12) ++code_size;
        ++next_code;
      } else {
        emit(clear);
        ++gen;
        next_code = clear + 2;
        code_size = mcs + 1;
      }
      prefix = c;
    }
    emit(prefix);
    emit(eoi);
  }
  if (bits > 0) {
    if (len < cap) out[len] = static_cast<uint8_t>(acc & 0xFF);
    else overflow = true;
    ++len;
  }
  return overflow ? -1 : len;
}

// rows: h rows of (1 + stride) bytes, each a filter type (0-4: none, sub,
// up, average, Paeth) then the filtered bytes; bpp bytes per pixel. Writes
// the h x stride unfiltered bytes to out. Returns 0, or the 1-based row of
// an unknown filter type.
int64_t nm_png_unfilter(const uint8_t* rows, int64_t h, int64_t stride,
                        int bpp, uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = rows + y * (stride + 1);
    const int type = src[0];
    ++src;
    uint8_t* cur = out + y * stride;
    const uint8_t* prev = y > 0 ? out + (y - 1) * stride : nullptr;
    for (int64_t x = 0; x < stride; ++x) {
      const int a = x >= bpp ? cur[x - bpp] : 0;
      const int b = prev != nullptr ? prev[x] : 0;
      const int c = (prev != nullptr && x >= bpp) ? prev[x - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b),
                    pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return y + 1;
      }
      cur[x] = static_cast<uint8_t>(src[x] + pred);
    }
  }
  return 0;
}

int nm_version() { return 2; }

}  // extern "C"
