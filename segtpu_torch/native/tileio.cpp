// Native tile I/O of the port's tiled inference (counterpart of
// segtpu/native/tileio.cpp): the host-side cutting of tiles from a large
// image and the weighted merge of tiled predictions (reference lib/tiles.py
// split/merge loops), for 5000x5000 aerial images.
//
//  * extract: gathers every tile in one pass directly from the UNPADDED
//    image using virtual reflect-101 borders (no padded copy), tiles
//    parallelized over a thread pool;
//  * merge: weighted accumulate into float64 canvases, row-parallel
//    (threads own disjoint output row ranges, so no atomics are needed);
//    the caller normalises and crops.
//
// Bound with ctypes by segtpu_torch/native/__init__.py, which builds it
// with g++ at first use and raises if the build fails.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// reflect-101 fold of coordinate x into [0, n-1]
inline int reflect101(int x, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  x = x % period;
  if (x < 0) x += period;
  return x >= n ? period - x : x;
}

template <typename T>
void extract_tiles_impl(const T* img, int H, int W, int C, const int* xs,
                        const int* ys, int n_tiles, int tile, int m_top,
                        int m_left, T* out) {
  const int n_threads =
      std::max(1u, std::min(std::thread::hardware_concurrency(), 32u));
  std::vector<std::thread> workers;
  workers.reserve(n_threads);

  auto work = [&](int t0, int t1) {
    for (int t = t0; t < t1; ++t) {
      // crop origin in padded coordinates -> unpadded source offset
      const int y0 = ys[t] - m_top;
      const int x0 = xs[t] - m_left;
      T* dst = out + static_cast<int64_t>(t) * tile * tile * C;
      for (int r = 0; r < tile; ++r) {
        const int sy = reflect101(y0 + r, H);
        const T* src_row = img + (static_cast<int64_t>(sy) * W) * C;
        T* dst_row = dst + static_cast<int64_t>(r) * tile * C;
        const int in_x0 = x0;
        // fast path: fully interior row segment
        if (in_x0 >= 0 && in_x0 + tile <= W) {
          std::memcpy(dst_row, src_row + static_cast<int64_t>(in_x0) * C,
                      static_cast<size_t>(tile) * C * sizeof(T));
        } else {
          for (int c = 0; c < tile; ++c) {
            const int sx = reflect101(in_x0 + c, W);
            std::memcpy(dst_row + static_cast<int64_t>(c) * C,
                        src_row + static_cast<int64_t>(sx) * C,
                        static_cast<size_t>(C) * sizeof(T));
          }
        }
      }
    }
  };

  const int per = (n_tiles + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    const int t0 = i * per;
    const int t1 = std::min(n_tiles, t0 + per);
    if (t0 >= t1) break;
    workers.emplace_back(work, t0, t1);
  }
  for (auto& w : workers) w.join();
}

}  // namespace

extern "C" {

void tileio_extract_tiles_f32(const float* img, int H, int W, int C,
                              const int* xs, const int* ys, int n_tiles,
                              int tile, int m_top, int m_left, float* out) {
  extract_tiles_impl<float>(img, H, W, C, xs, ys, n_tiles, tile, m_top,
                            m_left, out);
}

void tileio_extract_tiles_u8(const uint8_t* img, int H, int W, int C,
                             const int* xs, const int* ys, int n_tiles,
                             int tile, int m_top, int m_left, uint8_t* out) {
  extract_tiles_impl<uint8_t>(img, H, W, C, xs, ys, n_tiles, tile, m_top,
                              m_left, out);
}

// Weighted merge: tiles (n_tiles, tile, tile, C) accumulated into
// acc/norm (Hp, Wp, C) float64, row-parallel (reference merge,
// lib/tiles.py:137-161 semantics; caller divides + crops margins).
void tileio_merge_f32(const float* tiles, const int* xs, const int* ys,
                      int n_tiles, int tile, int C, const double* weight,
                      int Hp, int Wp, double* acc, double* norm) {
  const int n_threads =
      std::max(1u, std::min(std::thread::hardware_concurrency(), 32u));
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  const int rows_per = (Hp + n_threads - 1) / n_threads;

  auto work = [&](int r0, int r1) {
    for (int t = 0; t < n_tiles; ++t) {
      const int ty = ys[t];
      const int tx = xs[t];
      const int lo = std::max(r0, ty);
      const int hi = std::min(r1, ty + tile);
      for (int y = lo; y < hi; ++y) {
        const int tr = y - ty;
        const float* src =
            tiles + ((static_cast<int64_t>(t) * tile + tr) * tile) * C;
        const double* wrow = weight + static_cast<int64_t>(tr) * tile;
        double* arow = acc + (static_cast<int64_t>(y) * Wp + tx) * C;
        double* nrow = norm + (static_cast<int64_t>(y) * Wp + tx) * C;
        for (int x = 0; x < tile; ++x) {
          const double w = wrow[x];
          for (int c = 0; c < C; ++c) {
            arow[static_cast<int64_t>(x) * C + c] +=
                static_cast<double>(src[static_cast<int64_t>(x) * C + c]) * w;
            nrow[static_cast<int64_t>(x) * C + c] += w;
          }
        }
      }
    }
  };

  for (int i = 0; i < n_threads; ++i) {
    const int r0 = i * rows_per;
    const int r1 = std::min(Hp, r0 + rows_per);
    if (r0 >= r1) break;
    workers.emplace_back(work, r0, r1);
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
