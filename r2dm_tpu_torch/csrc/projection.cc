// Native point-cloud -> range-image projection core.
//
// C++ replacement for the reference's numba-JIT hot path
// (data/kitti_360/kitti_360.py:27-93): bin the raw Velodyne points onto the
// equirectangular (H, W) grid with a z-buffer, either by spherical elevation
// bins or by scan unfolding (ring recovery from counterclockwise point
// order). This runs per scan in the ingest pipeline; the z-buffer semantics
// reproduce the reference's descending-depth stable scatter exactly:
// the nearest point wins each cell, ties broken toward the later original
// index.
//
// The port's own copy of r2dm_tpu/data/native/projection.cc. Built at first
// use by ops/build.py::load_host (g++ -O3 -shared -fPIC -std=c++17 into
// r2dm_tpu_torch/_build/) and bound by ctypes in data/projection.py.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr float kPi = 3.14159265358979323846f;

// elevation limits of the HDL-64E (reference kitti_360.py:76)
constexpr float kHUp = 3.0f * kPi / 180.0f;
constexpr float kHDown = -25.0f * kPi / 180.0f;

// floor(f) -> [0, hi] bin with NaN/Inf guarded: raw .bin files can carry
// non-finite coordinates, and |z/d| can round above 1 before asin — a
// float->int cast of those is undefined behavior (UBSan float-cast-overflow;
// tools/sanitize_projection.cc). NaN and anything below 0 map to bin 0,
// +Inf to hi, matching clip semantics for every finite value.
inline int bin_index(float f, int hi) {
  f = std::floor(f);
  if (!(f > 0.0f)) return 0;
  if (f >= (float)hi) return hi;
  return (int)f;
}

}  // namespace

extern "C" {

// points: n x 4 float32 (x, y, z, reflectance), the raw .bin layout.
// out:    H x W x 6 float32 (x, y, z, reflectance, depth, mask), zeroed.
// Returns 0 on success.
int project_scan(const float* points, int64_t n, int H, int W,
                 int scan_unfolding, float min_depth, float max_depth,
                 float* out) {
  if (n <= 0) return 0;

  std::vector<int> grid_h(n), grid_w(n);
  std::vector<float> depth(n);

  // depth + horizontal bin (reference kitti_360.py:48,82-84)
  for (int64_t i = 0; i < n; ++i) {
    const float x = points[i * 4 + 0];
    const float y = points[i * 4 + 1];
    const float z = points[i * 4 + 2];
    const float d = std::sqrt(x * x + y * y + z * z);
    depth[i] = d;
    const float azimuth = -std::atan2(y, x);            // [-pi, pi]
    float gw = (azimuth / kPi + 1.0f) * 0.5f;           // [0, 1]
    gw = gw - std::floor(gw);                           // % 1
    grid_w[i] = bin_index(gw * W, W - 1);
  }

  if (scan_unfolding) {
    // ring recovery: quadrant of each point, split where the sequence
    // crosses from the 3rd quadrant back to the 1st
    // (reference kitti_360.py:52-74)
    std::vector<int8_t> quads(n);
    for (int64_t i = 0; i < n; ++i) {
      const float x = points[i * 4 + 0];
      const float y = points[i * 4 + 1];
      quads[i] = (y >= 0.0f) ? (x >= 0.0f ? 0 : 1) : (x >= 0.0f ? 3 : 2);
    }
    std::vector<int64_t> delims;
    for (int64_t i = 0; i < n; ++i) {
      const int8_t prev = quads[(i + n - 1) % n];
      if ((int)prev - (int)quads[i] == 3) delims.push_back(i);
    }
    // segments between delimiters are rings, assigned bottom-up from H-1;
    // segments beyond H get row -1 which the scatter wraps to H-1 (numpy
    // negative-index semantics of the reference scatter)
    std::fill(grid_h.begin(), grid_h.end(), 0);
    if (!delims.empty()) {
      int ring = H - 1;
      bool done = false;
      for (int64_t s = (int64_t)delims.size() - 1; s >= 0 && !done; --s) {
        const int64_t lo = delims[s];
        const int64_t hi = (s + 1 < (int64_t)delims.size()) ? delims[s + 1] : n;
        const int row = ring < 0 ? H + ring : ring;  // wrap -1 -> H-1
        for (int64_t i = lo; i < hi; ++i) grid_h[i] = row;
        if (ring >= 0) {
          --ring;
        } else {
          done = true;
        }
      }
    }
  } else {
    // spherical: elevation -> row bin (reference kitti_360.py:76-79)
    for (int64_t i = 0; i < n; ++i) {
      const float z = points[i * 4 + 2];
      const float d = depth[i];
      const float elevation = std::asin(d > 0 ? z / d : 0.0f) - kHDown;
      const float gh = 1.0f - elevation / (kHUp - kHDown);
      grid_h[i] = bin_index(gh * H, H - 1);
    }
  }

  // z-buffer scatter: nearest depth wins, ties -> later index
  // (== reference's stable descending-depth sort + last-write-wins)
  std::vector<float> best(static_cast<size_t>(H) * W, -1.0f);
  for (int64_t i = 0; i < n; ++i) {
    const float d = depth[i];
    // a non-finite point is not a point: writing it would poison its cell
    // (NaN fails every later depth comparison, dropping real returns there).
    // Matches the reference's effective behavior — numpy's descending sort
    // places NaN depths first, so any valid point overwrites them.
    if (!std::isfinite(d)) continue;
    const size_t cell = static_cast<size_t>(grid_h[i]) * W + grid_w[i];
    if (best[cell] < 0.0f || d <= best[cell]) {
      best[cell] = d;
      float* dst = out + cell * 6;
      dst[0] = points[i * 4 + 0];
      dst[1] = points[i * 4 + 1];
      dst[2] = points[i * 4 + 2];
      dst[3] = points[i * 4 + 3];
      dst[4] = d;
      dst[5] = (d >= min_depth && d <= max_depth) ? 1.0f : 0.0f;
    }
  }
  return 0;
}

}  // extern "C"
