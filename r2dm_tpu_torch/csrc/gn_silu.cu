// GroupNorm (+ per-sample affine) (+ SiLU) on NHWC bf16, for Hopper (sm_90a).
//
// Replaces the TPU kernel r2dm_tpu/ops/pallas_gn.py::fused_group_norm_silu
// (Pallas body _gn_silu_kernel, pallas_gn.py:50-104), which kept one whole
// sample resident in VMEM. Here:
//   phase A  gn_stats_kernel: split-HW fp32 sums of x and x^2 per (sample,
//            channel); many blocks per sample, each writes its own partial
//            row (no atomics, so the result does not depend on block order);
//   fold     gn_fold_kernel: one block per sample adds the partial rows,
//            forms group mean and E[x^2]-E[x]^2 (clamped >= 0, eps inside the
//            rsqrt, count H*W*C/G, as models/layers.py:417-427) and folds the
//            affine into a = rstd*gain, b = -mean*rstd*gain + shift
//            (layers.py:478-489);
//   phase B  gn_apply_kernel: y = x*a + b (+ SiLU) in fp32, rounded to bf16
//            once.
// gn_coeffs_launch runs phase A + fold (the ResidualBlock feeds (a, b) to the
// conv prologue of act_ringconv.cu); gn_silu_launch runs all three.
//
// Bound on an H100 SXM (3.35 TB/s): memory. Phase A reads the activation
// once, phase B reads it again and writes it once; the TPU kernel's single
// read would need a whole sample (8.4 MB at 64x1024x64) in one SM's 227 KB,
// so the design pays one extra read and spreads each sample over many SMs.
// Loads and stores are 16 bytes per thread (8 channels), C % 8 == 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;           // bf16 channels per 16-byte vector
constexpr int kMaxC = kThreads * kVec;  // 2048 channels

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// partial: (B, nchunks, 2, C) fp32; block (chunk, b) sums rows
// [chunk*rows_per_chunk, ...) of sample b.
__global__ void __launch_bounds__(kThreads) gn_stats_kernel(
    const __nv_bfloat16* __restrict__ x, float* __restrict__ partial, int HW,
    int C, int rows_per_chunk, int nchunks) {
  __shared__ float sh[2][kMaxC];
  const int chunk = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int tpr = C / kVec;         // threads per pixel row
  const int rpp = kThreads / tpr;   // pixel rows per pass
  const int v = t % tpr, r = t / tpr;
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) s1[i] = s2[i] = 0.f;
  const int row0 = chunk * rows_per_chunk;
  const int row1 = min(row0 + rows_per_chunk, HW);
  if (r < rpp) {
    const __nv_bfloat16* base = x + (size_t)b * HW * C + v * kVec;
    for (int row = row0 + r; row < row1; row += rpp) {
      float f[kVec];
      load8(base + (size_t)row * C, f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        s1[i] += f[i];
        s2[i] += f[i] * f[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      sh[0][r * C + v * kVec + i] = s1[i];
      sh[1][r * C + v * kVec + i] = s2[i];
    }
  }
  __syncthreads();
  float* out = partial + ((size_t)b * nchunks + chunk) * 2 * C;
  for (int c = t; c < C; c += kThreads) {
    float a1 = 0.f, a2 = 0.f;
    for (int rr = 0; rr < rpp; ++rr) {
      a1 += sh[0][rr * C + c];
      a2 += sh[1][rr * C + c];
    }
    out[c] = a1;
    out[C + c] = a2;
  }
}

// One block per sample. gain/shift: fp32, element (b, c) at b*gstride + c
// (gstride 0 broadcasts a (C,) vector).
__global__ void __launch_bounds__(kThreads) gn_fold_kernel(
    const float* __restrict__ partial, const float* __restrict__ gain,
    const float* __restrict__ shift, int gstride, float* __restrict__ a_out,
    float* __restrict__ b_out, int C, int G, int nchunks, float count,
    float eps) {
  __shared__ float s1[kMaxC], s2[kMaxC];
  __shared__ float gmean[kMaxC], grstd[kMaxC];
  const int b = blockIdx.x, t = threadIdx.x;
  const float* p = partial + (size_t)b * nchunks * 2 * C;
  for (int c = t; c < C; c += kThreads) {
    float a1 = 0.f, a2 = 0.f;
    for (int k = 0; k < nchunks; ++k) {
      a1 += p[(size_t)k * 2 * C + c];
      a2 += p[(size_t)k * 2 * C + C + c];
    }
    s1[c] = a1;
    s2[c] = a2;
  }
  __syncthreads();
  const int cpg = C / G;
  for (int g = t; g < G; g += kThreads) {
    float g1 = 0.f, g2 = 0.f;
    for (int c = g * cpg; c < (g + 1) * cpg; ++c) {
      g1 += s1[c];
      g2 += s2[c];
    }
    const float mean = g1 / count;
    const float var = fmaxf(g2 / count - mean * mean, 0.f);
    gmean[g] = mean;
    grstd[g] = rsqrtf(var + eps);
  }
  __syncthreads();
  for (int c = t; c < C; c += kThreads) {
    const int g = c / cpg;
    const float gn = gain[(size_t)b * gstride + c];
    const float sh = shift[(size_t)b * gstride + c];
    a_out[(size_t)b * C + c] = grstd[g] * gn;
    b_out[(size_t)b * C + c] = (-gmean[g] * grstd[g]) * gn + sh;
  }
}

__global__ void __launch_bounds__(kThreads) gn_apply_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ bb, __nv_bfloat16* __restrict__ y,
    long long n_vec, long long hwc, int C, int silu) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    const long long e = i * kVec;
    const long long b = e / hwc;
    const int c = (int)(e % C);
    const float* ab = a + b * C + c;
    const float* bp = bb + b * C + c;
    float f[kVec];
    load8(x + e, f);
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      float v = f[k] * ab[k] + bp[k];
      if (silu) v = v * (1.f / (1.f + __expf(-v)));
      f[k] = v;
    }
    store8(y + e, f);
  }
}

void stats_and_fold(const void* x, void* partial, const void* gain,
                    const void* shift, int gstride, void* a, void* b, int B,
                    int HW, int C, int G, int rows_per_chunk, int nchunks,
                    float eps, cudaStream_t s) {
  gn_stats_kernel<<<dim3(nchunks, B), kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(partial), HW,
      C, rows_per_chunk, nchunks);
  gn_fold_kernel<<<B, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const float*>(gain),
      static_cast<const float*>(shift), gstride, static_cast<float*>(a),
      static_cast<float*>(b), C, G, nchunks, (float)HW * (float)(C / G), eps);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// (a, b) fp32 (B, C) such that GN_affine(x) == x*a + b.
int gn_coeffs_launch(const void* x, void* partial, const void* gain,
                     const void* shift, int gstride, void* a, void* b, int B,
                     int HW, int C, int G, int rows_per_chunk, int nchunks,
                     float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stats_and_fold(x, partial, gain, shift, gstride, a, b, B, HW, C, G,
                 rows_per_chunk, nchunks, eps, s);
  return static_cast<int>(cudaGetLastError());
}

// y = [silu](GN(x)*gain + shift), bf16 NHWC; a/b are (B, C) fp32 scratch.
int gn_silu_launch(const void* x, void* partial, const void* gain,
                   const void* shift, int gstride, void* a, void* b, void* y,
                   int B, int HW, int C, int G, int rows_per_chunk,
                   int nchunks, float eps, int silu, int apply_blocks,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stats_and_fold(x, partial, gain, shift, gstride, a, b, B, HW, C, G,
                 rows_per_chunk, nchunks, eps, s);
  const long long hwc = (long long)HW * C;
  gn_apply_kernel<<<apply_blocks, kThreads, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y),
      (long long)B * hwc / kVec, hwc, C, silu);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
