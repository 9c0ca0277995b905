// GroupNorm (+ per-sample affine) (+ SiLU) on NHWC bf16, for Hopper (sm_90a).
//
// Replaces the TPU kernel r2dm_tpu/ops/pallas_gn.py::fused_group_norm_silu
// (Pallas body _gn_silu_kernel, pallas_gn.py:50-104), which kept one whole
// sample resident in VMEM and so read x once.
//
// v2: one kernel, one launch per call. The grid is K CTAs per sample times
// B samples; the K CTAs of a sample form one thread block cluster, and CTA
// rank r streams the contiguous pixel rows [r*rows, min((r+1)*rows, HW)) of
// its sample (empty when HW < K).
//   1. statistics: fp32 sums of x and x^2 per channel; thread t owns the
//      8-channel vector t % (C/8) of every (512/(C/8))-th row, 16-byte
//      loads, kUnroll of them in flight a thread (64 KB a CTA); the CTA
//      reduces them over its threads through shared memory into s1[C], s2[C];
//   2. fold through distributed shared memory: after a cluster barrier, rank
//      g mod K owns group g: it adds that group's channels of s1/s2 from all
//      K CTAs (each thread a fixed subset, then a fixed-order CTA sum: the
//      result is deterministic, with no atomics), forms the mean and
//      E[x^2]-E[x]^2 (clamped at 0, eps inside the rsqrt, count H*W*C/G, as
//      r2dm_tpu/models/layers.py:417-427), folds the affine into
//      a = rstd*gain, b = -mean*rstd*gain + shift (layers.py:478-489) and
//      pushes (a, b) into every CTA's shared memory. A second cluster
//      barrier ends all remote access, so a CTA may leave after it with no
//      third barrier (fetching (a, b) from the owners after the barrier
//      instead cost 3-6 us a call);
//   3. apply: each thread reads the (a, b) of its 8 channels from its own
//      shared memory into registers, and the CTA walks its rows again, last
//      to first: y = x*a + b, [SiLU], in fp32, rounded to bf16 once, 16-byte
//      stores.
// Why a cluster: the fold needs every CTA's sums of the sample. v1 wrote
// them to global memory as fp32 partial rows (half the size of x at
// 8x8x128x512) and folded them in a second launch on B blocks; here they
// never leave the SMs, and the whole call is one launch.
//
// Bound on an H100 SXM (3.35 TB/s): memory, x read once and y written once.
// This kernel reads x twice: the second read of a CTA's share is an L2 hit
// where the activation fits the 50 MB L2 (config H, b8: levels 2-4,
// 4-34 MB); at level 1 (67-134 MB) the walk from the last row finds the
// rows read last in L2 and reads the rest from HBM again.
//
// The launch arithmetic (K, rows per CTA, threads per pixel row, rows per
// pass, dynamic shared memory) comes from the wrapper, ops/gn_silu.py
// _launch_args. K is its CLUSTER constant, 8, the portable cluster size:
// at K = 16 cudaOccupancyMaxActiveClusters reports 7 co-resident clusters
// on an H100 SXM, and b8 needs 8 (gn_max_active_clusters reports it).
// A refused cluster launch returns its error; nothing retries.
//
// Under a width axis (ops/gn_silu.py, parallel/width.py) a rank holds some of
// each image's columns, and the statistics are sums over every rank's. The
// one launch is then split in two, with the sum across ranks between them:
//   gn_stats_kernel: step 1 on the same clusters, then each CTA folds its
//     share of the channels across the cluster's K CTAs in rank order and
//     writes the (B, C) fp32 sums of x and x^2 of this rank's pixels;
//   (the wrapper all-reduces them over the width group)
//   gn_apply_kernel: K plain CTAs a sample; each folds every group's summed
//     channels in channel order (count: the whole image's H*W*C/G), forms
//     the folded affine and runs step 3's apply loop on its rows.
// Steps 1 and 3 are the same device functions in both forms.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;     // bf16 channels per 16-byte vector
constexpr int kUnroll = 8;  // 16-byte loads in flight per thread
// dynamic shared memory of any call: 2*rpp*C <= 2*kThreads*kVec floats of
// per-thread-row sums, plus s1 and s2 at C <= 2048 (ops/gn_silu.py)
constexpr int kMaxSmem = 4 * (2 * kThreads * kVec + 2 * 2048);
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* x;
  __nv_bfloat16* y;
  const float* gain;     // element (b, c) at b*gstride + c (gstride 0: (C,))
  const float* shift;
  int gstride;
  int HW, C, G;
  int rows;              // pixel rows per CTA
  int tpr;               // threads per pixel row, C / 8
  int rpp;               // pixel rows per pass, kThreads / tpr
  float count;           // elements per group, H*W*C/G (the whole image's)
  float eps;
  int silu;
  float* sums;           // split form: (2, B, C) fp32, sum x then sum x^2
};

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float* f) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

// z*sigmoid(z) = z/(1 + exp(-z)) in fp32: ex2.approx and rcp.approx, two
// MUFU operations, each within a few fp32 ulps, with no cancellation in
// either tail (0.5 + 0.5*tanh(z/2) cancels for z < 0). For z < -88 the
// exp overflows to inf and the result is -0, as z*sigmoid(z) rounds there.
__device__ __forceinline__ float silu(float z) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(-z * kLog2e));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return z * r;
}

// Sum of u1 and u2 over the CTA, in a fixed order, returned to every
// thread. ws: 2*kWarps floats of shared memory, free again on return.
__device__ __forceinline__ void block_sum2(float& u1, float& u2, float* ws) {
#pragma unroll
  for (int off = 16; off; off >>= 1) {
    u1 += __shfl_xor_sync(0xffffffffu, u1, off);
    u2 += __shfl_xor_sync(0xffffffffu, u2, off);
  }
  const int w = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    ws[w] = u1;
    ws[kWarps + w] = u2;
  }
  __syncthreads();
  u1 = 0.f;
  u2 = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) {
    u1 += ws[i];
    u2 += ws[kWarps + i];
  }
  __syncthreads();
}

// Step 1: this CTA's fp32 sums of x and x^2 over rows [row0, row1) of
// sample b, per channel, into s1[C] and s2[C] (red: 2*rpp*C floats of
// scratch). Ends with the CTA's threads synchronised.
__device__ __forceinline__ void cta_stats(const Params& p, const __nv_bfloat16* xs, int row0,
                                          int row1, float* red, float* s1, float* s2) {
  const int C = p.C, rpp = p.rpp, t = threadIdx.x;
  const int v = t % p.tpr, r = t / p.tpr;
  float a1[kVec], a2[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) a1[i] = a2[i] = 0.f;
  if (r < rpp) {
    for (int row = row0 + r; row < row1; row += kUnroll * rpp) {
      uint4 u[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int rr = row + k * rpp;
        u[k] = rr < row1 ? __ldg(reinterpret_cast<const uint4*>(xs + (size_t)rr * C))
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        float f[kVec];
        unpack8(u[k], f);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          a1[i] += f[i];
          a2[i] = fmaf(f[i], f[i], a2[i]);
        }
      }
    }
    float4* d1 = reinterpret_cast<float4*>(red + r * C + v * kVec);
    float4* d2 = reinterpret_cast<float4*>(red + (rpp + r) * C + v * kVec);
    d1[0] = make_float4(a1[0], a1[1], a1[2], a1[3]);
    d1[1] = make_float4(a1[4], a1[5], a1[6], a1[7]);
    d2[0] = make_float4(a2[0], a2[1], a2[2], a2[3]);
    d2[1] = make_float4(a2[4], a2[5], a2[6], a2[7]);
  }
  __syncthreads();
  // rows -> P partial rows per channel (in place: element q*C + c is read
  // only by the thread that writes it), then -> one
  const int P = max(1, kThreads / C);
  for (int i = t; i < P * C; i += kThreads) {
    const int c = i % C, q = i / C;
    float u1 = 0.f, u2 = 0.f;
    for (int rr = q; rr < rpp; rr += P) {
      u1 += red[rr * C + c];
      u2 += red[(rpp + rr) * C + c];
    }
    red[q * C + c] = u1;
    red[(rpp + q) * C + c] = u2;
  }
  __syncthreads();
  for (int c = t; c < C; c += kThreads) {
    float u1 = 0.f, u2 = 0.f;
    for (int q = 0; q < P; ++q) {
      u1 += red[q * C + c];
      u2 += red[(rpp + q) * C + c];
    }
    s1[c] = u1;
    s2[c] = u2;
  }
}

// Step 3: y = x*a + b [SiLU] over this thread's rows of [row0, row1), its 8
// channels' (a, b) from ca/cb, walking from the last row (the stats pass
// read them first to last, so the most recent, still in L2, come first).
__device__ __forceinline__ void cta_apply(const Params& p, const __nv_bfloat16* xs,
                                          __nv_bfloat16* ys, int row0, int row1,
                                          const float* ca, const float* cb) {
  const int C = p.C, rpp = p.rpp, t = threadIdx.x;
  const int v = t % p.tpr, r = t / p.tpr;
  if (r >= rpp) return;
  float fa[kVec], fb[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    fa[i] = ca[v * kVec + i];
    fb[i] = cb[v * kVec + i];
  }
  const int first = row0 + r;
  const int n = first < row1 ? (row1 - first + rpp - 1) / rpp : 0;
  for (int j0 = n - 1; j0 >= 0; j0 -= kUnroll) {
    uint4 u[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = j0 - k;
      u[k] = j >= 0 ? __ldg(reinterpret_cast<const uint4*>(xs + (size_t)(first + j * rpp) * C))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = j0 - k;
      if (j < 0) break;
      float f[kVec];
      unpack8(u[k], f);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float z = fmaf(f[i], fa[i], fb[i]);
        f[i] = p.silu ? silu(z) : z;
      }
      *reinterpret_cast<uint4*>(ys + (size_t)(first + j * rpp) * C) = pack8(f);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) gn_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float ws[2 * kWarps];
  const int C = p.C, rpp = p.rpp;
  // [2][rpp][C]: per-thread-row sums; after the first cluster barrier the
  // first 2*C floats take every channel's folded (a, b)
  float* red = smem;
  float* s1 = smem + 2 * rpp * C;  // [C] this CTA's sums of x
  float* s2 = s1 + C;              // [C] ... and of x^2

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int K = (int)cluster.num_blocks();
  const int b = blockIdx.y, t = threadIdx.x;
  const int row0 = min(rank * p.rows, p.HW);
  const int row1 = min(row0 + p.rows, p.HW);
  const int v = t % p.tpr;
  const __nv_bfloat16* xs = p.x + (size_t)b * p.HW * C + v * kVec;

  // 1. statistics over this CTA's rows
  cta_stats(p, xs, row0, row1, red, s1, s2);
  cluster.sync();  // every CTA's s1/s2 complete and visible to the cluster

  // 2. fold: this rank owns the groups g = rank, rank + K, ...; the
  // K*cpg remote reads of a group are spread over all threads
  const int cpg = C / p.G;
  float* ca = red;  // [C] every channel's folded a, pushed by its owner
  float* cb = red + C;
  for (int g = rank; g < p.G; g += K) {
    float u1 = 0.f, u2 = 0.f;
    for (int i = t; i < K * cpg; i += kThreads) {
      const int c = g * cpg + i % cpg;
      const int k = i / cpg;
      u1 += cluster.map_shared_rank(s1, k)[c];
      u2 += cluster.map_shared_rank(s2, k)[c];
    }
    block_sum2(u1, u2, ws);
    const float mean = u1 / p.count;
    const float var = fmaxf(u2 / p.count - mean * mean, 0.f);
    const float rstd = rsqrtf(var + p.eps);
    // pushed into every CTA's ca/cb (stores to distributed shared memory,
    // so that after the next barrier no CTA reads another's shared memory)
    for (int i = t; i < K * cpg; i += kThreads) {
      const int c = g * cpg + i % cpg;
      const int k = i / cpg;
      const float gn = p.gain[(size_t)b * p.gstride + c];
      const float sh = p.shift[(size_t)b * p.gstride + c];
      cluster.map_shared_rank(ca, k)[c] = rstd * gn;
      cluster.map_shared_rank(cb, k)[c] = (-mean * rstd) * gn + sh;
    }
  }
  // every remote read and write of the cluster is done: after this barrier
  // a CTA may leave, and ca/cb hold all C channels
  cluster.sync();
  // 3. apply
  cta_apply(p, xs, p.y + (size_t)b * p.HW * C + v * kVec, row0, row1, ca, cb);
}

// The split form's first launch: step 1 on the same clusters, then CTA k of
// the cluster writes channels c = k*kThreads + t, k*kThreads + t + K*kThreads,
// ... of the (B, C) sums, each the K CTAs' partial sums added in rank order.
__global__ void __launch_bounds__(kThreads, 1) gn_stats_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, rpp = p.rpp;
  float* red = smem;
  float* s1 = smem + 2 * rpp * C;
  float* s2 = s1 + C;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int K = (int)cluster.num_blocks();
  const int b = blockIdx.y, t = threadIdx.x;
  const int row0 = min(rank * p.rows, p.HW);
  const int row1 = min(row0 + p.rows, p.HW);
  const __nv_bfloat16* xs = p.x + (size_t)b * p.HW * C + (t % p.tpr) * kVec;
  cta_stats(p, xs, row0, row1, red, s1, s2);
  cluster.sync();
  float* out1 = p.sums + (size_t)b * C;
  float* out2 = p.sums + ((size_t)gridDim.y + b) * C;
  for (int c = rank * kThreads + t; c < C; c += K * kThreads) {
    float u1 = 0.f, u2 = 0.f;
    for (int k = 0; k < K; ++k) {
      u1 += cluster.map_shared_rank(s1, k)[c];
      u2 += cluster.map_shared_rank(s2, k)[c];
    }
    out1[c] = u1;
    out2[c] = u2;
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

// The split form's second launch: K CTAs a sample (no cluster); each folds
// the summed channels of every group in channel order (thread g < G folds
// group g), forms (a, b) of every channel in shared memory, and applies.
__global__ void __launch_bounds__(kThreads, 1) gn_apply_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int C = p.C, G = p.G, cpg = C / G;
  float* ca = smem;           // [C]
  float* cb = smem + C;       // [C]
  float* gm = smem + 2 * C;   // [G] group means
  float* gr = gm + G;         // [G] group 1/sqrt(var + eps)
  const int rank = blockIdx.x;
  const int b = blockIdx.y, t = threadIdx.x;
  const float* s1 = p.sums + (size_t)b * C;
  const float* s2 = p.sums + ((size_t)gridDim.y + b) * C;
  for (int g = t; g < G; g += kThreads) {
    float u1 = 0.f, u2 = 0.f;
    for (int j = 0; j < cpg; ++j) {
      u1 += s1[g * cpg + j];
      u2 += s2[g * cpg + j];
    }
    const float mean = u1 / p.count;
    gm[g] = mean;
    gr[g] = rsqrtf(fmaxf(u2 / p.count - mean * mean, 0.f) + p.eps);
  }
  __syncthreads();
  for (int c = t; c < C; c += kThreads) {
    const float mean = gm[c / cpg], rstd = gr[c / cpg];
    const float gn = p.gain[(size_t)b * p.gstride + c];
    const float sh = p.shift[(size_t)b * p.gstride + c];
    ca[c] = rstd * gn;
    cb[c] = (-mean * rstd) * gn + sh;
  }
  __syncthreads();
  const int row0 = min(rank * p.rows, p.HW);
  const int row1 = min(row0 + p.rows, p.HW);
  const size_t off = (size_t)b * p.HW * C + (t % p.tpr) * kVec;
  cta_apply(p, p.x + off, p.y + off, row0, row1, ca, cb);
}

// The dynamic shared memory attribute, set once per device at the largest
// size any call takes (not on every launch), for both cluster kernels
cudaError_t prepare() {
  static std::atomic<unsigned long long> done{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(gn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(gn_stats_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess) done.fetch_or(bit, std::memory_order_acq_rel);
  return e;
}

void config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr, int K, int B, int smem,
            cudaStream_t s) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3(K, B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

Params params(const void* x, void* y, const void* gain, const void* shift, int gstride, int HW,
              int C, int G, int rows, int tpr, int rpp, float count, float eps, int silu,
              void* sums) {
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.y = static_cast<__nv_bfloat16*>(y);
  p.gain = static_cast<const float*>(gain);
  p.shift = static_cast<const float*>(shift);
  p.gstride = gstride;
  p.HW = HW;
  p.C = C;
  p.G = G;
  p.rows = rows;
  p.tpr = tpr;
  p.rpp = rpp;
  p.count = count;
  p.eps = eps;
  p.silu = silu;
  p.sums = static_cast<float*>(sums);
  return p;
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// y = [silu](GN(x)*gain + shift), bf16 NHWC; gain/shift fp32, element
// (b, c) at b*gstride + c
int gn_launch(const void* x, void* y, const void* gain, const void* shift, int gstride, int B,
              int HW, int C, int G, int K, int rows, int tpr, int rpp, int smem, float eps,
              int silu, void* stream) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = prepare();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Params p = params(x, y, gain, shift, gstride, HW, C, G, rows, tpr, rpp,
                          (float)HW * (float)(C / G), eps, silu, nullptr);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  config(cfg, attr, K, B, smem, static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&cfg, gn_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The split form's statistics: sums (2, B, C) fp32 <- per-channel sums of x
// and x^2 over each sample's HW pixels, on clusters of K CTAs
int gn_stats_launch(const void* x, void* sums, int B, int HW, int C, int K, int rows, int tpr,
                    int rpp, int smem, void* stream) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = prepare();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Params p = params(x, nullptr, nullptr, nullptr, 0, HW, C, 1, rows, tpr, rpp, 0.f, 0.f, 0,
                          sums);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  config(cfg, attr, K, B, smem, static_cast<cudaStream_t>(stream));
  e = cudaLaunchKernelEx(&cfg, gn_stats_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The split form's apply: y = [silu](GN(x)*gain + shift) from the summed
// (2, B, C) statistics and the whole image's count per group, on K CTAs a
// sample, each over the same rows as a cluster rank
int gn_apply_launch(const void* x, void* y, const void* sums, const void* gain,
                    const void* shift, int gstride, int B, int HW, int C, int G, int K, int rows,
                    int tpr, int rpp, float count, float eps, int silu, void* stream) {
  const Params p = params(x, y, gain, shift, gstride, HW, C, G, rows, tpr, rpp, count, eps, silu,
                          const_cast<void*>(sums));
  const int smem = 4 * (2 * C + 2 * G);
  gn_apply_kernel<<<dim3(K, B, 1), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// cudaOccupancyMaxActiveClusters for clusters of K CTAs with `smem` bytes of
// dynamic shared memory each; < 0: minus the CUDA error.
int gn_max_active_clusters(int K, int smem) {
  cudaError_t e = prepare();
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  config(cfg, attr, K, 1, smem, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, reinterpret_cast<const void*>(gn_kernel), &cfg);
  return e == cudaSuccess ? n : -static_cast<int>(e);
}

}  // extern "C"
