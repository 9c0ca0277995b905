// Fused (affine + SiLU) prologue + 3x3 ring convolution, NHWC bf16, for
// Hopper (sm_90a):
//
//     y = ring_conv3x3(silu(x * a + b), k) + bias     (apply_act = 1)
//     y = ring_conv3x3(x, k) + bias                    (apply_act = 0)
//
// a, b fp32 per (sample, input channel); W wraps circularly; H is zero-padded
// AFTER the activation (silu(b) != 0, so pad rows must stay exactly zero).
//
// Replaces the TPU kernel r2dm_tpu/ops/pallas_resconv.py::fused_act_ringconv
// (Pallas body _kernel, pallas_resconv.py:82-170). Its width-pair lane
// packing, block-expanded kernel and 8-row halo DMA existed for the TPU's
// 128-lane MXU and 16 MB VMEM and are not carried over.
//
// Design: an implicit GEMM with M = BM output pixels of one (b, h) row
// segment, N = BN output channels, K = 9 taps x C_in, walked as slices of
// (kernel row kh, BK input channels). For each slice the block stages the
// (BM + 2)-pixel input halo of row h + kh - 1 -- W index taken mod W (the
// ring), the prologue silu(x*a + b) computed in fp32 while staging and
// rounded to bf16 -- and the three kw taps' BK x BN weight tiles; the three
// taps then read the same halo at pixel offsets 0, 1, 2. A kernel row
// outside [0, H) is skipped: its contribution is exactly zero. The next
// slice's global loads are issued into registers before the current slice's
// tensor-core work, so their latency hides behind it. Eight warps each own a
// 32x32 output sub-tile: ldmatrix from padded (bank-conflict-free) shared
// rows feeds mma.sync m16n8k16 bf16 with fp32 accumulators; the epilogue
// adds the bias in fp32 and stores bf16 pairs.
//
// Bound on an H100 SXM at config H, level 1, 64 -> 64 channels, per image:
// 2*9*64*64*65536 = 4.83 GFLOP (4.9 us at 989 TFLOP/s bf16) against 8.4 MB
// in + 8.4 MB out (5.0 us at 3.35 TB/s). mma.sync cannot reach the wgmma
// peak and the loads are not asynchronous copies; TMA, wgmma and a deeper
// pipeline are the way to that bound.
//
// Requirements (checked by the Python wrapper): C_in % 8 == 0, F % 8 == 0,
// contiguous NHWC x, weight packed as (9*C_in, F) bf16 with row
// (kh*3 + kw)*C_in + c (HWIO flattened).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // output pixels per block (one row segment)
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // input channels per slice
constexpr int LDA = BK + 8;   // 80-byte rows: ldmatrix without bank conflicts
constexpr int LDB = BN + 8;   // 144-byte rows
constexpr int kThreads = 256; // 8 warps: 4 along M x 2 along N, 32x32 each
constexpr int kVecA = (BM + 2) * (BK / 8);  // 16-byte vectors per halo
constexpr int kVecB = 3 * BK * (BN / 8);    // 16-byte vectors per weight slice
constexpr int kPerA = (kVecA + kThreads - 1) / kThreads;
constexpr int kPerB = (kVecB + kThreads - 1) / kThreads;

// silu(x*a + b) on 8 bf16 channels in fp32, rounded to bf16 once. a, b are
// 32-byte aligned (C_in % 8 == 0), so they load as float4 pairs. The fast
// divide is within 2 ulp of fp32, far below the bf16 rounding that follows.
__device__ __forceinline__ uint4 act8(uint4 u, const float* __restrict__ pa,
                                      const float* __restrict__ pb) {
  const float4 a0 = reinterpret_cast<const float4*>(pa)[0];
  const float4 a1 = reinterpret_cast<const float4*>(pa)[1];
  const float4 b0 = reinterpret_cast<const float4*>(pb)[0];
  const float4 b1 = reinterpret_cast<const float4*>(pb)[1];
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    float s0 = f.x * av[2 * i] + bv[2 * i];
    float s1 = f.y * av[2 * i + 1] + bv[2 * i + 1];
    s0 = __fdividef(s0, 1.f + __expf(-s0));
    s1 = __fdividef(s1, 1.f + __expf(-s1));
    h[i] = __floats2bfloat162_rn(s0, s1);
  }
  return u;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Slice {
  int kh, c0;
};

__global__ void __launch_bounds__(kThreads, 2) act_ringconv_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ pa,
    const float* __restrict__ pb, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int H,
    int W, int Cin, int F, int apply_act) {
  __shared__ __align__(128) __nv_bfloat16 sa[BM + 2][LDA];
  __shared__ __align__(128) __nv_bfloat16 sb[3][BK][LDB];

  const int tiles_w = (W + BM - 1) / BM;
  const int h = blockIdx.x / tiles_w;
  const int w0 = (blockIdx.x % tiles_w) * BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
  const float* pa_b = pa + (size_t)b * Cin;
  const float* pb_b = pb + (size_t)b * Cin;

  // slices (kh, c0), kernel rows that fall in the H padding left out
  const int kh_lo = h == 0 ? 1 : 0;
  const int kh_hi = h == H - 1 ? 1 : 2;
  const int n_c = (Cin + BK - 1) / BK;
  const int n_slices = (kh_hi - kh_lo + 1) * n_c;
  auto slice_of = [&](int s) { return Slice{kh_lo + s / n_c, (s % n_c) * BK}; };

  uint4 ra[kPerA], rb[kPerB];
  auto load = [&](int s) {
    const Slice sl = slice_of(s);
    const __nv_bfloat16* xrow = x + ((size_t)b * H + (h + sl.kh - 1)) * W * Cin;
#pragma unroll
    for (int k = 0; k < kPerA; ++k) {
      const int i = tid + k * kThreads;
      ra[k] = make_uint4(0, 0, 0, 0);
      if (i < kVecA) {
        const int r = i / (BK / 8), c = sl.c0 + (i % (BK / 8)) * 8;
        int win = (w0 - 1 + r) % W;
        if (win < 0) win += W;
        if (c < Cin) ra[k] = *reinterpret_cast<const uint4*>(xrow + (size_t)win * Cin + c);
      }
    }
#pragma unroll
    for (int k = 0; k < kPerB; ++k) {
      const int i = tid + k * kThreads;
      rb[k] = make_uint4(0, 0, 0, 0);
      if (i < kVecB) {
        const int kw = i / (BK * (BN / 8)), rem = i % (BK * (BN / 8));
        const int c = sl.c0 + rem / (BN / 8), n = n0 + (rem % (BN / 8)) * 8;
        if (c < Cin && n < F)
          rb[k] = *reinterpret_cast<const uint4*>(
              w + ((size_t)(sl.kh * 3 + kw) * Cin + c) * F + n);
      }
    }
  };
  auto store = [&](int s) {
    const Slice sl = slice_of(s);
#pragma unroll
    for (int k = 0; k < kPerA; ++k) {
      const int i = tid + k * kThreads;
      if (i < kVecA) {
        const int r = i / (BK / 8), cv = (i % (BK / 8)) * 8;
        uint4 v = ra[k];
        if (apply_act && sl.c0 + cv < Cin) v = act8(v, pa_b + sl.c0 + cv, pb_b + sl.c0 + cv);
        *reinterpret_cast<uint4*>(&sa[r][cv]) = v;
      }
    }
#pragma unroll
    for (int k = 0; k < kPerB; ++k) {
      const int i = tid + k * kThreads;
      if (i < kVecB) {
        const int kw = i / (BK * (BN / 8)), rem = i % (BK * (BN / 8));
        *reinterpret_cast<uint4*>(&sb[kw][rem / (BN / 8)][(rem % (BN / 8)) * 8]) = rb[k];
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  if (n_slices > 0) load(0);
  for (int s = 0; s < n_slices; ++s) {
    __syncthreads();  // every warp is done reading the previous slice
    store(s);
    __syncthreads();
    if (s + 1 < n_slices) load(s + 1);  // in flight during the mma work
#pragma unroll
    for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[2][4], bf[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4(af[i], &sa[wm * 32 + i * 16 + kw + lane % 16][kk + (lane / 16) * 8]);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          ldmatrix_x4_trans(bf[j], &sb[kw][kk + lane % 16][wn * 32 + j * 16 + (lane / 16) * 8]);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_bf16(acc[i][j], af[i], bf[j / 2][(j % 2) * 2], bf[j / 2][(j % 2) * 2 + 1]);
      }
    }
  }

  // epilogue: thread holds rows lane/4 (+8), channel pairs 2*(lane%4)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int wo = w0 + wm * 32 + i * 16 + lane / 4 + half * 8;
      if (wo >= W) continue;
      __nv_bfloat16* yrow = y + (((size_t)b * H + h) * W + wo) * F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + wn * 32 + j * 8 + 2 * (lane % 4);
        if (n >= F) continue;
        *reinterpret_cast<__nv_bfloat162*>(yrow + n) = __floats2bfloat162_rn(
            acc[i][j][2 * half] + bias[n], acc[i][j][2 * half + 1] + bias[n + 1]);
      }
    }
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int act_ringconv_launch(const void* x, const void* a, const void* b,
                        const void* w, const void* bias, void* y, int B, int H,
                        int W, int Cin, int F, int apply_act, void* stream) {
  const dim3 grid(H * ((W + BM - 1) / BM), (F + BN - 1) / BN, B);
  act_ringconv_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), H, W,
      Cin, F, apply_act);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
