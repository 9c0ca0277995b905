// The W8A8 int8 serving lane for Hopper (sm_90a): a 3x3 ring convolution on
// s8 x s8 -> s32 tensor-core products, NHWC, and the absmax reduction that
// gives its dynamic activation scale.
//
//     xs   = max|x| / 127 + 1e-12                       (absmax_kernel)
//     xq   = clamp(round_half_even(x / xs), -127, 127)   (while staging)
//     y    = float(conv(ring_pad(xq), kq)) * (xs * ks[f]) + bias[f]
//
// kq, ks: the fp32 master kernel quantized per output channel by the Python
// wrapper (ops/quant.py::pack_weight), packed K-major as s8 (F, 9, Cp), C_in
// zero-padded to Cp (a multiple of BK). W wraps circularly; H is zero-padded.
//
// Replaces the JAX function r2dm_tpu/ops/quant.py::ring_conv_w8a8, an XLA
// int8 convolution (quant.py:78-107), not a Pallas kernel. The arithmetic is
// the same: IEEE division (no --use_fast_math in the build), __float2int_rn
// (round half to even, as jnp.round), and an epilogue of separately rounded
// _rn intrinsics, so nvcc cannot contract the multiply and the add into one
// FMA as XLA does not. The s32 accumulators are exact and equal the plain
// version's; the fp32 output is then bit-equal to it, and so is the bf16
// output (one round-to-nearest-even of the same fp32 value).
//
// Design: an implicit GEMM, M = B*H*W output pixels, N = F, K = 9*C_in, in
// the shape of csrc/act_ringconv.cu: a block takes BM = 128 pixels of one
// (b, h) row segment and BN = 64 output channels, and walks K as slices of
// (kernel row kh, BK = 64 input channels); a kernel row outside [0, H) is
// skipped (its contribution is exactly zero). Per slice, every thread
// stages 8-channel vectors of the x halo row (BM + 2 pixels, the W index
// taken mod W: the ring), reading bf16 or fp32 and quantizing as it goes
// (a scalar path takes C_in % 8 != 0, such as the 34 channels of in_conv),
// and 16-byte vectors of the three kw taps' weight rows. Four warps, each 64
// pixels x 32 channels, then issue mma.sync m16n8k32 s8 x s8 -> s32 from
// shared memory: tap kw reads the same halo shifted by kw rows. Rows are 80
// bytes (64 + 16 pad, 20 words), so the fragments' 32-bit loads are bank-
// conflict free. Ragged W, F and C_in are masked; F = 2 (out_conv) runs one
// N tile with 62 channels masked.
//
// Bound on an H100 SXM at config H, level 1, 64 -> 64 channels, b8:
// 2*9*64*64*8*64*1024 = 38.7 G int8 operations, 0.0196 ms at 1,979 TOPS,
// against 134 MB of bf16 x in and y out, 0.0401 ms at 3.35 TB/s: level 1 is
// bound by bytes, like the bf16 conv, and only the deeper levels (C_in up to
// 512 at 8x128) have the arithmetic intensity for int8 to pay. So the design
// reads x once per kernel row at its own width (bf16 in, quantized in
// registers, never written back as s8) and keeps the whole tap triple on one
// staged halo. Each x element is still quantized three times (once per kh)
// and the staging is not overlapped with the products (no cp.async ring: a
// quantizing copy goes through registers); a wgmma s8 form with a TMA-fed
// weight ring is the next step (ROADMAP).
//
// absmax_kernel: a grid-stride pass of 16-byte loads, a warp-shuffle and a
// shared-memory max per block, then one atomicMax on the float's bits (the
// order of non-negative floats is the order of their bits as int), so the
// result is exact and independent of the order. Bound: x read once, 67 MB
// at level 1 b8 in bf16: 0.020 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;        // output pixels per block (one row segment)
constexpr int BN = 64;         // output channels per block
constexpr int BK = 64;         // input channels (s8 bytes) per K slice
constexpr int kThreads = 128;  // four warps: 2 along M (64 pixels) x 2 along N (32 channels)
constexpr int ROW = BK + 16;   // shared row stride in bytes
constexpr int A_ROWS = BM + 2;
constexpr int A_BYTES = A_ROWS * ROW;
constexpr int B_BYTES = 3 * BN * ROW;
constexpr int VEC_A = A_ROWS * (BK / 8);  // 8-channel vectors of one halo slice
constexpr int VEC_B = 3 * BN * (BK / 16);  // 16-byte vectors of one weight slice
constexpr float kQmax = 127.f;
constexpr float kEps = 1e-12f;
static_assert(A_BYTES % 16 == 0 && ROW % 16 == 0, "16-byte aligned rows");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// the activation scale, in the order of quant.py:62
__device__ __forceinline__ float act_scale(const float* amax) {
  return __fadd_rn(__fdiv_rn(*amax, kQmax), kEps);
}

__device__ __forceinline__ uint32_t q8(float v, float s) {
  const int i = __float2int_rn(__fdiv_rn(v, s));
  return static_cast<uint32_t>(max(-127, min(127, i))) & 0xffu;
}

__device__ __forceinline__ uint32_t pack4(const float* v, float s) {
  return q8(v[0], s) | (q8(v[1], s) << 8) | (q8(v[2], s) << 16) | (q8(v[3], s) << 24);
}

// 8 consecutive channels as fp32 (16-byte aligned source)
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// epilogue value: float(acc) * (xs * ks) [+ bias], each step rounded alone
__device__ __forceinline__ float dequant(int acc, float scale, const float* bias, int n) {
  const float v = __fmul_rn(__int2float_rn(acc), scale);
  return bias ? __fadd_rn(v, bias[n]) : v;
}

__device__ __forceinline__ void store1(float* y, float v) { *y = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* y, float v) { *y = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store2(float* y, float v0, float v1) {
  *reinterpret_cast<float2*>(y) = make_float2(v0, v1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* y, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(y) = __floats2bfloat162_rn(v0, v1);
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads, 3) w8a8_ringconv_kernel(
    const TIn* __restrict__ x, const float* __restrict__ amax, const int8_t* __restrict__ wq,
    const float* __restrict__ ks, const float* __restrict__ bias, TOut* __restrict__ y, int H,
    int W, int Cin, int Cp, int F) {
  __shared__ __align__(16) uint8_t sA[A_BYTES];
  __shared__ __align__(16) uint8_t sB[B_BYTES];

  const int tiles_w = (W + BM - 1) / BM;
  const int h = blockIdx.x / tiles_w;
  const int w0 = (blockIdx.x % tiles_w) * BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int wm = warp % 2, wn = warp / 2;  // this warp: pixels wm*64 .., channels wn*32 ..
  const float xs = act_scale(amax);
  const bool vec = Cin % 8 == 0;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0;

  for (int kh = 0; kh < 3; ++kh) {
    const int hh = h + kh - 1;
    if (hh < 0 || hh >= H) continue;  // zero padding in H
    const TIn* xrow = x + ((size_t)b * H + hh) * W * Cin;
    for (int c0 = 0; c0 < Cp; c0 += BK) {
      __syncthreads();  // the previous slice's products are done with sA, sB
      // x halo: pixel r is input column (w0 - 1 + r) mod W, quantized
      for (int i = tid; i < VEC_A; i += kThreads) {
        const int r = i / (BK / 8), c = c0 + (i % (BK / 8)) * 8;
        const int w = ((w0 - 1 + r) % W + W) % W;
        const TIn* src = xrow + (size_t)w * Cin + c;
        float v[8];
        if (vec) {
          if (c < Cin) {
            load8(src, v);
          } else {
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = 0.f;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = c + j < Cin ? to_float(src[j]) : 0.f;
        }
        *reinterpret_cast<uint2*>(sA + r * ROW + (c - c0)) = make_uint2(pack4(v, xs), pack4(v + 4, xs));
      }
      // weights of the three kw taps of row kh: (tap, n) rows of BK bytes
      for (int j = tid; j < VEC_B; j += kThreads) {
        const int tap = j / (BN * (BK / 16)), n = (j / (BK / 16)) % BN, v = j % (BK / 16);
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + n < F)
          val = *reinterpret_cast<const uint4*>(wq + ((size_t)(n0 + n) * 9 + kh * 3 + tap) * Cp + c0 + v * 16);
        *reinterpret_cast<uint4*>(sB + (tap * BN + n) * ROW + v * 16) = val;
      }
      __syncthreads();
#pragma unroll
      for (int kw = 0; kw < 3; ++kw) {
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          uint32_t a[4][4], bf[4][2];
#pragma unroll
          for (int mt = 0; mt < 4; ++mt) {
            // output pixel p reads halo row p + kw
            const uint8_t* pa = sA + (wm * 64 + mt * 16 + g + kw) * ROW + kk * 32 + t4 * 4;
            a[mt][0] = *reinterpret_cast<const uint32_t*>(pa);
            a[mt][1] = *reinterpret_cast<const uint32_t*>(pa + 8 * ROW);
            a[mt][2] = *reinterpret_cast<const uint32_t*>(pa + 16);
            a[mt][3] = *reinterpret_cast<const uint32_t*>(pa + 8 * ROW + 16);
          }
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint8_t* pb = sB + (kw * BN + wn * 32 + nt * 8 + g) * ROW + kk * 32 + t4 * 4;
            bf[nt][0] = *reinterpret_cast<const uint32_t*>(pb);
            bf[nt][1] = *reinterpret_cast<const uint32_t*>(pb + 16);
          }
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) mma_s8(acc[mt][nt], a[mt], bf[nt][0], bf[nt][1]);
        }
      }
    }
  }

  // epilogue: acc[mt][nt][2*half + q] is pixel wm*64 + mt*16 + g + 8*half,
  // channel wn*32 + nt*8 + 2*t4 + q
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + wn * 32 + nt * 8 + 2 * t4;
    if (n >= F) continue;
    const bool pair = n + 1 < F && F % 2 == 0;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int wo = w0 + wm * 64 + mt * 16 + g + 8 * half;
        if (wo >= W) continue;
        TOut* out = y + (((size_t)b * H + h) * W + wo) * F + n;
        const int v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if constexpr (std::is_same<TOut, int>::value) {
          out[0] = v0;  // the raw s32 sums
          if (n + 1 < F) out[1] = v1;
        } else {
          const float d0 = dequant(v0, __fmul_rn(xs, ks[n]), bias, n);
          if (pair) {
            store2(out, d0, dequant(v1, __fmul_rn(xs, ks[n + 1]), bias, n + 1));
          } else {
            store1(out, d0);
            if (n + 1 < F) store1(out + 1, dequant(v1, __fmul_rn(xs, ks[n + 1]), bias, n + 1));
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256) absmax_kernel(const T* __restrict__ x, long long n,
                                                     float* __restrict__ out) {
  float m = 0.f;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = n / 8;
  for (long long i = first; i < nvec; i += stride) {
    float v[8];
    load8(x + i * 8, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[j]));
  }
  for (long long i = nvec * 8 + first; i < n; i += stride) m = fmaxf(m, fabsf(to_float(x[i])));
#pragma unroll
  for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ float warp_max[32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x / 32) ? warp_max[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o /= 2) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) atomicMax(reinterpret_cast<int*>(out), __float_as_int(m));
  }
}

template <typename TIn, typename TOut>
int launch_conv(const void* x, const void* amax, const void* wq, const void* ks, const void* bias, void* y,
                int B, int H, int W, int Cin, int Cp, int F, cudaStream_t stream) {
  const dim3 grid(H * ((W + BM - 1) / BM), (F + BN - 1) / BN, B);
  w8a8_ringconv_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const float*>(amax), static_cast<const int8_t*>(wq),
      static_cast<const float*>(ks), static_cast<const float*>(bias), static_cast<TOut*>(y), H, W, Cin, Cp,
      F);
  return static_cast<int>(cudaGetLastError());
}

template <typename TIn>
int launch_conv_out(int out_dtype, const void* x, const void* amax, const void* wq, const void* ks,
                    const void* bias, void* y, int B, int H, int W, int Cin, int Cp, int F,
                    cudaStream_t stream) {
  switch (out_dtype) {
    case 0:
      return launch_conv<TIn, float>(x, amax, wq, ks, bias, y, B, H, W, Cin, Cp, F, stream);
    case 1:
      return launch_conv<TIn, __nv_bfloat16>(x, amax, wq, ks, bias, y, B, H, W, Cin, Cp, F, stream);
    case 2:
      return launch_conv<TIn, int>(x, amax, wq, ks, bias, y, B, H, W, Cin, Cp, F, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// dtype codes: 0 float32, 1 bfloat16, 2 int32 (output only: the raw sums)
int w8a8_ringconv_launch(const void* x, int in_dtype, const void* amax, const void* wq, const void* ks,
                         const void* bias, void* y, int out_dtype, int B, int H, int W, int Cin,
                         int Cp, int F, void* stream) {
  if (Cp % BK != 0 || Cp < Cin) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0)
    return launch_conv_out<float>(out_dtype, x, amax, wq, ks, bias, y, B, H, W, Cin, Cp, F, s);
  if (in_dtype == 1)
    return launch_conv_out<__nv_bfloat16>(out_dtype, x, amax, wq, ks, bias, y, B, H, W, Cin, Cp, F, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

int absmax_launch(const void* x, int dtype, long long n, void* out, void* stream) {
  const long long blocks_needed = (n / 8 + 255) / 256;
  const int blocks = static_cast<int>(blocks_needed < 1 ? 1 : (blocks_needed > 1056 ? 1056 : blocks_needed));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    absmax_kernel<float><<<blocks, 256, 0, s>>>(static_cast<const float*>(x), n, static_cast<float*>(out));
  else if (dtype == 1)
    absmax_kernel<__nv_bfloat16><<<blocks, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(x), n,
                                                         static_cast<float*>(out));
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
