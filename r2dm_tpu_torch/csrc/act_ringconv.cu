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
// Design (v3): an implicit GEMM with M = BM output pixels of one (b, h) row
// segment, N = BN output channels, K = 9 taps x C_in, walked as slices of
// (kernel row kh, BK input channels). A kernel row outside [0, H) is
// skipped: its contribution is exactly zero.
//
// - Copies. Every thread issues 16-byte cp.async.ca copies of the RAW x halo of
//   row h + kh - 1 ((BM + 2) pixels x BK channels, the W index taken mod W per
//   vector: the ring) and of the three kw taps' weight tiles into a ring of S
//   shared-memory stages (commit_group / wait_group S-2). Channels past C_in
//   and output channels past F are zero-filled (src-size 0).
// - Prologue. Once a stage has landed, each thread applies silu(x*a + b) in
//   fp32 to the halo vectors it copied itself, in place, rounded to bf16 once,
//   then fence.proxy.async: the writes go through the generic proxy and wgmma
//   reads through the async proxy. This runs while the previous slice's
//   wgmma work is in flight, so the tensor cores do not wait for it.
// - Tensor cores. Two warpgroups, each 64 pixels x 64 channels, issue
//   wgmma.mma_async m64n64k16 (bf16 in, fp32 accumulate), A and B both from
//   shared memory in the no-swizzle K-major core-matrix layout:
//   A [BK/8 chunks][BM + 2 pixels][8 channels], B [3 taps][BK/8][BN + 2][8].
//   A 16-byte row is one pixel's (or one output channel's) 8 channels, so a
//   descriptor has SBO = 128 B (next 8 rows) and LBO = rows x 16 B (next
//   channel chunk), and tap kw is the same A descriptor moved by kw x 16 B:
//   the three taps read one staged halo. (A 128-byte swizzle would break
//   under a one-pixel shift.) Two pad rows per chunk make the copies' shared
//   stores bank-conflict free. Three stages of 20,992 B are 62,976 B of
//   dynamic shared memory, asked for once by the launcher.
// - Epilogue: bias in fp32, bf16 pairs from the wgmma accumulator layout,
//   ragged W and F masked.
//
// Bound on an H100 SXM at config H, level 1, 64 -> 64 channels, per image:
// 2*9*64*64*65536 = 4.83 GFLOP (4.9 us at 989 TFLOP/s bf16) against 8.4 MB
// in + 8.4 MB out (5.0 us at 3.35 TB/s). What bounds v3, from ablations on
// an H100 80GB HBM3 at 700 W (summed over the 48 launches of a b8 forward,
// 7.6 ms in all against a 1.47 ms bound; PERF.md): the wgmma skeleton alone
// takes 3.7 ms, with a full wgmma.wait_group 0 and a barrier every slice;
// the prologue adds 3.0 ms, SFU-bound, because each x element is activated
// again for every 64 output channels and every kernel row that reads it;
// the copies add 0.9 ms. Deep layers (48 slices a block) run no faster than
// level 1 (6 slices), so pipeline fill is not the limit. Next, in order:
// take the prologue out of the conv (the GN statistics pass writes the
// activated x once), pack the weight once instead of per call, then TMA,
// a producer warp with setmaxnreg, and a persistent grid.
//
// The halo'd form (kHalo, act_ringconv_halo_launch): under a width axis a
// rank holds Wl of the image's columns, x (B, H, Wl, C_in), and the two
// one-column strips its neighbours' columns give the ring (left, right:
// (B, H, 1, C_in) each, from parallel/width.py::halo_exchange). The copies
// read pixel -1 from the left strip and pixel Wl from the right strip (and
// any pixel past Wl, which only masked outputs read, from the right strip
// too) and write Wl output columns; no padded copy of x is made. Everything
// else (the stages, the prologue, wgmma, the tiling) is v3's, and the ring
// form compiles as before.
//
// Requirements (checked by the Python wrapper): C_in % 8 == 0, F % 8 == 0,
// contiguous NHWC x and a, b on 16-byte boundaries, weight packed as
// (F, 9*C_in) bf16 with column (kh*3 + kw)*C_in + c (ops/act_ringconv.py::
// pack_weight).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;         // output pixels per block (one row segment)
constexpr int BN = 64;          // output channels per block
constexpr int BK = 32;          // input channels per slice
constexpr int S = 3;            // ring stages
constexpr int kThreads = 256;   // two warpgroups, 64 pixels each
constexpr int CH = BK / 8;      // 16-byte channel chunks per slice
constexpr int A_ROWS = BM + 2;  // halo pixels
constexpr int B_ROWS = BN + 2;  // two pad rows: chunk stride = 32 mod 128 B
constexpr int A_BYTES = CH * A_ROWS * 16;
constexpr int B_TAP_BYTES = CH * B_ROWS * 16;
constexpr int STAGE_BYTES = A_BYTES + 3 * B_TAP_BYTES;
constexpr int SMEM_BYTES = S * STAGE_BYTES;
constexpr int kVecA = A_ROWS * CH;  // 16-byte vectors per halo
constexpr int kVecB = 3 * BN * CH;  // 16-byte vectors per weight slice
constexpr int kPerA = (kVecA + kThreads - 1) / kThreads;
constexpr int kPerB = (kVecB + kThreads - 1) / kThreads;
static_assert(kThreads % CH == 0, "a thread keeps one channel chunk");
static_assert(A_BYTES % 16 == 0 && B_TAP_BYTES % 16 == 0, "16-byte rows");
static_assert(BK % 16 == 0 && BN == 64, "m64n64k16 steps");

// silu(x*a + b) on 8 bf16 channels in fp32, rounded to bf16 once. The fast
// divide is within 2 ulp of fp32, far below the bf16 rounding that follows.
__device__ __forceinline__ uint4 act8(uint4 u, const float (&av)[8], const float (&bv)[8]) {
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

// 16-byte copy global -> shared; src_bytes 0 zero-fills the destination.
// .ca, not .cg: slice c + 1 reads the other half of the 128-byte lines that
// slice c read (BK = 32 channels is 64 bytes), and L1 serves it.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// generic-proxy writes to shared memory -> visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// shared-memory matrix descriptor, no swizzle (layout type 0), base offset 0
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// keeps the compiler from moving accumulator registers across the async
// wgmma issue / wait
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d += A (64 x 16, K-major) * B (16 x 64, K-major), both from shared memory
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <bool kHalo>
__global__ void __launch_bounds__(kThreads, 2) act_ringconv_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ left,
    const __nv_bfloat16* __restrict__ right, const float* __restrict__ pa,
    const float* __restrict__ pb, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int H,
    int W, int Cin, int F, int apply_act) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int tiles_w = (W + BM - 1) / BM;
  const int h = blockIdx.x / tiles_w;
  const int w0 = (blockIdx.x % tiles_w) * BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ch = tid % CH;  // this thread's channel chunk in every slice

  // slices (kh, c0), kernel rows that fall in the H padding left out
  const int kh_lo = h == 0 ? 1 : 0;
  const int kh_hi = h == H - 1 ? 1 : 2;
  const int n_c = (Cin + BK - 1) / BK;
  const int n_slices = (kh_hi - kh_lo + 1) * n_c;

  // halo vector i = tid + k*kThreads is pixel i / CH, chunk ch; its W index
  // wraps (the ring), or, in the halo'd form, pixel -1 comes from the left
  // strip and pixels from W on from the right strip (a_src 1 and 2)
  int a_off[kPerA];
  int a_src[kPerA];
#pragma unroll
  for (int k = 0; k < kPerA; ++k) {
    int win = w0 - 1 + (tid + k * kThreads) / CH;
    if constexpr (kHalo) {
      a_src[k] = win < 0 ? 1 : (win >= W ? 2 : 0);
      a_off[k] = a_src[k] ? 0 : win * Cin;
    } else {
      win %= W;
      a_src[k] = 0;
      a_off[k] = (win < 0 ? win + W : win) * Cin;
    }
  }

  auto issue = [&](int s) {
    if (s < n_slices) {
      const int kh = kh_lo + s / n_c;
      const int c = (s % n_c) * BK + ch * 8;
      const int c_bytes = c < Cin ? 16 : 0;
      const uint32_t st = sbase + (s % S) * STAGE_BYTES;
      const size_t row = (size_t)b * H + (h + kh - 1);
      const int cc = c_bytes ? c : 0;
      const __nv_bfloat16* xrow = x + row * W * Cin + cc;
#pragma unroll
      for (int k = 0; k < kPerA; ++k) {
        const int i = tid + k * kThreads;
        if (kVecA % kThreads == 0 || i < kVecA) {
          const __nv_bfloat16* src = xrow + a_off[k];
          if constexpr (kHalo) {
            if (a_src[k]) src = (a_src[k] == 1 ? left : right) + row * Cin + cc;
          }
          cp16(st + (ch * A_ROWS + i / CH) * 16, src, c_bytes);
        }
      }
#pragma unroll
      for (int k = 0; k < kPerB; ++k) {
        const int j = tid + k * kThreads;
        if (kVecB % kThreads == 0 || j < kVecB) {
          const int tap = j / (BN * CH), n = (j % (BN * CH)) / CH;
          const bool ok = c_bytes && n0 + n < F;
          const __nv_bfloat16* src = ok ? w + (size_t)(n0 + n) * 9 * Cin + (kh * 3 + tap) * Cin + c : w;
          cp16(st + A_BYTES + tap * B_TAP_BYTES + (ch * B_ROWS + n) * 16, src, ok ? 16 : 0);
        }
      }
    }
    cp_commit();  // an empty group past the last slice keeps the count
  };

  // the prologue, in place, on the halo vectors this thread copied
  auto transform = [&](int s) {
    if (!apply_act || s >= n_slices) return;
    const int c = (s % n_c) * BK + ch * 8;
    if (c >= Cin) return;  // zero-filled channels stay zero
    const float4* qa = reinterpret_cast<const float4*>(pa + (size_t)b * Cin + c);
    const float4* qb = reinterpret_cast<const float4*>(pb + (size_t)b * Cin + c);
    const float4 a0 = qa[0], a1 = qa[1], b0 = qb[0], b1 = qb[1];
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
    uint8_t* st = smem + (s % S) * STAGE_BYTES;
#pragma unroll
    for (int k = 0; k < kPerA; ++k) {
      const int i = tid + k * kThreads;
      if (kVecA % kThreads == 0 || i < kVecA) {
        uint4* p = reinterpret_cast<uint4*>(st + (ch * A_ROWS + i / CH) * 16);
        *p = act8(*p, av, bv);
      }
    }
  };

  // warpgroup g computes pixels g*64 .. g*64 + 63 of the block
  const int g = tid / 128;
  const uint64_t da0 = smem_desc(sbase + g * 64 * 16, A_ROWS * 16, 128);
  const uint64_t db0 = smem_desc(sbase + A_BYTES, B_ROWS * 16, 128);

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;

  for (int s = 0; s < S - 1; ++s) issue(s);
  cp_wait<S - 2>();
  transform(0);
  fence_proxy_async();
  __syncthreads();

  for (int s = 0; s < n_slices; ++s) {
    // tensor cores on slice s (descriptor addresses in 16-byte units)
    const uint64_t st16 = (s % S) * (STAGE_BYTES / 16);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 3; ++tap)
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_m64n64k16(acc, da0 + st16 + tap + kk * 2 * A_ROWS,
                        db0 + st16 + tap * (B_TAP_BYTES / 16) + kk * 2 * B_ROWS);
    wgmma_commit();
    fence_acc(acc);
    // meanwhile: copies of slice s + S - 1 into the stage slice s - 1 left
    // free, and the prologue of slice s + 1
    issue(s + S - 1);
    cp_wait<S - 2>();
    transform(s + 1);
    fence_proxy_async();
    wgmma_wait0();
    fence_acc(acc);
    __syncthreads();  // slice s + 1 ready; stage of slice s free
  }

  // epilogue: accumulator d[4j + q] of warp wr, lane l holds pixel
  // 16*wr + l/4 + 8*(q/2), channel 8j + 2*(l%4) + q%2
  const int wr = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + j * 8 + 2 * (lane % 4);
    if (n >= F) continue;
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int wo = w0 + g * 64 + wr * 16 + lane / 4 + half * 8;
      if (wo >= W) continue;
      *reinterpret_cast<__nv_bfloat162*>(y + (((size_t)b * H + h) * W + wo) * F + n) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] + b0, acc[4 * j + 2 * half + 1] + b1);
    }
  }
}

template <bool kHalo>
int launch(const void* x, const void* left, const void* right, const void* a,
           const void* b, const void* w, const void* bias, void* y, int B, int H,
           int W, int Cin, int F, int apply_act, void* stream) {
  // above 48 KB, dynamic shared memory has to be asked for once
  static const cudaError_t attr = cudaFuncSetAttribute(
      act_ringconv_kernel<kHalo>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(H * ((W + BM - 1) / BM), (F + BN - 1) / BN, B);
  act_ringconv_kernel<kHalo><<<grid, kThreads, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(left),
      static_cast<const __nv_bfloat16*>(right), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), H, W,
      Cin, F, apply_act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int act_ringconv_launch(const void* x, const void* a, const void* b,
                        const void* w, const void* bias, void* y, int B, int H,
                        int W, int Cin, int F, int apply_act, void* stream) {
  return launch<false>(x, nullptr, nullptr, a, b, w, bias, y, B, H, W, Cin, F, apply_act, stream);
}

// the halo'd form: x (B, H, W, Cin) holds a rank's W columns, left and right
// (B, H, 1, Cin) its neighbours' edge columns
int act_ringconv_halo_launch(const void* x, const void* left, const void* right,
                             const void* a, const void* b, const void* w,
                             const void* bias, void* y, int B, int H, int W, int Cin,
                             int F, int apply_act, void* stream) {
  return launch<true>(x, left, right, a, b, w, bias, y, B, H, W, Cin, F, apply_act, stream);
}

}  // extern "C"
