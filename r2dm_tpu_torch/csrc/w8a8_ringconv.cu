// The W8A8 int8 serving lane for Hopper (sm_90a): the absmax reduction that
// gives the dynamic activation scale, a pass that quantizes the activation
// once, and a 3x3 ring convolution on s8 x s8 -> s32 tensor-core products,
// NHWC. A quantized conv is three launches:
//
//     amax = max|x|                                         (absmax_kernel)
//     xs   = amax / 127 + 1e-12
//     xq   = clamp(round_half_even(x / xs), -127, 127)      (quantize_kernel)
//     y    = float(conv(ring_pad(xq), kq)) * (xs * ks[f]) + bias[f]
//                                                           (w8a8_ringconv_kernel)
//
// kq, ks: the fp32 master kernel quantized per output channel by the Python
// wrapper (ops/quant.py::pack_weight), packed K-major as s8 (F, 9, Cp), C_in
// zero-padded to Cp (a multiple of BK). W wraps circularly; H is zero-padded.
//
// Replaces the JAX function r2dm_tpu/ops/quant.py::ring_conv_w8a8, an XLA
// int8 convolution (quant.py:78-107), and the absmax of its act_qparams
// (quant.py:59-64), not a Pallas kernel. The arithmetic is the same: IEEE
// division (no --use_fast_math in the build), __float2int_rn (round half to
// even, as jnp.round), and an epilogue of separately rounded _rn intrinsics,
// so nvcc cannot contract the multiply and the add into one FMA as XLA does
// not. The s32 accumulators are exact and equal the plain version's; the
// fp32 output is then bit-equal to it, and so is the bf16 output (one
// round-to-nearest-even of the same fp32 value).
//
// absmax_kernel: a grid-stride pass of 16-byte loads, a warp-shuffle and a
// shared-memory max per block, then one atomicMax, all on the bits of |x| as
// int (the order of non-negative floats is the order of their bits), so the
// result is exact and independent of the order. A NaN is mapped to the
// positive quiet NaN 0x7fc00000, above +inf (0x7f800000) as an int, so one
// NaN in x makes the scale NaN and every output NaN, as in the JAX package
// (fmaxf would drop it). The wrapper zero-fills the output before the launch.
// Bound: x read once, 67 MB at level 1 b8 in bf16: 0.020 ms.
//
// quantize_kernel: x (B, H, W, C_in) bf16 or fp32 -> xq (B, H, W + 2, Cp) s8,
// each element divided once. The layout is made for the conv: the W ring's
// two columns are written in (column 0 is x's column W - 1, column W + 1 is
// its column 0) and the channels zero-padded to Cp, so every A tile of the
// conv is one rectangle of xq (no modulo in the copies; a TMA box later).
// One thread makes 16 channels of one padded pixel and stores them as one
// 16-byte vector. Bound: x read once and xq written once, 67 + 34 MB at
// level 1 b8 in bf16: 0.030 ms. Its halo'd form (kHalo, quantize_halo_launch)
// serves a width axis, where a rank holds W of the image's columns: columns
// 0 and W + 1 come from the (B, H, 1, C) strips left and right (the
// neighbours' edge columns, exchanged by the caller, in x's dtype) in place
// of the wrap, quantized with the same scale, each element divided once.
//
// w8a8_ringconv_kernel (v2): an implicit GEMM, M = BM output pixels of one
// (b, h) row segment, N = BN = 64 output channels, K = 9 x Cp, walked as
// slices of (kernel row kh, BK = 64 s8 channels); a kernel row outside
// [0, H) is skipped (its contribution is exactly zero). BM = 256 where
// W >= 256 (each warpgroup two m64 tiles; 3 stages), 128 below (4 stages).
// - Copies. Every thread issues 16-byte cp.async.ca copies of the xq halo of
//   row h + kh - 1 (BM + 2 padded columns x BK channels; columns past W + 2
//   zero-filled) and of the three kw taps' weight rows (output channels past
//   F zero-filled) into a ring of S stages (commit_group / wait_group), S - 2
//   slices ahead of the products; once a stage has landed, each thread
//   fences its copies to the async proxy (cp.async writes through the
//   generic proxy, wgmma reads through the async one) before the barrier.
// - Tensor cores. Two warpgroups, each BM/2 pixels x 64 channels, issue
//   wgmma.mma_async m64n64k32 s8 x s8 -> s32, A and B both from shared
//   memory in the no-swizzle K-major core-matrix layout (for 8-bit types
//   both operands must be K-major): A [BK/16 chunks][BM + 2 pixels][16 B],
//   B [3 taps][BK/16][BN + 2][16 B]. A 16-byte core-matrix row is one
//   pixel's (or one output channel's) 16 channels, so a descriptor has
//   SBO = 128 B (the next 8 rows) and LBO = rows x 16 B (the next 16-channel
//   chunk of a k32), and tap kw is the same A descriptor moved by kw x 16 B:
//   the three taps read one staged halo. Two pad rows per chunk keep the
//   copies' shared stores free of bank conflicts. One wgmma group stays in
//   flight across the barrier (wait_group 1): slice s + S - 2 is copied into
//   the stage that slice s - 2 left, while slice s - 1's products finish.
// - Epilogue: float(acc) * (xs * ks[n]) + bias[n], each step rounded alone,
//   from the wgmma s32 accumulator fragment (the layout of the fp32 one).
//   With whole N tiles the block's output tile goes through shared memory
//   and out as 16-byte vectors, each pixel's 64 channels one 128-byte run:
//   stored from the fragments (16-byte pieces of 8 lines per warp store),
//   level 1 took 0.126 ms against 0.079 staged (w8a8_variants.py;
//   PERF.md). A ragged N tile (out_conv's F = 2) stores from the fragments,
//   masked. The int32 form writes the raw sums.
//
// Bound at config H, b8, on an H100 SXM (1,979 int8 TOPS, 3.35 TB/s): every
// level does 2*9*C*F*B*H*W = 38.7 G int8 operations, 0.0196 ms. Level 1
// (64 -> 64 at 64x1024) moves 134 MB as the lane's function (bf16 x in, bf16
// y out: 0.040 ms, bound by bytes), 101 MB as this conv (s8 xq in: 0.030
// ms); level 2 (128 -> 128 at 32x512) is about balanced (67 MB: 0.020 ms);
// levels 3 and 4 (256 and 512 channels) are bound by operations, 0.0196 ms.
//
// Why v2 quantizes outside the conv. v1 (mma.sync m16n8k32 from 80-byte
// padded rows, no copy pipeline) read bf16 x and divided while staging, so
// each x element was quantized once per kernel row and once per 64-channel
// N tile (24 IEEE divisions per element at 512 channels), and the staging,
// through registers, could not be a cp.async: 0.353 ms at level 1 b8 and
// 15.1 ms over the 53 sites of a forward (bound 1.15), 5-6 % of the int8
// peak (NVIDIA H100 80GB HBM3, 700 W; PERF.md). The bf16 conv measured the
// same trap (csrc/act_ringconv.cu: its in-kernel prologue cost 3.0 of 7.6
// ms, because each x element was activated again for every 64 output
// channels and every kernel row), and its fix was to take the prologue out
// of the conv. Here the quantize pass divides each element once and writes
// s8, a quarter of fp32 x's bytes, which the conv copies with cp.async. v2
// measured on the same card: 0.080 ms at level 1 (the quantize pass 0.043),
// 2.91 ms over the 53 sites (the quantize pass 1.19). What bounds it now:
// at level 1 the three slices a block are too few to hide the copies'
// latency, and every block copies the whole 36 KB weight again; at 256 and
// 512 channels, n64 products from shared memory read as many bytes of A as
// of B. Next: a persistent grid that keeps the weight resident, and a real
// m64n128k32 / m64n256k32 (a 128-channel tile of two n64 products did not
// help).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BN = 64;          // output channels per block
constexpr int BK = 64;          // input channels (s8 bytes) per slice
constexpr int kThreads = 256;   // two warpgroups
constexpr int CH = BK / 16;     // 16-byte channel chunks per slice
constexpr int B_ROWS = BN + 2;  // two pad rows: chunk stride = 32 mod 128 B
constexpr int B_TAP_BYTES = CH * B_ROWS * 16;
constexpr int kVecB = 3 * BN * CH;  // 16-byte vectors per weight slice
constexpr int kPerB = (kVecB + kThreads - 1) / kThreads;

// The tile of one block: MT m64 tiles per warpgroup (BM = 128 MT output
// pixels of one row segment; MT = 2 where W >= 256), S ring stages (two
// slices copied ahead, one computing, one in flight at S = 4; one ahead at
// S = 3, which keeps two blocks of MT = 2 on an SM).
template <int MT>
struct Tile {
  static constexpr int S = MT == 1 ? 4 : 3;
  static constexpr int BM = 128 * MT;
  static constexpr int A_ROWS = BM + 2;  // halo pixels
  static constexpr int A_BYTES = CH * A_ROWS * 16;
  static constexpr int STAGE_BYTES = A_BYTES + 3 * B_TAP_BYTES;
  static constexpr int SMEM_BYTES = S * STAGE_BYTES;
  static constexpr int kVecA = A_ROWS * CH;  // 16-byte vectors per halo
  static constexpr int kPerA = (kVecA + kThreads - 1) / kThreads;
  static_assert(A_BYTES % 16 == 0 && S >= 3, "16-byte rows; one slice computing and one in flight");
};
constexpr int QV = 16;  // channels per thread of the quantize pass (one 16-byte store)
constexpr float kQmax = 127.f;
constexpr float kEps = 1e-12f;
constexpr int kQuietNaN = 0x7fc00000;
constexpr int kInf = 0x7f800000;
static_assert(kThreads % CH == 0, "a thread keeps one channel chunk");
static_assert(B_TAP_BYTES % 16 == 0, "16-byte rows");
static_assert(BK % 32 == 0 && BN == 64 && BK % QV == 0, "m64n64k32 steps");

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

// |v| as the bits of a non-negative int; every NaN as the positive quiet NaN
__device__ __forceinline__ int abs_bits(float v) {
  const int i = __float_as_int(v) & 0x7fffffff;
  return i > kInf ? kQuietNaN : i;
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

// 16-byte copy global -> shared; src_bytes 0 zero-fills the destination
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
__device__ __forceinline__ void fence_acc(int (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A (64 x 32 s8, K-major) * B (32 x 64 s8, K-major), both from shared
// memory, s32 accumulators. The integer form has no transpose or negate
// operands, only scale-d; no .satfinite: the sums are exact and cannot
// overflow (|sum| <= 9 Cp 127^2 < 2^31).
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
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

template <typename TOut, int MT>
__global__ void __launch_bounds__(kThreads, 2) w8a8_ringconv_kernel(
    const int8_t* __restrict__ xq, const float* __restrict__ amax, const int8_t* __restrict__ wq,
    const float* __restrict__ ks, const float* __restrict__ bias, TOut* __restrict__ y, int H, int W,
    int Cp, int F) {
  using T = Tile<MT>;
  constexpr int S = T::S, A_ROWS = T::A_ROWS, A_BYTES = T::A_BYTES, STAGE_BYTES = T::STAGE_BYTES;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const int Wp = W + 2;
  const int tiles_w = (W + T::BM - 1) / T::BM;
  const int h = blockIdx.x / tiles_w;
  const int w0 = (blockIdx.x % tiles_w) * T::BM;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int ch = tid % CH;  // this thread's channel chunk in every slice

  // slices (kh, c0), kernel rows that fall in the H padding left out
  const int kh_lo = h == 0 ? 1 : 0;
  const int kh_hi = h == H - 1 ? 1 : 2;
  const int n_c = Cp / BK;
  const int n_slices = (kh_hi - kh_lo + 1) * n_c;

  auto issue = [&](int s) {
    if (s < n_slices) {
      const int kh = kh_lo + s / n_c;
      const int c = (s % n_c) * BK + ch * 16;
      const uint32_t st = sbase + (s % S) * STAGE_BYTES;
      // padded column w0 + r of row h + kh - 1: halo pixel r
      const int8_t* xrow = xq + (((size_t)b * H + (h + kh - 1)) * Wp + w0) * Cp + c;
#pragma unroll
      for (int k = 0; k < T::kPerA; ++k) {
        const int i = tid + k * kThreads;
        if (T::kVecA % kThreads == 0 || i < T::kVecA) {
          const int r = i / CH;
          const bool ok = w0 + r < Wp;
          cp16(st + (ch * A_ROWS + r) * 16, ok ? xrow + (size_t)r * Cp : xq, ok ? 16 : 0);
        }
      }
#pragma unroll
      for (int k = 0; k < kPerB; ++k) {
        const int j = tid + k * kThreads;
        if (kVecB % kThreads == 0 || j < kVecB) {
          const int tap = j / (BN * CH), n = (j % (BN * CH)) / CH;
          const bool ok = n0 + n < F;
          const int8_t* src = ok ? wq + ((size_t)(n0 + n) * 9 + kh * 3 + tap) * Cp + c : wq;
          cp16(st + A_BYTES + tap * B_TAP_BYTES + (ch * B_ROWS + n) * 16, src, ok ? 16 : 0);
        }
      }
    }
    cp_commit();  // an empty group past the last slice keeps the count
  };

  // warpgroup g computes pixels g*64*MT .. (g + 1)*64*MT - 1 of the block,
  // m64 tile mt of them from mt*64
  const int g = tid / 128;
  const uint64_t da0 = smem_desc(sbase + g * 64 * MT * 16, A_ROWS * 16, 128);
  const uint64_t db0 = smem_desc(sbase + A_BYTES, B_ROWS * 16, 128);

  int acc[MT][32];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[mt][i] = 0;

  for (int s = 0; s < S - 2; ++s) issue(s);

  for (int s = 0; s < n_slices; ++s) {
    cp_wait<S - 3>();  // this thread's copies of slice s have landed
    fence_proxy_async();
    // every thread's copies of slice s are visible; both warpgroups are past
    // the wait for slice s - 2's products, so its stage is free
    __syncthreads();
    issue(s + S - 2);
    // tensor cores on slice s (descriptor addresses in 16-byte units)
    const uint64_t st16 = (s % S) * (STAGE_BYTES / 16);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    wgmma_fence();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int tap = 0; tap < 3; ++tap)
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk)
          wgmma_m64n64k32_s8(acc[mt], da0 + st16 + mt * 64 + tap + kk * 2 * A_ROWS,
                             db0 + st16 + tap * (B_TAP_BYTES / 16) + kk * 2 * B_ROWS);
    wgmma_commit();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    wgmma_wait<1>();  // slice s - 1's products are done
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);

  // epilogue: accumulator d[4j + q] of warp wr, lane l holds pixel
  // 16*wr + l/4 + 8*(q/2), channel 8j + 2*(l%4) + q%2 of its m64 tile
  const int wr = (tid % 128) / 32, lane = tid % 32;
  const float xs = act_scale(amax);
  // the output pair (channels n, n + 1) of the sums v0, v1 at out
  auto put2 = [&](TOut* out, int v0, int v1, int n) {
    if constexpr (std::is_same<TOut, int>::value) {
      *reinterpret_cast<int2*>(out) = make_int2(v0, v1);  // the raw s32 sums
    } else {
      store2(out, dequant(v0, __fmul_rn(xs, ks[n]), bias, n), dequant(v1, __fmul_rn(xs, ks[n + 1]), bias, n + 1));
    }
  };
  if (F % BN == 0) {
    // whole N tiles: the block's tile goes through shared memory (rows of
    // RS bytes, 16 pad bytes keep the pair stores free of bank conflicts),
    // then out as 16-byte vectors, each pixel's BN channels one run of
    // 128 or 256 bytes
    constexpr int RS = BN * sizeof(TOut) + 16;
    constexpr int VPR = BN * sizeof(TOut) / 16;
    static_assert(T::BM * RS <= T::SMEM_BYTES, "the output tile fits the ring");
    __syncthreads();  // both warpgroups' products are done with the stages
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int p = (g * MT + mt) * 64 + wr * 16 + lane / 4 + half * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = j * 8 + 2 * (lane % 4);
          put2(reinterpret_cast<TOut*>(smem + p * RS) + n, acc[mt][4 * j + 2 * half], acc[mt][4 * j + 2 * half + 1],
               n0 + n);
        }
      }
    __syncthreads();
    TOut* yrow = y + (((size_t)b * H + h) * W + w0) * F + n0;
    for (int i = tid; i < T::BM * VPR; i += kThreads) {
      const int p = i / VPR, v = i % VPR;
      if (w0 + p < W)
        *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(yrow + (size_t)p * F) + v * 16) =
            *reinterpret_cast<const uint4*>(smem + p * RS + v * 16);
    }
    return;
  }
  // a ragged N tile (out_conv's F = 2): each value stored from its fragment
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + j * 8 + 2 * (lane % 4);
    if (n >= F) continue;
    const bool has1 = n + 1 < F;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int wo = w0 + (g * MT + mt) * 64 + wr * 16 + lane / 4 + half * 8;
        if (wo >= W) continue;
        TOut* out = y + (((size_t)b * H + h) * W + wo) * F + n;
        const int v0 = acc[mt][4 * j + 2 * half], v1 = acc[mt][4 * j + 2 * half + 1];
        if (has1 && F % 2 == 0) {
          put2(out, v0, v1, n);
        } else if constexpr (std::is_same<TOut, int>::value) {
          out[0] = v0;
          if (has1) out[1] = v1;
        } else {
          store1(out, dequant(v0, __fmul_rn(xs, ks[n]), bias, n));
          if (has1) store1(out + 1, dequant(v1, __fmul_rn(xs, ks[n + 1]), bias, n + 1));
        }
      }
    }
  }
}

template <typename T, bool kHalo>
__global__ void __launch_bounds__(256) quantize_kernel(const T* __restrict__ x, const T* __restrict__ left,
                                                       const T* __restrict__ right, const float* __restrict__ amax,
                                                       int8_t* __restrict__ xq, long long rows, int W, int C,
                                                       int Cp) {
  const float xs = act_scale(amax);
  const int Wp = W + 2, nv = Cp / QV;
  const long long n = rows * Wp * nv;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const bool vec = C % 8 == 0;  // 16-byte aligned groups of 8 channels
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const int c = static_cast<int>(i % nv) * QV;
    const long long pix = i / nv;  // padded pixel (row, wp)
    const long long row = pix / Wp;
    const int wp = static_cast<int>(pix % Wp);
    const T* src;
    if (kHalo && wp == 0) {
      src = left + row * C + c;  // the left neighbour's last column
    } else if (kHalo && wp == W + 1) {
      src = right + row * C + c;  // the right neighbour's first column
    } else {
      const int w = wp == 0 ? W - 1 : (wp > W ? 0 : wp - 1);  // the ring
      src = x + (row * W + w) * C + c;
    }
    float v[QV];
    if (vec) {
      // C % 8 == 0: c < C means c + 8 <= C, and c + 8 < C means c + 16 <= C
      if (c < C) {
        load8(src, v);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = 0.f;
      }
      if (c + 8 < C) {
        load8(src + 8, v + 8);
      } else {
#pragma unroll
        for (int j = 8; j < QV; ++j) v[j] = 0.f;
      }
    } else {
#pragma unroll
      for (int j = 0; j < QV; ++j) v[j] = c + j < C ? to_float(src[j]) : 0.f;
    }
    *reinterpret_cast<uint4*>(xq + pix * Cp + c) =
        make_uint4(pack4(v, xs), pack4(v + 4, xs), pack4(v + 8, xs), pack4(v + 12, xs));
  }
}

template <typename T>
__global__ void __launch_bounds__(256) absmax_kernel(const T* __restrict__ x, long long n,
                                                     float* __restrict__ out) {
  int m = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = n / 8;
  for (long long i = first; i < nvec; i += stride) {
    float v[8];
    load8(x + i * 8, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = max(m, abs_bits(v[j]));
  }
  for (long long i = nvec * 8 + first; i < n; i += stride) m = max(m, abs_bits(to_float(x[i])));
#pragma unroll
  for (int o = 16; o > 0; o /= 2) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
  __shared__ int warp_max[32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = lane < (int)(blockDim.x / 32) ? warp_max[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o /= 2) m = max(m, __shfl_xor_sync(0xffffffffu, m, o));
    if (lane == 0) atomicMax(reinterpret_cast<int*>(out), m);
  }
}

int grid_stride_blocks(long long work) {
  const long long blocks = (work + 255) / 256;
  return static_cast<int>(blocks < 1 ? 1 : (blocks > 1056 ? 1056 : blocks));
}

template <typename TOut, int MT>
int launch_tile(const void* xq, const void* amax, const void* wq, const void* ks, const void* bias, void* y,
                int B, int H, int W, int Cp, int F, cudaStream_t stream) {
  constexpr int smem = Tile<MT>::SMEM_BYTES;
  // above 48 KB, dynamic shared memory has to be asked for once
  static const cudaError_t attr =
      cudaFuncSetAttribute(w8a8_ringconv_kernel<TOut, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(H * ((W + Tile<MT>::BM - 1) / Tile<MT>::BM), (F + BN - 1) / BN, B);
  w8a8_ringconv_kernel<TOut, MT><<<grid, kThreads, smem, stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(amax), static_cast<const int8_t*>(wq),
      static_cast<const float*>(ks), static_cast<const float*>(bias), static_cast<TOut*>(y), H, W, Cp, F);
  return static_cast<int>(cudaGetLastError());
}

// 256-pixel tiles where a row holds at least one, 128 below
template <typename TOut>
int launch_conv(const void* xq, const void* amax, const void* wq, const void* ks, const void* bias, void* y,
                int B, int H, int W, int Cp, int F, cudaStream_t stream) {
  return W >= 256 ? launch_tile<TOut, 2>(xq, amax, wq, ks, bias, y, B, H, W, Cp, F, stream)
                  : launch_tile<TOut, 1>(xq, amax, wq, ks, bias, y, B, H, W, Cp, F, stream);
}

template <bool kHalo>
int launch_quantize(const void* x, const void* left, const void* right, int dtype, const void* amax, void* xq,
                    long long rows, int W, int C, int Cp, void* stream) {
  if (Cp % QV != 0 || Cp < C) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = grid_stride_blocks(rows * (W + 2) * (Cp / QV));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(amax);
  int8_t* q = static_cast<int8_t*>(xq);
  if (dtype == 0) {
    using T = float;
    quantize_kernel<T, kHalo><<<blocks, 256, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(left),
                                                     static_cast<const T*>(right), a, q, rows, W, C, Cp);
  } else if (dtype == 1) {
    using T = __nv_bfloat16;
    quantize_kernel<T, kHalo><<<blocks, 256, 0, s>>>(static_cast<const T*>(x), static_cast<const T*>(left),
                                                     static_cast<const T*>(right), a, q, rows, W, C, Cp);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// xq: s8 (B, H, W + 2, Cp) from quantize_launch. out_dtype: 0 float32,
// 1 bfloat16, 2 int32 (the raw sums)
int w8a8_ringconv_launch(const void* xq, const void* amax, const void* wq, const void* ks, const void* bias,
                         void* y, int out_dtype, int B, int H, int W, int Cp, int F, void* stream) {
  if (Cp % BK != 0 || Cp < BK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return launch_conv<float>(xq, amax, wq, ks, bias, y, B, H, W, Cp, F, s);
    case 1:
      return launch_conv<__nv_bfloat16>(xq, amax, wq, ks, bias, y, B, H, W, Cp, F, s);
    case 2:
      return launch_conv<int>(xq, amax, wq, ks, bias, y, B, H, W, Cp, F, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// x: (rows = B*H, W, C) in dtype (0 float32, 1 bfloat16) -> xq (rows, W + 2, Cp) s8
int quantize_launch(const void* x, int dtype, const void* amax, void* xq, long long rows, int W, int C, int Cp,
                    void* stream) {
  return launch_quantize<false>(x, nullptr, nullptr, dtype, amax, xq, rows, W, C, Cp, stream);
}

// the halo'd form: left, right (rows, 1, C) in x's dtype give columns 0 and W + 1
int quantize_halo_launch(const void* x, const void* left, const void* right, int dtype, const void* amax, void* xq,
                         long long rows, int W, int C, int Cp, void* stream) {
  return launch_quantize<true>(x, left, right, dtype, amax, xq, rows, W, C, Cp, stream);
}

int absmax_launch(const void* x, int dtype, long long n, void* out, void* stream) {
  const int blocks = grid_stride_blocks(n / 8);
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
