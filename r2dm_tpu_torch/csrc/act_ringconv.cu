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
// The work: an implicit GEMM with M = output pixels, N = F output channels,
// K = 9 taps x C_in. At config H every level but the first is bound by
// operations (576-2,304 FLOP a byte against the card's 295); level 1
// (64 -> 64 at 64x1024) sits at the ridge. What bounded v3, the kernel this
// one replaced (32.7 % of its roofline at b256): a block-wide barrier and a
// full wgmma.wait_group 0 on every 32-channel slice, so the tensor cores
// drained every few hundred cycles, and copies issued by every thread with
// per-thread address arithmetic.
//
// Design (v4): a persistent, warp-specialised kernel, one block of 384
// threads an SM. What bounds it, by ablation (PERF.md): at levels 2-4 the
// copies, which alone take 70-90 % of the kernel's time with the tensor
// cores off: the L2 -> SM traffic of the re-read operands (each x row read
// for three kernel rows, the weights again for every tile), 5-7 TB/s by
// count at b256. At level 1 not the weights' traffic (the whole weight kept
// in shared memory gained 3 %); most likely the shared memory the m64n64
// products read, 4 KB for 131 kFLOP, the ridge of its 128 B a clock.
// - Tiles. A tile is BM = 128 MT output pixels of one (b, h) row segment by
//   BN output channels; its K loop walks slices of (kernel row kh, BK input
//   channels), a kernel row outside [0, H) skipped (its contribution is
//   exactly zero). BN and MT are template arguments, one instantiation per
//   tile variant (Tile<BN, MT>), named by the wrapper by its geometry;
//   ops/act_ringconv.py::tile_variant picks one from the shape: BN = 64 at
//   F = 64 (with MT = 2, 256-pixel tiles: half the weight reads a pixel),
//   256 at F > 128 where that still gives every SM a tile, else 128. A wider
//   N tile reads each staged halo byte for more output channels, and each
//   weight byte for as many pixels. The grid is min(tiles, SMs); block i takes tiles i,
//   i + grid, ..., neighbouring tiles sharing their x rows in L2.
// - Producer warpgroup (setmaxnreg down to 40 registers, the consumers up
//   to 232). One thread issues, per slice, one bulk copy of the weights
//   (cp.async.bulk, the TMA's 1D form: the launch packs the weight so that
//   a slice is one contiguous run in the layout wgmma reads) and one TMA box
//   of the x tensor map per 16 channels: the row segment's BM pixels x 16
//   channels, whole 32-byte sectors, written in the 32-byte swizzle (channels
//   past C_in zero-filled by the TMA). The ring's wrap, the one irregular
//   part, is the two halo pixels no box reaches (pixel w0 - 1 and w0 + BM,
//   taken mod W): four or eight 16-byte cp.async a slice, then
//   cp.async.mbarrier.arrive.noinc. The stage's full barrier completes when
//   the boxes' and the bulk copy's bytes and those copies have landed. A
//   ragged last row segment (W % BM != 0) or the SiLU prologue takes a
//   cp.async path: the 128 threads copy the whole halo (the W index taken
//   mod W per vector); with apply_act they wait for their copies, apply
//   silu(x*a + b) in place in fp32 (rounded to bf16 once), fence them to
//   the async proxy and arrive (slower; no path of the cells uses it).
// - A ring of S stages (up to 6, as many as shared memory holds beside the
//   staging tiles), each with a full and an empty mbarrier; no block-wide
//   barrier in the loop.
// - Two consumer warpgroups, each 64 MT pixels x BN channels, issue
//   wgmma.mma_async m64nBNk16 (bf16 in, fp32 accumulate), A and B from
//   shared memory. A, the halo, is K-major in the 32-byte swizzle: one
//   plane of 32-byte rows (16 channels, a k16 step) per 16 channels, SBO =
//   256 B (next 8 rows), and tap kw is the same descriptor moved by kw rows,
//   so the three taps read one staged halo. The swizzle is a function of
//   the address (bit 4 ^= bit 7), so a descriptor started one row in reads
//   the rows as the TMA wrote them. B, the weights, is K-major without
//   swizzle: [3 taps][BK/8][BN][8], SBO = 128 B, LBO = BN x 16 B. A
//   slice's products are one wgmma group; the next slice is issued
//   before waiting, with wait_group 1, so one group is always in flight, and
//   a stage is released (one arrive a consumer warp) only once the group
//   that read it has retired.
// - Epilogue: bias added in fp32 and rounded to bf16 once; each warpgroup
//   stages its tile through shared memory (rows padded by 16 bytes, so the
//   fragments' stores are free of bank conflicts) and writes 16-byte
//   vectors, each pixel's channels one contiguous run, ragged W and F
//   masked. It overlaps the producer's copies of the block's next tile.
// - The tensor map (x seen as (C_in, B*H*W pixels), (16, BM) boxes) is
//   encoded with cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint (no link to the driver library), once per
//   (pointer, shape), in a small cache: the caching allocator hands the
//   same activations' addresses out call after call.
//
// Bound on an H100 SXM at config H, level 1, 64 -> 64 channels, per image:
// 2*9*64*64*65536 = 4.83 GFLOP (4.9 us at 989 TFLOP/s bf16) against 8.4 MB
// in + 8.4 MB out (5.0 us at 3.35 TB/s). The measured times, per level and
// against v3, are in PERF.md.
//
// The halo'd form (kHalo, act_ringconv_halo_launch): under a width axis a
// rank holds W of the image's columns, x (B, H, W, C_in), and the two
// one-column strips its neighbours' columns give the ring (left, right:
// (B, H, 1, C_in) each, from parallel/width.py::halo_exchange). The copies
// read pixel -1 from the left strip and pixel W from the right strip (and
// any pixel past W, which only masked outputs read, from the right strip
// too) and write W output columns; no padded copy of x is made: the TMA
// boxes read x, the wrap pixels' copies the strips. Everything else is the
// ring form's.
//
// Requirements (checked by the Python wrapper): C_in % 8 == 0, F % 8 == 0,
// contiguous NHWC x and a, b on 16-byte boundaries. The weight comes as the
// HWIO view the model holds (fp32 or bf16, any strides); each launch first
// packs it (pack_kernel, one pass with the cast) into the layout
// ops/act_ringconv.py::pack_weight defines: bf16
// [F/BN][3 kh][C_in/BK][3 kw][BK/8][BN][8], C_in and F zero-padded to
// multiples of BK and BN, so slice (n tile, kh, channel slice) is one
// contiguous run of 3 x BK x BN values.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kThreads = 384;           // producer warpgroup + two consumer warpgroups
constexpr int kSmemLimit = 232448;      // dynamic shared memory a block may have on sm_90
// arrivals a stage's full barrier waits for: with TMA, thread 0's
// expect_tx and its cp.async arrive; else the 128 producer threads' and the
// expect_tx
constexpr int kFullArrivalsTma = 2;
constexpr int kFullArrivalsCopy = 128 + 1;
constexpr int kEmptyArrivals = 8;       // one a consumer warp

// One tile variant: BN output channels, MT m64 tiles per consumer
// warpgroup (BM = 128 MT pixels), BK input channels a slice, S stages.
template <int BN_, int MT_>
struct Tile {
  static constexpr int BN = BN_;
  static constexpr int MT = MT_;
  static constexpr int BM = 128 * MT;
  static constexpr int BK = BN == 256 ? 16 : 32;
  static constexpr int CH = BK / 8;  // 16-byte channel chunks a slice
  // the halo: one plane of 32-byte rows (16 channels) per 16 channels of
  // the slice, pixel w0 - 1 + r at row 7 + r, so the BM pixels of the row
  // segment start 256-byte aligned (a TMA box's destination, one swizzle
  // pattern) at row 8, and the two wrap pixels sit at rows 7 and BM + 8
  static constexpr int A_PLANES = BK / 16;
  static constexpr int A_PLANE = BM + 16;
  static constexpr int A_PLANE_BYTES = A_PLANE * 32;
  static constexpr int A_BYTES = A_PLANES * A_PLANE_BYTES;
  static constexpr int A_TMA_BYTES = BK * BM * 2;  // what the TMA boxes bring a slice
  static constexpr int B_TAP_BYTES = CH * BN * 16;
  static constexpr int B_BYTES = 3 * B_TAP_BYTES;  // one bulk copy a slice
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int EP_COLS = BN < 128 ? BN : 128;  // output channels an epilogue pass
  static constexpr int EP_STRIDE = EP_COLS * 2 + 16;   // bytes a staged row, padded
  static constexpr int EP_BYTES = 64 * MT * EP_STRIDE;  // one warpgroup's staging tile
  static constexpr int S_FIT = (kSmemLimit - 2 * EP_BYTES - 2 * 6 * 8) / STAGE_BYTES;
  static constexpr int S = S_FIT < 6 ? S_FIT : 6;
  static constexpr int BAR_OFF = S * STAGE_BYTES + 2 * EP_BYTES;
  static constexpr int SMEM_BYTES = BAR_OFF + 2 * S * 8;
  static constexpr int A_VECS = (BM + 2) * CH;  // 16-byte halo vectors a slice
  static_assert(S >= 3, "one stage computing, one in flight, one filling");
  static_assert(SMEM_BYTES <= kSmemLimit, "shared memory");
  static_assert(STAGE_BYTES % 256 == 0 && A_PLANE_BYTES % 256 == 0 && EP_STRIDE % 16 == 0,
                "256-byte stages and planes (TMA, the swizzle pattern), 16-byte rows");
  static_assert(128 % CH == 0, "a producer thread keeps one channel chunk");
};

// shared address of halo row r (pixel w0 - 1 + r - 7), channel chunk c8 of
// the slice in stage st, in the 32-byte swizzle: the two 16-byte halves of
// a row swap where bit 7 of its address is set (bit 4 ^= bit 7), as the TMA
// writes the layout and wgmma reads it
template <class T>
__device__ __forceinline__ uint32_t a_addr(uint32_t st, int r, int c8) {
  const uint32_t row = st + (c8 >> 1) * T::A_PLANE_BYTES + r * 32;
  return row + ((static_cast<uint32_t>(c8 & 1) ^ ((row >> 7) & 1)) << 4);
}

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
// .ca: the next slice reads the other half of the lines this one read.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// generic-proxy writes to shared memory -> visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// arrive on bar once every cp.async this thread issued so far has landed
__device__ __forceinline__ void cp_arrive_noinc(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// TMA: a 2D box of the tensor map at (c0, c1) -> shared (128-byte aligned),
// completing its bytes on bar
__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], "
      "[%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// bulk copy (the TMA's 1D form) global -> shared, completing bytes on bar
__device__ __forceinline__ void bulk_g2s(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id) { asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory"); }

// shared-memory matrix descriptor, no swizzle (layout type 0), base offset 0
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// keeps the compiler from moving accumulator registers across the async
// wgmma issue / wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d (+)= A (64 x 16, K-major) * B (16 x N, K-major), both from shared
// memory; scale_d 0 overwrites d
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, "
        "0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  __device__ static __forceinline__ void mma(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
        "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// a tile's place: sample b, row h, first pixel w0, first output channel n0
// (output channels fastest, so the blocks at work at once share x rows)
struct TilePos {
  int b, h, w0, n0;
};

template <class T>
__device__ __forceinline__ TilePos tile_pos(int t, int H, int tiles_w, int n_tiles) {
  TilePos p;
  p.n0 = (t % n_tiles) * T::BN;
  t /= n_tiles;
  p.w0 = (t % tiles_w) * T::BM;
  t /= tiles_w;
  p.h = t % H;
  p.b = t / H;
  return p;
}

template <int BN, int MT, bool kHalo>
__global__ void __launch_bounds__(kThreads, 1) act_ringconv_kernel(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ left,
    const __nv_bfloat16* __restrict__ right, const float* __restrict__ pa,
    const float* __restrict__ pb, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y, int B, int H,
    int W, int Cin, int F, int apply_act, const __grid_constant__ CUtensorMap x_map, int use_tma) {
  using T = Tile<BN, MT>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t sbase = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full = sbase + T::BAR_OFF;  // S full barriers, then S empty ones
  const uint32_t empty = full + T::S * 8;

  const int tiles_w = (W + T::BM - 1) / T::BM;
  const int n_tiles = (F + BN - 1) / BN;
  const int n_all = B * H * tiles_w * n_tiles;
  const int n_c = (Cin + T::BK - 1) / T::BK;  // channel slices a kernel row
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < T::S; ++s) {
      mbar_init(full + s * 8, use_tma ? kFullArrivalsTma : kFullArrivalsCopy);
      mbar_init(empty + s * 8, kEmptyArrivals);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // both roles walk the same slices: tile t = blockIdx.x, + gridDim.x, ...;
  // slice j of a tile is (kernel row kh_lo + j / n_c, channel slice j % n_c)
  int stage = 0;
  uint32_t phase = 0;
  if (tid < 128) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (use_tma && tid != 0) return;  // one thread issues the TMA copies
    const int ch = tid % T::CH;  // this thread's channel chunk in every slice (copy path)
    const size_t w_slice = T::B_BYTES / 2;  // bf16 values a slice of the packed weight
    for (int t = blockIdx.x; t < n_all; t += gridDim.x) {
      const TilePos p = tile_pos<T>(t, H, tiles_w, n_tiles);
      const int kh_lo = p.h == 0 ? 1 : 0;
      const int kh_hi = p.h == H - 1 ? 1 : 2;
      const int n_slices = (kh_hi - kh_lo + 1) * n_c;
      for (int j = 0; j < n_slices; ++j) {
        const int kh = kh_lo + j / n_c;
        const int cs = j % n_c;
        const uint32_t st = sbase + stage * T::STAGE_BYTES;
        const uint32_t fb = full + stage * 8;
        const size_t row = (size_t)p.b * H + (p.h + kh - 1);
        mbar_wait(empty + stage * 8, phase ^ 1);
        if (tid == 0) {
          mbar_expect_tx(fb, T::B_BYTES + (use_tma ? T::A_TMA_BYTES : 0));
          bulk_g2s(st + T::A_BYTES, w + (((size_t)(p.n0 / BN) * 3 + kh) * n_c + cs) * w_slice, T::B_BYTES, fb);
        }
        if (use_tma) {
          // the row segment's BM pixels, one box a channel chunk (channels
          // past C_in zero-filled by the TMA); the two wrap pixels, which
          // no box reaches, by cp.async
          const int pix0 = static_cast<int>(row * W) + p.w0;
#pragma unroll
          for (int pl = 0; pl < T::A_PLANES; ++pl)
            tma_2d(st + pl * T::A_PLANE_BYTES + 8 * 32, &x_map, cs * T::BK + pl * 16, pix0, fb);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            int win = e ? p.w0 + T::BM : p.w0 - 1;
            const __nv_bfloat16* src;
            if constexpr (kHalo) {
              src = win < 0 ? left + row * Cin : (win >= W ? right + row * Cin : x + (row * W + win) * Cin);
            } else {
              win = win < 0 ? W - 1 : (win >= W ? 0 : win);
              src = x + (row * W + win) * Cin;
            }
#pragma unroll
            for (int c8 = 0; c8 < T::CH; ++c8) {
              const int c = cs * T::BK + c8 * 8;
              cp16(a_addr<T>(st, e ? 8 + T::BM : 7, c8), src + (c < Cin ? c : 0), c < Cin ? 16 : 0);
            }
          }
          cp_arrive_noinc(fb);
        } else {
          // halo vector v is pixel v / CH, chunk ch; its W index wraps (the
          // ring), or, in the halo'd form, pixel -1 comes from the left
          // strip and pixels from W on from the right strip
          const int c = cs * T::BK + ch * 8;
          const int c_bytes = c < Cin ? 16 : 0;
          const int cc = c_bytes ? c : 0;
          const __nv_bfloat16* xrow = x + row * W * Cin + cc;
          for (int v = tid; v < T::A_VECS; v += 128) {
            const int pix = v / T::CH;
            int win = p.w0 - 1 + pix;
            const __nv_bfloat16* src;
            if constexpr (kHalo) {
              src = win < 0 ? left + row * Cin + cc : (win >= W ? right + row * Cin + cc : xrow + (size_t)win * Cin);
            } else {
              win %= W;
              if (win < 0) win += W;
              src = xrow + (size_t)win * Cin;
            }
            cp16(a_addr<T>(st, 7 + pix, ch), src, c_bytes);
          }
          if (apply_act) {
            // the prologue, in place, on the vectors this thread copied;
            // zero-filled channels stay zero
            cp_wait_all();
            if (c_bytes) {
              const float4* qa = reinterpret_cast<const float4*>(pa + (size_t)p.b * Cin + c);
              const float4* qb = reinterpret_cast<const float4*>(pb + (size_t)p.b * Cin + c);
              const float4 a0 = qa[0], a1 = qa[1], b0 = qb[0], b1 = qb[1];
              const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
              const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
              for (int v = tid; v < T::A_VECS; v += 128) {
                uint4* q = reinterpret_cast<uint4*>(smem + (a_addr<T>(st, 7 + v / T::CH, ch) - sbase));
                *q = act8(*q, av, bv);
              }
            }
            fence_proxy_async();
            mbar_arrive(fb);
          } else {
            cp_arrive_noinc(fb);
          }
        }
        if (++stage == T::S) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    cp_wait_all();  // no copy outlives its thread
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int g = tid / 128 - 1;  // warpgroup g computes pixels g*64*MT ... of a tile
  const int wtid = tid % 128, wr = wtid / 32, lane = tid % 32;
  // A: 32-byte swizzle (layout type 3), SBO = 8 rows, a k16 step one plane
  // (LBO unused); B: no swizzle, SBO = 8 rows, LBO = the next 8 channels
  const uint64_t da0 = smem_desc(sbase + (7 + g * 64 * MT) * 32, 16, 256) | (3ull << 62);
  const uint64_t db0 = smem_desc(sbase + T::A_BYTES, BN * 16, 128);
  uint8_t* ep = smem + T::S * T::STAGE_BYTES + g * T::EP_BYTES;
  float acc[MT][BN / 2];
  for (int t = blockIdx.x; t < n_all; t += gridDim.x) {
    const TilePos p = tile_pos<T>(t, H, tiles_w, n_tiles);
    const int kh_lo = p.h == 0 ? 1 : 0;
    const int kh_hi = p.h == H - 1 ? 1 : 2;
    const int n_slices = (kh_hi - kh_lo + 1) * n_c;
    int prev = 0;
    for (int j = 0; j < n_slices; ++j) {
      mbar_wait(full + stage * 8, phase);
      fence_proxy_async();  // the producer's cp.async writes go through the generic proxy
      // descriptor addresses in 16-byte units
      const uint64_t st16 = static_cast<uint64_t>(stage) * (T::STAGE_BYTES / 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 3; ++tap)
#pragma unroll
        for (int kk = 0; kk < T::BK / 16; ++kk)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            Wgmma<BN>::mma(acc[mt], da0 + st16 + (mt * 64 + tap) * 2 + kk * (T::A_PLANE_BYTES / 16),
                           db0 + st16 + tap * (T::B_TAP_BYTES / 16) + kk * 2 * BN, (j | tap | kk) != 0);
      wgmma_commit();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
      // slice j stays in flight; slice j - 1 has retired, so its stage is free
      wgmma_wait<1>();
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
      if (j > 0 && lane == 0) mbar_arrive(empty + prev * 8);
      prev = stage;
      if (++stage == T::S) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) fence_acc(acc[mt]);
    if (lane == 0) mbar_arrive(empty + prev * 8);

    // epilogue, EP_COLS channels a pass: accumulator d[4j + q] of warp wr,
    // lane l holds pixel 16*wr + l/4 + 8*(q/2), channel 8j + 2*(l%4) + q%2
    constexpr int VEC_ROW = T::EP_COLS / 8;  // 16-byte vectors a staged row
#pragma unroll
    for (int pass = 0; pass < BN / T::EP_COLS; ++pass) {
      named_sync(1 + g);  // the last pass's reads of the staging tile are done
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jj = 0; jj < VEC_ROW; ++jj) {
          const int j = pass * VEC_ROW + jj;
          const int col = jj * 8 + 2 * (lane % 4);
          const int n = p.n0 + pass * T::EP_COLS + col;
          const float b0 = n < F ? bias[n] : 0.f, b1 = n < F ? bias[n + 1] : 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = mt * 64 + wr * 16 + lane / 4 + half * 8;
            *reinterpret_cast<__nv_bfloat162*>(ep + r * T::EP_STRIDE + col * 2) =
                __floats2bfloat162_rn(acc[mt][4 * j + 2 * half] + b0, acc[mt][4 * j + 2 * half + 1] + b1);
          }
        }
      named_sync(1 + g);
      for (int v = wtid; v < 64 * MT * VEC_ROW; v += 128) {
        const int r = v / VEC_ROW, c8 = v % VEC_ROW;
        const int wo = p.w0 + g * 64 * MT + r;
        const int n = p.n0 + pass * T::EP_COLS + c8 * 8;
        if (wo < W && n < F)
          *reinterpret_cast<uint4*>(y + (((size_t)p.b * H + p.h) * W + wo) * F + n) =
              *reinterpret_cast<const uint4*>(ep + r * T::EP_STRIDE + c8 * 16);
      }
    }
  }
}

// The weight packed for tile variant T in one pass, from the HWIO kernel
// (3, 3, C_in, F) at any strides (elements; a parameter's permuted OIHW
// storage), fp32 or bf16, rounded to bf16: [F/BN][3 kh][C_in/BK][3 kw]
// [BK/8][BN][8], zeros past C_in and F; one thread an element, the writes in
// order.
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <class T, class In>
__global__ void pack_kernel(const In* __restrict__ k, long long s_kh, long long s_kw, long long s_c,
                            long long s_f, int Cin, int F, __nv_bfloat16* __restrict__ w, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int out = i;
  const int c8 = i % 8;
  i /= 8;
  const int nn = i % T::BN;
  i /= T::BN;
  const int ch = i % T::CH;
  i /= T::CH;
  const int kw = i % 3;
  i /= 3;
  const int n_c = (Cin + T::BK - 1) / T::BK;
  const int cs = i % n_c;
  i /= n_c;
  const int kh = i % 3;
  const int c = cs * T::BK + ch * 8 + c8, f = (i / 3) * T::BN + nn;
  const float v = c < Cin && f < F ? to_float(k[kh * s_kh + kw * s_kw + c * s_c + f * s_f]) : 0.f;
  w[out] = __float2bfloat16_rn(v);
}

// the weight as the wrapper hands it over: the HWIO view's pointer, its
// strides in elements, and whether it is fp32 (else bf16)
struct Weight {
  const void* ptr;
  long long s_kh, s_kw, s_c, s_f;
  int fp32;
};

template <class T>
int pack(const Weight& k, int Cin, int F, void* w, void* stream) {
  const long long n = (long long)((F + T::BN - 1) / T::BN) * 9 * ((Cin + T::BK - 1) / T::BK) * T::BK * T::BN;
  if (n <= 0 || n > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = static_cast<int>((n + 255) / 256);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(w);
  if (k.fp32)
    pack_kernel<T, float><<<blocks, 256, 0, st>>>(static_cast<const float*>(k.ptr), k.s_kh, k.s_kw, k.s_c,
                                                  k.s_f, Cin, F, out, static_cast<int>(n));
  else
    pack_kernel<T, __nv_bfloat16><<<blocks, 256, 0, st>>>(static_cast<const __nv_bfloat16*>(k.ptr), k.s_kh,
                                                          k.s_kw, k.s_c, k.s_f, Cin, F, out, static_cast<int>(n));
  return static_cast<int>(cudaGetLastError());
}

int num_sms() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  static int cached[64] = {};
  if (dev >= 0 && dev < 64 && cached[dev]) return cached[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev >= 0 && dev < 64) cached[dev] = n;
  return n;
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr)
                                                                     : nullptr;
  }();
  return fn;
}

// The tensor map of x seen as (C, pixels) with (8, BM) boxes, made once per
// (pointer, pixels, C, BM): a small direct-mapped cache, since the caching
// allocator hands the same activations' addresses out again call after call.
struct MapEntry {
  const void* ptr;
  long long pixels;
  int cin, bm;
  CUtensorMap map;
};

int x_map(const void* x, long long pixels, int Cin, int bm, CUtensorMap* out) {
  static std::mutex lock;
  static MapEntry cache[64] = {};
  const size_t slot = ((reinterpret_cast<uintptr_t>(x) >> 8) ^ static_cast<size_t>(pixels) ^
                       (static_cast<size_t>(Cin) << 3) ^ static_cast<size_t>(bm)) % 64;
  std::lock_guard<std::mutex> guard(lock);
  MapEntry& e = cache[slot];
  if (e.ptr != x || e.pixels != pixels || e.cin != Cin || e.bm != bm) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Cin), static_cast<cuuint64_t>(pixels)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Cin) * 2};
    const cuuint32_t box[2] = {16, static_cast<cuuint32_t>(bm)};
    const cuuint32_t unit[2] = {1, 1};
    const CUresult rc = encode(&e.map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides,
                               box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_32B,
                               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (rc != CUDA_SUCCESS) {
      e.ptr = nullptr;
      return static_cast<int>(cudaErrorInvalidValue);
    }
    e.ptr = x;
    e.pixels = pixels;
    e.cin = Cin;
    e.bm = bm;
  }
  *out = e.map;
  return 0;
}

// the weight packed into w, then the conv
template <class T, bool kHalo>
int launch(const void* x, const void* left, const void* right, const void* a,
           const void* b, const Weight& k, void* w, const void* bias, void* y, int B, int H,
           int W, int Cin, int F, int apply_act, void* stream) {
  constexpr int BN = T::BN, MT = T::MT;
  // above 48 KB, dynamic shared memory has to be asked for once
  static const cudaError_t attr = cudaFuncSetAttribute(
      act_ringconv_kernel<BN, MT, kHalo>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM_BYTES);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long tiles = (long long)B * H * ((W + T::BM - 1) / T::BM) * ((F + BN - 1) / BN);
  const int sms = num_sms();
  if (sms <= 0 || tiles <= 0 || tiles > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  // the TMA copies whole row segments; a ragged last segment or the SiLU
  // prologue (which rewrites the halo in place) takes the cp.async path
  const int use_tma = !apply_act && W % T::BM == 0;
  CUtensorMap map = {};
  if (use_tma) {
    const int rc = x_map(x, (long long)B * H * W, Cin, T::BM, &map);
    if (rc != 0) return rc;
  }
  const int packed = pack<T>(k, Cin, F, w, stream);
  if (packed != 0) return packed;
  const int grid = tiles < sms ? static_cast<int>(tiles) : sms;  // persistent: one block an SM
  act_ringconv_kernel<BN, MT, kHalo><<<grid, kThreads, T::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(left),
      static_cast<const __nv_bfloat16*>(right), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(y), B, H, W, Cin, F, apply_act, map, use_tma);
  return static_cast<int>(cudaGetLastError());
}

// a tile variant the wrapper names by its geometry (ops/act_ringconv.py::TILES)
template <class T>
bool is_tile(int bm, int bn, int bk) {
  return bm == T::BM && bn == T::BN && bk == T::BK;
}

// fn(T{}) for the compiled tile variant T of that geometry; any other is
// refused
template <class Fn>
int with_tile(int bm, int bn, int bk, Fn&& fn) {
  if (is_tile<Tile<64, 2>>(bm, bn, bk)) return fn(Tile<64, 2>{});
  if (is_tile<Tile<128, 1>>(bm, bn, bk)) return fn(Tile<128, 1>{});
  if (is_tile<Tile<256, 1>>(bm, bn, bk)) return fn(Tile<256, 1>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the ring form: k the HWIO weight (its strides in elements, fp32 or bf16),
// packed into w (bf16, as many elements as ops/act_ringconv.py::pack_weight
// gives) on the stream before the conv; (bm, bn, bk) the tile variant
int act_ringconv_launch(const void* x, const void* a, const void* b, const void* k, long long s_kh,
                        long long s_kw, long long s_c, long long s_f, int k_fp32, void* w,
                        const void* bias, void* y, int B, int H, int W, int Cin, int F,
                        int apply_act, int bm, int bn, int bk, void* stream) {
  const Weight weight = {k, s_kh, s_kw, s_c, s_f, k_fp32};
  return with_tile(bm, bn, bk, [&](auto t) {
    return launch<decltype(t), false>(x, nullptr, nullptr, a, b, weight, w, bias, y, B, H, W, Cin, F, apply_act,
                                      stream);
  });
}

// the halo'd form: x (B, H, W, Cin) holds a rank's W columns, left and right
// (B, H, 1, Cin) its neighbours' edge columns
int act_ringconv_halo_launch(const void* x, const void* left, const void* right, const void* a,
                             const void* b, const void* k, long long s_kh, long long s_kw, long long s_c,
                             long long s_f, int k_fp32, void* w, const void* bias, void* y, int B, int H,
                             int W, int Cin, int F, int apply_act, int bm, int bn, int bk, void* stream) {
  const Weight weight = {k, s_kh, s_kw, s_c, s_f, k_fp32};
  return with_tile(bm, bn, bk, [&](auto t) {
    return launch<decltype(t), true>(x, left, right, a, b, weight, w, bias, y, B, H, W, Cin, F, apply_act, stream);
  });
}

// the pack alone (the launches' first kernel), for its test and timing
int act_ringconv_pack(const void* k, long long s_kh, long long s_kw, long long s_c, long long s_f, int k_fp32,
                      int Cin, int F, int bm, int bn, int bk, void* w, void* stream) {
  const Weight weight = {k, s_kh, s_kw, s_c, s_f, k_fp32};
  return with_tile(bm, bn, bk, [&](auto t) { return pack<decltype(t)>(weight, Cin, F, w, stream); });
}

}  // extern "C"
