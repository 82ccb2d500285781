// The tensor-core product of K1 segmax_scan, K10 segmax_scan_i8c and P1
// dot_rowmax (bf16 and int8 kinds): one persistent, warp-specialised
// mainloop on Hopper's TMA and wgmma, over either operand type. They
// replace picovdb_tpu's Pallas products (`_segmax_kernel` and
// `_segmax_kernel_i8c` in ops/pallas_scan.py, `_dot_kernel` and
// `_dot_kernel_i8` in bench/segmax_sweep_probe.py) and are bound by the
// tensor cores (2 Q cap dim operations against operands read about once),
// so the design keeps them fed: copies run ahead of the products and the
// epilogue never leaves the registers.
//
// A CTA holds three warpgroups. Warpgroup 2 is the producer: one elected
// thread keeps a ring of STAGES shared-memory stages filled with TMA
// copies (cp.async.bulk.tensor, 128B swizzle) of a 128-query x 128-byte
// slice of q and a 256-row x 128-byte slice of the corpus, guarded by full
// / empty mbarriers. Warpgroups 0 and 1 are the consumers: each multiplies
// its 64 queries against the stage's 256 rows with four wgmmas per stage,
// accumulators in registers (128 per thread), and releases the stage once
// its products completed. One output tile is 128 queries x 256 corpus
// rows (two 128-row segments); after its last k-stage each consumer thread
// hands its accumulators to the caller's epilogue (`Epi::tile`) in
// registers, so no score ever goes through shared or device memory.
//
// The operand type is a traits struct. A k-stage is 128 bytes of a row in
// both: 64 bf16 (Bf16: wgmma.m64n256k16 bf16 -> f32) or 128 int8 (Int8:
// wgmma.m64n256k32 s8 -> s32, exact integer sums). Each wgmma consumes 32
// bytes of every row, so the ring, the swizzle, the descriptors (+32 B per
// step) and the barrier protocol are byte for byte the same; only the
// instruction, the accumulator type and the TMA element type differ.
//
// The grid is persistent: one CTA per SM walks tiles t = blockIdx.x,
// + gridDim.x, ..., tile t covering query tile t % q_tiles and corpus tile
// t / q_tiles. Query tiles vary fastest, so the CTAs working at one time
// share a few corpus tiles and read each from HBM about once, while the
// queries (4 MB at Q = 2048, dim 1024 bf16) stay in L2. The producer runs
// into the next tile while the consumers run the epilogue, and the
// mbarrier parities carry across ring wraps and tiles alike.
//
// Out-of-range rows (past Q, past cap) and columns (past dim) are zero
// filled by TMA (bf16 +0.0, int8 0), so the epilogue only has to skip
// writing them. TMA needs the row stride and both base addresses 16-byte
// aligned: dim % 8 == 0 for bf16, dim % 16 == 0 for int8. At other widths
// the same mainloop takes one of two other producers, whose threads write
// the stage themselves, 128 arrivals on its full barrier in place of one
// expect_tx, the consumers fencing the writes (generic proxy) for wgmma's
// async proxy after the wait:
//  * PIECE 2, the realigning producer, for rows whose bases or widths
//    cp.async cannot copy either (bf16: odd widths, 2-byte aligned views;
//    int8: widths and bases off 4 bytes, as glove-25's 25-byte rows): TMA
//    loads each row's aligned 144-byte span of the k-slice into a staging
//    slot, rows j, j + C, ... read as one 2D tensor (a stride of C rows is
//    a multiple of 16 bytes: C = 8 for bf16's even row bytes, 16 for int8's
//    any) from row j's start aligned down (see ClassMaps), and the producer
//    warpgroup shifts each slice into the ring's swizzled stage in shared
//    memory by any byte; its 128 threads then arrive as below. Two ring
//    stages and two staging slots fill the shared memory. cp.async has no
//    2- or 1-byte copy, a box must start on a 16-byte boundary, and
//    producers that moved the bytes from device memory through the
//    threads measured 6-8 ms where TMA takes 0.9 (K1).
//  * PIECE 8 or 4, the cp.async producer: the whole producer warpgroup
//    copies each stage in pieces of PIECE bytes (8 where the row bytes and
//    both bases are multiples of 8, else 4) to the very offsets TMA's 128B
//    swizzle gives them, zero-filling the pieces past dim, Q and cap
//    (src-size 0) as TMA does; a piece never crosses a row's end, since
//    PIECE divides the row bytes. Each producer thread arrives with
//    cp.async.mbarrier.arrive.noinc once its copies have landed. K1 takes
//    it at even bf16 widths TMA cannot read directly (dim 1020, 300, 100,
//    50; 4- and 8-byte aligned views), K5 and K10 at int8 widths of whole
//    4 bytes (glove-100's 100 bytes, glove-200's 200, dim 1020).
// P1 at widths TMA cannot read keeps the first score tiles of tiles.cuh.
// The launcher reads the current device (SM count, shared-memory
// attribute): callers launch under their tensors' device.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no libcuda call is linked

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace pv {
namespace {
namespace wg {

constexpr int BM = 128;                    // queries per tile (2 x m64)
constexpr int BN = 256;                    // corpus rows per tile
constexpr int ROW_BYTES = 128;             // bytes of a row per k-stage
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * ROW_BYTES;    // 16 KB
constexpr int B_BYTES = BN * ROW_BYTES;    // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int THREADS = 384;               // consumers: warpgroups 0, 1
constexpr int CONSUMER_WARPS = 8;
constexpr int ACC = BN / 2;                // accumulators per thread
// the ring, 1 KB to align it (swizzle atoms are 1024 B), the barriers
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

// The 128 accumulator registers of an m64n256 wgmma, as asm operands
// %0..%127 and as their constraint list ("+f" or "+r").
#define PV_WG_D128                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                       \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "              \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "              \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "              \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "              \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "              \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "              \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "              \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "      \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "  \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define PV_WG_ACC4(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3])
#define PV_WG_ACC16(C, i) \
  PV_WG_ACC4(C, i), PV_WG_ACC4(C, i + 4), PV_WG_ACC4(C, i + 8), \
  PV_WG_ACC4(C, i + 12)
#define PV_WG_ACC128(C)                                                       \
  PV_WG_ACC16(C, 0), PV_WG_ACC16(C, 16), PV_WG_ACC16(C, 32),                  \
  PV_WG_ACC16(C, 48), PV_WG_ACC16(C, 64), PV_WG_ACC16(C, 80),                 \
  PV_WG_ACC16(C, 96), PV_WG_ACC16(C, 112)

// bf16 operands, float32 accumulators.
struct Bf16 {
  typedef float Acc;
  static constexpr int BK = 64;       // elements per k-stage (128 B)
  static constexpr int ELEM_BYTES = 2;
  static constexpr int CLASSES = 8;   // realigning producer's row classes
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

  // D (64 x 256) = A (64 x 16) . B (256 x 16)^T with both operands K-major
  // in 128B-swizzled shared memory (the plain TN case: scale 1, no
  // transpose bits); scale_d = 0 overwrites D instead of accumulating.
  static __device__ __forceinline__ void mma(float (&d)[ACC], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " PV_WG_D128
        ", %128, %129, p, 1, 1, 0, 0;\n}\n"
        : PV_WG_ACC128("+f")
        : "l"(da), "l"(db), "r"(scale_d));
  }

  // Keeps the compiler from moving the epilogue's accumulator reads above
  // the wgmma.wait_group that completes them. Only after wait_group 0: an
  // accumulator read while a wgmma is in flight serializes the wgmmas.
  static __device__ __forceinline__ void fence(float (&d)[ACC]) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
  }
};

// int8 operands, int32 accumulators: exact integer sums. The integer form
// takes no scale or transpose immediates (both operands are K-major).
struct Int8 {
  typedef int Acc;
  static constexpr int BK = 128;       // elements per k-stage (128 B)
  static constexpr int ELEM_BYTES = 1;
  static constexpr int CLASSES = 16;   // realigning producer's row classes
  // TMA has no signed 8-bit type; bytes copy as they are and the
  // out-of-bounds zero fill is int8 0
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_UINT8;

  static __device__ __forceinline__ void mma(int (&d)[ACC], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " PV_WG_D128
        ", %128, %129, p;\n}\n"
        : PV_WG_ACC128("+r")
        : "l"(da), "l"(db), "r"(scale_d));
  }

  static __device__ __forceinline__ void fence(int (&d)[ACC]) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i])::"memory");
  }
};

#undef PV_WG_ACC128
#undef PV_WG_ACC16
#undef PV_WG_ACC4
#undef PV_WG_D128

// The int32 whose order is an accumulator's: float32's sortable bits, or
// the int32 sum itself (the epilogues' raw key before any lane bits).
__device__ __forceinline__ int order_key(float s) {
  return to_sortable(__float_as_int(s));
}
__device__ __forceinline__ int order_key(int s) { return s; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of `map` at (c0 = column, c1 = row) into shared memory at `dst`;
// completion (the box's full byte count, out-of-bounds fill included) is
// reported to the mbarrier `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major operand in 128B-swizzled rows of 128 B:
// start address >> 4 (bits 0-13), leading offset unused by the swizzled
// K-major layout (1, bits 16-29), stride 1024 B between 8-row groups
// (bits 32-45), layout SWIZZLE_128B (1, bits 62-63). A wgmma step inside a
// stage (k16 bf16, k32 int8: 32 B of each row) is +32 B of start address,
// i.e. + 2 on the descriptor.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// One cp.async of PIECE (4 or 8) bytes from global `src` to shared `dst`;
// src_bytes 0 reads nothing and zero-fills the piece.
template <int PIECE>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(PIECE), "r"(src_bytes)
               : "memory");
}

// An arrival on `bar` once every cp.async this thread issued has landed;
// the barrier's count includes it (noinc).
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

// Thread t (of the producer warpgroup's 128) of the cp.async producer:
// bytes [128 k, 128 k + 128) of the ROWS rows from `src` on (of which
// `rows_left` exist) of a row-major matrix with rows of `row_bytes` bytes,
// into the stage at `dst` as TMA's 128B swizzle lays a box of 128-byte
// rows out: row r at r * 128, its 16-byte chunk c at chunk c ^ (r % 8)
// (the ring's stages are 1024-byte aligned). The thread copies piece
// t % (128 / PIECE) of rows t / (128 / PIECE), + 128 / (128 / PIECE), ...:
// neighbouring threads read neighbouring pieces of a row. Pieces past
// row_bytes or past rows_left read nothing and are zero-filled. One
// pointer and one shared address stepped a row group at a time keep the
// producer within its 40 registers.
template <int PIECE, int ROWS>
__device__ __forceinline__ void cp_stage(uint32_t dst,
                                         const unsigned char* src,
                                         long rows_left, long row_bytes,
                                         int k, int t) {
  constexpr int PER_ROW = ROW_BYTES / PIECE;  // pieces a row: 16 or 32
  constexpr int ROW_STEP = 128 / PER_ROW;     // rows a pass: 8 or 4
  const int b = (t % PER_ROW) * PIECE;        // the piece's byte in the row
  const int r0 = t / PER_ROW;
  const long col = (long)k * ROW_BYTES + b;
  // rows this thread copies from: none where its piece lies past the row
  const int lim =
      col >= row_bytes ? 0 : rows_left < ROWS ? (int)rows_left : ROWS;
  const unsigned char* s = src + r0 * row_bytes + col;
  uint32_t d = dst + r0 * ROW_BYTES + (b & 15);
#pragma unroll 1
  for (int r = r0; r < ROWS; r += ROW_STEP) {
    const bool ok = r < lim;
    cp_async<PIECE>(d + (((b >> 4) ^ (r & 7)) << 4), ok ? s : src,
                    ok ? PIECE : 0);
    s += ROW_STEP * row_bytes;
    d += ROW_STEP * ROW_BYTES;
  }
}

// The realigning producer (PIECE 2) reads rows that cp.async cannot copy
// (bf16 rows only 2-byte aligned, int8 rows whose bytes or bases are off
// 4). TMA cannot read them as one 2D tensor (their stride is no multiple
// of 16 bytes), and a box must start on a 16-byte boundary. But rows j,
// j + C, j + 2 C, ... form a 2D tensor whose row stride, C x row bytes, is
// a multiple of 16 bytes for T::CLASSES = C row classes (8 for bf16's even
// row bytes, 16 for int8's any); its map is based at row j's start
// aligned down to 16 bytes (`off` bytes before it). One box of STAGE_ROW =
// 144 bytes at byte 128 k of that map holds each of the class's rows'
// 128-byte slice k at byte off, and zeros past the row's end and past the
// class's rows; TMA reads no 16-byte chunk that holds no byte of a row.
// Per stage the producer's elected thread loads the classes' boxes into a
// staging slot (no swizzle; two slots), and the 128 threads of the
// producer warpgroup move each row's slice out of it into the ring's
// swizzled stage, in the rows' own order, by two 16-byte shared loads, a
// shift by off bytes and one 16-byte store a piece.
constexpr int STAGE_ROW = 144;             // bytes of a staged row's span
constexpr int SLOT_A = BM * STAGE_ROW;     // a slot's A boxes: 18 KB
constexpr int SLOT_BYTES = SLOT_A + BN * STAGE_ROW;  // 54 KB
constexpr int SLOTS = 2;
constexpr int REALIGN_STAGES = 2;          // ring stages beside the slots
static_assert(REALIGN_STAGES * STAGE_BYTES + SLOTS * SLOT_BYTES + 1024 +
                  8 * (2 * REALIGN_STAGES + SLOTS) <= 232448,
              "the realigning producer's shared memory");

struct TileMaps {  // the TMA producer's: q and v
  CUtensorMap q, v;
};

template <int C>
struct ClassMaps {  // the realigning producer's: C classes of q and of v
  CUtensorMap q[C], v[C];
  int qoff[C], voff[C];  // off of each class (bytes); -1: no such row
  uint32_t slot_bytes;  // bytes of a slot's boxes (classes that hold a row)
};

template <class T, int PIECE>
using MapsOf = typename std::conditional<PIECE == 2, ClassMaps<T::CLASSES>,
                                         TileMaps>::type;

// The 16 bytes at byte `off` (0..15; bf16's are even) of the 32 bytes lo |
// hi, as four words (little endian: byte i of the pair is byte i % 4 of
// word i / 4). Selects, not an indexed array, so nothing goes to local
// memory.
__device__ __forceinline__ uint4 shift_pair(uint4 lo, uint4 hi, int off) {
  const uint32_t z[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const bool w1 = off & 4, w2 = off & 8;
  uint32_t t[7], u[5];
#pragma unroll
  for (int i = 0; i < 7; ++i) t[i] = w1 ? z[i + 1] : z[i];
#pragma unroll
  for (int i = 0; i < 5; ++i) u[i] = w2 ? t[i + 2] : t[i];
  const uint32_t sh = (off & 3) * 8;  // 0, 8, 16 or 24 bits
  return make_uint4(__funnelshift_r(u[0], u[1], sh),
                    __funnelshift_r(u[1], u[2], sh),
                    __funnelshift_r(u[2], u[3], sh),
                    __funnelshift_r(u[3], u[4], sh));
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a));
  return v;
}

// Thread t (of the producer warpgroup's 128) moves 16-byte piece c = t % 8
// of rows t / 8, + 16, ... of a box of ROWS rows from the staging slot at
// `src` (class j's box of ROWS / C rows at j ROWS / C STAGE_ROW) to the
// stage at `dst`, swizzled as TMA's 128B swizzle lays a box of 128-byte
// rows out. A thread's rows are all of class (t / 8) % C (C = 8 or 16
// divides 16), so one offset `off` (bytes; < 0 where the class has no row,
// whose pieces are zero) serves them all.
template <int ROWS, int C>
__device__ __forceinline__ void realign_box(uint32_t dst, uint32_t src, int t,
                                            int off) {
  constexpr int PER = ROWS / C;  // rows of a class in the box
  constexpr int BATCH = 4;       // passes whose loads issue together
  const int c = t % 8, r0 = t / 8, j = r0 % C;
  const uint32_t from = src + (j * PER + r0 / C) * STAGE_ROW + 16 * c;
#pragma unroll
  for (int p0 = 0; p0 < ROWS / 16; p0 += BATCH) {
    uint4 lo[BATCH], hi[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {  // row r / C of its class: + 16 / C a pass
      const uint32_t a = from + (16 / C) * (p0 + u) * STAGE_ROW;
      lo[u] = ld_shared_v4(a);
      hi[u] = ld_shared_v4(a + 16);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int r = r0 + 16 * (p0 + u);
      const uint4 v = off >= 0 ? shift_pair(lo[u], hi[u], off)
                               : make_uint4(0, 0, 0, 0);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       dst + r * ROW_BYTES + ((c ^ (r & 7)) << 4)),
                   "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
}

// The realigning producer's elected thread: the classes' boxes of tile
// `tile`'s k-stage k into the slot at `slot`, reported to `bar`.
template <class T>
__device__ __forceinline__ void stage_boxes(const ClassMaps<T::CLASSES>& maps,
                                            uint32_t slot, uint32_t bar,
                                            int tile, int k, int q_tiles) {
  constexpr int C = T::CLASSES;
  const int m_q = (tile % q_tiles) * (BM / C);
  const int m_v = (tile / q_tiles) * (BN / C);
  mbar_expect_tx(bar, maps.slot_bytes);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (maps.qoff[c] >= 0)
      tma_load_2d(slot + c * (BM / C) * STAGE_ROW, &maps.q[c], bar,
                  k * T::BK, m_q);
    tma_load_2d(slot + SLOT_A + c * (BN / C) * STAGE_ROW, &maps.v[c], bar,
                k * T::BK, m_v);
  }
}

// The mainloop. `Epi::tile(acc, q0, r0, Q, cap)` runs in each consumer
// thread once per output tile (queries q0.., corpus rows r0..). Fragment
// layout of `acc` (wgmma's accumulator, f32 of m64nNk16 and s32 of
// m64nNk32 alike): lane l of warp w of consumer warpgroup g holds tile
// rows 64 g + 16 w + l / 4 (h = 0) and + 8 (h = 1), at columns
// 8 j + 2 (l % 4) + e, in acc[4 j + 2 h + e]. PIECE 0: the TMA producer
// (maps.q, maps.v); 2: the realigning producer (ClassMaps of T::CLASSES);
// 4 or 8: the cp.async producer (pointers qp, vp).
template <class T, class Epi, int PIECE>
__global__ void __launch_bounds__(THREADS, 1)
tiles_kernel(const __grid_constant__ MapsOf<T, PIECE> maps,
             const unsigned char* __restrict__ qp,
             const unsigned char* __restrict__ vp, const Epi epi, int Q,
             long cap, int dim) {
  constexpr bool CP = PIECE == 4 || PIECE == 8;  // the cp.async producer
  constexpr bool RA = PIECE == 2;                // the realigning producer
  constexpr int NS = RA ? REALIGN_STAGES : STAGES;  // ring stages
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t a_ring = base, b_ring = base + NS * A_BYTES;
  const uint32_t slots = base + NS * STAGE_BYTES;  // RA: the staging slots
  const uint32_t full = slots + (RA ? SLOTS * SLOT_BYTES : 0);
  const uint32_t empty = full + 8 * NS, staged = empty + 8 * NS;
  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      // the TMA producer's one expect_tx arrival, or the 128 threads'
      // arrivals of the cp.async and realigning producers
      mbar_init(full + 8 * s, PIECE ? 128 : 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    if (RA)
      for (int s = 0; s < SLOTS; ++s) mbar_init(staged + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int q_tiles = (Q + BM - 1) / BM;
  const int tiles = q_tiles * (int)((cap + BN - 1) / BN);
  const int k_iters = (dim + T::BK - 1) / T::BK;

  // registers a thread keeps: the producer's, each consumer's (P + 2 C =
  // 504, the 168 x 3 the launch gives); the realigning producer's batched
  // shared loads take a larger share
  constexpr int PREGS = RA ? 72 : 40, CREGS = (504 - PREGS) / 2;
  if (threadIdx.x >= 2 * 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PREGS));
    if constexpr (RA) {
      const int t = threadIdx.x - 2 * 128;
      // this thread's rows are of class (t / 8) % C: their offsets (bytes)
      const int cls = (t / 8) % T::CLASSES;
      const int qoff = maps.qoff[cls], voff = maps.voff[cls];
      // the elected thread runs SLOTS stages ahead: (next_tile, next_k)
      int next_tile = blockIdx.x, next_k = 0;
      if (t == 0)
        for (int s = 0; s < SLOTS && next_tile < tiles; ++s) {
          stage_boxes<T>(maps, slots + s * SLOT_BYTES, staged + 8 * s,
                         next_tile, next_k, q_tiles);
          if (++next_k == k_iters) {
            next_k = 0;
            next_tile += gridDim.x;
          }
        }
      int stage = 0, slot = 0;
      uint32_t phase = 0, sphase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int k = 0; k < k_iters; ++k) {
          const uint32_t from = slots + slot * SLOT_BYTES;
          mbar_wait(staged + 8 * slot, sphase);     // the boxes have landed
          mbar_wait(empty + 8 * stage, phase ^ 1);  // first lap: free
          realign_box<BM, T::CLASSES>(a_ring + stage * A_BYTES, from, t,
                                      qoff);
          realign_box<BN, T::CLASSES>(b_ring + stage * B_BYTES, from + SLOT_A,
                                      t, voff);
          // the stores, for wgmma's async proxy, then this thread's arrival
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          mbar_arrive(full + 8 * stage);
          // every thread has read the slot: refill it
          asm volatile("bar.sync 1, 128;\n" ::: "memory");
          if (t == 0 && next_tile < tiles) {
            // the slot's generic reads before TMA's writes (async proxy)
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            stage_boxes<T>(maps, from, staged + 8 * slot, next_tile, next_k,
                           q_tiles);
            if (++next_k == k_iters) {
              next_k = 0;
              next_tile += gridDim.x;
            }
          }
          if (++stage == NS) {
            stage = 0;
            phase ^= 1;
          }
          if (++slot == SLOTS) {
            slot = 0;
            sphase ^= 1;
          }
        }
      }
    } else if constexpr (CP) {
      const int t = threadIdx.x - 2 * 128;
      const long row_bytes = (long)dim * T::ELEM_BYTES;
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int q0 = (tile % q_tiles) * BM, r0 = (tile / q_tiles) * BN;
        for (int k = 0; k < k_iters; ++k) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // first lap: free
          cp_stage<PIECE, BM>(a_ring + stage * A_BYTES, qp + q0 * row_bytes,
                              Q - q0, row_bytes, k, t);
          cp_stage<PIECE, BN>(b_ring + stage * B_BYTES, vp + r0 * row_bytes,
                              cap - r0, row_bytes, k, t);
          cp_async_arrive(full + 8 * stage);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if (threadIdx.x == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int q0 = (t % q_tiles) * BM, r0 = (t / q_tiles) * BN;
        for (int k = 0; k < k_iters; ++k) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // first lap: free
          mbar_expect_tx(full + 8 * stage, STAGE_BYTES);
          tma_load_2d(a_ring + stage * A_BYTES, &maps.q, full + 8 * stage,
                      k * T::BK, q0);
          tma_load_2d(b_ring + stage * B_BYTES, &maps.v, full + 8 * stage,
                      k * T::BK, r0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CREGS));
    const uint32_t a_half = (threadIdx.x / 128) * (A_BYTES / 2);
    const bool leader = threadIdx.x % 32 == 0;
    typename T::Acc acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int prev = 0;
      for (int k = 0; k < k_iters; ++k) {
        mbar_wait(full + 8 * stage, phase);
        if constexpr (PIECE > 0)  // threads wrote in the generic proxy
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const uint64_t da = sw128_desc(a_ring + stage * A_BYTES + a_half);
        const uint64_t db = sw128_desc(b_ring + stage * B_BYTES);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < ROW_BYTES / 32; ++kk)
          T::mma(acc, da + 2 * kk, db + 2 * kk, (k | kk) != 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the previous stage's products have completed: release it
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (k > 0 && leader) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == NS) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      T::fence(acc);
      if (leader) mbar_arrive(empty + 8 * prev);
      epi.tile(acc, (t % q_tiles) * BM, (long)(t / q_tiles) * BN, Q, cap);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so the library needs
// no -lcuda.
#if CUDART_VERSION < 12050
#error "wgmma_tiles.cuh needs CUDA 12.5 or later (cudaGetDriverEntryPointByVersion)"
#endif
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// 0, or a cudaError_t when libcuda has no cuTensorMapEncodeTiled.
inline int encoder(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || !p)
      return (int)cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return 0;
}

// The tensor map of a (rows, dim) row-major matrix of T's elements read in
// boxes of 128 bytes x box_rows rows, 128B-swizzled, out-of-bounds elements
// zero. 0, or minus the CUresult of a refused encode.
template <class T>
int encode_rows(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                long long rows, int dim, int box_rows) {
  const cuuint64_t gdim[2] = {(cuuint64_t)dim, (cuuint64_t)rows};
  const cuuint64_t gstride[1] = {(cuuint64_t)dim * T::ELEM_BYTES};
  const cuuint32_t box[2] = {(cuuint32_t)T::BK, (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = enc(map, T::TMA_TYPE, 2, const_cast<void*>(ptr), gdim,
                         gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// The map of class j of a (rows, dim) row-major matrix of T's elements at
// `ptr` (a base aligned to T's element): rows j, j + T::CLASSES, ... as a
// 2D tensor (see ClassMaps) from row j's start aligned down to 16 bytes,
// read in boxes of STAGE_ROW bytes x box_rows rows, unswizzled,
// out-of-bounds elements zero; `*off` the bytes between its base and row
// j's start, -1 (and no map) where the matrix has no row j. 0, or minus
// the CUresult of a refused encode.
template <class T>
int encode_class(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                 long long rows, int dim, int j, int box_rows, int* off) {
  constexpr int C = T::CLASSES;
  if (rows <= j) {
    *off = -1;
    return 0;
  }
  const long long row_bytes = (long long)dim * T::ELEM_BYTES;
  const uintptr_t start = (uintptr_t)ptr + j * row_bytes;
  const uintptr_t base = start & ~(uintptr_t)15;
  *off = (int)(start - base);
  const cuuint64_t gdim[2] = {
      (cuuint64_t)((row_bytes + *off) / T::ELEM_BYTES),
      (cuuint64_t)((rows - j + C - 1) / C)};
  const cuuint64_t gstride[1] = {(cuuint64_t)(C * row_bytes)};
  const cuuint32_t box[2] = {(cuuint32_t)(STAGE_ROW / T::ELEM_BYTES),
                             (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = enc(map, T::TMA_TYPE, 2, reinterpret_cast<void*>(base),
                         gdim, gstride, box, estride,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// Launches the persistent kernel on q (Q, dim) and v (cap, dim), both of
// T's type, on the current device (one CTA per SM, fewer when there are
// fewer tiles): PIECE 0 encodes their TMA maps (rows of whole 16 bytes,
// 16-byte aligned bases), PIECE 2 their class maps for the realigning
// producer (any row bytes of T, bases aligned to its element), PIECE 4 or
// 8 feeds the ring by cp.async (the row bytes and both bases multiples of
// PIECE). Returns 0, a cudaError_t, or minus a CUresult of the encode.
template <class T, class Epi, int PIECE = 0>
int launch_tiles(const void* q, const void* v, const Epi& epi, int Q,
                 long long cap, int dim, cudaStream_t stream) {
  if (Q <= 0 || cap <= 0) return (int)cudaSuccess;
  const int align = PIECE == 2 ? T::ELEM_BYTES : PIECE ? PIECE : 16;
  if (dim <= 0 || (long long)dim * T::ELEM_BYTES % align ||
      ((uintptr_t)q | (uintptr_t)v) % align)
    return (int)cudaErrorInvalidValue;
  MapsOf<T, PIECE> maps{};
  if constexpr (PIECE == 0 || PIECE == 2) {
    EncodeTiled enc;
    int err = encoder(&enc);
    if (err) return err;
    if constexpr (PIECE == 0) {
      if ((err = encode_rows<T>(enc, &maps.q, q, Q, dim, BM))) return err;
      if ((err = encode_rows<T>(enc, &maps.v, v, cap, dim, BN))) return err;
    } else {
      constexpr int C = T::CLASSES;
      maps.slot_bytes = BN * STAGE_ROW;
      for (int j = 0; j < C; ++j) {
        if ((err = encode_class<T>(enc, &maps.q[j], q, Q, dim, j, BM / C,
                                   &maps.qoff[j])))
          return err;
        if ((err = encode_class<T>(enc, &maps.v[j], v, cap, dim, j, BN / C,
                                   &maps.voff[j])))
          return err;
        if (maps.qoff[j] >= 0) maps.slot_bytes += BM / C * STAGE_ROW;
      }
    }
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the ring, 1 KB to align it, the barriers; the realigning producer's
  // ring of REALIGN_STAGES and its slots
  constexpr int smem =
      PIECE == 2 ? REALIGN_STAGES * STAGE_BYTES + SLOTS * SLOT_BYTES + 1024 +
                       8 * (2 * REALIGN_STAGES + SLOTS)
                 : SMEM_BYTES;
  if (e == cudaSuccess)  // > 48 KB of dynamic shared memory
    e = cudaFuncSetAttribute(tiles_kernel<T, Epi, PIECE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((Q + BM - 1) / BM) * ((cap + BN - 1) / BN);
  if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;  // int tile ids
  const int grid = (int)std::min<long long>(tiles, sms);
  tiles_kernel<T, Epi, PIECE><<<grid, THREADS, smem, stream>>>(
      maps, static_cast<const unsigned char*>(q),
      static_cast<const unsigned char*>(v), epi, Q, (long)cap, dim);
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace
}  // namespace pv
