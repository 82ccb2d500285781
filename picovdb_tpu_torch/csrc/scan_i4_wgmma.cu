// K6 fused_topk_i4 at batch sizes (k <= 128 where no sweep serves) on
// Hopper's tensor cores: exact masked top-k over a packed int4 corpus with
// a per-row scale, at every even width and base.
//
// Replaces picovdb_tpu/ops/pallas_scan.py:fused_topk_i4
// (`_scan_kernel_i4`) on the int4 store's batches (route `i4stor_fused`,
// every `query_columnar` chunk of more than 4 queries, and smaller ones
// where neither sweep takes the operands). The TPU kernel
// unpacks the nibbles into two biased int8 planes in VMEM, runs two int8
// matrix-unit products per tile, then its k-pass ladder and a merge into
// the running top-k. This kernel computes the same function: the biased
// planes (1..15) times the int8 queries on wgmma (m64n128k32 s8 -> s32,
// exact), minus 8 sum(q) per query, converted once to float32 and times
// the row's scale (the template's line, scan_topk.cu), the k best rows
// per query by row_key (ties to the lower row) -- bit for bit
// `scan_topk_plain(..., int4=True)`.
//
// What bounds it on the H100: the operations. 2 Q cap dim int8 operations
// (7.0e13 at Q = 2048 over 16.7M x 1024 rows: 35.6 ms at 1,979 T/s)
// against 0.5 B an element read about once (8.6 GB: 2.6 ms). The template
// (scan_topk.cu) it replaces ran the product on CUDA-core __dp4a and read
// the packed plane once per 16-query tile.
//
// Design:
//  * The queries' columns are permuted once per call (ops/scan.py::
//    permute_i4_queries), so that k-stage j (128 bytes) is q[:, 64 j ..]
//    followed by q[:, dim/2 + 64 j ..]: the elements the low and the high
//    nibbles of packed bytes [64 j, 64 j + 64) hold. Each half is padded
//    with zeros to whole stages on its own, so a row of dim/2 packed bytes
//    takes ceil(dim/2 / 64) stages and the last one's bytes past the row
//    (TMA's zero fill, or a neighbour row's bytes) meet zero columns in
//    both planes. The A operand is then one ordinary TMA box a stage (64
//    queries x 128 bytes, 128B swizzle), and one packed 64-byte slice of a
//    row expands into exactly that stage's 128-byte B row: low nibbles in
//    bytes 0-63, high in 64-127.
//  * Expanded in shared memory, never in device memory. A CTA holds three
//    warpgroups. In warpgroup 2 one thread keeps a ring of S1 slots filled
//    by TMA: the A box and, for rows TMA reads (PIECE 0: dim/2 a multiple
//    of 16 bytes at a 16-byte aligned base), the packed 64-byte slice of
//    the tile's 256 rows (64B swizzle, rows past cap and bytes past the
//    row zero filled). Its three other warps are
//    the expanders: they read a slice (16-byte chunk c of row r at chunk
//    c ^ ((r >> 1) & 3)), mask the two nibble planes, and write them into
//    one of S2 B tiles in the 128B-swizzled layout TMA would produce
//    (chunk c of row r at c ^ (r % 8)); a quarter warp takes one chunk of
//    8 consecutive rows, so neither side has a bank conflict. Each
//    expander then fences its generic-proxy writes for the async proxy
//    (fence.proxy.async) before it arrives on the tile's barrier.
//    Warpgroups 0 and 1 are the consumers: each multiplies the 64 queries
//    against its 128 of the 256 rows, four wgmmas a stage, accumulators in
//    registers (64 a thread), and releases the slot and the B tile once
//    its products completed.
//  * Rows TMA cannot read (PIECE 8 / 4: dim/2 and the base multiples of 8
//    or 4 bytes; PIECE 2: any other even width or base; ops/scan.py::
//    rows_piece). Of the two ways to feed them -- a producer warpgroup
//    staging the packed slice as K4's and K3's scans do (wgmma_scan.cuh
//    `produce_rows`), or the expanders reading the packed bytes from
//    device memory themselves -- this kernel takes the second: the
//    expanders touch every byte anyway to unpack it, so reading it from
//    device memory at its own alignment costs no staging slot and no
//    barrier, keeps one ring shape for every row class (the realigning
//    producer's 2 x 18 KB of staging slots do not fit beside the k <= 32
//    ring), and TMA then brings the A box alone. Chunk c of a row's stage
//    is loaded as 8-byte (PIECE 8) or 4-byte (PIECE 4) words, or as five
//    4-byte words shifted into place (PIECE 2, __funnelshift_r), each word
//    only where it holds a byte of the row: no read leaves the aligned
//    words that hold the operand's bytes, and bytes of the next row in a
//    shared word meet zero query columns. The loads of a stage are issued
//    before the wait for its B tile, so their latency hides behind the
//    consumers' products.
//  * A running selection per query, so the grid is not tiles_kernel's:
//    CTA c owns query tile c % q_tiles for its lifetime and walks the
//    contiguous corpus range c / q_tiles (ops/scan.py::
//    i4_wgmma_partition); the q_tiles CTAs of a range walk it together and
//    read a packed tile from device memory about once.
//  * The epilogue stays in registers: accumulator (query, row) becomes
//    s = float(acc - 8 sum(q)) * vscale[row] and row_key(s, row), admitted
//    for a live row below cap whose key beats the query's running k-th
//    best (`tau`) into that query's shared buffer of BUF keys (an atomic
//    slot). The expanders put each tile's row scales and a bit a row
//    (live: unmasked and below cap) in shared memory when they expand its
//    first stage, so whether a row is admitted depends on mask and index
//    alone, never on its scale's value; a key is built only where s
//    reaches tau's score, so the common rejection is a few instructions
//    and no load from device memory. An admission that finds the buffer
//    full keeps its key in a pending bit; the consumers then compact (a
//    sort of every buffer to
//    its best k, behind a named barrier the producer never joins) and
//    re-admit the pending keys against the raised tau, inside the same
//    epilogue. Rows past cap are zero filled and skipped by index, never
//    by value (a zero byte expands to nibbles 0, not 8).
//  * At the end each CTA writes its k best keys per query as a partial;
//    launch_topk_merge merges the ranges' partials per query.
//  * Two shapes of the rings (shared memory: 24 KB a slot, 32 KB a B tile
//    beside 64 x BUF x 8 bytes of buffers): k <= 32 three slots, three B
//    tiles (the expanders run two stages ahead of the products' releases)
//    and buffers of 64 keys; k <= 128 two slots, one B tile (the
//    expansion and the products take turns) and buffers of 256.

#include <cstring>

#include "wgmma_scan.cuh"

namespace pv {
namespace {
namespace i4 {

using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::smem_u32;
using wg::sw128_desc;
using wg::tma_load_2d;
using ws::fence_acc;

constexpr int BM = 64;          // queries per CTA: one m64 A tile
constexpr int BN = 256;         // corpus rows per tile
constexpr int NW = 128;         // rows per consumer warpgroup (wgmma n)
constexpr int ROW_BYTES = 128;  // expanded bytes of a row per k-stage
constexpr int PACKED = 64;      // packed bytes of a row per k-stage
constexpr int A_BYTES = BM * ROW_BYTES;  // 8 KB
constexpr int P_BYTES = BN * PACKED;     // 16 KB
constexpr int B_BYTES = BN * ROW_BYTES;  // 32 KB
constexpr int THREADS = 384;
constexpr int CONSUMERS = 256;  // warpgroups 0 and 1
constexpr int CONSUMER_WARPS = 8;
constexpr int EXPANDERS = 96;   // warps 1-3 of warpgroup 2
constexpr int ACC = NW / 2;     // accumulators a thread (m64n128)
constexpr int CONSUMER_BAR = 1;  // named barrier of the consumers alone
constexpr int ITEMS = BN * (PACKED / 16);  // 16-byte chunks of a slice
constexpr int PER = (ITEMS + EXPANDERS - 1) / EXPANDERS;  // an expander's
// Tiles whose row scales and live bits (bit r % 32 of word r / 32: row r
// of the tile is unmasked and below cap) sit in shared memory for the
// epilogue: the expanders write a tile's at its first stage, at most three
// tiles ahead of the epilogue that reads them (the B ring holds at most
// three stages).
constexpr int MSC_TILES = 4;
constexpr int LIVE_WORDS = BN / 32;  // live bits of a tile

// S1 TMA slots (A and the packed slice), S2 expanded B tiles, BUF keys a
// query. With S2 == 1 the consumers release a stage as soon as its
// products complete (no lag: there is no second B tile to expand into).
template <int S1, int S2, int BUF>
struct Ring {
  static constexpr int A_OFF = 0;
  static constexpr int B_OFF = S1 * A_BYTES;
  static constexpr int P_OFF = B_OFF + S2 * B_BYTES;
  static constexpr int BAR_OFF = P_OFF + S1 * P_BYTES;
  static constexpr int MSC_OFF = BAR_OFF + 8 * (2 * S1 + 2 * S2);
  static constexpr int LIVE_OFF = MSC_OFF + MSC_TILES * BN * 4;
  static constexpr int TAU_OFF = LIVE_OFF + MSC_TILES * LIVE_WORDS * 4;
  static constexpr int BUF_OFF = TAU_OFF + BM * 8;
  static constexpr int CNT_OFF = BUF_OFF + BM * BUF * 8;
  // 1 KB to align the ring (swizzle atoms are 1024 B)
  static constexpr int SMEM = 1024 + CNT_OFF + BM * 4;
  static_assert(SMEM <= 232448, "shared memory of one CTA");
};

// The 64 accumulator registers of an m64n128 wgmma.
#define PV_I4_D64                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"
#define PV_I4_ACC8(i)                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]), \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// D (64 x 128) = A (64 x 32 int8) . B (128 x 32 int8)^T, both K-major in
// 128B-swizzled shared memory; scale_d = 0 overwrites D.
__device__ __forceinline__ void mma(int (&d)[ACC], uint64_t da, uint64_t db,
                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " PV_I4_D64
      ", %64, %65, p;\n}\n"
      : PV_I4_ACC8(0), PV_I4_ACC8(8), PV_I4_ACC8(16), PV_I4_ACC8(24),
        PV_I4_ACC8(32), PV_I4_ACC8(40), PV_I4_ACC8(48), PV_I4_ACC8(56)
      : "l"(da), "l"(db), "r"(scale_d));
}

#undef PV_I4_ACC8
#undef PV_I4_D64

// The biased nibble planes of a packed word, as non-negative bytes.
__device__ __forceinline__ uint4 low_plane(uint4 x) {
  const uint32_t m = 0x0F0F0F0Fu;
  return make_uint4(x.x & m, x.y & m, x.z & m, x.w & m);
}
__device__ __forceinline__ uint4 high_plane(uint4 x) {
  const uint32_t m = 0x0F0F0F0Fu;
  return make_uint4((x.x >> 4) & m, (x.y >> 4) & m, (x.z >> 4) & m,
                    (x.w >> 4) & m);
}

// Bytes [off, off + 16) of a packed row of `rb` bytes at `row` (its first
// byte), off < rb, for rows TMA cannot read: PIECE 8 / 4 as 8- / 4-byte
// words (row and off at their alignment), PIECE 2 as the five 4-byte words
// from the one below the chunk, shifted into place. A word is loaded only
// where it holds a byte of the row (else 0): bytes past the row's end are
// the next row's, which meet zero query columns.
template <int PIECE>
__device__ __forceinline__ uint4 load_chunk(const uint8_t* row, int rb,
                                            int off) {
  const uint8_t* a = row + off;
  const uint8_t* end = row + rb;
  if constexpr (PIECE == 8) {
    const uint2* w = reinterpret_cast<const uint2*>(a);
    const uint2 z = make_uint2(0u, 0u);
    const uint2 x0 = __ldg(w), x1 = a + 8 < end ? __ldg(w + 1) : z;
    return make_uint4(x0.x, x0.y, x1.x, x1.y);
  } else if constexpr (PIECE == 4) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(a);
    uint32_t x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a + 4 * i < end ? __ldg(w + i) : 0u;
    return make_uint4(x[0], x[1], x[2], x[3]);
  } else {
    const uintptr_t ua = reinterpret_cast<uintptr_t>(a);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(ua & ~(uintptr_t)3);
    const uint32_t sh = 8u * (uint32_t)(ua & 3);
    const uint8_t* w0 = reinterpret_cast<const uint8_t*>(w);
    uint32_t x[5];
#pragma unroll
    for (int i = 0; i < 5; ++i)
      x[i] = w0 + 4 * i < end && (i < 4 || sh) ? __ldg(w + i) : 0u;
    return make_uint4(__funnelshift_r(x[0], x[1], sh),
                      __funnelshift_r(x[1], x[2], sh),
                      __funnelshift_r(x[2], x[3], sh),
                      __funnelshift_r(x[3], x[4], sh));
  }
}

// tq: TMA map of q_perm (Q, dim_p) int8, dim_p = 128 ceil(dim/2 / 64) (each
// half padded to whole stages), boxes of 128 bytes x 64 rows, 128B swizzle;
// PIECE 0: tv, of v (cap, dim / 2) packed bytes, boxes of 64 bytes x 256
// rows, 64B swizzle (rows past cap and bytes past dim / 2 zero); PIECE 8 /
// 4 / 2: the expanders read v (`v`) from device memory (`load_chunk`).
// vscale (cap,), mask (cap,)
// uint8; `partial` receives, per query of this CTA's tile, k keys at
// ((q * ranges + range) * k); BUF == 0 (the wide kind's pass A) keeps no
// selection: `partial` is then the slab, (Q, ld) uint32 with ld = cap
// rounded up to 128, and every live query's row below cap gets its
// sortable score key float_order(s) at (q * ld + row), whatever its mask
// byte. q_perm (for the query sums); dim even.
template <int S1, int S2, int BUF, int PIECE>
__global__ void __launch_bounds__(THREADS, 1)
scan_i4_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tv,
               const int8_t* __restrict__ q_perm,
               const uint8_t* __restrict__ v,
               const float* __restrict__ vscale,
               const uint8_t* __restrict__ mask, u64* __restrict__ partial,
               int Q, long cap, int dim, int k, int q_tiles, int ranges) {
  typedef Ring<S1, S2, BUF> R;
  constexpr bool TMA_ROWS = PIECE == 0;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  const uint32_t a_ring = base + R::A_OFF, b_ring = base + R::B_OFF;
  const uint32_t p_ring = base + R::P_OFF;
  // barriers: loaded (TMA bytes of a slot), empty1 (a slot read by the
  // expanders and the consumers), full2 (a B tile expanded), empty2 (a B
  // tile consumed)
  const uint32_t loaded = base + R::BAR_OFF, empty1 = loaded + 8 * S1;
  const uint32_t full2 = empty1 + 8 * S1, empty2 = full2 + 8 * S2;
  float* msc = reinterpret_cast<float*>(sm + R::MSC_OFF);
  uint32_t* mlive = reinterpret_cast<uint32_t*>(sm + R::LIVE_OFF);
  u64* tau = reinterpret_cast<u64*>(sm + R::TAU_OFF);
  u64* buf = reinterpret_cast<u64*>(sm + R::BUF_OFF);
  int* cnt = reinterpret_cast<int*>(sm + R::CNT_OFF);

  const int q0 = (blockIdx.x % q_tiles) * BM, range = blockIdx.x / q_tiles;
  const long tiles = (cap + BN - 1) / BN;  // none when cap == 0
  const long tb = range * tiles / ranges, te = (range + 1) * tiles / ranges;
  const int rb = dim / 2;  // packed bytes a row
  const int k_iters = (rb + PACKED - 1) / PACKED;
  const int dim_p = k_iters * ROW_BYTES;  // q_perm's row
  const long steps = (te - tb) * k_iters;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S1; ++s) {
      mbar_init(loaded + 8 * s, 1);  // the TMA thread's expect_tx
      // the eight consumer warps, and the three expander warps where the
      // slot holds the packed slice
      mbar_init(empty1 + 8 * s,
                CONSUMER_WARPS + (TMA_ROWS ? EXPANDERS / 32 : 0));
    }
    for (int s = 0; s < S2; ++s) {
      mbar_init(full2 + 8 * s, EXPANDERS);
      mbar_init(empty2 + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < BM) {
    cnt[threadIdx.x] = 0;
    tau[threadIdx.x] = 0ull;
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // warpgroup 2
    const int t = threadIdx.x - CONSUMERS;
    if (t < 32) {  // warp 0: one thread keeps the TMA slots filled
      if (t == 0)
        for (long n = 0; n < steps; ++n) {
          const int s1 = (int)(n % S1);
          mbar_wait(empty1 + 8 * s1, (uint32_t)((n / S1) & 1) ^ 1);
          mbar_expect_tx(loaded + 8 * s1, A_BYTES + (TMA_ROWS ? P_BYTES : 0));
          const int kk = (int)(n % k_iters);
          tma_load_2d(a_ring + s1 * A_BYTES, &tq, loaded + 8 * s1,
                      kk * ROW_BYTES, q0);
          if (TMA_ROWS)
            tma_load_2d(p_ring + s1 * P_BYTES, &tv, loaded + 8 * s1,
                        kk * PACKED, (int)((tb + n / k_iters) * BN));
        }
      return;
    }
    // warps 1-3 expand: 16-byte chunk c of row r of the packed slice
    // (stored by TMA at chunk c ^ ((r >> 1) & 3), or read from device
    // memory) into chunks c (low nibbles) and c + 4 (high) of B row r,
    // 128B-swizzled (chunk ^ r % 8). A quarter warp takes one chunk of 8
    // consecutive rows: conflict-free reads and writes.
    const int e = t - 32;
    for (long n = 0; n < steps; ++n) {
      const int s1 = (int)(n % S1), s2 = (int)(n % S2);
      const int kk = (int)(n % k_iters);
      const bool first = kk == 0;
      const long tile = tb + n / k_iters;
      uint4 x[PER];  // every read issued before the first write
      if constexpr (!TMA_ROWS) {
        // the stage's chunks from device memory, before the wait for the
        // B tile: their latency hides behind the consumers' products
#pragma unroll
        for (int m = 0; m < PER; ++m) {
          const int i = e + m * EXPANDERS, row = (i % 8) + 8 * (i / 32);
          const int off = kk * PACKED + 16 * ((i / 8) % 4);
          const long r = tile * BN + row;
          x[m] = make_uint4(0u, 0u, 0u, 0u);
          if (i < ITEMS && r < cap && off < rb)
            x[m] = load_chunk<PIECE>(v + r * rb, rb, off);
        }
      } else {
        mbar_wait(loaded + 8 * s1, (uint32_t)((n / S1) & 1));
      }
      mbar_wait(empty2 + 8 * s2, (uint32_t)((n / S2) & 1) ^ 1);
      // at a tile's first stage, its row scales for the epilogue: loaded
      // here, stored after the expansion has hidden the loads' latency
      float sc[(BN + EXPANDERS - 1) / EXPANDERS];
      uint32_t lw[(BN + EXPANDERS - 1) / EXPANDERS];
#pragma unroll
      for (int m = 0; m * EXPANDERS < BN; ++m) {
        const long row = tile * BN + e + m * EXPANDERS;
        // warp-uniform (EXPANDERS and BN are multiples of 32): a warp's
        // ballot is the live word of its 32 rows
        if (first && e + m * EXPANDERS < BN) {
          const bool live = row < cap && mask[row];
          sc[m] = live ? vscale[row] : 0.0f;
          lw[m] = __ballot_sync(0xffffffffu, live);
        }
      }
      const unsigned char* pt = sm + R::P_OFF + s1 * P_BYTES;
      unsigned char* bt = sm + R::B_OFF + s2 * B_BYTES;
      if constexpr (TMA_ROWS) {
#pragma unroll
        for (int m = 0; m < PER; ++m) {
          const int i = e + m * EXPANDERS, row = (i % 8) + 8 * (i / 32);
          if (i < ITEMS)
            x[m] = *reinterpret_cast<const uint4*>(
                pt + row * PACKED + 16 * (((i / 8) % 4) ^ ((row >> 1) & 3)));
        }
      }
#pragma unroll
      for (int m = 0; m < PER; ++m) {
        const int i = e + m * EXPANDERS;
        const int row = (i % 8) + 8 * (i / 32), c = (i / 8) % 4;
        if (i < ITEMS) {
          uint4* dst = reinterpret_cast<uint4*>(bt + row * ROW_BYTES);
          dst[c ^ (row & 7)] = low_plane(x[m]);
          dst[(c + 4) ^ (row & 7)] = high_plane(x[m]);
        }
      }
      if (first) {
        float* ms = msc + (int)(tile % MSC_TILES) * BN;
        uint32_t* lv = mlive + (int)(tile % MSC_TILES) * LIVE_WORDS;
#pragma unroll
        for (int m = 0; m * EXPANDERS < BN; ++m)
          if (e + m * EXPANDERS < BN) {
            ms[e + m * EXPANDERS] = sc[m];
            if (e % 32 == 0) lv[(e + m * EXPANDERS) / 32] = lw[m];
          }
      }
      // the B tile, written through the generic proxy, is read by wgmma
      // through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full2 + 8 * s2);
      if constexpr (TMA_ROWS) {
        __syncwarp();
        if (e % 32 == 0) mbar_arrive(empty1 + 8 * s1);  // the slice is read
      }
    }
    return;
  }

  // consumers: warpgroup g multiplies the 64 queries by rows 128 g .. of
  // each tile. Lane l of warp w holds queries 16 w + l / 4 (+ 8) at rows
  // 8 j + 2 (l % 4) + e, in acc[4 j + 2 h + e] (wgmma's fragment layout).
  const int g = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
  const int l = threadIdx.x % 32;
  const bool leader = l == 0;
  int qi[2], bias[2];
  bool qlive[2];
  u64 tk[2] = {0ull, 0ull};  // the query's tau, and its score (a key
  float ts[2];               // scored below ts cannot beat tau)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ts[h] = -__int_as_float(0x7f800000);
    qi[h] = 16 * w + l / 4 + 8 * h;
    qlive[h] = q0 + qi[h] < Q;
    // sum(q): the quad's four lanes split the row, then add across it
    int s = 0;
    if (qlive[h])
      for (int e = (l % 4) * 16; e < dim_p; e += 64) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(
            q_perm + (long)(q0 + qi[h]) * dim_p + e));
        s = __dp4a((int)u.x, 0x01010101, s);
        s = __dp4a((int)u.y, 0x01010101, s);
        s = __dp4a((int)u.z, 0x01010101, s);
        s = __dp4a((int)u.w, 0x01010101, s);
      }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    bias[h] = 8 * s;
  }

  constexpr bool LAG = S2 > 1;  // release a stage after the next one's issue
  int acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0;
  long n = 0;
  for (long tile = tb; tile < te; ++tile) {
    int prev1 = 0, prev2 = 0;
    for (int kk = 0; kk < k_iters; ++kk, ++n) {
      const int s1 = (int)(n % S1), s2 = (int)(n % S2);
      mbar_wait(loaded + 8 * s1, (uint32_t)((n / S1) & 1));
      mbar_wait(full2 + 8 * s2, (uint32_t)((n / S2) & 1));
      const uint64_t da = sw128_desc(a_ring + s1 * A_BYTES);
      const uint64_t db = sw128_desc(b_ring + s2 * B_BYTES +
                                     g * (NW * ROW_BYTES));
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int s4 = 0; s4 < ROW_BYTES / 32; ++s4)
        mma(acc, da + 2 * s4, db + 2 * s4, (kk | s4) != 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if constexpr (LAG) {
        // the previous stage's products have completed: release it
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (kk > 0 && leader) {
          mbar_arrive(empty1 + 8 * prev1);
          mbar_arrive(empty2 + 8 * prev2);
        }
      } else {
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        if (leader) {
          mbar_arrive(empty1 + 8 * s1);
          mbar_arrive(empty2 + 8 * s2);
        }
      }
      prev1 = s1;
      prev2 = s2;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    if (LAG && leader) {
      mbar_arrive(empty1 + 8 * prev1);
      mbar_arrive(empty2 + 8 * prev2);
    }

    if constexpr (BUF == 0) {
      // the wide kind's slab (topk_i4_wide.cu): every (live query, row
      // below cap) gets float_order(s), rows 8 j + 2 (l % 4) + {0, 1} as
      // one 8-byte store (a quad writes 32 contiguous bytes); the readers
      // of the slab read the mask
      uint32_t* slab = reinterpret_cast<uint32_t*>(partial);
      const long ld = (cap + SEG - 1) / SEG * SEG;
      const float* ms =
          msc + (int)(tile % MSC_TILES) * BN + g * NW + 2 * (l % 4);
      const long r0 = tile * BN + g * NW + 2 * (l % 4);
#pragma unroll
      for (int j = 0; j < ACC / 4; ++j) {
        const float2 sc2 = *reinterpret_cast<const float2*>(ms + 8 * j);
        const long r = r0 + 8 * j;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (!qlive[h] || r >= cap) continue;
          uint32_t* out = slab + (long)(q0 + qi[h]) * ld + r;
          const uint32_t k0 = float_order(__fmul_rn(
              __int2float_rn(acc[4 * j + 2 * h] - bias[h]), sc2.x));
          const uint32_t k1 = float_order(__fmul_rn(
              __int2float_rn(acc[4 * j + 2 * h + 1] - bias[h]), sc2.y));
          if (r + 1 < cap)
            *reinterpret_cast<uint2*>(out) = make_uint2(k0, k1);
          else
            *out = k0;
        }
      }
    } else {
      // epilogue: admit, and compact + re-admit while an admission failed
      const float* ms =
          msc + (int)(tile % MSC_TILES) * BN + g * NW + 2 * (l % 4);
      // row 8 j + 2 (l % 4) + e of the warpgroup's 128: bit 8 (j % 4) +
      // 2 (l % 4) + e of its live word j / 4
      uint32_t live[NW / 32];
#pragma unroll
      for (int i = 0; i < NW / 32; ++i)
        live[i] =
            mlive[(int)(tile % MSC_TILES) * LIVE_WORDS + g * (NW / 32) + i];
      const long r0 = tile * BN + g * NW + 2 * (l % 4);
      // bit 4 j + 2 h + e: not yet admitted or dropped
      uint64_t pend = ~0ull;
      for (;;) {
#pragma unroll
        for (int j = 0; j < ACC / 4; ++j) {
          if (!((pend >> (4 * j)) & 0xFull)) continue;
          const float2 sc2 = *reinterpret_cast<const float2*>(ms + 8 * j);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sc = e ? sc2.y : sc2.x;
            const bool row_live =
                (live[j / 4] >> (8 * (j % 4) + 2 * (l % 4) + e)) & 1u;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int i = 4 * j + 2 * h + e;
              if (!((pend >> i) & 1ull)) continue;
              bool keep = false;
              if (qlive[h] && row_live) {
                const float s =
                    __fmul_rn(__int2float_rn(acc[i] - bias[h]), sc);
                if (s >= ts[h]) {
                  const u64 key = row_key(s, (uint32_t)(r0 + 8 * j + e));
                  if (key > tk[h]) {
                    const int slot = atomicAdd(&cnt[qi[h]], 1);
                    if (slot < BUF) buf[qi[h] * BUF + slot] = key;
                    else keep = true;
                  }
                }
              }
              if (!keep) pend &= ~(1ull << i);
            }
          }
        }
        if (!ws::any_of(pend != 0, CONSUMER_BAR, CONSUMERS)) break;
        ws::compact<BM, BUF, CONSUMER_BAR, CONSUMERS>(buf, cnt, tau, k);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          tk[h] = tau[qi[h]];
          ts[h] = row_key_score(tk[h]);
        }
      }
    }
  }
  if constexpr (BUF > 0) {
    ws::named_sync(CONSUMER_BAR, CONSUMERS);
    ws::compact<BM, BUF, CONSUMER_BAR, CONSUMERS>(buf, cnt, tau, k);
    for (int i = threadIdx.x; i < BM * k; i += CONSUMERS) {
      const int qq = i / k, j = i % k;
      if (q0 + qq < Q)
        partial[((long)(q0 + qq) * ranges + range) * k + j] = buf[qq * BUF + j];
    }
  }
}

// The tensor map of the packed rows v (cap, dim / 2) read in boxes of 64
// bytes x 256 rows, 64B-swizzled, rows past cap and bytes past dim / 2
// zero. 0, or minus the CUresult of a refused encode.
int encode_packed(wg::EncodeTiled enc, CUtensorMap* map, const void* v,
                  long long cap, int dim) {
  const cuuint64_t gdim[2] = {(cuuint64_t)(dim / 2), (cuuint64_t)cap};
  const cuuint64_t gstride[1] = {(cuuint64_t)(dim / 2)};
  const cuuint32_t box[2] = {(cuuint32_t)PACKED, (cuuint32_t)BN};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2,
                         const_cast<void*>(v), gdim, gstride, box, estride,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

template <int S1, int S2, int BUF, int PIECE>
int launch_piece(const CUtensorMap& tq, const CUtensorMap& tv,
                 const void* q_perm, const void* v, const void* vscale,
                 const void* mask, u64* partial, int Q, long long cap,
                 int dim, int k, int q_tiles, int ranges,
                 cudaStream_t stream) {
  constexpr int smem = Ring<S1, S2, BUF>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(
      scan_i4_kernel<S1, S2, BUF, PIECE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  scan_i4_kernel<S1, S2, BUF, PIECE>
      <<<q_tiles * ranges, THREADS, smem, stream>>>(
          tq, tv, static_cast<const int8_t*>(q_perm),
          static_cast<const uint8_t*>(v), static_cast<const float*>(vscale),
          static_cast<const uint8_t*>(mask), partial, Q, (long)cap, dim, k,
          q_tiles, ranges);
  return (int)cudaGetLastError();
}

// The maps and the grid of a launch over q_perm (Q, dim_p) and v (cap, dim
// / 2) by the rows' producer `piece` (ops/scan.py::rows_piece of v: 0 TMA,
// 8 / 4 / 2 the expanders' reads): q_tiles = ceil(Q / 64) query tiles x
// `ranges` = max(1, min(ceil(cap / 256), SMs / q_tiles)) corpus ranges
// (ops/scan.py::i4_wgmma_partition). 0, a cudaError_t, or minus a refused
// encode's CUresult.
struct Plan {
  CUtensorMap tq, tv;
  int q_tiles, ranges, piece;
};
int plan(Plan* p, int piece, const void* q_perm, const void* v, int Q,
         long long cap, int dim) {
  const uintptr_t bits = (uintptr_t)(dim / 2) | (uintptr_t)v;
  const int align = piece == 0 ? 16 : piece == 2 ? 1 : piece;
  if (cap < 0 || dim <= 0 || dim % 2 || (uintptr_t)q_perm % 16 ||
      (piece != 0 && piece != 8 && piece != 4 && piece != 2) ||
      bits % align)
    return (int)cudaErrorInvalidValue;
  p->piece = piece;
  std::memset(&p->tv, 0, sizeof(p->tv));  // the expanders read v themselves
  wg::EncodeTiled enc;
  int err = wg::encoder(&enc);
  if (err) return err;
  const int dim_p = (dim / 2 + PACKED - 1) / PACKED * ROW_BYTES;
  if ((err = wg::encode_rows<wg::Int8>(enc, &p->tq, q_perm, Q, dim_p, BM)))
    return err;
  if (piece == 0 && cap > 0 && (err = encode_packed(enc, &p->tv, v, cap, dim)))
    return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  p->q_tiles = (Q + BM - 1) / BM;
  const long long tiles = std::max(1LL, (cap + BN - 1) / BN);
  p->ranges =
      (int)std::max(1LL, std::min(tiles, (long long)(sms / p->q_tiles)));
  if ((long long)p->q_tiles * p->ranges > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// The ring shape <S1, S2, BUF> with the plan's producer.
template <int S1, int S2, int BUF>
int launch(const Plan& p, const void* q_perm, const void* v,
           const void* vscale, const void* mask, u64* partial, int Q,
           long long cap, int dim, int k, cudaStream_t s) {
  switch (p.piece) {
    case 0:
      return launch_piece<S1, S2, BUF, 0>(p.tq, p.tv, q_perm, v, vscale, mask,
                                          partial, Q, cap, dim, k, p.q_tiles,
                                          p.ranges, s);
    case 8:
      return launch_piece<S1, S2, BUF, 8>(p.tq, p.tv, q_perm, v, vscale, mask,
                                          partial, Q, cap, dim, k, p.q_tiles,
                                          p.ranges, s);
    case 4:
      return launch_piece<S1, S2, BUF, 4>(p.tq, p.tv, q_perm, v, vscale, mask,
                                          partial, Q, cap, dim, k, p.q_tiles,
                                          p.ranges, s);
    default:
      return launch_piece<S1, S2, BUF, 2>(p.tq, p.tv, q_perm, v, vscale, mask,
                                          partial, Q, cap, dim, k, p.q_tiles,
                                          p.ranges, s);
  }
}

}  // namespace i4
}  // namespace

// The wide kind's pass A (topk_i4_wide.cu): the scan with the slab
// epilogue (BUF 0), three TMA slots and three B tiles (no buffers beside
// them), the rows by the producer `piece` names. q_perm (Q, dim_p) int8
// permuted queries, v (cap, dim / 2) packed rows, vscale (cap,) float32,
// mask (cap,) uint8; slab (Q, ld = cap rounded up to 128) uint32 receives
// float_order(score) of every live query's row below cap.
int launch_i4_slab(int piece, const void* q_perm, const void* v,
                   const void* vscale, const void* mask, uint32_t* slab,
                   int Q, long long cap, int dim, cudaStream_t stream) {
  using namespace i4;
  if (Q <= 0 || cap <= 0) return (int)cudaSuccess;
  if (!vscale) return (int)cudaErrorInvalidValue;
  Plan p;
  const int err = plan(&p, piece, q_perm, v, Q, cap, dim);
  if (err) return err;
  return launch<3, 3, 0>(p, q_perm, v, vscale, mask,
                         reinterpret_cast<u64*>(slab), Q, cap, dim, 0,
                         stream);
}

}  // namespace pv

// K6's tensor-core scan: piece (the rows' producer, ops/scan.py::
// rows_piece: 0 TMA, 8 / 4 / 2 the expanders' reads of 8- / 4-byte words or
// of any bytes), q_perm (Q, dim_p) int8 queries with their columns
// permuted and each half padded to whole stages (ops/scan.py::
// permute_i4_queries; dim_p = 128 ceil(dim/2 / 64)), v (cap, dim / 2)
// packed int4 rows, vscale (cap,) float32, mask (cap,) uint8; Q > 0, k <=
// 128, dim even, 16-byte aligned q_perm, v and dim / 2 at the piece's
// alignment. The grid is `Plan`'s;
// `partial` is scratch of Q * ranges * k uint64; vals (Q, k) float32 (the
// scaled scores) and idx (Q, k) int32 receive the result (-inf / 0 where
// empty). Launches on the current device. Returns 0, a cudaError_t, or
// minus the CUresult of a refused tensor-map encode.
extern "C" int pv_scan_topk_i4_wgmma(int piece, const void* q_perm,
                                     const void* v, const void* vscale,
                                     const void* mask, void* partial,
                                     void* vals, void* idx, int Q,
                                     long long cap, int dim, int k,
                                     void* stream) {
  using namespace pv;
  using namespace pv::i4;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (k > 128 || !vscale) return (int)cudaErrorInvalidValue;
  Plan p;
  int err = plan(&p, piece, q_perm, v, Q, cap, dim);
  if (err) return err;
  u64* part = static_cast<u64*>(partial);
  cudaStream_t s = (cudaStream_t)stream;
  // k <= 32: three TMA slots, three B tiles, 64-key buffers; up to 128:
  // two slots, one B tile, 256-key buffers (shared memory holds no more)
  err = k <= 32 ? launch<3, 3, 64>(p, q_perm, v, vscale, mask, part, Q, cap,
                                   dim, k, s)
                : launch<2, 1, 256>(p, q_perm, v, vscale, mask, part, Q, cap,
                                    dim, k, s);
  if (err) return err;
  return (int)launch_topk_merge(part, static_cast<float*>(vals),
                                static_cast<int*>(idx), Q, p.ranges * k, k, s,
                                false);
}
