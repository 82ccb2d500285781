// The tensor-core masked top-k scan: K4 and K3 (scan_topk_wgmma.cu, whose
// head comment sets out the design) and K7 at Q > 16 (ivf_scan_wgmma.cu).
// Rows as M, N queries as N, a ring of 128-byte k-stages, a selection
// per query in registers and shared memory, over either the rows [0, cap)
// in 128-row segments or the live steps of an IVF hot-tile table
// (`Rows`). With BUF 0 it is the wide kinds' pass A (K4: topk_wide.cu, K3:
// topk_i8_wide.cu, K7: ivf_scan_wide.cu): every key goes to a slab.
//
// The query planes always arrive by TMA (the launchers pad them to whole
// 16 bytes). The rows take one of three producers (PIECE), as K1's
// mainloop does (wgmma_tiles.cuh), each writing the very bytes TMA's 128B
// swizzle lays out, so the consumers and the epilogues are the same (the
// cp.async and realigning producers are wgmma_scan.cuh's `produce_rows`,
// which K8's segment scan shares):
//  * PIECE 0: TMA, one producer warp, for rows of whole 16 bytes at a
//    16-byte aligned base;
//  * PIECE 8 / 4: a producer warpgroup copying each stage's 128 rows by
//    cp.async in pieces of PIECE bytes (wg::cp_stage: zero-filled past the
//    row's end and past cap), where the row bytes and the base are
//    multiples of PIECE (float32 rows at every width, bf16 rows at even
//    widths, int8 rows at dim % 4 == 0);
//  * PIECE 2: the realigning producer, for any other rows (odd bf16
//    widths, int8 widths not a multiple of 4, bases aligned to 1 or 2
//    bytes). Rows j, j + 16, j + 32, ... of any matrix form a 2D tensor
//    whose stride, 16 row bytes, TMA takes, based at row j's start
//    aligned down to 16 bytes (`off` bytes before it); the producer's
//    elected thread loads each class's 8 rows of a segment, 144 bytes of
//    each row's span at k-stage kk, into a staging slot (two slots, TMA
//    running a slot ahead), and the warpgroup shifts each row's 128 bytes
//    into the ring's swizzled stage (wg::shift_pair at any byte offset).
// The cp.async and realigning producers arrive on a stage's full barrier
// once per thread (128) beside the elected thread's expect_tx for the
// query planes; the consumers fence the generic-proxy writes for wgmma's
// async proxy after their wait. With their warpgroup the kernel runs 384
// threads, 168 registers each at launch; as K1's producers, they give
// registers back (setmaxnreg: 40 a thread for cp.async, 72 for the
// realigning producer's shifts) and the consumers take them (232 / 216),
// which the float kinds' wide tiles (N = 64) need to keep their sums in
// registers.
#pragma once

#include <climits>
#include <mutex>
#include <type_traits>

#include "wgmma_scan.cuh"

namespace pv {
namespace {
namespace tk {

using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::smem_u32;
using wg::sw128_desc;
using wg::tma_load_2d;

constexpr int ROWS = SEG;                      // a segment: two m64 tiles
constexpr int ROW_BYTES = 128;                 // bytes of a row per k-stage
constexpr int A_BYTES = ROWS * ROW_BYTES;      // 16 KB
constexpr int HALF_BYTES = A_BYTES / 2;        // a warpgroup's m64 tile
constexpr int CONSUMERS = 256;                 // warpgroups 0 and 1
constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMER_BAR = 1;  // named barriers: 1 the consumers, 2 + g
                                 // warpgroup g's split, 4 the producer
using ws::PRODUCERS;             // warpgroup's (PIECE 2: ws::PRODUCER_BAR)
using ws::RowClasses;
using ws::RowMapsOf;
using ws::RSLOT;
using ws::RSLOTS;

// Threads of the kernel with the rows' producer PIECE: one producer warp
// for TMA, a warpgroup for the others.
__host__ __device__ constexpr int threads_of(int piece) {
  return CONSUMERS + (piece ? PRODUCERS : 32);
}

// Row kinds: BK elements a k-stage, the TMA type, the query planes; INT:
// s8 wgmma into one int32 sum a row, SCALED: times the row's scale into a
// float32 score (else the int32 sum is the score); Score: what ranks.
struct F32 {  // 3xTF32: query planes hi, lo
  typedef float Score;
  static constexpr bool INT = false, SCALED = false;
  static constexpr int BK = 32, ELEM_BYTES = 4, PLANES = 2;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
struct Bf16 {  // three bf16 planes of the float32 query
  typedef float Score;
  static constexpr bool INT = false, SCALED = false;
  static constexpr int BK = 64, ELEM_BYTES = 2, PLANES = 3;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
// bf16 rows against a bf16 query (K7: the postings' dtype is the query's),
// one plane
struct Bf16Q {
  typedef float Score;
  static constexpr bool INT = false, SCALED = false;
  static constexpr int BK = 64, ELEM_BYTES = 2, PLANES = 1;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
// int8 rows times their scale against the int8 queries (K3): exact int32
// sums. TMA has no signed 8-bit type; the bytes copy as they are and the
// out-of-bounds fill is int8 0.
struct Int8R {
  typedef float Score;
  static constexpr bool INT = true, SCALED = true;
  static constexpr int BK = 128, ELEM_BYTES = 1, PLANES = 1;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};
// column-scaled int8 rows against folded int8 queries (K7): the exact
// int32 sum ranks (int_row_key), never a float32 rounding of it
struct Int8C {
  typedef int Score;
  static constexpr bool INT = true, SCALED = false;
  static constexpr int BK = 128, ELEM_BYTES = 1, PLANES = 1;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// Which rows the scan walks. hot == nullptr: the rows [0, cap) as
// ceil(cap / 128) segments. Else (K7) the live steps of an IVF hot-tile
// table: logical segment j is physical rows hot[j / ns] * bn + (j % ns) *
// 128 + [0, 128), ns = bn / 128, over the min(*n_hot, grid_b) live steps,
// read on the device (dead steps read nothing).
struct Rows {
  const int* hot;
  const int* n_hot;
  int bn, grid_b;
};

__device__ __forceinline__ long num_segments(const Rows& m, long cap) {
  if (!m.hot) return (cap + ROWS - 1) / ROWS;
  return (long)max(0, min(*m.n_hot, m.grid_b)) * (m.bn / ROWS);
}

__device__ __forceinline__ long segment_row(const Rows& m, long seg) {
  if (!m.hot) return seg * ROWS;
  const int ns = m.bn / ROWS;
  return (long)m.hot[seg / ns] * m.bn + (seg % ns) * ROWS;
}

// A (score, row) selection key, and the least score a key above `tau` can
// carry (tau = 0, no key yet: every score)
__device__ __forceinline__ u64 sel_key(float s, uint32_t row) {
  return row_key(s, row);
}
__device__ __forceinline__ u64 sel_key(int s, uint32_t row) {
  return int_row_key(s, row);
}
__device__ __forceinline__ float score_floor(u64 tau, float) {
  return row_key_score(tau);
}
__device__ __forceinline__ int score_floor(u64 tau, int) {
  return tau ? (int)((uint32_t)(tau >> 32) ^ 0x80000000u) : INT_MIN;
}
// The slab's 32-bit sortable key of a score: the high word of its
// selection key (row_key / int_row_key), so pass B's (key, row) keys order
// as the selection keys do
__device__ __forceinline__ uint32_t slab_key(float s) { return float_order(s); }
__device__ __forceinline__ uint32_t slab_key(int s) {
  return (uint32_t)s ^ 0x80000000u;
}

// Shared memory of kind T with N queries a CTA, S stages, BUF keys a
// query and the rows' producer PIECE: the ring (rows, then the query
// planes), the realigning producer's staging slots, F32's lo buffers (two
// a warpgroup), the barriers (full, empty, then the slots'), then the
// selection (tau, the buffers, their counts); 1 KB to align the ring
// (swizzle atoms are 1024 B).
template <class T, int N, int S, int BUF, int PIECE = 0>
struct Smem {
  static constexpr int PLANE_BYTES = N * ROW_BYTES;  // a query plane
  static constexpr int B_BYTES = T::PLANES * PLANE_BYTES;
  static constexpr int A_OFF = 0;
  static constexpr int B_OFF = S * A_BYTES;
  static constexpr int SLOT_OFF = B_OFF + S * B_BYTES;
  static constexpr int LO_OFF = SLOT_OFF + (PIECE == 2 ? RSLOTS * RSLOT : 0);
  static constexpr int BAR_OFF = LO_OFF + (T::PLANES == 2 ? 4 * HALF_BYTES : 0);
  static constexpr int TAU_OFF =
      BAR_OFF + 8 * (2 * S + (PIECE == 2 ? RSLOTS : 0));
  static constexpr int BUF_OFF = TAU_OFF + N * 8;
  static constexpr int CNT_OFF = BUF_OFF + N * BUF * 8;
  static constexpr int BYTES = 1024 + CNT_OFF + N * 4;
  // a stage's TMA bytes: the rows and the planes, or the planes alone
  static constexpr uint32_t TX = (PIECE ? 0 : A_BYTES) + B_BYTES;
  static_assert(BYTES <= 232448, "shared memory of one CTA");
};

// Consumer warpgroup g's k-stage n (of the CTA's run), float kinds: wait
// for its slot, (F32) split the warpgroup's rows into lo buffer n % 2 of
// its two, and issue the stage's wgmmas into `part` as one commit group
// (F32, Bf16: 12, three products; Bf16Q: 4). The other lo buffer and the
// previous slot are still read by stage n - 1's wgmmas.
template <class T, int N, int S, int BUF, int PIECE>
__device__ __forceinline__ void issue(float (&part)[N / 2], uint32_t n,
                                      unsigned char* sm, int g) {
  typedef Smem<T, N, S, BUF, PIECE> L;
  const int st = (int)(n % S);
  const uint32_t base = smem_u32(sm);
  mbar_wait(base + L::BAR_OFF + 8 * st, (n / S) & 1);
  if constexpr (PIECE > 0)  // the producer's threads wrote the rows
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const int a_off = L::A_OFF + st * A_BYTES + g * HALF_BYTES;
  const int lo_off = L::LO_OFF + (2 * g + (int)(n % 2)) * HALF_BYTES;
  const uint32_t bq = base + L::B_OFF + st * L::B_BYTES;
  if constexpr (T::PLANES == 2)  // 3xTF32: split the warpgroup's rows
    ws::split_tf32<HALF_BYTES>(sm + a_off, sm + lo_off, 2 + g);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s4 = 0; s4 < ROW_BYTES / 32; ++s4) {
    const uint64_t da = sw128_desc(base + a_off) + 2 * s4;
    const uint64_t d0 = sw128_desc(bq) + 2 * s4;
    if constexpr (T::PLANES == 2) {  // hi.hi + hi.lo + lo.hi
      ws::mma_tf32(part, da, d0, s4 != 0);
      ws::mma_tf32(part, da, sw128_desc(bq + L::PLANE_BYTES) + 2 * s4, 1);
      ws::mma_tf32(part, sw128_desc(base + lo_off) + 2 * s4, d0, 1);
    } else if constexpr (T::PLANES == 3) {  // v.q1 + v.q2 + v.q3
      ws::mma_bf16(part, da, d0, s4 != 0);
      ws::mma_bf16(part, da, sw128_desc(bq + L::PLANE_BYTES) + 2 * s4, 1);
      ws::mma_bf16(part, da, sw128_desc(bq + 2 * L::PLANE_BYTES) + 2 * s4, 1);
    } else {  // v.q
      ws::mma_bf16(part, da, d0, s4 != 0);
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Consumer warpgroup g's k-stage n, int8 kinds: wait for its slot and
// issue the stage's four s8 wgmmas into the segment's int32 sum (`first`:
// the segment's first stage overwrites it) as one commit group.
template <class T, int N, int S, int BUF, int PIECE>
__device__ __forceinline__ void issue_s8(int (&sum)[N / 2], uint32_t n,
                                         unsigned char* sm, int g,
                                         bool first) {
  typedef Smem<T, N, S, BUF, PIECE> L;
  const int st = (int)(n % S);
  const uint32_t base = smem_u32(sm);
  mbar_wait(base + L::BAR_OFF + 8 * st, (n / S) & 1);
  if constexpr (PIECE > 0)  // the producer's threads wrote the rows
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const uint64_t da =
      sw128_desc(base + L::A_OFF + st * A_BYTES + g * HALF_BYTES);
  const uint64_t db = sw128_desc(base + L::B_OFF + st * L::B_BYTES);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s4 = 0; s4 < ROW_BYTES / 32; ++s4)
    ws::mma_s8(sum, da + 2 * s4, db + 2 * s4, !first || s4 != 0);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most W commit groups are pending and frees stage n's
// slot: its wgmmas have completed.
template <int S, int W>
__device__ __forceinline__ void release(uint32_t n, uint32_t empty,
                                        int lane) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(W) : "memory");
  if (lane == 0) mbar_arrive(empty + 8 * (int)(n % S));
}

// Retires stage n once at most W commit groups are pending (W = 1: all
// but the stage issued after it): frees its slot and folds its sum into
// the row's with one round-to-nearest add a register.
template <int S, int W, int A>
__device__ __forceinline__ void retire(float (&part)[A], float (&acc)[A],
                                       uint32_t n, uint32_t empty, int lane) {
  release<S, W>(n, empty, lane);
  ws::fence_acc(part);
#pragma unroll
  for (int i = 0; i < A; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
}

// A producer's walk over its range's segments that hold a live row, a
// k-stage at a time: next() moves to the next (segment, k-stage) and
// returns false past the range's end. Start at seg = first segment - 1,
// kk = k_iters - 1. Every lane of a warp calls it together (the mask's
// warp vote).
struct Walk {
  long seg, se, r0;
  int kk, k_iters;
  __device__ __forceinline__ bool next(const Rows& map,
                                       const uint8_t* __restrict__ mask,
                                       long cap, int lane) {
    if (seg < se && ++kk < k_iters) return true;
    kk = 0;
    while (++seg < se) {
      r0 = segment_row(map, seg);
      bool live[4];
      if (ws::segment_live(mask, r0, cap, lane, live)) return true;
    }
    return false;
  }
};

// tv: the rows' maps (PIECE 0: TMA's of the rows (cap, dim), boxes of 128
// bytes x 128 rows, 128B-swizzled; PIECE 2: the class maps; PIECE 8 / 4:
// unused, the producer reads `vp`, the rows' base); tq0 .. tq2: TMA maps of
// the query planes (Q, padded width), boxes of 128 bytes x N rows (F32
// reads two, the one-plane kinds one), 128B-swizzled. mask (cap,) uint8;
// vscale (cap,) float32, Int8R's row scales; `map` the segments walked.
// `partial` receives, per query of this CTA's tile, k keys at ((q *
// ranges + range) * k). BUF == 0 (the wide kinds' pass A) keeps no
// selection: `partial` is then the slab, (Q, ld) uint32, and every row
// below cap of a live segment gets its sortable score key slab_key(s),
// whatever its mask byte (the readers of the slab read the mask); rows of
// dead segments are not written. Over the rows [0, cap) (K4, K3) a row's
// key lies at (q * ld + row), ld = cap rounded up to whole segments; over
// a hot-tile table (K7) at its logical row, (q * ld + seg * 128 + lane)
// for logical segment seg, ld = grid_b * bn.
template <class T, int N, int S, int BUF, int PIECE = 0>
__global__ void __launch_bounds__(threads_of(PIECE), 1)
scan_topk_wgmma_kernel(const __grid_constant__ RowMapsOf<PIECE> tv,
                       const __grid_constant__ CUtensorMap tq0,
                       const __grid_constant__ CUtensorMap tq1,
                       const __grid_constant__ CUtensorMap tq2,
                       const unsigned char* __restrict__ vp,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ vscale,
                       u64* __restrict__ partial, int Q, long cap, int dim,
                       int k, int q_tiles, int ranges, int k_iters,
                       const Rows map) {
  typedef Smem<T, N, S, BUF, PIECE> L;
  typedef typename T::Score Sc;
  constexpr int ACC = N / 2;  // accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  const uint32_t a_ring = base + L::A_OFF, b_ring = base + L::B_OFF;
  const uint32_t full = base + L::BAR_OFF, empty = full + 8 * S;
  const uint32_t staged = empty + 8 * S;  // PIECE 2: the slots' barriers
  u64* tau = reinterpret_cast<u64*>(sm + L::TAU_OFF);
  u64* buf = reinterpret_cast<u64*>(sm + L::BUF_OFF);
  int* cnt = reinterpret_cast<int*>(sm + L::CNT_OFF);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // the elected producer thread's expect_tx arrival, and each thread's
      // of the cp.async and realigning producers
      mbar_init(full + 8 * s, PIECE ? 1 + PRODUCERS : 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    if (PIECE == 2)
      for (int s = 0; s < RSLOTS; ++s) mbar_init(staged + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < N) {
    cnt[threadIdx.x] = 0;
    tau[threadIdx.x] = 0ull;
  }
  __syncthreads();

  const int q0 = (blockIdx.x % q_tiles) * N, range = blockIdx.x / q_tiles;
  const int nq = min(N, Q - q0);  // the tile's queries: the buffers sorted
  const long segs = num_segments(map, cap);  // none when cap == 0
  const long sb = range * segs / ranges, se = (range + 1) * segs / ranges;
  const int lane = threadIdx.x % 32;

  // registers a thread keeps past the launch's 168 (PIECE > 0): the
  // producer's, each consumer's (P + 2 C = 504, the 168 x 3 the launch
  // gives)
  constexpr int PREGS = PIECE == 2 ? 72 : 40, CREGS = (504 - PREGS) / 2;
  if (threadIdx.x >= CONSUMERS) {  // the producer
    if constexpr (PIECE > 0)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PREGS));
    const int t = threadIdx.x - CONSUMERS;
    // k-stage kk's query planes into stage st, with the stage's expect_tx
    auto planes = [&](int st, int kk) {
      mbar_expect_tx(full + 8 * st, L::TX);
      const uint32_t b = b_ring + st * L::B_BYTES;
      tma_load_2d(b, &tq0, full + 8 * st, kk * T::BK, q0);
      if constexpr (T::PLANES >= 2)
        tma_load_2d(b + L::PLANE_BYTES, &tq1, full + 8 * st, kk * T::BK, q0);
      if constexpr (T::PLANES == 3)
        tma_load_2d(b + 2 * L::PLANE_BYTES, &tq2, full + 8 * st, kk * T::BK,
                    q0);
    };
    if constexpr (PIECE == 0) {  // one warp; lane 0 issues the copies
      uint32_t n = 0;
      for (long seg = sb; seg < se; ++seg) {
        const long r0 = segment_row(map, seg);
        bool live[4];
        if (!ws::segment_live(mask, r0, cap, lane, live)) continue;
        if (lane == 0)
          for (int kk = 0; kk < k_iters; ++kk, ++n) {
            const int st = (int)(n % S);
            mbar_wait(empty + 8 * st, ((n / S) & 1) ^ 1);  // first lap: free
            planes(st, kk);
            tma_load_2d(a_ring + st * A_BYTES, &tv.v, full + 8 * st,
                        kk * T::BK, (int)r0);
          }
        __syncwarp();
      }
    } else {  // cp.async or the realigning producer (wgmma_scan.cuh)
      Walk w{sb - 1, se, 0, k_iters - 1, k_iters};
      auto next = [&](ws::Pos& p) {
        if (!w.next(map, mask, cap, lane)) return false;
        p.r0 = w.r0;
        p.kk = w.kk;
        return true;
      };
      ws::produce_rows<PIECE, S>(
          tv, next, [&](int st, const ws::Pos& p) { planes(st, p.kk); },
          a_ring, full, empty, base + L::SLOT_OFF, staged, vp, cap,
          (long)dim * T::ELEM_BYTES, T::BK, t);
    }
    return;
  }
  if constexpr (PIECE > 0)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CREGS));

  // consumers: warpgroup g multiplies rows 64 g .. 64 g + 63 of the
  // segment by the query tile. Lane l of warp w holds rows 64 g + 16 w +
  // l / 4 (+ 8 h) at queries 8 j + 2 (l % 4) + e, in acc[4 j + 2 h + e];
  // ts[2 j + e] is the least score that can beat that query's running
  // k-th best (a key scored below it cannot beat tau).
  const int g = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
  const int m0 = 64 * g + 16 * w + lane / 4;  // the thread's first row
  Sc ts[N / 4];
  uint32_t qlive = 0;  // bit 2 j + e: query 8 j + 2 (l % 4) + e < Q
#pragma unroll
  for (int t = 0; t < N / 4; ++t) {
    ts[t] = score_floor(0ull, Sc());
    qlive |= (uint32_t)(q0 + 8 * (t / 2) + 2 * (lane % 4) + t % 2 < Q) << t;
  }
  uint32_t n = 0;
  for (long seg = sb; seg < se; ++seg) {
    const long r0 = segment_row(map, seg);
    bool live[4];
    if (!ws::segment_live(mask, r0, cap, lane, live)) continue;
    Sc acc[ACC];
    if constexpr (T::INT) {
      // one int32 sum a (row, query) over the whole width, then the score
      int sum[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) sum[i] = 0;
      for (int kk = 0; kk < k_iters; ++kk) {
        issue_s8<T, N, S, BUF, PIECE>(sum, n + kk, sm, g, kk == 0);
        if (kk > 0) release<S, 1>(n + kk - 1, empty, lane);
      }
      release<S, 0>(n + k_iters - 1, empty, lane);
      ws::fence_acc(sum);
      if constexpr (T::SCALED) {
        float sc[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long r = r0 + m0 + 8 * h;
          sc[h] = r < cap ? vscale[r] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < ACC; ++i)
          acc[i] = __fmul_rn(__int2float_rn(sum[i]), sc[(i / 2) % 2]);
      } else {
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] = sum[i];
      }
    } else {
      // a one-stage lag: stage m + 1 is issued before stage m is retired,
      // its sum alternating between p0 and p1
      float p0[ACC], p1[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
      issue<T, N, S, BUF, PIECE>(p0, n, sm, g);
      int kk = 1;
      for (; kk + 1 < k_iters; kk += 2) {
        issue<T, N, S, BUF, PIECE>(p1, n + kk, sm, g);
        retire<S, 1>(p0, acc, n + kk - 1, empty, lane);
        issue<T, N, S, BUF, PIECE>(p0, n + kk + 1, sm, g);
        retire<S, 1>(p1, acc, n + kk, empty, lane);
      }
      if (kk < k_iters) {  // an even count: the last stage in p1
        issue<T, N, S, BUF, PIECE>(p1, n + kk, sm, g);
        retire<S, 1>(p0, acc, n + kk - 1, empty, lane);
        retire<S, 0>(p1, acc, n + kk, empty, lane);
      } else {
        retire<S, 0>(p0, acc, n + kk - 1, empty, lane);
      }
    }
    n += k_iters;

    if constexpr (BUF == 0) {  // the wide kinds' slab: every key, no select
      uint32_t* slab = reinterpret_cast<uint32_t*>(partial);
      const long ld = map.hot ? (long)map.grid_b * map.bn
                              : (cap + ROWS - 1) / ROWS * ROWS;
      const long l0 = map.hot ? seg * ROWS : r0;  // the segment's slab row
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long r = r0 + m0 + 8 * h;
        if (r < cap)
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if ((qlive >> (2 * j + e)) & 1u)
                slab[(long)(q0 + 8 * j + 2 * (lane % 4) + e) * ld + l0 + m0 +
                     8 * h] = slab_key(acc[4 * j + 2 * h + e]);
      }
    } else {
      // epilogue: admit, and compact + re-admit while an admission failed.
      // pend bit 4 j + 2 h + e: a live (row, query) not yet admitted or
      // dropped
      uint32_t pend = 0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long r = r0 + m0 + 8 * h;  // the thread's row h
        if (r < cap && mask[r])
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              pend |= ((qlive >> (2 * j + e)) & 1u) << (4 * j + 2 * h + e);
      }
      for (;;) {
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 4 * j + 2 * h + e;
              if (!((pend >> i) & 1u)) continue;
              bool keep = false;
              const Sc s = acc[i];
              if (s >= ts[2 * j + e]) {
                const int qq = 8 * j + 2 * (lane % 4) + e;
                const u64 key = sel_key(s, (uint32_t)(r0 + m0 + 8 * h));
                if (key > tau[qq]) {
                  const int slot = atomicAdd(&cnt[qq], 1);
                  if (slot < BUF) buf[qq * BUF + slot] = key;
                  else keep = true;
                }
              }
              if (!keep) pend &= ~(1u << i);
            }
        if (!ws::any_of(pend != 0, CONSUMER_BAR, CONSUMERS)) break;
        ws::compact<N, BUF, CONSUMER_BAR, CONSUMERS>(buf, cnt, tau, k, nq);
#pragma unroll
        for (int t = 0; t < N / 4; ++t)
          ts[t] = score_floor(tau[8 * (t / 2) + 2 * (lane % 4) + t % 2], Sc());
      }
    }
  }
  if constexpr (BUF > 0) {
    ws::named_sync(CONSUMER_BAR, CONSUMERS);
    ws::compact<N, BUF, CONSUMER_BAR, CONSUMERS>(buf, cnt, tau, k, nq);
    for (int i = threadIdx.x; i < N * k; i += CONSUMERS) {
      const int qq = i / k, j = i % k;
      if (q0 + qq < Q)
        partial[((long)(q0 + qq) * ranges + range) * k + j] = buf[qq * BUF + j];
    }
  }
}

// K3's int8 queries (Q, dim) as TMA reads them (ws::tma_rows).
inline cudaError_t tma_queries(const void** q, void* dst, int Q, int dim,
                               cudaStream_t s) {
  return ws::tma_rows(q, dst, Q, dim, 1, s);
}

using ws::plane_ld;
using ws::with_piece;

// Encodes the maps, sizes the grid (ops/scan.py::topk_wgmma_partition at
// a query tile of N, over ceil(cap / 128) segments, or over the hot
// table's grid_b * bn / 128 for `map`'s hot tiles: the live ones are
// shared on the device) and launches the scan with S stages, BUF keys a
// query and the rows' producer PIECE (0 TMA: rows of whole 16 bytes at a
// 16-byte aligned base; 8 / 4 cp.async: row bytes and base multiples of
// PIECE; 2 the realigning producer: any rows, flat or hot-tile);
// `*ranges` receives the grid's segment ranges. `planes` holds T::PLANES
// query planes of (Q, qld), `plane` bytes apart, qld >= dim elements a
// row of whole 16 bytes (zeros past dim).
template <class T, int N, int S, int BUF, int PIECE>
int launch_scan_rows(const void* planes, size_t plane, int qld, const void* v,
                     const void* mask, const float* vscale, void* partial,
                     int Q, long long cap, int dim, int k, const Rows& map,
                     int* ranges_out, cudaStream_t stream) {
  static_assert(PIECE == 0 || PIECE == 2 || PIECE == 4 || PIECE == 8,
                "the rows' producers");
  const long long row_bytes = (long long)dim * T::ELEM_BYTES;
  const int align = PIECE == 0 ? 16 : PIECE == 2 ? 1 : PIECE;
  if (qld < dim || (long long)qld * T::ELEM_BYTES % 16 || plane % 16 ||
      (uintptr_t)planes % 16 || row_bytes % align || (uintptr_t)v % align)
    return (int)cudaErrorInvalidValue;
  wg::EncodeTiled enc;
  int err = wg::encoder(&enc);
  if (err) return err;
  RowMapsOf<PIECE> tv{};
  CUtensorMap tq[3]{};
  if constexpr (PIECE == 0) {
    if (cap > 0 && (err = wg::encode_rows<T>(enc, &tv.v, v, cap, dim, ROWS)))
      return err;
  } else if constexpr (PIECE == 2) {
    if ((err = ws::row_classes<T>(enc, &tv, v, cap, dim))) return err;
  }
  for (int p = 0; p < 3; ++p) {
    if (p >= T::PLANES) {  // F32 reads two planes, the rest one
      tq[p] = tq[0];
      continue;
    }
    if ((err = wg::encode_rows<T>(
             enc, &tq[p], static_cast<const unsigned char*>(planes) + p * plane,
             Q, qld, N)))
      return err;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int q_tiles = (Q + N - 1) / N;
  const long long segs = std::max(
      1LL, map.hot ? (long long)map.grid_b * (map.bn / ROWS)
                   : (cap + ROWS - 1) / ROWS);
  const int ranges =
      (int)std::max(1LL, std::min(segs, (long long)(sms / q_tiles)));
  if ((long long)q_tiles * ranges > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const int k_iters = (int)((row_bytes + ROW_BYTES - 1) / ROW_BYTES);
  constexpr int smem = Smem<T, N, S, BUF, PIECE>::BYTES;
  e = cudaFuncSetAttribute(scan_topk_wgmma_kernel<T, N, S, BUF, PIECE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  u64* part = static_cast<u64*>(partial);
  scan_topk_wgmma_kernel<T, N, S, BUF, PIECE>
      <<<q_tiles * ranges, threads_of(PIECE), smem, stream>>>(
          tv, tq[0], tq[1], tq[2], static_cast<const unsigned char*>(v),
          static_cast<const uint8_t*>(mask), vscale, part, Q, (long)cap, dim,
          k, q_tiles, ranges, k_iters, map);
  *ranges_out = ranges;
  return (int)cudaGetLastError();
}

// launch_scan_rows with its planes (Q, qld) back to back, then the merge
// of the ranges' partials (Int8C's keys carry int32 scores).
template <class T, int N, int S, int BUF, int PIECE>
int launch_rows(const void* planes, int qld, const void* v, const void* mask,
                const float* vscale, void* partial, void* vals, void* idx,
                int Q, long long cap, int dim, int k, const Rows& map,
                cudaStream_t stream) {
  int ranges = 0;
  const int err = launch_scan_rows<T, N, S, BUF, PIECE>(
      planes, (size_t)Q * qld * T::ELEM_BYTES, qld, v, mask, vscale, partial,
      Q, cap, dim, k, map, &ranges, stream);
  if (err) return err;
  return (int)launch_topk_merge(static_cast<u64*>(partial),
                                static_cast<float*>(vals),
                                static_cast<int*>(idx), Q, ranges * k, k,
                                stream,
                                std::is_same<typename T::Score, int>::value);
}

}  // namespace tk
}  // namespace
}  // namespace pv
