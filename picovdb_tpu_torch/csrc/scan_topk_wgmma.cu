// K4 fused_topk and K3 fused_topk_i8 on Hopper's tensor cores: exact
// masked top-k over float32 or bfloat16 rows against float32 queries (K4),
// or over int8 rows times their float32 scales against int8 queries (K3),
// reading only the 128-row segments that hold a live row.
//
// Replaces picovdb_tpu/ops/pallas_scan.py:fused_topk (`_scan_kernel`)
// wherever TMA can read the rows and k <= 128 (ops/scan.py::
// topk_wgmma_ready), and pallas_scan.py:fused_topk_i8 (`_scan_kernel_i8`)
// at batches past the one-query sweep's limit wherever TMA can read both
// operands and k <= 384 (ops/scan.py::i8_wgmma_ready). K4 at 128 < k <=
// 1024 runs topk_wide.cu, whose pass A is this scan with a slab epilogue
// (BUF 0: every live segment's keys written, nothing selected here);
// scan_topk.cu's template keeps other widths. It computes pv_scan_topk's
// kinds 0, 1 and 2: per query the k
// best masked rows by the float32 score (q . v; for int8 rows
// float32(int32 q . v) * vscale[row], one conversion and one multiply), as
// (Q, k) float32 scores (-inf where a slot is empty) and (Q, k) int32 rows
// (0 where empty), ties to the lower row.
//
// What bounds it on the H100: float32 rows run three TF32 products (2 Q
// cap dim operations each at 495 T/s: 6.4 ms at Q = 256 over 2M x 1024
// rows, above their 8 GB at 3.35 TB/s, 2.4 ms); bf16 rows at the route's
// Q = 64 are bound by their bytes (1M x 1024: 0.61 ms; three bf16 products
// 0.40 ms), and under a sparse filter by the bytes of the segments that
// hold a live row. int8 rows at the host-rescore route's Q = 64 are bound
// by their bytes (1M x 1024: 0.307 ms; the s8 product 0.07 ms). The
// templates it replaces scored with CUDA-core FMAs through unpipelined
// shared-memory tiles, re-read the corpus once per query tile (16 queries,
// 2 at k > 128) and read every row whatever the mask.
//
// Design:
//  * Rows as M, queries as N (64; 32 for the int8 kind at k > 128). A
//    128-row segment is two m64 tiles, one per consumer warpgroup; both
//    operands are K-major as they lie and arrive by TMA in 128-byte
//    k-stages, 128B-swizzled (32 float32, 64 bf16 or 128 int8 elements).
//    One producer warp's lane 0 keeps a ring of S stages filled (the
//    segment's rows, the query tile's planes) behind full / empty
//    mbarriers.
//  * Float32 rows run 3xTF32 as K8 does (hi.hi + hi.lo + lo.hi): the
//    launcher splits the queries once into hi and lo planes, each consumer
//    warpgroup splits its m64 tile of a stage in shared memory
//    (wgmma_scan.cuh). bf16 rows keep the float32 query: the launcher
//    splits it into three bf16 planes q1 = bf16(q), q2 = bf16(q - q1),
//    q3 = bf16(q - q1 - q2), which rebuild it exactly, and each plane's
//    product with a bf16 row is exact in float32 (a bf16 query alone
//    would move scores by ~1e-3). Either way a k-stage runs 12 wgmmas
//    (m64n64, three products of four steps) into an accumulator of its
//    own, folded into the row's sum by one round-to-nearest add a
//    register: the tensor cores' float32 sum rounds toward zero at every
//    wgmma (as K8 found), so one accumulator over a 1024-wide row (384 /
//    192 wgmmas) would drift past the 1e-5 score limit. A one-stage lag:
//    a warpgroup issues stage m + 1 (for float32 rows, split into the
//    second of its two lo buffers) before it waits for stage m's wgmmas,
//    the two stages' sums in two register arrays.
//  * int8 rows (K3, `Int8R`): one query plane, four s8 wgmmas a k-stage
//    into one int32 accumulator over the whole width (the integer sum is
//    exact, so nothing is folded per stage); after the segment's last
//    stage each sum is converted to float32 (round to nearest) and
//    multiplied by its row's scale, each thread loading its two rows'
//    scales once a segment, as K5's SegmaxTileEpi<int, true> does: bit for
//    bit the plain version's scores.
//  * Only live segments. Producer and consumers read a segment's 128 mask
//    bytes (one warp ballot, rows past cap dead) and skip a segment with
//    no live row alike: no copy, no product.
//  * The selection, as K6's tensor-core scan keeps it: CTA c owns query
//    tile c % q_tiles and walks the contiguous segment range c / q_tiles
//    of `ranges` (ops/scan.py::topk_wgmma_partition), so the q_tiles CTAs
//    of one range read each segment from device memory about once. After a
//    segment's last stage each thread holds 2 rows x N / 4 queries in
//    registers; a live row (by its mask byte: never by its score or its
//    scale's sign) of a live query whose score reaches the query's running
//    k-th best score (`ts`, kept in registers) builds row_key(s, row) and,
//    if it beats the query's tau, takes an atomic slot of that query's
//    shared buffer of BUF keys. An admission that finds the buffer full
//    keeps its key in a pending bit; the consumers then compact every
//    buffer to its best k (behind a named barrier the producer never
//    joins) and re-admit the pending keys against the raised tau, in the
//    same epilogue. Each CTA writes its k best keys per query as a
//    partial; launch_topk_merge merges the ranges' partials.
//  * Ring and buffers within a CTA's 227 KB. A float32 stage is 16 KB of
//    rows and two 8 KB query planes, beside four 8 KB lo buffers (two a
//    warpgroup); a bf16 stage 16 KB of rows and three planes (40 KB); an
//    int8 stage 16 KB of rows and one plane of N x 128 bytes (24 KB at N
//    = 64, 20 KB at N = 32). The buffers take N x BUF x 8 bytes. K4: k <=
//    32 three stages and BUF 64 (f32 162 KB, bf16 154 KB), k <= 64 three
//    stages and BUF 128 (194 / 186 KB), k <= 128 two stages and BUF 256
//    (226 / 210 KB). K3: k <= 32 four stages and BUF 64 (130 KB), k <= 64
//    four and BUF 128 (162 KB), k <= 128 three and BUF 256 (202 KB), k <=
//    384 N = 32, four stages and BUF 512 (209 KB; BUF 512 at N = 64 would
//    take 256 KB of buffers alone). One CTA an SM.

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
constexpr int THREADS = CONSUMERS + 32;        // and one producer warp
constexpr int CONSUMER_BAR = 1;  // named barriers: 1 the consumers, 2 + g
                                 // warpgroup g's split

// Row kinds: BK elements a k-stage, the TMA type, the query planes.
struct F32 {  // 3xTF32: query planes hi, lo
  static constexpr int BK = 32, ELEM_BYTES = 4, PLANES = 2;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
struct Bf16 {  // three bf16 planes of the float32 query
  static constexpr int BK = 64, ELEM_BYTES = 2, PLANES = 3;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
// int8 rows times their scale against the int8 queries (K3): exact int32
// sums. TMA has no signed 8-bit type; the bytes copy as they are and the
// out-of-bounds fill is int8 0.
struct Int8R {
  static constexpr int BK = 128, ELEM_BYTES = 1, PLANES = 1;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// Shared memory of kind T with N queries a CTA, S stages and BUF keys a
// query: the ring (rows, then the query planes), F32's lo buffers (two a
// warpgroup), the barriers, then the selection (tau, the buffers, their
// counts); 1 KB to align the ring (swizzle atoms are 1024 B).
template <class T, int N, int S, int BUF>
struct Smem {
  static constexpr int PLANE_BYTES = N * ROW_BYTES;  // a query plane
  static constexpr int B_BYTES = T::PLANES * PLANE_BYTES;
  static constexpr int A_OFF = 0;
  static constexpr int B_OFF = S * A_BYTES;
  static constexpr int LO_OFF = B_OFF + S * B_BYTES;
  static constexpr int BAR_OFF = LO_OFF + (T::PLANES == 2 ? 4 * HALF_BYTES : 0);
  static constexpr int TAU_OFF = BAR_OFF + 2 * S * 8;
  static constexpr int BUF_OFF = TAU_OFF + N * 8;
  static constexpr int CNT_OFF = BUF_OFF + N * BUF * 8;
  static constexpr int BYTES = 1024 + CNT_OFF + N * 4;
  static constexpr uint32_t TX = A_BYTES + B_BYTES;  // a stage's TMA bytes
  static_assert(BYTES <= 232448, "shared memory of one CTA");
};

// Consumer warpgroup g's k-stage n (of the CTA's run), float kinds: wait
// for its slot, (F32) split the warpgroup's rows into lo buffer n % 2 of
// its two, and issue the stage's 12 wgmmas into `part` as one commit
// group. The other lo buffer and the previous slot are still read by stage
// n - 1's wgmmas.
template <class T, int N, int S, int BUF>
__device__ __forceinline__ void issue(float (&part)[N / 2], uint32_t n,
                                      unsigned char* sm, int g) {
  typedef Smem<T, N, S, BUF> L;
  const int st = (int)(n % S);
  const uint32_t base = smem_u32(sm);
  mbar_wait(base + L::BAR_OFF + 8 * st, (n / S) & 1);
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
    const uint64_t d1 = sw128_desc(bq + L::PLANE_BYTES) + 2 * s4;
    if constexpr (T::PLANES == 2) {  // hi.hi + hi.lo + lo.hi
      ws::mma_tf32(part, da, d0, s4 != 0);
      ws::mma_tf32(part, da, d1, 1);
      ws::mma_tf32(part, sw128_desc(base + lo_off) + 2 * s4, d0, 1);
    } else {  // v.q1 + v.q2 + v.q3
      ws::mma_bf16(part, da, d0, s4 != 0);
      ws::mma_bf16(part, da, d1, 1);
      ws::mma_bf16(part, da, sw128_desc(bq + 2 * L::PLANE_BYTES) + 2 * s4, 1);
    }
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Consumer warpgroup g's k-stage n, Int8R: wait for its slot and issue
// the stage's four s8 wgmmas into the segment's int32 sum (`first`: the
// segment's first stage overwrites it) as one commit group.
template <int N, int S, int BUF>
__device__ __forceinline__ void issue_s8(int (&sum)[N / 2], uint32_t n,
                                         unsigned char* sm, int g,
                                         bool first) {
  typedef Smem<Int8R, N, S, BUF> L;
  const int st = (int)(n % S);
  const uint32_t base = smem_u32(sm);
  mbar_wait(base + L::BAR_OFF + 8 * st, (n / S) & 1);
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

// tv: TMA map of the rows (cap, dim), boxes of 128 bytes x 128 rows; tq0
// .. tq2: of the query planes (Q, dim), boxes of 128 bytes x N rows (F32
// reads two, Int8R one); all 128B-swizzled. mask (cap,) uint8; vscale
// (cap,) float32, Int8R's row scales. `partial` receives, per query of
// this CTA's tile, k keys at ((q * ranges + range) * k). BUF == 0 (the
// wide kind's pass A, topk_wide.cu) keeps no selection: `partial` is then
// the slab, (Q, ld) uint32 with ld = cap rounded up to whole segments,
// and every row below cap of a live segment gets its sortable score key
// float_order(s) at (q * ld + row), whatever its mask byte (the readers
// of the slab read the mask); rows of dead segments are not written.
template <class T, int N, int S, int BUF>
__global__ void __launch_bounds__(THREADS, 1)
scan_topk_wgmma_kernel(const __grid_constant__ CUtensorMap tv,
                       const __grid_constant__ CUtensorMap tq0,
                       const __grid_constant__ CUtensorMap tq1,
                       const __grid_constant__ CUtensorMap tq2,
                       const uint8_t* __restrict__ mask,
                       const float* __restrict__ vscale,
                       u64* __restrict__ partial, int Q, long cap, int k,
                       int q_tiles, int ranges, int k_iters) {
  typedef Smem<T, N, S, BUF> L;
  constexpr int ACC = N / 2;  // accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  const uint32_t a_ring = base + L::A_OFF, b_ring = base + L::B_OFF;
  const uint32_t full = base + L::BAR_OFF, empty = full + 8 * S;
  u64* tau = reinterpret_cast<u64*>(sm + L::TAU_OFF);
  u64* buf = reinterpret_cast<u64*>(sm + L::BUF_OFF);
  int* cnt = reinterpret_cast<int*>(sm + L::CNT_OFF);
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + 8 * s, 1);  // the producer's expect_tx arrival
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (threadIdx.x < N) {
    cnt[threadIdx.x] = 0;
    tau[threadIdx.x] = 0ull;
  }
  __syncthreads();

  const int q0 = (blockIdx.x % q_tiles) * N, range = blockIdx.x / q_tiles;
  const long segs = (cap + ROWS - 1) / ROWS;  // none when cap == 0
  const long sb = range * segs / ranges, se = (range + 1) * segs / ranges;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x >= CONSUMERS) {  // the producer warp
    uint32_t n = 0;
    for (long seg = sb; seg < se; ++seg) {
      const long r0 = seg * ROWS;
      bool live[4];
      if (!ws::segment_live(mask, r0, cap, lane, live)) continue;
      if (lane == 0)
        for (int kk = 0; kk < k_iters; ++kk, ++n) {
          const int st = (int)(n % S);
          mbar_wait(empty + 8 * st, ((n / S) & 1) ^ 1);  // first lap: free
          mbar_expect_tx(full + 8 * st, L::TX);
          const uint32_t b = b_ring + st * L::B_BYTES;
          tma_load_2d(a_ring + st * A_BYTES, &tv, full + 8 * st, kk * T::BK,
                      (int)r0);
          tma_load_2d(b, &tq0, full + 8 * st, kk * T::BK, q0);
          if constexpr (T::PLANES >= 2)
            tma_load_2d(b + L::PLANE_BYTES, &tq1, full + 8 * st, kk * T::BK,
                        q0);
          if constexpr (T::PLANES == 3)
            tma_load_2d(b + 2 * L::PLANE_BYTES, &tq2, full + 8 * st,
                        kk * T::BK, q0);
        }
      __syncwarp();
    }
    return;
  }

  // consumers: warpgroup g multiplies rows 64 g .. 64 g + 63 of the
  // segment by the query tile. Lane l of warp w holds rows 64 g + 16 w +
  // l / 4 (+ 8 h) at queries 8 j + 2 (l % 4) + e, in acc[4 j + 2 h + e];
  // ts[2 j + e] is that query's running k-th best score (a key scored
  // below it cannot beat tau).
  const int g = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
  const int m0 = 64 * g + 16 * w + lane / 4;  // the thread's first row
  float ts[N / 4];
  uint32_t qlive = 0;  // bit 2 j + e: query 8 j + 2 (l % 4) + e < Q
#pragma unroll
  for (int t = 0; t < N / 4; ++t) {
    ts[t] = -__int_as_float(0x7f800000);
    qlive |= (uint32_t)(q0 + 8 * (t / 2) + 2 * (lane % 4) + t % 2 < Q) << t;
  }
  uint32_t n = 0;
  for (long seg = sb; seg < se; ++seg) {
    const long r0 = seg * ROWS;
    bool live[4];
    if (!ws::segment_live(mask, r0, cap, lane, live)) continue;
    float acc[ACC];
    if constexpr (T::PLANES == 1) {
      // one int32 sum a (row, query) over the whole width, then the score
      int sum[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) sum[i] = 0;
      for (int kk = 0; kk < k_iters; ++kk) {
        issue_s8<N, S, BUF>(sum, n + kk, sm, g, kk == 0);
        if (kk > 0) release<S, 1>(n + kk - 1, empty, lane);
      }
      release<S, 0>(n + k_iters - 1, empty, lane);
      ws::fence_acc(sum);
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
      // a one-stage lag: stage m + 1 is issued before stage m is retired,
      // its sum alternating between p0 and p1
      float p0[ACC], p1[ACC];
#pragma unroll
      for (int i = 0; i < ACC; ++i) acc[i] = 0.0f;
      issue<T, N, S, BUF>(p0, n, sm, g);
      int kk = 1;
      for (; kk + 1 < k_iters; kk += 2) {
        issue<T, N, S, BUF>(p1, n + kk, sm, g);
        retire<S, 1>(p0, acc, n + kk - 1, empty, lane);
        issue<T, N, S, BUF>(p0, n + kk + 1, sm, g);
        retire<S, 1>(p1, acc, n + kk, empty, lane);
      }
      if (kk < k_iters) {  // an even count: the last stage in p1
        issue<T, N, S, BUF>(p1, n + kk, sm, g);
        retire<S, 1>(p0, acc, n + kk - 1, empty, lane);
        retire<S, 0>(p1, acc, n + kk, empty, lane);
      } else {
        retire<S, 0>(p0, acc, n + kk - 1, empty, lane);
      }
    }
    n += k_iters;

    if constexpr (BUF == 0) {  // the wide kind's slab: every key, no select
      uint32_t* slab = reinterpret_cast<uint32_t*>(partial);
      const long ld = segs * ROWS;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long r = r0 + m0 + 8 * h;
        if (r < cap)
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if ((qlive >> (2 * j + e)) & 1u)
                slab[(long)(q0 + 8 * j + 2 * (lane % 4) + e) * ld + r] =
                    float_order(acc[4 * j + 2 * h + e]);
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
              const float s = acc[i];
              if (s >= ts[2 * j + e]) {
                const int qq = 8 * j + 2 * (lane % 4) + e;
                const u64 key = row_key(s, (uint32_t)(r0 + m0 + 8 * h));
                if (key > tau[qq]) {
                  const int slot = atomicAdd(&cnt[qq], 1);
                  if (slot < BUF) buf[qq * BUF + slot] = key;
                  else keep = true;
                }
              }
              if (!keep) pend &= ~(1u << i);
            }
        if (!ws::any_of(pend != 0, CONSUMER_BAR, CONSUMERS)) break;
        ws::compact<N, BUF, CONSUMER_BAR, CONSUMERS>(buf, cnt, tau, k);
#pragma unroll
        for (int t = 0; t < N / 4; ++t)
          ts[t] = row_key_score(tau[8 * (t / 2) + 2 * (lane % 4) + t % 2]);
      }
    }
  }
  if constexpr (BUF > 0) {
    ws::named_sync(CONSUMER_BAR, CONSUMERS);
    ws::compact<N, BUF, CONSUMER_BAR, CONSUMERS>(buf, cnt, tau, k);
    for (int i = threadIdx.x; i < N * k; i += CONSUMERS) {
      const int qq = i / k, j = i % k;
      if (q0 + qq < Q)
        partial[((long)(q0 + qq) * ranges + range) * k + j] = buf[qq * BUF + j];
    }
  }
}

// Encodes the maps, sizes the grid (ops/scan.py::topk_wgmma_partition at
// a query tile of N) and launches the scan with S stages and BUF keys a
// query; `*ranges` receives the grid's segment ranges. `planes` holds
// T::PLANES query planes of (Q, dim), `plane` bytes apart.
template <class T, int N, int S, int BUF>
int launch_scan(const void* planes, size_t plane, const void* v,
                const void* mask, const float* vscale, void* partial, int Q,
                long long cap, int dim, int k, int* ranges_out,
                cudaStream_t stream) {
  if ((long long)dim * T::ELEM_BYTES % 16 || plane % 16 ||
      ((uintptr_t)planes | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
  wg::EncodeTiled enc;
  int err = wg::encoder(&enc);
  if (err) return err;
  CUtensorMap tv{}, tq[3]{};
  if (cap > 0 && (err = wg::encode_rows<T>(enc, &tv, v, cap, dim, ROWS)))
    return err;
  for (int p = 0; p < 3; ++p) {
    const int pp = p < T::PLANES ? p : 0;  // F32 reads two, Int8R one
    if ((err = wg::encode_rows<T>(
             enc, &tq[p], static_cast<const unsigned char*>(planes) + pp * plane,
             Q, dim, N)))
      return err;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int q_tiles = (Q + N - 1) / N;
  const long long segs = std::max(1LL, (cap + ROWS - 1) / ROWS);
  const int ranges =
      (int)std::max(1LL, std::min(segs, (long long)(sms / q_tiles)));
  if ((long long)q_tiles * ranges > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const int k_iters = (dim * T::ELEM_BYTES + ROW_BYTES - 1) / ROW_BYTES;
  constexpr int smem = Smem<T, N, S, BUF>::BYTES;
  e = cudaFuncSetAttribute(scan_topk_wgmma_kernel<T, N, S, BUF>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  u64* part = static_cast<u64*>(partial);
  scan_topk_wgmma_kernel<T, N, S, BUF>
      <<<q_tiles * ranges, THREADS, smem, stream>>>(
          tv, tq[0], tq[1], tq[2], static_cast<const uint8_t*>(mask), vscale,
          part, Q, (long)cap, k, q_tiles, ranges, k_iters);
  *ranges_out = ranges;
  return (int)cudaGetLastError();
}

// launch_scan with its planes back to back, then the merge of the
// ranges' partials.
template <class T, int N, int S, int BUF>
int launch(const void* planes, const void* v, const void* mask,
           const float* vscale, void* partial, void* vals, void* idx, int Q,
           long long cap, int dim, int k, cudaStream_t stream) {
  int ranges = 0;
  const int err = launch_scan<T, N, S, BUF>(
      planes, (size_t)Q * dim * T::ELEM_BYTES, v, mask, vscale, partial, Q,
      cap, dim, k, &ranges, stream);
  if (err) return err;
  return (int)launch_topk_merge(static_cast<u64*>(partial),
                                static_cast<float*>(vals),
                                static_cast<int*>(idx), Q, ranges * k, k,
                                stream, false);
}

}  // namespace tk
}  // namespace

// The wide kind's pass A (topk_wide.cu): the scan with the slab epilogue
// (BUF 0) and four stages, N = 32 queries a CTA at Q <= 32 (half the
// operand reads and products of N = 64, whose tile would be at least half
// empty), else 64. kind 0: float32 rows, planes hi and lo; 1: bf16 rows,
// three bf16 planes; `plane` bytes apart.
int launch_scan_slab(int kind, const void* planes, size_t plane,
                     const void* v, const void* mask, uint32_t* slab, int Q,
                     long long cap, int dim, cudaStream_t stream) {
  using namespace tk;
  int ranges = 0;
  if (kind == 0)
    return Q <= 32 ? launch_scan<F32, 32, 4, 0>(planes, plane, v, mask,
                                                nullptr, slab, Q, cap, dim, 0,
                                                &ranges, stream)
                   : launch_scan<F32, 64, 4, 0>(planes, plane, v, mask,
                                                nullptr, slab, Q, cap, dim, 0,
                                                &ranges, stream);
  if (kind == 1)
    return Q <= 32 ? launch_scan<Bf16, 32, 4, 0>(planes, plane, v, mask,
                                                 nullptr, slab, Q, cap, dim, 0,
                                                 &ranges, stream)
                   : launch_scan<Bf16, 64, 4, 0>(planes, plane, v, mask,
                                                 nullptr, slab, Q, cap, dim, 0,
                                                 &ranges, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace pv

// K4 on the tensor cores: pv_scan_topk's kinds 0 and 1 for k <= 128, rows
// of whole 16 bytes (float32 dim % 4, bf16 dim % 8) and 16-byte aligned
// bases. kind 0: v (cap, dim) float32 and `planes` (2, Q, dim) float32,
// the queries' hi and lo (ops/scan.py::split_tf32); 1: v bfloat16 and
// `planes` (3, Q, dim) bfloat16, the queries' three bf16 planes
// (ops/scan.py::split_bf16). mask (cap,) uint8. The grid is q_tiles =
// ceil(Q / 64) query tiles x `ranges` = max(1, min(ceil(cap / 128), SMs /
// q_tiles)) segment ranges (ops/scan.py::topk_wgmma_partition); `partial`
// is scratch of Q * ranges * k uint64; vals (Q, k) float32 and idx (Q, k)
// int32 receive the result (-inf / 0 where empty). Launches on the current
// device. Returns 0, a cudaError_t, or minus the CUresult of a refused
// tensor-map encode.
extern "C" int pv_scan_topk_wgmma(int kind, const void* planes, const void* v,
                                  const void* mask, void* partial, void* vals,
                                  void* idx, int Q, long long cap, int dim,
                                  int k, void* stream) {
  using namespace pv::tk;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (k > 128 || cap < 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    return k <= 32   ? launch<F32, 64, 3, 64>(planes, v, mask, nullptr, partial,
                                              vals, idx, Q, cap, dim, k, s)
           : k <= 64 ? launch<F32, 64, 3, 128>(planes, v, mask, nullptr,
                                               partial, vals, idx, Q, cap, dim,
                                               k, s)
                     : launch<F32, 64, 2, 256>(planes, v, mask, nullptr,
                                               partial, vals, idx, Q, cap, dim,
                                               k, s);
  if (kind == 1)
    return k <= 32   ? launch<Bf16, 64, 3, 64>(planes, v, mask, nullptr,
                                               partial, vals, idx, Q, cap, dim,
                                               k, s)
           : k <= 64 ? launch<Bf16, 64, 3, 128>(planes, v, mask, nullptr,
                                                partial, vals, idx, Q, cap,
                                                dim, k, s)
                     : launch<Bf16, 64, 2, 256>(planes, v, mask, nullptr,
                                                partial, vals, idx, Q, cap,
                                                dim, k, s);
  return (int)cudaErrorInvalidValue;
}

// K3 on the tensor cores: pv_scan_topk's kind 2 for k <= 384, rows of
// whole 16 bytes (dim % 16) and 16-byte aligned bases. q (Q, dim) int8, v
// (cap, dim) int8, vscale (cap,) float32, mask (cap,) uint8. The grid is
// q_tiles = ceil(Q / N) query tiles (N = 64 for k <= 128, else 32) x
// `ranges` = max(1, min(ceil(cap / 128), SMs / q_tiles)) segment ranges
// (ops/scan.py::i8_wgmma_partition); `partial` is scratch of Q * ranges *
// k uint64; vals (Q, k) float32 and idx (Q, k) int32 receive the result
// (-inf / 0 where empty). Launches on the current device. Returns 0, a
// cudaError_t, or minus the CUresult of a refused tensor-map encode.
extern "C" int pv_scan_topk_i8_wgmma(const void* q, const void* v,
                                     const void* vscale, const void* mask,
                                     void* partial, void* vals, void* idx,
                                     int Q, long long cap, int dim, int k,
                                     void* stream) {
  using namespace pv::tk;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (k > 384 || cap < 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* vs = static_cast<const float*>(vscale);
  return k <= 32    ? launch<Int8R, 64, 4, 64>(q, v, mask, vs, partial, vals,
                                               idx, Q, cap, dim, k, s)
         : k <= 64  ? launch<Int8R, 64, 4, 128>(q, v, mask, vs, partial, vals,
                                                idx, Q, cap, dim, k, s)
         : k <= 128 ? launch<Int8R, 64, 3, 256>(q, v, mask, vs, partial, vals,
                                                idx, Q, cap, dim, k, s)
                    : launch<Int8R, 32, 4, 512>(q, v, mask, vs, partial, vals,
                                                idx, Q, cap, dim, k, s);
}