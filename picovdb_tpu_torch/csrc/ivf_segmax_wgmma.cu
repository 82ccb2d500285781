// K8 ivf_segmax_scan on Hopper's tensor cores: per 128-row segment of each
// live hot tile, the top `per_seg` packed keys, reading only the segments
// that hold a live row.
//
// Replaces picovdb_tpu/ops/ivf.py:probe_scan_segmax (`_ivf_segmax_kernel`,
// `_ivf_segmax_kernel_i8c`) at every postings width and base
// (ops/ivf.py::ivf_segmax_ready): rows TMA reads by TMA, the others by the
// rows' producers K4's scan uses (wgmma_scan.cuh `produce_rows`: cp.async
// in 8- or 4-byte pieces, or the realigning producer), where segmax.cu's
// `ivf_segmax_kernel`, the first kernel, served them before. It
// computes pv_ivf_segmax's function and slab: (Q, grid_b * per_seg * ns)
// int32 keys, column b * per_seg * ns + r * ns + s for the r-th best of
// segment s of hot tile hot[b]; a key is the score's order-preserving
// int32 (float32: sortable bits; int8 postings: the raw int32 sum) with its
// low 7 bits replaced by the row's lane; masked rows, exhausted ranks and
// dead steps (b >= *n_hot, read on the device) carry KEY_MIN.
//
// What bounds it on the H100: the bytes of the segments it must read. At
// the route's 32-query chunks a float32 segment is 512 KB for 2 x 32 x 128
// x 1024 operations, far below the tensor cores' rate, so the kernel reads
// each live segment once at HBM rate and skips the rest. The kernel it
// replaces scored float32 rows with CUDA-core FMAs through unpipelined
// shared-memory tiles, launched a block for every step of the padded hot
// table (dead or not), and read every row of a segment the probe's mask
// had emptied.
//
// Design:
//  * Rows as M, queries as N. A segment is two m64 tiles, one per consumer
//    warpgroup; the query tile is N = 32 (Q <= 32, the route's chunks) or
//    64 (more queries take further query tiles), so no wgmma is wasted on
//    absent corpus rows. Both operands are K-major as they lie (rows and
//    queries contiguous in dim) and arrive by TMA in 128-byte k-stages,
//    128B-swizzled (32 float32, 64 bf16 or 128 int8 elements).
//  * Float32 postings run 3xTF32: x = hi + lo with hi = x with its low 13
//    mantissa bits cleared (exact in TF32) and lo = x - hi (exact in
//    float32); the product is hi.hi + hi.lo + lo.hi in the float32
//    accumulator (lo.lo, below 2^-20 of sum |q v| <= 1, is dropped). The
//    launcher splits the queries once (two planes, two TMA boxes a stage);
//    each consumer warpgroup splits its m64 tile of a stage in shared
//    memory, element by element at the same swizzled offsets (hi in
//    place, lo into its own buffer, once its four warps have waited for
//    the last stage's wgmmas), fences the writes for the async proxy and
//    syncs its four warps before the wgmmas. TF32 alone (hi.hi) misses
//    the 1e-5 key limit on clustered unit vectors. The tensor cores' float32
//    sum rounds toward zero at each wgmma: over the 384 wgmmas of a
//    1024-wide row it moved scores near 1 by 384 ulps (2.3e-5) on phase 7's
//    clustered store. So each k-stage's 12 wgmmas sum into an accumulator
//    of their own (scale_d = 0 at its first), which one round-to-nearest
//    add per register folds into the row's sum: 32 truncating steps on
//    partial sums of 1/32 the size, and 32 rounded adds. bf16 postings
//    run bf16 wgmma (64 wgmmas a 1024-wide row, one accumulator),
//    column-scaled int8 postings s8 wgmma with exact int32 sums.
//  * Only live segments. A persistent grid (as many CTAs as fit, at most
//    two an SM) shares the items (query tile, segment) of the live steps
//    min(*n_hot, grid_b) x ns x q_tiles, query tiles fastest so the CTAs
//    that read one segment run together and share it in L2, and then the
//    dead steps' segments, each CTA computing its shares from n_hot on the
//    device (`share`). A segment whose 128 mask
//    bytes are all zero issues no copy: producer and consumers both read
//    the mask (one warp ballot) and skip it alike, and the consumers write
//    its KEY_MIN columns, as those of dead steps. No second launch.
//  * A CTA holds two consumer warpgroups and one producer warp, whose lane
//    0 keeps a ring of three stages filled (the segment's 128 rows, the
//    query tile's planes) behind full / empty mbarriers. Over rows TMA
//    cannot read (`PIECE`, ops/scan.py::rows_piece) a producer warpgroup
//    takes its place: 384 threads, which give registers back by setmaxnreg
//    (40 a producer thread for cp.async, the consumers taking 96; the
//    realigning producer's shifts keep 72, its consumers the launch's 80),
//    still up to two CTAs an SM. The query planes come padded to whole 16
//    bytes (zeros past dim) and still arrive by TMA. The realigning
//    producer's two 18 KB staging slots leave room for two CTAs an SM only
//    at two stages (N = 32: 96 KB a CTA; three stages take 116 KB), so its
//    ring is two stages deep (`REALIGN_STAGES`).
//  * Epilogue: after a segment's last k-stage each consumer writes its
//    accumulators as packed keys into a (N, 132) int32 tile in shared
//    memory (conflict-free), then a warp per query runs `per_seg` warp-wide
//    max passes over the segment's 128 keys (a lane holds 4; masked lanes
//    KEY_MIN) and writes the slab, as segment.cu's segment_topn does.
//  * The wgmma wrappers, the row split and the mask read are
//    wgmma_scan.cuh's, shared with K4's tensor-core scan.

#include <atomic>

#include "wgmma_scan.cuh"

namespace pv {
namespace {
namespace sg {

using wg::mbar_arrive;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::smem_u32;
using wg::sw128_desc;
using wg::tma_load_2d;
using ws::fence_acc;
using ws::FULL;
using ws::mma_bf16;
using ws::mma_s8;
using ws::mma_tf32;
using ws::named_sync;
using ws::segment_live;

constexpr int ROWS = SEG;                     // a segment: two m64 tiles
constexpr int ROW_BYTES = 128;                // bytes of a row per k-stage
constexpr int A_BYTES = ROWS * ROW_BYTES;     // 16 KB
constexpr int HALF_BYTES = A_BYTES / 2;       // a warpgroup's m64 tile
constexpr int STAGES = 3;                     // the ring, but PIECE 2's:
// two stages, two CTAs an SM, beat three stages, one CTA: 0.1790 / 0.1867
// ms against 0.2165 / 0.2268 over 1,183,514 bf16 / int8 rows of dim 25,
// 32-query chunks, depth 8 (chip_smoke.py phase 7c, H100 80GB HBM3, 700 W)
constexpr int REALIGN_STAGES = 2;
constexpr int CONSUMERS = 256;                // warpgroups 0 and 1
constexpr int CONSUMER_WARPS = 8;
constexpr int LDS = ROWS + 4;                 // score tile row, in ints
// registers a thread at launch with the producer warpgroup (384 threads,
// two CTAs an SM: 65,536 / 768 rounded down to 8)
constexpr int LAUNCH_REGS = 80;

// Threads with the rows' producer PIECE: one producer warp for TMA, a
// warpgroup for the others.
__host__ __device__ constexpr int threads_of(int piece) {
  return CONSUMERS + (piece ? ws::PRODUCERS : 32);
}

// Element kinds: BK elements a k-stage, the TMA type, and the query planes
// (float32: hi and lo).
struct F32 {
  typedef float Acc;
  static constexpr int BK = 32, ELEM_BYTES = 4, PLANES = 2;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
struct Bf16 {
  typedef float Acc;
  static constexpr int BK = 64, ELEM_BYTES = 2, PLANES = 1;
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
struct Int8 {
  typedef int Acc;
  static constexpr int BK = 128, ELEM_BYTES = 1, PLANES = 1;
  // bytes copy as they are; the out-of-bounds zero fill is int8 0
  static constexpr CUtensorMapDataType TMA_TYPE = CU_TENSOR_MAP_DATA_TYPE_UINT8;
};

// Shared memory of kind T at query tile N, S stages and the rows'
// producer PIECE: the ring (A, then the planes of B), the realigning
// producer's staging slots, F32's two lo buffers, the score tile, the
// barriers (full, empty, then the slots'); 1 KB to align the ring (swizzle
// atoms are 1024 B).
template <class T, int N, int S, int PIECE>
struct Smem {
  static constexpr int B_BYTES = T::PLANES * N * ROW_BYTES;
  static constexpr int A_OFF = 0;
  static constexpr int B_OFF = S * A_BYTES;
  static constexpr int SLOT_OFF = B_OFF + S * B_BYTES;
  static constexpr int LO_OFF =
      SLOT_OFF + (PIECE == 2 ? ws::RSLOTS * ws::RSLOT : 0);
  static constexpr int S_OFF = LO_OFF + (T::PLANES == 2 ? 2 * HALF_BYTES : 0);
  static constexpr int BAR_OFF = S_OFF + N * LDS * 4;
  static constexpr int BYTES =
      1024 + BAR_OFF + 8 * (2 * S + (PIECE == 2 ? ws::RSLOTS : 0));
  // a stage's TMA bytes: the rows and the planes, or the planes alone
  static constexpr uint32_t TX = (PIECE ? 0 : A_BYTES) + B_BYTES;
  static_assert(BYTES <= 232448, "shared memory of one CTA");
};

template <int A>
__device__ __forceinline__ void mma(float (&d)[A], uint64_t da, uint64_t db,
                                    int scale_d, F32) {
  mma_tf32(d, da, db, scale_d);
}
template <int A>
__device__ __forceinline__ void mma(float (&d)[A], uint64_t da, uint64_t db,
                                    int scale_d, Bf16) {
  mma_bf16(d, da, db, scale_d);
}
template <int A>
__device__ __forceinline__ void mma(int (&d)[A], uint64_t da, uint64_t db,
                                    int scale_d, Int8) {
  mma_s8(d, da, db, scale_d);
}

// This CTA's share [*beg, *end) of `units` items among the grid's CTAs.
__device__ __forceinline__ void share(long units, long* beg, long* end) {
  *beg = (long)blockIdx.x * units / gridDim.x;
  *end = (long)(blockIdx.x + 1) * units / gridDim.x;
}

// tv: the rows' maps (PIECE 0: TMA's of the postings (cap, dim), boxes of
// 128 bytes x 128 rows, 128B-swizzled; PIECE 2: the realigning producer's
// class maps; PIECE 8 / 4: unused, the producer reads `vp`, the postings'
// base, rows of `row_bytes`); tq / tq_lo: of the query planes (Q, qld),
// boxes of 128 bytes x N rows (float32: hi and lo; other kinds read tq
// alone), 128B-swizzled. mask (cap,) uint8, hot (grid_b,) int32, n_hot
// (1,) int32 on the device; keys (Q, grid_b * per_seg * bn / 128) int32.
template <class T, int N, int S, int PIECE>
__global__ void __launch_bounds__(threads_of(PIECE), 2)
ivf_segmax_wgmma_kernel(const __grid_constant__ ws::RowMapsOf<PIECE> tv,
                        const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tq_lo,
                        const unsigned char* __restrict__ vp,
                        const uint8_t* __restrict__ mask,
                        const int* __restrict__ hot,
                        const int* __restrict__ n_hot, int* __restrict__ keys,
                        int Q, long cap, long row_bytes, int bn, int grid_b,
                        int per_seg, int q_tiles, int k_iters) {
  typedef Smem<T, N, S, PIECE> L;
  typedef typename T::Acc Acc;
  constexpr int ACC = N / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(sm);
  const uint32_t a_ring = base + L::A_OFF, b_ring = base + L::B_OFF;
  const uint32_t full = base + L::BAR_OFF, empty = full + 8 * S;
  const uint32_t staged = empty + 8 * S;  // PIECE 2: the slots' barriers
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      // the elected producer thread's expect_tx arrival, and each thread's
      // of the cp.async and realigning producers
      mbar_init(full + 8 * s, PIECE ? 1 + ws::PRODUCERS : 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    if (PIECE == 2)
      for (int s = 0; s < ws::RSLOTS; ++s) mbar_init(staged + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int ns = bn / SEG;
  const int live_steps = max(0, min(*n_hot, grid_b));
  const long ncol = (long)grid_b * per_seg * ns;
  long ub, ue;  // items u: query tile u % q_tiles, live segment u / q_tiles
  share((long)live_steps * ns * q_tiles, &ub, &ue);
  const int lane = threadIdx.x % 32;

  // registers a thread keeps past the launch's (PIECE > 0): the
  // producer's, each consumer's (P + 2 C within 3 x LAUNCH_REGS)
  constexpr int PREGS = PIECE == 2 ? 72 : 40;
  constexpr int CREGS = (3 * LAUNCH_REGS - PREGS) / 2 / 8 * 8;
  if (threadIdx.x >= CONSUMERS) {  // the producer
    // stage st's query planes of the item at p, with the stage's expect_tx
    auto planes = [&](int st, const ws::Pos& p) {
      mbar_expect_tx(full + 8 * st, L::TX);
      const uint32_t b = b_ring + st * L::B_BYTES;
      tma_load_2d(b, &tq, full + 8 * st, p.kk * T::BK, p.q0);
      if constexpr (T::PLANES == 2)
        tma_load_2d(b + N * ROW_BYTES, &tq_lo, full + 8 * st, p.kk * T::BK,
                    p.q0);
    };
    if constexpr (PIECE == 0) {  // one warp; lane 0 issues the copies
      uint32_t n = 0;
      for (long u = ub; u < ue; ++u) {
        const int seg = (int)(u / q_tiles), q0 = (int)(u % q_tiles) * N;
        const long r0 = (long)hot[seg / ns] * bn + (long)(seg % ns) * SEG;
        bool live[4];
        if (!segment_live(mask, r0, r0 + SEG, lane, live)) continue;
        if (lane == 0)
          for (int k = 0; k < k_iters; ++k, ++n) {
            const int st = (int)(n % S);
            mbar_wait(empty + 8 * st, ((n / S) & 1) ^ 1);  // first lap: free
            planes(st, ws::Pos{r0, k, q0});
            tma_load_2d(a_ring + st * A_BYTES, &tv.v, full + 8 * st,
                        k * T::BK, (int)r0);
          }
        __syncwarp();
      }
    } else {  // cp.async or the realigning producer (wgmma_scan.cuh)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PREGS));
      // the walk over the items with a live row, a k-stage at a time
      long u = ub - 1;
      int kk = k_iters - 1;
      auto next = [&](ws::Pos& p) {
        if (u >= ub && u < ue && ++kk < k_iters) {
          p.kk = kk;
          return true;
        }
        kk = 0;
        while (++u < ue) {
          const int seg = (int)(u / q_tiles);
          const long r0 = (long)hot[seg / ns] * bn + (long)(seg % ns) * SEG;
          bool live[4];
          if (segment_live(mask, r0, r0 + SEG, lane, live)) {
            p = ws::Pos{r0, 0, (int)(u % q_tiles) * N};
            return true;
          }
        }
        return false;
      };
      ws::produce_rows<PIECE, S>(tv, next, planes, a_ring, full, empty,
                                 base + L::SLOT_OFF, staged, vp, cap,
                                 row_bytes, T::BK,
                                 (int)threadIdx.x - CONSUMERS);
    }
    return;
  }
  if constexpr (PIECE > 0 && CREGS > LAUNCH_REGS)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CREGS));

  // consumers: warpgroup g multiplies rows 64 g .. 64 g + 63 of the
  // segment by the query tile. Lane l of warp w holds rows 64 g + 16 w +
  // l / 4 (+ 8) at queries 8 j + 2 (l % 4) + e, in acc[4 j + 2 h + e].
  const int g = threadIdx.x / 128, w = (threadIdx.x / 32) % 4;
  const int warp = threadIdx.x / 32;
  int* tile = reinterpret_cast<int*>(sm + L::S_OFF);
  const uint32_t lo_buf = base + L::LO_OFF + g * HALF_BYTES;
  uint32_t n = 0;
  for (long u = ub; u < ue; ++u) {
    const int seg = (int)(u / q_tiles), q0 = (int)(u % q_tiles) * N;
    const int b = seg / ns, s = seg % ns;
    const long r0 = (long)hot[b] * bn + (long)s * SEG;
    const long col0 = (long)b * per_seg * ns + s;
    bool live[4];
    if (!segment_live(mask, r0, r0 + SEG, lane, live)) {  // no copy: KEY_MIN columns
      for (int i = threadIdx.x; i < N * per_seg; i += CONSUMERS) {
        const int qq = i / per_seg, t = i % per_seg;
        if (q0 + qq < Q) keys[(long)(q0 + qq) * ncol + col0 + (long)t * ns] = KEY_MIN;
      }
      continue;
    }
    Acc acc[ACC], part[ACC];  // part: F32's sum of one k-stage
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = part[i] = 0;
    for (int k = 0; k < k_iters; ++k, ++n) {
      const int st = (int)(n % S);
      mbar_wait(full + 8 * st, (n / S) & 1);
      if constexpr (PIECE > 0)  // the producer's threads wrote the rows
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t a = a_ring + st * A_BYTES + g * HALF_BYTES;
      const uint32_t bq = b_ring + st * L::B_BYTES;
      if constexpr (T::PLANES == 2)  // 3xTF32: split the warpgroup's rows
        ws::split_tf32<HALF_BYTES>(sm + L::A_OFF + st * A_BYTES + g * HALF_BYTES,
                                   sm + L::LO_OFF + g * HALF_BYTES, 2 + g);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < ROW_BYTES / 32; ++kk) {
        const uint64_t da = sw128_desc(a) + 2 * kk;
        const uint64_t db = sw128_desc(bq) + 2 * kk;
        if constexpr (T::PLANES == 2) {
          mma(part, da, db, kk != 0, T());
          mma(part, da, sw128_desc(bq + N * ROW_BYTES) + 2 * kk, 1, T());
          mma(part, sw128_desc(lo_buf) + 2 * kk, db, 1, T());
        } else {
          mma(acc, da, db, (k | kk) != 0, T());
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (lane == 0) mbar_arrive(empty + 8 * st);
      if constexpr (T::PLANES == 2) {
        fence_acc(part);
#pragma unroll
        for (int i = 0; i < ACC; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      }
    }
    fence_acc(acc);

    // epilogue: the segment's packed keys into the score tile, then per
    // query `per_seg` warp-wide max passes
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 64 * g + 16 * w + lane / 4 + 8 * h;
          const int qq = 8 * j + 2 * (lane % 4) + e;
          tile[qq * LDS + m] =
              (wg::order_key(acc[4 * j + 2 * h + e]) & ~(SEG - 1)) | m;
        }
    named_sync(1, CONSUMERS);
    for (int qq = warp; qq < N && q0 + qq < Q; qq += CONSUMER_WARPS) {
      int key[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        key[c] = live[c] ? tile[qq * LDS + lane + 32 * c] : KEY_MIN;
      int* out = keys + (long)(q0 + qq) * ncol + col0;
      for (int t = 0; t < per_seg; ++t) {
        int mx = max(max(key[0], key[1]), max(key[2], key[3]));
        mx = __reduce_max_sync(FULL, mx);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (key[c] == mx) key[c] = KEY_MIN;  // keys are distinct by lane
        if (lane == 0) out[(long)t * ns] = mx;
      }
    }
    named_sync(1, CONSUMERS);  // the tile is free for the next segment
  }

  // the dead steps' segments: KEY_MIN in every query's columns
  long db, de;
  share((long)(grid_b - live_steps) * ns, &db, &de);
  for (long d = db; d < de; ++d) {
    const int b = live_steps + (int)(d / ns), s = (int)(d % ns);
    const long col0 = (long)b * per_seg * ns + s;
    for (int i = threadIdx.x; i < Q * per_seg; i += CONSUMERS)
      keys[(long)(i / per_seg) * ncol + col0 + (long)(i % per_seg) * ns] =
          KEY_MIN;
  }
}

// The persistent grid's CTAs on the current device: as many as fit an SM
// (at most two: launch bounds) times the SM count. Worked out at a
// device's first launch of an instantiation and kept: the attribute and
// occupancy queries take the host longer than the launch itself.
template <class T, int N, int S, int PIECE>
int grid_ctas(int* ctas) {
  constexpr int MAX_DEVICES = 64;
  static std::atomic<int> known[MAX_DEVICES];  // 0: not yet worked out
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < MAX_DEVICES && (*ctas = known[dev].load()) > 0) return 0;
  constexpr int smem = Smem<T, N, S, PIECE>::BYTES;
  auto kernel = ivf_segmax_wgmma_kernel<T, N, S, PIECE>;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, threads_of(PIECE), smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *ctas = std::min(per_sm, 2) * sms;
  if (dev < MAX_DEVICES) known[dev].store(*ctas);
  return 0;
}

// Encodes the maps (tv: TMA's, boxes of 128 bytes x 128 rows, or the
// realigning producer's class maps; tq and, for float32, tq_lo: 128 bytes
// x N rows of the planes (Q, qld)) and launches the persistent grid.
template <class T, int N, int S, int PIECE>
int launch(const void* q, const void* q_lo, int qld, const void* v,
           const void* mask, const void* hot, const void* n_hot, void* keys,
           int Q, long long cap, int dim, int bn, int grid_b, int per_seg,
           cudaStream_t stream) {
  wg::EncodeTiled enc;
  int err = wg::encoder(&enc);
  if (err) return err;
  ws::RowMapsOf<PIECE> tv{};
  CUtensorMap tq, tq_lo;
  if constexpr (PIECE == 0) {
    if ((err = wg::encode_rows<T>(enc, &tv.v, v, cap, dim, ROWS))) return err;
  } else if constexpr (PIECE == 2) {
    if ((err = ws::row_classes<T>(enc, &tv, v, cap, dim))) return err;
  }
  if ((err = wg::encode_rows<T>(enc, &tq, q, Q, qld, N))) return err;
  if constexpr (T::PLANES == 2) {
    if ((err = wg::encode_rows<T>(enc, &tq_lo, q_lo, Q, qld, N))) return err;
  } else {
    tq_lo = tq;  // not read
  }
  int ctas = 0;
  if ((err = grid_ctas<T, N, S, PIECE>(&ctas))) return err;
  const int q_tiles = (Q + N - 1) / N;
  const long long row_bytes = (long long)dim * T::ELEM_BYTES;
  const int k_iters = (int)((row_bytes + ROW_BYTES - 1) / ROW_BYTES);
  ivf_segmax_wgmma_kernel<T, N, S, PIECE>
      <<<ctas, threads_of(PIECE), Smem<T, N, S, PIECE>::BYTES, stream>>>(
          tv, tq, tq_lo, static_cast<const unsigned char*>(v),
          static_cast<const uint8_t*>(mask), static_cast<const int*>(hot),
          static_cast<const int*>(n_hot), static_cast<int*>(keys), Q,
          (long)cap, (long)row_bytes, bn, grid_b, per_seg, q_tiles, k_iters);
  return (int)cudaGetLastError();
}

// The query tile (N = 32 at Q <= 32, the route's chunks; else 64) and the
// ring depth: three stages, two for the realigning producer. The planes
// (Q, qld), qld = dim rounded up to whole 16 bytes, 16-byte aligned; the
// rows' bytes and base multiples of the piece (16 for TMA, 2: any).
template <class T, int PIECE>
int launch_kind(const void* q, const void* q_lo, const void* v,
                const void* mask, const void* hot, const void* n_hot,
                void* keys, int Q, long long cap, int dim, int bn, int grid_b,
                int per_seg, cudaStream_t s) {
  constexpr int S = PIECE == 2 ? REALIGN_STAGES : STAGES;
  const int qld = ws::plane_ld(dim, T::ELEM_BYTES);
  const int align = PIECE == 0 ? 16 : PIECE == 2 ? 1 : PIECE;
  if ((long long)dim * T::ELEM_BYTES % align || (uintptr_t)v % align ||
      ((uintptr_t)q | (uintptr_t)(T::PLANES == 2 ? q_lo : q)) % 16)
    return (int)cudaErrorInvalidValue;
  return Q <= 32 ? launch<T, 32, S, PIECE>(q, q_lo, qld, v, mask, hot, n_hot,
                                           keys, Q, cap, dim, bn, grid_b,
                                           per_seg, s)
                 : launch<T, 64, S, PIECE>(q, q_lo, qld, v, mask, hot, n_hot,
                                           keys, Q, cap, dim, bn, grid_b,
                                           per_seg, s);
}

}  // namespace sg
}  // namespace
}  // namespace pv

// K8 on the tensor cores: pv_ivf_segmax's contract (ops/ivf.py::
// ivf_segmax_scan) at every postings width and base. piece: the rows'
// producer (ops/scan.py::rows_piece): 0 TMA (row bytes and v's base
// multiples of 16), 8 or 4 cp.async (multiples of piece), 2 the realigning
// producer (kinds 1 and 2, any width and base). kind 0: float32 postings,
// q the queries' hi plane and q_lo their lo plane (ops/scan.py::
// split_tf32); 1: bf16 postings and q; 2: column-scaled int8 postings and
// folded int8 q (q_lo unused); the planes
// (Q, qld), qld = dim rounded up to whole 16 bytes, zeros past dim,
// 16-byte aligned. postings (cap, dim) with cap % bn == 0 and bn % 128 ==
// 0, mask (cap,) uint8, hot (grid_b,) int32 tile ids in [0, cap / bn),
// n_hot (1,) int32 on the device -> keys (Q, grid_b * per_seg * bn / 128)
// int32; per_seg in 1..8. Returns 0, a cudaError_t, or minus the CUresult
// of a refused tensor-map encode.
extern "C" int pv_ivf_segmax_wgmma(int piece, int kind, const void* q,
                                   const void* q_lo, const void* v,
                                   const void* mask, const void* hot,
                                   const void* n_hot, void* keys, int Q,
                                   long long cap, int dim, int bn, int grid_b,
                                   int per_seg, void* stream) {
  using namespace pv;
  using namespace pv::sg;
  if (Q <= 0 || grid_b <= 0) return (int)cudaSuccess;
  if (bn <= 0 || bn % SEG || cap % bn || per_seg < 1 || per_seg > 8 ||
      dim <= 0 || kind < 0 || kind > 2 || (kind == 0 && !q_lo))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return ws::with_piece(piece, [&](auto p) {
    constexpr int P = decltype(p)::value;
    if (kind == 1)
      return launch_kind<Bf16, P>(q, q_lo, v, mask, hot, n_hot, keys, Q, cap,
                                  dim, bn, grid_b, per_seg, s);
    if (kind == 2)
      return launch_kind<Int8, P>(q, q_lo, v, mask, hot, n_hot, keys, Q, cap,
                                  dim, bn, grid_b, per_seg, s);
    if constexpr (P == 2)  // float32 rows are whole 4 bytes
      return (int)cudaErrorInvalidValue;
    else
      return launch_kind<F32, P>(q, q_lo, v, mask, hot, n_hot, keys, Q, cap,
                                 dim, bn, grid_b, per_seg, s);
  });
}
