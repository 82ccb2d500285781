// One-query sweeps of K9 fused_topk_i8c, K7 ivf_scan_topk, K6
// fused_topk_i4, K3 fused_topk_i8 and K4 fused_topk at their serving
// shapes (Q <= 16, k <= 128; K3 k <= 384; rows of 16-byte words): every
// row read once from device memory, at HBM rate.
//
// Replaces, on those shapes:
//  * picovdb_tpu/ops/pallas_scan.py:fused_topk_i8 (`_scan_kernel_i8`,
//    K3), the default float32 store's Q = 1 route `i8_fused_smallq`
//    (k_sel = k + 4) and the int8 store's host-rescore band
//    `i8stor_fused_exact` (k + 128 + 4: 142 at k = 10), at every Q <= 16,
//    and through `sweep_narrow_kernel` at every int8 width and base (the
//    template, pv_scan_topk kind 2, served those until then);
//  * picovdb_tpu/ops/pallas_scan.py:fused_topk_i4 (`_scan_kernel_i4`,
//    K6), the int4 store's Q = 1 query and small batches (route
//    `i4stor_fused` at k_sel = k + 4; served at Q <= 4, where it beats
//    scan_i4_wgmma.cu, which takes larger Q), and through
//    `sweep_narrow_kernel<Int4>` at every even width and base (the
//    template, pv_scan_topk kind 3, served those until then);
//  * picovdb_tpu/ops/pallas_scan.py:fused_topk_i8c (`_scan_kernel_i8c`,
//    K9), on the routes `i8c_fused_smallq` (Q <= 16 at k_sel = k + 6) and
//    the serial Q = 1 loop, up to ops/scan.py::I8C_SWEEP_Q_MAX over rows
//    of whole 16-byte words, and through `sweep_narrow_kernel<Int8C>` up
//    to I8C_NARROW_Q_MAX at every other width and base (glove-100's 100
//    bytes, glove-25's 25; the template, pv_scan_topk kind 4, served those
//    until then); scan_topk_wgmma.cu and topk_i8_wide.cu serve the rest;
//  * picovdb_tpu/ops/ivf.py:probe_scan_local (`_ivf_kernel`,
//    `_ivf_kernel_i8c`, K7), the IVF ladder over the hot tiles that a
//    device table names, at Q <= 16 (a Q = 1 probe and the small batches),
//    and through `sweep_narrow_kernel` at every postings width and base
//    (ivf_scan_wgmma.cu and ivf_scan_wide.cu serve larger batches and k >
//    128);
//  * picovdb_tpu/ops/pallas_scan.py:fused_topk (`_scan_kernel`, K4) over
//    float32 rows and the bf16 mirror at small Q (ops/scan.py::
//    TOPK_SWEEP_Q_MAX; the Q = 1 exact retry, `mixed_fused_smallq`,
//    `pallas_fused`, a mesh shard's Q = 1 call), and through
//    `sweep_narrow_kernel` at every width and base (scan_topk_wgmma.cu
//    served those shapes until then, and serves larger batches).
// All compute what their templates compute: per query the k best masked
// rows, one partial of k keys per CTA, merged by launch_topk_merge. Six
// element kinds: column-scaled int8 rows x folded int8 queries ranked on
// the raw int32 sum (int_row_key, ties to the lower row; bit for bit the
// plain versions, whose keys are distinct per row, so the merged set does
// not depend on the row shares); float32 rows x float32 queries and bf16
// rows x bf16 queries (the TPU kernel casts q to the postings' dtype), and
// bf16 rows x float32 queries (`Bf16F`, K4's mirror), float32 sums ranked
// by row_key; packed int4 rows x int8 queries and per-row-scaled int8 rows
// x int8 queries, the template's scaled score ranked by row_key (see
// `Int4`, `Int8R`).
//
// What bounds it on the H100: the bytes. At Q = 1 a 16-byte word of a row
// is 4 FMAs (f32), 8 (bf16), 4 __dp4a (int8) or 8 (int4), so the sweep of
// the rows from device memory is the floor (K7 at phase 2: 40 live 1,024-row tiles
// of 4 KB rows, 168 MB, 0.05 ms at 3.35 TB/s). The template kernel
// (scan_topk.cu) it replaces held one live query in a 16-query tile, so at
// Q = 1 15/16 of its arithmetic was wasted, and staged the rows through
// shared memory with two barriers per 64-byte k-step; for K7 it also
// launched a block for every step of the padded hot table, dead or not,
// and merged grid_b x 8 x k keys a query.
//
// Design:
//  * The query tile is sized to Q: QT = 1, 2, 4, 8 or 16, the smallest
//    >= Q, so no lane computes for an absent query. The CTA loads its QT x
//    dim query block once, into shared memory (<= QBLOCK_BYTES).
//  * A grid of CTAS_PER_SM CTAs per SM; each takes its rows from `Rows`:
//    K9 and K6 contiguous 128-row-aligned ranges (ops/scan.py::
//    sweep_partition),
//    K7 a share of the live hot tiles' rows, a pure function of (n_hot,
//    bn, CTAs) that every CTA evaluates after reading n_hot on the device
//    (ops/ivf.py::ivf_sweep_partition): dead steps cost no CTA, and a
//    query merges CTAs x k keys.
//  * A warp owns groups of RW rows: every lane reads 16-byte words of each
//    row with non-coherent loads, two per row issued together (Int4: one,
//    its two nibble planes split once for every query), skips the
//    loads of masked rows, runs the kind's products per query, and sums
//    each (query, row) over the warp (__reduce_add_sync, or five xor
//    shuffles for float sums). A warp reads the mask of its 16 rows of a
//    128-row tile at once (one ballot). No barrier inside a tile. A K7
//    group maps to physical rows through the table once: shares start on
//    a multiple of SHARE rows, so a group never crosses a hot tile.
//  * K3's, K4's, K6's, K7's and K9's rows at any width and base
//    (`sweep_narrow_kernel`, the narrow kind; K6's packed int4 rows; K7's
//    float32, bf16 and column-scaled int8 postings over the hot tiles'
//    shares, K9's column-scaled int8 rows over flat ranges): a row of `rb`
//    bytes lies at byte phase p = (v
//    + row rb) % 16 of its 16-byte words. The CTA keeps P = 16 / g phase
//    copies of each query (g the largest power of two <= 16 dividing rb
//    and v's base, a multiple of the element's bytes): copy j holds j g
//    zero bytes, the query, zeros to W whole words (K6: the query's two
//    halves, each so, QW = 2: a packed byte's low nibble meets the first
//    half, its high nibble the second, and a neighbour's nibbles in a
//    shared word meet zeros in both planes). A warp reads each row
//    as the aligned words that hold a byte of it, so a warp still reads
//    contiguous 16-byte words, and meets them with the copy of the row's
//    phase: the bytes of a neighbouring row in a shared word meet zeros
//    (the float kinds zero them in the word too: 0 x NaN is NaN). No read
//    leaves the 16-byte chunks that hold a byte of the row. The sums, keys
//    and selection are the kind's, so it is bit for bit the plain version
//    for the int8 kinds too.
//  * Selection behind a threshold: per query a shared buffer of BUF keys
//    admits only keys above the running k-th best (`tau`); after each tile
//    the CTA compacts (compact_buffers) when a buffer could overflow in
//    the next, and at the end writes its k best per query (0 where empty:
//    a CTA with no live row writes an empty partial). BUF = 256 serves k
//    <= 128; K3's `Int8R` also has BUF = 512 for 128 < k <= 384 (the
//    host-rescore band): its buffers take 64 KB at QT = 16, so the query
//    block and the buffers stay within 80 KB at dim 1024 and two CTAs
//    still share an SM.
//  * Tiles up to each kind's served limit only (`QT_MAX`, `NARROW_QT_MAX`:
//    K3's 4, K4's `Bf16F` 4, K6's 4 and 8; K9 and K7 reach 16): a
//    kind's entry takes up to 16 queries all the same, in passes of its
//    largest tile, each reading the rows again (the crossover calls of
//    chip_smoke.py time those past the limits).

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace pv {
namespace {

constexpr int SW_THREADS = 256;
constexpr int SW_WARPS = SW_THREADS / 32;
constexpr int TR = 128;          // rows per tile between the CTA's barriers
constexpr int WARP_ROWS = TR / SW_WARPS;  // 16 rows of a tile per warp
constexpr int BUF_K128 = 256;    // candidate slots per query (>= k + TR)
constexpr int BUF_K384 = 512;    // Int8R's, for 128 < k <= 384 (>= k + TR)
constexpr int CTAS_PER_SM = 2;   // ops/scan.py SWEEP_CTAS_PER_SM
constexpr int QBLOCK_BYTES = 65536;  // ops/scan.py SWEEP_QBLOCK_BYTES
constexpr int SHARE = 16;        // ops/ivf.py IVF_SWEEP_SHARE: K7's share unit
// the narrow kind's shared memory (query block, buffers, tau and counts):
// two CTAs an SM (ops/scan.py NARROW_SMEM_BYTES)
constexpr size_t NARROW_SMEM_BYTES = 112 << 10;
// K6's and K7's kinds in the packed layout: steps whose words a lane
// loads together, and queries a group of sums (K3's: every step, every
// query)
constexpr int NARROW_LOADS = 4;
constexpr int NARROW_QG = 8;
constexpr unsigned FULL = 0xffffffffu;

// Element kinds: a 16-byte word of a row holds EPW elements; `dot` adds a
// row word times a query word to a lane's sum, `sum` totals a (query, row)
// over the warp, `key` is the row's selection key.
struct Int8C {  // column-scaled int8 rows, folded int8 queries
  typedef int Acc;
  static constexpr int EPW = 16;
  static constexpr int QW = 1;  // query words a row word meets
  static constexpr bool ROW_SCALE = false;  // the key scales by vscale[row]
  static constexpr int K_MAX = 128;
  // the largest query tile of the 16-byte sweep and of the narrow kind:
  // K9's and K7's limits reach 16 (a kind served only below 16 caps its
  // tiles, and its entries take more queries in passes of the cap)
  static constexpr int QT_MAX = 16, NARROW_QT_MAX = 16;
  static __device__ __forceinline__ int dot(uint4 a, uint4 b, int acc) {
    acc = __dp4a((int)a.x, (int)b.x, acc);
    acc = __dp4a((int)a.y, (int)b.y, acc);
    acc = __dp4a((int)a.z, (int)b.z, acc);
    return __dp4a((int)a.w, (int)b.w, acc);
  }
  static __device__ __forceinline__ int sum(int s) {
    return __reduce_add_sync(FULL, s);
  }
  static __device__ __forceinline__ u64 key(int s, uint32_t row) {
    return int_row_key(s, row);
  }
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
  return s;
}

struct F32 {  // float32 rows and queries
  typedef float Acc;
  static constexpr int EPW = 4;
  static constexpr int QW = 1;
  static constexpr bool ROW_SCALE = false;
  static constexpr int K_MAX = 128;
  static constexpr int QT_MAX = 16, NARROW_QT_MAX = 16;  // K7's
  static __device__ __forceinline__ float dot(uint4 a, uint4 b, float acc) {
    acc = fmaf(__uint_as_float(a.x), __uint_as_float(b.x), acc);
    acc = fmaf(__uint_as_float(a.y), __uint_as_float(b.y), acc);
    acc = fmaf(__uint_as_float(a.z), __uint_as_float(b.z), acc);
    return fmaf(__uint_as_float(a.w), __uint_as_float(b.w), acc);
  }
  static __device__ __forceinline__ float sum(float s) { return warp_sum(s); }
  static __device__ __forceinline__ u64 key(float s, uint32_t row) {
    return row_key(s, row);
  }
};

// bf16 -> float32 is exact: the low or high half of a word, shifted into
// the high 16 bits; the product of two bf16 is exact in float32.
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ float bf_fma2(uint32_t a, uint32_t b, float acc) {
  return fmaf(bf_hi(a), bf_hi(b), fmaf(bf_lo(a), bf_lo(b), acc));
}

struct Bf16 {  // bf16 rows and queries, float32 sums
  typedef float Acc;
  static constexpr int EPW = 8;
  static constexpr int QW = 1;
  static constexpr bool ROW_SCALE = false;
  static constexpr int K_MAX = 128;
  static constexpr int QT_MAX = 16, NARROW_QT_MAX = 16;  // K7's
  static __device__ __forceinline__ float dot(uint4 a, uint4 b, float acc) {
    acc = bf_fma2(a.x, b.x, acc);
    acc = bf_fma2(a.y, b.y, acc);
    acc = bf_fma2(a.z, b.z, acc);
    return bf_fma2(a.w, b.w, acc);
  }
  static __device__ __forceinline__ float sum(float s) { return warp_sum(s); }
  static __device__ __forceinline__ u64 key(float s, uint32_t row) {
    return row_key(s, row);
  }
};

// bf16 rows (K4's mirror) against the float32 query (K4 keeps the query in
// float32; K7's `Bf16` rounds it, as its TPU kernel does): a 16-byte row
// word holds 8 bf16, met by two float32 query words, QW = 2. The query
// block holds each query deinterleaved: word c of its first half the
// query's floats [8 c, 8 c + 4), word c of its second half [8 c + 4, 8 c +
// 8), so row word c meets words c and cpr + c (Int4's layout) and a warp's
// reads of either half are contiguous (`query_word`). In the narrow kind
// row word c meets word c of both halves of the phase copy. bf16 -> float32
// is exact, so the sums are the plain version's float32 products, summed
// in another order.
struct Bf16F {
  typedef float Acc;
  static constexpr int EPW = 8;
  static constexpr int QW = 2;
  static constexpr bool ROW_SCALE = false;
  static constexpr int K_MAX = 128;
  // ops/scan.py TOPK_SWEEP_Q_MAX, TOPK_NARROW_Q_MAX
  static constexpr int QT_MAX = 4, NARROW_QT_MAX = 4;
  static __device__ __forceinline__ float dot(uint4 a, uint4 lo, uint4 hi,
                                              float acc) {
    acc = fmaf(bf_lo(a.x), __uint_as_float(lo.x), acc);
    acc = fmaf(bf_hi(a.x), __uint_as_float(lo.y), acc);
    acc = fmaf(bf_lo(a.y), __uint_as_float(lo.z), acc);
    acc = fmaf(bf_hi(a.y), __uint_as_float(lo.w), acc);
    acc = fmaf(bf_lo(a.z), __uint_as_float(hi.x), acc);
    acc = fmaf(bf_hi(a.z), __uint_as_float(hi.y), acc);
    acc = fmaf(bf_lo(a.w), __uint_as_float(hi.z), acc);
    return fmaf(bf_hi(a.w), __uint_as_float(hi.w), acc);
  }
  static __device__ __forceinline__ float sum(float s) { return warp_sum(s); }
  static __device__ __forceinline__ u64 key(float s, uint32_t row) {
    return row_key(s, row);
  }
};

// Packed int4 rows (K6) against int8 queries: a 16-byte row word holds 16
// packed bytes, 32 elements. Byte b of word c carries element 16 c + b of
// the row's first half in its low nibble and element dim/2 + 16 c + b in
// its high nibble, both biased by +8 (1..15), so row word c meets query
// word c (the low plane) and query word cpr + c (the high plane): QW = 2
// query words a row word. The masked planes are non-negative bytes, safe
// as __dp4a's signed operand. The key is the template's: (sum - 8 sum(q))
// converted once, times the row's scale, ranked by row_key. In the narrow
// kind (rows of any even width at any base) row word c meets word c of the
// phase copy of each half instead.
struct Int4 {
  typedef int Acc;
  static constexpr int EPW = 32;
  static constexpr int QW = 2;
  static constexpr bool ROW_SCALE = true;
  static constexpr int K_MAX = 128;
  // ops/scan.py I4_SWEEP_Q_MAX, I4_NARROW_Q_MAX
  static constexpr int QT_MAX = 4, NARROW_QT_MAX = 8;
  // the planes of a row word, split once and met by every query
  static __device__ __forceinline__ uint4 low(uint4 a) {
    const uint32_t m = 0x0F0F0F0Fu;
    return make_uint4(a.x & m, a.y & m, a.z & m, a.w & m);
  }
  static __device__ __forceinline__ uint4 high(uint4 a) {
    const uint32_t m = 0x0F0F0F0Fu;
    return make_uint4((a.x >> 4) & m, (a.y >> 4) & m, (a.z >> 4) & m,
                      (a.w >> 4) & m);
  }
  static __device__ __forceinline__ int dot(uint4 lo, uint4 hi, uint4 qlo,
                                            uint4 qhi, int acc) {
    acc = __dp4a((int)lo.x, (int)qlo.x, acc);
    acc = __dp4a((int)lo.y, (int)qlo.y, acc);
    acc = __dp4a((int)lo.z, (int)qlo.z, acc);
    acc = __dp4a((int)lo.w, (int)qlo.w, acc);
    acc = __dp4a((int)hi.x, (int)qhi.x, acc);
    acc = __dp4a((int)hi.y, (int)qhi.y, acc);
    acc = __dp4a((int)hi.z, (int)qhi.z, acc);
    return __dp4a((int)hi.w, (int)qhi.w, acc);
  }
  static __device__ __forceinline__ int sum(int s) {
    return __reduce_add_sync(FULL, s);
  }
};

// Per-row-scaled int8 rows (K3: the float32 store's int8 mirror, the int8
// store's plane) against int8 queries: Int8C's word products and warp sum,
// and the template's key (scan_topk.cu): the int32 sum converted once,
// times the row's scale, ranked by row_key, ties to the lower row.
struct Int8R : Int8C {
  static constexpr bool ROW_SCALE = true;
  static constexpr int K_MAX = 384;
  // ops/scan.py I8_SWEEP_Q_MAX (the narrow kind's limit too)
  static constexpr int QT_MAX = 4, NARROW_QT_MAX = 4;
};

// Which rows CTA c of n reads, as logical rows [beg, end) and their
// physical rows. K9 (hot null): logical = physical, the range [c chunk,
// min(cap, (c + 1) chunk)). K7: logical row i is lane i % bn of hot step
// i / bn, physical row hot[i / bn] * bn + i % bn, for the live steps below
// min(*n_hot, grid_b) (n_hot read on the device); CTA c takes the units
// [c U / n, (c + 1) U / n) of SHARE rows, U = live steps * bn / SHARE, so
// the shares cover the live rows once and differ by at most one unit.
struct Rows {
  const int* hot;
  const int* n_hot;
  long cap, chunk;  // K9
  int bn, grid_b;   // K7

  __device__ __forceinline__ void range(int c, int n, long* beg,
                                        long* end) const {
    if (!hot) {
      *beg = (long)c * chunk;
      *end = *beg + chunk < cap ? *beg + chunk : cap;
      return;
    }
    const int live = max(0, min(*n_hot, grid_b));
    const long units = (long)live * (bn / SHARE);
    *beg = SHARE * ((long)c * units / n);
    *end = SHARE * ((long)(c + 1) * units / n);
  }

  // (K7's logical rows stay below grid_b * bn <= cap < 2^31: int division)
  __device__ __forceinline__ long phys(long i) const {
    if (!hot) return i;
    const int ii = (int)i;
    return (long)hot[ii / bn] * bn + ii % bn;
  }
};

// Rows per warp step: 4 while the query tile is small, 2 at QT >= 8 so the
// QT x RW sums and the loaded words stay in registers. Shared memory, for
// rows of `cpr` 16-byte words: the query block, then the buffers.
template <int QT>
struct Sweep {
  static constexpr int RW = QT <= 4 ? 4 : 2;
  static_assert(SHARE % RW == 0 && WARP_ROWS % RW == 0, "row groups");
  // (qw query words a row word; Int4 adds each query's int8 sum)
  static constexpr size_t smem(int cpr, int qw, int buf) {
    return (size_t)QT * qw * cpr * 16 + (size_t)QT * buf * 8 + QT * 8 +
           QT * 4 + (qw == 2 ? QT * 4 : 0);
  }
};

// Word j of a query row in the 16-byte sweep's query block, read from the
// query's word query_word<K>(j, cpr): Bf16F's deinterleaved halves (half
// j / cpr, word j % cpr: the query's word 2 (j % cpr) + j / cpr), the
// query as it is for the other kinds.
template <class K>
__device__ __forceinline__ int query_word(int j, int cpr) {
  if constexpr (std::is_same<K, Bf16F>::value)
    return 2 * (j % cpr) + j / cpr;
  else
    return j;
}

template <class K, int QT, int BUF>
__global__ void __launch_bounds__(SW_THREADS, CTAS_PER_SM)
sweep_topk_kernel(const uint4* __restrict__ q, const uint4* __restrict__ v,
                  const float* __restrict__ vscale,
                  const uint8_t* __restrict__ mask, const Rows rows,
                  u64* __restrict__ partial, int Q, int cpr, int k) {
  typedef typename K::Acc Acc;
  constexpr int RW = Sweep<QT>::RW;
  constexpr int GROUPS = WARP_ROWS / RW;  // a warp's row groups per tile
  constexpr bool I4 = std::is_same<K, Int4>::value;
  const int qwords = K::QW * cpr;  // 16-byte words of a query row
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* qs = reinterpret_cast<uint4*>(smem);           // QT x qwords
  u64* buf = reinterpret_cast<u64*>(qs + QT * qwords);  // QT x BUF keys
  u64* tau = buf + QT * BUF;
  int* cnt = reinterpret_cast<int*>(tau + QT);
  int* qsum = cnt + QT;  // Int4: each query's int8 sum

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < QT * qwords; i += SW_THREADS) {
    const int qq = i / qwords;
    qs[i] = qq < Q ? __ldg(q + qq * qwords + query_word<K>(i - qq * qwords,
                                                           cpr))
                   : zero;
  }
  if (threadIdx.x < QT) {
    cnt[threadIdx.x] = 0;
    tau[threadIdx.x] = 0ull;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if constexpr (I4) {  // warp w sums queries w, w + 8 from the block
    for (int qq = warp; qq < QT; qq += SW_WARPS) {
      int s = 0;
      for (int c = lane; c < qwords; c += 32) {
        const uint4 w = qs[qq * qwords + c];
        s = __dp4a((int)w.x, 0x01010101, s);
        s = __dp4a((int)w.y, 0x01010101, s);
        s = __dp4a((int)w.z, 0x01010101, s);
        s = __dp4a((int)w.w, 0x01010101, s);
      }
      s = __reduce_add_sync(FULL, s);
      if (lane == 0) qsum[qq] = s;
    }
    __syncthreads();
  }
  long rbeg, rend;
  rows.range(blockIdx.x, gridDim.x, &rbeg, &rend);
  for (long t0 = rbeg; t0 < rend; t0 += TR) {
    // the warp's rows of this tile: group g, row r is logical row
    // t0 + g * SW_WARPS * RW + warp * RW + r; bit g * RW + r of `live`
    uint32_t live;
    {
      const long i = t0 + (lane / RW) * SW_WARPS * RW + warp * RW + lane % RW;
      live = __ballot_sync(
          FULL, lane < WARP_ROWS && i < rend && mask[rows.phys(i)] != 0);
    }
#pragma unroll 1
    for (int g = 0; g < GROUPS; ++g) {
      const uint32_t gl = (live >> (g * RW)) & ((1u << RW) - 1);
      if (!gl) continue;  // uniform: no live row in the group
      const long p0 = rows.phys(t0 + (long)g * SW_WARPS * RW + warp * RW);
      // Int4, Int8R: the scale of the row this lane admits for (lane %
      // RW), loaded before the products hide its latency
      float sc = 0.0f;
      if constexpr (K::ROW_SCALE)
        if ((gl >> (lane % RW)) & 1u) sc = vscale[p0 + lane % RW];
      Acc acc[QT][RW];
#pragma unroll
      for (int qq = 0; qq < QT; ++qq)
#pragma unroll
        for (int r = 0; r < RW; ++r) acc[qq][r] = 0;
      if constexpr (I4) {
        // a packed row is half as long: one word a lane per row, its
        // planes split once, row word c meeting query words c and cpr + c
        for (int c = lane; c < cpr; c += 32) {
          uint4 lo[RW], hi[RW];
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            const uint4 x =
                (gl >> r) & 1u ? __ldg(v + (p0 + r) * cpr + c) : zero;
            lo[r] = K::low(x);
            hi[r] = K::high(x);
          }
#pragma unroll
          for (int qq = 0; qq < QT; ++qq) {
            const uint4 w = qs[qq * qwords + c];
            const uint4 h = qs[qq * qwords + cpr + c];
#pragma unroll
            for (int r = 0; r < RW; ++r)
              acc[qq][r] = K::dot(lo[r], hi[r], w, h, acc[qq][r]);
          }
        }
      } else {
        for (int c = lane; c < cpr; c += 64) {
          const bool two = c + 32 < cpr;
          uint4 x0[RW], x1[RW];
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            const uint4* row = v + (p0 + r) * cpr + c;
            const bool on = (gl >> r) & 1u;
            x0[r] = on ? __ldg(row) : zero;
            x1[r] = on && two ? __ldg(row + 32) : zero;
          }
#pragma unroll
          for (int qq = 0; qq < QT; ++qq) {
            const uint4* qr = qs + qq * qwords + c;
            if constexpr (K::QW == 2) {  // Bf16F: words c and cpr + c
              const uint4 l0 = qr[0], h0 = qr[cpr];
              const uint4 l1 = two ? qr[32] : zero;
              const uint4 h1 = two ? qr[cpr + 32] : zero;
#pragma unroll
              for (int r = 0; r < RW; ++r)
                acc[qq][r] =
                    K::dot(x1[r], l1, h1, K::dot(x0[r], l0, h0, acc[qq][r]));
            } else {
              const uint4 w0 = qr[0];
              const uint4 w1 = two ? qr[32] : zero;
#pragma unroll
              for (int r = 0; r < RW; ++r)
                acc[qq][r] = K::dot(x1[r], w1, K::dot(x0[r], w0, acc[qq][r]));
            }
          }
        }
      }
      // each (query, row) sum over the warp; lane (qq RW + r) % 32 admits it
#pragma unroll
      for (int qq = 0; qq < QT; ++qq)
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const Acc s = K::sum(acc[qq][r]);
          if (lane == (qq * RW + r) % 32 && ((gl >> r) & 1u) && qq < Q) {
            u64 key;
            if constexpr (K::ROW_SCALE)  // the template's line (scan_topk.cu)
              key = row_key(__fmul_rn(__int2float_rn(I4 ? s - 8 * qsum[qq] : s),
                                      sc),
                            (uint32_t)(p0 + r));
            else
              key = K::key(s, (uint32_t)(p0 + r));
            if (key > tau[qq]) buf[qq * BUF + atomicAdd(&cnt[qq], 1)] = key;
          }
        }
    }
    __syncthreads();
    bool full = false;
#pragma unroll
    for (int s = 0; s < QT; ++s) full |= cnt[s] > BUF - TR;
    __syncthreads();
    if (full) compact_buffers(buf, cnt, tau, QT, BUF, k);
  }
  __syncthreads();
  compact_buffers(buf, cnt, tau, QT, BUF, k);
  for (int i = threadIdx.x; i < QT * k; i += SW_THREADS) {
    const int qq = i / k, j = i % k;
    if (qq < Q)
      partial[((long)qq * gridDim.x + blockIdx.x) * k + j] = buf[qq * BUF + j];
  }
}

// Zeros the bytes of a 16-byte word outside [lo, hi) (float kinds: the
// narrow sweep's row words may hold a neighbour's elements, which meet
// zero query bytes but could carry a NaN's or an infinity's bits; the
// integer kinds' products with zero are zero, so they keep the word).
template <class K>
__device__ __forceinline__ uint4 clip_word(uint4 x, int lo, int hi) {
  if constexpr (std::is_same<typename K::Acc, int>::value) {
    return x;
  } else {
    if (lo <= 0 && hi >= 16) return x;
    uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int a = min(max(lo - 4 * i, 0), 4), b = min(max(hi - 4 * i, 0), 4);
      const uint32_t up = b >= 4 ? 0xffffffffu : (1u << (8 * b)) - 1u;
      const uint32_t dn = a >= 4 ? 0xffffffffu : (1u << (8 * a)) - 1u;
      w[i] &= up & ~dn;
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// A row word of the narrow kind against its query copy at `cq`: the kind's
// word product, Int4's two planes and Bf16F's word against the copy's
// halves (words cq[0] and cq[W]).
template <class K>
__device__ __forceinline__ typename K::Acc narrow_dot(uint4 x, const uint4* cq,
                                                      int W,
                                                      typename K::Acc acc) {
  if constexpr (std::is_same<K, Int4>::value)
    return K::dot(K::low(x), K::high(x), cq[0], cq[W], acc);
  else if constexpr (K::QW == 2)
    return K::dot(x, cq[0], cq[W], acc);
  else
    return K::dot(x, cq[0], acc);
}

// A (query, row) sum's selection key: Int8R's and Int4's scaled score (the
// template's line, scan_topk.cu; Int4's sum already less 8 sum(q)), else
// the kind's key.
template <class K>
__device__ __forceinline__ u64 narrow_key(typename K::Acc s, float sc,
                                          uint32_t row) {
  if constexpr (K::ROW_SCALE)
    return row_key(__fmul_rn(__int2float_rn(s), sc), row);
  else
    return K::key(s, row);
}

// CTAs an SM the narrow sweep's registers leave room for: two, but one
// for K7's kinds at a 16-query tile, whose sums and query words do not fit
// the 128 registers two CTAs of 256 threads allow.
template <class K>
__host__ __device__ constexpr int narrow_ctas_per_sm(int qt) {
  return qt >= 16 && !K::ROW_SCALE ? 1 : CTAS_PER_SM;
}

// The narrow sweep: kind K (Int8R: K3's per-row-scaled int8 rows; Int4:
// K6's packed int4 rows, rb = dim / 2; Int8C, F32, Bf16: K7's
// column-scaled int8, float32 and bf16 postings; F32 and Bf16F: K4's
// float32 rows and bf16 mirror against the float32 query) over rows
// of `rb` bytes at any base, the rows `rows` names (K3, K4 and K6 flat
// ranges, K7 a share of the live hot tiles, whose 16-row units keep a
// warp's rows in one tile). The query block holds P phase copies of each
// of the QT queries, copy j at (j QT + qq) QW W words: QW times (Int4's
// two halves, each rb bytes of the query; Bf16F's two halves of the
// float32 query, word c of half h meeting the bf16 elements 4 h ... 4 h +
// 3 of row word c) j g zero bytes (Bf16F: j g / 2 zero floats), rb query
// bytes, zeros (lg: log2 g, g = 16 / P, a multiple of the element's bytes). Row
// r's words are the W_r = ceil((p_r + rb) / 16) aligned words from (v + r
// rb) / 16 on (`vw` the 16-byte aligned base below v), met with copy p_r /
// g; a float kind zeroes the bytes of its first and last word that are not
// the row's (`clip_word`). L == 0: the row groups, the mask ballot and the
// warp sums of sweep_topk_kernel. L > 0 (rows of at most 16 words, W <=
// L, a power of two): a warp's 16 rows of a tile in L / 2 steps of 32 / L
// rows, L lanes a row and a word a lane, every step's word loaded before
// the first product, each sum over its L lanes by xor shuffles: at 100
// bytes (7 words a row) the row-group layout kept 7 of 32 lanes loading.
// The keys and the selection are the kind's.
template <class K, int QT, int BUF>
__global__ void __launch_bounds__(SW_THREADS, narrow_ctas_per_sm<K>(QT))
sweep_narrow_kernel(const unsigned char* __restrict__ q,
                    const unsigned char* __restrict__ v,
                    const float* __restrict__ vscale,
                    const uint8_t* __restrict__ mask, const Rows rows,
                    u64* __restrict__ partial, int Q, int rb, int lg, int W,
                    int L, int k) {
  typedef typename K::Acc Acc;
  constexpr bool I4 = std::is_same<K, Int4>::value;
  // K3's kind (Int8R) takes the wide loop bodies below; K6's and K7's the
  // narrow ones (Int4's two planes a word took the registers: 16-24 bytes
  // spilled at QT 2 and 16 with K3's)
  constexpr bool K3_BODY = K::ROW_SCALE && !I4;
  // rows a warp step of the row-group layout: K3's 4 up to QT 2, else 2
  // (each row's own word range and phase copy take the registers a QT 4
  // tile of four rows spilled); K6's and K7's 2, and 1 from QT 8 on
  constexpr int RW = K3_BODY ? (QT <= 2 ? 4 : 2) : QT < 8 ? 2 : 1;
  constexpr int MAX_STEPS = 8;  // L / 2 steps of a packed tile, L <= 16
  // steps whose words a lane loads before their products, and queries
  // summed together: all of them for K3's kind; NARROW_LOADS and NARROW_QG
  // for K6's and K7's, whose smaller loop bodies the compiler otherwise
  // pipelines past the registers (ptxas spilled 16-308 bytes)
  constexpr int LOADS = K3_BODY ? MAX_STEPS : NARROW_LOADS;
  constexpr int QG = K3_BODY || QT <= NARROW_QG ? QT : NARROW_QG;
  constexpr int GROUPS = WARP_ROWS / RW;
  const int P = 16 >> lg;
  const int QS = K::QW * W;  // words of one (phase, query) copy
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* qs = reinterpret_cast<uint4*>(smem);           // P x QT x QS words
  u64* buf = reinterpret_cast<u64*>(qs + P * QT * QS);  // QT x BUF keys
  u64* tau = buf + QT * BUF;
  int* cnt = reinterpret_cast<int*>(tau + QT);
  int* qsum = cnt + QT;  // Int4: each query's int8 sum
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if constexpr (std::is_same<K, Bf16F>::value) {
    // the phase copies of the float32 queries (rb / 2 elements), a float a
    // thread: float f of word c of half h of copy (j, qq) meets the bf16 at
    // byte 2 (4 h + f) of the row's word c, so it is the query's element 8
    // c + 4 h + f - j g / 2 (copy j: j g / 2 zero elements first)
    float* qf = reinterpret_cast<float*>(smem);
    const float* qsrc = reinterpret_cast<const float*>(q);
    const int n = rb / 2, wf = W * 4;
    for (int i = threadIdx.x; i < P * QT * 2 * wf; i += SW_THREADS) {
      const int ch = i / wf, e = i - ch * wf;
      const int h = ch % 2, cq = ch / 2;
      const int j = cq / QT, qq = cq - j * QT;
      const int src = 2 * (e & ~3) + 4 * h + (e & 3) - ((j << lg) >> 1);
      qf[i] = qq < Q && src >= 0 && src < n ? __ldg(qsrc + (long)qq * n + src)
                                            : 0.0f;
    }
  } else {
    // the phase copies, a byte a thread: byte b of half h of copy (j, qq)
    // is byte b - j g of the query's half h (rb bytes each)
    unsigned char* qb = smem;
    const int wb = W * 16;
    for (int i = threadIdx.x; i < P * QT * K::QW * wb; i += SW_THREADS) {
      const int ch = i / wb, b = i - ch * wb;
      const int h = ch % K::QW, cq = ch / K::QW;
      const int j = cq / QT, qq = cq - j * QT;
      const int src = b - (j << lg);
      qb[i] = qq < Q && src >= 0 && src < rb
                  ? q[((long)qq * K::QW + h) * rb + src]
                  : (unsigned char)0;
    }
  }
  if constexpr (I4) {  // warp w sums queries w, w + 8 (2 rb int8 bytes)
    for (int qq = warp; qq < QT; qq += SW_WARPS) {
      int s = 0;
      if (qq < Q)
        for (int b = lane; b < 2 * rb; b += 32)
          s += (int)(signed char)q[(long)qq * 2 * rb + b];
      s = __reduce_add_sync(FULL, s);
      if (lane == 0) qsum[qq] = s;
    }
  }
  if (threadIdx.x < QT) {
    cnt[threadIdx.x] = 0;
    tau[threadIdx.x] = 0ull;
  }
  __syncthreads();

  const uintptr_t vb = (uintptr_t)v;
  const uint4* vw = reinterpret_cast<const uint4*>(vb & ~(uintptr_t)15);
  const long v0 = (long)(vb & 15);  // v's byte in its first word
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  long rbeg, rend;
  rows.range(blockIdx.x, gridDim.x, &rbeg, &rend);
  for (long t0 = rbeg; t0 < rend; t0 += TR) {
    if (L) {  // packed: the warp's rows t0 + 16 warp + [0, 16)
      const long rw0 = t0 + WARP_ROWS * warp;
      const long pw0 = rw0 < rend ? rows.phys(rw0) : 0;  // one tile's rows
      const uint32_t live = __ballot_sync(
          FULL, lane < WARP_ROWS && rw0 + lane < rend && mask[pw0 + lane] != 0);
      const int G = 32 / L, steps = WARP_ROWS / G;
      const int c = lane % L, gi = lane / L;  // the lane's word and row
#pragma unroll
      for (int s0 = 0; s0 < MAX_STEPS; s0 += LOADS) {
        if (s0 >= steps) break;  // uniform
        uint4 x[LOADS];
        float sc[LOADS];
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          x[u] = zero;
          sc[u] = 0.0f;
          const int rr = (s0 + u) * G + gi;
          if (s0 + u < steps && ((live >> rr) & 1u)) {
            const long b0 = v0 + (pw0 + rr) * rb;
            const int ph = (int)(b0 & 15);
            if (c < ((ph + rb + 15) >> 4))
              x[u] = clip_word<K>(__ldg(vw + (b0 >> 4) + c), ph - 16 * c,
                                  ph + rb - 16 * c);
            if constexpr (K::ROW_SCALE) sc[u] = vscale[pw0 + rr];
          }
        }
#pragma unroll
        for (int u = 0; u < LOADS; ++u) {
          if (s0 + u >= steps) break;  // uniform
          const int rr = (s0 + u) * G + gi;
          const int ph = (int)((v0 + (pw0 + rr) * rb) & 15);
          const uint4* cp = qs + (ph >> lg) * QT * QS + c;
          // the queries QG at a time: a group's query words, sums and
          // shuffles stay within the registers
#pragma unroll 1
          for (int g0 = 0; g0 < QT; g0 += QG) {
            Acc acc[QG];
#pragma unroll
            for (int qq = 0; qq < QG; ++qq)
              acc[qq] = c < W ? narrow_dot<K>(x[u], cp + (g0 + qq) * QS, W,
                                              Acc(0))
                              : Acc(0);
            for (int o = L >> 1; o > 0; o >>= 1)
#pragma unroll
              for (int qq = 0; qq < QG; ++qq)
                acc[qq] += __shfl_xor_sync(FULL, acc[qq], o);
            if ((live >> rr) & 1u)
#pragma unroll
              for (int qq = 0; qq < QG; ++qq) {
                const int qi = g0 + qq;
                if (qi % L == c && qi < Q) {
                  const Acc s = I4 ? acc[qq] - 8 * qsum[qi] : acc[qq];
                  const u64 key = narrow_key<K>(s, sc[u], (uint32_t)(pw0 + rr));
                  if (key > tau[qi])
                    buf[qi * BUF + atomicAdd(&cnt[qi], 1)] = key;
                }
              }
          }
        }
      }
    } else {
    uint32_t live;
    {
      const long i = t0 + (lane / RW) * SW_WARPS * RW + warp * RW + lane % RW;
      live = __ballot_sync(FULL, lane < WARP_ROWS && i < rend &&
                                     mask[rows.phys(i)] != 0);
    }
#pragma unroll 1
    for (int g = 0; g < GROUPS; ++g) {
      const uint32_t gl = (live >> (g * RW)) & ((1u << RW) - 1);
      if (!gl) continue;  // uniform: no live row in the group
      const long p0 = rows.phys(t0 + (long)g * SW_WARPS * RW + warp * RW);
      float sc = 0.0f;
      if constexpr (K::ROW_SCALE)
        if ((gl >> (lane % RW)) & 1u) sc = vscale[p0 + lane % RW];
      // each row's first word, its words and its phase copy
      long w0[RW];
      int nw[RW], cw[RW], ph[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const long b0 = v0 + (p0 + r) * rb;
        ph[r] = (int)(b0 & 15);
        w0[r] = b0 >> 4;
        nw[r] = (ph[r] + rb + 15) >> 4;
        cw[r] = (ph[r] >> lg) * QT * QS;
      }
      Acc acc[QT][RW];
#pragma unroll
      for (int qq = 0; qq < QT; ++qq)
#pragma unroll
        for (int r = 0; r < RW; ++r) acc[qq][r] = 0;
      for (int c = lane; c < W; c += 64) {
        uint4 x0[RW], x1[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const bool on = (gl >> r) & 1u;
          x0[r] = on && c < nw[r]
                      ? clip_word<K>(__ldg(vw + w0[r] + c), ph[r] - 16 * c,
                                     ph[r] + rb - 16 * c)
                      : zero;
          x1[r] = on && c + 32 < nw[r]
                      ? clip_word<K>(__ldg(vw + w0[r] + c + 32),
                                     ph[r] - 16 * (c + 32),
                                     ph[r] + rb - 16 * (c + 32))
                      : zero;
        }
        const bool two = c + 32 < W;
#pragma unroll
        for (int qq = 0; qq < QT; ++qq)
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            const uint4* cp = qs + cw[r] + qq * QS + c;
            acc[qq][r] = narrow_dot<K>(x0[r], cp, W, acc[qq][r]);
            if (two) acc[qq][r] = narrow_dot<K>(x1[r], cp + 32, W, acc[qq][r]);
          }
      }
#pragma unroll
      for (int qq = 0; qq < QT; ++qq)
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const Acc s = K::sum(acc[qq][r]);
          if (lane == (qq * RW + r) % 32 && ((gl >> r) & 1u) && qq < Q) {
            const u64 key = narrow_key<K>(I4 ? s - 8 * qsum[qq] : s, sc,
                                          (uint32_t)(p0 + r));
            if (key > tau[qq]) buf[qq * BUF + atomicAdd(&cnt[qq], 1)] = key;
          }
        }
    }
    }
    __syncthreads();
    bool full = false;
#pragma unroll
    for (int s = 0; s < QT; ++s) full |= cnt[s] > BUF - TR;
    __syncthreads();
    if (full) compact_buffers(buf, cnt, tau, QT, BUF, k);
  }
  __syncthreads();
  compact_buffers(buf, cnt, tau, QT, BUF, k);
  for (int i = threadIdx.x; i < QT * k; i += SW_THREADS) {
    const int qq = i / k, j = i % k;
    if (qq < Q)
      partial[((long)qq * gridDim.x + blockIdx.x) * k + j] = buf[qq * BUF + j];
  }
}

// The narrow kind's phases and words for rows of `rb` bytes at v: g the
// largest power of two <= 16 dividing rb and v's base (lg its log2), W =
// ceil((16 - g + rb) / 16) words a copy (the widest phase's), and the
// query block's bytes.
struct Narrow {
  int lg, W;
  __host__ Narrow(int rb, const void* v) {
    lg = 4;
    while (lg > 0 && ((rb | (int)((uintptr_t)v & 15)) & ((1 << lg) - 1))) --lg;
    W = (16 - (1 << lg) + rb + 15) / 16;
  }
  // (qw query copies a phase: Int4's two halves)
  size_t block(int qt, int qw = 1) const {
    return (size_t)(16 >> lg) * qt * qw * W * 16;
  }
  // the whole shared memory: block, buffers, tau and counts (Int4: sums)
  size_t smem(int qt, int qw, int buf) const {
    return block(qt, qw) + (size_t)qt * buf * 8 + qt * 12 +
           (qw == 2 ? qt * 4 : 0);
  }
  // lanes a row of the packed layout: the power of two >= W (at least 2)
  // for rows of at most 16 words, else 0
  int lanes() const {
    if (W > 16) return 0;
    int l = 2;
    while (l < W) l *= 2;
    return l;
  }
};

template <class K, int QT, int BUF>
cudaError_t launch_narrow_qt(const void* q, const void* v, const void* vscale,
                             const void* mask, const Rows& rows, u64* partial,
                             int Q, int rb, const Narrow& nw, int k, int ctas,
                             cudaStream_t stream) {
  const size_t smem = nw.smem(QT, K::QW, BUF);
  const cudaError_t e = cudaFuncSetAttribute(
      sweep_narrow_kernel<K, QT, BUF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  sweep_narrow_kernel<K, QT, BUF><<<ctas, SW_THREADS, smem, stream>>>(
      static_cast<const unsigned char*>(q),
      static_cast<const unsigned char*>(v), static_cast<const float*>(vscale),
      static_cast<const uint8_t*>(mask), rows, partial, Q, rb, nw.lg, nw.W,
      nw.lanes(), k);
  return cudaGetLastError();
}

// The query tile for nq queries: 1, 2, 4, 8 or 16, the smallest >= nq.
__host__ inline int tile_of(int nq) {
  return nq == 1 ? 1 : nq == 2 ? 2 : nq <= 4 ? 4 : nq <= 8 ? 8 : 16;
}

// f(std::integral_constant<int, QT>()) for the tile qt = tile_of(nq), nq
// <= QMAX: only the tiles up to QMAX are instantiated.
template <int QMAX, class F>
cudaError_t with_tile(int qt, F&& f) {
  if (qt == 1) return f(std::integral_constant<int, 1>());
  if (qt == 2) return f(std::integral_constant<int, 2>());
  if constexpr (QMAX <= 4) {
    return f(std::integral_constant<int, 4>());
  } else {
    if (qt == 4) return f(std::integral_constant<int, 4>());
    if constexpr (QMAX <= 8)
      return f(std::integral_constant<int, 8>());
    else
      return qt == 8 ? f(std::integral_constant<int, 8>())
                     : f(std::integral_constant<int, 16>());
  }
}

// The narrow sweep of kind K over rows of rb bytes (Int4: queries of 2 rb
// bytes), BUF slots a query, then the merge of the CTAs' partials into
// vals / idx. The queries go in passes of K::NARROW_QT_MAX (one pass up
// to the kind's limit), each with the query tile sized to its queries and
// its partials at its queries' rows. Refuses (cudaErrorInvalidValue) Q >
// 16, k > BUF - 128, rows or a base off the element's bytes, and a query
// block with buffers above NARROW_SMEM_BYTES.
template <class K, int BUF>
cudaError_t narrow(const void* q, const void* v, const void* vs,
                   const void* mask, const Rows& rows, void* partial,
                   void* vals, void* idx, int Q, int rb, int es, int k,
                   int ctas, cudaStream_t s) {
  constexpr int QMAX = K::NARROW_QT_MAX;
  if (Q > 16 || k > BUF - TR || rb <= 0 || rb % es || (uintptr_t)v % es ||
      ctas <= 0)
    return cudaErrorInvalidValue;
  const Narrow nw(rb, v);
  if (nw.smem(tile_of(std::min(Q, QMAX)), K::QW, BUF) > NARROW_SMEM_BYTES)
    return cudaErrorInvalidValue;
  u64* part = static_cast<u64*>(partial);
  for (int q0 = 0; q0 < Q; q0 += QMAX) {
    const int nq = std::min(QMAX, Q - q0);
    const void* qp =
        static_cast<const unsigned char*>(q) + (size_t)q0 * K::QW * rb;
    u64* pp = part + (size_t)q0 * ctas * k;
    const cudaError_t err = with_tile<QMAX>(tile_of(nq), [&](auto t) {
      return launch_narrow_qt<K, decltype(t)::value, BUF>(
          qp, v, vs, mask, rows, pp, nq, rb, nw, k, ctas, s);
    });
    if (err != cudaSuccess) return err;
  }
  return launch_topk_merge(part, static_cast<float*>(vals),
                           static_cast<int*>(idx), Q, ctas * k, k, s,
                           std::is_same<K, Int8C>::value);
}

template <class K, int QT, int BUF>
cudaError_t launch_qt(const void* q, const void* v, const void* vscale,
                      const void* mask, const Rows& rows, u64* partial, int Q,
                      int cpr, int k, int ctas, cudaStream_t stream) {
  const size_t smem = Sweep<QT>::smem(cpr, K::QW, BUF);
  const cudaError_t e = cudaFuncSetAttribute(
      sweep_topk_kernel<K, QT, BUF>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  sweep_topk_kernel<K, QT, BUF><<<ctas, SW_THREADS, smem, stream>>>(
      static_cast<const uint4*>(q), static_cast<const uint4*>(v),
      static_cast<const float*>(vscale), static_cast<const uint8_t*>(mask),
      rows, partial, Q, cpr, k);
  return cudaGetLastError();
}

// The sweep of kind K, then the merge of the CTAs' partials into vals /
// idx. The queries go in passes of K::QT_MAX (one pass up to the kind's
// limit), each with the query tile sized to its queries and its partials
// at its queries' rows. Refuses (cudaErrorInvalidValue) what the sweep
// does not take: Q > 16, k > K::K_MAX, rows that are not whole 16-byte
// words, misaligned q or v, a query block above QBLOCK_BYTES.
template <class K>
cudaError_t sweep(const void* q, const void* v, const void* vscale,
                  const void* mask, const Rows& rows, void* partial,
                  void* vals, void* idx, int Q, int dim, int k, int ctas,
                  cudaStream_t s) {
  constexpr int QMAX = K::QT_MAX;
  if (Q > 16 || k > K::K_MAX || ctas <= 0 || dim <= 0 || dim % K::EPW ||
      ((uintptr_t)q | (uintptr_t)v) % 16)
    return cudaErrorInvalidValue;
  const int cpr = dim / K::EPW;
  if ((long)tile_of(std::min(Q, QMAX)) * K::QW * cpr * 16 > QBLOCK_BYTES)
    return cudaErrorInvalidValue;
  u64* part = static_cast<u64*>(partial);
  for (int q0 = 0; q0 < Q; q0 += QMAX) {
    const int nq = std::min(QMAX, Q - q0);
    const void* qp =
        static_cast<const uint4*>(q) + (size_t)q0 * K::QW * cpr;
    u64* pp = part + (size_t)q0 * ctas * k;
    const cudaError_t err = with_tile<QMAX>(tile_of(nq), [&](auto t) {
      constexpr int QT = decltype(t)::value;
      if constexpr (K::K_MAX > 128)
        if (k > 128)
          return launch_qt<K, QT, BUF_K384>(qp, v, vscale, mask, rows, pp, nq,
                                            cpr, k, ctas, s);
      return launch_qt<K, QT, BUF_K128>(qp, v, vscale, mask, rows, pp, nq,
                                        cpr, k, ctas, s);
    });
    if (err != cudaSuccess) return err;
  }
  return launch_topk_merge(part, static_cast<float*>(vals),
                           static_cast<int*>(idx), Q, ctas * k, k, s,
                           std::is_same<K, Int8C>::value);
}

}  // namespace
}  // namespace pv

// K9 on the one-query sweep: q (Q, dim) folded int8 queries, v (cap, dim)
// column-scaled int8 rows, mask (cap,) uint8; Q <= 16, k <= 128,
// dim % 16 == 0 with the query block (QT x dim bytes) <= 64 KB, 16-byte
// aligned q and v. CTA c reads rows [c * chunk, min(cap, (c + 1) * chunk))
// (chunk % 128 == 0; max(1, ceil(cap / chunk)) CTAs); `partial` is scratch
// of that many * Q * k uint64; vals (Q, k) float32 (the int32 sums) and
// idx (Q, k) int32 receive the result (-inf / 0 where empty). Returns the
// cudaError_t of the launches.
extern "C" int pv_sweep_topk_i8c(const void* q, const void* v,
                                 const void* mask, void* partial, void* vals,
                                 void* idx, int Q, long long cap, int dim,
                                 int k, long long chunk, void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (cap < 0 || chunk <= 0 || chunk % SEG) return (int)cudaErrorInvalidValue;
  const long long n = (cap + chunk - 1) / chunk;
  const Rows rows{nullptr, nullptr, (long)cap, (long)chunk, 0, 0};
  return (int)sweep<Int8C>(q, v, nullptr, mask, rows, partial, vals, idx, Q,
                           dim, k, n > 1 ? (int)n : 1, (cudaStream_t)stream);
}

// K9's narrow kind on the one-query sweep: q (Q, dim) folded int8 queries
// (any base), v (cap, dim) column-scaled int8 rows at any width and base,
// mask (cap,) uint8; Q <= 16, k <= 128, and the query block (P phase
// copies of the QT queries, W words each: ops/scan.py::narrow_block_bytes)
// with the buffers within NARROW_SMEM_BYTES. `sweep_narrow_kernel<Int8C>`,
// K7's instantiation, over K9's flat ranges: CTA c reads rows [c * chunk,
// min(cap, (c + 1) * chunk)) (chunk % 128 == 0); `partial` is scratch of
// max(1, ceil(cap / chunk)) * Q * k uint64; vals (Q, k) float32 (the int32
// sums) and idx (Q, k) int32 receive the result (-inf / 0 where empty).
// Returns the cudaError_t of the launches.
extern "C" int pv_sweep_topk_i8c_narrow(const void* q, const void* v,
                                        const void* mask, void* partial,
                                        void* vals, void* idx, int Q,
                                        long long cap, int dim, int k,
                                        long long chunk, void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (cap < 0 || chunk <= 0 || chunk % SEG || k > Int8C::K_MAX)
    return (int)cudaErrorInvalidValue;
  const long long n = (cap + chunk - 1) / chunk;
  const Rows rows{nullptr, nullptr, (long)cap, (long)chunk, 0, 0};
  return (int)narrow<Int8C, BUF_K128>(q, v, nullptr, mask, rows, partial,
                                      vals, idx, Q, dim, 1, k,
                                      n > 1 ? (int)n : 1,
                                      (cudaStream_t)stream);
}

// K6 on the one-query sweep: q (Q, dim) int8 queries, v (cap, dim / 2)
// packed int4 rows (the two-plane nibble layout), vscale (cap,) float32,
// mask (cap,) uint8; Q <= 16, k <= 128, dim % 32 == 0 with the query block
// (QT x dim bytes) <= 64 KB, 16-byte aligned q and v. Rows as K9's: CTA c
// reads [c * chunk, min(cap, (c + 1) * chunk)) (chunk % 128 == 0);
// `partial` is scratch of max(1, ceil(cap / chunk)) * Q * k uint64; vals
// (Q, k) float32 (the scaled scores) and idx (Q, k) int32 receive the
// result (-inf / 0 where empty). Returns the cudaError_t of the launches.
extern "C" int pv_sweep_topk_i4(const void* q, const void* v,
                                const void* vscale, const void* mask,
                                void* partial, void* vals, void* idx, int Q,
                                long long cap, int dim, int k,
                                long long chunk, void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (cap < 0 || chunk <= 0 || chunk % SEG || !vscale)
    return (int)cudaErrorInvalidValue;
  const long long n = (cap + chunk - 1) / chunk;
  const Rows rows{nullptr, nullptr, (long)cap, (long)chunk, 0, 0};
  return (int)sweep<Int4>(q, v, vscale, mask, rows, partial, vals, idx, Q,
                          dim, k, n > 1 ? (int)n : 1, (cudaStream_t)stream);
}

// K3 on the one-query sweep: q (Q, dim) int8 queries, v (cap, dim) int8
// rows, vscale (cap,) float32 row scales, mask (cap,) uint8; Q <= 16,
// k <= 384, dim % 16 == 0 with the query block (QT x dim bytes) <= 64 KB,
// 16-byte aligned q and v. Rows as K9's: CTA c reads [c * chunk,
// min(cap, (c + 1) * chunk)) (chunk % 128 == 0); `partial` is scratch of
// max(1, ceil(cap / chunk)) * Q * k uint64; vals (Q, k) float32 (the
// scaled scores) and idx (Q, k) int32 receive the result (-inf / 0 where
// empty). Returns the cudaError_t of the launches.
extern "C" int pv_sweep_topk_i8(const void* q, const void* v,
                                const void* vscale, const void* mask,
                                void* partial, void* vals, void* idx, int Q,
                                long long cap, int dim, int k,
                                long long chunk, void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (cap < 0 || chunk <= 0 || chunk % SEG || !vscale)
    return (int)cudaErrorInvalidValue;
  const long long n = (cap + chunk - 1) / chunk;
  const Rows rows{nullptr, nullptr, (long)cap, (long)chunk, 0, 0};
  return (int)sweep<Int8R>(q, v, vscale, mask, rows, partial, vals, idx, Q,
                           dim, k, n > 1 ? (int)n : 1, (cudaStream_t)stream);
}

// K3's narrow kind on the one-query sweep: q (Q, dim) int8 queries (any
// base), v (cap, dim) int8 rows at any width and base, vscale (cap,)
// float32, mask (cap,) uint8; Q <= 16, k <= 384, and the query block (P
// phase copies of the QT queries, W words each: ops/scan.py::
// narrow_block_bytes) with the buffers within NARROW_SMEM_BYTES. Rows as
// K9's: CTA c reads [c * chunk, min(cap, (c + 1) * chunk)) (chunk % 128 ==
// 0); `partial` is scratch of max(1, ceil(cap / chunk)) * Q * k uint64;
// vals (Q, k) float32 (the scaled scores) and idx (Q, k) int32 receive the
// result (-inf / 0 where empty). Returns the cudaError_t of the launches.
extern "C" int pv_sweep_topk_i8_narrow(const void* q, const void* v,
                                       const void* vscale, const void* mask,
                                       void* partial, void* vals, void* idx,
                                       int Q, long long cap, int dim, int k,
                                       long long chunk, void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (cap < 0 || chunk <= 0 || chunk % SEG || !vscale || k > Int8R::K_MAX)
    return (int)cudaErrorInvalidValue;
  const long long n = (cap + chunk - 1) / chunk;
  const int ctas = n > 1 ? (int)n : 1;
  const Rows rows{nullptr, nullptr, (long)cap, (long)chunk, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(k <= 128 ? narrow<Int8R, BUF_K128>(q, v, vscale, mask, rows,
                                                  partial, vals, idx, Q, dim,
                                                  1, k, ctas, s)
                        : narrow<Int8R, BUF_K384>(q, v, vscale, mask, rows,
                                                  partial, vals, idx, Q, dim,
                                                  1, k, ctas, s));
}

// K6's narrow kind on the one-query sweep: q (Q, dim) int8 queries (any
// base), v (cap, dim / 2) packed int4 rows at any even width and base,
// vscale (cap,) float32, mask (cap,) uint8; Q <= 16, k <= 128, and the
// query block (P phase copies of both halves of the QT queries, W words
// each: ops/scan.py::i4_narrow_bytes) with the buffers within
// NARROW_SMEM_BYTES. Rows as K9's: CTA c reads [c * chunk, min(cap, (c +
// 1) * chunk)) (chunk % 128 == 0); `partial` is scratch of max(1, ceil(cap
// / chunk)) * Q * k uint64; vals (Q, k) float32 (the scaled scores) and
// idx (Q, k) int32 receive the result (-inf / 0 where empty). Returns the
// cudaError_t of the launches.
extern "C" int pv_sweep_topk_i4_narrow(const void* q, const void* v,
                                       const void* vscale, const void* mask,
                                       void* partial, void* vals, void* idx,
                                       int Q, long long cap, int dim, int k,
                                       long long chunk, void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (cap < 0 || chunk <= 0 || chunk % SEG || !vscale || k > Int4::K_MAX ||
      dim <= 0 || dim % 2)
    return (int)cudaErrorInvalidValue;
  const long long n = (cap + chunk - 1) / chunk;
  const Rows rows{nullptr, nullptr, (long)cap, (long)chunk, 0, 0};
  return (int)narrow<Int4, BUF_K128>(q, v, vscale, mask, rows, partial, vals,
                                     idx, Q, dim / 2, 1, k, n > 1 ? (int)n : 1,
                                     (cudaStream_t)stream);
}

// K7 on the one-query sweep. kind 0: postings and q float32; 1: both
// bfloat16; 2: column-scaled int8 postings and folded int8 q (raw int32
// scores; vals carry them as float32). postings (cap, dim) with
// cap % bn == 0 and bn % 16 == 0, mask (cap,) uint8, hot (grid_b,) int32
// tile ids in [0, cap / bn), n_hot (1,) int32 on the device (steps b >=
// n_hot are dead); Q <= 16, k <= 128, rows of 16-byte words with the query
// block (QT x dim elements) <= 64 KB, 16-byte aligned q and postings.
// `ctas` CTAs share the live rows (ops/ivf.py::ivf_sweep_partition);
// `partial` is scratch of Q * ctas * k uint64; vals (Q, k) float32 and idx
// (Q, k) int32 receive the result (-inf / 0 where empty). Returns the
// cudaError_t of the launches.
extern "C" int pv_ivf_sweep_topk(int kind, const void* q, const void* v,
                                 const void* mask, const void* hot,
                                 const void* n_hot, void* partial, void* vals,
                                 void* idx, int Q, long long cap, int dim,
                                 int k, int bn, int grid_b, int ctas,
                                 void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (bn <= 0 || bn % SHARE || grid_b <= 0 || cap % bn)
    return (int)cudaErrorInvalidValue;
  const Rows rows{static_cast<const int*>(hot), static_cast<const int*>(n_hot),
                  (long)cap, 0, bn, grid_b};
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    return (int)sweep<F32>(q, v, nullptr, mask, rows, partial, vals, idx, Q, dim, k,
                           ctas, s);
  if (kind == 1)
    return (int)sweep<Bf16>(q, v, nullptr, mask, rows, partial, vals, idx, Q, dim, k,
                            ctas, s);
  if (kind == 2)
    return (int)sweep<Int8C>(q, v, nullptr, mask, rows, partial, vals, idx, Q, dim, k,
                             ctas, s);
  return (int)cudaErrorInvalidValue;
}

// K7 on the narrow sweep: pv_ivf_sweep_topk's contract at every postings
// width and base (kind 0: float32 postings and q; 1: both bfloat16; 2:
// column-scaled int8 postings and folded int8 q, raw int32 scores), q at
// any base, the query block of phase copies (ops/ivf.py::ivf_narrow_ready:
// ops/scan.py::narrow_block_bytes over the row bytes) with the buffers
// within NARROW_SMEM_BYTES; Q <= 16, k <= 128. `ctas` CTAs share the live
// rows (ops/ivf.py::ivf_sweep_partition); `partial` is scratch of Q *
// ctas * k uint64; vals (Q, k) float32 and idx (Q, k) int32 receive the
// result (-inf / 0 where empty). Returns the cudaError_t of the launches.
extern "C" int pv_ivf_sweep_topk_narrow(int kind, const void* q,
                                        const void* v, const void* mask,
                                        const void* hot, const void* n_hot,
                                        void* partial, void* vals, void* idx,
                                        int Q, long long cap, int dim, int k,
                                        int bn, int grid_b, int ctas,
                                        void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (bn <= 0 || bn % SHARE || grid_b <= 0 || cap % bn || dim <= 0 ||
      kind < 0 || kind > 2 || k > 128)
    return (int)cudaErrorInvalidValue;
  const Rows rows{static_cast<const int*>(hot), static_cast<const int*>(n_hot),
                  (long)cap, 0, bn, grid_b};
  cudaStream_t s = (cudaStream_t)stream;
  const int es = kind == 0 ? 4 : kind == 1 ? 2 : 1;
  if (kind == 0)
    return (int)narrow<F32, BUF_K128>(q, v, nullptr, mask, rows, partial,
                                      vals, idx, Q, dim * es, es, k, ctas, s);
  if (kind == 1)
    return (int)narrow<Bf16, BUF_K128>(q, v, nullptr, mask, rows, partial,
                                       vals, idx, Q, dim * es, es, k, ctas, s);
  return (int)narrow<Int8C, BUF_K128>(q, v, nullptr, mask, rows, partial,
                                      vals, idx, Q, dim * es, es, k, ctas, s);
}

// K4 on the one-query sweep. kind 0: float32 rows (`F32`); 1: bf16 rows
// (`Bf16F`); the queries float32 in both. q (Q, dim), v (cap, dim), mask
// (cap,) uint8; Q <= 16, k <= 128, rows of 16-byte words (dim % 4 == 0 /
// dim % 8 == 0) with the query block (QT x dim floats) <= 64 KB, 16-byte
// aligned q and v. Rows as K9's: CTA c reads [c * chunk, min(cap, (c + 1)
// * chunk)) (chunk % 128 == 0); `partial` is scratch of max(1, ceil(cap /
// chunk)) * Q * k uint64; vals (Q, k) float32 and idx (Q, k) int32 receive
// the result (-inf / 0 where empty). Returns the cudaError_t of the
// launches.
extern "C" int pv_sweep_topk_f32(int kind, const void* q, const void* v,
                                 const void* mask, void* partial, void* vals,
                                 void* idx, int Q, long long cap, int dim,
                                 int k, long long chunk, void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (cap < 0 || chunk <= 0 || chunk % SEG || kind < 0 || kind > 1)
    return (int)cudaErrorInvalidValue;
  const long long n = (cap + chunk - 1) / chunk;
  const int ctas = n > 1 ? (int)n : 1;
  const Rows rows{nullptr, nullptr, (long)cap, (long)chunk, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    return (int)sweep<F32>(q, v, nullptr, mask, rows, partial, vals, idx, Q,
                           dim, k, ctas, s);
  return (int)sweep<Bf16F>(q, v, nullptr, mask, rows, partial, vals, idx, Q,
                           dim, k, ctas, s);
}

// K4's narrow kind on the one-query sweep: pv_sweep_topk_f32's contract
// over rows at any width and base (kind 0: float32 rows, 1: bf16 rows;
// float32 queries at any 4-byte aligned base), the query block of phase
// copies (ops/scan.py::topk_narrow_bytes) with the buffers within
// NARROW_SMEM_BYTES; Q <= 16, k <= 128. Rows as K9's; `partial` is scratch
// of max(1, ceil(cap / chunk)) * Q * k uint64. Returns the cudaError_t of
// the launches.
extern "C" int pv_sweep_topk_f32_narrow(int kind, const void* q,
                                        const void* v, const void* mask,
                                        void* partial, void* vals, void* idx,
                                        int Q, long long cap, int dim, int k,
                                        long long chunk, void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (cap < 0 || chunk <= 0 || chunk % SEG || kind < 0 || kind > 1 ||
      dim <= 0 || k > 128 || (uintptr_t)q % 4)
    return (int)cudaErrorInvalidValue;
  const long long n = (cap + chunk - 1) / chunk;
  const int ctas = n > 1 ? (int)n : 1;
  const Rows rows{nullptr, nullptr, (long)cap, (long)chunk, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    return (int)narrow<F32, BUF_K128>(q, v, nullptr, mask, rows, partial,
                                      vals, idx, Q, dim * 4, 4, k, ctas, s);
  return (int)narrow<Bf16F, BUF_K128>(q, v, nullptr, mask, rows, partial,
                                      vals, idx, Q, dim * 2, 2, k, ctas, s);
}
