// K4 fused_topk, K3 fused_topk_i8 and K9 fused_topk_i8c on Hopper's
// tensor cores: exact masked top-k over float32 or bfloat16 rows against
// float32 queries (K4), over int8 rows times their float32 scales against
// int8 queries (K3), or over column-scaled int8 rows against folded int8
// queries ranked on the exact int32 sum (K9, `Int8C`: K3's scan with no
// row scale, K7's key), reading only the 128-row segments that hold a live
// row.
//
// Replaces picovdb_tpu/ops/pallas_scan.py:fused_topk (`_scan_kernel`)
// at k <= 128 (ops/scan.py::topk_wgmma_ready), and pallas_scan.py:
// fused_topk_i8 (`_scan_kernel_i8`) at k <= 384 where the one-query
// sweeps do not serve (ops/scan.py::i8_wgmma_ready), and pallas_scan.py:
// fused_topk_i8c (`_scan_kernel_i8c`) at k <= 128 where neither of K9's
// sweeps serves (ops/scan.py::i8c_wgmma_ready: Q past their limits, widths
// past the 16-byte sweep's query block), at every row width and base:
// rows TMA cannot read (bytes not whole 16, or a base off 16 bytes: the
// glove-100 / -25 widths, odd bf16 mirrors, views) arrive by the
// mainloop's cp.async or realigning producer (scan_topk_wgmma.cuh,
// `PIECE`), where the template scan_topk.cu served them before. K4 at
// 128 < k <= 1024 runs topk_wide.cu, K3 and K9 past k 128
// topk_i8_wide.cu, whose pass A is this scan with a slab epilogue (BUF 0:
// every live segment's keys written, nothing selected here). It computes
// pv_scan_topk's kinds 0, 1, 2 and 4: per query the k best masked rows by
// the float32 score (q . v; for int8 rows float32(int32 q . v) *
// vscale[row], one conversion and one multiply; K9 the int32 sum itself),
// as (Q, k) float32 scores (-inf where a slot is empty) and (Q, k) int32
// rows (0 where empty), ties to the lower row.
//
// What bounds it on the H100: float32 rows run three TF32 products (2 Q
// cap dim operations each at 495 T/s: 6.4 ms at Q = 256 over 2M x 1024
// rows, above their 8 GB at 3.35 TB/s, 2.4 ms); bf16 rows at the route's
// Q = 64 are bound by their bytes (1M x 1024: 0.61 ms; three bf16 products
// 0.40 ms), and under a sparse filter by the bytes of the segments that
// hold a live row. int8 rows at the host-rescore route's Q = 64 are bound
// by their bytes (1M x 1024: 0.307 ms; the s8 product 0.07 ms). A narrow
// row costs its k-stages whole: a 100-byte int8 row is one 128-byte stage,
// 28 of its bytes zero. The
// templates it replaces scored with CUDA-core FMAs through unpipelined
// shared-memory tiles, re-read the corpus once per query tile (16 queries,
// 2 at k > 128) and read every row whatever the mask.
//
// Design:
//  * Rows as M, queries as N (64; 32 for the int8 kind at k > 128). A
//    128-row segment is two m64 tiles, one per consumer warpgroup; both
//    operands are K-major and fill a ring of S 128-byte k-stages,
//    128B-swizzled (32 float32, 64 bf16 or 128 int8 elements), behind
//    full / empty mbarriers. The query planes arrive by TMA (the launcher
//    pads them to whole 16-byte rows where the queries are not); the rows
//    by TMA from one producer warp's lane 0 where TMA reads them, else by
//    a producer warpgroup's cp.async or realigning producer
//    (scan_topk_wgmma.cuh), which writes the bytes TMA would.
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
//    take 256 KB of buffers alone). The realigning producer adds two 18 KB
//    staging slots: K4's bf16 rows past k 64 then run 32 queries a CTA and
//    four stages (<Bf16, 32, 4, 256>: 213 KB; 64 queries and two stages
//    would take 246 KB), K3's two stages past k 64 (<64, 2, 256>: 214 KB;
//    <32, 2, 512>: 205 KB). One CTA an SM.
//  * The kernel and its launcher live in scan_topk_wgmma.cuh, where K7's
//    tensor-core scan (ivf_scan_wgmma.cu) runs them over an IVF hot-tile
//    table.

#include "scan_topk_wgmma.cuh"

namespace pv {
namespace {

// K4's configurations at k with the rows' producer PIECE: three stages and
// BUF 64 / 128 to k 64, then two stages and BUF 256; the realigning
// producer's slots leave no room for 64 queries' buffers of 256 keys, so
// past k 64 it runs 32 queries a CTA and four stages (ops/scan.py::
// topk_wgmma_qtile).
template <class T, int PIECE>
int k4(const void* planes, int qld, const void* v, const void* mask,
       void* partial, void* vals, void* idx, int Q, long long cap, int dim,
       int k, cudaStream_t s) {
  using namespace tk;
  const Rows flat{};  // the rows [0, cap)
  if (k <= 32)
    return launch_rows<T, 64, 3, 64, PIECE>(planes, qld, v, mask, nullptr,
                                             partial, vals, idx, Q, cap, dim,
                                             k, flat, s);
  if (k <= 64)
    return launch_rows<T, 64, 3, 128, PIECE>(planes, qld, v, mask, nullptr,
                                              partial, vals, idx, Q, cap, dim,
                                              k, flat, s);
  constexpr bool RA = PIECE == 2;
  return launch_rows<T, RA ? 32 : 64, RA ? 4 : 2, 256, PIECE>(
      planes, qld, v, mask, nullptr, partial, vals, idx, Q, cap, dim, k, flat,
      s);
}

// K3's configurations at k with the rows' producer PIECE: four stages and
// BUF 64 / 128 to k 64, three and BUF 256 to k 128, then 32 queries a CTA,
// four stages and BUF 512; two stages past k 64 beside the realigning
// producer's slots. T: `Int8R` (K3, `vs` the row scales) or `Int8C` (K9,
// no scale, up to k 128: its wide kind takes k past it).
template <class T, int PIECE>
int k3(const void* q, int qld, const void* v, const float* vs,
       const void* mask, void* partial, void* vals, void* idx, int Q,
       long long cap, int dim, int k, cudaStream_t s) {
  using namespace tk;
  const Rows flat{};  // the rows [0, cap)
  constexpr bool RA = PIECE == 2;
  if (k <= 32)
    return launch_rows<T, 64, 4, 64, PIECE>(q, qld, v, mask, vs, partial,
                                             vals, idx, Q, cap, dim, k, flat,
                                             s);
  if (k <= 64)
    return launch_rows<T, 64, 4, 128, PIECE>(q, qld, v, mask, vs, partial,
                                              vals, idx, Q, cap, dim, k, flat,
                                              s);
  if (k <= 128)
    return launch_rows<T, 64, RA ? 2 : 3, 256, PIECE>(
        q, qld, v, mask, vs, partial, vals, idx, Q, cap, dim, k, flat, s);
  if constexpr (T::SCALED)
    return launch_rows<T, 32, RA ? 2 : 4, 512, PIECE>(
        q, qld, v, mask, vs, partial, vals, idx, Q, cap, dim, k, flat, s);
  else
    return (int)cudaErrorInvalidValue;
}

// The int8 kinds' queries, padded where TMA cannot read them as they lie
// (`tk::tma_queries`, at the head of `scratch`), then k3<T> with the
// partials after them.
template <class T>
int int8_scan(int piece, const void* q, const void* v, const float* vs,
              const void* mask, void* scratch, void* vals, void* idx, int Q,
              long long cap, int dim, int k, cudaStream_t s) {
  const int qld = tk::plane_ld(dim, 1);
  unsigned char* qp = static_cast<unsigned char*>(scratch);
  void* partial = qp + ((size_t)Q * qld + 255) / 256 * 256;
  const cudaError_t e = tk::tma_queries(&q, qp, Q, dim, s);
  if (e != cudaSuccess) return (int)e;
  const int ld = q == qp ? qld : dim;  // q's rows as TMA reads them
  return tk::with_piece(piece, [&](auto p) {
    return k3<T, decltype(p)::value>(q, ld, v, vs, mask, partial, vals, idx,
                                     Q, cap, dim, k, s);
  });
}

}  // namespace
}  // namespace pv

// K4 on the tensor cores: pv_scan_topk's kinds 0 and 1 for k <= 128.
// piece: the rows' producer (ops/scan.py::rows_piece): 0 TMA (row bytes
// and v's base multiples of 16), 8 or 4 cp.async (multiples of piece), 2
// the realigning producer (kind 1 only, any width and base). kind 0: v
// (cap, dim) float32 and `planes` (2, Q, qld) float32, the queries' hi and
// lo (ops/scan.py::split_tf32); 1: v bfloat16 and `planes` (3, Q, qld)
// bfloat16, the queries' three bf16 planes (ops/scan.py::split_bf16); qld
// = dim rounded up to whole 16 bytes, zeros past dim, `planes` 16-byte
// aligned. mask (cap,) uint8. The grid is q_tiles = ceil(Q / N) query
// tiles (N = ops/scan.py::topk_wgmma_qtile) x `ranges` = max(1,
// min(ceil(cap / 128), SMs / q_tiles)) segment ranges (ops/scan.py::
// topk_wgmma_partition); `partial` is scratch of Q * ranges * k uint64;
// vals (Q, k) float32 and idx (Q, k) int32 receive the result (-inf / 0
// where empty). Launches on the current device. Returns 0, a cudaError_t,
// or minus the CUresult of a refused tensor-map encode.
extern "C" int pv_scan_topk_wgmma(int piece, int kind, const void* planes,
                                  const void* v, const void* mask,
                                  void* partial, void* vals, void* idx, int Q,
                                  long long cap, int dim, int k,
                                  void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (k > 128 || cap < 0 || dim <= 0 || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int qld = tk::plane_ld(dim, kind == 0 ? 4 : 2);
  return tk::with_piece(piece, [&](auto p) {
    constexpr int P = decltype(p)::value;
    if (kind == 1)
      return k4<tk::Bf16, P>(planes, qld, v, mask, partial, vals, idx, Q, cap,
                             dim, k, s);
    if constexpr (P == 2)  // float32 rows are whole 4 bytes
      return (int)cudaErrorInvalidValue;
    else
      return k4<tk::F32, P>(planes, qld, v, mask, partial, vals, idx, Q, cap,
                            dim, k, s);
  });
}

// K3 on the tensor cores: pv_scan_topk's kind 2 for k <= 384. piece: the
// rows' producer, as pv_scan_topk_wgmma's (2: any int8 width and base). q
// (Q, dim) int8 queries (any base), v (cap, dim) int8, vscale (cap,)
// float32, mask (cap,) uint8. `scratch` (256-byte aligned) holds the
// queries as TMA reads them where q's rows are not (whole 16 bytes at a
// 16-byte aligned base): ceil(Q qld / 256) x 256 bytes, qld = dim rounded
// up to 16 (`tk::tma_queries`); then the partial results, Q * ranges * k
// uint64. The grid is q_tiles = ceil(Q / N) query tiles (N = 64 for k <=
// 128, else 32) x `ranges` = max(1, min(ceil(cap / 128), SMs / q_tiles))
// segment ranges (ops/scan.py::i8_wgmma_partition); vals (Q, k) float32
// and idx (Q, k) int32 receive the result (-inf / 0 where empty). Launches
// on the current device. Returns 0, a cudaError_t, or minus the CUresult
// of a refused tensor-map encode.
extern "C" int pv_scan_topk_i8_wgmma(int piece, const void* q, const void* v,
                                     const void* vscale, const void* mask,
                                     void* scratch, void* vals, void* idx,
                                     int Q, long long cap, int dim, int k,
                                     void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (k > 384 || cap < 0 || dim <= 0 || !vscale || (uintptr_t)scratch % 256)
    return (int)cudaErrorInvalidValue;
  return int8_scan<tk::Int8R>(piece, q, v, static_cast<const float*>(vscale),
                             mask, scratch, vals, idx, Q, cap, dim, k,
                             (cudaStream_t)stream);
}

// K9 on the tensor cores: pv_scan_topk's kind 4 for k <= 128, K3's scan
// at `Int8C` (no row scale: the exact int32 sum ranks, int_row_key, ties
// to the lower row; vals carry the sums as float32). piece: the rows'
// producer, as pv_scan_topk_i8_wgmma's (2: any int8 width and base). q
// (Q, dim) folded int8 queries (any base), v (cap, dim) column-scaled int8
// rows, mask (cap,) uint8. `scratch` as pv_scan_topk_i8_wgmma's: the
// queries as TMA reads them, ceil(Q qld / 256) x 256 bytes, then Q *
// ranges * k uint64 partials. The grid is ceil(Q / 64) query tiles x
// `ranges` segment ranges (ops/scan.py::i8_wgmma_partition). Launches on
// the current device. Returns 0, a cudaError_t, or minus the CUresult of
// a refused tensor-map encode.
extern "C" int pv_scan_topk_i8c_wgmma(int piece, const void* q, const void* v,
                                      const void* mask, void* scratch,
                                      void* vals, void* idx, int Q,
                                      long long cap, int dim, int k,
                                      void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (k > 128 || cap < 0 || dim <= 0 || (uintptr_t)scratch % 256)
    return (int)cudaErrorInvalidValue;
  return int8_scan<tk::Int8C>(piece, q, v, nullptr, mask, scratch, vals, idx,
                              Q, cap, dim, k, (cudaStream_t)stream);
}
