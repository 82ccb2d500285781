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
//  * The kernel and its launcher live in scan_topk_wgmma.cuh, where K7's
//    tensor-core scan (ivf_scan_wgmma.cu) runs them over an IVF hot-tile
//    table.

#include "scan_topk_wgmma.cuh"

namespace pv {

// The wide kind's pass A (topk_wide.cu): the scan with the slab epilogue
// (BUF 0) and four stages, N = 32 queries a CTA at Q <= 32 (half the
// operand reads and products of N = 64, whose tile would be at least half
// empty), else 64. kind 0: float32 rows, planes hi and lo; 1: bf16 rows,
// three bf16 planes; `plane` bytes apart.
int launch_scan_slab(int kind, const void* planes, size_t plane,
                     const void* v, const void* mask, uint32_t* slab, int Q,
                     long long cap, int dim, cudaStream_t stream) {
  using namespace tk;
  const Rows flat{};  // the rows [0, cap)
  int r = 0;
  if (kind == 0)
    return Q <= 32 ? launch_scan<F32, 32, 4, 0>(planes, plane, v, mask, nullptr,
                                                slab, Q, cap, dim, 0, flat, &r,
                                                stream)
                   : launch_scan<F32, 64, 4, 0>(planes, plane, v, mask, nullptr,
                                                slab, Q, cap, dim, 0, flat, &r,
                                                stream);
  if (kind == 1)
    return Q <= 32 ? launch_scan<Bf16, 32, 4, 0>(planes, plane, v, mask,
                                                 nullptr, slab, Q, cap, dim, 0,
                                                 flat, &r, stream)
                   : launch_scan<Bf16, 64, 4, 0>(planes, plane, v, mask,
                                                 nullptr, slab, Q, cap, dim, 0,
                                                 flat, &r, stream);
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
  const Rows flat{};  // the rows [0, cap)
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (k > 128 || cap < 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0)
    return k <= 32   ? launch<F32, 64, 3, 64>(planes, v, mask, nullptr, partial,
                                              vals, idx, Q, cap, dim, k, flat, s)
           : k <= 64 ? launch<F32, 64, 3, 128>(planes, v, mask, nullptr,
                                               partial, vals, idx, Q, cap, dim,
                                               k, flat, s)
                     : launch<F32, 64, 2, 256>(planes, v, mask, nullptr,
                                               partial, vals, idx, Q, cap, dim,
                                               k, flat, s);
  if (kind == 1)
    return k <= 32   ? launch<Bf16, 64, 3, 64>(planes, v, mask, nullptr,
                                               partial, vals, idx, Q, cap, dim,
                                               k, flat, s)
           : k <= 64 ? launch<Bf16, 64, 3, 128>(planes, v, mask, nullptr,
                                                partial, vals, idx, Q, cap,
                                                dim, k, flat, s)
                     : launch<Bf16, 64, 2, 256>(planes, v, mask, nullptr,
                                                partial, vals, idx, Q, cap,
                                                dim, k, flat, s);
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
  const Rows flat{};  // the rows [0, cap)
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (k > 384 || cap < 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* vs = static_cast<const float*>(vscale);
  return k <= 32    ? launch<Int8R, 64, 4, 64>(q, v, mask, vs, partial, vals,
                                               idx, Q, cap, dim, k, flat, s)
         : k <= 64  ? launch<Int8R, 64, 4, 128>(q, v, mask, vs, partial, vals,
                                                idx, Q, cap, dim, k, flat, s)
         : k <= 128 ? launch<Int8R, 64, 3, 256>(q, v, mask, vs, partial, vals,
                                                idx, Q, cap, dim, k, flat, s)
                    : launch<Int8R, 32, 4, 512>(q, v, mask, vs, partial, vals,
                                                idx, Q, cap, dim, k, flat, s);
}