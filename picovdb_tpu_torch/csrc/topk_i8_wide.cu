// K3 fused_topk_i8 and K9 fused_topk_i8c at 128 < k <= 1024 (the wide
// kinds): K3's tensor-core scan writing every live row's sortable score
// key to a slab, then the per-query radix select over the slab.
//
// K9's (`pv_scan_topk_i8c_wide`) replaces picovdb_tpu/ops/pallas_scan.py:
// fused_topk_i8c (`_scan_kernel_i8c`) past k_sel 128 at every width and
// base up to 64M rows (ops/scan.py::i8c_wide_ready; the template, kind 4,
// served it): pass A is the scan at `Int8C` (no row scale, the slab key
// the sign-flipped int32 sum, as K7's wide kind over int8 postings,
// ivf_scan_wide.cu), the finish decodes the keys to the sums. Below,
// K3's.
//
// Replaces picovdb_tpu/ops/pallas_scan.py:fused_topk_i8 (`_scan_kernel_i8`)
// past k_sel 128 (ops/scan.py::i8_wide_ready), at every int8 width and
// base (rows TMA cannot read by cp.async or the realigning producer, the
// queries padded to whole 16 bytes where they are not): the int8 store's
// host-rescore band k + RESCORE_GUARD + 4 (142 at top_k = 10, 432 at 300),
// at every batch size past k_sel 384. Up to k_sel 384 the sweep and K3's
// tensor-core scan take it too: the wide kind serves there only where its
// query tile holds min(Q, 64) queries over rows TMA reads, and where it
// reads the others no more often than the scan's 32-query tiles do
// (ops/scan.py::i8_wide_covers, with the times chip_smoke.py measured).
// It computes scan_topk_plain's int8 branch bit for bit: per query the k
// best live rows by float32(int32 q . v) * vscale[row] (one conversion,
// one multiply), ties to the lower row (row_key), as (Q, k) float32
// scores (-inf where a slot is empty) and (Q, k) int32 rows (0 where
// empty).
//
// What bounds it on the H100: the int8 rows and their scales, read once
// per query tile of pass A (1M x 1024: 1.03 GB, 0.31 ms at 3.35 TB/s);
// the s8 products (2 Q cap dim at 1,979 T/s: 0.07 ms at Q = 64 over 1M
// rows) stay under that. The slab adds q_tile x cap x 4 bytes written
// once and read about twice (256 MB at Q = 64 over 1M rows). The template
// it replaces (scan_topk.cu kind 2) ran two queries a CTA at k > 128 on
// CUDA-core __dp4a, so it read the rows once per query pair.
//
// Design, as K4's wide kind (topk_wide.cu), for the reason given there:
// per-query buffers of k = 1024 keys do not fit a CTA beside the ring.
//  * Pass A (scan_topk_wgmma.cuh, BUF 0): K3's tensor-core scan as it is
//    (`Int8R`: the rows by the producer their width and base allow, the
//    int8 queries by TMA, four s8
//    wgmmas a k-stage into one int32 sum a row over the whole width,
//    converted and scaled once a segment), only segments with a live row,
//    four stages, 32 queries a CTA at Q <= 32, else 64 (as K4's wide
//    kind's pass A); its epilogue stores float_order(score) of every
//    (query, row below cap) of a live segment to the slab (q_tile, ld),
//    ld = cap rounded up to 128. A tile of fewer queries than the CTA's N
//    runs one query tile, TMA zero-filling the query rows past it (Q = 1
//    included).
//  * Pass B (radix_select.cuh), unchanged: three digit histograms read
//    from the slab beside the mask, the keys at or above the k-th's bucket
//    collected, sorted and decoded; ties past CAP taken in row order. The
//    score key orders as row_key's high word, so the selection equals the
//    plain version's on (score, row) keys.
//  * The launcher walks the queries in tiles of q_tile (ops/scan.py::
//    topk_wide_tile keeps the slab under 256 MiB; radix_select.cuh's
//    `walk_tiles`). One scratch buffer (slab, histograms, candidates:
//    ops/scan.py::i4_wide_scratch) and one library call a batch.
//  * Why it beats the scan it runs on past k = 128: the scan keeps 512
//    keys a query in shared memory at 32 queries a CTA there, so a 64-query
//    batch reads the rows twice and compacts its buffers again and again;
//    the slab costs 4 bytes a (query, row) written and read about twice,
//    under the int8 row's 1,024 read once per 64 queries.

#include <algorithm>
#include <type_traits>

#include "radix_select.cuh"
#include "scan_topk_wgmma.cuh"

namespace pv {
namespace {

// The int8 wide kinds' call: the queries padded where TMA cannot read them
// (after the tile in `scratch`), then `rs::walk_tiles` with pass A the
// scan of kind T (`Int8R`: K3, `vs` the row scales; `Int8C`: K9, the
// int32 sums as the keys, decoded as such) over the rows [0, cap), 32
// queries a CTA at a tile of <= 32, else 64, four stages, the rows'
// producer `piece`.
template <class T>
int int8_wide(int piece, const void* q, const void* v, const float* vs,
              const void* mask, void* scratch, void* vals, void* idx, int Q,
              long long cap, int dim, int k, int q_tile,
              long long scratch_bytes, cudaStream_t s) {
  using namespace tk;
  const long ld = (long)((cap + SEG - 1) / SEG) * SEG;
  const int qld = plane_ld(dim, 1);
  const size_t tile = rs::up256(rs::tile_layout(q_tile, ld).bytes);
  if (k > 1024 || cap < 0 || cap > 0x7FFFFFFFLL || dim <= 0 || q_tile <= 0 ||
      q_tile > 65535 || (uintptr_t)mask % 4 || (uintptr_t)scratch % 256 ||
      (size_t)scratch_bytes < tile + (size_t)Q * qld)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = rs::prepare(&sms);
  if (e != cudaSuccess) return (int)e;
  unsigned char* qp = static_cast<unsigned char*>(scratch) + tile;
  if ((e = tma_queries(&q, qp, Q, dim, s)) != cudaSuccess) return (int)e;
  const int qrow = q == qp ? qld : dim;  // q's rows as TMA reads them
  const Rows flat{};  // the rows [0, cap)
  const rs::Decode dec{nullptr, 1, std::is_same<T, tk::Int8C>::value};
  return with_piece(piece, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return rs::walk_tiles(
        static_cast<unsigned char*>(scratch),
        static_cast<const uint8_t*>(mask), static_cast<float*>(vals),
        static_cast<int*>(idx), Q, q_tile, (long)cap, ld, k, sms, s,
        [&](int q0, int nq, uint32_t* slab) {
          if (cap == 0) return 0;
          const void* qt = static_cast<const int8_t*>(q) + (size_t)q0 * qrow;
          const size_t plane = (size_t)nq * qrow;
          int r = 0;
          return nq <= 32 ? launch_scan_rows<T, 32, 4, 0, P>(
                                qt, plane, qrow, v, mask, vs, slab, nq, cap,
                                dim, 0, flat, &r, s)
                          : launch_scan_rows<T, 64, 4, 0, P>(
                                qt, plane, qrow, v, mask, vs, slab, nq, cap,
                                dim, 0, flat, &r, s);
        },
        dec);
  });
}

}  // namespace
}  // namespace pv

// K3's wide kind: q (Q, dim) int8 queries (any base), v (cap, dim) int8
// rows, vscale (cap,) float32, mask (cap,) uint8 4-byte aligned; k <=
// 1024 (served where ops/scan.py::i8_wide_ready). piece: the rows'
// producer (ops/scan.py::rows_piece): 0 TMA (dim and v's base multiples of
// 16), 8 or 4 cp.async (multiples of piece), 2 the realigning producer
// (any width and base). `scratch` (256-byte aligned) holds
// `scratch_bytes`, at least one tile of q_tile queries' slab, histograms
// and candidates, each from a 256-byte boundary (ops/scan.py::
// i4_wide_scratch), rounded up to 256 bytes, then Q x qld bytes, qld = dim
// rounded up to 16: the queries as TMA reads them where q's rows are not
// (`tk::tma_queries`). vals (Q, k) float32 and idx (Q, k) int32 receive
// the result (-inf / 0 where empty). Launches on the current device.
// Returns 0, a cudaError_t, or minus the CUresult of a refused tensor-map
// encode.
extern "C" int pv_scan_topk_i8_wide(int piece, const void* q, const void* v,
                                    const void* vscale, const void* mask,
                                    void* scratch, void* vals, void* idx,
                                    int Q, long long cap, int dim, int k,
                                    int q_tile, long long scratch_bytes,
                                    void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (!vscale) return (int)cudaErrorInvalidValue;
  return int8_wide<tk::Int8R>(piece, q, v, static_cast<const float*>(vscale),
                              mask, scratch, vals, idx, Q, cap, dim, k,
                              q_tile, scratch_bytes, (cudaStream_t)stream);
}

// K9's wide kind: pv_scan_topk_i8_wide's contract over column-scaled int8
// rows against folded int8 queries, no scales (served where ops/scan.py::
// i8c_wide_ready: 128 < k <= 1024, any width and base, one query's slab
// within its budget). Pass A is K3's scan at `Int8C`, whose slab keys are
// the sign-flipped int32 sums (slab_key), decoded by the select's finish
// to the sums as float32 (rs::Decode int_scores), ties to the lower row.
// Returns 0, a cudaError_t, or minus the CUresult of a refused tensor-map
// encode.
extern "C" int pv_scan_topk_i8c_wide(int piece, const void* q, const void* v,
                                     const void* mask, void* scratch,
                                     void* vals, void* idx, int Q,
                                     long long cap, int dim, int k,
                                     int q_tile, long long scratch_bytes,
                                     void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  return int8_wide<tk::Int8C>(piece, q, v, nullptr, mask, scratch, vals, idx,
                              Q, cap, dim, k, q_tile, scratch_bytes,
                              (cudaStream_t)stream);
}
