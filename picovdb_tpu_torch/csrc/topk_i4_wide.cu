// K6 fused_topk_i4 at 128 < k <= 1024 (the wide kind): K6's tensor-core
// scan writing every live row's sortable score key to a slab, then the
// per-query radix select over the slab.
//
// Replaces picovdb_tpu/ops/pallas_scan.py:fused_topk_i4 (`_scan_kernel_i4`)
// at k_sel 129-1024 at every even width, base and cap
// (ops/scan.py::i4_wide_ready): the int4 store's host-rescore band, k +
// 4 RESCORE_GUARD + SHARD_GUARD = 526 at k = 10 (k + 512 + 4 on a
// host-uploaded store at Q <= RESCORE_MAX_Q), on every shard of a mesh
// store, at every batch size. It
// computes scan_topk_plain(..., int4=True) bit for bit: per query the k
// best live rows by float32(q . lo + q . hi - 8 sum(q)) * vscale[row],
// ties to the lower row (row_key), as (Q, k) float32 scores (-inf where a
// slot is empty) and (Q, k) int32 rows (0 where empty).
//
// What bounds it on the H100: the packed plane's bytes at small batches
// (131,072 x 1024: 67 MB, 0.020 ms at 3.35 TB/s) and its int8 operations
// at large ones (2 Q cap dim at 1,979 T/s: 0.017 ms at Q = 128 over the
// same rows); the slab adds q_tile x cap x 4 bytes written once and read
// about twice (64 MB at Q = 128 over 131,072 rows). The template it
// replaces (scan_topk.cu kind 3) ran two queries a CTA on CUDA-core
// __dp4a, so it read the packed plane once per query pair, and kept 2,048
// candidate slots a block.
//
// Design, as K4's wide kind (topk_wide.cu), for the reason given there:
// per-query buffers of k = 1024 keys do not fit a CTA beside the ring.
//  * Pass A (scan_i4_wgmma.cu, BUF 0): K6's tensor-core scan as it is (the
//    permuted queries, each half padded to whole stages, the TMA ring, the
//    expander warps' nibble planes -- from TMA's slice, or read by the
//    expanders from device memory where TMA cannot read the rows --,
//    m64n128k32 s8 wgmma, exact int32 sums), whose epilogue stores
//    float_order(float32(acc - 8 sum(q)) * vscale[row]) for each (live
//    query, row below cap) to the slab (q_tile, ld), ld = cap rounded up to
//    128. A tile of fewer than 64 queries runs one M tile, TMA zero-filling
//    the query rows past it (Q = 1 included).
//  * Pass B (radix_select.cuh), unchanged from K4's wide kind: three digit
//    histograms read from the slab beside the mask, the keys at or above
//    the k-th's bucket collected, sorted and decoded; ties past CAP taken
//    in row order. The score key orders as row_key's high word, so the
//    selection equals the plain version's on (score, row) keys.
//  * The launcher walks the permuted queries in tiles of q_tile and the
//    rows in ranges (ops/scan.py::topk_wide_plan keeps a tile's slab under
//    256 MiB at every cap; radix_select.cuh's `walk_ranges`: past one
//    range each range's best k are kept as keys and merged), zeroing a
//    tile's histograms with one memset. One scratch buffer (slab,
//    histograms, candidates, the ranges' partial:
//    ops/scan.py::wide_walk_scratch) and one library call a batch.

#include <algorithm>

#include "radix_select.cuh"

namespace pv {
namespace {

// K6's wide kind over rows [0, cap) in ranges of range_rows (a multiple of
// SEG; at least cap: one range), the contract of pv_scan_topk_i4_wide
// below.
int i4_wide(int piece, const void* q_perm, const void* v, const void* vscale,
            const void* mask, void* scratch, void* vals, void* idx, int Q,
            long long cap, int dim, int k, int q_tile, long long range_rows,
            long long scratch_bytes, void* stream) {
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (k > 1024 || cap < 0 || cap > 0x7FFFFFFFLL || dim <= 0 || dim % 2 ||
      q_tile <= 0 || q_tile > 65535 || range_rows <= 0 ||
      range_rows % SEG || !vscale || (uintptr_t)mask % 4 ||
      (uintptr_t)scratch % 256 ||
      (size_t)scratch_bytes <
          rs::walk_bytes(q_tile, (long)cap, (long)range_rows, k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int sms = 0;
  const cudaError_t e = rs::prepare(&sms);
  if (e != cudaSuccess) return (int)e;
  const int8_t* qp = static_cast<const int8_t*>(q_perm);
  const int dim_p = (dim / 2 + 63) / 64 * 128;  // a permuted query row
  const int8_t* rows = static_cast<const int8_t*>(v);
  const float* scales = static_cast<const float*>(vscale);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  return rs::walk_ranges(
      static_cast<unsigned char*>(scratch), m, static_cast<float*>(vals),
      static_cast<int*>(idx), Q, q_tile, (long)cap, rs::up_seg((long)cap),
      (long)range_rows, k, sms, s,
      [&](int q0, int nq, long r0, long n, uint32_t* slab) {
        // a range starts on a whole segment: its packed rows keep the
        // plane's alignment class, so the plane's producer reads them
        return launch_i4_slab(piece, qp + (size_t)q0 * dim_p,
                              rows + (size_t)r0 * (dim / 2), scales + r0,
                              m + r0, slab, nq, n, dim, s);
      });
}

}  // namespace
}  // namespace pv

// K6's wide kind: piece (the rows' producer, ops/scan.py::rows_piece: 0
// TMA, 8 / 4 / 2 the expanders' reads), q_perm (Q, dim_p) int8 queries
// with their columns permuted and each half padded to whole 64-byte stages
// (ops/scan.py::permute_i4_queries; dim_p = 128 ceil(dim/2 / 64)), v (cap,
// dim / 2) packed int4 rows, vscale (cap,) float32, mask (cap,) uint8
// 4-byte aligned; dim even, 16-byte aligned q_perm, v and dim / 2 at the
// piece's alignment, k <= 1024 (served at 128 < k). The rows go in ranges
// of range_rows (a multiple of 128, ops/scan.py::topk_wide_plan; at least
// cap: one range), the queries in tiles of q_tile within each. `scratch`
// (256-byte aligned) holds `scratch_bytes`, at least one tile of q_tile
// queries' slab, histograms and candidates over a range's rows, each from
// a 256-byte boundary, then past one range the tile's partial of q_tile x
// ranges x k keys (ops/scan.py::wide_walk_scratch). vals (Q, k) float32
// and idx (Q, k) int32 receive the result (-inf / 0 where empty).
// Launches on the current device. Returns 0, a cudaError_t, or minus the
// CUresult of a refused tensor-map encode.
extern "C" int pv_scan_topk_i4_wide(int piece, const void* q_perm,
                                    const void* v, const void* vscale,
                                    const void* mask, void* scratch,
                                    void* vals, void* idx, int Q,
                                    long long cap, int dim, int k,
                                    int q_tile, long long range_rows,
                                    long long scratch_bytes, void* stream) {
  return pv::i4_wide(piece, q_perm, v, vscale, mask, scratch, vals, idx, Q,
                     cap, dim, k, q_tile, range_rows, scratch_bytes, stream);
}
