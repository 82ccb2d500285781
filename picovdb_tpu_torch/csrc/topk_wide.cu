// K4 fused_topk at 128 < k <= 1024 (the wide kind): a tensor-core score
// pass that writes every live row's sortable score key to a slab, then a
// per-query radix select over the slab.
//
// Replaces picovdb_tpu/ops/pallas_scan.py:fused_topk (`_scan_kernel`) at
// k_sel 129-1024 (ops/scan.py::topk_wide_ready), at every row width, base
// and cap: the batch routes' wide top_k (k_sel = top_k + 4 over the bf16
// mirror) and the engine's exact retry (k_eff + 4 over the float32 rows). Per query the k best masked rows by the float32 score, as
// (Q, k) float32 scores (-inf where a slot is empty) and (Q, k) int32 rows
// (0 where empty), ties to the lower row (row_key: -0.0 ranks below +0.0).
//
// What bounds it on the H100: the rows, read once per query tile of
// pass A (1M x 1024 bf16: 0.61 ms at 3.35 TB/s; 131,072 x 1024 float32,
// ~10 % masked: 0.144 ms); float32 rows' three TF32 products (2 x N x cap
// x dim each at 495 T/s) stay under that at one query tile. The slab adds Q x cap x 4
// bytes written once and read about twice (8 MB at Q = 16 over 131,072
// rows, inside the 50 MB L2; 256 MB at Q = 64 over 1M rows, an eighth of
// the bf16 mirror's bytes).
//
// Design, and why not K4's one-pass buffers: K4's tensor-core scan keeps
// N x BUF keys of candidates a CTA in shared memory. At k = 1024 that is
// 512 KB for 64 queries, and with ~132 segment ranges over 131,072 rows a
// range holds fewer rows than k, so every partial would be its whole range
// and the merge would sort Q x cap keys. Here:
//  * Pass A (scan_topk_wgmma.cuh, BUF 0): K4's own mainloop, its rows'
//    producers (TMA, or cp.async / realignment over rows TMA cannot read)
//    and numerics
//    (3xTF32 for float32 rows, the float32 query's three bf16 planes for
//    bf16 rows, each k-stage summed apart and added rounded to nearest),
//    CTAs over topk_wgmma_partition's (query tile, segment range) pairs
//    (tiles of 32 queries at Q <= 32, else 64), only segments with a live
//    row; its epilogue stores float_order(score) for each (query, row) to
//    the slab (Q, ld), ld = cap rounded up to 128.
//  * Pass B (radix_select.cuh, shared with K6's wide kind in
//    topk_i4_wide.cu), a radix select on the 32-bit keys in three digits
//    (bits 31-21, 20-10, 9-0). The histogram is built here from the slab, not in
//    pass A: an 11-bit digit's histogram for 64 queries (512 KB) does not
//    fit a CTA's shared memory beside the ring, and an 8-bit digit of the
//    key (sign and seven exponent bits) splits scores only by pairs of
//    octaves, so nearly every live row of a unit-vector store would share
//    the k-th key's bucket. The readers (`hist_kernel`, `collect_kernel`)
//    are CTAs of 256 threads over (slab slice, query), a warp a 128-row
//    segment, 16-byte loads, the mask read beside the keys (a dead segment
//    is skipped, a dead row never counted). The level-0 histogram names
//    the digit holding the k-th key; when the keys above that bucket and
//    in it number more than CAP, level 1 and then level 2 count the
//    bucket's keys only; each of those kernels first resolves the levels
//    before it from the global histograms (`resolve`) and returns at once
//    when it is not needed. `collect_kernel` appends every key at or above
//    the resolved bucket (at most CAP) with its row as a 64-bit row_key to
//    the query's candidate list. `finish_kernel` (one CTA of 1024 threads
//    a query) sorts the candidates (a bitonic network over a power of two
//    of at least 256 keys, 8 a thread in registers, the short strides by
//    warp shuffles, the long ones through shared memory) and writes the
//    best k decoded. Where even the full key leaves more than CAP
//    candidates (more than CAP - k rows with one equal score), the keys
//    above it are collected and the equal ones taken in row order by a
//    block-wide scan of the slab, so ties still go to the lower row:
//    exact at every k.
//  * The launcher splits the queries into pass A's planes (radix_select.cuh's
//    `split_planes`, K7's wide kind's too; rows padded with zeros to whole
//    16 bytes, which TMA reads) in its own scratch, then walks
//    them in tiles of `q_tile` and the rows in ranges of range_rows
//    (ops/scan.py::topk_wide_plan keeps a tile's slab under 256 MiB at
//    every cap: past 64M rows, or where the plane would cut the tile below
//    min(Q, 64) queries, the rows go in ranges, each range's best k kept
//    as keys and merged by launch_topk_merge; the walk, radix_select.cuh's
//    `walk_ranges`, is every wide kind's), zeroing a tile's histograms and
//    candidate count with one memset. One scratch buffer and one library
//    call a batch: the host's enqueue stays short beside pass A (PERF.md
//    §6).

#include "radix_select.cuh"
#include "scan_topk_wgmma.cuh"

namespace pv {
namespace {

// Pass A on one tile of nq queries: the scan with the slab epilogue (BUF
// 0), four stages and the rows' producer PIECE, N = 32 queries a CTA at
// nq <= 32 (half the operand reads and products of N = 64, whose tile
// would be at least half empty), else 64. `planes` (T::PLANES planes of
// (nq, qld), `plane` bytes apart).
template <class T, int PIECE>
int slab_pass(const void* planes, size_t plane, int qld, const void* v,
              const void* mask, uint32_t* slab, int nq, long long cap,
              int dim, cudaStream_t s) {
  using namespace tk;
  const Rows flat{};  // the rows [0, cap)
  int r = 0;
  return nq <= 32 ? launch_scan_rows<T, 32, 4, 0, PIECE>(
                        planes, plane, qld, v, mask, nullptr, slab, nq, cap,
                        dim, 0, flat, &r, s)
                  : launch_scan_rows<T, 64, 4, 0, PIECE>(
                        planes, plane, qld, v, mask, nullptr, slab, nq, cap,
                        dim, 0, flat, &r, s);
}

// K4's wide kind over rows [0, cap) in ranges of range_rows (a multiple
// of SEG; at least cap: one range, the walk of one plane), the contract of
// pv_scan_topk_wide below.
int topk_wide(int piece, int kind, const void* q, const void* v,
              const void* mask, void* scratch, void* vals, void* idx, int Q,
              long long cap, int dim, int k, int q_tile, long long range_rows,
              long long scratch_bytes, void* stream) {
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  const int es = kind == 0 ? 4 : 2;  // bytes of a plane element and a row's
  const int qld = tk::plane_ld(dim, es);
  // the query planes (ops/scan.py::topk_wide_scratch), then the walk's
  // tile (and partial)
  const size_t planes = rs::up256((size_t)Q * qld * (kind == 0 ? 8 : 6));
  if (k > 1024 || cap < 0 || cap > 0x7FFFFFFFLL || dim <= 0 || q_tile <= 0 ||
      q_tile > 65535 || range_rows <= 0 || range_rows % SEG ||
      (kind != 0 && kind != 1) || (uintptr_t)mask % 4 ||
      (uintptr_t)scratch % 256 ||
      (size_t)scratch_bytes <
          planes + rs::walk_bytes(q_tile, (long)cap, (long)range_rows, k))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t plane = (size_t)Q * qld * es;
  int sms = 0;
  cudaError_t e = rs::prepare(&sms);
  if (e != cudaSuccess) return (int)e;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  if ((e = rs::split_planes(static_cast<const float*>(q), base, Q, dim, qld,
                            kind, sms, s)) != cudaSuccess)
    return (int)e;
  const unsigned char* rows = static_cast<const unsigned char*>(v);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  return tk::with_piece(piece, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return rs::walk_ranges(
        base + planes, m, static_cast<float*>(vals), static_cast<int*>(idx),
        Q, q_tile, (long)cap, rs::up_seg((long)cap), (long)range_rows, k,
        sms, s, [&](int q0, int nq, long r0, long n, uint32_t* slab) {
          if (n == 0) return 0;
          // a range starts on a whole segment: its rows keep the plane's
          // alignment class, so the plane's producer reads them
          const void* pt = base + (size_t)q0 * qld * es;
          const void* vr = rows + (size_t)r0 * dim * es;
          if (kind == 1)
            return slab_pass<tk::Bf16, P>(pt, plane, qld, vr, m + r0, slab,
                                          nq, n, dim, s);
          if constexpr (P == 2)  // float32 rows are whole 4 bytes
            return (int)cudaErrorInvalidValue;
          else
            return slab_pass<tk::F32, P>(pt, plane, qld, vr, m + r0, slab,
                                         nq, n, dim, s);
        });
  });
}

}  // namespace
}  // namespace pv

// K4's wide kind: pv_scan_topk's kinds 0 and 1 for 128 < k <= 1024 (the
// launcher takes any k <= 1024). piece: the rows' producer
// (ops/scan.py::rows_piece): 0 TMA (row bytes and v's base multiples of
// 16), 8 or 4 cp.async (multiples of piece), 2 the realigning producer
// (kind 1 only, any width and base). q (Q, dim) float32 queries; kind 0: v
// (cap, dim) float32, 1: v bfloat16. mask (cap,) uint8, 4-byte aligned.
// The rows go in ranges of range_rows (a multiple of 128, ops/scan.py::
// topk_wide_plan; at least cap: one range, the walk of one plane), the
// queries in tiles of q_tile within each; a range starting on a multiple
// of 128 rows keeps the plane's producer and the mask's 4-byte alignment.
// `scratch` (256-byte aligned) holds `scratch_bytes`, at least
// ops/scan.py::topk_wide_scratch's at the planes' width qld (dim rounded
// up to whole 16 bytes): the planes, then one tile of q_tile queries'
// slab, histograms and candidates over a range's rows, then past one
// range the tile's partial of q_tile x ranges x k keys. vals (Q, k)
// float32 and idx (Q, k) int32 receive the result (-inf / 0 where empty).
// Launches on the current device. Returns 0, a cudaError_t, or minus the
// CUresult of a refused tensor-map encode.
extern "C" int pv_scan_topk_wide(int piece, int kind, const void* q,
                                 const void* v, const void* mask,
                                 void* scratch, void* vals, void* idx, int Q,
                                 long long cap, int dim, int k, int q_tile,
                                 long long range_rows,
                                 long long scratch_bytes, void* stream) {
  return pv::topk_wide(piece, kind, q, v, mask, scratch, vals, idx, Q, cap,
                       dim, k, q_tile, range_rows, scratch_bytes, stream);
}
