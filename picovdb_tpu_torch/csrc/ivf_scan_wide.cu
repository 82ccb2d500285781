// K7 ivf_scan_topk at 128 < k <= 1024 (the wide kind): K7's tensor-core
// scan over the live hot tiles writing every key to a slab indexed by
// logical row, then the per-query radix select over the slab.
//
// Replaces picovdb_tpu/ops/ivf.py:probe_scan_local (`_ivf_kernel`,
// `_ivf_kernel_i8c`) at k_sel 129-1024 (ops/ivf.py::ivf_wide_ready), at
// every postings width and base (rows TMA cannot read by pass A's cp.async
// or realigning producer, scan_topk_wgmma.cuh `PIECE`, the queries padded
// to whole 16 bytes in the scratch) and every batch size, over hot tables
// of up to 64M rows (postings of any cap): the host-rescore band of every
// quantized IVF store (int8 storage: k + RESCORE_GUARD + the int8
// postings' guard = 160 at top_k = 10; int4: k + 4 RESCORE_GUARD + 22 =
// 544), and float
// postings at top_k >= 125. It computes pv_ivf_scan_topk's function: per
// query the k best masked rows of the hot tiles hot[b], b < *n_hot (read
// on the device), as (Q, k) float32 scores (-inf where a slot is empty)
// and (Q, k) int32 IVF rows hot[b] * bn + lane (0 where empty), ties to
// the lower row. Kinds: float32 postings and queries (3xTF32), bf16
// postings and queries, column-scaled int8 postings and folded int8
// queries ranked on the exact int32 sum (returned as float32).
//
// What bounds it on the H100: the live hot tiles' rows, read once per
// query tile of pass A (40 tiles of 1024 x 1024 float32: 0.17 GB, 0.05 ms
// at 3.35 TB/s), or for float32 postings at large batches three TF32
// products (2 Q rows dim each at 495 T/s). The slab adds q_tile x grid_b
// x bn x 4 bytes written once and read about twice. The template it
// replaces (scan_topk.cu) ran two queries a CTA at k > 128 on CUDA-core
// FMAs, a block for every step of the padded hot table, dead or not, and
// re-read every hot tile once per query pair.
//
// Design, as K4's wide kind (topk_wide.cu) for the reason given there
// (per-query buffers of k = 1024 keys do not fit a CTA beside the ring):
//  * The step order (`ivf_rows_kernel`, one CTA a step of the hot table):
//    each live step's rank among the live steps by tile id (ties by step),
//    so `sorted` lists the live tiles in ascending order, and the logical
//    mask `lmask`: step rank r's bn mask bytes at [r bn, (r + 1) bn), zero
//    in the dead steps' slots. In that order the slab's logical rows
//    ascend with the IVF rows, so pass B's ties to the lower slab row are
//    ties to the lower IVF row whatever order the probe lists its tiles in
//    (its overflow tiles come first). The mask is gathered once (grid_b x
//    bn bytes, 1 byte a row, beside the 4 of the key the readers take),
//    not mapped in every reader: the readers stay K4's, unchanged, and
//    nothing reads n_hot on the host.
//  * Pass A (scan_topk_wgmma.cuh, BUF 0): K7's tensor-core scan over the
//    `Rows` map {sorted, n_hot} (each CTA computes its share of the live
//    steps' segments on the device, a segment with no live row issues no
//    copy), four stages, 32 queries a CTA at Q <= 32, else 64; its
//    epilogue stores slab_key(score) (float_order, or the sign-flipped
//    int32 sum for int8 postings: never a float32 rounding of it) at the
//    row's logical index seg * 128 + lane of the slab (q_tile, grid_b bn).
//  * Pass B (radix_select.cuh) over the slab with the logical mask: dead
//    steps and masked rows never reach the selection; the finish decodes
//    a logical row l to sorted[l / bn] * bn + l % bn, and int8 postings'
//    keys to their int32 score.
//  * The launcher splits float32 queries into TF32 hi / lo planes
//    (radix_select.cuh's `split_planes`, as K4's wide kind), and copies
//    bf16 and int8 queries whose rows TMA cannot read (`ws::tma_rows`), in
//    its scratch as rows of whole 16 bytes, builds the step order, then
//    walks the queries in tiles of q_tile (ops/scan.py::topk_wide_tile
//    over grid_b x bn rows; radix_select.cuh's `walk_tiles`). One scratch
//    buffer (ops/ivf.py::ivf_wide_scratch) and one library call a batch.

#include "radix_select.cuh"
#include "scan_topk_wgmma.cuh"

namespace pv {
namespace {
namespace iw {

// CTA b: step b of the hot table. A live step (b < min(*n_hot, grid_b))
// counts the live steps before it in (tile id, step) order, writes its
// tile at that rank of `sorted` and its tile's bn mask bytes at that
// rank's slot of `lmask`; a dead step zeroes its own slot (every live
// rank is below the live count, so below b).
__global__ void __launch_bounds__(256)
ivf_rows_kernel(const int* __restrict__ hot, const int* __restrict__ n_hot,
                const uint8_t* __restrict__ mask, int* __restrict__ sorted,
                uint8_t* __restrict__ lmask, int bn, int grid_b) {
  __shared__ int sm[8];
  const int b = blockIdx.x;
  const int live = max(0, min(*n_hot, grid_b));
  if (b >= live) {
    for (int i = threadIdx.x; i < bn; i += blockDim.x)
      lmask[(long)b * bn + i] = 0;
    return;
  }
  const int t = hot[b];
  int c = 0;
  for (int i = threadIdx.x; i < live; i += blockDim.x) {
    const int u = hot[i];
    c += u < t || (u == t && i < b);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) c += __shfl_xor_sync(0xffffffffu, c, o);
  if (threadIdx.x % 32 == 0) sm[threadIdx.x / 32] = c;
  __syncthreads();
  int rank = 0;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) rank += sm[w];
  if (threadIdx.x == 0) sorted[rank] = t;
  const uint8_t* src = mask + (long)t * bn;
  for (int i = threadIdx.x; i < bn; i += blockDim.x)
    lmask[(long)rank * bn + i] = src[i];
}

// Pass A over the rows map, four stages and the rows' producer PIECE, N =
// 32 queries a CTA at Q <= 32 (a tile of nq), else 64. `planes` holds
// T::PLANES query planes of (nq, qld) `plane` bytes apart.
template <class T, int PIECE>
int scan_slab(const void* planes, size_t plane, int qld, const void* v,
              const void* mask, uint32_t* slab, int nq, long long cap,
              int dim, const tk::Rows& map, cudaStream_t s) {
  int r = 0;
  return nq <= 32 ? tk::launch_scan_rows<T, 32, 4, 0, PIECE>(
                        planes, plane, qld, v, mask, nullptr, slab, nq, cap,
                        dim, 0, map, &r, s)
                  : tk::launch_scan_rows<T, 64, 4, 0, PIECE>(
                        planes, plane, qld, v, mask, nullptr, slab, nq, cap,
                        dim, 0, map, &r, s);
}

}  // namespace iw
}  // namespace
}  // namespace pv

// K7's wide kind: pv_ivf_scan_topk's contract for k <= 1024 (served at 128
// < k), at every postings width and base. piece: the rows' producer
// (ops/scan.py::rows_piece): 0 TMA (row bytes and v's base multiples of
// 16), 8 or 4 cp.async (multiples of piece), 2 the realigning producer
// (kinds 1 and 2). kind 0: float32 postings and queries; 1: bf16 postings
// and queries; 2: column-scaled int8 postings and folded int8 queries. q
// (Q, dim) (any base), postings (cap, dim) with cap % bn == 0 and bn %
// 128 == 0, mask (cap,) uint8, hot (grid_b,) int32 tile ids in [0, cap /
// bn), n_hot (1,) int32 on the device. `scratch` (256-byte aligned) holds
// `scratch_bytes`, at least ops/ivf.py::ivf_wide_scratch's: the query
// planes as rows of qld elements, qld = dim rounded up to whole 16 bytes
// (kind 0 the TF32 hi and lo planes, kinds 1 and 2 the queries copied
// there where their rows are not whole 16 bytes at an aligned base), the
// sorted live tiles, the logical mask, then one tile of q_tile queries'
// slab (q_tile x grid_b bn keys), histograms and candidates, each from a
// 256-byte boundary. vals (Q, k) float32 and idx (Q, k) int32 receive the
// result (-inf / 0 where empty). Launches on the current device. Returns
// 0, a cudaError_t, or minus the CUresult of a refused tensor-map encode.
extern "C" int pv_ivf_scan_topk_wide(int piece, int kind, const void* q,
                                     const void* v, const void* mask,
                                     const void* hot, const void* n_hot,
                                     void* scratch, void* vals, void* idx,
                                     int Q, long long cap, int dim, int k,
                                     int bn, int grid_b, int q_tile,
                                     long long scratch_bytes, void* stream) {
  using namespace pv;
  using namespace pv::iw;
  if (Q <= 0 || k <= 0 || grid_b <= 0) return (int)cudaSuccess;
  if (kind < 0 || kind > 2 || k > 1024 || cap <= 0 || dim <= 0 || bn <= 0 ||
      bn % SEG || cap % bn || !hot || !n_hot || q_tile <= 0 ||
      q_tile > 65535 || (uintptr_t)scratch % 256)
    return (int)cudaErrorInvalidValue;
  const long ld = (long)grid_b * bn;  // the slab's logical rows a query
  if (ld > 0x7FFFFFFFL) return (int)cudaErrorInvalidValue;
  const int es = kind == 0 ? 4 : kind == 1 ? 2 : 1;
  const int qld = tk::plane_ld(dim, es);
  const size_t plane = (size_t)Q * qld * es;  // kind 0: hi, then lo
  const size_t sorted_off = rs::up256(kind == 0 ? 2 * plane : plane);
  const size_t lmask_off = sorted_off + rs::up256((size_t)grid_b * 4);
  const size_t tile_off = lmask_off + rs::up256((size_t)ld);
  if ((size_t)scratch_bytes < tile_off + rs::tile_layout(q_tile, ld).bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int sms = 0;
  cudaError_t e = rs::prepare(&sms);
  if (e != cudaSuccess) return (int)e;
  unsigned char* base = static_cast<unsigned char*>(scratch);
  int* sorted = reinterpret_cast<int*>(base + sorted_off);
  uint8_t* lmask = base + lmask_off;
  const void* planes = q;
  if (kind == 0) {
    e = rs::split_planes(static_cast<const float*>(q), base, Q, dim, qld, 0,
                         sms, s);
    planes = base;
  } else {
    e = ws::tma_rows(&planes, base, Q, dim, es, s);
  }
  if (e != cudaSuccess) return (int)e;
  const int qrow = planes == q ? dim : qld;  // the planes' rows as TMA reads
  const size_t pl = (size_t)Q * qrow * es;
  ivf_rows_kernel<<<grid_b, 256, 0, s>>>(
      static_cast<const int*>(hot), static_cast<const int*>(n_hot),
      static_cast<const uint8_t*>(mask), sorted, lmask, bn, grid_b);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const tk::Rows map{sorted, static_cast<const int*>(n_hot), bn, grid_b};
  return tk::with_piece(piece, [&](auto p) {
    constexpr int P = decltype(p)::value;
    return rs::walk_tiles(
        base + tile_off, lmask, static_cast<float*>(vals),
        static_cast<int*>(idx), Q, q_tile, ld, ld, k, sms, s,
        [&](int q0, int nq, uint32_t* slab) {
          const void* qt = static_cast<const unsigned char*>(planes) +
                           (size_t)q0 * qrow * es;
          if (kind == 1)
            return scan_slab<tk::Bf16Q, P>(qt, pl, qrow, v, mask, slab, nq,
                                           cap, dim, map, s);
          if (kind == 2)
            return scan_slab<tk::Int8C, P>(qt, pl, qrow, v, mask, slab, nq,
                                           cap, dim, map, s);
          if constexpr (P == 2)  // float32 rows are whole 4 bytes
            return (int)cudaErrorInvalidValue;
          else
            return scan_slab<tk::F32, P>(qt, pl, qrow, v, mask, slab, nq, cap,
                                         dim, map, s);
        },
        rs::Decode{sorted, bn, kind == 2});
  });
}
