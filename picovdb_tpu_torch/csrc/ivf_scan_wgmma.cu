// K7 ivf_scan_topk at batches (Q > 16, k <= 128) on Hopper's tensor
// cores: exact masked top-k over the live hot tiles of the IVF postings.
//
// Replaces picovdb_tpu/ops/ivf.py:probe_scan_local (`_ivf_kernel`,
// `_ivf_kernel_i8c`) at k <= 128 wherever neither one-query sweep
// (sweep_topk.cu: the 16-byte sweep, the narrow sweep) takes the batch
// (ops/ivf.py::ivf_wgmma_ready): every 64- and 512-query batch of a
// ShardedIVF shard and of an IVF store, at every postings width and base
// (rows TMA cannot read by the cp.async or realigning producer,
// scan_topk_wgmma.cuh `PIECE`), and the batches of up to 16 queries whose
// query block the sweeps cannot hold (float32 rows past dim 1024 at 9-16
// queries). ivf_scan_wide.cu takes k > 128.
// It computes pv_ivf_scan_topk's function: per query the k best masked
// rows of the hot tiles hot[b], b < *n_hot (read on the device), as (Q, k)
// float32 scores (-inf where a slot is empty) and (Q, k) int32 IVF rows
// hot[b] * bn + lane (0 where empty), ties to the lower row. Kinds:
// float32 postings and queries (3xTF32), bf16 postings and queries,
// column-scaled int8 postings and folded int8 queries ranked on the exact
// int32 sum (returned as float32).
//
// What bounds it on the H100: a shard's live hot rows read once (520k x
// 1024 float32 at 11d's default probe: 2.1 GB, 0.64 ms at 3.35 TB/s) and,
// for float32 postings, three TF32 products (2 Q rows dim each at 495
// T/s: 3.3 ms at Q = 512). The template it replaces scored on CUDA-core
// FMAs through unpipelined shared-memory tiles, re-read every hot tile
// once per 16-query tile (32 times at Q = 512), launched a block for every
// step of the padded hot table, dead or not, and wrote Q x grid_b x split
// x k partials, cut into query groups of more launches.
//
// Design: K4's tensor-core scan (scan_topk_wgmma.cuh: rows as M, 64
// queries as N, a TMA ring with 128B swizzle, 3xTF32 with a sum per
// k-stage added rounded to nearest, the register epilogue with per-query
// buffers, tau and compaction, then launch_topk_merge) over K8's row map
// (ivf_segmax_wgmma.cu): the logical segment j of the live steps is
// physical rows hot[j / ns] * bn + (j % ns) * 128 + [0, 128). The grid is
// q_tiles x ranges CTAs, ranges = min(grid_b * ns, SMs / q_tiles); each
// CTA computes its share of the min(*n_hot, grid_b) * ns live segments on
// the device, so the launcher reads nothing back. CTA c takes query tile c
// % q_tiles (query tiles fastest: the CTAs of one range read its segments
// together, from L2 after the first). A segment whose 128 mask bytes are
// all zero issues no copy. bf16 postings take one bf16 query plane
// (`Bf16Q`: the probed route casts the queries to the postings' dtype);
// int8 postings take K3's s8 path with no row scale (`Int8C`: the int32
// sum is the score, its key int_row_key). Over rows TMA cannot read the
// query planes come padded to whole 16 bytes (zeros past dim), and past k
// 64 the realigning producer runs 32 queries a CTA, four stages: its two
// 18 KB staging slots leave no room for 64 queries' buffers of 256 keys
// (ops/scan.py::topk_wgmma_qtile, as K4's).

#include "scan_topk_wgmma.cuh"

namespace pv {
namespace {

// K7's configurations at k with the rows' producer PIECE: float32 three
// stages and BUF 64 / 128 to k 64, then two and BUF 256; the one-plane
// kinds four stages, then three; the realigning producer past k 64 32
// queries a CTA and four stages.
template <class T, int PIECE>
int k7(const void* planes, int qld, const void* v, const void* mask,
       void* partial, void* vals, void* idx, int Q, long long cap, int dim,
       int k, const tk::Rows& map, cudaStream_t s) {
  using namespace tk;
  constexpr bool F = T::PLANES == 2, RA = PIECE == 2;
  if (k <= 32)
    return launch_rows<T, 64, F ? 3 : 4, 64, PIECE>(
        planes, qld, v, mask, nullptr, partial, vals, idx, Q, cap, dim, k,
        map, s);
  if (k <= 64)
    return launch_rows<T, 64, F ? 3 : 4, 128, PIECE>(
        planes, qld, v, mask, nullptr, partial, vals, idx, Q, cap, dim, k,
        map, s);
  return launch_rows<T, RA ? 32 : 64, RA ? 4 : F ? 2 : 3, 256, PIECE>(
      planes, qld, v, mask, nullptr, partial, vals, idx, Q, cap, dim, k, map,
      s);
}

}  // namespace
}  // namespace pv

// K7 on the tensor cores: pv_ivf_scan_topk's contract for k <= 128, at
// every postings width and base. piece: the rows' producer (ops/scan.py::
// rows_piece): 0 TMA (row bytes and v's base multiples of 16), 8 or 4
// cp.async (multiples of piece), 2 the realigning producer (kinds 1 and 2,
// any width and base). kind 0: float32 postings and `planes` (2, Q, qld)
// float32, the queries' hi and lo (ops/scan.py::split_tf32); 1: bf16
// postings and `planes` the (Q, qld) bf16 queries; 2: column-scaled int8
// postings and the (Q, qld) folded int8 queries; qld = dim rounded up to
// whole 16 bytes, zeros past dim, `planes` 16-byte aligned. postings (cap,
// dim) with cap % bn == 0 and bn % 128 == 0, mask (cap,) uint8, hot
// (grid_b,) int32 tile ids in [0, cap / bn), n_hot (1,) int32 on the
// device. `partial` is scratch of Q * ranges * k uint64, ranges = max(1,
// min(grid_b * bn / 128, SMs / ceil(Q / N))), N = ops/scan.py::
// topk_wgmma_qtile (ops/ivf.py::ivf_wgmma_partition); vals (Q, k) float32
// and idx (Q, k) int32 receive the result (-inf / 0 where empty).
// Launches on the current device. Returns 0, a cudaError_t, or minus the
// CUresult of a refused tensor-map encode.
extern "C" int pv_ivf_scan_topk_wgmma(int piece, int kind, const void* planes,
                                      const void* v, const void* mask,
                                      const void* hot, const void* n_hot,
                                      void* partial, void* vals, void* idx,
                                      int Q, long long cap, int dim, int k,
                                      int bn, int grid_b, void* stream) {
  using namespace pv;
  using namespace pv::tk;
  if (Q <= 0 || k <= 0 || grid_b <= 0) return (int)cudaSuccess;
  if (k > 128 || cap <= 0 || dim <= 0 || bn <= 0 || bn % ROWS || cap % bn ||
      !hot || !n_hot || kind < 0 || kind > 2)
    return (int)cudaErrorInvalidValue;
  const Rows map{static_cast<const int*>(hot), static_cast<const int*>(n_hot),
                 bn, grid_b};
  cudaStream_t s = (cudaStream_t)stream;
  const int qld = plane_ld(dim, kind == 0 ? 4 : kind == 1 ? 2 : 1);
  return with_piece(piece, [&](auto p) {
    constexpr int P = decltype(p)::value;
    if (kind == 1)
      return k7<Bf16Q, P>(planes, qld, v, mask, partial, vals, idx, Q, cap,
                          dim, k, map, s);
    if (kind == 2)
      return k7<Int8C, P>(planes, qld, v, mask, partial, vals, idx, Q, cap,
                          dim, k, map, s);
    if constexpr (P == 2)  // float32 rows are whole 4 bytes
      return (int)cudaErrorInvalidValue;
    else
      return k7<F32, P>(planes, qld, v, mask, partial, vals, idx, Q, cap, dim,
                        k, map, s);
  });
}
