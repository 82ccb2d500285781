// K9 fused_topk_i8c at its serving shapes (Q <= 16, k <= 128, dim % 16 ==
// 0): a one-query sweep of the column-scaled int8 mirror at HBM rate.
//
// Replaces picovdb_tpu/ops/pallas_scan.py:fused_topk_i8c
// (`_scan_kernel_i8c`) on the shapes its routes use (`i8c_fused_smallq`,
// Q <= 16 at k_sel = k + 6, and the serial Q = 1 loop). It computes what
// pv_scan_topk kind 4 computes: per query the k best masked rows by the
// raw int32 sum q_i8 . v_i8, ranked by int_row_key (ties to the lower
// row), one partial of k keys per CTA, merged by launch_topk_merge. Bit
// for bit fused_topk_i8c_plain: the keys are distinct per row, so the
// merged set does not depend on the row ranges.
//
// What bounds it on the H100: the bytes. At Q = 1 a row of dim bytes is
// dim / 4 dp4a, so the sweep of the mirror from device memory (1 GB at
// 1M x 1024, 0.31 ms at 3.35 TB/s) is the floor; at Q = 16 the 16 dp4a
// per 4 bytes take about as long on the integer pipes. The template kernel
// (scan_topk.cu) it replaces here held one live query in a 16-query tile,
// so at Q = 1 15/16 of its arithmetic was wasted, and staged the corpus
// through shared memory with two barriers per 64-byte k-step.
//
// Design:
//  * The query tile is sized to Q: QT = 1, 2, 4, 8 or 16, the smallest
//    >= Q, so no lane computes for an absent query. The CTA loads its QT x
//    dim query block once, into shared memory.
//  * A grid of CTAS_PER_SM CTAs per SM takes contiguous 128-row-aligned
//    row ranges (ops/scan.py::sweep_partition). A warp owns groups of RW
//    rows: every lane reads 16-byte words of each row with non-coherent
//    loads, two per row issued together (at dim 1024: 8 per lane, 4 KB a
//    warp, up to 64 KB an SM across its 16 warps, above the ~25 KB that
//    covers device-memory latency at 3.35 TB/s), skips the loads of masked
//    rows, runs one __dp4a per 4 bytes per query, and sums each (query,
//    row) over the warp with one __reduce_add_sync. A warp reads the mask
//    of its 16 rows of a tile at once (one ballot). No barrier inside a
//    128-row tile.
//  * Selection behind a threshold: per query a shared buffer of BUF keys
//    admits only keys above the running k-th best (`tau`); after each tile
//    the CTA compacts (compact_buffers) when a buffer could overflow in
//    the next, and at the end writes its k best per query (0 where empty:
//    a range with no live row writes an empty partial).

#include "common.cuh"

namespace pv {
namespace {

constexpr int SW_THREADS = 256;
constexpr int SW_WARPS = SW_THREADS / 32;
constexpr int TR = 128;          // rows per tile between the CTA's barriers
constexpr int WARP_ROWS = TR / SW_WARPS;  // 16 rows of a tile per warp
constexpr int BUF = 256;         // candidate slots per query (>= k + TR)
constexpr int CTAS_PER_SM = 2;   // ops/scan.py SWEEP_CTAS_PER_SM
constexpr int DIM_MAX = 4096;    // ops/scan.py SWEEP_DIM_MAX

__device__ __forceinline__ uint4 ldg16(const int8_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ int dot16(uint4 a, uint4 b, int acc) {
  acc = __dp4a((int)a.x, (int)b.x, acc);
  acc = __dp4a((int)a.y, (int)b.y, acc);
  acc = __dp4a((int)a.z, (int)b.z, acc);
  return __dp4a((int)a.w, (int)b.w, acc);
}

// Rows per warp step: 4 while the query tile is small, 2 at QT >= 8 so the
// QT x RW sums and the loaded words stay in registers.
template <int QT>
struct Sweep {
  static constexpr int RW = QT <= 4 ? 4 : 2;
  static constexpr size_t smem(int dim) {
    return (size_t)QT * dim + (size_t)QT * BUF * 8 + QT * 8 + QT * 4;
  }
};

template <int QT>
__global__ void __launch_bounds__(SW_THREADS, CTAS_PER_SM)
sweep_topk_i8c_kernel(const int8_t* __restrict__ q,
                      const int8_t* __restrict__ v,
                      const uint8_t* __restrict__ mask,
                      u64* __restrict__ partial, int Q, long cap, int dim,
                      int k, long chunk, int nchunks) {
  constexpr int RW = Sweep<QT>::RW;
  constexpr int GROUPS = WARP_ROWS / RW;  // a warp's row groups per tile
  extern __shared__ __align__(16) unsigned char smem[];
  const int cpr = dim / 16;  // 16-byte words per row
  uint4* qs = reinterpret_cast<uint4*>(smem);        // QT x cpr words
  u64* buf = reinterpret_cast<u64*>(qs + QT * cpr);  // QT x BUF keys
  u64* tau = buf + QT * BUF;
  int* cnt = reinterpret_cast<int*>(tau + QT);

  for (int i = threadIdx.x; i < QT * cpr; i += SW_THREADS) {
    const int qq = i / cpr;
    qs[i] = qq < Q ? ldg16(q + (long)qq * dim + 16 * (i % cpr))
                   : make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x < QT) {
    cnt[threadIdx.x] = 0;
    tau[threadIdx.x] = 0ull;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const long rbeg = (long)blockIdx.x * chunk;
  const long rend = rbeg + chunk < cap ? rbeg + chunk : cap;
  for (long t0 = rbeg; t0 < rend; t0 += TR) {
    // the warp's rows of this tile: group g, row r is
    // t0 + g * SW_WARPS * RW + warp * RW + r; bit g * RW + r of `live`
    uint32_t live;
    {
      const long row = t0 + (lane / RW) * SW_WARPS * RW + warp * RW + lane % RW;
      live = __ballot_sync(0xffffffffu,
                           lane < WARP_ROWS && row < rend && mask[row] != 0);
    }
#pragma unroll 1
    for (int g = 0; g < GROUPS; ++g) {
      const long r0 = t0 + (long)g * SW_WARPS * RW + warp * RW;
      const uint32_t gl = (live >> (g * RW)) & ((1u << RW) - 1);
      if (!gl) continue;  // uniform: no live row in the group
      int acc[QT][RW];
#pragma unroll
      for (int qq = 0; qq < QT; ++qq)
#pragma unroll
        for (int r = 0; r < RW; ++r) acc[qq][r] = 0;
      for (int c = lane; c < cpr; c += 64) {
        const bool two = c + 32 < cpr;
        uint4 x0[RW], x1[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const int8_t* row = v + (r0 + r) * dim + 16 * c;
          const bool on = (gl >> r) & 1u;
          x0[r] = on ? ldg16(row) : zero;
          x1[r] = on && two ? ldg16(row + 512) : zero;
        }
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) {
          const uint4 w0 = qs[qq * cpr + c];
          const uint4 w1 = two ? qs[qq * cpr + c + 32] : zero;
#pragma unroll
          for (int r = 0; r < RW; ++r)
            acc[qq][r] = dot16(x1[r], w1, dot16(x0[r], w0, acc[qq][r]));
        }
      }
      // each (query, row) sum over the warp; lane (qq RW + r) % 32 admits it
#pragma unroll
      for (int qq = 0; qq < QT; ++qq)
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const int s = __reduce_add_sync(0xffffffffu, acc[qq][r]);
          if (lane == (qq * RW + r) % 32 && ((gl >> r) & 1u) && qq < Q) {
            const u64 key = int_row_key(s, (uint32_t)(r0 + r));
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
      partial[((long)qq * nchunks + blockIdx.x) * k + j] = buf[qq * BUF + j];
  }
}

template <int QT>
cudaError_t launch_sweep(const void* q, const void* v, const void* mask,
                         u64* partial, int Q, long cap, int dim, int k,
                         long chunk, int nchunks, cudaStream_t stream) {
  const size_t smem = Sweep<QT>::smem(dim);
  const cudaError_t e = cudaFuncSetAttribute(
      sweep_topk_i8c_kernel<QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return e;
  sweep_topk_i8c_kernel<QT><<<nchunks, SW_THREADS, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(v),
      static_cast<const uint8_t*>(mask), partial, Q, cap, dim, k, chunk,
      nchunks);
  return cudaGetLastError();
}

}  // namespace
}  // namespace pv

// K9 on the one-query sweep: q (Q, dim) folded int8 queries, v (cap, dim)
// column-scaled int8 rows, mask (cap,) uint8; Q <= 16, k <= 128,
// dim % 16 == 0 and <= 4096, 16-byte aligned q and v. CTA c reads rows
// [c * chunk, min(cap, (c + 1) * chunk)) (chunk % 128 == 0; max(1,
// ceil(cap / chunk)) CTAs); `partial` is scratch of that many * Q * k
// uint64; vals (Q, k) float32 (the int32 sums) and idx (Q, k) int32
// receive the result (-inf / 0 where empty). Returns the cudaError_t of
// the launches.
extern "C" int pv_sweep_topk_i8c(const void* q, const void* v,
                                 const void* mask, void* partial, void* vals,
                                 void* idx, int Q, long long cap, int dim,
                                 int k, long long chunk, void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  if (Q > 16 || k > 128 || cap < 0 || dim <= 0 || dim % 16 ||
      dim > DIM_MAX || chunk <= 0 || chunk % SEG ||
      ((uintptr_t)q | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
  const long long n = (cap + chunk - 1) / chunk;
  const int nc = n > 1 ? (int)n : 1;
  cudaStream_t s = (cudaStream_t)stream;
  u64* part = static_cast<u64*>(partial);
  cudaError_t err;
  if (Q == 1)
    err = launch_sweep<1>(q, v, mask, part, Q, cap, dim, k, chunk, nc, s);
  else if (Q == 2)
    err = launch_sweep<2>(q, v, mask, part, Q, cap, dim, k, chunk, nc, s);
  else if (Q <= 4)
    err = launch_sweep<4>(q, v, mask, part, Q, cap, dim, k, chunk, nc, s);
  else if (Q <= 8)
    err = launch_sweep<8>(q, v, mask, part, Q, cap, dim, k, chunk, nc, s);
  else
    err = launch_sweep<16>(q, v, mask, part, Q, cap, dim, k, chunk, nc, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_topk_merge(part, static_cast<float*>(vals),
                                static_cast<int*>(idx), Q, nc * k, k, s,
                                true);
}
