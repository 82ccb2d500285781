// Pieces shared by the tensor-core scans that keep a selection per query
// or per segment rather than a dense tile: K4's masked top-k scan
// (scan_topk_wgmma.cu), K6's int4 scan (scan_i4_wgmma.cu) and K8's IVF
// segment scan (ivf_segmax_wgmma.cu).
//
//  * wgmma at m64n32 / m64n64 in TF32, bf16 and s8, with both operands
//    K-major in 128B-swizzled shared memory (K4, K8: rows as M, queries as
//    N);
//  * the 3xTF32 split of a row tile in shared memory (K4, K8);
//  * which rows of a 128-row segment the mask keeps (K4, K8);
//  * the per-query candidate buffers' compaction behind a named barrier of
//    the consumer warpgroups alone (K4, K6);
//  * the rows' producers for rows TMA cannot read (K4, K3, K7, K8): a
//    producer warpgroup copying each 128-row stage by cp.async in 8- or
//    4-byte pieces, or staging each row's aligned span by TMA and shifting
//    it into place (`produce_rows`, and the realigning producer's maps).
#pragma once

#include <mutex>

#include "wgmma_tiles.cuh"

namespace pv {
namespace {
namespace ws {

constexpr unsigned FULL = 0xffffffffu;

// The accumulator registers of an m64nNk wgmma (N / 2 a thread).
#define PV_WS_D16                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define PV_WS_D32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define PV_WS_ACC8(C, i)                                                    \
  C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3]), C(d[i + 4]), C(d[i + 5]), \
      C(d[i + 6]), C(d[i + 7])
#define PV_WS_ACC16(C) PV_WS_ACC8(C, 0), PV_WS_ACC8(C, 8)
#define PV_WS_ACC32(C) PV_WS_ACC16(C), PV_WS_ACC8(C, 16), PV_WS_ACC8(C, 24)
// D (64 x N) (+)= A (64 x k) . B (N x k)^T, both K-major in 128B-swizzled
// shared memory; scale_d = 0 overwrites D. DESC and PRED: the operand
// numbers of the descriptors and the predicate, after the N / 2
// accumulators.
#define PV_WS_MMA(NAME, ACC, ACCN, INSTR, DREGS, DESC, PRED, TAIL, CONS)   \
  __device__ __forceinline__ void NAME(ACC (&d)[ACCN], uint64_t da,        \
                                       uint64_t db, int scale_d) {         \
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, " PRED ", 0;\n"         \
                 "wgmma.mma_async.sync.aligned." INSTR " " DREGS ", " DESC  \
                 ", p" TAIL ";\n}\n"                                        \
                 : CONS                                                    \
                 : "l"(da), "l"(db), "r"(scale_d));                        \
  }

PV_WS_MMA(mma_tf32, float, 16, "m64n32k8.f32.tf32.tf32", PV_WS_D16,
          "%16, %17", "%18", ", 1, 1", PV_WS_ACC16("+f"))
PV_WS_MMA(mma_tf32, float, 32, "m64n64k8.f32.tf32.tf32", PV_WS_D32,
          "%32, %33", "%34", ", 1, 1", PV_WS_ACC32("+f"))
PV_WS_MMA(mma_bf16, float, 16, "m64n32k16.f32.bf16.bf16", PV_WS_D16,
          "%16, %17", "%18", ", 1, 1, 0, 0", PV_WS_ACC16("+f"))
PV_WS_MMA(mma_bf16, float, 32, "m64n64k16.f32.bf16.bf16", PV_WS_D32,
          "%32, %33", "%34", ", 1, 1, 0, 0", PV_WS_ACC32("+f"))
PV_WS_MMA(mma_s8, int, 16, "m64n32k32.s32.s8.s8", PV_WS_D16, "%16, %17",
          "%18", "", PV_WS_ACC16("+r"))
PV_WS_MMA(mma_s8, int, 32, "m64n64k32.s32.s8.s8", PV_WS_D32, "%32, %33",
          "%34", "", PV_WS_ACC32("+r"))

#undef PV_WS_MMA
#undef PV_WS_ACC32
#undef PV_WS_ACC16
#undef PV_WS_ACC8
#undef PV_WS_D32
#undef PV_WS_D16

// After wait_group 0 only: keeps the epilogue's reads of the accumulators
// below the wait that completes them.
template <int A>
__device__ __forceinline__ void fence_acc(float (&d)[A]) {
#pragma unroll
  for (int i = 0; i < A; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int A>
__device__ __forceinline__ void fence_acc(int (&d)[A]) {
#pragma unroll
  for (int i = 0; i < A; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Whether any of the `threads` threads at named barrier `id` passes `x`
// (a barrier of those threads too).
__device__ __forceinline__ bool any_of(bool x, int id, int threads) {
  uint32_t r;
  asm volatile(
      "{\n.reg .pred p, q;\nsetp.ne.u32 p, %1, 0;\n"
      "bar.red.or.pred q, %2, %3, p;\nselp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(r)
      : "r"((uint32_t)x), "r"(id), "r"(threads)
      : "memory");
  return r != 0;
}

// The lane's four rows of the segment at r0 (lane, +32, +64, +96): whether
// each is live (below `rows` and kept by the mask), and whether any row of
// the segment is (warp-uniform).
__device__ __forceinline__ bool segment_live(const uint8_t* __restrict__ mask,
                                             long r0, long rows, int lane,
                                             bool (&live)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const long r = r0 + lane + 32 * c;
    live[c] = r < rows && mask[r] != 0;
  }
  return __any_sync(FULL, live[0] | live[1] | live[2] | live[3]);
}

// 3xTF32's row split, run by the 128 threads of one consumer warpgroup on
// its `bytes` of a stage's float32 row tile: hi = x with the low 13 bits
// cleared (in place), lo = x - hi, at the same swizzled offsets of the
// warpgroup's lo buffer. The lo buffer is what the last stage's wgmmas
// read: the warpgroup's four warps have all waited for them when they meet
// at named barrier `bar`. The generic-proxy writes are fenced for wgmma's
// async proxy before the warpgroup meets there again.
template <int BYTES>
__device__ __forceinline__ void split_tf32(unsigned char* tile,
                                           unsigned char* lo_tile, int bar) {
  named_sync(bar, 128);
  float4* x = reinterpret_cast<float4*>(tile);
  float4* lo = reinterpret_cast<float4*>(lo_tile);
#pragma unroll
  for (int j = 0; j < BYTES / 16 / 128; ++j) {
    const int i = threadIdx.x % 128 + 128 * j;
    const float4 v = x[i];
    const float4 h = make_float4(
        __uint_as_float(__float_as_uint(v.x) & 0xffffe000u),
        __uint_as_float(__float_as_uint(v.y) & 0xffffe000u),
        __uint_as_float(__float_as_uint(v.z) & 0xffffe000u),
        __uint_as_float(__float_as_uint(v.w) & 0xffffe000u));
    x[i] = h;
    lo[i] = make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  named_sync(bar, 128);
}

// compact_buffers (common.cuh) run by the THREADS consumer threads alone,
// behind named barrier BAR: each of the first nq (<= NQ) buffers of BUF
// keys sorted descending, its best k kept, tau raised to its k-th key (a
// tile's buffers past its last query stay empty: nq skips their sort).
template <int NQ, int BUF, int BAR, int THREADS>
__device__ __forceinline__ void compact(u64* buf, int* cnt, u64* tau, int k,
                                        int nq = NQ) {
  const int tid = threadIdx.x;
  for (int t = tid; t < nq * BUF; t += THREADS)
    if (t % BUF >= cnt[t / BUF]) buf[t] = 0;
  named_sync(BAR, THREADS);
  for (int size = 2; size <= BUF; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < nq * BUF / 2; t += THREADS) {
        const int i = 2 * stride * (t / stride) + (t % stride);
        const int j = i + stride;
        const bool desc = ((i & (BUF - 1) & size) == 0);
        const u64 a = buf[i], b = buf[j];
        if (desc ? (a < b) : (a > b)) {
          buf[i] = b;
          buf[j] = a;
        }
      }
      named_sync(BAR, THREADS);
    }
  }
  if (tid < NQ) {
    const int c = min(cnt[tid], k);
    cnt[tid] = c;
    tau[tid] = c >= k ? buf[tid * BUF + k - 1] : 0ull;
  }
  named_sync(BAR, THREADS);
}


// ---------------------------------------------------------------------------
// The rows' producers of the scans over rows TMA cannot read (K4 and K3's
// tensor-core scan and its wide kinds, K7's over an IVF hot-tile table,
// K8's segment scan). Each writes a stage's 128 rows x 128 bytes the way
// TMA's 128B swizzle lays a box out, so the consumers do not change:
//  * PIECE 8 / 4: the producer warpgroup's 128 threads copy the stage by
//    cp.async in pieces of PIECE bytes (wg::cp_stage: zero-filled past the
//    row's end and past cap), where the row bytes and the base are
//    multiples of PIECE;
//  * PIECE 2, the realigning producer, any other rows: rows j, j + 16,
//    j + 32, ... of any matrix form a 2D tensor whose stride, 16 row bytes,
//    TMA takes, based at row j's start aligned down to 16 bytes (`off`
//    bytes before it); the elected thread loads each class's 8 rows of a
//    segment, 144 bytes of each row's span at k-stage kk, into a staging
//    slot (two slots, TMA running a slot ahead), and the warpgroup shifts
//    each row's 128 bytes into the ring's swizzled stage (wg::shift_pair at
//    any byte offset). TMA zero-fills past each class's last byte, so a
//    stage holds no byte of another row.
// Both arrive on a stage's full barrier once per thread (128) beside the
// elected thread's expect_tx for the query planes; the consumers fence the
// generic-proxy writes for wgmma's async proxy after their wait.

constexpr int PRODUCERS = 128;    // the producer warpgroup
constexpr int PRODUCER_BAR = 4;   // its named barrier (PIECE 2)
constexpr int PROWS = SEG;        // rows of a stage: a segment
constexpr int PROW_BYTES = 128;   // bytes of a row per k-stage
constexpr int PA_BYTES = PROWS * PROW_BYTES;  // a stage's rows: 16 KB

// The realigning producer: RCLASSES classes of rows, 8 rows of each a
// segment, each staged as its 144-byte span (128 bytes and up to 15 before
// them); two staging slots of 18 KB.
constexpr int RCLASSES = 16;
constexpr int RCLASS_ROWS = PROWS / RCLASSES;
constexpr int RSTAGE_ROW = 144;
constexpr int RSLOT = PROWS * RSTAGE_ROW;
constexpr int RSLOTS = 2;

// The rows' maps: TMA's (PIECE 0; unused by the cp.async producer), or
// the realigning producer's class maps, each class's `off` (bytes between
// its map's base and its first row; -1: the matrix has no row of the
// class) and the bytes of a slot's boxes.
struct RowTma {
  CUtensorMap v;
};
struct RowClasses {
  CUtensorMap v[RCLASSES];
  int off[RCLASSES];
  uint32_t slot_bytes;
};
template <int PIECE>
using RowMapsOf =
    typename std::conditional<PIECE == 2, RowClasses, RowTma>::type;

// Where a producer's walk stands: the stage's first row (a multiple of
// 128), its k-stage, and the query tile's first query (K8: the item's).
struct Pos {
  long r0;
  int kk, q0;
};

// The realigning producer's elected thread: the classes' boxes of the
// segment at row r0, k-stage kk (bk elements), into the slot at `slot`,
// reported to `bar`.
__device__ __forceinline__ void stage_rows(const RowClasses& m, uint32_t slot,
                                           uint32_t bar, long r0, int kk,
                                           int bk) {
  wg::mbar_expect_tx(bar, m.slot_bytes);
#pragma unroll 1
  for (int c = 0; c < RCLASSES; ++c)
    if (m.off[c] >= 0)
      wg::tma_load_2d(slot + c * RCLASS_ROWS * RSTAGE_ROW, &m.v[c], bar,
                      kk * bk, (int)(r0 / RCLASSES));
}

// Thread t (of the producer warpgroup's 128) moves 16-byte piece c = t % 8
// of the segment's rows j, j + 16, ..., j = t / 8 (all of class j, whose
// box holds them at j * 8 * RSTAGE_ROW), from the slot at `src` to the
// stage at `dst`, 128B-swizzled as TMA lays out a box of 128-byte rows:
// row r at r * 128, its chunk c at chunk c ^ (r % 8). `off` (bytes) the
// class's shift; < 0 where the class has no row: zeros.
__device__ __forceinline__ void realign_rows(uint32_t dst, uint32_t src, int t,
                                             int off) {
  constexpr int BATCH = 4;  // rows whose shared loads issue together
  const int c = t % 8, j = t / 8;
  const uint32_t from = src + j * RCLASS_ROWS * RSTAGE_ROW + 16 * c;
#pragma unroll
  for (int i0 = 0; i0 < RCLASS_ROWS; i0 += BATCH) {
    uint4 lo[BATCH], hi[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const uint32_t a = from + (i0 + u) * RSTAGE_ROW;
      lo[u] = wg::ld_shared_v4(a);
      hi[u] = wg::ld_shared_v4(a + 16);
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int r = j + RCLASSES * (i0 + u);
      const uint4 v = off >= 0 ? wg::shift_pair(lo[u], hi[u], off)
                               : make_uint4(0, 0, 0, 0);
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       dst + r * PROW_BYTES + ((c ^ (r & 7)) << 4)),
                   "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
    }
  }
}

// The producer warpgroup's loop (thread t of 128, PIECE 8 / 4 / 2) over a
// ring of S stages of PA_BYTES at `a_ring` behind `full` / `empty`
// barriers (8 bytes apart each). `next(p)` moves the walk to its next
// (stage row, k-stage, query tile) in `p` and returns false past its end;
// every thread calls it together (it may vote over a warp).
// `planes(st, p)` (called by thread 0) issues stage st's query planes by
// TMA with the stage's expect_tx. PIECE 2 stages its rows through the two
// slots at `slots`, reported to the barriers at `staged`; `vp` (the rows'
// base, rows of `row_bytes`, `cap` of them) feeds cp.async; bk elements a
// k-stage.
template <int PIECE, int S, class Next, class Planes>
__device__ __forceinline__ void produce_rows(
    const RowMapsOf<PIECE>& tv, Next&& next, Planes&& planes, uint32_t a_ring,
    uint32_t full, uint32_t empty, uint32_t slots, uint32_t staged,
    const unsigned char* vp, long cap, long row_bytes, int bk, int t) {
  static_assert(PIECE == 8 || PIECE == 4 || PIECE == 2, "non-TMA producers");
  uint32_t n = 0;
  Pos p{0, 0, 0};
  if constexpr (PIECE == 2) {
    const int off = tv.off[t / 8];  // this thread's rows' class shift
    // one walk: the elected thread stages each (segment, k-stage) into
    // the next slot as the walk reaches it, RSLOTS ahead of the shifts,
    // and the slot keeps its position (valid: the walk had not ended)
    bool valid[RSLOTS];
    Pos at[RSLOTS];
#pragma unroll
    for (int s = 0; s < RSLOTS; ++s) {
      valid[s] = next(p);
      at[s] = p;
      if (valid[s] && t == 0)
        stage_rows(tv, slots + s * RSLOT, staged + 8 * s, p.r0, p.kk, bk);
    }
    static_assert(RSLOTS == 2, "two slots, alternating");
    uint32_t sphase = 0;
    for (int slot = 0; valid[0] || valid[1]; slot ^= 1) {
      const bool on = slot ? valid[1] : valid[0];
      if (!on) break;  // the walk ended in this slot
      const Pos cur = slot ? at[1] : at[0];
      const int st = (int)(n % S);
      const uint32_t from = slots + slot * RSLOT;
      wg::mbar_wait(staged + 8 * slot, sphase);          // the boxes landed
      wg::mbar_wait(empty + 8 * st, ((n / S) & 1) ^ 1);  // first lap: free
      if (t == 0) planes(st, cur);
      realign_rows(a_ring + st * PA_BYTES, from, t, off);
      // the stores, for wgmma's async proxy, then this thread's arrival
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      wg::mbar_arrive(full + 8 * st);
      named_sync(PRODUCER_BAR, PRODUCERS);  // every thread read the slot
      const bool more = next(p);
      if (more && t == 0) {
        // the slot's generic reads before TMA's writes (async proxy)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        stage_rows(tv, from, staged + 8 * slot, p.r0, p.kk, bk);
      }
      if (slot) {
        valid[1] = more;
        at[1] = p;
        sphase ^= 1;
      } else {
        valid[0] = more;
        at[0] = p;
      }
      ++n;
    }
  } else {  // cp.async in pieces of PIECE bytes, then each thread arrives
    while (next(p)) {
      const int st = (int)(n % S);
      wg::mbar_wait(empty + 8 * st, ((n / S) & 1) ^ 1);  // first lap: free
      if (t == 0) planes(st, p);
      wg::cp_stage<PIECE, PROWS>(a_ring + st * PA_BYTES, vp + p.r0 * row_bytes,
                                 cap - p.r0, row_bytes, p.kk, t);
      wg::cp_async_arrive(full + 8 * st);
      ++n;
    }
  }
}

// The realigning producer's map of class j of the (rows, dim) row-major
// matrix of T's elements at `ptr` (any row bytes, any base): rows j, j +
// RCLASSES, ... as a 2D tensor of stride RCLASSES row bytes, based at row
// j's start aligned down to 16 bytes, read in boxes of RSTAGE_ROW bytes x
// RCLASS_ROWS rows, unswizzled, out-of-bounds elements zero; `*off` the
// bytes between its base and row j's start, -1 (and no map) where the
// matrix has no row j. TMA reads only the 16-byte chunks that hold a byte
// of the class's rows. 0, or minus the CUresult of a refused encode.
template <class T>
int encode_row_class(wg::EncodeTiled enc, CUtensorMap* map, const void* ptr,
                     long long rows, int dim, int j, int* off) {
  if (rows <= j) {
    *off = -1;
    return 0;
  }
  const long long row_bytes = (long long)dim * T::ELEM_BYTES;
  const uintptr_t start = (uintptr_t)ptr + j * row_bytes;
  const uintptr_t base = start & ~(uintptr_t)15;
  *off = (int)(start - base);
  const cuuint64_t gdim[2] = {
      (cuuint64_t)((row_bytes + *off) / T::ELEM_BYTES),
      (cuuint64_t)((rows - j + RCLASSES - 1) / RCLASSES)};
  const cuuint64_t gstride[1] = {(cuuint64_t)(RCLASSES * row_bytes)};
  const cuuint32_t box[2] = {(cuuint32_t)(RSTAGE_ROW / T::ELEM_BYTES),
                             (cuuint32_t)RCLASS_ROWS};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = enc(map, T::TMA_TYPE, 2, reinterpret_cast<void*>(base),
                         gdim, gstride, box, estride,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// The realigning producer's class maps of the (cap, dim) rows at v. A
// map holds only the base, the shape and the strides, so the last few
// matrices' maps are kept and reused instead of sixteen host encodes a
// launch: keyed by (v, cap, dim), a cache for each row type.
template <class T>
int row_classes(wg::EncodeTiled enc, RowClasses* out, const void* v,
                long long cap, int dim) {
  struct Entry {
    const void* v;
    long long cap;
    int dim;
    RowClasses maps;
  };
  static Entry cache[4];
  static int used = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (cache[i].v == v && cache[i].cap == cap && cache[i].dim == dim) {
      *out = cache[i].maps;
      return 0;
    }
  RowClasses m{};
  for (int j = 0; j < RCLASSES; ++j) {
    const int err = encode_row_class<T>(enc, &m.v[j], v, cap, dim, j,
                                        &m.off[j]);
    if (err) return err;
    if (m.off[j] >= 0) m.slot_bytes += RCLASS_ROWS * RSTAGE_ROW;
  }
  Entry& e = cache[used < 4 ? used++ : (int)(((uintptr_t)v >> 8) % 4)];
  e = Entry{v, cap, dim, m};
  *out = m;
  return 0;
}

// Rows of `dim` elements of `es` bytes as TMA reads them: `*q` itself where
// its rows are whole 16 bytes at a 16-byte aligned base; else copied to
// dst as rows of dim rounded up to 16 bytes, zeros past dim (a memset and
// one 2D copy on the stream, in the launcher's scratch), and `*q` set to
// dst.
inline cudaError_t tma_rows(const void** q, void* dst, int Q, int dim, int es,
                            cudaStream_t s) {
  const size_t rb = (size_t)dim * es;
  if (rb % 16 == 0 && (uintptr_t)*q % 16 == 0) return cudaSuccess;
  const size_t ld = (rb + 15) / 16 * 16;
  cudaError_t e = cudaMemsetAsync(dst, 0, (size_t)Q * ld, s);
  if (e == cudaSuccess)
    e = cudaMemcpy2DAsync(dst, ld, *q, rb, rb, Q, cudaMemcpyDeviceToDevice, s);
  if (e == cudaSuccess) *q = dst;
  return e;
}

// Elements of a query plane's row for rows of `dim` elements of `es`
// bytes: dim rounded up to whole 16 bytes, which TMA reads (the launchers
// pad the planes to it, zeros past dim).
inline int plane_ld(int dim, int es) {
  const int per = 16 / es;
  return (dim + per - 1) / per * per;
}

// Calls f with the rows' producer `piece` (0 TMA, 8 / 4 cp.async, 2 the
// realigning producer; ops/scan.py::rows_piece) as a
// std::integral_constant; any other piece is refused.
template <class F>
int with_piece(int piece, F&& f) {
  switch (piece) {
    case 0: return f(std::integral_constant<int, 0>());
    case 8: return f(std::integral_constant<int, 8>());
    case 4: return f(std::integral_constant<int, 4>());
    case 2: return f(std::integral_constant<int, 2>());
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace ws
}  // namespace
}  // namespace pv
