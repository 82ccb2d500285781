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
//    the consumer warpgroups alone (K4, K6).
#pragma once

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

}  // namespace ws
}  // namespace
}  // namespace pv
