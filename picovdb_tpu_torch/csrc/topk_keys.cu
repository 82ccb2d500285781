// K2 topk_packed_keys: per-query top-k_sel of the segmax key slab, and the
// merge step of scan_topk (K3/K4).
//
// Replaces picovdb_tpu/ops/pallas_scan.py:topk_packed_keys
// (`_topk_keys_kernel`). Per query it selects the k_sel (<= 32) largest
// packed keys of its (2 * cap / 128)-key row, in descending order, with
// their columns; where keys are equal the larger column leaves first, and
// every entry leaves once, as `lax.top_k` / `torch.topk` count
// multiplicity. The TPU kernel's Q % 128 requirement came from Mosaic's
// lane tiling and does not exist here.
//
// What bounds it on the H100: it reads the slab once (Q x C int32: 130 MB
// at Q = 2048 over 1M rows, 4 MB at Q = 64) and does little arithmetic per
// key, so it is bound by device-memory bandwidth, and at small Q by how
// many SMs it keeps busy. The split-row warp select (`warp_select_kernel`)
// gives one warp one chunk of one row (`scan.topk_keys_chunk`: chunks of
// whole 512 keys, about 1,024 warps a launch, so Q = 64 spreads over the
// 132 SMs and Q = 2048 reads each row in one chunk). A lane loads 4 keys
// a step (16-byte loads, four steps in flight) and compares each key's
// 64-bit composite ((key ^ 0x80000000) << 32 | column: distinct, and
// ordered as the tie rule orders) with the warp's current k-th best
// (`tau`) in a register; the few that pass enter a warp-private queue in
// shared memory through `__ballot_sync`. When the queue holds 32 it is
// sorted and merged with the warp's 32 held keys (one a lane) by bitonic
// steps of shuffles, and tau is refreshed. No block barrier anywhere.
// The chunks' top-k_sel lists of a row go to a scratch slab; the last
// warp of the row (an atomic ticket) merges them by the same warp merge
// and writes the result. Slots past the candidates hold KEY_MIN and
// column 0.
//
// MODE 1 / 2 of `row_topk_kernel` (k up to 1024) are the merge of
// scan_topk's partial selections: one 256-thread block a row streams the
// row into a shared-memory buffer above the running k-th best and
// bitonic-sorts it when it fills.

#include "common.cuh"

namespace pv {
namespace {

constexpr int THREADS = 256;

// MODE 1: 64-bit selection keys of scan_topk's partial results; writes
//         decoded scores and rows.
// MODE 2: MODE 1 over int_row_key keys (int32 scores).
template <int BUF, int MODE>
__global__ void __launch_bounds__(THREADS)
row_topk_kernel(const u64* __restrict__ in, long L, int k, float* out_a,
                int* out_b) {
  __shared__ u64 buf[BUF];
  __shared__ int cnt[1];
  __shared__ u64 tau[1];
  const long row = blockIdx.x;
  if (threadIdx.x == 0) {
    cnt[0] = 0;
    tau[0] = 0ull;
  }
  __syncthreads();
  for (long base = 0; base < L; base += THREADS) {
    const long i = base + threadIdx.x;
    if (i < L) {
      const u64 key = in[row * L + i];
      if (key > tau[0]) buf[atomicAdd(&cnt[0], 1)] = key;
    }
    __syncthreads();
    const bool full = cnt[0] > BUF - THREADS;
    __syncthreads();
    if (full) compact_buffers(buf, cnt, tau, 1, BUF, k);
  }
  compact_buffers(buf, cnt, tau, 1, BUF, k);
  for (int j = threadIdx.x; j < k; j += THREADS) {
    const u64 key = buf[j];  // 0 past the candidates: -inf / row 0
    out_a[row * k + j] =
        MODE == 2 ? int_row_key_score(key) : row_key_score(key);
    out_b[row * k + j] = row_key_row(key);
  }
}

// ---------------------------------------------------------------------------
// The split-row warp select (MODE 0's successor: K2's kernel).
// ---------------------------------------------------------------------------

constexpr int SEL_WARPS = 8;    // warps a block
constexpr int SEL_UNROLL = 4;   // 16-byte loads in flight a lane
constexpr int SEL_STEP = 128;   // keys a warp reads a step (32 lanes x 4)
constexpr int SEL_QUEUE = 32 + SEL_STEP - 1 + 1;  // < 32 held over + a step

__device__ __forceinline__ u64 shfl_xor_u64(u64 v, int m) {
  const uint32_t lo = __shfl_xor_sync(0xffffffffu, (uint32_t)v, m);
  const uint32_t hi = __shfl_xor_sync(0xffffffffu, (uint32_t)(v >> 32), m);
  return ((u64)hi << 32) | lo;
}

__device__ __forceinline__ u64 shfl_u64(u64 v, int src) {
  const uint32_t lo = __shfl_sync(0xffffffffu, (uint32_t)v, src);
  const uint32_t hi = __shfl_sync(0xffffffffu, (uint32_t)(v >> 32), src);
  return ((u64)hi << 32) | lo;
}

// The 32 keys of a warp (one a lane) sorted descending: lane 0 the largest.
__device__ __forceinline__ u64 warp_sort_desc(u64 x, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1) {
      const u64 y = shfl_xor_u64(x, stride);
      // blocks of `size` alternate direction; the last one descends
      const bool desc = (lane & size) == 0, low = (lane & stride) == 0;
      x = (low == desc) ? (x > y ? x : y) : (x < y ? x : y);
    }
  return x;
}

// The 32 largest of two descending warp lists a and b, descending: the
// lane-wise max of a and b reversed is bitonic, then five merge steps.
__device__ __forceinline__ u64 warp_merge_desc(u64 a, u64 b, int lane) {
  const u64 r = shfl_u64(b, 31 - lane);
  u64 x = a > r ? a : r;
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    const u64 y = shfl_xor_u64(x, stride);
    const bool low = (lane & stride) == 0;
    x = low ? (x > y ? x : y) : (x < y ? x : y);
  }
  return x;
}

// The composite of key `kv` at column `i`: unsigned order is (key, column)
// order; 0 (KEY_MIN at column 0, or no key) is below every candidate.
__device__ __forceinline__ u64 composite(int kv, long i) {
  return ((u64)((uint32_t)kv ^ 0x80000000u) << 32) | (u64)(uint32_t)i;
}

// One warp a (query, chunk of `chunk` keys). VEC: 16-byte loads (C % 4
// == 0 and an aligned slab). `partial` (Q, S, k) and `ticket` (Q,),
// zeroed, are used only where a row has S > 1 chunks.
template <bool VEC>
__global__ void __launch_bounds__(SEL_WARPS * 32)
warp_select_kernel(const int* __restrict__ keys, long C, int k, long chunk,
                   int S, int Q, u64* __restrict__ partial,
                   int* __restrict__ ticket, int* __restrict__ out_keys,
                   int* __restrict__ out_cols) {
  __shared__ u64 queues[SEL_WARPS][SEL_QUEUE];
  const int lane = threadIdx.x % 32, wib = threadIdx.x / 32;
  const long w = (long)blockIdx.x * SEL_WARPS + wib;
  if (w >= (long)Q * S) return;  // whole warps
  const int q = (int)(w / S), s = (int)(w % S);
  const int* row = keys + (long)q * C;
  const long c0 = (long)s * chunk, c1 = min(c0 + chunk, C);
  u64* queue = queues[wib];
  const unsigned below = (1u << lane) - 1;
  u64 held = 0, tau = 0;
  int qn = 0;  // the queue's fill, the same in every lane

  // steps a pass: SEL_UNROLL 16-byte loads in flight, or one step of
  // element loads (a ragged or misaligned slab)
  constexpr int U = VEC ? SEL_UNROLL : 1;
  for (long b = c0; b < c1; b += U * SEL_STEP) {
    // the keys of this lane's 4 a step left in the chunk (<= 0: none)
    const long left = c1 - b - 4 * lane;
    int4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int* p = row + b + u * SEL_STEP + 4 * lane;
      const long n = left - u * SEL_STEP;
      if (VEC && n >= 4) {
        v[u] = __ldcs(reinterpret_cast<const int4*>(p));
      } else {
        v[u].x = n > 0 ? p[0] : 0;
        v[u].y = n > 1 ? p[1] : 0;
        v[u].z = n > 2 ? p[2] : 0;
        v[u].w = n > 3 ? p[3] : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long i = b + u * SEL_STEP + 4 * lane;
      const long n = left - u * SEL_STEP;
      const int kv[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      // composite > tau, word by word: almost every key fails on its key
      const uint32_t thi = (uint32_t)(tau >> 32), tlo = (uint32_t)tau;
      bool pass[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const uint32_t hi = (uint32_t)kv[e] ^ 0x80000000u;
        pass[e] = e < n &&
                  (hi > thi || (hi == thi && (uint32_t)(i + e) > tlo));
      }
      if (!__any_sync(0xffffffffu, pass[0] | pass[1] | pass[2] | pass[3]))
        continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned m = __ballot_sync(0xffffffffu, pass[e]);
        if (pass[e]) queue[qn + __popc(m & below)] = composite(kv[e], i + e);
        qn += __popc(m);
      }
      if (qn >= 32) {  // merge the queue into the held keys
        __syncwarp();
        for (int j = 0; j < qn; j += 32) {
          const u64 x = j + lane < qn ? queue[j + lane] : 0;
          held = warp_merge_desc(held, warp_sort_desc(x, lane), lane);
        }
        __syncwarp();
        qn = 0;
        tau = shfl_u64(held, k - 1);
      }
    }
  }
  if (qn > 0) {
    __syncwarp();
    const u64 x = lane < qn ? queue[lane] : 0;
    held = warp_merge_desc(held, warp_sort_desc(x, lane), lane);
  }
  if (S > 1) {
    u64* mine = partial + ((long)q * S + s) * k;
    if (lane < k) mine[lane] = held;
    __threadfence();
    __syncwarp();
    int t = 0;
    if (lane == 0) t = atomicAdd(ticket + q, 1);
    if (__shfl_sync(0xffffffffu, t, 0) != S - 1) return;  // not the last
    __threadfence();
    // the last warp of the row: merge the S descending lists, loaded
    // SEL_UNROLL at a time
    const u64* lists = partial + (long)q * S * k;
    held = 0;
    tau = 0;
    for (int j0 = 0; j0 < S; j0 += SEL_UNROLL) {
      u64 x[SEL_UNROLL];
#pragma unroll
      for (int u = 0; u < SEL_UNROLL; ++u)
        x[u] = j0 + u < S && lane < k
                   ? __ldcg(lists + (long)(j0 + u) * k + lane) : 0;
#pragma unroll
      for (int u = 0; u < SEL_UNROLL; ++u) {
        if (!__any_sync(0xffffffffu, x[u] > tau)) continue;
        held = warp_merge_desc(held, x[u], lane);
        tau = shfl_u64(held, k - 1);
      }
    }
  }
  if (lane < k) {
    out_keys[(long)q * k + lane] = (int)((uint32_t)(held >> 32) ^ 0x80000000u);
    out_cols[(long)q * k + lane] = (int)(uint32_t)held;
  }
}

}  // namespace

cudaError_t launch_topk_merge(const u64* partial, float* vals, int* idx,
                              int nrows, int L, int k, cudaStream_t stream,
                              bool int_scores) {
  if (k <= 128 && int_scores)
    row_topk_kernel<512, 2><<<nrows, THREADS, 0, stream>>>(partial, L, k,
                                                           vals, idx);
  else if (k <= 128)
    row_topk_kernel<512, 1><<<nrows, THREADS, 0, stream>>>(partial, L, k,
                                                           vals, idx);
  else if (int_scores)
    row_topk_kernel<2048, 2><<<nrows, THREADS, 0, stream>>>(partial, L, k,
                                                            vals, idx);
  else
    row_topk_kernel<2048, 1><<<nrows, THREADS, 0, stream>>>(partial, L, k,
                                                            vals, idx);
  return cudaGetLastError();
}

}  // namespace pv

// keys (Q, C) int32 -> out_keys, out_cols (Q, k) int32, 1 <= k <= min(C,
// 32), in chunks of `chunk` keys (a multiple of 512). Where a row has S =
// ceil(C / chunk) > 1 chunks, `scratch` holds Q S k + ceil(Q / 2) u64
// (the chunks' lists, then the rows' tickets, which this launcher zeroes
// on the stream); else it may be null. Returns a cudaError_t.
extern "C" int pv_topk_packed_keys(const void* keys, void* out_keys,
                                   void* out_cols, void* scratch, int Q,
                                   long long C, int k, long long chunk,
                                   void* stream) {
  using namespace pv;
  if (Q <= 0) return (int)cudaSuccess;
  if (k < 1 || k > 32 || k > C || chunk <= 0 ||
      chunk % (SEL_UNROLL * SEL_STEP))
    return (int)cudaErrorInvalidValue;
  const long long S = (C + chunk - 1) / chunk;
  if (S > 1 && !scratch) return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)Q * S + SEL_WARPS - 1) / SEL_WARPS;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const bool vec = C % 4 == 0 && (uintptr_t)keys % 16 == 0;
  const int* in = static_cast<const int*>(keys);
  u64* part = static_cast<u64*>(scratch);
  int* tick = S > 1 ? reinterpret_cast<int*>(part + (long long)Q * S * k)
                    : nullptr;
  int* ok = static_cast<int*>(out_keys);
  int* oc = static_cast<int*>(out_cols);
  cudaStream_t st = (cudaStream_t)stream;
  if (tick) {
    const cudaError_t e = cudaMemsetAsync(tick, 0, sizeof(int) * Q, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (vec)
    warp_select_kernel<true><<<(unsigned)blocks, SEL_WARPS * 32, 0, st>>>(
        in, (long)C, k, (long)chunk, (int)S, Q, part, tick, ok, oc);
  else
    warp_select_kernel<false><<<(unsigned)blocks, SEL_WARPS * 32, 0, st>>>(
        in, (long)C, k, (long)chunk, (int)S, Q, part, tick, ok, oc);
  return (int)cudaGetLastError();
}
