// Pass B of the wide kinds (128 < k <= 1024): an exact per-query radix
// select over a slab of 32-bit sortable score keys, reading the mask beside
// them. K4's wide kind (topk_wide.cu, whose head comment sets out the
// design), K6's (topk_i4_wide.cu), K3's (topk_i8_wide.cu) and K7's
// (ivf_scan_wide.cu) run it on the slab their tensor-core scan's pass A
// writes: `select_tile` launches, per tile of nq queries, hist_kernel<0..2>
// (11 / 11 / 10-bit digit histograms, the deeper levels only while more
// than CAP keys reach the k-th's bucket), collect_kernel (the keys at or
// above that bucket as row_keys) and finish_kernel (their sort, the ties
// past CAP taken in row order), writing the best k decoded (`Decode`: the
// key's score as float32 or int32, the slab row as itself or through a
// hot-tile table). Exact at every k, ties to the lower slab row.
//
// `walk_ranges` runs it over a plane's rows in ranges of R rows (R a whole
// number of 128-row segments, sized by ops/scan.py::topk_wide_plan so a
// query tile's slab keeps within its budget past 64M rows): per range
// pass A and pass B as above, the finish writing each range's best k as
// 64-bit selection keys with the range's first row added, then one
// launch_topk_merge a query tile over the (tile, ranges, k) partial. The
// keys order by (score, row) across ranges as within one, so ties still go
// to the lower row.

#pragma once

#include <algorithm>

#include "common.cuh"

namespace pv {
namespace {
namespace rs {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CAP = 8192;            // candidates a query the finish sorts
constexpr int BINS = 2048;           // a digit's histogram (11 bits)
constexpr int LEVELS = 3;            // digits of 11, 11 and 10 bits
constexpr int HIST = LEVELS * BINS + 4;  // a query's histograms + count
constexpr int READERS = 256;         // threads of a reading CTA
constexpr int FINISH = 1024;         // threads of the finishing CTA
constexpr int FINISH_SMEM = (CAP + CAP / 16) * 8;  // its sort's keys, padded

// Level l's digit: (key >> SHIFT[l]) & MASK[l]; the bits above it are the
// prefix resolved by levels 0 .. l - 1.
__device__ __forceinline__ int shift_of(int l) {
  return l == 0 ? 21 : l == 1 ? 10 : 0;
}
__device__ __forceinline__ int width_of(int l) { return l == 2 ? 10 : 11; }

// Rows r .. r + 3 (r % 4 == 0, mask 4-byte aligned): bit c set where row
// r + c is below cap and kept by the mask.
__device__ __forceinline__ uint32_t live4(const uint8_t* __restrict__ mask,
                                          long r, long cap) {
  if (r + 4 <= cap) {
    const uint32_t m = *reinterpret_cast<const uint32_t*>(mask + r);
    return (uint32_t)((m & 0xffu) != 0) | (uint32_t)((m & 0xff00u) != 0) << 1 |
           (uint32_t)((m & 0xff0000u) != 0) << 2 | (uint32_t)((m >> 24) != 0) << 3;
  }
  uint32_t b = 0;
  for (int c = 0; c < 4; ++c)
    if (r + c < cap && mask[r + c]) b |= 1u << c;
  return b;
}

// Inclusive prefix sum of x over the block's threads in thread order
// (blockDim.x a multiple of 32); sm holds 32 ints. Every thread calls it.
__device__ __forceinline__ int block_scan_incl(int x, int* sm) {
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sm[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? sm[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    sm[lane] = s;
  }
  __syncthreads();
  const int r = x + (w > 0 ? sm[w - 1] : 0);
  __syncthreads();
  return r;
}

// Over a level's BINS counts h (global), the digit d holding the kk-th
// largest counted key (kk clamped to the count), with the keys above it.
// d = -1 where nothing is counted. Every thread calls it; sm holds 36 ints.
__device__ __forceinline__ void find_digit(const uint32_t* h, int kk_in,
                                           int* sm, int* d, int* above,
                                           int* kk) {
  const int per = BINS / blockDim.x;
  const int hi = BINS - 1 - (int)threadIdx.x * per;  // digits hi, hi - 1, ..
  int sum = 0;
  for (int i = 0; i < per; ++i) sum += (int)h[hi - i];
  const int incl = block_scan_incl(sum, sm);
  if (threadIdx.x == blockDim.x - 1) sm[32] = incl;
  __syncthreads();
  const int want = min(kk_in, sm[32]);
  const int excl = incl - sum;
  if (want > 0 && excl < want && want <= incl) {
    int c = excl;
    for (int i = 0; i < per; ++i) {
      const int hv = (int)h[hi - i];
      if (c + hv >= want) {
        sm[33] = hi - i;
        sm[34] = c;
        break;
      }
      c += hv;
    }
  }
  __syncthreads();
  *kk = want;
  *d = want > 0 ? sm[33] : -1;
  *above = want > 0 ? sm[34] : 0;
  __syncthreads();
}

// A query's selection after the levels resolved so far.
struct Sel {
  int level;        // deepest level resolved; -1: no live key
  uint32_t prefix;  // key >> shift_of(level) of the bucket of the kk-th key
  int above;        // live keys above the bucket
  int bucket;       // live keys in it
  int kk;           // rank in the bucket of the last key kept (1-based)
  bool ready;       // nothing more to count: collect, or take ties
  bool ties;        // level 2 and above + bucket > CAP: the keys equal to
                    // the prefix are taken in row order
};

// Resolves levels 0 .. levels - 1 from the query's histograms `hq` for the
// best k, stopping at the first level whose keys at or above its bucket
// number at most CAP. Every thread calls it and gets the same result.
__device__ Sel resolve(const uint32_t* hq, int k, int levels, int* sm) {
  Sel s{-1, 0u, 0, 0, 0, true, false};
  int kk = k;
  for (int l = 0; l < levels; ++l) {
    int d, above;
    find_digit(hq + l * BINS, kk, sm, &d, &above, &kk);
    if (d < 0) return s;  // level 0 counted no live key
    s.level = l;
    s.prefix = l == 0 ? (uint32_t)d : (s.prefix << width_of(l)) | (uint32_t)d;
    s.above += above;
    kk -= above;
    s.kk = kk;
    s.bucket = (int)hq[l * BINS + d];
    const bool fits = s.above + s.bucket <= CAP;
    s.ready = fits || l == LEVELS - 1;
    s.ties = !fits && l == LEVELS - 1;
    if (s.ready) return s;
  }
  return s;
}

// Level L's histogram of the query's live keys whose bits above digit L
// equal the prefix levels 0 .. L - 1 resolved; a CTA a (slice, query),
// flushed to hist[q][L] by global atomics. Returns at once where the
// earlier levels already resolved the query.
template <int L>
__global__ void __launch_bounds__(READERS)
hist_kernel(const uint32_t* __restrict__ slab, const uint8_t* __restrict__ mask,
            uint32_t* __restrict__ hist, long cap, long ld, int k) {
  __shared__ uint32_t h[BINS];
  __shared__ int sm[40];
  const int q = blockIdx.y;
  uint32_t* hq = hist + (long)q * HIST;
  uint32_t prefix = 0;
  if constexpr (L > 0) {
    const Sel s = resolve(hq, k, L, sm);
    if (s.ready) return;
    prefix = s.prefix;
  }
  for (int i = threadIdx.x; i < BINS; i += READERS) h[i] = 0;
  __syncthreads();
  const uint32_t* row = slab + (long)q * ld;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int WARPS = READERS / 32;
  const long segs = ld / SEG;
  for (long seg = (long)blockIdx.x * WARPS + warp; seg < segs;
       seg += (long)gridDim.x * WARPS) {
    const long r = seg * SEG + 4 * lane;
    const uint32_t lv = live4(mask, r, cap);
    if (!__any_sync(FULL, lv != 0)) continue;
    if (!lv) continue;
    const uint4 kv = *reinterpret_cast<const uint4*>(row + r);
    const uint32_t ks[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint32_t key = ks[c];
      bool in = (lv >> c) & 1u;
      if constexpr (L > 0)
        in = in && (key >> (shift_of(L) + width_of(L))) == prefix;
      if (in)
        atomicAdd(&h[(key >> shift_of(L)) & ((1u << width_of(L)) - 1)], 1u);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BINS; i += READERS)
    if (h[i]) atomicAdd(&hq[L * BINS + i], h[i]);
}

// Appends the query's live keys at or above the resolved bucket (above the
// full key where ties are taken by row) as row_keys to its candidate list
// cand[q], counted at hist[q][LEVELS * BINS].
__global__ void __launch_bounds__(READERS)
collect_kernel(const uint32_t* __restrict__ slab,
               const uint8_t* __restrict__ mask, uint32_t* __restrict__ hist,
               u64* __restrict__ cand, long cap, long ld, int k) {
  __shared__ int sm[40];
  const int q = blockIdx.y;
  uint32_t* hq = hist + (long)q * HIST;
  const Sel s = resolve(hq, k, LEVELS, sm);
  if (s.level < 0) return;
  const u64 lo = s.ties ? (u64)s.prefix + 1
                        : (u64)s.prefix << shift_of(s.level);
  uint32_t* cnt = hq + LEVELS * BINS;
  u64* cq = cand + (long)q * CAP;
  const uint32_t* row = slab + (long)q * ld;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int WARPS = READERS / 32;
  const long segs = ld / SEG;
  for (long seg = (long)blockIdx.x * WARPS + warp; seg < segs;
       seg += (long)gridDim.x * WARPS) {
    const long r = seg * SEG + 4 * lane;
    const uint32_t lv = live4(mask, r, cap);
    if (!__any_sync(FULL, lv != 0)) continue;
    if (!lv) continue;
    const uint4 kv = *reinterpret_cast<const uint4*>(row + r);
    const uint32_t ks[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (((lv >> c) & 1u) && (u64)ks[c] >= lo) {
        const uint32_t slot = atomicAdd(cnt, 1u);
        if (slot < (uint32_t)CAP)
          cq[slot] = ((u64)ks[c] << 32) | (u64)(0xFFFFFFFFu - (uint32_t)(r + c));
      }
  }
}

// The ties path: the first `need` live rows of the query's slab row whose
// key equals t, in row order, as row_keys at out[0 ..); returns how many.
// Every thread of the block calls it.
__device__ int take_ties(const uint32_t* __restrict__ row,
                         const uint8_t* __restrict__ mask, long cap, long ld,
                         uint32_t t, int need, u64* out, int* sm) {
  int taken = 0;
  for (long t0 = 0; t0 < cap && taken < need; t0 += 4L * FINISH) {
    const long r = t0 + 4L * threadIdx.x;
    uint32_t hit = 0;
    if (r < ld) {
      const uint32_t lv = live4(mask, r, cap);
      if (lv) {
        const uint4 kv = *reinterpret_cast<const uint4*>(row + r);
        const uint32_t ks[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (((lv >> c) & 1u) && ks[c] == t) hit |= 1u << c;
      }
    }
    const int c = __popc(hit);
    const int incl = block_scan_incl(c, sm);
    int pos = taken + incl - c;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if ((hit >> b) & 1u) {
        if (pos < need)
          out[pos] = ((u64)t << 32) | (u64)(0xFFFFFFFFu - (uint32_t)(r + b));
        ++pos;
      }
    if (threadIdx.x == FINISH - 1) sm[35] = incl;
    __syncthreads();
    taken += sm[35];
    __syncthreads();
  }
  return min(taken, need);
}

__device__ __forceinline__ u64 shfl_xor_u64(u64 v, int m) {
  const uint32_t lo = __shfl_xor_sync(FULL, (uint32_t)v, m);
  const uint32_t hi = __shfl_xor_sync(FULL, (uint32_t)(v >> 32), m);
  return ((u64)hi << 32) | lo;
}

// One step of the bitonic network on the key x at index i whose partner
// (index i ^ stride) holds y: blocks of `size` end descending where
// (i & size) == 0, so the lower index keeps the larger key there.
__device__ __forceinline__ u64 bitonic_pick(u64 x, u64 y, int i, int stride,
                                            int size) {
  const bool lower = (i & stride) == 0, desc = (i & size) == 0;
  return (lower == desc) ? (x > y ? x : y) : (x < y ? x : y);
}

// Shared-memory slot of key i in the sort's exchanges: one u64 of padding
// every 16 keys, so a warp's stores of keys 8 t + e (e fixed) fall on
// distinct bank pairs.
__device__ __forceinline__ int pad16(int i) { return i + (i >> 4); }

// The P keys (P a power of two, 32 SORT_E <= P <= CAP) cq[0 .. n) padded
// with 0 sorted descending into buf[0 .. P): the bitonic network of
// block_sort_desc (common.cuh) with thread t holding keys SORT_E t ..
// SORT_E t + SORT_E - 1 in registers; strides below SORT_E run in
// registers, below 32 SORT_E by warp shuffles, the rest through shared
// memory (padded slots), a barrier pair a step. Every thread of the block
// calls it; it ends with a barrier.
constexpr int SORT_E = 8;
constexpr int LOG_CAP = 13;  // CAP = 8192
__device__ void sort_desc(const u64* __restrict__ cq, int n, int P, u64* buf) {
  const int t = threadIdx.x;
  const bool act = t * SORT_E < P;  // whole warps: P / SORT_E >= 32
  u64 x[SORT_E];
#pragma unroll
  for (int e = 0; e < SORT_E; ++e) {
    const int i = t * SORT_E + e;
    x[e] = act && i < n ? cq[i] : 0ull;
  }
#pragma unroll
  for (int ls = 1; ls <= LOG_CAP; ++ls) {
    const int size = 1 << ls;
    if (size > P) break;
#pragma unroll
    for (int lst = ls - 1; lst >= 0; --lst) {
      const int stride = 1 << lst;
      if (stride >= 32 * SORT_E) {
        __syncthreads();  // the last exchange's reads are done
        if (act)
#pragma unroll
          for (int e = 0; e < SORT_E; ++e) buf[pad16(t * SORT_E + e)] = x[e];
        __syncthreads();
        if (act)
#pragma unroll
          for (int e = 0; e < SORT_E; ++e) {
            const int i = t * SORT_E + e;
            x[e] = bitonic_pick(x[e], buf[pad16(i ^ stride)], i, stride, size);
          }
      } else if (stride >= SORT_E) {
        if (act)
#pragma unroll
          for (int e = 0; e < SORT_E; ++e)
            x[e] = bitonic_pick(x[e], shfl_xor_u64(x[e], stride / SORT_E),
                                t * SORT_E + e, stride, size);
      } else if (act) {
#pragma unroll
        for (int e = 0; e < SORT_E; ++e)
          if (!(e & stride)) {
            const int i = t * SORT_E + e;
            const u64 a = x[e], b = x[e | stride];
            x[e] = bitonic_pick(a, b, i, stride, size);
            x[e | stride] = bitonic_pick(b, a, i | stride, stride, size);
          }
      }
    }
  }
  __syncthreads();
  if (act)
#pragma unroll
    for (int e = 0; e < SORT_E; ++e) buf[t * SORT_E + e] = x[e];
  __syncthreads();
}

// How the finish writes a key: its score (the high word of a row_key, or
// of an int_row_key where int_scores: K7's int8 postings rank the exact
// int32 sum) and its row (the slab row, or where hot is set, slab row l is
// IVF row hot[l / bn] * bn + l % bn: K7's slab is indexed by logical row).
struct Decode {
  const int* hot = nullptr;
  int bn = 1;
  int int_scores = 0;
  // where set (a range walk), the best k go as selection keys to
  // keys[q * key_ld + j] (0 past them), rows offset by row0, not decoded
  u64* keys = nullptr;
  long key_ld = 0;
  long row0 = 0;
};

// One CTA a query: its candidates sorted by row_key (`sort_desc`; the
// ties path appends the equal keys in row order behind the keys above
// them), the best k written decoded to vals / idx (-inf / 0 past them), or
// as keys where `dec.keys` is set.
__global__ void __launch_bounds__(FINISH)
finish_kernel(const uint32_t* __restrict__ slab,
              const uint8_t* __restrict__ mask,
              const uint32_t* __restrict__ hist, const u64* __restrict__ cand,
              float* __restrict__ vals, int* __restrict__ idx, long cap,
              long ld, int k, const Decode dec) {
  extern __shared__ u64 buf[];  // pad16(CAP) keys
  __shared__ int sm[40];
  const int q = blockIdx.x;
  const uint32_t* hq = hist + (long)q * HIST;
  const Sel s = resolve(hq, k, LEVELS, sm);
  const int n = s.level < 0 ? 0 : min((int)hq[LEVELS * BINS], CAP);
  int p = 32 * SORT_E;
  while (p < n) p <<= 1;
  sort_desc(cand + (long)q * CAP, n, p, buf);
  int total = n;
  if (s.ties)
    total += take_ties(slab + (long)q * ld, mask, cap, ld, s.prefix, s.kk,
                       buf + n, sm);
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += FINISH) {
    const u64 key = j < total ? buf[j] : 0ull;
    int row = row_key_row(key);
    if (dec.hot && key) row = dec.hot[row / dec.bn] * dec.bn + row % dec.bn;
    if (dec.keys) {
      dec.keys[(long)q * dec.key_ld + j] =
          key ? (key & 0xFFFFFFFF00000000ull) |
                    (u64)(0xFFFFFFFFu - (uint32_t)(row + dec.row0))
              : 0ull;
      continue;
    }
    vals[(long)q * k + j] =
        dec.int_scores ? int_row_key_score(key) : row_key_score(key);
    idx[(long)q * k + j] = row;
  }
}

// A query tile's select: slab (nq, ld) keys of rows [0, cap) (ld = cap
// rounded up to 128), mask (cap,) uint8 4-byte aligned, hist (nq, HIST)
// zeroed before, cand (nq, CAP) scratch; vals / idx (nq, k) receive the
// best k decoded by `dec` (-inf / 0 past the live rows). ~4 reading CTAs
// an SM of `sms`.
inline cudaError_t select_tile(const uint32_t* slab, const uint8_t* mask,
                               uint32_t* hist, u64* cand, float* vals,
                               int* idx, int nq, long cap, long ld, int k,
                               int sms, cudaStream_t s,
                               const Decode dec = {}) {
  if (cap > 0) {
    const long segs = ld / SEG;
    const long want = (4L * sms + nq - 1) / nq;  // ~4 CTAs an SM
    const int split = (int)std::max(
        1L, std::min(want, (segs + READERS / 32 - 1) / (READERS / 32)));
    const dim3 grid(split, nq);
    hist_kernel<0><<<grid, READERS, 0, s>>>(slab, mask, hist, cap, ld, k);
    hist_kernel<1><<<grid, READERS, 0, s>>>(slab, mask, hist, cap, ld, k);
    hist_kernel<2><<<grid, READERS, 0, s>>>(slab, mask, hist, cap, ld, k);
    collect_kernel<<<grid, READERS, 0, s>>>(slab, mask, hist, cand, cap, ld,
                                            k);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  finish_kernel<<<nq, FINISH, FINISH_SMEM, s>>>(slab, mask, hist, cand, vals,
                                                idx, cap, ld, k, dec);
  return cudaGetLastError();
}

// The current device's SM count, and finish_kernel's dynamic shared
// memory set on it: once a launcher's call.
inline cudaError_t prepare(int* sms) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(finish_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FINISH_SMEM);
  return e;
}

// The query planes pass A multiplies, from the float32 queries q (rows x
// dim) written as rows x ld (ld >= dim, zeros past dim, so a plane row is
// whole 16 bytes where TMA needs it): kind 0 hi = q with its low 13
// mantissa bits cleared and lo = q - hi (ops/scan.py::split_tf32), kind 1
// three bf16 planes q1 = bf16(q), q2 = bf16(q - q1), q3 = bf16(q - q1 -
// q2) (ops/scan.py::split_bf16), planes `total` = rows x ld elements
// apart. K4's and K7's wide kinds split their float queries with it (K7
// takes kind 0 alone: its bf16 kind multiplies one plane, the queries as
// they are).
__global__ void __launch_bounds__(256)
planes_kernel(const float* __restrict__ q, void* __restrict__ planes,
              long total, int dim, int ld, int kind) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long)gridDim.x * blockDim.x) {
    const long row = i / ld;
    const int col = (int)(i - row * ld);
    const float x = col < dim ? q[row * dim + col] : 0.0f;
    if (kind == 0) {
      float* f = static_cast<float*>(planes);
      const float h = __uint_as_float(__float_as_uint(x) & 0xffffe000u);
      f[i] = h;
      f[total + i] = x - h;
    } else {
      __nv_bfloat16* b = static_cast<__nv_bfloat16*>(planes);
      const __nv_bfloat16 q1 = __float2bfloat16_rn(x);
      const float r = x - __bfloat162float(q1);
      const __nv_bfloat16 q2 = __float2bfloat16_rn(r);
      b[i] = q1;
      b[total + i] = q2;
      b[2 * total + i] = __float2bfloat16_rn(r - __bfloat162float(q2));
    }
  }
}

// planes_kernel over rows x ld elements, at most 4 CTAs an SM of `sms`.
inline cudaError_t split_planes(const float* q, void* planes, long rows,
                                int dim, int ld, int kind, int sms,
                                cudaStream_t s) {
  const long total = rows * ld;
  planes_kernel<<<(int)std::min((total + 255) / 256, 4L * sms), 256, 0, s>>>(
      q, planes, total, dim, ld, kind);
  return cudaGetLastError();
}

// Bytes of one tile's histograms and candidates at q_tile queries.
inline size_t hist_bytes(int q_tile) {
  return (size_t)q_tile * HIST * sizeof(uint32_t);
}
inline size_t cand_bytes(int q_tile) {
  return (size_t)q_tile * CAP * sizeof(u64);
}

inline size_t up256(size_t b) { return (b + 255) / 256 * 256; }

// One query tile's scratch: its slab (q_tile x ld keys), histograms and
// candidates, each from a 256-byte boundary (ops/scan.py::
// i4_wide_scratch restates it).
struct Tile {
  size_t hist, cand, bytes;  // offsets; the slab at 0
};
inline Tile tile_layout(int q_tile, long ld) {
  Tile t;
  t.hist = up256((size_t)q_tile * ld * sizeof(uint32_t));
  t.cand = t.hist + up256(hist_bytes(q_tile));
  t.bytes = t.cand + cand_bytes(q_tile);
  return t;
}

inline long up_seg(long rows) { return (rows + SEG - 1) / SEG * SEG; }

// Ranges of range_rows rows over [0, cap): one where range_rows >= cap.
inline long range_count(long cap, long range_rows) {
  return cap > range_rows ? (cap + range_rows - 1) / range_rows : 1;
}

// Bytes of a walk's scratch past the query planes (ops/scan.py::
// wide_walk_scratch restates it): one tile's `tile_layout` over a range's
// rows, then, where there are several ranges, the tile's partial of
// q_tile x ranges x k keys from a 256-byte boundary.
inline size_t walk_bytes(int q_tile, long cap, long range_rows, int k) {
  const long ranges = range_count(cap, range_rows);
  const size_t b = tile_layout(q_tile, ranges == 1 ? up_seg(cap)
                                                   : range_rows).bytes;
  return ranges == 1 ? b : up256(b) + (size_t)q_tile * ranges * k * 8;
}

// Every wide kind's walk over its Q queries in tiles of q_tile and its cap
// rows in ranges of range_rows (a multiple of SEG; one range where it is at
// least cap, ld then the slab's row length): for each query tile and range
// the tile's histograms zeroed with one memset, `pass_a(q0, nq, r0, rows,
// slab)` writing the slab of queries [q0, q0 + nq) over rows [r0, r0 +
// rows) (returns 0 or an error), then their select over the range's mask.
// One range: the select writes rows [q0, q0 + nq) of vals / idx (Q, k)
// decoded by `dec`. Several: it writes each range's best k as keys, rows
// offset by r0, to the tile's partial, and launch_topk_merge merges them
// into vals / idx. `tile` (256-byte aligned) holds `walk_bytes`; `sms` from
// `prepare`. Returns 0, a cudaError_t, or pass A's error.
template <class PassA>
int walk_ranges(unsigned char* tile, const uint8_t* mask, float* vals,
                int* idx, int Q, int q_tile, long cap, long ld,
                long range_rows, int k, int sms, cudaStream_t s,
                PassA pass_a, const Decode dec = {}) {
  const long ranges = range_count(cap, range_rows);
  const Tile t = tile_layout(q_tile, ranges == 1 ? ld : range_rows);
  uint32_t* slab = reinterpret_cast<uint32_t*>(tile);
  uint32_t* hist = reinterpret_cast<uint32_t*>(tile + t.hist);
  u64* cand = reinterpret_cast<u64*>(tile + t.cand);
  u64* partial = reinterpret_cast<u64*>(tile + up256(t.bytes));
  for (int q0 = 0; q0 < Q; q0 += q_tile) {
    const int nq = std::min(q_tile, Q - q0);
    for (long r = 0; r < ranges; ++r) {
      const long r0 = r * range_rows;
      const long rows = ranges == 1 ? cap : std::min(range_rows, cap - r0);
      cudaError_t e = cudaMemsetAsync(hist, 0, hist_bytes(nq), s);
      if (e != cudaSuccess) return (int)e;
      const int err = pass_a(q0, nq, r0, rows, slab);
      if (err) return err;
      Decode d = dec;
      if (ranges > 1) {
        d.keys = partial + r * k;
        d.key_ld = ranges * k;
        d.row0 = r0;
      }
      e = select_tile(slab, mask + r0, hist, cand, vals + (size_t)q0 * k,
                      idx + (size_t)q0 * k, nq, rows,
                      ranges == 1 ? ld : up_seg(rows), k, sms, s, d);
      if (e != cudaSuccess) return (int)e;
    }
    if (ranges > 1) {
      const cudaError_t e = launch_topk_merge(
          partial, vals + (size_t)q0 * k, idx + (size_t)q0 * k, nq,
          (int)(ranges * k), k, s, dec.int_scores != 0);
      if (e != cudaSuccess) return (int)e;
    }
  }
  return (int)cudaSuccess;
}

// `walk_ranges` over one range: the slab rows [0, cap) of length ld, pass
// A called as `pass_a(q0, nq, slab)` (K3's, K9's and K7's wide kinds).
template <class PassA>
int walk_tiles(unsigned char* tile, const uint8_t* mask, float* vals,
               int* idx, int Q, int q_tile, long cap, long ld, int k,
               int sms, cudaStream_t s, PassA pass_a,
               const Decode dec = {}) {
  return walk_ranges(
      tile, mask, vals, idx, Q, q_tile, cap, ld, std::max(cap, 1L), k, sms,
      s, [&](int q0, int nq, long, long, uint32_t* slab) {
        return pass_a(q0, nq, slab);
      },
      dec);
}

}  // namespace rs
}  // namespace
}  // namespace pv
