// Shared pieces of the exact-scan selection kernels (sm_90a).
//
// Two key encodings travel between the kernels:
//
//  * the packed segment key of the segmax tier (int32): the score's float32
//    bits made order-preserving (`to_sortable`), with the low 7 bits
//    replaced by the row's lane inside its 128-row segment; masked rows
//    carry KEY_MIN. Bit for bit the encoding of picovdb_tpu's
//    ops/pallas_scan.py (`_to_sortable`, `& ~127 | lane`).
//  * the 64-bit selection key (uint64): an order-preserving image of the
//    float32 score in the high word and a tie-breaker in the low word, so
//    one unsigned comparison orders (score, tie-break) and every key of a
//    row is distinct. 0 marks an empty slot and sorts below every real key.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace pv {

typedef unsigned long long u64;

constexpr int KEY_MIN = (int)0x80000000;
constexpr int SEG = 128;

__device__ __forceinline__ int to_sortable(int bits) {
  return bits >= 0 ? bits : bits ^ 0x7FFFFFFF;
}

// float32 -> uint32 whose unsigned order is the float order.
__device__ __forceinline__ uint32_t float_order(float s) {
  uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float order_float(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

// Selection key of a scored row: higher score first, then lower row.
__device__ __forceinline__ u64 row_key(float score, uint32_t row) {
  return ((u64)float_order(score) << 32) | (u64)(0xFFFFFFFFu - row);
}

__device__ __forceinline__ float row_key_score(u64 key) {
  return key ? order_float((uint32_t)(key >> 32)) : -__int_as_float(0x7f800000);
}

__device__ __forceinline__ int row_key_row(u64 key) {
  return key ? (int)(0xFFFFFFFFu - (uint32_t)key) : 0;
}

// Descending bitonic sort of `total / len` independent segments of `len`
// (a power of two) entries each, stored back to back in shared memory.
// Every thread of the block must call it; it ends with a barrier.
__device__ __forceinline__ void block_sort_desc(u64* buf, int total, int len) {
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < total / 2; t += blockDim.x) {
        int i = 2 * stride * (t / stride) + (t % stride);
        int j = i + stride;
        bool desc = ((i & (len - 1) & size) == 0);
        u64 a = buf[i], b = buf[j];
        if (desc ? (a < b) : (a > b)) {
          buf[i] = b;
          buf[j] = a;
        }
      }
      __syncthreads();
    }
  }
}

// Streaming top-k of `nseg` candidate buffers in shared memory. Each
// buffer keeps its candidates unordered in [0, cnt) and admits only keys
// above its threshold `tau` (the k-th best key seen so far, 0 until k
// keys arrived). `compact` sorts every buffer, keeps its best k and raises
// tau; callers compact before a buffer could overflow.
__device__ __forceinline__ void compact_buffers(u64* buf, int* cnt, u64* tau,
                                                int nseg, int len, int k) {
  for (int t = threadIdx.x; t < nseg * len; t += blockDim.x) {
    if (t % len >= cnt[t / len]) buf[t] = 0;
  }
  __syncthreads();
  block_sort_desc(buf, nseg * len, len);
  if (threadIdx.x < nseg) {
    int c = min(cnt[threadIdx.x], k);
    cnt[threadIdx.x] = c;
    tau[threadIdx.x] = (c >= k) ? buf[threadIdx.x * len + k - 1] : 0ull;
  }
  __syncthreads();
}

// Top-k merge of per-chunk partial selections: `partial` holds, for each
// of `nrows` queries, `L` 64-bit selection keys (0 = empty); the k best
// per query come out decoded as float32 scores (-inf when empty) and
// int32 rows (0 when empty). Launched by pv_scan_topk after the scan.
cudaError_t launch_topk_merge(const u64* partial, float* vals, int* idx,
                              int nrows, int L, int k, cudaStream_t stream);

}  // namespace pv
