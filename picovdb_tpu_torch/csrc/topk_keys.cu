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
// at Q = 2048 over 1M rows) and does little arithmetic per key, so it is
// bound by device-memory bandwidth. One 256-thread block streams one
// query row with coalesced loads; each key is compared against the running
// k-th best key (`tau`) and only keys above it enter a shared-memory
// buffer, which is bitonic-sorted and cut back to k when it fills. After
// the first few tiles almost every key fails the one comparison, so the
// block runs at the speed of its loads.

#include "common.cuh"

namespace pv {
namespace {

constexpr int THREADS = 256;

// MODE 0: int32 packed keys, tie-break on the larger column; writes keys
//         and columns.
// MODE 1: 64-bit selection keys of scan_topk's partial results; writes
//         decoded scores and rows.
template <int BUF, int MODE>
__global__ void __launch_bounds__(THREADS)
row_topk_kernel(const void* __restrict__ in, long L, int k, void* out_a,
                void* out_b) {
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
      u64 key;
      if (MODE == 0) {
        const int kv = static_cast<const int*>(in)[row * L + i];
        key = ((u64)((uint32_t)kv ^ 0x80000000u) << 32) | (u64)(uint32_t)i;
      } else {
        key = static_cast<const u64*>(in)[row * L + i];
      }
      if (key > tau[0]) buf[atomicAdd(&cnt[0], 1)] = key;
    }
    __syncthreads();
    const bool full = cnt[0] > BUF - THREADS;
    __syncthreads();
    if (full) compact_buffers(buf, cnt, tau, 1, BUF, k);
  }
  compact_buffers(buf, cnt, tau, 1, BUF, k);
  for (int j = threadIdx.x; j < k; j += THREADS) {
    const u64 key = buf[j];  // 0 past the candidates: KEY_MIN / column 0
    if (MODE == 0) {
      static_cast<int*>(out_a)[row * k + j] =
          (int)((uint32_t)(key >> 32) ^ 0x80000000u);
      static_cast<int*>(out_b)[row * k + j] = (int)(uint32_t)key;
    } else {
      static_cast<float*>(out_a)[row * k + j] = row_key_score(key);
      static_cast<int*>(out_b)[row * k + j] = row_key_row(key);
    }
  }
}

}  // namespace

cudaError_t launch_topk_merge(const u64* partial, float* vals, int* idx,
                              int nrows, int L, int k, cudaStream_t stream) {
  if (k <= 128)
    row_topk_kernel<512, 1><<<nrows, THREADS, 0, stream>>>(partial, L, k,
                                                           vals, idx);
  else
    row_topk_kernel<2048, 1><<<nrows, THREADS, 0, stream>>>(partial, L, k,
                                                            vals, idx);
  return cudaGetLastError();
}

}  // namespace pv

// keys (Q, C) int32 -> out_keys, out_cols (Q, k) int32, k <= 32.
extern "C" int pv_topk_packed_keys(const void* keys, void* out_keys,
                                   void* out_cols, int Q, long long C, int k,
                                   void* stream) {
  using namespace pv;
  if (Q <= 0) return (int)cudaSuccess;
  row_topk_kernel<512, 0><<<Q, THREADS, 0, (cudaStream_t)stream>>>(
      keys, (long)C, k, out_keys, out_cols);
  return (int)cudaGetLastError();
}
