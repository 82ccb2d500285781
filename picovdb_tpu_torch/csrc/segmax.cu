// K1 segmax_scan: per-128-row-segment top-2 packed keys over the bf16
// scan mirror.
//
// Replaces picovdb_tpu/ops/pallas_scan.py:segmax_scan (`_segmax_kernel`).
// For every (query, 128-row segment) it scores q . v with bf16 inputs and
// float32 accumulation, packs each score into the int32 segment key
// (sortable float bits, low 7 bits = lane; masked rows KEY_MIN, masking
// applied after packing as in the TPU kernel) and emits the segment's two
// largest keys. Output layout is (Q, 2 * cap / 128) int32 with column
// 2 * seg + r (r = 0 best, 1 second); the caller decodes a winner's row as
// seg * 128 + (key & 127).
//
// What bounds it on the H100: at the main-path shape (Q = 2048 per chunk,
// 1M x 1024 bf16 mirror) it is a 4.3 TFLOP matrix product whose output is
// 2/128 of the score matrix, so it is bound by tensor-core throughput,
// not by bytes. The design keeps the score tile out of device memory:
// one block scores 64 queries x one 128-row segment with mma.sync (wmma
// bf16 16x16x16 -> f32) from shared-memory tiles, and reduces the tile to
// its two keys per query in the epilogue (one warp per query row, warp
// shuffles). Blocks carry no state, so the TPU's two grid orders
// (classic / stream) are the same launch here; query tiles vary fastest
// so the blocks reading one segment run together and share it in L2.
// A first, simple kernel: no TMA, no wgmma, no pipelining yet.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace pv {
namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BN = SEG;       // corpus rows per block (one segment)
constexpr int KC = 64;        // bf16 elements per k-step
constexpr int LDA = KC + 8;   // padded smem row (elements), wmma ldm % 8 == 0
constexpr int LDS = BN + 4;   // padded f32 score row, wmma ldm % 4 == 0
constexpr int THREADS = 256;  // 8 warps: 4 (query) x 2 (row halves)

__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long row0, long nrows, int rows,
                                          int k0, int dim, bool vec) {
  if (vec) {  // dim % 8 == 0: 16-byte loads
    constexpr int VPR = KC / 8;
    for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
      int r = i / VPR, c = (i % VPR) * 8;
      long gr = row0 + r;
      int gk = k0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < nrows && gk < dim)
        val = *reinterpret_cast<const uint4*>(src + gr * dim + gk);
      *reinterpret_cast<uint4*>(dst + r * LDA + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * KC; i += THREADS) {
      int r = i / KC, c = i % KC;
      long gr = row0 + r;
      int gk = k0 + c;
      dst[r * LDA + c] = (gr < nrows && gk < dim) ? src[gr * dim + gk]
                                                  : __float2bfloat16(0.0f);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
segmax_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ v,
              const uint8_t* __restrict__ mask, int* __restrict__ keys,
              int Q, long cap, int dim, int q_tiles) {
  // A/B operand tiles during the k-loop, then the f32 score tile.
  __shared__ __align__(128) unsigned char smem[BQ * LDS * sizeof(float)];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BQ * LDA;
  float* Ss = reinterpret_cast<float*>(smem);

  const int qt = blockIdx.x % q_tiles;
  const long seg = blockIdx.x / q_tiles;
  const int q0 = qt * BQ;
  const long r0 = seg * BN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const bool vec = (dim % 8) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.0f);

  for (int k0 = 0; k0 < dim; k0 += KC) {
    load_tile(As, q, q0, Q, BQ, k0, dim, vec);
    load_tile(Bs, v, r0, cap, BN, k0, dim, vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, As + (wm * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // B = v^T: element (k, n) sits at Bs[n * LDA + k] -> col_major
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> b;
        wmma::load_matrix_sync(b, Bs + (wn * 64 + j * 16) * LDA + kk, LDA);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wmma::store_matrix_sync(Ss + (wm * 16) * LDS + wn * 64 + j * 16, acc[j],
                            LDS, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: lane l owns lanes l, l+32, l+64, l+96 of the segment.
  bool live[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) live[c] = mask[r0 + lane + 32 * c] != 0;
  const long ncol = 2 * (cap / SEG);
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= Q) break;  // uniform across the warp
    int m1 = KEY_MIN, m2 = KEY_MIN;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ln = lane + 32 * c;
      int key = (to_sortable(__float_as_int(Ss[r * LDS + ln])) & ~(SEG - 1)) | ln;
      if (!live[c]) key = KEY_MIN;  // after packing, as the TPU kernel does
      if (key > m1) {
        m2 = m1;
        m1 = key;
      } else if (key > m2) {
        m2 = key;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      int o1 = __shfl_xor_sync(0xffffffffu, m1, off);
      int o2 = __shfl_xor_sync(0xffffffffu, m2, off);
      int n2 = max(min(m1, o1), max(m2, o2));
      m1 = max(m1, o1);
      m2 = n2;
    }
    if (lane == 0) {
      keys[(long)qi * ncol + 2 * seg] = m1;
      keys[(long)qi * ncol + 2 * seg + 1] = m2;
    }
  }
}

}  // namespace
}  // namespace pv

// q (Q, dim) bf16, v (cap, dim) bf16 with cap % 128 == 0, mask (cap,)
// uint8 -> keys (Q, 2 * cap / 128) int32. Returns the cudaError_t of the
// launch.
extern "C" int pv_segmax_scan(const void* q, const void* v, const void* mask,
                              void* keys, int Q, long long cap, int dim,
                              void* stream) {
  using namespace pv;
  const int q_tiles = (Q + BQ - 1) / BQ;
  const long long blocks = (long long)q_tiles * (cap / SEG);
  if (Q <= 0 || cap <= 0) return (int)cudaSuccess;
  segmax_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(v), static_cast<const uint8_t*>(mask),
      static_cast<int*>(keys), Q, (long)cap, dim, q_tiles);
  return (int)cudaGetLastError();
}
