// The first, unpipelined score tiles of the segment kernels and the
// dot-floor probe P1: one block scores BQ = 64 queries against one 128-row
// corpus segment from shared-memory tiles that all 256 threads load with
// synchronous 16-byte copies, on the tensor cores (bf16 wmma 16x16x16 ->
// f32, or int8 mma.sync m16n8k32 -> s32), and leaves the (BQ, 128) score
// tile in shared memory for the caller's epilogue. The int8 tile serves
// K5, K10, K8's int8 kind and P1-int8 at widths TMA cannot read (dim % 16
// != 0); the bf16 tile serves K8's bf16 kind and K1 / P1-bf16 at widths
// TMA cannot read (dim % 8 != 0). K1 and P1 otherwise run the TMA + wgmma
// mainloop of wgmma_tiles.cuh.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace pv {
namespace {

using namespace nvcuda;

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
  if (vec) {  // 16-byte aligned rows: 16-byte loads
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

// The (BQ, 128) score tile of queries q0.. against corpus rows r0.. with
// bf16 wmma, left as float32 in `smem` (BQ x LDS), which during the k-loop
// holds the A/B operand tiles. Ends with a barrier.
__device__ __forceinline__ void score_tile_bf16(
    unsigned char* smem, const __nv_bfloat16* __restrict__ q,
    const __nv_bfloat16* __restrict__ v, int q0, int Q, long r0, long cap,
    int dim) {
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BQ * LDA;
  float* Ss = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2, wn = warp % 2;
  // 16-byte loads need 16-byte rows and bases (a view may start anywhere)
  const bool vec = dim % 8 == 0 && ((uintptr_t)q | (uintptr_t)v) % 16 == 0;

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
}

constexpr int KC8 = 128;        // int8 elements per k-step
constexpr int LDA8 = KC8 + 16;  // padded row (bytes): 36 words, so the 8
                                // rows a fragment load touches hit 8
                                // different 4-bank groups

__device__ __forceinline__ void load_tile_i8(int8_t* dst, const int8_t* src,
                                             long row0, long nrows, int rows,
                                             int k0, int dim, bool vec) {
  if (vec) {  // 16-byte aligned rows: 16-byte loads
    constexpr int VPR = KC8 / 16;
    for (int i = threadIdx.x; i < rows * VPR; i += THREADS) {
      int r = i / VPR, c = (i % VPR) * 16;
      long gr = row0 + r;
      int gk = k0 + c;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gr < nrows && gk < dim)
        val = *reinterpret_cast<const uint4*>(src + gr * dim + gk);
      *reinterpret_cast<uint4*>(dst + r * LDA8 + c) = val;
    }
  } else {
    for (int i = threadIdx.x; i < rows * KC8; i += THREADS) {
      int r = i / KC8, c = i % KC8;
      long gr = row0 + r;
      int gk = k0 + c;
      dst[r * LDA8 + c] = (gr < nrows && gk < dim) ? src[gr * dim + gk] : 0;
    }
  }
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The (BQ, 128) int32 score tile of int8 queries q0.. against int8 rows
// r0.. with mma.sync s8, left in `smem` (BQ x LDS ints). Ends with a
// barrier.
__device__ __forceinline__ void score_tile_i8(
    unsigned char* smem, const int8_t* __restrict__ q,
    const int8_t* __restrict__ v, int q0, int Q, long r0, long cap, int dim) {
  int8_t* As = reinterpret_cast<int8_t*>(smem);
  int8_t* Bs = As + BQ * LDA8;
  int* Ss = reinterpret_cast<int*>(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;  // 16 queries x 64 rows per warp
  const int g = lane >> 2, t = lane & 3;   // mma groupID, thread in group
  const bool vec = dim % 16 == 0 && ((uintptr_t)q | (uintptr_t)v) % 16 == 0;

  int acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;

  for (int k0 = 0; k0 < dim; k0 += KC8) {
    load_tile_i8(As, q, q0, Q, BQ, k0, dim, vec);
    load_tile_i8(Bs, v, r0, cap, BN, k0, dim, vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KC8; kk += 32) {
      // A (16 x 32, row-major): rows g and g + 8, bytes 4t..4t+3 and
      // 16 + 4t..16 + 4t + 3
      const int8_t* a = As + (wm * 16 + g) * LDA8 + kk + 4 * t;
      const uint32_t a0 = lds32(a), a1 = lds32(a + 8 * LDA8);
      const uint32_t a2 = lds32(a + 16), a3 = lds32(a + 8 * LDA8 + 16);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // B = v^T (32 x 8, col-major): corpus row n = g of the n-tile,
        // bytes 4t..4t+3 and 16 + 4t..16 + 4t + 3
        const int8_t* b = Bs + (wn * 64 + j * 8 + g) * LDA8 + kk + 4 * t;
        const uint32_t b0 = lds32(b), b1 = lds32(b + 16);
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
            "{%0, %1, %2, %3};\n"
            : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]),
              "+r"(acc[j][3])
            : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      }
    }
    __syncthreads();
  }
  // accumulator (16 x 8 per n-tile): c0, c1 at row g, columns 2t, 2t+1;
  // c2, c3 at row g + 8
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int* s = Ss + (wm * 16 + g) * LDS + wn * 64 + j * 8 + 2 * t;
    s[0] = acc[j][0];
    s[1] = acc[j][1];
    s[8 * LDS] = acc[j][2];
    s[8 * LDS + 1] = acc[j][3];
  }
  __syncthreads();
}

}  // namespace
}  // namespace pv
