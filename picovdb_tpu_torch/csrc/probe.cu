// P1 dot_rowmax: the dot-product floor of the segment kernels, with no
// segment extraction.
//
// Replaces the Pallas kernel `dot_only` of bench/segmax_sweep_probe.py
// (`_dot_kernel`, `_dot_kernel_i8`), which times the matrix product of the
// batch segmax sweep at K1's tiling without its epilogue. Here the product
// is K1's: the persistent TMA + wgmma mainloop of wgmma_tiles.cuh (128
// queries x 256 rows per tile) for bf16 with dim % 8 == 0 and for int8
// with dim % 16 == 0, whose epilogue `RowmaxTileEpi` keeps each query's
// maximum over the tile in registers (a thread's 64 scores of the row, then
// its quad by shuffles); at other widths K5's / K1's first score tile
// (tiles.cuh: 64 queries x one 128-row segment per block, mma.sync s8 ->
// s32 or wmma bf16 -> f32) and a warp's maximum of each tile row. Either
// way the maxima combine across blocks by atomicMax on the sortable key
// (float32: to_sortable of its bits; int8: the int32 sum itself) into a
// (Q,) int32 output that the caller fills with KEY_MIN first.
//
// This deviates from the TPU kernel, which keeps only the maximum of its
// last corpus tile, a guard against dead-code elimination. Over all rows
// the output is a function of every block and has a plain version:
// (q.float() @ v.float().T).amax(1), exact integers for int8.
//
// What bounds it on the H100: the tensor cores' issue rate (2 Q cap dim
// operations against a few hundred MB of operands), which is what it
// measures: the time K1 / K5 / K10 would take with a free epilogue. The
// int8 kind runs the mainloop K5 and K10 are to move onto.

#include "tiles.cuh"
#include "wgmma_tiles.cuh"

namespace pv {
namespace {

__device__ __forceinline__ int rowmax_key(float s) {
  return to_sortable(__float_as_int(s));
}
__device__ __forceinline__ int rowmax_key(int s) { return s; }

// P1's epilogue on the wgmma accumulators (layout: wgmma_tiles.cuh), for
// either kind: per row the largest key (float32: sortable bits; int32: the
// raw sum) over the tile's columns inside cap (cap % 256 == 128 leaves a
// last tile's second segment out: its zero-filled rows must not enter the
// max), the quad's maximum, one atomicMax per row below Q.
struct RowmaxTileEpi {
  int* __restrict__ out;

  template <class A>
  __device__ __forceinline__ void tile(A (&acc)[wg::ACC], int q0, long r0,
                                       int Q, long cap) const {
    const int lane = threadIdx.x % 32;
    const int row = q0 + 64 * (threadIdx.x / 128) +
                    16 * ((threadIdx.x / 32) % 4) + lane / 4;
    const int nseg = r0 + SEG < cap ? 2 : 1;  // uniform across the CTA
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int m = KEY_MIN;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (s >= nseg) break;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            m = max(m, rowmax_key(acc[4 * (16 * s + j) + 2 * h + e]));
      }
      m = max(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = max(m, __shfl_xor_sync(0xffffffffu, m, 2));
      const int q = row + 8 * h;
      if (lane % 4 == 0 && q < Q) atomicMax(&out[q], m);
    }
  }
};

// The block's (BQ, 128) tile -> per query the maximum key, one warp per
// query row, merged into out[qi] with atomicMax.
template <bool INT>
__device__ __forceinline__ void tile_rowmax(const unsigned char* smem,
                                            int* __restrict__ out, int Q,
                                            int q0) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= Q) break;  // uniform across the warp
    int m = KEY_MIN;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ln = lane + 32 * c;
      const int key =
          INT ? reinterpret_cast<const int*>(smem)[r * LDS + ln]
              : to_sortable(__float_as_int(
                    reinterpret_cast<const float*>(smem)[r * LDS + ln]));
      m = max(m, key);
    }
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) atomicMax(&out[qi], m);
  }
}

template <bool INT>
__global__ void __launch_bounds__(THREADS)
dot_rowmax_kernel(const void* __restrict__ q, const void* __restrict__ v,
                  int* __restrict__ out, int Q, long cap, int dim,
                  int q_tiles) {
  __shared__ __align__(128) unsigned char smem[BQ * LDS * sizeof(float)];
  const int qt = blockIdx.x % q_tiles;
  const long seg = blockIdx.x / q_tiles;
  const int q0 = qt * BQ;
  if constexpr (INT)
    score_tile_i8(smem, static_cast<const int8_t*>(q),
                  static_cast<const int8_t*>(v), q0, Q, seg * BN, cap, dim);
  else
    score_tile_bf16(smem, static_cast<const __nv_bfloat16*>(q),
                    static_cast<const __nv_bfloat16*>(v), q0, Q, seg * BN,
                    cap, dim);
  tile_rowmax<INT>(smem, out, Q, q0);
}

}  // namespace
}  // namespace pv

// kind 0: q (Q, dim) and v (cap, dim) bfloat16 -> out[i] = the sortable
// float32 key of max_r q_i . v_r; kind 1: both int8 -> out[i] = max_r of
// the int32 sums. cap % 128 == 0; out (Q,) int32 must hold KEY_MIN on
// entry. Returns the cudaError_t of the launch.
extern "C" int pv_dot_rowmax(int kind, const void* q, const void* v,
                             void* out, int Q, long long cap, int dim,
                             void* stream) {
  using namespace pv;
  if (Q <= 0 || cap <= 0) return (int)cudaSuccess;
  if (cap % SEG) return (int)cudaErrorInvalidValue;
  const int q_tiles = (Q + BQ - 1) / BQ;
  const long long blocks = (long long)q_tiles * (cap / SEG);
  cudaStream_t s = (cudaStream_t)stream;
  int* o = static_cast<int*>(out);
  if (kind == 0)
    dot_rowmax_kernel<false><<<(unsigned)blocks, THREADS, 0, s>>>(
        q, v, o, Q, (long)cap, dim, q_tiles);
  else if (kind == 1)
    dot_rowmax_kernel<true><<<(unsigned)blocks, THREADS, 0, s>>>(
        q, v, o, Q, (long)cap, dim, q_tiles);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// P1 on the TMA + wgmma mainloop: pv_dot_rowmax's contract, kind 0 (bf16)
// for dim % 8 == 0, kind 1 (int8) for dim % 16 == 0, 16-byte aligned q and
// v. Returns 0, a cudaError_t, or minus the CUresult of a refused
// tensor-map encode.
extern "C" int pv_dot_rowmax_wgmma(int kind, const void* q, const void* v,
                                   void* out, int Q, long long cap, int dim,
                                   void* stream) {
  using namespace pv;
  if (cap % SEG) return (int)cudaErrorInvalidValue;
  const RowmaxTileEpi epi{static_cast<int*>(out)};
  const cudaStream_t s = (cudaStream_t)stream;
  if (kind == 0) return wg::launch_tiles<wg::Bf16>(q, v, epi, Q, cap, dim, s);
  if (kind == 1) return wg::launch_tiles<wg::Int8>(q, v, epi, Q, cap, dim, s);
  return (int)cudaErrorInvalidValue;
}
