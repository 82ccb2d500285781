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
// not by bytes. Where TMA can read the operands (dim % 8 == 0, 16-byte
// aligned bases) the product is the persistent TMA + wgmma mainloop of
// wgmma_tiles.cuh (128 queries x 256 rows per tile, a 4-stage ring, two
// consumer warpgroups), and `SegmaxTileEpi` reduces each thread's
// accumulator registers to the two keys per query and segment: the
// thread's top 2 of its 32 scores, merged across the quad of lanes that
// share the row by shuffles. No score leaves the registers. Other widths
// keep the first kernel, `segmax_kernel`: one block scores 64 queries x
// one 128-row segment with wmma bf16 16x16x16 from unpipelined
// shared-memory tiles (tiles.cuh) and reduces the tile in shared memory.
// Neither carries state between tiles, so the TPU's two grid orders
// (classic / stream) are the same launch here; query tiles vary fastest
// so the blocks reading one segment run together and share it in L2.
//
// K5 segmax_scan_i8 and K10 segmax_scan_i8c (below) are the wmma kernel
// over a per-row int8 corpus and over the column-scaled int8 mirror. The
// wmma and mma.sync score tiles live in tiles.cuh, shared with K8 and the
// dot-floor probe P1, whose two kinds also run on wgmma_tiles.cuh (bf16
// and int8 instantiations of one mainloop, the int8 one the product K5 and
// K10 are to move onto).

#include "tiles.cuh"
#include "wgmma_tiles.cuh"

namespace pv {
namespace {

// K1's epilogue on the wgmma accumulators (layout: wgmma_tiles.cuh). For
// each of its two rows and each segment of the tile that lies inside cap
// (cap % 256 == 128 leaves a last tile's second segment out), a thread
// packs its 32 scores of the segment (key (to_sortable(bits) & ~127) |
// lane, KEY_MIN for masked rows after packing, as segment_top2 and the TPU
// kernel do), keeps its top 2, merges them with the three other lanes of
// its quad and the quad leader writes keys[q, 2 seg] and [q, 2 seg + 1].
// Rows past Q write nothing.
struct SegmaxTileEpi {
  const uint8_t* __restrict__ mask;
  int* __restrict__ keys;
  long ncol;  // 2 * cap / 128

  __device__ __forceinline__ void tile(float (&acc)[wg::ACC], int q0, long r0,
                                       int Q, long cap) const {
    const int lane = threadIdx.x % 32, quad = lane % 4;
    const int row = q0 + 64 * (threadIdx.x / 128) +
                    16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const long seg = r0 / SEG + s;
      if (seg * SEG >= cap) break;  // uniform across the CTA
      uint32_t live = 0;  // bit 2 j + e: segment lane 8 j + 2 quad + e
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          live |= (uint32_t)(mask[seg * SEG + 8 * j + 2 * quad + e] != 0)
                  << (2 * j + e);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int m1 = KEY_MIN, m2 = KEY_MIN;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float sc = acc[4 * (16 * s + j) + 2 * h + e];
            int key = (to_sortable(__float_as_int(sc)) & ~(SEG - 1)) |
                      (8 * j + 2 * quad + e);
            if (!((live >> (2 * j + e)) & 1u)) key = KEY_MIN;
            if (key > m1) {
              m2 = m1;
              m1 = key;
            } else if (key > m2) {
              m2 = key;
            }
          }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const int o1 = __shfl_xor_sync(0xffffffffu, m1, off);
          const int o2 = __shfl_xor_sync(0xffffffffu, m2, off);
          const int n2 = max(min(m1, o1), max(m2, o2));
          m1 = max(m1, o1);
          m2 = n2;
        }
        const int q = row + 8 * h;
        if (quad == 0 && q < Q)
          *reinterpret_cast<int2*>(keys + (long)q * ncol + 2 * seg) =
              make_int2(m1, m2);
      }
    }
  }
};

// Epilogue of K1, K5 and K10: the block's (BQ, 128) score tile in shared
// memory -> each query's two largest packed keys of the segment. Scores are
// the float tile `fs`, or the int32 tile `is` times the row scales `vscale`
// (K5; the integer sum converted to float32, then one multiply, exactly as
// the plain version and the TPU kernel compute it), or with `vscale` null
// the raw int32 sums themselves (K10: the key is (s & ~127) | lane, no
// conversion). Lane l of a warp owns segment lanes l, l+32, l+64, l+96;
// one warp per query row.
__device__ __forceinline__ void segment_top2(
    const float* fs, const int* is, const float* __restrict__ vscale,
    const uint8_t* __restrict__ mask, int* __restrict__ keys, int Q,
    long cap, int q0, long seg) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long r0 = seg * BN;
  bool live[4];
  float scale[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    live[c] = mask[r0 + lane + 32 * c] != 0;
    scale[c] = vscale ? vscale[r0 + lane + 32 * c] : 1.0f;
  }
  const long ncol = 2 * (cap / SEG);
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= Q) break;  // uniform across the warp
    int m1 = KEY_MIN, m2 = KEY_MIN;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ln = lane + 32 * c;
      int raw;
      if (!is)
        raw = to_sortable(__float_as_int(fs[r * LDS + ln]));
      else if (vscale)
        raw = to_sortable(__float_as_int(
            __fmul_rn(__int2float_rn(is[r * LDS + ln]), scale[c])));
      else
        raw = is[r * LDS + ln];
      int key = (raw & ~(SEG - 1)) | ln;
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

__global__ void __launch_bounds__(THREADS)
segmax_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ v,
              const uint8_t* __restrict__ mask, int* __restrict__ keys,
              int Q, long cap, int dim, int q_tiles) {
  // A/B operand tiles during the k-loop, then the f32 score tile.
  __shared__ __align__(128) unsigned char smem[BQ * LDS * sizeof(float)];
  const int qt = blockIdx.x % q_tiles;
  const long seg = blockIdx.x / q_tiles;
  const int q0 = qt * BQ;
  score_tile_bf16(smem, q, v, q0, Q, seg * BN, cap, dim);
  segment_top2(reinterpret_cast<float*>(smem), nullptr, nullptr, mask, keys,
               Q, cap, q0, seg);
}

// ---------------------------------------------------------------------------
// K5 segmax_scan_i8: K1 over a per-row int8 corpus.
//
// Replaces picovdb_tpu/ops/pallas_scan.py:segmax_scan_i8
// (`_segmax_kernel_i8`). The block shape, output layout and epilogue are
// those of K1's wmma kernel; the product is s8 x s8 -> s32 on the tensor
// cores with
// mma.sync.m16n8k32 (fragments loaded by hand from shared memory: each
// thread's A and B registers are 4 consecutive bytes of one row, so every
// fragment register is one 32-bit shared load), and the epilogue scales
// the exact int32 sums by the row scales before packing the keys.
//
// What bounds it on the H100: at the main-path shape (Q = 2048 per chunk,
// 1024-wide rows) it is a 4.3 TOP integer product whose output is 2/128 of
// the score matrix, bound by tensor-core issue rate as K1 is; the corpus
// is 1 B/element, half of K1's bf16 mirror, but this first kernel feeds
// the tensor cores from unpipelined shared-memory tiles (tiles.cuh), so it
// runs at half the wmma K1's time, far from K1's TMA + wgmma mainloop. No
// TMA, no wgmma yet.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
segmax_i8_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ v,
                 const float* __restrict__ vscale,
                 const uint8_t* __restrict__ mask, int* __restrict__ keys,
                 int Q, long cap, int dim, int q_tiles) {
  // A/B operand tiles during the k-loop, then the int32 score tile.
  __shared__ __align__(128) unsigned char smem[BQ * LDS * sizeof(int)];
  const int qt = blockIdx.x % q_tiles;
  const long seg = blockIdx.x / q_tiles;
  const int q0 = qt * BQ;
  score_tile_i8(smem, q, v, q0, Q, seg * BN, cap, dim);
  segment_top2(nullptr, reinterpret_cast<int*>(smem), vscale, mask, keys, Q,
               cap, q0, seg);
}

// ---------------------------------------------------------------------------
// K10 segmax_scan_i8c: K5 over the column-scaled int8 mirror.
//
// Replaces picovdb_tpu/ops/pallas_scan.py:segmax_scan_i8c
// (`_segmax_kernel_i8c`). The column scales are folded into the int8
// queries by the caller, so the int32 sum ranks a query's rows as the true
// score does: the epilogue packs the raw sum (s & ~127) | lane, with no
// conversion and no scale, masks after packing and keeps the segment's top
// two. These are integer keys, bit for bit the TPU kernel's (its slab is
// (n_tiles * 2 * ns, Q), per tile ns first-best rows then ns second-best;
// here K1's (Q, 2 * cap / 128) layout, column 2 * seg + r). |s| <=
// 127 * 127 * dim < 2^31 keeps every key above KEY_MIN. What bounds it on
// the H100: as K5, the tensor cores' issue rate, fed from unpipelined
// shared-memory tiles; it drops K5's row-scale read and float epilogue.
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS)
segmax_i8c_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ v,
                  const uint8_t* __restrict__ mask, int* __restrict__ keys,
                  int Q, long cap, int dim, int q_tiles) {
  __shared__ __align__(128) unsigned char smem[BQ * LDS * sizeof(int)];
  const int qt = blockIdx.x % q_tiles;
  const long seg = blockIdx.x / q_tiles;
  const int q0 = qt * BQ;
  score_tile_i8(smem, q, v, q0, Q, seg * BN, cap, dim);
  segment_top2(nullptr, reinterpret_cast<int*>(smem), nullptr, mask, keys, Q,
               cap, q0, seg);
}

// ---------------------------------------------------------------------------
// K8 ivf_segmax_scan: per 128-row segment of each IVF hot tile, the top
// `per_seg` packed keys.
//
// Replaces picovdb_tpu/ops/ivf.py:probe_scan_segmax (`_ivf_segmax_kernel`,
// `_ivf_segmax_kernel_i8c`). A block scores BQ queries against segment s of
// postings tile hot[b] (rows hot[b] * bn + s * 128 ..), the tile named by a
// device table, and keeps each query's `per_seg` (<= 8) largest keys of
// the segment. Keys are K1's: sortable float32 bits (the int8 kind: the
// raw int32 score) with the low 7 bits replaced by the lane; masked rows,
// exhausted ranks and dead steps (b >= *n_hot, read on the device) carry
// KEY_MIN. The slab is (Q, grid_b * per_seg * ns), column
// b * per_seg * ns + r * ns + s, picovdb_tpu's slab transposed; the
// route decodes it. Products: float32 postings with float32 FMAs on the
// CUDA cores (a tensor-core f32 product would be TF32, whose 10-bit
// mantissa can reach clustered top-10 gaps), bf16 postings with K1's wmma,
// int8 postings with K5's mma.sync s8. What bounds it on the H100: the hot
// tiles' bytes at Q <= 64 for f32 (4 B per element), tensor-core issue for
// the others, as K1/K5; a first kernel: no TMA, no pipelining.
// ---------------------------------------------------------------------------

constexpr int KCF = 32;       // float32 elements per k-step
constexpr int LDF = KCF + 1;  // padded row (floats)

// The (BQ, 128) float32 score tile with CUDA-core FMAs: thread (ty, tx)
// owns queries 4 ty .. 4 ty + 3 and rows tx + 16 j, j < 8.
__device__ __forceinline__ void score_tile_f32(
    unsigned char* smem, const float* __restrict__ q,
    const float* __restrict__ v, int q0, int Q, long r0, long cap, int dim) {
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + BQ * LDF;
  float* Ss = reinterpret_cast<float*>(smem);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < dim; k0 += KCF) {
    for (int i = threadIdx.x; i < BQ * KCF; i += THREADS) {
      const int r = i / KCF, c = i % KCF, gk = k0 + c;
      As[r * LDF + c] = (q0 + r < Q && gk < dim) ? q[(long)(q0 + r) * dim + gk] : 0.0f;
    }
    for (int i = threadIdx.x; i < BN * KCF; i += THREADS) {
      const int r = i / KCF, c = i % KCF, gk = k0 + c;
      const long gr = r0 + r;
      Bs[r * LDF + c] = (gr < cap && gk < dim) ? v[gr * dim + gk] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KCF; ++kk) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[(ty * 4 + i) * LDF + kk];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[(tx + 16 * j) * LDF + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) Ss[(ty * 4 + i) * LDS + tx + 16 * j] = acc[i][j];
  __syncthreads();
}

// Epilogue of K8: each query's `per_seg` largest keys of the segment, by
// `per_seg` warp-wide max passes (a lane holds 4 keys; keys are distinct by
// their lane bits, so the one owner clears each winner). One warp per
// query row; writes keys[qi * ncol + col0 + r * rstride].
__device__ __forceinline__ void segment_topn(
    const float* fs, const int* is, const uint8_t* __restrict__ mask,
    long r0, bool dead, int* __restrict__ keys, int Q, long ncol, int q0,
    long col0, int rstride, int per_seg) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  bool live[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    live[c] = !dead && mask[r0 + lane + 32 * c] != 0;
  for (int r = warp; r < BQ; r += THREADS / 32) {
    const int qi = q0 + r;
    if (qi >= Q) break;  // uniform across the warp
    int key[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ln = lane + 32 * c;
      const int raw = is ? is[r * LDS + ln] : to_sortable(__float_as_int(fs[r * LDS + ln]));
      key[c] = live[c] ? ((raw & ~(SEG - 1)) | ln) : KEY_MIN;
    }
    for (int t = 0; t < per_seg; ++t) {
      int m = max(max(key[0], key[1]), max(key[2], key[3]));
      m = __reduce_max_sync(0xffffffffu, m);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (key[c] == m) key[c] = KEY_MIN;
      if (lane == 0) keys[(long)qi * ncol + col0 + (long)t * rstride] = m;
    }
  }
}

// KIND 0: float32 postings and q; 1: bf16; 2: column-scaled int8.
template <int KIND>
__global__ void __launch_bounds__(THREADS)
ivf_segmax_kernel(const void* __restrict__ q, const void* __restrict__ v,
                  const uint8_t* __restrict__ mask,
                  const int* __restrict__ hot, const int* __restrict__ n_hot,
                  int* __restrict__ keys, int Q, long cap, int dim, int bn,
                  int grid_b, int per_seg, int q_tiles) {
  __shared__ __align__(128) unsigned char smem[BQ * LDS * sizeof(float)];
  const int ns = bn / SEG;
  const int qt = blockIdx.x % q_tiles;
  const long rest = blockIdx.x / q_tiles;
  const int b = (int)(rest / ns), s = (int)(rest % ns);
  const int q0 = qt * BQ;
  const bool dead = b >= *n_hot;  // uniform across the block
  const long r0 = (long)hot[b] * bn + (long)s * SEG;
  if (!dead) {
    if (KIND == 0)
      score_tile_f32(smem, static_cast<const float*>(q),
                     static_cast<const float*>(v), q0, Q, r0, cap, dim);
    else if (KIND == 1)
      score_tile_bf16(smem, static_cast<const __nv_bfloat16*>(q),
                      static_cast<const __nv_bfloat16*>(v), q0, Q, r0, cap, dim);
    else
      score_tile_i8(smem, static_cast<const int8_t*>(q),
                    static_cast<const int8_t*>(v), q0, Q, r0, cap, dim);
  }
  const long ncol = (long)grid_b * per_seg * ns;
  segment_topn(KIND == 2 ? nullptr : reinterpret_cast<const float*>(smem),
               KIND == 2 ? reinterpret_cast<const int*>(smem) : nullptr, mask,
               r0, dead, keys, Q, ncol, q0, (long)b * per_seg * ns + s, ns,
               per_seg);
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

// K1 on the TMA + wgmma mainloop: pv_segmax_scan's contract, for dim % 8
// == 0 and 16-byte aligned q and v. Returns 0, a cudaError_t, or minus the
// CUresult of a refused tensor-map encode.
extern "C" int pv_segmax_scan_wgmma(const void* q, const void* v,
                                    const void* mask, void* keys, int Q,
                                    long long cap, int dim, void* stream) {
  using namespace pv;
  if (cap % SEG) return (int)cudaErrorInvalidValue;
  const SegmaxTileEpi epi{static_cast<const uint8_t*>(mask),
                          static_cast<int*>(keys), (long)(2 * (cap / SEG))};
  return wg::launch_tiles<wg::Bf16>(q, v, epi, Q, cap, dim,
                                    (cudaStream_t)stream);
}

// q (Q, dim) int8, v (cap, dim) int8 with cap % 128 == 0, vscale (cap,)
// float32, mask (cap,) uint8 -> keys (Q, 2 * cap / 128) int32, K1's
// layout. Returns the cudaError_t of the launch.
extern "C" int pv_segmax_scan_i8(const void* q, const void* v,
                                 const void* vscale, const void* mask,
                                 void* keys, int Q, long long cap, int dim,
                                 void* stream) {
  using namespace pv;
  const int q_tiles = (Q + BQ - 1) / BQ;
  const long long blocks = (long long)q_tiles * (cap / SEG);
  if (Q <= 0 || cap <= 0) return (int)cudaSuccess;
  segmax_i8_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(v),
      static_cast<const float*>(vscale), static_cast<const uint8_t*>(mask),
      static_cast<int*>(keys), Q, (long)cap, dim, q_tiles);
  return (int)cudaGetLastError();
}

// K10. q (Q, dim) folded int8, v (cap, dim) column-scaled int8 with
// cap % 128 == 0, mask (cap,) uint8 -> keys (Q, 2 * cap / 128) int32, K1's
// layout. Returns the cudaError_t of the launch.
extern "C" int pv_segmax_scan_i8c(const void* q, const void* v,
                                  const void* mask, void* keys, int Q,
                                  long long cap, int dim, void* stream) {
  using namespace pv;
  const int q_tiles = (Q + BQ - 1) / BQ;
  const long long blocks = (long long)q_tiles * (cap / SEG);
  if (Q <= 0 || cap <= 0) return (int)cudaSuccess;
  segmax_i8c_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(v),
      static_cast<const uint8_t*>(mask), static_cast<int*>(keys), Q,
      (long)cap, dim, q_tiles);
  return (int)cudaGetLastError();
}

// K8. kind 0: postings and q float32; 1: both bfloat16; 2: column-scaled
// int8 postings and folded int8 q. postings (cap, dim) with cap % bn == 0
// and bn % 128 == 0, mask (cap,) uint8, hot (grid_b,) int32 tile ids in
// [0, cap / bn), n_hot (1,) int32 on the device -> keys (Q, grid_b *
// per_seg * bn / 128) int32. per_seg in 1..8. Returns the cudaError_t of
// the launch.
extern "C" int pv_ivf_segmax(int kind, const void* q, const void* v,
                             const void* mask, const void* hot,
                             const void* n_hot, void* keys, int Q,
                             long long cap, int dim, int bn, int grid_b,
                             int per_seg, void* stream) {
  using namespace pv;
  if (Q <= 0 || grid_b <= 0) return (int)cudaSuccess;
  if (bn % SEG || per_seg < 1 || per_seg > 8) return (int)cudaErrorInvalidValue;
  const int q_tiles = (Q + BQ - 1) / BQ;
  const long long blocks = (long long)q_tiles * grid_b * (bn / SEG);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int* h = static_cast<const int*>(hot);
  const int* nh = static_cast<const int*>(n_hot);
  int* out = static_cast<int*>(keys);
  if (kind == 0)
    ivf_segmax_kernel<0><<<(unsigned)blocks, THREADS, 0, s>>>(
        q, v, m, h, nh, out, Q, (long)cap, dim, bn, grid_b, per_seg, q_tiles);
  else if (kind == 1)
    ivf_segmax_kernel<1><<<(unsigned)blocks, THREADS, 0, s>>>(
        q, v, m, h, nh, out, Q, (long)cap, dim, bn, grid_b, per_seg, q_tiles);
  else if (kind == 2)
    ivf_segmax_kernel<2><<<(unsigned)blocks, THREADS, 0, s>>>(
        q, v, m, h, nh, out, Q, (long)cap, dim, bn, grid_b, per_seg, q_tiles);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
