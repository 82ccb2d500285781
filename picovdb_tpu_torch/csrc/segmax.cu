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
// share the row by shuffles. No score leaves the registers. At even
// widths TMA cannot read (dim 1020, 300, 100, 50, or 4- / 8-byte aligned
// views) the same mainloop runs with its cp.async producer
// (pv_segmax_scan_cpasync), and at odd widths and on 2-byte aligned views
// with its realigning producer (pv_segmax_scan_realign: TMA stages each
// row's aligned span, rows j, j + 8, ... read as one 2D tensor whose
// 8-row stride TMA can take, and the producer warpgroup shifts the slices
// into the swizzled ring in shared memory). The first kernel,
// `segmax_kernel` (one block scores 64 queries x one 128-row segment with
// wmma bf16 16x16x16 from unpipelined shared-memory tiles, tiles.cuh, and
// reduces the tile in shared memory), serves no dispatch any more; it
// stays as pv_segmax_scan, the kernel the realigning producer replaced,
// timed beside it. No kernel carries state between tiles, so the TPU's
// two grid orders (classic / stream) are the same launch here; query
// tiles vary fastest so the blocks reading one segment run together and
// share it in L2.
//
// K5 segmax_scan_i8 and K10 segmax_scan_i8c (below) are K1 over a per-row
// int8 corpus and over the column-scaled int8 mirror. Both run the int8
// instantiation of the same mainloop, K10 with SegmaxTileEpi<int>, K5 with
// SegmaxTileEpi<int, true> (the row scales), fed as K1's is: by TMA, by
// cp.async at int8 widths and bases of whole 4 bytes, else by the
// realigning producer with sixteen row classes (any byte). Their first
// kernels, over the mma.sync tile, serve no dispatch. The wmma and
// mma.sync score tiles live in tiles.cuh, shared with K8's first kernel
// and the dot-floor probe P1, whose two kinds also run on wgmma_tiles.cuh.

#include "tiles.cuh"
#include "wgmma_tiles.cuh"

namespace pv {
namespace {

// The epilogue of K1 (float accumulators), K10 (int32 accumulators) and K5
// (int32 accumulators with `SCALED` row scales) on the wgmma accumulators
// (layout: wgmma_tiles.cuh). For each of its two rows and each segment of
// the tile that lies inside cap (cap % 256 == 128 leaves a last tile's
// second segment out: its zero-filled rows score 0, which would beat an
// all-negative segment), a thread packs its 32 scores of the segment (key
// (order_key(s) & ~127) | lane: K1 the sortable float32 bits, K10 the raw
// int32 sum, K5 the sortable bits of the sum converted to float32 and
// times the row's scale, one rounding each as segment_top2 and the TPU
// kernel compute it; KEY_MIN for masked rows after packing), keeps its top
// 2, merges them with the three other lanes of its quad and the quad
// leader writes keys[q, 2 seg] and [q, 2 seg + 1]. A thread loads each of
// its 32 rows' mask byte and scale once a segment, for both of its query
// rows. Rows past Q write nothing.
template <class A, bool SCALED = false>
struct SegmaxTileEpi {
  const uint8_t* __restrict__ mask;
  int* __restrict__ keys;
  long ncol;  // 2 * cap / 128
  const float* __restrict__ vscale;  // (cap,): K5's row scales

  __device__ __forceinline__ void tile(A (&acc)[wg::ACC], int q0, long r0,
                                       int Q, long cap) const {
    const int lane = threadIdx.x % 32, quad = lane % 4;
    const int row = q0 + 64 * (threadIdx.x / 128) +
                    16 * ((threadIdx.x / 32) % 4) + lane / 4;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const long seg = r0 / SEG + s;
      if (seg * SEG >= cap) break;  // uniform across the CTA
      int m1[2] = {KEY_MIN, KEY_MIN}, m2[2] = {KEY_MIN, KEY_MIN};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        // segment lanes 8 j + 2 quad + e
        const long r = seg * SEG + 8 * j + 2 * quad;
        const bool live[2] = {mask[r] != 0, mask[r + 1] != 0};
        float sc[2] = {1.0f, 1.0f};
        if constexpr (SCALED) {
          sc[0] = vscale[r];
          sc[1] = vscale[r + 1];
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const A a = acc[4 * (16 * s + j) + 2 * h + e];
            int raw;
            if constexpr (SCALED)
              raw = wg::order_key(__fmul_rn(__int2float_rn(a), sc[e]));
            else
              raw = wg::order_key(a);
            int key = (raw & ~(SEG - 1)) | (8 * j + 2 * quad + e);
            if (!live[e]) key = KEY_MIN;
            if (key > m1[h]) {
              m2[h] = m1[h];
              m1[h] = key;
            } else if (key > m2[h]) {
              m2[h] = key;
            }
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const int o1 = __shfl_xor_sync(0xffffffffu, m1[h], off);
          const int o2 = __shfl_xor_sync(0xffffffffu, m2[h], off);
          const int n2 = max(min(m1[h], o1), max(m2[h], o2));
          m1[h] = max(m1[h], o1);
          m2[h] = n2;
        }
        const int q = row + 8 * h;
        if (quad == 0 && q < Q)
          *reinterpret_cast<int2*>(keys + (long)q * ncol + 2 * seg) =
              make_int2(m1[h], m2[h]);
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
// (`_segmax_kernel_i8`). The epilogue scales the exact int32 sums by the
// row scales before packing the keys.
//
// What bounds it on the H100: at the main-path shape (Q = 2048 per chunk,
// 1024-wide rows) it is a 4.3 TOP integer product whose output is 2/128 of
// the score matrix, bound by the tensor cores' int8 rate (1,979 TOP/s) as
// K10 is. It runs K10's int8 mainloop (wgmma_tiles.cuh) with
// SegmaxTileEpi<int, true>, whose keys are the int32 sum converted to
// float32 and times the row's scale: by TMA where it can read the
// operands (dim % 16 == 0, 16-byte aligned bases; pv_segmax_scan_i8_wgmma),
// by cp.async at widths and bases of whole 4 bytes (glove-100's 100-byte
// rows; pv_segmax_scan_i8_cpasync), else by the realigning producer
// (glove-25's 25-byte rows, 1- and 2-byte aligned views;
// pv_segmax_scan_i8_realign). The first kernel below (K1's block shape and
// layout, s8 x s8 -> s32 with mma.sync.m16n8k32 from unpipelined
// shared-memory tiles, tiles.cuh) serves no dispatch; it stays as
// pv_segmax_scan_i8, timed beside the kinds that replaced it.
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
// 127 * 127 * dim < 2^31 keeps every key above KEY_MIN.
//
// What bounds it on the H100: at the main-path shape (Q = 2048 per chunk,
// 1M x 1024 mirror) a 4.3 TOP int8 product whose output is 2/128 of the
// score matrix: the tensor cores' int8 rate (1,979 TOP/s), twice K1's.
// It runs the int8 instantiation of K1's mainloop (wgmma_tiles.cuh,
// wgmma.m64n256k32 s8 -> s32, exact sums) with K1's register epilogue
// over the int32 accumulators, SegmaxTileEpi<int>, fed by K5's producers
// (pv_segmax_scan_i8c_wgmma / _cpasync / _realign). The first kernel below
// (K5's over the mma.sync tile, without the row scale) serves no
// dispatch; it stays as pv_segmax_scan_i8c, timed beside them.
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
// `_ivf_segmax_kernel_i8c`): K8's first port, which serves no dispatch
// since the tensor-core segment scan (ivf_segmax_wgmma.cu) takes every
// postings width and base; chip_smoke.py times that scan against it. A
// block scores BQ queries against segment s of
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
  const SegmaxTileEpi<float> epi{static_cast<const uint8_t*>(mask),
                                 static_cast<int*>(keys),
                                 (long)(2 * (cap / SEG)), nullptr};
  return wg::launch_tiles<wg::Bf16>(q, v, epi, Q, cap, dim,
                                    (cudaStream_t)stream);
}

// K1 on the same mainloop fed by cp.async, at widths TMA cannot read:
// pv_segmax_scan's contract for an even dim with q and v 4-byte aligned
// (8-byte pieces where the row bytes and both bases are multiples of 8,
// else 4-byte pieces). Returns 0 or a cudaError_t.
extern "C" int pv_segmax_scan_cpasync(const void* q, const void* v,
                                      const void* mask, void* keys, int Q,
                                      long long cap, int dim, void* stream) {
  using namespace pv;
  if (cap % SEG) return (int)cudaErrorInvalidValue;
  const SegmaxTileEpi<float> epi{static_cast<const uint8_t*>(mask),
                                 static_cast<int*>(keys),
                                 (long)(2 * (cap / SEG)), nullptr};
  const uintptr_t bits = (uintptr_t)q | (uintptr_t)v | (uintptr_t)(2 * dim);
  cudaStream_t s = (cudaStream_t)stream;
  if (bits % 8 == 0)
    return wg::launch_tiles<wg::Bf16, SegmaxTileEpi<float>, 8>(q, v, epi, Q,
                                                              cap, dim, s);
  return wg::launch_tiles<wg::Bf16, SegmaxTileEpi<float>, 4>(q, v, epi, Q,
                                                            cap, dim, s);
}

// K1 on the same mainloop fed by its realigning producer, for the rows
// neither TMA's plain maps nor cp.async can read: pv_segmax_scan's
// contract for any dim, q and v 2-byte aligned (odd widths, 2-byte aligned
// views). Returns 0, a cudaError_t, or minus the CUresult of a refused
// tensor-map encode.
extern "C" int pv_segmax_scan_realign(const void* q, const void* v,
                                      const void* mask, void* keys, int Q,
                                      long long cap, int dim, void* stream) {
  using namespace pv;
  if (cap % SEG) return (int)cudaErrorInvalidValue;
  const SegmaxTileEpi<float> epi{static_cast<const uint8_t*>(mask),
                                 static_cast<int*>(keys),
                                 (long)(2 * (cap / SEG)), nullptr};
  return wg::launch_tiles<wg::Bf16, SegmaxTileEpi<float>, 2>(
      q, v, epi, Q, cap, dim, (cudaStream_t)stream);
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

namespace pv {
namespace {

// K5's (SCALED) or K10's launch on the int8 mainloop fed by `piece`: 0
// TMA, -1 cp.async in 8-byte pieces where dim and both bases are
// multiples of 8, else in 4-byte pieces, 2 the realigning producer.
template <bool SCALED>
int segmax_i8_tiles(int piece, const void* q, const void* v,
                    const void* vscale, const void* mask, void* keys, int Q,
                    long long cap, int dim, cudaStream_t s) {
  if (cap % SEG) return (int)cudaErrorInvalidValue;
  typedef SegmaxTileEpi<int, SCALED> Epi;
  const Epi epi{static_cast<const uint8_t*>(mask), static_cast<int*>(keys),
                (long)(2 * (cap / SEG)), static_cast<const float*>(vscale)};
  if (piece < 0)
    piece = ((uintptr_t)q | (uintptr_t)v | (uintptr_t)dim) % 8 ? 4 : 8;
  switch (piece) {
    case 0: return wg::launch_tiles<wg::Int8, Epi, 0>(q, v, epi, Q, cap, dim, s);
    case 8: return wg::launch_tiles<wg::Int8, Epi, 8>(q, v, epi, Q, cap, dim, s);
    case 4: return wg::launch_tiles<wg::Int8, Epi, 4>(q, v, epi, Q, cap, dim, s);
    case 2: return wg::launch_tiles<wg::Int8, Epi, 2>(q, v, epi, Q, cap, dim, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace pv

// K5 on the int8 TMA + wgmma mainloop: pv_segmax_scan_i8's contract, for
// dim % 16 == 0 and 16-byte aligned q and v. Returns 0, a cudaError_t, or
// minus the CUresult of a refused tensor-map encode.
extern "C" int pv_segmax_scan_i8_wgmma(const void* q, const void* v,
                                       const void* vscale, const void* mask,
                                       void* keys, int Q, long long cap,
                                       int dim, void* stream) {
  return pv::segmax_i8_tiles<true>(0, q, v, vscale, mask, keys, Q, cap, dim,
                                   (cudaStream_t)stream);
}

// K5 on the same mainloop fed by cp.async, at int8 widths TMA cannot read:
// pv_segmax_scan_i8's contract for dim % 4 == 0 with q and v 4-byte
// aligned (8-byte pieces where dim and both bases are multiples of 8).
// Returns 0 or a cudaError_t.
extern "C" int pv_segmax_scan_i8_cpasync(const void* q, const void* v,
                                         const void* vscale, const void* mask,
                                         void* keys, int Q, long long cap,
                                         int dim, void* stream) {
  return pv::segmax_i8_tiles<true>(-1, q, v, vscale, mask, keys, Q, cap, dim,
                                   (cudaStream_t)stream);
}

// K5 on the same mainloop fed by its realigning producer: pv_segmax_scan_i8's
// contract for any dim and any bases. Returns 0, a cudaError_t, or minus
// the CUresult of a refused tensor-map encode.
extern "C" int pv_segmax_scan_i8_realign(const void* q, const void* v,
                                         const void* vscale, const void* mask,
                                         void* keys, int Q, long long cap,
                                         int dim, void* stream) {
  return pv::segmax_i8_tiles<true>(2, q, v, vscale, mask, keys, Q, cap, dim,
                                   (cudaStream_t)stream);
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

// K10 on the int8 TMA + wgmma mainloop: pv_segmax_scan_i8c's contract, for
// dim % 16 == 0 and 16-byte aligned q and v. Returns 0, a cudaError_t, or
// minus the CUresult of a refused tensor-map encode.
extern "C" int pv_segmax_scan_i8c_wgmma(const void* q, const void* v,
                                        const void* mask, void* keys, int Q,
                                        long long cap, int dim, void* stream) {
  return pv::segmax_i8_tiles<false>(0, q, v, nullptr, mask, keys, Q, cap,
                                    dim, (cudaStream_t)stream);
}

// K10 on the mainloop fed by cp.async (pv_segmax_scan_i8_cpasync's widths
// and bases) and by its realigning producer (any), with
// pv_segmax_scan_i8c's contract. Return 0, a cudaError_t, or minus the
// CUresult of a refused tensor-map encode.
extern "C" int pv_segmax_scan_i8c_cpasync(const void* q, const void* v,
                                          const void* mask, void* keys, int Q,
                                          long long cap, int dim,
                                          void* stream) {
  return pv::segmax_i8_tiles<false>(-1, q, v, nullptr, mask, keys, Q, cap,
                                    dim, (cudaStream_t)stream);
}

extern "C" int pv_segmax_scan_i8c_realign(const void* q, const void* v,
                                          const void* mask, void* keys, int Q,
                                          long long cap, int dim,
                                          void* stream) {
  return pv::segmax_i8_tiles<false>(2, q, v, nullptr, mask, keys, Q, cap,
                                    dim, (cudaStream_t)stream);
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
