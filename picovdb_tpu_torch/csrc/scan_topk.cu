// K3 fused_topk_i8, K4 fused_topk and K6 fused_topk_i4: exact masked
// top-k_sel over a corpus in float32, bfloat16, int8 with a per-row scale,
// or packed int4 with a per-row scale.
//
// Replaces picovdb_tpu/ops/pallas_scan.py:fused_topk (`_scan_kernel`, K4),
// fused_topk_i8 (`_scan_kernel_i8`, K3) and fused_topk_i4
// (`_scan_kernel_i4`, K6). All compute, per query, the k_sel best masked
// rows by score q . v (int8: s8 . s8 -> s32, times the row's scale; int4:
// see below); rows that no round could select come out as -inf / row 0.
// Selection is exact on the float32 scores (the TPU ladder quantizes them
// through its packed key); callers rescore the winners anyway.
// k_sel <= 1024 is served here, so the exact retry never needs a dense
// (Q, cap) score matrix; wider k goes to the plain exact scan.
//
// What bounds it on the H100: on the main path Q <= 16 (K3, 1 B/element;
// K6, 0.5 B/element) or Q = 64 (K4 on the 2 B bf16 mirror), so arithmetic
// per corpus byte is low and the sweep of the corpus from device memory
// (1 GB int8 or 8 GB int4 at 16M x 1024) is the floor. The TPU kernel
// sweeps the corpus serially per query tile, which at Q <= 16 would be one
// block; here the corpus is split into chunks across all SMs: each block
// scores a tile of queries against its chunk with CUDA-core FMAs (int8 and
// int4: __dp4a) from shared-memory tiles, keeps a per-query candidate
// buffer in shared memory behind a running k-th-best threshold, and writes
// its chunk's top-k_sel. A second launch (launch_topk_merge) merges the
// chunks' winners per query.
//
// int4 (K6): a row is dim/2 bytes; byte j holds element j (low nibble)
// and element j + dim/2 (high nibble), each stored as value + 8 in
// [1, 15]. Four packed bytes load as one 32-bit word; w & 0x0F0F0F0F and
// (w >> 4) & 0x0F0F0F0F are the two biased planes (safe as signed bytes),
// and score = dp4a(lo, q[j..j+3]) + dp4a(hi, q[d/2 + j..]) summed, minus
// 8 * sum(q) (once per query), times the row scale. The unpacked corpus
// never exists: the sweep reads 0.5 B/element.
// A first, simple kernel: no tensor cores, no TMA, no pipelining yet.
//
// K7 ivf_scan_topk (pv_ivf_scan_topk, below) is the same kernel over the
// IVF tier's hot tiles. It replaces picovdb_tpu/ops/ivf.py:probe_scan_local
// (`_ivf_kernel`, `_ivf_kernel_i8c`): a "chunk" is one postings tile of
// `bn` rows, named by the device table hot[c]; blocks with c >= *n_hot
// (read on the device) score nothing and write an empty partial, which
// the merge reads like any other. Row ids are hot[c] * bn + lane. A tile
// spreads over `split` blocks of bn / split rows each (chunk c covers
// part c % split of tile hot[c / split]): a probe has tens of live tiles
// at Q = 1, which as one block each would leave most SMs idle. Kinds:
// float32 rows and queries; bfloat16 rows against bfloat16 queries (the
// TPU kernel casts q to the postings' dtype); column-scaled int8 rows
// against folded int8 queries, ranked on the raw int32 sum itself (its
// selection key's high word is the int32 with the sign bit flipped, so
// scores past 2^24 never round through float32). What bounds it on the
// H100: at Q <= 16 the hot tiles' bytes (4 / 2 / 1 B per element), as for
// K3/K4; a probe reads a few hundred 1024-row tiles, so the grid is
// q_tiles x grid_b blocks.
//
// K9 fused_topk_i8c (pv_scan_topk kind 4) is K3 over the column-scaled
// int8 mirror. It replaces picovdb_tpu/ops/pallas_scan.py:fused_topk_i8c
// (`_scan_kernel_i8c`): folded int8 queries against int8 rows with no row
// scale, ranked on the raw int32 sum by K7's Int8C key (ties to the lower
// row). The TPU kernel ranks (s & ~0xFFF) | lane (bn = 4096), so the two
// selections agree except on near-ties, and the rescored top-k is the
// same. What bounds it on the H100: the 1 B/element sweep at Q <= 16, as
// K3; it saves K3's row-scale read and multiply.

#include <type_traits>

#include "common.cuh"

namespace pv {
namespace {

constexpr int THREADS = 256;
constexpr int TR = 128;  // corpus rows per tile
constexpr int KCW = 16;  // 32-bit words of each row per k-step

struct Int4 {};   // corpus kind tag: packed two-plane nibbles (int8 bytes)
struct Bf16Q {};  // bf16 rows x bf16 queries (the IVF probe's bf16 postings)
struct Int8C {};  // column-scaled int8 rows: raw int32 scores, no row scale

template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int EPW = 1;  // corpus elements per 32-bit word
  typedef float QT;              // query element type
  typedef float VT;              // corpus storage type
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int EPW = 2;
  typedef float QT;
  typedef __nv_bfloat16 VT;
};
template <>
struct Elem<int8_t> {
  static constexpr int EPW = 4;
  typedef int8_t QT;
  typedef int8_t VT;
};
template <>
struct Elem<Bf16Q> {
  static constexpr int EPW = 2;
  typedef __nv_bfloat16 QT;
  typedef __nv_bfloat16 VT;
};
template <>
struct Elem<Int8C> {
  static constexpr int EPW = 4;
  typedef int8_t QT;
  typedef int8_t VT;
};
template <>
struct Elem<Int4> {
  static constexpr int EPW = 4;  // packed bytes per word (8 elements)
  typedef int8_t QT;
  typedef int8_t VT;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// One 32-bit word of `EPW` elements starting at element `e` of a row of
// `dim` elements; elements past the row are zero.
template <typename T>
__device__ __forceinline__ uint32_t load_word(const T* row, int e, int dim,
                                              bool aligned) {
  constexpr int EPW = Elem<T>::EPW;
  if (aligned && e + EPW <= dim) return *reinterpret_cast<const uint32_t*>(row + e);
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < EPW; ++i) {
    if (e + i < dim) {
      uint32_t bits;
      if (EPW == 1) bits = *reinterpret_cast<const uint32_t*>(row + e + i);
      else if (EPW == 2) bits = *reinterpret_cast<const uint16_t*>(row + e + i);
      else bits = *reinterpret_cast<const uint8_t*>(row + e + i);
      w |= bits << (32 / EPW * i);
    }
  }
  return w;
}

// QT queries x one corpus chunk per block; BUF candidate slots per query.
// `dim` is the query width; a corpus row holds dim elements (dim / 2
// bytes for int4). With `hot` (K7) chunk c is rows hot[c / split] *
// chunk * split + (c % split) * chunk + [0, chunk), and chunks with
// c / split >= *n_hot are empty.
template <typename T, int QT, int BUF>
__global__ void __launch_bounds__(THREADS)
scan_topk_kernel(const typename Elem<T>::QT* __restrict__ q,
                 const typename Elem<T>::VT* __restrict__ v,
                 const float* __restrict__ vscale,
                 const uint8_t* __restrict__ mask, u64* __restrict__ partial,
                 int Q, long cap, int dim, int k, long chunk, int nchunks,
                 const int* __restrict__ hot, const int* __restrict__ n_hot,
                 int split) {
  constexpr int EPW = Elem<T>::EPW;
  constexpr bool I4 = std::is_same<T, Int4>::value;
  constexpr bool RAW = std::is_same<T, Int8C>::value;
  constexpr bool I8 = std::is_same<T, int8_t>::value || RAW;
  constexpr int TPQ = THREADS / QT;  // threads per query
  constexpr int RPT = TR / TPQ;      // tile rows per thread
  constexpr int KE = KCW * EPW;      // row elements (int4: bytes) per k-step
  // Query tile: float per element (f32 / bf16 corpora), packed int8 words
  // (int8), or packed int8 words of both query halves (int4).
  constexpr int QWORDS = I4 ? QT * 2 * KCW : (I8 ? QT * KCW : QT * KE);

  __shared__ uint32_t Vs[TR * (KCW + 1)];
  __shared__ uint32_t Qs[QWORDS];
  __shared__ u64 buf[QT * BUF];
  __shared__ int cnt[QT];
  __shared__ u64 tau[QT];
  __shared__ int qsum[QT];  // int4: sum of each query's int8 elements

  const int q0 = blockIdx.x * QT;
  const int c = blockIdx.y;
  const long rbeg = hot ? ((long)hot[c / split] * split + c % split) * chunk
                        : (long)c * chunk;
  long rend = (rbeg + chunk < cap) ? rbeg + chunk : cap;
  if (hot && c / split >= *n_hot) rend = rbeg;  // dead step: empty partial
  const int qi = threadIdx.x / TPQ, rsub = threadIdx.x % TPQ;
  const int vdim = I4 ? dim / 2 : dim;
  const bool aligned = (vdim % EPW) == 0;
  if (threadIdx.x < QT) {
    cnt[threadIdx.x] = 0;
    tau[threadIdx.x] = 0ull;
    qsum[threadIdx.x] = 0;
  }
  if constexpr (I4) {
    __syncthreads();
    int part = 0;
    if (q0 + qi < Q)
      for (int e = rsub; e < dim; e += TPQ) part += q[(long)(q0 + qi) * dim + e];
    atomicAdd(&qsum[qi], part);
  }

  for (long t0 = rbeg; t0 < rend; t0 += TR) {
    float facc[RPT];
    int iacc[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      facc[j] = 0.0f;
      iacc[j] = 0;
    }
    for (int k0 = 0; k0 < vdim; k0 += KE) {
      for (int i = threadIdx.x; i < TR * KCW; i += THREADS) {
        const int r = i / KCW, w = i % KCW;
        const long gr = t0 + r;
        Vs[r * (KCW + 1) + w] =
            gr < rend ? load_word(v + gr * vdim, k0 + w * EPW, vdim, aligned) : 0u;
      }
      for (int i = threadIdx.x; i < QWORDS; i += THREADS) {
        if constexpr (I4) {
          // word w of plane p: query elements p * dim/2 + k0 + 4w .. + 3
          const int qq = i / (2 * KCW), p = (i / KCW) % 2, w = i % KCW;
          Qs[i] = q0 + qq < Q
                      ? load_word(q + (long)(q0 + qq) * dim + p * vdim,
                                  k0 + w * EPW, vdim, aligned)
                      : 0u;
        } else if constexpr (I8) {
          const int qq = i / KCW, w = i % KCW;
          Qs[i] = q0 + qq < Q
                      ? load_word(q + (long)(q0 + qq) * dim, k0 + w * EPW, dim, aligned)
                      : 0u;
        } else {
          const int qq = i / KE, e = k0 + i % KE;
          const float x = (q0 + qq < Q && e < dim)
                              ? to_float(q[(long)(q0 + qq) * dim + e]) : 0.0f;
          Qs[i] = __float_as_uint(x);
        }
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < KCW; ++w) {
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const uint32_t word = Vs[(rsub + TPQ * j) * (KCW + 1) + w];
          if (I4) {
            const uint32_t lo = word & 0x0F0F0F0Fu;
            const uint32_t hi = (word >> 4) & 0x0F0F0F0Fu;
            iacc[j] = __dp4a((int)lo, (int)Qs[qi * 2 * KCW + w], iacc[j]);
            iacc[j] = __dp4a((int)hi, (int)Qs[qi * 2 * KCW + KCW + w], iacc[j]);
          } else if (I8) {
            iacc[j] = __dp4a((int)word, (int)Qs[qi * KCW + w], iacc[j]);
          } else if (EPW == 2) {
            const float2 f = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&word));
            facc[j] = fmaf(__uint_as_float(Qs[qi * KE + 2 * w]), f.x, facc[j]);
            facc[j] = fmaf(__uint_as_float(Qs[qi * KE + 2 * w + 1]), f.y, facc[j]);
          } else {
            facc[j] = fmaf(__uint_as_float(Qs[qi * KE + w]),
                           __uint_as_float(word), facc[j]);
          }
        }
      }
      __syncthreads();
    }
    if (q0 + qi < Q) {
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const long row = t0 + rsub + TPQ * j;
        if (row < rend && mask[row]) {
          float s = facc[j];
          if (I4) s = __fmul_rn(__int2float_rn(iacc[j] - 8 * qsum[qi]), vscale[row]);
          if (I8 && !RAW) s = __fmul_rn(__int2float_rn(iacc[j]), vscale[row]);
          const u64 key = RAW ? int_row_key(iacc[j], (uint32_t)row)
                              : row_key(s, (uint32_t)row);
          if (key > tau[qi]) buf[qi * BUF + atomicAdd(&cnt[qi], 1)] = key;
        }
      }
    }
    __syncthreads();
    bool full = false;
#pragma unroll
    for (int s = 0; s < QT; ++s) full |= cnt[s] > BUF - TR;
    __syncthreads();
    if (full) compact_buffers(buf, cnt, tau, QT, BUF, k);
  }
  __syncthreads();
  compact_buffers(buf, cnt, tau, QT, BUF, k);
  for (int i = threadIdx.x; i < QT * k; i += THREADS) {
    const int qq = i / k, j = i % k;
    if (q0 + qq < Q)
      partial[((long)(q0 + qq) * nchunks + c) * k + j] = buf[qq * BUF + j];
  }
}

template <typename T>
cudaError_t launch_scan(const void* q, const void* v, const void* vscale,
                        const void* mask, u64* partial, int Q, long cap,
                        int dim, int k, long chunk, int nchunks,
                        const int* hot, const int* n_hot, int split,
                        cudaStream_t stream) {
  typedef typename Elem<T>::QT QE;
  typedef typename Elem<T>::VT VE;
  if (k <= 128) {
    dim3 grid((Q + 15) / 16, nchunks);
    scan_topk_kernel<T, 16, 256><<<grid, THREADS, 0, stream>>>(
        static_cast<const QE*>(q), static_cast<const VE*>(v),
        static_cast<const float*>(vscale), static_cast<const uint8_t*>(mask),
        partial, Q, cap, dim, k, chunk, nchunks, hot, n_hot, split);
  } else {
    dim3 grid((Q + 1) / 2, nchunks);
    scan_topk_kernel<T, 2, 2048><<<grid, THREADS, 0, stream>>>(
        static_cast<const QE*>(q), static_cast<const VE*>(v),
        static_cast<const float*>(vscale), static_cast<const uint8_t*>(mask),
        partial, Q, cap, dim, k, chunk, nchunks, hot, n_hot, split);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace pv

// kind 0: v float32, q float32; 1: v bfloat16, q float32; 2: v int8 with
// vscale (cap,) float32, q int8; 3: v (cap, dim / 2) packed int4 with
// vscale (cap,) float32, q int8 (dim even); 4 (K9): column-scaled int8 v
// and folded int8 q, no vscale (raw int32 scores; vals carry them as
// float32). mask (cap,) uint8. `partial` is scratch of
// Q * ceil(cap / chunk) * k uint64 (chunk % 128 == 0); vals (Q, k) float32
// and idx (Q, k) int32 receive the result. k <= 1024.
extern "C" int pv_scan_topk(int kind, const void* q, const void* v,
                            const void* vscale, const void* mask,
                            void* partial, void* vals, void* idx, int Q,
                            long long cap, int dim, int k, long long chunk,
                            void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  u64* part = static_cast<u64*>(partial);
  const int nc = (int)((cap + chunk - 1) / chunk);
  cudaError_t err;
  if (kind == 0)
    err = launch_scan<float>(q, v, vscale, mask, part, Q, cap, dim, k, chunk, nc, nullptr, nullptr, 1, s);
  else if (kind == 1)
    err = launch_scan<__nv_bfloat16>(q, v, vscale, mask, part, Q, cap, dim, k, chunk, nc, nullptr, nullptr, 1, s);
  else if (kind == 2)
    err = launch_scan<int8_t>(q, v, vscale, mask, part, Q, cap, dim, k, chunk, nc, nullptr, nullptr, 1, s);
  else if (kind == 3)
    err = launch_scan<Int4>(q, v, vscale, mask, part, Q, cap, dim, k, chunk, nc, nullptr, nullptr, 1, s);
  else if (kind == 4)
    err = launch_scan<Int8C>(q, v, nullptr, mask, part, Q, cap, dim, k, chunk, nc, nullptr, nullptr, 1, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)launch_topk_merge(part, static_cast<float*>(vals),
                                static_cast<int*>(idx), Q, nc * k, k, s,
                                kind == 4);
}

// K7. kind 0: postings and q float32; 1: both bfloat16; 2: column-scaled
// int8 postings and folded int8 q (raw int32 scores; vals carry them as
// float32, only their -inf-ness is read). postings (cap, dim) with
// cap % bn == 0, mask (cap,) uint8, hot (grid_b,) int32 tile ids in
// [0, cap / bn), n_hot (1,) int32 on the device; each tile spreads over
// `split` blocks (bn % split == 0). `partial` is scratch of
// Q * grid_b * split * k uint64; vals (Q, k) float32 and idx (Q, k) int32
// receive the result (-inf / 0 where empty). k <= 1024.
extern "C" int pv_ivf_scan_topk(int kind, const void* q, const void* v,
                                const void* mask, const void* hot,
                                const void* n_hot, void* partial, void* vals,
                                void* idx, int Q, long long cap, int dim,
                                int k, long long bn, int grid_b, int split,
                                void* stream) {
  using namespace pv;
  if (Q <= 0 || k <= 0 || grid_b <= 0) return (int)cudaSuccess;
  if (split < 1 || bn % split) return (int)cudaErrorInvalidValue;
  const long chunk = (long)(bn / split);
  const int nc = grid_b * split;
  cudaStream_t s = (cudaStream_t)stream;
  u64* part = static_cast<u64*>(partial);
  const int* h = static_cast<const int*>(hot);
  const int* nh = static_cast<const int*>(n_hot);
  cudaError_t err;
  if (kind == 0)
    err = launch_scan<float>(q, v, nullptr, mask, part, Q, cap, dim, k, chunk, nc, h, nh, split, s);
  else if (kind == 1)
    err = launch_scan<Bf16Q>(q, v, nullptr, mask, part, Q, cap, dim, k, chunk, nc, h, nh, split, s);
  else if (kind == 2)
    err = launch_scan<Int8C>(q, v, nullptr, mask, part, Q, cap, dim, k, chunk, nc, h, nh, split, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)launch_topk_merge(part, static_cast<float*>(vals),
                                static_cast<int*>(idx), Q, nc * k, k, s,
                                kind == 2);
}
