// The tensor-core product of K1 segmax_scan and of P1 dot_rowmax (bf16 and
// int8 kinds): one persistent, warp-specialised mainloop on Hopper's TMA
// and wgmma, over either operand type. Both replace picovdb_tpu's Pallas
// products (`_segmax_kernel` in ops/pallas_scan.py, `_dot_kernel` and
// `_dot_kernel_i8` in bench/segmax_sweep_probe.py) and are bound by the
// tensor cores (2 Q cap dim operations against operands read about once),
// so the design keeps them fed: copies run ahead of the products and the
// epilogue never leaves the registers.
//
// A CTA holds three warpgroups. Warpgroup 2 is the producer: one elected
// thread keeps a ring of STAGES shared-memory stages filled with TMA
// copies (cp.async.bulk.tensor, 128B swizzle) of a 128-query x 128-byte
// slice of q and a 256-row x 128-byte slice of the corpus, guarded by full
// / empty mbarriers. Warpgroups 0 and 1 are the consumers: each multiplies
// its 64 queries against the stage's 256 rows with four wgmmas per stage,
// accumulators in registers (128 per thread), and releases the stage once
// its products completed. One output tile is 128 queries x 256 corpus
// rows (two 128-row segments); after its last k-stage each consumer thread
// hands its accumulators to the caller's epilogue (`Epi::tile`) in
// registers, so no score ever goes through shared or device memory.
//
// The operand type is a traits struct. A k-stage is 128 bytes of a row in
// both: 64 bf16 (Bf16: wgmma.m64n256k16 bf16 -> f32) or 128 int8 (Int8:
// wgmma.m64n256k32 s8 -> s32, exact integer sums). Each wgmma consumes 32
// bytes of every row, so the ring, the swizzle, the descriptors (+32 B per
// step) and the barrier protocol are byte for byte the same; only the
// instruction, the accumulator type and the TMA element type differ.
//
// The grid is persistent: one CTA per SM walks tiles t = blockIdx.x,
// + gridDim.x, ..., tile t covering query tile t % q_tiles and corpus tile
// t / q_tiles. Query tiles vary fastest, so the CTAs working at one time
// share a few corpus tiles and read each from HBM about once, while the
// queries (4 MB at Q = 2048, dim 1024 bf16) stay in L2. The producer runs
// into the next tile while the consumers run the epilogue, and the
// mbarrier parities carry across ring wraps and tiles alike.
//
// Out-of-range rows (past Q, past cap) and columns (past dim) are zero
// filled by TMA (bf16 +0.0, int8 0), so the epilogue only has to skip
// writing them. TMA needs the row stride and both base addresses 16-byte
// aligned: dim % 8 == 0 for bf16, dim % 16 == 0 for int8; other widths
// take the first score tiles of tiles.cuh. The launcher reads the current
// device (SM count, shared-memory attribute): callers launch under their
// tensors' device.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no libcuda call is linked

#include <algorithm>

#include "common.cuh"

namespace pv {
namespace {
namespace wg {

constexpr int BM = 128;                    // queries per tile (2 x m64)
constexpr int BN = 256;                    // corpus rows per tile
constexpr int ROW_BYTES = 128;             // bytes of a row per k-stage
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * ROW_BYTES;    // 16 KB
constexpr int B_BYTES = BN * ROW_BYTES;    // 32 KB
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int THREADS = 384;               // consumers: warpgroups 0, 1
constexpr int CONSUMER_WARPS = 8;
constexpr int ACC = BN / 2;                // accumulators per thread
// the ring, 1 KB to align it (swizzle atoms are 1024 B), the barriers
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;

// The 128 accumulator registers of an m64n256 wgmma, as asm operands
// %0..%127 and as their constraint list ("+f" or "+r").
#define PV_WG_D128                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "                       \
  "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "              \
  "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "              \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "              \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "              \
  "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "              \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "              \
  "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "              \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "      \
  "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "  \
  "%120, %121, %122, %123, %124, %125, %126, %127}"
#define PV_WG_ACC4(C, i) C(d[i]), C(d[i + 1]), C(d[i + 2]), C(d[i + 3])
#define PV_WG_ACC16(C, i) \
  PV_WG_ACC4(C, i), PV_WG_ACC4(C, i + 4), PV_WG_ACC4(C, i + 8), \
  PV_WG_ACC4(C, i + 12)
#define PV_WG_ACC128(C)                                                       \
  PV_WG_ACC16(C, 0), PV_WG_ACC16(C, 16), PV_WG_ACC16(C, 32),                  \
  PV_WG_ACC16(C, 48), PV_WG_ACC16(C, 64), PV_WG_ACC16(C, 80),                 \
  PV_WG_ACC16(C, 96), PV_WG_ACC16(C, 112)

// bf16 operands, float32 accumulators.
struct Bf16 {
  typedef float Acc;
  static constexpr int BK = 64;       // elements per k-stage (128 B)
  static constexpr int DIM_ALIGN = 8;  // dim % 8 == 0: 16-byte row stride
  static constexpr int ELEM_BYTES = 2;
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;

  // D (64 x 256) = A (64 x 16) . B (256 x 16)^T with both operands K-major
  // in 128B-swizzled shared memory (the plain TN case: scale 1, no
  // transpose bits); scale_d = 0 overwrites D instead of accumulating.
  static __device__ __forceinline__ void mma(float (&d)[ACC], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " PV_WG_D128
        ", %128, %129, p, 1, 1, 0, 0;\n}\n"
        : PV_WG_ACC128("+f")
        : "l"(da), "l"(db), "r"(scale_d));
  }

  // Keeps the compiler from moving the epilogue's accumulator reads above
  // the wgmma.wait_group that completes them. Only after wait_group 0: an
  // accumulator read while a wgmma is in flight serializes the wgmmas.
  static __device__ __forceinline__ void fence(float (&d)[ACC]) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
  }
};

// int8 operands, int32 accumulators: exact integer sums. The integer form
// takes no scale or transpose immediates (both operands are K-major).
struct Int8 {
  typedef int Acc;
  static constexpr int BK = 128;       // elements per k-stage (128 B)
  static constexpr int DIM_ALIGN = 16;  // dim % 16 == 0: 16-byte row stride
  static constexpr int ELEM_BYTES = 1;
  // TMA has no signed 8-bit type; bytes copy as they are and the
  // out-of-bounds zero fill is int8 0
  static constexpr CUtensorMapDataType TMA_TYPE =
      CU_TENSOR_MAP_DATA_TYPE_UINT8;

  static __device__ __forceinline__ void mma(int (&d)[ACC], uint64_t da,
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " PV_WG_D128
        ", %128, %129, p;\n}\n"
        : PV_WG_ACC128("+r")
        : "l"(da), "l"(db), "r"(scale_d));
  }

  static __device__ __forceinline__ void fence(int (&d)[ACC]) {
#pragma unroll
    for (int i = 0; i < ACC; ++i) asm volatile("" : "+r"(d[i])::"memory");
  }
};

#undef PV_WG_ACC128
#undef PV_WG_ACC16
#undef PV_WG_ACC4
#undef PV_WG_D128

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of `map` at (c0 = column, c1 = row) into shared memory at `dst`;
// completion (the box's full byte count, out-of-bounds fill included) is
// reported to the mbarrier `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major operand in 128B-swizzled rows of 128 B:
// start address >> 4 (bits 0-13), leading offset unused by the swizzled
// K-major layout (1, bits 16-29), stride 1024 B between 8-row groups
// (bits 32-45), layout SWIZZLE_128B (1, bits 62-63). A wgmma step inside a
// stage (k16 bf16, k32 int8: 32 B of each row) is +32 B of start address,
// i.e. + 2 on the descriptor.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The mainloop. `Epi::tile(acc, q0, r0, Q, cap)` runs in each consumer
// thread once per output tile (queries q0.., corpus rows r0..). Fragment
// layout of `acc` (wgmma's accumulator, f32 of m64nNk16 and s32 of
// m64nNk32 alike): lane l of warp w of consumer warpgroup g holds tile
// rows 64 g + 16 w + l / 4 (h = 0) and + 8 (h = 1), at columns
// 8 j + 2 (l % 4) + e, in acc[4 j + 2 h + e].
template <class T, class Epi>
__global__ void __launch_bounds__(THREADS, 1)
tiles_kernel(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tv, const Epi epi, int Q,
             long cap, int dim) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t a_ring = base, b_ring = base + STAGES * A_BYTES;
  const uint32_t full = base + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);  // the producer's expect_tx arrival
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int q_tiles = (Q + BM - 1) / BM;
  const int tiles = q_tiles * (int)((cap + BN - 1) / BN);
  const int k_iters = (dim + T::BK - 1) / T::BK;

  if (threadIdx.x >= 2 * 128) {  // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 2 * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int q0 = (t % q_tiles) * BM, r0 = (t / q_tiles) * BN;
        for (int k = 0; k < k_iters; ++k) {
          mbar_wait(empty + 8 * stage, phase ^ 1);  // first lap: free
          mbar_expect_tx(full + 8 * stage, STAGE_BYTES);
          tma_load_2d(a_ring + stage * A_BYTES, &tq, full + 8 * stage,
                      k * T::BK, q0);
          tma_load_2d(b_ring + stage * B_BYTES, &tv, full + 8 * stage,
                      k * T::BK, r0);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const uint32_t a_half = (threadIdx.x / 128) * (A_BYTES / 2);
    const bool leader = threadIdx.x % 32 == 0;
    typename T::Acc acc[ACC];
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[i] = 0;
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int prev = 0;
      for (int k = 0; k < k_iters; ++k) {
        mbar_wait(full + 8 * stage, phase);
        const uint64_t da = sw128_desc(a_ring + stage * A_BYTES + a_half);
        const uint64_t db = sw128_desc(b_ring + stage * B_BYTES);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < ROW_BYTES / 32; ++kk)
          T::mma(acc, da + 2 * kk, db + 2 * kk, (k | kk) != 0);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the previous stage's products have completed: release it
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        if (k > 0 && leader) mbar_arrive(empty + 8 * prev);
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      T::fence(acc);
      if (leader) mbar_arrive(empty + 8 * prev);
      epi.tile(acc, (t % q_tiles) * BM, (long)(t / q_tiles) * BN, Q, cap);
    }
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so the library needs
// no -lcuda.
#if CUDART_VERSION < 12050
#error "wgmma_tiles.cuh needs CUDA 12.5 or later (cudaGetDriverEntryPointByVersion)"
#endif
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// 0, or a cudaError_t when libcuda has no cuTensorMapEncodeTiled.
inline int encoder(EncodeTiled* out) {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    if (e != cudaSuccess) return (int)e;
    if (found != cudaDriverEntryPointSuccess || !p)
      return (int)cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  *out = fn;
  return 0;
}

// The tensor map of a (rows, dim) row-major matrix of T's elements read in
// boxes of 128 bytes x box_rows rows, 128B-swizzled, out-of-bounds elements
// zero. 0, or minus the CUresult of a refused encode.
template <class T>
int encode_rows(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                long long rows, int dim, int box_rows) {
  const cuuint64_t gdim[2] = {(cuuint64_t)dim, (cuuint64_t)rows};
  const cuuint64_t gstride[1] = {(cuuint64_t)dim * T::ELEM_BYTES};
  const cuuint32_t box[2] = {(cuuint32_t)T::BK, (cuuint32_t)box_rows};
  const cuuint32_t estride[2] = {1, 1};
  const CUresult r = enc(map, T::TMA_TYPE, 2, const_cast<void*>(ptr), gdim,
                         gstride, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : -(int)r;
}

// Encodes q (Q, dim) and v (cap, dim), both of T's type, and launches the
// persistent kernel on the current device (one CTA per SM, fewer when
// there are fewer tiles). Returns 0, a cudaError_t, or minus a CUresult of
// the encode.
template <class T, class Epi>
int launch_tiles(const void* q, const void* v, const Epi& epi, int Q,
                 long long cap, int dim, cudaStream_t stream) {
  if (Q <= 0 || cap <= 0) return (int)cudaSuccess;
  if (dim <= 0 || dim % T::DIM_ALIGN || ((uintptr_t)q | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
  EncodeTiled enc;
  int err = encoder(&enc);
  if (err) return err;
  CUtensorMap tq, tv;
  if ((err = encode_rows<T>(enc, &tq, q, Q, dim, BM))) return err;
  if ((err = encode_rows<T>(enc, &tv, v, cap, dim, BN))) return err;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)  // > 48 KB of dynamic shared memory
    e = cudaFuncSetAttribute(tiles_kernel<T, Epi>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)((Q + BM - 1) / BM) * ((cap + BN - 1) / BN);
  if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;  // int tile ids
  const int grid = (int)std::min<long long>(tiles, sms);
  tiles_kernel<T, Epi><<<grid, THREADS, SMEM_BYTES, stream>>>(tq, tv, epi, Q,
                                                              (long)cap, dim);
  return (int)cudaGetLastError();
}

}  // namespace wg
}  // namespace
}  // namespace pv
