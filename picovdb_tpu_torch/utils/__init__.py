"""Host-side utilities: paths, hashing, normalization, timing.

Behavioral counterpart of the reference's utility section
(reference: picovdb/pico_vdb.py:42-94), re-implemented vectorized: the
reference normalizes and hashes one vector at a time inside a Python loop;
here whole batches are normalized with one NumPy pass so bulk upserts stay
host-cheap before the device transfer.
"""

from __future__ import annotations

import functools
import hashlib
import logging
import time

import numpy as np

from ..constants import Float

logger = logging.getLogger("picovdb_tpu_torch")


# --- persistence path naming (reference: picovdb/pico_vdb.py:42-51) ---------

def ids_path(base: str) -> str:
    return f"{base}.ids.json"


def meta_path(base: str) -> str:
    return f"{base}.meta.json"


def vecs_path(base: str) -> str:
    return f"{base}.vecs.npy"


def ann_path(base: str) -> str:
    """On-disk ANN index sidecar (counterpart of `<base>.vecs.npy.faiss`)."""
    return f"{base}.vecs.npy.ivf.npz"


# --- hashing -----------------------------------------------------------------

def hash_vec(v: np.ndarray) -> str:
    """Content ID: md5 hex of the vector's bytes (reference: pico_vdb.py:54-55)."""
    return hashlib.md5(np.ascontiguousarray(v).tobytes()).hexdigest()


def hash_rows(mat: np.ndarray) -> list:
    """md5 hex per row of a C-contiguous 2-D matrix."""
    mat = np.ascontiguousarray(mat)
    return [hashlib.md5(row.tobytes()).hexdigest() for row in mat]


# --- normalization -----------------------------------------------------------

def normalize(v: np.ndarray) -> np.ndarray:
    """Zero-safe L2 normalization of a single vector.

    The zero vector maps deterministically to the first basis vector e0
    (reference: picovdb/pico_vdb.py:58-68).
    """
    vec = np.asarray(v, dtype=Float)
    n = float(np.linalg.norm(vec))
    if n == 0.0:
        out = np.zeros_like(vec, dtype=Float)
        if out.size:
            out.flat[0] = Float(1.0)
        return out
    return (vec / n).astype(Float, copy=False)


def normalize_batch(mat: np.ndarray, inplace: bool = False) -> np.ndarray:
    """Zero-safe L2 normalization of a (N, dim) batch in one vectorized pass.

    Rows of all zeros map to e0, matching `normalize` and the reference's
    query-side batch handling (picovdb/pico_vdb.py:583-591).

    Row norms are computed through a batched BLAS dot (`matmul` of (N,1,dim)
    by (N,dim,1)), which is bit-identical to the reference's per-vector
    `np.linalg.norm(vec)` (1-D norm = BLAS dot + sqrt) — so normalized bytes,
    and therefore md5 content IDs, match the reference exactly. A plain
    axis-wise `np.linalg.norm(mat, axis=1)` differs by 1 ULP on ~19% of
    random vectors (verified empirically), which would make auto-generated
    IDs diverge from reference-created stores.

    With `inplace=True` and a C-contiguous float32 input, rows are scaled
    in place (no second (N, dim) allocation) — the bulk-load fast path.
    """
    mat = np.ascontiguousarray(mat, dtype=Float)
    if mat.ndim != 2:
        raise ValueError(f"normalize_batch expects 2-D input; got {mat.shape}")
    if mat.shape[0] == 0:
        return mat
    sq = np.matmul(mat[:, None, :], mat[:, :, None])[:, 0, 0]
    norms = np.sqrt(sq, out=sq)
    zero = norms == 0.0
    if np.any(zero):
        if not inplace:
            mat = mat.copy()
        mat[zero] = 0.0
        if mat.shape[1]:
            mat[zero, 0] = 1.0
        norms[zero] = 1.0
    if inplace:
        mat /= norms[:, None]
        return mat
    return (mat / norms[:, None]).astype(Float, copy=False)


def to_c_f32(a: np.ndarray) -> np.ndarray:
    """C-contiguous float32 view/copy (reference: picovdb/pico_vdb.py:71-73)."""
    return np.ascontiguousarray(a, dtype=Float)


# --- timing ------------------------------------------------------------------

def timed(name: str):
    """DEBUG-level wall-time logging decorator (reference: pico_vdb.py:81-94).

    Logs "<name> took X ms" at DEBUG level on the "picovdb_tpu_torch" logger.
    """

    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            start = time.perf_counter()
            result = func(*args, **kwargs)
            end = time.perf_counter()
            logger.debug("%s took %.4f ms", name, (end - start) * 1000)
            return result

        return wrapper

    return decorator


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (int(n - 1).bit_length())


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def encode_query_wire(vecs: np.ndarray, wire: str) -> np.ndarray:
    """Cast a (Q, dim) f32 query batch to a compact upload dtype.

    The batch serving lanes ship queries host->device; on
    bandwidth-limited links the f32 wire dominates the e2e wall
    (BENCH_r03: a 128 MB query upload behind ~30 MB/s). Every consumer
    normalizes queries on device, so any uniform per-row prescale is free
    for the cosine ranking — which makes float16 safe for arbitrary
    magnitudes: rows whose max |component| falls outside f16's comfortable
    range are rescaled into it first (zero rows pass through as zeros).

    `wire`:
      * "int16" (2 B, the `auto` pick): per-row max-scaled fixed point,
        [-32704, 32704] with truncation (see the branch below for why).
        At the same bytes as float16 its rounding noise is ~9x lower
        (every row uses ~all 15 magnitude bits; f16 spends 5 on
        exponent), measured recall@10 = 1.0000 where f16 loses the odd
        boundary tie (bench/results/wire_ab_r4.json). No scale column
        travels — the device-side L2 normalization divides any per-row
        scale back out.
      * "float16" (2 B, ~2^-11 relative rounding; rescales rows whose
        max |component| falls outside f16's safe band).
      * "bfloat16" (2 B, ~2^-9; full f32 exponent range, never rescales).
      * "int8" (1 B, opt-in for extreme links: per-row max-scaled to
        [-127, 127]; ~0.98 recall@10 on random corpora).
    The caller's array is never mutated.
    """
    if wire == "bfloat16":
        # NumPy has no bfloat16: this wire travels as a CPU torch tensor,
        # which DeviceIndex.query_async uploads and widens like the others
        import torch

        return torch.from_numpy(np.ascontiguousarray(vecs)).to(torch.bfloat16)
    if wire == "int16":
        # Hot serving path: two passes over the batch (scale-multiply,
        # cast) instead of five (multiply/rint/clip/astype + clip temp).
        # Targeting 32704 < 32767 makes the clip unnecessary (f32
        # rounding in the multiply cannot push |x|*32704/row_max past
        # 32767), and C-cast truncation toward zero costs at most 1 LSB
        # of 32704 (~3e-5 relative) vs rint's 0.5 — far inside the
        # recall-1.0000 margin (int12 already measures min cosine
        # 1.000000 vs f32 on gaussian rows). Measured on the bench
        # host: 848 ms -> 354 ms for the 32768 x 1024 encode.
        row_max = np.abs(vecs).max(axis=1)
        safe = np.where(row_max > 0.0, row_max, 1.0)
        with np.errstate(over="ignore", invalid="ignore"):
            # denormal-scale rows overflow the factor to inf here and
            # are recomputed on the fallback below — expected, not noise
            factor = (np.float32(32704.0) / safe)[:, None].astype(
                np.float32
            )
            out = (vecs * factor).astype(np.int16)  # zero rows stay 0
        bad = ~np.isfinite(factor[:, 0])
        if bad.any():
            # denormal-scale rows (row_max < ~1.2e-34 overflows the f32
            # factor to inf, and inf/NaN -> int16 is undefined): redo
            # just those rows in float64 on the old clipped path
            vb = vecs[bad].astype(np.float64)
            sb = np.abs(vb).max(axis=1)
            sb = np.where(sb > 0.0, sb, 1.0)[:, None]
            out[bad] = np.clip(
                np.rint(vb * (32704.0 / sb)), -32704, 32704
            ).astype(np.int16)
        return out
    if wire == "int8":
        row_max = np.abs(vecs).max(axis=1)
        scale = np.where(row_max > 0.0, row_max, 1.0)[:, None]
        return np.clip(
            np.rint(vecs * (127.0 / scale)), -127.0, 127.0
        ).astype(np.int8)
    if wire != "float16":
        raise ValueError(f"unknown query wire dtype: {wire!r}")
    row_max = np.abs(vecs).max(axis=1)
    lo = float(row_max.min()) if row_max.size else 1.0
    hi = float(row_max.max()) if row_max.size else 1.0
    if 1e-3 <= lo and hi <= 6e4:
        # every row sits in f16's safe band: one straight cast
        return vecs.astype(np.float16)
    scale = np.where(row_max > 0.0, row_max, 1.0)[:, None]
    return (vecs / scale).astype(np.float16)
