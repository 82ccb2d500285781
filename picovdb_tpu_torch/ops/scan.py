"""Selection kernels of the exact scan, their plain versions, and the
routes built from them.

Counterpart of picovdb_tpu/ops/pallas_scan.py for the float32 main path,
the quantized storage tiers and the opt-in column-scaled int8 tier. Eight
hand-written CUDA kernels (`csrc/`) take the place of the eight Pallas
kernels those paths run:

  K1 `segmax_scan`      csrc/segmax.cu     per-128-row-segment top-2 keys
                        (product: csrc/wgmma_tiles.cuh, see `wgmma_ready`)
  K2 `topk_packed_keys` csrc/topk_keys.cu  per-query top-k_sel of the keys
  K3 `fused_topk_i8`    csrc/scan_topk.cu  exact top-k over per-row int8
  K4 `fused_topk`       csrc/scan_topk.cu  exact top-k over f32 / bf16 rows
  K5 `segmax_scan_i8`   csrc/segmax.cu     K1 over per-row int8 rows
  K6 `fused_topk_i4`    csrc/scan_topk.cu  exact top-k over packed int4 rows
  K9 `fused_topk_i8c`   csrc/scan_topk.cu  exact top-k over column-scaled int8
                        (Q <= 16: csrc/sweep_topk.cu, see `sweep_ready`)
  K10 `segmax_scan_i8c` csrc/segmax.cu     K1 over column-scaled int8, int keys

Each wrapper checks its inputs, allocates the outputs, and for a CUDA
tensor launches its kernel on that tensor's device and its current stream
(`_launch`, raising on a launch error) and adds one to `LAUNCHES[name]`.
For a CPU tensor it runs the kernel's plain PyTorch version beside it,
which follows the kernel's decomposition (per-segment top-2 on packed
keys for K1/K5, chunked partial top-k plus merge for K3/K4/K6, the two
nibble planes and the 8 * sum(q) bias fold for K6) so the CPU tests
exercise the key packing, decode and merge logic the kernels rely on.
There is no fallback from a CUDA tensor to a plain version.

The `make_*` factories compose the kernels into the serving routes
(normalize -> select -> exact float32 or dequantizing rescore ->
crowding mark), as the JAX package's factories do; they return plain
closures.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import _build
from .exact import exact_topk, normalize_on_device

# The TPU kernels carry a finite masked-score sentinel (SCORE_SENTINEL)
# that every exit turns into -inf; these kernels write -inf directly.
KEY_MIN = -(2**31)  # packed-key sentinel, below every real key
SEG = 128  # rows per segmax segment

# Kernel launches made through the wrappers, by kernel. Comparing a kernel
# with its plain version does not go through a wrapper's counted path.
# "segmax" and "dot_rowmax" count K1 / P1 (both kinds) on either product;
# the "_wgmma" keys count the TMA + wgmma mainloop alone (see `wgmma_ready`,
# `wgmma_i8_ready`): "dot_rowmax_wgmma" P1-bf16's, "dot_rowmax_i8_wgmma"
# P1-int8's. "scan_topk_i8c" counts every K9 launch, "scan_topk_i8c_sweep"
# those of its one-query sweep (see `sweep_ready`).
LAUNCHES = {"segmax": 0, "segmax_wgmma": 0, "topk_keys": 0, "scan_topk": 0,
            "scan_topk_i8": 0, "segmax_i8": 0, "scan_topk_i4": 0,
            "ivf_scan_topk": 0, "ivf_segmax": 0,  # K7, K8: ops/ivf.py
            "scan_topk_i8c": 0, "scan_topk_i8c_sweep": 0, "segmax_i8c": 0,
            "dot_rowmax": 0, "dot_rowmax_wgmma": 0,  # P1: probes.py
            "dot_rowmax_i8_wgmma": 0}
# Requests whose k_sel exceeded SCAN_KSEL_MAX and went to the plain exact
# scan instead of K3/K4/K6 (the JAX package's `k > bn` fallback).
WIDE_K_FALLBACKS = {"scan_topk": 0, "scan_topk_i8": 0, "scan_topk_i4": 0}

TOPK_KEYS_MAX = 32  # K2's k_sel bound (segmax k + guard <= 22)
SCAN_KSEL_MAX = 1024  # K3/K4/K6/K9's k_sel bound
_PLAIN_CHUNK = 4096  # corpus rows per partial top-k in the plain K3/K4/K6/K9
_I64_MIN = -(2**63)  # empty 64-bit selection key


def reset_launch_counts() -> None:
    for d in (LAUNCHES, WIDE_K_FALLBACKS):
        for name in d:
            d[name] = 0


def _to_sortable(bits: torch.Tensor) -> torch.Tensor:
    """float32 bits (int32) -> int32 whose integer order is the float order."""
    return torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)


def _from_sortable(key: torch.Tensor) -> torch.Tensor:
    """Inverse of `_to_sortable` (low index bits must be cleared first)."""
    return torch.where(key >= 0, key, key ^ 0x7FFFFFFF)


def quantize_rows_i8(v: torch.Tensor):
    """Per-row symmetric int8 quantization: (rows int8, scales f32).

    scales[r] = max|v[r]| / 127, floored so all-zero rows stay finite.
    The division by 127 is a multiplication by float32(1/127), as XLA
    compiles it, so both packages build bit-identical mirrors."""
    f = v.float()
    s = torch.clamp(f.abs().amax(dim=1), min=1e-30) * (1.0 / 127.0)
    q = torch.round(f / s[:, None])  # round half to even, like jnp.round
    return torch.clamp(q, -127, 127).to(torch.int8), s


# ---------------------------------------------------------------------------
# Column-scaled int8 (the IVF tier's int8 postings): one scale per column,
# folded into the query, so selection ranks raw int32 products.
# ---------------------------------------------------------------------------


def colmax_abs(v: torch.Tensor) -> torch.Tensor:
    """Per-column abs-max in float32 (the reduction half of the chunked
    column quantization)."""
    return v.float().abs().amax(dim=0)


def quantize_cols_scaled_i8(v: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Column-quantize against given (dim,) scales: clip(round(v / s))."""
    q = torch.round(v.float() / s[None, :])
    return torch.clamp(q, -127, 127).to(torch.int8)


def quantize_cols_i8(v: torch.Tensor):
    """Per-column symmetric int8 quantization: (rows int8, col scales f32).

    scales[d] = max_r |v[r, d]| / 127, floored so all-zero columns stay
    finite; the division by 127 is a multiplication by float32(1/127), as
    XLA compiles it (bit-identical to picovdb_tpu's quantize_cols_i8)."""
    s = torch.clamp(colmax_abs(v), min=1e-30) * (1.0 / 127.0)
    return quantize_cols_scaled_i8(v, s), s


def fold_queries_i8(queries: torch.Tensor, cscale: torch.Tensor) -> torch.Tensor:
    """Fold the corpus column scales into the queries, then quantize them
    per row. The per-query scale is a positive constant that cannot change
    the query's ranking, so it is dropped."""
    q, _ = quantize_rows_i8(queries.float() * cscale[None, :])
    return q


# ---------------------------------------------------------------------------
# int4 storage: two-plane nibble packing, 0.5 B/element
#
# Element j < dim/2 lives in the LOW nibble of byte j, element j + dim/2 in
# the HIGH nibble; both nibbles store value + 8 (unsigned 1..15), so the
# int4 dot is q[:, :d/2] . lo + q[:, d/2:] . hi - 8 * sum(q). Bit for bit
# the layout of picovdb_tpu's quantize_rows_i4.
# ---------------------------------------------------------------------------


def quantize_rows_i4(v: torch.Tensor):
    """Per-row symmetric int4 quantization: (packed int8 (n, dim/2),
    scales f32 (n,)).

    scales[r] = max|v[r]| / 7 (floored like `quantize_rows_i8`; the
    division is a multiplication by float32(1/7), as XLA compiles it);
    nibbles are clip(round(v / s), -7, 7) + 8. `dim` must be even."""
    f = v.float()
    half = f.shape[1] // 2
    s = torch.clamp(f.abs().amax(dim=1), min=1e-30) * (1.0 / 7.0)
    q = torch.clamp(torch.round(f / s[:, None]), -7, 7).to(torch.int32) + 8
    packed = q[:, :half] | (q[:, half:] << 4)
    # the byte as a signed int8 (XLA's int32 -> int8 keeps the low 8 bits)
    packed = torch.where(packed > 127, packed - 256, packed)
    return packed.to(torch.int8), s


def unpack_i4(packed: torch.Tensor) -> torch.Tensor:
    """(..., dim/2) packed int8 -> (..., dim) int8 values in [-7, 7]
    (unscaled; multiply by the row scales to dequantize)."""
    p = packed.to(torch.int32) & 255
    return torch.cat([(p & 15) - 8, ((p >> 4) & 15) - 8], dim=-1).to(torch.int8)


def unpack_i4_np_into(packed: np.ndarray, out: np.ndarray) -> None:
    """NumPy `unpack_i4` for host paths, writing the unscaled values into
    a caller-provided (n, dim) buffer (no (n, dim) integer temporary)."""
    half = packed.shape[1]
    p = packed.astype(np.int16) & 255
    out[:, :half] = (p & 15) - 8
    out[:, half:] = ((p >> 4) & 15) - 8


def _int_acc(dim: int, bound: int) -> torch.dtype:
    """Float type in which integer dot products with |sum| <= bound * dim
    stay exact: float32 below 2^24, float64 above."""
    return torch.float64 if bound * dim >= 2**24 else torch.float32


def _i4_scores(q_i8: torch.Tensor, v_i4: torch.Tensor,
               vscale: torch.Tensor) -> torch.Tensor:
    """Scaled int4 scores as K6 computes them: the two half-width integer
    products minus the 8 * sum(q) bias, exact, then times the row scale."""
    dim = q_i8.shape[1]
    half = dim // 2
    acc = _int_acc(dim, 127 * 23)
    q = q_i8.to(acc)
    p = v_i4.to(torch.int32) & 255  # the biased nibble planes, 1..15
    lo, hi = (p & 15).to(acc), ((p >> 4) & 15).to(acc)
    s = q[:, :half] @ lo.T + q[:, half:] @ hi.T - 8 * q.sum(dim=1, keepdim=True)
    return s.float() * vscale


def _int_dot(q_i8: torch.Tensor, v_i8: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """The exact int8 x int8 dot products (the kernels' int32 sums) as
    `dtype`: summed in a float type that holds them exactly."""
    acc = _int_acc(q_i8.shape[1], 127 * 127)
    return (q_i8.to(acc) @ v_i8.to(acc).T).to(dtype)


def _i8_scores(q_i8: torch.Tensor, v_i8: torch.Tensor,
               vscale: torch.Tensor) -> torch.Tensor:
    """Scaled int8 scores: the exact integer dot product, then times the
    row scale in float32 (the kernels' int32 sum, converted, scaled)."""
    return _int_dot(q_i8, v_i8, torch.float32) * vscale


def _require_i32_keys(name: str, dim: int) -> None:
    """Raw int32 sums must stay above KEY_MIN: |s| <= 127 * 127 * dim."""
    _require(127 * 127 * dim < 2**31,
             f"{name}: dim {dim} overflows the int32 score keys")


def rescore_exact(queries, vectors, vals, idxs):
    """Replace selection scores with exact float32 dot products.

    Gathers the k winning rows per query, recomputes q . v in float32,
    keeps -inf padding markers, and re-sorts by the exact scores."""
    gathered = vectors[idxs.long()].float()  # (Q, k, dim)
    exact = torch.einsum("qd,qkd->qk", queries.float(), gathered)
    return _pin_and_sort(exact, vals, idxs)


def rescore_exact_i8r(queries, v_i8, vscale, vals, idxs):
    """Dequantizing rescore against a per-row int8 STORAGE corpus: the
    winners are reconstructed as v_i8[row] * vscale[row], the best the
    store holds; scores carry the storage quantization."""
    idx = idxs.long()
    exact = torch.einsum("qd,qkd->qk", queries.float(), v_i8[idx].float())
    return _pin_and_sort(exact * vscale[idx], vals, idxs)


def rescore_exact_i4r(queries, v_i4, vscale, vals, idxs):
    """`rescore_exact_i8r` for the packed int4 layout: the winners unpack
    to [-7, 7] and reconstruct as nibble * vscale[row]."""
    idx = idxs.long()
    g = v_i4[idx].to(torch.int32) & 255
    lo = ((g & 15) - 8).float()
    hi = (((g >> 4) & 15) - 8).float()
    half = v_i4.shape[1]
    q = queries.float()
    exact = (torch.einsum("qd,qkd->qk", q[:, :half], lo)
             + torch.einsum("qd,qkd->qk", q[:, half:], hi))
    return _pin_and_sort(exact * vscale[idx], vals, idxs)


def _pin_and_sort(exact, vals, idxs):
    """-inf where the selection was empty, then a stable descending sort."""
    exact = torch.where(torch.isneginf(vals), float("-inf"), exact)
    order = torch.argsort(-exact, dim=1, stable=True)
    return exact.gather(1, order), idxs.gather(1, order)


def _tie_margin(kind: str, dim: int, scale: float) -> float:
    """Crowding margin for the low-precision selection tiers (see
    picovdb_tpu.ops.pallas_scan._tie_margin): ~1x the tier's score-noise
    rms, which scales as 1/sqrt(dim). The constants were measured against
    the TPU's matrix unit; re-measuring them on the H100 is a ROADMAP
    item. PICOVDB_TIE_MARGIN_SCALE multiplies (0 disables)."""
    base = {"bf16": 0.0017, "int4": 0.22}.get(kind, 0.0122)
    return base * scale / (dim ** 0.5)


def _tie_scale_env() -> float:
    try:
        return float(os.getenv("PICOVDB_TIE_MARGIN_SCALE", "1") or 1)
    except ValueError:
        return 1.0


def _mark_crowded(vals_k, exact_full, k: int, margin: float):
    """Set the k-th value to -inf where the guard band is crowded: the
    k-th and the band's last exact scores lie within `margin`, so rows
    outside the band may belong in the top-k and the engine's exact retry
    re-serves the query. A -inf band bottom (candidates exhausted) is an
    infinite gap and never marks."""
    if margin <= 0.0 or exact_full.shape[1] <= k:
        return vals_k
    crowded = (exact_full[:, k - 1] - exact_full[:, -1]) < margin
    out = vals_k.clone()
    out[crowded, k - 1] = float("-inf")
    return out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(t: torch.Tensor, name: str, entry: str, *args) -> None:
    """Call the kernel library's `entry(*args, stream)` on `t`'s card: under
    `torch.cuda.device(t.device)`, so the launcher's `cudaGetDevice` (SM
    count, shared-memory attribute) and its `<<<>>>` launch address the
    tensor's own device whatever the current one is, with that device's
    current stream as the last argument; raises on the returned code. Every
    launch of the port goes through here."""
    with torch.cuda.device(t.device):
        err = getattr(_build.library(), entry)(*args, _stream(t))
    _build.check(err, name)


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# K1 segmax_scan, K5 segmax_scan_i8
# ---------------------------------------------------------------------------


def _tma_ready(queries, vectors, dim_multiple: int) -> bool:
    return (queries.shape[1] % dim_multiple == 0
            and queries.data_ptr() % 16 == 0 and vectors.data_ptr() % 16 == 0)


def wgmma_ready(queries: torch.Tensor, vectors: torch.Tensor) -> bool:
    """Whether K1 / P1-bf16 run the TMA + wgmma mainloop
    (csrc/wgmma_tiles.cuh) on these contiguous bf16 operands: TMA needs a
    row stride that is a multiple of 16 bytes (dim % 8 == 0) and 16-byte
    aligned bases. Otherwise they run the wmma tile (csrc/tiles.cuh)."""
    return _tma_ready(queries, vectors, 8)


def wgmma_i8_ready(queries: torch.Tensor, vectors: torch.Tensor) -> bool:
    """Whether P1-int8 runs the mainloop's int8 instantiation on these
    contiguous int8 operands: rows of int8 are a multiple of 16 bytes at
    dim % 16 == 0, and both bases 16-byte aligned. Otherwise it runs the
    mma.sync tile (csrc/tiles.cuh `score_tile_i8`, which K5, K8 and K10
    still use)."""
    return _tma_ready(queries, vectors, 16)


def _segmax_checks(name, queries, vectors, mask):
    num_q, dim = queries.shape
    cap = vectors.shape[0]
    _require(vectors.ndim == 2 and vectors.shape[1] == dim,
             f"{name}: vectors {tuple(vectors.shape)} vs dim {dim}")
    _require(cap % SEG == 0, f"{name}: cap {cap} is not a multiple of {SEG}")
    _require(mask.shape == (cap,) and mask.dtype == torch.bool,
             f"{name}: mask must be (cap,) bool")
    return num_q, cap, dim


def segmax_scan(queries: torch.Tensor, vectors: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Per-128-row-segment top-2 packed keys of the masked corpus.

    queries (Q, dim) bf16, vectors (cap, dim) bf16 with cap % 128 == 0,
    mask (cap,) bool -> keys (Q, 2 * cap / 128) int32 with column
    2 * seg + r. A key is the sortable float32 bits of q . v (bf16 inputs,
    float32 sums) with its low 7 bits replaced by the row's lane; masked
    rows carry KEY_MIN. Row of a key in column c: (c // 2) * 128 +
    (key & 127)."""
    num_q, cap, dim = _segmax_checks("segmax_scan", queries, vectors, mask)
    if not queries.is_cuda:
        return segmax_scan_plain(queries, vectors, mask)
    _require(queries.dtype == torch.bfloat16 and vectors.dtype == torch.bfloat16,
             "segmax_scan: the kernel takes bf16 queries and vectors")
    _require(vectors.is_cuda and mask.is_cuda, "segmax_scan: mixed devices")
    q = queries.contiguous()
    _require(vectors.is_contiguous() and mask.is_contiguous(),
             "segmax_scan: vectors and mask must be contiguous")
    keys = torch.empty((num_q, 2 * (cap // SEG)), dtype=torch.int32,
                       device=q.device)
    wgmma = wgmma_ready(q, vectors)
    _launch(q, "segmax_scan",
            "pv_segmax_scan_wgmma" if wgmma else "pv_segmax_scan",
            q.data_ptr(), vectors.data_ptr(), mask.data_ptr(),
            keys.data_ptr(), num_q, cap, dim)
    LAUNCHES["segmax"] += 1
    LAUNCHES["segmax_wgmma"] += wgmma
    return keys


def _segmax_keys(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(Q, cap) float32 scores -> the (Q, 2 * cap / 128) segment keys."""
    return _segment_top2(_to_sortable(scores.view(torch.int32)), mask)


def _segment_top2(raw: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(Q, cap) int32 order-preserving scores -> per 128-row segment the
    two largest packed keys (raw & ~127) | lane, column 2 * seg + r."""
    num_q, cap = raw.shape
    nseg = cap // SEG
    keys = raw.reshape(num_q, nseg, SEG)
    lane = torch.arange(SEG, dtype=torch.int32, device=keys.device)
    keys = (keys & ~(SEG - 1)) | lane
    # mask AFTER packing, or a masked lane's sentinel would get its lane
    # bits ORed back into a live-looking key
    keys = torch.where(mask.reshape(1, nseg, SEG), keys, KEY_MIN)
    m1 = keys.amax(dim=2)
    m2 = torch.where(keys == m1[:, :, None], KEY_MIN, keys).amax(dim=2)
    return torch.stack([m1, m2], dim=2).reshape(num_q, 2 * nseg)


def segmax_scan_plain(queries, vectors, mask):
    """Plain version of K1: the same keys from a dense score matrix."""
    scores = queries.to(vectors.dtype).float() @ vectors.float().T
    return _segmax_keys(scores, mask)


def segmax_scan_i8(q_i8: torch.Tensor, v_i8: torch.Tensor,
                   vscale: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K1 over a per-row int8 corpus (K5): the same (Q, 2 * cap / 128)
    key slab, from scores (q_i8 . v_i8, an exact integer sum) * vscale[row]
    in float32. The query's own scale is a positive per-query constant and
    cannot change its ranking, so it is not applied."""
    num_q, cap, dim = _segmax_checks("segmax_scan_i8", q_i8, v_i8, mask)
    _require(vscale.shape == (cap,), "segmax_scan_i8: vscale must be (cap,)")
    if not q_i8.is_cuda:
        return segmax_scan_i8_plain(q_i8, v_i8, vscale, mask)
    _require(q_i8.dtype == torch.int8 and v_i8.dtype == torch.int8
             and vscale.dtype == torch.float32,
             "segmax_scan_i8: takes int8 queries and vectors, f32 scales")
    _require(v_i8.is_cuda and mask.is_cuda and vscale.is_cuda,
             "segmax_scan_i8: mixed devices")
    q = q_i8.contiguous()
    _require(v_i8.is_contiguous() and mask.is_contiguous()
             and vscale.is_contiguous(),
             "segmax_scan_i8: vectors, scales and mask must be contiguous")
    keys = torch.empty((num_q, 2 * (cap // SEG)), dtype=torch.int32,
                       device=q.device)
    _launch(q, "segmax_scan_i8", "pv_segmax_scan_i8", q.data_ptr(),
            v_i8.data_ptr(), vscale.data_ptr(), mask.data_ptr(),
            keys.data_ptr(), num_q, cap, dim)
    LAUNCHES["segmax_i8"] += 1
    return keys


def segmax_scan_i8_plain(q_i8, v_i8, vscale, mask):
    """Plain version of K5: exact integer products, scaled, then K1's
    key packing."""
    return _segmax_keys(_i8_scores(q_i8, v_i8, vscale), mask)


def segmax_scan_i8c(q_i8: torch.Tensor, v_i8: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """K1 over the column-scaled int8 mirror (K10): the (Q, 2 * cap / 128)
    key slab of the raw int32 sums q_i8 . v_i8, key (s & ~127) | lane, no
    conversion, no scale. `q_i8` must be `fold_queries_i8(queries,
    cscale)` for the mirror's column scales, so the integer sum ranks a
    query's rows as the true score does. Integer keys: bit for bit the TPU
    kernel's, in K1's layout."""
    num_q, cap, dim = _segmax_checks("segmax_scan_i8c", q_i8, v_i8, mask)
    _require_i32_keys("segmax_scan_i8c", dim)
    if not q_i8.is_cuda:
        return segmax_scan_i8c_plain(q_i8, v_i8, mask)
    _require(q_i8.dtype == torch.int8 and v_i8.dtype == torch.int8,
             "segmax_scan_i8c: takes int8 queries and vectors")
    _require(v_i8.is_cuda and mask.is_cuda, "segmax_scan_i8c: mixed devices")
    q = q_i8.contiguous()
    _require(v_i8.is_contiguous() and mask.is_contiguous(),
             "segmax_scan_i8c: vectors and mask must be contiguous")
    keys = torch.empty((num_q, 2 * (cap // SEG)), dtype=torch.int32,
                       device=q.device)
    _launch(q, "segmax_scan_i8c", "pv_segmax_scan_i8c", q.data_ptr(),
            v_i8.data_ptr(), mask.data_ptr(), keys.data_ptr(), num_q, cap,
            dim)
    LAUNCHES["segmax_i8c"] += 1
    return keys


def segmax_scan_i8c_plain(q_i8, v_i8, mask):
    """Plain version of K10: the exact int32 sums packed as keys."""
    return _segment_top2(_int_dot(q_i8, v_i8, torch.int32), mask)


# ---------------------------------------------------------------------------
# K2 topk_packed_keys
# ---------------------------------------------------------------------------


def topk_packed_keys(keys: torch.Tensor, k_sel: int):
    """Per-row top-k_sel of a (Q, C) int32 key slab, descending.

    Returns (keys (Q, k_sel) int32, columns (Q, k_sel) int32). Equal keys
    leave one per round (multiplicity as in `torch.topk`); the kernel
    takes the larger column first."""
    num_q, c = keys.shape
    _require(keys.dtype == torch.int32, "topk_packed_keys: keys must be int32")
    _require(0 < k_sel <= min(c, TOPK_KEYS_MAX),
             f"topk_packed_keys: k_sel {k_sel} outside 1..min({c}, {TOPK_KEYS_MAX})")
    if not keys.is_cuda:
        return topk_packed_keys_plain(keys, k_sel)
    keys = keys.contiguous()
    out_k = torch.empty((num_q, k_sel), dtype=torch.int32, device=keys.device)
    out_c = torch.empty_like(out_k)
    _launch(keys, "topk_packed_keys", "pv_topk_packed_keys", keys.data_ptr(),
            out_k.data_ptr(), out_c.data_ptr(), num_q, c, k_sel)
    LAUNCHES["topk_keys"] += 1
    return out_k, out_c


def topk_packed_keys_plain(keys, k_sel):
    """Plain version of K2."""
    tk, ti = torch.topk(keys, k_sel, dim=1)
    return tk, ti.to(torch.int32)


# ---------------------------------------------------------------------------
# K3 fused_topk_i8 / K4 fused_topk / K6 fused_topk_i4
# ---------------------------------------------------------------------------

# pv_scan_topk's corpus kinds
_KIND_F32, _KIND_BF16, _KIND_I8, _KIND_I4, _KIND_I8C = 0, 1, 2, 3, 4


def _scan_chunk(cap: int, q_tiles: int, num_q: int, k: int,
                device: torch.device) -> int:
    """Corpus rows per block: enough blocks to fill every SM a few times
    over, within a bounded partial-result buffer (<= 256 MiB)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, -(-4 * sms // q_tiles))
    want = min(want, max(1, (256 << 20) // (8 * num_q * k)), -(-cap // SEG))
    chunk = -(-cap // want)
    return -(-chunk // SEG) * SEG


def _scan_topk(queries, vectors, vscale, mask, k: int, name: str,
               int4: bool = False, i8c: bool = False):
    num_q, dim = queries.shape
    cap = vectors.shape[0]
    vdim = dim // 2 if int4 else dim
    _require(vectors.ndim == 2 and vectors.shape[1] == vdim
             and (not int4 or dim % 2 == 0),
             f"{name}: vectors {tuple(vectors.shape)} vs query dim {dim}")
    _require(mask.shape == (cap,) and mask.dtype == torch.bool,
             f"{name}: mask must be (cap,) bool")
    _require(0 < k <= SCAN_KSEL_MAX, f"{name}: k {k} outside 1..{SCAN_KSEL_MAX}")
    if not queries.is_cuda:
        if i8c:
            return fused_topk_i8c_plain(queries, vectors, mask, k)
        return scan_topk_plain(queries, vectors, vscale, mask, k, int4=int4)
    if i8c:
        kind = _KIND_I8C
        _require(vectors.dtype == torch.int8 and queries.dtype == torch.int8,
                 f"{name}: takes int8 queries and column-scaled int8 vectors")
    elif vscale is None:
        kind = {torch.float32: _KIND_F32,
                torch.bfloat16: _KIND_BF16}.get(vectors.dtype)
        _require(kind is not None and queries.dtype == torch.float32,
                 f"{name}: takes float32 queries over float32/bf16 vectors")
    else:
        kind = _KIND_I4 if int4 else _KIND_I8
        _require(vectors.dtype == torch.int8 and queries.dtype == torch.int8
                 and vscale.dtype == torch.float32 and vscale.shape == (cap,),
                 f"{name}: takes int8 queries, int8 vectors, (cap,) f32 scales")
        _require(vscale.is_cuda and vscale.is_contiguous(),
                 f"{name}: vscale must be a contiguous CUDA tensor")
    _require(vectors.is_cuda and mask.is_cuda, f"{name}: mixed devices")
    _require(vectors.is_contiguous() and mask.is_contiguous(),
             f"{name}: vectors and mask must be contiguous")
    q = queries.contiguous()
    sweep = i8c and sweep_ready(q, vectors, k)
    if sweep:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        chunk, nchunks = sweep_partition(cap, sms)
        entry, head = "pv_sweep_topk_i8c", (q.data_ptr(), vectors.data_ptr())
    else:
        q_tiles = -(-num_q // (16 if k <= 128 else 2))
        chunk = _scan_chunk(cap, q_tiles, num_q, k, q.device)
        nchunks = -(-cap // chunk)
        entry, head = "pv_scan_topk", (
            kind, q.data_ptr(), vectors.data_ptr(),
            vscale.data_ptr() if vscale is not None else None)
    partial = torch.empty((num_q * nchunks * k,), dtype=torch.int64,
                          device=q.device)
    vals = torch.empty((num_q, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((num_q, k), dtype=torch.int32, device=q.device)
    _launch(q, name, entry, *head, mask.data_ptr(), partial.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), num_q, cap, dim, k, chunk)
    LAUNCHES[name] += 1
    LAUNCHES["scan_topk_i8c_sweep"] += sweep
    return vals, idx


# K9's one-query sweep (csrc/sweep_topk.cu): its shapes and row ranges
SWEEP_Q_MAX = 16  # query tile sized to Q: 1, 2, 4, 8 or 16
SWEEP_K_MAX = 128
SWEEP_DIM_MAX = 4096  # the CTA's query block (<= 64 KB) in shared memory
SWEEP_CTAS_PER_SM = 2


def sweep_ready(q_i8: torch.Tensor, v_i8: torch.Tensor, k: int) -> bool:
    """Whether K9 runs its one-query sweep on these contiguous operands:
    Q <= 16, k <= 128, rows of 16-byte words (dim % 16 == 0, dim <= 4096)
    and 16-byte aligned bases. Other shapes keep `pv_scan_topk` kind 4."""
    num_q, dim = q_i8.shape
    return (num_q <= SWEEP_Q_MAX and k <= SWEEP_K_MAX and dim % 16 == 0
            and dim <= SWEEP_DIM_MAX and q_i8.data_ptr() % 16 == 0
            and v_i8.data_ptr() % 16 == 0)


def sweep_partition(cap: int, sms: int):
    """The sweep's row ranges on a card of `sms` SMs: (chunk, n), CTA c
    reading rows [c * chunk, min(cap, (c + 1) * chunk)). chunk is a
    multiple of 128, n <= SWEEP_CTAS_PER_SM * sms CTAs (at least one: a
    range may be empty or ragged at the end)."""
    segs = max(1, -(-cap // SEG))
    chunk = -(-segs // min(SWEEP_CTAS_PER_SM * sms, segs)) * SEG
    return chunk, max(1, -(-cap // chunk))


def scan_topk_plain(queries, vectors, vscale, mask, k: int,
                    chunk: int = _PLAIN_CHUNK, int4: bool = False):
    """Plain version of K3/K4/K6: per-chunk partial top-k, then a merge.

    Integer products (int8, and int4's two nibble planes minus the
    8 * sum(q) bias) are summed exactly, in float32 while |sum| < 2^24 and
    in float64 beyond, so they equal the kernels' int32 sums before the
    row scale."""
    num_q = queries.shape[0]
    cap = vectors.shape[0]
    if vscale is None:
        qf = queries.float()
    cand_v, cand_i = [], []
    for s in range(0, cap, chunk):
        e = min(cap, s + chunk)
        if int4:
            sc = _i4_scores(queries, vectors[s:e], vscale[s:e])
        elif vscale is not None:
            sc = _i8_scores(queries, vectors[s:e], vscale[s:e])
        else:
            sc = qf @ vectors[s:e].float().T
        sc = sc.masked_fill(~mask[s:e], float("-inf"))
        tv, ti = torch.topk(sc, min(k, e - s), dim=1)
        cand_v.append(tv)
        cand_i.append(ti + s)
    cv, ci = torch.cat(cand_v, dim=1), torch.cat(cand_i, dim=1)
    kk = min(k, cv.shape[1])
    vals, pos = torch.topk(cv, kk, dim=1)
    idx = ci.gather(1, pos)
    if kk < k:
        vals = torch.cat([vals, vals.new_full((num_q, k - kk), float("-inf"))], 1)
        idx = torch.cat([idx, idx.new_zeros((num_q, k - kk))], 1)
    idx = torch.where(torch.isneginf(vals), 0, idx)
    return vals, idx.to(torch.int32)


def _sel_keys(sc, rows):
    """(score, row) selection keys as int64: higher score first, then the
    lower row, exactly the kernels' 64-bit key order (int scores ranked
    as integers, float scores by their sortable bits)."""
    hi = sc if sc.dtype == torch.int64 else _to_sortable(
        sc.contiguous().view(torch.int32)).to(torch.int64)
    return (hi << 32) | (0xFFFFFFFF - rows)[None, :]


def _merge_sel_keys(cand, k: int, int_scores: bool):
    """The kernels' merge of partial selections: the k best of the
    candidate key blocks, decoded to ((Q, k) float32 scores, -inf where
    empty; (Q, k) int32 rows, 0 where empty)."""
    keys = torch.cat(cand, dim=1)
    kk = min(k, keys.shape[1])
    top = torch.topk(keys, kk, dim=1).values
    if kk < k:
        top = torch.cat([top, top.new_full((top.shape[0], k - kk), _I64_MIN)], 1)
    empty = top == _I64_MIN
    hi = (top >> 32).to(torch.int32)
    vals = hi.float() if int_scores else _from_sortable(hi).view(torch.float32)
    vals = torch.where(empty, float("-inf"), vals)
    idx = torch.where(empty, 0, 0xFFFFFFFF - (top & 0xFFFFFFFF))
    return vals, idx.to(torch.int32)


def fused_topk_i8c_plain(q_i8, v_i8, mask, k: int, chunk: int = _PLAIN_CHUNK):
    """Plain version of K9: per-chunk partial top-k on 64-bit (int32 sum,
    row) keys, then the merge: the kernel's order, ties to the lower row.
    Scores come out as the int32 sums in float32 (-inf / row 0 where
    empty)."""
    cap = v_i8.shape[0]
    cand = []
    for s in range(0, cap, chunk):
        e = min(cap, s + chunk)
        rows = torch.arange(s, e, device=q_i8.device)
        keys = _sel_keys(_int_dot(q_i8, v_i8[s:e], torch.int64), rows)
        keys = torch.where(mask[s:e][None, :], keys, _I64_MIN)
        cand.append(torch.topk(keys, min(k, e - s), dim=1).values)
    return _merge_sel_keys(cand, k, int_scores=True)


def _dense_topk(scores, mask, k: int):
    """Masked dense top-k of a (Q, cap) score matrix (the wide-k path)."""
    scores = scores.masked_fill(~mask[None, :], float("-inf"))
    vals, idx = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    return vals, idx.to(torch.int32)


def fused_topk(queries, vectors, mask, k: int):
    """Exact masked top-k over a float32 or bfloat16 corpus (K4).

    queries (Q, dim) float32, vectors (cap, dim) f32/bf16, mask (cap,)
    bool -> ((Q, k) f32 scores, (Q, k) int32 rows); empty slots carry
    -inf. k beyond SCAN_KSEL_MAX goes to the plain exact scan, like the
    JAX package's k > bn fallback."""
    if k > SCAN_KSEL_MAX:
        WIDE_K_FALLBACKS["scan_topk"] += 1
        return exact_topk(queries, vectors, mask, min(k, vectors.shape[0]))
    return _scan_topk(queries, vectors, None, mask, k, "scan_topk")


def fused_topk_i8(q_i8, v_i8, vscale, mask, k: int):
    """Exact masked top-k over the per-row int8 mirror (K3).

    Scores are (q_i8 . v_i8) * vscale[row]: the query's own scale is a
    positive per-query constant and cannot change its ranking."""
    if k > SCAN_KSEL_MAX:
        WIDE_K_FALLBACKS["scan_topk_i8"] += 1
        return _dense_topk(_i8_scores(q_i8, v_i8, vscale), mask, k)
    return _scan_topk(q_i8, v_i8, vscale, mask, k, "scan_topk_i8")


def fused_topk_i8c(q_i8, v_i8, mask, k: int):
    """Exact masked top-k over the column-scaled int8 mirror (K9).

    q_i8 (Q, dim) = `fold_queries_i8(queries, cscale)`, v_i8 (cap, dim) the
    mirror's rows, mask (cap,) bool -> ((Q, k) float32 raw int32 sums,
    ranking-faithful but not cosines: rescore for real scores; (Q, k)
    int32 rows). Selection ranks the exact int32 sum, ties to the lower
    row (the TPU kernel ranks (s & ~0xFFF) | lane: the sets agree except
    on near-ties). Its routes keep k_sel <= 16; k beyond SCAN_KSEL_MAX is
    refused."""
    _require_i32_keys("fused_topk_i8c", q_i8.shape[1])
    return _scan_topk(q_i8, v_i8, None, mask, k, "scan_topk_i8c", i8c=True)


def fused_topk_i4(q_i8, v_i4, vscale, mask, k: int):
    """Exact masked top-k over a packed int4 corpus (K6).

    q_i8 (Q, dim) int8, v_i4 (cap, dim / 2) packed nibbles (the
    `quantize_rows_i4` layout), vscale (cap,) f32, mask (cap,) bool ->
    ((Q, k) scaled scores, (Q, k) int32 rows). The unpacked corpus is
    never materialized; k beyond SCAN_KSEL_MAX takes the plain dense scan
    of `exact_topk_i4r`'s selection."""
    if k > SCAN_KSEL_MAX:
        WIDE_K_FALLBACKS["scan_topk_i4"] += 1
        return _dense_topk(_i4_scores(q_i8, v_i4, vscale), mask, k)
    return _scan_topk(q_i8, v_i4, vscale, mask, k, "scan_topk_i4", int4=True)


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


def _segmax_finish(queries, keys, rescore_vectors, k: int, guard: int,
                   margin: float, vscale=None, slots=None):
    """The tail shared by the segmax routes: top-k_sel of the key slab
    (K2), decode to rows, (view row -> corpus slot through `slots`),
    exact rescore (times the row scale for int8 storage), crowding mark."""
    k_sel = min(k + guard, keys.shape[1])
    tk, ti = topk_packed_keys(keys, k_sel)
    gidx = (ti // 2) * SEG + (tk & (SEG - 1))
    empty = tk == KEY_MIN
    gidx = torch.where(empty, 0, gidx)
    if slots is not None:
        gidx = slots[gidx.long()]
    gathered = rescore_vectors[gidx.long()].float()
    exact = torch.einsum("qd,qkd->qk", queries, gathered)
    if vscale is not None:
        exact = exact * vscale[gidx.long()]
    exact = torch.where(empty, float("-inf"), exact)
    order = torch.argsort(-exact, dim=1, stable=True)
    vals_full = exact.gather(1, order)
    vals = _mark_crowded(vals_full[:, :k], vals_full, k, margin)
    return vals, gidx.gather(1, order)[:, :k].to(torch.int32)


def segmax_topk(queries, scan_vectors, rescore_vectors, mask, k: int,
                guard: int = 6, normalize: bool = True,
                tie_scale: Optional[float] = None, slots=None):
    """Batch route: segmax candidates (K1) -> top-k_sel of the keys (K2) ->
    exact float32 rescore -> crowding mark.

    queries (Q, dim) f32, scan_vectors (cap, dim) bf16 mirror,
    rescore_vectors (cap, dim) f32, mask (cap,) bool -> ((Q, k) exact
    scores, (Q, k) int32 rows). The rescore uses the float32 queries.

    `slots` serves a compacted corpus view (the filtered-batch route,
    DeviceIndex._filter_view): scan_vectors and mask are the view's, and
    `slots[view_row]` is the row's corpus slot. Candidates translate
    before the rescore, which reads the full-capacity corpus, and the
    returned rows are corpus slots."""
    if tie_scale is None:
        tie_scale = _tie_scale_env()
    if normalize:
        queries = normalize_on_device(queries)
    keys = segmax_scan(queries.to(scan_vectors.dtype), scan_vectors, mask)
    return _segmax_finish(queries, keys, rescore_vectors, k, guard,
                          _tie_margin("bf16", queries.shape[1], tie_scale),
                          slots=slots)


def make_segmax_topk(k: int, guard: int = 6, normalize: bool = True,
                     tie_scale: Optional[float] = None):
    """fn(queries, scan_vectors, rescore_vectors, mask[, slots]) ->
    (vals, idx)."""
    return lambda q, sv, rv, m, slots=None: segmax_topk(
        q, sv, rv, m, k, guard, normalize, tie_scale, slots)


def make_segmax_topk_i8(k: int, guard: int = 6, normalize: bool = True,
                        tie_scale: Optional[float] = None,
                        rescore_dequant: bool = False):
    """Batch route over a per-row int8 corpus: K5 segment keys -> K2 ->
    exact rescore -> crowding mark.

    fn(queries f32, v_i8, vscale, rescore_vectors, mask) -> (vals, idx).
    `rescore_dequant=True` serves int8 STORAGE: rescore_vectors is the
    int8 corpus itself and the winners are reconstructed through the row
    scales (see rescore_exact_i8r); otherwise it is the float32 corpus."""
    if tie_scale is None:
        tie_scale = _tie_scale_env()

    def fn(queries, v_i8, vscale, rescore_vectors, mask):
        if normalize:
            queries = normalize_on_device(queries)
        q_i8, _ = quantize_rows_i8(queries)
        keys = segmax_scan_i8(q_i8, v_i8, vscale, mask)
        return _segmax_finish(
            queries, keys, rescore_vectors, k, guard,
            _tie_margin("i8", queries.shape[1], tie_scale),
            vscale=vscale if rescore_dequant else None)

    return fn


def make_fused_topk_i8(k: int, guard: int = 4, normalize: bool = True,
                       tie_scale: Optional[float] = None,
                       rescore_dequant: bool = False):
    """Small-batch route: exact selection over a per-row int8 corpus (K3)
    + exact float32 (or, for int8 storage, dequantizing) rescore +
    crowding mark.

    fn(queries f32, v_i8, vscale, rescore_vectors, mask) -> (vals, idx)
    """
    if tie_scale is None:
        tie_scale = _tie_scale_env()

    def fn(queries, v_i8, vscale, rescore_vectors, mask):
        if normalize:
            queries = normalize_on_device(queries)
        q_i8, _ = quantize_rows_i8(queries)
        vals, idx = fused_topk_i8(q_i8, v_i8, vscale, mask, k + max(0, guard))
        if rescore_dequant:
            vals, idx = rescore_exact_i8r(queries, v_i8, vscale, vals, idx)
        else:
            vals, idx = rescore_exact(queries, rescore_vectors, vals, idx)
        out = _mark_crowded(vals[:, :k], vals, k,
                            _tie_margin("i8", queries.shape[1], tie_scale))
        return out, idx[:, :k]

    return fn


def make_segmax_topk_i8c(k: int, guard: int = 8, normalize: bool = True,
                         tie_scale: Optional[float] = None):
    """Batch route over the column-scaled int8 mirror: fold the column
    scales into the queries, K10 integer segment keys -> K2 -> exact
    float32 rescore -> crowding mark. The guard is one notch wider than
    the bf16 tier's (8 vs 6): column-scaled noise depends on the data.

    fn(queries f32, v_i8, cscale, rescore_vectors f32, mask) -> (vals, idx)
    """
    if tie_scale is None:
        tie_scale = _tie_scale_env()

    def fn(queries, v_i8, cscale, rescore_vectors, mask):
        if normalize:
            queries = normalize_on_device(queries)
        keys = segmax_scan_i8c(fold_queries_i8(queries, cscale), v_i8, mask)
        return _segmax_finish(queries, keys, rescore_vectors, k, guard,
                              _tie_margin("i8", queries.shape[1], tie_scale))

    return fn


def make_fused_topk_i8c(k: int, guard: int = 6, normalize: bool = True,
                        tie_scale: Optional[float] = None):
    """Small-batch route over the column-scaled int8 mirror: exact
    selection on the raw int32 sums (K9, k + guard) + exact float32
    rescore + crowding mark.

    fn(queries f32, v_i8, cscale, rescore_vectors f32, mask) -> (vals, idx)
    """
    if tie_scale is None:
        tie_scale = _tie_scale_env()

    def fn(queries, v_i8, cscale, rescore_vectors, mask):
        if normalize:
            queries = normalize_on_device(queries)
        q_i8 = fold_queries_i8(queries, cscale)
        vals, idx = fused_topk_i8c(q_i8, v_i8, mask, k + max(0, guard))
        vals, idx = rescore_exact(queries, rescore_vectors, vals, idx)
        out = _mark_crowded(vals[:, :k], vals, k,
                            _tie_margin("i8", queries.shape[1], tie_scale))
        return out, idx[:, :k]

    return fn


def make_fused_topk_i4(k: int, guard: int = 4, normalize: bool = True,
                       tie_scale: Optional[float] = None):
    """int4-storage route: exact selection over the packed corpus (K6) +
    dequantizing rescore. Never marked crowded (`tie_scale` is accepted
    for signature parity): no finer device tier exists to retry into;
    exact ranking of host-born stores comes from the engine's host rescore.

    fn(queries f32, v_i4, vscale, mask) -> (vals, idx)"""
    del tie_scale

    def fn(queries, v_i4, vscale, mask):
        if normalize:
            queries = normalize_on_device(queries)
        q_i8, _ = quantize_rows_i8(queries)
        vals, idx = fused_topk_i4(q_i8, v_i4, vscale, mask, k + max(0, guard))
        vals, idx = rescore_exact_i4r(queries, v_i4, vscale, vals, idx)
        return vals[:, :k], idx[:, :k]

    return fn


def make_mixed_fused_topk(k: int, guard: int = 4, normalize: bool = True,
                          tie_scale: Optional[float] = None):
    """Exact selection over the bf16 mirror (K4) + exact float32 rescore +
    crowding mark.

    fn(queries f32, scan_vectors bf16, rescore_vectors f32, mask)"""
    if tie_scale is None:
        tie_scale = _tie_scale_env()

    def fn(queries, scan_vectors, rescore_vectors, mask):
        if normalize:
            queries = normalize_on_device(queries)
        vals, idx = fused_topk(queries, scan_vectors, mask, k + max(0, guard))
        vals, idx = rescore_exact(queries, rescore_vectors, vals, idx)
        out = _mark_crowded(vals[:, :k], vals, k,
                            _tie_margin("bf16", queries.shape[1], tie_scale))
        return out, idx[:, :k]

    return fn


def make_fused_topk(k: int, compute_dtype_name: Optional[str] = None,
                    rescore: bool = True, normalize: bool = True,
                    guard: int = 4):
    """Exact selection over the corpus itself (K4) + exact rescore.

    fn(queries, vectors, mask) -> (vals, idx). With compute_dtype_name
    "bfloat16" the selection reads bf16 copies of the queries and rows
    (a bf16 corpus is read as it is)."""
    k_sel = k + max(0, guard) if rescore else k

    def fn(queries, vectors, mask):
        if normalize:
            queries = normalize_on_device(queries)
        q_sel, v_sel = queries, vectors
        if compute_dtype_name == "bfloat16":
            q_sel = queries.to(torch.bfloat16).float()
            v_sel = vectors.to(torch.bfloat16)
        vals, idx = fused_topk(q_sel, v_sel, mask, k_sel)
        if rescore:
            vals, idx = rescore_exact(queries, vectors, vals, idx)
            vals, idx = vals[:, :k], idx[:, :k]
        return vals, idx

    return fn
