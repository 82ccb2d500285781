"""Selection kernels of the exact scan, their plain versions, and the
routes built from them.

Counterpart of picovdb_tpu/ops/pallas_scan.py for the float32 main path,
the quantized storage tiers and the opt-in column-scaled int8 tier. Eight
hand-written CUDA kernels (`csrc/`) take the place of the eight Pallas
kernels those paths run:

  K1 `segmax_scan`      csrc/segmax.cu     per-128-row-segment top-2 keys
                        (product: csrc/wgmma_tiles.cuh, see `wgmma_ready`;
                        fed by cp.async, see `cpasync_ready`; by the
                        realigning producer, see `realign_ready`)
  K2 `topk_packed_keys` csrc/topk_keys.cu  per-query top-k_sel of the keys
  K3 `fused_topk_i8`    csrc/scan_topk.cu  exact top-k over per-row int8
                        (past k 128 where it reads the rows no more
                        often, and past k 384: csrc/topk_i8_wide.cu,
                        see `i8_wide_ready`; else small Q, k <= 384:
                        csrc/sweep_topk.cu, see `i8_sweep_ready`; larger
                        Q: csrc/scan_topk_wgmma.cu, see `i8_wgmma_ready`)
  K4 `fused_topk`       csrc/scan_topk.cu  exact top-k over f32 / bf16 rows
                        (small Q, k <= 128: csrc/sweep_topk.cu, see
                        `topk_sweep_ready` and, at any width and base,
                        `topk_narrow_ready`; else k <= 128:
                        csrc/scan_topk_wgmma.cu,
                        see `topk_wgmma_ready`; 128 < k <= 1024: the
                        wide kind, csrc/topk_wide.cu, see
                        `topk_wide_ready`: that scan writing a slab of
                        score keys, then a radix select a query, over
                        the rows in ranges past a slab's budget, see
                        `topk_wide_plan`)
  K5 `segmax_scan_i8`   csrc/segmax.cu     K1 over per-row int8 rows
                        (product: csrc/wgmma_tiles.cuh, see `wgmma_i8_ready`,
                        `cpasync_i8_ready`, `realign_i8_ready`)
  K6 `fused_topk_i4`    csrc/scan_topk.cu  exact top-k over packed int4 rows
                        (Q <= 4: csrc/sweep_topk.cu, see `i4_sweep_ready`
                        and, at any even width and base,
                        `i4_narrow_ready`; else csrc/scan_i4_wgmma.cu,
                        `i4_wgmma_ready`; 128 < k <= 1024: the wide kind,
                        csrc/topk_i4_wide.cu, see `i4_wide_ready`, in
                        ranges as K4's)
  K9 `fused_topk_i8c`   csrc/scan_topk.cu  exact top-k over column-scaled int8
                        (small Q, k <= 128: csrc/sweep_topk.cu, see
                        `sweep_ready` and, at any width and base,
                        `i8c_narrow_ready`; else k <= 128:
                        csrc/scan_topk_wgmma.cu, see `i8c_wgmma_ready`;
                        128 < k <= 1024: csrc/topk_i8_wide.cu, see
                        `i8c_wide_ready`)
  K10 `segmax_scan_i8c` csrc/segmax.cu     K1 over column-scaled int8, int keys
                        (product: csrc/wgmma_tiles.cuh, K5's producers)

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
# `wgmma_i8_ready`), "segmax_cpasync" K1 on the mainloop fed by cp.async
# (`cpasync_ready`), "segmax_realign" K1 on the mainloop fed by its
# realigning producer (`realign_ready`): "dot_rowmax_wgmma" P1-bf16's,
# "dot_rowmax_i8_wgmma" P1-int8's, "segmax_i8c_wgmma" K10's ("segmax_i8c"
# counts every K10 launch), "segmax_i8_wgmma" K5's ("segmax_i8" every K5
# launch); "segmax_i8_cpasync" / "segmax_i8_realign" and
# "segmax_i8c_cpasync" / "segmax_i8c_realign" count K5's and K10's int8
# mainloop fed by cp.async (`cpasync_i8_ready`) or by the realigning
# producer (`realign_i8_ready`), each with its launches by shape in
# LAUNCH_SHAPES as K5's and K10's TMA kind ("_wgmma").
# "scan_topk" counts every K4 launch, "scan_topk_sweep" those of its
# one-query sweep (`topk_sweep_ready`), "scan_topk_narrow" those of the
# sweep's narrow kind at any width and base (`topk_narrow_ready`), both
# with their launches by shape in LAUNCH_SHAPES, "scan_topk_wgmma" those of
# its tensor-core scan (`topk_wgmma_ready`), "scan_topk_wide" those of its
# wide kind (`topk_wide_ready`: the slab pass and the radix select, one
# call).
# "scan_topk_i8c" counts every K9
# launch, "scan_topk_i8c_sweep" those of its one-query sweep (see
# `sweep_ready`), "scan_topk_i8c_narrow" those of the sweep's narrow kind
# at any width and base (`i8c_narrow_ready`), "scan_topk_i8c_wgmma" those
# of its tensor-core scan (`i8c_wgmma_ready`), "scan_topk_i8c_wide" those
# of its wide kind (`i8c_wide_ready`); "ivf_scan_topk" every
# K7 launch, "ivf_scan_topk_sweep" its sweep's (ops/ivf.py::
# `ivf_sweep_ready`), "ivf_scan_topk_wgmma" its tensor-core scan's
# (`ivf_wgmma_ready`); "scan_topk_i4" every K6 launch, "scan_topk_i4_sweep"
# those of the sweep's int4 kind (`i4_sweep_ready`), "scan_topk_i4_narrow"
# those of the sweep's narrow int4 kind at any even width and base
# (`i4_narrow_ready`), "scan_topk_i4_wgmma"
# those of its tensor-core scan (`i4_wgmma_ready`), "scan_topk_i4_wide"
# those of its wide kind (`i4_wide_ready`), "scan_topk_i4_wide_ranges"
# those of them that walked the rows in ranges (`topk_wide_plan`), as
# "scan_topk_wide_ranges" K4's wide kind's; "scan_topk_i8" every K3
# launch, "scan_topk_i8_sweep" those of the sweep's row-scaled int8 kind
# (`i8_sweep_ready`), "scan_topk_i8_wgmma" those of the tensor-core scan's
# int8 kind (`i8_wgmma_ready`), "scan_topk_i8_wide" those of its wide kind
# (`i8_wide_ready`); "scan_topk_i8_narrow" those of the sweep's narrow
# kind over int8 rows at any width and base (`i8_narrow_ready`);
# "ivf_scan_topk_narrow" those of K7's narrow sweep (ops/ivf.py::
# `ivf_narrow_ready`). The tensor-core scans and wide kinds of K4, K3, K6,
# K7 and K9 and K8's segment scan read the rows by the producer
# `rows_piece` names (K6's: its expanders' reads): their keys count TMA's,
# and the
# same keys ending in "_cpasync" count them fed by cp.async, "_realign" by
# the realigning producer, over rows TMA cannot read
# ("scan_topk_wgmma_cpasync", "scan_topk_wide_realign",
# "scan_topk_i8_wgmma_realign", "scan_topk_i8_wide_cpasync", ...); each of
# these keys, "scan_topk_i8_narrow", "scan_topk_i4_narrow",
# "scan_topk_i8c_narrow", "ivf_scan_topk_narrow" and the two "_ranges"
# keys also has its launches by shape in LAUNCH_SHAPES. "ivf_scan_topk_wide"
# those of K7's wide kind (ops/ivf.py::`ivf_wide_ready`); "ivf_segmax" every K8 launch,
# "ivf_segmax_wgmma" those of its tensor-core segment scan over rows TMA
# reads (ops/ivf.py::`ivf_segmax_scan`).
LAUNCHES = {"segmax": 0, "segmax_wgmma": 0, "segmax_cpasync": 0,
            "segmax_realign": 0,
            "topk_keys": 0, "scan_topk": 0, "scan_topk_wgmma": 0,
            "scan_topk_wide": 0, "scan_topk_wide_ranges": 0,
            "scan_topk_sweep": 0, "scan_topk_narrow": 0,
            "scan_topk_wgmma_cpasync": 0, "scan_topk_wgmma_realign": 0,
            "scan_topk_wide_cpasync": 0, "scan_topk_wide_realign": 0,
            "scan_topk_i8": 0, "scan_topk_i8_sweep": 0,
            "scan_topk_i8_wgmma": 0, "scan_topk_i8_wide": 0,
            "scan_topk_i8_narrow": 0,
            "scan_topk_i8_wgmma_cpasync": 0, "scan_topk_i8_wgmma_realign": 0,
            "scan_topk_i8_wide_cpasync": 0, "scan_topk_i8_wide_realign": 0,
            "segmax_i8": 0,
            "segmax_i8_wgmma": 0, "segmax_i8_cpasync": 0,
            "segmax_i8_realign": 0,
            "scan_topk_i4": 0, "scan_topk_i4_sweep": 0,
            "scan_topk_i4_wgmma": 0, "scan_topk_i4_wide": 0,
            "scan_topk_i4_wide_ranges": 0, "scan_topk_i4_narrow": 0,
            "scan_topk_i4_wgmma_cpasync": 0, "scan_topk_i4_wgmma_realign": 0,
            "scan_topk_i4_wide_cpasync": 0, "scan_topk_i4_wide_realign": 0,
            "ivf_scan_topk": 0, "ivf_scan_topk_sweep": 0,  # K7: ops/ivf.py
            "ivf_scan_topk_wgmma": 0, "ivf_scan_topk_wide": 0,
            "ivf_scan_topk_narrow": 0,
            "ivf_scan_topk_wgmma_cpasync": 0, "ivf_scan_topk_wgmma_realign": 0,
            "ivf_scan_topk_wide_cpasync": 0, "ivf_scan_topk_wide_realign": 0,
            "ivf_segmax": 0, "ivf_segmax_wgmma": 0,  # K8: ops/ivf.py
            "ivf_segmax_wgmma_cpasync": 0, "ivf_segmax_wgmma_realign": 0,
            "scan_topk_i8c": 0, "scan_topk_i8c_sweep": 0,
            "scan_topk_i8c_narrow": 0, "scan_topk_i8c_wgmma": 0,
            "scan_topk_i8c_wgmma_cpasync": 0, "scan_topk_i8c_wgmma_realign": 0,
            "scan_topk_i8c_wide": 0, "scan_topk_i8c_wide_cpasync": 0,
            "scan_topk_i8c_wide_realign": 0, "segmax_i8c": 0,
            "segmax_i8c_wgmma": 0, "segmax_i8c_cpasync": 0,
            "segmax_i8c_realign": 0,
            "dot_rowmax": 0, "dot_rowmax_wgmma": 0,  # P1: probes.py
            "dot_rowmax_i8_wgmma": 0}
# Requests whose k_sel exceeded SCAN_KSEL_MAX and went to the plain exact
# scan instead of K3/K4/K6 (the JAX package's `k > bn` fallback).
WIDE_K_FALLBACKS = {"scan_topk": 0, "scan_topk_i8": 0, "scan_topk_i4": 0}

TOPK_KEYS_MAX = 32  # K2's k_sel bound (segmax k + guard <= 22)
SCAN_KSEL_MAX = 1024  # K3/K4/K6/K9's k_sel bound
_PLAIN_CHUNK = 4096  # corpus rows per partial top-k in the plain K3/K4/K6/K9
_I64_MIN = -(2**63)  # empty 64-bit selection key


# Each kernel's launches by shape, e.g. LAUNCH_SHAPES["scan_topk_i4"]
# [(2048, 14)]: the split of LAUNCHES[name] (not of its sub-kernel keys,
# but for those of K3's and K6's narrow sweeps, K6's tensor-core kinds, K5's
# and K10's kinds and the kinds over rows TMA cannot read) by the launch's
# query count and k (k_sel; per_seg for K8; None where a
# kernel takes no k), so a cost per launch is weighed at the shape the
# launch was made at.
LAUNCH_SHAPES: dict = {}


def reset_launch_counts() -> None:
    for d in (LAUNCHES, WIDE_K_FALLBACKS):
        for name in d:
            d[name] = 0
    LAUNCH_SHAPES.clear()


def _count(name: str, num_q: int, k: int | None = None) -> None:
    """One launch of kernel `name` with `num_q` queries and `k`: LAUNCHES
    and LAUNCH_SHAPES."""
    LAUNCHES[name] += 1
    per = LAUNCH_SHAPES.setdefault(name, {})
    per[num_q, k] = per.get((num_q, k), 0) + 1



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
    aligned bases. Otherwise K1 takes `cpasync_ready`'s producer or
    `realign_ready`'s, P1-bf16 the wmma tile (csrc/tiles.cuh)."""
    return _tma_ready(queries, vectors, 8)


def cpasync_piece(queries: torch.Tensor, vectors: torch.Tensor) -> int:
    """The bytes a cp.async copy of the mainloop's second producer moves
    on these bf16 or int8 operands: 8 where the row bytes and both bases
    are multiples of 8, 4 where they are multiples of 4, 0 where neither
    holds. Mirrors pv_segmax_scan_cpasync's and
    pv_segmax_scan_i8[c]_cpasync's choice."""
    bits = (queries.shape[1] * queries.element_size() | queries.data_ptr()
            | vectors.data_ptr())
    return 8 if bits % 8 == 0 else 4 if bits % 4 == 0 else 0


def cpasync_ready(queries: torch.Tensor, vectors: torch.Tensor) -> bool:
    """Whether K1 runs the TMA + wgmma mainloop fed by its cp.async
    producer on these contiguous bf16 operands: TMA cannot read them
    (`wgmma_ready` fails), yet cp.async can copy their rows in 8- or
    4-byte pieces (an even dim, 4-byte aligned bases; `cpasync_piece`).
    Odd widths and 2-byte aligned views take `realign_ready`'s producer."""
    return (not wgmma_ready(queries, vectors)
            and cpasync_piece(queries, vectors) > 0)


def realign_ready(queries: torch.Tensor, vectors: torch.Tensor) -> bool:
    """Whether K1 runs the TMA + wgmma mainloop fed by its realigning
    producer on these contiguous bf16 operands: every pair the other two
    producers refuse (an odd dim, or a base only 2-byte aligned). TMA
    stages each row's aligned span (rows j, j + 8, ... as one 2D tensor
    each, whose stride of 8 rows, 16 dim bytes, TMA can take, from row
    j's start aligned down to 16 bytes) and the producer warpgroup shifts
    the slices into place in shared memory. At dim 1020 it took 2.26-2.41
    ms where cp.async took 1.53-1.65 (H100 80GB HBM3, 700 W; PERF.md), so
    even widths keep `cpasync_ready`. bf16 bases are always 2-byte
    aligned, so with `wgmma_ready` and `cpasync_ready` it covers every
    pair, and K1 never dispatches to the wmma tile."""
    return (not wgmma_ready(queries, vectors)
            and not cpasync_ready(queries, vectors))


def wgmma_i8_ready(queries: torch.Tensor, vectors: torch.Tensor) -> bool:
    """Whether K5, K10 and P1-int8 run the mainloop's int8 instantiation fed
    by TMA on these contiguous int8 operands: rows of int8 are a multiple
    of 16 bytes at dim % 16 == 0, and both bases 16-byte aligned.
    Otherwise K5 and K10 take `cpasync_i8_ready`'s producer or
    `realign_i8_ready`'s, P1-int8 the mma.sync tile (csrc/tiles.cuh
    `score_tile_i8`)."""
    return _tma_ready(queries, vectors, 16)


def cpasync_i8_ready(queries: torch.Tensor, vectors: torch.Tensor) -> bool:
    """Whether K5 and K10 run the int8 mainloop fed by its cp.async
    producer on these contiguous int8 operands: TMA cannot read them
    (`wgmma_i8_ready` fails), yet cp.async can copy their rows in 8- or
    4-byte pieces (dim % 4 == 0 and 4-byte aligned bases, `cpasync_piece`:
    glove-100's 100-byte rows, glove-200's 200, dim 1020)."""
    return (not wgmma_i8_ready(queries, vectors)
            and cpasync_piece(queries, vectors) > 0)


def realign_i8_ready(queries: torch.Tensor, vectors: torch.Tensor) -> bool:
    """Whether K5 and K10 run the int8 mainloop fed by its realigning
    producer on these contiguous int8 operands: every pair the other two
    producers refuse (a width or a base off 4 bytes: glove-25's 25-byte
    rows, dim 1019, 1- and 2-byte aligned views). TMA stages each row's
    aligned span (rows j, j + 16, ... as one 2D tensor each, whose stride
    of 16 rows TMA takes at any width) and the producer warpgroup shifts
    the slices into place by any byte. With `wgmma_i8_ready` and
    `cpasync_i8_ready` it covers every pair, and neither K5 nor K10 ever
    dispatches to the mma.sync tile."""
    return (not wgmma_i8_ready(queries, vectors)
            and not cpasync_i8_ready(queries, vectors))


def _i8_producer(queries: torch.Tensor, vectors: torch.Tensor) -> str:
    """The suffix of K5's and K10's entry point and launch key for the
    producer their ready rules name: "_wgmma" (TMA), "_cpasync" or
    "_realign"."""
    return ("_wgmma" if wgmma_i8_ready(queries, vectors)
            else "_cpasync" if cpasync_i8_ready(queries, vectors)
            else "_realign")


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
    wgmma = wgmma_ready(q, vectors)
    cpasync = cpasync_ready(q, vectors)
    keys = _segmax_launch(q, vectors, mask, "pv_segmax_scan_wgmma" if wgmma
                          else "pv_segmax_scan_cpasync" if cpasync
                          else "pv_segmax_scan_realign")
    _count("segmax", num_q)
    LAUNCHES["segmax_wgmma"] += wgmma
    LAUNCHES["segmax_cpasync"] += cpasync
    LAUNCHES["segmax_realign"] += not (wgmma or cpasync)
    return keys


def _segmax_launch(q, vectors, mask, entry: str) -> torch.Tensor:
    """K1's launch on checked CUDA operands through `entry`, uncounted: the
    TMA mainloop (`pv_segmax_scan_wgmma`), the mainloop fed by cp.async
    (`pv_segmax_scan_cpasync`) or by its realigning producer
    (`pv_segmax_scan_realign`), or the wmma tile the last replaced
    (`pv_segmax_scan`, served by no dispatch)."""
    num_q, dim = q.shape
    cap = vectors.shape[0]
    keys = torch.empty((num_q, 2 * (cap // SEG)), dtype=torch.int32,
                       device=q.device)
    _launch(q, "segmax_scan", entry, q.data_ptr(), vectors.data_ptr(),
            mask.data_ptr(), keys.data_ptr(), num_q, cap, dim)
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
    kind = _i8_producer(q, v_i8)
    keys = _segmax_i8_launch(q, v_i8, vscale, mask,
                             "pv_segmax_scan_i8" + kind)
    _count("segmax_i8", num_q)
    _count("segmax_i8" + kind, num_q)
    return keys


def _segmax_i8_launch(q, v_i8, vscale, mask, entry: str) -> torch.Tensor:
    """K5's launch on checked CUDA operands through `entry`, uncounted:
    the int8 mainloop fed by TMA (`pv_segmax_scan_i8_wgmma`), by cp.async
    (`pv_segmax_scan_i8_cpasync`) or by its realigning producer
    (`pv_segmax_scan_i8_realign`), or the mma.sync tile they replaced
    (`pv_segmax_scan_i8`, served by no dispatch)."""
    num_q, dim = q.shape
    cap = v_i8.shape[0]
    keys = torch.empty((num_q, 2 * (cap // SEG)), dtype=torch.int32,
                       device=q.device)
    _launch(q, "segmax_scan_i8", entry, q.data_ptr(), v_i8.data_ptr(),
            vscale.data_ptr(), mask.data_ptr(), keys.data_ptr(), num_q, cap,
            dim)
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
    kind = _i8_producer(q, v_i8)
    keys = _segmax_i8c_launch(q, v_i8, mask, "pv_segmax_scan_i8c" + kind)
    _count("segmax_i8c", num_q)
    _count("segmax_i8c" + kind, num_q)
    return keys


def _segmax_i8c_launch(q, v_i8, mask, entry: str) -> torch.Tensor:
    """K10's launch on checked CUDA operands through `entry`, uncounted:
    the int8 mainloop fed by TMA, by cp.async or by its realigning
    producer (`pv_segmax_scan_i8c_wgmma` / `_cpasync` / `_realign`), or
    the mma.sync tile they replaced (`pv_segmax_scan_i8c`, served by no
    dispatch)."""
    num_q, dim = q.shape
    cap = v_i8.shape[0]
    keys = torch.empty((num_q, 2 * (cap // SEG)), dtype=torch.int32,
                       device=q.device)
    _launch(q, "segmax_scan_i8c", entry, q.data_ptr(), v_i8.data_ptr(),
            mask.data_ptr(), keys.data_ptr(), num_q, cap, dim)
    return keys


def segmax_scan_i8c_plain(q_i8, v_i8, mask):
    """Plain version of K10: the exact int32 sums packed as keys."""
    return _segment_top2(_int_dot(q_i8, v_i8, torch.int32), mask)


# ---------------------------------------------------------------------------
# K2 topk_packed_keys
# ---------------------------------------------------------------------------


# K2's split-row warp select (csrc/topk_keys.cu): one warp a chunk of a
# row, chunks of whole TOPK_KEYS_STEP keys (32 lanes x 4 keys x 4 loads in
# flight), sized so that a launch holds about TOPK_KEYS_WARPS warps (~8 an
# SM of 132) and a row is cut no finer than that needs: over phase 3's
# 15,872-key rows Q = 64 takes 16 chunks a row, Q = 256 four, Q = 2048 one
# (no merge). 1,024 measured best of 1,024 / 2,048 / 4,096 / 8,192 there,
# weighed by the route's launches (H100 80GB HBM3, 700 W; PERF.md).
TOPK_KEYS_STEP = 512
TOPK_KEYS_WARPS = 1024


def topk_keys_chunk(num_q: int, c: int) -> int:
    """Keys a warp of K2's select reads from its row: about
    TOPK_KEYS_WARPS / num_q chunks a row, rounded up to whole
    TOPK_KEYS_STEP keys. A row of more than one chunk has its chunks'
    lists merged by its last warp."""
    want = max(1, -(-TOPK_KEYS_WARPS // max(1, num_q)))
    chunk = -(-c // want)
    return -(-chunk // TOPK_KEYS_STEP) * TOPK_KEYS_STEP


def topk_packed_keys(keys: torch.Tensor, k_sel: int):
    """Per-row top-k_sel of a (Q, C) int32 key slab, descending.

    Returns (keys (Q, k_sel) int32, columns (Q, k_sel) int32). Equal keys
    leave one per round (multiplicity as in `torch.topk`); the kernel
    takes the larger column first. On a CUDA tensor: the split-row warp
    select (csrc/topk_keys.cu), one warp a chunk of `topk_keys_chunk`
    keys of a row, the chunks' lists merged by the row's last warp in the
    same launch (scratch and tickets only where a row has several)."""
    num_q, c = keys.shape
    _require(keys.dtype == torch.int32, "topk_packed_keys: keys must be int32")
    _require(0 < k_sel <= min(c, TOPK_KEYS_MAX),
             f"topk_packed_keys: k_sel {k_sel} outside 1..min({c}, {TOPK_KEYS_MAX})")
    if not keys.is_cuda:
        return topk_packed_keys_plain(keys, k_sel)
    keys = keys.contiguous()
    out_k, out_c = torch.empty((2, num_q, k_sel), dtype=torch.int32,
                               device=keys.device)
    chunk = topk_keys_chunk(num_q, c)
    chunks = -(-c // chunk)
    # where a row has several chunks: their lists, then the rows' tickets
    # (zeroed by the launcher)
    scratch = (torch.empty(num_q * chunks * k_sel + (num_q + 1) // 2,
                           dtype=torch.int64, device=keys.device)
               if chunks > 1 else None)
    _launch(keys, "topk_packed_keys", "pv_topk_packed_keys", keys.data_ptr(),
            out_k.data_ptr(), out_c.data_ptr(),
            None if scratch is None else scratch.data_ptr(), num_q, c, k_sel,
            chunk)
    _count("topk_keys", num_q, k_sel)
    return out_k, out_c


def topk_packed_keys_plain(keys, k_sel):
    """Plain version of K2 (`torch.topk`: the same keys; among equal keys
    its columns may leave in another order than the kernel's)."""
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
        if k > TOPK_WGMMA_K_MAX and (int4 or vscale is None):
            # K4's and K6's wide kinds: the rows in the kernel's ranges
            _, rows, ranges = wide_walk(num_q, cap)
            if ranges > 1:
                return scan_topk_ranges_plain(queries, vectors, vscale, mask,
                                              k, rows, int4=int4)
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
    # the ready rules are the only switch between kernels: the one-query
    # sweep, else its narrow kind, else the tensor-core scan, else the
    # wide kind, else the template (K3 asks its wide kind first:
    # `i8_wide_ready`); the tensor-core kinds' counters name the rows'
    # producer
    piece = _PIECE_KEY[rows_piece(vectors)]
    if i8c and sweep_ready(q, vectors, k):
        vals, idx = _sweep_launch(q, vectors, None, mask, k, name)
        LAUNCHES["scan_topk_i8c_sweep"] += 1
    elif i8c and i8c_narrow_ready(q, vectors, k):
        vals, idx = _sweep_launch(q, vectors, None, mask, k, name,
                                  "pv_sweep_topk_i8c_narrow")
        _count("scan_topk_i8c_narrow", num_q, k)
    elif i8c and i8c_wgmma_ready(q, vectors, k):
        vals, idx = _i8_wgmma_launch(q, vectors, None, mask, k, name)
        _count("scan_topk_i8c_wgmma" + piece, num_q, k)
    elif i8c and i8c_wide_ready(q, vectors, k):
        vals, idx = _i8_wide_launch(q, vectors, None, mask, k, name)
        _count("scan_topk_i8c_wide" + piece, num_q, k)
    elif kind == _KIND_I8 and i8_wide_ready(q, vectors, k):
        vals, idx = _i8_wide_launch(q, vectors, vscale, mask, k, name)
        _count("scan_topk_i8_wide" + piece, num_q, k)
    elif kind == _KIND_I8 and i8_sweep_ready(q, vectors, k):
        vals, idx = _sweep_launch(q, vectors, vscale, mask, k, name)
        LAUNCHES["scan_topk_i8_sweep"] += 1
    elif kind == _KIND_I8 and i8_narrow_ready(q, vectors, k):
        vals, idx = _sweep_launch(q, vectors, vscale, mask, k, name,
                                  "pv_sweep_topk_i8_narrow")
        _count("scan_topk_i8_narrow", num_q, k)
    elif kind == _KIND_I8 and i8_wgmma_ready(q, vectors, k):
        vals, idx = _i8_wgmma_launch(q, vectors, vscale, mask, k, name)
        _count("scan_topk_i8_wgmma" + piece, num_q, k)
    elif int4 and i4_sweep_ready(q, vectors, k):
        vals, idx = _sweep_launch(q, vectors, vscale, mask, k, name)
        LAUNCHES["scan_topk_i4_sweep"] += 1
    elif int4 and i4_narrow_ready(q, vectors, k):
        vals, idx = _sweep_launch(q, vectors, vscale, mask, k, name,
                                  "pv_sweep_topk_i4_narrow")
        _count("scan_topk_i4_narrow", num_q, k)
    elif int4 and i4_wgmma_ready(q, vectors, k):
        vals, idx = _i4_wgmma_launch(q, vectors, vscale, mask, k, name)
        _count("scan_topk_i4_wgmma" + piece, num_q, k)
    elif int4 and i4_wide_ready(q, vectors, k):
        vals, idx = _i4_wide_launch(q, vectors, vscale, mask, k, name)
        _count("scan_topk_i4_wide" + piece, num_q, k)
        if wide_walk(num_q, cap)[2] > 1:
            _count("scan_topk_i4_wide_ranges", num_q, k)
    elif kind in (_KIND_F32, _KIND_BF16) and topk_sweep_ready(q, vectors, k):
        vals, idx = _topk_sweep_launch(q, vectors, mask, k, name)
        _count("scan_topk_sweep", num_q, k)
    elif kind in (_KIND_F32, _KIND_BF16) and topk_narrow_ready(q, vectors, k):
        vals, idx = _topk_sweep_launch(q, vectors, mask, k, name,
                                       "pv_sweep_topk_f32_narrow")
        _count("scan_topk_narrow", num_q, k)
    elif kind in (_KIND_F32, _KIND_BF16) and topk_wgmma_ready(q, vectors, k):
        vals, idx = _topk_wgmma_launch(q, vectors, mask, k, name)
        _count("scan_topk_wgmma" + piece, num_q, k)
    elif kind in (_KIND_F32, _KIND_BF16) and topk_wide_ready(q, vectors, k):
        vals, idx = _topk_wide_launch(q, vectors, mask, k, name)
        _count("scan_topk_wide" + piece, num_q, k)
        if wide_walk(num_q, cap)[2] > 1:
            _count("scan_topk_wide_ranges", num_q, k)
    else:
        vals, idx = _template_launch(q, vectors, vscale, mask, k, kind, name)
    _count(name, num_q, k)
    return vals, idx


def _outputs(num_q: int, k: int, device):
    return (torch.empty((num_q, k), dtype=torch.float32, device=device),
            torch.empty((num_q, k), dtype=torch.int32, device=device))


def _template_launch(q, vectors, vscale, mask, k: int, kind: int,
                     name: str = "scan_topk"):
    """`pv_scan_topk` (csrc/scan_topk.cu) on checked CUDA operands,
    uncounted: the 16-query template (2 queries at k > 128) over chunks
    spread across every SM, then the merge. It serves only K3 past 64M
    rows at k > 384 (kind 2, `i8_wide_ready`) and K9 past 64M rows at k >
    128 (kind 4, `i8c_wide_ready`): every other kind has a Hopper kernel at
    every shape, and kinds 0, 1 and 3 (K4, K6) stay for chip_smoke.py's
    comparisons alone."""
    num_q, dim = q.shape
    cap = vectors.shape[0]
    q_tiles = -(-num_q // (16 if k <= 128 else 2))
    chunk = _scan_chunk(cap, q_tiles, num_q, k, q.device)
    nchunks = -(-cap // chunk)
    partial = torch.empty((num_q * nchunks * k,), dtype=torch.int64,
                          device=q.device)
    vals, idx = _outputs(num_q, k, q.device)
    _launch(q, name, "pv_scan_topk", kind, q.data_ptr(), vectors.data_ptr(),
            vscale.data_ptr() if vscale is not None else None,
            mask.data_ptr(), partial.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), num_q, cap, dim, k, chunk)
    return vals, idx


def _sweep_launch(q, vectors, vscale, mask, k: int, name: str,
                  entry: str | None = None):
    """The one-query sweep (csrc/sweep_topk.cu) on checked CUDA operands,
    uncounted: K9 (`vscale` None, column-scaled int8 rows; `entry`
    "pv_sweep_topk_i8c_narrow": its narrow kind, any width and base), K6
    (packed int4 rows, half the queries' width, with their scales; `entry`
    "pv_sweep_topk_i4_narrow": its narrow kind, any even width and base)
    or K3 (int8 rows with their scales; `entry` "pv_sweep_topk_i8_narrow":
    its narrow kind, any width and base), CTAs over `sweep_partition`'s
    ranges."""
    num_q, dim = q.shape
    cap = vectors.shape[0]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, nchunks = sweep_partition(cap, sms)
    partial = torch.empty((num_q * nchunks * k,), dtype=torch.int64,
                          device=q.device)
    vals, idx = _outputs(num_q, k, q.device)
    head = (q.data_ptr(), vectors.data_ptr())
    if vscale is None:
        entry = entry or "pv_sweep_topk_i8c"
    else:
        entry = entry or ("pv_sweep_topk_i8" if vectors.shape[1] == dim
                          else "pv_sweep_topk_i4")
        head = head + (vscale.data_ptr(),)
    _launch(q, name, entry, *head, mask.data_ptr(), partial.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), num_q, cap, dim, k, chunk)
    return vals, idx


def _topk_sweep_launch(q, vectors, mask, k: int, name: str = "scan_topk",
                       entry: str = "pv_sweep_topk_f32"):
    """K4's one-query sweep (csrc/sweep_topk.cu: `F32` over float32 rows,
    `Bf16F` over the bf16 mirror, both against the float32 queries) on
    checked CUDA operands, uncounted; `entry` "pv_sweep_topk_f32_narrow":
    its narrow kind, any width and base. CTAs over `sweep_partition`'s
    ranges, then the merge."""
    num_q, dim = q.shape
    cap = vectors.shape[0]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, nchunks = sweep_partition(cap, sms)
    partial = torch.empty((num_q * nchunks * k,), dtype=torch.int64,
                          device=q.device)
    vals, idx = _outputs(num_q, k, q.device)
    kind = _KIND_F32 if vectors.dtype == torch.float32 else _KIND_BF16
    _launch(q, name, entry, kind, q.data_ptr(), vectors.data_ptr(),
            mask.data_ptr(), partial.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), num_q, cap, dim, k, chunk)
    return vals, idx


def _i4_wgmma_launch(q, v_i4, vscale, mask, k: int,
                     name: str = "scan_topk_i4"):
    """K6's tensor-core scan (csrc/scan_i4_wgmma.cu) on checked CUDA
    operands, uncounted: the queries' columns permuted once, each half
    padded to whole stages (`permute_i4_queries`), the rows by the producer
    `rows_piece` names (TMA, or the expanders' reads), CTAs over
    `i4_wgmma_partition`'s (query tile, corpus range) pairs, then the
    merge."""
    num_q, dim = q.shape
    cap = v_i4.shape[0]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    _, ranges = i4_wgmma_partition(num_q, cap, sms)
    q_perm = permute_i4_queries(q)
    partial = torch.empty((num_q * ranges * k,), dtype=torch.int64,
                          device=q.device)
    vals, idx = _outputs(num_q, k, q.device)
    _launch(q, name, "pv_scan_topk_i4_wgmma", rows_piece(v_i4),
            q_perm.data_ptr(), v_i4.data_ptr(), vscale.data_ptr(),
            mask.data_ptr(),
            partial.data_ptr(), vals.data_ptr(), idx.data_ptr(), num_q, cap,
            dim, k)
    return vals, idx


def _i4_wide_launch(q, v_i4, vscale, mask, k: int,
                    name: str = "scan_topk_i4", range_rows=None):
    """K6's wide kind (csrc/topk_i4_wide.cu) on checked CUDA operands,
    uncounted: the queries' columns permuted once, each half padded to
    whole stages (`permute_i4_queries`), then `_scaled_wide_launch` with
    the rows by the producer `rows_piece` names, walked as `wide_walk`
    plans. `range_rows` is a measurement hook: only chip_smoke.py's
    `--wide-cross` sets it (ranges of that many rows); every other caller
    leaves it None and takes `topk_wide_plan`'s."""
    return _scaled_wide_launch("pv_scan_topk_i4_wide", permute_i4_queries(q),
                               q, v_i4, vscale, mask, k, name,
                               rows_piece(v_i4), pad_queries=False,
                               walk=wide_walk(q.shape[0], v_i4.shape[0],
                                              range_rows))


def _i8_wide_launch(q, v_i8, vscale, mask, k: int,
                    name: str = "scan_topk_i8"):
    """K3's wide kind (csrc/topk_i8_wide.cu) on checked CUDA operands,
    uncounted: `_scaled_wide_launch` of the int8 queries as they are, the
    rows by the producer `rows_piece` names, the scratch's tile followed by
    room for the queries, which the library call pads to whole 16 bytes
    where TMA cannot read them as they lie. `vscale` None: K9's
    (`pv_scan_topk_i8c_wide`, column-scaled rows, the int32 sums)."""
    entry = ("pv_scan_topk_i8c_wide" if vscale is None
             else "pv_scan_topk_i8_wide")
    return _scaled_wide_launch(entry, q, q, v_i8, vscale, mask, k, name,
                               rows_piece(v_i8))


def _scaled_wide_launch(entry: str, q_arg, q, vectors, vscale, mask, k: int,
                        name: str, piece: int, pad_queries: bool = True,
                        walk=None):
    """The int wide kinds' launch (K6's, K3's; K9's, `vscale` None, whose
    call takes no scales): one library call
    `entry` that, a tile of `topk_wide_tile` queries at a time, runs the
    tensor-core scan on the queries `q_arg` (the rows by the producer
    `piece`) writing the slab and the radix select over it, in one scratch
    buffer (`i4_wide_scratch`; K3's, `pad_queries`, then Q rows of the
    width rounded up to 16 bytes for the padded queries); a mask view not
    4-byte aligned is copied. `walk` (K6's: `wide_walk`'s (q_tile,
    range_rows, ranges)): the entry takes the rows in ranges of range_rows,
    the scratch `wide_walk_scratch`'s. K3's and K9's entries (walk None)
    take no range_rows argument yet: this branch and the second argument
    list go when they take the range walk (ROADMAP, "Configurations still
    on the template")."""
    num_q, dim = q.shape
    cap = vectors.shape[0]
    q_tile, range_rows, _ = walk or (topk_wide_tile(num_q, cap), 0, 1)
    nbytes = wide_walk_scratch(cap, q_tile, range_rows, k)
    head = (piece,)
    if pad_queries:
        nbytes = _up256(nbytes) + num_q * _pad_to(dim, 16)
    tail = (q_tile, nbytes) if walk is None else (q_tile, range_rows, nbytes)
    if mask.data_ptr() % 4:
        mask = mask.clone()
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=q.device)
    vals, idx = _outputs(num_q, k, q.device)
    scales = () if vscale is None else (vscale.data_ptr(),)
    _launch(q, name, entry, *head, q_arg.data_ptr(), vectors.data_ptr(),
            *scales, mask.data_ptr(), scratch.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), num_q, cap, dim, k, *tail)
    return vals, idx


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _planes_ld(vectors: torch.Tensor) -> int:
    """Elements of K4's query plane rows over these rows: the width rounded
    up to whole 16 bytes of the plane's type (float32 hi / lo: 4 elements,
    bf16 planes: 8), which TMA reads."""
    return _pad_to(vectors.shape[1],
                   4 if vectors.dtype == torch.float32 else 8)


def _topk_wgmma_launch(q, vectors, mask, k: int, name: str = "scan_topk"):
    """K4's tensor-core scan (csrc/scan_topk_wgmma.cu) on checked CUDA
    operands, uncounted: the float32 queries, zero-padded to `_planes_ld`
    columns (`_pad_cols`), split once into the planes the rows' kind multiplies
    (`split_tf32` / `split_bf16`), the rows by the producer `rows_piece`
    names, CTAs over `topk_wgmma_partition`'s (query tile, segment range)
    pairs at `topk_wgmma_qtile`, then the merge."""
    num_q, dim = q.shape
    cap = vectors.shape[0]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    _, ranges = topk_wgmma_partition(num_q, cap, sms,
                                     topk_wgmma_qtile(vectors, k))
    if vectors.dtype == torch.float32:
        kind, planes = _KIND_F32, torch.stack(split_tf32(_pad_cols(q, 4)))
    else:
        kind, planes = _KIND_BF16, torch.stack(split_bf16(_pad_cols(q, 8)))
    partial = torch.empty((num_q * ranges * k,), dtype=torch.int64,
                          device=q.device)
    vals, idx = _outputs(num_q, k, q.device)
    _launch(q, name, "pv_scan_topk_wgmma", rows_piece(vectors), kind,
            planes.data_ptr(), vectors.data_ptr(), mask.data_ptr(),
            partial.data_ptr(), vals.data_ptr(), idx.data_ptr(), num_q, cap,
            dim, k)
    return vals, idx


def _topk_wide_launch(q, vectors, mask, k: int, name: str = "scan_topk",
                      range_rows=None):
    """K4's wide kind (csrc/topk_wide.cu) on checked CUDA operands,
    uncounted: one library call splits the float32 queries into the
    planes the rows' kind multiplies (as `split_tf32` / `split_bf16`, rows
    of `_planes_ld` elements), then, a tile of queries at a time over the
    rows in ranges as `wide_walk` plans (`range_rows`, set only by
    chip_smoke.py's `--wide-cross`: ranges of that many rows; None
    everywhere else), runs the scan writing the slab (the rows by the
    producer `rows_piece` names) and the radix select over it, in one
    scratch buffer (`topk_wide_scratch`); a mask view not 4-byte aligned is
    copied. Past one range each range's best k are merged."""
    num_q, dim = q.shape
    cap = vectors.shape[0]
    kind = _KIND_F32 if vectors.dtype == torch.float32 else _KIND_BF16
    q_tile, rows, _ = wide_walk(num_q, cap, range_rows)
    nbytes = topk_wide_scratch(num_q, cap, _planes_ld(vectors), kind, q_tile,
                               rows, k)
    if mask.data_ptr() % 4:
        mask = mask.clone()
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=q.device)
    vals, idx = _outputs(num_q, k, q.device)
    _launch(q, name, "pv_scan_topk_wide", rows_piece(vectors), kind,
            q.data_ptr(), vectors.data_ptr(), mask.data_ptr(),
            scratch.data_ptr(), vals.data_ptr(), idx.data_ptr(), num_q, cap,
            dim, k, q_tile, rows, nbytes)
    return vals, idx


def _i8_wgmma_launch(q, v_i8, vscale, mask, k: int,
                     name: str = "scan_topk_i8"):
    """K3's tensor-core scan (csrc/scan_topk_wgmma.cu, the int8 kind) on
    checked CUDA operands, uncounted: the rows by the producer `rows_piece`
    names, one scratch buffer (room for the queries, which the library call
    pads to whole 16 bytes where TMA cannot read them as they lie, then the
    partials), CTAs over `i8_wgmma_partition`'s (query tile, segment range)
    pairs, then the merge. `vscale` None: K9's (`pv_scan_topk_i8c_wgmma`,
    the `Int8C` kind: column-scaled rows, the int32 sums, k <= 128)."""
    num_q, dim = q.shape
    cap = v_i8.shape[0]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    _, ranges = i8_wgmma_partition(num_q, cap, sms, k)
    scratch = torch.empty((_up256(num_q * _pad_to(dim, 16))
                           + num_q * ranges * k * 8,), dtype=torch.uint8,
                          device=q.device)
    vals, idx = _outputs(num_q, k, q.device)
    entry, scales = (("pv_scan_topk_i8c_wgmma", ()) if vscale is None else
                     ("pv_scan_topk_i8_wgmma", (vscale.data_ptr(),)))
    _launch(q, name, entry, rows_piece(v_i8), q.data_ptr(), v_i8.data_ptr(),
            *scales, mask.data_ptr(), scratch.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), num_q, cap, dim, k)
    return vals, idx


def _pad_cols(x: torch.Tensor, mult: int) -> torch.Tensor:
    """x's rows as (rows, ld), zeros past x's width, ld its width rounded
    up to a multiple of `mult` (x itself where it is one): K4's query rows
    of whole 16 bytes, and torch._int_mm's operands in chip_smoke.py."""
    dim = x.shape[1]
    ld = _pad_to(dim, mult)
    return x if ld == dim else torch.nn.functional.pad(x, (0, ld - dim))


def split_tf32(q: torch.Tensor):
    """float32 -> (hi, lo): hi = q with the low 13 mantissa bits cleared
    (exact in TF32), lo = q - hi (exact in float32). K4's and K8's 3xTF32
    product is hi.hi + hi.lo + lo.hi."""
    hi = (q.view(torch.int32) & -8192).view(torch.float32)
    return hi, q - hi


def split_bf16(q: torch.Tensor):
    """float32 -> three bf16 planes q1 = bf16(q), q2 = bf16(q - q1), q3 =
    bf16(q - q1 - q2), whose sum is q exactly for normal values (8 + 8 + 8
    bits of its 24-bit significand; each residual is exact in float32). K4
    multiplies bf16 rows by each plane, products exact in float32, so the
    score keeps the float32 query."""
    q1 = q.to(torch.bfloat16)
    r = q - q1.float()
    q2 = r.to(torch.bfloat16)
    return q1, q2, (r - q2.float()).to(torch.bfloat16)


# K4's tensor-core scan (csrc/scan_topk_wgmma.cu): a CTA holds 64 queries
# and walks a contiguous range of 128-row segments
TOPK_WGMMA_QTILE = 64
TOPK_WGMMA_K_MAX = 128
# K4's crossover with its template: from this many queries on the
# tensor-core scan beats it. chip_smoke.py times both at Q = 1 ... 256,
# k_sel 14 and 36, on phase 3's 1M x 1024 bf16 mirror and phase 7's 2M x
# 1024 float32 rows: on an H100 80GB HBM3 at 700 W the scan wins at every Q
# (1M bf16, Q = 1: 1.85 against 4.07 ms; 2M f32, Q = 1: 4.01 against
# 11.33). It stays at 1: the dispatch asks the one-query sweeps first
# (`topk_sweep_ready`, `topk_narrow_ready`, which `topk_wgmma_ready`
# excludes), so the scan takes the small batches only where neither sweep
# does (a query block or phase copies past their shared memory).
TOPK_WGMMA_Q_MIN = 1


def _float_rows(queries: torch.Tensor, vectors: torch.Tensor) -> bool:
    return (queries.dtype == torch.float32
            and vectors.dtype in (torch.float32, torch.bfloat16))


def topk_wgmma_ready(queries: torch.Tensor, vectors: torch.Tensor,
                     k: int) -> bool:
    """Whether K4 runs the tensor-core scan on these contiguous operands:
    float32 or bf16 rows (float32 queries) at any width and base (the rows
    by the producer `rows_piece` names; the query planes are the
    launcher's own), k <= 128, Q >= TOPK_WGMMA_Q_MIN, where neither
    one-query sweep takes them (`topk_sweep_ready`, `topk_narrow_ready`:
    Q past their limits, or a query block too large). Wider k takes
    `topk_wide_ready`'s kind."""
    return (_float_rows(queries, vectors)
            and k <= TOPK_WGMMA_K_MAX
            and queries.shape[0] >= TOPK_WGMMA_Q_MIN
            and not topk_sweep_ready(queries, vectors, k)
            and not topk_narrow_ready(queries, vectors, k))


def rows_piece(vectors: torch.Tensor) -> int:
    """The producer of K4's and K3's tensor-core mainloop
    (csrc/scan_topk_wgmma.cuh) for these contiguous rows: 0 TMA (the row
    bytes and the base multiples of 16), 8 or 4 cp.async in pieces of that
    many bytes (the row bytes and the base multiples of 8, else of 4), 2
    the realigning producer (any other rows: odd bf16 widths, int8 widths
    not a multiple of 4, bases aligned to 1 or 2 bytes)."""
    bits = vectors.shape[1] * vectors.element_size() | vectors.data_ptr()
    return (0 if bits % 16 == 0 else 8 if bits % 8 == 0
            else 4 if bits % 4 == 0 else 2)


# The LAUNCHES suffix of each producer's kinds (`rows_piece`)
_PIECE_KEY = {0: "", 8: "_cpasync", 4: "_cpasync", 2: "_realign"}


def topk_wgmma_qtile(vectors: torch.Tensor, k: int) -> int:
    """Queries a CTA of K4's tensor-core scan over these rows at k: 64, but
    32 for the realigning producer past k = 64, whose staging slots leave
    no room for 64 queries' buffers of 256 keys (csrc/scan_topk_wgmma.cu)."""
    return (32 if rows_piece(vectors) == 2 and k > 64
            else TOPK_WGMMA_QTILE)


def topk_wgmma_partition(num_q: int, cap: int, sms: int,
                         qtile: int = TOPK_WGMMA_QTILE):
    """The tensor-core scan's grid on a card of `sms` SMs: (q_tiles,
    ranges). CTA c takes query tile c % q_tiles (of `qtile` queries) and
    segment range c // q_tiles of `ranges` equal shares of the ceil(cap /
    128) segments (range r: segments [r S // ranges, (r + 1) S //
    ranges)), so the q_tiles CTAs of one range walk it together and read
    each segment from device memory about once. Mirrors the kernel's own
    computation."""
    q_tiles = -(-num_q // qtile)
    segs = max(1, -(-cap // SEG))
    return q_tiles, max(1, min(segs, sms // q_tiles))


# K4's wide kind (csrc/topk_wide.cu): the tensor-core scan (32 or 64
# queries a CTA) writes each live row's score key to a slab of q_tile x cap
# uint32,
# then a radix select a query reads it: three digit histograms of 2,048
# bins (+ a candidate count) a query, and at most TOPK_WIDE_CAP candidates
# a query sorted in one CTA's shared memory (the kernel's CAP)
TOPK_WIDE_CAP = 8192
TOPK_WIDE_HIST = 3 * 2048 + 4
TOPK_WIDE_SLAB_BYTES = 256 << 20  # the slab's budget, as _scan_chunk's
TOPK_WIDE_QTILE_MAX = 256  # queries a tile: bounds the candidates' 16 MiB


def topk_wide_ready(queries: torch.Tensor, vectors: torch.Tensor,
                    k: int) -> bool:
    """Whether K4 runs its wide kind on these contiguous operands: float32
    or bf16 rows (float32 queries) at any width and base (the rows by the
    producer `rows_piece` names), 128 < k <= SCAN_KSEL_MAX, at every cap:
    past a slab's budget the rows go in ranges (`topk_wide_plan`). The
    template (`pv_scan_topk` kinds 0 and 1) serves no K4 shape."""
    return (queries.dtype == torch.float32
            and vectors.dtype in (torch.float32, torch.bfloat16)
            and TOPK_WGMMA_K_MAX < k <= SCAN_KSEL_MAX)


def _up256(b: int) -> int:
    return -(-b // 256) * 256


def topk_wide_scratch(num_q: int, cap: int, dim: int, kind: int,
                      q_tile: int, range_rows: int = 0, k: int = 0) -> int:
    """Bytes of the wide kind's scratch, as csrc/topk_wide.cu lays it out:
    the query planes (float32 hi and lo, or three bf16), then the walk's
    (`wide_walk_scratch`: one tile's slab, histograms and candidates, and
    past one range of `range_rows` rows the tile's partial), each from a
    256-byte boundary."""
    per = 8 if kind == _KIND_F32 else 6  # plane bytes an element
    return (_up256(num_q * dim * per)
            + wide_walk_scratch(cap, q_tile, range_rows, k))


def i4_wide_scratch(cap: int, q_tile: int) -> int:
    """Bytes of one tile of a wide kind's select, as csrc/topk_i4_wide.cu
    (K6's wide kind, whose whole scratch it is) and csrc/topk_wide.cu lay
    it out: the slab (q_tile x cap rounded up to 128, uint32), histograms
    (q_tile x TOPK_WIDE_HIST uint32) and candidates (q_tile x TOPK_WIDE_CAP
    uint64), each from a 256-byte boundary."""
    return (_up256(q_tile * (-(-cap // SEG) * SEG) * 4)
            + _up256(q_tile * TOPK_WIDE_HIST * 4) + q_tile * TOPK_WIDE_CAP * 8)


def wide_range_count(cap: int, range_rows: int) -> int:
    """Ranges of `range_rows` rows over [0, cap): one where range_rows is
    0 or at least cap (csrc/radix_select.cuh `range_count`)."""
    return -(-cap // range_rows) if 0 < range_rows < cap else 1


def wide_ranges(cap: int, range_rows: int):
    """The rows [r0, r1) of each range the walk takes, in order: whole
    128-row segments from 0 (range_rows a multiple of SEG), the last cut at
    cap."""
    n = wide_range_count(cap, range_rows)
    if n == 1:
        return [(0, cap)]
    return [(r0, min(cap, r0 + range_rows))
            for r0 in range(0, n * range_rows, range_rows)]


def wide_walk_scratch(cap: int, q_tile: int, range_rows: int,
                      k: int) -> int:
    """Bytes of a wide kind's walk (csrc/radix_select.cuh `walk_bytes`):
    one tile of q_tile queries over a range's rows (`i4_wide_scratch`),
    then, past one range, the tile's partial of q_tile x ranges x k 64-bit
    keys from a 256-byte boundary."""
    ranges = wide_range_count(cap, range_rows)
    if ranges == 1:
        return i4_wide_scratch(cap, q_tile)
    return (_up256(i4_wide_scratch(range_rows, q_tile))
            + q_tile * ranges * k * 8)


# The range walk of K4's and K6's wide kinds (csrc/radix_select.cuh
# `walk_ranges`): where a tile of min(Q, TOPK_WGMMA_QTILE) queries' slab
# over the whole plane would pass TOPK_WIDE_SLAB_BYTES (past 64M rows at Q
# = 1, 4M at Q = 16, 1M at Q >= 64), the rows go in ranges of the most
# whole segments that keep that tile's slab within the budget, so each
# range is read once per query tile instead of the plane once per narrowed
# tile; each range's best k are merged. `chip_smoke.py --wide-cross` times
# the rule on planes made on the card (H100 80GB HBM3, 700 W; int4 x 384
# and float32 x 96 at 1,183,514 / 16M / 70M rows, Q 1-128, k_sel 204 /
# 526 / 1000; PERF.md §6): against the walk of one plane in its narrowed
# tiles the ranges win 2.8-3.0x at Q = 16 and 4.5-5.5x at Q = 64 over 16M
# rows (int4 Q = 64, k_sel 204: 9.12 against 45.22 ms) and 1.10-1.31x at Q
# = 64 over 1,183,514 rows, and tie at Q = 128 there (0.99-1.09x); ranges
# a quarter or a sixteenth as long (slabs of 64 / 16 MiB) lose at every Q
# <= 64, by 1.02-3.9x (70M int4, Q = 64, k_sel 204: 48.31 / 76.20 against
# 37.08 ms: a range's fixed cost outweighs a slab nearer the L2), and win
# by at most 7 % at Q = 128 (a 128-query tile), within the 10-14 % kernel
# times repeat. So the ranges fill the slab's budget.


def topk_wide_plan(num_q: int, cap: int):
    """(q_tile, range_rows) of K4's and K6's wide kinds over `cap` rows at
    Q: one range (range_rows the cap rounded up to whole segments) and
    `topk_wide_tile`'s tile where a tile of min(Q, TOPK_WGMMA_QTILE)
    queries' slab over the whole plane fits TOPK_WIDE_SLAB_BYTES (the walk
    of one plane, unchanged); else ranges of the most whole segments whose
    slab at that tile fits it, walked in `topk_wide_tile` query tiles over
    a range."""
    ld = max(SEG, -(-cap // SEG) * SEG)
    full = min(num_q, TOPK_WGMMA_QTILE)
    if full * 4 * ld <= TOPK_WIDE_SLAB_BYTES:
        return topk_wide_tile(num_q, cap), ld
    rows = max(SEG, TOPK_WIDE_SLAB_BYTES // (4 * full) // SEG * SEG)
    return topk_wide_tile(num_q, rows), rows


def wide_walk(num_q: int, cap: int, range_rows=None):
    """(q_tile, range_rows, ranges) of a wide kind's walk: `topk_wide_plan`'s,
    or ranges of `range_rows` rows where given. Only chip_smoke.py's
    `--wide-cross` gives it, to time ranges the plan would not choose; the
    dispatch always takes the plan's."""
    if range_rows is None:
        q_tile, rows = topk_wide_plan(num_q, cap)
    else:
        rows = range_rows
        q_tile = topk_wide_tile(num_q, min(max(cap, 1), rows))
    return q_tile, rows, wide_range_count(cap, rows)


def topk_wide_tile(num_q: int, cap: int) -> int:
    """Queries the wide kind serves at a time over `cap` rows: as many as
    keep the slab (q_tile x cap rounded up to 128, 4 bytes each) within
    TOPK_WIDE_SLAB_BYTES, at most TOPK_WIDE_QTILE_MAX, and whole 64-query
    tiles of the scan where a tile holds 64 or more and the batch does not
    fit one (Q = 64 over 1M rows: one tile, the corpus read once)."""
    per_q = 4 * (-(-cap // SEG) * SEG)
    t = min(num_q, TOPK_WIDE_QTILE_MAX, max(1, TOPK_WIDE_SLAB_BYTES // per_q))
    if TOPK_WGMMA_QTILE <= t < num_q:
        t -= t % TOPK_WGMMA_QTILE
    return t


# The one-query sweep of K9 and K7 (csrc/sweep_topk.cu): its shapes and
# K9's row ranges (K7's shares: ops/ivf.py::ivf_sweep_partition)
SWEEP_Q_MAX = 16  # query tile sized to Q: 1, 2, 4, 8 or 16
SWEEP_K_MAX = 128
SWEEP_QBLOCK_BYTES = 65536  # the CTA's query block in shared memory
SWEEP_DIM_MAX = SWEEP_QBLOCK_BYTES // SWEEP_Q_MAX  # K9: int8 at Q = 16
SWEEP_CTAS_PER_SM = 2


def sweep_tile(num_q: int) -> int:
    """The sweep's query tile for `num_q` queries: 1, 2, 4, 8 or 16, the
    smallest >= num_q."""
    return min(SWEEP_Q_MAX, 1 << max(0, num_q - 1).bit_length())


# K9's sweep limits (csrc/sweep_topk.cu `Int8C`): up to I8C_SWEEP_Q_MAX
# queries the 16-byte sweep beats K9's tensor-core scan over the same rows,
# up to I8C_NARROW_Q_MAX its narrow kind over rows the 16-byte sweep
# cannot read; K7 keeps SWEEP_Q_MAX. `python3 chip_smoke.py --k9-cross`
# times them at k_sel 16 on planes made on the card (H100 80GB HBM3,
# 700 W; PERF.md). The 16-byte sweep at Q = 1 / 2 / 4 / 5 / 8 / 16 against
# the scan: 1M x 1024 0.452 / 0.459 / 0.496 / 0.656 / 0.722 / 1.142 ms
# against 0.476 / 0.502 / 0.506 / 0.519 / 0.480 / 0.482; 4M x 1024 1.392
# / 1.441 / 1.519 / 2.307 / 2.454 / 4.190 against 1.597 / 1.619 / 1.674 /
# 1.718 / 1.570 / 1.569: it wins up to Q = 4 on both (its 8-query tile
# serves Q = 5 at Q = 8's cost). The narrow kind over 1,183,514 rows:
# dim 100 0.168 / 0.197 / 0.240 / 0.351 / 0.376 / 1.135 against 0.246 /
# 0.265 / 0.257 / 0.266 / 0.298 / 0.308, dim 25 0.115 / 0.158 / 0.188 /
# 0.248 / 0.271 / 0.707 against 0.272 / 0.283 / 0.273 / 0.285 / 0.291 /
# 0.306: it wins up to Q = 4 at dim 100 and up to Q = 8 at dim 25 (by
# 7-13 % at Q = 5-8, which the limit gives away); at dim 1019 (16 phase
# copies) it fits only Q <= 4, and wins there 2.2x / 2.1x / 1.6x (0.567 /
# 0.603 / 0.793 against 1.247 / 1.246 / 1.248). A second run repeated
# every verdict, its times within 0-14 % of these.
I8C_SWEEP_Q_MAX = 4
I8C_NARROW_Q_MAX = 4
I8C_WGMMA_K_MAX = 128  # K9's tensor-core scan; its wide kind past it


def sweep_ready(q_i8: torch.Tensor, v_i8: torch.Tensor, k: int) -> bool:
    """Whether K9 runs its one-query sweep on these contiguous operands:
    Q <= I8C_SWEEP_Q_MAX, k <= 128, rows of 16-byte words (dim % 16 == 0,
    dim <= 4096) and 16-byte aligned bases. Other widths and bases take
    `i8c_narrow_ready`'s narrow kind, larger batches and widths the
    tensor-core scan (`i8c_wgmma_ready`), k past 128 the wide kind
    (`i8c_wide_ready`)."""
    num_q, dim = q_i8.shape
    return (num_q <= I8C_SWEEP_Q_MAX and k <= SWEEP_K_MAX and dim % 16 == 0
            and dim <= SWEEP_DIM_MAX and q_i8.data_ptr() % 16 == 0
            and v_i8.data_ptr() % 16 == 0)


def i8c_narrow_ready(q_i8: torch.Tensor, v_i8: torch.Tensor, k: int) -> bool:
    """Whether K9 runs the one-query sweep's narrow kind (csrc/
    sweep_topk.cu `sweep_narrow_kernel<Int8C>`, K7's instantiation over
    flat ranges) on these contiguous operands: Q <= I8C_NARROW_Q_MAX, k <=
    128, operands the 16-byte sweep cannot read (`_i8_tma_ready` fails: a
    width not a multiple of 16, or a base not 16-byte aligned: glove-100's
    100 bytes, glove-25's 25), and the phase copies with the buffers within
    NARROW_SMEM_BYTES (`narrow_fits`). The rest takes `i8c_wgmma_ready`'s
    scan."""
    return (q_i8.shape[0] <= I8C_NARROW_Q_MAX and k <= SWEEP_K_MAX
            and not _i8_tma_ready(q_i8, v_i8)
            and narrow_fits(q_i8, v_i8, k))


def i8c_wgmma_ready(q_i8: torch.Tensor, v_i8: torch.Tensor, k: int) -> bool:
    """Whether K9 runs its tensor-core scan (csrc/scan_topk_wgmma.cu,
    `pv_scan_topk_i8c_wgmma`: K3's scan at `Int8C`) on these contiguous
    operands: k <= I8C_WGMMA_K_MAX where neither sweep takes them (Q past
    their limits, a query block or phase copies past their shared memory,
    widths past 4096), at any width and base: the rows by the producer
    `rows_piece` names, the queries padded to whole 16 bytes by the library
    call where TMA cannot read them as they lie."""
    return (k <= I8C_WGMMA_K_MAX and not sweep_ready(q_i8, v_i8, k)
            and not i8c_narrow_ready(q_i8, v_i8, k))


def i8c_wide_ready(q_i8: torch.Tensor, v_i8: torch.Tensor, k: int) -> bool:
    """Whether K9 runs its wide kind (csrc/topk_i8_wide.cu,
    `pv_scan_topk_i8c_wide`: the scan at `Int8C` writing a slab of the
    sign-flipped int32 sums, then the radix select) on these contiguous
    operands: I8C_WGMMA_K_MAX < k <= SCAN_KSEL_MAX at any width and base,
    any Q, and one query's slab (cap rounded up to 128 rows, 4 bytes a row)
    within TOPK_WIDE_SLAB_BYTES. Only a slab over the budget (past 64M
    rows) keeps the template, `pv_scan_topk` kind 4."""
    ld = -(-v_i8.shape[0] // SEG) * SEG
    return (I8C_WGMMA_K_MAX < k <= SCAN_KSEL_MAX
            and 4 * ld <= TOPK_WIDE_SLAB_BYTES)


def sweep_partition(cap: int, sms: int):
    """The sweep's row ranges on a card of `sms` SMs: (chunk, n), CTA c
    reading rows [c * chunk, min(cap, (c + 1) * chunk)). chunk is a
    multiple of 128, n <= SWEEP_CTAS_PER_SM * sms CTAs (at least one: a
    range may be empty or ragged at the end)."""
    segs = max(1, -(-cap // SEG))
    chunk = -(-segs // min(SWEEP_CTAS_PER_SM * sms, segs)) * SEG
    return chunk, max(1, -(-cap // chunk))


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


# K6's sweep limit: up to this many queries the sweep's int4 kind beats
# the tensor-core scan over the same rows. chip_smoke.py phase 5 times
# both at Q = 1 ... 64 over 16M rows: on an H100 80GB HBM3 at 700 W the
# sweep takes 3.26 / 4.59 / 5.88 / 11.08 ms at Q = 1 / 2 / 4 / 8, the
# scan 5.9-6.6 ms at every Q <= 64. Over 131,072 rows (phase 2) the sweep
# still wins at Q = 8 (0.196 against 0.243 ms): the limit follows the
# large store, where the difference is milliseconds, not tens of us.
I4_SWEEP_Q_MAX = 4


def i4_sweep_ready(q_i8: torch.Tensor, v_i4: torch.Tensor, k: int) -> bool:
    """Whether K6 runs the one-query sweep's int4 kind on these contiguous
    operands: Q <= I4_SWEEP_Q_MAX, k <= 128, packed rows of whole 16-byte
    words (dim % 32 == 0: 32 elements a word), the query block
    (sweep_tile(Q) x dim bytes) within SWEEP_QBLOCK_BYTES, 16-byte aligned
    bases. Other widths and bases take `i4_narrow_ready`'s narrow kind,
    larger batches and query blocks the tensor-core scan."""
    num_q, dim = q_i8.shape
    return (num_q <= I4_SWEEP_Q_MAX and k <= SWEEP_K_MAX
            and _i4_tma_ready(q_i8, v_i4)
            and sweep_tile(num_q) * dim <= SWEEP_QBLOCK_BYTES)


# K6's narrow sweep limits (csrc/sweep_topk.cu `sweep_narrow_kernel
# <Int4>`): up to I4_NARROW_Q_MAX queries its narrow kind beats the
# tensor-core scan over packed rows of at most 16 words (its packed
# layout: dim / 2 <= 240 + g bytes), up to I4_NARROW_WIDE_Q_MAX over longer
# rows (its row-group layout). chip_smoke.py phase 5b times both at k_sel
# 14 over planes of 131,072 and 1,183,514 rows (H100 80GB HBM3, 700 W;
# PERF.md): at dim 100 the sweep wins at every Q <= 16 (1,183,514 rows,
# Q = 1 / 4 / 8 / 16: 0.169 / 0.229 / 0.319 / 0.510 ms against the scan's
# 0.525 / 0.542 / 0.549 / 0.574); at dim 300 up to Q = 8 (0.752 against
# 0.926) and not at Q = 16 (1.342 against 0.948); at dim 784 (25 words)
# up to Q = 4 over 1,183,514 rows (0.748 against 0.887) and not at Q = 5
# (1.133 against 0.890), though over 131,072 rows it still wins at Q = 8;
# at dim 1022 at Q = 4 by 2.3x. The limits follow the larger store.
I4_NARROW_Q_MAX = 8
I4_NARROW_WIDE_Q_MAX = 4


def i4_narrow_words(dim: int, ptr: int) -> int:
    """Words W of a phase copy for packed rows of dim / 2 bytes at base
    `ptr`: ceil((16 - g + dim / 2) / 16), g = 16 / `narrow_phases`."""
    rb = dim // 2
    return -(-(16 - 16 // narrow_phases(rb, ptr) + rb) // 16)


def i4_narrow_bytes(num_q: int, dim: int, ptr: int) -> int:
    """The int4 narrow kind's shared memory over packed rows of dim / 2
    bytes at base `ptr`: the query block of `narrow_phases` copies of both
    halves of sweep_tile(Q) queries, `i4_narrow_words` each (2 x P x QT x
    W x 16 bytes), then QT buffers of 256 keys, tau, counts and query sums
    (csrc/sweep_topk.cu `Narrow::smem`)."""
    phases = narrow_phases(dim // 2, ptr)
    qt = sweep_tile(num_q)
    return (2 * phases * qt * i4_narrow_words(dim, ptr) * 16
            + qt * (256 * 8 + 16))


def _i4_tma_ready(q_i8: torch.Tensor, v_i4: torch.Tensor) -> bool:
    """What the 16-byte sweep and TMA read: packed rows of whole 16 bytes
    (dim % 32 == 0) and 16-byte aligned bases of both."""
    return q_i8.shape[1] % 32 == 0 and _aligned(q_i8, v_i4)


def i4_narrow_ready(q_i8: torch.Tensor, v_i4: torch.Tensor, k: int) -> bool:
    """Whether K6 runs the one-query sweep's narrow int4 kind (csrc/
    sweep_topk.cu `sweep_narrow_kernel<Int4>`) on these contiguous
    operands: k <= 128, operands the 16-byte sweep cannot read
    (`_i4_tma_ready` fails: dim % 32 != 0, or a base off 16 bytes; the
    query is read a byte at a time, the rows as the aligned words that
    hold them), Q up to I4_NARROW_Q_MAX over rows of at most 16 words
    (`i4_narrow_words`), else up to I4_NARROW_WIDE_Q_MAX, and the phase
    copies of both halves with the buffers within NARROW_SMEM_BYTES
    (`i4_narrow_bytes`: every even width up to 1,602 at Q = 4 with 16
    copies, odd row bytes or a 1-byte aligned base; wider at fewer phases
    or queries). The rest takes `i4_wgmma_ready`'s scan."""
    num_q, dim = q_i8.shape
    ptr = v_i4.data_ptr()
    top = (I4_NARROW_Q_MAX if i4_narrow_words(dim, ptr) <= 16
           else I4_NARROW_WIDE_Q_MAX)
    return (num_q <= top and k <= SWEEP_K_MAX
            and not _i4_tma_ready(q_i8, v_i4)
            and i4_narrow_bytes(num_q, dim, ptr) <= NARROW_SMEM_BYTES)


# K3's sweep limit on k: 384, its second buffer size, for the int8 store's
# host-rescore band of k + 128 + 4. The tensor-core scan's int8 kind takes
# the same k (its buffers of 512 keys at a 32-query tile).
I8_SWEEP_K_MAX = 384
I8_WGMMA_K_MAX = 384
# K3's wide kind (csrc/topk_i8_wide.cu: the tensor-core scan's int8 kind
# writing a slab, then the radix select) serves k_sel past this where its
# query tile over the plane holds the batch's tensor-core tile
# (`i8_wide_covers`), and every k_sel past I8_SWEEP_K_MAX; the sweep and the
# tensor-core scan the rest. chip_smoke.py phase 4 times them on int8 planes
# x 1024 at k_sel 142 / 384 (H100 80GB HBM3, 700 W). Over its 1M-row store
# (a tile of 64) the wide kind takes 0.43 / 0.52 / 0.77 / 1.47 ms at Q = 1
# / 17 / 64 / 128, k_sel 142, against the sweep's 0.56 at Q = 1 and the
# scan's 0.91 / 1.24 / 1.71 (1.23-3.30 at k_sel 256-384). Over 2M rows
# (tile 32): Q = 17 1.05 against the scan's 1.46, Q = 64 2.33 against
# 1.87, Q = 128 4.54 against 2.89. Over 4M (tile 16): Q = 17 3.44 against
# 2.12, Q = 128 14.76 against 4.58 (at k_sel 384 the rule gives away three
# shapes: 2M, Q = 64 2.38 against the scan's 3.52; 2M, Q = 128 and 4M, Q
# = 17 by 4-5 %). Over 16M (tile
# 4): Q = 1 6.10 against the sweep's 5.90 (k_sel 384: 6.04 against 6.36),
# Q = 4 6.49 against 6.74, Q = 17 / 64 / 128 30.8 / 99.1 / 197.5 against
# the scan's 6.5 / 8.8 / 15.0. Below this bound the sweep's and the scan's
# first instantiations serve (phase 4's k_sel 14 at Q = 1, phase 14's at
# Q = 16).
I8_WIDE_K_MIN = 128
# K3's sweep limit on Q: up to this many queries the one-query sweep beats
# the tensor-core scan's int8 kind over the same rows; past it the scan
# takes every batch. chip_smoke.py phase 4 times both at Q = 1 ... 64,
# k_sel 14 and 142, on its 1M-row int8 plane: on an H100 80GB HBM3 at
# 700 W the sweep takes 0.42 / 0.43 / 0.50 / 0.78 ms at Q = 1 / 2 / 4 / 8
# (k_sel 14; 0.56 / 0.58 / 0.69 / 1.02 at k_sel 142), the scan 0.53-0.56
# (k_sel 14; 0.99-1.01 at k_sel 142) at every Q <= 32; the sweep's
# 8-query tile serves Q = 5 ... 8 at its Q = 8 time. The narrow kind
# (`i8_narrow_ready`) keeps the limit: chip_smoke.py --narrow-cross times
# it against the scan over the same int8 rows of 131,072 and 1,183,514
# rows (H100 80GB HBM3, 700 W; k_sel 14; PERF.md): at dim
# 100 the sweep wins at Q <= 4 (1,183,514 rows: 0.166 / 0.217 ms at Q = 1
# / 4 against 0.273 / 0.250) and loses past it (Q = 5 / 8: 0.304 / 0.357
# against 0.250 / 0.260; over 131,072 rows a tie at Q = 5, 0.116 against
# 0.117); at dim 25 it still wins at Q = 5 / 8 by 1-17 % (0.225 / 0.239
# against 0.270 / 0.273), at Q = 16 it loses at both sizes.
I8_SWEEP_Q_MAX = 4


def i8_sweep_ready(q_i8: torch.Tensor, v_i8: torch.Tensor, k: int) -> bool:
    """Whether K3's one-query sweep's row-scaled int8 kind can take these
    contiguous operands: Q <= I8_SWEEP_Q_MAX, k <= I8_SWEEP_K_MAX, rows of
    whole 16-byte words (dim % 16 == 0), the query block (sweep_tile(Q) x
    dim bytes) within SWEEP_QBLOCK_BYTES, 16-byte aligned bases. The
    dispatch asks `i8_wide_ready` first; larger batches take
    `i8_wgmma_ready`'s scan; other widths and bases `i8_narrow_ready`'s
    narrow kind."""
    num_q, dim = q_i8.shape
    return (num_q <= I8_SWEEP_Q_MAX and k <= I8_SWEEP_K_MAX
            and dim % 16 == 0
            and sweep_tile(num_q) * dim <= SWEEP_QBLOCK_BYTES
            and _aligned(q_i8, v_i8))


def i8_wgmma_ready(q_i8: torch.Tensor, v_i8: torch.Tensor, k: int) -> bool:
    """Whether K3's tensor-core scan's row-scaled int8 kind
    (csrc/scan_topk_wgmma.cu) takes these contiguous operands: k <=
    I8_WGMMA_K_MAX where neither one-query sweep does (`i8_sweep_ready`,
    `i8_narrow_ready`: Q past I8_SWEEP_Q_MAX, or a query block too large
    for the sweep), at any width and base: the rows by the producer
    `rows_piece` names, the queries padded to whole 16 bytes by the
    library call where TMA cannot read them as they lie. The dispatch asks
    `i8_wide_ready` first."""
    return (k <= I8_WGMMA_K_MAX and not i8_sweep_ready(q_i8, v_i8, k)
            and not i8_narrow_ready(q_i8, v_i8, k))


# The tensor-core scan's query tile past k 128 (`i8_wgmma_partition`):
# its buffers of 512 keys a query leave room for 32 queries a CTA
I8_WGMMA_WIDE_QTILE = 32


def i8_wide_covers(num_q: int, cap: int, piece: int = 0) -> bool:
    """Whether K3's wide kind's query tile over `cap` rows
    (`topk_wide_tile`) lets it serve a batch of Q at k_sel 129-384. Over
    rows TMA reads (`piece` 0) the tile must hold min(Q, 64) queries, the
    batch's tensor-core tile: the wide kind then reads the plane less
    often than the 32-query scan, or once, as the sweep does. Over a larger
    plane its slab budget cuts the tile (Q = 64 over 16M rows: 4 queries,
    the plane read 16 times, 11x the scan's time), and the sweep or the
    scan serves k_sel up to their limit (the times at I8_WIDE_K_MIN).

    Over rows TMA cannot read (`piece` > 0) it serves wherever it reads
    the plane no more often than the scan's I8_WGMMA_WIDE_QTILE-query
    tiles do (ceil(Q / tile) <= ceil(Q / 32)): the scan there is bound by
    its 128-row segments, not the rows' bytes (a narrow row costs a whole
    128-byte k-stage), so an equal number of reads costs the wide kind
    less. chip_smoke.py --narrow-cross times both over int8 planes at dims
    25 / 100 / 1019 (H100 80GB HBM3, 700 W; PERF.md): over 1,183,514 rows
    (a tile of 56) the wide kind wins Q = 16 / 32 / 64 / 128 at k_sel 142
    at every width (Q = 64: 0.781 / 0.744 / 2.556 ms against the scan's
    1.136 / 1.192 / 2.968); over 2,367,028 rows (a tile of 28) it wins Q =
    16, and at Q = 32 (two reads against one) it loses at dim 1019 (4.460
    against 2.980) and wins by 7-17 % at dims 25 / 100, which this rule
    gives away; at Q = 64 / 128 the scan wins at k_sel 142."""
    tile = topk_wide_tile(num_q, cap)
    if piece:
        return -(-num_q // tile) <= -(-num_q // I8_WGMMA_WIDE_QTILE)
    return tile >= min(num_q, TOPK_WGMMA_QTILE)


def i8_wide_ready(q_i8: torch.Tensor, v_i8: torch.Tensor, k: int) -> bool:
    """Whether K3 runs its wide kind (csrc/topk_i8_wide.cu) on these
    contiguous operands, asked before the sweeps and the scan: any width
    and base (the rows by the producer `rows_piece` names, the queries
    padded by the library call where TMA cannot read them), one query's
    slab (cap rounded up to 128 rows, 4 bytes a row) within
    TOPK_WIDE_SLAB_BYTES, and k past I8_SWEEP_K_MAX (up to SCAN_KSEL_MAX:
    only the template takes those otherwise) or past I8_WIDE_K_MIN where
    `i8_wide_covers` holds. Any Q: a batch smaller than a query tile runs
    one tile. Other shapes take the sweeps or the scan; a slab over the
    budget (past 64M rows) and k past I8_SWEEP_K_MAX keep the template,
    `pv_scan_topk` kind 2."""
    num_q = q_i8.shape[0]
    cap = v_i8.shape[0]
    ld = -(-cap // SEG) * SEG
    return (I8_WIDE_K_MIN < k <= SCAN_KSEL_MAX
            and 4 * ld <= TOPK_WIDE_SLAB_BYTES
            and (k > I8_SWEEP_K_MAX
                 or i8_wide_covers(num_q, cap, rows_piece(v_i8))))


# The narrow kind's shared memory (csrc/sweep_topk.cu NARROW_SMEM_BYTES):
# its query block of phase copies, the buffers, tau and counts within 112
# KB keep two CTAs an SM
NARROW_SMEM_BYTES = 112 << 10


def narrow_phases(dim: int, ptr: int) -> int:
    """The narrow kind's phase copies of a query for int8 rows of `dim`
    bytes at base `ptr`: 16 / g, g the largest power of two <= 16 dividing
    both (a row starts at byte j g of its 16-byte word)."""
    g = 16
    while g > 1 and (dim | ptr) % g:
        g //= 2
    return 16 // g


def narrow_block_bytes(num_q: int, dim: int, ptr: int) -> int:
    """The narrow kind's query block: sweep_tile(Q) queries x
    `narrow_phases` copies x W words of 16 bytes, W = ceil((16 - g + dim)
    / 16) (the widest phase's)."""
    phases = narrow_phases(dim, ptr)
    words = -(-(16 - 16 // phases + dim) // 16)
    return sweep_tile(num_q) * phases * words * 16


def i8_narrow_ready(q_i8: torch.Tensor, v_i8: torch.Tensor, k: int) -> bool:
    """Whether K3 runs the one-query sweep's narrow kind (csrc/
    sweep_topk.cu `sweep_narrow_kernel`) on these contiguous operands: Q
    <= I8_SWEEP_Q_MAX (the crossover it shares with the 16-byte sweep,
    measured for it too: see the constant), k <= I8_SWEEP_K_MAX, operands
    the 16-byte sweep cannot read (`_i8_tma_ready` fails: a width not a
    multiple of 16, or a base not 16-byte aligned; the query is read a
    byte at a time, the rows as the aligned words that hold them), and the
    query block
    (`narrow_block_bytes`) with the buffers within NARROW_SMEM_BYTES:
    every width up to 1,505 at Q = 4 and k <= 384 (odd widths and 1-byte
    aligned bases: 16 copies; 1,633 at k <= 128), wider at fewer phases or
    queries. The rest takes `i8_wgmma_ready`'s scan."""
    return (q_i8.shape[0] <= I8_SWEEP_Q_MAX and k <= I8_SWEEP_K_MAX
            and not _i8_tma_ready(q_i8, v_i8)
            and narrow_fits(q_i8, v_i8, k))


def narrow_fits(q_i8: torch.Tensor, v_i8: torch.Tensor, k: int) -> bool:
    """Whether the narrow kind's shared memory takes these operands: the
    query block (`narrow_block_bytes`) and sweep_tile(Q) buffers of 256
    keys (512 past k 128), tau and counts within NARROW_SMEM_BYTES (the
    kernel refuses the rest)."""
    num_q, dim = q_i8.shape
    buf = 256 if k <= TOPK_WGMMA_K_MAX else 512
    return (num_q <= SWEEP_Q_MAX
            and narrow_block_bytes(num_q, dim, v_i8.data_ptr())
            + sweep_tile(num_q) * (buf * 8 + 12) <= NARROW_SMEM_BYTES)


# K4's sweep limits (csrc/sweep_topk.cu `F32` / `Bf16F` over float32 rows
# and the bf16 mirror, float32 queries): up to TOPK_SWEEP_Q_MAX queries the
# 16-byte sweep beats the tensor-core scan over the same rows, up to
# TOPK_NARROW_Q_MAX its narrow kind over rows the 16-byte sweep cannot
# read. `python3 chip_smoke.py --k4-cross` times both on planes made on
# the card (H100 80GB HBM3, 700 W; PERF.md), ~10 % of the rows masked.
# The 16-byte sweep at Q = 1 / 4 / 8 / 16, k_sel 14, against the scan:
# float32 x 1024, 131,072 rows 0.220 / 0.274 / 0.315 / 0.454 ms against
# 0.525 / 0.448 / 0.436 / 0.425, 2M rows 2.54 / 2.48 / 3.14 / 4.71 against
# 4.27 / 3.99 / 4.24 / 4.55; bf16 x 1024, 131,072 rows 0.141 / 0.173 /
# 0.287 / 0.464 against 0.305 / 0.286 / 0.380 / 0.388, 1M rows 0.749 /
# 0.802 / 1.287 / 2.401 against 1.986 / 1.058 / 1.194 / 1.465; float32 x
# 100 over 1,183,514 rows 0.290 / 0.561 / 0.963 against 0.536 / 0.578 /
# 0.545 (k_sel 36 and 128 alike). It wins at Q <= 4 on every plane and
# loses at Q = 16 on all but one; at Q = 5 ... 8 (its 8-query tile) it
# wins over float32 rows of 1024 (by 25-35 %) and loses over the 1M bf16
# mirror (by 7-15 %) and float32 rows of 100 (1.8x): the limit follows the
# larger stores. The narrow kind at Q = 1 / 2 / 4 / 8 against the scan
# over 131,072 rows at dims 1020 / 1019 and 1,183,514 at 100 / 25:
# float32 x 1019 0.267 / 0.281 / 0.337 against 0.609 / 0.595 / 0.667 (Q 8:
# its phase copies do not fit), bf16 x 1019 0.193 / 0.220 against 0.492 /
# 0.484 (Q 4 does not fit), bf16 x 1020 0.188 / 0.219 / 0.250 / 0.361
# against 0.393 / 0.426 / 0.346 / 0.364, bf16 x 100 0.362 / 0.421 / 0.511
# / 0.761 against 0.439 / 0.549 / 0.498 / 0.498, float32 x 25 0.233 /
# 0.253 / 0.286 / 0.395 against 0.405 / 0.431 / 0.426 / 0.431, bf16 x 25
# 0.171 / 0.190 / 0.240 / 0.321 against 0.457 / 0.518 / 0.501 / 0.492: it
# wins up to Q = 4 but at bf16 x 100 (3 % slower at Q = 4), and at Q = 8
# loses over bf16 x 100 (1.5x), which the limit follows.
TOPK_SWEEP_Q_MAX = 4
TOPK_NARROW_Q_MAX = 4


def _topk_tma_ready(queries: torch.Tensor, vectors: torch.Tensor) -> bool:
    """What K4's 16-byte sweep reads: rows of whole 16 bytes (dim % 4 ==
    0 for float32 rows, % 8 for bf16) and 16-byte aligned bases of both."""
    per = 4 if vectors.dtype == torch.float32 else 8
    return queries.shape[1] % per == 0 and _aligned(queries, vectors)


def topk_sweep_ready(queries: torch.Tensor, vectors: torch.Tensor,
                     k: int) -> bool:
    """Whether K4 runs the one-query sweep (csrc/sweep_topk.cu `F32` /
    `Bf16F`) on these contiguous operands: float32 or bf16 rows against
    float32 queries, Q <= TOPK_SWEEP_Q_MAX, k <= 128, rows of whole 16
    bytes at 16-byte aligned bases (`_topk_tma_ready`), and the query block
    (sweep_tile(Q) x dim float32) within SWEEP_QBLOCK_BYTES (dim 4096 at
    a tile of 4). Other widths and bases take `topk_narrow_ready`'s narrow
    kind, larger batches and query blocks the tensor-core scan."""
    num_q, dim = queries.shape
    return (_float_rows(queries, vectors) and num_q <= TOPK_SWEEP_Q_MAX
            and k <= SWEEP_K_MAX and _topk_tma_ready(queries, vectors)
            and sweep_tile(num_q) * dim * 4 <= SWEEP_QBLOCK_BYTES)


def topk_narrow_bytes(num_q: int, dim: int, es: int, ptr: int) -> int:
    """K4's narrow kind's shared memory over rows of dim elements of `es`
    bytes at base `ptr` (csrc/sweep_topk.cu `Narrow::smem`): the query
    block of `narrow_phases` copies of sweep_tile(Q) float32 queries, W =
    ceil((16 - g + row bytes) / 16) words each, twice over bf16 rows
    (`Bf16F`: a row word meets two query words), then QT buffers of 256
    keys, tau and counts (and, as K6's two halves, a sum a query)."""
    rb = dim * es
    phases = narrow_phases(rb, ptr)
    words = -(-(16 - 16 // phases + rb) // 16)
    qw = 2 if es == 2 else 1
    qt = sweep_tile(num_q)
    return (qw * phases * qt * words * 16
            + qt * (256 * 8 + 12 + (4 if qw == 2 else 0)))


def topk_narrow_ready(queries: torch.Tensor, vectors: torch.Tensor,
                      k: int) -> bool:
    """Whether K4 runs the one-query sweep's narrow kind (csrc/
    sweep_topk.cu `sweep_narrow_kernel<F32 | Bf16F>`) on these contiguous
    operands: float32 or bf16 rows against float32 queries, operands the
    16-byte sweep cannot read (`_topk_tma_ready` fails: a width off whole
    16 bytes, or a base off 16 bytes; the query is copied into phase copies
    from any base, the rows read as the aligned words that hold them), Q
    <= TOPK_NARROW_Q_MAX, k <= 128, and the phase copies with the buffers
    within NARROW_SMEM_BYTES (`topk_narrow_bytes`: bf16 rows at dim 1019,
    eight copies of 33 KB a query, take Q <= 2). The rest takes
    `topk_wgmma_ready`'s scan."""
    num_q, dim = queries.shape
    return (_float_rows(queries, vectors) and num_q <= TOPK_NARROW_Q_MAX
            and k <= SWEEP_K_MAX and not _topk_tma_ready(queries, vectors)
            and topk_narrow_bytes(num_q, dim, vectors.element_size(),
                                  vectors.data_ptr()) <= NARROW_SMEM_BYTES)


def _i8_tma_ready(q_i8: torch.Tensor, v_i8: torch.Tensor) -> bool:
    """What the 16-byte sweep reads: int8 rows of whole 16 bytes (dim % 16
    == 0) and 16-byte aligned bases of both."""
    return q_i8.shape[1] % 16 == 0 and _aligned(q_i8, v_i8)


def i8_wgmma_partition(num_q: int, cap: int, sms: int, k: int):
    """The int8 scan's grid: `topk_wgmma_partition` at its query tile, 64
    queries a CTA, and 32 past k = 128, where each query's buffer takes
    512 keys (csrc/scan_topk_wgmma.cu)."""
    qtile = (TOPK_WGMMA_QTILE if k <= TOPK_WGMMA_K_MAX
             else I8_WGMMA_WIDE_QTILE)
    return topk_wgmma_partition(num_q, cap, sms, qtile)


# K6's tensor-core scan (csrc/scan_i4_wgmma.cu): a CTA holds 64 queries and
# walks a contiguous range of 256-row corpus tiles
I4_WGMMA_BM = 64
I4_WGMMA_BN = 256
I4_WGMMA_K_MAX = 128
I4_STAGE_BYTES = 64  # a k-stage: 64 packed bytes of a row, 128 expanded


def i4_wgmma_ready(q_i8: torch.Tensor, v_i4: torch.Tensor, k: int) -> bool:
    """Whether K6 runs the tensor-core scan on these contiguous operands:
    k <= 128 where neither sweep takes them (`i4_sweep_ready`,
    `i4_narrow_ready`: Q past their limits, or a query block too large), at
    any even width and base: a packed row takes ceil(dim / 2 / 64) k-stages
    against the permuted queries, each half padded to whole stages
    (`permute_i4_queries`); the rows by the producer `rows_piece` names
    (TMA where the row bytes and the base are multiples of 16, else the
    expanders read them from device memory)."""
    return (k <= I4_WGMMA_K_MAX and not i4_sweep_ready(q_i8, v_i4, k)
            and not i4_narrow_ready(q_i8, v_i4, k))


def i4_wide_ready(q_i8: torch.Tensor, v_i4: torch.Tensor, k: int) -> bool:
    """Whether K6 runs its wide kind (csrc/topk_i4_wide.cu: the tensor-core
    scan writing a slab, then the radix select) on these contiguous
    operands: 128 < k <= SCAN_KSEL_MAX at any even width and base (the
    scan's producers) and any cap: past a slab's budget the rows go in
    ranges (`topk_wide_plan`). Any Q: a batch under 64 queries runs one
    query tile. The template (`pv_scan_topk` kind 3) serves no K6
    shape."""
    return I4_WGMMA_K_MAX < k <= SCAN_KSEL_MAX


def i4_wgmma_partition(num_q: int, cap: int, sms: int):
    """The tensor-core scan's grid on a card of `sms` SMs: (q_tiles,
    ranges). CTA c takes query tile c % q_tiles and corpus range c //
    q_tiles of `ranges` equal shares of the ceil(cap / 256) tiles, so the
    q_tiles CTAs of one range walk it together and read each packed tile
    from device memory about once. Mirrors the kernel's own computation."""
    q_tiles = -(-num_q // I4_WGMMA_BM)
    tiles = max(1, -(-cap // I4_WGMMA_BN))
    return q_tiles, max(1, min(tiles, sms // q_tiles))


def permute_i4_queries(q_i8: torch.Tensor) -> torch.Tensor:
    """The int8 queries with their columns reordered for the tensor-core
    scan, (Q, 128 S), S = ceil(dim / 2 / 64) k-stages: stage j (128 bytes)
    is q[:, 64 j:64 j + 64] then q[:, dim/2 + 64 j:dim/2 + 64 j + 64], the
    elements that the low and the high nibbles of packed bytes [64 j, 64 j
    + 64) hold. Each half is padded with zeros to 64 S columns on its own,
    so the last stage's bytes past a row's dim / 2 (TMA's zero fill, or a
    neighbour row's bytes) meet zero columns in both planes; padding the
    row's end instead would pair high-plane columns with low nibbles."""
    num_q, dim = q_i8.shape
    half = dim // 2
    stages = -(-half // I4_STAGE_BYTES)
    halves = q_i8.reshape(num_q, 2, half)
    if stages * I4_STAGE_BYTES != half:
        halves = torch.nn.functional.pad(
            halves, (0, stages * I4_STAGE_BYTES - half))
    return (halves.reshape(num_q, 2, stages, I4_STAGE_BYTES).transpose(1, 2)
            .reshape(num_q, 2 * stages * I4_STAGE_BYTES).contiguous())


def scan_topk_plain(queries, vectors, vscale, mask, k: int,
                    chunk: int = _PLAIN_CHUNK, int4: bool = False):
    """Plain version of K3/K4/K6: per-chunk partial top-k, then a merge.

    Integer products (int8, and int4's two nibble planes minus the
    8 * sum(q) bias) are summed exactly, in float32 while |sum| < 2^24 and
    in float64 beyond, so they equal the kernels' int32 sums before the
    row scale. The row-scaled kinds (int8, int4) select on the kernels'
    64-bit (score, row) keys: ties go to the lower row, so K3's and K6's
    kernels equal it bit for bit whatever their row partition."""
    num_q = queries.shape[0]
    cap = vectors.shape[0]
    if vscale is not None:
        scores = _i4_scores if int4 else _i8_scores
        cand = []
        for s in range(0, cap, chunk):
            e = min(cap, s + chunk)
            rows = torch.arange(s, e, device=queries.device)
            keys = _sel_keys(scores(queries, vectors[s:e], vscale[s:e]), rows)
            keys = torch.where(mask[s:e][None, :], keys, _I64_MIN)
            cand.append(torch.topk(keys, min(k, e - s), dim=1).values)
        return _merge_sel_keys(cand, k, int_scores=False)
    qf = queries.float()
    cand_v, cand_i = [], []
    for s in range(0, cap, chunk):
        e = min(cap, s + chunk)
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


def scan_topk_ranges_plain(queries, vectors, vscale, mask, k: int,
                           range_rows: int, int4: bool = False):
    """Plain version of K4's and K6's range walk (csrc/radix_select.cuh
    `walk_ranges`): `scan_topk_plain` over each range of
    `wide_ranges(cap, range_rows)`, its best k as (score, row) keys with
    the range's first row added, then the kernels' merge
    (`_merge_sel_keys`). A row of the whole plane's best k is among its
    range's best k, and the keys order (score, row) across ranges as within
    one, so it equals the whole plane's plain version (ties to the lower
    row)."""
    cap = vectors.shape[0]
    bounds = wide_ranges(cap, range_rows)
    if len(bounds) == 1:
        return scan_topk_plain(queries, vectors, vscale, mask, k, int4=int4)
    cand = []
    for r0, r1 in bounds:
        vals, idx = scan_topk_plain(
            queries, vectors[r0:r1], None if vscale is None else vscale[r0:r1],
            mask[r0:r1], k, int4=int4)
        keys = _sel_keys(vals, idx.to(torch.int64) + r0)
        cand.append(torch.where(torch.isneginf(vals), _I64_MIN, keys))
    return _merge_sel_keys(cand, k, int_scores=False)


def _sel_keys(sc, rows):
    """(score, row) selection keys as int64: higher score first, then the
    lower row, exactly the kernels' 64-bit key order (int scores ranked
    as integers, float scores by their sortable bits). `rows` (cols,) for
    every query, or each key's own (Q, cols)."""
    hi = sc if sc.dtype == torch.int64 else _to_sortable(
        sc.contiguous().view(torch.int32)).to(torch.int64)
    return (hi << 32) | (0xFFFFFFFF - rows).expand(sc.shape)


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
