"""Selection kernels of the exact scan, their plain versions, and the
routes built from them.

Counterpart of picovdb_tpu/ops/pallas_scan.py for the float32 main path.
Four hand-written CUDA kernels (`csrc/`) take the place of the four Pallas
kernels the path runs:

  K1 `segmax_scan`      csrc/segmax.cu     per-128-row-segment top-2 keys
  K2 `topk_packed_keys` csrc/topk_keys.cu  per-query top-k_sel of the keys
  K3 `fused_topk_i8`    csrc/scan_topk.cu  exact top-k over the int8 mirror
  K4 `fused_topk`       csrc/scan_topk.cu  exact top-k over f32 / bf16 rows

Each wrapper checks its inputs, allocates the outputs, and for a CUDA
tensor launches its kernel on the current stream (raising on a launch
error) and adds one to `LAUNCHES[name]`. For a CPU tensor it runs the
kernel's plain PyTorch version beside it, which follows the kernel's
decomposition (per-segment top-2 on packed keys for K1, chunked partial
top-k plus merge for K3/K4) so the CPU tests exercise the key packing,
decode and merge logic the kernels rely on. There is no fallback from a
CUDA tensor to a plain version.

The `make_*` factories compose the kernels into the serving routes
(normalize -> select -> exact float32 rescore -> crowding mark), as the
JAX package's factories do; they return plain closures.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from . import _build
from .exact import exact_topk, normalize_on_device

# The TPU kernels carry a finite masked-score sentinel (SCORE_SENTINEL)
# that every exit turns into -inf; these kernels write -inf directly.
KEY_MIN = -(2**31)  # packed-key sentinel, below every real key
SEG = 128  # rows per segmax segment

# Kernel launches made through the wrappers, by kernel. Comparing a kernel
# with its plain version does not go through a wrapper's counted path.
LAUNCHES = {"segmax": 0, "topk_keys": 0, "scan_topk": 0, "scan_topk_i8": 0}
# Requests whose k_sel exceeded SCAN_KSEL_MAX and went to the plain exact
# scan instead of K3/K4 (the JAX package's `k > bn` fallback).
WIDE_K_FALLBACKS = {"scan_topk": 0, "scan_topk_i8": 0}

TOPK_KEYS_MAX = 32  # K2's k_sel bound (segmax k + guard <= 22)
SCAN_KSEL_MAX = 1024  # K3/K4's k_sel bound
_PLAIN_CHUNK = 4096  # corpus rows per partial top-k in the plain K3/K4


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


def rescore_exact(queries, vectors, vals, idxs):
    """Replace selection scores with exact float32 dot products.

    Gathers the k winning rows per query, recomputes q . v in float32,
    keeps -inf padding markers, and re-sorts by the exact scores."""
    gathered = vectors[idxs.long()].float()  # (Q, k, dim)
    exact = torch.einsum("qd,qkd->qk", queries.float(), gathered)
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


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---------------------------------------------------------------------------
# K1 segmax_scan
# ---------------------------------------------------------------------------


def segmax_scan(queries: torch.Tensor, vectors: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Per-128-row-segment top-2 packed keys of the masked corpus.

    queries (Q, dim) bf16, vectors (cap, dim) bf16 with cap % 128 == 0,
    mask (cap,) bool -> keys (Q, 2 * cap / 128) int32 with column
    2 * seg + r. A key is the sortable float32 bits of q . v (bf16 inputs,
    float32 sums) with its low 7 bits replaced by the row's lane; masked
    rows carry KEY_MIN. Row of a key in column c: (c // 2) * 128 +
    (key & 127)."""
    num_q, dim = queries.shape
    cap = vectors.shape[0]
    _require(vectors.ndim == 2 and vectors.shape[1] == dim,
             f"segmax_scan: vectors {tuple(vectors.shape)} vs dim {dim}")
    _require(cap % SEG == 0, f"segmax_scan: cap {cap} is not a multiple of {SEG}")
    _require(mask.shape == (cap,) and mask.dtype == torch.bool,
             "segmax_scan: mask must be (cap,) bool")
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
    err = _build.library().pv_segmax_scan(
        q.data_ptr(), vectors.data_ptr(), mask.data_ptr(), keys.data_ptr(),
        num_q, cap, dim, _stream(q))
    _build.check(err, "segmax_scan")
    LAUNCHES["segmax"] += 1
    return keys


def segmax_scan_plain(queries, vectors, mask):
    """Plain version of K1: the same keys from a dense score matrix."""
    num_q = queries.shape[0]
    cap = vectors.shape[0]
    nseg = cap // SEG
    scores = queries.to(vectors.dtype).float() @ vectors.float().T
    keys = _to_sortable(scores.view(torch.int32)).reshape(num_q, nseg, SEG)
    lane = torch.arange(SEG, dtype=torch.int32, device=keys.device)
    keys = (keys & ~(SEG - 1)) | lane
    # mask AFTER packing, or a masked lane's sentinel would get its lane
    # bits ORed back into a live-looking key
    keys = torch.where(mask.reshape(1, nseg, SEG), keys, KEY_MIN)
    m1 = keys.amax(dim=2)
    m2 = torch.where(keys == m1[:, :, None], KEY_MIN, keys).amax(dim=2)
    return torch.stack([m1, m2], dim=2).reshape(num_q, 2 * nseg)


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
    err = _build.library().pv_topk_packed_keys(
        keys.data_ptr(), out_k.data_ptr(), out_c.data_ptr(), num_q, c, k_sel,
        _stream(keys))
    _build.check(err, "topk_packed_keys")
    LAUNCHES["topk_keys"] += 1
    return out_k, out_c


def topk_packed_keys_plain(keys, k_sel):
    """Plain version of K2."""
    tk, ti = torch.topk(keys, k_sel, dim=1)
    return tk, ti.to(torch.int32)


# ---------------------------------------------------------------------------
# K3 fused_topk_i8 / K4 fused_topk
# ---------------------------------------------------------------------------


def _scan_chunk(cap: int, q_tiles: int, num_q: int, k: int,
                device: torch.device) -> int:
    """Corpus rows per block: enough blocks to fill every SM a few times
    over, within a bounded partial-result buffer (<= 256 MiB)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    want = max(1, -(-4 * sms // q_tiles))
    want = min(want, max(1, (256 << 20) // (8 * num_q * k)), -(-cap // SEG))
    chunk = -(-cap // want)
    return -(-chunk // SEG) * SEG


def _scan_topk(queries, vectors, vscale, mask, k: int, name: str):
    num_q, dim = queries.shape
    cap = vectors.shape[0]
    _require(vectors.ndim == 2 and vectors.shape[1] == dim,
             f"{name}: vectors {tuple(vectors.shape)} vs dim {dim}")
    _require(mask.shape == (cap,) and mask.dtype == torch.bool,
             f"{name}: mask must be (cap,) bool")
    _require(0 < k <= SCAN_KSEL_MAX, f"{name}: k {k} outside 1..{SCAN_KSEL_MAX}")
    if not queries.is_cuda:
        return scan_topk_plain(queries, vectors, vscale, mask, k)
    if vscale is None:
        kind = {torch.float32: 0, torch.bfloat16: 1}.get(vectors.dtype)
        _require(kind is not None and queries.dtype == torch.float32,
                 f"{name}: takes float32 queries over float32/bf16 vectors")
    else:
        kind = 2
        _require(vectors.dtype == torch.int8 and queries.dtype == torch.int8
                 and vscale.dtype == torch.float32 and vscale.shape == (cap,),
                 f"{name}: takes int8 queries, int8 vectors, (cap,) f32 scales")
        _require(vscale.is_cuda and vscale.is_contiguous(),
                 f"{name}: vscale must be a contiguous CUDA tensor")
    _require(vectors.is_cuda and mask.is_cuda, f"{name}: mixed devices")
    _require(vectors.is_contiguous() and mask.is_contiguous(),
             f"{name}: vectors and mask must be contiguous")
    q = queries.contiguous()
    q_tiles = -(-num_q // (16 if k <= 128 else 2))
    chunk = _scan_chunk(cap, q_tiles, num_q, k, q.device)
    nchunks = -(-cap // chunk)
    partial = torch.empty((num_q * nchunks * k,), dtype=torch.int64,
                          device=q.device)
    vals = torch.empty((num_q, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((num_q, k), dtype=torch.int32, device=q.device)
    err = _build.library().pv_scan_topk(
        kind, q.data_ptr(), vectors.data_ptr(),
        vscale.data_ptr() if vscale is not None else None,
        mask.data_ptr(), partial.data_ptr(), vals.data_ptr(), idx.data_ptr(),
        num_q, cap, dim, k, chunk, _stream(q))
    _build.check(err, name)
    LAUNCHES[name] += 1
    return vals, idx


def scan_topk_plain(queries, vectors, vscale, mask, k: int,
                    chunk: int = _PLAIN_CHUNK):
    """Plain version of K3/K4: per-chunk partial top-k, then a merge.

    int8 products are summed in float32 while they stay exact integers
    (|sum| < 2^24, i.e. dim <= 1040) and in float64 beyond, so they equal
    the kernel's int32 sums before the row scale."""
    num_q = queries.shape[0]
    cap, dim = vectors.shape
    acc = (torch.float64 if vscale is not None and 127 * 127 * dim >= 2**24
           else torch.float32)
    qf = queries.to(acc)
    cand_v, cand_i = [], []
    for s in range(0, cap, chunk):
        e = min(cap, s + chunk)
        sc = qf @ vectors[s:e].to(acc).T
        sc = sc.float()
        if vscale is not None:
            sc = sc * vscale[s:e]
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
        sc = (q_i8.float() @ v_i8.float().T) * vscale[None, :]
        sc = sc.masked_fill(~mask[None, :], float("-inf"))
        vals, idx = torch.topk(sc, min(k, v_i8.shape[0]), dim=1)
        return vals, idx.to(torch.int32)
    return _scan_topk(q_i8, v_i8, vscale, mask, k, "scan_topk_i8")


# ---------------------------------------------------------------------------
# Routes
# ---------------------------------------------------------------------------


def segmax_topk(queries, scan_vectors, rescore_vectors, mask, k: int,
                guard: int = 6, normalize: bool = True,
                tie_scale: Optional[float] = None):
    """Batch route: segmax candidates (K1) -> top-k_sel of the keys (K2) ->
    exact float32 rescore -> crowding mark.

    queries (Q, dim) f32, scan_vectors (cap, dim) bf16 mirror,
    rescore_vectors (cap, dim) f32, mask (cap,) bool -> ((Q, k) exact
    scores, (Q, k) int32 rows). The rescore uses the float32 queries."""
    if tie_scale is None:
        tie_scale = _tie_scale_env()
    if normalize:
        queries = normalize_on_device(queries)
    keys = segmax_scan(queries.to(scan_vectors.dtype), scan_vectors, mask)
    k_sel = min(k + guard, keys.shape[1])
    tk, ti = topk_packed_keys(keys, k_sel)
    gidx = (ti // 2) * SEG + (tk & (SEG - 1))
    empty = tk == KEY_MIN
    gidx = torch.where(empty, 0, gidx)
    gathered = rescore_vectors[gidx.long()].float()
    exact = torch.einsum("qd,qkd->qk", queries, gathered)
    exact = torch.where(empty, float("-inf"), exact)
    order = torch.argsort(-exact, dim=1, stable=True)
    vals_full = exact.gather(1, order)
    vals = _mark_crowded(vals_full[:, :k], vals_full, k,
                         _tie_margin("bf16", queries.shape[1], tie_scale))
    return vals, gidx.gather(1, order)[:, :k].to(torch.int32)


def make_segmax_topk(k: int, guard: int = 6, normalize: bool = True,
                     tie_scale: Optional[float] = None):
    """fn(queries, scan_vectors, rescore_vectors, mask) -> (vals, idx)."""
    return lambda q, sv, rv, m: segmax_topk(q, sv, rv, m, k, guard,
                                            normalize, tie_scale)


def make_fused_topk_i8(k: int, guard: int = 4, normalize: bool = True,
                       tie_scale: Optional[float] = None):
    """Small-batch route: exact selection over the int8 mirror (K3) +
    exact float32 rescore + crowding mark.

    fn(queries f32, v_i8, vscale, rescore_vectors f32, mask) -> (vals, idx)
    """
    if tie_scale is None:
        tie_scale = _tie_scale_env()

    def fn(queries, v_i8, vscale, rescore_vectors, mask):
        if normalize:
            queries = normalize_on_device(queries)
        q_i8, _ = quantize_rows_i8(queries)
        vals, idx = fused_topk_i8(q_i8, v_i8, vscale, mask, k + max(0, guard))
        vals, idx = rescore_exact(queries, rescore_vectors, vals, idx)
        out = _mark_crowded(vals[:, :k], vals, k,
                            _tie_margin("i8", queries.shape[1], tie_scale))
        return out, idx[:, :k]

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
    "bfloat16" the selection reads bf16 copies of the queries and rows."""
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
