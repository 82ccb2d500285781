"""Exact masked cosine top-k with plain tensor ops (`matmul` + `topk`).

Counterpart of picovdb_tpu/ops/exact.py: `scores = Q @ V.T`, inactive or
filtered-out rows masked to -inf, top-k on the device. This is the plain
route (`xla_topk`), the `scan_mode="approx"` route (`xla_approx`) and the
fallback for k past the hand-written kernels' reach; it materializes the
(Q, cap) score matrix, so callers keep it for small batches and wide k.

Float32 products here run in full float32: the module turns TF32 off for
CUDA matmuls (`torch.backends.cuda.matmul.allow_tf32 = False`), because the
exact rescore and this scan are the precision reference of every route.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = float("-inf")

# Full-f32 products for the rescore and the exact scan (TF32 keeps ~3
# decimal digits, far looser than the 1e-5 score contract).
torch.backends.cuda.matmul.allow_tf32 = False


def default_device() -> torch.device:
    """The device a store or index lives on when the caller names none: the
    card, cuda:0. Without a usable CUDA device this raises instead of
    quietly serving from the host; run on the CPU by passing
    device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run on the "
            "host")
    return torch.device("cuda:0")


def normalize_on_device(q: torch.Tensor) -> torch.Tensor:
    """Zero-safe L2 normalization (zero rows -> e0), in float32.

    Counterpart of picovdb_tpu.ops.exact.normalize_on_device and of the
    host-side utils.normalize_batch. Idempotent for normalized inputs.
    """
    q = q.float()
    norms = torch.sqrt((q * q).sum(dim=1, keepdim=True))
    zero = norms == 0.0
    if bool(zero.any()):
        q = q.clone()
        rows = zero[:, 0]
        q[rows, 0] = 1.0
        norms = torch.where(zero, torch.ones_like(norms), norms)
    return q / norms


def _dtype(name: Optional[str]) -> Optional[torch.dtype]:
    if not name or name == "float32":
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unsupported compute_dtype {name!r}")


def exact_topk(queries: torch.Tensor, vectors: torch.Tensor,
               mask: torch.Tensor, k: int,
               compute_dtype: Optional[str] = None):
    """Masked exact top-k.

    Args:
      queries: (Q, dim) normalized query batch.
      vectors: (cap, dim) corpus (padded rows are masked off).
      mask: (cap,) bool — active AND filter mask.
      k: number of results per query (k <= cap).
      compute_dtype: optional "bfloat16" for the product inputs; the
        accumulation stays float32.

    Returns (values (Q, k) float32, indices (Q, k) int32); padding entries
    (fewer than k candidates) carry -inf scores.
    """
    cd = _dtype(compute_dtype)
    q, v = queries.float(), vectors.float()
    if cd is not None:
        q, v = q.to(cd).float(), v.to(cd).float()
    scores = q @ v.T
    scores = scores.masked_fill(~mask[None, :], NEG_INF)
    values, indices = torch.topk(scores, k, dim=1)
    return values, indices.to(torch.int32)


def make_exact_topk(k: int, compute_dtype_name: Optional[str] = None,
                    normalize: bool = True):
    """fn(queries, vectors, mask) -> (vals, idx): `exact_topk` with the
    queries normalized first (the counterpart of the JAX factory)."""

    def fn(queries, vectors, mask):
        if normalize:
            queries = normalize_on_device(queries)
        return exact_topk(queries, vectors, mask, k, compute_dtype_name)

    return fn


def approx_topk_rescored(queries, vectors, mask, k: int, k_sel: int,
                         compute_dtype: Optional[str] = None):
    """Masked top-k of `scan_mode="approx"`.

    Counterpart of picovdb_tpu.ops.exact.approx_topk_rescored. Its
    `lax.approx_max_k` exists only on the TPU (off it, JAX takes the exact
    top-k), so the candidates here are the exact top-k_sel: what the JAX
    package computes on the CPU. With float32 products that top-k is
    already exact and comes back as it is; with bfloat16 products its
    k_sel candidates are rescored in float32 and cut to k. Materializes
    the (Q, cap) score matrix, so callers chunk Q."""
    cap = vectors.shape[0]
    if _dtype(compute_dtype) is None:
        return exact_topk(queries, vectors, mask, min(k, cap))
    from .scan import rescore_exact

    vals, idx = exact_topk(queries, vectors, mask, min(k_sel, cap),
                           compute_dtype)
    vals, idx = rescore_exact(queries, vectors, vals, idx)
    return vals[:, :k], idx[:, :k]


def make_approx_topk(k: int, compute_dtype_name: Optional[str] = None,
                     normalize: bool = True):
    """fn(queries, vectors, mask) -> (vals, idx): `approx_topk_rescored`
    with k_sel = max(2k, k + 16), as the JAX factory chooses it."""
    k_sel = max(2 * k, k + 16)

    def fn(queries, vectors, mask):
        if normalize:
            queries = normalize_on_device(queries)
        return approx_topk_rescored(queries, vectors, mask, k, k_sel,
                                    compute_dtype_name)

    return fn


def _quantized_topk(scores, rescore_fn, mask, k: int, guard: int):
    """Masked top-(k + guard) of dense selection scores, rescored by
    `rescore_fn(vals, idx)` and cut to k."""
    scores = scores.masked_fill(~mask[None, :], NEG_INF)
    k_sel = min(k + guard, scores.shape[1])
    vals, idx = torch.topk(scores, k_sel, dim=1)
    vals, idx = rescore_fn(vals, idx.to(torch.int32))
    return vals[:, :k], idx[:, :k]


def exact_topk_i8r(queries, v_i8, vscale, mask, k: int, guard: int = 4):
    """Masked top-k over a per-ROW-quantized int8 STORAGE corpus.

    Selection: the int8 query against the int8 rows (exact integer sums)
    times the row scale; ranking: the dequantizing rescore of the
    k + guard winners, so scores carry the storage quantization. The
    plain route (CPU, wide k) of `storage_dtype="int8"`; it builds the
    dense (Q, cap) score matrix."""
    from .scan import _i8_scores, quantize_rows_i8, rescore_exact_i8r

    q_i8, _ = quantize_rows_i8(queries)
    return _quantized_topk(
        _i8_scores(q_i8, v_i8, vscale),
        lambda v, i: rescore_exact_i8r(queries, v_i8, vscale, v, i),
        mask, k, guard)


def exact_topk_i4r(queries, v_i4, vscale, mask, k: int, guard: int = 4):
    """`exact_topk_i8r` for a packed int4 STORAGE corpus (two nibble
    planes, see ops/scan.py): the selection scores equal the unpacked
    int8 dot product times the row scale; ranking is the dequantizing
    int4 rescore."""
    from .scan import _i4_scores, quantize_rows_i8, rescore_exact_i4r

    q_i8, _ = quantize_rows_i8(queries)
    return _quantized_topk(
        _i4_scores(q_i8, v_i4, vscale),
        lambda v, i: rescore_exact_i4r(queries, v_i4, vscale, v, i),
        mask, k, guard)


def make_exact_topk_i8r(k: int, normalize: bool = True):
    """fn(queries, v_i8, vscale, mask) -> (vals, idx)."""

    def fn(queries, v_i8, vscale, mask):
        if normalize:
            queries = normalize_on_device(queries)
        return exact_topk_i8r(queries, v_i8, vscale, mask, k)

    return fn


def make_exact_topk_i4r(k: int, normalize: bool = True):
    """fn(queries, v_i4, vscale, mask) -> (vals, idx)."""

    def fn(queries, v_i4, vscale, mask):
        if normalize:
            queries = normalize_on_device(queries)
        return exact_topk_i4r(queries, v_i4, vscale, mask, k)

    return fn
