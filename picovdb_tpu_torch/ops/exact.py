"""Exact masked cosine top-k with plain tensor ops (`matmul` + `topk`).

Counterpart of picovdb_tpu/ops/exact.py: `scores = Q @ V.T`, inactive or
filtered-out rows masked to -inf, top-k on the device. This is the plain
route (`xla_topk`) and the fallback for k past the hand-written kernels'
reach; it materializes the (Q, cap) score matrix, so callers keep it for
small batches and wide k.

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
