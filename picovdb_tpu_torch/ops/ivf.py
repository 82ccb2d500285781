"""IVF-flat ANN tier on PyTorch: device k-means, cluster-contiguous
postings, and scans that read only the probed ("hot") tiles.

Counterpart of picovdb_tpu/ops/ivf.py (the reference's FAISS HNSW tier
re-designed for a device-resident layout):

  * **Train**: spherical k-means on the device (Lloyd iterations, cosine
    assignment by matmul, `index_add_` centroid sums) over a sample.
  * **Layout**: corpus rows reordered cluster-contiguous into a postings
    mirror of IVF_BN-row tiles (`vectors` in the storage dtype, or
    column-scaled int8 `vectors_i8c` + `cscale`), `slots` mapping IVF rows
    back to engine slot ids, an overflow region that incremental updates
    append to (always probed).
  * **Search**: queries score the centroids, take the top `nprobe` each;
    the union over the batch becomes a row mask and a sorted hot-tile
    list (`_probe_preamble`). Two hand-written kernels then read only the
    hot tiles:

      K7 `ivf_scan_topk`   exact top-k_run per query: Q <= 16 the
                           one-query sweep csrc/sweep_topk.cu (rows of
                           16-byte words, `ivf_sweep_ready`; its narrow
                           kind at any width and base, `ivf_narrow_ready`),
                           else k <= 128 the tensor-core scan
                           csrc/ivf_scan_wgmma.cu (`ivf_wgmma_ready`),
                           128 < k <= 1024 its wide kind
                           csrc/ivf_scan_wide.cu (`ivf_wide_ready`); the
                           first port, csrc/scan_topk.cu, only over hot
                           tables past 64M rows at a wide k
      K8 `ivf_segmax_scan` top-`per_seg` keys per segment: the tensor-core
                           segment scan csrc/ivf_segmax_wgmma.cu at every
                           width and base; the first port, csrc/segmax.cu,
                           serves no dispatch

    followed by an exact rescore (of the storage-dtype postings, or, in
    the int8-only layout, of the engine corpus by slot id).

The union-over-batch probe only adds candidates relative to per-query
probing, so recall is >= classic IVF at equal nprobe. Each wrapper checks
its inputs, launches its kernel for a CUDA tensor (raising on a launch
error) and adds one to `scan.LAUNCHES[name]`; for a CPU tensor it runs the
kernel's plain PyTorch version beside it. There is no fallback from a
CUDA tensor to a plain version. `n_hot` stays a device tensor: the
kernels read it on the device.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..constants import Float
from ..utils import next_pow2, round_up
from . import scan as _scan
from .exact import default_device, normalize_on_device
from .scan import (
    _I64_MIN,
    KEY_MIN,
    SCAN_KSEL_MAX,
    SEG,
    _int_acc,
    _launch,
    _merge_sel_keys,
    _require,
    _sel_keys,
    _to_sortable,
    colmax_abs,
    fold_queries_i8,
    quantize_cols_i8,
    quantize_cols_scaled_i8,
    rescore_exact,
    rescore_exact_i4r,
    rescore_exact_i8r,
    split_tf32,
    unpack_i4,
)

# Rows per postings tile (the scan block of both kernels). Layout-coupled:
# PICOVDB_IVF_BN takes effect at the next build; a multiple of 128.
IVF_BN = int(os.getenv("PICOVDB_IVF_BN", "1024") or 1024)

# Below this dim the int8 postings' selection noise rivals real score gaps
# on clustered data (picovdb_tpu measured exact-probe top-1 misses at
# dim 16), so the storage-dtype postings serve instead.
IVF_I8_MIN_DIM = 256

# Keys K8 keeps per 128-row segment on the segmax route. Not picovdb_tpu's
# max(4, min(8, need)): a query's top-k is a random subset of its cluster,
# not spread evenly over the cluster's segments, so depth 4 truncates
# clustered top-10 sets (tests/test_torch_ivf.py::
# test_segmax_depth_4_truncates_clustered_top_k shows it on picovdb_tpu's
# own route); depth 8 loses none there.
SEGMAX_DEPTH = 8


def _ivf_i8_enabled(dim: int) -> bool:
    """int8 postings allowed at this dim (PICOVDB_IVF_I8): "auto" = dim >=
    IVF_I8_MIN_DIM; only explicit truthy values force it below."""
    env = os.getenv("PICOVDB_IVF_I8", "auto").strip().lower()
    if env in ("auto", ""):
        return dim >= IVF_I8_MIN_DIM
    return env in ("1", "true", "on", "yes")


def _ivf_guard(is_i8: bool, dim: int) -> int:
    """Selection band beyond k (PICOVDB_IVF_GUARD overrides): +4 for
    float postings, +22 for int8 postings at dim >= IVF_I8_MIN_DIM (+6
    below), picovdb_tpu's measured widths."""
    env = os.getenv("PICOVDB_IVF_GUARD")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            pass
    if not is_i8:
        return 4
    return 22 if dim >= IVF_I8_MIN_DIM else 6


def _ivf_i8_mirror(dim: int) -> bool:
    """The classic layout's optional int8 postings mirror: opt-in only
    (PICOVDB_IVF_I8 = 1/true/on/yes)."""
    env = os.getenv("PICOVDB_IVF_I8", "auto")
    if env.lower() in ("1", "true", "on", "yes"):
        return _ivf_i8_enabled(dim)
    return False


def default_nlist(n_active: int) -> int:
    """~2*sqrt(N), clamped — the usual IVF sizing rule."""
    return int(max(8, min(4096, 2 * math.sqrt(max(1, n_active)))))


def _i8_clip_max() -> float:
    """Largest fraction of components a requantize-on-append may clip
    before `update` refuses (PICOVDB_IVF_I8_CLIP_MAX, default 0.05)."""
    try:
        return float(os.getenv("PICOVDB_IVF_I8_CLIP_MAX", "0.05"))
    except ValueError:
        return 0.05


def ef_to_nprobe(ef: int, nlist: int) -> int:
    """The reference's efSearch knob as nprobe: ef / 2 clusters."""
    return int(max(1, min(nlist, round(ef / 2))))


def should_build(n_active: int, dim: Optional[int] = None,
                 itemsize: float = 4.0) -> bool:
    """`index="auto"` builds the tier once the exact sweep reads >= 2 GiB
    (picovdb_tpu's measured crossover; not re-measured on the H100)."""
    if dim:
        return n_active * dim * itemsize >= 2 * 2**30
    return n_active >= 2_000_000


# ---------------------------------------------------------------------------
# Training and layout helpers (plain tensor ops; TF32 is off, ops/exact.py)
# ---------------------------------------------------------------------------


def _assign(vectors: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    return torch.argmax(vectors @ centroids.T, dim=1)


def _kmeans(vectors: torch.Tensor, init: torch.Tensor, nlist: int,
            iters: int) -> torch.Tensor:
    """Spherical k-means (cosine): Lloyd iterations, unit centroids; an
    empty cluster keeps its centroid."""
    c = init
    for _ in range(iters):
        assign = _assign(vectors, c)
        sums = torch.zeros((nlist, vectors.shape[1]), dtype=torch.float32,
                           device=vectors.device)
        sums.index_add_(0, assign, vectors)
        norms = torch.linalg.vector_norm(sums, dim=1, keepdim=True)
        c = torch.where(norms > 1e-6, sums / torch.clamp(norms, min=1e-9), c)
    return c


def _gather_rows_dequant(arr, scale, idx):
    """Gather + per-row dequantization of int8 storage rows."""
    return arr[idx].float() * scale[idx][:, None]


def _gather_rows_dequant_i4(arr, scale, idx):
    """Gather + unpack + dequantization of packed int4 storage rows."""
    return unpack_i4(arr[idx]).float() * scale[idx][:, None]


def _reorder_pad(vecs: torch.Tensor, order: torch.Tensor, cap_ivf: int,
                 chunk: int = 262_144) -> torch.Tensor:
    """Cluster-contiguous reorder + tile padding on the device, gathered
    chunk by chunk into the output (no corpus-sized temporary)."""
    out = vecs.new_zeros((cap_ivf, vecs.shape[1]))
    for s in range(0, order.shape[0], chunk):
        e = min(order.shape[0], s + chunk)
        out[s:e] = vecs[order[s:e]]
    return out


# ---------------------------------------------------------------------------
# K7 ivf_scan_topk, K8 ivf_segmax_scan, and their plain versions
# ---------------------------------------------------------------------------

# kernel kinds: f32 rows x f32 queries; bf16 rows x bf16 queries; int8
# column-scaled rows x int8 folded queries (raw int32 scores)
_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_PLAIN_TILES = 64  # hot tiles per step of the plain versions
_PARTIAL_BYTES = 256 << 20  # bound of K7's per-block partial results


def _ivf_checks(name, q, postings, mask, hot, n_hot, bn):
    num_q, dim = q.shape
    cap = postings.shape[0]
    _require(postings.ndim == 2 and postings.shape[1] == dim,
             f"{name}: postings {tuple(postings.shape)} vs dim {dim}")
    _require(bn % SEG == 0 and cap % bn == 0,
             f"{name}: cap {cap} is not a multiple of the tile {bn}")
    _require(mask.shape == (cap,) and mask.dtype == torch.bool,
             f"{name}: mask must be (cap,) bool")
    _require(hot.ndim == 1 and hot.dtype == torch.int32 and hot.shape[0] > 0,
             f"{name}: hot must be a non-empty int32 vector")
    _require(n_hot.shape == (1,) and n_hot.dtype == torch.int32,
             f"{name}: n_hot must be (1,) int32")
    _require(q.dtype == postings.dtype and q.dtype in _KINDS,
             f"{name}: takes f32/f32, bf16/bf16 or int8/int8 queries/rows")
    if q.is_cuda:
        for t in (postings, mask, hot, n_hot):
            _require(t.is_cuda and t.is_contiguous(),
                     f"{name}: every input must be a contiguous CUDA tensor")
    return num_q, cap, dim


def _row_scores(q, postings, rows):
    """Scores of the queries against the given postings rows, as the
    kernels compute them: float32 sums of float32 (or bf16) products,
    exact integer sums (int64) for int8."""
    v = postings[rows]
    if q.dtype == torch.int8:
        acc = _int_acc(q.shape[1], 127 * 127)
        return (q.to(acc) @ v.to(acc).T).to(torch.int64)
    return q.float() @ v.float().T


def _tile_scores(q, postings, hot_b, bn):
    """Scores of the queries against the rows of the given hot tiles.
    Returns (scores, rows)."""
    rows = (hot_b.long()[:, None] * bn
            + torch.arange(bn, device=q.device)).reshape(-1)
    return _row_scores(q, postings, rows), rows


# K7's one-query sweep (csrc/sweep_topk.cu SHARE): a CTA's share of the
# live hot tiles' rows is whole units of this many rows
IVF_SWEEP_SHARE = 16


def _ivf_tma_ready(q: torch.Tensor, postings: torch.Tensor) -> bool:
    """What the 16-byte sweep and TMA read as they lie: rows of whole 16
    bytes (dim % 4 for float32, % 8 for bf16, % 16 for int8) at 16-byte
    aligned bases of both operands."""
    return ((q.shape[1] * q.element_size()) % 16 == 0
            and q.data_ptr() % 16 == 0 and postings.data_ptr() % 16 == 0)


def ivf_sweep_ready(q: torch.Tensor, postings: torch.Tensor, k: int) -> bool:
    """Whether K7 runs the one-query sweep (csrc/sweep_topk.cu) on these
    contiguous operands: Q <= 16, k <= 128, rows of whole 16-byte words
    at 16-byte aligned bases (`_ivf_tma_ready`), and the CTA's query block
    (the query tile `scan.sweep_tile(Q)` times a row's bytes) within
    `scan.SWEEP_QBLOCK_BYTES` (float32 at Q = 16: dim <= 1024). Other rows
    take `ivf_narrow_ready`'s narrow kind; a query block too large for
    the sweep (float32 past dim 1024 at 9-16 queries) and groups above 16
    queries `ivf_wgmma_ready`'s tensor-core scan; k > 128 (the quantized
    stores' host-rescore bands) `ivf_wide_ready`'s wide kind."""
    num_q, dim = q.shape
    row_bytes = dim * q.element_size()
    return (num_q <= _scan.SWEEP_Q_MAX and k <= _scan.SWEEP_K_MAX
            and _ivf_tma_ready(q, postings)
            and _scan.sweep_tile(num_q) * row_bytes <= _scan.SWEEP_QBLOCK_BYTES)


def ivf_narrow_ready(q: torch.Tensor, postings: torch.Tensor, k: int) -> bool:
    """Whether K7 runs the one-query sweep's narrow kind (csrc/
    sweep_topk.cu `sweep_narrow_kernel`, K3's over int8 rows, here over
    float32, bf16 and column-scaled int8 postings and the hot tiles'
    shares) on these contiguous operands: Q <= 16, k <= 128, operands the
    16-byte sweep cannot read (`_ivf_tma_ready` fails: a row off whole 16
    bytes, or a base off 16 bytes; the query is read a byte at a time, the
    rows as the aligned words that hold them), and the query block of
    phase copies (`scan.narrow_block_bytes` over the row bytes) with the
    buffers within `scan.NARROW_SMEM_BYTES` (at every base: widths up to
    313 float32, 305 bf16 or 289 int8 elements at Q = 16, 761 / 753 / 737
    at Q = 8, 1,657 / 1,649 / 1,633 at Q = 4). The rest takes
    `ivf_wgmma_ready`'s scan."""
    num_q, dim = q.shape
    row_bytes = dim * q.element_size()
    tile = _scan.sweep_tile(num_q)
    return (num_q <= _scan.SWEEP_Q_MAX and k <= _scan.SWEEP_K_MAX
            and not _ivf_tma_ready(q, postings)
            and _scan.narrow_block_bytes(num_q, row_bytes, postings.data_ptr())
            + tile * (256 * 8 + 12) <= _scan.NARROW_SMEM_BYTES)


def ivf_sweep_partition(n_hot: int, bn: int, ctas: int):
    """The sweep's shares: CTA c of `ctas` reads the logical rows [beg, end)
    of the `n_hot` live hot steps (logical row i is row i % bn of tile
    hot[i // bn]), whole units of IVF_SWEEP_SHARE rows dealt by integer
    division. Together the shares cover [0, n_hot * bn) once, never reach a
    dead step, and differ by at most one unit. The kernel evaluates the
    same function on the device (csrc/sweep_topk.cu `Rows::range`).
    Returns [(beg, end)] for c = 0 .. ctas - 1."""
    units = max(0, n_hot) * (bn // IVF_SWEEP_SHARE)
    return [(IVF_SWEEP_SHARE * (c * units // ctas),
             IVF_SWEEP_SHARE * ((c + 1) * units // ctas)) for c in range(ctas)]


def ivf_wgmma_ready(q: torch.Tensor, postings: torch.Tensor, k: int) -> bool:
    """Whether K7 runs its tensor-core scan (csrc/ivf_scan_wgmma.cu) on
    these contiguous operands: k <= 128 where neither one-query sweep
    takes them (`ivf_sweep_ready`, `ivf_narrow_ready`: Q > 16, or a query
    block too large for them), at any width and base: the rows by the
    producer `scan.rows_piece` names, the query planes padded to whole 16
    bytes by the launcher. k > 128 takes `ivf_wide_ready`'s wide kind."""
    return (k <= _scan.TOPK_WGMMA_K_MAX and not ivf_sweep_ready(q, postings, k)
            and not ivf_narrow_ready(q, postings, k))


def ivf_wide_ready(q: torch.Tensor, postings: torch.Tensor, k: int,
                   hot: Optional[torch.Tensor] = None,
                   bn: Optional[int] = None) -> bool:
    """Whether K7 runs its wide kind (csrc/ivf_scan_wide.cu: the tensor-core
    scan over the live hot tiles writing a slab, then the radix select) on
    these contiguous operands: 128 < k <= SCAN_KSEL_MAX and one query's
    slab as `ivf_wide_scratch` sizes it, the hot table's grid_b x bn rows
    at 4 bytes a row (`hot` (grid_b,), `bn`; without them the largest
    table, the postings' cap), within scan.TOPK_WIDE_SLAB_BYTES: a probe's
    hot table over postings of any cap, up to 64M rows of its own. At any
    width and base (the rows by the producer `scan.rows_piece` names, the
    queries padded to whole 16 bytes in the scratch). Any Q: a batch
    smaller than a query tile runs one tile. Only a hot table past the
    budget keeps the template, `pv_ivf_scan_topk`."""
    rows = postings.shape[0] if hot is None else hot.shape[0] * bn
    return (_scan.TOPK_WGMMA_K_MAX < k <= SCAN_KSEL_MAX
            and 4 * rows <= _scan.TOPK_WIDE_SLAB_BYTES)


_ES = {0: 4, 1: 2, 2: 1}  # bytes of an element of each kind


def ivf_wide_scratch(num_q: int, dim: int, kind: int, grid_b: int, bn: int,
                     q_tile: int) -> int:
    """Bytes of the wide kind's scratch, as csrc/ivf_scan_wide.cu lays it
    out: the query planes as rows of dim rounded up to whole 16 bytes (the
    float32 queries' TF32 hi and lo planes, or room for the bf16 / int8
    queries copied there where TMA cannot read them as they lie), the live
    tiles in ascending order (grid_b int32), the logical mask (grid_b x bn
    bytes), then one tile's slab (q_tile x grid_b x bn keys), histograms
    and candidates (`scan.i4_wide_scratch` over grid_b x bn rows), each
    from a 256-byte boundary."""
    up = _scan._up256
    es = _ES[kind]
    qld = _scan._pad_to(dim, 16 // es)
    planes = up(num_q * qld * (8 if kind == 0 else es))
    return (planes + up(grid_b * 4) + up(grid_b * bn)
            + _scan.i4_wide_scratch(grid_b * bn, q_tile))


def ivf_wgmma_partition(num_q: int, grid_b: int, bn: int, sms: int,
                        qtile: int = _scan.TOPK_WGMMA_QTILE):
    """The tensor-core scan's grid on a card of `sms` SMs: (q_tiles,
    ranges), as K4's `scan.topk_wgmma_partition` over the hot table's
    grid_b * bn / 128 segments at `qtile` queries a CTA (64; 32 for the
    realigning producer past k 64, `scan.topk_wgmma_qtile`). CTA c takes
    query tile c % q_tiles and share c // q_tiles of `ranges` equal shares
    of the live steps' segments, range r the logical segments [r S //
    ranges, (r + 1) S // ranges) of the S = min(n_hot, grid_b) * bn / 128
    live ones, which it computes from n_hot on the device
    (csrc/scan_topk_wgmma.cuh `num_segments`). The launcher's partial
    buffer holds Q x ranges x k keys."""
    return _scan.topk_wgmma_partition(num_q, grid_b * bn, sms, qtile)


def _tma_planes(q: torch.Tensor):
    """The query planes the tensor-core kinds read by TMA: rows of whole 16
    bytes (zeros past dim) at a 16-byte aligned base; float32 queries
    split into their TF32 hi and lo planes (`split_tf32`), bf16 and int8
    queries as they are. Returns (planes, lo plane or None)."""
    if q.dtype == torch.float32:
        return split_tf32(_scan._pad_cols(q, 4))
    p = _scan._pad_cols(q, 16 // q.element_size())
    return (p if p.data_ptr() % 16 == 0 else p.clone()), None


def _plain_over_shares(q, postings, mask, hot, n_hot, k: int, bn: int,
                       ctas: int):
    """K7's plain version with the sweep's partials: one partial top-k per
    share of `ivf_sweep_partition` (reads n_hot on the host), then the
    merge."""
    n_live = min(int(n_hot.reshape(-1)[0]), hot.shape[0])
    cand = [torch.full((q.shape[0], 1), _I64_MIN, dtype=torch.int64,
                       device=q.device)]  # what a CTA with no live row adds
    for beg, end in ivf_sweep_partition(n_live, bn, ctas):
        if beg == end:
            continue
        i = torch.arange(beg, end, device=q.device)
        rows = hot.long()[i // bn] * bn + i % bn
        keys = torch.where(mask[rows][None, :],
                           _sel_keys(_row_scores(q, postings, rows), rows),
                           _I64_MIN)
        cand.append(torch.topk(keys, min(k, end - beg), dim=1).values)
    return _merge_sel_keys(cand, k, int_scores=q.dtype == torch.int8)


def ivf_scan_topk_plain(q, postings, mask, hot, n_hot, k: int,
                        bn: int = IVF_BN, ctas: Optional[int] = None):
    """Plain version of K7: per hot tile (dead steps b >= n_hot score
    nothing) a partial top-k on (score, row) keys, then the merge. With
    `ctas`, the partials are those of the one-query sweep's `ctas` shares
    instead (the same result: every key is distinct per row)."""
    if ctas is not None:
        return _plain_over_shares(q, postings, mask, hot, n_hot, k, bn, ctas)
    num_q = q.shape[0]
    grid_b = hot.shape[0]
    live_b = torch.arange(grid_b, device=q.device) < n_hot
    kt = min(k, bn)
    cand = []
    for b0 in range(0, grid_b, _PLAIN_TILES):
        hb = hot[b0:b0 + _PLAIN_TILES]
        t = hb.shape[0]
        sc, rows = _tile_scores(q, postings, hb, bn)
        live = mask[rows] & live_b[b0:b0 + t].repeat_interleave(bn)
        keys = torch.where(live[None, :], _sel_keys(sc, rows), _I64_MIN)
        cand.append(torch.topk(keys.view(num_q, t, bn), kt, dim=2)
                    .values.reshape(num_q, t * kt))
    return _merge_sel_keys(cand, k, int_scores=q.dtype == torch.int8)


def ivf_scan_topk(q, postings, mask, hot, n_hot, k: int, bn: int = IVF_BN):
    """Exact masked top-k over the hot tiles of the postings (K7).

    q (Q, dim) and postings (cap_ivf, dim) both float32, both bfloat16, or
    both int8 (column-scaled postings, folded queries); mask (cap_ivf,)
    bool; hot (grid_b,) int32 tile ids; n_hot (1,) int32 on the device:
    steps b >= n_hot read nothing. Returns ((Q, k) float32 scores, -inf
    where empty; (Q, k) int32 IVF rows hot[b] * bn + lane, 0 where
    empty). Selection is exact on the scores (int8: the int32 sums), ties
    to the lower row. Runs the one-query sweep where `ivf_sweep_ready`
    holds, else its narrow kind where `ivf_narrow_ready` holds, else the
    tensor-core scan where `ivf_wgmma_ready` holds, else the wide kind
    where `ivf_wide_ready` holds, else the template. The tensor-core
    kinds' counters name the rows' producer (`scan.rows_piece`)."""
    _ivf_checks("ivf_scan_topk", q, postings, mask, hot, n_hot, bn)
    _require(0 < k <= SCAN_KSEL_MAX,
             f"ivf_scan_topk: k {k} outside 1..{SCAN_KSEL_MAX}")
    if not q.is_cuda:
        return ivf_scan_topk_plain(q, postings, mask, hot, n_hot, k, bn)
    q = q.contiguous()
    num_q = q.shape[0]
    piece = _scan._PIECE_KEY[_scan.rows_piece(postings)]
    if ivf_sweep_ready(q, postings, k):
        vals, idx = _ivf_sweep_launch(q, postings, mask, hot, n_hot, k, bn)
        _scan.LAUNCHES["ivf_scan_topk_sweep"] += 1
    elif ivf_narrow_ready(q, postings, k):
        vals, idx = _ivf_sweep_launch(q, postings, mask, hot, n_hot, k, bn,
                                      "pv_ivf_sweep_topk_narrow")
        _scan._count("ivf_scan_topk_narrow", num_q, k)
    elif ivf_wgmma_ready(q, postings, k):
        vals, idx = _ivf_wgmma_launch(q, postings, mask, hot, n_hot, k, bn)
        _count_kind("ivf_scan_topk_wgmma" + piece, num_q, k)
    elif ivf_wide_ready(q, postings, k, hot, bn):
        vals, idx = _ivf_wide_launch(q, postings, mask, hot, n_hot, k, bn)
        _count_kind("ivf_scan_topk_wide" + piece, num_q, k)
    else:
        vals, idx = _ivf_template_launch(q, postings, mask, hot, n_hot, k, bn)
    _scan._count("ivf_scan_topk", num_q, k)
    return vals, idx


def _count_kind(key: str, num_q: int, k: int) -> None:
    """A launch of a K7 / K8 tensor-core kind: the TMA kinds' counters
    alone, the kinds over rows TMA cannot read (keys ending in
    "_cpasync" / "_realign") also by shape in LAUNCH_SHAPES."""
    if key.endswith(("_cpasync", "_realign")):
        _scan._count(key, num_q, k)
    else:
        _scan.LAUNCHES[key] += 1


def _ivf_sweep_launch(q, postings, mask, hot, n_hot, k: int, bn: int,
                      entry: str = "pv_ivf_sweep_topk"):
    """K7's one-query sweep on checked CUDA operands, uncounted (`entry`
    "pv_ivf_sweep_topk_narrow": its narrow kind, any width and base):
    SWEEP_CTAS_PER_SM CTAs per SM share the live rows."""
    num_q, dim = q.shape
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    ctas = _scan.SWEEP_CTAS_PER_SM * sms
    partial = torch.empty((num_q * ctas * k,), dtype=torch.int64,
                          device=q.device)
    vals = torch.empty((num_q, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((num_q, k), dtype=torch.int32, device=q.device)
    _launch(q, "ivf_scan_topk", entry, _KINDS[q.dtype],
            q.data_ptr(), postings.data_ptr(), mask.data_ptr(), hot.data_ptr(),
            n_hot.data_ptr(), partial.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), num_q, postings.shape[0], dim, k, bn,
            hot.shape[0], ctas)
    return vals, idx


def _ivf_wgmma_launch(q, postings, mask, hot, n_hot, k: int, bn: int):
    """K7's tensor-core scan on checked CUDA operands, uncounted: the query
    planes as TMA reads them (`_tma_planes`: float32 queries split once
    into hi and lo), the rows by the producer `scan.rows_piece` names, CTAs
    over `ivf_wgmma_partition`'s (query tile, segment share) pairs at
    `scan.topk_wgmma_qtile`, the shares of the live steps computed on the
    device; then the merge. One launch whatever Q."""
    num_q, dim = q.shape
    grid_b = hot.shape[0]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    _, ranges = ivf_wgmma_partition(num_q, grid_b, bn, sms,
                                    _scan.topk_wgmma_qtile(postings, k))
    hi, lo = _tma_planes(q)
    planes = hi if lo is None else torch.stack((hi, lo))
    partial = torch.empty((num_q * ranges * k,), dtype=torch.int64,
                          device=q.device)
    vals = torch.empty((num_q, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((num_q, k), dtype=torch.int32, device=q.device)
    _launch(q, "ivf_scan_topk", "pv_ivf_scan_topk_wgmma",
            _scan.rows_piece(postings), _KINDS[q.dtype], planes.data_ptr(),
            postings.data_ptr(), mask.data_ptr(), hot.data_ptr(),
            n_hot.data_ptr(), partial.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), num_q, postings.shape[0], dim, k, bn, grid_b)
    return vals, idx


def _ivf_wide_launch(q, postings, mask, hot, n_hot, k: int, bn: int):
    """K7's wide kind on checked CUDA operands, uncounted: one library call
    that splits float32 queries into their TF32 planes (bf16 and int8
    queries copied to rows of whole 16 bytes where TMA cannot read them),
    orders the live steps by tile and gathers their mask, then, a tile of
    `scan.topk_wide_tile` queries at a time over the hot table's grid_b x
    bn rows, runs the tensor-core scan writing the slab (the rows by the
    producer `scan.rows_piece` names) and the radix select over it, in one
    scratch buffer (`ivf_wide_scratch`)."""
    num_q, dim = q.shape
    grid_b = hot.shape[0]
    kind = _KINDS[q.dtype]
    q_tile = _scan.topk_wide_tile(num_q, grid_b * bn)
    nbytes = ivf_wide_scratch(num_q, dim, kind, grid_b, bn, q_tile)
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=q.device)
    vals = torch.empty((num_q, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((num_q, k), dtype=torch.int32, device=q.device)
    _launch(q, "ivf_scan_topk", "pv_ivf_scan_topk_wide",
            _scan.rows_piece(postings), kind, q.data_ptr(),
            postings.data_ptr(), mask.data_ptr(), hot.data_ptr(),
            n_hot.data_ptr(), scratch.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), num_q, postings.shape[0], dim, k, bn, grid_b,
            q_tile, nbytes)
    return vals, idx


def _ivf_template_launch(q, postings, mask, hot, n_hot, k: int, bn: int):
    """K7's template (csrc/scan_topk.cu) on checked CUDA operands,
    uncounted: every step of the hot table over `split` blocks."""
    num_q, dim = q.shape
    cap = postings.shape[0]
    grid_b = hot.shape[0]
    # each tile over `split` blocks (k <= 128: 16-query tiles, few blocks
    # per probe otherwise; wider k runs 2-query tiles, whose per-block
    # 2048-slot compaction a split would only repeat), and queries in
    # groups, so the per-block partial results stay within _PARTIAL_BYTES
    per_q = grid_b * k * 8
    split = 8 if k <= 128 else 1
    while split > 1 and (bn % split or num_q * per_q * split > _PARTIAL_BYTES):
        split //= 2
    group = max(1, min(num_q, _PARTIAL_BYTES // (per_q * split)))
    partial = torch.empty((group * grid_b * split * k,), dtype=torch.int64,
                          device=q.device)
    vals = torch.empty((num_q, k), dtype=torch.float32, device=q.device)
    idx = torch.empty((num_q, k), dtype=torch.int32, device=q.device)
    for g0 in range(0, num_q, group):
        nq = min(group, num_q - g0)
        _launch(q, "ivf_scan_topk", "pv_ivf_scan_topk", _KINDS[q.dtype],
                q[g0].data_ptr(), postings.data_ptr(), mask.data_ptr(),
                hot.data_ptr(), n_hot.data_ptr(), partial.data_ptr(),
                vals[g0].data_ptr(), idx[g0].data_ptr(), nq, cap, dim, k, bn,
                grid_b, split)
    return vals, idx


def ivf_segmax_scan_plain(q, postings, mask, hot, n_hot, per_seg: int,
                          bn: int = IVF_BN):
    """Plain version of K8: packed keys per hot tile, then `per_seg` max
    passes per 128-row segment; dead steps and masked rows KEY_MIN."""
    num_q = q.shape[0]
    grid_b = hot.shape[0]
    ns = bn // SEG
    live_b = torch.arange(grid_b, device=q.device) < n_hot
    lane = torch.arange(bn, device=q.device, dtype=torch.int32) % SEG
    out = []
    for b0 in range(0, grid_b, _PLAIN_TILES):
        hb = hot[b0:b0 + _PLAIN_TILES]
        t = hb.shape[0]
        sc, rows = _tile_scores(q, postings, hb, bn)
        raw = (sc.to(torch.int32) if sc.dtype == torch.int64
               else _to_sortable(sc.contiguous().view(torch.int32)))
        keys = (raw & ~(SEG - 1)) | lane.repeat(t)
        live = mask[rows] & live_b[b0:b0 + t].repeat_interleave(bn)
        keys = torch.where(live[None, :], keys, KEY_MIN).view(num_q, t, ns, SEG)
        tops = []
        for _ in range(per_seg):
            m = keys.amax(dim=3)
            tops.append(m)
            keys = torch.where(keys == m[..., None], KEY_MIN, keys)
        # column b * per_seg * ns + r * ns + s, picovdb_tpu's slab order
        out.append(torch.stack(tops, dim=2).reshape(num_q, t * per_seg * ns))
    return torch.cat(out, dim=1)


def ivf_segmax_scan(q, postings, mask, hot, n_hot, per_seg: int,
                    bn: int = IVF_BN):
    """Per 128-row segment of each hot tile, its top-`per_seg` packed keys
    (K8).

    Inputs as `ivf_scan_topk`. Returns (Q, grid_b * per_seg * bn / 128)
    int32 keys, column b * per_seg * ns + r * ns + s for the r-th best of
    segment s of hot tile hot[b]. A key is the sortable float32 bits of
    the score (int8: the raw int32 score) with its low 7 bits replaced by
    the row's lane; masked rows, exhausted ranks and dead steps b >= n_hot
    carry KEY_MIN. Runs the tensor-core segment scan at every width and
    base, its counter naming the rows' producer."""
    _ivf_checks("ivf_segmax_scan", q, postings, mask, hot, n_hot, bn)
    _require(1 <= per_seg <= 8, f"ivf_segmax_scan: per_seg {per_seg} not in 1..8")
    if not q.is_cuda:
        return ivf_segmax_scan_plain(q, postings, mask, hot, n_hot, per_seg, bn)
    q = q.contiguous()
    keys = _ivf_segmax_launch(q, postings, mask, hot, n_hot, per_seg, bn)
    _scan._count("ivf_segmax", q.shape[0], per_seg)
    _count_kind("ivf_segmax_wgmma"
                + _scan._PIECE_KEY[_scan.rows_piece(postings)],
                q.shape[0], per_seg)
    return keys


def _ivf_segmax_keys(q, postings, hot, per_seg: int, bn: int):
    """K8's output slab and the arguments after q, v of both K8 kernels."""
    num_q, dim = q.shape
    grid_b = hot.shape[0]
    keys = torch.empty((num_q, grid_b * per_seg * (bn // SEG)),
                       dtype=torch.int32, device=q.device)
    return keys, (keys.data_ptr(), num_q, postings.shape[0], dim, bn, grid_b,
                  per_seg)


def _ivf_segmax_launch(q, postings, mask, hot, n_hot, per_seg: int, bn: int):
    """K8's tensor-core segment scan on checked CUDA operands, uncounted:
    the query planes as TMA reads them (`_tma_planes`), the rows by the
    producer `scan.rows_piece` names."""
    keys, tail = _ivf_segmax_keys(q, postings, hot, per_seg, bn)
    hi, lo = _tma_planes(q)
    _launch(q, "ivf_segmax_scan", "pv_ivf_segmax_wgmma",
            _scan.rows_piece(postings), _KINDS[q.dtype], hi.data_ptr(),
            None if lo is None else lo.data_ptr(), postings.data_ptr(),
            mask.data_ptr(), hot.data_ptr(), n_hot.data_ptr(), *tail)
    return keys


def _ivf_segmax_first_launch(q, postings, mask, hot, n_hot, per_seg: int,
                             bn: int):
    """K8's first kernel, `pv_ivf_segmax` (csrc/segmax.cu), on checked CUDA
    operands, uncounted. It serves no dispatch: chip_smoke.py times the
    segment scan against it."""
    keys, tail = _ivf_segmax_keys(q, postings, hot, per_seg, bn)
    _launch(q, "ivf_segmax_scan", "pv_ivf_segmax", _KINDS[q.dtype],
            q.data_ptr(), postings.data_ptr(), mask.data_ptr(), hot.data_ptr(),
            n_hot.data_ptr(), *tail)
    return keys


# ---------------------------------------------------------------------------
# Probe preamble, rescore, and the two probed routes
# ---------------------------------------------------------------------------


def _probe_preamble(q, centroids, active, seg_starts, cluster2tile, *,
                    nprobe: int, nlist: int, g_tiles: Optional[int],
                    cap_ivf: int, n_tiles: int, bn: int):
    """Probe clusters and build (row_mask (cap_ivf,) bool, hot (grid_b,)
    int32 tile ids, n_hot (1,) int32 device tensor, grid_b), shared by
    both kernels. Plain tensor ops; nothing is read back to the host."""
    dev = q.device
    cs = q @ centroids.T  # (Q, nlist_pad)
    col = torch.arange(cs.shape[1], device=dev)
    cs = torch.where(col[None, :] < nlist, cs, float("-inf"))
    probed = torch.topk(cs, min(nprobe, nlist), dim=1).indices
    # union over the batch; the overflow bucket (incremental appends) is
    # probed by every query
    cluster_mask = torch.zeros(centroids.shape[0], dtype=torch.float32,
                               device=dev)
    cluster_mask.index_fill_(0, probed.reshape(-1), 1.0)
    cluster_mask[nlist] = 1.0
    # per-row membership is piecewise constant over the cluster-contiguous
    # layout: +1/-1 at the segment edges, then a cumsum
    cm_main = cluster_mask[: nlist + 1]
    delta = torch.zeros(cap_ivf + 1, dtype=torch.float32, device=dev)
    delta.index_add_(0, seg_starts[:-1], cm_main)
    delta.index_add_(0, seg_starts[1:], -cm_main)
    row_mask = (torch.cumsum(delta, 0)[:cap_ivf] > 0.5) & active
    tile_hot = (cluster_mask @ cluster2tile) > 0  # (n_tiles,)
    n_hot = tile_hot.sum().to(torch.int32).reshape(1)
    # overflow-region tiles sort first: truncation to grid_b sheds the
    # highest-id probed tiles, never the freshly upserted rows
    ov_tile0 = seg_starts[nlist] // bn
    iota = torch.arange(n_tiles, device=dev)
    sort_key = torch.where(iota >= ov_tile0, iota - n_tiles, iota)
    tile_ids = torch.where(tile_hot, sort_key, n_tiles)
    grid_b = min(g_tiles, n_tiles) if g_tiles else n_tiles
    hot = torch.sort(tile_ids).values[:grid_b]
    hot = torch.where(hot < 0, hot + n_tiles, hot)
    n_hot = torch.clamp(n_hot, max=grid_b)
    last_hot = hot.gather(0, torch.clamp(n_hot - 1, min=0).long())
    hot = torch.where(hot >= n_tiles, last_hot, hot)
    # n_hot == 0 (every probed cluster empty) leaves last_hot == n_tiles;
    # clamp so every step names a real tile (dead steps read nothing)
    hot = torch.clamp(hot, max=n_tiles - 1)
    return row_mask, hot.to(torch.int32), n_hot, grid_b


def _rescore_by_slot(q, corpus, slots, vals, idxs, k, corpus_scale=None,
                     packed_i4: bool = False):
    """Exact rescore for the int8-only layout: winner IVF rows -> engine
    slot ids -> `rescore_exact*` over the slot-indexed corpus (float, or
    int8 / packed int4 storage times its row scale). -inf / pad candidates
    stay -inf with slot -1."""
    sl = slots[idxs.long()]
    vals = torch.where(sl < 0, float("-inf"), vals)
    sl = torch.clamp(sl, min=0)
    if packed_i4:
        vals, sl = rescore_exact_i4r(q, corpus, corpus_scale, vals, sl)
    elif corpus_scale is not None:
        vals, sl = rescore_exact_i8r(q, corpus, corpus_scale, vals, sl)
    else:
        vals, sl = rescore_exact(q, corpus, vals, sl)
    return _cut_to_slots(vals, sl, k)


def _cut_to_slots(vals, slot_ids, k):
    """The first k of a rescored band; -1 where the score is -inf."""
    vals = vals[:, :k]
    slot_ids = torch.where(torch.isneginf(vals), -1, slot_ids[:, :k])
    return vals, slot_ids.to(torch.int32)


def _scan_inputs(q, vectors, vectors_i8, cscale):
    """What the kernels read: folded int8 queries over the int8 postings,
    or the queries in the postings' dtype (bf16 postings: bf16 queries)."""
    if vectors_i8 is not None:
        return fold_queries_i8(q, cscale), vectors_i8
    return q.to(vectors.dtype), vectors


def _cap_of(vectors, vectors_i8, rescore_by_slot):
    return (vectors_i8 if rescore_by_slot else vectors).shape[0]


def probe_scan_local(q, centroids, vectors, slots, seg_starts, active,
                     cluster2tile, *, k: int, k_sel: int, nprobe: int,
                     nlist: int, g_tiles: Optional[int],
                     vectors_i8=None, cscale=None,
                     rescore_by_slot: bool = False, rescore_scale=None,
                     rescore_packed_i4: bool = False):
    """Probe -> hot tiles -> K7 -> exact rescore -> slot ids, over one
    device's IVF arrays. `q` is L2-normalized float32. Returns ((Q, k) f32
    exact scores, (Q, k) int32 slot ids; -1 marks missing candidates).

    `rescore_by_slot` (int8-only layout): `vectors` is the engine's
    slot-indexed corpus; postings geometry comes from `vectors_i8`."""
    cap_ivf = _cap_of(vectors, vectors_i8, rescore_by_slot)
    row_mask, hot, n_hot, _ = _probe_preamble(
        q, centroids, active, seg_starts, cluster2tile, nprobe=nprobe,
        nlist=nlist, g_tiles=g_tiles, cap_ivf=cap_ivf,
        n_tiles=cap_ivf // IVF_BN, bn=IVF_BN)
    q_scan, v_scan = _scan_inputs(q, vectors, vectors_i8, cscale)
    vals, idxs = ivf_scan_topk(q_scan, v_scan, row_mask, hot, n_hot,
                               min(k_sel, IVF_BN))
    if rescore_by_slot:
        return _rescore_by_slot(q, vectors, slots, vals, idxs, k,
                                corpus_scale=rescore_scale,
                                packed_i4=rescore_packed_i4)
    vals, idxs = rescore_exact(q, vectors, vals, idxs)
    return _cut_to_slots(vals, slots[idxs.long()], k)


def probe_scan_segmax(q, centroids, vectors, slots, seg_starts, active,
                      cluster2tile, *, k: int, k_sel: int, nprobe: int,
                      nlist: int, g_tiles: Optional[int],
                      per_seg: int = SEGMAX_DEPTH,
                      vectors_i8=None, cscale=None,
                      rescore_by_slot: bool = False, rescore_scale=None,
                      rescore_packed_i4: bool = False):
    """Probe -> hot tiles -> K8 -> global top-k_sel of the key slab
    (`torch.topk`, as picovdb_tpu's `lax.top_k`) -> decode -> exact
    rescore -> slot ids. Same contract as `probe_scan_local`."""
    cap_ivf = _cap_of(vectors, vectors_i8, rescore_by_slot)
    ns = IVF_BN // SEG
    row_mask, hot, n_hot, _ = _probe_preamble(
        q, centroids, active, seg_starts, cluster2tile, nprobe=nprobe,
        nlist=nlist, g_tiles=g_tiles, cap_ivf=cap_ivf,
        n_tiles=cap_ivf // IVF_BN, bn=IVF_BN)
    q_scan, v_scan = _scan_inputs(q, vectors, vectors_i8, cscale)
    keys = ivf_segmax_scan(q_scan, v_scan, row_mask, hot, n_hot, per_seg)
    # decode only the winners: column c is grid step c // (per_seg * ns),
    # segment (c % (per_seg * ns)) % ns of tile hot[step], lane key & 127
    tk, ti = torch.topk(keys, min(k_sel, keys.shape[1]), dim=1)
    step = ti // (per_seg * ns)
    s = (ti % (per_seg * ns)) % ns
    gidx = (hot.long()[step] * ns + s) * SEG + (tk & (SEG - 1)).long()
    empty = tk == KEY_MIN
    gidx = torch.where(empty, 0, gidx)
    marker = torch.where(empty, float("-inf"), 0.0)
    if rescore_by_slot:
        return _rescore_by_slot(q, vectors, slots, marker, gidx, k,
                                corpus_scale=rescore_scale,
                                packed_i4=rescore_packed_i4)
    vals, idxs = rescore_exact(q, vectors, marker, gidx)
    return _cut_to_slots(vals, slots[idxs], k)


def _make_ivf_search(k: int, nprobe: int, nlist: int,
                     g_tiles: Optional[int] = None, style: str = "ladder",
                     per_seg: int = SEGMAX_DEPTH, slot_rescore: bool = False,
                     k_sel: Optional[int] = None, packed_i4: bool = False):
    """The probed search as a plain closure: normalize on the device, then
    `probe_scan_local` (K7, "ladder") or `probe_scan_segmax` (K8).

    fn(q, centroids, vectors, slots, seg_starts, active, cluster2tile,
       vectors_i8=None, cscale=None, rescore_scale=None) -> (vals, slots)
    """
    if k_sel is None:
        k_sel = k + 4
    scan = probe_scan_segmax if style == "segmax" else probe_scan_local
    extra = {"per_seg": per_seg} if style == "segmax" else {}

    def fn(q, centroids, vectors, slots, seg_starts, active, cluster2tile,
           vectors_i8=None, cscale=None, rescore_scale=None):
        return scan(
            normalize_on_device(q), centroids, vectors, slots, seg_starts,
            active, cluster2tile, k=k, k_sel=k_sel, nprobe=nprobe,
            nlist=nlist, g_tiles=g_tiles, vectors_i8=vectors_i8,
            cscale=cscale, rescore_by_slot=slot_rescore,
            rescore_scale=rescore_scale, rescore_packed_i4=packed_i4,
            **extra)

    return fn


# ---------------------------------------------------------------------------
# The index
# ---------------------------------------------------------------------------


def _i8_requantize(rows_f: np.ndarray, cscale: np.ndarray):
    """Appended rows against frozen column scales: (int8 rows, fraction of
    components that clip)."""
    scaled = np.rint(rows_f / cscale)
    clipped = float((np.abs(scaled) > 127).mean())
    return np.clip(scaled, -127, 127).astype(np.int8), clipped


class IVFIndex:
    """Cluster-reordered device postings + hot-tile search (one device)."""

    def __init__(self, centroids, vectors, slots, row_cluster, active,
                 cluster2tile, nlist: int, n_tiles: int, dim: int,
                 seg_starts=None) -> None:
        self.centroids = centroids  # (nlist_pad, dim) f32
        self.vectors = vectors  # (cap_ivf, dim) storage dtype, or None
        self.slots = slots  # (cap_ivf,) int64 slot id, -1 pad
        self.row_cluster = row_cluster  # (cap_ivf,) int64
        self.active = active  # (cap_ivf,) bool
        self.cluster2tile = cluster2tile  # (nlist_pad, n_tiles) f32 0/1
        # (nlist + 2,) int64: first row of each cluster, then the overflow
        # region's start, then cap_ivf
        self.seg_starts = seg_starts
        self.nlist = nlist
        self.n_tiles = n_tiles
        self.dim = dim
        self.device = centroids.device
        self._host_blob: Optional[dict] = None
        # column-scaled int8 postings: the int8-only layout's only postings
        # (`vectors is None`; the rescore reads the engine corpus by slot),
        # or the classic layout's opt-in selection mirror
        self.vectors_i8c = None
        self.cscale = None
        # frozen column scales for requantize-on-append + its clip guard
        self._cscale_np: Optional[np.ndarray] = None
        self.last_update_clip_fraction: Optional[float] = None
        if vectors is not None and _ivf_i8_mirror(dim):
            self.refresh_i8_mirror()

    def refresh_i8_mirror(self) -> None:
        """(Re)derive the classic layout's int8 mirror from `vectors` and
        freeze its column scales on the host. No-op in the int8-only
        layout."""
        if self.vectors is None:
            return
        self.vectors_i8c, self.cscale = quantize_cols_i8(self.vectors)
        self._cscale_np = self.cscale.cpu().numpy()

    # -- construction --------------------------------------------------------

    @classmethod
    def build(cls, host_vectors: Optional[np.ndarray], active_mask: np.ndarray,
              nlist: Optional[int] = None, dim: Optional[int] = None,
              iters: int = 8, seed: int = 0,
              warm_centroids: Optional[np.ndarray] = None, dev_vectors=None,
              storage_dtype: Optional[str] = None, i8_only: bool = False,
              dequant_scale=None, device=None) -> "IVFIndex":
        """Train + lay out the postings.

        With `dev_vectors` (the engine's device corpus, any storage dtype;
        packed (cap, dim / 2) for int4, with `dequant_scale` for int8/int4)
        everything runs on its device and only int row/order tables cross
        from the host; `host_vectors` may be None. Otherwise the active
        rows are uploaded once to `device`. The classic layout keeps the
        storage dtype; `i8_only` keeps only column-scaled int8 postings,
        built in two chunked passes (column abs-max, then quantize)."""
        src0 = host_vectors if host_vectors is not None else dev_vectors
        size = src0.shape[0]
        dim = dim if dim is not None else src0.shape[1]
        act_rows = np.nonzero(active_mask[:size])[0]
        n_active = act_rows.shape[0]
        if n_active == 0:
            raise ValueError("cannot build IVF over an empty corpus")
        nlist = int(nlist) if nlist else default_nlist(n_active)
        nlist = min(nlist, n_active)
        if storage_dtype == "int4" and not i8_only:
            raise ValueError("int4 corpora require the int8-only postings layout")
        packed_i4 = storage_dtype == "int4" and dev_vectors is not None
        gather_dq = _gather_rows_dequant_i4 if packed_i4 else _gather_rows_dequant
        if dev_vectors is not None:
            # gather through act_rows: an active-row copy would double the
            # corpus's device residency
            src, sel = dev_vectors, act_rows
            device = dev_vectors.device
        else:
            device = torch.device(device) if device is not None else default_device()
            dt = (torch.bfloat16 if storage_dtype == "bfloat16" and not i8_only
                  else torch.float32)
            vecs = np.ascontiguousarray(np.asarray(host_vectors)[act_rows],
                                        dtype=Float)
            src = torch.from_numpy(vecs).to(device).to(dt)
            sel = np.arange(n_active, dtype=np.int64)

        def rows_of(gsel: np.ndarray):
            gidx = torch.from_numpy(np.ascontiguousarray(gsel, dtype=np.int64)
                                    ).to(device)
            if dequant_scale is not None:
                return gather_dq(src, dequant_scale, gidx)
            return src[gidx]

        rng = np.random.default_rng(seed)
        if warm_centroids is not None and warm_centroids.shape == (nlist, dim):
            init = torch.from_numpy(np.ascontiguousarray(
                warm_centroids, dtype=Float)).to(device)
            train_iters = max(0, min(iters, 2))  # refresh only; 0 = as saved
        else:
            pick = rng.choice(n_active, size=nlist, replace=False)
            init = rows_of(sel[pick]).float()
            train_iters = iters
        if train_iters:
            # Lloyd converges on ~50 points per list: train on a sample;
            # the final assignment still uses every row
            n_train = min(n_active, max(nlist * 50, 10_000))
            if n_train < n_active:
                tr = np.sort(rng.choice(n_active, size=n_train, replace=False))
            else:
                tr = np.arange(n_active)
            centroids = _kmeans(rows_of(sel[tr]).float(), init, nlist,
                                train_iters)
        else:
            centroids = init
        # chunked assignment: one (n, nlist) score matrix would not fit
        assign = np.empty(n_active, dtype=np.int64)
        a_chunk = 131_072
        for s in range(0, n_active, a_chunk):
            e = min(n_active, s + a_chunk)
            assign[s:e] = _assign(rows_of(sel[s:e]).float(),
                                  centroids).cpu().numpy()

        # cluster-contiguous order; the slack past n_active is the overflow
        # region incremental updates append to (cluster id nlist)
        order = np.argsort(assign, kind="stable")
        sorted_clusters = assign[order]
        slack = max(IVF_BN, int(0.04 * n_active))
        cap_ivf = round_up(n_active + slack, IVF_BN)
        n_tiles = cap_ivf // IVF_BN

        i8_buf = i8_scales = cs_np = None
        gsel = sel[order]
        if i8_only:
            chunk = 262_144
            cmax = torch.zeros(dim, dtype=torch.float32, device=device)
            for s0 in range(0, n_active, chunk):
                cmax = torch.maximum(cmax, colmax_abs(rows_of(gsel[s0:s0 + chunk])))
            cs_np = (np.maximum(cmax.cpu().numpy(), 1e-30) / 127.0).astype(np.float32)
            i8_scales = torch.from_numpy(cs_np).to(device)
            i8_buf = torch.zeros((cap_ivf, dim), dtype=torch.int8, device=device)
            for s0 in range(0, n_active, chunk):
                e0 = min(n_active, s0 + chunk)
                i8_buf[s0:e0] = quantize_cols_scaled_i8(rows_of(gsel[s0:e0]),
                                                        i8_scales)
            ivf_vecs = None
        else:
            ivf_vecs = _reorder_pad(src, torch.from_numpy(gsel).to(device),
                                    cap_ivf)
        del src
        ivf_slots = np.full(cap_ivf, -1, dtype=np.int64)
        ivf_slots[:n_active] = act_rows[order]
        ivf_cluster = np.full(cap_ivf, nlist, dtype=np.int64)  # pad bucket
        ivf_cluster[:n_active] = sorted_clusters
        ivf_act = np.zeros(cap_ivf, dtype=bool)
        ivf_act[:n_active] = True
        nlist_pad = round_up(nlist + 1, 8)  # +1 pad / overflow bucket
        c2t = np.zeros((nlist_pad, n_tiles), dtype=Float)
        c2t[ivf_cluster, np.arange(cap_ivf) // IVF_BN] = 1.0
        c2t[nlist] = 0.0  # the overflow bucket probes nothing yet
        cent_np = np.zeros((nlist_pad, dim), dtype=Float)
        cent_np[:nlist] = centroids.cpu().numpy()
        starts = np.searchsorted(sorted_clusters, np.arange(nlist + 1))
        seg_starts = np.concatenate([starts, [cap_ivf]]).astype(np.int64)

        def up(a):
            return torch.from_numpy(a).to(device)

        idx = cls(centroids=up(cent_np), vectors=ivf_vecs,
                  slots=up(ivf_slots), row_cluster=up(ivf_cluster),
                  active=up(ivf_act), cluster2tile=up(c2t), nlist=nlist,
                  n_tiles=n_tiles, dim=dim, seg_starts=up(seg_starts))
        if i8_only:
            idx.vectors_i8c, idx.cscale, idx._cscale_np = i8_buf, i8_scales, cs_np
        idx._host_blob = {
            "centroids": cent_np[:nlist],
            "assign_rows": act_rows.astype(np.int64),
            "assign_cluster": assign.astype(np.int32),
            "nlist": np.asarray(nlist),
        }
        s2r = np.full(int(act_rows.max()) + 1, -1, dtype=np.int64)
        s2r[act_rows[order]] = np.arange(n_active, dtype=np.int64)
        idx._slot2row = s2r
        idx._n_used = n_active
        idx._n_build = n_active
        idx._blob_stale = False
        return idx

    @classmethod
    def from_numpy_state(cls, centroids, vectors, slots, row_cluster, active,
                         cluster2tile, seg_starts, nlist: int, n_tiles: int,
                         dim: int, vectors_i8c=None, cscale=None,
                         slot2row=None, n_used: Optional[int] = None,
                         n_build: Optional[int] = None, host_blob=None,
                         device=None) -> "IVFIndex":
        """Adopt an index's arrays as numpy (picovdb_tpu's IVFIndex state:
        a bfloat16 `vectors` array comes as ml_dtypes bfloat16) plus its
        host bookkeeping, so both packages probe one layout."""
        device = torch.device(device) if device is not None else default_device()

        def up(a, dtype=None):
            if a is None:
                return None
            a = np.asarray(a)
            if a.dtype.name == "bfloat16":
                return torch.from_numpy(a.astype(np.float32)).to(device).to(
                    torch.bfloat16)
            # a copy: the index mutates its tensors in place, and the
            # caller's arrays may be read-only views of another store
            t = torch.from_numpy(np.array(a, copy=True, order="C")).to(device)
            return t if dtype is None else t.to(dtype)

        idx = cls(centroids=up(centroids, torch.float32), vectors=up(vectors),
                  slots=up(slots, torch.int64),
                  row_cluster=up(row_cluster, torch.int64),
                  active=up(active, torch.bool),
                  cluster2tile=up(cluster2tile, torch.float32), nlist=int(nlist),
                  n_tiles=int(n_tiles), dim=int(dim),
                  seg_starts=up(seg_starts, torch.int64))
        if vectors_i8c is not None:
            idx.vectors_i8c = up(vectors_i8c, torch.int8)
            idx.cscale = up(cscale, torch.float32)
            idx._cscale_np = np.asarray(cscale, dtype=np.float32)
        if slot2row is None:
            sl = np.asarray(slots)
            live = np.nonzero(sl >= 0)[0]
            slot2row = np.full(int(sl.max()) + 1 if live.size else 1, -1, np.int64)
            slot2row[sl[live]] = live
        idx._slot2row = np.asarray(slot2row, dtype=np.int64).copy()
        idx._n_used = int(n_used) if n_used is not None else int(
            (np.asarray(slots) >= 0).sum())
        idx._n_build = int(n_build) if n_build is not None else idx._n_used
        idx._host_blob = host_blob
        idx._blob_stale = False
        return idx

    # -- incremental maintenance ---------------------------------------------

    def update(self, changed_slots: np.ndarray, rows: Optional[np.ndarray],
               active_flags: np.ndarray) -> bool:
        """Apply a small mutation set in place; False = the caller must
        rebuild.

        Deleted / updated slots deactivate their old IVF row; new and
        updated rows append to the overflow region (cluster nlist, probed
        by every query). False when the overflow region is full, or, in
        the int8-only layout, when the appended rows clip more than
        PICOVDB_IVF_I8_CLIP_MAX of their components against the frozen
        build-time column scales (drifted data wants fresh scales). The
        classic layout's int8 mirror requantizes appended rows the same
        way and re-derives itself on a guard trip."""
        i8_only = self.vectors is None
        store = self.vectors_i8c if i8_only else self.vectors
        changed_slots = np.asarray(changed_slots, dtype=np.int64)
        active_flags = np.asarray(active_flags, dtype=bool)
        n_new = int(active_flags.sum())
        if self._n_used + n_new > store.shape[0]:
            return False
        q8_new = None
        if i8_only and n_new:
            q8_new, clipped = _i8_requantize(
                np.asarray(rows[active_flags], dtype=np.float32), self._cscale_np)
            self.last_update_clip_fraction = clipped
            if clipped > _i8_clip_max():
                return False

        max_slot = int(changed_slots.max()) if changed_slots.size else 0
        if max_slot >= self._slot2row.shape[0]:
            grown = np.full(max_slot + 1, -1, dtype=np.int64)
            grown[: self._slot2row.shape[0]] = self._slot2row
            self._slot2row = grown
        old_rows = self._slot2row[changed_slots]
        old_rows = old_rows[old_rows >= 0]
        new_slots = changed_slots[active_flags]
        start = self._n_used
        self._slot2row[changed_slots] = -1
        self._slot2row[new_slots] = np.arange(start, start + n_new)
        self._n_used = start + n_new
        self._blob_stale = True

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        if old_rows.size:
            self.active.index_fill_(0, up(old_rows), False)
        if n_new:
            end = start + n_new
            if i8_only:
                self.vectors_i8c[start:end] = up(q8_new)
            else:
                new_f = np.asarray(rows[active_flags], dtype=Float)
                self.vectors[start:end] = up(new_f).to(self.vectors.dtype)
            self.slots[start:end] = up(new_slots)
            self.row_cluster[start:end] = self.nlist
            self.active[start:end] = True
            tiles = np.unique(np.arange(start, end) // IVF_BN)
            self.cluster2tile[self.nlist].index_fill_(0, up(tiles), 1.0)
            if not i8_only and self.vectors_i8c is not None:
                if self._cscale_np is None:
                    self.refresh_i8_mirror()
                else:
                    q8, clipped = _i8_requantize(new_f, self._cscale_np)
                    self.last_update_clip_fraction = clipped
                    if clipped > _i8_clip_max():
                        self.refresh_i8_mirror()
                    else:
                        self.vectors_i8c[start:end] = up(q8)
        return True

    def warm_update_path(self, bucket: int = 1024) -> None:
        """No-op: picovdb_tpu pre-compiles its update scatters here; eager
        PyTorch has nothing to compile."""

    @property
    def overflow_fraction(self) -> float:
        """Fraction of rows appended to the overflow region since the last
        full build (dead holes count too)."""
        used = max(1, self._n_used)
        return float(self._n_used - self._n_build) / used

    def to_blob(self) -> Optional[dict]:
        """The persistable sidecar (centroids + the live rows' clusters),
        refreshed after incremental updates so a reload reuses the
        trained centroids without a retrain."""
        if self._host_blob is not None and self._blob_stale:
            live_slots = np.nonzero(self._slot2row >= 0)[0].astype(np.int64)
            row_cluster = self.row_cluster.cpu().numpy()
            self._host_blob = {
                "centroids": self._host_blob["centroids"],
                "assign_rows": live_slots,
                "assign_cluster": row_cluster[
                    self._slot2row[live_slots]].astype(np.int32),
                "nlist": np.asarray(self.nlist),
            }
            self._blob_stale = False
        return self._host_blob

    @classmethod
    def from_blob(cls, blob: dict, host_vectors: Optional[np.ndarray],
                  active_mask: np.ndarray, dim: int, dev_vectors=None,
                  storage_dtype: Optional[str] = None, i8_only: bool = False,
                  dequant_scale=None, device=None) -> Optional["IVFIndex"]:
        """Rebuild from a sidecar without retraining k-means (warm
        centroids, zero iterations); None when the blob no longer matches
        the store's active rows or dim (the caller retrains)."""
        try:
            cent = np.asarray(blob["centroids"], dtype=Float)
            if cent.ndim != 2 or cent.shape[1] != dim:
                return None
            size = (active_mask.shape[0] if host_vectors is None
                    else host_vectors.shape[0])
            act_rows = np.nonzero(active_mask[:size])[0]
            saved_rows = np.asarray(blob["assign_rows"])
            if act_rows.shape != saved_rows.shape or not np.array_equal(
                    act_rows, saved_rows):
                return None
            nlist = int(blob["nlist"])
        except (KeyError, TypeError, ValueError):
            return None
        return cls.build(
            host_vectors if dev_vectors is None else None, active_mask,
            nlist=nlist, dim=dim, warm_centroids=cent, iters=0,
            dev_vectors=dev_vectors, storage_dtype=storage_dtype,
            i8_only=i8_only, dequant_scale=dequant_scale, device=device)

    # -- search ----------------------------------------------------------------

    def search(self, queries, k: int, ef: int, dev,
               nprobe: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Probed masked top-k; host (vals, slot_ids) of (Q, k). When every
        probed cluster was empty (stale centroids, tiny nprobe) the query
        is served by the exact scan of `dev` instead of coming back empty."""
        vals, slot_ids, num_q = self.search_async(queries, k, ef, dev, nprobe)
        vals_np = vals.cpu().numpy()[:num_q, :k]
        slots_np = slot_ids.cpu().numpy()[:num_q, :k]
        if not np.isfinite(vals_np).any():
            return dev.query(queries[:num_q], k, None)
        return vals_np, slots_np

    def _query_tensor(self, queries) -> torch.Tensor:
        if isinstance(queries, np.ndarray):
            queries = torch.from_numpy(np.ascontiguousarray(queries))
        return queries.to(device=self.device, dtype=torch.float32)

    def g_tiles(self, num_q: int, nprobe: int) -> int:
        """The hot-tile grid bound of a `num_q`-query probe (see
        `search_async`)."""
        q_pad = max(8, next_pow2(num_q))
        p_cluster = min(1.0, nprobe / self.nlist)
        uniq = self.nlist * (1.0 - (1.0 - p_cluster) ** q_pad) + 1
        span = self.n_tiles / self.nlist + 1.0
        e_hot = self.n_tiles * (1.0 - math.exp(-uniq * span / self.n_tiles))
        return min(self.n_tiles, round_up(int(1.35 * e_hot) + 16, 64))

    def search_async(self, queries, k: int, ef: int, dev,
                     nprobe: Optional[int] = None):
        """Dispatch a probed top-k without waiting for the device: returns
        (vals (Q, k), slot_ids (Q, k), num_q) as device tensors.

        `nprobe` overrides the ef -> nprobe mapping. The hot-tile grid is
        bounded by `g_tiles`, sized as picovdb_tpu sizes it from the batch
        padded to max(8, next_pow2(Q)) (its kernels' query tiles; the pad
        queries repeat the first one and add nothing to the union): the
        expected distinct probed clusters nlist * (1 - (1 - p)^Q) spread
        over tile spans, times 1.35, plus 16, in 64-tile buckets. A
        truncated list sheds the highest-id probed tiles; overflow tiles
        sort first and are never shed."""
        if nprobe is None:
            nprobe = ef_to_nprobe(ef, self.nlist)
        nprobe = int(max(1, min(self.nlist, nprobe)))
        num_q = queries.shape[0]
        g_tiles = self.g_tiles(num_q, nprobe)
        # Style: the ladder (K7) pays selection per hot tile, segmax (K8)
        # `per_seg` max passes + one global top-k; segmax needs a cluster
        # to span enough 128-row segments to surface the full guard band,
        # or the ladder serves (PICOVDB_IVF_STYLE overrides).
        slot_rescore = self.vectors is None  # int8-only layout
        postings = self.vectors_i8c if slot_rescore else self.vectors
        use_i8_sel = (self.vectors_i8c is not None) or slot_rescore
        k_sel = k + _ivf_guard(use_i8_sel, self.dim)
        span_segs = max(1e-6, (postings.shape[0] / max(1, self.nlist)) / SEG)
        need = math.ceil(1.5 * k_sel / span_segs)
        style = os.getenv("PICOVDB_IVF_STYLE", "") or (
            "segmax" if num_q > 1 and k_sel <= 64 and need <= 8 else "ladder")
        if slot_rescore:
            if dev is None or getattr(dev, "vectors", None) is None:
                raise RuntimeError(
                    "int8-only IVF needs the engine's device corpus for the "
                    "exact rescore")
            rescore_v = dev.vectors
            rescore_scale = getattr(dev, "vstore_scale", None)
            packed_i4 = getattr(dev, "storage_dtype", None) == "int4"
        else:
            rescore_v, rescore_scale, packed_i4 = self.vectors, None, False
        fn = _make_ivf_search(k, nprobe, self.nlist, g_tiles, style,
                              slot_rescore=slot_rescore, k_sel=k_sel,
                              packed_i4=packed_i4)
        vals, slot_ids = fn(self._query_tensor(queries), self.centroids,
                            rescore_v, self.slots, self.seg_starts, self.active,
                            self.cluster2tile, self.vectors_i8c, self.cscale,
                            rescore_scale)
        return vals, slot_ids, num_q
