"""K4's tensor-core scan (csrc/scan_topk_wgmma.cu) and K5's int8 mainloop,
checked on the CPU.

* Numerics: a numpy emulation of the kernel's products on seeded clustered
  unit vectors at dim 1024, with the tensor cores' float32 sum rounding
  toward zero at every wgmma and each k-stage's wgmmas summed apart, then
  added rounded. Float32 rows run 3xTF32 (hi.hi + hi.lo + lo.hi); bf16
  rows run the float32 query's three bf16 planes. Both keep every score
  within 1e-5 of the float64 score; plain TF32, and the bf16 query alone,
  do not. The three planes rebuild a normal float32 query exactly.
* The grid (`topk_wgmma_partition`, restated from the kernel): every
  (query tile, segment) once. A walk of one CTA's selection as the kernel
  runs it (skip a segment with no live row, admit keys above tau into a
  buffer of BUF, compact and re-admit when it fills, merge the ranges'
  partials) equals the exact top-k of the same scores and never scores a
  dead segment.
* Dispatch, recorded by a stand-in for `scan._launch` on CPU tensors that
  report themselves as CUDA tensors: `topk_wgmma_ready` at its edges,
  which entry K4 and K5 take and what they pass; on the CPU the new
  counters stay 0.
"""

import types

import numpy as np
import pytest
import torch

from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads
from torch_port_setup import clustered_unit, tf32_hi, toward_zero

cap_torch_threads()

TOL_SCORE = 1e-5
SEG = tscan.SEG


# --------------------------------------------------------------------------
# Numerics
# --------------------------------------------------------------------------


def _queries_near(rng, v, n=32):
    q = v[:n] + 0.01 * rng.standard_normal((n, v.shape[1])).astype(np.float32)
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _staged(products, stage: int, step: int, shape):
    """The kernel's sum: per k-stage of `stage` elements, its wgmmas of
    `step` elements (every product in turn) into an accumulator of their
    own, rounded toward zero at each; the stage's sum added into the row's,
    rounded to nearest."""
    dim = products[0][0].shape[1]
    acc = np.zeros(shape, np.float32)
    for s in range(0, dim, stage):
        part = np.zeros(shape, np.float32)
        for kk in range(s, s + stage, step):
            for a, b in products:
                p = (a[:, kk:kk + step].astype(np.float64)
                     @ b[:, kk:kk + step].astype(np.float64).T)
                part = toward_zero(part + p)
        acc = acc + part
    return acc


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16)


def test_3xtf32_scores_within_limit_where_tf32_misses():
    rng = np.random.default_rng(0)
    v = clustered_unit(rng, 512, 1024)
    q = _queries_near(rng, v)
    exact = q.astype(np.float64) @ v.astype(np.float64).T
    qh, ql = (t.numpy() for t in tscan.split_tf32(torch.from_numpy(q)))
    vh = tf32_hi(v)
    # the tensor cores read a float32 operand's top 19 bits: lo truncated
    got = _staged([(vh, qh), (vh, tf32_hi(ql)), (tf32_hi(v - vh), qh)],
                  32, 8, exact.T.shape).T
    assert np.abs(got - exact).max() <= TOL_SCORE
    assert np.abs(tf32_hi(q) @ vh.T - exact).max() > TOL_SCORE
    assert exact.max() > 0.9  # clustered: the top scores sit near 1


def test_bf16_planes_scores_within_limit_where_bf16_query_misses():
    rng = np.random.default_rng(1)
    v = _bf16(clustered_unit(rng, 512, 1024)).float().numpy()  # bf16 rows
    q = _queries_near(rng, v)
    exact = q.astype(np.float64) @ v.astype(np.float64).T
    planes = [p.float().numpy() for p in tscan.split_bf16(torch.from_numpy(q))]
    got = _staged([(v, p) for p in planes], 64, 16, exact.T.shape).T
    assert np.abs(got - exact).max() <= TOL_SCORE
    assert np.abs(planes[0] @ v.T - exact).max() > TOL_SCORE  # bf16(q) alone


def test_bf16_planes_rebuild_the_query_exactly():
    g = torch.Generator().manual_seed(2)
    q = torch.randn(64, 1024, generator=g) * torch.logspace(-3, 3, 1024)
    planes = tscan.split_bf16(q)
    assert all(p.dtype == torch.bfloat16 for p in planes)
    total = sum(p.double() for p in planes)
    assert torch.equal(total, q.double())
    hi, lo = tscan.split_tf32(q)
    assert torch.equal(hi + lo, q)


# --------------------------------------------------------------------------
# The grid, and one CTA's selection walk
# --------------------------------------------------------------------------


@pytest.mark.parametrize("num_q", [1, 64, 65, 256, 2048, 9000])
@pytest.mark.parametrize("cap", [0, 100, 128, 8320, 1_000_000])
@pytest.mark.parametrize("sms", [1, 132])
def test_topk_wgmma_partition(num_q, cap, sms):
    """CTA c takes query tile c % q_tiles and segments [r S // ranges,
    (r + 1) S // ranges) of range r = c // q_tiles: every (query tile,
    segment) exactly once, at most max(sms, q_tiles) CTAs."""
    q_tiles, ranges = tscan.topk_wgmma_partition(num_q, cap, sms)
    assert q_tiles == -(-num_q // 64) and ranges >= 1
    segs = -(-cap // SEG)
    seen = set()
    for c in range(q_tiles * ranges):
        qt, r = c % q_tiles, c // q_tiles
        for s in range(r * segs // ranges, (r + 1) * segs // ranges):
            assert (qt, s) not in seen
            seen.add((qt, s))
    assert len(seen) == q_tiles * segs
    assert q_tiles * ranges <= max(sms, q_tiles)


def _walk(scores, mask, k, buf, ranges):
    """The kernel's selection over (Q, cap) float32 scores with one query
    tile: each range's CTA walks its segments, skips those with no live
    row, admits live keys above tau into a buffer of `buf` (a full buffer
    compacts to its best k and raises tau, then the pending key is tried
    again) and writes its k best; the merge keeps the k best of the ranges'
    partials. Returns ((Q, k) keys, the segments scored)."""
    nq, cap = scores.shape
    segs = -(-cap // SEG)
    hi = tscan._to_sortable(torch.from_numpy(scores).view(torch.int32))
    keys = ((hi.to(torch.int64) << 32)
            | (0xFFFFFFFF - torch.arange(cap))[None, :]).numpy()
    scored, parts = set(), []
    for r in range(ranges):
        tau = np.full(nq, np.iinfo(np.int64).min)
        held = [[] for _ in range(nq)]
        for s in range(r * segs // ranges, (r + 1) * segs // ranges):
            rows = np.arange(s * SEG, min(cap, (s + 1) * SEG))
            if not mask[rows].any():
                continue
            scored.add(s)
            for qi in range(nq):
                for row in rows[mask[rows]]:
                    key = keys[qi, row]
                    while key > tau[qi]:
                        if len(held[qi]) < buf:
                            held[qi].append(key)
                            break
                        held[qi] = sorted(held[qi], reverse=True)[:k]
                        if len(held[qi]) == k:
                            tau[qi] = held[qi][-1]
        parts.append([sorted(h, reverse=True)[:k] for h in held])
    out = np.full((nq, k), np.iinfo(np.int64).min)
    for qi in range(nq):
        best = sorted((x for p in parts for x in p[qi]), reverse=True)[:k]
        out[qi, :len(best)] = best
    return out, scored


@pytest.mark.parametrize("k,buf,ranges", [(1, 2, 3), (5, 8, 1), (14, 16, 4),
                                          (40, 64, 7)])
def test_selection_walk_is_the_exact_top_k_and_skips_dead_segments(
        k, buf, ranges):
    rng = np.random.default_rng(k)
    nq, cap = 3, 20 * SEG + 40  # a ragged last segment
    scores = rng.standard_normal((nq, cap)).astype(np.float32)
    scores[:, 7 * SEG:8 * SEG] = -5.0  # a live segment of negative scores
    scores[1, 300] = scores[1, 301]  # a tie: the lower row first
    mask = rng.random(cap) < 0.3
    dead = [2, 3, 11, 20]
    for s in dead:
        mask[s * SEG:(s + 1) * SEG] = False
    got, scored = _walk(scores, mask, k, buf, ranges)
    assert not scored & set(dead)
    assert scored == {s for s in range(21) if mask[s * SEG:(s + 1) * SEG].any()}
    rows = torch.arange(cap)
    ref = tscan._sel_keys(torch.from_numpy(scores), rows)
    ref = torch.where(torch.from_numpy(mask)[None, :], ref, tscan._I64_MIN)
    ref = torch.topk(ref, k, dim=1).values.numpy()
    assert np.array_equal(got, ref)


# --------------------------------------------------------------------------
# Dispatch
# --------------------------------------------------------------------------


class _AsCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so a wrapper
    takes its kernel branch up to the (recorded) launch."""

    @property
    def is_cuda(self):
        return True


def _as_cuda(t):
    return torch.Tensor._make_subclass(_AsCuda, t)


@pytest.fixture
def recorded(monkeypatch):
    calls = []

    def launch(t, name, entry, *args):
        assert len(args) + 1 == len(_build._SIGNATURES[entry]), entry
        calls.append((entry, args))

    monkeypatch.setattr(tscan, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    return calls


def _rows(dtype, cap, dim, offset=0):
    flat = torch.zeros(cap * dim + 16, dtype=dtype)
    return flat[offset:offset + cap * dim].view(cap, dim)


@pytest.mark.parametrize("dtype,words,ragged,offset", [
    (torch.float32, 96, 98, 1), (torch.bfloat16, 96, 100, 2)])
def test_topk_wgmma_ready_edges(monkeypatch, dtype, words, ragged, offset):
    """float32 / bf16 rows at any width and base (TMA at whole 16 bytes,
    dim % 4 / % 8, on a 16-byte aligned base; else cp.async: `rows_piece`),
    k <= 128, Q >= TOPK_WGMMA_Q_MIN where neither one-query sweep takes
    the operands; float32 queries."""
    q = torch.zeros(64, words)
    v = _rows(dtype, 4 * SEG, words)
    assert tscan.topk_wgmma_ready(q, v, 128)
    assert not tscan.topk_wgmma_ready(q, v, 129)
    assert tscan.rows_piece(v) == 0
    ragged_rows = _rows(dtype, 4 * SEG, ragged)
    assert tscan.topk_wgmma_ready(torch.zeros(64, ragged), ragged_rows, 14)
    assert tscan.rows_piece(ragged_rows) == 8
    off_rows = _rows(dtype, 4 * SEG, words, offset)
    assert tscan.topk_wgmma_ready(q, off_rows, 14)
    assert tscan.rows_piece(off_rows) == 4
    assert not tscan.topk_wgmma_ready(q.to(torch.bfloat16), v, 14)
    assert not tscan.topk_wgmma_ready(q, _rows(torch.int8, 4 * SEG, words), 14)
    # a misaligned query view is fine: the launcher splits it into planes
    qm = torch.zeros(64 * words + 1)[1:].view(64, words)
    assert tscan.topk_wgmma_ready(qm, v, 14)
    # the sweeps take Q up to their limits, the scan every larger batch
    lim = tscan.TOPK_SWEEP_Q_MAX
    assert not tscan.topk_wgmma_ready(q[:lim], v, 14)
    assert tscan.topk_wgmma_ready(q[:lim + 1], v, 14)
    assert not tscan.topk_wgmma_ready(q[:1], off_rows, 14)  # narrow sweep
    # TOPK_WGMMA_Q_MIN's edge, with the sweeps' limits below it
    monkeypatch.setattr(tscan, "TOPK_SWEEP_Q_MAX", 4)
    monkeypatch.setattr(tscan, "TOPK_NARROW_Q_MAX", 4)
    monkeypatch.setattr(tscan, "TOPK_WGMMA_Q_MIN", 8)
    assert tscan.topk_wgmma_ready(q[:8], v, 14)
    assert not tscan.topk_wgmma_ready(q[:7], v, 14)


@pytest.mark.parametrize("dtype,dim,k,nq,took", [
    pytest.param(torch.float32, 96, 14, 64, "scan", id="dtype0-96-14-64-True"),
    pytest.param(torch.bfloat16, 1024, 36, 65, "scan",
                 id="dtype1-1024-36-65-True"),
    # one query: K4's one-query sweep since it has one (the scan before)
    pytest.param(torch.float32, 96, 128, 1, "sweep",
                 id="dtype2-96-128-1-True"),
    pytest.param(torch.float32, 96, 129, 64, "wide",
                 id="dtype3-96-129-64-False"),
    # rows TMA cannot read, which the template served before: the scan,
    # its rows by cp.async (their ids name the rule's answer then)
    pytest.param(torch.float32, 98, 14, 64, "scan",
                 id="dtype4-98-14-64-False"),
    pytest.param(torch.bfloat16, 100, 14, 64, "scan",
                 id="dtype5-100-14-64-False")])
def test_k4_dispatch_by_topk_wgmma_ready(recorded, dtype, dim, k, nq, took):
    """K4 takes the tensor-core scan where `topk_wgmma_ready` holds (the
    rows' producer `rows_piece`, the query planes: hi and lo for float32
    rows, three bf16 for bf16 rows, padded to whole 16 bytes), at any
    width (dim 98 float32 rows by cp.async in 8-byte pieces, dim 100 bf16
    rows in 8-byte pieces: the template served them before), the wide
    kind where `topk_wide_ready` does (k 129), and the one-query sweep
    where `topk_sweep_ready` does (Q = 1); "scan_topk" counts all,
    "scan_topk_wgmma" the scan by TMA, "scan_topk_wgmma_cpasync" the scan
    fed by cp.async, "scan_topk_wide" the wide kind, "scan_topk_sweep" the
    sweep, LAUNCH_SHAPES splits them by (Q, k)."""
    cap = 4 * SEG + 64
    q = torch.randn(nq, dim)
    v = torch.zeros(cap, dim, dtype=dtype)
    mask = torch.ones(cap, dtype=torch.bool)
    tc = took == "scan"
    assert tscan.topk_wgmma_ready(q, v, k) == tc
    assert tscan.topk_wide_ready(q, v, k) == (took == "wide")
    assert tscan.topk_sweep_ready(q, v, k) == (took == "sweep")
    piece = tscan.rows_piece(v)
    assert piece == (0 if dim in (96, 1024) else 8)
    before = dict(tscan.LAUNCHES)
    vals, idx = tscan.fused_topk(*map(_as_cuda, (q, v, mask)), k)
    assert vals.shape == idx.shape == (nq, k)
    (entry, args), = recorded
    kind = 0 if dtype == torch.float32 else 1
    if took == "sweep":
        # kind, q, v, mask, partial, vals, idx, Q, cap, dim, k, chunk
        assert entry == "pv_sweep_topk_f32"
        assert args[0] == kind
        assert args[7:11] == (nq, cap, dim, k)
    else:
        # piece, kind, planes, v, mask, ..., Q, cap, dim, k
        assert args[:2] == (piece, kind)
    if tc:
        assert entry == "pv_scan_topk_wgmma"
        assert args[8:] == (nq, cap, dim, k)
    elif took == "wide":
        assert entry == "pv_scan_topk_wide"
    suffix = tscan._PIECE_KEY[piece]
    for name, hit in (("scan_topk_wgmma" + suffix, tc),
                      ("scan_topk_wide" + suffix, took == "wide"),
                      ("scan_topk_sweep", took == "sweep")):
        assert tscan.LAUNCHES[name] == before[name] + hit
    assert tscan.LAUNCHES["scan_topk"] == before["scan_topk"] + 1
    assert tscan.LAUNCH_SHAPES["scan_topk"][nq, k] >= 1


def test_k4_passes_the_split_planes(recorded, monkeypatch):
    """The launcher's planes are the queries' split, stacked: (2, Q, dim)
    float32 for float32 rows, (3, Q, dim) bf16 for bf16 rows, and the
    partial buffer holds Q x ranges x k keys."""
    seen = []
    real_stack = torch.stack

    def stack(ts):
        out = real_stack(ts)
        seen.append(out)
        return out

    monkeypatch.setattr(tscan.torch, "stack", stack)
    q = torch.randn(70, 96)
    mask = torch.ones(8320, dtype=torch.bool)
    for dtype, planes in ((torch.float32, tscan.split_tf32(q)),
                          (torch.bfloat16, tscan.split_bf16(q))):
        v = torch.zeros(8320, 96, dtype=dtype)
        tscan.fused_topk(*map(_as_cuda, (q, v, mask)), 14)
        assert torch.equal(seen[-1], real_stack(planes))
    assert seen[0].shape == (2, 70, 96) and seen[1].shape == (3, 70, 96)
    # 2 query tiles x 65 segment ranges: one segment each
    assert tscan.topk_wgmma_partition(70, 8320, 132) == (2, 65)


@pytest.mark.parametrize("dim,offset,tc", [(96, 0, True), (1024, 0, True),
                                           (96, 1, False), (104, 0, False)])
def test_k5_dispatch_by_wgmma_i8_ready(recorded, dim, offset, tc):
    """K5 takes the int8 mainloop fed by TMA (`pv_segmax_scan_i8_wgmma`)
    where `wgmma_i8_ready` holds, else the same mainloop fed by cp.async
    (dim 104 on an aligned base) or by the realigning producer (a base 1
    byte off), with the same arguments, never the mma.sync tile;
    "segmax_i8" counts every launch, "segmax_i8_wgmma" / "_cpasync" /
    "_realign" each producer's."""
    cap = 2 * SEG
    q = torch.zeros(17, dim, dtype=torch.int8)
    v = torch.zeros(cap * dim + 16, dtype=torch.int8)[offset:offset + cap * dim]
    v = v.view(cap, dim)
    vs = torch.ones(cap)
    mask = torch.ones(cap, dtype=torch.bool)
    assert tscan.wgmma_i8_ready(q, v) == tc
    before = dict(tscan.LAUNCHES)
    keys = tscan.segmax_scan_i8(*map(_as_cuda, (q, v, vs, mask)))
    assert keys.shape == (17, 2 * cap // SEG)
    (entry, args), = recorded
    kind = "_wgmma" if tc else "_realign" if offset % 4 else "_cpasync"
    assert entry == "pv_segmax_scan_i8" + kind
    assert args[5:] == (17, cap, dim)
    assert tscan.LAUNCHES["segmax_i8"] == before["segmax_i8"] + 1
    for k in ("_wgmma", "_cpasync", "_realign"):
        assert (tscan.LAUNCHES["segmax_i8" + k]
                == before["segmax_i8" + k] + (k == kind))


def test_counters_stay_zero_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    q = torch.nn.functional.normalize(torch.randn(70, 64, generator=g), dim=1)
    v = torch.nn.functional.normalize(torch.randn(3 * SEG, 64, generator=g),
                                      dim=1)
    mask = torch.rand(3 * SEG, generator=g) > 0.5
    tscan.reset_launch_counts()
    for rows in (v, v.to(torch.bfloat16)):
        vals, idx = tscan.fused_topk(q, rows, mask, 14)
        ref = tscan.scan_topk_plain(q, rows, None, mask, 14)
        assert torch.equal(vals, ref[0]) and torch.equal(idx, ref[1])
    q8, _ = tscan.quantize_rows_i8(q)
    v8, vs = tscan.quantize_rows_i8(v)
    keys = tscan.segmax_scan_i8(q8, v8, vs, mask)
    assert torch.equal(keys, tscan.segmax_scan_i8_plain(q8, v8, vs, mask))
    assert tscan.LAUNCHES["scan_topk_wgmma"] == tscan.LAUNCHES["scan_topk"] == 0
    assert tscan.LAUNCHES["segmax_i8_wgmma"] == tscan.LAUNCHES["segmax_i8"] == 0
