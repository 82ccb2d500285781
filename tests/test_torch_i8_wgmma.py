"""K3's tensor-core scan (csrc/scan_topk_wgmma.cu, the int8 kind `Int8R`),
checked on the CPU.

* The selection: a numpy emulation of the kernel's walk. CTAs take
  `i8_wgmma_partition`'s (query tile, segment range) pairs at the kernel's
  query tile (64, 32 past k = 128) and buffer size; each skips segments
  with no live row, scores a segment as float32(int32 sum) * row scale,
  admits a live row's key where its score reaches the query's running
  k-th score and the key beats tau, and when a buffer overflows compacts
  every buffer of the tile to its best k and re-admits the pending keys.
  The ranges' partials merge to the k best. Bit for bit `scan_topk_plain`,
  with live rows of scale <= 0 and equal rows across range boundaries.
* The ready rule's edges (Q at the sweep's limit +- 1, k 128 / 129 / 384 /
  385, dim % 16, misaligned bases) and K3's dispatch, recorded on CPU
  tensors posing as CUDA tensors against `_build._SIGNATURES`; on the CPU
  the counters stay 0.
"""

import types

import numpy as np
import pytest
import torch

from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

SEG = tscan.SEG


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# The selection walk
# --------------------------------------------------------------------------


def _buf(k):
    """The kernel's buffer of keys a query for k (pv_scan_topk_i8_wgmma)."""
    return 64 if k <= 32 else 128 if k <= 64 else 256 if k <= 128 else 512


def _qtile(k):
    """The kernel's queries a CTA for k (pv_scan_topk_i8_wgmma)."""
    return 64 if k <= 128 else 32


def _keys(q8, v8, vs):
    """(Q, cap) selection keys as the kernel builds them: the exact int32
    sum converted to float32, times the row's scale in float32, its
    order-preserving bits over the complemented row."""
    s = (q8.astype(np.int64) @ v8.astype(np.int64).T).astype(np.float32)
    s = (s * vs[None, :]).astype(np.float32)
    bits = s.view(np.int32).astype(np.int64)
    hi = np.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    rows = np.arange(v8.shape[0], dtype=np.int64)
    return s, (hi << 32) | (0xFFFFFFFF - rows)[None, :]


def _emulate(q8, v8, vs, mask, k, sms):
    """The kernel's selection and merge. Returns ((Q, k) float32 scores,
    (Q, k) int32 rows, the segments scored, the compactions run)."""
    nq, cap = q8.shape[0], v8.shape[0]
    n, buf = _qtile(k), _buf(k)
    q_tiles, ranges = tscan.i8_wgmma_partition(nq, cap, sms, k)
    segs = -(-cap // SEG)
    score, keys = _keys(q8, v8, vs)
    empty = np.iinfo(np.int64).min
    partial = np.full((nq, ranges, k), empty)
    scored, compactions = set(), 0
    for c in range(q_tiles * ranges):
        qt, r = c % q_tiles, c // q_tiles
        qs = [q for q in range(qt * n, (qt + 1) * n) if q < nq]
        held = {q: [] for q in qs}
        tau = {q: empty for q in qs}
        ts = {q: -np.inf for q in qs}

        def compact():
            for q in qs:
                held[q] = sorted(held[q], reverse=True)[:k]
                if len(held[q]) == k:
                    tau[q] = held[q][-1]
                    ts[q] = score[q, int(0xFFFFFFFF - (tau[q] & 0xFFFFFFFF))]

        for s in range(r * segs // ranges, (r + 1) * segs // ranges):
            rows = np.arange(s * SEG, min(cap, (s + 1) * SEG))
            live = rows[mask[rows]]
            if live.size == 0:
                continue
            scored.add(s)
            pend = {q: list(live) for q in qs}
            while True:
                for q in qs:
                    keep = []
                    for row in pend[q]:
                        if score[q, row] >= ts[q] and keys[q, row] > tau[q]:
                            if len(held[q]) < buf:
                                held[q].append(keys[q, row])
                            else:
                                keep.append(row)
                    pend[q] = keep
                if not any(pend.values()):
                    break
                compact()
                compactions += 1
        compact()
        for q in qs:
            partial[q, r, :len(held[q])] = held[q]
    top = np.sort(partial.reshape(nq, -1), axis=1)[:, ::-1][:, :k]
    hi = (top >> 32).astype(np.int32)
    vals = np.where(hi >= 0, hi, hi ^ 0x7FFFFFFF).view(np.float32)
    rows = (0xFFFFFFFF - (top & 0xFFFFFFFF)).astype(np.int32)
    vals = np.where(top == empty, -np.inf, vals).astype(np.float32)
    return vals, np.where(top == empty, 0, rows), scored, compactions


def _store(rng, cap, dim, nq):
    """int8 rows and queries with equal rows across range boundaries (row
    1, every query 0's best, copied to 5, 130, 2000 and 4000 with its
    scale), scales 0 and < 0 on live rows, a ~80 % mask and three dead
    segments."""
    v8 = rng.integers(-127, 128, (cap, dim)).astype(np.int8)
    q8 = rng.integers(-127, 128, (nq, dim)).astype(np.int8)
    vs = rng.uniform(1e-3, 1e-2, cap).astype(np.float32)
    v8[1] = np.where(rng.random(dim) < 0.5, 127, -127)
    vs[1] = 0.02
    q8[0] = v8[1]
    copies = [r for r in (1, 5, 130, 2000, 4000) if r < cap]
    v8[copies], vs[copies] = v8[1], vs[1]
    vs[600:620] = 0.0
    vs[620:640] = -vs[620:640]
    mask = rng.random(cap) < 0.8
    mask[copies] = True
    mask[600:640] = True
    for s in (3, 9, 17):
        mask[s * SEG:(s + 1) * SEG] = False
    return q8, v8, vs, mask


@pytest.mark.parametrize("k,nq,sms", [(1, 17, 6), (14, 70, 8), (40, 33, 5),
                                      (129, 40, 8), (142, 17, 3),
                                      (384, 20, 4)])
def test_selection_walk_equals_the_plain_version(k, nq, sms):
    rng = np.random.default_rng(k)
    cap, dim = 40 * SEG + 37, 32  # a ragged last segment
    q8, v8, vs, mask = _store(rng, cap, dim, nq)
    vals, idx, scored, compactions = _emulate(q8, v8, vs, mask, k, sms)
    ref_v, ref_i = tscan.scan_topk_plain(_t(q8), _t(v8), _t(vs), _t(mask), k)
    np.testing.assert_array_equal(vals, ref_v.numpy())
    np.testing.assert_array_equal(idx, ref_i.numpy())
    assert scored == {s for s in range(41) if mask[s * SEG:(s + 1) * SEG].any()}
    assert not scored & {3, 9, 17}
    assert compactions > 0  # the buffers overflowed and were compacted
    if k >= 5:  # equal scores on rows of different ranges: lower row first
        assert idx[0, :5].tolist() == [1, 5, 130, 2000, 4000]
    _, ranges = tscan.i8_wgmma_partition(nq, cap, sms, k)
    assert ranges > 1


def test_selection_walk_ranks_nonpositive_rows_and_pads():
    """Only rows of scale 0 and < 0 live, fewer than k: every one ranked
    as the plain version ranks it (a negative scale times a negative sum
    ranks high), the rest -inf / row 0."""
    rng = np.random.default_rng(9)
    cap, dim = 6 * SEG, 32
    q8, v8, vs, _ = _store(rng, cap, dim, 20)
    mask = np.zeros(cap, dtype=bool)
    mask[600:640] = True
    vals, idx, scored, _ = _emulate(q8, v8, vs, mask, 142, 4)
    ref_v, ref_i = tscan.scan_topk_plain(_t(q8), _t(v8), _t(vs), _t(mask), 142)
    np.testing.assert_array_equal(vals, ref_v.numpy())
    np.testing.assert_array_equal(idx, ref_i.numpy())
    assert np.isfinite(vals[:, :40]).all() and np.isneginf(vals[:, 40:]).all()
    assert (idx[:, 40:] == 0).all() and (vals[:, 20:40] == 0).any()
    assert scored == {4}


@pytest.mark.parametrize("num_q,k", [(17, 14), (64, 142), (2048, 384),
                                     (9000, 1)])
def test_i8_wgmma_partition(num_q, k):
    """The query tile is 64 up to k = 128, 32 past it; CTAs cover every
    (query tile, segment) once, at most max(sms, q_tiles) of them."""
    cap, sms = 1_000_000, 132
    q_tiles, ranges = tscan.i8_wgmma_partition(num_q, cap, sms, k)
    assert q_tiles == -(-num_q // _qtile(k))
    assert ranges == max(1, min(-(-cap // SEG), sms // q_tiles))
    assert q_tiles * ranges <= max(sms, q_tiles)


# --------------------------------------------------------------------------
# The ready rule and the dispatch
# --------------------------------------------------------------------------


def _operands(dim, nq, offset=0, qoffset=0, rows=512):
    qf = torch.zeros(nq * dim + 16, dtype=torch.int8)
    vf = torch.zeros(rows * dim + 16, dtype=torch.int8)
    return (qf[qoffset:qoffset + nq * dim].view(nq, dim),
            vf[offset:offset + rows * dim].view(rows, dim))


def test_i8_wgmma_ready_edges():
    lim = tscan.I8_SWEEP_Q_MAX
    q, v = _operands(96, lim + 1)
    for k in (1, 128, 129, 142, 384):
        assert tscan.i8_wgmma_ready(q, v, k)
    assert not tscan.i8_wgmma_ready(q, v, 385)
    # Q at the sweep's limit - 1, the limit, + 1: the sweep or the scan
    for nq in (lim - 1, lim, lim + 1):
        q, v = _operands(96, nq)
        assert tscan.i8_wgmma_ready(q, v, 14) == (nq > lim)
        assert tscan.i8_sweep_ready(q, v, 14) == (nq <= lim)
    # any width and base: the rows by the producer `rows_piece` names (TMA
    # at whole 16 bytes on a 16-byte aligned base, else cp.async), the
    # queries padded by the library call where TMA cannot read them
    for dim, off, qoff, piece in ((104, 0, 0, 8), (112, 0, 0, 0),
                                  (96, 8, 0, 8), (96, 0, 4, 0)):
        q, v = _operands(dim, 64, offset=off, qoffset=qoff)
        assert tscan.i8_wgmma_ready(q, v, 14)
        assert tscan.rows_piece(v) == piece
    # only the int8 kind: float queries or rows never take it here
    q, v = _operands(96, 64)
    assert not tscan.topk_wgmma_ready(q, v, 14)


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


@pytest.mark.parametrize("nq,k,dim,offset,want", [
    (17, 14, 96, 0, "scan"), (64, 142, 1024, 0, "scan"),
    (2048, 384, 96, 0, "scan"), (64, 385, 96, 0, "template"),
    # rows TMA cannot read, which the template served before: the scan over
    # such rows (their ids name the kernel they took then)
    pytest.param(64, 14, 104, 0, "rows", id="64-14-104-0-template"),
    pytest.param(64, 14, 96, 1, "rows", id="64-14-96-1-template"),
    (4, 142, 96, 0, "sweep"), (5, 142, 96, 0, "scan"),
    (16, 142, 96, 0, "scan"), (64, 128, 1024, 0, "scan"),
    (2048, 128, 96, 0, "scan"), (4, 128, 96, 0, "sweep"),
    (5, 128, 96, 0, "scan"), (64, 142, 1024, 0, "wide"),
    (2048, 384, 96, 0, "wide"), (64, 385, 96, 0, "wide"),
    (4, 142, 96, 0, "wide"), (5, 142, 96, 0, "wide"),
    (16, 142, 96, 0, "wide")])
def test_k3_dispatch_by_i8_wgmma_ready(recorded, monkeypatch, nq, k, dim,
                                       offset, want):
    """K3 takes its wide kind past k 128 where `i8_wide_ready` holds (the
    "wide" cases: 8320 rows, one tile holds the batch's 64 queries).
    Where it cannot serve (the other cases: one query's slab over the
    budget) K3 takes the sweep at Q <= I8_SWEEP_Q_MAX, the tensor-core
    scan's int8 kind past it (`pv_scan_topk_i8_wgmma` with the rows'
    producer, q, v, vscale, mask, a scratch of the padded queries' room and
    Q x ranges x k keys, vals, idx, Q, cap, dim, k), also over rows TMA
    cannot read (dim 104: cp.async, a base 1 byte off: the realigning
    producer), the template (`pv_scan_topk` kind 2) past k 384;
    "scan_topk_i8" counts all, "scan_topk_i8_wgmma" the scan by TMA, its
    "_cpasync" / "_realign" keys the others, LAUNCH_SHAPES by (Q, k).
    tests/test_torch_i8_wide.py holds the wide kind's share by tile."""
    cap = 8320
    if want != "wide":
        monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", 4 * cap - 1)
    q, v = _operands(dim, nq, offset, rows=cap)
    vs, mask = torch.ones(cap), torch.ones(cap, dtype=torch.bool)
    sizes = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        if kw.get("dtype") == torch.uint8:
            sizes.append(out.numel())
        return out

    monkeypatch.setattr(tscan.torch, "empty", empty)
    before = dict(tscan.LAUNCHES)
    assert tscan.i8_wide_ready(q, v, k) == (want == "wide")
    vals, idx = tscan.fused_topk_i8(*map(_as_cuda, (q, v, vs, mask)), k)
    assert vals.shape == idx.shape == (nq, k)
    (entry, args), = recorded
    assert entry == {"scan": "pv_scan_topk_i8_wgmma",
                     "wide": "pv_scan_topk_i8_wide",
                     "template": "pv_scan_topk",
                     "rows": "pv_scan_topk_i8_wgmma",
                     "sweep": "pv_sweep_topk_i8"}[want]
    if want in ("scan", "rows"):  # piece, q, v, vscale, mask, scratch, ...
        piece = tscan.rows_piece(v)
        assert (piece == 0) == (want == "scan")
        _, ranges = tscan.i8_wgmma_partition(nq, cap, 132, k)
        assert args[:5] == (piece, q.data_ptr(), v.data_ptr(), vs.data_ptr(),
                            mask.data_ptr())
        assert args[8:] == (nq, cap, dim, k)
        # room for the padded queries, then Q x ranges x k keys
        assert sizes == [tscan._up256(nq * -(-dim // 16) * 16)
                         + nq * ranges * k * 8]
        key = "scan_topk_i8_wgmma" + tscan._PIECE_KEY[piece]
        assert tscan.LAUNCHES[key] == before[key] + 1
        assert tscan.LAUNCH_SHAPES[key][nq, k] >= 1
    tc = want == "scan"
    assert tscan.LAUNCHES["scan_topk_i8"] == before["scan_topk_i8"] + 1
    assert (tscan.LAUNCHES["scan_topk_i8_wgmma"]
            == before["scan_topk_i8_wgmma"] + tc)
    assert (tscan.LAUNCHES["scan_topk_i8_sweep"]
            == before["scan_topk_i8_sweep"] + (want == "sweep"))
    assert tscan.LAUNCH_SHAPES["scan_topk_i8"][nq, k] >= 1


def test_counters_stay_zero_on_the_cpu():
    rng = np.random.default_rng(0)
    q8, v8, vs, mask = _store(rng, 8 * SEG, 32, 40)
    tscan.reset_launch_counts()
    got = tscan.fused_topk_i8(_t(q8), _t(v8), _t(vs), _t(mask), 142)
    ref = tscan.scan_topk_plain(_t(q8), _t(v8), _t(vs), _t(mask), 142)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert tscan.LAUNCHES["scan_topk_i8_wgmma"] == 0
    assert tscan.LAUNCHES["scan_topk_i8"] == 0
