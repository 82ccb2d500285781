"""K4's and K6's wide kinds walking the rows in ranges (csrc/radix_select.cuh
`walk_ranges`, `pv_scan_topk_wide` / `pv_scan_topk_i4_wide` with range_rows
below the cap) against the ranged and the whole plane's plain versions, on
a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda_wide_ranges.py -q

TOPK_WIDE_SLAB_BYTES is patched small, so a few thousand rows split into
ranges of 1,024 rows (a tile of min(Q, 64) queries over a range fills the
budget). K4 over float32 and bf16 rows at dims 1024 / 1020 / 1019, K6 over
packed int4 rows at dims 384 / 200 / 100: every rows producer (TMA,
cp.async, the realigning producer / the expanders' reads); Q 1 / 63 / 64 /
65 / 200 (tiles within a range, more than one) and k 129 / 526 / 1024;
range edges inside a run of equal scores; ranges with no live row; k past
a range's live rows. K6 bit for bit both plain versions; K4's scores within
1e-5 of them (summation order), the id set equal wherever the k-th /
(k + 1)-th gap exceeds 1e-4, tied rows in row order.
"""

import pytest
import torch

from picovdb_tpu_torch.ops import scan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.cuda

RANGE = 1024  # rows a range under the patched budget
CAP = 5_000  # five ranges, the last of 904 rows


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _budget(monkeypatch, nq):
    """A budget of one tile of min(Q, 64) queries over RANGE rows."""
    monkeypatch.setattr(scan, "TOPK_WIDE_SLAB_BYTES",
                        min(nq, scan.TOPK_WGMMA_QTILE) * 4 * RANGE)


def _rows(g, cap, dim):
    return torch.nn.functional.normalize(torch.randn(cap, dim, generator=g),
                                         dim=1)


def _f_case(dev, dtype, dim, nq, seed, cap=CAP):
    g = torch.Generator().manual_seed(seed)
    v = _rows(g, cap, dim)
    q = torch.nn.functional.normalize(
        v[torch.randint(0, cap, (nq,), generator=g)]
        + 0.3 * torch.randn(nq, dim, generator=g), dim=1)
    mask = torch.rand(cap, generator=g) > 0.2
    mask[RANGE:2 * RANGE] = False  # a range with no live row
    return q.to(dev), v.to(dtype).to(dev), mask.to(dev)


def _i4_case(dev, dim, nq, seed, cap=CAP):
    g = torch.Generator().manual_seed(seed)
    v = _rows(g, cap, dim)
    q = torch.nn.functional.normalize(
        v[torch.randint(0, cap, (nq,), generator=g)]
        + 0.3 * torch.randn(nq, dim, generator=g), dim=1)
    mask = torch.rand(cap, generator=g) > 0.2
    mask[RANGE:2 * RANGE] = False
    v4, vs = scan.quantize_rows_i4(v.to(dev))
    q8, _ = scan.quantize_rows_i8(q.to(dev))
    return q8, v4, vs, mask.to(dev)


def _agrees(got, ref, mask, k):
    """K4: scores within 1e-5, ids equal outside the gap (ref holds k + 1)."""
    vals, idx = got
    fin = torch.isfinite(vals)
    assert torch.equal(fin, torch.isfinite(ref[0][:, :k]))
    if bool(fin.any()):
        err = float((vals[fin] - ref[0][:, :k][fin]).abs().max())
        assert err <= 1e-5, err
    assert bool(mask[idx[fin].long()].all())
    assert bool((idx[~fin] == 0).all())
    gap = (ref[0][:, k - 1] - ref[0][:, k]).cpu()
    for i in range(vals.shape[0]):
        if gap[i] > 1e-4 or torch.isneginf(ref[0][i, k]):
            assert set(idx[i][fin[i]].tolist()) == set(
                ref[1][i, :k][fin[i]].tolist()), i


def _launched(fn, key, *args):
    """One call of `fn`, counted once under `key` and its `_ranges` key."""
    before = dict(scan.LAUNCHES)
    got = fn(*args)
    rkey = ("scan_topk_i4_wide_ranges" if key.startswith("scan_topk_i4")
            else "scan_topk_wide_ranges")
    assert scan.LAUNCHES[key] == before[key] + 1, key
    assert scan.LAUNCHES[rkey] == before[rkey] + 1, rkey
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [1024, 1020, 1019])
@pytest.mark.parametrize("k", [129, 526, 1024])
@pytest.mark.parametrize("nq", [1, 63, 64, 65, 200])
def test_k4_ranges_against_plain(dev, monkeypatch, dtype, dim, k, nq):
    _budget(monkeypatch, nq)
    q, v, mask = _f_case(dev, dtype, dim, nq, seed=nq + k + dim)
    q_tile, rows, n = scan.wide_walk(nq, CAP)
    assert (rows, n) == (RANGE, 5) and q_tile >= min(nq, 64)
    key = "scan_topk_wide" + scan._PIECE_KEY[scan.rows_piece(v)]
    got = _launched(scan.fused_topk, key, q, v, mask, k)
    ranged = scan.scan_topk_ranges_plain(q, v, None, mask, k + 1, RANGE)
    whole = scan.scan_topk_plain(q, v, None, mask, k + 1)
    torch.cuda.synchronize()
    _agrees(got, ranged, mask, k)
    _agrees(got, whole, mask, k)


@pytest.mark.parametrize("dim", [384, 200, 100])
@pytest.mark.parametrize("k", [129, 526, 1024])
@pytest.mark.parametrize("nq", [1, 63, 64, 65, 200])
def test_k6_ranges_against_plain(dev, monkeypatch, dim, k, nq):
    _budget(monkeypatch, nq)
    q8, v4, vs, mask = _i4_case(dev, dim, nq, seed=nq + k + dim)
    assert scan.wide_walk(nq, CAP)[1:] == (RANGE, 5)
    key = "scan_topk_i4_wide" + scan._PIECE_KEY[scan.rows_piece(v4)]
    got = _launched(scan.fused_topk_i4, key, q8, v4, vs, mask, k)
    ranged = scan.scan_topk_ranges_plain(q8, v4, vs, mask, k, RANGE,
                                         int4=True)
    whole = scan.scan_topk_plain(q8, v4, vs, mask, k, int4=True)
    torch.cuda.synchronize()
    for ref in (ranged, whole):
        assert torch.equal(got[0], ref[0]), "scores differ"
        assert torch.equal(got[1], ref[1]), "rows differ"


def test_producers_are_the_planes(dev):
    """The widths above cover each producer: K4 TMA / cp.async / the
    realigning producer (bf16 at 1019), K6 TMA / 8-byte / realigned
    reads."""
    pieces = set()
    for dim in (1024, 1020, 1019):
        for dt in (torch.float32, torch.bfloat16):
            pieces.add(("k4", scan.rows_piece(torch.empty(
                (8, dim), dtype=dt, device=dev))))
    for dim in (384, 200, 100):
        pieces.add(("k6", scan.rows_piece(torch.empty(
            (8, dim // 2), dtype=torch.int8, device=dev))))
    assert {("k4", 0), ("k4", 4), ("k4", 2), ("k6", 0), ("k6", 4),
            ("k6", 2)} <= pieces, pieces


@pytest.mark.parametrize("kind", ["f32", "bf16", "i4"])
@pytest.mark.parametrize("nq", [1, 64])
def test_equal_scores_across_range_edges(dev, monkeypatch, kind, nq):
    """A run of rows holding the same vector spans the edges at 1,024 and
    2,048 rows, more of them than k: the best k are the run's lowest live
    rows in row order, across the edges as within a range."""
    k = 526
    _budget(monkeypatch, nq)
    if kind == "i4":
        q8, v4, vs, mask = _i4_case(dev, 384, nq, seed=11)
        run = torch.arange(900, 2_300, device=dev)
        v4[run] = v4[run[0]].clone()
        vs[run] = vs[run[0]].clone()
        mask[run] = True
        mask[run[::7]] = False
        q8[:] = scan.quantize_rows_i8(
            (scan.unpack_i4(v4[run[:1]]).float() * vs[run[:1], None])
            .expand(nq, -1).contiguous())[0]
        got = _launched(scan.fused_topk_i4, "scan_topk_i4_wide", q8, v4, vs,
                        mask, k)
        ref = scan.scan_topk_plain(q8, v4, vs, mask, k, int4=True)
    else:
        dt = torch.float32 if kind == "f32" else torch.bfloat16
        q, v, mask = _f_case(dev, dt, 1024, nq, seed=12)
        run = torch.arange(900, 2_300, device=dev)
        v[run] = v[run[0]].clone()
        mask[run] = True
        mask[run[::7]] = False
        q[:] = v[run[0]].float()
        got = _launched(scan.fused_topk, "scan_topk_wide", q, v, mask, k)
        ref = scan.scan_topk_plain(q, v, None, mask, k)
    torch.cuda.synchronize()
    want = run[mask[run]][:k].to(torch.int32)
    for i in range(nq):
        assert torch.equal(got[1][i], want), i
        assert bool((got[0][i] == got[0][i, 0]).all())
    if kind == "i4":  # K6 bit for bit; K4 within the summation order's 1e-5
        assert torch.equal(got[0], ref[0])
    else:
        assert float((got[0] - ref[0]).abs().max()) <= 1e-5


@pytest.mark.parametrize("kind", ["f32", "i4"])
def test_k_past_a_range_and_sparse_ranges(dev, monkeypatch, kind):
    """A few live rows a range (fewer than k in each, none in some): every
    live row comes out, then -inf / 0."""
    nq, k = 16, 1024
    _budget(monkeypatch, nq)
    g = torch.Generator().manual_seed(5)
    live = torch.randperm(CAP, generator=g)[:700].to(dev)
    if kind == "i4":
        q8, v4, vs, mask = _i4_case(dev, 200, nq, seed=6)
        mask[:] = False
        mask[live] = True
        mask[3 * RANGE:4 * RANGE] = False
        got = _launched(scan.fused_topk_i4, "scan_topk_i4_wide_cpasync", q8,
                        v4, vs, mask, k)
        ref = scan.scan_topk_plain(q8, v4, vs, mask, k, int4=True)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    else:
        q, v, mask = _f_case(dev, torch.float32, 96, nq, seed=6)
        mask[:] = False
        mask[live] = True
        mask[3 * RANGE:4 * RANGE] = False
        got = _launched(scan.fused_topk, "scan_topk_wide", q, v, mask, k)
        ref = scan.scan_topk_plain(q, v, None, mask, k + 1)
        torch.cuda.synchronize()
        _agrees(got, ref, mask, k)
    n = int(mask.sum())
    assert n < k
    assert bool(torch.isfinite(got[0][:, :n]).all())
    assert bool(torch.isneginf(got[0][:, n:]).all())
    assert not bool(got[1][:, n:].any())


def test_one_range_with_narrowed_tiles(dev, monkeypatch):
    """Ranges given at the cap (`range_rows`): the walk of one plane in
    query tiles of 16 over 200 queries, as before the range walk; and the
    same call in ranges of 1,024 rows agree with the plain version."""
    q8, v4, vs, mask = _i4_case(dev, 384, 200, seed=8)
    ld = -(-CAP // scan.SEG) * scan.SEG
    monkeypatch.setattr(scan, "TOPK_WIDE_SLAB_BYTES", 16 * 4 * ld)
    assert scan.wide_walk(200, CAP, ld) == (16, ld, 1)
    ref = scan.scan_topk_plain(q8, v4, vs, mask, 526, int4=True)
    for rows in (ld, RANGE):
        got = scan._i4_wide_launch(q8, v4, vs, mask, 526, range_rows=rows)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    q, v, fmask = _f_case(dev, torch.bfloat16, 1019, 200, seed=9)
    fref = scan.scan_topk_plain(q, v, None, fmask, 527)
    for rows in (ld, RANGE):
        got = scan._topk_wide_launch(q, v, fmask, 526, range_rows=rows)
        torch.cuda.synchronize()
        _agrees(got, fref, fmask, 526)
