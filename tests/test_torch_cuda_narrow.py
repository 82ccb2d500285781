"""K3's and K4's kinds over rows that TMA cannot read, against their plain
versions, on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda_narrow.py -q

K3 (int8 rows and their scales): the sweep's narrow kind at Q 1 / 2 / 4
(launched directly past k 128, where the wide kind takes the dispatch),
the tensor-core scan fed by cp.async or by the realigning producer at Q
5 / 16 / 64 (k_sel 14, 142, 384, launched directly where the wide kind
or the narrow sweep takes the dispatch), and the wide kind over the same rows at
k_sel 142 / 432 / 1024; widths 25, 50, 100, 300, 1018, 1019, 1020 and
bases off 16 bytes by 1, 2, 4 and 8; bit for bit the plain version
(exact int32 sums, one conversion and one multiply, ties to the lower
row). K4 (float32 queries over float32 or bf16 rows): the tensor-core scan
(k_sel 14, 36, 100; launched directly where the narrow sweep takes the
dispatch) and the wide kind (k_sel 200, 1024) at widths 25, 98,
100, 1019, 1020, 1022 and bases off by one element; scores within 1e-5
of the plain version's, the same ids outside a 1e-4 gap. Each dispatch
adds one to the kind's counter and none to the template's.
"""

import pytest
import torch

from picovdb_tpu_torch.ops import scan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.cuda

TOL_SCORE = 1e-5  # float32 scores: summation order only
TOL_GAP = 1e-4  # ids must agree where the k-th / (k + 1)-th gap exceeds it


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _at(x, off_bytes: int):
    """A contiguous copy of x whose base lies `off_bytes` past a 256-byte
    boundary (a view into a larger buffer)."""
    es = x.element_size()
    assert off_bytes % es == 0
    flat = torch.zeros(x.numel() + 256 // es, dtype=x.dtype, device=x.device)
    v = flat[off_bytes // es:off_bytes // es + x.numel()].view(x.shape)
    v.copy_(x)
    assert v.data_ptr() % 256 == off_bytes
    return v


def _rows(dev, cap, dim, nq, seed):
    g = torch.Generator().manual_seed(seed)
    v = torch.nn.functional.normalize(torch.randn(cap, dim, generator=g), dim=1)
    q = torch.nn.functional.normalize(torch.randn(nq, dim, generator=g), dim=1)
    mask = torch.rand(cap, generator=g) > 0.2
    mask[:300] = False
    return v.to(dev), q.to(dev), mask.to(dev)


def _i8(dev, cap, dim, nq, off, seed):
    v, q, mask = _rows(dev, cap, dim, nq, seed)
    v8, vs = scan.quantize_rows_i8(v)
    q8, _ = scan.quantize_rows_i8(q)
    return q8, _at(v8, off), vs, mask


def _launched(key, fn):
    before = dict(scan.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    grew = {n for n in scan.LAUNCHES if scan.LAUNCHES[n] > before[n]}
    return out, grew


def _bit_for_bit(got, ref):
    assert torch.equal(got[0], ref[0]), "scores differ"
    assert torch.equal(got[1], ref[1]), "rows differ"


K3_DIMS = [25, 50, 100, 300, 1018, 1019, 1020]
K3_OFFS = [0, 1, 2, 4, 8]


@pytest.mark.parametrize("dim", K3_DIMS)
@pytest.mark.parametrize("off", K3_OFFS)
@pytest.mark.parametrize("nq,k", [(1, 14), (2, 142), (4, 384), (4, 14)])
def test_k3_narrow_sweep(dev, dim, off, nq, k):
    q8, v8, vs, mask = _i8(dev, 9_000, dim, nq, off, seed=dim + off + nq)
    assert scan.i8_narrow_ready(q8, v8, k)
    if k <= scan.I8_WIDE_K_MIN:
        got, grew = _launched("scan_topk_i8_narrow",
                              lambda: scan.fused_topk_i8(q8, v8, vs, mask, k))
        assert grew == {"scan_topk_i8", "scan_topk_i8_narrow"}, grew
    else:  # the wide kind takes the dispatch here: the sweep launched alone
        got = scan._sweep_launch(q8, v8, vs, mask, k, "fused_topk_i8",
                                 "pv_sweep_topk_i8_narrow")
        torch.cuda.synchronize()
    _bit_for_bit(got, scan.scan_topk_plain(q8, v8, vs, mask, k))


@pytest.mark.parametrize("dim", K3_DIMS)
@pytest.mark.parametrize("off", K3_OFFS)
@pytest.mark.parametrize("nq,k", [(5, 14), (16, 64), (64, 128), (64, 142),
                                  (17, 384)])
def test_k3_scan_rows(dev, dim, off, nq, k):
    q8, v8, vs, mask = _i8(dev, 9_000, dim, nq, off, seed=3 * dim + off + nq)
    piece = scan.rows_piece(v8)
    if piece == 0:
        pytest.skip("rows TMA reads")
    ref = scan.scan_topk_plain(q8, v8, vs, mask, k)
    if (k <= scan.TOPK_WGMMA_K_MAX and scan.i8_wgmma_ready(q8, v8, k)
            and not scan.i8_wide_ready(q8, v8, k)):
        key = "scan_topk_i8_wgmma" + scan._PIECE_KEY[piece]
        got, grew = _launched(key, lambda: scan.fused_topk_i8(q8, v8, vs,
                                                              mask, k))
        assert grew == {"scan_topk_i8", key}, grew
    else:  # the wide kind or the narrow sweep takes the dispatch here: the
        # scan launched alone
        got = scan._i8_wgmma_launch(q8, v8, vs, mask, k)
        torch.cuda.synchronize()
    _bit_for_bit(got, ref)


@pytest.mark.parametrize("dim", [25, 100, 300, 1019, 1020])
@pytest.mark.parametrize("off", [0, 1, 2, 4, 8])
@pytest.mark.parametrize("nq,k", [(1, 142), (16, 432), (64, 1024),
                                  (3, 142)])
def test_k3_wide_rows(dev, dim, off, nq, k):
    q8, v8, vs, mask = _i8(dev, 9_000, dim, nq, off, seed=5 * dim + off + k)
    piece = scan.rows_piece(v8)
    if piece == 0:
        pytest.skip("rows TMA reads")
    assert scan.i8_wide_ready(q8, v8, k)
    key = "scan_topk_i8_wide" + scan._PIECE_KEY[piece]
    got, grew = _launched(key, lambda: scan.fused_topk_i8(q8, v8, vs, mask, k))
    assert grew == {"scan_topk_i8", key}, grew
    _bit_for_bit(got, scan.scan_topk_plain(q8, v8, vs, mask, k))


def test_k3_misaligned_queries(dev):
    """Queries off a 16-byte boundary over rows TMA reads: the narrow
    sweep at Q <= 4, the scan by TMA past it on the library call's padded
    copy of the queries (counted as the TMA kind), and the wide kind
    likewise."""
    _, v8, vs, mask = _i8(dev, 9_000, 256, 1, 0, seed=7)
    for nq, k, key in ((3, 14, "scan_topk_i8_narrow"),
                       (40, 14, "scan_topk_i8_wgmma"),
                       (40, 432, "scan_topk_i8_wide")):
        q = scan.quantize_rows_i8(_rows(dev, 8, 256, nq, nq)[1])[0]
        q8 = _at(q, 1)
        got, grew = _launched(key, lambda: scan.fused_topk_i8(q8, v8, vs,
                                                              mask, k))
        assert grew == {"scan_topk_i8", key}, grew
        _bit_for_bit(got, scan.scan_topk_plain(q8, v8, vs, mask, k))


def _k4_check(got, ref, mask, k):
    vals, idx = got
    fin = torch.isfinite(vals)
    assert torch.equal(fin, torch.isfinite(ref[0][:, :k]))
    if bool(fin.any()):
        err = float((vals[fin] - ref[0][:, :k][fin]).abs().max())
        assert err <= TOL_SCORE, err
    gap = ref[0][:, k - 1] - ref[0][:, k]
    sure = (gap > TOL_GAP) | ~torch.isfinite(ref[0][:, k])
    for i in torch.nonzero(sure).flatten().tolist():
        a = set(idx[i][fin[i]].tolist())
        b = set(ref[1][i, :k][torch.isfinite(ref[0][i, :k])].tolist())
        assert a == b, f"query {i}"
    assert bool(mask[idx[fin].long()].all())


K4_ROWS = [(torch.float32, 1019, 0), (torch.float32, 1022, 0),
           (torch.float32, 98, 4), (torch.float32, 1020, 4),
           (torch.bfloat16, 1019, 0), (torch.bfloat16, 1020, 0),
           (torch.bfloat16, 100, 2), (torch.bfloat16, 25, 0),
           (torch.bfloat16, 1024, 2), (torch.bfloat16, 96, 4)]


@pytest.mark.parametrize("dtype,dim,off", K4_ROWS)
@pytest.mark.parametrize("nq,k", [(1, 14), (16, 36), (64, 100), (64, 14)])
def test_k4_scan_rows(dev, dtype, dim, off, nq, k):
    v, q, mask = _rows(dev, 9_000, dim, nq, seed=dim + nq + k)
    rows = _at(v.to(dtype), off)
    piece = scan.rows_piece(rows)
    assert piece != 0
    ref = scan.scan_topk_plain(q, rows, None, mask, k + 1)
    key = "scan_topk_wgmma" + scan._PIECE_KEY[piece]
    if scan.topk_narrow_ready(q, rows, k):
        # the narrow sweep takes the dispatch at small Q (held to the plain
        # version in tests/test_torch_cuda_topk_sweep.py): the scan alone
        got, grew = _launched("scan_topk_narrow",
                              lambda: scan.fused_topk(q, rows, mask, k))
        assert grew == {"scan_topk", "scan_topk_narrow"}, grew
        _k4_check(got, ref, mask, k)
        got = scan._topk_wgmma_launch(q, rows, mask, k)
        torch.cuda.synchronize()
    else:
        got, grew = _launched(key, lambda: scan.fused_topk(q, rows, mask, k))
        assert grew == {"scan_topk", key}, grew
    _k4_check(got, ref, mask, k)


@pytest.mark.parametrize("dtype,dim,off", K4_ROWS)
@pytest.mark.parametrize("nq,k", [(1, 200), (16, 1024), (64, 204)])
def test_k4_wide_rows(dev, dtype, dim, off, nq, k):
    v, q, mask = _rows(dev, 9_000, dim, nq, seed=2 * dim + nq + k)
    rows = _at(v.to(dtype), off)
    piece = scan.rows_piece(rows)
    key = "scan_topk_wide" + scan._PIECE_KEY[piece]
    got, grew = _launched(key, lambda: scan.fused_topk(q, rows, mask, k))
    assert grew == {"scan_topk", key}, grew
    _k4_check(got, scan.scan_topk_plain(q, rows, None, mask, k + 1), mask, k)


def test_all_masked_and_tiny(dev):
    """No live row, and fewer rows than a realigning class count."""
    for cap in (5_000, 7):
        q8, v8, vs, mask = _i8(dev, cap, 100, 16, 1, seed=cap)
        none = torch.zeros_like(mask)
        for k in (14, 142):
            got = scan.fused_topk_i8(q8, v8, vs, none, k)
            torch.cuda.synchronize()
            _bit_for_bit(got, scan.scan_topk_plain(q8, v8, vs, none, k))
        live = torch.ones_like(mask)
        got = scan.fused_topk_i8(q8, v8, vs, live, 14)
        torch.cuda.synchronize()
        _bit_for_bit(got, scan.scan_topk_plain(q8, v8, vs, live, 14))
        v, q, m = _rows(dev, cap, 1019, 16, seed=cap)
        m = torch.ones_like(m)
        rows = v.to(torch.bfloat16)
        for k in (14, 200):
            got = scan.fused_topk(q, rows, m, k)
            torch.cuda.synchronize()
            _k4_check(got, scan.scan_topk_plain(q, rows, None, m, k + 1), m,
                      k)
