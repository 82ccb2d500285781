"""K4's one-query sweep and its narrow kind (csrc/sweep_topk.cu `F32` /
`Bf16F`, `sweep_narrow_kernel<F32 | Bf16F>`) against the plain version,
on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda_topk_sweep.py -q

float32 queries over float32 rows and the bf16 mirror, at every query
tile (Q 1, 2, 3, 4, 5, 8, 9, 16: launched directly past the dispatch's
limits; over bf16 rows, `Bf16F`'s tiles stop at its limit of 4 and the
launcher takes more queries in passes of 4) and k 1 / 14 / 36 / 128; the 16-byte sweep at widths 96 / 1024 /
4096 (the query block at its 64 KB edge), the narrow kind at widths 25,
98, 100, 1019, 1020, 1022 and bases off 16 bytes by whole elements, its
rows' neighbours poisoned with NaN (a row word's bytes that are not the
row's must not meet the query). Scores within 1e-5 of the plain
version's, the same -inf slots, the same ids outside a 1e-4 gap, only
masked-in rows. Each dispatch adds one to its kind's counter and to
"scan_topk", none to another kind's.
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


def _at(x, off_bytes: int, fill=float("nan")):
    """A contiguous copy of x whose base lies `off_bytes` past a 256-byte
    boundary, inside a buffer of `fill` (NaN: the rows' neighbours)."""
    es = x.element_size()
    flat = torch.full((x.numel() + 512 // es,), fill, dtype=x.dtype,
                      device=x.device)
    v = flat[off_bytes // es:off_bytes // es + x.numel()].view(x.shape)
    v.copy_(x)
    assert v.data_ptr() % 256 == off_bytes
    return v


def _case(dev, dtype, cap, dim, nq, seed, off=0):
    g = torch.Generator().manual_seed(seed)
    v = torch.nn.functional.normalize(torch.randn(cap, dim, generator=g), dim=1)
    q = torch.nn.functional.normalize(torch.randn(nq, dim, generator=g), dim=1)
    mask = torch.rand(cap, generator=g) > 0.2
    mask[:300] = False
    return q.to(dev), _at(v.to(dev).to(dtype), off), mask.to(dev)


def _check(got, ref, mask, k):
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
    assert bool((idx[~fin] == 0).all())


def _run(q, rows, mask, k, narrow: bool):
    """The kind through the dispatch where its rule holds (its counter and
    "scan_topk" grow, no other), else launched alone (uncounted)."""
    rule = scan.topk_narrow_ready if narrow else scan.topk_sweep_ready
    key = "scan_topk_narrow" if narrow else "scan_topk_sweep"
    if rule(q, rows, k):
        before = dict(scan.LAUNCHES)
        got = scan.fused_topk(q, rows, mask, k)
        torch.cuda.synchronize()
        grew = {n for n in scan.LAUNCHES if scan.LAUNCHES[n] > before[n]}
        assert grew == {"scan_topk", key}, grew
        return got
    got = scan._topk_sweep_launch(
        q, rows, mask, k, "fused_topk",
        "pv_sweep_topk_f32_narrow" if narrow else "pv_sweep_topk_f32")
    torch.cuda.synchronize()
    return got


DTYPES = [torch.float32, torch.bfloat16]
QS = [1, 2, 3, 4, 5, 8, 9, 16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim", [96, 1024])
@pytest.mark.parametrize("nq", QS)
@pytest.mark.parametrize("k", [1, 14, 36, 128])
def test_sweep(dev, dtype, dim, nq, k):
    q, rows, mask = _case(dev, dtype, 9_000, dim, nq, seed=dim + nq + k)
    assert scan._topk_tma_ready(q, rows)
    got = _run(q, rows, mask, k, narrow=False)
    _check(got, scan.scan_topk_plain(q, rows, None, mask, k + 1), mask, k)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sweep_query_block_edge(dev, dtype):
    """dim 4096: the query block of a 4-query tile is exactly 64 KB (the
    sweep's); at 5 queries the 8-query tile is refused by the rule and, for
    float32 rows, by the launcher; over bf16 rows the launcher, whose
    tiles stop at 4, serves them in passes of 4 and 1."""
    q, rows, mask = _case(dev, dtype, 3_000, 4096, 5, seed=4)
    assert scan.topk_sweep_ready(q[:4], rows, 14) == (
        4 <= scan.TOPK_SWEEP_Q_MAX)
    assert not scan.topk_sweep_ready(q, rows, 14)
    got = _run(q[:4], rows, mask, 14, narrow=False)
    _check(got, scan.scan_topk_plain(q[:4], rows, None, mask, 15), mask, 14)
    if dtype == torch.float32:
        with pytest.raises(RuntimeError):
            scan._topk_sweep_launch(q, rows, mask, 14)
    else:
        got = scan._topk_sweep_launch(q, rows, mask, 14)
        _check(got, scan.scan_topk_plain(q, rows, None, mask, 15), mask, 14)


NARROW = [(torch.float32, 25, 0), (torch.float32, 25, 4),
          (torch.float32, 98, 8), (torch.float32, 1019, 0),
          (torch.float32, 1022, 0), (torch.float32, 1024, 4),
          (torch.bfloat16, 25, 0), (torch.bfloat16, 25, 6),
          (torch.bfloat16, 100, 2), (torch.bfloat16, 1019, 0),
          (torch.bfloat16, 1020, 0), (torch.bfloat16, 1024, 2)]


@pytest.mark.parametrize("dtype,dim,off", NARROW)
@pytest.mark.parametrize("nq", QS)
@pytest.mark.parametrize("k", [1, 14, 128])
def test_narrow(dev, dtype, dim, off, nq, k):
    q, rows, mask = _case(dev, dtype, 9_000, dim, nq, seed=dim + off + nq + k,
                          off=off)
    assert not scan._topk_tma_ready(q, rows)
    es, ptr = rows.element_size(), rows.data_ptr()
    if scan.topk_narrow_bytes(nq, dim, es, ptr) > scan.NARROW_SMEM_BYTES:
        assert not scan.topk_narrow_ready(q, rows, k)
    # the launcher's largest tile: `Bf16F`'s stops at its limit (passes of
    # TOPK_NARROW_Q_MAX queries)
    qt = nq if dtype == torch.float32 else min(nq, scan.TOPK_NARROW_Q_MAX)
    if scan.topk_narrow_bytes(qt, dim, es, ptr) > scan.NARROW_SMEM_BYTES:
        with pytest.raises(RuntimeError):  # the launcher refuses it too
            scan._topk_sweep_launch(q, rows, mask, k, "fused_topk",
                                    "pv_sweep_topk_f32_narrow")
        return
    got = _run(q, rows, mask, k, narrow=True)
    _check(got, scan.scan_topk_plain(q, rows, None, mask, k + 1), mask, k)


def test_misaligned_query_takes_the_narrow_kind(dev):
    """Rows of whole 16 bytes at an aligned base, queries off 16 bytes:
    the narrow kind (one phase copy), which reads the query from any
    4-byte base."""
    q, rows, mask = _case(dev, torch.bfloat16, 9_000, 256, 3, seed=8)
    qm = _at(q, 4, fill=0.0)
    assert not scan.topk_sweep_ready(qm, rows, 14)
    got = _run(qm, rows, mask, 14, narrow=True)
    _check(got, scan.scan_topk_plain(q, rows, None, mask, 15), mask, 14)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim,off", [(1024, 0), (100, 8), (25, 4)])
def test_masks(dev, dtype, dim, off):
    """No live row, one live row, a few rows across ranges, and k past the
    live rows: the slots past them come out -inf / 0."""
    q, rows, mask = _case(dev, dtype, 40_000, dim, 3, seed=dim + off, off=off)
    narrow = not scan._topk_tma_ready(q, rows)
    for live in ([], [77], [5, 900, 901, 20_000, 39_999]):
        keep = torch.zeros_like(mask)
        keep[live] = True
        for k in (1, 14, 128):
            got = _run(q, rows, keep, k, narrow)
            _check(got, scan.scan_topk_plain(q, rows, None, keep, k + 1),
                   keep, k)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dim,off", [(1024, 0), (1019, 0)])
def test_many_ranges_and_compaction(dev, dtype, dim, off):
    """A plane over every SM's two ranges (300,000 rows), with negative
    scores only in one range and a buffer that compacts many times (k
    128 over a plane whose scores rise with the row)."""
    q, rows, mask = _case(dev, dtype, 300_000, dim, 2, seed=11, off=off)
    narrow = not scan._topk_tma_ready(q, rows)
    ramp = torch.linspace(0.0, 1.0, rows.shape[0], device=dev)
    rising = (rows.float() * 0.01 + ramp[:, None] * q[0][None, :]).to(
        rows.dtype)
    for plane in (rows, _at(rising, off)):
        got = _run(q, plane, mask, 128, narrow)
        _check(got, scan.scan_topk_plain(q, plane, None, mask, 129), mask, 128)


def test_counters_by_shape(dev):
    """"scan_topk_sweep" and "scan_topk_narrow" split by (Q, k) in
    LAUNCH_SHAPES."""
    scan.reset_launch_counts()
    q, rows, mask = _case(dev, torch.float32, 3_000, 96, 1, seed=1)
    scan.fused_topk(q, rows, mask, 14)
    q, rows, mask = _case(dev, torch.bfloat16, 3_000, 25, 1, seed=1)
    scan.fused_topk(q, rows, mask, 14)
    torch.cuda.synchronize()
    assert scan.LAUNCH_SHAPES["scan_topk_sweep"] == {(1, 14): 1}
    assert scan.LAUNCH_SHAPES["scan_topk_narrow"] == {(1, 14): 1}
    assert scan.LAUNCHES["scan_topk"] == 2
