"""K6 at every even width and base against its plain version, on a card:
the sweep's narrow int4 kind (`pv_sweep_topk_i4_narrow`), and the
tensor-core scan and the wide kind over rows TMA cannot read (the
expanders' 8- / 4-byte and realigning reads, `rows_piece` 8 / 4 / 2) or
whose last k-stage is partial (TMA, dim % 128 != 0).

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda_i4_narrow.py -q

Packed rows at glove-100 / glove-200 / gist-960's widths and others, at
bases off 16 bytes (the packed plane copied into a larger buffer at an
offset, its neighbours' bytes nonzero), caps off a multiple of 256, ties
(rows 5, 6 and 130 copies of row 1), a masked block, every launch counted
on the kind the ready rules name and bit for bit the plain version (exact
int32 sums, one conversion and one multiply, ties to the lower row).
"""

import pytest
import torch

from picovdb_tpu_torch.ops import scan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _store(dev, cap, dim, nq, off=0, seed=0, negative=False):
    """Packed int4 rows at byte `off` of a buffer whose other bytes are
    0xFF (both nibbles 15), with ties and a masked block, and int8
    queries. `negative`: every score <= 0, so a row past cap read as zeros
    would beat the rest if it were not skipped by index."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randn(cap, dim, generator=g)
    q = torch.randn(nq, dim, generator=g)
    if negative:
        v, q = v.abs(), -q.abs()
    v[5], v[6] = v[1], v[1]
    if cap > 130:
        v[130] = v[1]
    v = torch.nn.functional.normalize(v, dim=1)
    mask = torch.rand(cap, generator=g) > 0.2
    mask[1] = mask[5] = True
    mask[256:512] = False
    q8, _ = scan.quantize_rows_i8(torch.nn.functional.normalize(q, dim=1))
    v4, vs = scan.quantize_rows_i4(v)
    rb = dim // 2
    flat = torch.full((off + cap * rb + 64,), -1, dtype=torch.int8)
    flat[off:off + cap * rb] = v4.reshape(-1)
    flat = flat.to(dev)
    view = flat[off:off + cap * rb].view(cap, rb)
    return q8.to(dev), view, vs.to(dev), mask.to(dev)


def _exact(q8, v4, vs, mask, k, key, repeats=1):
    """K6 on the kind `key` counts, `repeats` launches in a row, each bit
    for bit the plain version."""
    ref = scan.scan_topk_plain(q8, v4, vs, mask, k, int4=True)
    for _ in range(repeats):
        before = dict(scan.LAUNCHES)
        got = scan.fused_topk_i4(q8, v4, vs, mask, k)
        assert scan.LAUNCHES[key] == before[key] + 1, key
        assert scan.LAUNCHES["scan_topk_i4"] == before["scan_topk_i4"] + 1
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]), "scores differ"
        assert torch.equal(got[1], ref[1]), "rows differ"
    return got


def _key(kind, v4):
    return kind + (scan._PIECE_KEY[scan.rows_piece(v4)]
                   if kind in ("scan_topk_i4_wgmma", "scan_topk_i4_wide")
                   else "")


# (dim, base offset): glove-100 (50-byte rows), glove-200 (100),
# gist-960 (480: TMA at an aligned base), fashion-mnist's 784 (392), 300,
# deep-image's 96, the mesh dry run's 64 (a half stage), and the extremes
# 2 and 1022
WIDTHS = [(100, 0), (100, 2), (200, 0), (200, 4), (960, 0), (960, 8),
          (64, 0), (784, 0), (300, 6), (96, 1), (2, 0), (1022, 0)]


@pytest.mark.parametrize("dim,off", WIDTHS)
@pytest.mark.parametrize("nq", [1, 2, 4, 8])
@pytest.mark.parametrize("k", [1, 14, 128])
def test_narrow_sweep_exact(dev, dim, off, nq, k):
    q8, v4, vs, mask = _store(dev, 3001, dim, nq, off, seed=dim + nq + k)
    if not scan.i4_narrow_ready(q8, v4, k):
        # the 16-byte sweep's operands, or rows past 16 words at Q = 8
        assert scan.i4_sweep_ready(q8, v4, k) or nq > 4
        pytest.skip("another kind serves these operands")
    _exact(q8, v4, vs, mask, k, "scan_topk_i4_narrow", repeats=2)


@pytest.mark.parametrize("dim,off", [(100, 0), (200, 4), (960, 8)])
@pytest.mark.parametrize("nq", [9, 16])
def test_narrow_sweep_launched_past_its_limit(dev, dim, off, nq):
    """chip_smoke.py times the narrow kind past its limits (its
    crossover with the scan): launched directly, still the plain
    version (the kind's tiles stop at its limit of 8: 16 queries run in
    two passes of 8, dim 960 in the row-group layout)."""
    q8, v4, vs, mask = _store(dev, 4100, dim, nq, off, seed=nq)
    got = scan._sweep_launch(q8, v4, vs, mask, 14, "fused_topk_i4",
                             "pv_sweep_topk_i4_narrow")
    ref = scan.scan_topk_plain(q8, v4, vs, mask, 14, int4=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("dim,off", WIDTHS)
@pytest.mark.parametrize("nq", [9, 17, 64, 130])
@pytest.mark.parametrize("k", [1, 14, 33, 128])
def test_scan_exact(dev, dim, off, nq, k):
    """The tensor-core scan at both ring shapes (k <= 32, k <= 128) over
    every producer, three launches in a row."""
    q8, v4, vs, mask = _store(dev, 4225, dim, nq, off, seed=dim + nq + k)
    assert scan.i4_wgmma_ready(q8, v4, k)
    _exact(q8, v4, vs, mask, k, _key("scan_topk_i4_wgmma", v4), repeats=3)


@pytest.mark.parametrize("dim,off", [(100, 0), (200, 0), (784, 0),
                                     (960, 0), (96, 1)])
@pytest.mark.parametrize("nq", [1, 5, 64])
def test_scan_negative_scores_beside_rows_past_cap(dev, dim, off, nq):
    """Every score <= 0 and cap off a multiple of 256: the rows past cap in
    the last tile are skipped by index (the producers leave them zero);
    Q = 1 on the scan through its direct launch."""
    q8, v4, vs, mask = _store(dev, 4225, dim, nq, off, negative=True)
    ref = scan.scan_topk_plain(q8, v4, vs, mask, 14, int4=True)
    got = scan._i4_wgmma_launch(q8, v4, vs, mask, 14)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert bool((got[0] <= 0).all())


def test_scan_takes_small_batches_past_the_narrow_block(dev):
    """803 packed bytes a row at a 1-byte aligned base: the narrow kind's
    phase copies overflow its shared memory at a 4-query tile, so the
    scan serves Q = 4."""
    q8, v4, vs, mask = _store(dev, 2000, 1606, 4, off=1, seed=3)
    assert not scan.i4_narrow_ready(q8, v4, 14)
    _exact(q8, v4, vs, mask, 14, _key("scan_topk_i4_wgmma", v4))


@pytest.mark.parametrize("dim,off", [(100, 0), (200, 0), (960, 0),
                                     (784, 0), (96, 1), (64, 0), (2, 0)])
@pytest.mark.parametrize("nq", [1, 16, 64, 128])
@pytest.mark.parametrize("k", [129, 526, 1024])
def test_wide_exact(dev, dim, off, nq, k):
    q8, v4, vs, mask = _store(dev, 9000, dim, nq, off, seed=dim + nq + k)
    assert scan.i4_wide_ready(q8, v4, k)
    _exact(q8, v4, vs, mask, k, _key("scan_topk_i4_wide", v4), repeats=2)


def test_wide_all_masked_past_tma(dev):
    q8, v4, vs, mask = _store(dev, 5000, 100, 16, off=2, seed=1)
    none = torch.zeros_like(mask)
    got = _exact(q8, v4, vs, none, 526, _key("scan_topk_i4_wide", v4))
    assert bool(torch.isneginf(got[0]).all()) and not bool(got[1].any())
