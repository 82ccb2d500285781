"""K6's wide kind (csrc/topk_i4_wide.cu, 128 < k <= 1024) against its
plain version, on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda_i4_wide.py -q

Packed int4 rows at dims 1024 and 256, cap off a multiple of 256, ~20 %
masked, at Q 1 / 16 / 64 / 128 and k 129 / 526 / 1024; query tiles
smaller than the batch; an all-masked plane; a plane where more than
TOPK_WIDE_CAP rows share the best score (the ties path: rows in order);
and dim 64, a partial k-stage. Bit for bit the plain version
(exact int32 sums, one conversion and one multiply, ties to the lower
row).
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


def _case(dev, cap, dim, nq, seed):
    g = torch.Generator().manual_seed(seed)
    v = torch.nn.functional.normalize(torch.randn(cap, dim, generator=g), dim=1)
    q = torch.nn.functional.normalize(torch.randn(nq, dim, generator=g), dim=1)
    mask = torch.rand(cap, generator=g) > 0.2
    v4, vs = scan.quantize_rows_i4(v.to(dev))
    q8, _ = scan.quantize_rows_i8(q.to(dev))
    return q8, v4, vs, mask.to(dev)


def _wide(q8, v4, vs, mask, k):
    before = dict(scan.LAUNCHES)
    got = scan.fused_topk_i4(q8, v4, vs, mask, k)
    assert scan.LAUNCHES["scan_topk_i4_wide"] == \
        before["scan_topk_i4_wide"] + 1
    assert scan.LAUNCHES["scan_topk_i4"] == before["scan_topk_i4"] + 1
    return got


def _bit_for_bit(got, ref):
    assert torch.equal(got[0], ref[0]), "scores differ"
    assert torch.equal(got[1], ref[1]), "rows differ"


@pytest.mark.parametrize("cap,dim", [(20_100, 1024), (9_000, 256)])
@pytest.mark.parametrize("k", [129, 526, 1024])
@pytest.mark.parametrize("nq", [1, 16, 64, 128])
def test_wide_against_plain(dev, cap, dim, k, nq):
    q8, v4, vs, mask = _case(dev, cap, dim, nq, seed=nq + k)
    mask[:256] = False
    assert scan.i4_wide_ready(q8, v4, k)
    got = _wide(q8, v4, vs, mask, k)
    ref = scan.scan_topk_plain(q8, v4, vs, mask, k, int4=True)
    torch.cuda.synchronize()
    _bit_for_bit(got, ref)


def test_wide_all_masked(dev):
    q8, v4, vs, mask = _case(dev, 5_000, 1024, 16, seed=1)
    none = torch.zeros_like(mask)
    got = _wide(q8, v4, vs, none, 526)
    torch.cuda.synchronize()
    assert bool(torch.isneginf(got[0]).all()) and not bool(got[1].any())


def test_wide_ties_past_cap(dev):
    """More than TOPK_WIDE_CAP rows hold the best row's packed bytes and
    scale, so they share its score: the k lowest live ones, in row
    order."""
    cap, k = 20_000, 526
    q8, v4, vs, mask = _case(dev, cap, 256, 3, seed=2)
    q8[:] = q8[0]
    best = int(scan.scan_topk_plain(q8[:1], v4, vs, mask, 1, int4=True)[1][0, 0])
    tied = torch.arange(2_000, 2_000 + scan.TOPK_WIDE_CAP + 500, device=dev)
    v4[tied] = v4[best].clone()
    vs[tied] = vs[best].clone()
    mask[tied] = True  # more than CAP of them live
    got = _wide(q8, v4, vs, mask, k)
    ref = scan.scan_topk_plain(q8, v4, vs, mask, k, int4=True)
    torch.cuda.synchronize()
    _bit_for_bit(got, ref)
    rows = sorted(set(tied[mask[tied]].tolist()) | {best})[:k]
    assert got[1][0].tolist() == rows


def test_wide_tiles_and_repeats(dev, monkeypatch):
    """Query tiles smaller than the batch (16 at a time over 128 queries)
    give the plain version's answer, and repeated launches agree."""
    q8, v4, vs, mask = _case(dev, 12_345, 1024, 128, seed=4)
    ref = scan.scan_topk_plain(q8, v4, vs, mask, 526, int4=True)
    ld = -(-12_345 // 128) * 128
    monkeypatch.setattr(scan, "TOPK_WIDE_SLAB_BYTES", 16 * 4 * ld)
    assert scan.topk_wide_tile(128, 12_345) == 16
    first = _wide(q8, v4, vs, mask, 526)
    torch.cuda.synchronize()
    _bit_for_bit(first, ref)
    for _ in range(3):
        _bit_for_bit(scan.fused_topk_i4(q8, v4, vs, mask, 526), first)


def test_dim_64_takes_the_wide_kind(dev):
    """dim 64 (32-byte rows: one k-stage TMA reads half of) kept the
    template until the scan took partial stages: now the wide kind."""
    q8, v4, vs, mask = _case(dev, 3_000, 64, 8, seed=5)
    assert scan.i4_wide_ready(q8, v4, 526)
    got = _wide(q8, v4, vs, mask, 526)
    ref = scan.scan_topk_plain(q8, v4, vs, mask, 526, int4=True)
    torch.cuda.synchronize()
    _bit_for_bit(got, ref)
