"""K3's wide kind (csrc/topk_i8_wide.cu, `i8_wide_ready`) against
its plain version, on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda_i8_wide.py -q

Per-row int8 rows at dims 1024 and 256, a cap off a multiple of 128, ~20 %
masked, at Q 1 / 16 / 64 / 128 and k 129 / 142 / 385 / 432 / 1024
(142: the int8 store's host-rescore band at top_k = 10); query tiles
smaller than the batch; an all-masked plane; a plane where more than
TOPK_WIDE_CAP rows share the best score (the ties path: rows in order);
a mask view off a 4-byte boundary (copied); queries off a 16-byte
boundary and dim 1000, which the template served until the wide kind
took every width and base (its rows by cp.async at dim 1000, the queries
padded by the library call); the dispatch where a
smaller slab budget cuts the wide kind's query tile (the scan at k_sel
142 past Q = 1, the wide kind at 432); and a store on cuda:1
while the current device is 0. Bit for bit the plain version (exact
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


def _case(dev, cap, dim, nq, seed):
    g = torch.Generator().manual_seed(seed)
    v = torch.nn.functional.normalize(torch.randn(cap, dim, generator=g), dim=1)
    q = torch.nn.functional.normalize(torch.randn(nq, dim, generator=g), dim=1)
    mask = torch.rand(cap, generator=g) > 0.2
    v8, vs = scan.quantize_rows_i8(v.to(dev))
    q8, _ = scan.quantize_rows_i8(q.to(dev))
    return q8, v8, vs, mask.to(dev)


def _wide(q8, v8, vs, mask, k):
    before = dict(scan.LAUNCHES)
    got = scan.fused_topk_i8(q8, v8, vs, mask, k)
    assert scan.LAUNCHES["scan_topk_i8_wide"] == \
        before["scan_topk_i8_wide"] + 1
    assert scan.LAUNCHES["scan_topk_i8"] == before["scan_topk_i8"] + 1
    return got


def _bit_for_bit(got, ref):
    assert torch.equal(got[0], ref[0]), "scores differ"
    assert torch.equal(got[1], ref[1]), "rows differ"


@pytest.mark.parametrize("cap,dim", [(20_100, 1024), (9_000, 256)])
@pytest.mark.parametrize("k", [129, 142, 385, 432, 1024])
@pytest.mark.parametrize("nq", [1, 16, 64, 128])
def test_wide_against_plain(dev, cap, dim, k, nq):
    q8, v8, vs, mask = _case(dev, cap, dim, nq, seed=nq + k)
    mask[:256] = False
    assert scan.i8_wide_ready(q8, v8, k)
    got = _wide(q8, v8, vs, mask, k)
    ref = scan.scan_topk_plain(q8, v8, vs, mask, k)
    torch.cuda.synchronize()
    _bit_for_bit(got, ref)


def test_wide_all_masked(dev):
    q8, v8, vs, mask = _case(dev, 5_000, 1024, 16, seed=1)
    got = _wide(q8, v8, vs, torch.zeros_like(mask), 432)
    torch.cuda.synchronize()
    assert bool(torch.isneginf(got[0]).all()) and not bool(got[1].any())


def test_wide_ties_past_cap(dev):
    """More than TOPK_WIDE_CAP rows hold the best row's bytes and scale, so
    they share its score: the k lowest live ones, in row order."""
    cap, k = 20_000, 432
    q8, v8, vs, mask = _case(dev, cap, 256, 3, seed=2)
    q8[:] = q8[0]
    best = int(scan.scan_topk_plain(q8[:1], v8, vs, mask, 1)[1][0, 0])
    tied = torch.arange(2_000, 2_000 + scan.TOPK_WIDE_CAP + 500, device=dev)
    v8[tied] = v8[best].clone()
    vs[tied] = vs[best].clone()
    mask[tied] = True  # more than CAP of them live
    got = _wide(q8, v8, vs, mask, k)
    ref = scan.scan_topk_plain(q8, v8, vs, mask, k)
    torch.cuda.synchronize()
    _bit_for_bit(got, ref)
    rows = sorted(set(tied[mask[tied]].tolist()) | {best})[:k]
    assert got[1][0].tolist() == rows


def test_wide_tiles_and_repeats(dev, monkeypatch):
    """Query tiles smaller than the batch (16 at a time over 128 queries)
    give the plain version's answer, and repeated launches agree."""
    q8, v8, vs, mask = _case(dev, 12_345, 1024, 128, seed=4)
    ref = scan.scan_topk_plain(q8, v8, vs, mask, 432)
    ld = -(-12_345 // 128) * 128
    monkeypatch.setattr(scan, "TOPK_WIDE_SLAB_BYTES", 16 * 4 * ld)
    assert scan.topk_wide_tile(128, 12_345) == 16
    first = _wide(q8, v8, vs, mask, 432)
    torch.cuda.synchronize()
    _bit_for_bit(first, ref)
    for _ in range(3):
        _bit_for_bit(scan.fused_topk_i8(q8, v8, vs, mask, 432), first)


def test_misaligned_mask_is_copied(dev):
    q8, v8, vs, mask = _case(dev, 8_320, 256, 17, seed=5)
    flat = torch.zeros(8_320 + 4, dtype=torch.bool, device=dev)
    view = flat[1:8_321]
    view.copy_(mask)
    assert view.data_ptr() % 4
    got = _wide(q8, v8, vs, view, 600)
    ref = scan.scan_topk_plain(q8, v8, vs, mask, 600)
    torch.cuda.synchronize()
    _bit_for_bit(got, ref)


@pytest.mark.parametrize("case", ["misaligned queries", "dim 1000"])
def test_other_shapes_take_the_wide_kind(dev, case):
    if case == "dim 1000":
        q8, v8, vs, mask = _case(dev, 6_000, 1000, 8, seed=6)
    else:
        q8, v8, vs, mask = _case(dev, 6_000, 256, 8, seed=6)
        flat = torch.zeros(8 * 256 + 16, dtype=torch.int8, device=dev)
        q8 = flat[4:4 + 8 * 256].view(8, 256).copy_(q8)
    assert scan.i8_wide_ready(q8, v8, 432)
    # TMA cannot read them as they lie: the wide kind takes them, its rows
    # by cp.async in 8-byte pieces (dim 1000), or by TMA beside the library
    # call's padded copy of the queries
    key = ("scan_topk_i8_wide_cpasync" if case == "dim 1000"
           else "scan_topk_i8_wide")
    before = dict(scan.LAUNCHES)
    got = scan.fused_topk_i8(q8, v8, vs, mask, 432)
    assert scan.LAUNCHES[key] == before[key] + 1
    assert scan.LAUNCHES["scan_topk_i8"] == before["scan_topk_i8"] + 1
    ref = scan.scan_topk_plain(q8, v8, vs, mask, 432)
    torch.cuda.synchronize()
    _bit_for_bit(got, ref)


@pytest.mark.parametrize("nq", [1, 5, 64])
def test_dispatch_by_wide_tile(dev, monkeypatch, nq):
    """A slab budget of 4 queries' slabs cuts the wide kind's query tile to
    4: at k_sel 142 the dispatch keeps it only where that tile holds the
    batch (Q = 1), else takes the scan (Q = 5, 64); at k_sel 432 the wide
    kind whatever the tile; every answer bit for bit the plain version."""
    cap = 20_100
    q8, v8, vs, mask = _case(dev, cap, 256, nq, seed=40 + nq)
    monkeypatch.setattr(scan, "TOPK_WIDE_SLAB_BYTES",
                        4 * 4 * (-(-cap // scan.SEG) * scan.SEG))
    assert scan.topk_wide_tile(nq, cap) == min(nq, 4)
    for k, want in ((142, "scan_topk_i8_wide" if nq == 1
                     else "scan_topk_i8_wgmma"), (432, "scan_topk_i8_wide")):
        before = dict(scan.LAUNCHES)
        got = scan.fused_topk_i8(q8, v8, vs, mask, k)
        for key in ("scan_topk_i8_wide", "scan_topk_i8_wgmma",
                    "scan_topk_i8_sweep"):
            assert scan.LAUNCHES[key] == before[key] + (key == want), key
        torch.cuda.synchronize()
        _bit_for_bit(got, scan.scan_topk_plain(q8, v8, vs, mask, k))


def test_wide_on_second_card(dev):
    """The wide kind on tensors of cuda:1 while the current device is 0:
    launched on their own card, equal to the same call on cuda:0. Skips on
    a machine with one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    q8, v8, vs, mask = _case(dev, 9_000, 1024, 64, seed=7)
    out = {}
    for name in ("cuda:0", "cuda:1"):
        d = torch.device(name)
        got = _wide(q8.to(d), v8.to(d), vs.to(d), mask.to(d), 432)
        assert torch.cuda.current_device() == 0
        torch.cuda.synchronize(d)
        out[name] = (got[0].cpu(), got[1].cpu())
    _bit_for_bit(out["cuda:0"], out["cuda:1"])
