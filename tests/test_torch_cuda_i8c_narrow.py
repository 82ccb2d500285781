"""K9 fused_topk_i8c's kinds against its plain version, on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda_i8c_narrow.py -q

Column-scaled int8 rows and folded int8 queries (`quantize_cols_i8`,
`fold_queries_i8`): the sweep's narrow kind (`pv_sweep_topk_i8c_narrow`)
at Q 1 ... 16, the tensor-core scan (`pv_scan_topk_i8c_wgmma`) at k 1 ...
128 and the wide kind (`pv_scan_topk_i8c_wide`) at k 129 ... 1024, each
at every producer piece (`rows_piece`: TMA, cp.async in 8- and 4-byte
pieces, the realigning producer), widths 25 / 96 / 100 / 1019 / 1020 /
1024 and bases off 16 bytes by 0, 1, 2, 4 and 8: bit for bit
`fused_topk_i8c_plain` (exact int32 sums, ties to the lower row, -inf /
row 0 where empty). Through the dispatch where the kind's ready rule
holds (its counter and "scan_topk_i8c" grow, no other key), else
launched alone (uncounted), as chip_smoke.py's crossovers launch them.
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


def _at(x, off_bytes: int):
    """A contiguous copy of x whose base lies `off_bytes` past a 256-byte
    boundary (a view into a larger buffer)."""
    flat = torch.zeros(x.numel() + 256, dtype=x.dtype, device=x.device)
    v = flat[off_bytes:off_bytes + x.numel()].view(x.shape)
    v.copy_(x)
    assert v.data_ptr() % 256 == off_bytes
    return v


def _i8c(dev, cap, dim, nq, off, seed, qoff=0):
    g = torch.Generator().manual_seed(seed)
    v = torch.nn.functional.normalize(torch.randn(cap, dim, generator=g), dim=1)
    q = torch.nn.functional.normalize(torch.randn(nq, dim, generator=g), dim=1)
    mask = torch.rand(cap, generator=g) > 0.2
    mask[:300] = False
    v8, cs = scan.quantize_cols_i8(v.to(dev))
    q8 = scan.fold_queries_i8(q.to(dev), cs)
    v8[cap // 2 + 1] = v8[cap // 2]  # equal rows: ties to the lower row
    return _at(q8, qoff), _at(v8, off), mask.to(dev)


def _held(q8, v8, mask, k, key, rule, alone):
    """The kind through the dispatch where `rule` holds, else `alone()`;
    bit for bit the plain version."""
    ref = scan.fused_topk_i8c_plain(q8, v8, mask, k)
    if rule(q8, v8, k):
        before = dict(scan.LAUNCHES)
        got = scan.fused_topk_i8c(q8, v8, mask, k)
        torch.cuda.synchronize()
        grew = {n for n in scan.LAUNCHES if scan.LAUNCHES[n] > before[n]}
        assert grew == {"scan_topk_i8c", key}, grew
    else:
        got = alone()
        torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]), "scores differ"
    assert torch.equal(got[1], ref[1]), "rows differ"
    return got


DIMS = [25, 96, 100, 1019, 1020, 1024]
OFFS = [0, 1, 2, 4, 8]


@pytest.mark.parametrize("dim", [25, 100, 1019, 1020, 1024])
@pytest.mark.parametrize("off", OFFS)
@pytest.mark.parametrize("nq,k", [(1, 1), (1, 16), (2, 128), (4, 16),
                                  (5, 16), (8, 64), (16, 16)])
def test_narrow_sweep(dev, dim, off, nq, k):
    q8, v8, mask = _i8c(dev, 9_000, dim, nq, off, seed=dim + off + nq)
    if scan._i8_tma_ready(q8, v8):
        pytest.skip("the 16-byte sweep's operands")
    if not scan.narrow_fits(q8, v8, k):
        assert not scan.i8c_narrow_ready(q8, v8, k)
        with pytest.raises(RuntimeError):  # the launcher refuses it too
            scan._sweep_launch(q8, v8, None, mask, k, "fused_topk_i8c",
                               "pv_sweep_topk_i8c_narrow")
        return
    _held(q8, v8, mask, k, "scan_topk_i8c_narrow", scan.i8c_narrow_ready,
          lambda: scan._sweep_launch(q8, v8, None, mask, k, "fused_topk_i8c",
                                     "pv_sweep_topk_i8c_narrow"))


def test_narrow_sweep_misaligned_queries(dev):
    """The query view at any base: the phase copies read it a byte at a
    time."""
    for qoff in (1, 3, 8):
        q8, v8, mask = _i8c(dev, 5_000, 100, 3, 0, seed=qoff, qoff=qoff)
        _held(q8, v8, mask, 16, "scan_topk_i8c_narrow", scan.i8c_narrow_ready,
              lambda: scan._sweep_launch(q8, v8, None, mask, 16,
                                         "fused_topk_i8c",
                                         "pv_sweep_topk_i8c_narrow"))


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("off", OFFS)
@pytest.mark.parametrize("nq,k", [(1, 1), (17, 16), (64, 33), (64, 64),
                                  (130, 65), (20, 128)])
def test_scan(dev, dim, off, nq, k):
    q8, v8, mask = _i8c(dev, 9_000, dim, nq, off, seed=3 * dim + off + nq)
    key = "scan_topk_i8c_wgmma" + scan._PIECE_KEY[scan.rows_piece(v8)]
    _held(q8, v8, mask, k, key, scan.i8c_wgmma_ready,
          lambda: scan._i8_wgmma_launch(q8, v8, None, mask, k,
                                        "fused_topk_i8c"))


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("off", OFFS)
@pytest.mark.parametrize("nq,k", [(1, 160), (16, 129), (64, 544),
                                  (3, 1024)])
def test_wide(dev, dim, off, nq, k):
    q8, v8, mask = _i8c(dev, 9_000, dim, nq, off, seed=5 * dim + off + nq)
    key = "scan_topk_i8c_wide" + scan._PIECE_KEY[scan.rows_piece(v8)]
    assert scan.i8c_wide_ready(q8, v8, k)
    _held(q8, v8, mask, k, key, scan.i8c_wide_ready, None)


@pytest.mark.parametrize("dim", [100, 1024])
def test_sweep_past_its_limit(dev, dim):
    """The 16-byte sweep and the narrow kind launched past K9's limits
    (the crossover chip_smoke.py --k9-cross times): every tile up to 16,
    still the plain version."""
    for nq in (5, 8, 9, 16):
        q8, v8, mask = _i8c(dev, 20_000, dim, nq, 0, seed=nq)
        entry = ("pv_sweep_topk_i8c" if scan._i8_tma_ready(q8, v8)
                 else "pv_sweep_topk_i8c_narrow")
        got = scan._sweep_launch(q8, v8, None, mask, 16, "fused_topk_i8c",
                                 entry)
        ref = scan.fused_topk_i8c_plain(q8, v8, mask, 16)
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_all_masked_underfilled_and_tiny(dev):
    """No live row: every kind's -inf / row 0; three live rows under k:
    -inf / 0 past them; a corpus of fewer rows than a segment."""
    for dim, off in ((100, 0), (25, 1), (1020, 4)):
        q8, v8, mask = _i8c(dev, 4_000, dim, 20, off, seed=dim)
        none = torch.zeros_like(mask)
        few = torch.zeros_like(mask)
        few[[7, 1999, 3999]] = True
        for msk in (none, few):
            for nq, k in ((1, 16), (20, 16), (1, 200), (20, 600)):
                got = scan.fused_topk_i8c(q8[:nq].contiguous(), v8, msk, k)
                ref = scan.fused_topk_i8c_plain(q8[:nq], v8, msk, k)
                torch.cuda.synchronize()
                assert torch.equal(got[0], ref[0])
                assert torch.equal(got[1], ref[1])
        tiny_q, tiny_v, _ = _i8c(dev, 70, dim, 2, off, seed=1)
        tiny_m = torch.ones(70, dtype=torch.bool, device=dev)
        for k in (5, 140):
            got = scan.fused_topk_i8c(tiny_q, tiny_v, tiny_m, k)
            ref = scan.fused_topk_i8c_plain(tiny_q, tiny_v, tiny_m, k)
            torch.cuda.synchronize()
            assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
