"""K5 and K10 over int8 rows TMA cannot read, against their plain versions,
on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda_segmax_i8_narrow.py -q

K5 (`segmax_scan_i8`: int8 rows and their scales) and K10
(`segmax_scan_i8c`: the column-scaled mirror and folded queries) on the
int8 mainloop fed by TMA, by cp.async (widths and bases of whole 4 bytes)
or by the realigning producer (any other), at widths 25, 100, 200, 1019,
1020, 1 and 17, bases off a 256-byte boundary by 0, 1, 2, 4 and 8 bytes
(views into larger buffers), Q 1 / 127 / 128 / 129 / 2048, cap % 256 ==
128 (the last tile's second segment lies past cap) and one fully masked
segment: keys bit for bit the plain version's (exact int32 sums; K5 one
conversion and one multiply). Each call adds one to the counter of the
kind it meant to reach and none to another's.
"""

import pytest
import torch

from picovdb_tpu_torch.ops import scan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.cuda

CAP = 33 * scan.SEG  # cap % 256 == 128
DIMS = [25, 100, 200, 1019, 1020, 1, 17]
OFFSETS = [0, 1, 2, 4, 8]
QS = [1, 127, 128, 129, 2048]
KINDS = ("_wgmma", "_cpasync", "_realign")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _at(x, off: int):
    """A contiguous int8 copy of x whose base lies `off` bytes past a
    256-byte boundary (a view into a larger buffer)."""
    flat = torch.zeros(x.numel() + 256, dtype=x.dtype, device=x.device)
    v = flat[off:off + x.numel()].view(x.shape)
    v.copy_(x)
    assert v.data_ptr() % 256 == off
    return v


def _case(dev, dim, nq, seed):
    g = torch.Generator().manual_seed(seed)
    v = torch.nn.functional.normalize(torch.randn(CAP, dim, generator=g), dim=1)
    q = torch.nn.functional.normalize(torch.randn(nq, dim, generator=g), dim=1)
    mask = torch.rand(CAP, generator=g) > 0.2
    mask[256:384] = False  # a fully masked segment
    return v.to(dev), q.to(dev), mask.to(dev)


def _want(dim: int, q_off: int, v_off: int) -> str:
    """The kind the ready rules must name: TMA at rows of whole 16 bytes
    on 16-byte aligned bases, cp.async at whole 4 bytes, else realigned."""
    bits = dim | q_off | v_off
    return "_wgmma" if bits % 16 == 0 else "_cpasync" if bits % 4 == 0 \
        else "_realign"


def _run(family, fn, want):
    before = dict(scan.LAUNCHES)
    keys = fn()
    torch.cuda.synchronize()
    assert scan.LAUNCHES[family] == before[family] + 1
    for k in KINDS:
        assert (scan.LAUNCHES[family + k] - before[family + k]
                == (k == want)), (family + k, want)
    return keys


@pytest.mark.parametrize("nq", QS)
@pytest.mark.parametrize("off", OFFSETS)
@pytest.mark.parametrize("dim", DIMS)
def test_k5_kinds_bit_for_bit(dev, dim, off, nq):
    v, q, mask = _case(dev, dim, nq, seed=dim * 31 + off + nq)
    v8, vs = scan.quantize_rows_i8(v)
    q8, _ = scan.quantize_rows_i8(q)
    q8, v8 = _at(q8, off), _at(v8, off)
    want = _want(dim, off, off)
    keys = _run("segmax_i8", lambda: scan.segmax_scan_i8(q8, v8, vs, mask),
                want)
    ref = scan.segmax_scan_i8_plain(q8, v8, vs, mask)
    torch.cuda.synchronize()
    assert torch.equal(keys, ref)
    assert bool((keys[:, 4:6] == scan.KEY_MIN).all())


@pytest.mark.parametrize("nq", QS)
@pytest.mark.parametrize("off", OFFSETS)
@pytest.mark.parametrize("dim", DIMS)
def test_k10_kinds_bit_for_bit(dev, dim, off, nq):
    v, q, mask = _case(dev, dim, nq, seed=dim * 37 + off + nq)
    v8, cs = scan.quantize_cols_i8(v)
    q8 = _at(scan.fold_queries_i8(q, cs), off)
    v8 = _at(v8, off)
    want = _want(dim, off, off)
    keys = _run("segmax_i8c", lambda: scan.segmax_scan_i8c(q8, v8, mask),
                want)
    ref = scan.segmax_scan_i8c_plain(q8, v8, mask)
    torch.cuda.synchronize()
    assert torch.equal(keys, ref)
    assert bool((keys[:, 4:6] == scan.KEY_MIN).all())


@pytest.mark.parametrize("dim,q_off,v_off", [(100, 0, 1), (100, 4, 8),
                                             (25, 2, 0), (1024, 0, 1),
                                             (1024, 8, 0), (200, 8, 4)])
def test_mixed_bases_and_all_negative(dev, dim, q_off, v_off):
    """q and v off by different bytes, and every sum negative, so the
    zero-filled rows past cap and Q (sums of 0) must never enter a key:
    both kinds bit for bit their plain versions and the mma.sync tile
    they replaced (launched uncounted on the same inputs)."""
    v, q, mask = _case(dev, dim, 17, seed=dim + q_off + v_off)
    q8 = -scan.quantize_rows_i8(q)[0].abs()
    v8, vs = scan.quantize_rows_i8(v)
    v8 = v8.abs()
    v8[:, 0] = 1  # every row meets a query's -127 at least once
    q8[:, 0] = -127
    q8, v8 = _at(q8, q_off), _at(v8, v_off)
    want = _want(dim, q_off, v_off)
    for family, call, plain, tile in (
            ("segmax_i8", lambda: scan.segmax_scan_i8(q8, v8, vs, mask),
             lambda: scan.segmax_scan_i8_plain(q8, v8, vs, mask),
             lambda: scan._segmax_i8_launch(q8, v8, vs, mask,
                                            "pv_segmax_scan_i8")),
            ("segmax_i8c", lambda: scan.segmax_scan_i8c(q8, v8, mask),
             lambda: scan.segmax_scan_i8c_plain(q8, v8, mask),
             lambda: scan._segmax_i8c_launch(q8, v8, mask,
                                             "pv_segmax_scan_i8c"))):
        keys = _run(family, call, want)
        ref = plain()
        live = ref != scan.KEY_MIN
        assert bool((ref[live] < 0).all())
        assert torch.equal(keys, ref), family
        assert torch.equal(tile(), ref), family
