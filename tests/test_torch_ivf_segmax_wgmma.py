"""K8's tensor-core segment scan (csrc/ivf_segmax_wgmma.cu), checked on
the CPU.

* 3xTF32: a numpy emulation of the kernel's product on seeded clustered
  unit vectors at dim 1024 (hi = x with its low 13 mantissa bits cleared,
  lo = x - hi, the TF32 operands truncated as the tensor cores may read
  them, float32 sums of hi.hi + hi.lo + lo.hi) keeps every packed key
  within 1e-5 of the float64 score; hi.hi alone, plain TF32, does not.
  With the tensor cores' float32 sum emulated as rounding toward zero at
  every wgmma, one accumulator over the row's 384 wgmmas misses the limit
  and the kernel's per-stage accumulators (12 wgmmas, then a rounded add)
  keep it.
* The shares (the kernel's `share`, restated): every (query tile, live segment)
  once, every dead step's segment once, no live item on a dead step.
* What a launch is passed (the rows' producer `rows_piece`, the padded
  query planes), recorded by a stand-in for `scan._launch` on CPU tensors
  that report themselves as CUDA tensors, with the counters.
* On the CPU the wrapper runs the plain version: the new counter stays 0.
"""

import types

import numpy as np
import pytest
import torch

from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import ivf as tivf
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads
from torch_port_setup import clustered_unit as _clustered
from torch_port_setup import tf32_hi as _hi
from torch_port_setup import toward_zero as _toward_zero

cap_torch_threads()

BN = tivf.IVF_BN
NS = BN // tscan.SEG
TOL_SCORE = 1e-5
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i8c": torch.int8}


# --------------------------------------------------------------------------
# 3xTF32
# --------------------------------------------------------------------------


def _key_values(s):
    """float32 scores -> the values their packed keys decode to (the
    sortable bits with the low 7 replaced, i.e. cleared before decoding)."""
    t = torch.from_numpy(np.ascontiguousarray(s, dtype=np.float32))
    k = tscan._to_sortable(t.view(torch.int32)) & ~(tscan.SEG - 1)
    return tscan._from_sortable(k).view(torch.float32).numpy().astype(np.float64)


def test_3xtf32_keys_within_limit_where_tf32_misses():
    rng = np.random.default_rng(0)
    dim = 1024
    v = _clustered(rng, 512, dim)
    q = v[:32] + 0.01 * rng.standard_normal((32, dim)).astype(np.float32)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    exact = q.astype(np.float64) @ v.astype(np.float64).T
    qh, vh = _hi(q), _hi(v)
    ql, vl = q - qh, v - vh
    assert np.array_equal(qh + ql, q) and np.array_equal(vh + vl, v)
    # the tensor cores read a float32 operand's top 19 bits: lo truncated
    three = qh @ vh.T + qh @ _hi(vl).T + _hi(ql) @ vh.T  # float32 sums
    err3 = np.abs(_key_values(three) - exact).max()
    assert err3 <= TOL_SCORE, err3
    err1 = np.abs(_key_values(qh @ vh.T) - exact).max()
    assert err1 > TOL_SCORE, err1
    assert exact.max() > 0.9  # clustered: the top scores sit near 1


def test_stage_accumulators_hold_the_limit_under_truncating_sums():
    rng = np.random.default_rng(0)
    dim = 1024
    v = _clustered(rng, 512, dim)
    q = v[:32] + 0.01 * rng.standard_normal((32, dim)).astype(np.float32)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    exact = q.astype(np.float64) @ v.astype(np.float64).T
    qh, vh = _hi(q), _hi(v)
    products = [(qh, vh), (qh, _hi(v - vh)), (_hi(q - qh), vh)]
    one = np.zeros(exact.shape, np.float32)  # every wgmma into one sum
    acc = np.zeros(exact.shape, np.float32)  # the kernel: a sum per stage
    for s in range(0, dim, 32):  # a 128-byte k-stage of float32
        part = np.zeros(exact.shape, np.float32)
        for kk in range(s, s + 32, 8):  # a k8 wgmma per product
            for a, b in products:
                p = (a[:, kk:kk + 8].astype(np.float64)
                     @ b[:, kk:kk + 8].astype(np.float64).T)
                one = _toward_zero(one + p)
                part = _toward_zero(part + p)
        acc = acc + part  # float32, rounded to nearest
    assert np.abs(_key_values(acc) - exact).max() <= TOL_SCORE
    assert np.abs(_key_values(one) - exact).max() > TOL_SCORE


def test_split_tf32_is_exact():
    g = torch.Generator().manual_seed(1)
    q = torch.randn(8, 96, generator=g)
    hi, lo = tivf.split_tf32(q)
    assert torch.equal(hi + lo, q)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert float(lo.abs().max()) <= float(q.abs().max()) * 2.0**-10


# --------------------------------------------------------------------------
# The shares
# --------------------------------------------------------------------------


def _partition(n_hot: int, grid_b: int, ns: int, q_tiles: int, ctas: int):
    """The tensor-core segment scan's shares, as every CTA computes them
    (`share` in csrc/ivf_segmax_wgmma.cu) after reading n_hot on the
    device: items u = (query tile u % q_tiles, segment u // q_tiles) of the
    live steps min(n_hot, grid_b) (segment i is segment i % ns of hot step
    i // ns), then the dead steps' segments. CTA c of `ctas` takes items
    [c U / ctas, (c + 1) U / ctas) and dead segments [c D / ctas, (c + 1)
    D / ctas) (integer division). Returns [((item beg, end), (dead beg,
    end))] for c = 0 .. ctas - 1."""
    live = max(0, min(n_hot, grid_b))
    units, dead = live * ns * q_tiles, (grid_b - live) * ns
    return [((c * units // ctas, (c + 1) * units // ctas),
             (c * dead // ctas, (c + 1) * dead // ctas)) for c in range(ctas)]


@pytest.mark.parametrize("n_hot,grid_b", [(0, 4), (1, 1), (7, 10), (40, 64),
                                          (64, 64), (90, 64)])
@pytest.mark.parametrize("q_tiles", [1, 3])
@pytest.mark.parametrize("ctas", [1, 7, 264])
def test_ivf_segmax_partition(n_hot, grid_b, q_tiles, ctas):
    """Together the CTAs' items cover (query tile, segment) of every live
    step once and their dead shares every segment of the dead steps once;
    shares differ by at most one item."""
    shares = _partition(n_hot, grid_b, NS, q_tiles, ctas)
    assert len(shares) == ctas
    live = min(n_hot, grid_b)
    items, dead = [], []
    for (ub, ue), (db, de) in shares:
        items += [((u % q_tiles), u // q_tiles) for u in range(ub, ue)]
        dead += [(live + d // NS, d % NS) for d in range(db, de)]
    assert sorted(items) == sorted((qt, seg) for qt in range(q_tiles)
                                   for seg in range(live * NS))
    assert all(seg // NS < live for _, seg in items)  # no dead step
    assert sorted(dead) == [(b, s) for b in range(live, grid_b)
                            for s in range(NS)]
    sizes = [ue - ub for (ub, ue), _ in shares]
    assert max(sizes) - min(sizes) <= 1


# --------------------------------------------------------------------------
# The ready rule and what the wrapper launches
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
    monkeypatch.setattr(tivf, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    return calls


def _operands(kind, dim, offset=0, nq=5, tiles=4):
    dt = DTYPES[kind]
    q = torch.zeros(nq, dim, dtype=dt)
    flat = torch.zeros(tiles * BN * dim + 16, dtype=dt)
    return q, flat[offset:offset + tiles * BN * dim].view(tiles * BN, dim)


@pytest.mark.parametrize("kind,dim,offset,tma", [
    ("f32", 96, 0, True), ("f32", 98, 0, False), ("bf16", 1024, 0, True),
    ("bf16", 100, 0, False), ("i8c", 96, 0, True), ("i8c", 96, 1, False),
    ("i8c", 104, 0, False), ("f32", 96, 1, False), ("bf16", 96, 1, False),
    ("i8c", 98, 0, False)])
def test_k8_dispatch_by_ivf_segmax_ready(recorded, kind, dim, offset, tma):
    """K8 takes the tensor-core segment scan at every width and base, its
    rows by the producer `rows_piece` names (TMA where `tma`: rows of
    whole 16 bytes from a 16-byte aligned base; cp.async where the row
    bytes and the base are multiples of 4 or 8; the realigning producer
    the rest), float32 queries as their hi and lo planes, every plane
    padded to whole 16 bytes; "ivf_segmax" counts every launch,
    "ivf_segmax_wgmma" the TMA kind's, the same key ending in "_cpasync" /
    "_realign" the others'."""
    q, v = _operands(kind, dim, offset)
    piece = tscan.rows_piece(v)
    assert piece in ((0,) if tma else (8, 4, 2))
    mask = torch.ones(v.shape[0], dtype=torch.bool)
    hot = torch.tensor([3, 1, 2], dtype=torch.int32)
    n_hot = torch.tensor([2], dtype=torch.int32)
    before = dict(tscan.LAUNCHES)
    keys = tivf.ivf_segmax_scan(*map(_as_cuda, (q, v, mask, hot, n_hot)), 8)
    assert keys.shape == (5, 3 * 8 * NS) and keys.dtype == torch.int32
    (entry, args), = recorded
    assert entry == "pv_ivf_segmax_wgmma"
    assert args[:2] == (piece, tivf._KINDS[DTYPES[kind]])
    assert (args[3] is not None) == (kind == "f32")  # the lo plane
    assert args[4] == v.data_ptr()
    assert args[9:] == (5, 4 * BN, dim, BN, 3, 8)
    key = "ivf_segmax_wgmma" + tscan._PIECE_KEY[piece]
    assert tscan.LAUNCHES["ivf_segmax"] == before["ivf_segmax"] + 1
    assert tscan.LAUNCHES[key] == before[key] + 1
    assert tscan.LAUNCH_SHAPES["ivf_segmax"][5, 8] >= 1
    if not tma:
        assert tscan.LAUNCH_SHAPES[key][5, 8] >= 1


def test_counter_stays_zero_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    q = torch.nn.functional.normalize(torch.randn(4, 64, generator=g), dim=1)
    v = torch.nn.functional.normalize(torch.randn(2 * BN, 64, generator=g),
                                      dim=1)
    mask = torch.ones(2 * BN, dtype=torch.bool)
    hot = torch.tensor([1, 0], dtype=torch.int32)
    tscan.reset_launch_counts()
    keys = tivf.ivf_segmax_scan(q, v, mask, hot,
                                torch.tensor([1], dtype=torch.int32), 4)
    assert bool((keys[:, 4 * NS:] == tscan.KEY_MIN).all())  # the dead step
    assert tscan.LAUNCHES["ivf_segmax"] == tscan.LAUNCHES["ivf_segmax_wgmma"] == 0
