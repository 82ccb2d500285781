"""K3's and K4's dispatch over rows at every width and base, checked on the
CPU: CPU tensors posing as CUDA tensors reach the launch, which a stand-in
for `scan._launch` records against `_build._SIGNATURES`.

* The ready rules, asked in the dispatch's order, give every (dtype,
  width, base offset, Q, k) of K3 (int8 rows: widths 25 ... 1024, bases
  off 16 bytes by 0-8 bytes, the query view too) and K4 (float32 and bf16
  rows, bases off by whole elements) exactly one kind up to 64M rows: no
  call reaches the template (`pv_scan_topk`). The tensor-core kinds
  (`topk_wgmma_ready`, `topk_wide_ready`, `i8_wgmma_ready`,
  `i8_wide_ready`) take every width and base; only the 16-byte sweeps
  (`i8_sweep_ready`, `topk_sweep_ready`) ask for rows of whole 16 bytes,
  and their narrow kinds (`i8_narrow_ready`, `topk_narrow_ready`) take
  the small batches over the others.
* Each launch takes its kind's entry with the arguments the entry's
  signature names: the tensor-core kinds' the rows' producer first
  (`rows_piece`: 0 TMA, 8 / 4 cp.async, 2 the realigning producer), K4's
  the query planes padded to whole 16 bytes; each adds one to its kind's
  counter (suffixed "_cpasync" / "_realign" by the producer,
  "scan_topk_i8_narrow") and to LAUNCH_SHAPES under that key.
* Past 64M rows (one query's slab over TOPK_WIDE_SLAB_BYTES) K4 at k >
  128 and K3 at k > 384 keep the template, as ROADMAP lists.
"""

import types

import pytest
import torch

from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

CAP = 4096


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


def _view(shape, dtype, off_bytes):
    es = torch.empty(0, dtype=dtype).element_size()
    n = shape[0] * shape[1]
    flat = torch.zeros(n + 64 // es, dtype=dtype)
    v = flat[off_bytes // es:off_bytes // es + n].view(shape)
    assert v.data_ptr() % 16 == off_bytes % 16
    return v


# K3's kinds in the dispatch's order: (name, ready rule, entry, counter
# key; "+" appends the rows' producer's suffix)
K3_KINDS = [
    ("wide", tscan.i8_wide_ready, "pv_scan_topk_i8_wide",
     "scan_topk_i8_wide+"),
    ("sweep", tscan.i8_sweep_ready, "pv_sweep_topk_i8", "scan_topk_i8_sweep"),
    ("narrow", tscan.i8_narrow_ready, "pv_sweep_topk_i8_narrow",
     "scan_topk_i8_narrow"),
    ("scan", tscan.i8_wgmma_ready, "pv_scan_topk_i8_wgmma",
     "scan_topk_i8_wgmma+")]

K4_KINDS = [
    ("sweep", tscan.topk_sweep_ready, "pv_sweep_topk_f32", "scan_topk_sweep"),
    ("narrow", tscan.topk_narrow_ready, "pv_sweep_topk_f32_narrow",
     "scan_topk_narrow"),
    ("scan", tscan.topk_wgmma_ready, "pv_scan_topk_wgmma", "scan_topk_wgmma+"),
    ("wide", tscan.topk_wide_ready, "pv_scan_topk_wide", "scan_topk_wide+")]


def _pick(kinds, q, v, k):
    """The kind the dispatch takes: the first whose rule holds."""
    held = [kind for kind in kinds if kind[1](q, v, k)]
    return held[0] if held else None


def _expect(kind, v):
    """The entry, counter key and producer a kind's launch takes on rows
    v."""
    name, _, entry, key = kind
    piece = tscan.rows_piece(v)
    if key.endswith("+"):
        key = key[:-1] + tscan._PIECE_KEY[piece]
    return entry, key, piece


def _check(recorded, fn, kinds, q, v, k, before, nq):
    kind = _pick(kinds, q, v, k)
    assert kind is not None, "the template"
    entry, key, piece = _expect(kind, v)
    recorded.clear()
    fn()
    (got, args), = recorded
    assert got == entry, (kind[0], got)
    assert tscan.LAUNCHES[key] == before[key] + 1, key
    if kind[3].endswith("+"):
        assert args[0] == piece in (0, 8, 4, 2)
    if kind[3].endswith("+") or kind[0] == "narrow":
        assert tscan.LAUNCH_SHAPES[key][nq, k] >= 1
    return kind[0]


@pytest.mark.parametrize("dim", [25, 50, 96, 100, 300, 1018, 1019, 1020,
                                 1024])
def test_k3_every_width_and_base_takes_one_kind(recorded, dim):
    seen = set()
    vs = torch.ones(CAP)
    mask = torch.ones(CAP, dtype=torch.bool)
    for off in (0, 1, 2, 4, 8):
        v = _view((CAP, dim), torch.int8, off)
        for qoff in (0, 4):
            for nq in (1, 3, 4, 5, 16, 64):
                q = _view((nq, dim), torch.int8, qoff)
                for k in (14, 128, 142, 384, 432, 1024):
                    # TMA reads the rows exactly where they are whole 16
                    # bytes at a 16-byte aligned base; the 16-byte sweep
                    # asks for the query's too
                    assert (tscan.rows_piece(v) == 0) == (dim % 16 == 0
                                                          and off == 0)
                    if dim % 16 or off or qoff:
                        assert not tscan.i8_sweep_ready(q, v, k)
                    before = dict(tscan.LAUNCHES)
                    seen.add(_check(
                        recorded, lambda: tscan.fused_topk_i8(
                            *map(_as_cuda, (q, v, vs, mask)), k),
                        K3_KINDS, q, v, k, before, nq))
    assert {"wide", "narrow", "scan"} <= seen
    if dim % 16:
        assert "sweep" not in seen


@pytest.mark.parametrize("dtype,dim", [
    (torch.float32, 25), (torch.float32, 96), (torch.float32, 98),
    (torch.float32, 1019), (torch.float32, 1022), (torch.bfloat16, 25),
    (torch.bfloat16, 96), (torch.bfloat16, 100), (torch.bfloat16, 1019),
    (torch.bfloat16, 1020), (torch.bfloat16, 1024)])
def test_k4_every_width_and_base_takes_one_kind(recorded, dtype, dim):
    es = torch.empty(0, dtype=dtype).element_size()
    seen = set()
    mask = torch.ones(CAP, dtype=torch.bool)
    for off in range(0, 9, es):
        v = _view((CAP, dim), dtype, off)
        for nq in (1, 16, 64, 70):
            q = torch.zeros(nq, dim)
            for k in (14, 64, 65, 128, 129, 204, 1024):
                assert sum(kind[1](q, v, k) for kind in K4_KINDS) == 1
                before = dict(tscan.LAUNCHES)
                seen.add(_check(
                    recorded, lambda: tscan.fused_topk(
                        *map(_as_cuda, (q, v, mask)), k),
                    K4_KINDS, q, v, k, before, nq))
    # Q = 1 takes a one-query sweep: the narrow kind over rows off whole
    # 16 bytes or a base off 16 bytes, the 16-byte sweep over the others
    sweep = {"sweep"} if dim % (16 // es) == 0 else set()
    assert seen == {"scan", "wide", "narrow"} | sweep


def test_k4_rows_launch_pads_the_planes(recorded, monkeypatch):
    """The scan over rows TMA cannot read gets the query planes padded to
    whole 16 bytes (float32 hi / lo to 4 elements, bf16 planes to 8) and a
    partial of Q x ranges x k keys at `topk_wgmma_qtile`'s query tile (32
    for the realigning producer past k 64)."""
    seen, sizes = [], []
    real_stack, real_empty = torch.stack, torch.empty

    def stack(ts):
        out = real_stack(ts)
        seen.append(out)
        return out

    def empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        if kw.get("dtype") == torch.int64:
            sizes.append(out.numel())
        return out

    monkeypatch.setattr(tscan.torch, "stack", stack)
    monkeypatch.setattr(tscan.torch, "empty", empty)
    mask = torch.ones(CAP, dtype=torch.bool)
    for dtype, dim, k, qld, qtile in ((torch.float32, 1019, 14, 1020, 64),
                                      (torch.bfloat16, 1019, 100, 1024, 32),
                                      (torch.bfloat16, 1019, 64, 1024, 64),
                                      (torch.bfloat16, 98, 100, 104, 64)):
        recorded.clear()
        seen.clear()
        sizes.clear()
        q = torch.randn(70, dim)
        v = torch.zeros(CAP, dim, dtype=dtype)
        tscan.fused_topk(*map(_as_cuda, (q, v, mask)), k)
        (entry, args), = recorded
        assert entry == "pv_scan_topk_wgmma"
        assert args[:2] == (tscan.rows_piece(v),
                            0 if dtype == torch.float32 else 1)
        planes, = seen
        assert planes.shape == ((2 if dtype == torch.float32 else 3), 70, qld)
        assert args[2] == planes.data_ptr()
        assert not bool(planes[:, :, dim:].any())
        assert tscan.topk_wgmma_qtile(v, k) == qtile
        _, ranges = tscan.topk_wgmma_partition(70, CAP, 132, qtile)
        assert sizes == [70 * ranges * k]


def test_past_64m_rows_the_template(recorded, monkeypatch):
    """One query's slab over the budget (a store past 64M rows, here
    shrunk): K3 past k 384 keeps the template, and K4 past k 128 takes its
    wide kind walking the rows in ranges, at narrow widths as at TMA's."""
    monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", 4 * CAP - 1)
    mask = torch.ones(CAP, dtype=torch.bool)
    for dim in (1019, 1024):
        v = torch.zeros(CAP, dim, dtype=torch.bfloat16)
        recorded.clear()
        tscan.fused_topk(*map(_as_cuda, (torch.zeros(4, dim), v, mask)), 200)
        (entry, args), = recorded
        assert entry == "pv_scan_topk_wide"
        assert args[:2] == (tscan.rows_piece(v), tscan._KIND_BF16)
        assert args[12:14] == tscan.wide_walk(4, CAP)[:2]
        v8 = torch.zeros(CAP, dim, dtype=torch.int8)
        recorded.clear()
        tscan.fused_topk_i8(*map(_as_cuda, (torch.zeros(4, dim,
                                                        dtype=torch.int8),
                                            v8, torch.ones(CAP), mask)), 432)
        (entry, args), = recorded
        assert entry == "pv_scan_topk" and args[0] == tscan._KIND_I8


def test_new_counters_stay_zero_on_the_cpu():
    tscan.reset_launch_counts()
    mask = torch.ones(512, dtype=torch.bool)
    for dim in (25, 1019):
        v8 = torch.randint(-127, 128, (512, dim), dtype=torch.int8)
        for nq, k in ((1, 14), (16, 14), (64, 432)):
            q8 = torch.randint(-127, 128, (nq, dim), dtype=torch.int8)
            tscan.fused_topk_i8(q8, v8, torch.ones(512), mask, k)
        rows = torch.randn(512, dim).to(torch.bfloat16)
        for k in (14, 200):
            tscan.fused_topk(torch.randn(8, dim), rows, mask, k)
    assert all(n == 0 for n in tscan.LAUNCHES.values())


@pytest.mark.parametrize("cap,dim,nq,k,want", [
    # glove-100's rows at the int8 store's host-rescore band: over narrow
    # rows the wide kind serves where it reads the plane no more often
    # than the scan's 32-query tiles (a tile of 56: Q = 64 twice, as the
    # scan); over rows TMA reads its tile must hold min(Q, 64)
    (1_183_514, 100, 64, 142, "wide"), (1_183_514, 25, 64, 142, "wide"),
    (1_183_514, 96, 64, 142, "scan"), (1_183_514, 100, 128, 142, "wide"),
    (1_183_514, 100, 16, 142, "wide"), (1_183_514, 96, 16, 142, "wide"),
    # twice as many rows: a tile of 28 (Q = 32 read twice, the scan once)
    (2_367_028, 100, 64, 142, "scan"), (2_367_028, 100, 32, 142, "scan"),
    (2_367_028, 100, 16, 142, "wide"), (2_367_028, 96, 32, 142, "scan"),
    (2_367_028, 100, 64, 432, "wide"),
    # 4M rows: a tile of 16
    (4_194_304, 25, 16, 142, "wide"), (4_194_304, 25, 17, 142, "scan")])
def test_k3_wide_kind_over_narrow_rows_by_reads(cap, dim, nq, k, want):
    v = torch.empty((cap, dim), dtype=torch.int8)  # never touched
    q = torch.zeros(nq, dim, dtype=torch.int8)
    piece = tscan.rows_piece(v)
    tile = tscan.topk_wide_tile(nq, cap)
    assert tscan.i8_wide_covers(nq, cap, piece) == (
        -(-nq // tile) <= -(-nq // 32) if piece
        else tile >= min(nq, tscan.TOPK_WGMMA_QTILE))
    assert tscan.i8_wide_covers(nq, cap) == (
        tile >= min(nq, tscan.TOPK_WGMMA_QTILE))
    kind = _pick(K3_KINDS, q, v, k)
    assert kind[0] == want, (kind[0], tile)
