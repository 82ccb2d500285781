"""K6 at every even width and base, checked on the CPU: the sweep's narrow
int4 kind (csrc/sweep_topk.cu `sweep_narrow_kernel<Int4>`), and the
tensor-core scan and wide kind fed past TMA (csrc/scan_i4_wgmma.cu with
PIECE 8 / 4 / 2, csrc/topk_i4_wide.cu).

* The dispatch: CPU tensors posing as CUDA tensors reach the launch, which
  a stand-in for `scan._launch` records against `_build._SIGNATURES`.
  Every (even dim in {2, 50, 64, 96, 100, 200, 300, 784, 960, 1022, 1024},
  base offset in {0, 2, 4, 8}, Q in {1, 4, 5, 64, 2048}, k in {14, 128,
  129, 526, 1024}) takes exactly one kind other than the template, the
  tensor-core kinds with the producer `rows_piece` names (their first
  argument and their counter's suffix); the template only past 64M rows
  (one query's slab over TOPK_WIDE_SLAB_BYTES) at k > 128.
* The kernels' reads and arithmetic emulated in numpy over a byte array
  standing for device memory (the packed plane at a base offset, poison
  bytes before and after it), each bit for bit `scan_topk_plain(...,
  int4=True)`: the permuted queries with each half padded to whole stages
  and a partial last stage; the expanders' 8- / 4-byte words and the
  realigning five-word reads, nonzero neighbour bytes past a row's end
  meeting zero query columns, no read outside the aligned words that hold
  a byte of the row; the wide kind's slab and pass B; the narrow kind's
  phase copies of both halves. Cases hold ties, all-masked ranges and caps
  that are not a multiple of 256.
* The port against the JAX package's `fused_topk_i4` in interpret mode at
  dims 96 / 100 / 200, Q = 1 / 17 / 64, k_sel 14 and 526; an int4
  `PicoVectorDB` (JAX against the port, on the CPU) at dim 100.
"""

import types

import numpy as np
import pytest
import torch

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from test_torch_i4_kernels import (_key_truncate, _merge, _partial, _plain,
                                   _queries, _scale, _store)
from test_torch_topk_wide import decode, float_order, pass_b
from torch_port_setup import cap_torch_threads, cpu_kw

cap_torch_threads()

SEG = tscan.SEG
STAGE = tscan.I4_STAGE_BYTES


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# The dispatch over widths, bases, Q and k
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
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    return calls


def _view(rows, cols, off):
    """A contiguous (rows, cols) int8 view `off` bytes into a buffer."""
    flat = torch.zeros(rows * cols + 32, dtype=torch.int8)
    return flat[off:off + rows * cols].view(rows, cols)


KINDS = {"sweep": ("pv_sweep_topk_i4", "scan_topk_i4_sweep"),
         "narrow": ("pv_sweep_topk_i4_narrow", "scan_topk_i4_narrow"),
         "scan": ("pv_scan_topk_i4_wgmma", "scan_topk_i4_wgmma"),
         "wide": ("pv_scan_topk_i4_wide", "scan_topk_i4_wide")}


def _kind(q, v, k):
    rules = {"sweep": tscan.i4_sweep_ready, "narrow": tscan.i4_narrow_ready,
             "scan": tscan.i4_wgmma_ready, "wide": tscan.i4_wide_ready}
    took = [name for name, rule in rules.items() if rule(q, v, k)]
    assert len(took) <= 1, took
    return took[0] if took else "template"


def _launch_one(recorded, q, v, k, nq, dim, cap):
    """One K6 call: the recorded entry and arguments, with the counters
    checked against the kind the ready rules name."""
    kind = _kind(q, v, k)
    vs = torch.ones(cap)
    mask = torch.ones(cap, dtype=torch.bool)
    before = dict(tscan.LAUNCHES)
    recorded.clear()
    vals, idx = tscan.fused_topk_i4(*map(_as_cuda, (q, v, vs, mask)), k)
    assert vals.shape == idx.shape == (nq, k)
    (entry, args), = recorded
    piece = tscan.rows_piece(v)
    assert tscan.LAUNCHES["scan_topk_i4"] == before["scan_topk_i4"] + 1
    if kind == "template":
        assert entry == "pv_scan_topk" and args[0] == tscan._KIND_I4
        return kind, piece
    name, key = KINDS[kind]
    if kind == "wide":  # the rows in ranges (`topk_wide_plan`), counted
        q_tile, rows, ranges = tscan.wide_walk(nq, cap)
        assert args[12:14] == (q_tile, rows)
        rkey = "scan_topk_i4_wide_ranges"
        assert tscan.LAUNCHES[rkey] == before[rkey] + (ranges > 1)
    assert entry == name, (kind, entry)
    if kind in ("scan", "wide"):
        key += tscan._PIECE_KEY[piece]
        assert args[0] == piece in (0, 8, 4, 2)
        assert args[1] != q.data_ptr() and args[2] == v.data_ptr()
        assert args[8:12] == (nq, cap, dim, k)
    else:
        assert args[:2] == (q.data_ptr(), v.data_ptr())
        assert args[7:11] == (nq, cap, dim, k)
    assert tscan.LAUNCHES[key] == before[key] + 1, key
    if kind != "sweep":
        assert tscan.LAUNCH_SHAPES[key][nq, k] >= 1
    return kind, piece


CAP = 512


@pytest.mark.parametrize("dim", [2, 50, 64, 96, 100, 200, 300, 784, 960,
                                 1022, 1024])
def test_every_even_width_and_base_takes_one_kind(recorded, dim):
    seen = set()
    for off in (0, 2, 4, 8):
        v = _view(CAP, dim // 2, off)
        # TMA reads the packed rows exactly where they are whole 16 bytes
        # at a 16-byte aligned base
        assert (tscan.rows_piece(v) == 0) == (dim % 32 == 0 and off == 0)
        for nq in (1, 4, 5, 64, 2048):
            q = _view(nq, dim, 0)
            for k in (14, 128, 129, 526, 1024):
                kind, piece = _launch_one(recorded, q, v, k, nq, dim, CAP)
                assert kind != "template", (dim, off, nq, k)
                assert (kind == "wide") == (k > 128)
                if nq > tscan.I4_NARROW_Q_MAX and k <= 128:
                    assert kind == "scan"
                if kind == "narrow":  # rows the 16-byte sweep cannot read
                    assert dim % 32 or off
                seen.add((kind, piece))
    kinds = {kind for kind, _ in seen}
    assert {"scan", "wide"} <= kinds
    assert kinds & {"sweep", "narrow"}
    if dim % 32:
        assert "sweep" not in kinds


@pytest.mark.parametrize("dim", [50, 100, 1024])
def test_template_only_past_the_slab_budget(recorded, monkeypatch, dim):
    """One query's slab over TOPK_WIDE_SLAB_BYTES (64M rows; here the
    budget is lowered below this plane's slab) no longer keeps the
    template: k > 128 takes the wide kind walking the rows in ranges
    (`scan_topk_i4_wide_ranges`), k <= 128 the kinds it took."""
    ld = -(-CAP // SEG) * SEG
    monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", 4 * ld - 1)
    for off in (0, 2):
        v = _view(CAP, dim // 2, off)
        for nq in (1, 5, 64):
            q = _view(nq, dim, 0)
            for k in (14, 128, 129, 1024):
                kind, _ = _launch_one(recorded, q, v, k, nq, dim, CAP)
                assert kind != "template", (off, nq, k)
                assert (kind == "wide") == (k > 128), (off, nq, k, kind)
                if k > 128:
                    assert tscan.wide_walk(nq, CAP)[2] > 1


def test_narrow_rule_edges():
    """Q up to I4_NARROW_Q_MAX over rows of at most 16 words (up to
    I4_NARROW_WIDE_Q_MAX over longer ones), k <= 128, operands the 16-byte
    sweep cannot read, within NARROW_SMEM_BYTES; the shared memory as
    csrc/sweep_topk.cu `Narrow::smem` counts it."""
    wide = tscan.I4_NARROW_WIDE_Q_MAX
    assert tscan.I4_SWEEP_Q_MAX <= wide <= tscan.I4_NARROW_Q_MAX
    # dim 300: 150-byte rows, 11 words; dim 784: 392 bytes, 25 words
    assert tscan.i4_narrow_words(300, 0) == 11
    assert tscan.i4_narrow_words(784, 0) == 25
    for dim, top in ((300, tscan.I4_NARROW_Q_MAX), (784, wide)):
        v = _view(8, dim // 2, 0)
        assert tscan.i4_narrow_ready(_view(top, dim, 0), v, 14)
        assert not tscan.i4_narrow_ready(_view(top + 1, dim, 0), v, 14)
    # rows the 16-byte sweep reads take the scan past its Q limit, not the
    # narrow kind
    for nq in (tscan.I4_SWEEP_Q_MAX + 1, tscan.I4_NARROW_Q_MAX):
        assert not tscan.i4_narrow_ready(_view(nq, 96, 0), _view(8, 48, 0),
                                         14)
    top = tscan.I4_NARROW_Q_MAX
    for nq in range(1, top + 1):
        assert tscan.i4_narrow_ready(_view(nq, 100, 0), _view(8, 50, 0), 128)
        assert not tscan.i4_narrow_ready(_view(nq, 100, 0), _view(8, 50, 0),
                                         129)
        # rows the 16-byte sweep reads: its kind, not the narrow one
        assert not tscan.i4_narrow_ready(_view(nq, 96, 0), _view(8, 48, 0),
                                         14)
        # ... but a query off 16 bytes, or rows off 16, go narrow
        assert tscan.i4_narrow_ready(_view(nq, 96, 4), _view(8, 48, 0), 14)
        assert tscan.i4_narrow_ready(_view(nq, 96, 0), _view(8, 48, 2), 14)
    assert not tscan.i4_narrow_ready(_view(top + 1, 100, 0), _view(8, 50, 0),
                                     14)
    # 50 packed bytes at a 2-byte aligned base: g = 2, 8 phases, W = 4
    assert tscan.i4_narrow_bytes(4, 100, 2) == 2 * 8 * 4 * 4 * 16 + 4 * 2064
    for dim in (1602, 1606):
        fits = tscan.i4_narrow_bytes(4, dim, 1) <= tscan.NARROW_SMEM_BYTES
        assert fits == (dim == 1602)
        assert tscan.i4_narrow_ready(_view(4, dim, 0), _view(2, dim // 2, 1),
                                     14) == fits


# --------------------------------------------------------------------------
# The permutation: each half padded to whole stages on its own
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [2, 50, 64, 96, 100, 200, 300, 1022])
def test_permutation_pads_each_half(dim):
    rng = np.random.default_rng(dim)
    q8 = rng.integers(-127, 128, size=(3, dim)).astype(np.int8)
    qp = tscan.permute_i4_queries(_t(q8)).numpy()
    half = dim // 2
    stages = -(-half // STAGE)
    assert qp.shape == (3, 2 * STAGE * stages)
    lo = np.zeros((3, STAGE * stages), np.int8)
    hi = np.zeros((3, STAGE * stages), np.int8)
    lo[:, :half], hi[:, :half] = q8[:, :half], q8[:, half:]
    for j in range(stages):
        st = qp[:, 2 * STAGE * j:2 * STAGE * (j + 1)]
        np.testing.assert_array_equal(st[:, :STAGE],
                                      lo[:, STAGE * j:STAGE * (j + 1)])
        np.testing.assert_array_equal(st[:, STAGE:],
                                      hi[:, STAGE * j:STAGE * (j + 1)])
    # the padded columns are zero in both halves; the query sum is kept
    assert qp.astype(np.int64).sum(1).tolist() == \
        q8.astype(np.int64).sum(1).tolist()


# --------------------------------------------------------------------------
# The reads of the rows, over a byte array standing for device memory
# --------------------------------------------------------------------------


class Memory:
    """The packed plane `v4` at byte `base` of an array whose other bytes
    are nonzero poison (buffer byte 0 stands at a 16-byte aligned address).
    `read` returns bytes and records the span it read."""

    def __init__(self, v4, base, rng):
        cap, rb = v4.shape
        self.rb, self.base, self.cap = rb, base, cap
        self.buf = rng.integers(1, 256, size=base + cap * rb + 64,
                                dtype=np.uint8)
        self.buf[base:base + cap * rb] = v4.view(np.uint8).reshape(-1)
        self.reads = []

    def row(self, r):
        return self.base + r * self.rb, self.base + (r + 1) * self.rb

    def read(self, a, n, r):
        self.reads.append((a, n, r))
        return self.buf[a:a + n]

    def check_reads(self):
        """Every read lies in the aligned words (of the read's size) that
        hold a byte of its row, and inside the buffer."""
        for a, n, r in self.reads:
            start, end = self.row(r)
            assert a % n == 0 and a < end and a + n > start, (a, n, r)
            assert a + n <= len(self.buf)


def load_chunk(mem, r, off, piece):
    """csrc/scan_i4_wgmma.cu `load_chunk<PIECE>` (PIECE 0: TMA's box, zero
    past the row): bytes [off, off + 16) of row r, off < rb."""
    start, end = mem.row(r)
    a = start + off
    out = np.zeros(16, np.uint8)
    if piece == 0:
        n = min(16, end - a)
        out[:n] = mem.buf[a:a + n]
    elif piece in (8, 4):
        for i in range(16 // piece):
            if a + piece * i < end:
                out[piece * i:piece * (i + 1)] = mem.read(a + piece * i,
                                                          piece, r)
    else:
        a4, sh = a & ~3, a & 3
        raw = np.zeros(20, np.uint8)
        for i in range(5):
            if a4 + 4 * i < end and (i < 4 or sh):
                raw[4 * i:4 * i + 4] = mem.read(a4 + 4 * i, 4, r)
        out = raw[sh:sh + 16]
    return out


def expanded_rows(mem, piece):
    """The B rows the expanders write, stage by stage: for each row below
    cap, chunk c of stage j (bytes 64 j + 16 c ..) read as `load_chunk`
    reads it where it starts inside the row (else zero), split into
    [low nibbles | high nibbles] of the stage's 64 bytes."""
    cap, rb = mem.cap, mem.rb
    stages = -(-rb // STAGE)
    b = np.zeros((cap, 2 * STAGE * stages), np.uint8)
    for r in range(cap):
        for j in range(stages):
            raw = np.zeros(STAGE, np.uint8)
            for c in range(STAGE // 16):
                off = STAGE * j + 16 * c
                if off < rb:
                    raw[16 * c:16 * c + 16] = load_chunk(mem, r, off, piece)
            b[r, 2 * STAGE * j:2 * STAGE * j + STAGE] = raw & 15
            b[r, 2 * STAGE * j + STAGE:2 * STAGE * (j + 1)] = raw >> 4
    return b


def scan_sums(q8, mem, piece):
    """The scan's int32 sums before the bias: the permuted queries against
    the expanded stages."""
    qp = tscan.permute_i4_queries(_t(q8)).numpy().astype(np.int64)
    return qp @ expanded_rows(mem, piece).astype(np.int64).T


def scan_emulated(q8, mem, piece, vs, mask, k, sms):
    sums = scan_sums(q8, mem, piece)
    cap = mem.cap
    q_tiles, ranges = tscan.i4_wgmma_partition(len(q8), cap, sms)
    tiles = -(-cap // tscan.I4_WGMMA_BN)
    parts = {}
    for rg in range(ranges):
        rows = np.arange(rg * tiles // ranges * tscan.I4_WGMMA_BN,
                         min(cap, (rg + 1) * tiles // ranges
                             * tscan.I4_WGMMA_BN))
        for t in range(q_tiles):
            qs = slice(t * tscan.I4_WGMMA_BM, (t + 1) * tscan.I4_WGMMA_BM)
            parts.setdefault(t, []).append(
                _partial(sums[qs][:, rows], q8[qs], vs, mask, rows, k))
    merged = [_merge(parts[t], k) for t in range(q_tiles)]
    return (np.concatenate([m[0] for m in merged]),
            np.concatenate([m[1] for m in merged]))


def wide_emulated(q8, mem, piece, vs, mask, k):
    """Pass A's slab over the same reads, then pass B a query."""
    rows = np.arange(mem.cap)
    slab = float_order(_scale(scan_sums(q8, mem, piece), q8, vs, rows))
    out = [decode(pass_b(slab[i], mask, k)) for i in range(len(q8))]
    return (np.stack([o[0] for o in out]),
            np.stack([o[1] for o in out]).astype(np.int32))


def _case(dim, cap, nq, seed, dup=((3, 130), (7, 9), (40, 700))):
    rng = np.random.default_rng(seed)
    dup = [(s, d) for s, d in dup if d < cap]
    v, v4, vs, mask = _store(rng, cap, dim, dup=dup, masked=slice(256, 512))
    return rng, v4, vs, mask, _queries(rng, v, nq)


# (dim, base offset, piece): 200 -> 100-byte rows (cp.async's 4-byte
# words), 784 -> 392 (8-byte), 100 -> 50 and 300 -> 150 (realigning), 96
# -> 48 at an aligned base (TMA, a partial last stage) and at an odd one
SCAN_CASES = [(200, 0, 4), (784, 0, 8), (100, 0, 2), (300, 0, 2),
              (96, 0, 0), (96, 1, 2), (960, 8, 8), (50, 6, 2), (2, 3, 2)]


@pytest.mark.parametrize("dim,base,piece", SCAN_CASES)
def test_scan_reads_past_tma_equal_plain(dim, base, piece):
    """The scan over rows read by `piece` (nonzero neighbour and poison
    bytes past each row), bit for bit the plain version, at a cap off a
    multiple of 256 with ties and an all-masked range."""
    cap, nq, k = 1000, 17, 14
    rng, v4, vs, mask, q8 = _case(dim, cap, nq, dim + base)
    mem = Memory(v4, base, rng)
    flat = torch.zeros(base + v4.size + 16, dtype=torch.int8)
    view = flat[base:base + v4.size].view(cap, dim // 2)
    assert tscan.rows_piece(view) == piece
    ev, ei = scan_emulated(q8, mem, piece, vs, mask, k, sms=6)
    mem.check_reads()
    assert piece == 0 or mem.reads
    pv, pi = _plain(q8, v4, vs, mask, k)
    np.testing.assert_array_equal(ev, pv)
    np.testing.assert_array_equal(ei, pi)
    both = np.isin(pi, [3, 130]).sum(axis=1) == 2  # ties to the lower row
    for i in np.nonzero(both)[0]:
        assert list(pi[i]).index(3) < list(pi[i]).index(130)


@pytest.mark.parametrize("dim,base,piece", [(100, 2, 2), (200, 4, 4),
                                            (784, 8, 8), (96, 0, 0)])
def test_scan_sums_are_the_i4_sum(dim, base, piece):
    """The permuted queries against the stages read by each producer give
    `_i4_scores`'s exact integer sum: the padded columns cancel the
    neighbour's bytes in both planes."""
    rng, v4, vs, mask, q8 = _case(dim, 300, 5, 3 * dim + base)
    mem = Memory(v4, base, rng)
    sums = scan_sums(q8, mem, piece)
    bias = 8 * q8.astype(np.int64).sum(axis=1, keepdims=True)
    np.testing.assert_array_equal(
        (sums - bias).astype(np.float32),
        tscan._i4_scores(_t(q8), _t(v4), torch.ones(300)).numpy())


@pytest.mark.parametrize("dim,base,piece", [(100, 0, 2), (200, 0, 4),
                                            (96, 0, 0), (784, 8, 8)])
@pytest.mark.parametrize("k", [129, 526])
def test_wide_reads_past_tma_equal_plain(dim, base, piece, k):
    """The wide kind over the same reads: the slab of score keys, then
    pass B, bit for bit the plain version, all rows masked included."""
    cap = 1300
    rng, v4, vs, mask, q8 = _case(dim, cap, 3, dim + k)
    mem = Memory(v4, base, rng)
    got = wide_emulated(q8, mem, piece, vs, mask, k)
    mem.check_reads()
    ref = _plain(q8, v4, vs, mask, k)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    none = np.zeros(cap, bool)
    vals, idx = wide_emulated(q8[:1], mem, piece, vs, none, k)
    assert np.isneginf(vals).all() and not idx.any()


# --------------------------------------------------------------------------
# The narrow kind: phase copies of both halves
# --------------------------------------------------------------------------


def narrow_copies(q8, rb, g):
    """The query block: copy j of each query holds, per half, j g zero
    bytes, the half's rb bytes, zeros to W words (csrc/sweep_topk.cu)."""
    phases = 16 // g
    words = -(-(16 - g + rb) // 16)
    out = np.zeros((phases, len(q8), 2, 16 * words), np.int64)
    for j in range(phases):
        for h in range(2):
            out[j, :, h, j * g:j * g + rb] = q8[:, h * rb:(h + 1) * rb]
    return out, words


def narrow_sums(q8, mem):
    """Each row read as the aligned 16-byte words that hold a byte of it,
    met with the copy of its phase: low nibbles against the first half's,
    high against the second's."""
    rb = mem.rb
    g = 16 // tscan.narrow_phases(rb, mem.base)
    copies, words = narrow_copies(q8, rb, g)
    sums = np.zeros((len(q8), mem.cap), np.int64)
    for r in range(mem.cap):
        start, end = mem.row(r)
        ph = start % 16
        assert ph % g == 0
        nw = (ph + rb + 15) // 16
        assert nw <= words
        x = np.concatenate([mem.read(start - ph + 16 * c, 16, r)
                            for c in range(nw)]).astype(np.int64)
        cp = copies[ph // g][:, :, :16 * nw]
        sums[:, r] = cp[:, 0] @ (x & 15) + cp[:, 1] @ (x >> 4)
    return sums


def narrow_emulated(q8, mem, vs, mask, k, sms):
    sums = narrow_sums(q8, mem)
    chunk, n = tscan.sweep_partition(mem.cap, sms)
    parts = []
    for c in range(n):
        rows = np.arange(c * chunk, min(mem.cap, (c + 1) * chunk))
        parts.append(_partial(sums[:, rows], q8, vs, mask, rows, k))
    return _merge(parts, k)


@pytest.mark.parametrize("dim,base", [(100, 0), (100, 2), (200, 0),
                                      (300, 5), (784, 8), (96, 4), (2, 1),
                                      (1022, 0)])
@pytest.mark.parametrize("nq,k", [(1, 14), (4, 128)])
def test_narrow_emulation_equals_plain(dim, base, nq, k):
    cap = 1000
    rng, v4, vs, mask, q8 = _case(dim, cap, nq, dim + base + k)
    mem = Memory(v4, base, rng)
    ev, ei = narrow_emulated(q8, mem, vs, mask, k, sms=3)
    mem.check_reads()
    pv, pi = _plain(q8, v4, vs, mask, k)
    np.testing.assert_array_equal(ev, pv)
    np.testing.assert_array_equal(ei, pi)


def test_narrow_neighbour_nibbles_meet_zeros():
    """Rows whose neighbours' bytes are all 0xFF (both nibbles 15): the
    words a row shares with them add nothing to its sum."""
    rng = np.random.default_rng(8)
    dim, cap = 100, 64
    v4 = rng.integers(-128, 128, size=(cap, dim // 2)).astype(np.int8)
    v4[1::2] = np.int8(-1)
    q8 = rng.integers(-127, 128, size=(2, dim)).astype(np.int8)
    p = v4.astype(np.int64) & 255
    ref = (q8[:, :50].astype(np.int64) @ (p & 15).T
           + q8[:, 50:].astype(np.int64) @ (p >> 4).T)
    for base in (0, 2, 6):
        mem = Memory(v4, base, rng)
        np.testing.assert_array_equal(narrow_sums(q8, mem), ref)
        np.testing.assert_array_equal(scan_sums(q8, mem, 2), ref)


# --------------------------------------------------------------------------
# The port against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [96, 100, 200])
@pytest.mark.parametrize("nq", [1, 17, 64])
@pytest.mark.parametrize("k", [14, 526])
def test_fused_topk_i4_matches_jax_at_other_widths(dim, nq, k):
    """The port's K6 (on the CPU, its plain version, which the CUDA tests
    hold every kind to) against `fused_topk_i4` in interpret mode: scores
    are the exact scaled int4 scores of their rows, equal to JAX's after
    its key truncation (k = 14: the ladder) or bit for bit (k = 526: its
    dense fallback), and id sets agree where the k-th/(k+1)-th gap exceeds
    twice the truncation."""
    rng = np.random.default_rng(1000 + dim + nq + k)
    cap = 2048
    v, v4, vs, mask = _store(rng, cap, dim)
    q8 = _queries(rng, v, nq)
    jv, ji = map(np.asarray, jps.fused_topk_i4(q8, v4, vs, mask, k,
                                               interpret=True))
    tv, ti = tscan.fused_topk_i4(_t(q8), _t(v4), _t(vs), _t(mask), k)
    tv, ti = tv.numpy(), ti.numpy()
    assert np.isfinite(tv).all() and mask[ti].all()
    exact = tscan._i4_scores(_t(q8), _t(v4), _t(vs)).numpy()
    np.testing.assert_array_equal(np.take_along_axis(exact, ti.astype(int), 1),
                                  tv)
    bn = jps._pick_bn(dim, min(jps.DEFAULT_QT, nq), k, 1, cap, 4096)
    full = np.where(mask, exact, -np.inf)
    srt = -np.sort(-full, axis=1)
    if k > bn:  # the dense fallback: the same float32 scores
        np.testing.assert_array_equal(tv, jv)
    else:
        np.testing.assert_allclose(_key_truncate(tv, bn), jv, rtol=0,
                                   atol=1e-6)
    for i in range(nq):
        if srt[i, k - 1] - srt[i, k] > 2.0 ** -10 * abs(srt[i, k - 1]):
            assert set(ji[i].tolist()) == set(ti[i].tolist()), i


def test_int4_store_matches_jax_at_dim_100(tmp_path):
    """An int4 `PicoVectorDB` at glove-100's width, host-uploaded (the host
    rescore: K6 at k + 512 + 4), in both packages: the same route, scores
    within 1e-5 and ids outside a 1e-4 k/k+1 gap, single queries, a batch
    and `query_columnar`."""
    dim, n = 100, 6000
    rng = np.random.default_rng(23)
    data = normalize_batch(rng.normal(size=(n, dim)).astype(np.float32))
    dbs = {}
    for name, pkg in (("jax", picovdb_tpu), ("torch", picovdb_tpu_torch)):
        db = pkg.PicoVectorDB(embedding_dim=dim, storage_dtype="int4",
                              storage_file=str(tmp_path / name),
                              use_pallas=True, **cpu_kw(pkg))
        db.upsert_columnar(data, ids=[str(i) for i in range(n)])
        dbs[name] = db
    q = data[rng.integers(0, n, 12)] + 0.05 * rng.normal(
        size=(12, dim)).astype(np.float32)
    qn = normalize_batch(q).astype(np.float64)
    s = -np.sort(-(qn @ data.astype(np.float64).T), axis=1)
    gaps = s[:, 9] - s[:, 10]
    for batch in (q[:1], q):
        got = {name: db.query(batch, top_k=10) for name, db in dbs.items()}
        routes = {name: db.last_query_debug()["strategy"]
                  for name, db in dbs.items()}
        assert routes["jax"] == routes["torch"] == "i4stor_fused", routes
        assert len(got["jax"]) == len(got["torch"]) == batch.shape[0]
        for i, (hj, ht) in enumerate(zip(got["jax"], got["torch"])):
            np.testing.assert_allclose(
                [h[picovdb_tpu.K_METRICS] for h in ht],
                [h[picovdb_tpu.K_METRICS] for h in hj], rtol=0, atol=1e-5)
            if gaps[i] > 1e-4:
                assert ({h[picovdb_tpu.K_ID] for h in hj}
                        == {h[picovdb_tpu.K_ID] for h in ht}), i
    cols = {name: db.query_columnar(q, top_k=10) for name, db in dbs.items()}
    for i in range(12):
        if gaps[i] > 1e-4:
            assert set(cols["jax"][0][i]) == set(cols["torch"][0][i]), i
