"""K6's two Hopper kernels, checked on the CPU.

* Which kernel K6 launches: the rules `i4_sweep_ready` (the one-query
  sweep's int4 kind, Q <= I4_SWEEP_Q_MAX) and `i4_wgmma_ready` (the
  tensor-core scan wherever neither sweep serves, at any even width and
  base), clause by clause, and the dispatch order (the sweep, its narrow
  kind, the tensor-core scan, the wide kind; the template past 64M rows
  only) with the entry points and arguments the wrapper passes, recorded
  by a stand-in for `scan._launch` on CPU tensors that report themselves
  as CUDA tensors.
* Each kernel's tile algorithm emulated in numpy, equal bit for bit to
  `scan_topk_plain(..., int4=True)` (vals and idx; ties to the lower row):
  the sweep's int4 word dot (a 16-byte row word against query words c and
  cpr + c, through __dp4a on the two masked nibble planes) over
  `sweep_partition`'s ranges, then the merge; the tensor-core scan's
  query-column permutation and in-shared-memory expansion of a packed
  64-byte slice into a [low | high] 128-byte stage (its int32 product is
  `_i4_scores`'s sum), partials per (query tile, corpus range) of
  `i4_wgmma_partition`, then the merge. Cases hold ties (duplicated rows),
  all-masked ranges and a cap that is not a multiple of 256.
* The port against the JAX package's `fused_topk_i4` in interpret mode
  at Q = 1, 16, 17 and 64 (tolerances as tests/test_torch_storage.py).
* On the CPU the wrapper runs the plain version: the counters stay 0.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

TOL_SCORE = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _store(rng, cap, dim, dup=(), masked=None):
    """Seeded int4 store: (q8 maker, packed plane, scales, mask) with rows
    `dup` = [(src, dst), ...] duplicated (equal scores: a tie) and rows
    `masked` (a slice) masked."""
    v = normalize_batch(rng.normal(size=(cap, dim)).astype(np.float32))
    for src, dst in dup:
        v[dst] = v[src]
    v4, vs = map(np.asarray, jps.quantize_rows_i4(jnp.asarray(v)))
    mask = rng.random(cap) > 0.1
    if masked is not None:
        mask[masked] = False
    return v, v4, vs, mask


def _queries(rng, v, nq):
    q = v[rng.integers(0, v.shape[0], nq)] + 0.3 * rng.normal(
        size=(nq, v.shape[1])).astype(np.float32)
    return np.asarray(jps.quantize_rows_i8(jnp.asarray(normalize_batch(q)))[0])


def _plain(q8, v4, vs, mask, k):
    vals, idx = tscan.scan_topk_plain(_t(q8), _t(v4), _t(vs), _t(mask), k,
                                      int4=True)
    return vals.numpy(), idx.numpy()


# --------------------------------------------------------------------------
# numpy emulation of the kernels' arithmetic and selection
# --------------------------------------------------------------------------


def _sbytes(w):
    """uint32 words -> their four bytes as signed ints (little-endian)."""
    b = [((w >> (8 * i)) & 0xFF).astype(np.int64) for i in range(4)]
    return [np.where(x > 127, x - 256, x) for x in b]


def _dp4a(a, b):
    """__dp4a without the accumulator: the four signed byte products."""
    return sum(x * y for x, y in zip(_sbytes(a), _sbytes(b)))


def _keys(scores, rows):
    """The kernels' 64-bit selection keys (uint64): float_order of the
    float32 score over (0xFFFFFFFF - row); 0 is an empty slot."""
    u = np.ascontiguousarray(scores, np.float32).view(np.uint32)
    u = u.astype(np.uint64)
    hi = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return (hi << np.uint64(32)) | (0xFFFFFFFF - rows.astype(np.uint64))[None, :]


def _scale(sums, q8, vs, rows):
    """The template's line: float32(sum - 8 sum(q)) * vscale[row]."""
    bias = 8 * q8.astype(np.int64).sum(axis=1, keepdims=True)
    return (sums - bias).astype(np.float32) * vs[rows][None, :]


def _best(keys, k):
    """The k largest keys per query, descending, 0-padded."""
    top = np.sort(keys, axis=1)[:, ::-1][:, :k]
    return np.pad(top, ((0, 0), (0, k - top.shape[1])))


def _partial(sums, q8, vs, mask, rows, k):
    """One CTA's partial: its k best keys per query (0 where empty)."""
    keys = _keys(_scale(sums, q8, vs, rows), rows)
    return _best(np.where(mask[rows][None, :], keys, np.uint64(0)), k)


def _merge(parts, k):
    """launch_topk_merge: the k best keys per query, decoded (empty: -inf,
    row 0)."""
    keys = _best(np.concatenate(parts, axis=1), k)
    hi = keys >> np.uint64(32)
    u = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi & 0xFFFFFFFF)
    vals = np.where(keys == 0, -np.inf,
                    u.astype(np.uint32).view(np.float32))
    idx = np.where(keys == 0, 0, 0xFFFFFFFF - (keys & np.uint64(0xFFFFFFFF)))
    return vals.astype(np.float32), idx.astype(np.int32)


def _sweep_sums(q8, v4, rows):
    """The sweep's int4 kind over `rows`: row word c (16 packed bytes)
    against query words c (low plane) and cpr + c (high plane), 8 __dp4a
    a word."""
    cpr = v4.shape[1] // 16
    words = np.ascontiguousarray(v4[rows]).view(np.uint32).reshape(
        len(rows), cpr, 4)
    qw = np.ascontiguousarray(q8).view(np.uint32).reshape(len(q8), 2 * cpr, 4)
    lo, hi = words & 0x0F0F0F0F, (words >> 4) & 0x0F0F0F0F
    s = (_dp4a(lo[None], qw[:, None, :cpr]).sum(axis=(2, 3))
         + _dp4a(hi[None], qw[:, None, cpr:]).sum(axis=(2, 3)))
    return s


def _sweep_emulated(q8, v4, vs, mask, k, sms):
    chunk, n = tscan.sweep_partition(v4.shape[0], sms)
    parts = []
    for c in range(n):
        rows = np.arange(c * chunk, min(v4.shape[0], (c + 1) * chunk))
        parts.append(_partial(_sweep_sums(q8, v4, rows), q8, vs, mask, rows, k))
    return _merge(parts, k)


def _tma_swizzle64(packed):
    """A packed slice (256 rows x 64 bytes) as TMA's 64B swizzle stores
    it: byte offset o of the row-major box lives at o ^ (((o >> 7) & 3)
    << 4)."""
    flat = packed.astype(np.uint8).reshape(-1)
    out = np.empty_like(flat)
    o = np.arange(flat.size)
    out[o ^ (((o >> 7) & 3) << 4)] = flat
    return out


def _stage_write(staging):
    """The expanders' pass over one TMA-swizzled slice: work item i takes
    16-byte chunk c = (i / 8) % 4 of row r = i % 8 + 8 (i / 32), read at
    chunk c ^ ((r >> 1) & 3), and writes its low nibbles to chunk c and its
    high nibbles to chunk c + 4 of B row r, each at chunk ^ (r % 8) (the
    128B swizzle)."""
    tile = np.zeros(256 * 128, np.uint8)
    seen = set()
    for i in range(256 * 4):
        r, c = i % 8 + 8 * (i // 32), (i // 8) % 4
        seen.add((r, c))
        off = r * 64 + 16 * (c ^ ((r >> 1) & 3))
        src = staging[off:off + 16]
        for cc, plane in ((c, src & 15), (c + 4, (src >> 4) & 15)):
            dst = r * 128 + 16 * (cc ^ (r % 8))
            tile[dst:dst + 16] = plane
    assert len(seen) == 256 * 4  # every chunk of the slice once
    return tile


def _tma_unswizzle(tile):
    """The K-major rows wgmma reads from a 128B-swizzled tile: byte offset
    o of the logical layout lives at o ^ (((o >> 7) & 7) << 4)."""
    o = np.arange(tile.size)
    return tile[o ^ (((o >> 7) & 7) << 4)].reshape(-1, 128)


def _expand_stages(v4):
    """The expansion in shared memory: each packed 64-byte slice [64 j,
    64 j + 64) of a row becomes the 128-byte stage [low nibbles | high
    nibbles], the biased planes as bytes 1..15 (0 for a zero byte)."""
    cap, half = v4.shape
    p = v4.astype(np.uint8)
    lo = (p & 15).reshape(cap, half // 64, 64)
    hi = (p >> 4).reshape(cap, half // 64, 64)
    return np.concatenate([lo, hi], axis=2).reshape(cap, 2 * half)


def _wgmma_emulated(q8, v4, vs, mask, k, sms):
    q_perm = tscan.permute_i4_queries(_t(q8)).numpy().astype(np.int64)
    b = _expand_stages(v4).astype(np.int64)
    cap = v4.shape[0]
    q_tiles, ranges = tscan.i4_wgmma_partition(len(q8), cap, sms)
    tiles = -(-cap // tscan.I4_WGMMA_BN)
    parts = {}
    for r in range(ranges):
        beg = r * tiles // ranges * tscan.I4_WGMMA_BN
        end = min(cap, (r + 1) * tiles // ranges * tscan.I4_WGMMA_BN)
        rows = np.arange(beg, end)
        for t in range(q_tiles):
            qs = slice(t * tscan.I4_WGMMA_BM, (t + 1) * tscan.I4_WGMMA_BM)
            sums = q_perm[qs] @ b[rows].T
            parts.setdefault(t, []).append(
                _partial(sums, q8[qs], vs, mask, rows, k))
    merged = [_merge(parts[t], k) for t in range(q_tiles)]
    return (np.concatenate([m[0] for m in merged]),
            np.concatenate([m[1] for m in merged]))


# --------------------------------------------------------------------------
# The emulations against the plain version, bit for bit
# --------------------------------------------------------------------------

# (cap, dim, nq, k, sms): ragged caps (not a multiple of 256 or 128), few
# SMs so ranges are short and some end ragged
SWEEP_CASES = [(1000, 64, 1, 14, 2), (1000, 96, 5, 1, 3), (1300, 64, 16, 128, 2),
               (257, 128, 2, 14, 1)]


@pytest.mark.parametrize("cap,dim,nq,k,sms", SWEEP_CASES)
def test_sweep_int4_emulation_equals_plain(cap, dim, nq, k, sms):
    rng = np.random.default_rng(cap + dim + nq)
    # duplicated rows across a range boundary and inside one; rows 256-511
    # masked: an all-masked range where ranges are 256 rows (and cap 257's
    # last range)
    v, v4, vs, mask = _store(rng, cap, dim, dup=[(3, 130), (7, 9)],
                             masked=slice(256, 512))
    q8 = _queries(rng, v, nq)
    ev, ei = _sweep_emulated(q8, v4, vs, mask, k, sms)
    pv, pi = _plain(q8, v4, vs, mask, k)
    np.testing.assert_array_equal(ev, pv)
    np.testing.assert_array_equal(ei, pi)
    # a tie goes to the lower row: row 3 before its copy at 130
    both = np.isin(pi, [3, 130]).sum(axis=1) == 2
    for i in np.nonzero(both)[0]:
        assert list(pi[i]).index(3) < list(pi[i]).index(130)


def test_sweep_word_dot_is_the_biased_int4_sum():
    """Row word c against query words c and cpr + c is the two-plane sum
    q[:d/2] . lo + q[d/2:] . hi of the packed layout."""
    rng = np.random.default_rng(5)
    v, v4, vs, mask = _store(rng, 64, 96)
    q8 = _queries(rng, v, 3)
    p = v4.astype(np.int64) & 255
    ref = (q8[:, :48].astype(np.int64) @ (p & 15).T
           + q8[:, 48:].astype(np.int64) @ ((p >> 4) & 15).T)
    np.testing.assert_array_equal(_sweep_sums(q8, v4, np.arange(64)), ref)


@pytest.mark.parametrize("cap,nq,k,sms", [(1000, 17, 14, 8), (700, 64, 1, 4),
                                          (1300, 130, 128, 6),
                                          (512, 40, 14, 1)])
def test_wgmma_emulation_equals_plain(cap, nq, k, sms):
    rng = np.random.default_rng(cap + nq)
    v, v4, vs, mask = _store(rng, cap, 128, dup=[(2, 300), (11, 12)],
                             masked=slice(256, 512))
    q8 = _queries(rng, v, nq)
    ev, ei = _wgmma_emulated(q8, v4, vs, mask, k, sms)
    pv, pi = _plain(q8, v4, vs, mask, k)
    np.testing.assert_array_equal(ev, pv)
    np.testing.assert_array_equal(ei, pi)


@pytest.mark.parametrize("dim", [128, 256, 1024])
def test_permuted_stages_give_the_i4_sum(dim):
    """permute_i4_queries(q) . _expand_stages(v) - 8 sum(q) is
    `_i4_scores`'s exact integer sum; stage j of a row is its packed bytes
    [64 j, 64 j + 64): low nibbles, then high."""
    rng = np.random.default_rng(dim)
    v, v4, vs, mask = _store(rng, 48, dim)
    q8 = _queries(rng, v, 5)
    b = _expand_stages(v4)
    p = v4.astype(np.uint8)
    for j in range(dim // 128):
        np.testing.assert_array_equal(b[:, 128 * j:128 * j + 64],
                                      p[:, 64 * j:64 * j + 64] & 15)
        np.testing.assert_array_equal(b[:, 128 * j + 64:128 * j + 128],
                                      p[:, 64 * j:64 * j + 64] >> 4)
    qp = tscan.permute_i4_queries(_t(q8)).numpy().astype(np.int64)
    sums = qp @ b.astype(np.int64).T - 8 * q8.astype(np.int64).sum(
        axis=1, keepdims=True)
    ones = torch.ones(48)
    np.testing.assert_array_equal(
        sums.astype(np.float32),
        tscan._i4_scores(_t(q8), _t(v4), ones).numpy())


def test_stage_expansion_matches_the_tma_swizzle():
    """The expanders' hand-swizzled B tile, made from the slice as TMA's
    64B swizzle stored it and read back through TMA's 128B-swizzle rule,
    is the expanded stage wgmma expects."""
    rng = np.random.default_rng(7)
    packed = rng.integers(-128, 128, size=(256, 64)).astype(np.int8)
    got = _tma_unswizzle(_stage_write(_tma_swizzle64(packed)))
    np.testing.assert_array_equal(
        got, _expand_stages(packed))


def test_plain_rounds_the_int32_sum_as_the_kernels_past_float32():
    """|sum - 8 sum(q)| <= 127 x 7 x dim stays in int32 at every width a
    store takes, and the kernels convert the exact integer once
    (__int2float_rn). At dim 19,200 (past 5,743, where `_int_acc` moves the
    plain version to float64, and past 2^24 / (127 x 7)) extreme queries
    and nibbles give biased sums above 2^24 that float32 must round; the
    plain scores are that one rounding, times the scale, and the
    tensor-core scan's emulation selects the same rows."""
    dim, cap = 19200, 300
    rng = np.random.default_rng(11)
    v4 = rng.integers(-128, 128, size=(cap, dim // 2)).astype(np.int8)
    v4[:8] = np.int8(-1)  # 0xFF: both nibbles 15, the value 7
    vs = (rng.random(cap) + 0.5).astype(np.float32)
    q8 = rng.integers(-127, 128, size=(3, dim)).astype(np.int8)
    q8[0] = 127
    q8[0, :33] = 126  # an odd sum above 2^24: float32 rounds it
    mask = np.ones(cap, bool)
    p = v4.astype(np.int64) & 255
    sums = (q8[:, :dim // 2].astype(np.int64) @ (p & 15).T
            + q8[:, dim // 2:].astype(np.int64) @ ((p >> 4) & 15).T)
    biased = sums - 8 * q8.astype(np.int64).sum(axis=1, keepdims=True)
    assert np.abs(biased).max() > 2 ** 24 and 127 * 7 * dim < 2 ** 31
    assert (biased.astype(np.float32).astype(np.int64) != biased).any()
    k = 16
    pv, pi = _plain(q8, v4, vs, mask, k)
    ref = _scale(sums, q8, vs, np.arange(cap))
    np.testing.assert_array_equal(pv, np.take_along_axis(ref, pi.astype(int), 1))
    ev, ei = _wgmma_emulated(q8, v4, vs, mask, k, 2)
    np.testing.assert_array_equal(ev, pv)
    np.testing.assert_array_equal(ei, pi)


# --------------------------------------------------------------------------
# The dispatch rules and what the wrapper launches
# --------------------------------------------------------------------------


def _operands(nq, dim, offset=0, rows=256):
    """Contiguous (nq, dim) int8 queries and a (rows, dim / 2) packed view
    `offset` bytes into a larger buffer."""
    q = torch.zeros(nq, dim, dtype=torch.int8)
    flat = torch.zeros(rows * dim // 2 + 16, dtype=torch.int8)
    return q, flat[offset:offset + rows * dim // 2].view(rows, dim // 2)


def test_i4_sweep_ready_rule():
    top = tscan.I4_SWEEP_Q_MAX
    for nq in sorted({1, 2, top}):
        q, v = _operands(nq, 96)
        assert tscan.i4_sweep_ready(q, v, 1)
        assert tscan.i4_sweep_ready(q, v, 128)
        assert not tscan.i4_sweep_ready(q, v, 129)
        assert not tscan.i4_sweep_ready(*_operands(nq, 80), 14)  # dim % 32
        assert not tscan.i4_sweep_ready(*_operands(nq, 96, offset=1), 14)
        q2, _ = _operands(nq, 96)
        assert not tscan.i4_sweep_ready(q2[:, 1:65], v, 14)  # q 1 byte off
    assert not tscan.i4_sweep_ready(*_operands(top + 1, 96), 14)
    # the query block: sweep_tile(Q) x dim bytes within 64 KB
    for nq in sorted({1, 2, top}):
        widest = tscan.SWEEP_QBLOCK_BYTES // tscan.sweep_tile(nq)
        assert tscan.i4_sweep_ready(*_operands(nq, widest, rows=1), 14)
        assert not tscan.i4_sweep_ready(*_operands(nq, widest + 32, rows=1),
                                        14)


def test_i4_wgmma_ready_rule():
    """k <= 128 wherever neither sweep takes the operands: past the
    sweeps' Q limits at every even width and base (dims off 128, 16-byte
    rows, bases off 16 bytes), and at small Q only where the narrow kind's
    phase copies do not fit its shared memory."""
    top = tscan.I4_SWEEP_Q_MAX
    assert tscan.I4_NARROW_Q_MAX >= top
    for nq in (tscan.I4_NARROW_Q_MAX + 1, 16, 17, 64, 130, 2048):
        q, v = _operands(nq, 1024, rows=4)
        assert tscan.i4_wgmma_ready(q, v, 1)
        assert tscan.i4_wgmma_ready(q, v, 128)
        assert not tscan.i4_wgmma_ready(q, v, 129)
        assert tscan.i4_wgmma_ready(*_operands(nq, 1056, rows=4), 14)
        assert tscan.i4_wgmma_ready(*_operands(nq, 1024, offset=8,
                                               rows=4), 14)
        assert tscan.i4_wgmma_ready(*_operands(nq, 100, offset=2, rows=4),
                                    14)
    assert tscan.i4_wgmma_ready(*_operands(top + 1, 128), 14)
    assert not tscan.i4_wgmma_ready(*_operands(top, 1024), 14)  # the sweep
    assert tscan.i4_wgmma_ready(*_operands(64, 96), 14)
    assert not tscan.i4_wgmma_ready(*_operands(top, 100), 14)  # narrow
    # 803 packed bytes a row: 16 phase copies of both halves overflow the
    # narrow kind at a 4-query tile, so the scan takes Q = 1 ... 4 there
    wide = _operands(top, 1606, rows=2)
    assert not tscan.i4_narrow_ready(*wide, 14)
    assert tscan.i4_wgmma_ready(*wide, 14)


def test_i4_wgmma_partition():
    # 2048 queries on 132 SMs: 32 query tiles x 4 ranges
    assert tscan.i4_wgmma_partition(2048, 1 << 24, 132) == (32, 4)
    assert tscan.i4_wgmma_partition(256, 1 << 24, 132) == (4, 33)
    assert tscan.i4_wgmma_partition(17, 1 << 24, 132) == (1, 132)
    assert tscan.i4_wgmma_partition(17, 300, 132) == (1, 2)  # 2 tiles
    assert tscan.i4_wgmma_partition(20000, 1000, 132) == (313, 1)
    assert tscan.i4_wgmma_partition(100, 0, 132) == (2, 1)


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
    """Stand-ins for `scan._launch` (records entry and arguments, checks
    the argument count against the library's signature table) and the SM
    count of a 132-SM card."""
    calls = []

    def launch(t, name, entry, *args):
        assert len(args) + 1 == len(_build._SIGNATURES[entry]), entry
        calls.append((entry, args))

    monkeypatch.setattr(tscan, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    return calls


# (Q, dim, k, offset, kernel): the sweep first (up to I4_SWEEP_Q_MAX = 4
# queries), then its narrow kind (the widths and bases the sweep cannot
# read), then the tensor-core scan (also where the sweep's query block
# overflows), then at 128 < k the wide kind; the template serves none of
# these (tests/test_torch_i4_narrow.py: only past 64M rows)
DISPATCH = [(1, 1024, 14, 0, "sweep"), (4, 96, 128, 0, "sweep"),
            (4, 16384, 14, 0, "sweep"), (4, 16416, 14, 0, "wgmma"),
            (5, 1024, 1024, 0, "wide"), (1, 80, 14, 0, "narrow"),
            (5, 1024, 14, 0, "wgmma"), (16, 1024, 14, 0, "wgmma"),
            (17, 1024, 14, 0, "wgmma"), (2048, 1024, 128, 0, "wgmma"),
            (16, 96, 14, 0, "wgmma"), (256, 1024, 129, 0, "wide"),
            (130, 1024, 14, 8, "wgmma"), (4, 1024, 14, 8, "narrow"),
            (1, 1024, 526, 0, "wide"), (5, 96, 1024, 0, "wide"),
            (64, 1024, 526, 8, "wide"), (64, 64, 526, 0, "wide")]


@pytest.mark.parametrize("nq,dim,k,offset,kernel", DISPATCH)
def test_k6_dispatch_order(recorded, nq, dim, k, offset, kernel):
    q, v = _operands(nq, dim, offset=offset, rows=256)
    vs = torch.ones(256)
    mask = torch.ones(256, dtype=torch.bool)
    before = dict(tscan.LAUNCHES)
    vals, idx = tscan.fused_topk_i4(*map(_as_cuda, (q, v, vs, mask)), k)
    assert vals.shape == idx.shape == (nq, k)
    (entry, args), = recorded
    assert entry == {"sweep": "pv_sweep_topk_i4",
                     "narrow": "pv_sweep_topk_i4_narrow",
                     "wgmma": "pv_scan_topk_i4_wgmma",
                     "wide": "pv_scan_topk_i4_wide"}[kernel]
    piece = tscan.rows_piece(v)
    if kernel in ("sweep", "narrow"):
        chunk, _ = tscan.sweep_partition(256, 132)
        assert args[:2] == (q.data_ptr(), v.data_ptr())
        assert args[7:] == (nq, 256, dim, k, chunk)
    else:  # the rows' producer, the permuted queries, the rows
        assert args[0] == piece and args[1] != q.data_ptr()
        assert args[2] == v.data_ptr()
        assert args[8:12] == (nq, 256, dim, k)
    assert tscan.LAUNCHES["scan_topk_i4"] == before["scan_topk_i4"] + 1
    for key in ("sweep", "narrow", "wgmma", "wide"):
        name = f"scan_topk_i4_{key}"
        if key in ("wgmma", "wide"):
            name += tscan._PIECE_KEY[piece]
        assert tscan.LAUNCHES[name] == before[name] + (kernel == key), name


def test_launch_shapes_split_the_count(recorded):
    """LAUNCH_SHAPES splits LAUNCHES["scan_topk_i4"] by (Q, k_sel), the
    shapes a phase's launches are weighed at; a reset clears it."""
    tscan.reset_launch_counts()
    vs = _as_cuda(torch.ones(256))
    mask = _as_cuda(torch.ones(256, dtype=torch.bool))
    for nq, k in ((1, 14), (1, 14), (2048, 14), (256, 14), (16, 1024)):
        q, v = _operands(nq, 1024)
        tscan.fused_topk_i4(_as_cuda(q), _as_cuda(v), vs, mask, k)
    assert tscan.LAUNCH_SHAPES["scan_topk_i4"] == {
        (1, 14): 2, (2048, 14): 1, (256, 14): 1, (16, 1024): 1}
    assert tscan.LAUNCHES["scan_topk_i4"] == 5
    tscan.reset_launch_counts()
    assert tscan.LAUNCH_SHAPES == {} and tscan.LAUNCHES["scan_topk_i4"] == 0


def test_counters_stay_zero_on_the_cpu():
    rng = np.random.default_rng(3)
    v, v4, vs, mask = _store(rng, 512, 128)
    tscan.reset_launch_counts()
    for nq in (1, 17):
        tscan.fused_topk_i4(_t(_queries(rng, v, nq)), _t(v4), _t(vs),
                            _t(mask), 14)
    assert tscan.LAUNCHES["scan_topk_i4"] == 0
    assert tscan.LAUNCHES["scan_topk_i4_sweep"] == 0
    assert tscan.LAUNCHES["scan_topk_i4_wgmma"] == 0


# --------------------------------------------------------------------------
# The port against the JAX package
# --------------------------------------------------------------------------


def _key_truncate(scores, bn):
    """A score as the TPU ladder reports it: the sortable float32 bits with
    the low lane_bits cleared, decoded back."""
    lane_bits = max(1, int(bn - 1).bit_length())
    key = tscan._to_sortable(_t(scores.astype(np.float32)).view(torch.int32))
    key = key & ~((1 << lane_bits) - 1)
    return tscan._from_sortable(key).view(torch.float32).numpy()


@pytest.mark.parametrize("nq", [1, 16, 17, 64])
def test_fused_topk_i4_matches_jax(nq):
    """The port's K6 (on the CPU, its plain version, which the CUDA tests
    hold all three kernels to) against `fused_topk_i4` in interpret mode:
    scores are the exact scaled int4 scores of their rows, equal to the
    ladder's after its key truncation, and id sets agree where the
    k-th/(k+1)-th gap exceeds twice that truncation."""
    rng = np.random.default_rng(100 + nq)
    cap, dim, k = 4096, 128, 14
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
    np.testing.assert_allclose(_key_truncate(tv, bn), jv, rtol=0,
                               atol=TOL_SCORE)
    full = np.where(mask, exact, -np.inf)
    srt = -np.sort(-full, axis=1)
    for i in range(nq):
        if srt[i, k - 1] - srt[i, k] > 2.0 ** -10 * abs(srt[i, k - 1]):
            assert set(ji[i].tolist()) == set(ti[i].tolist()), i
