"""K5 and K10 over int8 rows TMA cannot read, checked on the CPU: the int8
mainloop (csrc/wgmma_tiles.cuh) fed by cp.async (`cp_stage`, PIECE 8 / 4)
or by the realigning producer with sixteen row classes (`ClassMaps<16>`,
`encode_class`, `stage_boxes`, `realign_box`), csrc/segmax.cu
`pv_segmax_scan_i8[c]_cpasync` / `_realign`.

* Both producers, emulated in numpy over a flat byte array that stands for
  device memory (the operand at a byte offset from a 16-byte boundary,
  poison around it), for a 128-row query box and a 256-row corpus box at
  widths 25 / 100 / 200 / 1019 / 1020 / 1 / 17 and offsets 0 / 1 / 2 / 4 /
  8. cp.async (where the row bytes and the base are multiples of 4):
  thread t copies piece t % (128 / PIECE) of rows t / (128 / PIECE), ...
  to TMA's swizzled offsets, zero-filling past the row and the box's rows.
  The realigning producer: class j's map holds rows j, j + 16, ... as a
  2D tensor of stride 16 row bytes (a multiple of 16 at any width), based
  at row j's start aligned down to 16 bytes (`off` bytes before it); its
  box of 144 bytes x ROWS / 16 rows at byte 128 k holds each row's slice k
  at byte off; thread t moves piece t % 8 of rows t / 8 + 16 p (all of
  class t / 8) out of the staging slot by two 16-byte loads shifted by
  `off` bytes (`shift_pair`: word selects, a funnel shift of 0, 8, 16 or
  24 bits) into the ring. Every stage is exactly TMA's 128B-swizzled box
  of the zero-padded rows, every stage byte is written once, and every
  byte read lies in a 16-byte chunk that holds a byte of the operand, none
  past its end.
* Unswizzled, the stages give back the zero-padded operands, so their
  exact int32 products, packed as K5's keys (converted, times the row
  scale) and K10's (the raw sums), are the plain versions' bit for bit.
* The ready rules (`wgmma_i8_ready`, `cpasync_i8_ready`,
  `realign_i8_ready`) name exactly one producer for every (int8 width,
  base) pair; K5's and K10's dispatch, recorded on CPU tensors posing as
  CUDA ones against `_build._SIGNATURES` (and on meta tensors of 64M rows),
  takes that producer's entry at every Q and never the mma.sync tile's
  (`pv_segmax_scan_i8`, `pv_segmax_scan_i8c`).
* The port against the JAX package: K5's and K10's keys (the TPU kernels
  in interpret mode) at dims 25 / 100 / 200, bit for bit, and
  `make_segmax_topk_i8(rescore_dequant=True)` end to end at dim 25.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads, tma_box

cap_torch_threads()

SEG = tscan.SEG
ROW_BYTES = 128  # bytes of a row a k-stage
PRODUCERS = 128  # threads of the producer warpgroup
POISON = 0xEE  # device memory around the operand
CLASSES = 16  # the int8 realigning producer's row classes
STAGE_ROW = 144  # bytes of a staged row's span
BM, BN = 128, 256  # the mainloop's query and corpus boxes
DIMS = [25, 100, 200, 1019, 1020, 1, 17]
OFFSETS = [0, 1, 2, 4, 8]


def _i8_bytes(rng, rows, dim):
    return rng.integers(-127, 128, (rows, dim), dtype=np.int8).view(np.uint8)


def _memory(mat, offset):
    """Device memory holding `mat` (rows, row bytes) at a 16-byte boundary
    plus `offset`, poison around it: (memory, base)."""
    base = 64 + offset
    mem = np.full(base + mat.size + 64, POISON, dtype=np.uint8)
    mem[base:base + mat.size] = mat.reshape(-1)
    return mem, base


def _piece(dim, *offsets):
    bits = dim
    for off in offsets:
        bits |= off
    return 8 if bits % 8 == 0 else 4 if bits % 4 == 0 else 0


def _cp_stage(mem, base, row_bytes, rows_total, row0, k, nrows, piece, read):
    """`cp_stage<piece, nrows>` for every producer thread: (stage bytes,
    times each was written). Every byte read is marked in `read`."""
    stage = np.full(nrows * ROW_BYTES, 0xAB, dtype=np.uint8)  # poison
    writes = np.zeros(nrows * ROW_BYTES, dtype=np.int64)
    per_row = ROW_BYTES // piece
    row_step = PRODUCERS // per_row
    rows_left = rows_total - row0
    t = np.arange(PRODUCERS)
    b = (t % per_row) * piece
    col = k * ROW_BYTES + b
    lim = np.where(col >= row_bytes, 0, min(rows_left, nrows))
    for i in range(nrows // row_step):
        r = t // per_row + i * row_step
        d = r * ROW_BYTES + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15))
        ok = r < lim
        a = base + (row0 + r) * row_bytes + col
        assert (a[ok] % piece == 0).all()  # cp.async's alignment
        assert (col[ok] + piece <= row_bytes).all()  # no piece crosses the end
        src = np.zeros((PRODUCERS, piece), dtype=np.uint8)  # src-size 0
        idx = a[ok, None] + np.arange(piece)
        src[ok] = mem[idx]
        read[idx] = True
        dst = d[:, None] + np.arange(piece)
        stage[dst] = src
        np.add.at(writes, dst.reshape(-1), 1)
    return stage, writes


def _shift_pair(lo, hi, off):
    """`shift_pair`: the 16 bytes at byte `off` (any, 0..15) of lo | hi,
    word by word."""
    z = np.concatenate([lo, hi], axis=-1)  # (..., 8) words
    w1, w2 = (off & 4) != 0, (off & 8) != 0
    t = np.where(w1[..., None], z[..., 1:8], z[..., 0:7])
    u = np.where(w2[..., None], t[..., 2:7], t[..., 0:5])
    sh = ((off & 3) * 8).astype(np.uint64)[..., None]
    pair = u[..., :4].astype(np.uint64) | (u[..., 1:5].astype(np.uint64) << 32)
    return ((pair >> sh) & 0xFFFFFFFF).astype(np.uint32)  # __funnelshift_r


def _class_box(mem, base, row_bytes, rows_total, row0, k, nrows, j, read):
    """TMA's box of class j's map (144 bytes x nrows / 16 rows,
    unswizzled) and off_j (bytes; -1 where the matrix has no row j): rows
    j, j + 16, ... of the matrix whose row 0 starts at byte `base`."""
    per = nrows // CLASSES
    box = np.full((per, STAGE_ROW), 0x5A, dtype=np.uint8)  # stale
    if rows_total <= j:
        return box, -1  # no map, no load: the slot keeps stale bytes
    start = base + j * row_bytes
    map_base = start & ~15
    off = start - map_base
    n_j = -(-(rows_total - j) // CLASSES)
    stride = CLASSES * row_bytes
    assert stride % 16 == 0 and map_base % 16 == 0
    m = np.arange(row0 // CLASSES, row0 // CLASSES + per)[:, None]
    c = np.arange(k * ROW_BYTES, k * ROW_BYTES + STAGE_ROW)[None, :]
    live = (m < n_j) & (c < row_bytes + off)  # the map's extent
    addr = map_base + m * stride + c
    box[:] = 0
    box[live] = mem[addr[live]]
    read[addr[live]] = True
    return box, off


def _realign_stage(mem, base, row_bytes, rows_total, row0, k, nrows, read):
    """`stage_boxes<Int8>` then `realign_box<nrows, 16>` for one box of
    nrows rows: (stage bytes, times each byte was written)."""
    per = nrows // CLASSES
    boxes, offs = zip(*(_class_box(mem, base, row_bytes, rows_total, row0, k,
                                   nrows, j, read) for j in range(CLASSES)))
    slot = np.concatenate([b.reshape(-1) for b in boxes])
    t = np.arange(PRODUCERS)
    c, r0 = t % 8, t // 8
    j = r0 % CLASSES
    p = np.arange(nrows // 16)[:, None]
    r = r0[None, :] + 16 * p  # (passes, 128)
    src = ((j * per + r0 // CLASSES) * STAGE_ROW + 16 * c)[None, :] \
        + (16 // CLASSES) * p * STAGE_ROW
    assert ((r % CLASSES == j) & (src == (j * per + r // CLASSES) * STAGE_ROW
                                  + 16 * c)).all()  # row r / 16 of class j
    words = slot.view("<u4")
    lo = words[(src // 4)[..., None] + np.arange(4)]
    hi = words[(src // 4 + 4)[..., None] + np.arange(4)]
    off = np.array(offs)[j][None, :].repeat(len(p), 0)
    out = _shift_pair(lo, hi, np.maximum(off, 0))
    out[off < 0] = 0  # a class with no row: zeros
    stage = np.full(nrows * ROW_BYTES, 0xAB, dtype=np.uint8)  # poison
    writes = np.zeros(nrows * ROW_BYTES, dtype=np.int64)
    dst = r * ROW_BYTES + ((c ^ (r & 7)) << 4)
    idx = dst[..., None] + np.arange(16)
    stage[idx] = np.ascontiguousarray(out).view(np.uint8).reshape(idx.shape)
    np.add.at(writes, idx.reshape(-1), 1)
    return stage, writes


def _stage(producer, mem, base, row_bytes, rows_total, row0, k, nrows, read,
           piece=0):
    if producer == "realign":
        return _realign_stage(mem, base, row_bytes, rows_total, row0, k,
                              nrows, read)
    return _cp_stage(mem, base, row_bytes, rows_total, row0, k, nrows, piece,
                     read)


def _check_box(producer, dim, offset, nrows, piece=0):
    """Every k-stage of the first tile and the last stage of the last
    (ragged: 37 rows, so classes end at different rows): the producer's
    stage is TMA's swizzled box of the rows in their own order, zeros past
    dim and past the rows that exist, every byte written once; every byte
    read lies in a 16-byte chunk that holds a byte of the operand, none
    past its end, and the tail tile's last slices were all read."""
    rng = np.random.default_rng(dim * 7 + offset + nrows)
    rows = nrows + 37
    mat = _i8_bytes(rng, rows, dim)
    mem, base = _memory(mat, offset)
    k_iters = -(-dim // ROW_BYTES)
    read = np.zeros(mem.size, dtype=bool)
    for row0 in (0, nrows):
        for k in range(0 if row0 == 0 else k_iters - 1, k_iters):
            got, writes = _stage(producer, mem, base, dim, rows, row0, k,
                                 nrows, read, piece)
            assert (writes == 1).all()
            np.testing.assert_array_equal(got, tma_box(mat, row0, k, rows,
                                                        nrows))
    got = np.nonzero(read)[0]
    end = base + mat.size
    assert got.min() >= base - base % 16 and got.max() < end
    tail = (k_iters - 1) * ROW_BYTES
    want = (base + np.arange(nrows, rows)[:, None] * dim
            + np.arange(tail, dim)[None, :])
    assert read[want].all()


@pytest.mark.parametrize("nrows", [BM, BN])
@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("dim", DIMS)
def test_realigned_stage_is_tmas_box(dim, offset, nrows):
    _check_box("realign", dim, offset, nrows)


@pytest.mark.parametrize("nrows", [BM, BN])
@pytest.mark.parametrize("offset", [o for o in OFFSETS if o % 4 == 0])
@pytest.mark.parametrize("dim", [d for d in DIMS if d % 4 == 0])
def test_cpasync_stage_is_tmas_box(dim, offset, nrows):
    piece = _piece(dim, offset)
    assert piece == (8 if (dim | offset) % 8 == 0 else 4)
    _check_box("cpasync", dim, offset, nrows, piece)


@pytest.mark.parametrize("nq", [1, 5, 15, 16, 17])
def test_queries_fewer_than_the_classes(nq):
    """Q < 16 leaves classes without a row: their boxes are not loaded and
    their rows come out zero, as TMA's zero fill would make them."""
    rng = np.random.default_rng(nq)
    mat = _i8_bytes(rng, nq, 25)
    mem, base = _memory(mat, 1)
    read = np.zeros(mem.size, dtype=bool)
    got, writes = _realign_stage(mem, base, 25, nq, 0, 0, BM, read)
    assert (writes == 1).all()
    np.testing.assert_array_equal(got, tma_box(mat, 0, 0, nq, BM))


@pytest.mark.parametrize("dim,q_off,v_off", [
    (25, 1, 2), (100, 0, 4), (200, 8, 8), (1019, 2, 1), (1, 0, 1),
    (17, 4, 0), (1020, 4, 4)])
def test_stages_rebuild_the_operands_and_the_keys(dim, q_off, v_off):
    """The query tile (Q = 70 of a 128-row box) and a corpus tile (cap =
    384: the second 256-row tile half past cap), each at its own offset
    and through the producer the ready rules name for the pair, stage by
    stage, unswizzled and joined, are the operands zero-padded to whole
    stages and tiles; their exact int32 products packed as K5's keys (times
    the row scales) and as K10's (the raw sums) are the plain versions'
    bit for bit."""
    rng = np.random.default_rng(dim + q_off + v_off)
    nq, cap = 70, 384
    q8 = rng.integers(-127, 128, (nq, dim), dtype=np.int8)
    v8 = rng.integers(-127, 128, (cap, dim), dtype=np.int8)
    vs = torch.from_numpy((rng.random(cap) + 0.5).astype(np.float32))
    mask = torch.from_numpy(rng.random(cap) > 0.2)
    mask[128:256] = False  # a fully masked segment
    piece = _piece(dim, q_off, v_off)
    producer = "cpasync" if piece else "realign"
    k_iters = -(-dim // ROW_BYTES)

    def operand(m, tile, offset):
        mat = m.view(np.uint8)
        mem, base = _memory(mat, offset)
        read = np.zeros(mem.size, dtype=bool)
        rows = m.shape[0]
        out = []
        for row0 in range(0, rows, tile):
            st = []
            for k in range(k_iters):
                got, _ = _stage(producer, mem, base, dim, rows, row0, k, tile,
                                read, piece)
                addr = np.arange(tile * ROW_BYTES)
                st.append(got[addr ^ (((addr >> 7) & 7) << 4)].reshape(
                    tile, ROW_BYTES))
            out.append(np.concatenate(st, axis=1))
        full = np.concatenate(out, axis=0).view(np.int8)
        assert not full[rows:].any()  # zero-filled rows
        assert not full[:, dim:].any()  # zero-filled columns
        np.testing.assert_array_equal(full[:rows, :dim], m)
        return full.astype(np.int64)

    sums = (operand(q8, BM, q_off) @ operand(v8, BN, v_off).T)[:nq, :cap]
    sums = torch.from_numpy(sums.astype(np.int32))
    tq, tv = torch.from_numpy(q8), torch.from_numpy(v8)
    k5 = tscan._segmax_keys(sums.float() * vs, mask)
    assert torch.equal(k5, tscan.segmax_scan_i8_plain(tq, tv, vs, mask))
    k10 = tscan._segment_top2(sums, mask)
    assert torch.equal(k10, tscan.segmax_scan_i8c_plain(tq, tv, mask))
    assert bool((k10[:, 2:4] == tscan.KEY_MIN).all())


# --------------------------------------------------------------------------
# The ready rules and the dispatch
# --------------------------------------------------------------------------


def _at(n, dim, off, device="cpu"):
    """An (n, dim) int8 view whose base lies `off` bytes past a 16-byte
    boundary."""
    flat = torch.zeros(n * dim + 16, dtype=torch.int8, device=device)
    assert flat.data_ptr() % 16 == 0
    return flat[off:off + n * dim].view(n, dim)


def _want(dim, q_off, v_off):
    bits = dim | q_off | v_off
    return "_wgmma" if bits % 16 == 0 else "_cpasync" if bits % 4 == 0 \
        else "_realign"


@pytest.mark.parametrize("dim", [1, 2, 3, 4, 8, 12, 16, 17, 25, 32, 100, 200,
                                 1019, 1020, 1024])
def test_ready_rules_cover_every_pair_once(dim):
    """For every pair of query and row bases off a 16-byte boundary by 0
    ... 15 bytes, exactly one of the three int8 rules holds: TMA at rows
    of whole 16 bytes and 16-byte aligned bases, cp.async at whole 4
    bytes (8-byte pieces at whole 8), the realigning producer at the
    rest."""
    for q_off in range(16):
        for v_off in range(16):
            q, v = _at(3, dim, q_off), _at(SEG, dim, v_off)
            got = {"_wgmma": tscan.wgmma_i8_ready(q, v),
                   "_cpasync": tscan.cpasync_i8_ready(q, v),
                   "_realign": tscan.realign_i8_ready(q, v)}
            want = _want(dim, q_off, v_off)
            assert [k for k, ok in got.items() if ok] == [want], (q_off,
                                                                  v_off)
            assert tscan._i8_producer(q, v) == want
            if want == "_cpasync":
                assert tscan.cpasync_piece(q, v) == _piece(dim, q_off, v_off)


class _AsCuda(torch.Tensor):
    """A CPU (or meta) tensor that reports itself as a CUDA tensor, so a
    wrapper takes its kernel branch up to the (recorded) launch."""

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
    return calls


def _dispatch(recorded, q, v, want):
    """K5 then K10 on (q, v): each takes its entry for `want` with the
    arguments its signature names and counts one launch of its family and
    of that kind (by shape too), none of another kind."""
    nq, dim = q.shape
    cap = v.shape[0]
    vs = torch.ones(cap, device=v.device)
    mask = torch.ones(cap, dtype=torch.bool, device=v.device)
    for family, call in (
            ("segmax_i8", lambda: tscan.segmax_scan_i8(
                *map(_as_cuda, (q, v, vs, mask)))),
            ("segmax_i8c", lambda: tscan.segmax_scan_i8c(
                *map(_as_cuda, (q, v, mask))))):
        before = dict(tscan.LAUNCHES)
        shapes = dict(tscan.LAUNCH_SHAPES.get(family + want, {}))
        recorded.clear()
        keys = call()
        assert keys.shape == (nq, 2 * cap // SEG)
        (entry, args), = recorded
        assert entry == "pv_" + family.replace("segmax", "segmax_scan") + want
        assert entry not in ("pv_segmax_scan_i8", "pv_segmax_scan_i8c")
        assert args[:2] == (q.data_ptr(), v.data_ptr())
        assert args[-3:] == (nq, cap, dim)
        assert tscan.LAUNCHES[family] == before[family] + 1
        for kind in ("_wgmma", "_cpasync", "_realign"):
            assert (tscan.LAUNCHES[family + kind] - before[family + kind]
                    == (kind == want)), family + kind
        got = tscan.LAUNCH_SHAPES[family + want]
        assert got[nq, None] == shapes.get((nq, None), 0) + 1


@pytest.mark.parametrize("offset", OFFSETS)
@pytest.mark.parametrize("dim", DIMS + [1024])
def test_k5_k10_dispatch_every_width_and_base(recorded, dim, offset):
    """At every Q the launch shapes hold (1, 127, 128, 129, 2048), queries
    and rows `offset` bytes off a 16-byte boundary (and the queries
    aligned, the rows off), K5 and K10 take the kind the ready rules name,
    never the mma.sync tile."""
    for nq in (1, 127, 128, 129, 2048):
        for q_off in {offset, 0}:
            q, v = _at(nq, dim, q_off), _at(2 * SEG, dim, offset)
            _dispatch(recorded, q, v, _want(dim, q_off, offset))


@pytest.mark.parametrize("dim,offset", [(25, 0), (25, 1), (100, 0), (100, 4),
                                        (1019, 2), (1024, 0)])
def test_k5_k10_dispatch_at_64m_rows(recorded, dim, offset):
    """The ready rules read the row bytes and the bases only: over 64M rows
    (meta tensors, no memory behind them) the dispatch is the same."""
    cap = 1 << 26
    q = _at(2048, dim, offset, "meta")
    v = _at(cap, dim, offset, "meta")
    assert (q.data_ptr() % 16, v.data_ptr() % 16) == (offset, offset)
    _dispatch(recorded, q, v, _want(dim, offset, offset))


def test_counters_stay_zero_on_the_cpu():
    rng = np.random.default_rng(0)
    q8 = torch.from_numpy(rng.integers(-127, 128, (20, 25), dtype=np.int8))
    v8 = torch.from_numpy(rng.integers(-127, 128, (256, 25), dtype=np.int8))
    vs = torch.from_numpy((rng.random(256) + 0.5).astype(np.float32))
    mask = torch.from_numpy(rng.random(256) > 0.3)
    tscan.reset_launch_counts()
    assert torch.equal(tscan.segmax_scan_i8(q8, v8, vs, mask),
                       tscan.segmax_scan_i8_plain(q8, v8, vs, mask))
    assert torch.equal(tscan.segmax_scan_i8c(q8, v8, mask),
                       tscan.segmax_scan_i8c_plain(q8, v8, mask))
    for family in ("segmax_i8", "segmax_i8c"):
        for kind in ("", "_wgmma", "_cpasync", "_realign"):
            assert tscan.LAUNCHES[family + kind] == 0
    assert not tscan.LAUNCH_SHAPES


# --------------------------------------------------------------------------
# The port against the JAX package at glove widths
# --------------------------------------------------------------------------


def _t(a):
    return torch.from_numpy(np.array(a))


def _tpu_slab_to_port(keys_t, ns, nq):
    """The TPU kernels' (n_tiles * 2 * ns, Q) slab (per tile ns first-best
    rows, then ns second-best) in the port's (Q, 2 * cap / 128) layout,
    column 2 * seg + r."""
    keys_t = np.asarray(keys_t)
    n_tiles = keys_t.shape[0] // (2 * ns)
    return keys_t.reshape(n_tiles, 2, ns, nq).transpose(3, 0, 2, 1).reshape(
        nq, -1)


def _glove_rows(dim, nq, cap=2048):
    rng = np.random.default_rng(dim * 11 + nq)
    v = normalize_batch(rng.normal(size=(cap, dim)).astype(np.float32))
    q = normalize_batch(rng.normal(size=(nq, dim)).astype(np.float32))
    mask = rng.random(cap) > 0.2
    mask[128:256] = False  # a fully masked segment
    return v, q, mask


@pytest.mark.parametrize("nq", [40, 256])
@pytest.mark.parametrize("dim", [25, 100, 200])
def test_k5_keys_match_the_tpu_kernel(dim, nq):
    v, q, mask = _glove_rows(dim, nq)
    v8, vs = map(np.asarray, jps.quantize_rows_i8(jnp.asarray(v)))
    q8 = np.asarray(jps.quantize_rows_i8(jnp.asarray(q))[0])
    keys_t, ns = jps.segmax_scan_i8(q8, v8, vs, mask, interpret=True,
                                    raw_t=True)
    got = tscan.segmax_scan_i8(*map(_t, (q8, v8, vs, mask)))
    np.testing.assert_array_equal(got.numpy(),
                                  _tpu_slab_to_port(keys_t, ns, nq))
    assert (got[:, 2:4] == tscan.KEY_MIN).all()


@pytest.mark.parametrize("nq", [40, 256])
@pytest.mark.parametrize("dim", [25, 100, 200])
def test_k10_keys_match_the_tpu_kernel(dim, nq):
    v, q, mask = _glove_rows(dim, nq)
    v8, cs = map(np.asarray, jps.quantize_cols_i8(jnp.asarray(v)))
    q8 = np.asarray(jps.fold_queries_i8(jnp.asarray(q), jnp.asarray(cs)))
    keys_t, ns = jps.segmax_scan_i8c(jnp.asarray(q8), jnp.asarray(v8),
                                     jnp.asarray(mask), interpret=True,
                                     raw_t=True)
    got = tscan.segmax_scan_i8c(*map(_t, (q8, v8, mask)))
    np.testing.assert_array_equal(got.numpy(),
                                  _tpu_slab_to_port(keys_t, ns, nq))


def test_segmax_topk_i8_route_matches_jax_at_dim_25():
    """The int8 store's batch route (`make_segmax_topk_i8` with the
    dequantizing rescore, tie_scale 0) at glove-25's width: the same
    scores within 1e-6 and the same ids where the float64 k-th / (k+1)-th
    gap over the dequantized rows exceeds 1e-4."""
    k, nq = 10, 256
    v, q, mask = _glove_rows(25, nq)
    v8, vs = map(np.asarray, jps.quantize_rows_i8(jnp.asarray(v)))
    q = (v[np.random.default_rng(3).integers(0, v.shape[0], nq)]
         + 0.2 * q).astype(np.float32)
    jv, ji = map(np.asarray, jps.make_segmax_topk_i8(
        k, interpret=True, rescore_dequant=True, tie_scale=0.0)(
            q, v8, vs, v8, mask))
    tv, ti = tscan.make_segmax_topk_i8(k, rescore_dequant=True,
                                       tie_scale=0.0)(
        *map(_t, (q, v8, vs, v8, mask)))
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_array_equal(np.isneginf(jv), np.isneginf(tv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=1e-6)
    rows = v8.astype(np.float64) * vs[:, None]
    qn = q.astype(np.float64)
    qn /= np.linalg.norm(qn, axis=1, keepdims=True)
    s = qn @ rows.T
    s[:, ~mask] = -np.inf
    s = -np.sort(-s, axis=1)
    agree = 0
    for i in range(nq):
        if s[i, k - 1] - s[i, k] > 1e-4:
            assert set(ji[i].tolist()) == set(ti[i].tolist()), i
            agree += 1
    assert agree > nq // 2
