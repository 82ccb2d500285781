"""K1 on the TMA + wgmma mainloop fed by its realigning producer
(csrc/wgmma_tiles.cuh: `ClassMaps`, `encode_class`, `stage_boxes`,
`realign_box`; pv_segmax_scan_realign), checked on the CPU.

* The producer, emulated in numpy over a flat byte array that stands for
  device memory (the operand at a 2-byte offset from a 16-byte boundary,
  poison bytes around it). TMA: class j's map holds rows j, j + 8, ... as
  a 2D tensor of row stride 8 x row bytes (a multiple of 16 for every even
  row width), based at row j's start aligned down to 16 bytes, off_j
  elements before it; its box of 72 elements (144 bytes) x ROWS / 8 rows
  at column 64 k (a 16-byte boundary) holds each row's slice k at byte
  2 off_j, zeros past the row's end and past the rows that exist. The
  threads: thread t moves piece t % 8 of rows t / 8, + 16, ... (all of
  class (t / 8) % 8) out of the staging slot, two 16-byte loads shifted by
  2 off_j bytes as `shift_pair` does (word selects, 16-bit funnel shifts),
  into the ring at chunk c ^ (r % 8) of row r. Every k-stage is exactly
  TMA's 128-byte x ROWS box with the 128B swizzle of the rows in their own
  order, zeros past dim, Q and cap; every stage byte is written once; every
  byte TMA reads lies in a 16-byte chunk that holds a byte of the operand,
  and none lies past its end.
* Unswizzled, the stages give back the zero-padded operands, so their
  products packed as K1's keys are the plain version's.
* The ready rules (`wgmma_ready`, `cpasync_ready`, `realign_ready`) and
  K1's dispatch among its producers at dims 1019 / 1021 / 97 / 1 and on
  2-byte aligned views of even widths, recorded on CPU tensors posing as
  CUDA tensors against `_build._SIGNATURES`: the wmma tile
  (`pv_segmax_scan`) is never dispatched. On the CPU the counters stay 0.
"""

import numpy as np
import pytest
import torch

from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import bf16_bytes, cap_torch_threads, tma_box

cap_torch_threads()

SEG = tscan.SEG
ROW_BYTES = 128  # bytes of a row a k-stage
PRODUCERS = 128  # threads of the producer warpgroup
POISON = 0xEE  # device memory around the operand
CLASSES = 8  # row classes of the realigning producer's maps
STAGE_ROW = 144  # bytes of a row's span in the staging slot


def _shift_pair(lo, hi, off):
    """`shift_pair`: the 16 bytes at byte `off` of lo | hi, word by word."""
    z = np.concatenate([lo, hi], axis=-1)  # (..., 8) words
    w1, w2 = (off & 4) != 0, (off & 8) != 0
    t = np.where(w1[..., None], z[..., 1:8], z[..., 0:7])
    u = np.where(w2[..., None], t[..., 2:7], t[..., 0:5])
    sh = ((off & 2) * 8).astype(np.uint64)[..., None]
    pair = u[..., :4].astype(np.uint64) | (u[..., 1:5].astype(np.uint64) << 32)
    return ((pair >> sh) & 0xFFFFFFFF).astype(np.uint32)  # __funnelshift_r


def _class_box(mem, base, row_bytes, rows_total, row0, k, nrows, j, read):
    """TMA's box of class j's map (144 bytes x nrows / 8 rows, unswizzled)
    and off_j (-1 where the matrix has no row j): rows j, j + 8, ... of the
    matrix whose row 0 starts at byte `base` of `mem`. Every byte read is
    added to `read`."""
    per = nrows // CLASSES
    box = np.full((per, STAGE_ROW), 0x5A, dtype=np.uint8)  # stale
    if rows_total <= j:
        return box, -1  # no map, no load: the slot keeps stale bytes
    dim = row_bytes // 2
    start = base + j * row_bytes
    map_base = start & ~15
    off = (start - map_base) // 2  # elements from the map's base to row j
    n_j = -(-(rows_total - j) // CLASSES)
    stride = CLASSES * row_bytes
    assert stride % 16 == 0 and map_base % 16 == 0 and (128 * k) % 16 == 0
    box[:] = 0
    m0, c0 = row0 // CLASSES, 64 * k
    for m in range(m0, m0 + per):
        if m >= n_j:
            continue  # past the class's rows: zero
        for c in range(c0, min(c0 + STAGE_ROW // 2, dim + off)):
            a = map_base + m * stride + 2 * c
            box[m - m0, 2 * (c - c0):2 * (c - c0) + 2] = mem[a:a + 2]
            read.update((a, a + 1))
    return box, off


def _realign_stage(mem, base, row_bytes, rows_total, row0, k, nrows, read):
    """`stage_boxes` then `realign_box` for one box of nrows rows: (stage
    bytes, times each byte was written)."""
    per = nrows // CLASSES
    boxes, offs = zip(*(_class_box(mem, base, row_bytes, rows_total, row0, k,
                                   nrows, j, read) for j in range(CLASSES)))
    slot = np.concatenate([b.reshape(-1) for b in boxes])
    t = np.arange(PRODUCERS)
    c, r0 = t % 8, t // 8
    j = r0 % CLASSES
    p = np.arange(nrows // 16)[:, None]
    r = r0[None, :] + 16 * p  # (passes, 128)
    src = (j * per * STAGE_ROW + (r0 // CLASSES) * STAGE_ROW + 16 * c)[None, :] \
        + 2 * p * STAGE_ROW
    assert ((r // CLASSES) * STAGE_ROW + j * per * STAGE_ROW + 16 * c
            == src).all()  # row r / 8 of class j
    words = slot.view("<u4")
    lo = words[(src // 4)[..., None] + np.arange(4)]
    hi = words[(src // 4 + 4)[..., None] + np.arange(4)]
    off = np.array(offs)[j][None, :].repeat(len(p), 0)
    out = _shift_pair(lo, hi, np.maximum(2 * off, 0))
    out[off < 0] = 0  # a class with no row: zeros
    stage = np.full(nrows * ROW_BYTES, 0xAB, dtype=np.uint8)  # poison
    writes = np.zeros(nrows * ROW_BYTES, dtype=np.int64)
    dst = r * ROW_BYTES + ((c ^ (r & 7)) << 4)
    idx = dst[..., None] + np.arange(16)
    stage[idx] = np.ascontiguousarray(out).view(np.uint8).reshape(idx.shape)
    np.add.at(writes, idx.reshape(-1), 1)
    return stage, writes


def _memory(mat, offset):
    """Device memory holding `mat` (rows, row_bytes) at a 16-byte boundary
    plus `offset`, poison around it: (memory, base)."""
    base = 64 + offset
    mem = np.full(base + mat.size + 64, POISON, dtype=np.uint8)
    mem[base:base + mat.size] = mat.reshape(-1)
    return mem, base


@pytest.mark.parametrize("dim", [1019, 1021, 97, 1, 1020, 1024])
@pytest.mark.parametrize("offset", [0, 2, 6, 14])
@pytest.mark.parametrize("nrows", [128, 256])
def test_realigned_stage_is_tmas_box(dim, offset, nrows):
    """Every k-stage of the first tile and the last stage of the last
    (ragged: 37 rows, so classes end at different rows) one: the realigned
    stage is TMA's swizzled box of the rows in their own order, zeros past
    dim and past the rows that exist, every byte written once; every byte
    TMA read lies in a 16-byte chunk that holds a byte of the operand, none
    past its end, and the tail tile's last slices were all read."""
    rng = np.random.default_rng(dim + offset + nrows)
    rows = nrows + 37
    mat = bf16_bytes(rng, rows, dim)
    mem, base = _memory(mat, offset)
    k_iters = -(-mat.shape[1] // ROW_BYTES)
    read = set()
    for row0 in (0, nrows):
        for k in range(0 if row0 == 0 else k_iters - 1, k_iters):
            got, writes = _realign_stage(mem, base, mat.shape[1], rows, row0,
                                         k, nrows, read)
            assert (writes == 1).all()
            np.testing.assert_array_equal(got, tma_box(mat, row0, k, rows,
                                                        nrows))
    got = np.array(sorted(read))
    end = base + mat.size
    assert got.min() >= base - base % 16 and got.max() < end
    tail = k_iters - 1
    want = {base + r * mat.shape[1] + b for r in range(nrows, rows)
            for b in range(tail * ROW_BYTES, mat.shape[1])}
    assert want <= read


@pytest.mark.parametrize("nq", [1, 5, 8, 9])
def test_queries_fewer_than_the_classes(nq):
    """Q < 8 leaves classes without a row: their boxes are not loaded and
    their rows come out zero, as TMA's zero fill would make them."""
    rng = np.random.default_rng(nq)
    mat = bf16_bytes(rng, nq, 1019)
    mem, base = _memory(mat, 6)
    for k in (0, 15):
        got, writes = _realign_stage(mem, base, mat.shape[1], nq, 0, k, 128,
                                     set())
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, tma_box(mat, 0, k, nq, 128))


@pytest.mark.parametrize("dim,q_off,v_off", [(1019, 0, 2), (97, 6, 14),
                                             (1, 2, 0), (1021, 10, 4)])
def test_stages_rebuild_the_operands_and_the_keys(dim, q_off, v_off):
    """The query tile (Q = 70 of a 128-row box) and a corpus tile (cap =
    384: the second 256-row tile half past cap), each at its own offset,
    realigned stage by stage, unswizzled and joined, are the operands
    zero-padded to whole stages and tiles; their bf16 products packed as
    K1's keys agree with the plain version's (KEY_MIN pattern equal,
    decoded values within 1e-5 of unit-vector scores: the padding's zeros
    change only the summation order)."""
    rng = np.random.default_rng(dim + q_off)
    nq, cap = 70, 384

    def unit(n):
        x = rng.standard_normal((n, dim)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return torch.from_numpy(x).to(torch.bfloat16)

    qb, vb = unit(nq), unit(cap)
    mask = torch.from_numpy(rng.random(cap) > 0.2)
    k_iters = -(-2 * dim // ROW_BYTES)

    def operand(t, rows, tile, offset):
        mat = t.view(torch.uint8).numpy().reshape(t.shape[0], 2 * dim)
        mem, base = _memory(mat, offset)
        out = []
        for row0 in range(0, rows, tile):
            st = []
            for k in range(k_iters):
                got, _ = _realign_stage(mem, base, 2 * dim, rows, row0, k,
                                        tile, set())
                addr = np.arange(tile * ROW_BYTES)
                st.append(got[addr ^ (((addr >> 7) & 7) << 4)].reshape(
                    tile, ROW_BYTES))
            out.append(np.concatenate(st, axis=1))
        full = np.concatenate(out, axis=0)  # (tiles * tile, k_iters * 128)
        as_bf16 = torch.from_numpy(np.ascontiguousarray(full)).view(
            torch.bfloat16)
        assert not as_bf16[rows:].float().any()  # zero-filled rows
        assert not as_bf16[:, dim:].float().any()  # zero-filled columns
        assert torch.equal(as_bf16[:rows, :dim], t)
        return as_bf16

    qa = operand(qb, nq, 128, q_off)
    va = operand(vb, cap, 256, v_off)
    scores = (qa.float() @ va.float().T)[:nq, :cap]
    keys = tscan._segmax_keys(scores.contiguous(), mask)
    ref = tscan.segmax_scan_plain(qb, vb, mask)
    live = ref != tscan.KEY_MIN
    assert torch.equal(keys != tscan.KEY_MIN, live)

    def dec(kk):
        return tscan._from_sortable(kk & ~(SEG - 1)).view(torch.float32)

    assert float((dec(keys)[live] - dec(ref)[live]).abs().max()) <= 1e-5


# --------------------------------------------------------------------------
# The ready rules and the dispatch
# --------------------------------------------------------------------------


def _operands(dim, q_off=0, v_off=0, nq=16, rows=256):
    """bf16 queries and rows whose bases lie q_off / v_off bytes past a
    16-byte boundary."""
    def at(n, off):
        flat = torch.zeros(n * dim + 16, dtype=torch.bfloat16)
        assert flat.data_ptr() % 16 == 0
        return flat[off // 2:off // 2 + n * dim].view(n, dim)

    return at(nq, q_off), at(rows, v_off)


@pytest.mark.parametrize("dim,q_off,v_off,want", [
    (1019, 0, 0, "realign"), (1021, 0, 0, "realign"), (97, 0, 0, "realign"),
    (1, 0, 0, "realign"), (1024, 0, 2, "realign"), (1024, 6, 0, "realign"),
    (1020, 0, 2, "realign"), (300, 14, 0, "realign"),
    (1024, 0, 0, "tma"), (1020, 0, 0, "cpasync"), (1024, 0, 4, "cpasync"),
    (1019, 2, 10, "realign")])
def test_ready_rules_cover_every_pair_once(dim, q_off, v_off, want):
    """Exactly one of the three ready rules holds for every bf16 pair: TMA
    at rows of whole 16 bytes and 16-byte aligned bases, cp.async at even
    widths and 4-byte aligned bases, the realigning producer at the rest
    (odd widths, bases only 2-byte aligned)."""
    q, v = _operands(dim, q_off, v_off)
    got = {"tma": tscan.wgmma_ready(q, v),
           "cpasync": tscan.cpasync_ready(q, v),
           "realign": tscan.realign_ready(q, v)}
    assert [name for name, ok in got.items() if ok] == [want]


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
    return calls


@pytest.mark.parametrize("dim,q_off,v_off,entry", [
    (1019, 0, 0, "pv_segmax_scan_realign"),
    (1021, 0, 0, "pv_segmax_scan_realign"),
    (97, 0, 0, "pv_segmax_scan_realign"), (1, 0, 0, "pv_segmax_scan_realign"),
    (1024, 0, 2, "pv_segmax_scan_realign"),
    (1020, 2, 0, "pv_segmax_scan_realign"),
    (1018, 0, 6, "pv_segmax_scan_realign"),
    (1024, 0, 0, "pv_segmax_scan_wgmma"), (1020, 0, 0, "pv_segmax_scan_cpasync")])
def test_k1_dispatch_among_its_producers(recorded, dim, q_off, v_off, entry):
    """K1 takes the TMA mainloop, the cp.async producer or the realigning
    one by the ready rules, with the same arguments (q, v, mask, keys, Q,
    cap, dim); "segmax" counts every launch, "segmax_realign" the
    realigning producer's; the wmma tile is never dispatched."""
    q, v = _operands(dim, q_off, v_off, nq=17, rows=2 * SEG)
    mask = torch.ones(2 * SEG, dtype=torch.bool)
    before = dict(tscan.LAUNCHES)
    keys = tscan.segmax_scan(*map(_as_cuda, (q, v, mask)))
    assert keys.shape == (17, 4)
    (got, args), = recorded
    assert got == entry != "pv_segmax_scan"
    assert args[:3] == (q.data_ptr(), v.data_ptr(), mask.data_ptr())
    assert args[4:] == (17, 2 * SEG, dim)
    assert tscan.LAUNCHES["segmax"] == before["segmax"] + 1
    for key, name in (("segmax_wgmma", "pv_segmax_scan_wgmma"),
                      ("segmax_cpasync", "pv_segmax_scan_cpasync"),
                      ("segmax_realign", "pv_segmax_scan_realign")):
        assert tscan.LAUNCHES[key] - before[key] == (entry == name), key


def test_counters_stay_zero_on_the_cpu():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((20, 1019)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((256, 1019)).astype(np.float32))
    mask = torch.from_numpy(rng.random(256) > 0.3)
    qb, vb = q.to(torch.bfloat16), v.to(torch.bfloat16)
    tscan.reset_launch_counts()
    keys = tscan.segmax_scan(qb, vb, mask)
    assert torch.equal(keys, tscan.segmax_scan_plain(qb, vb, mask))
    assert tscan.LAUNCHES["segmax_realign"] == tscan.LAUNCHES["segmax"] == 0
