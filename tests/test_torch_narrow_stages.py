"""The rows' producers of K4's and K3's tensor-core mainloop
(csrc/scan_topk_wgmma.cuh) at widths TMA cannot read, checked on the CPU.

* The cp.async producer (PIECE 8 / 4: `wg::cp_stage` over a segment's 128
  rows, thread t of the producer warpgroup's 128 copying piece t % (128 /
  PIECE) of rows t / (128 / PIECE), + 128 / (128 / PIECE), ...): every
  k-stage of the first segment and of a ragged last one (37 rows) is
  TMA's 128B-swizzled box of 128-byte x 128 rows, zeros past dim and cap,
  every byte written once, for int8, bf16 and float32 rows at dims 100,
  300, 1020, 1019 (float32), 25 (float32), 50, 98, 1018, 1022.
* The realigning producer (PIECE 2: `encode_row_class`, `stage_rows`,
  `realign_rows`), emulated over a flat byte array standing for device
  memory (the operand at every byte offset from a 16-byte boundary,
  poison around it): class j (of 16) is rows j, j + 16, ... as a 2D
  tensor of stride 16 row bytes from row j's start aligned down to 16
  bytes (`off` bytes before it), its box 144 bytes x 8 rows at byte 128 k;
  thread t moves piece t % 8 of rows t / 8 + 16 i out of the slot by two
  16-byte loads shifted by `off` bytes (`shift_pair` at any byte offset:
  word selects, then a funnel shift of 0, 8, 16 or 24 bits) into the
  ring's swizzled stage. Every stage is TMA's box, zeros past dim and cap
  (a class with no row: zeros), every byte written once, and every byte
  TMA reads lies in a 16-byte chunk that holds a byte of the operand.
* The launchers' query rows (zeros to whole 16 bytes: `_pad_cols` for
  K4's planes, and K3's library calls' `tk::tma_queries`, a memset and a
  2D copy to the same rows) give TMA's box of the queries as they lie
  with its zero fill; unswizzled,
  the realigned int8 stages give back the rows, so the s8 products with
  the padded queries are the exact int32 sums (bit for bit the plain
  version's keys).
"""

import numpy as np
import pytest
import torch

from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads, tma_box

cap_torch_threads()

ROWS = tscan.SEG  # rows a segment: the stage's box
ROW_BYTES = 128  # bytes of a row a k-stage
PRODUCERS = 128  # threads of the producer warpgroup
CLASSES = 16  # the realigning producer's row classes
STAGE_ROW = 144  # bytes of a staged row's span
POISON = 0xEE


def _matrix(rng, rows, dim, dtype):
    x = torch.from_numpy(rng.standard_normal((rows, dim)).astype(np.float32))
    if dtype == torch.int8:
        x = torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
    else:
        x = x.to(dtype)
    return x.view(torch.uint8).numpy().reshape(rows, -1)


def _cp_stage(mat, row0, k, rows_total, piece):
    """`cp_stage<piece, 128>` for every producer thread: (stage, writes)."""
    row_bytes = mat.shape[1]
    stage = np.full(ROWS * ROW_BYTES, 0xAB, dtype=np.uint8)
    writes = np.zeros(ROWS * ROW_BYTES, dtype=np.int64)
    per_row = ROW_BYTES // piece
    row_step = PRODUCERS // per_row
    rows_left = rows_total - row0
    for t in range(PRODUCERS):
        b = (t % per_row) * piece
        col = k * ROW_BYTES + b
        lim = 0 if col >= row_bytes else min(rows_left, ROWS)
        for r in range(t // per_row, ROWS, row_step):
            d = r * ROW_BYTES + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15))
            if r < lim:
                assert col + piece <= row_bytes  # no piece crosses the end
                src = mat[row0 + r, col:col + piece]
            else:
                src = np.zeros(piece, dtype=np.uint8)  # src-size 0
            stage[d:d + piece] = src
            writes[d:d + piece] += 1
    return stage, writes


@pytest.mark.parametrize("dtype,dim", [
    (torch.int8, 100), (torch.int8, 300), (torch.int8, 1020),
    (torch.int8, 1016), (torch.bfloat16, 1020), (torch.bfloat16, 1018),
    (torch.bfloat16, 100), (torch.bfloat16, 50), (torch.float32, 1019),
    (torch.float32, 1022), (torch.float32, 25), (torch.float32, 98)])
def test_cp_stage_is_tmas_box(dtype, dim):
    rng = np.random.default_rng(dim)
    rows = ROWS + 37
    mat = _matrix(rng, rows, dim, dtype)
    v = torch.zeros(1, dim, dtype=dtype)
    piece = tscan.rows_piece(v)  # an aligned base: the row bytes decide
    assert piece in (8, 4) and mat.shape[1] % piece == 0
    for row0 in (0, ROWS):
        for k in range(-(-mat.shape[1] // ROW_BYTES)):
            got, writes = _cp_stage(mat, row0, k, rows, piece)
            assert (writes == 1).all()
            np.testing.assert_array_equal(got, tma_box(mat, row0, k, rows,
                                                        ROWS))


def _shift_pair(lo, hi, off):
    """`wg::shift_pair`: the 16 bytes at byte `off` (0..15) of lo | hi."""
    z = np.concatenate([lo, hi], axis=-1)  # (..., 8) words
    w1, w2 = (off & 4) != 0, (off & 8) != 0
    t = np.where(w1[..., None], z[..., 1:8], z[..., 0:7])
    u = np.where(w2[..., None], t[..., 2:7], t[..., 0:5])
    sh = ((off & 3) * 8).astype(np.uint64)[..., None]
    pair = u[..., :4].astype(np.uint64) | (u[..., 1:5].astype(np.uint64) << 32)
    return ((pair >> sh) & 0xFFFFFFFF).astype(np.uint32)  # __funnelshift_r


def _class_box(mem, base, row_bytes, es, rows_total, row0, k, j, read):
    """TMA's box of class j's map (144 bytes x 8 rows) at segment row0,
    k-stage k, and its `off` (-1: no row j). Bytes read go to `read`."""
    box = np.full((ROWS // CLASSES, STAGE_ROW), 0x5A, dtype=np.uint8)
    if rows_total <= j:
        return box, -1
    start = base + j * row_bytes
    map_base = start & ~15
    off = start - map_base
    inner = (row_bytes + off) // es * es  # gdim[0] elements, as bytes
    n_j = -(-(rows_total - j) // CLASSES)
    stride = CLASSES * row_bytes
    assert stride % 16 == 0 and map_base % 16 == 0
    box[:] = 0
    m0, c0 = row0 // CLASSES, ROW_BYTES * k
    for m in range(m0, m0 + ROWS // CLASSES):
        if m >= n_j:
            continue
        hi = min(c0 + STAGE_ROW, inner)
        if hi > c0:
            a = map_base + m * stride
            box[m - m0, :hi - c0] = mem[a + c0:a + hi]
            read.update(range(a + c0, a + hi))
    return box, off


def _realign_stage(mem, base, row_bytes, es, rows_total, row0, k, read):
    """`stage_rows` then `realign_rows` for one segment's k-stage: (stage,
    writes)."""
    boxes, offs = zip(*(_class_box(mem, base, row_bytes, es, rows_total,
                                   row0, k, j, read) for j in range(CLASSES)))
    slot = np.concatenate([b.reshape(-1) for b in boxes])
    t = np.arange(PRODUCERS)
    c, j = t % 8, t // 8
    i = np.arange(ROWS // CLASSES)[:, None]
    r = j[None, :] + CLASSES * i  # (8, 128)
    src = (j * (ROWS // CLASSES) * STAGE_ROW + 16 * c)[None, :] + i * STAGE_ROW
    words = slot.view("<u4")
    lo = words[(src // 4)[..., None] + np.arange(4)]
    hi = words[(src // 4 + 4)[..., None] + np.arange(4)]
    off = np.array(offs)[j][None, :].repeat(len(i), 0)
    out = _shift_pair(lo, hi, np.maximum(off, 0))
    out[off < 0] = 0
    stage = np.full(ROWS * ROW_BYTES, 0xAB, dtype=np.uint8)
    writes = np.zeros(ROWS * ROW_BYTES, dtype=np.int64)
    dst = r * ROW_BYTES + ((c ^ (r & 7)) << 4)
    idx = dst[..., None] + np.arange(16)
    stage[idx] = np.ascontiguousarray(out).view(np.uint8).reshape(idx.shape)
    np.add.at(writes, idx.reshape(-1), 1)
    return stage, writes


def _memory(mat, offset):
    base = 64 + offset
    mem = np.full(base + mat.size + 64, POISON, dtype=np.uint8)
    mem[base:base + mat.size] = mat.reshape(-1)
    return mem, base


REALIGN = [(torch.int8, d, o) for d in (25, 50, 100, 1019, 1018, 300)
           for o in (0, 1, 2, 3, 7, 8, 13)] + [
    (torch.bfloat16, d, o) for d in (1019, 25, 1021, 100) for o in (0, 2, 6,
                                                                    14)]


@pytest.mark.parametrize("dtype,dim,offset", REALIGN)
def test_realigned_stage_is_tmas_box(dtype, dim, offset):
    """Every k-stage of the first segment and the last stage of a ragged
    last one (37 rows: classes end at different rows)."""
    rng = np.random.default_rng(dim + offset)
    rows = ROWS + 37
    es = torch.empty(0, dtype=dtype).element_size()
    mat = _matrix(rng, rows, dim, dtype)
    mem, base = _memory(mat, offset)
    k_iters = -(-mat.shape[1] // ROW_BYTES)
    read = set()
    for row0 in (0, ROWS):
        for k in range(0 if row0 == 0 else k_iters - 1, k_iters):
            got, writes = _realign_stage(mem, base, mat.shape[1], es, rows,
                                         row0, k, read)
            assert (writes == 1).all()
            np.testing.assert_array_equal(got, tma_box(mat, row0, k, rows,
                                                        ROWS))
    got = np.array(sorted(read))
    assert got.min() >= base - base % 16 and got.max() < base + mat.size


@pytest.mark.parametrize("rows", [1, 5, 15, 16, 17])
def test_fewer_rows_than_classes(rows):
    """Classes without a row load no box and come out zero, as TMA's zero
    fill would make them."""
    rng = np.random.default_rng(rows)
    mat = _matrix(rng, rows, 1019, torch.int8)
    mem, base = _memory(mat, 5)
    for k in (0, 7):
        got, writes = _realign_stage(mem, base, 1019, 1, rows, 0, k, set())
        assert (writes == 1).all()
        np.testing.assert_array_equal(got, tma_box(mat, 0, k, rows, ROWS))


@pytest.mark.parametrize("dtype,mult", [(torch.int8, 16), (torch.float32, 4),
                                        (torch.bfloat16, 8)])
@pytest.mark.parametrize("dim", [25, 100, 1019])
def test_padded_query_rows_are_tmas_zero_fill(dtype, mult, dim):
    """`_pad_cols`: the queries' rows of whole 16 bytes at a fresh base
    (the widths here are not whole 16 bytes);
    TMA's box of them at the plane's width is its box of the queries as
    they lie (zeros past dim)."""
    rng = np.random.default_rng(dim)
    q = torch.from_numpy(rng.standard_normal((70, dim)).astype(
        np.float32)).to(dtype)
    qp = tscan._pad_cols(q, mult)
    assert qp.shape[1] % mult == 0 and qp.shape[1] * qp.element_size() % 16 == 0
    assert torch.equal(qp[:, :dim], q) and not bool(qp[:, dim:].any())
    mat = q.view(torch.uint8).numpy().reshape(70, -1)
    padded = qp.view(torch.uint8).numpy().reshape(70, -1)
    for k in range(-(-padded.shape[1] // ROW_BYTES)):
        np.testing.assert_array_equal(tma_box(padded, 0, k, 70, 64),
                                      tma_box(mat, 0, k, 70, 64))


@pytest.mark.parametrize("dim,offset", [(1019, 3), (100, 1), (50, 6)])
def test_realigned_stages_give_the_exact_int8_sums(dim, offset):
    """A 300-row int8 plane at `offset`, realigned segment by segment,
    unswizzled and joined: the rows zero-padded to whole stages and
    segments; their s8 products with the padded queries are the exact
    int32 sums, so the kernel's keys are the plain version's."""
    rng = np.random.default_rng(dim)
    cap, nq = 300, 5
    mat = _matrix(rng, cap, dim, torch.int8)
    mem, base = _memory(mat, offset)
    k_iters = -(-dim // ROW_BYTES)
    segs = -(-cap // ROWS)
    rows = np.zeros((segs * ROWS, k_iters * ROW_BYTES), dtype=np.uint8)
    addr = np.arange(ROWS * ROW_BYTES)
    unswizzle = addr ^ (((addr >> 7) & 7) << 4)
    for s in range(segs):
        for k in range(k_iters):
            stage, _ = _realign_stage(mem, base, dim, 1, cap, s * ROWS, k,
                                      set())
            rows[s * ROWS:(s + 1) * ROWS, k * ROW_BYTES:(k + 1) * ROW_BYTES] \
                = stage[unswizzle].reshape(ROWS, ROW_BYTES)
    assert (rows[:cap, :dim] == mat).all() and not rows[:, dim:].any()
    assert not rows[cap:].any()
    q8 = torch.from_numpy(rng.integers(-127, 128, (nq, dim)).astype(np.int8))
    qp = tscan._pad_cols(q8, 16).numpy().astype(np.int64)
    sums = qp @ rows.view(np.int8)[:cap, :qp.shape[1]].astype(np.int64).T
    v8 = torch.from_numpy(mat.view(np.int8))
    np.testing.assert_array_equal(
        sums, q8.numpy().astype(np.int64) @ v8.numpy().astype(np.int64).T)
    vs = torch.from_numpy(rng.uniform(0.001, 0.01, cap).astype(np.float32))
    mask = torch.ones(cap, dtype=torch.bool)
    got = tscan.scan_topk_plain(q8, v8, vs, mask, 14)
    scores = torch.from_numpy(sums.astype(np.float32)) * vs
    want = torch.topk(scores, 14, dim=1)
    assert torch.equal(got[0], want.values)
