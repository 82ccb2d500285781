"""K1 on the TMA + wgmma mainloop fed by cp.async (csrc/wgmma_tiles.cuh,
`cp_stage`), checked on the CPU.

* The producer's address map, emulated in numpy: the 128 producer
  threads' pieces of 8 or 4 bytes, each copied (or zero-filled) to the
  shared-memory offset `cp_stage` computes, rebuild a k-stage exactly as
  TMA lays out a 128-byte x ROWS box with the 128B swizzle (byte b of
  logical row r at r * 128 + b, the address's bits 4-6 XORed with its bits
  7-9), zeros past dim, past Q and past cap included; every byte of the
  stage is written once, and no piece crosses a row's end. Unswizzled
  stage by stage, the copies rebuild the zero-padded operands the wgmma
  products read, so the keys are the plain version's.
* The ready rule (`cpasync_ready`, `cpasync_piece`) at dims 1020 / 1018 /
  300 / 100 / 50 / 97 and 8- / 4- / 2-byte aligned views, and K1's
  dispatch between its three producers (odd widths and 2-byte aligned
  views: the realigning one, `realign_ready`), recorded on CPU tensors
  posing as CUDA tensors against `_build._SIGNATURES`; on the CPU the
  counters stay 0.
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


def _cp_stage(mat, row0, k, rows_total, piece, nrows):
    """`cp_stage` for every producer thread: (stage bytes, times each byte
    was written). `mat` is the (rows, row_bytes) uint8 matrix; the copy
    starts at row `row0`, of which rows_total - row0 rows exist."""
    row_bytes = mat.shape[1]
    stage = np.full(nrows * ROW_BYTES, 0xAB, dtype=np.uint8)  # poison
    writes = np.zeros(nrows * ROW_BYTES, dtype=np.int64)
    per_row = ROW_BYTES // piece
    row_step = PRODUCERS // per_row
    rows_left = rows_total - row0
    for t in range(PRODUCERS):
        b = (t % per_row) * piece
        col = k * ROW_BYTES + b
        lim = 0 if col >= row_bytes else min(rows_left, nrows)
        for r in range(t // per_row, nrows, row_step):
            d = r * ROW_BYTES + ((((b >> 4) ^ (r & 7)) << 4) | (b & 15))
            if r < lim:
                assert col + piece <= row_bytes  # no piece crosses the end
                src = mat[row0 + r, col:col + piece]
            else:
                src = np.zeros(piece, dtype=np.uint8)  # src-size 0
            stage[d:d + piece] = src
            writes[d:d + piece] += 1
    return stage, writes


@pytest.mark.parametrize("dim,piece", [(1020, 8), (1018, 4), (300, 8),
                                       (100, 8), (50, 4), (1024, 8),
                                       (1024, 4)])
@pytest.mark.parametrize("nrows", [128, 256])
def test_cp_stage_lands_where_tma_puts_it(dim, piece, nrows):
    """Every k-stage of the first tile and of the last (ragged) one: each
    piece at TMA's swizzled offset, zeros past dim and past the rows that
    exist, every byte written exactly once."""
    rng = np.random.default_rng(dim + piece + nrows)
    rows = nrows + 37  # the second tile holds 37 rows
    mat = bf16_bytes(rng, rows, dim)
    assert mat.shape[1] % piece == 0
    k_iters = -(-mat.shape[1] // ROW_BYTES)
    for row0 in (0, nrows):
        for k in range(k_iters):
            got, writes = _cp_stage(mat, row0, k, rows, piece, nrows)
            assert (writes == 1).all()
            np.testing.assert_array_equal(got, tma_box(mat, row0, k, rows,
                                                        nrows))
    # the last stage of a row carries zeros past dim: 2 dim % 128 bytes
    last, _ = _cp_stage(mat, 0, k_iters - 1, rows, piece, nrows)
    tail = 2 * dim - (k_iters - 1) * ROW_BYTES
    addr = np.arange(nrows * ROW_BYTES)
    logical = last[addr ^ (((addr >> 7) & 7) << 4)].reshape(nrows, ROW_BYTES)
    assert (logical[:, tail:] == 0).all()


@pytest.mark.parametrize("dim,piece", [(1020, 8), (1018, 4), (50, 4)])
def test_stages_rebuild_the_operands_and_the_keys(dim, piece):
    """The query tile (Q = 70 of a 128-row box) and a corpus tile (cap =
    384: the second 256-row tile half past cap) copied stage by stage,
    unswizzled and joined, are the operands zero-padded to whole stages
    and tiles; their bf16 products packed as K1's keys agree with the
    plain version's (KEY_MIN pattern equal, decoded values within 1e-5 of
    unit-vector scores: the padding's zeros change only the summation
    order)."""
    rng = np.random.default_rng(dim)
    nq, cap = 70, 384

    def unit(n):
        x = rng.standard_normal((n, dim)).astype(np.float32)
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        return torch.from_numpy(x).to(torch.bfloat16)

    qb, vb = unit(nq), unit(cap)
    mask = torch.from_numpy(rng.random(cap) > 0.2)
    k_iters = -(-2 * dim // ROW_BYTES)

    def operand(t, rows, tile):
        mat = t.view(torch.uint8).numpy().reshape(t.shape[0], 2 * dim)
        out = []
        for row0 in range(0, rows, tile):
            st = []
            for k in range(k_iters):
                got, _ = _cp_stage(mat, row0, k, rows, piece, tile)
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

    qa = operand(qb, nq, 128)
    va = operand(vb, cap, 256)
    scores = (qa.float() @ va.float().T)[:nq, :cap]
    keys = tscan._segmax_keys(scores.contiguous(), mask)
    ref = tscan.segmax_scan_plain(qb, vb, mask)
    live = ref != tscan.KEY_MIN
    assert torch.equal(keys != tscan.KEY_MIN, live)

    def dec(kk):
        return tscan._from_sortable(kk & ~(SEG - 1)).view(torch.float32)

    assert float((dec(keys)[live] - dec(ref)[live]).abs().max()) <= 1e-5


# --------------------------------------------------------------------------
# The ready rule and the dispatch
# --------------------------------------------------------------------------


def _operands(dim, offset=0, nq=16, rows=256):
    """bf16 queries and rows whose base lies `offset` bytes past a 16-byte
    boundary."""
    q = torch.zeros(nq, dim, dtype=torch.bfloat16)
    flat = torch.zeros(rows * dim + 16, dtype=torch.bfloat16)
    assert flat.data_ptr() % 16 == 0
    v = flat[offset // 2:offset // 2 + rows * dim].view(rows, dim)
    return q, v


@pytest.mark.parametrize("dim,offset,want", [
    (1024, 0, "tma"), (1020, 0, 8), (1018, 0, 4), (300, 0, 8), (100, 0, 8),
    (50, 0, 4), (97, 0, "realign"), (1019, 0, "realign"), (1024, 8, 8),
    (1024, 4, 4), (1024, 2, "realign"), (1020, 4, 4), (1020, 2, "realign"),
    (50, 2, "realign")])
def test_cpasync_ready_rule(dim, offset, want):
    """TMA at rows of whole 16 bytes and 16-byte aligned bases; else
    cp.async in 8-byte pieces where the row bytes and the bases are
    multiples of 8, in 4-byte pieces where they are multiples of 4; else
    (odd dim, 2-byte aligned views) the realigning producer."""
    q, v = _operands(dim, offset)
    assert tscan.wgmma_ready(q, v) == (want == "tma")
    assert tscan.cpasync_ready(q, v) == (want in (8, 4))
    assert tscan.realign_ready(q, v) == (want == "realign")
    if want in (8, 4):
        assert tscan.cpasync_piece(q, v) == want


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


@pytest.mark.parametrize("dim,offset,entry", [
    (1024, 0, "pv_segmax_scan_wgmma"), (1020, 0, "pv_segmax_scan_cpasync"),
    (1018, 0, "pv_segmax_scan_cpasync"), (300, 0, "pv_segmax_scan_cpasync"),
    (1024, 8, "pv_segmax_scan_cpasync"), (97, 0, "pv_segmax_scan_realign"),
    (1024, 2, "pv_segmax_scan_realign")])
def test_k1_dispatch_by_ready_rules(recorded, dim, offset, entry):
    """K1 takes the TMA mainloop, the cp.async one or the realigning one by
    the ready rules, with the same arguments (q, v, mask, keys, Q, cap,
    dim); "segmax" counts all three, "segmax_wgmma", "segmax_cpasync" and
    "segmax_realign" their own; the wmma tile is never dispatched."""
    q, v = _operands(dim, offset, nq=17, rows=2 * SEG)
    mask = torch.ones(2 * SEG, dtype=torch.bool)
    before = dict(tscan.LAUNCHES)
    keys = tscan.segmax_scan(*map(_as_cuda, (q, v, mask)))
    assert keys.shape == (17, 4)
    (got, args), = recorded
    assert got == entry
    assert args[:3] == (q.data_ptr(), v.data_ptr(), mask.data_ptr())
    assert args[4:] == (17, 2 * SEG, dim)
    assert tscan.LAUNCHES["segmax"] == before["segmax"] + 1
    assert (tscan.LAUNCHES["segmax_wgmma"] - before["segmax_wgmma"]
            == (entry == "pv_segmax_scan_wgmma"))
    assert (tscan.LAUNCHES["segmax_cpasync"] - before["segmax_cpasync"]
            == (entry == "pv_segmax_scan_cpasync"))
    assert (tscan.LAUNCHES["segmax_realign"] - before["segmax_realign"]
            == (entry == "pv_segmax_scan_realign"))


def test_counters_stay_zero_on_the_cpu():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((20, 1020)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((256, 1020)).astype(np.float32))
    mask = torch.from_numpy(rng.random(256) > 0.3)
    qb, vb = q.to(torch.bfloat16), v.to(torch.bfloat16)
    tscan.reset_launch_counts()
    keys = tscan.segmax_scan(qb, vb, mask)
    assert torch.equal(keys, tscan.segmax_scan_plain(qb, vb, mask))
    assert tscan.LAUNCHES["segmax_cpasync"] == tscan.LAUNCHES["segmax"] == 0
