"""K3's narrow sweep (csrc/sweep_topk.cu `sweep_narrow_kernel`,
`i8_narrow_ready`), checked on the CPU.

* Its reads, emulated in numpy over a flat byte array that stands for
  device memory (the int8 rows at every byte phase 0..15 of a 16-byte
  boundary, poison bytes around them), at dims 25, 50, 100, 300, 1019 and
  1020: the CTA's phase copies of each query (P = 16 / g copies, copy j
  holding j g zero bytes, the query, zeros to W whole words), each row
  read as the aligned 16-byte words that hold a byte of it and met with
  the copy of its phase. The int32 sums are the exact ones (a
  neighbouring row's bytes in a shared word meet zeros), no word read
  lies outside the 16-byte chunks that hold a byte of the row, and the
  keys float32(sum) * scale ranked by (score, row) select what the plain
  version selects, bit for bit (masked rows and scales <= 0 included).
* `narrow_phases` / `narrow_block_bytes` restate the kernel's `Narrow`
  (g the largest power of two <= 16 dividing dim and the base), and
  `i8_narrow_ready`'s edges: the 16-byte sweep's operands stay the
  sweep's, the query block and buffers within NARROW_SMEM_BYTES, Q <=
  I8_SWEEP_Q_MAX, k <= 384.
"""

import numpy as np
import pytest
import torch

from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

POISON = 0x7E  # device memory around the rows (int8 126)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _memory(v8, phase):
    """Device memory holding the rows at a 16-byte boundary plus `phase`,
    poison around them: (memory as uint8, base)."""
    base = 64 + phase
    mem = np.full(base + v8.size + 64, POISON, dtype=np.uint8)
    mem[base:base + v8.size] = v8.view(np.uint8).reshape(-1)
    return mem, base


def _copies(q8, dim, phases, words):
    """The CTA's query block: copy j of query qq at [j, qq], j g zero
    bytes, the query's dim bytes, zeros to `words` 16-byte words."""
    g = 16 // phases
    out = np.zeros((phases, q8.shape[0], words * 16), dtype=np.int8)
    for j in range(phases):
        out[j, :, j * g:j * g + dim] = q8
    return out


def _narrow_sums(mem, base, q8, cap, dim):
    """Every row's int32 sum with every query as the kernel forms it, and
    the bytes each row's word reads touched."""
    phases = tscan.narrow_phases(dim, base)
    words = -(-(16 - 16 // phases + dim) // 16)
    g = 16 // phases
    copies = _copies(q8, dim, phases, words)
    sums = np.zeros((q8.shape[0], cap), dtype=np.int64)
    reads = []
    for r in range(cap):
        b0 = base + r * dim
        ph = b0 & 15
        assert ph % g == 0  # the row's phase has a copy
        w0, nw = b0 >> 4, (ph + dim + 15) >> 4
        assert nw <= words
        got = mem[16 * w0:16 * (w0 + nw)].view(np.int8).astype(np.int64)
        reads.append((16 * w0, 16 * (w0 + nw)))
        sums[:, r] = copies[ph // g, :, :16 * nw].astype(np.int64) @ got
    return sums, reads


def _float_order(s):
    u = s.astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def _select(scores, mask, k):
    """The k best live rows by (float_order(score), lower row)."""
    vals = np.full((scores.shape[0], k), -np.inf, dtype=np.float32)
    idx = np.zeros((scores.shape[0], k), dtype=np.int32)
    rows = np.flatnonzero(mask)
    for i in range(scores.shape[0]):
        order = rows[np.lexsort((rows, -_float_order(scores[i, rows]).astype(
            np.float64)))][:k]
        vals[i, :len(order)] = scores[i, order]
        idx[i, :len(order)] = order
    return vals, idx


@pytest.mark.parametrize("dim", [100, 300, 1020, 1019, 25, 50])
@pytest.mark.parametrize("phase", range(16))
def test_narrow_reads_rebuild_the_plain_sums_and_keys(dim, phase):
    rng = np.random.default_rng(dim * 16 + phase)
    cap, nq = 300, 3
    v8 = rng.integers(-127, 128, (cap, dim)).astype(np.int8)
    q8 = rng.integers(-127, 128, (nq, dim)).astype(np.int8)
    vs = rng.uniform(0.001, 0.01, cap).astype(np.float32)
    vs[40:50] = 0.0
    vs[50:60] = -0.004
    v8[200] = v8[100]  # equal rows: ties to the lower row
    vs[200] = vs[100]
    mask = rng.random(cap) > 0.15
    mem, base = _memory(v8, phase)
    sums, reads = _narrow_sums(mem, base, q8, cap, dim)
    exact = q8.astype(np.int64) @ v8.astype(np.int64).T
    np.testing.assert_array_equal(sums, exact)
    for r, (lo, hi) in enumerate(reads):  # within the row's chunks
        first, last = base + r * dim, base + (r + 1) * dim - 1
        assert lo == first - first % 16 and hi == last - last % 16 + 16
    scores = sums.astype(np.float32) * vs[None, :]
    for k in (14, 142):
        want = _select(scores, mask, k)
        got = tscan.scan_topk_plain(_t(q8), _t(v8), _t(vs), _t(mask), k)
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])


@pytest.mark.parametrize("dim,ptr,phases", [
    (1024, 0, 1), (1024, 16, 1), (1024, 8, 2), (1020, 0, 4), (1020, 4, 4),
    (1020, 2, 8), (1018, 0, 8), (100, 0, 4), (300, 8, 4), (1019, 0, 16),
    (1024, 1, 16), (25, 3, 16), (50, 0, 8), (48, 16, 1), (48, 32, 1)])
def test_narrow_phases(dim, ptr, phases):
    assert tscan.narrow_phases(dim, ptr) == phases
    g = 16 // phases
    # a row starts at byte j g of its word for every j < phases
    starts = {(ptr + r * dim) % 16 for r in range(64)}
    assert starts <= set(range(ptr % g, 16, g))


def test_narrow_block_bytes():
    # 16 copies of W = ceil((15 + 1019) / 16) = 65 words a query
    assert tscan.narrow_block_bytes(4, 1019, 0) == 4 * 16 * 65 * 16
    assert tscan.narrow_block_bytes(1, 100, 0) == 1 * 4 * 7 * 16
    assert tscan.narrow_block_bytes(3, 1020, 4) == 4 * 4 * 65 * 16
    assert tscan.narrow_block_bytes(2, 1024, 0) == 2 * 1 * 64 * 16


def _operands(dim, nq=1, offset=0, rows=512):
    q = torch.zeros(nq, dim, dtype=torch.int8)
    flat = torch.zeros(rows * dim + 16, dtype=torch.int8)
    return q, flat[offset:offset + rows * dim].view(rows, dim)


def test_i8_narrow_ready_edges():
    lim = tscan.I8_SWEEP_Q_MAX
    for dim in (25, 50, 100, 300, 1019, 1020):
        for nq in range(1, lim + 1):
            q, v = _operands(dim, nq)
            for k in (1, 14, 128, 129, 384):
                assert tscan.i8_narrow_ready(q, v, k), (dim, nq, k)
            assert not tscan.i8_narrow_ready(q, v, 385)
        assert not tscan.i8_narrow_ready(*_operands(dim, lim + 1), 14)
    # the 16-byte sweep's operands stay the sweep's; a base or a query
    # view off 16 bytes leaves it
    assert not tscan.i8_narrow_ready(*_operands(96, 1), 14)
    assert tscan.i8_narrow_ready(*_operands(96, 1, offset=1), 14)
    qm = torch.zeros(96 + 1, dtype=torch.int8)[1:].view(1, 96)
    assert tscan.i8_narrow_ready(qm, _operands(96, 1)[1], 14)
    # odd widths at Q = 4: 16 copies a query, within NARROW_SMEM_BYTES up
    # to dim 1,505 (W = 95 words) at 128 < k <= 384, 1,633 at k <= 128
    assert tscan.i8_narrow_ready(*_operands(1505, 4, rows=2), 384)
    assert not tscan.i8_narrow_ready(*_operands(1507, 4, rows=2), 384)
    assert tscan.i8_narrow_ready(*_operands(1633, 4, rows=2), 128)
    assert not tscan.i8_narrow_ready(*_operands(1635, 4, rows=2), 128)
    assert tscan.i8_narrow_ready(*_operands(1507, 2, rows=2), 384)
    for nq, dim, k in ((4, 1505, 384), (1, 2001, 14), (4, 1020, 200)):
        q, v = _operands(dim, nq, rows=2)
        qt = tscan.sweep_tile(nq)
        used = tscan.narrow_block_bytes(nq, dim, v.data_ptr()) + qt * (
            (256 if k <= 128 else 512) * 8 + 12)
        assert used <= tscan.NARROW_SMEM_BYTES


def test_counter_stays_zero_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    v8 = torch.randint(-127, 128, (512, 100), generator=g, dtype=torch.int8)
    q8 = torch.randint(-127, 128, (1, 100), generator=g, dtype=torch.int8)
    tscan.reset_launch_counts()
    tscan.fused_topk_i8(q8, v8, torch.ones(512),
                        torch.ones(512, dtype=torch.bool), 14)
    assert tscan.LAUNCHES["scan_topk_i8"] == 0
    assert tscan.LAUNCHES["scan_topk_i8_narrow"] == 0
