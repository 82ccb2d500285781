"""K4's narrow sweep over rows the 16-byte sweep cannot read
(csrc/sweep_topk.cu `sweep_narrow_kernel<F32 | Bf16F>`,
`topk_narrow_ready`), checked on the CPU.

* Its reads, emulated in numpy over a flat byte array that stands for
  device memory: float32 and bf16 rows at every byte phase their element
  allows (0, 4, 8, 12 / 0, 2, ..., 14) of a 16-byte boundary, NaN bytes
  around them and in the masked-out rows between live ones. The CTA's
  phase copies are filled by the kernel's own index formulas (`F32`: byte
  b of copy j is the query's byte b - j g; `Bf16F`: float f of word c of
  half h of copy j is the query's element 8 c + 4 h + f - j g / 2), each
  row is read as the aligned 16-byte words that hold a byte of it, its
  first and last word's bytes that are not the row's zeroed
  (`clip_word`), and met with the copy of its phase. Rows and queries of
  small integers make every float32 sum exact: the sums equal the exact
  ones (no NaN reaches a sum), no word read lies outside the 16-byte
  chunks that hold a byte of the row, and the (score, row) keys over
  `sweep_partition`'s ranges select the plain version's scores bit for
  bit.
* `topk_narrow_bytes` restates the kernel's `Narrow::smem`;
  `topk_narrow_ready` at its edges (the 16-byte sweep's operands stay the
  sweep's, Q <= TOPK_NARROW_Q_MAX, k <= 128, the phase copies within
  NARROW_SMEM_BYTES: bf16 rows at dim 1019 take Q <= 2).
* The dispatch on CPU tensors posing as CUDA ones, recorded at
  `scan._launch` against `_build._SIGNATURES`: every (dtype in {float32,
  bf16}, dim in {25, 100, 1019, 1020, 1024}, base offset, Q, k) takes
  exactly one of K4's kinds (the sweep, its narrow kind, the tensor-core
  scan, the wide kind), none the template; the narrow kind's launch passes
  the rows' kind first, and counts "scan_topk_narrow" with its shape.
"""

import types

import numpy as np
import pytest
import torch

from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

SEG = tscan.SEG
CAP = 4096
POISON = 0xFF  # NaN in float32 and in bf16


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
    start = (-flat.data_ptr() % 16 + off_bytes) // es
    v = flat[start:start + n].view(shape)
    assert v.data_ptr() % 16 == off_bytes % 16
    return v


# --------------------------------------------------------------------------
# The reads, emulated
# --------------------------------------------------------------------------


def _narrow(rb, base):
    """The kernel's `Narrow`: (lg, W) for rows of rb bytes at `base`."""
    lg = 4
    while lg > 0 and (rb | (base & 15)) & ((1 << lg) - 1):
        lg -= 1
    return lg, (16 - (1 << lg) + rb + 15) // 16


def _block(q, es, rb, lg, W, QT):
    """The CTA's query block of phase copies, filled by the kernel's
    formulas, as uint8 (P x QT x QW x W words of 16 bytes)."""
    P = 16 >> lg
    qw = 2 if es == 2 else 1
    nq = q.shape[0]
    if es == 2:  # Bf16F: a float a thread
        n, wf = rb // 2, W * 4
        i = np.arange(P * QT * 2 * wf)
        ch, e = i // wf, i % wf
        h, cq = ch % 2, ch // 2
        j, qq = cq // QT, cq % QT
        src = 2 * (e & ~3) + 4 * h + (e & 3) - ((j << lg) >> 1)
        ok = (qq < nq) & (src >= 0) & (src < n)
        out = np.zeros(i.shape, dtype=np.float32)
        out[ok] = q[qq[ok], src[ok]]
        return out.view(np.uint8)
    qb = q.astype(np.float32).view(np.uint8).reshape(nq, -1)  # F32: bytes
    wb = W * 16
    i = np.arange(P * QT * qw * wb)
    ch, b = i // wb, i % wb
    cq = ch // qw
    j, qq = cq // QT, cq % QT
    src = b - (j << lg)
    ok = (qq < nq) & (src >= 0) & (src < rb)
    out = np.zeros(i.shape, dtype=np.uint8)
    out[ok] = qb[qq[ok], src[ok]]
    return out


def _clip(x, lo, hi):
    """clip_word: the bytes of a 16-byte word outside [lo, hi) zeroed."""
    x = x.copy()
    b = np.arange(16)
    x[(b < lo) | (b >= hi)] = 0
    return x


def _word_dot(xw, cw, es):
    """The kind's word product in float32: F32's 4 floats against the
    copy's word; Bf16F's 8 bf16 against the copy's halves (cw: 2 words)."""
    if es == 4:
        return np.float32(np.dot(xw.view(np.float32).astype(np.float64),
                                 cw.view(np.float32).astype(np.float64)))
    bits = xw.view(np.uint16).astype(np.uint32) << 16
    row = bits.view(np.float32).astype(np.float64)
    return np.float32(np.dot(row, cw.view(np.float32).astype(np.float64)))


def _emulate(mem, base, q, cap, dim, es, live):
    """Every live row's sum with every query as the narrow kind forms it,
    and the byte ranges its words read."""
    rb = dim * es
    lg, W = _narrow(rb, base)
    QT = tscan.sweep_tile(q.shape[0])
    qw = 2 if es == 2 else 1
    QS = qw * W
    blk = _block(q, es, rb, lg, W, QT).reshape(-1, 16)
    v0, vw = base & 15, base & ~15
    sums = np.zeros((q.shape[0], cap), dtype=np.float32)
    reads = []
    for r in np.flatnonzero(live):
        b0 = v0 + r * rb
        ph = b0 & 15
        assert ph % (1 << lg) == 0  # the row's phase has a copy
        nw = (ph + rb + 15) >> 4
        assert nw <= W
        w0 = vw + 16 * (b0 >> 4)
        reads.append((w0, w0 + 16 * nw))
        for qq in range(q.shape[0]):
            acc = np.float32(0)
            for c in range(nw):
                x = _clip(mem[w0 + 16 * c:w0 + 16 * c + 16], ph - 16 * c,
                          ph + rb - 16 * c)
                cp = (ph >> lg) * QT * QS + qq * QS + c
                cw = (blk[cp] if qw == 1
                      else np.concatenate([blk[cp], blk[cp + W]]))
                acc = np.float32(acc + _word_dot(x, cw, es))
            sums[qq, r] = acc
    return sums, reads


def _float_order(s):
    u = s.astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def _select_vals(sums, live, k, cap):
    """The selection's scores over `sweep_partition`'s ranges (two CTAs a
    SM on a one-SM card) and the merge: the k best keys' scores, -inf
    where empty."""
    chunk, n = tscan.sweep_partition(cap, 1)
    rows = np.arange(cap, dtype=np.uint64)
    keys = (_float_order(sums) << np.uint64(32)) | (np.uint64(0xFFFFFFFF)
                                                    - rows)[None, :]
    keys = np.where(live[None, :], keys, np.uint64(0))
    cand = [np.sort(keys[:, c * chunk:(c + 1) * chunk], axis=1)[:, ::-1][:, :k]
            for c in range(n)]
    top = np.sort(np.concatenate(cand, axis=1), axis=1)[:, ::-1][:, :k]
    top = np.pad(top, ((0, 0), (0, k - top.shape[1])))
    hi = top >> np.uint64(32)
    u = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi & 0xFFFFFFFF)
    return np.where(top == 0, -np.inf,
                    u.astype(np.uint32).view(np.float32)).astype(np.float32)


def _memory(rows, es, phase, nan_rows):
    """Device memory holding the rows (float32 values, stored as float32 or
    bf16) at a 16-byte boundary plus `phase`, NaN bytes around them and in
    the rows `nan_rows`: (memory as uint8, base)."""
    stored = (rows.astype(np.float32) if es == 4 else
              (rows.astype(np.float32).view(np.uint32) >> 16)
              .astype(np.uint16))
    raw = stored.view(np.uint8).reshape(rows.shape[0], -1).copy()
    raw[nan_rows] = POISON
    base = 64 + phase
    mem = np.full(base + raw.size + 64, POISON, dtype=np.uint8)
    mem[base:base + raw.size] = raw.reshape(-1)
    return mem, base


@pytest.mark.parametrize("es,dim", [(4, 25), (4, 98), (4, 1019),
                                    (2, 25), (2, 100), (2, 1019), (2, 1020)])
@pytest.mark.parametrize("nq", [1, 3])
def test_narrow_reads_emulated(es, dim, nq):
    rng = np.random.default_rng(es * 1000 + dim + nq)
    cap = 40
    rows = rng.integers(-8, 9, (cap, dim)).astype(np.float32)
    q = rng.integers(-8, 9, (nq, dim)).astype(np.float32)
    live = rng.random(cap) > 0.25
    live[[3, 4]] = (True, False)  # a NaN row beside a live one
    exact = q.astype(np.int64) @ rows.astype(np.int64).T
    for phase in range(0, 16, es):
        mem, base = _memory(rows, es, phase, np.flatnonzero(~live))
        rb = dim * es
        sums, reads = _emulate(mem, base, q, cap, dim, es, live)
        assert not np.isnan(sums).any()
        np.testing.assert_array_equal(sums[:, live], exact[:, live])
        for (lo, hi), r in zip(reads, np.flatnonzero(live)):
            first, last = base + r * rb, base + (r + 1) * rb - 1
            assert lo == first & ~15 and hi == (last & ~15) + 16
        for k in (1, 14):
            vals = _select_vals(sums, live, k, cap)
            tv, _ = tscan.scan_topk_plain(
                torch.from_numpy(q),
                torch.from_numpy(rows).to(torch.float32 if es == 4
                                          else torch.bfloat16),
                None, torch.from_numpy(live), k)
            np.testing.assert_array_equal(vals, tv.numpy())  # bit for bit


# --------------------------------------------------------------------------
# The ready rule and its shared memory
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [25, 100, 1019, 1020, 1022])
@pytest.mark.parametrize("es,off", [(4, 0), (4, 4), (4, 8), (2, 0), (2, 2),
                                    (2, 4), (2, 8)])
@pytest.mark.parametrize("nq", [1, 2, 3, 4, 8, 16])
def test_topk_narrow_bytes_restates_the_kernel(dim, es, off, nq):
    rb = dim * es
    lg, W = _narrow(rb, off)
    qt = tscan.sweep_tile(nq)
    qw = 2 if es == 2 else 1
    smem = ((16 >> lg) * qt * qw * W * 16 + qt * 256 * 8 + qt * 12
            + (qt * 4 if qw == 2 else 0))
    assert tscan.topk_narrow_bytes(nq, dim, es, off) == smem


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_topk_narrow_ready_edges(dtype):
    lim = tscan.TOPK_NARROW_Q_MAX
    es = torch.empty(0, dtype=dtype).element_size()
    odd = _view((CAP, 25), dtype, 0)  # 100 / 50 bytes a row
    q = _view((lim + 1, 25), torch.float32, 0)
    assert tscan.topk_narrow_ready(q[:1], odd, 128)
    assert tscan.topk_narrow_ready(q[:lim], odd, 14)
    assert not tscan.topk_narrow_ready(q, odd, 14)
    assert not tscan.topk_narrow_ready(q[:1], odd, 129)
    assert not tscan.topk_narrow_ready(q[:1].to(torch.bfloat16), odd, 14)
    # rows and a query the 16-byte sweep reads stay the sweep's; a base
    # off 16 bytes, or the query's, are the narrow kind's
    whole = _view((CAP, 96), dtype, 0)
    q96 = _view((1, 96), torch.float32, 0)
    assert not tscan.topk_narrow_ready(q96, whole, 14)
    assert tscan.topk_narrow_ready(q96, _view((CAP, 96), dtype, es), 14)
    assert tscan.topk_narrow_ready(_view((1, 96), torch.float32, 4), whole,
                                   14)
    # the phase copies: bf16 rows at dim 1019 (eight copies, 129 words
    # each, twice) leave room for two queries
    big = _view((CAP, 1019), dtype, 0)
    q1019 = _view((lim + 1, 1019), torch.float32, 0)
    for nq in range(1, lim + 1):
        fits = (tscan.topk_narrow_bytes(nq, 1019, es, big.data_ptr())
                <= tscan.NARROW_SMEM_BYTES)
        assert tscan.topk_narrow_ready(q1019[:nq], big, 14) == fits
        # what the narrow kind cannot hold, the tensor-core scan takes
        assert tscan.topk_wgmma_ready(q1019[:nq], big, 14) == (not fits)
    if dtype == torch.bfloat16:
        assert tscan.topk_narrow_bytes(2, 1019, 2, 0) <= tscan.NARROW_SMEM_BYTES
        assert tscan.topk_narrow_bytes(3, 1019, 2, 0) > tscan.NARROW_SMEM_BYTES


# --------------------------------------------------------------------------
# The dispatch
# --------------------------------------------------------------------------

K4_KINDS = [
    ("sweep", tscan.topk_sweep_ready, "pv_sweep_topk_f32", "scan_topk_sweep"),
    ("narrow", tscan.topk_narrow_ready, "pv_sweep_topk_f32_narrow",
     "scan_topk_narrow"),
    ("scan", tscan.topk_wgmma_ready, "pv_scan_topk_wgmma", "scan_topk_wgmma+"),
    ("wide", tscan.topk_wide_ready, "pv_scan_topk_wide", "scan_topk_wide+")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [25, 100, 1019, 1020, 1024])
def test_every_width_and_base_takes_one_kind(recorded, dtype, dim):
    es = torch.empty(0, dtype=dtype).element_size()
    mask = torch.ones(CAP, dtype=torch.bool)
    seen = set()
    for off in range(0, 9, es):
        v = _view((CAP, dim), dtype, off)
        for qoff in (0, 4):
            for nq in (1, 2, 3, 4, 5, 8, 9, 16, 17, 64):
                q = _view((nq, dim), torch.float32, qoff)
                for k in (1, 14, 128, 129, 1024):
                    held = [kd for kd in K4_KINDS if kd[1](q, v, k)]
                    assert len(held) == 1, (off, qoff, nq, k,
                                            [kd[0] for kd in held])
                    name, _, entry, key = held[0]
                    if key.endswith("+"):
                        key = key[:-1] + tscan._PIECE_KEY[tscan.rows_piece(v)]
                    before = dict(tscan.LAUNCHES)
                    recorded.clear()
                    tscan.fused_topk(*map(_as_cuda, (q, v, mask)), k)
                    (got, args), = recorded
                    assert got == entry, (name, got)
                    grew = {n for n in tscan.LAUNCHES
                            if tscan.LAUNCHES[n] > before[n]}
                    assert grew == {"scan_topk", key}, grew
                    if name in ("sweep", "narrow"):
                        assert args[0] == (0 if es == 4 else 1)
                        assert args[7:11] == (nq, CAP, dim, k)
                        assert tscan.LAUNCH_SHAPES[key][nq, k] >= 1
                    seen.add(name)
    per = 16 // es
    want = {"narrow", "scan", "wide"} | ({"sweep"} if dim % per == 0 else set())
    assert seen == want
