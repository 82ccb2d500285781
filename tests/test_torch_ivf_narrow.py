"""K7 and K8 over IVF postings TMA cannot read, checked on the CPU.

* K7's narrow sweep (csrc/sweep_topk.cu `sweep_narrow_kernel` over the
  float32, bf16 and column-scaled int8 kinds and a hot-tile `Rows` map),
  emulated in numpy over a flat byte array standing for device memory:
  postings of dims 25 / 50 / 100 / 1019 at every element-aligned byte
  offset 1-15 from a 16-byte boundary, poison around them (NaN bit
  patterns for the float kinds). The CTA shares of `ivf_sweep_partition`
  over the live hot steps, each row read as the aligned 16-byte words that
  hold a byte of it (the float kinds zeroing the bytes of the first and
  last word that are not the row's, `clip_word`), met with the query's
  phase copy (P = 16 / g copies, copy j holding j g zero bytes, g a
  multiple of the element's bytes); a partial top-k a share, then the
  merge. int8: bit for bit `ivf_scan_topk_plain(ctas=...)`; float32 and
  bf16: the same ids outside the 1e-4 gap, scores within 1e-5 (products
  summed in float64 here, in float32 there), no NaN from the poison.
* The realigning producer's class maps at hot-tile segment starts (K7's
  tensor-core scan and wide kind, K8's segment scan): every k-stage of a
  segment at rows hot[b] * bn + s * 128 is TMA's box of those rows.
* The ready rules at their edges (`ivf_narrow_ready`, `ivf_wgmma_ready`,
  `ivf_wide_ready`).
* The dispatch partition: up to 64M postings rows every (dtype, width,
  base alignment 1 / 2 / 4 / 8 / 16, Q, k <= 1024) reaches exactly one K7
  kind and none reaches the template; every K8 call the segment scan; the
  launches recorded on CPU tensors posing as CUDA ones, their arguments
  counted against `_build._SIGNATURES`.
"""

import types

import numpy as np
import pytest
import torch

from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import ivf as tivf
from picovdb_tpu_torch.ops import scan as tscan
from test_torch_narrow_stages import _matrix, _memory, _realign_stage
from torch_port_setup import cap_torch_threads, tma_box

cap_torch_threads()

TOL_SCORE = 1e-5
TOL_GAP = 1e-4
BN = 128  # the emulation's tile (any multiple of the share unit 16)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i8c": torch.int8}
ES = {"f32": 4, "bf16": 2, "i8c": 1}
NP = {"f32": np.float32, "bf16": None, "i8c": np.int8}
POISON = 0xFF  # float32 / bf16 NaN, int8 -1


def _rows(rng, kind, cap, dim):
    x = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((cap, dim)).astype(np.float32)),
        dim=1)
    if kind == "i8c":
        return torch.clamp(torch.round(x * 120), -127, 127).to(torch.int8)
    return x.to(DTYPES[kind])


def _elements(buf, kind):
    """Bytes (..., n) as the kind's elements, float64 (int8: int64)."""
    if kind == "i8c":
        return buf.view(np.int8).astype(np.int64)
    if kind == "f32":
        return buf.view("<f4").astype(np.float64)
    u = buf.view("<u2").astype(np.uint32) << 16  # bf16: the high half
    return u.view("<f4").astype(np.float64)


def _narrow_scores(mem, base, q, kind, dim, rows):
    """Each query's score with each physical row in `rows`, as the narrow
    sweep forms it: the row's aligned words (clipped for the float kinds)
    met with the copy of its phase."""
    es = ES[kind]
    rb = dim * es
    g = 16
    while g > 1 and (rb | base) % g:
        g //= 2
    assert g >= es  # a phase copy for every element-aligned row start
    words = -(-(16 - g + rb) // 16)
    qb = q.view(torch.uint8).numpy().reshape(q.shape[0], rb)
    copies = np.zeros((16 // g, q.shape[0], 16 * words), dtype=np.uint8)
    for j in range(16 // g):
        copies[j, :, j * g:j * g + rb] = qb
    out = np.zeros((q.shape[0], len(rows)))
    for n, p in enumerate(rows):
        b0 = base + int(p) * rb
        ph = b0 & 15
        nw = (ph + rb + 15) >> 4
        got = mem[16 * (b0 >> 4):16 * ((b0 >> 4) + nw)].copy()
        if kind != "i8c":  # clip_word: bytes outside the row zeroed
            pos = np.arange(got.size)
            got[(pos < ph) | (pos >= ph + rb)] = 0
        x = _elements(got, kind)
        c = _elements(copies[ph // g, :, :16 * nw], kind)
        out[:, n] = c @ x
    return out


def _keys(scores, rows, kind):
    """(score, row) keys: higher score first, ties to the lower row."""
    return sorted(((-s, int(r)) for s, r in zip(scores, rows)))


# (kind, byte offset of the postings from a 16-byte boundary): every
# element-aligned offset 1-15 (no tensor lies off its element's bytes)
OFFSETS = [(kind, off) for kind in ("f32", "bf16", "i8c")
           for off in range(ES[kind], 16, ES[kind])]


@pytest.mark.parametrize("kind,offset", OFFSETS)
@pytest.mark.parametrize("dim", [25, 50, 100, 1019])
def test_narrow_sweep_over_hot_tile_shares(kind, dim, offset):
    es = ES[kind]
    rng = np.random.default_rng(dim * 16 + offset + es)
    n_tiles, nq, k = 6, 2, 14
    cap = n_tiles * BN
    v = _rows(rng, kind, cap, dim)
    v[3 * BN + 5] = v[BN + 9]  # equal rows in two live tiles: lower row
    q = _rows(rng, kind, nq, dim)
    mask = torch.from_numpy(rng.random(cap) > 0.15)
    hot = torch.tensor([4, 1, 3, 0, 5, 2], dtype=torch.int32)
    n_hot = torch.tensor([4], dtype=torch.int32)
    mat = v.view(torch.uint8).numpy().reshape(cap, -1)
    mem = np.full(64 + offset + mat.size + 64, POISON, dtype=np.uint8)
    base = 64 + offset
    mem[base:base + mat.size] = mat.reshape(-1)
    ctas = 5
    shares = tivf.ivf_sweep_partition(4, BN, ctas)
    assert shares[0][0] == 0 and shares[-1][1] == 4 * BN
    merged = []
    for beg, end in shares:
        logical = np.arange(beg, end)
        phys = hot.numpy()[logical // BN].astype(np.int64) * BN + logical % BN
        live = phys[mask.numpy()[phys]]
        if live.size == 0:
            continue
        sc = _narrow_scores(mem, base, q, kind, dim, live)
        assert np.isfinite(sc).all()  # no poison reached a sum
        if kind == "i8c":  # the exact int32 sums
            exact = (q.numpy().astype(np.int64)
                     @ v.numpy()[live].astype(np.int64).T)
            np.testing.assert_array_equal(sc, exact)
        merged.append((sc, live))
    sc = np.concatenate([m[0] for m in merged], axis=1)
    rows = np.concatenate([m[1] for m in merged])
    pv, pi = tivf.ivf_scan_topk_plain(q, v, mask, hot, n_hot, k + 1, BN,
                                      ctas=ctas)
    for i in range(nq):
        want = _keys(sc[i], rows, kind)[:k]
        got_rows = [r for _, r in want]
        if kind == "i8c":
            assert pi[i, :k].tolist() == got_rows
            assert pv[i, :k].tolist() == [-s for s, _ in want]
        else:
            np.testing.assert_allclose(pv[i, :k].numpy(),
                                       [-s for s, _ in want], rtol=0,
                                       atol=TOL_SCORE)
            if pv[i, k - 1] - pv[i, k] > TOL_GAP:
                assert set(pi[i, :k].tolist()) == set(got_rows)


@pytest.mark.parametrize("dtype,dim,offset", [
    (torch.bfloat16, 25, 0), (torch.bfloat16, 25, 6), (torch.bfloat16, 101, 2),
    (torch.int8, 25, 0), (torch.int8, 25, 3), (torch.int8, 100, 1),
    (torch.int8, 1019, 0)])
def test_class_maps_at_hot_tile_segment_starts(dtype, dim, offset):
    """The realigning producer over a hot-tile table: the segment at
    physical rows hot[b] * bn + s * 128 (a multiple of 128, so the class
    maps' box coordinate r0 / 16 names its rows j, j + 16, ...) gives TMA's
    box of those rows at every k-stage, reading only the operand's
    chunks."""
    rng = np.random.default_rng(dim + offset)
    bn, n_tiles = 1024, 4
    rows = n_tiles * bn
    mat = _matrix(rng, rows, dim, dtype)
    mem, base = _memory(mat, offset)
    es = torch.empty(0, dtype=dtype).element_size()
    k_iters = -(-mat.shape[1] // 128)
    hot = [3, 0, 2]
    read = set()
    for b, s in ((0, 0), (0, 7), (1, 3), (2, 5)):
        row0 = hot[b] * bn + s * 128
        for k in range(k_iters):
            got, writes = _realign_stage(mem, base, mat.shape[1], es, rows,
                                         row0, k, read)
            assert (writes == 1).all()
            np.testing.assert_array_equal(got, tma_box(mat, row0, k, rows,
                                                        128))
    got = np.array(sorted(read))
    assert got.min() >= base - base % 16 and got.max() < base + mat.size


def _operands(kind, dim, nq=1, offset=0, rows=512, qoffset=0):
    dt = DTYPES[kind]
    qf = torch.zeros(nq * dim + 16, dtype=dt)
    q = qf[qoffset:qoffset + nq * dim].view(nq, dim)
    flat = torch.zeros(rows * dim + 16, dtype=dt)
    return q, flat[offset:offset + rows * dim].view(rows, dim)


@pytest.mark.parametrize("kind", ["f32", "bf16", "i8c"])
def test_ivf_narrow_ready_edges(kind):
    """Q <= 16, k <= 128, operands the 16-byte sweep cannot read (a row off
    whole 16 bytes, a base or a query view off 16 bytes), the query block
    of phase copies with the buffers within NARROW_SMEM_BYTES."""
    es = ES[kind]
    ragged = {4: 25, 2: 100, 1: 100}[es]
    whole = 16 // es * 6
    for nq in (1, 2, 5, 16):
        q, v = _operands(kind, ragged, nq)
        assert tivf.ivf_narrow_ready(q, v, 1)
        assert tivf.ivf_narrow_ready(q, v, 128)
        assert not tivf.ivf_narrow_ready(q, v, 129)
        assert not tivf.ivf_narrow_ready(*_operands(kind, whole, nq), 14)
        assert tivf.ivf_sweep_ready(*_operands(kind, whole, nq), 14)
        assert tivf.ivf_narrow_ready(*_operands(kind, whole, nq, offset=1), 14)
        assert tivf.ivf_narrow_ready(*_operands(kind, whole, nq, qoffset=1),
                                     14)
    assert not tivf.ivf_narrow_ready(*_operands(kind, ragged, 17), 14)
    # the shared-memory edge at Q = 16: the widest width taken at every
    # base, and the first refused at the worst phase count
    lim = {4: 313, 2: 305, 1: 289}[es]
    for off in range(0, 16 // es):
        assert tivf.ivf_narrow_ready(*_operands(kind, lim, 16, off, rows=2),
                                     14), off
    assert not all(tivf.ivf_narrow_ready(*_operands(kind, lim + 1, 16, off,
                                                    rows=2), 14)
                   for off in range(0, 16 // es))
    for nq, dim in ((16, lim), (4, 1019 if es == 4 else 1000)):
        q, v = _operands(kind, dim, nq, rows=2)
        if tivf.ivf_narrow_ready(q, v, 14):
            used = tscan.narrow_block_bytes(nq, dim * es, v.data_ptr()) \
                + tscan.sweep_tile(nq) * (256 * 8 + 12)
            assert used <= tscan.NARROW_SMEM_BYTES


@pytest.mark.parametrize("kind", ["f32", "bf16", "i8c"])
def test_tensor_core_kinds_take_every_width(kind):
    """`ivf_wgmma_ready` (k <= 128, where neither sweep takes the operands)
    and `ivf_wide_ready` (128 < k <= 1024, the slab within its budget) at
    every width and base."""
    es = ES[kind]
    for dim in (25, 50, 100, 101, 1019, 1536, 16 // es * 64):
        for off in sorted({0, 1, 16 // es // 2}):
            for nq in (1, 16, 17, 64):
                q, v = _operands(kind, dim, nq, off, rows=64)
                sweeps = (tivf.ivf_sweep_ready(q, v, 14)
                          or tivf.ivf_narrow_ready(q, v, 14))
                assert tivf.ivf_wgmma_ready(q, v, 14) != sweeps
                assert not tivf.ivf_wgmma_ready(q, v, 129)
                for k in (129, 544, 1024):
                    assert tivf.ivf_wide_ready(q, v, k)
                assert not tivf.ivf_wide_ready(q, v, 1025)


def _kind_of(q, v, k):
    """Every K7 kind whose ready rule holds (the dispatch takes the first)."""
    return [name for name, rule in (
        ("sweep", tivf.ivf_sweep_ready), ("narrow", tivf.ivf_narrow_ready),
        ("wgmma", tivf.ivf_wgmma_ready), ("wide", tivf.ivf_wide_ready))
        if rule(q, v, k)]


WIDTHS = list(range(1, 130)) + [255, 256, 300, 511, 1019, 1020, 1024, 1536,
                                2048, 4095]


@pytest.mark.parametrize("kind", ["f32", "bf16", "i8c"])
def test_every_dispatch_reaches_one_kind(kind):
    """(width, base alignment, Q, k <= 1024): exactly one ready rule holds
    (the sweep's and the narrow kind's exclude each other and the scan's,
    k decides between the scan and the wide kind), so the template serves
    none of them."""
    es = ES[kind]
    dt = DTYPES[kind]
    qs = (1, 2, 4, 5, 8, 9, 16, 17, 64, 300)
    ks = (1, 14, 68, 128, 129, 204, 544, 1024)
    for align in (16, 8, 4, 2, 1):
        if align < es:
            continue
        for dim in WIDTHS:
            flat = torch.zeros(64 * dim + 32, dtype=dt)
            off = (align // es) if align < 16 else 0
            v = flat[off:off + 64 * dim].view(64, dim)
            if (v.data_ptr() % 16) != (0 if align == 16 else align):
                pytest.skip("an unaligned CPU allocation")
            for nq in qs:
                q = torch.zeros(nq, dim, dtype=dt)
                for k in ks:
                    got = _kind_of(q, v, k)
                    assert len(got) == 1, (dim, align, nq, k, got)
                    assert (got[0] == "wide") == (k > 128)


def test_template_only_past_the_slab_budget():
    """Up to 64M postings rows (4 bytes a row of the slab within
    TOPK_WIDE_SLAB_BYTES) the wide kind takes every k past 128; one tile
    more and only k <= 128 keeps a kind."""
    for kind in DTYPES:
        q = torch.zeros(4, 25, dtype=DTYPES[kind])
        v = torch.empty((64 << 20, 25), dtype=DTYPES[kind], device="meta")
        assert tivf.ivf_wide_ready(q, v, 1024)
        big = torch.empty(((64 << 20) + 1024, 25), dtype=DTYPES[kind],
                          device="meta")
        assert not tivf.ivf_wide_ready(q, big, 129)
        assert _kind_of(q, big, 14) == ["narrow"]


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


ENTRIES = {"sweep": "pv_ivf_sweep_topk", "narrow": "pv_ivf_sweep_topk_narrow",
           "wgmma": "pv_ivf_scan_topk_wgmma", "wide": "pv_ivf_scan_topk_wide"}


@pytest.mark.parametrize("kind", ["f32", "bf16", "i8c"])
@pytest.mark.parametrize("dim,offset", [(25, 0), (100, 0), (50, 1), (96, 1),
                                        (96, 0), (1019, 0)])
@pytest.mark.parametrize("nq,k", [(1, 14), (16, 14), (17, 68), (64, 68),
                                  (1, 144), (16, 204), (64, 1024)])
def test_recorded_launches(recorded, kind, dim, offset, nq, k):
    """The wrapper launches the kind its ready rules name with the rows'
    producer `rows_piece` names, the argument count of the library's
    signature, and counts it under the kind's key (the tensor-core kinds'
    suffix naming the producer); K8 launches its segment scan."""
    dt = DTYPES[kind]
    n_tiles = 4
    q = torch.zeros(nq, dim, dtype=dt)
    flat = torch.zeros(n_tiles * 1024 * dim + 16, dtype=dt)
    v = flat[offset:offset + n_tiles * 1024 * dim].view(n_tiles * 1024, dim)
    mask = torch.ones(n_tiles * 1024, dtype=torch.bool)
    hot = torch.tensor([3, 1, 2], dtype=torch.int32)
    n_hot = torch.tensor([2], dtype=torch.int32)
    want, = _kind_of(q, v, k)
    piece = tscan.rows_piece(v)
    suffix = tscan._PIECE_KEY[piece]
    key = {"sweep": "ivf_scan_topk_sweep", "narrow": "ivf_scan_topk_narrow",
           "wgmma": "ivf_scan_topk_wgmma" + suffix,
           "wide": "ivf_scan_topk_wide" + suffix}[want]
    before = dict(tscan.LAUNCHES)
    args = tuple(map(_as_cuda, (q, v, mask, hot, n_hot)))
    vals, idx = tivf.ivf_scan_topk(*args, k)
    assert vals.shape == idx.shape == (nq, k)
    (entry, la), = recorded
    assert entry == ENTRIES[want]
    if want in ("wgmma", "wide"):
        assert la[0] == piece and la[1] == tivf._KINDS[dt]
    else:
        assert la[0] == tivf._KINDS[dt]
    assert tscan.LAUNCHES[key] == before[key] + 1
    assert tscan.LAUNCHES["ivf_scan_topk"] == before["ivf_scan_topk"] + 1
    recorded.clear()
    keys = tivf.ivf_segmax_scan(*args, 8)
    assert keys.shape == (nq, 3 * 8 * 8)
    (entry, la), = recorded
    assert entry == "pv_ivf_segmax_wgmma" and la[0] == piece
    assert la[1] == tivf._KINDS[dt]


def test_counters_stay_zero_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    v = torch.nn.functional.normalize(torch.randn(2048, 25, generator=g),
                                      dim=1)
    mask = torch.ones(2048, dtype=torch.bool)
    hot = torch.tensor([1, 0], dtype=torch.int32)
    n_hot = torch.tensor([2], dtype=torch.int32)
    tscan.reset_launch_counts()
    for nq, k in ((1, 14), (64, 68), (16, 204)):
        tivf.ivf_scan_topk(v[:nq], v, mask, hot, n_hot, k)
    tivf.ivf_segmax_scan(v[:32], v, mask, hot, n_hot, 8)
    assert all(tscan.LAUNCHES[name] == 0 for name in tscan.LAUNCHES
               if name.startswith("ivf_"))
