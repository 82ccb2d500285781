"""K3's wide kind (csrc/topk_i8_wide.cu: k_sel past I8_WIDE_K_MIN = 128),
checked on the CPU.

* Both passes emulated in numpy as the kernels run them: pass A is K3's
  tensor-core scan (`Int8R`: the exact int32 sum, converted to float32
  and times the row scale) over `topk_wgmma_partition`'s (query tile,
  segment range) pairs at the wide launcher's query tiles (32 queries a
  CTA at a tile of <= 32, else 64), skipping segments with no live row
  and writing float_order(score) of every row below cap of the others to
  the slab; pass B is the radix select of K4's wide kind
  (tests/test_torch_topk_wide.py::pass_b: the digit histograms beside the
  mask, the collection, the sort, the ties past CAP in row order). The
  decoded result equals `scan_topk_plain` bit for bit at k_sel 129 / 160
  / 432 / 544 / 1024 and Q 1 / 17 / 64, with duplicated rows (ties to
  the lower row), scales 0 and < 0, a masked slice, a cap off a multiple
  of 128, all rows masked, and more rows sharing the best score than the
  candidates' CAP holds.
* `i8_wide_ready` at its edges (k 128 / 129 / 384 / 385 / 1024 / 1025:
  I8_WIDE_K_MIN = 128, phase 4's crossover; any width and base, the slab
  budget, and at 128 < k <= 384 the query tile that
  `i8_wide_covers` asks for), and K3's dispatch recorded by a stand-in
  for `scan._launch` on CPU tensors posing as CUDA ones against
  `_build._SIGNATURES`: the wide kind first, then the sweep, the
  tensor-core scan and the template, also where a smaller slab budget
  cuts the wide kind's query tile or refuses it; on the CPU the counters
  stay 0.
* The port's K3 route at k_sel 432 (its plain version on the CPU, which
  the CUDA tests hold the kernel to) against the JAX package's
  `fused_topk_i8` in interpret mode: bit for bit where JAX serves k_sel
  past its block with its dense fallback (a cap whose block is 256 rows),
  and through its Pallas ladder (a block of 512 rows) equal after the
  ladder's key truncation, the ids equal where the k-th / (k + 1)-th gap
  exceeds twice it.
* Both packages' engines (`use_pallas=True`) on a host-uploaded int8
  store at `top_k=300`: route `i8stor_fused_exact`, the same ids, and the
  port's K3 launch shape (Q, 432).
"""

import types

import numpy as np
import pytest
import torch

from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from test_torch_i4_kernels import _key_truncate
from test_torch_topk_wide import decode, float_order, pass_b
from torch_port_setup import cap_torch_threads

cap_torch_threads()

SEG = tscan.SEG
KS = [129, 160, 432, 544, 1024]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _store(rng, cap, dim, nq):
    """int8 rows and queries; row 1 (query 0's best) copied to rows 5, 130,
    2000 with its scale; scales 0 and < 0 on live rows; ~80 % live, a
    masked slice and three dead segments."""
    v8 = rng.integers(-127, 128, (cap, dim)).astype(np.int8)
    q8 = rng.integers(-127, 128, (nq, dim)).astype(np.int8)
    vs = rng.uniform(1e-3, 1e-2, cap).astype(np.float32)
    v8[1] = np.where(rng.random(dim) < 0.5, 127, -127)
    vs[1] = 0.02
    q8[0] = v8[1]
    copies = [r for r in (1, 5, 130, 2000) if r < cap]
    v8[copies], vs[copies] = v8[1], vs[1]
    vs[600:620] = 0.0
    vs[620:640] = -vs[620:640]
    mask = rng.random(cap) < 0.8
    mask[copies] = True
    mask[600:640] = True
    mask[900:1100] = False
    for s in (3, 9, 17):
        mask[s * SEG:(s + 1) * SEG] = False
    return q8, v8, vs, mask


def _scores(q8, v8, vs):
    """The kernel's scores: float32(int32 sum) * scale, rounded to nearest."""
    s = (q8.astype(np.int64) @ v8.astype(np.int64).T).astype(np.float32)
    return (s * vs[None, :]).astype(np.float32)


# --------------------------------------------------------------------------
# Both passes, emulated
# --------------------------------------------------------------------------


def slab_keys(q8, v8, vs, mask, sms=132):
    """Pass A: the slab (Q, ld) as the launcher's query tiles and the
    scan's CTAs write it (every row below cap of a segment with a live
    row), with the segments written."""
    nq, cap = q8.shape[0], v8.shape[0]
    ld = -(-cap // SEG) * SEG
    segs = ld // SEG
    score = _scores(q8, v8, vs)
    slab = np.zeros((nq, ld), np.uint32)
    written = np.zeros((nq, ld), bool)
    q_tile = tscan.topk_wide_tile(nq, cap)
    for q0 in range(0, nq, q_tile):
        nt = min(q_tile, nq - q0)
        n = 32 if nt <= 32 else 64
        q_tiles, ranges = tscan.topk_wgmma_partition(nt, cap, sms, n)
        for c in range(q_tiles * ranges):
            qt, r = c % q_tiles, c // q_tiles
            qs = np.arange(q0 + qt * n, q0 + min(nt, (qt + 1) * n))
            for s in range(r * segs // ranges, (r + 1) * segs // ranges):
                rows = np.arange(s * SEG, min(cap, (s + 1) * SEG))
                if not mask[rows].any():
                    continue  # no copy, no product
                assert not written[qs[:, None], rows].any()
                slab[qs[:, None], rows] = float_order(score[qs][:, rows])
                written[qs[:, None], rows] = True
    live_seg = np.array([mask[s * SEG:(s + 1) * SEG].any() for s in range(segs)])
    want = np.repeat(live_seg, SEG) & (np.arange(ld) < cap)
    assert (written == want[None, :]).all()
    return slab


def wide_emulated(q8, v8, vs, mask, k, stats=None):
    """Pass A's slab, then pass B a query, decoded as finish_kernel
    writes it."""
    slab = slab_keys(q8, v8, vs, mask)
    cap = v8.shape[0]
    out = [decode(pass_b(slab[i, :cap], mask, k, stats=stats))
           for i in range(q8.shape[0])]
    return (np.stack([o[0] for o in out]),
            np.stack([o[1] for o in out]).astype(np.int32))


def _plain(q8, v8, vs, mask, k):
    vals, idx = tscan.scan_topk_plain(_t(q8), _t(v8), _t(vs), _t(mask), k)
    return vals.numpy(), idx.numpy()


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("nq", [1, 17, 64])
def test_wide_emulation_equals_plain(k, nq):
    rng = np.random.default_rng(nq * 11 + k)
    cap, dim = 3000, 32  # not a multiple of 128
    q8, v8, vs, mask = _store(rng, cap, dim, nq)
    got = wide_emulated(q8, v8, vs, mask, k)
    ref = _plain(q8, v8, vs, mask, k)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    fin = np.isfinite(got[0])
    assert mask[got[1][fin]].all() and (got[1][~fin] == 0).all()
    assert got[1][0, :4].tolist() == [1, 5, 130, 2000]  # ties: lower row


def test_wide_emulation_all_masked_and_ties_past_cap():
    """No live row: every slot -inf / row 0. Then more rows than CAP share
    the best score: the k lowest of them, in row order (the ties path)."""
    rng = np.random.default_rng(3)
    cap, dim, k = tscan.TOPK_WIDE_CAP + 1200, 32, 432
    q8, v8, vs, mask = _store(rng, cap, dim, 2)
    none = np.zeros(cap, bool)
    vals, idx = wide_emulated(q8, v8, vs, none, k)
    assert np.isneginf(vals).all() and not idx.any()
    np.testing.assert_array_equal(vals, _plain(q8, v8, vs, none, k)[0])
    q8[1] = q8[0]
    tied = np.arange(1000, 1000 + tscan.TOPK_WIDE_CAP + 100)
    v8[tied], vs[tied] = v8[1], vs[1]
    mask[tied] = True  # more than CAP of them live
    stats = {}
    got = wide_emulated(q8, v8, vs, mask, k, stats=stats)
    assert stats["ties"], stats
    ref = _plain(q8, v8, vs, mask, k)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    want = sorted({1, 5, 130, *tied.tolist()})[:k]
    assert got[1][0].tolist() == want


# --------------------------------------------------------------------------
# The ready rule and the dispatch
# --------------------------------------------------------------------------


def _operands(dim, nq, offset=0, qoffset=0, rows=512):
    qf = torch.zeros(nq * dim + 16, dtype=torch.int8)
    vf = torch.zeros(rows * dim + 16, dtype=torch.int8)
    return (qf[qoffset:qoffset + nq * dim].view(nq, dim),
            vf[offset:offset + rows * dim].view(rows, dim))


@pytest.mark.parametrize("nq", [1, 4, 5, 64, 2048])
def test_i8_wide_ready_edges(monkeypatch, nq):
    """I8_WIDE_K_MIN < k <= SCAN_KSEL_MAX, any width and base (the rows by
    the producer `rows_piece` names), one query's slab within
    TOPK_WIDE_SLAB_BYTES; any Q; at k <= I8_SWEEP_K_MAX only where the
    query tile holds min(Q, 64) (over rows TMA reads)."""
    q, v = _operands(96, nq)
    for k in (128, 129, 384, 385, 1024, 1025):
        assert tscan.i8_wide_ready(q, v, k) == (
            tscan.I8_WIDE_K_MIN < k <= tscan.SCAN_KSEL_MAX), k
    assert tscan.I8_WIDE_K_MIN == 128  # phase 4's measured crossover
    for dim in (16, 112, 104, 100):
        assert tscan.i8_wide_ready(*_operands(dim, nq), 432), dim
    assert tscan.i8_wide_ready(*_operands(96, nq, offset=8), 432)
    assert tscan.i8_wide_ready(*_operands(96, nq, qoffset=4), 432)
    q, v = _operands(96, nq, rows=300)  # ld 384 rows
    monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", 4 * 384)
    assert tscan.i8_wide_ready(q, v, 432)
    # a tile of one query: k <= 384 only for a single query
    assert tscan.i8_wide_ready(q, v, 384) == (nq == 1)
    assert tscan.i8_wide_ready(q, v, 129) == (nq == 1)
    monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", 4 * 384 - 1)
    assert not tscan.i8_wide_ready(q, v, 432)
    assert not tscan.i8_wide_ready(q, v, 142)


@pytest.mark.parametrize("nq,cap,covers", [
    (1, 1 << 20, True), (64, 1 << 20, True), (128, 1 << 20, True),
    (2048, 1 << 20, True), (17, 2 << 20, True), (32, 2 << 20, True),
    (33, 2 << 20, False), (64, 2 << 20, False), (16, 4 << 20, True),
    (17, 4 << 20, False), (1, 16 << 20, True), (4, 16 << 20, True),
    (5, 16 << 20, False), (64, 16 << 20, False), (1, 64 << 20, True),
    (2, 64 << 20, False)])
def test_i8_wide_covers(nq, cap, covers):
    """The wide kind's query tile over an int8 plane of `cap` rows
    (`topk_wide_tile`, a 256 MiB slab) against min(Q, 64): over 1M rows
    it holds a 64-query tile of any batch; over 16M rows four queries."""
    assert tscan.i8_wide_covers(nq, cap) == covers
    assert covers == (tscan.topk_wide_tile(nq, cap) >= min(nq, 64))


# (Q, k, budget in queries' slabs, kernel) over 4096 rows: the default
# budget (the wide kind past k 128), budgets that cut the wide kind's
# query tile to 4, 32 and 64 queries (the sweep or the scan at k <= 384
# where the tile misses min(Q, 64), the wide kind past k 384 whatever the
# tile), and a budget below one query's slab (the sweep, the scan, then
# the template past k 384)
TILE_DISPATCH = [
    (1, 142, None, "wide"), (64, 384, None, "wide"),
    (1, 142, 4, "wide"), (4, 384, 4, "wide"), (5, 142, 4, "scan"),
    (64, 142, 4, "scan"), (64, 432, 4, "wide"), (17, 142, 32, "wide"),
    (32, 384, 32, "wide"), (64, 142, 32, "scan"), (128, 256, 32, "scan"),
    (2048, 142, 32, "scan"), (128, 142, 64, "wide"), (2048, 384, 64, "wide"),
    (1, 142, 0, "sweep"), (4, 384, 0, "sweep"), (5, 384, 0, "scan"),
    (64, 142, 0, "scan"), (1, 385, 0, "template"), (64, 1024, 0, "template")]


@pytest.mark.parametrize("nq,k,slabs,kernel", TILE_DISPATCH)
def test_k3_dispatch_by_wide_tile(recorded, monkeypatch, nq, k, slabs,
                                  kernel):
    cap, dim = 4096, 96
    if slabs is not None:
        monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES",
                            max(4 * cap * slabs, 4 * cap - 1))
    q, v = _operands(dim, nq, rows=cap)
    vs, mask = torch.ones(cap), torch.ones(cap, dtype=torch.bool)
    before = dict(tscan.LAUNCHES)
    vals, idx = tscan.fused_topk_i8(*map(_as_cuda, (q, v, vs, mask)), k)
    assert vals.shape == idx.shape == (nq, k)
    (entry, args), = recorded
    assert entry == {"sweep": "pv_sweep_topk_i8",
                     "scan": "pv_scan_topk_i8_wgmma",
                     "wide": "pv_scan_topk_i8_wide",
                     "template": "pv_scan_topk"}[kernel]
    if kernel == "wide":  # piece, q, v, vscale, mask, scratch, ...
        q_tile = tscan.topk_wide_tile(nq, cap)
        assert args[0] == tscan.rows_piece(v) == 0
        assert args[8:] == (nq, cap, dim, k, q_tile, _wide_scratch(
            nq, cap, dim, q_tile))
        assert q_tile >= min(nq, 64) or k > tscan.I8_SWEEP_K_MAX
    for key, name in (("sweep", "scan_topk_i8_sweep"),
                      ("scan", "scan_topk_i8_wgmma"),
                      ("wide", "scan_topk_i8_wide")):
        assert tscan.LAUNCHES[name] == before[name] + (kernel == key), name


def _wide_scratch(nq, cap, dim, q_tile):
    """The wide kind's scratch: a tile of the select, then room for the
    queries' rows padded to whole 16 bytes."""
    return (tscan._up256(tscan.i4_wide_scratch(cap, q_tile))
            + nq * -(-dim // 16) * 16)


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


# (Q, dim, k, offset, kernel): the sweep, the tensor-core scan, the wide
# kind, the template
DISPATCH = [(1, 96, 128, 0, "sweep"), (64, 96, 128, 0, "scan"),
            (1, 96, 129, 0, "wide"), (1, 1024, 142, 0, "wide"),
            (64, 1024, 142, 0, "wide"), (4, 96, 384, 0, "wide"),
            (17, 96, 432, 0, "wide"), (64, 1024, 432, 0, "wide"),
            (128, 96, 1024, 0, "wide"),
            # rows TMA cannot read, which the template served before: the
            # wide kind, its rows by cp.async or the realigning producer
            # (their ids name the kernel then)
            pytest.param(64, 104, 432, 0, "wide",
                         id="64-104-432-0-template"),
            pytest.param(64, 96, 142, 8, "wide",
                         id="64-96-142-8-template"),
            pytest.param(1, 100, 1024, 0, "wide",
                         id="1-100-1024-0-template")]


@pytest.mark.parametrize("nq,dim,k,offset,kernel", DISPATCH)
def test_k3_dispatch_with_the_wide_kind(recorded, nq, dim, k, offset, kernel):
    cap = 512
    q, v = _operands(dim, nq, offset=offset, rows=cap)
    vs = torch.ones(cap)
    mask = torch.ones(cap, dtype=torch.bool)
    before = dict(tscan.LAUNCHES)
    vals, idx = tscan.fused_topk_i8(*map(_as_cuda, (q, v, vs, mask)), k)
    assert vals.shape == idx.shape == (nq, k)
    (entry, args), = recorded
    assert entry == {"sweep": "pv_sweep_topk_i8",
                     "scan": "pv_scan_topk_i8_wgmma",
                     "wide": "pv_scan_topk_i8_wide",
                     "template": "pv_scan_topk"}[kernel]
    piece = tscan.rows_piece(v)
    if kernel == "wide":  # piece, q, v, vscale, mask, scratch, ...
        q_tile = tscan.topk_wide_tile(nq, cap)
        assert args[:5] == (piece, q.data_ptr(), v.data_ptr(), vs.data_ptr(),
                            mask.data_ptr())
        assert args[8:] == (nq, cap, dim, k, q_tile, _wide_scratch(
            nq, cap, dim, q_tile))
    assert tscan.LAUNCHES["scan_topk_i8"] == before["scan_topk_i8"] + 1
    for key, name in (("sweep", "scan_topk_i8_sweep"),
                      ("scan", "scan_topk_i8_wgmma"),
                      ("wide", "scan_topk_i8_wide")):
        if key != "sweep":
            name += tscan._PIECE_KEY[piece]
        assert tscan.LAUNCHES[name] == before[name] + (kernel == key), name
    assert tscan.LAUNCH_SHAPES["scan_topk_i8"][nq, k] >= 1


def test_wide_copies_a_misaligned_mask(recorded):
    """A mask view off a 4-byte boundary is copied for the kernel."""
    q, v = _operands(96, 16)
    mask = torch.ones(516, dtype=torch.bool)[1:513]
    tscan.fused_topk_i8(*map(_as_cuda, (q, v, torch.ones(512), mask)), 432)
    (entry, args), = recorded
    assert entry == "pv_scan_topk_i8_wide" and args[4] % 4 == 0
    assert args[4] != mask.data_ptr()


def test_counter_stays_zero_on_the_cpu():
    rng = np.random.default_rng(4)
    q8, v8, vs, mask = _store(rng, 1024, 32, 17)
    tscan.reset_launch_counts()
    for nq in (1, 17):
        got = tscan.fused_topk_i8(_t(q8[:nq]), _t(v8), _t(vs), _t(mask), 432)
        ref = _plain(q8[:nq], v8, vs, mask, 432)
        np.testing.assert_array_equal(got[1].numpy(), ref[1])
    assert tscan.LAUNCHES["scan_topk_i8"] == 0
    assert tscan.LAUNCHES["scan_topk_i8_wide"] == 0


# --------------------------------------------------------------------------
# The port against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [2304, 2048])
@pytest.mark.parametrize("nq", [1, 17])
def test_fused_topk_i8_wide_matches_jax(cap, nq):
    """The port's K3 at k_sel 432 against `fused_topk_i8` in interpret
    mode on one numpy-seeded store whose scores are distinct down to rank
    k + 1. cap 2304: JAX's block is 256 rows, under k, so it serves the
    dense fallback: scores and rows bit for bit. cap 2048: its Pallas
    ladder (512-row blocks): scores equal after the ladder's key
    truncation, rows equal where the k-th / (k + 1)-th gap exceeds twice
    it."""
    rng = np.random.default_rng(700 + nq + cap)
    dim, k = 64, 432
    v8 = rng.integers(-127, 128, (cap, dim)).astype(np.int8)
    q8 = rng.integers(-127, 128, (nq, dim)).astype(np.int8)
    vs = rng.uniform(1e-3, 1e-2, cap).astype(np.float32)
    mask = rng.random(cap) > 0.1
    exact = np.where(mask, _scores(q8, v8, vs), -np.inf)
    srt = -np.sort(-exact, axis=1)
    for i in range(nq):  # distinct scores down to rank k + 1
        assert np.unique(srt[i, :k + 1]).size == k + 1
    jv, ji = map(np.asarray, jps.fused_topk_i8(q8, v8, vs, mask, k,
                                               interpret=True))
    tv, ti = tscan.fused_topk_i8(_t(q8), _t(v8), _t(vs), _t(mask), k)
    tv, ti = tv.numpy(), ti.numpy()
    assert np.isfinite(tv).all() and mask[ti].all()
    np.testing.assert_array_equal(np.take_along_axis(exact, ti.astype(int), 1),
                                  tv)
    bn = jps._pick_bn(dim, min(jps.DEFAULT_QT, nq), k, 1, cap, 4096)
    assert (bn < k) == (cap == 2304)
    if bn < k:  # the dense fallback: the same float32 scores
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti, ji)
    else:  # the ladder: its key truncation, ids outside twice it
        np.testing.assert_array_equal(_key_truncate(tv, bn), jv)
        for i in range(nq):
            if srt[i, k - 1] - srt[i, k] > 2.0 ** -10 * abs(srt[i, k - 1]):
                assert set(ji[i].tolist()) == set(ti[i].tolist()), i


def test_engine_top_k_300_matches_jax():
    """A host-uploaded int8 store asked for top_k = 300 in both packages
    (`use_pallas=True`, so both take their kernel routes on the CPU):
    route i8stor_fused_exact with the host rescore, k_sel 300 + 128 + 4 =
    432 on the port's K3 (its launch shape recorded), the same ids."""
    import picovdb_tpu as jpkg
    import picovdb_tpu_torch as tpkg
    from picovdb_tpu.utils import normalize_batch

    rng = np.random.default_rng(11)
    n, dim = 4096, 64
    corpus = normalize_batch(rng.normal(size=(n, dim)).astype(np.float32))
    ids = [f"r{i}" for i in range(n)]
    qs = corpus[rng.integers(0, n, 3)] + 0.05 * rng.normal(size=(3, dim))
    qs = qs.astype(np.float32)
    got = {}
    for name, pkg, kw in (("jax", jpkg, {}), ("port", tpkg, {"device": "cpu"})):
        db = pkg.PicoVectorDB(embedding_dim=dim, storage_file=None,
                              storage_dtype="int8", use_pallas=True, **kw)
        db.upsert_columnar(corpus, ids=ids)
        if name == "port":
            tscan.reset_launch_counts()
            seen = []
            real = tscan._scan_topk

            def spy(q, v, *a, **kk):
                seen.append((q.shape[0], a[2]))
                return real(q, v, *a, **kk)

            tscan._scan_topk = spy
        try:
            one = db.query(qs[0], top_k=300)
            dbg1 = db.last_query_debug()
            batch, _ = db.query_columnar(qs, top_k=300)
            dbg3 = db.last_query_debug()
        finally:
            if name == "port":
                tscan._scan_topk = real
        for dbg in (dbg1, dbg3):
            assert dbg["strategy"] == "i8stor_fused_exact", dbg
            assert dbg["rescore"] == "host", dbg
        got[name] = ([h["_id_"] for h in one], batch)
        if name == "port":
            assert seen == [(1, 432), (3, 432)], seen
    assert got["jax"][0] == got["port"][0]
    assert (np.asarray(got["jax"][1]) == np.asarray(got["port"][1])).all()
