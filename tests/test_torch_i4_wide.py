"""K6's wide kind (csrc/topk_i4_wide.cu: 128 < k <= 1024), checked on the
CPU.

* Both passes emulated in numpy as the kernels run them: pass A is K6's
  tensor-core scan (the permuted queries against the packed rows expanded
  into [low | high] nibble stages, exact int32 sums) writing each row's
  sortable score key float_order(float32(sum - 8 sum(q)) * vscale[row])
  to the slab; pass B is the radix select of K4's wide kind
  (tests/test_torch_topk_wide.py::pass_b: the digit histograms beside the
  mask, the collection, the sort, the ties past CAP in row order). The
  decoded result equals `scan_topk_plain(..., int4=True)` bit for bit at
  k 129 / 526 / 1024 and Q 1 / 17 / 64 / 128, with duplicated rows (ties
  to the lower row), a masked slice, a cap that is not a multiple of 256,
  all rows masked, and more rows sharing the best score than the
  candidates' CAP holds.
* `i4_wide_ready` at its edges, and K6's dispatch recorded by a stand-in
  for `scan._launch` on CPU tensors posing as CUDA ones against
  `_build._SIGNATURES`: the sweep, the tensor-core scan, the wide kind at
  every even width and base (the rows' producer first); its scratch and
  query tile; k past SCAN_KSEL_MAX on the plain dense scan. On the CPU the
  new counter stays 0.
* The port (its plain version on the CPU, which the CUDA tests hold the
  kernel to) against the JAX package's `fused_topk_i4` in interpret mode
  at k_sel 526 and Q 1 / 17 on a small store whose scores are distinct
  down to rank k + 1: JAX
  serves k > its block with a dense fallback (ROADMAP fault 3), so the
  results are compared, not the paths.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from test_torch_i4_kernels import _expand_stages, _key_truncate, _queries
from test_torch_i4_kernels import _scale, _store
from test_torch_topk_wide import decode, float_order, pass_b
from torch_port_setup import cap_torch_threads

cap_torch_threads()

SEG = tscan.SEG


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# Both passes, emulated
# --------------------------------------------------------------------------


def slab_keys(q8, v4, vs, sms=132):
    """Pass A: every (query, row) score key as the scan's slab epilogue
    writes it, over i4_wgmma_partition's (query tile, corpus range)
    pairs."""
    q_perm = tscan.permute_i4_queries(_t(q8)).numpy().astype(np.int64)
    b = _expand_stages(v4).astype(np.int64)
    cap = v4.shape[0]
    q_tiles, ranges = tscan.i4_wgmma_partition(len(q8), cap, sms)
    tiles = -(-cap // tscan.I4_WGMMA_BN)
    ld = -(-cap // SEG) * SEG
    slab = np.zeros((len(q8), ld), np.uint32)
    written = np.zeros((len(q8), ld), bool)
    for r in range(ranges):
        rows = np.arange(r * tiles // ranges * tscan.I4_WGMMA_BN,
                         min(cap, (r + 1) * tiles // ranges * tscan.I4_WGMMA_BN))
        for t in range(q_tiles):
            qs = slice(t * tscan.I4_WGMMA_BM, (t + 1) * tscan.I4_WGMMA_BM)
            sums = q_perm[qs] @ b[rows].T
            slab[qs, rows] = float_order(_scale(sums, q8[qs], vs, rows))
            written[qs, rows] = True
    assert written[:, :cap].all() and not written[:, cap:].any()
    return slab


def wide_emulated(q8, v4, vs, mask, k):
    """Pass A's slab, then pass B a query, decoded as finish_kernel
    writes it."""
    slab = slab_keys(q8, v4, vs)
    cap = v4.shape[0]
    out = [decode(pass_b(slab[i, :cap], mask, k)) for i in range(len(q8))]
    return (np.stack([o[0] for o in out]),
            np.stack([o[1] for o in out]).astype(np.int32))


def _plain(q8, v4, vs, mask, k):
    vals, idx = tscan.scan_topk_plain(_t(q8), _t(v4), _t(vs), _t(mask), k,
                                      int4=True)
    return vals.numpy(), idx.numpy()


@pytest.mark.parametrize("k", [129, 526, 1024])
@pytest.mark.parametrize("nq", [1, 17, 64, 128])
def test_wide_emulation_equals_plain(k, nq):
    rng = np.random.default_rng(nq * 7 + k)
    cap, dim = 3000, 128  # not a multiple of 256
    dup = [(5, 2990), (17, 1000), (1000, 1001)]
    v, v4, vs, mask = _store(rng, cap, dim, dup=dup, masked=slice(600, 900))
    q8 = _queries(rng, v, nq)
    got = wide_emulated(q8, v4, vs, mask, k)
    ref = _plain(q8, v4, vs, mask, k)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    assert mask[got[1][np.isfinite(got[0])]].all()


def test_wide_emulation_all_masked_and_ties_past_cap():
    """No live row: every slot -inf / row 0. Then more rows than CAP share
    the best score: the k lowest of them, in row order (the ties path)."""
    rng = np.random.default_rng(3)
    cap, dim, k = tscan.TOPK_WIDE_CAP + 1200, 128, 526
    v, v4, vs, mask = _store(rng, cap, dim)
    q8, v4, vs = (np.array(a) for a in (_queries(rng, v, 2), v4, vs))
    none = np.zeros(cap, bool)
    vals, idx = wide_emulated(q8, v4, vs, none, k)
    assert np.isneginf(vals).all() and not idx.any()
    np.testing.assert_array_equal(vals, _plain(q8, v4, vs, none, k)[0])
    q8[1] = q8[0]
    best = int(_plain(q8[:1], v4, vs, mask, 1)[1][0, 0])
    tied = np.arange(1000, 1000 + tscan.TOPK_WIDE_CAP + 100)
    v4[tied] = v4[best]
    vs[tied] = vs[best]
    mask[tied] = True  # more than CAP of them live
    stats = {}
    slab = slab_keys(q8, v4, vs)
    pass_b(slab[0, :cap], mask, k, stats=stats)
    assert stats["ties"], stats
    got = wide_emulated(q8, v4, vs, mask, k)
    ref = _plain(q8, v4, vs, mask, k)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    want = sorted({*tied[mask[tied]].tolist(), best})[:k]
    assert got[1][0].tolist() == want


# --------------------------------------------------------------------------
# The ready rule and the dispatch
# --------------------------------------------------------------------------


def _operands(nq, dim, offset=0, rows=256):
    q = torch.zeros(nq, dim, dtype=torch.int8)
    flat = torch.zeros(rows * (dim // 2) + 16, dtype=torch.int8)
    return q, flat[offset:offset + rows * (dim // 2)].view(rows, dim // 2)


def test_i4_wide_ready_edges(monkeypatch):
    """128 < k <= SCAN_KSEL_MAX at any even width, base and cap (a slab
    past TOPK_WIDE_SLAB_BYTES walks the rows in ranges); any Q."""
    for nq in (1, 4, 5, 64, 2048):
        q, v = _operands(nq, 1024)
        assert not tscan.i4_wide_ready(q, v, 128)
        assert tscan.i4_wide_ready(q, v, 129)
        assert tscan.i4_wide_ready(q, v, 1024)
        assert not tscan.i4_wide_ready(q, v, 1025)
    for dim in (128, 256, 64, 192, 96, 100, 2):
        assert tscan.i4_wide_ready(*_operands(8, dim), 526), dim
    assert tscan.i4_wide_ready(*_operands(8, 1024, offset=8), 526)
    assert tscan.i4_wide_ready(*_operands(8, 100, offset=2), 526)
    qq = torch.zeros(8 * 1024 + 16, dtype=torch.int8)[4:4 + 8 * 1024]
    assert tscan.i4_wide_ready(qq.view(8, 1024), _operands(8, 1024)[1], 526)
    q, v = _operands(8, 1024, rows=300)  # ld 384 rows
    monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", 4 * 384)
    assert tscan.i4_wide_ready(q, v, 526)
    assert tscan.wide_walk(1, 300)[2] == 1
    monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", 4 * 384 - 1)
    assert tscan.i4_wide_ready(q, v, 526)
    assert tscan.wide_walk(1, 300)[2] > 1


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
# kind (at every even width and base: the template keeps none of these)
DISPATCH = [(1, 1024, 14, 0, "sweep"), (64, 1024, 128, 0, "wgmma"),
            (1, 1024, 129, 0, "wide"), (1, 1024, 526, 0, "wide"),
            (64, 1024, 526, 0, "wide"), (128, 1024, 526, 0, "wide"),
            (2048, 256, 1024, 0, "wide"), (64, 64, 526, 0, "wide"),
            (64, 1024, 526, 8, "wide"), (4, 192, 526, 0, "wide")]


@pytest.mark.parametrize("nq,dim,k,offset,kernel", DISPATCH)
def test_k6_dispatch_with_the_wide_kind(recorded, nq, dim, k, offset, kernel):
    q, v = _operands(nq, dim, offset=offset)
    vs = torch.ones(256)
    mask = torch.ones(256, dtype=torch.bool)
    before = dict(tscan.LAUNCHES)
    vals, idx = tscan.fused_topk_i4(*map(_as_cuda, (q, v, vs, mask)), k)
    assert vals.shape == idx.shape == (nq, k)
    (entry, args), = recorded
    assert entry == {"sweep": "pv_sweep_topk_i4",
                     "wgmma": "pv_scan_topk_i4_wgmma",
                     "wide": "pv_scan_topk_i4_wide"}[kernel]
    piece = tscan.rows_piece(v)
    if kernel == "wide":
        q_tile = tscan.topk_wide_tile(nq, 256)
        # the rows' producer, the permuted queries; one range, the plane
        assert args[0] == piece and args[1] != q.data_ptr()
        assert args[2:5] == (v.data_ptr(), vs.data_ptr(), mask.data_ptr())
        assert args[8:] == (nq, 256, dim, k, q_tile, 256,
                            tscan.i4_wide_scratch(256, q_tile))
    assert tscan.LAUNCHES["scan_topk_i4"] == before["scan_topk_i4"] + 1
    for key in ("sweep", "wgmma", "wide"):
        name = f"scan_topk_i4_{key}"
        if key != "sweep":
            name += tscan._PIECE_KEY[piece]
        assert tscan.LAUNCHES[name] == before[name] + (kernel == key), name


def test_wide_copies_a_misaligned_mask_and_k_past_the_bound(recorded):
    """A mask view off a 4-byte boundary is copied for the kernel; k past
    SCAN_KSEL_MAX takes the plain dense scan (counted in WIDE_K_FALLBACKS),
    no launch."""
    q, v = _operands(16, 1024)
    vs = torch.ones(256)
    mask = torch.ones(260, dtype=torch.bool)[1:257]
    tscan.fused_topk_i4(*map(_as_cuda, (q, v, vs, mask)), 526)
    (entry, args), = recorded
    assert entry == "pv_scan_topk_i4_wide" and args[4] % 4 == 0
    assert args[4] != mask.data_ptr()
    before = tscan.WIDE_K_FALLBACKS["scan_topk_i4"]
    vals, _ = tscan.fused_topk_i4(q, v, vs, mask, 1025)
    assert vals.shape[0] == 16 and len(recorded) == 1
    assert tscan.WIDE_K_FALLBACKS["scan_topk_i4"] == before + 1


@pytest.mark.parametrize("nq,cap", [(1, 131_072), (128, 131_072),
                                    (2048, 524_288), (64, 2_000_000)])
def test_scratch_is_one_tile_of_the_select(nq, cap):
    """The scratch holds one query tile's slab, histograms and candidates
    (csrc/topk_i4_wide.cu's layout), the slab within its budget."""
    t = tscan.topk_wide_tile(nq, cap)
    ld = -(-cap // SEG) * SEG
    assert t * ld * 4 <= tscan.TOPK_WIDE_SLAB_BYTES or t == 1
    up = lambda b: -(-b // 256) * 256  # noqa: E731
    assert tscan.i4_wide_scratch(cap, t) == (
        up(t * ld * 4) + up(t * tscan.TOPK_WIDE_HIST * 4)
        + t * tscan.TOPK_WIDE_CAP * 8)


def test_counter_stays_zero_on_the_cpu():
    rng = np.random.default_rng(4)
    v, v4, vs, mask = _store(rng, 512, 128)
    tscan.reset_launch_counts()
    for nq in (1, 17):
        tscan.fused_topk_i4(_t(_queries(rng, v, nq)), _t(v4), _t(vs),
                            _t(mask), 526)
    assert tscan.LAUNCHES["scan_topk_i4"] == 0
    assert tscan.LAUNCHES["scan_topk_i4_wide"] == 0


# --------------------------------------------------------------------------
# The port against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("nq", [1, 17])
def test_fused_topk_i4_wide_matches_jax(nq):
    """The port's K6 at k_sel 526 (on the CPU its plain version) against
    `fused_topk_i4` in interpret mode on a store whose scores are
    distinct down to rank k + 1: the
    port's scores are the exact scaled int4 scores of its rows, equal to
    JAX's (bit for bit from its dense fallback, after its key truncation
    from its ladder), and the id lists are equal."""
    rng = np.random.default_rng(500 + nq)
    cap, dim, k = 2048, 128, 526
    v, v4, vs, mask = _store(rng, cap, dim)
    q8 = _queries(rng, v, nq)
    exact = tscan._i4_scores(_t(q8), _t(v4), _t(vs)).numpy()
    full = np.where(mask, exact, -np.inf)
    srt = -np.sort(-full, axis=1)
    for i in range(nq):  # distinct scores down to rank k + 1
        assert np.unique(srt[i, :k + 1]).size == k + 1
    jv, ji = map(np.asarray, jps.fused_topk_i4(q8, v4, vs, mask, k,
                                               interpret=True))
    tv, ti = tscan.fused_topk_i4(_t(q8), _t(v4), _t(vs), _t(mask), k)
    tv, ti = tv.numpy(), ti.numpy()
    assert np.isfinite(tv).all() and mask[ti].all()
    np.testing.assert_array_equal(np.take_along_axis(exact, ti.astype(int), 1),
                                  tv)
    bn = jps._pick_bn(dim, min(jps.DEFAULT_QT, nq), k, 1, cap, 4096)
    if k > bn:  # the dense fallback: the same float32 scores
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti, ji)
    else:  # the ladder: its key truncation, ids outside twice it
        np.testing.assert_allclose(_key_truncate(tv, bn), jv, rtol=0,
                                   atol=1e-6)
        for i in range(nq):
            if srt[i, k - 1] - srt[i, k] > 2.0 ** -10 * abs(srt[i, k - 1]):
                assert set(ji[i].tolist()) == set(ti[i].tolist()), i
