"""The range walk of K4's and K6's wide kinds (csrc/radix_select.cuh
`walk_ranges`), checked on the CPU.

* The planner (`scan.topk_wide_plan`, `wide_walk`, `wide_ranges`): the
  ranges cover [0, cap) in whole 128-row segments without overlap, keep a
  tile of min(Q, 64) queries' slab within TOPK_WIDE_SLAB_BYTES, and leave
  the walk of one plane unchanged where such a tile fits it; the scratch
  (`wide_walk_scratch`) as the kernel's `walk_bytes` counts it. Caps 1,
  128, the budget's edge, 2^26 +- 128, 70M, 100M and 400M.
* The ready rules past 64M rows (meta tensors): K4 and K6 take their wide
  kinds at every cap; K3 past k 384 and K9 past k 128 keep the template.
  The dispatch recorded on CPU tensors posing as CUDA ones against
  `_build._SIGNATURES` with the budget patched small: the plan's tile and
  rows, and the `_ranges` counters.
* `scan_topk_ranges_plain` (each range's best k as (score, row) keys,
  rows offset, then `_merge_sel_keys`) equals the whole plane's plain
  version: ties straddling a range edge, ranges with no live row, k_sel
  past a range's live rows, scales <= 0; and the kernel's walk emulated in
  numpy (K6's slab keys a range at a time, the radix select, the keys
  offset by the range's first row, the merge) equals both bit for bit.
* K7's ready rule sizes the slab by the hot table it allocates: over
  70M-row postings (meta tensors) a probe-sized hot table takes the wide
  kind and a whole-table one the template.
* The port against the JAX package's `fused_topk` / `fused_topk_i4` in
  interpret mode at k_sel > 128, the budget patched small so a few
  thousand rows split into ranges (the port's CPU path then runs the
  ranged plain version).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import ivf as tivf
from picovdb_tpu_torch.ops import scan as tscan
from test_torch_i4_kernels import _queries, _store
from test_torch_i4_wide import slab_keys
from test_torch_topk_wide import decode, pass_b
from torch_port_setup import cap_torch_threads

cap_torch_threads()

SEG = tscan.SEG
BUDGET = tscan.TOPK_WIDE_SLAB_BYTES
TOL_SCORE = 1e-5  # float32 scores: summation order only
TOL_GAP = 1e-4  # id sets agree where the k-th / (k+1)-th gap exceeds it


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# The planner
# --------------------------------------------------------------------------

CAPS = (1, 128, BUDGET // 4, (1 << 26) - 128, (1 << 26) + 128,
        70_000_000, 100_000_000, 400_000_000)


@pytest.mark.parametrize("cap", CAPS)
def test_ranges_cover_the_cap_in_whole_segments(cap):
    for nq in (1, 4, 16, 63, 64, 65, 200, 2048):
        q_tile, rows, n = tscan.wide_walk(nq, cap)
        assert (q_tile, rows) == tscan.topk_wide_plan(nq, cap)
        bounds = tscan.wide_ranges(cap, rows)
        assert len(bounds) == n == tscan.wide_range_count(cap, rows)
        assert bounds[0][0] == 0 and bounds[-1][1] == cap
        for (a0, a1), (b0, _) in zip(bounds, bounds[1:]):
            assert a1 == b0  # no gap, no overlap
        for r0, r1 in bounds:
            assert r0 % SEG == 0 and 0 < r1 - r0 <= max(rows, cap if n == 1
                                                        else rows)
        full = min(nq, tscan.TOPK_WGMMA_QTILE)
        ld = -(-cap // SEG) * SEG
        if full * 4 * ld <= BUDGET:  # the walk of one plane, unchanged
            assert n == 1 and q_tile == tscan.topk_wide_tile(nq, cap)
        else:
            assert rows % SEG == 0 and n > 1
            # a tile of min(Q, 64) queries over a range fits the budget,
            # and the tile the walk takes holds at least that many
            assert full * 4 * rows <= BUDGET
            assert min(nq, tscan.TOPK_WIDE_QTILE_MAX) >= q_tile >= full
            assert q_tile * 4 * rows <= BUDGET
            # the most whole segments: one more would pass the budget
            assert full * 4 * (rows + SEG) > BUDGET


def test_plan_at_the_stores_of_the_smoke():
    """Q = 1 reads ranges of 64M rows, Q >= 64 ranges of 1M rows in 64-query
    tiles; over 16M rows Q = 16 takes ranges of 4M rows in one tile, not
    four tiles of four queries over the plane."""
    assert tscan.topk_wide_plan(1, 70_000_000) == (1, 1 << 26)
    assert tscan.wide_walk(1, 70_000_000)[2] == 2
    assert tscan.topk_wide_plan(64, 70_000_000) == (64, 1 << 20)
    assert tscan.wide_walk(64, 70_000_000)[2] == 67
    assert tscan.topk_wide_plan(200, 70_000_000) == (64, 1 << 20)
    assert tscan.topk_wide_plan(16, 16 << 20) == (16, 4 << 20)
    assert tscan.topk_wide_tile(16, 16 << 20) == 4
    assert tscan.wide_walk(1, 16 << 20)[2] == 1


@pytest.mark.parametrize("cap,nq,k", [(1000, 100, 300), (70_000_000, 64, 526),
                                      (4096, 1, 1024), (0, 4, 200)])
def test_walk_scratch_as_the_kernel_counts_it(cap, nq, k):
    """One tile over a range's rows (slab, histograms, candidates), then
    past one range the tile's partial of q_tile x ranges x k keys, each
    from a 256-byte boundary (csrc/radix_select.cuh `walk_bytes`)."""
    up = tscan._up256
    for rows in (256, 1 << 20, max(cap, 1)):
        q_tile = tscan.wide_walk(nq, cap, rows)[0]
        n = tscan.wide_range_count(cap, rows)
        ld = -(-cap // SEG) * SEG if n == 1 else rows
        tile = (up(q_tile * ld * 4) + up(q_tile * tscan.TOPK_WIDE_HIST * 4)
                + q_tile * tscan.TOPK_WIDE_CAP * 8)
        want = tile if n == 1 else up(tile) + q_tile * n * k * 8
        assert tscan.wide_walk_scratch(cap, q_tile, rows, k) == want


# --------------------------------------------------------------------------
# The ready rules and the dispatch
# --------------------------------------------------------------------------


def test_ready_rules_past_64m_rows():
    cap = 70_000_000
    for dtype in (torch.float32, torch.bfloat16):
        v = torch.empty((cap, 96), dtype=dtype, device="meta")
        for nq in (1, 64):
            q = torch.zeros(nq, 96)
            assert tscan.topk_wide_ready(q, v, 129)
            assert tscan.topk_wide_ready(q, v, 1024)
            assert not tscan.topk_wide_ready(q, v, 128)
    v4 = torch.empty((cap, 192), dtype=torch.int8, device="meta")
    v8 = torch.empty((cap, 384), dtype=torch.int8, device="meta")
    for nq in (1, 64):
        q8 = torch.zeros(nq, 384, dtype=torch.int8)
        assert tscan.i4_wide_ready(q8, v4, 204)
        assert tscan.i4_wide_ready(q8, v4, 526)
        assert not tscan.i4_wide_ready(q8, v4, 128)
        # K3 and K9 keep their slab limit (the next slice's walk)
        assert not tscan.i8_wide_ready(q8, v8, 432)
        assert not tscan.i8c_wide_ready(q8, v8, 200)


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


CAP = 4096


@pytest.mark.parametrize("kind", ["f32", "bf16", "i4"])
def test_dispatch_walks_ranges_past_the_budget(recorded, monkeypatch, kind):
    """With the budget below a 64-query tile's slab over 4,096 rows the
    wide kinds launch with the plan's tile and ranges, count
    "scan_topk[_i4]_wide" (with the producer's suffix) and the `_ranges`
    key; within it, one range of the whole plane."""
    dim = 100
    mask = torch.ones(CAP, dtype=torch.bool)
    if kind == "i4":
        v = torch.zeros(CAP, dim // 2, dtype=torch.int8)
        args = (torch.zeros(64, dim, dtype=torch.int8), v, torch.ones(CAP),
                mask)
        fn, entry, key = (tscan.fused_topk_i4, "pv_scan_topk_i4_wide",
                          "scan_topk_i4_wide")
        at = 12  # q_tile's place in the arguments
    else:
        dt = torch.float32 if kind == "f32" else torch.bfloat16
        v = torch.zeros(CAP, dim, dtype=dt)
        args = (torch.zeros(64, dim), v, mask)
        fn, entry = tscan.fused_topk, "pv_scan_topk_wide"
        key = "scan_topk_wide"
        at = 12
    key += tscan._PIECE_KEY[tscan.rows_piece(v)]
    rkey = ("scan_topk_i4_wide_ranges" if kind == "i4"
            else "scan_topk_wide_ranges")
    for budget, ranged in ((BUDGET, False), (64 * 4 * 1024, True)):
        monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", budget)
        tscan.reset_launch_counts()
        recorded.clear()
        vals, idx = fn(*map(_as_cuda, args), 526)
        assert vals.shape == idx.shape == (64, 526)
        (got, a), = recorded
        q_tile, rows, n = tscan.wide_walk(64, CAP)
        assert (n > 1) == ranged
        assert got == entry
        assert a[at - 4:at] == (64, CAP, dim, 526)
        assert a[at:at + 2] == (q_tile, rows)
        if ranged:
            assert (q_tile, rows, n) == (64, 1024, 4)
        else:
            assert rows >= CAP
        assert tscan.LAUNCHES[key] == 1
        assert tscan.LAUNCHES[rkey] == int(ranged)
        if ranged:
            assert tscan.LAUNCH_SHAPES[rkey] == {(64, 526): 1}
    assert "pv_scan_topk" not in [e for e, _ in recorded]


def test_counters_stay_zero_on_the_cpu(monkeypatch):
    monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", 4 * 1024)
    tscan.reset_launch_counts()
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.standard_normal((CAP, 32)).astype(np.float32))
    tscan.fused_topk(v[:4], v, torch.ones(CAP, dtype=torch.bool), 200)
    assert tscan.LAUNCHES["scan_topk_wide_ranges"] == 0
    assert tscan.LAUNCHES["scan_topk_i4_wide_ranges"] == 0


# --------------------------------------------------------------------------
# The ranged plain version against the whole plane's
# --------------------------------------------------------------------------


def _i4_case(case, rng, cap=3000, dim=64):
    """An int4 store with the case's feature placed around range edges of
    256 rows: (q8, v4, vs, mask)."""
    tied = (250, 251, 252, 256, 257, 300, 511, 512, 513)
    dup = [(250, r) for r in tied[1:]] if case == "ties" else ()
    v, v4, vs, mask = (np.array(a) for a in _store(rng, cap, dim, dup=dup))
    q8 = np.array(_queries(rng, v, 5))
    if case == "ties":  # equal rows across the edges at 256 and 512, every
        # query's best (queries at the tied row)
        mask[list(tied)] = True
        q8[:] = np.asarray(jps.quantize_rows_i8(jnp.asarray(
            normalize_batch(v[250:251].repeat(5, 0))))[0])
    elif case == "dead_ranges":  # ranges 1 and 3 hold no live row
        mask[256:512] = False
        mask[768:1024] = False
    elif case == "sparse":  # a range's live rows fewer than k
        mask[:] = False
        mask[rng.choice(cap, 150, replace=False)] = True
        mask[256:300] = True
    elif case == "nonpositive":  # scales <= 0 on a band across an edge
        vs = vs.copy()
        vs[200:320] = 0.0
        vs[320:400] = -vs[320:400]
    return q8, v4, vs, mask


@pytest.mark.parametrize("case", ["ties", "dead_ranges", "sparse",
                                  "nonpositive"])
@pytest.mark.parametrize("k", [129, 526])
def test_ranged_plain_equals_the_whole_plane_int4(case, k):
    rng = np.random.default_rng(sum(map(ord, case)) + k)
    q8, v4, vs, mask = _i4_case(case, rng)
    args = (_t(q8), _t(v4), _t(vs), _t(mask), k)
    whole = tscan.scan_topk_plain(*args, int4=True)
    for rows in (256, 512, 1024, 2944):
        got = tscan.scan_topk_ranges_plain(*args, rows, int4=True)
        assert torch.equal(got[0], whole[0]) and torch.equal(got[1], whole[1])
    if case == "ties":  # the tie in row order across the edges
        assert (whole[1][:, :9] == _t(np.array(
            [250, 251, 252, 256, 257, 300, 511, 512, 513], np.int32))).all()


def _oracle(q, v, mask, k):
    """float64 top-k with the kernels' tie rule (equal scores: lower row)."""
    sc = q.astype(np.float64) @ v.astype(np.float64).T
    sc = np.where(mask[None, :], sc, -np.inf)
    order = np.lexsort((np.broadcast_to(np.arange(v.shape[0]), sc.shape),
                        -sc), axis=1)
    return np.take_along_axis(sc, order, 1)[:, :k], order[:, :k]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["ties", "dead_ranges", "sparse"])
def test_ranged_plain_equals_the_whole_plane_float(dtype, case):
    """Over float32 / bf16 rows: the scores equal the whole plane's, the
    ids equal them outside the k / k+1 gap, and tied rows straddling a
    range edge go to the lower row (the kernels' rule)."""
    rng = np.random.default_rng(7 + len(case))
    cap, dim, k = 3000, 48, 200
    v = normalize_batch(rng.standard_normal((cap, dim)).astype(np.float32))
    mask = rng.random(cap) > 0.1
    q = normalize_batch(v[rng.integers(0, cap, 6)] + 0.2 * rng.standard_normal(
        (6, dim)).astype(np.float32))
    if case == "ties":
        v[240:272] = v[0]
        mask[240:272] = True
        mask[0] = False  # the source row would tie too
        q[:] = v[0]
    elif case == "dead_ranges":
        mask[256:768] = False
    else:
        mask[:] = False
        mask[rng.choice(cap, 120, replace=False)] = True
    vt = _t(v).to(dtype)
    args = (_t(q), vt, _t(mask), k)
    wv, wi = tscan.scan_topk_plain(args[0], vt, None, args[2], k)
    ov, oi = _oracle(q, vt.float().numpy(), mask, k + 1)
    for rows in (256, 1024):
        gv, gi = tscan.scan_topk_ranges_plain(args[0], vt, None, args[2], k,
                                              rows)
        assert torch.equal(gv, wv)
        fin = np.isfinite(gv.numpy())
        for i in range(q.shape[0]):
            n = int(fin[i].sum())
            assert set(gi[i, :n].tolist()) == set(wi[i, :n].tolist()) or (
                ov[i, k - 1] - ov[i, k] <= TOL_GAP)
        if case == "ties":  # 32 equal best rows: 240 .. 271 in row order
            assert (gi[:, :32] == _t(np.arange(240, 272,
                                               dtype=np.int32))).all()
            assert (gi[:, :32].numpy() == oi[:, :32]).all()


# --------------------------------------------------------------------------
# The kernel's walk, emulated (K6)
# --------------------------------------------------------------------------


def walk_emulated(q8, v4, vs, mask, k, rows):
    """csrc/radix_select.cuh `walk_ranges` over K6's rows: per range the
    slab keys of the range's rows (pass A on the views at the range's
    first row), pass B's best k as row keys of the range's rows, the
    range's first row added (the finish's `dec.row0`), then
    launch_topk_merge's k best keys of the partial, decoded."""
    cap = v4.shape[0]
    parts = []
    for r0, r1 in tscan.wide_ranges(cap, rows):
        slab = slab_keys(q8, v4[r0:r1], vs[r0:r1])
        keys = np.stack([pass_b(slab[i], mask[r0:r1], k)
                         for i in range(len(q8))])
        parts.append(np.where(keys > 0, keys - np.uint64(r0), keys))
    part = np.concatenate(parts, axis=1)
    top = np.sort(part, axis=1)[:, ::-1][:, :k]
    return decode(top)


@pytest.mark.parametrize("case", ["ties", "dead_ranges", "sparse",
                                  "nonpositive"])
@pytest.mark.parametrize("nq,k", [(1, 1024), (17, 526), (64, 129)])
def test_walk_emulated_equals_the_plain_versions(case, nq, k):
    rng = np.random.default_rng(40 + nq + len(case))
    q8, v4, vs, mask = _i4_case(case, rng, cap=1500, dim=128)
    q8 = np.resize(q8, (nq, q8.shape[1]))
    args = (_t(q8), _t(v4), _t(vs), _t(mask), k)
    ref = tscan.scan_topk_plain(*args, int4=True)
    ranged = tscan.scan_topk_ranges_plain(*args, 512, int4=True)
    ev, ei = walk_emulated(q8, v4, vs, mask, k, 512)
    np.testing.assert_array_equal(ev, ref[0].numpy())
    np.testing.assert_array_equal(ei, ref[1].numpy())
    assert torch.equal(ranged[0], ref[0]) and torch.equal(ranged[1], ref[1])


# --------------------------------------------------------------------------
# K7's ready rule: the hot table's slab
# --------------------------------------------------------------------------


def test_ivf_wide_ready_sizes_the_hot_table(recorded):
    """Over 70M-row column-scaled int8 postings (meta tensors, nothing
    allocated) a probe's hot table (g_tiles(1, 16) tiles at the store's
    nlist) takes the wide kind at k_sel 138 / 522, and a table of every
    tile (a slab past the budget) the template; without a hot table the
    rule sizes the largest, the postings' cap."""
    bn = tivf.IVF_BN
    n_tiles = 70_000_000 // bn
    cap = n_tiles * bn
    ns = types.SimpleNamespace(nlist=tivf.default_nlist(cap), n_tiles=n_tiles)
    grid_b = tivf.IVFIndex.g_tiles(ns, 1, 16)
    assert 0 < grid_b * bn * 4 <= BUDGET < cap * 4
    post = torch.empty((cap, 100), dtype=torch.int8, device="meta")
    mask = torch.empty((cap,), dtype=torch.bool, device="meta")
    n_hot = torch.tensor([grid_b], dtype=torch.int32)
    for nq in (1, 64):
        q = torch.zeros(nq, 100, dtype=torch.int8)
        for k in (138, 522):
            for tiles, want in ((grid_b, "pv_ivf_scan_topk_wide"),
                                (n_tiles, "pv_ivf_scan_topk")):
                hot = torch.arange(tiles, dtype=torch.int32)
                assert tivf.ivf_wide_ready(q, post, k, hot, bn) == (
                    tiles == grid_b)
                recorded.clear()
                tivf.ivf_scan_topk(*map(_as_cuda, (q, post, mask, hot, n_hot)),
                                   k, bn)
                assert recorded[0][0] == want, (nq, k, tiles)
        assert not tivf.ivf_wide_ready(q, post, 522)


# --------------------------------------------------------------------------
# The port against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k", [200, 1000])
def test_fused_topk_ranges_match_jax(monkeypatch, k):
    """K4 at k_sel 200 / 1000 over 2,048 x 64 rows, 10 % masked, with the
    budget holding 8 queries' slab over 512 rows: the port's plain version
    walks 4 ranges. Scores within TOL_SCORE of JAX's (its packed picks
    rescored at k <= 512), ids equal outside the k / k+1 gap."""
    monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", 8 * 4 * 512)
    rng = np.random.default_rng(k + 1)
    v = normalize_batch(rng.standard_normal((2048, 64)).astype(np.float32))
    q = normalize_batch(rng.standard_normal((8, 64)).astype(np.float32))
    mask = rng.random(2048) >= 0.1
    assert tscan.wide_walk(8, 2048) == (8, 512, 4)
    jv, ji = map(np.asarray, jps.fused_topk(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(mask), k,
        interpret=True))
    if k <= 512:  # the Pallas kernel's packed scores: rescore its picks
        jv, ji = map(np.asarray, jps.rescore_exact(q, v, jv, ji))
    tv, ti = tscan.fused_topk(_t(q), _t(v), _t(mask), k)
    tv, ti = tv.numpy(), ti.numpy()
    assert np.array_equal(np.isfinite(tv), np.isfinite(jv))
    fin = np.isfinite(tv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=TOL_SCORE)
    exact = np.sort(q.astype(np.float64) @ v[mask].T.astype(np.float64),
                    axis=1)[:, ::-1]
    for i in range(q.shape[0]):
        assert mask[ti[i][fin[i]]].all()
        if k < exact.shape[1] and exact[i, k - 1] - exact[i, k] <= TOL_GAP:
            continue
        assert set(ti[i][fin[i]].tolist()) == set(ji[i][fin[i]].tolist()), i


@pytest.mark.parametrize("nq", [1, 17])
def test_fused_topk_i4_ranges_match_jax(monkeypatch, nq):
    """K6 at k_sel 526 over 2,048 x 128 int4 rows, the budget holding
    min(Q, 64) queries' slab over 768 rows: the port's plain version walks
    3 ranges. Its scores are the exact scaled int4 scores of its rows, and
    where JAX serves k past its block from its dense fallback the scores and
    ids equal JAX's bit for bit."""
    monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", nq * 4 * 768)
    rng = np.random.default_rng(900 + nq)
    cap, dim, k = 2048, 128, 526
    v, v4, vs, mask = _store(rng, cap, dim)
    q8 = _queries(rng, v, nq)
    assert tscan.wide_walk(nq, cap)[1:] == (768, 3)
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
    np.testing.assert_array_equal(tv, srt[:, :k].astype(np.float32))
    bn = jps._pick_bn(dim, min(jps.DEFAULT_QT, nq), k, 1, cap, 4096)
    assert k > bn  # JAX's dense fallback: the same float32 scores
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)
