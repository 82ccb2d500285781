"""picovdb_tpu_torch's IVF tier ops against picovdb_tpu on the CPU.

The same seeded numpy inputs go through the JAX function (its Pallas
kernels in interpret mode) and the port's counterpart (the plain versions
of K7 / K8 on CPU tensors); a JAX-built layout is handed to the port with
`IVFIndex.from_numpy_state`, so both probe one layout. Tolerances, each
with its reason:

  * column quantization, the probe preamble (row mask, hot list, n_hot)
    and the layout built from warm centroids with zero k-means iterations
    are identical: integer arithmetic, 0/1 sums, or the same float32
    operations in the same order;
  * rescored scores agree within TOL_SCORE = 1e-5: float32 dot products
    of the same rows, summed in different orders;
  * id sets agree wherever the float64 k-th/(k+1)-th gap over the rows
    the route ranks exceeds TOL_GAP = 1e-4. The TPU ladder selects on
    packed keys (low 10 bits of the score replaced by the lane), the port
    on exact scores, and both rescore the same guard band exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picovdb_tpu.ops import ivf as jivf
from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import ivf as tivf
from picovdb_tpu_torch.ops import scan as tscan

TOL_SCORE = 1e-5
TOL_GAP = 1e-4
DIM = 32


def _t(a):
    return torch.from_numpy(np.array(a))


def clustered(rng, n, dim=DIM, n_clusters=24, noise=0.35):
    """Unit-norm gaussian mixture (picovdb_tpu's IVF calibration shape:
    noise-vector norm 0.35 beside unit centres)."""
    centres = normalize_batch(rng.normal(size=(n_clusters, dim)).astype(np.float32))
    lab = rng.integers(0, n_clusters, n)
    pts = centres[lab] + noise / np.sqrt(dim) * rng.normal(size=(n, dim))
    return normalize_batch(pts.astype(np.float32))


def state_of(j):
    """A JAX IVFIndex's arrays and bookkeeping, as numpy."""
    opt = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return dict(
        centroids=np.asarray(j.centroids), vectors=opt(j.vectors),
        slots=np.asarray(j.slots), row_cluster=np.asarray(j.row_cluster),
        active=np.asarray(j.active), cluster2tile=np.asarray(j.cluster2tile),
        seg_starts=np.asarray(j.seg_starts), nlist=j.nlist, n_tiles=j.n_tiles,
        dim=j.dim, vectors_i8c=opt(j.vectors_i8c), cscale=opt(j.cscale),
        slot2row=j._slot2row, n_used=j._n_used, n_build=j._n_build,
        host_blob=j._host_blob)


def port_of(j):
    return tivf.IVFIndex.from_numpy_state(**state_of(j), device="cpu")


def _gaps(rows, q, k, live=None):
    """Float64 k-th minus (k+1)-th score per query over the live rows."""
    qn = normalize_batch(q).astype(np.float64)
    s = qn @ rows.astype(np.float64).T
    if live is not None:
        s[:, ~live] = -np.inf
    s = -np.sort(-s, axis=1)
    return s[:, k - 1] - s[:, k]


def assert_same(jv, js, tv, ts, gaps):
    jv, js = np.asarray(jv), np.asarray(js)
    tv, ts = np.asarray(tv), np.asarray(ts)
    assert jv.shape == tv.shape
    np.testing.assert_array_equal(np.isneginf(jv), np.isneginf(tv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=TOL_SCORE)
    for i in range(jv.shape[0]):
        if gaps[i] > TOL_GAP:
            assert set(js[i][fin[i]]) == set(ts[i][fin[i]]), i


# ---------------------------------------------------------------------------
# column quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_column_quantization_bit_identical(seed):
    rng = np.random.default_rng(seed)
    v = (rng.normal(size=(2000, 48)) * rng.uniform(0.01, 3, 48)).astype(np.float32)
    v[:, 5] = 0.0  # an all-zero column stays finite
    jq, js = map(np.asarray, jps.quantize_cols_i8(jnp.asarray(v)))
    tq, ts = tscan.quantize_cols_i8(_t(v))
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tscan.colmax_abs(_t(v)).numpy(),
                                  np.asarray(jps.colmax_abs(jnp.asarray(v))))
    s2 = (np.maximum(np.abs(v).max(0), 1e-30) / 127.0).astype(np.float32)
    np.testing.assert_array_equal(
        tscan.quantize_cols_scaled_i8(_t(v), _t(s2)).numpy(),
        np.asarray(jps.quantize_cols_scaled_i8(jnp.asarray(v), jnp.asarray(s2))))
    q = rng.normal(size=(17, 48)).astype(np.float32)
    np.testing.assert_array_equal(
        tscan.fold_queries_i8(_t(q), _t(js)).numpy(),
        np.asarray(jps.fold_queries_i8(jnp.asarray(q), jnp.asarray(js))))


def test_policy_helpers_match(monkeypatch):
    for n in (1, 100, 10_000, 5_000_000):
        assert tivf.default_nlist(n) == jivf.default_nlist(n)
    for ef, nl in ((2, 100), (32, 100), (10_000, 100), (33, 7)):
        assert tivf.ef_to_nprobe(ef, nl) == jivf.ef_to_nprobe(ef, nl)
    for args in ((2_000_000, None), (1_000_000, 1024, 4.0), (500, 64, 1.0)):
        assert tivf.should_build(*args) == jivf.should_build(*args)
    for env in (None, "auto", "1", "off", "yes", "typo"):
        if env is None:
            monkeypatch.delenv("PICOVDB_IVF_I8", raising=False)
        else:
            monkeypatch.setenv("PICOVDB_IVF_I8", env)
        for dim in (32, 256):
            assert tivf._ivf_i8_enabled(dim) == jivf._ivf_i8_enabled(dim)
            assert tivf._ivf_i8_mirror(dim) == jivf._ivf_i8_mirror(dim)
            assert tivf._ivf_guard(True, dim) == jivf._ivf_guard(True, dim)
    monkeypatch.setenv("PICOVDB_IVF_GUARD", "9")
    assert tivf._ivf_guard(False, 32) == jivf._ivf_guard(False, 32) == 9
    monkeypatch.setenv("PICOVDB_IVF_I8_CLIP_MAX", "bad")
    assert tivf._i8_clip_max() == jivf._i8_clip_max() == 0.05


# ---------------------------------------------------------------------------
# layout and preamble
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layout():
    """A JAX-built classic layout over 8000 clustered rows (9 tiles), with
    50 rows appended to the overflow region and 20 deactivated."""
    rng = np.random.default_rng(5)
    v = clustered(rng, 8000)
    mask = np.ones(8000, bool)
    mask[::97] = False
    j = jivf.IVFIndex.build(v, mask, nlist=16, dim=DIM)
    extra = clustered(np.random.default_rng(6), 50)
    changed = np.concatenate([np.arange(8000, 8050), np.arange(0, 40, 2)])
    rows = np.concatenate([extra, v[0:40:2]])
    flags = np.concatenate([np.ones(50, bool), np.zeros(20, bool)])
    assert j.update(changed, rows, flags)
    allv = np.concatenate([v, extra])
    live = np.concatenate([mask, np.ones(50, bool)])
    live[0:40:2] = False
    return j, allv, live


@pytest.mark.parametrize("nq,nprobe,g_tiles", [(1, 2, None), (8, 3, None),
                                               (4, 16, 3), (1, 1, 2)])
def test_probe_preamble_identical(layout, nq, nprobe, g_tiles):
    j, v, _ = layout
    t = port_of(j)
    q = normalize_batch(v[7:7 + nq] + 0.01)
    cap = int(j.slots.shape[0])
    kw = dict(nprobe=nprobe, nlist=j.nlist, g_tiles=g_tiles, cap_ivf=cap,
              n_tiles=j.n_tiles, bn=jivf.IVF_BN)
    jr = jivf._probe_preamble(jnp.asarray(q), j.centroids, j.active,
                              j.seg_starts, j.cluster2tile, **kw)
    tr = tivf._probe_preamble(_t(q), t.centroids, t.active, t.seg_starts,
                              t.cluster2tile, **kw)
    np.testing.assert_array_equal(tr[0].numpy(), np.asarray(jr[0]))
    np.testing.assert_array_equal(tr[1].numpy(), np.asarray(jr[1]))
    assert int(tr[2][0]) == int(jr[2]) and tr[3] == jr[3]
    # overflow tiles (the appended rows) sort first and survive truncation
    ov_tile = int(j.seg_starts[j.nlist]) // jivf.IVF_BN
    assert int(tr[1][0]) == ov_tile


def test_build_from_warm_centroids_identical():
    """Zero k-means iterations from the same centroids: the assignment is
    one argmax per row, so both packages lay out the same postings; the
    port's device-mirror build equals its host-fed one."""
    rng = np.random.default_rng(8)
    v = clustered(rng, 5000)
    mask = np.ones(5000, bool)
    mask[rng.choice(5000, 300, replace=False)] = False
    warm = normalize_batch(rng.normal(size=(20, DIM)).astype(np.float32))
    j = jivf.IVFIndex.build(v, mask, nlist=20, dim=DIM, iters=0,
                            warm_centroids=warm)
    t = tivf.IVFIndex.build(v, mask, nlist=20, dim=DIM, iters=0,
                            warm_centroids=warm, device="cpu")
    td = tivf.IVFIndex.build(None, mask, nlist=20, dim=DIM, iters=0,
                             warm_centroids=warm, dev_vectors=_t(v))
    for x in (t, td):
        np.testing.assert_array_equal(x.slots.numpy(), np.asarray(j.slots))
        np.testing.assert_array_equal(x.seg_starts.numpy(),
                                      np.asarray(j.seg_starts))
        np.testing.assert_array_equal(x.cluster2tile.numpy(),
                                      np.asarray(j.cluster2tile))
        np.testing.assert_array_equal(x.row_cluster.numpy(),
                                      np.asarray(j.row_cluster))
        np.testing.assert_array_equal(x.vectors.numpy(), np.asarray(j.vectors))
        np.testing.assert_array_equal(x._slot2row, j._slot2row)
        assert x.n_tiles == j.n_tiles and x.nlist == j.nlist


def test_kmeans_build_recall():
    """A trained (not warm) build: the port's k-means clusters the mixture
    and a full probe finds the exact top-10."""
    rng = np.random.default_rng(9)
    v = clustered(rng, 4000)
    t = tivf.IVFIndex.build(v, np.ones(4000, bool), nlist=24, dim=DIM,
                            device="cpu")
    q = normalize_batch(v[:16] + 0.01 * rng.normal(size=(16, DIM)))
    vals, slots = t.search(q.astype(np.float32), 10, ef=48, dev=None)
    exact = np.argsort(-(q @ v.T), axis=1)[:, :10]
    assert np.mean([len(set(slots[i]) & set(exact[i])) / 10
                    for i in range(16)]) >= 0.99


# ---------------------------------------------------------------------------
# K7 / K8 plain versions against probe_scan_local / probe_scan_segmax
# ---------------------------------------------------------------------------


def _routes(j, t, q, k, k_sel, nprobe, style, per_seg=8, **extra):
    """(JAX result, port result) of one probed route on one layout."""
    kw = dict(k=k, k_sel=k_sel, nprobe=nprobe, nlist=j.nlist, g_tiles=None)
    jx = extra.pop("jax", {})
    tx = extra.pop("torch", {})
    if style == "segmax":
        jf, tf = jivf.probe_scan_segmax, tivf.probe_scan_segmax
        kw["per_seg"] = per_seg
    else:
        jf, tf = jivf.probe_scan_local, tivf.probe_scan_local
    cd = jnp.bfloat16 if j.vectors is not None and j.vectors.dtype == jnp.bfloat16 else None
    jr = jf(jnp.asarray(q), j.centroids, jx.get("vectors", j.vectors), j.slots,
            j.seg_starts, j.active, j.cluster2tile, interpret=True,
            compute_dtype=cd, vectors_i8=j.vectors_i8c, cscale=j.cscale,
            **jx.get("kw", {}), **kw)
    tr = tf(_t(q), t.centroids, tx.get("vectors", t.vectors), t.slots,
            t.seg_starts, t.active, t.cluster2tile, vectors_i8=t.vectors_i8c,
            cscale=t.cscale, **tx.get("kw", {}), **kw)
    return jr, tr


@pytest.mark.parametrize("style", ["ladder", "segmax"])
@pytest.mark.parametrize("postings", ["float32", "bfloat16", "int8"])
def test_probe_routes_match_jax(layout, monkeypatch, style, postings):
    j0, v, _ = layout
    if postings == "int8":
        monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # the classic int8 mirror
    st = state_of(j0)
    j = jivf.IVFIndex(
        j0.centroids,
        j0.vectors.astype(jnp.bfloat16) if postings == "bfloat16" else j0.vectors,
        j0.slots, j0.row_cluster, j0.active, j0.cluster2tile, j0.nlist,
        j0.n_tiles, j0.dim, seg_starts=j0.seg_starts)
    st["vectors"] = np.asarray(j.vectors)
    st["vectors_i8c"] = None if j.vectors_i8c is None else np.asarray(j.vectors_i8c)
    st["cscale"] = None if j.cscale is None else np.asarray(j.cscale)
    t = tivf.IVFIndex.from_numpy_state(**st, device="cpu")
    rng = np.random.default_rng(11)
    q = normalize_batch(v[rng.integers(0, len(v), 16)]
                        + 0.02 * rng.normal(size=(16, DIM))).astype(np.float32)
    k = 10
    # int8: the TPU ladder ranks int32 scores with their low 10 bits
    # replaced by the lane (~0.2 % of a score at dim 32), the port ranks
    # them exactly; a band of k + 30 holds the true top-k on both sides
    k_sel = k + (30 if postings == "int8" else 4)
    jr, tr = _routes(j, t, q, k, k_sel, nprobe=16, style=style)
    # nprobe = nlist: every cluster is probed, so the rescore ranks every
    # active postings row (in the postings' dtype)
    rows = np.asarray(j.vectors).astype(np.float32)
    assert_same(*jr, *tr, _gaps(rows, q, k, np.asarray(j.active)))


@pytest.mark.parametrize("style", ["ladder", "segmax"])
@pytest.mark.parametrize("storage", ["int8", "int4"])
def test_slot_rescore_routes_match_jax(monkeypatch, style, storage):
    """The int8-only layout: K7 / K8 over column-scaled int8 postings, the
    rescore gathering the engine's int8 / packed int4 corpus by slot."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    rng = np.random.default_rng(12)
    v = clustered(rng, 6000)
    mask = np.ones(6000, bool)
    j = jivf.IVFIndex.build(v, mask, nlist=16, dim=DIM, i8_only=True)
    t = port_of(j)
    quant = jps.quantize_rows_i4 if storage == "int4" else jps.quantize_rows_i8
    plane, scale = map(np.asarray, quant(jnp.asarray(v)))
    q = normalize_batch(v[:16] + 0.02 * rng.normal(size=(16, DIM))).astype(np.float32)
    k, k_sel = 10, 10 + 128 + 6  # the host rescore's band through IVF
    extra = dict(rescore_by_slot=True, rescore_packed_i4=storage == "int4")
    jr, tr = _routes(
        j, t, q, k, k_sel, nprobe=16, style=style,
        jax=dict(vectors=jnp.asarray(plane),
                 kw=dict(rescore_scale=jnp.asarray(scale), **extra)),
        torch=dict(vectors=_t(plane), kw=dict(rescore_scale=_t(scale), **extra)))
    if storage == "int4":
        rows = np.empty((6000, DIM), np.float32)
        tscan.unpack_i4_np_into(plane, rows)
    else:
        rows = plane.astype(np.float32)
    assert_same(*jr, *tr, _gaps(rows * scale[:, None], q, k))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segmax_depth_4_truncates_clustered_top_k(monkeypatch, seed):
    """Clusters of 768 rows span 6 segments, so picovdb_tpu's search sizes
    the segmax depth max(4, min(8, need)) at 4. A query's top-10 is a
    random subset of its cluster; where more than 4 of its top-14 fall in
    one segment, depth 4 drops them. Every cluster is probed, so a miss
    against the float64 oracle is the depth's alone: picovdb_tpu's route
    misses, the port's route at the same depth misses the same queries,
    and at SEGMAX_DEPTH (8) it misses none."""
    monkeypatch.setenv("PICOVDB_IVF_STYLE", "segmax")
    rng = np.random.default_rng(seed)
    n_clusters, per_cluster, nq, k = 16, 768, 32, 10
    centres = normalize_batch(rng.normal(size=(n_clusters, DIM)).astype(np.float32))
    lab = rng.permutation(np.repeat(np.arange(n_clusters), per_cluster))
    n = len(lab)
    v = normalize_batch((centres[lab] + 0.35 / np.sqrt(DIM)
                         * rng.normal(size=(n, DIM))).astype(np.float32))
    j = jivf.IVFIndex.build(v, np.ones(n, bool), nlist=n_clusters, dim=DIM,
                            iters=0, warm_centroids=centres)
    t = port_of(j)
    q = normalize_batch(v[rng.integers(0, n, nq)]
                        + 0.01 * rng.normal(size=(nq, DIM))).astype(np.float32)
    depths = []
    make = jivf._make_ivf_search

    def record(*args, **kw):
        depths.append(args[8])  # per_seg, by position in search_async's call
        return make(*args, **kw)

    monkeypatch.setattr(jivf, "_make_ivf_search", record)
    _, js = j.search(q, k, 64, None, nprobe=n_clusters)
    assert depths == [4]
    _, ts = t.search(q, k, 64, None, nprobe=n_clusters)
    fn4 = tivf._make_ivf_search(k, n_clusters, n_clusters,
                                t.g_tiles(nq, n_clusters), "segmax",
                                per_seg=4, k_sel=k + 4)
    _, ts4 = fn4(_t(q), t.centroids, t.vectors, t.slots, t.seg_starts,
                 t.active, t.cluster2tile)
    order = np.argsort(-(q.astype(np.float64) @ v.astype(np.float64).T), 1)
    gaps = _gaps(v, q, k)

    def misses(ids):
        ids = np.asarray(ids)
        return [i for i in range(nq)
                if gaps[i] > TOL_GAP and set(ids[i]) != set(order[i, :k])]

    assert misses(js), "depth 4 truncated nothing: the witness is void"
    assert misses(ts4.numpy()) == misses(js)
    assert misses(ts) == []


def _hot_case(kind, seed=3):
    rng = np.random.default_rng(seed)
    bn = tivf.IVF_BN
    v = normalize_batch(rng.normal(size=(6 * bn, DIM)).astype(np.float32))
    q = normalize_batch(rng.normal(size=(3, DIM)).astype(np.float32))
    qt, vt = _t(q), _t(v)
    if kind == "i8c":
        vt, cs = tscan.quantize_cols_i8(vt)
        qt = tscan.fold_queries_i8(qt, cs)
    elif kind == "bf16":
        qt, vt = qt.to(torch.bfloat16), vt.to(torch.bfloat16)
    mask = _t(rng.random(6 * bn) > 0.2)
    hot = torch.tensor([4, 1, 5, 0], dtype=torch.int32)
    return qt, vt, mask, hot


@pytest.mark.parametrize("kind", ["f32", "bf16", "i8c"])
@pytest.mark.parametrize("n_hot", [0, 2, 4])
def test_plain_kernels_read_live_hot_tiles_only(kind, n_hot):
    """K7's plain version equals a dense scan of the live hot tiles' rows
    (dead steps and masked rows never score); K8's keys of dead steps are
    KEY_MIN and its live keys are the tiles' per-segment maxima."""
    q, v, mask, hot = _hot_case(kind)
    nh = torch.tensor([n_hot], dtype=torch.int32)
    bn = tivf.IVF_BN
    rows = torch.cat([torch.arange(t * bn, (t + 1) * bn)
                      for t in hot[:n_hot].tolist()] or [torch.zeros(0, dtype=torch.int64)])
    rows = rows[mask[rows]]
    k = 300
    vals, idx = tivf.ivf_scan_topk(q, v, mask, hot, nh, k)
    if kind == "i8c":
        dense = (q.long() @ v.long().T)[:, rows].double()
    else:
        dense = (q.float() @ v.float().T)[:, rows].double()
    want = torch.sort(dense, dim=1, descending=True).values[:, :k]
    kk = want.shape[1]
    assert bool(torch.isneginf(vals[:, kk:]).all())
    np.testing.assert_allclose(vals[:, :kk].double().numpy(), want.numpy(),
                               rtol=0, atol=1e-6)
    assert set(idx[:, :kk].reshape(-1).tolist()) <= set(rows.tolist())
    keys = tivf.ivf_segmax_scan(q, v, mask, hot, nh, 4)
    ns = bn // tscan.SEG
    assert keys.shape == (3, 4 * 4 * ns)
    assert bool((keys[:, n_hot * 4 * ns:] == tscan.KEY_MIN).all())
    if n_hot:
        assert bool((keys[:, : n_hot * 4 * ns] != tscan.KEY_MIN).any())


def test_k7_ties_break_to_the_lower_row():
    """Equal int8 scores rank by row, the kernel's 64-bit key order."""
    q = torch.ones((1, 8), dtype=torch.int8)
    v = torch.zeros((tivf.IVF_BN, 8), dtype=torch.int8)
    v[[5, 9, 700, 3]] = 1  # four rows tie at score 8
    mask = torch.ones(tivf.IVF_BN, dtype=torch.bool)
    vals, idx = tivf.ivf_scan_topk(q, v, mask, torch.zeros(1, dtype=torch.int32),
                                   torch.ones(1, dtype=torch.int32), 3)
    assert idx[0].tolist() == [3, 5, 9] and vals[0].tolist() == [8.0] * 3


# ---------------------------------------------------------------------------
# maintenance and persistence
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i8_only", [False, True])
def test_update_matches_jax(monkeypatch, i8_only):
    """Overflow append + deactivate leave both packages' arrays equal;
    a drifted append trips the clip guard in both."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    rng = np.random.default_rng(13)
    v = clustered(rng, 3000)
    j = jivf.IVFIndex.build(v, np.ones(3000, bool), nlist=12, dim=DIM,
                            i8_only=i8_only)
    t = port_of(j)
    new = clustered(np.random.default_rng(14), 40)
    changed = np.concatenate([np.arange(3000, 3040), [3, 17, 3001]])
    rows = np.concatenate([new, v[[3, 17]], new[1:2]])
    flags = np.concatenate([np.ones(40, bool), [True, False, True]])
    assert j.update(changed, rows, flags) and t.update(changed, rows, flags)
    for name in ("slots", "row_cluster", "active", "cluster2tile"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    if i8_only:
        np.testing.assert_array_equal(t.vectors_i8c.numpy(),
                                      np.asarray(j.vectors_i8c))
    else:
        np.testing.assert_array_equal(t.vectors.numpy(), np.asarray(j.vectors))
        np.testing.assert_array_equal(t.vectors_i8c.numpy(),
                                      np.asarray(j.vectors_i8c))
    np.testing.assert_array_equal(t._slot2row, j._slot2row)
    assert t.overflow_fraction == j.overflow_fraction > 0
    assert t.last_update_clip_fraction == j.last_update_clip_fraction
    # 10x the build's dynamic range clips nearly every component
    monkeypatch.setenv("PICOVDB_IVF_I8_CLIP_MAX", "0.05")
    far = 10 * new[:2]
    if i8_only:
        assert not j.update(np.array([3100, 3101]), far, np.ones(2, bool))
        assert not t.update(np.array([3100, 3101]), far, np.ones(2, bool))
    else:  # the classic mirror re-derives itself instead of refusing
        assert j.update(np.array([3100, 3101]), far, np.ones(2, bool))
        assert t.update(np.array([3100, 3101]), far, np.ones(2, bool))
        np.testing.assert_array_equal(t.vectors_i8c.numpy(),
                                      np.asarray(j.vectors_i8c))
    assert t.last_update_clip_fraction == j.last_update_clip_fraction > 0.05


def test_update_refuses_when_overflow_is_full():
    rng = np.random.default_rng(15)
    v = clustered(rng, 2000)
    t = tivf.IVFIndex.build(v, np.ones(2000, bool), nlist=8, dim=DIM,
                            device="cpu")
    room = t.vectors.shape[0] - t._n_used
    many = clustered(rng, room + 1)
    assert not t.update(np.arange(2000, 2001 + room), many,
                        np.ones(room + 1, bool))


def test_blob_round_trip_both_ways():
    rng = np.random.default_rng(16)
    v = clustered(rng, 3000)
    mask = np.ones(3000, bool)
    j = jivf.IVFIndex.build(v, mask, nlist=12, dim=DIM)
    t = tivf.IVFIndex.build(v, mask, nlist=12, dim=DIM, device="cpu")
    for src, dst_cls, kw in ((j, tivf.IVFIndex, {"device": "cpu"}),
                             (t, jivf.IVFIndex, {})):
        blob = src.to_blob()
        back = dst_cls.from_blob(blob, v, mask, DIM, **kw)
        assert back is not None
        np.testing.assert_allclose(np.asarray(back.centroids)[:12],
                                   blob["centroids"], rtol=0, atol=0)
        assert back._n_used == 3000
    # a changed active set makes the blob stale: the caller retrains
    mask2 = mask.copy()
    mask2[5] = False
    assert tivf.IVFIndex.from_blob(t.to_blob(), v, mask2, DIM) is None
    assert tivf.IVFIndex.from_blob({"centroids": np.zeros((3, 7))}, v, mask,
                                   DIM) is None
    # after an update the refreshed blob covers the live rows
    assert t.update(np.array([0, 3000]), np.stack([v[0], v[1]]),
                    np.array([False, True]))
    assert j.update(np.array([0, 3000]), np.stack([v[0], v[1]]),
                    np.array([False, True]))
    np.testing.assert_array_equal(t.to_blob()["assign_rows"],
                                  j.to_blob()["assign_rows"])
