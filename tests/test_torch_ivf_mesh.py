"""Sharded IVF tier (`ShardedIVF`): picovdb_tpu vs picovdb_tpu_torch on
the CPU.

The case-by-case counterpart of tests/test_ivf_mesh.py, at its sizes (one
IVF tile a shard on the 8-shard mesh). picovdb_tpu runs on its 8-device
virtual CPU mesh (K7 in Pallas interpret mode, passed by ShardedIVF
itself, as tests/test_ivf_mesh.py runs it); the port on meshes of repeated
CPU devices: 8 shards, 4 shards and dp = 2 x 4 (the IVF tier serves from
the mesh's first row). A port index built by `from_blob` of picovdb_tpu's
blob shares its centroids and so probes the same clusters. Scores agree
within TOL_SCORE = 1e-5 absolute; ids are compared as global slots or
store ids, equal wherever the float64 k-th / (k+1)-th gap exceeds
TOL_GAP = 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu.parallel import make_mesh as jax_mesh
from picovdb_tpu.parallel.ivf_mesh import ShardedIVF as JaxShardedIVF
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.parallel import make_mesh
from picovdb_tpu_torch.parallel.ivf_mesh import ShardedIVF
from test_ivf import clustered_data
from torch_port_setup import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual mesh")

K_ID, K_VECTOR = picovdb_tpu.K_ID, picovdb_tpu.K_VECTOR
TOL_SCORE = 1e-5
TOL_GAP = 1e-5
CPU = torch.device("cpu")
MESHES = {"8": (1, 8), "4": (1, 4), "dp2x4": (2, 4)}


def port_mesh(name):
    dp, shards = MESHES[name]
    return make_mesh(shards, devices=[CPU] * (dp * shards), dp=dp)


def mesh_for(pkg, name="8"):
    return jax_mesh() if pkg is picovdb_tpu else port_mesh(name)


def oracle(corpus, live, queries, k):
    scores = np.where(live[None, :], queries.astype(np.float64)
                      @ corpus.astype(np.float64).T, -np.inf)
    idx = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    return scores, idx, np.take_along_axis(scores, idx, axis=1)


def gap_ok(row, k):
    s = np.sort(row[np.isfinite(row)])[::-1]
    return s.shape[0] <= k or s[k - 1] - s[k] > TOL_GAP


def assert_matches(got, want, scores, k):
    """(vals, slots) within TOL_SCORE; slot sets equal where the gap
    allows."""
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=TOL_SCORE)
    for r in range(got[0].shape[0]):
        if gap_ok(scores[r], k):
            assert sorted(got[1][r]) == sorted(want[1][r]), r


def _queries(rng, vectors, m, dim):
    return normalize_batch(
        vectors[:m] + 0.01 * rng.normal(size=(m, dim)).astype(np.float32))


# ---------------------------------------------------------------------------
# the index
# ---------------------------------------------------------------------------


_JAX_IVF = {}


def _jax_ivf(nlist, n=4000, dim=32, k=10, masked=False):
    """picovdb_tpu's ShardedIVF over the test corpus, its blob and its
    searches at a partial and the full probe (one build per case)."""
    key = (nlist, n, dim, k, masked)
    if key not in _JAX_IVF:
        rng = np.random.default_rng(21)
        vectors, _ = clustered_data(rng, n, dim)
        mask = np.ones(n, dtype=bool)
        if masked:
            mask[100:200] = False
        queries = _queries(rng, vectors, 16, dim)
        ivf = JaxShardedIVF.build(vectors, mask, jax_mesh(), nlist=nlist,
                                  dim=dim)
        _JAX_IVF[key] = dict(
            vectors=vectors, mask=mask, queries=queries, ivf=ivf,
            blob=ivf.to_blob(),
            partial=ivf.search(queries, k, ef=2, dev=None),
            full=ivf.search(queries, k, ef=1000, dev=None))
    return _JAX_IVF[key]


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_ivf_from_jax_blob_probes_the_same(mesh_name):
    """A port index laid out from picovdb_tpu's blob: on the 8-shard mesh
    the very same per-shard layout; on every mesh the same answers at a
    partial probe, and the oracle's at the full probe."""
    j = _jax_ivf(16)
    n, dim, k = 4000, 32, 10
    mesh = port_mesh(mesh_name)
    ivf = ShardedIVF.from_blob(j["blob"], j["vectors"], j["mask"], dim,
                               mesh=mesh)
    assert ivf is not None and ivf.nlist == 16
    shards = mesh.shape["shard"]
    assert len(ivf.slots) == shards
    assert all(t.shape == (ivf.cap_shard,) for t in ivf.slots)
    if shards == 8:
        jv = j["ivf"]
        assert ivf.cap_shard == jv.cap_shard and ivf.n_tiles == jv.n_tiles
        np.testing.assert_array_equal(
            np.concatenate([t.numpy() for t in ivf.slots]), np.asarray(jv.slots))
        np.testing.assert_array_equal(
            np.stack([t.numpy() for t in ivf.seg_starts]),
            np.asarray(jv.seg_starts))
        np.testing.assert_array_equal(
            np.stack([t.numpy() for t in ivf.cluster2tile]),
            np.asarray(jv.cluster2tile))
    scores, _, ovals = oracle(j["vectors"], j["mask"], j["queries"], k)
    full = ivf.search(j["queries"], k, ef=1000, dev=None)
    np.testing.assert_allclose(full[0], ovals, rtol=0, atol=TOL_SCORE)
    assert_matches(full, j["full"], scores, k)
    part = ivf.search(j["queries"], k, ef=2, dev=None)
    np.testing.assert_allclose(part[0], j["partial"][0], rtol=0, atol=TOL_SCORE)
    for r in range(16):
        if gap_ok(np.where(np.isin(np.arange(n), j["partial"][1][r]),
                           scores[r], -np.inf), k):
            assert sorted(part[1][r]) == sorted(j["partial"][1][r])


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_ivf_nprobe_tradeoff_and_mask(mesh_name):
    """Deleted rows never surface; recall grows with ef and reaches 0.9;
    each ef answers as picovdb_tpu's index of the same blob."""
    j = _jax_ivf(32, k=5, masked=True)
    k = 5
    ivf = ShardedIVF.from_blob(j["blob"], j["vectors"], j["mask"], 32,
                               mesh=port_mesh(mesh_name))
    _, oidx, _ = oracle(j["vectors"], j["mask"], j["queries"], k)
    recalls = {}
    for ef in (2, 128):
        vals, slots = ivf.search(j["queries"], k, ef=ef, dev=None)
        assert not (set(range(100, 200)) & set(slots.ravel().tolist()))
        recalls[ef] = np.mean([len(set(slots[i]) & set(oidx[i])) / k
                               for i in range(16)])
        if ef == 2:
            np.testing.assert_allclose(vals, j["partial"][0][:, :k], rtol=0,
                                       atol=TOL_SCORE)
    assert recalls[128] >= recalls[2]
    assert recalls[128] >= 0.9, recalls


def test_sharded_ivf_own_build_matches_the_oracle_at_full_probe():
    """The port's own k-means build (not from a blob) is exact at the
    full probe, on every shard count."""
    rng = np.random.default_rng(4)
    n, dim, k = 4000, 32, 10
    vectors, _ = clustered_data(rng, n, dim)
    queries = _queries(rng, vectors, 16, dim)
    _, _, ovals = oracle(vectors, np.ones(n, bool), queries, k)
    for name in MESHES:
        ivf = ShardedIVF.build(vectors, np.ones(n, bool), port_mesh(name),
                               nlist=16, dim=dim)
        assert ivf._n_used.sum() == n and ivf.overflow_fraction == 0.0
        vals, slots = ivf.search(queries, k, ef=1000, dev=None)
        np.testing.assert_allclose(vals, ovals, rtol=0, atol=TOL_SCORE)


def _update_case(ivf, vectors, rng):
    """delete 2 rows, update 3 in place, append 4 new; returns the
    mutated corpus, its live mask, the new rows and the changed slots."""
    n, dim = vectors.shape
    corpus = np.vstack([vectors, np.zeros((4, dim), np.float32)])
    live = np.ones(n + 4, dtype=bool)
    upd = normalize_batch(rng.normal(size=(7, dim)).astype(np.float32))
    changed = np.array([5, 6, 100, 200, 300, n, n + 1, n + 2, n + 3])
    flags = np.array([False, False] + [True] * 7)
    rows = np.zeros((9, dim), np.float32)
    rows[2:] = upd
    corpus[changed[2:]] = upd
    live[5] = live[6] = False
    assert ivf.update(changed, rows, flags)
    return corpus, live, upd, changed


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_ivf_update_in_place(mesh_name):
    """update() applies deletes / updates / appends in place on both
    packages' indexes of one blob; the full probe matches the mutated
    oracle and picovdb_tpu's index after the same update."""
    rng = np.random.default_rng(23)
    n, dim, k = 4000, 32, 10
    vectors, _ = clustered_data(rng, n, dim)
    jivf = JaxShardedIVF.build(vectors, np.ones(n, bool), jax_mesh(),
                               nlist=16, dim=dim)
    tivf = ShardedIVF.from_blob(jivf.to_blob(), vectors, np.ones(n, bool),
                                dim, mesh=port_mesh(mesh_name))
    assert tivf.overflow_fraction == 0.0
    corpus, live, upd, changed = _update_case(tivf, vectors,
                                              np.random.default_rng(1))
    _update_case(jivf, vectors, np.random.default_rng(1))
    assert 0.0 < tivf.overflow_fraction < 0.01
    queries = normalize_batch(rng.normal(size=(12, dim)).astype(np.float32))
    scores, _, ovals = oracle(corpus, live, queries, k)
    got = tivf.search(queries, k, ef=1000, dev=None)
    np.testing.assert_allclose(got[0], ovals, rtol=0, atol=TOL_SCORE)
    assert_matches(got, jivf.search(queries, k, ef=1000, dev=None), scores, k)
    v2, s2 = tivf.search(upd[3:4], 1, ef=1000, dev=None)
    assert s2[0, 0] == changed[5]
    # the refreshed blob is picovdb_tpu's
    tb, jb = tivf.to_blob(), jivf.to_blob()
    np.testing.assert_array_equal(tb["assign_rows"], jb["assign_rows"])
    if mesh_name == "8":
        np.testing.assert_array_equal(tb["assign_cluster"],
                                      jb["assign_cluster"])


def test_sharded_ivf_update_with_i8_mirror(monkeypatch):
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    rng = np.random.default_rng(25)
    n, dim = 3000, 32
    vectors, _ = clustered_data(rng, n, dim)
    ivf = ShardedIVF.build(vectors, np.ones(n, bool), port_mesh("8"),
                           nlist=16, dim=dim)
    assert ivf.vectors_i8c is not None and len(ivf.cscale) == 8
    new = normalize_batch(rng.normal(size=(2, dim)).astype(np.float32))
    assert ivf.update(np.array([n, n + 1]), new, np.array([True, True]))
    v, s = ivf.search(new[:1], 1, ef=1000, dev=None)
    assert s[0, 0] == n


def test_sharded_ivf_int8_parity(monkeypatch):
    """Per-shard int8 postings select what the float32 postings select."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    rng = np.random.default_rng(27)
    n, dim, k = 4096, 32, 8
    vectors, _ = clustered_data(rng, n, dim)
    queries = _queries(rng, vectors, 16, dim)
    ivf = ShardedIVF.build(vectors, np.ones(n, bool), port_mesh("8"),
                           nlist=16, dim=dim)
    assert ivf.vectors_i8c is not None
    _, s_i8 = ivf.search(queries, k, ef=64, dev=None)
    ivf.vectors_i8c = ivf.cscale = None
    _, s_f32 = ivf.search(queries, k, ef=64, dev=None)
    overlap = np.mean([len(set(s_i8[i]) & set(s_f32[i])) / k
                       for i in range(16)])
    assert overlap >= 0.95, overlap


def test_sharded_ivf_update_overflow_exhaustion():
    """An append set past the total per-shard slack returns False and
    changes nothing."""
    rng = np.random.default_rng(29)
    n, dim = 2000, 16
    vectors, _ = clustered_data(rng, n, dim)
    ivf = ShardedIVF.build(vectors, np.ones(n, bool), port_mesh("8"),
                           nlist=8, dim=dim)
    total_free = int(8 * ivf.cap_shard - ivf._n_used.sum())
    m = total_free + 1
    big = normalize_batch(rng.normal(size=(m, dim)).astype(np.float32))
    before = ivf._n_used.copy()
    act_before = [t.clone() for t in ivf.active]
    assert not ivf.update(np.arange(n, n + m), big, np.ones(m, dtype=bool))
    np.testing.assert_array_equal(ivf._n_used, before)
    assert all(torch.equal(a, b) for a, b in zip(ivf.active, act_before))


def test_sharded_ivf_i8only_update_owner_placement(monkeypatch):
    """int8-only in-place updates: appends requantize against the frozen
    per-shard scales and land on their OWNING corpus shard; a row far
    outside the build-time range trips the clip guard and changes
    nothing."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    rng = np.random.default_rng(31)
    n, dim = 4096, 32
    vectors, _ = clustered_data(rng, n, dim)
    mask = np.ones(n, dtype=bool)
    mask[n - 16:] = False
    ivf = ShardedIVF.build(vectors, mask, port_mesh("8"), nlist=16, dim=dim,
                           i8_only=True, corpus_cap=n)
    jivf = JaxShardedIVF.build(vectors, mask, jax_mesh(), nlist=16, dim=dim,
                               i8_only=True, corpus_cap=n)
    # the same host-quantized postings and frozen scales as picovdb_tpu
    ivf2 = ShardedIVF.from_blob(jivf.to_blob(), vectors, mask, dim,
                                mesh=port_mesh("8"), i8_only=True,
                                corpus_cap=n)
    np.testing.assert_array_equal(ivf2._cscale_np, jivf._cscale_np)
    np.testing.assert_array_equal(
        np.concatenate([t.numpy() for t in ivf2.vectors_i8c]),
        np.asarray(jivf.vectors_i8c))
    assert ivf.vectors is None and ivf.overflow_fraction == 0.0
    shard_rows = n // 8
    slots = np.array([n - 16, n - 1], dtype=np.int64)
    new = normalize_batch(rng.normal(size=(2, dim)).astype(np.float32))
    used = ivf._n_used.copy()
    assert ivf.update(slots, new, np.array([True, True]))
    assert ivf.last_update_clip_fraction <= 0.02
    for slot in slots:
        owner = slot // shard_rows
        row = int(ivf._slot2row[slot])
        assert row // ivf.cap_shard == owner
        local = int(ivf.slots[owner][row % ivf.cap_shard])
        assert owner * shard_rows + local == slot
    assert int(ivf._n_used.sum()) == int(used.sum()) + 2
    assert ivf.update(np.array([5]), np.zeros((1, dim), np.float32),
                      np.array([False]))
    assert ivf._slot2row[5] == -1
    wild = np.zeros((1, dim), np.float32)
    wild[0, :8] = 1.0
    state = (ivf._n_used.copy(), int(ivf._slot2row[n - 8]))
    assert not ivf.update(np.array([n - 8]), wild, np.array([True]))
    assert ivf.last_update_clip_fraction > 0.0
    np.testing.assert_array_equal(ivf._n_used, state[0])
    assert int(ivf._slot2row[n - 8]) == state[1]


def test_sharded_classic_mirror_update_is_o_changed(monkeypatch):
    """Classic layout: in-distribution appends scatter into the int8
    mirror against the frozen scales; drifted appends re-derive it."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    rng = np.random.default_rng(33)
    n, dim = 3000, 32
    vectors, _ = clustered_data(rng, n, dim)
    ivf = ShardedIVF.build(vectors, np.ones(n, bool), port_mesh("8"),
                           nlist=16, dim=dim)
    frozen = ivf._cscale_np
    new = normalize_batch(rng.normal(size=(2, dim)).astype(np.float32))
    assert ivf.update(np.array([n, n + 1]), new, np.array([True, True]))
    assert ivf.last_update_clip_fraction <= 0.05
    assert ivf._cscale_np is frozen
    assert ivf.search(new[:1], 1, ef=1000, dev=None)[1][0, 0] == n
    big = np.full((1, dim), 100.0, dtype=np.float32)
    assert ivf.update(np.array([n + 2]), big, np.array([True]))
    assert ivf.last_update_clip_fraction > 0.05
    assert ivf._cscale_np is not frozen
    _, s2 = ivf.search(normalize_batch(big.copy()), 1, ef=1000, dev=None)
    assert s2[0, 0] == n + 2


# ---------------------------------------------------------------------------
# the engine: PicoVectorDB(mesh=..., index="ivf")
# ---------------------------------------------------------------------------


def _store(pkg, path, dim, mesh_name="8", **kw):
    return pkg.PicoVectorDB(embedding_dim=dim, storage_file=path,
                            mesh=mesh_for(pkg, mesh_name), index="ivf", **kw)


_JAX_E2E = {}


def _e2e_scenario(db, vectors, k):
    db.upsert([{K_ID: str(i), K_VECTOR: vectors[i]} for i in range(len(vectors))])
    out = {"first": db.query(vectors[77], top_k=k, ef_search=1000),
           "route": db._last_topk_strategy}
    db.delete(["77"])
    out["after"] = db.query(vectors[77], top_k=k, ef_search=1000)
    out["mode"] = db._last_ann_rebuild_mode
    out["route2"] = db._last_topk_strategy
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_engine_mesh_ivf_end_to_end(tmp_path, mesh_name):
    """index="ivf" on a mesh store serves through the sharded probe scan,
    as picovdb_tpu's does, and a delete epoch stays incremental."""
    rng = np.random.default_rng(35)
    dim, n, k = 24, 3000, 8
    vectors, _ = clustered_data(rng, n, dim)
    if "jax" not in _JAX_E2E:
        _JAX_E2E["jax"] = _e2e_scenario(
            _store(picovdb_tpu, f"{tmp_path}/j", dim, ivf_nlist=32), vectors, k)
    want = _JAX_E2E["jax"]
    tdb = _store(picovdb_tpu_torch, f"{tmp_path}/t", dim, mesh_name,
                 ivf_nlist=32)
    got = _e2e_scenario(tdb, vectors, k)
    assert type(tdb._ivf).__name__ == "ShardedIVF"
    assert got["route"] == want["route"] == "ivf"
    assert got["first"][0][K_ID] == "77"
    assert [h[K_ID] for h in got["first"]] == [h[K_ID] for h in want["first"]]
    assert got["mode"] == want["mode"] == "incremental"
    assert got["route2"].startswith("ivf")
    assert all(h[K_ID] != "77" for h in got["after"])
    assert [h[K_ID] for h in got["after"]] == [h[K_ID] for h in want["after"]]
    exact = picovdb_tpu_torch.PicoVectorDB(
        embedding_dim=dim, storage_file=f"{tmp_path}/x",
        mesh=port_mesh(mesh_name), index="exact")
    exact.upsert([{K_ID: str(i), K_VECTOR: vectors[i]} for i in range(n)])
    r2 = exact.query(vectors[42], top_k=k)
    r1 = tdb.query(vectors[42], top_k=k, ef_search=1000)
    assert [h[K_ID] for h in r1] == [h[K_ID] for h in r2]


def test_engine_mesh_ivf_sidecar_crossloads(tmp_path):
    """A mesh store's sidecar reloads warm into a mesh store and a
    single-device store of either package, and picovdb_tpu's mesh sidecar
    into the port's mesh store."""
    rng = np.random.default_rng(37)
    dim, n, k = 24, 2500, 5
    vectors, _ = clustered_data(rng, n, dim)
    for src, dst in ((picovdb_tpu_torch, picovdb_tpu),
                     (picovdb_tpu, picovdb_tpu_torch)):
        path = f"{tmp_path}/{src.__name__}"
        db = _store(src, path, dim, ivf_nlist=16)
        db.upsert([{K_ID: str(i), K_VECTOR: vectors[i]} for i in range(n)])
        db.query(vectors[0], top_k=k)
        db.save()
        for pkg, mesh in ((dst, True), (src, True), (picovdb_tpu_torch, False)):
            kw = dict(mesh=mesh_for(pkg)) if mesh else dict(device="cpu")
            db2 = pkg.PicoVectorDB(embedding_dim=dim, storage_file=path,
                                   index="ivf", ivf_nlist=16, **kw)
            assert db2._ivf is not None  # the sidecar, no retrain
            res = db2.query(vectors[42], top_k=k, ef_search=1000)
            assert db2._last_topk_strategy.startswith("ivf")
            assert res[0][K_ID] == "42"


@pytest.mark.parametrize("mesh_name", ["8", "dp2x4"])
@pytest.mark.parametrize("storage", ["int8", "int4"])
def test_engine_mesh_int8_only_ivf(tmp_path, monkeypatch, mesh_name, storage):
    """index="ivf" with quantized storage on a mesh: the int8-only
    per-shard layout (owner placement, rescore from the engine's shard),
    an incremental epoch, and a warm sidecar reload; full-probe answers
    equal the sharded exact scan's and picovdb_tpu's."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    rng = np.random.default_rng(39)
    dim, n, k = 32, 4096, 8
    vectors, _ = clustered_data(rng, n, dim)
    dbs = {}
    for pkg in (picovdb_tpu, picovdb_tpu_torch):
        db = _store(pkg, f"{tmp_path}/{pkg.__name__}", dim, mesh_name,
                    storage_dtype=storage, ivf_nlist=16)
        db.upsert_columnar(vectors.copy(), ids=[str(i) for i in range(n)])
        db.rebuild_index()
        dbs[pkg] = db
    tdb, jdb = dbs[picovdb_tpu_torch], dbs[picovdb_tpu]
    assert tdb._ivf is not None and tdb._ivf.vectors is None
    assert tdb._ivf.corpus_cap == tdb._dev.cap
    res = tdb.query(vectors[77], top_k=k, ef_search=1000)
    assert tdb._last_topk_strategy.startswith("ivf")
    assert res[0][K_ID] == "77"
    assert [h[K_ID] for h in res] == [
        h[K_ID] for h in jdb.query(vectors[77], top_k=k, ef_search=1000)]
    exact = tdb.query(vectors[77], top_k=k, ef_search=1000,
                      where=lambda d: True)
    assert {h[K_ID] for h in res} == {h[K_ID] for h in exact}
    new = normalize_batch(rng.normal(size=(2, dim)).astype(np.float32))
    tdb.upsert([{K_ID: f"n{j}", K_VECTOR: new[j]} for j in range(2)])
    tdb.delete(["77"])
    res3 = tdb.query(vectors[77], top_k=k, ef_search=1000)
    assert tdb._last_ann_rebuild_mode == "incremental"
    assert tdb._ivf.last_update_clip_fraction <= 0.02
    assert all(h[K_ID] != "77" for h in res3)
    assert tdb.query(new[0], top_k=k, ef_search=1000)[0][K_ID] == "n0"
    tdb.save()
    db2 = _store(picovdb_tpu_torch, f"{tmp_path}/{picovdb_tpu_torch.__name__}",
                 dim, mesh_name, storage_dtype=storage, ivf_nlist=16)
    assert db2._ivf is not None and db2._ivf.vectors is None
    assert db2.query(vectors[42], top_k=k, ef_search=1000)[0][K_ID] == "42"


def test_engine_mesh_capacity_triggered_i8_only(tmp_path, monkeypatch):
    """A bf16 mesh store whose classic per-shard postings would pass the
    per-shard budget takes the int8-only layout; with room, classic."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    monkeypatch.setenv("PICOVDB_IVF_BUDGET_GB", "0.00001")
    rng = np.random.default_rng(41)
    dim, n, k = 32, 4096, 8
    vectors, _ = clustered_data(rng, n, dim)
    path = f"{tmp_path}/t"
    db = _store(picovdb_tpu_torch, path, dim, storage_dtype="bfloat16",
                ivf_nlist=16)
    db.upsert_columnar(vectors.copy(), ids=[str(i) for i in range(n)])
    db.rebuild_index()
    assert db._ivf is not None and db._ivf.vectors is None
    assert db._ivf.corpus_cap == db._dev.cap
    res = db.query(vectors[77], top_k=k, ef_search=1000)
    assert db._last_topk_strategy.startswith("ivf") and res[0][K_ID] == "77"
    exact = db.query(vectors[77], top_k=k, ef_search=1000, where=lambda d: True)
    assert {h[K_ID] for h in res} == {h[K_ID] for h in exact}
    db.save()
    db2 = _store(picovdb_tpu_torch, path, dim, storage_dtype="bfloat16",
                 ivf_nlist=16)
    assert db2._ivf is not None and db2._ivf.vectors is None
    assert db2.query(vectors[42], top_k=k, ef_search=1000)[0][K_ID] == "42"
    monkeypatch.setenv("PICOVDB_IVF_BUDGET_GB", "13")
    db3 = _store(picovdb_tpu_torch, path, dim, storage_dtype="bfloat16",
                 ivf_nlist=16)
    assert db3._ivf is not None and db3._ivf.vectors is not None
    assert db3._ivf.vectors[0].dtype == torch.bfloat16


def test_engine_mesh_ivf_incremental_epoch(tmp_path):
    """A mutation epoch on a mesh IVF store stays incremental and, at the
    full probe, answers as a sharded exact twin does."""
    rng = np.random.default_rng(43)
    dim, n, k = 24, 3000, 8
    vectors, _ = clustered_data(rng, n, dim)
    db = _store(picovdb_tpu_torch, f"{tmp_path}/t", dim, ivf_nlist=32)
    twin = picovdb_tpu_torch.PicoVectorDB(
        embedding_dim=dim, storage_file=f"{tmp_path}/x", mesh=port_mesh("8"),
        index="exact")
    new = normalize_batch(rng.normal(size=(5, dim)).astype(np.float32))
    for d in (db, twin):
        d.upsert([{K_ID: str(i), K_VECTOR: vectors[i]} for i in range(n)])
        d.query(vectors[0], top_k=k)
        d.upsert([{K_ID: f"new{j}", K_VECTOR: new[j]} for j in range(3)]
                 + [{K_ID: "10", K_VECTOR: new[3]},
                    {K_ID: "11", K_VECTOR: new[4]}])
        d.delete(["20"])
    res = db.query(new[0], top_k=k, ef_search=1000)
    assert db._last_ann_rebuild_mode == "incremental"
    assert db._last_sync_mode == "incremental"
    assert db._last_topk_strategy.startswith("ivf")
    assert res[0][K_ID] == "new0"
    assert db.query(new[3], top_k=k, ef_search=1000)[0][K_ID] == "10"
    assert all(h[K_ID] != "20" for h in db.query(vectors[20], top_k=k,
                                                 ef_search=1000))
    qs = normalize_batch(rng.normal(size=(16, dim)).astype(np.float32))
    i1, _ = db.query_columnar(qs, top_k=k, ef_search=1000)
    i2, _ = twin.query_columnar(qs, top_k=k)
    np.testing.assert_array_equal(i1, i2)


def test_engine_mesh_ivf_sidecar_after_incremental(tmp_path):
    rng = np.random.default_rng(45)
    dim, n, k = 24, 2500, 5
    vectors, _ = clustered_data(rng, n, dim)
    path = f"{tmp_path}/t"
    db = _store(picovdb_tpu_torch, path, dim, ivf_nlist=16)
    db.upsert([{K_ID: str(i), K_VECTOR: vectors[i]} for i in range(n)])
    db.query(vectors[0], top_k=k)
    new = normalize_batch(rng.normal(size=(2, dim)).astype(np.float32))
    db.upsert([{K_ID: f"n{j}", K_VECTOR: new[j]} for j in range(2)])
    db.delete(["7"])
    db.query(new[0], top_k=k)
    assert db._last_ann_rebuild_mode == "incremental"
    db.save()
    db2 = _store(picovdb_tpu_torch, path, dim, ivf_nlist=16)
    assert db2._ivf is not None
    assert db2.query(new[1], top_k=k, ef_search=1000)[0][K_ID] == "n1"
    assert all(h[K_ID] != "7" for h in db2.query(vectors[7], top_k=k,
                                                 ef_search=1000))


@pytest.mark.parametrize("device_born", [False, True])
def test_engine_mesh_i8only_clip_guard_falls_back_to_rebuild(
        tmp_path, monkeypatch, device_born):
    """An append that clips against the frozen scales rebuilds the tier
    (fresh scales), also on a device-born (lazy) store."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    monkeypatch.setenv("PICOVDB_IVF_I8_CLIP_MAX", "0")
    rng = np.random.default_rng(47)
    dim, n, k = 32, 4096, 8
    vectors, _ = clustered_data(rng, n, dim)
    db = _store(picovdb_tpu_torch, f"{tmp_path}/t", dim,
                storage_dtype="int8", ivf_nlist=16)
    if device_born:
        db.ingest_device(torch.from_numpy(vectors),
                         ids=[str(i) for i in range(n)], normalize=False)
        assert db._host_lazy
    else:
        db.upsert_columnar(vectors.copy(), ids=[str(i) for i in range(n)])
    db.rebuild_index()
    assert db._ivf is not None and db._ivf.vectors is None
    onehot = np.zeros(dim, np.float32)
    onehot[0] = 1.0
    db.upsert([{K_ID: "hot", K_VECTOR: onehot}])
    res = db.query(onehot, top_k=k, ef_search=1000)
    assert db._last_ann_rebuild_mode == "full"
    assert res[0][K_ID] == "hot"
    assert db.query(vectors[7], top_k=1)[0][K_ID] == "7"


def test_engine_mesh_i8only_empty_shard_append_self_heals(tmp_path,
                                                         monkeypatch):
    """An append routed to an owner shard with no built rows clips ~100 %
    against the floor scales, so the guard refuses and the rebuild makes
    it visible."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    rng = np.random.default_rng(49)
    dim, k = 32, 4
    db = _store(picovdb_tpu_torch, f"{tmp_path}/t", dim, storage_dtype="int8",
                ivf_nlist=8)
    seed, _ = clustered_data(rng, 64, dim)
    db.upsert([{K_ID: f"s{i}", K_VECTOR: seed[i]} for i in range(64)])
    db.rebuild_index()
    assert db._ivf is not None and db._ivf.vectors is None
    shard_rows = int(db._dev.cap) // 8
    more, _ = clustered_data(rng, shard_rows - 64, dim)
    db.upsert_columnar(more, ids=[f"m{i}" for i in range(shard_rows - 64)])
    db.rebuild_index()
    newv = rng.normal(size=dim).astype(np.float32)
    newv /= np.linalg.norm(newv)
    db.upsert([{K_ID: "fresh", K_VECTOR: newv}])
    res = db.query(newv, top_k=k, ef_search=10**6)
    assert res[0][K_ID] == "fresh"
    assert db._last_ann_rebuild_mode == "full"
