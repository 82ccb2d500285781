"""Differential engine slice for the IVF tier: picovdb_tpu vs
picovdb_tpu_torch on the CPU.

Each sequence of operations is replayed through both packages'
`PicoVectorDB` (JAX: its Pallas kernels in interpret mode; port: the
plain versions of K7 / K8). Per query the routes (`last_strategy`) must be
identical, scores agree within TOL_SCORE = 1e-5 (float32 dot products of
the same rows, summed in different orders; the host rescore is the same
NumPy code in both), and id sets agree wherever the float64
k-th/(k+1)-th gap over the rows the route ranks exceeds TOL_GAP = 1e-4.
Clusters hold a few hundred rows, so both packages' probes take the
ladder (K7) for single queries and batches alike, except where a test
forces otherwise.

The port builds the tier under index="auto" at the first sync after a
bulk load, as picovdb_tpu's README says; picovdb_tpu itself builds only
on rebuild_index() / vacuum() (ROADMAP queue 3), so the "auto" parity
test compares after rebuild_index() and the port's own build is tested
on the port alone.
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import ivf as tivf
from torch_port_setup import cap_torch_threads, cpu_kw

cap_torch_threads()

K_ID, K_METRICS = picovdb_tpu.K_ID, picovdb_tpu.K_METRICS
PACKAGES = {"jax": picovdb_tpu, "torch": picovdb_tpu_torch}
TOL_SCORE = 1e-5
TOL_GAP = 1e-4
DIM = 32
N = 3000


@pytest.fixture(autouse=True)
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def clustered(rng, n, dim=DIM, n_clusters=16, noise=0.35):
    centres = normalize_batch(rng.normal(size=(n_clusters, dim)).astype(np.float32))
    lab = rng.integers(0, n_clusters, n)
    pts = centres[lab] + noise / np.sqrt(dim) * rng.normal(size=(n, dim))
    return normalize_batch(pts.astype(np.float32))


def _build(tmp, vecs, n=N, **kw):
    kw.setdefault("index", "ivf")
    dbs = {}
    for name, pkg in PACKAGES.items():
        db = pkg.PicoVectorDB(embedding_dim=DIM, storage_file=f"{tmp}/{name}",
                              **kw, **cpu_kw(pkg))
        db.upsert_columnar(vecs[:n], ids=[f"d{i}" for i in range(n)],
                           metadata=[{"tag": i % 5} for i in range(n)])
        dbs[name] = db
    return dbs


def _gaps(vecs, live, q, k):
    qn = normalize_batch(np.atleast_2d(q)).astype(np.float64)
    s = qn @ vecs[live].astype(np.float64).T
    s = -np.sort(-s, axis=1)
    return s[:, k - 1] - s[:, k]


def _same(rj, rt, gaps):
    assert len(rj) == len(rt)
    for i, (hj, ht) in enumerate(zip(rj, rt)):
        assert len(hj) == len(ht), i
        np.testing.assert_allclose([h[K_METRICS] for h in ht],
                                   [h[K_METRICS] for h in hj],
                                   rtol=0, atol=TOL_SCORE)
        if gaps[i] > TOL_GAP:
            assert {h[K_ID] for h in hj} == {h[K_ID] for h in ht}, i


def _both(dbs, method, q, **kw):
    out, routes = {}, {}
    for name, db in dbs.items():
        res = getattr(db, method)(q, **kw)
        if method == "query" and np.ndim(q) == 1:
            res = [res]
        if method == "query_columnar":
            ids, sc = res
            res = [[{K_ID: i, K_METRICS: s} for i, s in zip(r, srow)
                    if i is not None] for r, srow in zip(ids, sc)]
        out[name] = res
        routes[name] = db.last_query_debug()["strategy"]
    assert routes["jax"] == routes["torch"], routes
    return out["jax"], out["torch"], routes["jax"]


def test_ivf_replay_through_every_lane(tmp_path):
    rng = np.random.default_rng(1)
    vecs = clustered(rng, N + 40)
    dbs = _build(tmp_path, vecs, ivf_nlist=16)
    live = np.zeros(N + 40, bool)
    live[:N] = True
    q = vecs[rng.integers(0, N, 24)] + 0.02 * rng.normal(size=(24, DIM))
    q = q.astype(np.float32)
    for method, qq, kw in (("query", q[0], {}), ("query", q[:6], {}),
                           ("query", q[:6], {"ef_search": 4}),
                           ("query_batched", q, {"batch_size": 8}),
                           ("query_columnar", q, {"batch_size": 16}),
                           ("query_columnar", q[:5], {"hnsw_ef_search": 2})):
        rj, rt, route = _both(dbs, method, qq, top_k=10, **kw)
        assert route == "ivf"
        _same(rj, rt, _gaps(vecs, live, qq, 10))
    # an append + a delete epoch: the overflow region, in place
    for name, db in dbs.items():
        db.upsert_columnar(vecs[N:], ids=[f"e{i}" for i in range(40)])
        db.delete([f"d{i}" for i in range(0, 60, 3)])
    live[N:] = True
    live[0:60:3] = False
    rj, rt, route = _both(dbs, "query", vecs[N:N + 8], top_k=5)
    assert route == "ivf"
    _same(rj, rt, _gaps(vecs, live, vecs[N:N + 8], 5))
    assert [h[0][K_ID] for h in rt] == [f"e{i}" for i in range(8)]
    for db in dbs.values():
        dbg = db.last_query_debug()
        assert dbg["ann_rebuild_mode"] == "incremental", dbg
    op = {n: db.last_query_debug()["ann_operating_point"] for n, db in dbs.items()}
    assert op["jax"] == op["torch"]
    st = {n: db.stats() for n, db in dbs.items()}
    assert st["jax"]["faiss"] is st["torch"]["faiss"] is True
    assert st["jax"]["ann_postings"] == st["torch"]["ann_postings"] == "storage"


def test_filtered_batches_stay_exact(tmp_path):
    rng = np.random.default_rng(2)
    vecs = clustered(rng, N)
    dbs = _build(tmp_path, vecs, ivf_nlist=16)
    q = (vecs[:12] + 0.02 * rng.normal(size=(12, DIM))).astype(np.float32)
    tag2 = np.arange(N) % 5 == 2
    for method in ("query", "query_batched", "query_columnar"):
        rj, rt, route = _both(dbs, method, q, top_k=10, where={"tag": 2})
        assert not route.startswith("ivf")
        _same(rj, rt, _gaps(vecs, tag2, q, 10))
        exact = np.argsort(-(normalize_batch(q) @ vecs[tag2].T), axis=1)[:, :10]
        ids = np.nonzero(tag2)[0]
        for i, hits in enumerate(rt):
            assert {h[K_ID] for h in hits} == {f"d{x}" for x in ids[exact[i]]}


def test_auto_union_routing_after_rebuild(tmp_path, monkeypatch):
    """index="auto" over a tier built by rebuild_index(): batches probe
    while their expected probed-cluster union stays <= 0.22 of the lists
    (nprobe 1 of 32: Q <= 7), larger ones serve exact."""
    import picovdb_tpu.ops.ivf as jivf

    monkeypatch.setattr(jivf, "should_build", lambda *a, **k: True)
    monkeypatch.setattr(tivf, "should_build", lambda *a, **k: True)
    rng = np.random.default_rng(3)
    vecs = clustered(rng, N, n_clusters=40)
    dbs = _build(tmp_path, vecs, index="auto", ivf_nlist=32, ivf_nprobe=1)
    for db in dbs.values():
        db.rebuild_index()
    live = np.ones(N, bool)
    q = (vecs[:8] + 0.01 * rng.normal(size=(8, DIM))).astype(np.float32)
    for nq, want in ((1, "ivf"), (4, "ivf"), (7, "ivf"), (8, None)):
        rj, rt, route = _both(dbs, "query", q[:nq], top_k=5)
        assert (route == want) if want else not route.startswith("ivf"), route
        if want is None:  # the exact route: ids equal the oracle's
            _same(rj, rt, _gaps(vecs, live, q[:nq], 5))


@pytest.mark.parametrize("storage", [None, "int8"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_sidecar_cross_load(tmp_path, monkeypatch, storage, writer):
    """A store saved with its .ivf.npz sidecar by one package reopens in
    the other with the tier rebuilt from the sidecar (same centroids, no
    k-means) and the same answers; int8 storage writes a quantized
    checkpoint and reopens lazily."""
    rng = np.random.default_rng(4)
    vecs = clustered(rng, N)
    kw = dict(index="ivf", ivf_nlist=16)
    if storage:
        kw["storage_dtype"] = storage
        kw["rescore"] = "device"
        # int8 postings at dim 32, with a band wide enough that the TPU
        # ladder's lane-truncated int32 keys keep the true top-10 too
        monkeypatch.setenv("PICOVDB_IVF_I8", "1")
        monkeypatch.setenv("PICOVDB_IVF_GUARD", "40")
    src = PACKAGES[writer].PicoVectorDB(embedding_dim=DIM,
                                        storage_file=f"{tmp_path}/s", **kw,
                                        **cpu_kw(PACKAGES[writer]))
    src.upsert_columnar(vecs, ids=[f"d{i}" for i in range(N)])
    q = (vecs[:6] + 0.02 * rng.normal(size=(6, DIM))).astype(np.float32)
    before = src.query(q, top_k=10)
    cent = np.asarray(src._ivf.centroids)
    src.save(quantized=True) if storage else src.save()
    other = PACKAGES["torch" if writer == "jax" else "jax"]
    dst = other.PicoVectorDB(embedding_dim=DIM, storage_file=f"{tmp_path}/s",
                             **kw, **cpu_kw(other))
    dst.query(q[0], top_k=3)  # a deferred (lazy) load builds at this sync
    assert dst._ivf is not None
    np.testing.assert_array_equal(np.asarray(dst._ivf.centroids)[:16],
                                  cent[:16])
    after = dst.query(q, top_k=10)
    assert dst.last_query_debug()["strategy"].startswith("ivf")
    rows = vecs
    if storage:  # ranked at storage precision: the dequantized plane
        rows = (np.asarray(dst._dev.vectors).astype(np.float32)
                * np.asarray(dst._dev.vstore_scale)[:, None])[:N]
    _same(before, after, _gaps(rows, np.ones(N, bool), q, 10))
    blob = picovdb_tpu_torch.persistence.load_ann(f"{tmp_path}/s")
    np.testing.assert_array_equal(blob["centroids"], cent[:16])


@pytest.mark.parametrize("storage", ["int8", "int4"])
def test_quantized_storage_host_rescore_through_ivf(tmp_path, monkeypatch,
                                                    storage):
    """int8 / int4 storage, host-born: the host-f64 rescore selects k +
    guard through the IVF tier's int8-only postings (route ivf_i8) and
    re-ranks on the authentic float32 rows."""
    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    rng = np.random.default_rng(5)
    vecs = clustered(rng, N)
    dbs = _build(tmp_path, vecs, ivf_nlist=16, storage_dtype=storage)
    q = (vecs[:8] + 0.02 * rng.normal(size=(8, DIM))).astype(np.float32)
    live = np.ones(N, bool)
    for qq in (q[0], q):
        rj, rt, route = _both(dbs, "query", qq, top_k=10)
        assert route == "ivf_i8"
        _same(rj, rt, _gaps(vecs, live, qq, 10))
    for db in dbs.values():
        assert db.last_query_debug()["rescore"] == "host"
        assert db.last_query_debug()["ann_operating_point"]["layout"] == "int8_only"


def test_device_born_build_needs_no_host_matrix(tmp_path, monkeypatch):
    """ingest_device into an index="ivf" int8 store: the first query's
    sync finds the mirror current and builds the int8-only postings from
    the device plane; the host matrix is never materialized."""
    import jax.numpy as jnp

    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    monkeypatch.setenv("PICOVDB_IVF_GUARD", "40")  # see test_sidecar_cross_load
    rng = np.random.default_rng(6)
    vecs = clustered(rng, N)
    ids = [f"d{i}" for i in range(N)]
    dbs = {}
    for name, pkg in PACKAGES.items():
        db = pkg.PicoVectorDB(embedding_dim=DIM, storage_file=f"{tmp_path}/{name}",
                              index="ivf", ivf_nlist=16, storage_dtype="int8",
                              **cpu_kw(pkg))
        arr = jnp.asarray(vecs) if name == "jax" else torch.from_numpy(vecs)
        db.ingest_device(arr, ids, normalize=False)
        dbs[name] = db
    q = (vecs[:6] + 0.02 * rng.normal(size=(6, DIM))).astype(np.float32)
    rj, rt, route = _both(dbs, "query", q, top_k=10)
    assert route == "ivf_i8"
    t = dbs["torch"]
    assert t._host_lazy and t._host_vectors is None
    assert t.last_query_debug()["sync_mode"] == "full"  # the adopt, no re-upload
    # rescored at storage precision in both: the dequantized plane
    plane = np.asarray(dbs["jax"]._dev.vectors).astype(np.float32)
    rows = plane * np.asarray(dbs["jax"]._dev.vstore_scale)[:, None]
    _same(rj, rt, _gaps(rows[:N], np.ones(N, bool), q, 10))


def test_auto_builds_at_the_first_sync_after_a_bulk_load(tmp_path, monkeypatch):
    """The port's index="auto" (picovdb_tpu's README contract): a bulk load
    that passes `should_build` gets the tier at the next sync, host-born or
    device-born; below the threshold the store stays exact."""
    rng = np.random.default_rng(7)
    vecs = clustered(rng, N)
    ids = [f"d{i}" for i in range(N)]
    small = picovdb_tpu_torch.PicoVectorDB(embedding_dim=DIM, device="cpu",
                                           storage_file=f"{tmp_path}/s")
    small.upsert_columnar(vecs, ids=ids)
    small.query(vecs[0], top_k=3)
    assert not small.last_query_debug()["ann_active"]
    monkeypatch.setattr(tivf, "should_build", lambda *a, **k: True)
    for i, how in enumerate(("host", "device")):
        db = picovdb_tpu_torch.PicoVectorDB(embedding_dim=DIM, ivf_nlist=32,
                                            ivf_nprobe=1, device="cpu",
                                            storage_file=f"{tmp_path}/a{i}")
        if how == "host":
            db.upsert_columnar(vecs, ids=ids)
        else:
            db.ingest_device(torch.from_numpy(vecs), ids, normalize=False)
        res = db.query(vecs[5], top_k=3)
        dbg = db.last_query_debug()
        assert dbg["ann_active"] and dbg["strategy"] == "ivf", dbg
        assert dbg["ann_build_params"]["kmeans_iters"] == 8
        assert res[0][K_ID] == "d5"


def test_grow_retry_frees_the_ivf_and_rebuilds_warm(tmp_path, monkeypatch):
    """A device grow that runs out of memory with the postings resident:
    the engine frees the postings (warm centroids stashed), retries the
    grow, and rebuilds the tier from them, with no host materialization.
    The failure is injected as tests/test_torch_grow.py injects it: the
    device module's pad helper raises OutOfMemoryError for the first pad
    of the int8 storage plane."""
    from picovdb_tpu_torch import device as tdevice
    from picovdb_tpu_torch.constants import ROW_PAD

    monkeypatch.setenv("PICOVDB_IVF_I8", "1")
    rng = np.random.default_rng(8)
    n = ROW_PAD - 50
    vecs = clustered(rng, n)
    db = picovdb_tpu_torch.PicoVectorDB(
        embedding_dim=DIM, storage_file=f"{tmp_path}/g", index="ivf",
        storage_dtype="int8", ivf_nlist=16, device="cpu")
    db.ingest_device(torch.from_numpy(vecs), [str(i) for i in range(n)],
                     normalize=False)
    db.rebuild_index()
    assert db._host_lazy and db._ivf is not None
    cent = db._ivf.centroids.clone()
    real_pad = tdevice._pad_to
    calls = {"n": 0}

    def pad(t, rows):  # the first corpus pad meets a full device
        if t is not None and t.dtype == torch.int8 and t.ndim == 2:
            calls["n"] += 1
            if calls["n"] == 1:
                raise torch.cuda.OutOfMemoryError("injected: device memory")
        return real_pad(t, rows)

    monkeypatch.setattr(tdevice, "_pad_to", pad)
    extra = clustered(rng, 100)
    db.upsert_columnar(extra, ids=[f"x{i}" for i in range(100)])
    res = db.query(extra[4], top_k=1, ef_search=1000)
    assert calls["n"] == 2 and res[0][K_ID] == "x4"
    assert db._last_ann_rebuild_mode == "full" and db._ivf is not None
    assert db._ivf_warm_blob is None
    assert db.last_query_debug()["ann_build_params"]["warm"] == "centroids"
    assert db._host_lazy and db._dev.cap > ROW_PAD
    assert db.query(vecs[7], top_k=1, ef_search=1000)[0][K_ID] == "7"
    assert torch.allclose(db._ivf.centroids, cent, atol=0.5)


@pytest.mark.parametrize("failure", ["oom", "other"])
def test_build_failures(tmp_path, monkeypatch, failure):
    """Running out of device memory during a build leaves the store exact;
    any other error raises."""
    rng = np.random.default_rng(9)
    vecs = clustered(rng, N)

    def boom(*a, **k):
        if failure == "oom":
            raise torch.cuda.OutOfMemoryError("injected")
        raise ValueError("injected")

    monkeypatch.setattr(tivf.IVFIndex, "build", classmethod(boom))
    db = picovdb_tpu_torch.PicoVectorDB(embedding_dim=DIM, index="ivf",
                                        device="cpu",
                                        storage_file=f"{tmp_path}/f")
    db.upsert_columnar(vecs, ids=[f"d{i}" for i in range(N)])
    if failure == "other":
        with pytest.raises(ValueError, match="injected"):
            db.query(vecs[0], top_k=3)
        return
    res = db.query(vecs[0], top_k=3)
    assert not db.last_query_debug()["ann_active"] and res[0][K_ID] == "d0"


@pytest.mark.parametrize("env", ["PICOVDB_SEGMAX_I8C", "PICOVDB_SMALLQ_I8C"])
def test_out_of_slice_paths_still_raise(tmp_path, monkeypatch, env):
    """`mesh=` still raises (item 8); the opt-in column-scaled tiers
    (item 9) serve beside the IVF tier: an index="ivf" store answers from
    the tier, and its exact lanes may take the column-scaled mirror."""
    with pytest.raises(NotImplementedError, match="item 8"):
        picovdb_tpu_torch.PicoVectorDB(embedding_dim=DIM, mesh=object(),
                                       index="ivf", device="cpu",
                                       storage_file=f"{tmp_path}/m")
    monkeypatch.setenv(env, "1")
    db = picovdb_tpu_torch.PicoVectorDB(embedding_dim=DIM, index="ivf",
                                        int8_tier=True, device="cpu",
                                        storage_file=f"{tmp_path}/o")
    vecs = clustered(np.random.default_rng(3), N)
    db.upsert_columnar(vecs, ids=[f"d{i}" for i in range(N)])
    assert db.query(vecs[7], top_k=3)[0][K_ID] == "d7"
    assert db.last_query_debug()["strategy"] == "ivf"
    flag = {"PICOVDB_SEGMAX_I8C": "segmax_i8c",
            "PICOVDB_SMALLQ_I8C": "smallq_i8c"}[env]
    assert getattr(db._dev, flag)
