"""Differential engine slice for the storage tiers: picovdb_tpu vs
picovdb_tpu_torch on the CPU, with bfloat16, int8 and int4 storage.

Each sequence of operations is replayed through both packages'
`PicoVectorDB` with `use_pallas=True`, so both take the kernel routes on
the CPU (JAX: Pallas interpret mode; port: the kernels' plain versions).
Per query the routes (`last_strategy`) must be identical, scores agree
within TOL_SCORE = 1e-5 (float32 dot products of the same stored rows,
summed in different orders; the host rescore's float32/float64 passes are
the same NumPy code in both), and id sets agree wherever the float64
k-th/(k+1)-th gap over the rows the route ranks (the dequantized stored
rows, or the authentic float32 rows under the host rescore) exceeds
TOL_GAP = 1e-4.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads, cpu_kw

cap_torch_threads()

K_ID, K_METRICS, K_VECTOR = (picovdb_tpu.K_ID, picovdb_tpu.K_METRICS,
                             picovdb_tpu.K_VECTOR)
PACKAGES = {"jax": picovdb_tpu, "torch": picovdb_tpu_torch}
TOL_SCORE = 1e-5
TOL_GAP = 1e-4
DIM = 64
N = 33_000  # padded capacity 40960 >= SEGMAX_MIN_CAP: the segmax tier routes


def _build(tmp, storage, n=N, rng_seed=7, **kw):
    rng = np.random.default_rng(rng_seed)
    vecs = rng.normal(size=(n, DIM)).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    meta = [{"tag": i % 5} for i in range(n)]
    dbs = {}
    for name, pkg in PACKAGES.items():
        db = pkg.PicoVectorDB(embedding_dim=DIM, storage_file=f"{tmp}/{name}",
                              storage_dtype=storage, use_pallas=True, **kw,
                              **cpu_kw(pkg))
        db.upsert_columnar(vecs, ids=ids, metadata=meta)
        dbs[name] = db
    return dbs, vecs


def _stored_rows(dev):
    """The rows a JAX DeviceIndex ranks: its plane, dequantized."""
    plane = np.asarray(dev.vectors)
    if dev.storage_dtype == "int4":
        rows = np.empty((plane.shape[0], 2 * plane.shape[1]), np.float32)
        tscan.unpack_i4_np_into(plane, rows)
    else:
        rows = plane.astype(np.float32)
    if dev.vstore_scale is not None:
        rows *= np.asarray(dev.vstore_scale)[:, None]
    return rows


def _gaps(rows, live, q, k):
    """Float64 k-th minus (k+1)-th score over the live rows, per query."""
    qn = normalize_batch(q).astype(np.float64)
    s = qn @ rows[: live.shape[0]][live].astype(np.float64).T
    s = -np.sort(-s, axis=1)
    if s.shape[1] <= k:
        return np.full(q.shape[0], np.inf)
    return s[:, k - 1] - s[:, k]


def _compare(rj, rt, gaps):
    assert len(rj) == len(rt)
    for i, (hj, ht) in enumerate(zip(rj, rt)):
        assert len(hj) == len(ht), i
        np.testing.assert_allclose([h[K_METRICS] for h in ht],
                                   [h[K_METRICS] for h in hj],
                                   rtol=0, atol=TOL_SCORE)
        if gaps[i] > TOL_GAP:
            assert {h[K_ID] for h in hj} == {h[K_ID] for h in ht}, i


def _query_both(dbs, q, **kw):
    out = {}
    for name, db in dbs.items():
        res = db.query(q, **kw)
        out[name] = res if q.ndim == 2 else [res]
        out[name + "_route"] = db.last_query_debug()["strategy"]
    assert out["jax_route"] == out["torch_route"], out
    return out


def _filter(rng, filt, n=N):
    if filt == "where":
        return {"where": {"tag": 2}}, np.arange(n) % 5 == 2
    if filt == "ids":
        allow = rng.choice(n, 3000, replace=False)
        live = np.zeros(n, bool)
        live[allow] = True
        return {"ids": [f"d{i}" for i in allow]}, live
    return {}, np.ones(n, bool)


# (Q, k, filter, the route both packages take)
CASES = {
    "int8": [(1, 10, None, "i8stor_fused_smallq"),
             (8, 10, "where", "i8stor_fused_exact"),
             (256, 10, None, "segmax_i8stor"),
             (300, 5, None, "segmax_i8stor_stream"),
             (256, 32, None, "i8stor_fused_exact"),
             (256, 10, "ids", "i8stor_fused_exact")],
    "int4": [(1, 10, None, "i4stor_fused"),
             (8, 10, "where", "i4stor_fused"),
             (256, 10, None, "i4stor_fused")],
    "bfloat16": [(1, 10, None, "xla_topk"),
                 (8, 5, "ids", "xla_topk"),
                 (256, 10, None, "pallas_fused"),
                 (64, 10, "where", "pallas_fused")],
}


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    built = {}

    def get(storage):
        if storage not in built:
            built[storage] = _build(tmp_path_factory.mktemp(storage), storage,
                                    rescore="device")
        return built[storage]

    return get


@pytest.mark.parametrize("storage,case", [
    (s, c) for s, cases in CASES.items() for c in cases])
def test_device_routes_match(stores, storage, case):
    nq, k, filt, route = case
    dbs, vecs = stores(storage)
    rng = np.random.default_rng(nq * 100 + k)
    q = (vecs[rng.integers(0, N, nq)]
         + 0.3 * rng.normal(size=(nq, DIM))).astype(np.float32)
    kw, live = _filter(rng, filt)
    got = _query_both(dbs, q if nq > 1 else q[0], top_k=k, **kw)
    assert got["torch_route"] == route
    _compare(got["jax"], got["torch"],
             _gaps(_stored_rows(dbs["jax"]._dev), live, q, k))


@pytest.mark.parametrize("storage,route", [("int8", "i8stor_xla"),
                                           ("int4", "i4stor_xla")])
def test_plain_routes_match(tmp_path, storage, route):
    """use_pallas=False: the dense plain scans of both packages (k past
    the small-batch ladder's k + 4 <= 16)."""
    rng = np.random.default_rng(1)
    vecs = rng.normal(size=(3000, DIM)).astype(np.float32)
    dbs = {}
    for name, pkg in PACKAGES.items():
        db = pkg.PicoVectorDB(embedding_dim=DIM, storage_dtype=storage,
                              storage_file=f"{tmp_path}/{name}",
                              use_pallas=False, rescore="device",
                              **cpu_kw(pkg))
        db.upsert_columnar(vecs, ids=[f"d{i}" for i in range(3000)])
        dbs[name] = db
    q = vecs[:8] + 0.2 * rng.normal(size=(8, DIM)).astype(np.float32)
    got = _query_both(dbs, q, top_k=20)
    assert got["torch_route"] == route
    _compare(got["jax"], got["torch"],
             _gaps(_stored_rows(dbs["jax"]._dev), np.ones(3000, bool), q, 20))
    loops = {n: db.query_serial_loop(q, 5) for n, db in dbs.items()}
    np.testing.assert_array_equal(loops["torch"][1], loops["jax"][1])


def test_batch_lanes_match(stores):
    """query_columnar (chunks of 256 and 44 queries, both segmax_i8stor)
    and query_batched (16-query chunks, i8stor_fused_smallq) on the int8
    store."""
    dbs, vecs = stores("int8")
    rng = np.random.default_rng(3)
    q = (vecs[rng.integers(0, N, 300)]
         + 0.3 * rng.normal(size=(300, DIM))).astype(np.float32)
    cols = {n: db.query_columnar(q, top_k=10, batch_size=256)
            for n, db in dbs.items()}
    gaps = _gaps(_stored_rows(dbs["jax"]._dev), np.ones(N, bool), q, 10)
    routes = {n: db.last_query_debug()["strategy"] for n, db in dbs.items()}
    assert routes["jax"] == routes["torch"] == "segmax_i8stor", routes
    (ij, sj), (it, st) = cols["jax"], cols["torch"]
    np.testing.assert_allclose(st, sj, rtol=0, atol=TOL_SCORE)
    for i in range(300):
        if gaps[i] > TOL_GAP:
            assert set(ij[i]) == set(it[i]), i
    bj = dbs["jax"].query_batched(q[:40], top_k=10, batch_size=16)
    bt = dbs["torch"].query_batched(q[:40], top_k=10, batch_size=16)
    _compare(bj, bt, gaps[:40])


# --------------------------------------------------------------------------
# host-f64 rescore
# --------------------------------------------------------------------------


def _neartie(rng, n, n_centers, spread=0.02):
    centers = rng.normal(size=(n_centers, DIM)).astype(np.float32)
    data = centers[rng.integers(0, n_centers, n)] + spread * rng.normal(
        size=(n, DIM)).astype(np.float32)
    return normalize_batch(data.astype(np.float32))


def _pair(tmp, data, storage, **kw):
    dbs = {}
    for name, pkg in PACKAGES.items():
        db = pkg.PicoVectorDB(embedding_dim=DIM, storage_dtype=storage,
                              storage_file=f"{tmp}/{name}", use_pallas=True,
                              **kw, **cpu_kw(pkg))
        db.upsert_columnar(data, ids=[str(i) for i in range(len(data))])
        dbs[name] = db
    return dbs


@pytest.mark.parametrize("storage,route", [("int8", "i8stor_fused_exact"),
                                           ("int4", "i4stor_fused"),
                                           ("bfloat16", "xla_topk")])
def test_host_rescore_matches(tmp_path, storage, route):
    """rescore="host": the device selects k + guard (int4: k + 4 x 128)
    candidates, the host ranks them on the authentic float32 rows."""
    rng = np.random.default_rng(4)
    data = _neartie(rng, 6000, 80)
    dbs = _pair(tmp_path, data, storage, rescore="host")
    q = data[rng.integers(0, 6000, 12)] + 0.005 * rng.normal(
        size=(12, DIM)).astype(np.float32)
    got = _query_both(dbs, q, top_k=10)
    assert got["torch_route"] == route
    for db in dbs.values():
        dbg = db.last_query_debug()
        assert dbg["rescore"] == "host"
        assert db.stats()["rescore"]["guard"] == (512 if storage == "int4"
                                                  else 128)
    _compare(got["jax"], got["torch"],
             _gaps(data, np.ones(6000, bool), q, 10))
    cols = {n: db.query_columnar(q, top_k=10) for n, db in dbs.items()}
    assert (cols["jax"][0] == cols["torch"][0]).all()


def test_rescore_saturation_escalates_in_both(tmp_path):
    """~256 near-duplicates per cluster against a 128-row guard band: the
    band saturates, both packages re-dispatch those queries 4x wider and
    serve the same exact top-k."""
    rng = np.random.default_rng(5)
    data = _neartie(rng, 4096, 16)
    dbs = _pair(tmp_path, data, "int8", rescore="host")
    q = data[rng.integers(0, 4096, 8)] + 0.005 * rng.normal(
        size=(8, DIM)).astype(np.float32)
    got = _query_both(dbs, q, top_k=10)
    esc = {n: db.stats()["rescore_escalations"] for n, db in dbs.items()}
    assert esc["torch"] == esc["jax"] > 0, esc
    _compare(got["jax"], got["torch"], _gaps(data, np.ones(4096, bool), q, 10))


def test_int8_rescore_wire_matches(tmp_path):
    """query_wire="int8_rescore": 1 B wire, k + 22 candidates, host re-rank
    (the lane of query_batched)."""
    rng = np.random.default_rng(6)
    data = normalize_batch(rng.normal(size=(5000, DIM)).astype(np.float32))
    dbs = _pair(tmp_path, data, "float32", query_wire="int8_rescore",
                mixed_precision=True, int8_tier=True)
    q = data[rng.integers(0, 5000, 300)] + 0.05 * rng.normal(
        size=(300, DIM)).astype(np.float32)
    out = {n: db.query_batched(q, top_k=10, batch_size=128)
           for n, db in dbs.items()}
    for db in dbs.values():
        assert db.last_query_debug()["rescore"] == "host-wire"
    _compare(out["jax"], out["torch"], _gaps(data, np.ones(5000, bool), q, 10))


# --------------------------------------------------------------------------
# mutations, device-born ingest
# --------------------------------------------------------------------------


@pytest.mark.parametrize("storage", ["int8", "int4"])
def test_mutation_sequence_matches(tmp_path, storage):
    """upsert -> query -> delete -> query -> upsert into freed slots ->
    vacuum -> query, compared step by step (device ranking)."""
    n = 9000
    dbs, vecs = _build(str(tmp_path), storage, n=n, rng_seed=11,
                       rescore="device")
    rng = np.random.default_rng(5)
    live = np.ones(n, bool)

    def check(nq, k, rows_live):
        q = (vecs[rng.integers(0, vecs.shape[0], nq)]
             + 0.3 * rng.normal(size=(nq, DIM))).astype(np.float32)
        got = _query_both(dbs, q, top_k=k)
        _compare(got["jax"], got["torch"],
                 _gaps(_stored_rows(dbs["jax"]._dev), rows_live, q, k))

    check(64, 10, live)
    gone = rng.choice(n, 700, replace=False)
    for db in dbs.values():
        assert len(db.delete([f"d{i}" for i in gone])) == 700
    live[gone] = False
    check(8, 10, live)
    for db in dbs.values():  # deleted rows never come back
        hits = db.query(vecs[gone[:4]], top_k=10)
        assert not {h[K_ID] for r in hits for h in r} & {f"d{i}" for i in gone}
    fresh = rng.normal(size=(300, DIM)).astype(np.float32)
    for db in dbs.values():
        rep = db.upsert([{K_ID: f"n{i}", K_VECTOR: fresh[i]}
                         for i in range(300)])
        assert len(rep["insert"]) == 300
    for db in dbs.values():
        db.vacuum()
        assert db.count() == n - 700 + 300
    vecs = np.concatenate([vecs[live], fresh])
    check(8, 5, np.ones(vecs.shape[0], bool))
    assert dbs["jax"].get_all() == dbs["torch"].get_all()


def _ingest_both(tmp, storage, rows, prequantized=False, **kw):
    ids = [f"g{i}" for i in range(rows.shape[0])]
    dbs = {}
    for name, pkg in PACKAGES.items():
        db = pkg.PicoVectorDB(embedding_dim=DIM, storage_dtype=storage,
                              storage_file=f"{tmp}/{name}", use_pallas=True,
                              **cpu_kw(pkg))
        if prequantized:
            if name == "jax":
                quant = (jps.quantize_rows_i4 if storage == "int4"
                         else jps.quantize_rows_i8)
                plane, scale = quant(jnp.asarray(rows))
            else:
                quant = (tscan.quantize_rows_i4 if storage == "int4"
                         else tscan.quantize_rows_i8)
                plane, scale = quant(torch.from_numpy(rows))
            db.ingest_device(plane, ids, scales=scale, normalize=False, **kw)
        else:
            x = (jnp.asarray(rows) if name == "jax"
                 else torch.from_numpy(rows.copy()))
            db.ingest_device(x, ids, **kw)
        dbs[name] = db
    return dbs


@pytest.mark.parametrize("storage", ["int8", "int4"])
def test_ingest_device_prequantized_matches(tmp_path, storage):
    """Pre-quantized device-born rows (scales=): lazy host, device
    ranking; dequantized getters equal; overlay mutations; then a
    quantized save of each loads in the other package."""
    rng = np.random.default_rng(8)
    rows = normalize_batch(rng.normal(size=(5000, DIM)).astype(np.float32))
    dbs = _ingest_both(tmp_path, storage, rows, prequantized=True)
    q = rows[:8] + 0.1 * rng.normal(size=(8, DIM)).astype(np.float32)
    live = np.ones(5000, bool)
    got = _query_both(dbs, q, top_k=10)
    _compare(got["jax"], got["torch"],
             _gaps(_stored_rows(dbs["jax"]._dev), live, q, 10))
    for db in dbs.values():
        assert db.last_query_debug()["rescore"] is None  # lazy: device only
    gj = dbs["jax"].get([f"g{i}" for i in range(20)], include_vector=True)
    gt = dbs["torch"].get([f"g{i}" for i in range(20)], include_vector=True)
    for a, b in zip(gj, gt):
        np.testing.assert_array_equal(b[K_VECTOR], a[K_VECTOR])
    new = rng.normal(size=(3, DIM)).astype(np.float32)
    for db in dbs.values():
        db.delete(["g1", "g2"])
        db.upsert([{K_ID: f"x{i}", K_VECTOR: new[i]} for i in range(3)])
    live[[1, 2]] = False
    got = _query_both(dbs, new, top_k=3)
    assert [r[0][K_ID] for r in got["torch"]] == ["x0", "x1", "x2"]
    _compare(got["jax"], got["torch"], np.full(3, np.inf))
    for db in dbs.values():
        np.testing.assert_array_equal(db.get("x0", include_vector=True)[K_VECTOR],
                                      normalize_batch(new)[0])
        db.save(quantized=True)
    for writer, reader in (("jax", "torch"), ("torch", "jax")):
        r = PACKAGES[reader].PicoVectorDB(
            embedding_dim=DIM, storage_dtype=storage,
            storage_file=f"{tmp_path}/{writer}", use_pallas=True,
            **cpu_kw(PACKAGES[reader]))
        # listing order follows slot reuse, so compare by id
        a = {x[K_ID]: x for x in dbs[writer].get_all(include_vector=True)}
        b = {x[K_ID]: x for x in r.get_all(include_vector=True)}
        assert sorted(a) == sorted(b) and len(a) == 5001
        for key, x in a.items():
            np.testing.assert_array_equal(x[K_VECTOR], b[key][K_VECTOR])


@pytest.mark.parametrize("storage", ["int8", "int4", "bfloat16"])
def test_ingest_device_host_shadow_matches(tmp_path, storage):
    """host_shadow=True keeps the authentic normalized float32 rows on the
    host, so the host-f64 rescore serves the device-born lossy store."""
    rng = np.random.default_rng(9)
    rows = rng.normal(size=(4000, DIM)).astype(np.float32)
    dbs = _ingest_both(tmp_path, storage, rows, host_shadow=True)
    q = rows[:10] + 0.2 * rng.normal(size=(10, DIM)).astype(np.float32)
    got = _query_both(dbs, q, top_k=10)
    for db in dbs.values():
        assert db.last_query_debug()["rescore"] == "host"
    _compare(got["jax"], got["torch"],
             _gaps(normalize_batch(rows), np.ones(4000, bool), q, 10))
    gj = dbs["jax"].get(["g3"], include_vector=True)[0][K_VECTOR]
    gt = dbs["torch"].get(["g3"], include_vector=True)[0][K_VECTOR]
    np.testing.assert_allclose(gt, gj, rtol=0, atol=1e-7)


def test_ingest_device_rejects_bad_inputs(tmp_path):
    db = picovdb_tpu_torch.PicoVectorDB(embedding_dim=DIM, storage_dtype="int4",
                                        storage_file=str(tmp_path / "s"),
                                        device="cpu")
    rows = torch.nn.functional.normalize(torch.randn(10, DIM), dim=1)
    v4, vs = tscan.quantize_rows_i4(rows)
    ids = [str(i) for i in range(10)]
    with pytest.raises(ValueError, match="normalize=False"):
        db.ingest_device(v4, ids, scales=vs)
    with pytest.raises(ValueError, match="host_shadow"):
        db.ingest_device(v4, ids, scales=vs, normalize=False, host_shadow=True)
    with pytest.raises(ValueError, match="one per row"):
        db.ingest_device(v4, ids, scales=vs[:-1], normalize=False)
    with pytest.raises(ValueError, match="unique"):
        db.ingest_device(v4, ["a"] * 10, scales=vs, normalize=False)
    db.ingest_device(v4, ids, scales=vs, normalize=False)
    with pytest.raises(ValueError, match="empty"):
        db.ingest_device(v4, ids, scales=vs, normalize=False)


# --------------------------------------------------------------------------
# the compacted filter view
# --------------------------------------------------------------------------


def _fview_pair(tmp, n=9000):
    rng = np.random.default_rng(12)
    vecs = rng.normal(size=(n, DIM)).astype(np.float32)
    dbs = {}
    for name, pkg in PACKAGES.items():
        db = pkg.PicoVectorDB(embedding_dim=DIM, storage_file=f"{tmp}/{name}",
                              mixed_precision=True, int8_tier=True,
                              use_pallas=True, **cpu_kw(pkg))
        db._dev.SEGMAX_MIN_CAP = 1024  # segmax otherwise needs 32k rows
        db.upsert_columnar(vecs, ids=[f"d{i}" for i in range(n)],
                           metadata=[{"tag": i % 2, "t5": i % 5}
                                     for i in range(n)])
        dbs[name] = db
    return dbs, vecs, rng


@pytest.mark.parametrize("nq,route", [(256, "fview_segmax"),
                                      (300, "fview_segmax_stream")])
def test_filter_view_route_matches(tmp_path, nq, route):
    dbs, vecs, rng = _fview_pair(tmp_path)
    q = (vecs[rng.integers(0, 9000, nq)]
         + 0.3 * rng.normal(size=(nq, DIM))).astype(np.float32)
    got = _query_both(dbs, q, top_k=10, where={"tag": 1})
    assert got["torch_route"] == route
    assert all(int(h[K_ID][1:]) % 2 == 1 for r in got["torch"] for h in r)
    _compare(got["jax"], got["torch"],
             _gaps(normalize_batch(vecs), np.arange(9000) % 2 == 1, q, 10))
    # the view is cached per filter and reused by the next batch
    cache = dbs["torch"]._dev._fview_cache
    assert len(cache) == 1
    got = _query_both(dbs, q, top_k=10, where={"tag": 1})
    assert len(cache) == 1 and got["torch_route"] == route


def test_refused_filter_views_stay_bounded(tmp_path, monkeypatch):
    """Every view refused (budget 0): rotating filters keep the cache at
    FVIEW_CACHE_MAX, refusals and views alike (picovdb_tpu caches a
    refusal without evicting, so its cache grows per filter)."""
    monkeypatch.setenv("PICOVDB_FVIEW_BUDGET_GB", "0")
    dbs, vecs, rng = _fview_pair(tmp_path)
    q = vecs[:32] + 0.1
    dev = dbs["torch"]._dev
    for t in range(5):
        got = _query_both(dbs, q, top_k=10, where={"t5": t})
        assert got["torch_route"] == "mixed_fused_batch_filtered"
        assert len(dev._fview_cache) <= dev.FVIEW_CACHE_MAX
    assert len(dev._fview_cache) == dev.FVIEW_CACHE_MAX
    assert all(v is None for v in dev._fview_cache.values())
    monkeypatch.delenv("PICOVDB_FVIEW_BUDGET_GB")
    got = _query_both(dbs, q, top_k=10, where={"tag": 0})
    assert got["torch_route"] == "fview_segmax"
    assert len(dev._fview_cache) == dev.FVIEW_CACHE_MAX
    assert sum(v is not None for v in dev._fview_cache.values()) == 1


@pytest.mark.parametrize("storage", ["int8", "int4"])
def test_device_index_takes_the_jax_quantized_state(storage):
    """DeviceIndex.from_numpy_state adopts picovdb_tpu's quantized plane
    and row scales as they are; the port's own full_upload builds the
    same plane bit for bit; both answer like the JAX DeviceIndex on the
    dispatch path, the exact snapshot and the serial loop."""
    from picovdb_tpu.device import DeviceIndex as JaxDeviceIndex
    from picovdb_tpu_torch.device import DeviceIndex

    rng = np.random.default_rng(13)
    n = 8000
    vecs = normalize_batch(rng.normal(size=(n, DIM)).astype(np.float32))
    active = rng.random(n) > 0.1
    jdev = JaxDeviceIndex(DIM, storage_dtype=storage, use_pallas=True)
    jdev.full_upload(vecs, active)
    plane = np.asarray(jdev.vectors)[:n]
    scale = np.asarray(jdev.vstore_scale)[:n]
    tdev = DeviceIndex(DIM, storage_dtype=storage, use_pallas=True, device="cpu")
    tdev.from_numpy_state(plane, active, scale)
    own = DeviceIndex(DIM, storage_dtype=storage, use_pallas=True, device="cpu")
    own.full_upload(vecs, active)
    for dev in (tdev, own):
        np.testing.assert_array_equal(dev.vectors[:n].numpy(), plane)
        np.testing.assert_array_equal(dev.vstore_scale[:n].numpy(), scale)
        assert dev.cap == jdev.cap
    q = vecs[:24] + 0.1 * rng.normal(size=(24, DIM)).astype(np.float32)
    rows = _stored_rows(jdev)[:n]
    for nq, k in ((8, 10), (24, 10)):
        jv, ji = jdev.query(q[:nq], k)
        tv, ti = tdev.query(q[:nq], k)
        assert tdev.last_strategy == jdev.last_strategy
        _compare_arrays(jv, ji, tv, ti, _gaps(rows, active, q[:nq], k))
    jv, ji = jdev.query_exact_snapshot(jdev.snapshot(), q, 12)
    tv, ti = tdev.query_exact_snapshot(tdev.snapshot(), q, 12)
    _compare_arrays(jv, ji, tv, ti, _gaps(rows, active, q, 12))
    jv, ji = jdev.query_serial_loop(q[:4], 5)
    tv, ti = tdev.query_serial_loop(q[:4], 5)
    assert tdev.last_strategy == jdev.last_strategy
    _compare_arrays(jv, ji, tv, ti, _gaps(rows, active, q[:4], 5))


def _compare_arrays(jv, ji, tv, ti, gaps):
    np.testing.assert_allclose(tv, jv, rtol=0, atol=TOL_SCORE)
    for i in range(jv.shape[0]):
        if gaps[i] > TOL_GAP:
            assert set(ti[i].tolist()) == set(np.asarray(ji)[i].tolist()), i
