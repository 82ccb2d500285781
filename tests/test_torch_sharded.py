"""Row-sharded stores (`mesh=`): picovdb_tpu vs picovdb_tpu_torch on the CPU.

The case-by-case counterpart of tests/test_sharded.py. The same numpy
inputs go through picovdb_tpu on its 8-device virtual CPU mesh (K3 / K4 /
K6 in Pallas interpret mode where the kernels are asked for) and through
the port on meshes of repeated CPU devices: 8 shards, 4 shards, and dp = 2
x 4 shards (the query batch split over two mesh rows). Scores agree within
TOL_SCORE = 1e-5 absolute; ids are compared through the store's ids (slot
order is LIFO), and must be equal wherever the float64 k-th / (k+1)-th
gap exceeds TOL_GAP = 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.parallel import make_mesh as jax_mesh
from picovdb_tpu.parallel.sharded_query import make_sharded_topk as jax_topk
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch import device as tdevice
from picovdb_tpu_torch.constants import ROW_PAD
from picovdb_tpu_torch.parallel import make_mesh
from picovdb_tpu_torch.parallel import sharded_query as tsq
from torch_port_setup import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-device virtual mesh")

K_ID, K_METRICS, K_VECTOR = (picovdb_tpu.K_ID, picovdb_tpu.K_METRICS,
                             picovdb_tpu.K_VECTOR)
TOL_SCORE = 1e-5
TOL_GAP = 1e-5
CPU = torch.device("cpu")
# the port's meshes: (dp, shards) over repeated CPU devices
MESHES = {"8": (1, 8), "4": (1, 4), "dp2x4": (2, 4)}


def port_mesh(name):
    dp, shards = MESHES[name]
    return make_mesh(shards, devices=[CPU] * (dp * shards), dp=dp)


def split(arr, shards):
    """A host plane as per-shard CPU tensors."""
    return [torch.from_numpy(np.array(a, order="C"))
            for a in np.split(np.asarray(arr), shards)]


def per_row(mesh, *planes):
    """Per-shard planes as make_sharded_topk takes them: one list per mesh
    row (every row of these meshes is on the same device)."""
    return [[p] * mesh.shape["dp"] for p in planes]


def gap_ok(exact_row, k):
    """Whether the k-th / (k+1)-th gap of a row's exact scores (float64,
    -inf masked) leaves the top-k set well defined."""
    s = np.sort(exact_row[np.isfinite(exact_row)])[::-1]
    return s.shape[0] <= k or s[k - 1] - s[k] > TOL_GAP


def assert_same(got, want, exact, k):
    """(vals, ids) pairs agree: scores within TOL_SCORE, ids equal where
    the gap allows (else the same scores suffice)."""
    gv, gi = got
    wv, wi = want
    np.testing.assert_allclose(gv, wv, rtol=0, atol=TOL_SCORE)
    for r in range(gv.shape[0]):
        if gap_ok(exact[r], k):
            assert sorted(gi[r]) == sorted(wi[r]), r


# ---------------------------------------------------------------------------
# the mesh and the sharded top-k
# ---------------------------------------------------------------------------


def test_mesh_shapes():
    mesh = make_mesh(devices=[CPU] * 8)
    assert mesh.shape["shard"] == 8 and mesh.shape["dp"] == 1
    mesh2 = make_mesh(devices=[CPU] * 8, dp=2)
    assert mesh2.shape["dp"] == 2 and mesh2.shape["shard"] == 4
    assert mesh2.devices.shape == (2, 4) and mesh2.size == 8
    jm = jax_mesh(dp=2)
    assert dict(jm.shape) == mesh2.shape


def test_make_mesh_never_falls_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ValueError):
        make_mesh(4, devices=[CPU] * 3)


def _topk_inputs(rng, n, dim, storage):
    vectors = normalize_batch(rng.normal(size=(n, dim)).astype(np.float32))
    queries = normalize_batch(rng.normal(size=(16, dim)).astype(np.float32))
    mask = rng.random(n) > 0.25
    planes = [vectors]
    if storage == "bfloat16":  # the bf16 rows both packages store
        planes = [torch.from_numpy(vectors).to(torch.bfloat16).float().numpy()]
    if storage in ("int8", "int4"):
        quant = jps.quantize_rows_i4 if storage == "int4" else jps.quantize_rows_i8
        vq, vs = (np.asarray(a) for a in quant(vectors))
        planes = [vq, vs]
    return queries, planes, mask


_JAX_TOPK = {}


def _jax_sharded(storage, use_pallas, queries, planes, mask, k):
    """picovdb_tpu's sharded top-k on its 8-device mesh (one run per case:
    its interpret-mode kernels are the slow half of these tests)."""
    key = (storage, use_pallas)
    if key not in _JAX_TOPK:
        from jax.sharding import NamedSharding, PartitionSpec as P

        mesh = jax_mesh()
        row = NamedSharding(mesh, P("shard", None))
        vec = NamedSharding(mesh, P("shard"))
        args = [jax.device_put(queries, NamedSharding(mesh, P()))]
        args.append(jax.device_put(
            planes[0].astype(jax.numpy.bfloat16) if storage == "bfloat16"
            else planes[0], row))
        if len(planes) == 2:
            args.append(jax.device_put(planes[1], vec))
        args.append(jax.device_put(mask, vec))
        fn = jax_topk(mesh, "shard", k, use_pallas=use_pallas,
                      interpret=use_pallas, storage_i8=storage == "int8",
                      storage_i4=storage == "int4",
                      compute_dtype_name=("bfloat16" if storage == "bfloat16"
                                          else None))
        _JAX_TOPK[key] = tuple(np.asarray(a) for a in fn(*args))
    return _JAX_TOPK[key]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8", "int4"])
def test_sharded_topk_matches_jax(mesh_name, use_pallas, storage):
    rng = np.random.default_rng(7)
    n, dim, k = 128 * 8, 64, 7
    queries, planes, mask = _topk_inputs(rng, n, dim, storage)
    want = _jax_sharded(storage, use_pallas, queries, planes, mask, k)
    mesh = port_mesh(mesh_name)
    shards = mesh.shape["shard"]
    tplanes = [split(p, shards) for p in planes]
    if storage == "bfloat16":
        tplanes[0] = [t.to(torch.bfloat16) for t in tplanes[0]]
    fn = tsq.make_sharded_topk(
        mesh, "shard", k, use_pallas=use_pallas,
        storage_i8=storage == "int8", storage_i4=storage == "int4",
        compute_dtype_name="bfloat16" if storage == "bfloat16" else None)
    vals, idxs = fn(torch.from_numpy(queries),
                    *per_row(mesh, *tplanes, split(mask, shards)))
    assert vals.shape == (16, k) and idxs.dtype == torch.int32
    if storage in ("int8", "int4"):
        # the ranking the route serves: dequantized storage rows
        deq = (np.asarray(jps.unpack_i4(planes[0])) if storage == "int4"
               else planes[0]).astype(np.float64) * planes[1][:, None]
    else:
        deq = planes[0].astype(np.float64)
    exact = np.where(mask[None, :], queries.astype(np.float64) @ deq.T, -np.inf)
    assert_same((vals.numpy(), idxs.numpy()), want, exact, k)


def test_merge_breaks_ties_to_the_lower_slot():
    """Equal scores on several shards: the merge keeps the lowest global
    slots, as JAX's stable top_k over its shard-ordered slab does; a
    missing candidate (slot -1) ranks after every real one."""
    vals = [torch.tensor([[0.5, 0.5, -np.inf]], dtype=torch.float32)] * 3
    slots = [torch.tensor([[s * 10 + 3, s * 10 + 1, -1]], dtype=torch.int32)
             for s in (2, 0, 1)]
    v, sl = tsq.merge_topk(vals, slots, 7, CPU)
    assert sl.tolist() == [[1, 3, 11, 13, 21, 23, -1]]
    assert v[0, :6].tolist() == [0.5] * 6 and np.isneginf(v[0, 6].item())


def test_shards_enqueue_before_any_host_read(monkeypatch):
    """No host read between shards: every shard's selection is made
    before the first result is copied off the device (counted on the
    plain version's calls; the copies to the merge device are not
    reads)."""
    calls, reads = [], []
    real = tsq.fused_topk_i8
    monkeypatch.setattr(tsq, "fused_topk_i8", lambda *a: (
        calls.append(len(reads)), real(*a))[1])
    for name in ("item", "cpu", "tolist"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, _o=orig, **kw:
                            (reads.append(1), _o(self, *a, **kw))[1])
    rng = np.random.default_rng(1)
    queries, planes, mask = _topk_inputs(rng, 512, 32, "int8")
    mesh = port_mesh("8")
    fn = tsq.make_sharded_topk(mesh, "shard", 5, use_pallas=True,
                               storage_i8=True, normalize=False)
    fn(torch.from_numpy(queries),
       *per_row(mesh, *[split(p, 8) for p in planes], split(mask, 8)))
    assert calls == [0] * 8


@pytest.mark.parametrize("mesh_name", ["4", "dp2x4"])
@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_queries_reach_every_shard_before_any_scan(monkeypatch, mesh_name,
                                                    storage):
    """Every copy of the queries to a shard's device is enqueued before
    the first shard's scan: a copy across cards runs on the source card's
    stream, so one made after shard 0's scan would wait for it and the
    shards on the other cards would start only when it ends."""
    events = []
    real_to = torch.Tensor.to
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **kw: (
        events.append("copy"), real_to(self, *a, **kw))[1])
    for name in ("_local_float", "_local_quant"):
        real = getattr(tsq, name)
        monkeypatch.setattr(tsq, name, lambda *a, _r=real: (
            events.append("scan"), _r(*a))[1])
    rng = np.random.default_rng(2)
    queries, planes, mask = _topk_inputs(rng, 512, 32, storage)
    mesh = port_mesh(mesh_name)
    shards = mesh.shape["shard"]
    fn = tsq.make_sharded_topk(mesh, "shard", 5, use_pallas=True,
                               storage_i8=storage == "int8", normalize=False)
    fn(torch.from_numpy(queries),
       *per_row(mesh, *[split(p, shards) for p in planes], split(mask, shards)))
    first = events.index("scan")
    per_copy = 2 if storage == "int8" else 1  # the int8 queries go too
    assert events[:first].count("copy") >= (
        1 + per_copy * shards * mesh.shape["dp"])
    assert events.count("scan") == shards * mesh.shape["dp"]


# ---------------------------------------------------------------------------
# engine: PicoVectorDB(mesh=...) against picovdb_tpu's mesh store
# ---------------------------------------------------------------------------


def _exact(db_vecs, live, q):
    qn = normalize_batch(np.atleast_2d(q).astype(np.float32)).astype(np.float64)
    return np.where(live[None, :], qn @ db_vecs.astype(np.float64).T, -np.inf)


def _engine_scenario(db, rng_seed=3):
    """upsert -> query (batch, filter) -> delete -> re-upsert ->
    query_columnar; returns every answer, the routes, and what the float64
    oracle needs."""
    rng = np.random.default_rng(rng_seed)
    dim, n, k = 32, 300, 6
    vecs = normalize_batch(rng.normal(size=(n, dim)).astype(np.float32))
    qs = rng.normal(size=(5, dim)).astype(np.float32)
    db.upsert([{K_ID: f"id{i}", K_VECTOR: vecs[i], "tag": i % 3}
               for i in range(n)])
    out = {"k": k, "batch": db.query(qs, top_k=k)}
    out["route"] = db._last_topk_strategy
    out["filtered"] = db.query(qs, top_k=k, where={"tag": 1})
    db.delete(["id3", "id5", "id100"])
    db.upsert([{K_ID: "late", K_VECTOR: qs[0], "tag": 0}])
    out["late"] = db.query(qs[0], top_k=1)[0][K_ID]
    out["columnar"] = db.query_columnar(qs, top_k=k)
    out["sharded"] = db.stats()["sharded"]
    live = np.ones(n + 1, bool)
    live[[3, 5, 100]] = False
    out["exact"] = (_exact(vecs, np.ones(n, bool), qs),
                    _exact(vecs, np.arange(n) % 3 == 1, qs),
                    _exact(np.vstack([vecs, normalize_batch(qs[:1])]), live, qs))
    return out


def _assert_hits(got, want, exact, k):
    for r, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose([h[K_METRICS] for h in g],
                                   [h[K_METRICS] for h in w],
                                   rtol=0, atol=TOL_SCORE)
        if gap_ok(exact[r], k):
            assert sorted(h[K_ID] for h in g) == sorted(h[K_ID] for h in w)


_JAX_ENGINE = {}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("scan_mode", ["auto", "fused"])
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8", "int4"])
def test_sharded_engine_matches_jax(tmp_path, mesh_name, scan_mode, storage):
    """The same operations through picovdb_tpu's mesh store (run once per
    storage and mode) and the port's: routes, scores and ids agree."""
    key = (storage, scan_mode)
    if key not in _JAX_ENGINE:
        _JAX_ENGINE[key] = _engine_scenario(picovdb_tpu.PicoVectorDB(
            embedding_dim=32, storage_file=f"{tmp_path}/jax", mesh=jax_mesh(),
            storage_dtype=storage, scan_mode=scan_mode))
    want = _JAX_ENGINE[key]
    got = _engine_scenario(picovdb_tpu_torch.PicoVectorDB(
        embedding_dim=32, storage_file=f"{tmp_path}/torch",
        mesh=port_mesh(mesh_name), storage_dtype=storage, scan_mode=scan_mode))
    k = want["k"]
    assert got["route"] == want["route"]
    assert got["route"].startswith("sharded_scan")
    _assert_hits(got["batch"], want["batch"], want["exact"][0], k)
    _assert_hits(got["filtered"], want["filtered"], want["exact"][1], k)
    assert all(h["tag"] == 1 for hits in got["filtered"] for h in hits)
    assert got["late"] == want["late"] == "late"
    np.testing.assert_allclose(got["columnar"][1], want["columnar"][1],
                               rtol=0, atol=TOL_SCORE)
    for r in range(5):
        if gap_ok(want["exact"][2][r], k):
            assert (sorted(got["columnar"][0][r])
                    == sorted(want["columnar"][0][r]))
    assert got["sharded"] and want["sharded"]


_JAX_SCATTER = {}


def _scatter_scenario(db):
    rng = np.random.default_rng(5)
    dim, n = 32, 4096
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    db.upsert([{K_ID: f"id{i}", K_VECTOR: vecs[i]} for i in range(n)])
    db.query(vecs[0], top_k=1)  # the first sync: a full upload
    db.upsert([{K_ID: f"id{i}", K_VECTOR: rng.normal(size=dim).astype(
        np.float32)} for i in range(0, n, 200)])
    db.delete(["id7", "id1234"])
    return db.query(rng.normal(size=(5, dim)).astype(np.float32), top_k=8)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_sharded_incremental_scatter_sync_parity(tmp_path, mesh_name):
    """A small mutation epoch scatters to the owner shards (incremental
    sync) and answers as picovdb_tpu's mesh store and a single-device
    port store do."""
    if "jax" not in _JAX_SCATTER:
        _JAX_SCATTER["jax"] = _scatter_scenario(picovdb_tpu.PicoVectorDB(
            embedding_dim=32, storage_file=f"{tmp_path}/j", mesh=jax_mesh()))
    tdb = picovdb_tpu_torch.PicoVectorDB(
        embedding_dim=32, storage_file=f"{tmp_path}/t",
        mesh=port_mesh(mesh_name))
    rt = _scatter_scenario(tdb)
    assert tdb._last_sync_mode == "incremental"
    assert tdb._dev.last_sync_mode == "scatter"
    rs = _scatter_scenario(picovdb_tpu_torch.PicoVectorDB(
        embedding_dim=32, storage_file=f"{tmp_path}/s", device="cpu"))
    for a, b, c in zip(rt, _JAX_SCATTER["jax"], rs):
        assert ([h[K_ID] for h in a] == [h[K_ID] for h in b]
                == [h[K_ID] for h in c])
        np.testing.assert_allclose([h[K_METRICS] for h in a],
                                   [h[K_METRICS] for h in b], atol=TOL_SCORE)
    assert all(h[K_ID] not in ("id7", "id1234") for hits in rt for h in hits)


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_dp_row_copies_take_the_scatter(tmp_path, monkeypatch, storage):
    """A dp row on other devices than row 0 serves its part of a batch
    from its own copy of the planes (here: row 1 of a dp = 2 x 4 CPU mesh
    is taken to differ, so its copies are real clones). A small mutation
    epoch writes the same rows into those copies, which are kept, not made
    again; the answers equal a single-device store's."""
    monkeypatch.setattr(tdevice.DeviceIndex, "_row_differs",
                        lambda self, r: r > 0)
    rng = np.random.default_rng(11)
    dim, n = 32, 4096
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    qs = rng.normal(size=(6, dim)).astype(np.float32)
    dbs = [picovdb_tpu_torch.PicoVectorDB(
        embedding_dim=32, storage_file=f"{tmp_path}/{name}",
        storage_dtype=storage, **kw)
        for name, kw in (("mesh", {"mesh": port_mesh("dp2x4")}),
                         ("one", {"device": "cpu"}))]
    answers = []
    for db in dbs:
        db.upsert([{K_ID: f"id{i}", K_VECTOR: vecs[i]} for i in range(n)])
        answers.append([db.query(qs, top_k=8)])
    dev = dbs[0]._dev
    planes = [p for p in (dev.vectors, dev.vstore_scale, dev.active)
              if p is not None]
    copies = [dev.mesh_planes(p)[1] for p in planes]
    assert all(c is not p and all(a is not b for a, b in zip(c, p))
               for c, p in zip(copies, planes))
    moved = [rng.normal(size=dim).astype(np.float32) for _ in range(0, n, 300)]
    for db, out in zip(dbs, answers):
        db.upsert([{K_ID: f"id{i}", K_VECTOR: v}
                   for i, v in zip(range(0, n, 300), moved)])
        db.delete(["id5", "id2001"])
        db.upsert([{K_ID: "late", K_VECTOR: qs[4]}])  # served by row 1
        out.append(db.query(qs, top_k=8))
    assert dev.last_sync_mode == "scatter"
    for p, c in zip(planes, copies):
        assert dev.mesh_planes(p)[1] is c
        assert all(torch.equal(a, b) for a, b in zip(p, c))
    for got, want in zip(*answers):
        for g, w in zip(got, want):
            assert [h[K_ID] for h in g] == [h[K_ID] for h in w]
            np.testing.assert_allclose([h[K_METRICS] for h in g],
                                       [h[K_METRICS] for h in w],
                                       rtol=0, atol=TOL_SCORE)
    assert answers[0][1][4][0][K_ID] == "late"


def test_mesh_grow_moves_rows_between_shards(tmp_path):
    """An append epoch that crosses the capacity bucket grows a device-born
    mesh store in place: shard boundaries move (rows change owner), the
    store stays lazy and serves picovdb_tpu's answers."""
    rng = np.random.default_rng(9)
    mesh = port_mesh("8")
    base_cap = ROW_PAD * 8
    dim, n = 8, base_cap - 64
    vecs = normalize_batch(rng.normal(size=(n, dim)).astype(np.float32))
    db = picovdb_tpu_torch.PicoVectorDB(embedding_dim=dim,
                                        storage_file=f"{tmp_path}/t", mesh=mesh)
    db.ingest_device(torch.from_numpy(vecs), ids=[str(i) for i in range(n)],
                     normalize=False)
    assert db._dev.cap == base_cap
    db.query(vecs[0])
    extra = normalize_batch(rng.normal(size=(128, dim)).astype(np.float32))
    db.upsert([{K_ID: f"x{i}", K_VECTOR: extra[i]} for i in range(128)])
    assert db.query(extra[2], top_k=1)[0][K_ID] == "x2"
    assert db._last_sync_mode == "incremental"
    assert db._dev.cap > base_cap and db._dev.cap % 8 == 0
    assert db._host_lazy
    rl = db._dev.shard_rows
    assert all(t.shape[0] == rl for t in db._dev.vectors + db._dev.active)
    # every row kept its slot across the re-split
    np.testing.assert_array_equal(db._dev.fetch_rows(np.arange(n)), vecs)
    np.testing.assert_allclose(  # upsert normalizes them once more
        db._dev.fetch_rows(np.arange(n, n + 128)), extra, rtol=0, atol=1e-6)
    jdb = picovdb_tpu.PicoVectorDB(embedding_dim=dim,
                                   storage_file=f"{tmp_path}/j", mesh=jax_mesh())
    jdb.ingest_device(jax.numpy.asarray(vecs), ids=[str(i) for i in range(n)],
                      normalize=False)
    jdb.query(vecs[0])
    jdb.upsert([{K_ID: f"x{i}", K_VECTOR: extra[i]} for i in range(128)])
    q = np.vstack([vecs[9], extra[5], rng.normal(size=dim)]).astype(np.float32)
    ids_t, sc_t = db.query_columnar(q, top_k=4)
    ids_j, sc_j = jdb.query_columnar(q, top_k=4)
    np.testing.assert_array_equal(ids_t, ids_j)
    np.testing.assert_allclose(sc_t, sc_j, atol=TOL_SCORE)


@pytest.mark.parametrize("which", ["corpus", "active", "scales"])
def test_mesh_grow_out_of_memory_keeps_the_store_consistent(tmp_path,
                                                           monkeypatch, which):
    """A failed allocation in the mesh grow (injected into `_reshard` by
    plane) ends as tests/test_torch_grow.py's single-device cases: the
    corpus fails -> nothing changed; the mask or scales fail -> every
    plane dropped and the next sync re-uploads; the query answers as a
    store that never failed."""
    rng = np.random.default_rng(11)
    dim, n = 16, ROW_PAD * 4 - 10
    base = normalize_batch(rng.normal(size=(n, dim)).astype(np.float32))
    extra = normalize_batch(rng.normal(size=(40, dim)).astype(np.float32))
    pick = {"corpus": lambda t: t.dtype == torch.int8 and t.ndim == 2,
            "active": lambda t: t.dtype == torch.bool,
            "scales": lambda t: t.dtype == torch.float32}[which]
    dbs = []
    for name in ("ref", "db"):
        db = picovdb_tpu_torch.PicoVectorDB(
            embedding_dim=dim, storage_file=f"{tmp_path}/{name}",
            mesh=port_mesh("4"), storage_dtype="int8", rescore="device")
        db.upsert_columnar(base, ids=[f"b{i}" for i in range(n)])
        db.query(base[0], top_k=3)
        db.upsert_columnar(extra, ids=[f"e{i}" for i in range(40)])
        dbs.append(db)
    want = dbs[0].query(extra[:4], top_k=5)
    real = tdevice._reshard

    def failing(planes, rows, devices):
        if pick(planes[0]):
            raise torch.cuda.OutOfMemoryError("injected: device memory")
        return real(planes, rows, devices)

    cap0 = dbs[1]._dev.cap
    monkeypatch.setattr(tdevice, "_reshard", failing)
    assert dbs[1]._dev.grow(n + 40) is False
    if which == "corpus":
        assert dbs[1]._dev.cap == cap0 and len(dbs[1]._dev.vectors) == 4
    else:
        assert dbs[1]._dev.vectors is None and dbs[1]._dev.active is None
    got = dbs[1].query(extra[:4], top_k=5)
    assert dbs[1]._last_sync_mode == "full"
    for hw, hg in zip(want, got):
        assert [h[K_ID] for h in hg] == [h[K_ID] for h in hw]
        np.testing.assert_allclose([h[K_METRICS] for h in hg],
                                   [h[K_METRICS] for h in hw], atol=1e-6)


@pytest.mark.parametrize("storage", ["float32", "int8"])
def test_sharded_save_shards4_crossloads_with_jax(tmp_path, storage):
    """A picovdb_tpu mesh store saved with save(shards=4) loads into a port
    mesh store and serves the same ids, and the reverse."""
    rng = np.random.default_rng(13)
    dim, n, k = 32, 700, 5
    vecs = normalize_batch(rng.normal(size=(n, dim)).astype(np.float32))
    items = [{K_ID: f"id{i}", K_VECTOR: vecs[i], "tag": i % 2} for i in range(n)]
    q = rng.normal(size=(6, dim)).astype(np.float32)
    for src, dst in ((picovdb_tpu, picovdb_tpu_torch),
                     (picovdb_tpu_torch, picovdb_tpu)):
        path = f"{tmp_path}/{src.__name__}"

        def mesh_of(pkg):
            return jax_mesh() if pkg is picovdb_tpu else port_mesh("8")

        a = src.PicoVectorDB(embedding_dim=dim, storage_file=path,
                             mesh=mesh_of(src), storage_dtype=storage)
        a.upsert(items)
        a.delete(["id4"])
        want = a.query_columnar(q, top_k=k)
        a.save(shards=4)
        b = dst.PicoVectorDB(embedding_dim=dim, storage_file=path,
                             mesh=mesh_of(dst), storage_dtype=storage)
        assert b.count() == n - 1
        got = b.query_columnar(q, top_k=k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=TOL_SCORE)
        assert b.query(q[0], top_k=3, where={"tag": 1})[0]["tag"] == 1


def test_mesh_store_refuses_the_serial_loop_and_many_processes(tmp_path,
                                                               monkeypatch):
    db = picovdb_tpu_torch.PicoVectorDB(embedding_dim=8,
                                        storage_file=f"{tmp_path}/t",
                                        mesh=port_mesh("4"))
    db.upsert([{K_ID: "a", K_VECTOR: np.ones(8, np.float32)}])
    db.query(np.ones(8, np.float32))
    with pytest.raises(ValueError, match="single-device"):
        db._dev.query_serial_loop(np.ones((2, 8), np.float32), 1)
    # a make_mesh store is one process's, whatever torch.distributed says
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
    one = picovdb_tpu_torch.PicoVectorDB(embedding_dim=8,
                                         storage_file=f"{tmp_path}/u",
                                         mesh=port_mesh("4"))
    assert not one._is_multiprocess()
    # a store spread over processes refuses to gather the whole matrix on
    # one host, as picovdb_tpu's does
    from picovdb_tpu_torch.parallel import Mesh

    spread = Mesh([[CPU] * 4], ("dp", "shard"), owners=[0, 0, 1, 1],
                  rank=0, world_size=2)
    many = picovdb_tpu_torch.PicoVectorDB(embedding_dim=8,
                                          storage_file=f"{tmp_path}/v",
                                          mesh=spread, index="ivf")
    assert many._is_multiprocess() and many._index_kind == "exact"
    many._host_lazy = True
    with pytest.raises(RuntimeError, match="multi-process store"):
        many._ensure_host_vectors()


@pytest.mark.parametrize("storage", ["int8", "int4"])
def test_mesh_quantized_checkpoint_crossloads(tmp_path, storage):
    """A device-born quantized mesh store saves its plane shard by shard
    (save(quantized=True)) and loads back into a mesh store of either
    package (each row to its owner shard) and a one-device port store:
    the same ids and scores."""
    rng = np.random.default_rng(15)
    dim, n, k = 32, 900, 5
    vecs = normalize_batch(rng.normal(size=(n, dim)).astype(np.float32))
    q = rng.normal(size=(6, dim)).astype(np.float32)
    path = f"{tmp_path}/q"
    db = picovdb_tpu_torch.PicoVectorDB(
        embedding_dim=dim, storage_file=path, mesh=port_mesh("8"),
        storage_dtype=storage)
    db.ingest_device(torch.from_numpy(vecs), ids=[f"id{i}" for i in range(n)],
                     normalize=False)
    # the same rows ingested pre-quantized (scales=) land on the same shards
    from picovdb_tpu_torch.ops import scan as tscan

    quant = tscan.quantize_rows_i4 if storage == "int4" else tscan.quantize_rows_i8
    pre = picovdb_tpu_torch.PicoVectorDB(
        embedding_dim=dim, storage_file=f"{tmp_path}/p", mesh=port_mesh("8"),
        storage_dtype=storage)
    pre.ingest_device(*quant(torch.from_numpy(vecs))[:1],
                      ids=[f"id{i}" for i in range(n)], normalize=False,
                      scales=quant(torch.from_numpy(vecs))[1])
    for a, b in zip(pre._dev.vectors, db._dev.vectors):
        assert torch.equal(a, b)
    db.delete(["id2"])
    want = db.query_columnar(q, top_k=k)
    db.save(quantized=True)
    for pkg, kw in ((picovdb_tpu_torch, dict(mesh=port_mesh("4"))),
                    (picovdb_tpu_torch, dict(device="cpu")),
                    (picovdb_tpu, dict(mesh=jax_mesh()))):
        b = pkg.PicoVectorDB(embedding_dim=dim, storage_file=path,
                             storage_dtype=storage, **kw)
        assert b.count() == n - 1
        got = b.query_columnar(q, top_k=k)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], atol=TOL_SCORE)
