"""Differential engine slice: picovdb_tpu vs picovdb_tpu_torch on the CPU.

One sequence of operations is replayed through both packages'
`PicoVectorDB`, built with `mixed_precision=True, int8_tier=True,
use_pallas=True` so both take the kernel routes on the CPU (JAX: Pallas
interpret mode; port: the kernels' plain versions), the compacted filter
view included. Per query the routes (`last_strategy`) must be identical,
scores agree within TOL_SCORE (float32 dot products summed in different
orders) and id sets agree wherever the exact k-th/(k+1)-th gap exceeds
TOL_GAP (inside it either pick is a correct top-k).
"""

import numpy as np
import pytest
import torch

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu.utils import normalize_batch
from torch_port_setup import cap_torch_threads, cpu_kw

cap_torch_threads()

K_ID, K_METRICS = picovdb_tpu.K_ID, picovdb_tpu.K_METRICS
TOL_SCORE = 1e-5
TOL_GAP = 1e-4
DIM = 64
N = 33_000  # padded capacity 40960 >= SEGMAX_MIN_CAP: the segmax tier routes
KNOBS = dict(mixed_precision=True, int8_tier=True, use_pallas=True)


def _build(tmp, rng_seed=7):
    rng = np.random.default_rng(rng_seed)
    vecs = rng.normal(size=(N, DIM)).astype(np.float32)
    ids = [f"d{i}" for i in range(N)]
    meta = [{"tag": i % 5} for i in range(N)]
    dbs = {}
    for name, pkg in (("jax", picovdb_tpu), ("torch", picovdb_tpu_torch)):
        db = pkg.PicoVectorDB(embedding_dim=DIM, storage_file=f"{tmp}/{name}",
                              **KNOBS, **cpu_kw(pkg))
        db.upsert_columnar(vecs, ids=ids, metadata=meta)
        dbs[name] = db
    return dbs, vecs


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    return _build(tmp_path_factory.mktemp("engine"))


def _oracle(vecs, live, q, k):
    """Exact float64 score of rank k-1 minus rank k, per query (inf when
    fewer than k+1 candidates)."""
    v = normalize_batch(vecs).astype(np.float64)
    qn = normalize_batch(q).astype(np.float64)
    s = qn @ v[live].T
    s = -np.sort(-s, axis=1)
    if s.shape[1] <= k:
        return np.full(q.shape[0], np.inf)
    return s[:, k - 1] - s[:, k]


def _compare(rj, rt, gaps):
    assert len(rj) == len(rt)
    for i, (hj, ht) in enumerate(zip(rj, rt)):
        assert len(hj) == len(ht), i
        np.testing.assert_allclose(
            [h[K_METRICS] for h in ht], [h[K_METRICS] for h in hj],
            rtol=0, atol=TOL_SCORE)
        if gaps[i] > TOL_GAP:
            assert {h[K_ID] for h in hj} == {h[K_ID] for h in ht}, i


def _query_both(dbs, q, **kw):
    out = {}
    for name, db in dbs.items():
        out[name] = db.query(q, **kw)
        out[name + "_route"] = db.last_query_debug()["strategy"]
    return out


# (Q, k, filter): Q = 1 and 8 take the small-batch tiers, 256 the segmax /
# batch ladder; k = 32 pushes past the segmax and small-ladder bounds.
CASES = [
    (1, 5, None), (1, 10, None), (1, 32, None), (8, 10, None),
    (8, 10, "where"), (8, 32, "ids"), (256, 10, None), (256, 5, "where"),
    (256, 32, None), (256, 10, "ids"),
]


@pytest.mark.parametrize("nq,k,filt", CASES)
def test_routes_ids_scores_match(pair, nq, k, filt):
    dbs, vecs = pair
    rng = np.random.default_rng(nq * 100 + k)
    rows = rng.integers(0, N, nq)
    q = (vecs[rows] + 0.3 * rng.normal(size=(nq, DIM))).astype(np.float32)
    live = np.ones(N, bool)
    kw = {"top_k": k}
    if filt == "where":
        kw["where"] = {"tag": 2}
        live = np.arange(N) % 5 == 2
    elif filt == "ids":
        allow = rng.choice(N, 3000, replace=False)
        kw["ids"] = [f"d{i}" for i in allow]
        live = np.zeros(N, bool)
        live[allow] = True
    got = _query_both(dbs, q if nq > 1 else q[0], **kw)
    assert got["jax_route"] == got["torch_route"], got
    rj = got["jax"] if nq > 1 else [got["jax"]]
    rt = got["torch"] if nq > 1 else [got["torch"]]
    _compare(rj, rt, _oracle(vecs, live, q, k))


def test_query_columnar_and_batched_match(pair):
    dbs, vecs = pair
    rng = np.random.default_rng(3)
    q = (vecs[rng.integers(0, N, 300)]
         + 0.3 * rng.normal(size=(300, DIM))).astype(np.float32)
    gaps = _oracle(vecs, np.ones(N, bool), q, 10)
    cols = {n: db.query_columnar(q, top_k=10, batch_size=256)
            for n, db in dbs.items()}
    routes = {n: db.last_query_debug()["strategy"] for n, db in dbs.items()}
    assert routes["jax"] == routes["torch"] == "segmax_mixed", routes
    (ij, sj), (it, st) = cols["jax"], cols["torch"]
    np.testing.assert_allclose(st, sj, rtol=0, atol=TOL_SCORE)
    for i in range(300):
        if gaps[i] > TOL_GAP:
            assert set(ij[i]) == set(it[i]), i
    bj = dbs["jax"].query_batched(q[:40], top_k=10, batch_size=16)
    bt = dbs["torch"].query_batched(q[:40], top_k=10, batch_size=16)
    _compare(bj, bt, gaps[:40])


def test_mutation_sequence_matches(tmp_path):
    """upsert -> query -> delete -> query -> upsert into freed slots ->
    vacuum -> query, compared step by step."""
    dbs, vecs = _build(str(tmp_path), rng_seed=11)
    rng = np.random.default_rng(5)
    live = np.ones(N, bool)

    def check(nq, k):
        q = (vecs[rng.integers(0, vecs.shape[0], nq)]
             + 0.3 * rng.normal(size=(nq, DIM))).astype(np.float32)
        got = _query_both(dbs, q, top_k=k)
        assert got["jax_route"] == got["torch_route"], got
        _compare(got["jax"], got["torch"], _oracle(vecs, live, q, k))

    check(256, 10)
    gone = rng.choice(N, 2000, replace=False)
    for db in dbs.values():
        assert len(db.delete([f"d{i}" for i in gone])) == 2000
    live[gone] = False
    check(8, 10)
    check(256, 10)
    # deleted rows never come back
    for db in dbs.values():
        hits = db.query(vecs[gone[:4]], top_k=10)
        assert not {h[K_ID] for r in hits for h in r} & {f"d{i}" for i in gone}
    fresh = rng.normal(size=(500, DIM)).astype(np.float32)
    for db in dbs.values():
        rep = db.upsert([{K_ID: f"n{i}", "_vector_": fresh[i]}
                         for i in range(500)])
        assert len(rep["insert"]) == 500
    for db in dbs.values():
        db.vacuum()
        assert db.count() == N - 2000 + 500
    vecs = np.concatenate([vecs[live], fresh])
    live = np.ones(vecs.shape[0], bool)
    check(8, 5)
    check(256, 10)
    assert (dbs["jax"].get_all() == dbs["torch"].get_all())


def test_append_past_capacity_grows_on_device(tmp_path):
    """An append epoch that crosses a capacity bucket grows the device
    planes in place and scatters only the new rows, in both packages."""
    rng = np.random.default_rng(2)
    base = rng.normal(size=(8000, DIM)).astype(np.float32)
    extra = rng.normal(size=(600, DIM)).astype(np.float32)
    dbs = {}
    for name, pkg in (("jax", picovdb_tpu), ("torch", picovdb_tpu_torch)):
        db = pkg.PicoVectorDB(embedding_dim=DIM,
                              storage_file=f"{tmp_path}/{name}", **KNOBS,
                              **cpu_kw(pkg))
        db.upsert_columnar(base, ids=[f"b{i}" for i in range(8000)])
        db.query(base[0], top_k=3)
        cap0 = db.last_query_debug()["device_capacity"]
        db.upsert_columnar(extra, ids=[f"e{i}" for i in range(600)])
        hits = db.query(extra[:4], top_k=3)
        dbg = db.last_query_debug()
        assert dbg["device_capacity"] > cap0 and dbg["sync_mode"] == "incremental"
        assert [h[0][K_ID] for h in hits] == [f"e{i}" for i in range(4)]
        dbs[name] = (dbg["device_capacity"], dbg["strategy"])
    assert dbs["jax"] == dbs["torch"]


def test_pack_results_bit_identical():
    from picovdb_tpu.device import DeviceIndex as JaxDeviceIndex
    from picovdb_tpu_torch.device import DeviceIndex

    rng = np.random.default_rng(4)
    vals = rng.normal(size=(3, 5)).astype(np.float32)
    vals[1, 4] = -np.inf
    idxs = rng.integers(0, 1000, size=(3, 5)).astype(np.int32)
    j = np.asarray(JaxDeviceIndex.pack_results(vals, idxs))
    t = DeviceIndex.pack_results(torch.from_numpy(vals), torch.from_numpy(idxs))
    np.testing.assert_array_equal(t.numpy(), j)


def test_concurrent_readers_and_writer(tmp_path):
    """Readers query while a writer deletes and re-inserts: no reader
    fails, and no id deleted before a query started comes back from it
    (the port mutates its device tensors in place, so its exact retry runs
    under the read lock)."""
    import sys
    import threading

    rng = np.random.default_rng(9)
    vecs = rng.normal(size=(4000, DIM)).astype(np.float32)
    # writer_priority: without it a saturated reader pool may starve the
    # writer, the reference's documented semantics
    db = picovdb_tpu_torch.PicoVectorDB(
        embedding_dim=DIM, storage_file=str(tmp_path / "c"),
        writer_priority=True, device="cpu", **KNOBS)
    db.upsert_columnar(vecs, ids=[f"c{i}" for i in range(4000)])
    gone: set = set()
    gone_lock = threading.Lock()
    errors: list = []
    stop = threading.Event()

    def reader(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set():
            with gone_lock:
                before = set(gone)
            q = vecs[r.integers(0, 4000, 20)]
            try:
                ids, _ = db.query_columnar(q, top_k=5)
                hit = {i for i in ids.ravel().tolist() if i is not None}
                if hit & before:
                    errors.append(("deleted id served", hit & before))
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

    def writer():
        for start in range(0, 300, 50):
            batch = [f"c{i}" for i in range(start, start + 50)]
            db.delete(batch)
            with gone_lock:
                gone.update(batch)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        readers = [threading.Thread(target=reader, args=(s,)) for s in range(4)]
        for t in readers:
            t.start()
        w = threading.Thread(target=writer)
        w.start()
        w.join(timeout=60)
        stop.set()
        for t in readers:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not w.is_alive() and not any(t.is_alive() for t in readers)
    assert not errors, errors[:3]
    assert db.count() == 3700


@pytest.mark.parametrize("build", ["store", "device_index", "ivf_index"])
def test_no_device_named_and_no_card_raises(tmp_path, monkeypatch, build):
    """Without device= a store or index goes to the card; where there is
    none it raises naming device="cpu" instead of serving from the host."""
    from picovdb_tpu_torch.device import DeviceIndex
    from picovdb_tpu_torch.ops import ivf as tivf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    vecs = normalize_batch(np.random.default_rng(4).normal(size=(64, DIM))
                           .astype(np.float32))
    make = {
        "store": lambda: picovdb_tpu_torch.PicoVectorDB(
            embedding_dim=DIM, storage_file=str(tmp_path / "s")),
        "device_index": lambda: DeviceIndex(DIM),
        "ivf_index": lambda: tivf.IVFIndex.build(
            vecs, np.ones(64, bool), nlist=4, dim=DIM),
    }[build]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make()


def test_default_device_is_the_card(monkeypatch):
    from picovdb_tpu_torch.ops.exact import default_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert default_device() == torch.device("cuda:0")
