"""Single-item upserts in picovdb_tpu_torch: O(1) amortized host appends.

The host matrix `_host_vectors` is the view of the first n rows of a
backing array whose capacity doubles when it fills
(`PicoVectorDB._append_host_rows`), so an append copies the whole matrix
only at a doubling.

* 300 single upserts, with updates, deletes and slot reuse among them,
  leave `get_all`, `query`, `save` and a reload equal to picovdb_tpu's
  engine after the same sequence (same ids and rows; scores within 1e-5,
  both float32 dot products).
* The backing reallocations (`_host_growths`) grow with log2 of the rows
  appended, counted, not timed; a matrix set another way (adopted by
  `upsert_columnar(copy=False)`) is copied before the first append and
  the caller's array is never written past its rows.
"""

import numpy as np
import pytest

import picovdb_tpu
import picovdb_tpu_torch
from torch_port_setup import cap_torch_threads, cpu_kw

cap_torch_threads()

K_ID, K_METRICS, K_VECTOR = (picovdb_tpu.K_ID, picovdb_tpu.K_METRICS,
                             picovdb_tpu.K_VECTOR)
DIM = 24
CALLS = 300
PACKAGES = {"jax": picovdb_tpu, "torch": picovdb_tpu_torch}


def _sequence(rng):
    """(op, payload) in order: single upserts of new ids, updates of
    earlier ids, and deletes (whose slots later upserts reuse)."""
    vecs = rng.normal(size=(CALLS, DIM)).astype(np.float32)
    ops, live = [], []
    for i in range(CALLS):
        if live and i % 11 == 5:
            ops.append(("delete", live.pop(int(rng.integers(len(live))))))
        if live and i % 7 == 3:
            j = live[int(rng.integers(len(live)))]
            ops.append(("upsert", (j, vecs[i], i % 4)))
        else:
            ops.append(("upsert", (f"u{i}", vecs[i], i % 4)))
            live.append(f"u{i}")
    return ops


def _replay(pkg, base, ops):
    db = pkg.PicoVectorDB(embedding_dim=DIM, storage_file=base, **cpu_kw(pkg))
    for op, arg in ops:
        if op == "delete":
            assert db.delete([arg]) == [arg]
        else:
            _id, vec, tag = arg
            db.upsert([{K_ID: _id, K_VECTOR: vec, "tag": tag}])
    return db


def _listing(db):
    recs = db.get_all(include_vector=True, include_deleted=True)
    return ([r[K_ID] for r in recs], [r.get("tag") for r in recs],
            np.stack([r[K_VECTOR] if K_VECTOR in r else np.zeros(DIM)
                      for r in recs]).astype(np.float32))


def _answers(db, q):
    hits = db.query(q, top_k=10)
    return ([[h[K_ID] for h in row] for row in hits],
            np.asarray([[h[K_METRICS] for h in row] for row in hits]))


def _same(a, b, q):
    ids_a, tags_a, rows_a = _listing(a)
    ids_b, tags_b, rows_b = _listing(b)
    assert ids_a == ids_b and tags_a == tags_b
    np.testing.assert_array_equal(rows_a, rows_b)
    assert a.count() == b.count()
    got_a, sc_a = _answers(a, q)
    got_b, sc_b = _answers(b, q)
    assert got_a == got_b
    np.testing.assert_allclose(sc_a, sc_b, rtol=0, atol=1e-5)


def test_single_upserts_match_picovdb_tpu(tmp_path):
    rng = np.random.default_rng(18)
    ops = _sequence(rng)
    assert sum(op == "delete" for op, _ in ops) > 20
    dbs = {name: _replay(pkg, str(tmp_path / name), ops)
           for name, pkg in PACKAGES.items()}
    q = rng.normal(size=(8, DIM)).astype(np.float32)
    _same(dbs["jax"], dbs["torch"], q)
    for db in dbs.values():
        db.save()
    back = {name: pkg.PicoVectorDB(embedding_dim=DIM,
                                   storage_file=str(tmp_path / name),
                                   **cpu_kw(pkg))
            for name, pkg in PACKAGES.items()}
    _same(back["jax"], back["torch"], q)
    _same(dbs["torch"], back["torch"], q)
    # a reloaded store keeps appending one row at a time
    for name, db in back.items():
        db.upsert([{K_ID: "late", K_VECTOR: q[0], "tag": 9}])
    _same(back["jax"], back["torch"], q)


@pytest.mark.parametrize("n", [100, 1000, 5000])
def test_backing_reallocations_grow_with_log_n(tmp_path, n):
    rng = np.random.default_rng(n)
    vecs = rng.normal(size=(n, 8)).astype(np.float32)
    db = picovdb_tpu_torch.PicoVectorDB(
        embedding_dim=8, storage_file=str(tmp_path / "s"), device="cpu")
    for i in range(n):
        db.upsert([{K_ID: str(i), K_VECTOR: vecs[i]}])
    # the first row sets the matrix; each later doubling from 16 rows
    # reallocates once
    assert db._host_growths == int(np.ceil(np.log2(n / 16))) + 1
    assert db._host_vectors.shape == (n, 8)
    norm = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
    np.testing.assert_allclose(db._host_vectors, norm, rtol=0, atol=1e-6)


def test_adopted_matrix_is_copied_before_the_first_append(tmp_path):
    rng = np.random.default_rng(3)
    big = rng.normal(size=(64, 8)).astype(np.float32)
    adopted = big[:40]  # a view: rows 40-63 belong to the caller
    tail = big[40:].copy()
    db = picovdb_tpu_torch.PicoVectorDB(
        embedding_dim=8, storage_file=str(tmp_path / "s"), device="cpu")
    db.upsert_columnar(adopted, ids=[f"a{i}" for i in range(40)], copy=False)
    assert db._host_vectors is adopted and db._host_growths == 0
    for i in range(10):
        db.upsert([{K_ID: f"b{i}", K_VECTOR: rng.normal(size=8)}])
    assert db._host_growths == 1 and db._host_vectors.base is not big
    np.testing.assert_array_equal(big[40:], tail)
    np.testing.assert_array_equal(db._host_vectors[:40], adopted)
    assert db.count() == 50
