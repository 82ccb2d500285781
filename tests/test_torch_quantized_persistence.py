"""Quantized checkpoints between picovdb_tpu and picovdb_tpu_torch.

`save(quantized=True)` writes an int8/int4 store's storage plane and row
scales (`<base>.vecs.q.npy`, `.vecs.qscale.npy`, `.vecs.q.json`, and the
exact overlay rows of a lazy store in `.vecs.overlay.npz`) instead of a
float32 matrix. A checkpoint written by either package loads in the other
with the same listing, bit-identical dequantized rows (the same float32
multiply of the same plane) and the same query answers (ids equal; scores
within 1e-5, float32 dot products summed in different orders).
"""

import numpy as np
import pytest

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu_torch import persistence as tpersist
from torch_port_setup import cap_torch_threads, cpu_kw

cap_torch_threads()

K_ID, K_METRICS, K_VECTOR = (picovdb_tpu.K_ID, picovdb_tpu.K_METRICS,
                             picovdb_tpu.K_VECTOR)
PACKAGES = {"jax": picovdb_tpu, "torch": picovdb_tpu_torch}
DIM = 32


def _open(pkg, base, storage):
    return PACKAGES[pkg].PicoVectorDB(embedding_dim=DIM, storage_file=base,
                                      storage_dtype=storage, use_pallas=True,
                                      rescore="device", **cpu_kw(PACKAGES[pkg]))


def _same_listing(a_db, b_db):
    a = {x[K_ID]: x for x in a_db.get_all(include_vector=True)}
    b = {x[K_ID]: x for x in b_db.get_all(include_vector=True)}
    assert sorted(a) == sorted(b)
    for key, x in a.items():
        assert {k: v for k, v in x.items() if k != K_VECTOR} == \
            {k: v for k, v in b[key].items() if k != K_VECTOR}
        np.testing.assert_array_equal(x[K_VECTOR], b[key][K_VECTOR])


def _same_answers(a_db, b_db, q):
    ha, hb = a_db.query(q, top_k=6), b_db.query(q, top_k=6)
    assert [[h[K_ID] for h in r] for r in ha] == \
        [[h[K_ID] for h in r] for r in hb]
    np.testing.assert_allclose([[h[K_METRICS] for h in r] for r in hb],
                               [[h[K_METRICS] for h in r] for r in ha],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("storage", ["int8", "int4"])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_quantized_checkpoint_loads_in_the_other_package(tmp_path, rng,
                                                         storage, writer,
                                                         reader):
    base = str(tmp_path / "q")
    w = _open(writer, base, storage)
    vecs = rng.normal(size=(400, DIM)).astype(np.float32)
    w.upsert([{K_ID: f"r{i}", K_VECTOR: vecs[i], "tag": i % 3}
              for i in range(400)])
    w.delete([f"r{i}" for i in range(0, 400, 9)])
    w.store_additional_data(note="q", n=400)
    w.save(quantized=True)
    assert tpersist.load_quantized(base)["storage_dtype"] == storage
    r = _open(reader, base, storage)
    assert r.count() == w.count() and r.capacity() == 400
    assert r.get_additional_data() == w.get_additional_data()
    # both packages' lazy readers list the same dequantized rows (the
    # writer itself still holds its authentic float32 rows)
    _same_listing(_open(writer, base, storage), r)
    _same_answers(w, r, vecs[1:6] + 0.05)
    # the reader is lazy: a mutation lands in the overlay, a second
    # quantized save carries it, and the writer's package reads it back
    fresh = rng.normal(size=(DIM,)).astype(np.float32)
    r.upsert([{K_ID: "new", K_VECTOR: fresh}])
    r.delete(["r1"])
    r.save(quantized=True)
    assert tpersist.load_quantized(base)["overlay"]
    w2 = _open(writer, base, storage)
    got = w2.get("new", include_vector=True)[K_VECTOR]
    np.testing.assert_array_equal(got, r.get("new", include_vector=True)[K_VECTOR])
    np.testing.assert_allclose(got, fresh / np.linalg.norm(fresh), atol=1e-6)
    assert w2.get("r1") is None and w2.query(fresh, top_k=1)[0][K_ID] == "new"
    _same_listing(w2, r)


def test_quantized_load_checks_and_auto_format(tmp_path, rng, monkeypatch):
    """Loading refuses a mismatched storage dtype or dim; the default save
    of a lazy quantized store writes the plane past
    PICOVDB_QSAVE_AUTO_GB and a float32 matrix below it (as picovdb_tpu
    does), which a float32 store reads; a quantized save refuses
    shards."""
    base = str(tmp_path / "q")
    db = _open("torch", base, "int8")
    db.upsert_columnar(rng.normal(size=(300, DIM)).astype(np.float32),
                       ids=[str(i) for i in range(300)])
    db.save(quantized=True)
    with pytest.raises(ValueError, match="storage_dtype"):
        _open("torch", base, "int4")
    with pytest.raises(ValueError, match="dim"):
        picovdb_tpu_torch.PicoVectorDB(embedding_dim=DIM + 2, storage_file=base,
                                       storage_dtype="int8", device="cpu")
    lazy = _open("torch", base, "int8")
    monkeypatch.setenv("PICOVDB_QSAVE_AUTO_GB", "0")
    lazy.save()
    assert tpersist.load_quantized(base) is not None
    monkeypatch.setenv("PICOVDB_QSAVE_AUTO_GB", "1")
    lazy.save()
    assert tpersist.load_quantized(base) is None  # f32 matrix replaced it
    f32 = picovdb_tpu.PicoVectorDB(embedding_dim=DIM, storage_file=base)
    assert f32.count() == 300
    with pytest.raises(ValueError, match="shards"):
        _open("torch", base, "int8").save(shards=2, quantized=True)


def test_save_ids_meta_atomic_is_readable_by_both(tmp_path):
    base = str(tmp_path / "m")
    tpersist.save_ids_meta_atomic(base, ["a", None], [{"x": 1}, None],
                                  {"k": 2}, DIM)
    from picovdb_tpu import persistence as jpersist

    for mod in (jpersist, tpersist):
        assert mod.load_ids(base) == ["a", None]
        assert mod.load_meta(base, 2) == ([{"x": 1}, None], {"k": 2})
