"""picovdb_tpu_torch: on-disk compatibility with picovdb_tpu, import
hygiene, and the entry points outside its slice.

A store saved by either package loads in the other with identical
`get_all` listings and query results (same ids; scores within 1e-5, both
float32 dot products). The port must import no JAX, no ml_dtypes and no
picovdb_tpu module, and must say which ROADMAP item brings each entry point
it does not serve yet.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import pytest

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu_torch.device import DeviceIndex
from torch_port_setup import cap_torch_threads, cpu_kw

cap_torch_threads()

K_ID, K_METRICS, K_VECTOR = (picovdb_tpu.K_ID, picovdb_tpu.K_METRICS,
                             picovdb_tpu.K_VECTOR)
PKG = Path(picovdb_tpu_torch.__file__).resolve().parent
DIM = 24
PACKAGES = {"jax": picovdb_tpu, "torch": picovdb_tpu_torch}


def _populate(db, rng):
    vecs = rng.normal(size=(300, DIM)).astype(np.float32)
    vecs[17] = 0.0  # zero vector -> e0
    db.upsert([{K_ID: f"r{i}", K_VECTOR: vecs[i], "tag": i % 3}
               for i in range(300)])
    db.delete([f"r{i}" for i in range(0, 300, 7)])
    db.store_additional_data(note="cross-load", n=300)
    return vecs


@pytest.mark.parametrize("shards", [None, 2])
@pytest.mark.parametrize("writer,reader", [("jax", "torch"), ("torch", "jax")])
def test_store_loads_in_the_other_package(tmp_path, rng, writer, reader,
                                          shards):
    base = str(tmp_path / "store")
    w = PACKAGES[writer].PicoVectorDB(embedding_dim=DIM, storage_file=base,
                                      **cpu_kw(PACKAGES[writer]))
    vecs = _populate(w, rng)
    w.save(shards=shards)
    r = PACKAGES[reader].PicoVectorDB(embedding_dim=DIM, storage_file=base,
                                      **cpu_kw(PACKAGES[reader]))
    assert r.count() == w.count()
    assert r.get_additional_data() == w.get_additional_data()
    a = w.get_all(include_vector=True, include_deleted=True)
    b = r.get_all(include_vector=True, include_deleted=True)
    assert [x[K_ID] for x in a] == [x[K_ID] for x in b]
    for x, y in zip(a, b):
        assert {k: v for k, v in x.items() if k != K_VECTOR} == \
            {k: v for k, v in y.items() if k != K_VECTOR}
        if K_VECTOR in x:
            np.testing.assert_array_equal(x[K_VECTOR], y[K_VECTOR])
    q = vecs[:5] + 0.1
    hw, hr = w.query(q, top_k=6), r.query(q, top_k=6)
    assert [[h[K_ID] for h in hits] for hits in hw] == \
        [[h[K_ID] for h in hits] for hits in hr]
    np.testing.assert_allclose(
        [[h[K_METRICS] for h in hits] for hits in hr],
        [[h[K_METRICS] for h in hits] for hits in hw], rtol=0, atol=1e-5)


def test_import_adds_no_jax_module():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import picovdb_tpu_torch, picovdb_tpu_torch.ops.scan\n"
        "import picovdb_tpu_torch.ops._build, picovdb_tpu_torch.hostops\n"
        "import picovdb_tpu_torch.models, picovdb_tpu_torch.tools.rag_demo\n"
        "added = set(sys.modules) - before\n"
        "bad = sorted(m for m in added if m.split('.')[0] in "
        "('jax', 'jaxlib', 'ml_dtypes', 'picovdb_tpu', 'flax', "
        "'transformers', 'sentence_transformers'))\n"
        "print(','.join(bad))\n"
    )
    env = dict(os.environ)
    root = str(PKG.parent)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=root, timeout=120, check=True)
    assert out.stdout.strip() == "", out.stdout


def test_no_source_file_imports_jax():
    forbidden = ("jax", "jaxlib", "ml_dtypes", "picovdb_tpu", "flax")
    for path in sorted(PKG.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in forbidden, (path, name)


@pytest.mark.parametrize("kwargs,item", [
    ({"index": "ivf"}, "item 7"),
    ({"scan_mode": "approx"}, "item 9"),
    ({"mesh": "cpu x 4"}, "item 8"),
    ({"storage_dtype": "int8", "mesh": "cpu x 4"}, "item 8"),
])
def test_out_of_slice_entry_points_raise(tmp_path, monkeypatch, kwargs, item):
    """Entry points of later ROADMAP items raise NotImplementedError
    naming their item. Items 7 (index="ivf"), 9 (scan_mode="approx") and
    8 (meshes, in one process and across processes) are ported: they
    serve. A make_mesh store stays one process's store in a multi-process
    program (a store across processes is built on multihost.pod_mesh)."""
    if "mesh" in kwargs:
        from picovdb_tpu_torch.parallel import make_mesh

        kwargs = {**kwargs, "mesh": make_mesh(devices=["cpu"] * 4)}

    def make():
        return picovdb_tpu_torch.PicoVectorDB(
            embedding_dim=DIM, storage_file=str(tmp_path / "s"), device="cpu",
            **kwargs)

    db = make()
    vecs = np.random.default_rng(0).normal(size=(300, DIM)).astype(np.float32)
    db.upsert_columnar(vecs, ids=[str(i) for i in range(300)])
    assert db.query(vecs[17], top_k=1)[0][picovdb_tpu_torch.K_ID] == "17"
    route = {"item 7": "ivf", "item 9": "xla_approx",
             "item 8": "sharded_scan"}[item]
    if "storage_dtype" in kwargs:
        route += "_i8stor"
    assert db.last_query_debug()["strategy"] == route
    if item == "item 8":
        monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
        monkeypatch.setattr(torch.distributed, "get_world_size", lambda: 2)
        again = make()
        assert not again._is_multiprocess()
        again.upsert_columnar(vecs, ids=[str(i) for i in range(300)])
        assert again.query(vecs[17], top_k=1)[0][picovdb_tpu_torch.K_ID] == "17"


def test_out_of_slice_calls_raise(tmp_path, monkeypatch):
    """The storage-tier entry points serve now and refuse what the JAX
    package refuses (a quantized save of a float32 store, host data to
    ingest_device); the f32 opt-in int8 segmax (item 9) serves too."""
    db = picovdb_tpu_torch.PicoVectorDB(embedding_dim=DIM, device="cpu",
                                        storage_file=str(tmp_path / "s"))
    with pytest.raises(ValueError, match="device"):
        db.ingest_device(np.zeros((2, DIM), np.float32), ids=["a", "b"])
    with pytest.raises(ValueError, match="int8/int4"):
        db.save(quantized=True)
    monkeypatch.setenv("PICOVDB_SEGMAX_I8", "1")
    dev = DeviceIndex(DIM, int8_tier=True, device="cpu")
    assert dev.segmax_i8
    assert not DeviceIndex(DIM, int8_tier=False, device="cpu").segmax_i8


def test_index_auto_serves_exact_and_cpu_defaults(tmp_path, rng):
    """`index="auto"` serves the exact scan; on the CPU the mirrors and the
    kernel routes default off, as the JAX package's do off its TPU."""
    db = picovdb_tpu_torch.PicoVectorDB(embedding_dim=DIM, device="cpu",
                                        storage_file=str(tmp_path / "s"))
    vecs = _populate(db, rng)
    hits = db.query(vecs[1], top_k=3)
    assert hits[0][K_ID] == "r1"
    dbg = db.last_query_debug()
    assert dbg["strategy"] == "xla_topk"
    assert dbg["index_kind"] == "auto" and not dbg["ann_active"]
    assert dbg["mirrors"] == {"bf16": False, "int8": False}


def test_query_serial_loop_and_from_numpy_state(rng, monkeypatch):
    """DeviceIndex.from_numpy_state takes the same corpus + mask as the
    JAX package's full_upload; the serial Q=1 loop equals batch queries
    (crowding mark off: the loop never marks, the dispatch path may)."""
    monkeypatch.setenv("PICOVDB_TIE_MARGIN_SCALE", "0")
    vecs = rng.normal(size=(5000, DIM)).astype(np.float32)
    vecs /= np.linalg.norm(vecs, axis=1, keepdims=True)
    active = rng.random(5000) > 0.2
    dev = DeviceIndex(DIM, mixed_precision=True, int8_tier=True, device="cpu")
    dev.from_numpy_state(vecs, active)
    q = vecs[:6]
    lv, li = dev.query_serial_loop(q, 5)
    assert dev.last_strategy == "i8_fused_smallq_loop"
    bv, bi = dev.query(q, 5)
    np.testing.assert_array_equal(li, bi)
    np.testing.assert_allclose(lv, bv, rtol=0, atol=1e-6)
    assert active[li].all()
    # the JAX package's DeviceIndex over the same state: same route, ids
    from picovdb_tpu.device import DeviceIndex as JaxDeviceIndex

    jdev = JaxDeviceIndex(DIM, mixed_precision=True, int8_tier=True,
                          use_pallas=True)
    jdev.full_upload(vecs, active)
    jv, ji = jdev.query(q, 5)
    assert jdev.last_strategy == "i8_fused_smallq"
    dev.query(q, 5)
    assert dev.last_strategy == "i8_fused_smallq"
    np.testing.assert_array_equal(bi, ji)
    np.testing.assert_allclose(bv, jv, rtol=0, atol=1e-5)
