"""A picovdb_tpu_torch store across 2 real OS processes on the CPU (gloo).

The counterpart of tests/test_multihost_procs.py: every mode of its
worker (`exact`, `i4`, `ivf`, `ivf8`, `engine`, `engine_i8`,
`engine_odd`) plus `grow` (an append epoch whose grow moves rows from
rank 1 to rank 0) and `dp` (the exact merge on a dp = 2 pod mesh) runs
in tests/torch_multihost_worker.py, once with the kernel routes asked
for (`use_pallas=True`: on the CPU the wrappers run their plain
versions) and once without. Each worker holds itself to the
float64 oracle; rank 0's answers are then compared here with
picovdb_tpu's on the same seeded inputs, over a 2-device slice of the
conftest's virtual CPU mesh (its plain routes): f32 ids equal and scores
within 1e-5; int8 / int4 scores within rtol 1e-5, atol 1e-6, ids through
the scores (ties).
"""

import os
import shutil
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu.parallel import make_mesh as jax_mesh
from picovdb_tpu_torch.constants import ROW_PAD
from torch_port_setup import cap_torch_threads, capped_env

cap_torch_threads()

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs the virtual CPU mesh")

NPROCS = 2
DIM = 16
N = 64
GROW_N = 2 * ROW_PAD - 100  # a few rows short of a 2-shard store's capacity
MODES = ["exact", "i4", "ivf", "ivf8", "engine", "engine_i8", "engine_odd",
         "grow", "dp"]
K_ID, K_VECTOR = picovdb_tpu.K_ID, picovdb_tpu.K_VECTOR
WORKER = os.path.join(os.path.dirname(__file__), "torch_multihost_worker.py")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _store(base, mode):
    """The checkpoint every rank loads its shard of: save(shards=2)."""
    n = {"engine_odd": N + 1, "grow": GROW_N}.get(mode, N)
    rng = np.random.default_rng(0)
    vecs = rng.standard_normal((n, DIM)).astype(np.float32)
    db = picovdb_tpu_torch.PicoVectorDB(embedding_dim=DIM, storage_file=base,
                                        device="cpu")
    db.upsert_columnar(vecs, ids=[f"r{i}" if mode != "grow" else str(i)
                                  for i in range(n)])
    db.save(shards=NPROCS)
    return vecs


def _run_workers(base, mode, kernels, out):
    port = _free_port()
    env = capped_env()
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(r), str(NPROCS), str(port), base,
             str(DIM), mode, "1" if kernels else "0", out],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
            text=True)
        for r in range(NPROCS)
    ]
    outs = []
    try:
        for p in procs:
            out_text, _ = p.communicate(timeout=150)
            outs.append(out_text)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text}"
        assert f"MH OK pid={r} mode={mode}" in text, text


def _jax_mesh2():
    return jax_mesh(devices=jax.devices()[:2])


def _jax_sharded(full, q, **kw):
    from jax.sharding import NamedSharding, PartitionSpec as P

    from picovdb_tpu.parallel.sharded_query import make_sharded_topk

    mesh = _jax_mesh2()
    row = NamedSharding(mesh, P("shard", None))
    vec = NamedSharding(mesh, P("shard"))
    args = [jax.device_put(q, NamedSharding(mesh, P()))]
    args += [jax.device_put(a, row if a.ndim == 2 else vec) for a in full]
    args.append(jax.device_put(np.ones(full[0].shape[0], bool), vec))
    fn = make_sharded_topk(mesh, "shard", 5, **kw)
    return tuple(np.asarray(a) for a in fn(*args))


def _queries(n=3, seed=7):
    q = np.random.default_rng(seed).standard_normal((n, DIM)).astype(
        np.float32)
    return q, q / np.linalg.norm(q, axis=1, keepdims=True)


def _scores_match(vals, idx, want_vals, exact):
    """int8 / int4 and IVF answers: scores within rtol 1e-5, atol 1e-6,
    ids checked through the scores their rows have."""
    np.testing.assert_allclose(vals, want_vals, rtol=1e-5, atol=1e-6)
    for qi in range(vals.shape[0]):
        np.testing.assert_allclose(exact[qi][idx[qi]], want_vals[qi],
                                   rtol=1e-5, atol=1e-6)


def _hits(res):
    return (np.array([[h[K_ID] for h in r] for r in res], dtype=str),
            np.array([[h["_metrics_"] for h in r] for r in res]))


def _jax_engine(jbase, mode, full):
    """picovdb_tpu's engine replay of the worker's calls on its 2-device
    mesh; the answers rank 0 records."""
    mesh = _jax_mesh2()
    q, _ = _queries()
    out = {}
    if mode == "engine_i8":
        db = picovdb_tpu.PicoVectorDB(embedding_dim=DIM,
                                      storage_file=jbase + "_i8", mesh=mesh,
                                      storage_dtype="int8")
        db.upsert([{K_ID: f"q{i}", K_VECTOR: full[i]}
                   for i in range(full.shape[0])])
        out["ids"], out["scores"] = _hits(db.query(q, top_k=5))
        return out
    db = picovdb_tpu.PicoVectorDB(embedding_dim=DIM, storage_file=jbase,
                                  mesh=mesh)
    if mode == "grow":
        rng = np.random.default_rng(5)
        extra = rng.standard_normal((400, DIM)).astype(np.float32)
        extra /= np.linalg.norm(extra, axis=1, keepdims=True)
        db.upsert([{K_ID: f"x{i}", K_VECTOR: extra[i]} for i in range(400)])
        q4 = rng.standard_normal((4, DIM)).astype(np.float32)
        out["ids"], out["scores"] = _hits(db.query(q4, top_k=5))
        return out
    id_list = [r[K_ID] for r in db.get_all()]
    out["ids"], out["scores"] = _hits(db.query(q, top_k=5))
    rng2 = np.random.default_rng(11)
    newv = rng2.standard_normal((5, DIM)).astype(np.float32)
    newv /= np.linalg.norm(newv, axis=1, keepdims=True)
    db.upsert([{K_ID: id_list[2], K_VECTOR: newv[0]}]
              + [{K_ID: f"mh_new{j}", K_VECTOR: newv[1 + j]}
                 for j in range(4)])
    db.delete([id_list[5]])
    out["ids2"], out["scores2"] = _hits(db.query(q, top_k=5))
    return out


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_two_process_store(tmp_path, mode, kernels):
    base = str(tmp_path / "mhstore")
    _store(base, mode)
    jdir = tmp_path / "jax"
    jdir.mkdir()
    for name in os.listdir(tmp_path):
        if name.startswith("mhstore"):
            shutil.copy(tmp_path / name, jdir / name)
    full = np.concatenate([np.load(p) for p in
                           picovdb_tpu_torch.persistence.find_shards(base)])
    out = str(tmp_path / "answers.npz")
    _run_workers(base, mode, kernels, out)
    got = dict(np.load(out))
    q, qn = _queries()

    if mode in ("exact", "dp"):
        want = _jax_sharded([full], q)
        np.testing.assert_array_equal(got["idx"], want[1])
        np.testing.assert_allclose(got["vals"], want[0], rtol=0, atol=1e-5)
    elif mode == "i4":
        from picovdb_tpu.ops.pallas_scan import quantize_rows_i4, unpack_i4

        v4, sc = (np.asarray(a) for a in quantize_rows_i4(full))
        want = _jax_sharded([v4, sc], q, storage_i4=True)
        deq = np.asarray(unpack_i4(v4)).astype(np.float64) * sc[:, None]
        _scores_match(got["vals"], got["idx"], want[0],
                      qn.astype(np.float64) @ deq.T)
    elif mode in ("ivf", "ivf8"):
        import types

        from jax.sharding import NamedSharding, PartitionSpec as P

        from picovdb_tpu.parallel.ivf_mesh import ShardedIVF

        mesh = _jax_mesh2()
        n = full.shape[0]
        kw = dict(i8_only=True, corpus_cap=n) if mode == "ivf8" else {}
        ivf = ShardedIVF.build(full, np.ones(n, dtype=bool), mesh, nlist=8,
                               dim=DIM, **kw)
        dev = types.SimpleNamespace(
            cap=n, vstore_scale=None, vectors=jax.device_put(
                full, NamedSharding(mesh, P("shard", None))))
        want = ivf.search(qn, 5, ef=10**6, dev=dev)
        _scores_match(got["vals"], got["idx"], want[0],
                      qn.astype(np.float64) @ full.T.astype(np.float64))
    else:
        want = _jax_engine(str(jdir / "mhstore"), mode, full)
        for key in ("ids", "ids2"):
            if key not in want:
                continue
            sc = "scores" + key[3:]
            if mode == "engine_i8":  # int8 storage: ids through scores
                fulln = full / np.linalg.norm(full, axis=1, keepdims=True)
                rows = np.char.lstrip(got[key].astype(str), "q").astype(int)
                _scores_match(got[sc], rows, want[sc],
                              qn.astype(np.float64) @ fulln.T.astype(
                                  np.float64))
                continue
            np.testing.assert_array_equal(got[key], want[key])
            np.testing.assert_allclose(got[sc], want[sc], rtol=0, atol=1e-5)
        if mode in ("engine", "engine_odd"):  # the reload answers alike
            np.testing.assert_array_equal(got["ids3"], want["ids2"])
