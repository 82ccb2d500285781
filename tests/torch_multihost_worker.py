"""Worker process for tests/test_torch_multihost_procs.py.

One of N real OS processes (ranks) of a picovdb_tpu_torch store spread
over processes, gloo-backed on the CPU: each rank holds one CPU "device"
of a `pod_mesh`, loads only its own shard of a `save(shards=N)`
checkpoint, and answers sharded top-k queries whose merge crosses
process boundaries (an all_gather). The counterpart of
tests/multihost_worker.py, mode for mode:

  * exact     — f32 corpus, `make_sharded_topk` cross-process merge
  * dp        — the same over a dp = 2 pod mesh (two devices a rank, the
                query batch split over the rows, each row merged across
                the ranks)
  * i4        — packed int4 STORAGE (`storage_i4=True`)
  * ivf       — `ShardedIVF` build + full-probe search, then one
                incremental `update()` epoch
  * ivf8      — the int8-only `ShardedIVF` layout, then one in-place
                frozen-scale requantize epoch
  * engine    — a `PicoVectorDB` per rank: distributed load, queries,
                mutations, the replicated vector getter, distributed save
                and reload (engine_odd: a row count the process count does
                not divide)
  * engine_i8 — int8 device storage; the distributed save writes
                dequantized f32 shards
  * grow      — a distributed-loaded store near its capacity takes an
                append epoch whose grow moves rows from rank 1 to rank 0

Each mode is held to the float64 oracle here; rank 0 writes its answers
to an .npz for the test to compare with picovdb_tpu's. `where` (default
cpu) puts the ranks on the card instead: `cuda-gloo`, every rank on
cuda:0 under gloo (collectives staged through host memory), or
`cuda-nccl`, one rank a card under NCCL (tests/test_torch_cuda_multihost.py);
each rank then prints its kernel launch counts.

Usage: python torch_multihost_worker.py <rank> <world> <port> <store_base>
       <dim> <mode> <kernels 0|1> <answers.npz> [cpu|cuda-gloo|cuda-nccl]
"""

import sys
import types

import numpy as np
import torch

torch.set_num_threads(2)


def _oracle_topk(qn, rows, k, live=None):
    s = qn.astype(np.float64) @ rows.T.astype(np.float64)
    if live is not None:
        s = np.where(live[None, :], s, -np.inf)
    want = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return s, want


def _local(mesh, full_plane):
    """A host plane (rows split evenly over the shard axis) as this rank's
    per-shard list: a tensor on its shard's device, None at the others."""
    parts = np.split(np.asarray(full_plane), mesh.shape["shard"])
    return [torch.from_numpy(np.array(parts[s], order="C")).to(
        mesh.row(0)[s]) if mesh.is_local(s) else None
        for s in range(mesh.shape["shard"])]


def run_exact(mesh, base, dim, full, qn, kernels, ans):
    from picovdb_tpu_torch.parallel.multihost import load_host_shard
    from picovdb_tpu_torch.parallel.sharded_query import make_sharded_topk

    dp = mesh.shape["dp"]
    blocks, n = load_host_shard(base, dim, mesh)
    assert n == full.shape[0], (n, full.shape)
    vec = [None] * mesh.shape["shard"]
    for s, b in zip(mesh.local_shards, blocks):
        vec[s] = b
    mask = [None if v is None else
            torch.ones(v.shape[0], dtype=torch.bool, device=v.device)
            for v in vec]
    fn = make_sharded_topk(mesh, "shard", 5, use_pallas=kernels)
    vals, idx = fn(torch.from_numpy(qn), [vec] * dp, [mask] * dp)
    vals, got = vals.cpu(), idx.cpu().numpy()
    assert got.shape == (qn.shape[0], 5), got.shape
    s, want = _oracle_topk(qn, full, 5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(vals.numpy(),
                               np.take_along_axis(s, want, axis=1), atol=1e-5)
    ans.update(vals=vals.numpy(), idx=got)


def run_i4(mesh, full, qn, kernels, ans):
    """Every rank quantizes the identical corpus and keeps its own shard of
    the packed planes and row scales."""
    from picovdb_tpu_torch.ops.scan import quantize_rows_i4, unpack_i4
    from picovdb_tpu_torch.parallel.sharded_query import make_sharded_topk

    v4, sc = quantize_rows_i4(torch.from_numpy(full))
    deq = unpack_i4(v4).float().numpy() * sc.numpy()[:, None]
    fn = make_sharded_topk(mesh, "shard", 5, use_pallas=kernels,
                           storage_i4=True)
    vals, idx = fn(torch.from_numpy(qn), [_local(mesh, v4.numpy())],
                   [_local(mesh, sc.numpy())],
                   [_local(mesh, np.ones(full.shape[0], dtype=bool))])
    vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
    s, want = _oracle_topk(qn, deq, 5)
    ovals = np.take_along_axis(s, want, axis=1)
    np.testing.assert_allclose(vals, ovals, rtol=1e-5, atol=1e-6)
    for qi in range(qn.shape[0]):  # tie-robust id check via scores
        np.testing.assert_allclose(s[qi][idx[qi]], ovals[qi], rtol=1e-5,
                                   atol=1e-6)
    ans.update(vals=vals, idx=idx)


def run_ivf(mesh, full, qn, ans):
    """ShardedIVF across processes: build, full-probe search, then one
    incremental update() epoch (append 2, delete 1) re-served exactly."""
    from picovdb_tpu_torch.parallel.ivf_mesh import ShardedIVF

    n, dim = full.shape
    k = 5
    ivf = ShardedIVF.build(full, np.ones(n, dtype=bool), mesh, nlist=8,
                           dim=dim)
    vals, slots = ivf.search(qn, k, ef=10**6, dev=None)  # full probe
    s, want = _oracle_topk(qn, full, k)
    ovals = np.take_along_axis(s, want, axis=1)
    np.testing.assert_allclose(vals, ovals, rtol=1e-5, atol=1e-6)
    for qi in range(qn.shape[0]):
        np.testing.assert_allclose(s[qi][slots[qi]], ovals[qi], rtol=1e-5,
                                   atol=1e-6)

    rng = np.random.default_rng(11)
    new = rng.standard_normal((2, dim)).astype(np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    changed = np.array([0, n, n + 1])
    rows = np.vstack([np.zeros((1, dim), np.float32), new])
    ok = ivf.update(changed, rows, np.array([False, True, True]))
    assert ok, "incremental update refused on the 2-process mesh"
    corpus = np.vstack([full, new])
    live = np.ones(n + 2, dtype=bool)
    live[0] = False
    vals2, slots2 = ivf.search(qn, k, ef=10**6, dev=None)
    s2, want2 = _oracle_topk(qn, corpus, k, live=live)
    ovals2 = np.take_along_axis(s2, want2, axis=1)
    np.testing.assert_allclose(vals2, ovals2, rtol=1e-5, atol=1e-6)
    for qi in range(qn.shape[0]):
        np.testing.assert_allclose(s2[qi][slots2[qi]], ovals2[qi], rtol=1e-5,
                                   atol=1e-6)
    v3, s3 = ivf.search(new[:1], 1, ef=10**6, dev=None)
    assert s3[0, 0] == n, s3
    ans.update(vals=vals, idx=slots, vals2=vals2, idx2=slots2)


def run_ivf8(mesh, full, qn, ans):
    """int8-only ShardedIVF across processes: per-shard int8 postings, the
    exact rescore reads each rank's own corpus shard by local slot, then
    one in-place update() epoch (frozen-scale requantize)."""
    from picovdb_tpu_torch.parallel.ivf_mesh import ShardedIVF

    n, dim = full.shape
    k = 5
    ivf = ShardedIVF.build(full, np.ones(n, dtype=bool), mesh, nlist=8,
                           dim=dim, i8_only=True, corpus_cap=n)
    assert ivf.vectors is None and ivf.vectors_i8c is not None
    dev = types.SimpleNamespace(cap=n, vectors=_local(mesh, full),
                                vstore_scale=None, storage_dtype="float32")
    vals, slots = ivf.search(qn, k, ef=10**6, dev=dev)  # full probe
    s, want = _oracle_topk(qn, full, k)
    for qi in range(qn.shape[0]):
        np.testing.assert_allclose(s[qi][slots[qi]], vals[qi], rtol=1e-5,
                                   atol=1e-6)
        assert slots[qi][0] == want[qi][0], (slots[qi], want[qi])

    rng = np.random.default_rng(11)
    new = rng.standard_normal((1, dim)).astype(np.float32)
    new /= np.linalg.norm(new, axis=1, keepdims=True)
    new *= 0.8  # stay inside the build-time dynamic range
    ok = ivf.update(np.array([0, 1]),
                    np.vstack([np.zeros((1, dim), np.float32), new]),
                    np.array([False, True]))
    assert ok, "i8-only incremental update refused on the 2-process mesh"
    assert ivf.last_update_clip_fraction <= 0.05
    full2 = full.copy()
    full2[1] = new[0]
    dev2 = types.SimpleNamespace(cap=n, vectors=_local(mesh, full2),
                                 vstore_scale=None, storage_dtype="float32")
    live = np.ones(n, dtype=bool)
    live[0] = False
    vals2, slots2 = ivf.search(qn, k, ef=10**6, dev=dev2)
    s2, _ = _oracle_topk(qn, full2, k, live=live)
    for qi in range(qn.shape[0]):
        np.testing.assert_allclose(s2[qi][slots2[qi]], vals2[qi], rtol=1e-5,
                                   atol=1e-6)
        assert 0 not in slots2[qi]
    v3, s3 = ivf.search(full2[1:2], 1, ef=10**6, dev=dev2)
    assert s3[0, 0] == 1, s3
    ans.update(vals=vals, idx=slots, vals2=vals2, idx2=slots2)


def _hits(res):
    return (np.array([[h["_id_"] for h in r] for r in res], dtype=str),
            np.array([[h["_metrics_"] for h in r] for r in res]))


def run_engine(mesh, base, dim, full, kernels, ans):
    """A PicoVectorDB on every rank over the pod mesh, each reading only
    its own checkpoint shard: queries, upserts, deletes, the replicated
    vector getter, a distributed re-save and a reload, all held to the
    host oracle. Every rank issues the same calls (the SPMD contract)."""
    from picovdb_tpu_torch import K_ID, K_VECTOR, PicoVectorDB

    n = full.shape[0]
    db = PicoVectorDB(embedding_dim=dim, storage_file=base, mesh=mesh,
                      use_pallas=kernels)
    assert db._host_lazy and db._host_vectors is None
    assert db.count() == n
    assert all(t is None for s, t in enumerate(db._dev.vectors)
               if not mesh.is_local(s))

    id_list = [r[K_ID] for r in db.get_all()]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((3, dim)).astype(np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    s, want = _oracle_topk(qn, full, 5)
    res = db.query(q, top_k=5)
    for qi in range(3):
        assert [h[K_ID] for h in res[qi]] == [id_list[j] for j in want[qi]]
        np.testing.assert_allclose([h["_metrics_"] for h in res[qi]],
                                   np.take_along_axis(s, want, axis=1)[qi],
                                   rtol=1e-5, atol=1e-5)
    want_route = "sharded_scan_pallas" if kernels else "sharded_scan"
    assert db.last_query_debug()["strategy"] == want_route

    # the vector getter: the owner rank broadcasts, every rank reads it
    got_vec = db.get([id_list[1], id_list[n - 1]], include_vector=True)
    np.testing.assert_allclose(got_vec[0][K_VECTOR], full[1], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_vec[1][K_VECTOR], full[n - 1], rtol=1e-5,
                               atol=1e-6)

    # update 1, delete 1, append 4, identical on every rank
    rng2 = np.random.default_rng(11)
    newv = rng2.standard_normal((5, dim)).astype(np.float32)
    newv /= np.linalg.norm(newv, axis=1, keepdims=True)
    db.upsert([{K_ID: id_list[2], K_VECTOR: newv[0]}]
              + [{K_ID: f"mh_new{j}", K_VECTOR: newv[1 + j]}
                 for j in range(4)])
    db.delete([id_list[5]])
    corpus = np.vstack([full, newv[1:5]])
    corpus[2] = newv[0]
    live = np.ones(n + 4, dtype=bool)
    live[5] = False
    ids2 = id_list + [f"mh_new{j}" for j in range(4)]
    s2, want2 = _oracle_topk(qn, corpus, 5, live=live)
    res2 = db.query(q, top_k=5)
    for qi in range(3):
        assert [h[K_ID] for h in res2[qi]] == [ids2[j] for j in want2[qi]]
    assert db.query(newv[1], top_k=1)[0][K_ID] == "mh_new0"
    assert all(h[K_ID] != id_list[5] for h in db.query(full[5], top_k=10))

    db.save()  # one shard file per rank
    db2 = PicoVectorDB(embedding_dim=dim, storage_file=base, mesh=mesh,
                       use_pallas=kernels)
    assert db2.count() == n + 4 - 1
    res3 = db2.query(q, top_k=5)
    for qi in range(3):
        assert [h[K_ID] for h in res3[qi]] == [ids2[j] for j in want2[qi]]
    ids_a, sc_a = _hits(res)
    ids_b, sc_b = _hits(res2)
    ids_c, sc_c = _hits(res3)
    ans.update(ids=ids_a, scores=sc_a, ids2=ids_b, scores2=sc_b, ids3=ids_c,
               scores3=sc_c)


def run_engine_i8(mesh, base, dim, full, kernels, ans):
    """int8 device storage across processes: the distributed save writes
    dequantized f32 shards, which reload as a float32 store ranking each
    checked row first."""
    from picovdb_tpu_torch import K_ID, K_VECTOR, PicoVectorDB, persistence

    n = full.shape[0]
    qbase = base + "_i8"
    db = PicoVectorDB(embedding_dim=dim, storage_file=qbase, mesh=mesh,
                      storage_dtype="int8", use_pallas=kernels)
    db.upsert([{K_ID: f"q{i}", K_VECTOR: full[i]} for i in range(n)])
    assert db.count() == n
    rng = np.random.default_rng(7)
    q = rng.standard_normal((3, dim)).astype(np.float32)
    res = db.query(q, top_k=5)
    db.save(quantized=True)  # warns: the multi-process save writes f32

    shards = persistence.find_shards(qbase)
    assert len(shards) == mesh.world_size, shards
    saved = np.concatenate([np.load(p) for p in shards])
    assert saved.shape == (n, dim), saved.shape
    fulln = full / np.linalg.norm(full, axis=1, keepdims=True)
    np.testing.assert_allclose(saved, fulln, rtol=0, atol=2e-2)
    db2 = PicoVectorDB(embedding_dim=dim, storage_file=qbase, mesh=mesh,
                       use_pallas=kernels)
    assert db2.count() == n
    for i in (0, 3, n - 1):
        assert db.query(full[i], top_k=1)[0][K_ID] == f"q{i}"
        assert db2.query(full[i], top_k=1)[0][K_ID] == f"q{i}"
    ids_a, sc_a = _hits(res)
    ans.update(ids=ids_a, scores=sc_a, saved_rank=np.asarray(
        persistence.shard_split_rows(n, mesh.world_size)))


def run_grow(mesh, base, dim, full, kernels, ans):
    """A distributed-loaded store a few rows short of its capacity takes an
    append epoch: the grow re-splits the shards at twice the rows, so
    rank 1's rows move to rank 0 through the process group; the store
    stays lazy and serves the oracle's answers, moved rows read back."""
    from picovdb_tpu_torch import K_ID, K_VECTOR, PicoVectorDB

    n = full.shape[0]
    db = PicoVectorDB(embedding_dim=dim, storage_file=base, mesh=mesh,
                      use_pallas=kernels)
    cap0 = db._dev.cap
    assert n < cap0 < n + 400, (n, cap0)
    rng = np.random.default_rng(5)
    extra = rng.standard_normal((400, dim)).astype(np.float32)
    extra /= np.linalg.norm(extra, axis=1, keepdims=True)
    db.upsert([{K_ID: f"x{i}", K_VECTOR: extra[i]} for i in range(400)])
    q = rng.standard_normal((4, dim)).astype(np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    res = db.query(q, top_k=5)
    assert db._last_sync_mode == "incremental", db._last_sync_mode
    assert db._dev.cap > cap0 and db._host_lazy
    rl = db._dev.shard_rows
    assert rl >= cap0  # shard 0 now holds every old row
    for s, t in enumerate(db._dev.vectors):
        assert (t is None) == (not mesh.is_local(s))
        assert t is None or t.shape[0] == rl
    corpus = np.vstack([full, extra])
    ids = [str(i) for i in range(n)] + [f"x{i}" for i in range(400)]
    s, want = _oracle_topk(qn, corpus, 5)
    for qi in range(4):
        assert [h[K_ID] for h in res[qi]] == [ids[j] for j in want[qi]]
    # rows that lived on rank 1 before the grow read back on every rank
    moved = [cap0 // 2, cap0 // 2 + 7, n - 1]
    got = db.get([str(i) for i in moved], include_vector=True)
    np.testing.assert_allclose(np.stack([g[K_VECTOR] for g in got]),
                               full[moved], rtol=0, atol=0)
    assert db.query(extra[7], top_k=1)[0][K_ID] == "x7"
    db.save()
    db2 = PicoVectorDB(embedding_dim=dim, storage_file=base, mesh=mesh,
                       use_pallas=kernels)
    assert db2.count() == n + 400
    res2 = db2.query(q, top_k=5)
    for qi in range(4):
        assert [h[K_ID] for h in res2[qi]] == [ids[j] for j in want[qi]]
    ids_a, sc_a = _hits(res)
    ans.update(ids=ids_a, scores=sc_a)


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    base, dim, mode = sys.argv[4], int(sys.argv[5]), sys.argv[6]
    kernels, out = sys.argv[7] == "1", sys.argv[8]
    where = sys.argv[9] if len(sys.argv) > 9 else "cpu"

    import torch.distributed as dist

    from picovdb_tpu_torch import persistence
    from picovdb_tpu_torch.parallel.multihost import (
        init_distributed,
        pod_mesh,
    )

    backend = "nccl" if where == "cuda-nccl" else "gloo"
    if backend == "nccl":
        import os

        os.environ["LOCAL_RANK"] = str(rank)
    init_distributed(f"tcp://127.0.0.1:{port}", world_size=world, rank=rank,
                     backend=backend, timeout_s=120)
    assert dist.get_world_size() == world
    local = {"cpu": [torch.device("cpu")],
             "cuda-gloo": [torch.device("cuda", 0)]}.get(where)
    mesh = pod_mesh(devices=local)  # cuda-nccl: cuda:LOCAL_RANK
    assert mesh.host_staged == (backend == "gloo")
    assert mesh.multiprocess and mesh.local_shards == [rank]
    # the oracle reads every shard file (host-side)
    full = np.concatenate([np.load(p)
                           for p in persistence.find_shards(base)])
    rng = np.random.default_rng(7)
    q = rng.standard_normal((3, dim)).astype(np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    ans = {}
    if mode in ("engine", "engine_odd"):
        run_engine(mesh, base, dim, full, kernels, ans)
    elif mode == "engine_i8":
        run_engine_i8(mesh, base, dim, full, kernels, ans)
    elif mode == "grow":
        run_grow(mesh, base, dim, full, kernels, ans)
    elif mode == "exact":
        run_exact(mesh, base, dim, full, qn, kernels, ans)
    elif mode == "dp":
        mesh2 = pod_mesh(dp=2, devices=[mesh.first] * 2)
        assert mesh2.shape["dp"] == 2 and mesh2.local_shards == [rank]
        run_exact(mesh2, base, dim, full, qn, kernels, ans)
    elif mode == "i4":
        run_i4(mesh, full, qn, kernels, ans)
    elif mode == "ivf":
        run_ivf(mesh, full, qn, ans)
    elif mode == "ivf8":
        run_ivf8(mesh, full, qn, ans)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    if rank == 0:
        np.savez(out, **ans)
    if where != "cpu":
        import json

        from picovdb_tpu_torch.ops import scan

        torch.cuda.synchronize()
        print("LAUNCHES " + json.dumps({k: v for k, v in scan.LAUNCHES.items()
                                        if v}), flush=True)
    from picovdb_tpu_torch.parallel.multihost import barrier

    barrier(mesh)
    dist.destroy_process_group()
    print(f"MH OK pid={rank} mode={mode}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
