"""Entry points: a one-card query step and a multi-device dry run.

Counterpart of picovdb_tpu's `__graft_entry__.py` on the port.

`entry()` returns the hot path of `PicoVectorDB.query` over a
device-resident corpus as a function and its inputs: K4 (`fused_topk`,
the tensor-core masked top-k scan) at k + 4, the exact float32 rescore,
then the top k, at the reference's serving shapes (256 queries over a
102,400 x 1024 corpus, top-10).

`dryrun_multichip(n)` serves one step over a (dp, shard) mesh of n
devices on tiny shapes: a scatter upsert into the row-sharded planes,
the sharded query with the cross-device merge (the plain route, then K4
on every shard), a `ShardedIVF` over the same rows (K7 on every shard),
and int8 / int4 storage over the mesh (K3 / K6 on every shard), each
checked against its oracle as picovdb_tpu's dry run checks it.

    python -m picovdb_tpu_torch.graft_entry   # entry(), then dryrun_multichip(4)

Both run on the card unless given CPU devices, and raise without one.
"""

from __future__ import annotations

import numpy as np
import torch

from picovdb_tpu_torch.ops import scan
from picovdb_tpu_torch.ops.exact import default_device, normalize_on_device


def entry(device=None, num_q: int = 256, cap: int = 102_400, dim: int = 1024,
          k: int = 10):
    """(fn, (queries, vectors, mask)) for the one-card query step.

    fn(queries, vectors, mask) -> ((Q, k) float32 scores, (Q, k) int32
    rows). The inputs are made and normalized on `device` (None: the
    card) from a seeded generator, so the ~400 MB corpus never crosses
    from the host. On a card K4 serves; on the CPU its wrapper runs the
    kernel's plain version."""
    device = default_device() if device is None else torch.device(device)

    def fn(queries, vectors, mask):
        vals, idxs = scan.fused_topk(queries, vectors, mask, k + 4)
        vals, idxs = scan.rescore_exact(queries, vectors, vals, idxs)
        return vals[:, :k], idxs[:, :k]

    g = torch.Generator(device=device).manual_seed(0)
    queries = normalize_on_device(
        torch.randn(num_q, dim, generator=g, device=device))
    vectors = normalize_on_device(
        torch.randn(cap, dim, generator=g, device=device))
    mask = torch.ones(cap, dtype=torch.bool, device=device)
    return fn, (queries, vectors, mask)


def dry_run_devices(n: int) -> list:
    """cuda:i % count for i < n: n shards on the cards there are, several
    a card where there are fewer than n. Raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "dryrun_multichip: no CUDA device is available; pass devices= "
            "(e.g. [torch.device('cpu')] * n) to run on the host")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def _overlap(got: np.ndarray, want: np.ndarray) -> float:
    k = want.shape[1]
    return float(np.mean([len(set(got[i].tolist()) & set(want[i].tolist()))
                          / k for i in range(want.shape[0])]))


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """One sharded serving step over an n-device mesh (tiny shapes).

    The data are picovdb_tpu's dry run's draws (numpy, seed 0). Returns
    the arrays it checks (host numpy): the corpus after the upsert
    (`vectors`), `active`, `queries`, the plain route's `vals` / `idxs`,
    the kernel route's `pallas_vals` / `pallas_idxs`, the IVF search's
    `ivf_vals` / `ivf_slots`, `i8_idxs`, `i4_idxs`, their overlaps with
    the oracles, the mesh's `dp` and `shards`, and `calls`: how many
    launches each kernel family's counter (`scan.LAUNCHES`) must gain on
    a card."""
    devices = (dry_run_devices(n_devices) if devices is None
               else [torch.device(d) for d in devices][:n_devices])
    if len(devices) < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                           f"{n_devices} devices; got {len(devices)}")
    from picovdb_tpu_torch.parallel import make_mesh
    from picovdb_tpu_torch.parallel.ivf_mesh import ShardedIVF
    from picovdb_tpu_torch.parallel.sharded_query import make_sharded_topk

    dp = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(devices=devices, dp=dp)
    n_shards = mesh.shape["shard"]

    dim, k = 64, 4
    rows_per_shard = 64
    cap = rows_per_shard * n_shards
    num_q = 8 * max(1, dp)

    rng = np.random.default_rng(0)
    host = rng.normal(size=(cap, dim)).astype(np.float32)
    queries = rng.normal(size=(num_q, dim)).astype(np.float32)
    upd_idx = np.arange(8, dtype=np.int64)
    upd_rows = rng.normal(size=(8, dim)).astype(np.float32)

    def planes(arr):
        """One list per mesh row of one tensor per shard, on its device
        (rows on the same device share one tensor)."""
        parts = np.split(arr, n_shards)
        first = [torch.from_numpy(np.ascontiguousarray(p)).to(d)
                 for p, d in zip(parts, mesh.row(0))]
        return [[t.to(d) for t, d in zip(first, mesh.row(r))]
                for r in range(dp)]

    vectors = planes(host)
    active = planes(np.ones(cap, dtype=bool))

    # upsert: scatter the new rows and their activity into every shard
    # (of every mesh row) that owns them
    for r in range(dp):
        for s in range(n_shards):
            lo = s * rows_per_shard
            mine = (upd_idx >= lo) & (upd_idx < lo + rows_per_shard)
            if mine.any():
                d = mesh.row(r)[s]
                local = torch.from_numpy(upd_idx[mine] - lo).to(d)
                vectors[r][s][local] = torch.from_numpy(upd_rows[mine]).to(d)
                active[r][s][local] = True
    host[upd_idx] = upd_rows
    q = torch.from_numpy(queries)

    # the sharded query: per-shard masked top-k, merged across shards
    vals, idxs = (t.cpu().numpy() for t in
                  make_sharded_topk(mesh, "shard", k)(q, vectors, active))
    assert vals.shape == (num_q, k), vals.shape
    assert np.isfinite(vals).all()
    assert (idxs >= 0).all() and (idxs < cap).all()

    # the kernel route: K4 on every shard, rescored exactly; the same
    # answers as the plain route
    pvals, pidxs = (t.cpu().numpy() for t in make_sharded_topk(
        mesh, "shard", k, use_pallas=True)(q, vectors, active))
    assert pvals.shape == (num_q, k), pvals.shape
    np.testing.assert_allclose(pvals, vals, rtol=1e-5, atol=1e-6)

    # ShardedIVF: shared centroids, per-shard postings; at ef = 1000 every
    # cluster is probed, so the scores are the exact scan's over the
    # normalized rows
    host_n = host / np.linalg.norm(host, axis=1, keepdims=True)
    ivf = ShardedIVF.build(host_n, np.ones(cap, dtype=bool), mesh, nlist=8,
                           dim=dim)
    q_host = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    ivals, islots = ivf.search(q_host, k, ef=1000, dev=None)
    assert ivals.shape == (num_q, k), ivals.shape
    oracle = q_host @ host_n.T
    ovals = -np.sort(-oracle, axis=1)[:, :k]
    np.testing.assert_allclose(ivals, ovals, rtol=1e-4, atol=1e-5)

    # int8 storage over the mesh: K3 on every shard, dequantized rescore;
    # the ranking must agree with the float oracle (int8 noise at dim 64:
    # a set comparison)
    v8, vs = scan.quantize_rows_i8(torch.from_numpy(host_n))
    i8_fn = make_sharded_topk(mesh, "shard", k, use_pallas=True,
                              storage_i8=True)
    _, i8idxs = i8_fn(q, planes(v8.numpy()), planes(vs.numpy()), active)
    i8idxs = i8idxs.cpu().numpy()
    overlap = _overlap(i8idxs, np.argsort(-oracle, axis=1)[:, :k])
    assert overlap >= 0.9, overlap

    # int4 storage over the mesh: K6 on every shard, held to the oracle
    # over the dequantized rows
    v4, v4s = scan.quantize_rows_i4(torch.from_numpy(host_n))
    deq = (scan.unpack_i4(v4).float() * v4s[:, None]).numpy()
    i4_fn = make_sharded_topk(mesh, "shard", k, use_pallas=True,
                              storage_i4=True)
    _, i4idxs = i4_fn(q, planes(v4.numpy()), planes(v4s.numpy()), active)
    i4idxs = i4idxs.cpu().numpy()
    overlap4 = _overlap(i4idxs, np.argsort(-(q_host @ deq.T), axis=1)[:, :k])
    assert overlap4 >= 0.9, overlap4

    calls = dp * n_shards  # a kernel route's launches: each row, each shard
    return {"vectors": host, "active": np.ones(cap, dtype=bool),
            "queries": queries, "vals": vals, "idxs": idxs,
            "pallas_vals": pvals, "pallas_idxs": pidxs, "ivf_vals": ivals,
            "ivf_slots": islots, "i8_idxs": i8idxs, "i4_idxs": i4idxs,
            "overlap_i8": overlap, "overlap_i4": overlap4, "dp": dp,
            "shards": n_shards,
            "calls": {"scan_topk": calls, "ivf_scan_topk": n_shards,
                      "scan_topk_i8": calls, "scan_topk_i4": calls}}


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry ok:", [tuple(o.shape) for o in out])
    n = 4  # four shards: one a card on four cards, all four on one
    dryrun_multichip(n)
    print(f"dryrun_multichip({n}) ok")
