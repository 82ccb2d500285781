"""Mesh stores on the card: K4 / K3 / K6 / K7 through the sharded routes.

Marked `cuda`: each test skips with a reason where no CUDA device is
present, and runs on the card with

    python -m pytest tests/test_torch_cuda_mesh.py -q

Four shards on cuda:0 (`make_mesh(devices=[cuda:0] * 4)`): each sharded
route's result equals the same route run shard by shard on the plain
versions (the shards' CPU copies, merged by `merge_topk`) within 1e-5
(every route ends in a float32 rescore, summed in another order on the
card), ids equal outside a 1e-5 k / k+1 gap; every kernel launches once
per shard and call. The
merge's tie rule holds on the card. The two-card case skips on one card.
"""

import numpy as np
import pytest
import torch

from picovdb_tpu_torch.ops import scan
from picovdb_tpu_torch.parallel import make_mesh
from picovdb_tpu_torch.parallel import sharded_query as tsq
from picovdb_tpu_torch.parallel.ivf_mesh import ShardedIVF
from torch_port_setup import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.cuda

SHARDS = 4
CPU = torch.device("cpu")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _planes(storage, n=4 * 8192, dim=128, seed=0):
    g = torch.Generator().manual_seed(seed)
    v = torch.nn.functional.normalize(torch.randn(n, dim, generator=g), dim=1)
    mask = torch.rand(n, generator=g) > 0.2
    if storage == "int8":
        planes = list(scan.quantize_rows_i8(v))
    elif storage == "int4":
        planes = list(scan.quantize_rows_i4(v))
    elif storage == "bfloat16":
        planes = [v.to(torch.bfloat16)]
    else:
        planes = [v]
    return [list(torch.chunk(p, SHARDS)) for p in planes], list(
        torch.chunk(mask, SHARDS))


KERNEL = {"float32": "scan_topk", "bfloat16": "scan_topk",
          "int8": "scan_topk_i8", "int4": "scan_topk_i4"}


@pytest.mark.parametrize("nq", [1, 64])
@pytest.mark.parametrize("storage", list(KERNEL))
def test_sharded_kernel_route_vs_plain(dev, storage, nq):
    planes, mask = _planes(storage)
    g = torch.Generator().manual_seed(1)
    q = torch.nn.functional.normalize(torch.randn(nq, 128, generator=g), dim=1)
    k = 10
    kw = dict(use_pallas=True, storage_i8=storage == "int8",
              storage_i4=storage == "int4",
              compute_dtype_name="bfloat16" if storage == "bfloat16" else None)
    mesh = make_mesh(devices=[dev] * SHARDS)
    fn = tsq.make_sharded_topk(mesh, "shard", k, **kw)
    on_card = [[t.to(dev) for t in p] for p in planes]
    scan.reset_launch_counts()
    for _ in range(3):
        vals, idx = fn(q.to(dev), *[[p] for p in on_card],
                       [[m.to(dev) for m in mask]])
    torch.cuda.synchronize()
    assert scan.LAUNCHES[KERNEL[storage]] == 3 * SHARDS
    cpu_mesh = make_mesh(devices=[CPU] * SHARDS)
    want_v, want_i = tsq.make_sharded_topk(cpu_mesh, "shard", k + 1, **kw)(
        q, *[[p] for p in planes], [mask])
    got_v, got_i = vals.cpu(), idx.cpu()
    torch.testing.assert_close(got_v, want_v[:, :k], rtol=0, atol=1e-5)
    for r in range(nq):
        if float(want_v[r, k - 1] - want_v[r, k]) > 1e-5:
            assert sorted(got_i[r].tolist()) == sorted(want_i[r, :k].tolist())


def test_sharded_merge_tie_rule_on_the_card(dev):
    vals = [torch.full((2, 3), 0.25, device=dev) for _ in range(SHARDS)]
    slots = [torch.tensor([[s * 8 + 5, s * 8 + 2, s * 8 + 7]] * 2,
                          dtype=torch.int32, device=dev)
             for s in (3, 1, 0, 2)]
    _, sl = tsq.merge_topk(vals, slots, 5, dev)
    assert sl.cpu().tolist() == [[2, 5, 7, 10, 13]] * 2


def test_sharded_ivf_k7_per_shard_vs_plain(dev):
    rng = np.random.default_rng(2)
    n, dim, k = 4 * 6000, 128, 10
    c = rng.normal(size=(64, dim)).astype(np.float32)
    x = c[rng.integers(0, 64, n)] + 0.3 * rng.normal(size=(n, dim)).astype(
        np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    mask = np.ones(n, bool)
    q = x[:32] + 0.01 * rng.normal(size=(32, dim)).astype(np.float32)
    card = ShardedIVF.build(x, mask, make_mesh(devices=[dev] * SHARDS),
                            nlist=64, dim=dim)
    host = ShardedIVF.from_blob(card.to_blob(), x, mask, dim,
                                mesh=make_mesh(devices=[CPU] * SHARDS))
    for nq in (1, 32):
        scan.reset_launch_counts()
        got = card.search(q[:nq], k, ef=16, dev=None)
        assert scan.LAUNCHES["ivf_scan_topk"] == SHARDS
        want = host.search(q[:nq], k + 1, ef=16, dev=None)
        np.testing.assert_allclose(got[0], want[0][:, :k], rtol=0, atol=1e-5)
        for r in range(nq):
            if want[0][r, k - 1] - want[0][r, k] > 1e-5:
                assert sorted(got[1][r]) == sorted(want[1][r, :k])


def test_two_cards_one_shard_each():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    devs = [torch.device("cuda", i) for i in range(2)]
    planes, mask = _planes("float32", n=2 * 8192)
    planes = [list(torch.chunk(torch.cat(p), 2)) for p in planes]
    mask = list(torch.chunk(torch.cat(mask), 2))
    q = torch.nn.functional.normalize(torch.randn(16, 128), dim=1)
    fn = tsq.make_sharded_topk(make_mesh(devices=devs), "shard", 10,
                               use_pallas=True)
    scan.reset_launch_counts()
    vals, idx = fn(q.to(devs[0]), [[p.to(d) for p, d in zip(planes[0], devs)]],
                   [[m.to(d) for m, d in zip(mask, devs)]])
    assert vals.device == devs[0] and scan.LAUNCHES["scan_topk"] == 2
    want_v, _ = tsq.make_sharded_topk(make_mesh(devices=[CPU] * 2), "shard",
                                      10, use_pallas=True)(
        q, *[[p] for p in planes], [mask])
    torch.testing.assert_close(vals.cpu(), want_v, rtol=0, atol=1e-5)


def test_dp_rows_on_two_cards(tmp_path):
    """A dp = 2 x 1 mesh over two cards: row 1 serves its half of each
    batch from its own copy of the planes on cuda:1, which a small
    mutation epoch updates in place; answers equal a CPU store's."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from picovdb_tpu_torch import PicoVectorDB

    devs = [torch.device("cuda", i) for i in range(2)]
    rng = np.random.default_rng(4)
    n, dim, k = 8192, 128, 10
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    qs = rng.normal(size=(16, dim)).astype(np.float32)
    dbs = [PicoVectorDB(embedding_dim=dim, storage_file=f"{tmp_path}/{name}",
                        **kw)
           for name, kw in (("mesh", {"mesh": make_mesh(devices=devs, dp=2),
                                      "scan_mode": "fused"}),
                            ("cpu", {"device": "cpu"}))]
    answers, launches = [], []
    for db in dbs:
        db.upsert_columnar(vecs, ids=[f"v{i}" for i in range(n)])
        first = db.query_columnar(qs, top_k=k + 1)
        db.upsert_columnar(qs[8:], ids=[f"v{i}" for i in range(8)])
        db.delete(["v9", "v4000"])
        scan.reset_launch_counts()
        answers.append((first, db.query_columnar(qs, top_k=k + 1)))
        launches.append(scan.LAUNCHES["scan_topk"])
    dev = dbs[0]._dev
    assert dev.last_sync_mode == "scatter"
    assert launches == [2, 0]  # one shard a row, two rows; the CPU store none
    copy = dev.mesh_planes(dev.vectors)[1]
    assert copy[0].device == devs[1] and torch.equal(copy[0].cpu(),
                                                     dev.vectors[0].cpu())
    for got, want in zip(*answers):
        np.testing.assert_allclose(got[1][:, :k], want[1][:, :k], rtol=0,
                                   atol=1e-5)
        for r in range(16):
            if want[1][r, k - 1] - want[1][r, k] > 1e-5:
                assert sorted(got[0][r, :k]) == sorted(want[0][r, :k])
