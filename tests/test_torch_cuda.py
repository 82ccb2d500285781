"""picovdb_tpu_torch's CUDA kernels against their plain versions, on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda.py -q

Shapes are small; `chip_smoke.py` checks the same kernels at the main
path's shapes. Tolerances: K5 keys and int8 / int4 scores are exact
(integer sums, one float32 conversion and one multiply); float32 / bf16
scores within 1e-5 (summation order). K8's float keys also within 1e-5:
unit-vector scores stay below 1, where summation order moves a key by at
most one 128-ulp quantum (7.6e-6), while a TF32 product would be off by
several 1e-5 at these widths.
"""

import pytest
import torch

from picovdb_tpu_torch.ops import scan

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _data(dev, cap=8192, dim=96, nq=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    v = torch.nn.functional.normalize(torch.randn(cap, dim, generator=g), dim=1)
    q = torch.nn.functional.normalize(torch.randn(nq, dim, generator=g), dim=1)
    mask = torch.rand(cap, generator=g) > 0.2
    return q.to(dev), v.to(dev), mask.to(dev)


# 96: 16-byte loads with a partial 64-wide k-step; 50: the element-wise
# load paths (dim not a multiple of 8, 4 or 2)
DIMS = [96, 50]


@pytest.mark.parametrize("dim", DIMS)
def test_segmax_and_topk_keys(dev, dim):
    q, v, mask = _data(dev, dim=dim, nq=200)
    qb, vb = q.to(torch.bfloat16), v.to(torch.bfloat16)
    before = scan.LAUNCHES["segmax"]
    keys = scan.segmax_scan(qb, vb, mask)
    assert scan.LAUNCHES["segmax"] == before + 1
    ref = scan.segmax_scan_plain(qb, vb, mask)
    torch.cuda.synchronize()
    dec = lambda k: scan._from_sortable(k & ~127).view(torch.float32)  # noqa: E731
    live = keys != scan.KEY_MIN
    assert torch.equal(live, ref != scan.KEY_MIN)
    assert float((dec(keys)[live] - dec(ref)[live]).abs().max()) <= 1e-4
    tk, tc = scan.topk_packed_keys(keys, 16)
    rk, _ = scan.topk_packed_keys_plain(keys, 16)
    assert torch.equal(tk, rk)
    assert torch.equal(torch.gather(keys, 1, tc.long()), tk)


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("kind,k", [("f32", 14), ("bf16", 36), ("i8", 14),
                                    ("f32", 700)])
def test_scan_topk(dev, kind, k, dim):
    q, v, mask = _data(dev, dim=dim)
    if kind == "i8":
        qq, _ = scan.quantize_rows_i8(q)
        vv, vs = scan.quantize_rows_i8(v)
        got = scan.fused_topk_i8(qq, vv, vs, mask, k)
    else:
        qq, vs = q, None
        vv = v.to(torch.bfloat16) if kind == "bf16" else v
        got = scan.fused_topk(qq, vv, mask, k)
    ref = scan.scan_topk_plain(qq, vv, vs, mask, k)
    torch.cuda.synchronize()
    assert float((got[0] - ref[0]).abs().max()) <= (0 if kind == "i8" else 1e-5)
    assert bool(mask[got[1].long()].all())


@pytest.mark.parametrize("dim", [96, 50, 1024])
def test_segmax_scan_i8_keys_exact(dev, dim):
    q, v, mask = _data(dev, dim=dim, nq=200)
    q8, _ = scan.quantize_rows_i8(q)
    v8, vs = scan.quantize_rows_i8(v)
    before = scan.LAUNCHES["segmax_i8"]
    keys = scan.segmax_scan_i8(q8, v8, vs, mask)
    assert scan.LAUNCHES["segmax_i8"] == before + 1
    ref = scan.segmax_scan_i8_plain(q8, v8, vs, mask)
    torch.cuda.synchronize()
    assert torch.equal(keys, ref)


@pytest.mark.parametrize("dim", [96, 50, 1024])
@pytest.mark.parametrize("nq,k", [(1, 14), (16, 14), (16, 526), (40, 100)])
def test_fused_topk_i4_exact(dev, dim, nq, k):
    if dim % 2:
        dim += 1  # int4 packs two elements per byte
    q, v, mask = _data(dev, dim=dim, nq=nq)
    q8, _ = scan.quantize_rows_i8(q)
    v4, vs = scan.quantize_rows_i4(v)
    before = scan.LAUNCHES["scan_topk_i4"]
    got = scan.fused_topk_i4(q8, v4, vs, mask, k)
    assert scan.LAUNCHES["scan_topk_i4"] == before + 1
    ref = scan.scan_topk_plain(q8, v4, vs, mask, k, int4=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0])
    assert bool(mask[got[1].long()].all())


def test_unsupported_input_raises(dev):
    q, v, mask = _data(dev)
    with pytest.raises(ValueError):
        scan.segmax_scan(q, v, mask)  # the kernel takes bf16 only
    with pytest.raises(ValueError):
        scan.fused_topk(q.half(), v, mask, 10)
    with pytest.raises(ValueError):  # K5 takes int8 only
        scan.segmax_scan_i8(q, v, v[:, 0].contiguous(), mask)
    v4, vs = scan.quantize_rows_i4(v)
    with pytest.raises(ValueError):  # K6: packed rows are dim / 2 wide
        scan.fused_topk_i4(scan.quantize_rows_i8(q)[0], v4[:, :10].contiguous(),
                           vs, mask, 10)


def test_engine_segmax_underfill_retries_on_card(dev, tmp_path):
    """Eight live rows inside one 128-row segment: the segmax tier can
    surface only two, and the engine sees -inf and re-serves exactly: the
    single-dispatch lane through the exact scan (`xla_topk` under
    scan_mode="mixed", as in picovdb_tpu), the columnar lane through the
    dispatch-time snapshot, which streams through K4."""
    import numpy as np

    from picovdb_tpu_torch import K_ID, PicoVectorDB

    rng = np.random.default_rng(0)
    n, dim, k = 40_960, 64, 5
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    db = PicoVectorDB(embedding_dim=dim, storage_file=str(tmp_path / "u"),
                      device=dev, scan_mode="mixed")
    db.upsert_columnar(vecs, ids=[str(i) for i in range(n)])
    keep = {str(i) for i in range(256, 264)}
    db.delete([str(i) for i in range(n) if str(i) not in keep])
    before = scan.LAUNCHES["scan_topk"]
    res = db.query(vecs[256], top_k=k)
    assert len(res) == k and res[0][K_ID] == "256"
    assert db.last_query_debug()["strategy"] == "xla_topk"
    ids, _ = db.query_columnar(vecs[256:258], top_k=k)
    assert (ids != None).sum(axis=1).tolist() == [k, k]  # noqa: E711
    assert scan.LAUNCHES["scan_topk"] == before + 1
    assert db.stats()["exact_retries"] >= 2


def test_int4_engine_round_trip_on_card(dev, tmp_path):
    """An int4 store on the card: device-born ingest of pre-quantized
    rows, K6 on every route, deletes honored, and a quantized checkpoint
    that reloads with the same answers."""
    from picovdb_tpu_torch import PicoVectorDB

    g = torch.Generator(device=dev).manual_seed(3)
    n, dim = 20_000, 128
    rows = torch.nn.functional.normalize(
        torch.randn(n, dim, generator=g, device=dev), dim=1)
    v4, vs = scan.quantize_rows_i4(rows)
    ids = [f"r{i}" for i in range(n)]
    base = str(tmp_path / "i4")
    db = PicoVectorDB(embedding_dim=dim, storage_file=base,
                      storage_dtype="int4", device=dev)
    db.ingest_device(v4, ids, scales=vs, normalize=False)
    before = scan.LAUNCHES["scan_topk_i4"]
    q = rows[:64].cpu().numpy()
    got, _ = db.query_columnar(q, top_k=5)
    assert db.last_query_debug()["strategy"] == "i4stor_fused"
    assert scan.LAUNCHES["scan_topk_i4"] > before
    assert (got[:, 0] == [f"r{i}" for i in range(64)]).mean() >= 0.9
    db.delete([f"r{i}" for i in range(10)])
    back, _ = db.query_columnar(q[:10], top_k=5)
    assert not set(back.ravel().tolist()) & {f"r{i}" for i in range(10)}
    db.save(quantized=True)
    db2 = PicoVectorDB(embedding_dim=dim, storage_file=base,
                       storage_dtype="int4", device=dev)
    again, _ = db2.query_columnar(q, top_k=5)
    assert (again == db.query_columnar(q, top_k=5)[0]).all()


def _ivf_data(dev, kind, dim, nq, n_tiles=16, grid_b=10, n_hot=7, seed=1):
    """Postings of n_tiles IVF tiles in the kernel's dtype, a row mask, and
    a hot table of grid_b tiles of which the first n_hot are live."""
    from picovdb_tpu_torch.ops import ivf

    q, v, mask = _data(dev, cap=n_tiles * ivf.IVF_BN, dim=dim, nq=nq, seed=seed)
    if kind == "i8c":
        v, cs = scan.quantize_cols_i8(v)
        q = scan.fold_queries_i8(q, cs)
    elif kind == "bf16":
        q, v = q.to(torch.bfloat16), v.to(torch.bfloat16)
    g = torch.Generator().manual_seed(seed)
    hot = torch.randperm(n_tiles, generator=g)[:grid_b].sort().values
    hot = hot.to(torch.int32).to(dev)
    return q, v, mask, hot, torch.tensor([n_hot], dtype=torch.int32, device=dev)


# (kind, Q, k): both K7 configurations (k <= 128: 16-query tiles; wider:
# 2-query tiles), all three kinds, a query count that is not a tile multiple
@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("kind,nq,k", [("f32", 1, 14), ("bf16", 16, 32),
                                       ("i8c", 16, 36), ("f32", 16, 300),
                                       ("i8c", 3, 544), ("bf16", 5, 200)])
def test_ivf_scan_topk(dev, kind, nq, k, dim):
    from picovdb_tpu_torch.ops import ivf

    q, v, mask, hot, n_hot = _ivf_data(dev, kind, dim, nq)
    before = scan.LAUNCHES["ivf_scan_topk"]
    vals, idx = ivf.ivf_scan_topk(q, v, mask, hot, n_hot, k)
    assert scan.LAUNCHES["ivf_scan_topk"] == before + 1
    rv, ri = ivf.ivf_scan_topk_plain(q, v, mask, hot, n_hot, k)
    torch.cuda.synchronize()
    assert torch.equal(torch.isneginf(vals), torch.isneginf(rv))
    if kind == "i8c":  # integer scores, ties to the lower row: exact
        assert torch.equal(vals, rv) and torch.equal(idx, ri)
    else:
        fin = torch.isfinite(rv)
        assert float((vals[fin] - rv[fin]).abs().max()) <= 1e-5
    live_tiles = set(hot[: int(n_hot)].tolist())
    got = idx[torch.isfinite(vals)].long()
    assert bool(mask[got].all())
    assert set((got // ivf.IVF_BN).tolist()) <= live_tiles  # no dead step


@pytest.mark.parametrize("kind", ["f32", "i8c"])
def test_ivf_scan_topk_no_hot_tile(dev, kind):
    """n_hot = 0 (every probed cluster empty): every step is dead and the
    whole result is empty."""
    from picovdb_tpu_torch.ops import ivf

    q, v, mask, hot, _ = _ivf_data(dev, kind, 64, 4)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    vals, idx = ivf.ivf_scan_topk(q, v, mask, hot, zero, 20)
    keys = ivf.ivf_segmax_scan(q, v, mask, hot, zero, 4)
    torch.cuda.synchronize()
    assert bool(torch.isneginf(vals).all()) and int(idx.abs().sum()) == 0
    assert bool((keys == scan.KEY_MIN).all())


@pytest.mark.parametrize("dim", DIMS + [1024])
@pytest.mark.parametrize("kind,nq,per_seg", [("f32", 64, 4), ("bf16", 64, 8),
                                             ("i8c", 70, 4), ("f32", 3, 8),
                                             ("i8c", 16, 8)])
def test_ivf_segmax_scan(dev, kind, nq, per_seg, dim):
    from picovdb_tpu_torch.ops import ivf

    q, v, mask, hot, n_hot = _ivf_data(dev, kind, dim, nq)
    before = scan.LAUNCHES["ivf_segmax"]
    keys = ivf.ivf_segmax_scan(q, v, mask, hot, n_hot, per_seg)
    assert scan.LAUNCHES["ivf_segmax"] == before + 1
    ref = ivf.ivf_segmax_scan_plain(q, v, mask, hot, n_hot, per_seg)
    torch.cuda.synchronize()
    assert keys.shape == ref.shape
    if kind == "i8c":  # raw int32 scores: bit for bit
        assert torch.equal(keys, ref)
        return
    live = keys != scan.KEY_MIN
    assert torch.equal(live, ref != scan.KEY_MIN)
    dec = lambda k: scan._from_sortable(k & ~127).view(torch.float32)  # noqa: E731
    assert float((dec(keys)[live] - dec(ref)[live]).abs().max()) <= 1e-5
    # dead steps (columns of hot[b] with b >= n_hot) are all KEY_MIN
    ns = ivf.IVF_BN // scan.SEG
    assert not bool(live[:, int(n_hot) * per_seg * ns:].any())


@pytest.mark.parametrize("kind", ["f32", "i8c"])
def test_ivf_scan_topk_bounded_partials(dev, kind, monkeypatch):
    """A small partial-result bound forces fewer blocks per tile and query
    groups; the answer must not change."""
    from picovdb_tpu_torch.ops import ivf

    q, v, mask, hot, n_hot = _ivf_data(dev, kind, 96, 40)
    want = ivf.ivf_scan_topk(q, v, mask, hot, n_hot, 200)
    monkeypatch.setattr(ivf, "_PARTIAL_BYTES", 10 * 200 * 8 * 3)
    got = ivf.ivf_scan_topk(q, v, mask, hot, n_hot, 200)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
