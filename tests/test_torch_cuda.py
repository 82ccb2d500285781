"""picovdb_tpu_torch's CUDA kernels against their plain versions, on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda.py -q

Shapes are small; `chip_smoke.py` checks the same kernels at the main
path's shapes. K1's keys (either product: the TMA + wgmma mainloop at
dim % 8 == 0, the wmma tile otherwise) decode within 1e-4 of the plain
version's, and the rows K2 picks from them rescore equal to the plain
version's outside a 1e-4 k/k+1 gap. Tolerances: K5 / K10 keys, K9 and P1 int8 results and
int8 / int4 scores are exact (integer sums, at most one float32
conversion and one multiply); float32 / bf16 scores within 1e-5
(summation order). K8's float keys also within 1e-5:
unit-vector scores stay below 1, where summation order moves a key by at
most one 128-ulp quantum (7.6e-6), while a TF32 product would be off by
several 1e-5 at these widths.
"""

import pytest
import torch

from picovdb_tpu_torch.ops import scan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

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

# K1 cases (dim, Q, cap): dims that are multiples of 8 run the TMA + wgmma
# mainloop (1024: 16 full k-stages; 768; 96: a half-filled second stage),
# 50 the wmma tile. Q = 17 and 200 leave a partial 128-query tile, 2048 is
# the serving chunk; cap % 256 == 128 (8320, 4224) leaves the last tile's
# second segment past the end.
SEGMAX_CASES = [(96, 200, 8192), (50, 200, 8192), (1024, 17, 8320),
                (768, 200, 4224), (1024, 2048, 16384), (96, 2048, 8320),
                (50, 17, 4224)]


def _dec(keys):
    return scan._from_sortable(keys & ~127).view(torch.float32)


def _decode_rescore(q, v, keys, k_sel):
    """K2's top-k_sel of a key slab, rows decoded as (c // 2) * 128 +
    (key & 127), rescored exactly against the float32 rows."""
    tk, tc = scan.topk_packed_keys(keys, k_sel)
    rows = (tc // 2) * scan.SEG + (tk & (scan.SEG - 1))
    empty = tk == scan.KEY_MIN
    vals = torch.where(empty, float("-inf"), 0.0)
    return scan.rescore_exact(q, v, vals, torch.where(empty, 0, rows))


@pytest.mark.parametrize("dim,nq,cap", SEGMAX_CASES)
def test_segmax_and_topk_keys(dev, dim, nq, cap):
    """K1 against its plain version: the same KEY_MIN pattern (fully
    masked segments included), decoded values within 1e-4 (bf16 products
    summed in another order), K2 equal on both slabs, and the decoded,
    rescored rows equal wherever the k-th/(k+1)-th exact gap exceeds 1e-4
    (a wrong lane or column mapping fails here, not in the values)."""
    q, v, mask = _data(dev, cap=cap, dim=dim, nq=nq)
    mask[128:256] = False  # a fully masked segment, and the last one
    mask[cap - 128:] = False
    qb, vb = q.to(torch.bfloat16), v.to(torch.bfloat16)
    before = dict(scan.LAUNCHES)
    keys = scan.segmax_scan(qb, vb, mask)
    assert scan.LAUNCHES["segmax"] == before["segmax"] + 1
    assert (scan.LAUNCHES["segmax_wgmma"] - before["segmax_wgmma"]
            == (dim % 8 == 0))
    ref = scan.segmax_scan_plain(qb, vb, mask)
    torch.cuda.synchronize()
    assert keys.shape == ref.shape == (nq, 2 * cap // scan.SEG)
    live = keys != scan.KEY_MIN
    assert torch.equal(live, ref != scan.KEY_MIN)
    assert not bool(live[:, 2:4].any()) and not bool(live[:, -2:].any())
    assert float((_dec(keys)[live] - _dec(ref)[live]).abs().max()) <= 1e-4
    tk, tc = scan.topk_packed_keys(keys, 16)
    rk, _ = scan.topk_packed_keys_plain(keys, 16)
    assert torch.equal(tk, rk)
    assert torch.equal(torch.gather(keys, 1, tc.long()), tk)
    tk, _ = scan.topk_packed_keys(ref, 16)
    assert torch.equal(tk, scan.topk_packed_keys_plain(ref, 16)[0])
    k = 10
    ex_k, id_k = _decode_rescore(q, v, keys, k + 6)
    ex_p, id_p = _decode_rescore(q, v, ref, k + 6)
    assert float((ex_k[:, :k] - ex_p[:, :k]).abs().max()) <= 1e-5
    gap = (ex_p[:, k - 1] - ex_p[:, k]).cpu()
    a, b = id_k[:, :k].cpu(), id_p[:, :k].cpu()
    for i in range(nq):
        if gap[i] > 1e-4:
            assert set(a[i].tolist()) == set(b[i].tolist()), i
    assert bool(mask[id_k[:, :k].long()].all())


def test_segmax_misaligned_view_takes_wmma(dev):
    """A bf16 corpus whose base is 2 bytes off a 16-byte boundary: TMA
    cannot read it, so K1 runs the wmma tile, with the plain version's
    keys."""
    q, v, mask = _data(dev, cap=4096, dim=96, nq=64)
    qb = q.to(torch.bfloat16)
    flat = torch.empty(v.numel() + 8, dtype=torch.bfloat16, device=dev)
    vb = flat[1:1 + v.numel()].view(v.shape)
    vb.copy_(v)
    assert not scan.wgmma_ready(qb, vb)
    before = scan.LAUNCHES["segmax_wgmma"]
    keys = scan.segmax_scan(qb, vb, mask)
    assert scan.LAUNCHES["segmax_wgmma"] == before
    ref = scan.segmax_scan_plain(qb, vb, mask)
    torch.cuda.synchronize()
    live = keys != scan.KEY_MIN
    assert torch.equal(live, ref != scan.KEY_MIN)
    assert float((_dec(keys)[live] - _dec(ref)[live]).abs().max()) <= 1e-4


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


@pytest.mark.parametrize("dim", DIMS + [1024])
@pytest.mark.parametrize("nq,k", [(1, 16), (16, 12), (5, 300), (17, 16)])
def test_fused_topk_i8c_exact(dev, dim, nq, k):
    """K9 ranks the raw int32 sums, ties to the lower row: bit for bit its
    plain version, on the one-query sweep wherever `sweep_ready` holds
    (Q <= 16, k <= 128, dim % 16 == 0: here dim 96 and 1024 at Q 1 and
    16), else on the template (dim 50, k 300, Q 17)."""
    q, v, mask = _data(dev, dim=dim, nq=nq)
    v8, cs = scan.quantize_cols_i8(v)
    q8 = scan.fold_queries_i8(q, cs)
    sweep = nq <= 16 and dim % 16 == 0 and k <= 128
    assert scan.sweep_ready(q8, v8, k) == sweep
    before = dict(scan.LAUNCHES)
    vals, idx = scan.fused_topk_i8c(q8, v8, mask, k)
    assert scan.LAUNCHES["scan_topk_i8c"] == before["scan_topk_i8c"] + 1
    assert (scan.LAUNCHES["scan_topk_i8c_sweep"]
            - before["scan_topk_i8c_sweep"] == sweep)
    rv, ri = scan.fused_topk_i8c_plain(q8, v8, mask, k)
    torch.cuda.synchronize()
    assert torch.equal(vals, rv) and torch.equal(idx, ri)


def _sweep_case(dev, dim, nq, cap, seed):
    """Column-scaled rows and folded queries with the sweep's edges: two
    equal rows on either side of a CTA range boundary c, both 127 *
    sign(q8[0]), the largest sum query 0 can reach (so its top two, lower
    row first), and one whole range masked. Returns q8, v8, mask, c."""
    q, v, mask = _data(dev, cap=cap, dim=dim, nq=nq, seed=seed)
    v8, cs = scan.quantize_cols_i8(v)
    q8 = scan.fold_queries_i8(q, cs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk, n = scan.sweep_partition(cap, sms)
    assert n >= 3, (chunk, n)
    c = chunk  # the boundary between ranges 0 and 1
    best = torch.where(q8[0] >= 0, 127, -127).to(torch.int8)
    v8[c - 1] = v8[c] = best
    mask[c - 1] = mask[c] = True
    mask[2 * chunk:3 * chunk] = False  # range 2 has no live row
    return q8, v8, mask, c


@pytest.mark.parametrize("dim", [1024, 96])
@pytest.mark.parametrize("nq", [1, 8, 16])
@pytest.mark.parametrize("k", [1, 16, 128])
def test_fused_topk_i8c_sweep(dev, dim, nq, k):
    """K9's one-query sweep, bit for bit its plain version, with ties
    across a range boundary (the lower row first) and a range with no live
    row; the sweep's counter moves."""
    q8, v8, mask, c = _sweep_case(dev, dim, nq, 300 * 128 + 40, nq + k)
    assert scan.sweep_ready(q8, v8, k)
    before = scan.LAUNCHES["scan_topk_i8c_sweep"]
    vals, idx = scan.fused_topk_i8c(q8, v8, mask, k)
    assert scan.LAUNCHES["scan_topk_i8c_sweep"] == before + 1
    rv, ri = scan.fused_topk_i8c_plain(q8, v8, mask, k)
    torch.cuda.synchronize()
    assert torch.equal(vals, rv) and torch.equal(idx, ri)
    assert idx[0, :2].tolist()[:k] == [c - 1, c][:k]  # the tie, lower first


def test_fused_topk_i8c_sweep_few_live_rows(dev):
    """k above the live count: the sweep's empty partials merge to -inf /
    row 0 past the live rows, as the plain version."""
    q, v, _ = _data(dev, cap=20_000, dim=128, nq=3)
    v8, cs = scan.quantize_cols_i8(v)
    q8 = scan.fold_queries_i8(q, cs)
    mask = torch.zeros(20_000, dtype=torch.bool, device=dev)
    mask[[7, 9000, 19_999]] = True
    vals, idx = scan.fused_topk_i8c(q8, v8, mask, 16)
    rv, ri = scan.fused_topk_i8c_plain(q8, v8, mask, 16)
    torch.cuda.synchronize()
    assert torch.equal(vals, rv) and torch.equal(idx, ri)
    assert bool(torch.isneginf(vals[:, 3:]).all()) and not bool(idx[:, 3:].any())


@pytest.mark.parametrize("dim", DIMS + [1024])
def test_segmax_scan_i8c_keys_exact(dev, dim):
    q, v, mask = _data(dev, dim=dim, nq=200)
    v8, cs = scan.quantize_cols_i8(v)
    q8 = scan.fold_queries_i8(q, cs)
    before = scan.LAUNCHES["segmax_i8c"]
    keys = scan.segmax_scan_i8c(q8, v8, mask)
    assert scan.LAUNCHES["segmax_i8c"] == before + 1
    ref = scan.segmax_scan_i8c_plain(q8, v8, mask)
    torch.cuda.synchronize()
    assert torch.equal(keys, ref)


@pytest.mark.parametrize("dim,nq,cap", [(96, 130, 8192), (50, 130, 8192),
                                        (1024, 130, 8192), (768, 17, 4224),
                                        (1024, 2048, 8320)])
def test_dot_rowmax(dev, dim, nq, cap):
    """P1: int8 row maxima bit for bit, through the mainloop's int8
    instantiation wherever dim % 16 == 0 (dim 50: the mma.sync tile; cap
    % 256 == 128 leaves the last tile's zero-filled segment out of the
    max); bf16 maxima within 1e-5 (float32 sums of exact bf16 products,
    in another order), through the TMA + wgmma mainloop wherever dim % 8
    == 0."""
    from picovdb_tpu_torch import probes

    q, v, _ = _data(dev, cap=cap, dim=dim, nq=nq)
    q8, v8 = scan.quantize_rows_i8(q)[0], scan.quantize_rows_i8(v)[0]
    before = dict(scan.LAUNCHES)
    got = probes.dot_rowmax(q8, v8)
    assert scan.LAUNCHES["dot_rowmax"] == before["dot_rowmax"] + 1
    assert (scan.LAUNCHES["dot_rowmax_i8_wgmma"]
            - before["dot_rowmax_i8_wgmma"] == (dim % 16 == 0))
    assert torch.equal(got, probes.dot_rowmax_plain(q8, v8))
    qb, vb = q.to(torch.bfloat16), v.to(torch.bfloat16)
    got = probes.rowmax_value(probes.dot_rowmax(qb, vb))
    assert (scan.LAUNCHES["dot_rowmax_wgmma"] - before["dot_rowmax_wgmma"]
            == (dim % 8 == 0))
    ref = probes.rowmax_value(probes.dot_rowmax_plain(qb, vb))
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-5


def test_dot_rowmax_i8_edges(dev):
    """P1-int8 on the mainloop where every sum is negative, at cap % 256
    == 128 and Q = 17: the zero-filled rows past cap and past Q (sums of
    0) must never enter a maximum. A view 1 byte off 16-byte alignment
    takes the mma.sync tile; both bit for bit the plain version."""
    from picovdb_tpu_torch import probes

    q, v, _ = _data(dev, cap=4224, dim=768, nq=17)
    q8 = -scan.quantize_rows_i8(q)[0].abs()
    v8 = scan.quantize_rows_i8(v)[0].abs()
    v8[:, 0] = 1  # every row meets a query's -127 at least once: sums < 0
    q8[:, 0] = -127
    ref = probes.dot_rowmax_plain(q8, v8)
    assert bool((ref < 0).all())
    before = scan.LAUNCHES["dot_rowmax_i8_wgmma"]
    got = probes.dot_rowmax(q8, v8)
    assert scan.LAUNCHES["dot_rowmax_i8_wgmma"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    flat = torch.empty(v8.numel() + 16, dtype=torch.int8, device=dev)
    vm = flat[1:1 + v8.numel()].view(v8.shape)
    vm.copy_(v8)
    assert not scan.wgmma_i8_ready(q8, vm)
    got = probes.dot_rowmax(q8, vm)
    assert scan.LAUNCHES["dot_rowmax_i8_wgmma"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, probes.dot_rowmax_plain(q8, vm))


@pytest.mark.parametrize("smallq_i8c", [False, True])
def test_store_on_second_card(dev, tmp_path, monkeypatch, smallq_i8c):
    """A store on cuda:1 while the current device is 0 serves a batch
    (K1 + K2) and a Q = 1 query (K3, or with PICOVDB_SMALLQ_I8C=1 K9's
    sweep) through kernels launched on its own card, equal to the same
    store on cuda:0. Skips on a machine with one card."""
    import numpy as np

    from picovdb_tpu_torch import PicoVectorDB

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    if smallq_i8c:
        monkeypatch.setenv("PICOVDB_SMALLQ_I8C", "1")
    torch.cuda.set_device(0)
    rng = np.random.default_rng(7)
    n, dim = 40_960, 128
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    q = vecs[:64] + 0.01 * rng.normal(size=(64, dim)).astype(np.float32)
    out = {}
    for name in ("cuda:0", "cuda:1"):
        db = PicoVectorDB(embedding_dim=dim, device=name,
                          storage_file=str(tmp_path / name.replace(":", "")))
        db.upsert_columnar(vecs, ids=[str(i) for i in range(n)])
        before = dict(scan.LAUNCHES)
        ids, scores = db.query_columnar(q, top_k=10)
        batch = db.last_query_debug()["strategy"]
        one = db.query(q[0], top_k=10)
        single = db.last_query_debug()["strategy"]
        assert torch.cuda.current_device() == 0
        assert scan.LAUNCHES["segmax"] > before["segmax"]
        key = "scan_topk_i8c_sweep" if smallq_i8c else "scan_topk_i8"
        assert scan.LAUNCHES[key] > before[key], (name, single)
        out[name] = (ids, scores, batch, [h["_id_"] for h in one], single)
    a, b = out["cuda:0"], out["cuda:1"]
    assert (a[0] == b[0]).all() and np.array_equal(a[1], b[1])
    assert a[2:] == b[2:]
