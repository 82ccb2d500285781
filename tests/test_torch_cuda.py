"""picovdb_tpu_torch's CUDA kernels against their plain versions, on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda.py -q

Shapes are small; `chip_smoke.py` checks the same kernels at the main
path's shapes. K1's keys (any product: the TMA + wgmma mainloop at
dim % 8 == 0, the mainloop fed by cp.async at other even widths, by its
realigning producer at odd widths and on 2-byte aligned views, and the
wmma tile those replaced) decode within 1e-4 of the plain
version's, and the rows K2 picks from them rescore equal to the plain
version's outside a 1e-4 k/k+1 gap. K2's split-row warp select returns
`torch.topk`'s keys bit for bit, its columns by the tie rule (equal keys:
the larger column first). Tolerances: K5 / K10 keys, K9 and
P1 int8 results, int8 / int4 scores, and K7's sweep on scores that are
exact in float32 are exact (integer sums, at most one float32 conversion
and one multiply); float32 / bf16 scores within 1e-5 (summation order).
K6's sweep and tensor-core scan equal the plain version bit for bit, vals
and idx (exact int32 sums, one conversion, one multiply, ties to the
lower row), over repeated launches.
K8's float keys also within 1e-5: unit-vector scores stay below 1, where
summation order moves a key by at most one 128-ulp quantum (7.6e-6),
while a TF32 product would be off by several 1e-5 at these widths; its
tensor-core segment scan (3xTF32 for float32 postings) is held to the
same limit, and its int8 keys bit for bit. K3's sweep (the row-scaled
int8 kind) and its tensor-core scan's int8 kind equal the plain version
bit for bit, vals and idx.
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
# 50 the mainloop fed by cp.async (4-byte pieces). Q = 17 and 200 leave a partial 128-query tile, 2048 is
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
    """A bf16 corpus whose base is 2 bytes off a 16-byte boundary: neither
    TMA nor cp.async can read it, so K1 runs the mainloop fed by its
    realigning producer (until it came, the wmma tile), with the plain
    version's keys."""
    q, v, mask = _data(dev, cap=4096, dim=96, nq=64)
    qb = q.to(torch.bfloat16)
    flat = torch.empty(v.numel() + 8, dtype=torch.bfloat16, device=dev)
    vb = flat[1:1 + v.numel()].view(v.shape)
    vb.copy_(v)
    assert not scan.wgmma_ready(qb, vb) and scan.realign_ready(qb, vb)
    before = dict(scan.LAUNCHES)
    keys = scan.segmax_scan(qb, vb, mask)
    assert scan.LAUNCHES["segmax_wgmma"] == before["segmax_wgmma"]
    assert scan.LAUNCHES["segmax_realign"] == before["segmax_realign"] + 1
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


def _i4_store(dev, cap, dim, nq, seed=0, negative=False):
    """Packed int4 rows with ties (rows 5 and 6 are row 1's copies, one
    across a 128-row boundary at 130), a masked block, and int8 queries.
    `negative`: non-negative rows against non-positive queries, so every
    score is <= 0 and a zero-filled row past cap (its sum 0 - 8 sum(q) > 0
    before the scale) would beat them all if it were not skipped."""
    g = torch.Generator().manual_seed(seed)
    v = torch.randn(cap, dim, generator=g)
    q = torch.randn(nq, dim, generator=g)
    if negative:
        v, q = v.abs(), -q.abs()
    v[5], v[6], v[130] = v[1], v[1], v[1]
    v = torch.nn.functional.normalize(v, dim=1)
    mask = torch.rand(cap, generator=g) > 0.2
    mask[1] = mask[5] = mask[130] = True
    mask[256:512] = False
    q8, _ = scan.quantize_rows_i8(torch.nn.functional.normalize(q, dim=1))
    v4, vs = scan.quantize_rows_i4(v)
    return q8.to(dev), v4.to(dev), vs.to(dev), mask.to(dev)


def _i4_exact(q8, v4, vs, mask, k, key, repeats=1):
    """K6 on the kernel that `key` counts, `repeats` launches in a row,
    each bit for bit the plain version (vals and idx)."""
    ref = scan.scan_topk_plain(q8, v4, vs, mask, k, int4=True)
    for _ in range(repeats):
        before = dict(scan.LAUNCHES)
        got = scan.fused_topk_i4(q8, v4, vs, mask, k)
        assert scan.LAUNCHES[key] == before[key] + 1, key
        assert scan.LAUNCHES["scan_topk_i4"] == before["scan_topk_i4"] + 1
        torch.cuda.synchronize()
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    return got


# (cap, dim): ragged caps (not a multiple of 128 or of 256)
I4_SHAPES = [(8195, 1024), (4100, 128)]


@pytest.mark.parametrize("cap,dim", I4_SHAPES + [(3001, 96)])
@pytest.mark.parametrize("k", [1, 14, 128])
@pytest.mark.parametrize("nq", [1, 2, 4, 5, 16])
def test_fused_topk_i4_sweep_exact(dev, nq, k, cap, dim):
    """K6's one-query sweep (int4 kind) = the plain version bit for bit,
    ties to the lower row: on `scan_topk_i4_sweep` up to I4_SWEEP_Q_MAX
    queries, launched directly past it (chip_smoke times it there)."""
    q8, v4, vs, mask = _i4_store(dev, cap, dim, nq, seed=nq + k)
    if nq <= scan.I4_SWEEP_Q_MAX:
        assert scan.i4_sweep_ready(q8, v4, k)
        _i4_exact(q8, v4, vs, mask, k, "scan_topk_i4_sweep")
        return
    got = scan._sweep_launch(q8, v4, vs, mask, k, "fused_topk_i4")
    ref = scan.scan_topk_plain(q8, v4, vs, mask, k, int4=True)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("cap,dim", I4_SHAPES)
@pytest.mark.parametrize("k", [1, 14, 128])
@pytest.mark.parametrize("nq", [5, 16, 17, 64, 130, 2048])
def test_fused_topk_i4_wgmma_exact(dev, nq, k, cap, dim):
    """K6's tensor-core scan = the plain version bit for bit over ragged
    caps, three launches in a row (a missing proxy fence between the
    expansion's shared-memory writes and wgmma shows as a rare wrong
    result)."""
    q8, v4, vs, mask = _i4_store(dev, cap, dim, nq, seed=nq + k)
    assert scan.i4_wgmma_ready(q8, v4, k)
    _i4_exact(q8, v4, vs, mask, k, "scan_topk_i4_wgmma", repeats=3)


@pytest.mark.parametrize("nq,key", [(1, "scan_topk_i4_sweep"),
                                    (4, "scan_topk_i4_sweep"),
                                    (5, "scan_topk_i4_wgmma"),
                                    (200, "scan_topk_i4_wgmma")])
def test_fused_topk_i4_negative_scores_beside_rows_past_cap(dev, nq, key):
    """Every score <= 0 and cap % 256 == 129: the rows the tensor-core
    scan's last tile holds past cap (zero bytes, whose sum before the
    scale is positive) and the sweep's ragged range never surface."""
    q8, v4, vs, mask = _i4_store(dev, 4225, 1024, nq, negative=True)
    ref = scan.scan_topk_plain(q8, v4, vs, mask, 14, int4=True)
    assert bool((ref[0] <= 0).all())
    got = _i4_exact(q8, v4, vs, mask, 14, key, repeats=2)
    assert int(got[1].max()) < 4225


@pytest.mark.parametrize("nq,key", [(1, "scan_topk_i4_sweep"),
                                    (64, "scan_topk_i4_wgmma")])
def test_fused_topk_i4_ranks_live_rows_whatever_their_scale(dev, nq, key):
    """Whether a row is ranked depends on its mask bit and index alone: live
    rows with a scale of 0 or below (ingest_device takes the caller's
    scales) score float(sum) x scale, ties to the lower row, as the plain
    version ranks them, beside masked rows and rows past cap."""
    # every sum <= 0: rows of scale 0 (the even ones) score 0 and beat the
    # other positive-scale rows; three odd rows of negative scale score
    # above 0 and come first
    q8, v4, vs, mask = _i4_store(dev, 4225, 1024, nq, seed=9, negative=True)
    rows = torch.arange(4225, device=dev)
    vs = torch.where(rows % 2 == 0, 0.0, vs)
    neg = torch.tensor([3, 1001, 4001], device=dev)
    vs[neg], mask[neg] = -vs[neg], True
    ref = scan.scan_topk_plain(q8, v4, vs, mask, 128, int4=True)
    assert bool((ref[1][:, :3].sort(dim=1).values == neg.int()).all())
    assert bool((ref[0][:, 3:] == 0).all())
    _i4_exact(q8, v4, vs, mask, 128, key, repeats=2)


def test_fused_topk_i4_repeated_batches_agree(dev):
    """Twenty launches of the tensor-core scan at Q = 256 over 64 Ki rows,
    every one the first one's result bit for bit."""
    q8, v4, vs, mask = _i4_store(dev, 65536, 1024, 256, seed=3)
    first = _i4_exact(q8, v4, vs, mask, 14, "scan_topk_i4_wgmma")
    outs = [scan.fused_topk_i4(q8, v4, vs, mask, 14) for _ in range(20)]
    torch.cuda.synchronize()
    for vals, idx in outs:
        assert torch.equal(vals, first[0]) and torch.equal(idx, first[1])


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


# (kind, Q, k): K7's one-query sweep where `ivf_sweep_ready` holds (Q <=
# 16, k <= 128, dim 96; dim 50 rows are not whole 16-byte words: its narrow
# kind) and its other kinds otherwise (k 300 / 544 / 200, Q 17), all three
# kinds
@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("kind,nq,k", [("f32", 1, 14), ("bf16", 16, 32),
                                       ("i8c", 16, 36), ("f32", 16, 300),
                                       ("i8c", 3, 544), ("bf16", 5, 200),
                                       ("i8c", 17, 14), ("f32", 17, 14)])
def test_ivf_scan_topk(dev, kind, nq, k, dim):
    from picovdb_tpu_torch.ops import ivf

    q, v, mask, hot, n_hot = _ivf_data(dev, kind, dim, nq)
    sweep = nq <= 16 and k <= 128 and dim % 16 == 0
    assert ivf.ivf_sweep_ready(q, v, k) == sweep
    before = dict(scan.LAUNCHES)
    vals, idx = ivf.ivf_scan_topk(q, v, mask, hot, n_hot, k)
    assert scan.LAUNCHES["ivf_scan_topk"] == before["ivf_scan_topk"] + 1
    assert (scan.LAUNCHES["ivf_scan_topk_sweep"]
            - before["ivf_scan_topk_sweep"] == sweep)
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


def _sweep_ivf_case(dev, kind, nq, n_hot, seed, dim=96, n_tiles=16,
                    grid_b=10):
    """Postings whose scores are exact in float32 in every kind (multiples
    of 1/16 in [-1, 1]; int8: integers), so the sweep must equal the plain
    version bit for bit and its many ties go to the lower row; an
    unsorted hot table of grid_b tiles, the first n_hot live. Query 0's
    largest reachable score is planted on the two rows on either side of
    the first share boundary of the card's CTAs and of the first hot-tile
    boundary. Returns the inputs and the two pairs of physical rows."""
    from picovdb_tpu_torch.ops import ivf

    g = torch.Generator().manual_seed(seed)
    cap = n_tiles * ivf.IVF_BN
    if kind == "i8c":
        v = torch.randint(-127, 128, (cap, dim), generator=g, dtype=torch.int8)
        q = torch.randint(-127, 128, (nq, dim), generator=g, dtype=torch.int8)
        best = torch.where(q[0] >= 0, 127, -127).to(torch.int8)
    else:
        dt = torch.float32 if kind == "f32" else torch.bfloat16
        v = (torch.randint(-16, 17, (cap, dim), generator=g) / 16).to(dt)
        q = (torch.randint(-16, 17, (nq, dim), generator=g) / 16).to(dt)
        best = torch.where(q[0] >= 0, 1.0, -1.0).to(dt)
    mask = torch.rand(cap, generator=g) > 0.2
    hot = torch.randperm(n_tiles, generator=g)[:grid_b].to(torch.int32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    live = n_hot * ivf.IVF_BN
    ends = [e for _, e in ivf.ivf_sweep_partition(
        n_hot, ivf.IVF_BN, scan.SWEEP_CTAS_PER_SM * sms) if 0 < e < live]
    pairs = []
    for b in ends[:1] + ([ivf.IVF_BN] if n_hot >= 2 else []):
        rows = [int(hot[i // ivf.IVF_BN]) * ivf.IVF_BN + i % ivf.IVF_BN
                for i in (b - 1, b)]
        v[rows] = best
        mask[rows] = True
        pairs.append(sorted(rows))
    n = torch.tensor([n_hot], dtype=torch.int32)
    return (q.to(dev), v.to(dev), mask.to(dev), hot.to(dev), n.to(dev)), pairs


@pytest.mark.parametrize("kind", ["f32", "bf16", "i8c"])
@pytest.mark.parametrize("nq", [1, 8, 16])
@pytest.mark.parametrize("k", [1, 14, 128])
@pytest.mark.parametrize("n_hot", [0, 1, 7, 10])
def test_ivf_scan_topk_sweep(dev, kind, nq, k, n_hot):
    """K7's one-query sweep, bit for bit its plain version on exact scores
    (ties to the lower row, across a share boundary of the card's CTAs and
    across a tile boundary of the unsorted hot table), dead steps never
    read (n_hot 0: -inf / row 0 everywhere; 10 = grid_b: none dead); the
    sweep's counter moves."""
    from picovdb_tpu_torch.ops import ivf

    args, pairs = _sweep_ivf_case(dev, kind, nq, n_hot, seed=nq + k + n_hot)
    assert ivf.ivf_sweep_ready(args[0], args[1], k)
    before = scan.LAUNCHES["ivf_scan_topk_sweep"]
    vals, idx = ivf.ivf_scan_topk(*args, k)
    assert scan.LAUNCHES["ivf_scan_topk_sweep"] == before + 1
    rv, ri = ivf.ivf_scan_topk_plain(*args, k)
    torch.cuda.synchronize()
    assert torch.equal(vals, rv) and torch.equal(idx, ri)
    if n_hot == 0:
        assert bool(torch.isneginf(vals).all()) and not bool(idx.any())
    hot, mask = args[3], args[2]
    got = idx[torch.isfinite(vals)].long()
    assert bool(mask[got].all())
    live_tiles = set(hot[:n_hot].tolist())
    assert set((got // ivf.IVF_BN).tolist()) <= live_tiles
    if pairs:  # query 0's planted ties, the lowest rows first
        tops = sorted(r for p in pairs for r in p)[:k]
        assert idx[0, :len(tops)].tolist() == tops


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
    (Q <= I8C_SWEEP_Q_MAX, k <= 128, dim % 16 == 0: here dim 96 and 1024
    at Q 1), else on another of its kinds (dim 50: the narrow kind; k 300:
    the wide kind; Q 17: the tensor-core scan), never the template."""
    q, v, mask = _data(dev, dim=dim, nq=nq)
    v8, cs = scan.quantize_cols_i8(v)
    q8 = scan.fold_queries_i8(q, cs)
    sweep = nq <= scan.I8C_SWEEP_Q_MAX and dim % 16 == 0 and k <= 128
    assert scan.sweep_ready(q8, v8, k) == sweep
    kinds = [n for n in scan.LAUNCHES if n.startswith("scan_topk_i8c_")]
    before = dict(scan.LAUNCHES)
    vals, idx = scan.fused_topk_i8c(q8, v8, mask, k)
    assert scan.LAUNCHES["scan_topk_i8c"] == before["scan_topk_i8c"] + 1
    assert (scan.LAUNCHES["scan_topk_i8c_sweep"]
            - before["scan_topk_i8c_sweep"] == sweep)
    assert sum(scan.LAUNCHES[n] - before[n] for n in kinds) == 1
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
    row; the sweep's counter moves (past I8C_SWEEP_Q_MAX, where the
    tensor-core scan takes the dispatch, the sweep launched alone)."""
    q8, v8, mask, c = _sweep_case(dev, dim, nq, 300 * 128 + 40, nq + k)
    assert scan.sweep_ready(q8, v8, k) == (nq <= scan.I8C_SWEEP_Q_MAX)
    if nq <= scan.I8C_SWEEP_Q_MAX:
        before = scan.LAUNCHES["scan_topk_i8c_sweep"]
        vals, idx = scan.fused_topk_i8c(q8, v8, mask, k)
        assert scan.LAUNCHES["scan_topk_i8c_sweep"] == before + 1
    else:
        vals, idx = scan._sweep_launch(q8, v8, None, mask, k,
                                       "fused_topk_i8c")
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
    """K10's keys bit for bit the plain version's: on the int8 mainloop fed
    by TMA at dim % 16 == 0 (96, 1024), by its realigning producer at dim
    50 (50-byte rows: cp.async takes whole 4 bytes)."""
    q, v, mask = _data(dev, dim=dim, nq=200)
    v8, cs = scan.quantize_cols_i8(v)
    q8 = scan.fold_queries_i8(q, cs)
    before = dict(scan.LAUNCHES)
    keys = scan.segmax_scan_i8c(q8, v8, mask)
    assert scan.LAUNCHES["segmax_i8c"] == before["segmax_i8c"] + 1
    assert (scan.LAUNCHES["segmax_i8c_wgmma"] - before["segmax_i8c_wgmma"]
            == (dim % 16 == 0))
    assert (scan.LAUNCHES["segmax_i8c_realign"] - before["segmax_i8c_realign"]
            == (dim % 4 != 0))
    ref = scan.segmax_scan_i8c_plain(q8, v8, mask)
    torch.cuda.synchronize()
    assert torch.equal(keys, ref)


@pytest.mark.parametrize("dim", [1024, 96])
@pytest.mark.parametrize("nq", [17, 200, 2048])
def test_segmax_scan_i8c_wgmma(dev, dim, nq):
    """K10 on the int8 mainloop: partial 128-query tiles (17, 200) and the
    serving chunk (2048), cap % 256 == 128 (the last tile's second segment
    lies past cap), a fully masked segment; keys bit for bit the plain
    version's."""
    q, v, mask = _data(dev, cap=8320, dim=dim, nq=nq, seed=nq)
    mask[256:384] = False
    v8, cs = scan.quantize_cols_i8(v)
    q8 = scan.fold_queries_i8(q, cs)
    assert scan.wgmma_i8_ready(q8, v8)
    before = scan.LAUNCHES["segmax_i8c_wgmma"]
    keys = scan.segmax_scan_i8c(q8, v8, mask)
    assert scan.LAUNCHES["segmax_i8c_wgmma"] == before + 1
    ref = scan.segmax_scan_i8c_plain(q8, v8, mask)
    torch.cuda.synchronize()
    assert torch.equal(keys, ref)
    assert bool((keys[:, 4:6] == scan.KEY_MIN).all())


def test_segmax_scan_i8c_all_negative(dev):
    """Every sum negative, at cap % 256 == 128 and Q = 17: the zero-filled
    rows past cap and past Q (sums of 0) must never enter a key. A view 1
    byte off 16-byte alignment takes the realigning producer; both bit for
    bit the plain version."""
    q, v, mask = _data(dev, cap=4224, dim=768, nq=17)
    q8 = -scan.quantize_rows_i8(q)[0].abs()
    v8 = scan.quantize_rows_i8(v)[0].abs()
    v8[:, 0] = 1  # every row meets a query's -127 at least once: sums < 0
    q8[:, 0] = -127
    ref = scan.segmax_scan_i8c_plain(q8, v8, mask)
    live = ref != scan.KEY_MIN
    assert bool((ref[live] < 0).all())
    before = scan.LAUNCHES["segmax_i8c_wgmma"]
    keys = scan.segmax_scan_i8c(q8, v8, mask)
    assert scan.LAUNCHES["segmax_i8c_wgmma"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(keys, ref)
    flat = torch.empty(v8.numel() + 16, dtype=torch.int8, device=dev)
    vm = flat[1:1 + v8.numel()].view(v8.shape)
    vm.copy_(v8)
    assert scan.realign_i8_ready(q8, vm)
    realigned = scan.LAUNCHES["segmax_i8c_realign"]
    keys = scan.segmax_scan_i8c(q8, vm, mask)
    assert scan.LAUNCHES["segmax_i8c_wgmma"] == before + 1
    assert scan.LAUNCHES["segmax_i8c_realign"] == realigned + 1
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


# --------------------------------------------------------------------------
# K3's one-query sweep (row-scaled int8 kind) and K8's tensor-core segment
# scan
# --------------------------------------------------------------------------


def _i8_store(dev, cap, dim, nq, seed):
    """Per-row int8 rows and int8 queries with ties (row 1 copied to rows
    5, 6 and 130, across the sweep's 128-row units, with equal scales),
    masked rows and a masked 256-row block, and live rows 600-639 of
    scale 0 and < 0 (they rank like any other score)."""
    g = torch.Generator().manual_seed(seed)
    v = torch.nn.functional.normalize(torch.randn(cap, dim, generator=g), dim=1)
    v[5], v[6], v[130] = v[1], v[1], v[1]
    q = torch.nn.functional.normalize(torch.randn(nq, dim, generator=g), dim=1)
    q[0] = v[1]
    v8, vs = scan.quantize_rows_i8(v)
    vs[600:620] = 0.0
    vs[620:640] = -vs[620:640]
    mask = torch.rand(cap, generator=g) > 0.2
    mask[256:512] = False
    mask[[1, 5, 6, 130]] = True
    mask[600:640] = True
    q8, _ = scan.quantize_rows_i8(q)
    return q8.to(dev), v8.to(dev), vs.to(dev), mask.to(dev)


@pytest.mark.parametrize("cap,dim", [(8195, 1024), (3001, 96), (70_001, 128)])
@pytest.mark.parametrize("k", [1, 14, 142, 384])
@pytest.mark.parametrize("nq", [1, 2, 4, 8, 16])
def test_fused_topk_i8_sweep_exact(dev, nq, k, cap, dim):
    """K3's sweep = the plain version bit for bit (ties to the lower row)
    at every query tile it has, through the dispatch where Q <=
    I8_SWEEP_Q_MAX and `i8_wide_ready` fails, and launched uncounted past
    them (the dispatch then takes the tensor-core scan or the wide kind,
    held to the same result); two launches in a row."""
    q8, v8, vs, mask = _i8_store(dev, cap, dim, nq, seed=nq + k)
    ref = scan.scan_topk_plain(q8, v8, vs, mask, k)
    assert scan.i8_sweep_ready(q8, v8, k) == (nq <= scan.I8_SWEEP_Q_MAX)
    served = (scan.i8_sweep_ready(q8, v8, k)
              and not scan.i8_wide_ready(q8, v8, k))
    for _ in range(2):
        before = scan.LAUNCHES["scan_topk_i8_sweep"]
        got = scan.fused_topk_i8(q8, v8, vs, mask, k)
        assert scan.LAUNCHES["scan_topk_i8_sweep"] == before + served
        sweep = scan._sweep_launch(q8, v8, vs, mask, k, "fused_topk_i8")
        torch.cuda.synchronize()
        for out in (got, sweep):
            assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    if k >= 4:
        assert got[1][0, :4].tolist() == [1, 5, 6, 130]


def test_fused_topk_i8_sweep_few_live_rows(dev):
    """Fewer live rows than k: the sweep pads with -inf / row 0 as the
    plain version does."""
    q8, v8, vs, mask = _i8_store(dev, 4096, 96, 3, seed=7)
    mask = torch.zeros_like(mask)
    mask[[9, 2000, 4095]] = True
    got = scan.fused_topk_i8(q8, v8, vs, mask, 142)
    ref = scan.scan_topk_plain(q8, v8, vs, mask, 142)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert bool(torch.isneginf(got[0][:, 3:]).all())


@pytest.mark.parametrize("nq", [1, 16])
@pytest.mark.parametrize("k", [14, 142])
def test_fused_topk_i8_sweep_nonpositive_scores(dev, nq, k):
    """k reaches past the live rows of positive score into those of score
    0 (scale 0) and below (scale < 0, and rows scored against the query's
    negation), then past every live row into the -inf padding: the sweep
    (launched uncounted, at Q = 16 too) and the dispatch's kernel rank
    them, and pad, as the plain version does."""
    q8, v8, vs, mask = _i8_store(dev, 4096, 96, nq, seed=nq + k)
    keep = torch.zeros_like(mask)
    keep[[1, 5]] = True
    keep[600:640] = True  # scales 0 and < 0
    v8[700] = -v8[1]  # the query's negation: a negative sum
    keep[700] = True
    got = scan._sweep_launch(q8, v8, vs, keep, k, "fused_topk_i8")
    ref = scan.scan_topk_plain(q8, v8, vs, keep, k)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    disp = scan.fused_topk_i8(q8, v8, vs, keep, k)  # the sweep, or the scan
    torch.cuda.synchronize()
    assert torch.equal(disp[0], ref[0]) and torch.equal(disp[1], ref[1])
    live = min(k, 43)
    rows = set(got[1][0, :live].tolist())
    assert rows <= set(keep.nonzero().flatten().tolist())
    if k >= 43:  # every live row, those of score <= 0 among them
        assert 700 in rows and bool((got[0][0, :live] <= 0).any())
    assert bool(torch.isfinite(got[0][:, :live]).all())
    assert bool(torch.isneginf(got[0][:, live:]).all())


def _k8_case(dev, kind, dim, nq, n_hot, seed, grid_b=10):
    """_ivf_data's postings with the first live hot tile's first two
    segments masked out entirely (no copy, KEY_MIN columns)."""
    from picovdb_tpu_torch.ops import ivf

    q, v, mask, hot, _ = _ivf_data(dev, kind, dim, nq, grid_b=grid_b,
                                   n_hot=n_hot, seed=seed)
    t0 = int(hot[0]) * ivf.IVF_BN
    mask[t0:t0 + 2 * scan.SEG] = False
    n = torch.tensor([n_hot], dtype=torch.int32, device=dev)
    return q, v, mask, hot, n


def _k8_agrees(keys, ref, kind):
    live = keys != scan.KEY_MIN
    assert torch.equal(live, ref != scan.KEY_MIN)
    if kind == "i8c":  # raw int32 scores: bit for bit
        assert torch.equal(keys, ref)
    elif bool(live.any()):
        assert float((_dec(keys)[live] - _dec(ref)[live]).abs().max()) <= 1e-5


@pytest.mark.parametrize("kind", ["f32", "bf16", "i8c"])
@pytest.mark.parametrize("dim", [1024, 96])
@pytest.mark.parametrize("nq,per_seg", [(3, 8), (32, 8), (33, 4), (70, 1),
                                        (130, 8)])
@pytest.mark.parametrize("n_hot", [0, 7, 10])
def test_ivf_segmax_wgmma(dev, kind, dim, nq, per_seg, n_hot):
    """K8's tensor-core segment scan against the plain version (float keys
    within 1e-5, int8 bit for bit), with all-masked segments, dead steps
    and n_hot = 0; the first kernel, launched uncounted on the same
    inputs, agrees too."""
    from picovdb_tpu_torch.ops import ivf

    q, v, mask, hot, n = _k8_case(dev, kind, dim, nq, n_hot, seed=nq + dim)
    before = dict(scan.LAUNCHES)
    keys = ivf.ivf_segmax_scan(q, v, mask, hot, n, per_seg)
    assert scan.LAUNCHES["ivf_segmax_wgmma"] == before["ivf_segmax_wgmma"] + 1
    assert scan.LAUNCHES["ivf_segmax"] == before["ivf_segmax"] + 1
    ref = ivf.ivf_segmax_scan_plain(q, v, mask, hot, n, per_seg)
    old = ivf._ivf_segmax_first_launch(q, v, mask, hot, n, per_seg,
                                       ivf.IVF_BN)
    torch.cuda.synchronize()
    assert keys.shape == ref.shape
    _k8_agrees(keys, ref, kind)
    _k8_agrees(old, ref, kind)
    ns = ivf.IVF_BN // scan.SEG
    assert bool((keys[:, n_hot * per_seg * ns:] == scan.KEY_MIN).all())
    if n_hot:  # hot[0]'s first two segments are masked out entirely
        for s in (0, 1):
            assert bool((keys[:, s:per_seg * ns:ns] == scan.KEY_MIN).all())


def test_ivf_segmax_wgmma_repeated_launches_agree(dev):
    """Ten launches of the float32 kind at the route's Q = 32 give the same
    keys (a missing proxy fence between the split's shared-memory writes
    and wgmma shows as a rare difference)."""
    from picovdb_tpu_torch.ops import ivf

    q, v, mask, hot, n = _k8_case(dev, "f32", 1024, 32, 10, seed=3)
    first = ivf.ivf_segmax_scan(q, v, mask, hot, n, 8)
    for _ in range(9):
        assert torch.equal(ivf.ivf_segmax_scan(q, v, mask, hot, n, 8), first)


# --------------------------------------------------------------------------
# K4's tensor-core scan and K5 on the int8 mainloop
# --------------------------------------------------------------------------


def _k4_case(dev, kind, cap, dim, nq, seed, negative=False):
    """Unit rows (float32 or bf16) and queries, ~20 % masked; `negative`
    makes every score of segment 1 negative (its rows the queries'
    negated mean)."""
    q, v, mask = _data(dev, cap=cap, dim=dim, nq=nq, seed=seed)
    if negative:
        v[128:256] = -torch.nn.functional.normalize(
            q.mean(0, keepdim=True) + 0.01 * v[128:256], dim=1)
    return q, (v.to(torch.bfloat16) if kind == "bf16" else v), mask


def _k4_agrees(got, ref, mask, k):
    """K4's (vals, idx) against the plain version's top-(k + 1): the same
    -inf slots, scores within 1e-5, the same id set wherever the k-th /
    (k + 1)-th gap exceeds 1e-4, only masked-in rows."""
    vals, idx = got
    fin = torch.isfinite(vals)
    assert torch.equal(fin, torch.isfinite(ref[0][:, :k]))
    if bool(fin.any()):
        err = float((vals[fin] - ref[0][:, :k][fin]).abs().max())
        assert err <= 1e-5, err
    assert bool(mask[idx[fin].long()].all())
    gap = (ref[0][:, k - 1] - ref[0][:, k]).cpu()
    for i in range(vals.shape[0]):
        if not gap[i] > 1e-4:
            continue
        assert set(idx[i].tolist()) == set(ref[1][i, :k].tolist()), i


def _k4_launch(q, v, mask, k):
    before = dict(scan.LAUNCHES)
    got = scan.fused_topk(q, v, mask, k)
    tc = scan.LAUNCHES["scan_topk_wgmma"] - before["scan_topk_wgmma"]
    sweep = scan.LAUNCHES["scan_topk_sweep"] - before["scan_topk_sweep"]
    assert sweep == scan.topk_sweep_ready(q, v, k)
    assert scan.LAUNCHES["scan_topk"] == before["scan_topk"] + 1
    return got, tc


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("cap,dim", [(8320, 1024), (4224, 96)])
@pytest.mark.parametrize("k", [1, 14, 36, 128])
@pytest.mark.parametrize("nq", [1, 5, 64, 65, 130])
def test_fused_topk_wgmma(dev, kind, cap, dim, k, nq):
    """K4's tensor-core scan against the plain version: Q off the 64-query
    tile, cap % 256 == 128, k at each ring size's edge, and two segments
    masked out entirely (skipped: no copy, no product). Up to
    TOPK_SWEEP_Q_MAX queries the one-query sweep takes the dispatch; the
    scan is then launched alone and held to the same plain version."""
    q, v, mask = _k4_case(dev, kind, cap, dim, nq, seed=nq + k)
    mask[:128] = False
    mask[1024:1152] = False
    sweep = scan.topk_sweep_ready(q, v, k)
    assert sweep == (nq <= scan.TOPK_SWEEP_Q_MAX)
    assert scan.topk_wgmma_ready(q, v, k) == (nq >= scan.TOPK_WGMMA_Q_MIN
                                              and not sweep)
    got, tc = _k4_launch(q, v, mask, k)
    assert tc == (nq >= scan.TOPK_WGMMA_Q_MIN and not sweep)
    ref = scan.scan_topk_plain(q, v, None, mask, k + 1)
    torch.cuda.synchronize()
    _k4_agrees(got, ref, mask, k)
    if sweep:
        direct = scan._topk_wgmma_launch(q, v, mask, k)
        torch.cuda.synchronize()
        _k4_agrees(direct, ref, mask, k)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_fused_topk_wgmma_at_the_crossover(dev, kind):
    """The ready rules' Q limit: up to TOPK_SWEEP_Q_MAX queries the
    one-query sweep, past it the tensor-core scan (TOPK_WGMMA_Q_MIN stays
    below the sweep's limit: the dispatch asks the sweep first); both
    agree with the plain version, and so does the tensor-core scan
    launched (uncounted) at the sweep's limit."""
    lim = scan.TOPK_SWEEP_Q_MAX + 1
    assert scan.TOPK_WGMMA_Q_MIN < lim
    for nq in (lim - 1, lim):
        q, v, mask = _k4_case(dev, kind, 8320, 1024, nq, seed=nq)
        got, tc = _k4_launch(q, v, mask, 14)
        assert tc == (nq >= lim)
        ref = scan.scan_topk_plain(q, v, None, mask, 15)
        direct = scan._topk_wgmma_launch(q, v, mask, 14)
        torch.cuda.synchronize()
        _k4_agrees(got, ref, mask, 14)
        _k4_agrees(direct, ref, mask, 14)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 14, 128])
def test_fused_topk_wgmma_sparse_masks(dev, kind, k):
    """Masks that leave one live row, a few rows in a few segments (the id
    filter's case: most segments skipped), and a segment whose every score
    is negative beside empty ones: the slots past the live rows come out
    -inf / 0."""
    q, v, mask = _k4_case(dev, kind, 8320, 1024, 70, seed=k, negative=True)
    cases = {"one": [77], "few": [5, 900, 901, 5000, 8319],
             "negative": list(range(128, 256))}
    for name, rows in cases.items():
        keep = torch.zeros_like(mask)
        keep[rows] = True
        got, tc = _k4_launch(q, v, keep, k)
        assert tc == 1
        ref = scan.scan_topk_plain(q, v, None, keep, k + 1)
        torch.cuda.synchronize()
        _k4_agrees(got, ref, keep, k)
        live = min(k, len(rows))
        assert bool(torch.isfinite(got[0][:, :live]).all()), name
        assert bool(torch.isneginf(got[0][:, live:]).all()), name
        assert bool((got[1][:, live:] == 0).all()), name
        if name == "negative":
            assert bool((got[0][:, :live] < 0).all())


def test_fused_topk_wgmma_repeated_launches_agree(dev):
    """Ten launches of the float32 kind at Q = 256 give the same result
    (the split's proxy fence, the buffers' atomics)."""
    q, v, mask = _k4_case(dev, "f32", 8320, 1024, 256, seed=5)
    first = scan.fused_topk(q, v, mask, 36)
    for _ in range(9):
        got = scan.fused_topk(q, v, mask, 36)
        assert torch.equal(got[0], first[0]) and torch.equal(got[1], first[1])


def test_fused_topk_wgmma_ready_edges(dev):
    """k 129 (the wide kind), a row stride off 16 bytes and a misaligned
    view (the scan's rows by cp.async, counted as
    "scan_topk_wgmma_cpasync") miss the scan by TMA; all agree with the
    plain version."""
    q, v, mask = _k4_case(dev, "f32", 4224, 96, 64, seed=2)
    assert scan.topk_wgmma_ready(q, v, 128)
    assert not scan.topk_wgmma_ready(q, v, 129)
    flat = torch.empty(v.numel() + 4, device=dev)
    vm = flat[1:1 + v.numel()].view(v.shape)
    vm.copy_(v)
    assert scan.topk_wgmma_ready(q, vm, 14) and scan.rows_piece(vm) == 4
    q2, v2 = q[:, :94].contiguous(), v[:, :94].contiguous()
    assert scan.topk_wgmma_ready(q2, v2, 14) and scan.rows_piece(v2) == 8
    for qq, vv, k in ((q, v, 129), (q, vm, 14), (q2, v2, 14)):
        got, tc = _k4_launch(qq, vv, mask, k)
        assert tc == 0
        ref = scan.scan_topk_plain(qq, vv, None, mask, k + 1)
        torch.cuda.synchronize()
        _k4_agrees(got, ref, mask, k)


@pytest.mark.parametrize("dim", [1024, 96])
@pytest.mark.parametrize("nq", [17, 200, 2048])
def test_segmax_scan_i8_wgmma(dev, dim, nq):
    """K5 on the int8 mainloop: partial 128-query tiles (17, 200) and the
    serving chunk (2048), cap % 256 == 128, a fully masked segment; keys
    bit for bit the plain version's, and the mma.sync tile's (launched
    uncounted on the same inputs, served by no dispatch)."""
    q, v, mask = _data(dev, cap=8320, dim=dim, nq=nq, seed=nq)
    mask[256:384] = False
    q8, _ = scan.quantize_rows_i8(q)
    v8, vs = scan.quantize_rows_i8(v)
    assert scan.wgmma_i8_ready(q8, v8)
    before = dict(scan.LAUNCHES)
    keys = scan.segmax_scan_i8(q8, v8, vs, mask)
    assert scan.LAUNCHES["segmax_i8_wgmma"] == before["segmax_i8_wgmma"] + 1
    assert scan.LAUNCHES["segmax_i8"] == before["segmax_i8"] + 1
    ref = scan.segmax_scan_i8_plain(q8, v8, vs, mask)
    tile = scan._segmax_i8_launch(q8, v8, vs, mask, "pv_segmax_scan_i8")
    torch.cuda.synchronize()
    assert torch.equal(keys, ref)
    assert torch.equal(tile, ref)
    assert bool((keys[:, 4:6] == scan.KEY_MIN).all())


def test_segmax_scan_i8_all_negative(dev):
    """Every scaled score negative, at cap % 256 == 128 and Q = 17: the
    zero-filled rows past cap and past Q never enter a key. A view 1 byte
    off 16-byte alignment takes the realigning producer; both bit for bit
    the plain version."""
    q, v, mask = _data(dev, cap=4224, dim=768, nq=17)
    q8 = -scan.quantize_rows_i8(q)[0].abs()
    v8, vs = scan.quantize_rows_i8(v)
    v8 = v8.abs()
    v8[:, 0] = 1
    q8[:, 0] = -127
    ref = scan.segmax_scan_i8_plain(q8, v8, vs, mask)
    live = ref != scan.KEY_MIN
    assert bool((ref[live] < 0).all())
    before = scan.LAUNCHES["segmax_i8_wgmma"]
    keys = scan.segmax_scan_i8(q8, v8, vs, mask)
    assert scan.LAUNCHES["segmax_i8_wgmma"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(keys, ref)
    flat = torch.empty(v8.numel() + 16, dtype=torch.int8, device=dev)
    vm = flat[1:1 + v8.numel()].view(v8.shape)
    vm.copy_(v8)
    assert scan.realign_i8_ready(q8, vm)
    realigned = scan.LAUNCHES["segmax_i8_realign"]
    keys = scan.segmax_scan_i8(q8, vm, vs, mask)
    assert scan.LAUNCHES["segmax_i8_wgmma"] == before + 1
    assert scan.LAUNCHES["segmax_i8_realign"] == realigned + 1
    torch.cuda.synchronize()
    assert torch.equal(keys, ref)


def test_k4_k5_on_second_card(dev):
    """K4's tensor-core scan and K5's mainloop on tensors of cuda:1 while
    the current device is 0: launched on their own card, equal to the same
    call on cuda:0. Skips on a machine with one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    q, v, mask = _k4_case(dev, "bf16", 8320, 1024, 64, seed=9)
    q8, _ = scan.quantize_rows_i8(q)
    v8, vs = scan.quantize_rows_i8(v.float())
    out = {}
    for name in ("cuda:0", "cuda:1"):
        d = torch.device(name)
        before = dict(scan.LAUNCHES)
        got = scan.fused_topk(q.to(d), v.to(d), mask.to(d), 36)
        keys = scan.segmax_scan_i8(q8.to(d), v8.to(d), vs.to(d), mask.to(d))
        assert torch.cuda.current_device() == 0
        assert scan.LAUNCHES["scan_topk_wgmma"] == before["scan_topk_wgmma"] + 1
        assert scan.LAUNCHES["segmax_i8_wgmma"] == before["segmax_i8_wgmma"] + 1
        torch.cuda.synchronize(d)
        out[name] = (got[0].cpu(), got[1].cpu(), keys.cpu())
    for a, b in zip(out["cuda:0"], out["cuda:1"]):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# K3's tensor-core scan (int8 kind) and K1's mainloop fed by cp.async
# --------------------------------------------------------------------------


def _k3_launch(q8, v8, vs, mask, k):
    before = dict(scan.LAUNCHES)
    got = scan.fused_topk_i8(q8, v8, vs, mask, k)
    tc = scan.LAUNCHES["scan_topk_i8_wgmma"] - before["scan_topk_i8_wgmma"]
    assert scan.LAUNCHES["scan_topk_i8"] == before["scan_topk_i8"] + 1
    return got, tc


def _k3_equal(got, ref):
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.parametrize("cap,dim", [(8320, 1024), (4224, 96)])
@pytest.mark.parametrize("k", [1, 14, 128, 129, 142, 384])
@pytest.mark.parametrize("nq", [17, 64, 128, 256, 2048])
def test_fused_topk_i8_wgmma_exact(dev, nq, k, cap, dim):
    """K3's tensor-core scan = the plain version bit for bit, vals and idx
    (exact int32 sums, one conversion, one multiply, ties to the lower
    row): Q past the sweep's limit and off the query tile, k at each
    buffer size's edge (N = 32 past 128), cap % 256 == 128, live rows of
    scale 0 and < 0, a masked 256-row block (two dead segments). Where
    `i8_wide_ready` holds the dispatch takes the wide kind and the scan is
    launched uncounted, both held to the plain version."""
    q8, v8, vs, mask = _i8_store(dev, cap, dim, nq, seed=nq + k)
    assert scan.i8_wgmma_ready(q8, v8, k)
    served = not scan.i8_wide_ready(q8, v8, k)
    got, tc = _k3_launch(q8, v8, vs, mask, k)
    assert tc == served
    ref = scan.scan_topk_plain(q8, v8, vs, mask, k)
    if not served:
        _k3_equal(scan._i8_wgmma_launch(q8, v8, vs, mask, k), ref)
    torch.cuda.synchronize()
    _k3_equal(got, ref)
    if k >= 4:
        assert got[1][0, :4].tolist() == [1, 5, 6, 130]


@pytest.mark.parametrize("k", [14, 142])
def test_fused_topk_i8_wgmma_sparse_masks(dev, k):
    """A ~1 % mask with most segments dead, one live row, and only live
    rows of scale <= 0 (a negative scale times a negative sum ranks high):
    the slots past the live rows come out -inf / 0, as in the plain
    version."""
    q8, v8, vs, mask = _i8_store(dev, 70_016, 128, 64, seed=k)
    g = torch.Generator().manual_seed(k)
    sparse = (torch.rand(70_016, generator=g) < 0.01).to(dev)
    sparse[:128 * 100] = False  # the first 100 segments dead
    cases = {"sparse": sparse, "one": [77], "nonpositive": list(range(600, 640))}
    for name, rows in cases.items():
        keep = rows if name == "sparse" else torch.zeros_like(mask)
        if name != "sparse":
            keep[rows] = True
        got, tc = _k3_launch(q8, v8, vs, keep, k)
        assert tc == (not scan.i8_wide_ready(q8, v8, k))
        ref = scan.scan_topk_plain(q8, v8, vs, keep, k)
        torch.cuda.synchronize()
        _k3_equal(got, ref)
        _k3_equal(scan._i8_wgmma_launch(q8, v8, vs, keep, k), ref)
        live = min(k, int(keep.sum()))
        assert bool(torch.isfinite(got[0][:, :live]).all()), name
        assert bool(torch.isneginf(got[0][:, live:]).all()), name
        assert bool((got[1][:, live:] == 0).all()), name
        if name == "nonpositive":  # the twenty rows of scale 0
            assert bool((got[0][:, :live] == 0).any())


@pytest.mark.parametrize("k", [14, 142])
def test_fused_topk_i8_wgmma_all_negative(dev, k):
    """Non-negative rows against non-positive queries: every score < 0,
    and a ragged last segment (cap 4229) whose zero-filled rows past cap
    (score 0) would beat them all were they admitted."""
    g = torch.Generator().manual_seed(k)
    cap, dim = 4229, 96
    v8 = torch.randint(1, 128, (cap, dim), generator=g, dtype=torch.int8)
    q8 = -torch.randint(1, 128, (64, dim), generator=g, dtype=torch.int8)
    vs = torch.rand(cap, generator=g) * 0.01 + 1e-3
    mask = torch.rand(cap, generator=g) > 0.2
    q8, v8, vs, mask = (t.to(dev) for t in (q8, v8, vs, mask))
    got, tc = _k3_launch(q8, v8, vs, mask, k)
    assert tc == (not scan.i8_wide_ready(q8, v8, k))
    ref = scan.scan_topk_plain(q8, v8, vs, mask, k)
    torch.cuda.synchronize()
    _k3_equal(got, ref)
    _k3_equal(scan._i8_wgmma_launch(q8, v8, vs, mask, k), ref)
    assert bool((got[0] < 0).all()) and bool((got[1] < cap).all())


def test_fused_topk_i8_wgmma_ready_edges(dev):
    """k 385, a row stride off 16 bytes, a misaligned view and Q at the
    sweep's limit leave the scan by TMA (the wide kind, the scan's rows by
    cp.async or the realigning producer, the sweep);
    all equal the plain version; the scan launched (uncounted) at Q = 1
    does too."""
    q8, v8, vs, mask = _i8_store(dev, 4224, 96, 64, seed=3)
    lim = scan.I8_SWEEP_Q_MAX
    assert scan.i8_wgmma_ready(q8, v8, 384)
    assert not scan.i8_wgmma_ready(q8, v8, 385)
    flat = torch.empty(v8.numel() + 16, dtype=torch.int8, device=dev)
    vm = flat[1:1 + v8.numel()].view(v8.shape)
    vm.copy_(v8)
    q2, v2 = q8[:, :88].contiguous(), v8[:, :88].contiguous()
    assert scan.i8_wgmma_ready(q8, vm, 14) and scan.rows_piece(vm) == 2
    assert scan.i8_wgmma_ready(q2, v2, 14) and scan.rows_piece(v2) == 8
    assert not scan.i8_wgmma_ready(q8[:lim], v8, 14)
    assert scan.i8_wgmma_ready(q8[:lim + 1].contiguous(), v8, 14)
    for qq, vv, k in ((q8, v8, 385), (q8, vm, 14), (q2, v2, 14),
                      (q8[:lim].contiguous(), v8, 14)):
        got, tc = _k3_launch(qq, vv, vs, mask, k)
        assert tc == 0
        torch.cuda.synchronize()
        _k3_equal(got, scan.scan_topk_plain(qq, vv, vs, mask, k))
    for nq in (1, lim):
        qq = q8[:nq].contiguous()
        got = scan._i8_wgmma_launch(qq, v8, vs, mask, 142)
        torch.cuda.synchronize()
        _k3_equal(got, scan.scan_topk_plain(qq, v8, vs, mask, 142))


def test_fused_topk_i8_wgmma_repeated_launches_agree(dev):
    """Ten launches at Q = 256, k_sel 142 give the same result (the
    buffers' atomics, the compaction and re-admission; the scan launched
    uncounted: the dispatch takes the wide kind there)."""
    q8, v8, vs, mask = _i8_store(dev, 70_016, 1024, 256, seed=5)
    first = scan._i8_wgmma_launch(q8, v8, vs, mask, 142)
    for _ in range(9):
        _k3_equal(scan._i8_wgmma_launch(q8, v8, vs, mask, 142), first)


def test_k3_k1_on_second_card(dev):
    """K3's int8 scan and K1's cp.async mainloop on tensors of cuda:1
    while the current device is 0: launched on their own card, equal to
    the same call on cuda:0. Skips on a machine with one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    q8, v8, vs, mask = _i8_store(torch.device("cpu"), 8320, 1024, 64, seed=9)
    q, v, m1 = _data(torch.device("cpu"), cap=8192, dim=1020, nq=200)
    out = {}
    for name in ("cuda:0", "cuda:1"):
        d = torch.device(name)
        before = dict(scan.LAUNCHES)
        got = scan.fused_topk_i8(q8.to(d), v8.to(d), vs.to(d), mask.to(d),
                                 128)
        keys = scan.segmax_scan(q.to(d, torch.bfloat16),
                                v.to(d, torch.bfloat16), m1.to(d))
        assert torch.cuda.current_device() == 0
        assert (scan.LAUNCHES["scan_topk_i8_wgmma"]
                == before["scan_topk_i8_wgmma"] + 1)
        assert scan.LAUNCHES["segmax_cpasync"] == before["segmax_cpasync"] + 1
        torch.cuda.synchronize(d)
        out[name] = (got[0].cpu(), got[1].cpu(), keys.cpu())
    for a, b in zip(out["cuda:0"], out["cuda:1"]):
        assert torch.equal(a, b)


def _k1_agrees(q, v, mask, keys, ref, k=10):
    """K1's keys against the plain slab as `test_segmax_and_topk_keys`
    holds them: KEY_MIN pattern equal, decoded values within 1e-4, K2
    equal on both slabs, the decoded rows rescored equal outside a 1e-4
    k / k+1 gap, only masked-in rows."""
    live = keys != scan.KEY_MIN
    assert torch.equal(live, ref != scan.KEY_MIN)
    assert float((_dec(keys)[live] - _dec(ref)[live]).abs().max()) <= 1e-4
    tk, tc = scan.topk_packed_keys(keys, k + 6)
    assert torch.equal(tk, scan.topk_packed_keys_plain(keys, k + 6)[0])
    assert torch.equal(torch.gather(keys, 1, tc.long()), tk)
    ex_k, id_k = _decode_rescore(q, v, keys, k + 6)
    ex_p, id_p = _decode_rescore(q, v, ref, k + 6)
    assert float((ex_k[:, :k] - ex_p[:, :k]).abs().max()) <= 1e-5
    gap = (ex_p[:, k - 1] - ex_p[:, k]).cpu()
    a, b = id_k[:, :k].cpu(), id_p[:, :k].cpu()
    for i in range(q.shape[0]):
        if gap[i] > 1e-4:
            assert set(a[i].tolist()) == set(b[i].tolist()), i
    assert bool(mask[id_k[:, :k].long()].all())


def _k1_launch(qb, vb, mask):
    before = dict(scan.LAUNCHES)
    keys = scan.segmax_scan(qb, vb, mask)
    assert scan.LAUNCHES["segmax"] == before["segmax"] + 1
    return keys, {key: scan.LAUNCHES[key] - before[key]
                  for key in ("segmax_wgmma", "segmax_cpasync",
                              "segmax_realign")}


@pytest.mark.parametrize("dim", [1020, 1018, 300, 100, 50])
@pytest.mark.parametrize("nq,cap", [(17, 8320), (200, 8192), (2048, 16384)])
def test_segmax_cpasync(dev, dim, nq, cap):
    """K1 on the mainloop fed by cp.async at even widths TMA cannot read
    (8-byte pieces at dim % 4 == 0, 4-byte pieces otherwise): Q off the
    128-query tile, cap % 256 == 128, a fully masked segment and the last
    one, held by `_k1_agrees`."""
    q, v, mask = _data(dev, cap=cap, dim=dim, nq=nq, seed=dim + nq)
    mask[128:256] = False
    mask[cap - 128:] = False
    qb, vb = q.to(torch.bfloat16), v.to(torch.bfloat16)
    assert scan.cpasync_ready(qb, vb) and not scan.wgmma_ready(qb, vb)
    assert scan.cpasync_piece(qb, vb) == (8 if dim % 4 == 0 else 4)
    keys, n = _k1_launch(qb, vb, mask)
    assert n == {"segmax_wgmma": 0, "segmax_cpasync": 1, "segmax_realign": 0}
    ref = scan.segmax_scan_plain(qb, vb, mask)
    torch.cuda.synchronize()
    assert keys.shape == ref.shape == (nq, 2 * cap // scan.SEG)
    assert not bool((keys[:, 2:4] != scan.KEY_MIN).any())
    _k1_agrees(q, v, mask, keys, ref)


@pytest.mark.parametrize("offset,piece", [(4, 8), (2, 4)])
def test_segmax_cpasync_aligned_view(dev, offset, piece):
    """A dim-1024 bf16 corpus whose base is 8 (4) bytes off a 16-byte
    boundary: TMA cannot read it, cp.async can in pieces of 8 (4) bytes,
    with the plain version's keys."""
    q, v, mask = _data(dev, cap=8192, dim=1024, nq=200, seed=offset)
    qb = q.to(torch.bfloat16)
    flat = torch.empty(v.numel() + 8, dtype=torch.bfloat16, device=dev)
    vb = flat[offset:offset + v.numel()].view(v.shape)
    vb.copy_(v)
    assert not scan.wgmma_ready(qb, vb) and scan.cpasync_ready(qb, vb)
    assert scan.cpasync_piece(qb, vb) == piece
    keys, n = _k1_launch(qb, vb, mask)
    assert n == {"segmax_wgmma": 0, "segmax_cpasync": 1, "segmax_realign": 0}
    ref = scan.segmax_scan_plain(qb, vb, mask)
    torch.cuda.synchronize()
    _k1_agrees(q, v, mask, keys, ref)


def test_segmax_cpasync_repeated_launches_agree(dev):
    """Ten launches at dim 1020, Q = 2048 give the same keys (the full
    barrier's 128 arrivals, the proxy fence)."""
    q, v, mask = _data(dev, cap=16384, dim=1020, nq=2048, seed=1)
    qb, vb = q.to(torch.bfloat16), v.to(torch.bfloat16)
    first = scan.segmax_scan(qb, vb, mask)
    for _ in range(9):
        assert torch.equal(scan.segmax_scan(qb, vb, mask), first)


@pytest.mark.parametrize("nq", [17, 2048])
def test_segmax_odd_width_takes_wmma(dev, nq):
    """dim 97 (rows of 194 bytes): neither TMA nor cp.async, so K1 runs
    the mainloop fed by its realigning producer (until it came, the wmma
    tile, which is held to the same keys here), with the plain version's
    keys."""
    q, v, mask = _data(dev, cap=8320, dim=97, nq=nq, seed=nq)
    qb, vb = q.to(torch.bfloat16), v.to(torch.bfloat16)
    assert not scan.wgmma_ready(qb, vb) and not scan.cpasync_ready(qb, vb)
    keys, n = _k1_launch(qb, vb, mask)
    assert n == {"segmax_wgmma": 0, "segmax_cpasync": 0, "segmax_realign": 1}
    ref = scan.segmax_scan_plain(qb, vb, mask)
    torch.cuda.synchronize()
    _k1_agrees(q, v, mask, keys, ref)
    tile = scan._segmax_launch(qb, vb, mask, "pv_segmax_scan")
    torch.cuda.synchronize()
    _k1_agrees(q, v, mask, tile, ref)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_template_misaligned_views(dev, offset):
    """Rows whose base is `offset` bytes off a 4-byte boundary (int8) or 2
    bytes off (bf16), which the template served (its word loads then read
    element by element), now go through the kinds over rows TMA cannot
    read (the narrow sweep, the scans' realigning producer): the plain
    version's result, no misaligned-address fault."""
    q8, v8, vs, mask = _i8_store(dev, 4224, 96, 20, seed=offset)
    flat = torch.empty(v8.numel() + 16, dtype=torch.int8, device=dev)
    vm = flat[offset:offset + v8.numel()].view(v8.shape)
    vm.copy_(v8)
    for k in (14, 142):
        got = scan.fused_topk_i8(q8, vm, vs, mask, k)
        torch.cuda.synchronize()
        _k3_equal(got, scan.scan_topk_plain(q8, vm, vs, mask, k))
    q, v, m = _k4_case(dev, "bf16", 4224, 96, 64, seed=offset)
    fb = torch.empty(v.numel() + 8, dtype=torch.bfloat16, device=dev)
    vb = fb[1:1 + v.numel()].view(v.shape)
    vb.copy_(v)
    got, tc = _k4_launch(q, vb, m, 14)
    assert tc == 0
    ref = scan.scan_topk_plain(q, vb, None, m, 15)
    torch.cuda.synchronize()
    _k4_agrees(got, ref, m, 14)


# --------------------------------------------------------------------------
# K1 fed by its realigning producer; K2's split-row warp select
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [1019, 1021, 97, 1])
@pytest.mark.parametrize("nq,cap", [(17, 8320), (200, 8192), (2048, 16384)])
def test_segmax_realign(dev, dim, nq, cap):
    """K1 on the mainloop fed by its realigning producer at odd widths
    (rows of 2038 / 2042 / 194 / 2 bytes: every 2-byte offset of a row
    start modulo 16 occurs): Q off the 128-query tile, cap % 256 == 128, a
    fully masked segment and the last one, held by `_k1_agrees`."""
    q, v, mask = _data(dev, cap=cap, dim=dim, nq=nq, seed=dim + nq)
    mask[128:256] = False
    mask[cap - 128:] = False
    qb, vb = q.to(torch.bfloat16), v.to(torch.bfloat16)
    assert scan.realign_ready(qb, vb)
    keys, n = _k1_launch(qb, vb, mask)
    assert n == {"segmax_wgmma": 0, "segmax_cpasync": 0, "segmax_realign": 1}
    ref = scan.segmax_scan_plain(qb, vb, mask)
    torch.cuda.synchronize()
    assert keys.shape == ref.shape == (nq, 2 * cap // scan.SEG)
    assert not bool((keys[:, 2:4] != scan.KEY_MIN).any())
    _k1_agrees(q, v, mask, keys, ref)


def _view_at(t, offset_elems):
    """A contiguous copy of `t` whose base lies `offset_elems` elements
    past an allocation's (16-byte aligned) start."""
    flat = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    out = flat[offset_elems:offset_elems + t.numel()].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("dim", [1024, 1020, 300, 1019])
@pytest.mark.parametrize("q_off,v_off", [(0, 1), (1, 0), (3, 5), (7, 7)])
def test_segmax_realign_aligned_views(dev, dim, q_off, v_off):
    """Queries and rows whose bases lie an odd number of bf16 elements (2,
    6, 10, 14 bytes) past a 16-byte boundary: only the realigning producer
    can read them, at even widths too; the plain version's keys."""
    q, v, mask = _data(dev, cap=8320, dim=dim, nq=200, seed=dim + q_off)
    qb = _view_at(q.to(torch.bfloat16), q_off)
    vb = _view_at(v.to(torch.bfloat16), v_off)
    assert scan.realign_ready(qb, vb)
    keys, n = _k1_launch(qb, vb, mask)
    assert n == {"segmax_wgmma": 0, "segmax_cpasync": 0, "segmax_realign": 1}
    ref = scan.segmax_scan_plain(qb, vb, mask)
    torch.cuda.synchronize()
    _k1_agrees(q, v, mask, keys, ref)


def test_segmax_realign_all_masked_and_negative(dev):
    """Every segment masked but one, whose live rows all score below 0
    (the zeros past cap and dim must not win): the plain keys."""
    q, v, mask = _data(dev, cap=8320, dim=1019, nq=130, seed=3)
    v = -v.abs()
    q = q.abs()
    mask[:] = False
    mask[8192:8200] = True
    qb, vb = q.to(torch.bfloat16), v.to(torch.bfloat16)
    keys, n = _k1_launch(qb, vb, mask)
    assert n["segmax_realign"] == 1
    ref = scan.segmax_scan_plain(qb, vb, mask)
    torch.cuda.synchronize()
    live = keys != scan.KEY_MIN
    assert torch.equal(live, ref != scan.KEY_MIN)
    assert float((_dec(keys)[live] - _dec(ref)[live]).abs().max()) <= 1e-4
    assert bool((_dec(keys)[live] < 0).all())


def test_segmax_realign_repeated_launches_agree(dev):
    """Ten launches at dim 1019, Q = 2048 give the same keys (the full
    barrier's 128 arrivals, the proxy fences)."""
    q, v, mask = _data(dev, cap=16384, dim=1019, nq=2048, seed=2)
    qb, vb = q.to(torch.bfloat16), v.to(torch.bfloat16)
    first = scan.segmax_scan(qb, vb, mask)
    for _ in range(9):
        assert torch.equal(scan.segmax_scan(qb, vb, mask), first)


def _k2_reference(keys, k):
    """The top-k of each row by (key, column) descending: the kernel's tie
    rule (equal keys, the larger column first), on the CPU."""
    flipped = keys.cpu().flip(1)
    vals, pos = torch.sort(flipped, dim=1, descending=True, stable=True)
    cols = keys.shape[1] - 1 - pos[:, :k]
    return vals[:, :k], cols.to(torch.int32)


def _k2_check(keys, k):
    before = dict(scan.LAUNCHES)
    tk, tc = scan.topk_packed_keys(keys, k)
    assert scan.LAUNCHES["topk_keys"] == before["topk_keys"] + 1
    torch.cuda.synchronize()
    rk, rc = _k2_reference(keys, k)
    assert torch.equal(tk.cpu(), rk)
    assert torch.equal(tk, torch.topk(keys, k, dim=1)[0])
    assert torch.equal(tc.cpu(), rc)


@pytest.mark.parametrize("nq", [1, 64, 256, 2048])
@pytest.mark.parametrize("c", [2, 6, 130, 1002, 4096, 15872, 16384])
@pytest.mark.parametrize("k", [1, 16, 22, 32])
def test_topk_packed_keys(dev, nq, c, k):
    """Random int32 keys with KEY_MIN runs and repeated values: keys bit
    for bit `torch.topk`'s, columns by the tie rule, at every chunking
    `scan.topk_keys_chunk` gives (one chunk a row at small C, up to 31)."""
    if k > c:
        pytest.skip("k_sel > C is refused")
    g = torch.Generator().manual_seed(nq * 7 + c + k)
    keys = torch.randint(-2**31, 2**31 - 1, (nq, c), generator=g,
                         dtype=torch.int64).to(torch.int32)
    keys[:, ::7] = scan.KEY_MIN
    n = keys[:, 2::5].shape[1]
    keys[:, 1:1 + 5 * n:5] = keys[:, 2::5]  # each a repeat of its neighbour
    _k2_check(keys.to(dev), k)


@pytest.mark.parametrize("case", ["all_equal", "key_min", "dup_max",
                                  "c_is_k", "ragged_chunk", "offset_base"])
@pytest.mark.parametrize("nq", [1, 64, 2048])
@pytest.mark.parametrize("k", [1, 16, 22, 32])
def test_topk_packed_keys_ties(dev, case, nq, k):
    """Crafted ties: rows of one key value, rows of KEY_MIN (column 0's
    KEY_MIN is the empty slot's pattern), the row maximum repeated on both
    sides of every chunk boundary, C == k_sel, C one key past whole
    chunks, and a slab 4 bytes off a 16-byte boundary (element loads)."""
    c = {"c_is_k": k, "ragged_chunk": 4 * 512 + 2}.get(case, 15872)
    g = torch.Generator().manual_seed(nq + k)
    keys = torch.randint(-2**30, 2**30, (nq, c), generator=g,
                         dtype=torch.int64).to(torch.int32)
    if case == "all_equal":
        keys[:] = 12345
    elif case == "key_min":
        keys[:] = scan.KEY_MIN
        keys[1::2, 5] = 7
    elif case == "dup_max":
        chunk = scan.topk_keys_chunk(nq, c)
        for b in range(0, c, chunk):
            for col in (b - 1, b, b + 1):
                if 0 <= col < c:
                    keys[:, col] = 2**31 - 1
    keys = keys.to(dev)
    if case == "offset_base":
        keys = _view_at(keys, 1)
        assert keys.data_ptr() % 16 == 4
    _k2_check(keys, k)
