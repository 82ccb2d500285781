"""K7's and K8's kinds over IVF postings TMA cannot read, against their
plain versions, on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda_ivf_narrow.py -q

Postings whose rows are not whole 16 bytes or whose base is off 16 bytes
(float32 at dims 25 / 50 and a view 4 bytes off, bf16 at dims 100 / 25
and a view 2 bytes off, column-scaled int8 at dims 100 / 25 / 104 and a
view 3 bytes off) take every producer `scan.rows_piece` names (cp.async
in 8- or 4-byte pieces, the realigning producer). Each kind K7 dispatches
to at Q 1 / 16 / 17 / 64 and k 14 / 68 / 160 / 544 (the narrow sweep, the
tensor-core scan, the wide kind) over a hot table of 12 tiles (not in
order) with n_hot 0 / 1 / 12, ~20 % of rows masked and one segment all
masked; K8's segment scan at Q 1 / 16 / 17 / 64 (the realigning producer
at both ring depths); float32 at dim 1536, where the sweep's query block
refuses Q 9-16, on the tensor-core scan. int8: bit for bit (integer
sums, ties to the lower row); float32 and bf16: scores within 1e-5, the
same id set wherever the plain version's k-th / (k + 1)-th gap exceeds
1e-4, only live hot rows; K8's float keys within 1e-5 in value.
"""

import pytest
import torch

from picovdb_tpu_torch.ops import ivf
from picovdb_tpu_torch.ops import scan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.cuda

BN = ivf.IVF_BN
TOL_SCORE = 1e-5
TOL_GAP = 1e-4
N_TILES = 16
HOT = [9, 3, 14, 0, 7, 12, 1, 5, 11, 2, 15, 6]  # grid_b 12, not in order

# (kind, dim, element offset of the postings view)
LAYOUTS = [("f32", 25, 0), ("f32", 50, 0), ("f32", 96, 1),
           ("bf16", 100, 0), ("bf16", 25, 0), ("bf16", 96, 1),
           ("i8c", 100, 0), ("i8c", 25, 0), ("i8c", 104, 0), ("i8c", 96, 3)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _store(dev, kind, dim, offset, seed=0):
    """Unit rows in the postings' kind (int8: column-scaled) as a view
    `offset` elements into a larger buffer, ~20 % masked, one segment of
    tile HOT[0] all masked; and a scan_inputs function for float32
    queries."""
    g = torch.Generator().manual_seed(seed)
    cap = N_TILES * BN
    v = torch.nn.functional.normalize(torch.randn(cap, dim, generator=g),
                                      dim=1).to(dev)
    mask = (torch.rand(cap, generator=g) > 0.2).to(dev)
    mask[HOT[0] * BN + 256:HOT[0] * BN + 384] = False
    if kind == "i8c":
        rows, cs = scan.quantize_cols_i8(v)
        inputs = lambda q: scan.fold_queries_i8(q, cs)  # noqa: E731
    else:
        dt = torch.float32 if kind == "f32" else torch.bfloat16
        rows = v.to(dt)
        inputs = lambda q: q.to(dt)  # noqa: E731
    flat = torch.zeros(rows.numel() + 16, dtype=rows.dtype, device=dev)
    view = flat[offset:offset + rows.numel()].view(rows.shape)
    view.copy_(rows)
    return view, mask, inputs


def _queries(dev, nq, dim, seed):
    g = torch.Generator().manual_seed(100 + seed)
    return torch.nn.functional.normalize(
        torch.randn(nq, dim, generator=g), dim=1).to(dev)


def _held(kind, got, ref, mask, hot, n_hot, k):
    """The kernel's (vals, idx) against the plain version's top-(k + 1)."""
    vals, idx = got
    rv, ri = ref
    assert torch.equal(torch.isneginf(vals), torch.isneginf(rv[:, :k]))
    if kind == "i8c":
        assert torch.equal(vals, rv[:, :k]) and torch.equal(idx, ri[:, :k])
    else:
        fin = torch.isfinite(vals)
        if bool(fin.any()):
            err = float((vals[fin] - rv[:, :k][fin]).abs().max())
            assert err <= TOL_SCORE, err
        gap = (rv[:, k - 1] - rv[:, k]).cpu()
        for i in range(vals.shape[0]):
            if gap[i] > TOL_GAP or torch.isneginf(rv[i, k]):
                assert set(idx[i][fin[i]].tolist()) == set(
                    ri[i, :k][fin[i]].tolist()), i
    fin = torch.isfinite(vals)
    assert bool((idx[~fin] == 0).all())
    live = torch.zeros_like(mask)
    for t in hot[:n_hot].tolist():
        live[t * BN:(t + 1) * BN] = True
    assert bool((mask & live)[idx[fin].long()].all()), "a dead row"


def _kind_key(q, v, k):
    """The counter of the K7 kind the dispatch takes for these operands."""
    suffix = scan._PIECE_KEY[scan.rows_piece(v)]
    if ivf.ivf_sweep_ready(q, v, k):
        return "ivf_scan_topk_sweep"
    if ivf.ivf_narrow_ready(q, v, k):
        return "ivf_scan_topk_narrow"
    if ivf.ivf_wgmma_ready(q, v, k):
        return "ivf_scan_topk_wgmma" + suffix
    assert ivf.ivf_wide_ready(q, v, k)
    return "ivf_scan_topk_wide" + suffix


@pytest.mark.parametrize("kind,dim,offset", LAYOUTS)
@pytest.mark.parametrize("nq", [1, 16, 17, 64])
@pytest.mark.parametrize("k", [14, 68, 160, 544])
@pytest.mark.parametrize("n_hot", [0, 1, len(HOT)])
def test_k7_kinds_against_plain(dev, kind, dim, offset, nq, k, n_hot):
    v, mask, inputs = _store(dev, kind, dim, offset)
    assert scan.rows_piece(v) != 0  # rows TMA cannot read
    q = inputs(_queries(dev, nq, dim, nq + k))
    hot = torch.tensor(HOT, dtype=torch.int32, device=dev)
    nh = torch.tensor([n_hot], dtype=torch.int32, device=dev)
    key = _kind_key(q, v, k)
    assert key != "ivf_scan_topk_sweep"
    if nq <= 16 and k <= 128:
        assert key == "ivf_scan_topk_narrow"
    before = dict(scan.LAUNCHES)
    got = ivf.ivf_scan_topk(q, v, mask, hot, nh, k)
    assert scan.LAUNCHES[key] == before[key] + 1
    assert scan.LAUNCHES["ivf_scan_topk"] == before["ivf_scan_topk"] + 1
    ref = ivf.ivf_scan_topk_plain(q, v, mask, hot, nh, k + 1)
    torch.cuda.synchronize()
    _held(kind, got, ref, mask, hot, n_hot, k)
    if n_hot == 0:
        assert bool(torch.isneginf(got[0]).all())


@pytest.mark.parametrize("kind,dim,offset", LAYOUTS)
def test_narrow_sweep_equals_plain_over_its_shares(dev, kind, dim, offset):
    """The narrow sweep's partials are those of `ivf_sweep_partition`'s
    shares: its answer equals `ivf_scan_topk_plain(ctas=...)` (int8 bit for
    bit) at Q = 4, k 128."""
    v, mask, inputs = _store(dev, kind, dim, offset, seed=5)
    q = inputs(_queries(dev, 4, dim, 9))
    hot = torch.tensor(HOT, dtype=torch.int32, device=dev)
    nh = torch.tensor([len(HOT)], dtype=torch.int32, device=dev)
    assert ivf.ivf_narrow_ready(q, v, 128)
    got = ivf._ivf_sweep_launch(q, v, mask, hot, nh, 128, BN,
                                "pv_ivf_sweep_topk_narrow")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ref = ivf.ivf_scan_topk_plain(q, v, mask, hot, nh, 129,
                                  ctas=scan.SWEEP_CTAS_PER_SM * sms)
    torch.cuda.synchronize()
    _held(kind, got, ref, mask, hot, len(HOT), 128)


@pytest.mark.parametrize("nq", [9, 12, 16])
def test_wide_rows_past_the_sweeps_block_take_the_scan(dev, nq):
    """float32 at dim 1536: the sweep's query block (16 x 6 KB) refuses Q
    9-16 and the narrow kind does not take rows TMA reads; the tensor-core
    scan takes the batch as one 64-query tile."""
    v, mask, inputs = _store(dev, "f32", 1536, 0)
    q = inputs(_queries(dev, nq, 1536, nq))
    hot = torch.tensor(HOT, dtype=torch.int32, device=dev)
    nh = torch.tensor([7], dtype=torch.int32, device=dev)
    assert scan.sweep_tile(nq) * 1536 * 4 > scan.SWEEP_QBLOCK_BYTES
    assert _kind_key(q, v, 14) == "ivf_scan_topk_wgmma"
    before = scan.LAUNCHES["ivf_scan_topk_wgmma"]
    got = ivf.ivf_scan_topk(q, v, mask, hot, nh, 14)
    assert scan.LAUNCHES["ivf_scan_topk_wgmma"] == before + 1
    ref = ivf.ivf_scan_topk_plain(q, v, mask, hot, nh, 15)
    torch.cuda.synchronize()
    _held("f32", got, ref, mask, hot, 7, 14)


def _k8_held(kind, keys, ref):
    assert keys.shape == ref.shape
    if kind == "i8c":
        assert torch.equal(keys, ref)
        return
    assert torch.equal(keys == scan.KEY_MIN, ref == scan.KEY_MIN)
    live = ref != scan.KEY_MIN
    if bool(live.any()):
        # the key's value (its low 7 bits carry the lane), as a float
        def dec(kk):
            return scan._from_sortable(kk & ~(scan.SEG - 1)).view(
                torch.float32)
        assert float((dec(keys)[live] - dec(ref)[live]).abs().max()) <= 1e-5


@pytest.mark.parametrize("kind,dim,offset", LAYOUTS)
@pytest.mark.parametrize("nq", [1, 16, 17, 64])
@pytest.mark.parametrize("n_hot", [0, 1, len(HOT)])
def test_k8_segment_scan_against_plain(dev, kind, dim, offset, nq, n_hot):
    v, mask, inputs = _store(dev, kind, dim, offset, seed=2)
    q = inputs(_queries(dev, nq, dim, nq + 3))
    hot = torch.tensor(HOT, dtype=torch.int32, device=dev)
    nh = torch.tensor([n_hot], dtype=torch.int32, device=dev)
    piece = scan.rows_piece(v)
    key = "ivf_segmax_wgmma" + scan._PIECE_KEY[piece]
    before = dict(scan.LAUNCHES)
    keys = ivf.ivf_segmax_scan(q, v, mask, hot, nh, 8)
    assert scan.LAUNCHES[key] == before[key] + 1
    ref = ivf.ivf_segmax_scan_plain(q, v, mask, hot, nh, 8)
    torch.cuda.synchronize()
    _k8_held(kind, keys, ref)
    ns = BN // scan.SEG
    assert bool((keys[:, n_hot * 8 * ns:] == scan.KEY_MIN).all())


def test_counters_name_the_producer(dev):
    """One call on each postings layout of phase 7c's stores: the narrow
    sweep at Q = 1, the tensor-core scan at Q = 64, k 68, the wide kind at
    Q = 16, k 204, K8 at Q = 32, each counted under the key its producer
    names, with its shape in LAUNCH_SHAPES."""
    for kind, dim, suffix in (("f32", 25, "_cpasync"), ("bf16", 100, "_cpasync"),
                              ("bf16", 25, "_realign"), ("i8c", 100, "_cpasync"),
                              ("i8c", 25, "_realign")):
        v, mask, inputs = _store(dev, kind, dim, 0, seed=7)
        hot = torch.tensor(HOT, dtype=torch.int32, device=dev)
        nh = torch.tensor([len(HOT)], dtype=torch.int32, device=dev)
        scan.reset_launch_counts()
        for nq, k in ((1, 14), (64, 68), (16, 204)):
            ivf.ivf_scan_topk(inputs(_queries(dev, nq, dim, 0)), v, mask, hot,
                              nh, k)
        ivf.ivf_segmax_scan(inputs(_queries(dev, 32, dim, 0)), v, mask, hot,
                            nh, 8)
        torch.cuda.synchronize()
        shapes = scan.LAUNCH_SHAPES
        assert shapes["ivf_scan_topk_narrow"] == {(1, 14): 1}, kind
        assert shapes["ivf_scan_topk_wgmma" + suffix] == {(64, 68): 1}, kind
        assert shapes["ivf_scan_topk_wide" + suffix] == {(16, 204): 1}, kind
        assert shapes["ivf_segmax_wgmma" + suffix] == {(32, 8): 1}, kind
        assert scan.LAUNCHES["ivf_scan_topk"] == 3
