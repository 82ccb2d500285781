"""K7's wide kind (csrc/ivf_scan_wide.cu, 128 < k <= 1024) against its
plain version, on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda_ivf_wide.py -q

Every kind (float32, bf16, column-scaled int8 postings) at Q 1 / 16 / 64
/ 128 and k 129 / 160 / 544 / 1024 over a hot table of 12 tiles (not in
order) with n_hot 0 / 1 / 5 / 12, ~20 % of rows masked and one tile's
segment all masked; query tiles smaller than the batch; ties across hot
tiles listed out of order, and more than TOPK_WIDE_CAP tied rows over
several of them (the ties path: the lower IVF rows); a misaligned
postings view that must take the template; and a store on cuda:1 while
the current device is 0. int8: scores and rows bit for bit (integer
sums, ties to the lower row); float32 and bf16: scores within 1e-5 (the
summation order: 3xTF32 and the per-stage sums), the same id set
wherever the plain version's k-th / (k + 1)-th gap exceeds 1e-4, only
live hot rows.
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


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _store(dev, kind, dim=256, n_tiles=N_TILES, seed=0):
    """Unit rows in the postings' kind (int8: column-scaled), ~20 % masked,
    one segment of tile HOT[0] all masked; and a scan_inputs function for
    float32 queries."""
    g = torch.Generator().manual_seed(seed)
    cap = n_tiles * BN
    v = torch.nn.functional.normalize(torch.randn(cap, dim, generator=g),
                                      dim=1).to(dev)
    mask = (torch.rand(cap, generator=g) > 0.2).to(dev)
    mask[HOT[0] * BN + 256:HOT[0] * BN + 384] = False
    if kind == "i8c":
        v8, cs = scan.quantize_cols_i8(v)
        return v8, mask, lambda q: scan.fold_queries_i8(q, cs)
    dt = torch.float32 if kind == "f32" else torch.bfloat16
    return v.to(dt), mask, lambda q: q.to(dt)


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


def _counted(q, v, mask, hot, n_hot, k):
    before = dict(scan.LAUNCHES)
    got = ivf.ivf_scan_topk(q, v, mask, hot, n_hot, k)
    assert scan.LAUNCHES["ivf_scan_topk_wide"] == \
        before["ivf_scan_topk_wide"] + 1
    assert scan.LAUNCHES["ivf_scan_topk"] == before["ivf_scan_topk"] + 1
    return got


@pytest.mark.parametrize("kind", ["f32", "bf16", "i8c"])
@pytest.mark.parametrize("nq", [1, 16, 64, 128])
@pytest.mark.parametrize("k", [129, 160, 544, 1024])
@pytest.mark.parametrize("n_hot", [0, 1, 5, 12])
def test_wide_against_plain(dev, kind, nq, k, n_hot):
    v, mask, inputs = _store(dev, kind)
    q = inputs(_queries(dev, nq, v.shape[1], nq + k))
    hot = torch.tensor(HOT, dtype=torch.int32, device=dev)
    nh = torch.tensor([n_hot], dtype=torch.int32, device=dev)
    assert ivf.ivf_wide_ready(q, v, k)
    got = _counted(q, v, mask, hot, nh, k)
    ref = ivf.ivf_scan_topk_plain(q, v, mask, hot, nh, k + 1)
    torch.cuda.synchronize()
    _held(kind, got, ref, mask, hot, n_hot, k)
    if n_hot == 0:
        assert bool(torch.isneginf(got[0]).all())


@pytest.mark.parametrize("kind", ["f32", "i8c"])
def test_wide_tiles_and_repeats(dev, monkeypatch, kind):
    """Query tiles smaller than the batch (16 at a time over 100 queries)
    give the plain version's answer, and repeated launches agree."""
    v, mask, inputs = _store(dev, kind, dim=1024, seed=4)
    q = inputs(_queries(dev, 100, 1024, 4))
    hot = torch.tensor(HOT, dtype=torch.int32, device=dev)
    nh = torch.tensor([10], dtype=torch.int32, device=dev)
    monkeypatch.setattr(scan, "TOPK_WIDE_SLAB_BYTES", 16 * 4 * len(HOT) * BN)
    assert scan.topk_wide_tile(100, len(HOT) * BN) == 16
    first = _counted(q, v, mask, hot, nh, 544)
    ref = ivf.ivf_scan_topk_plain(q, v, mask, hot, nh, 545)
    torch.cuda.synchronize()
    _held(kind, first, ref, mask, hot, 10, 544)
    for _ in range(3):
        again = ivf.ivf_scan_topk(q, v, mask, hot, nh, 544)
        assert torch.equal(again[0], first[0])
        assert torch.equal(again[1], first[1])


@pytest.mark.parametrize("kind", ["f32", "bf16", "i8c"])
def test_ties_across_hot_tiles_out_of_order(dev, kind):
    """The last row of step 0's tile and the first of step 1's (a lower
    tile id) hold the same vector, the best every query can reach: both
    rank first, the lower IVF row ahead."""
    v, mask, inputs = _store(dev, kind, seed=3)
    hot = torch.tensor(HOT, dtype=torch.int32, device=dev)
    a, b = HOT[0] * BN + BN - 1, HOT[1] * BN
    q = inputs(_queries(dev, 20, 256, 5))
    best = (torch.where(q[0] >= 0, 1, -1) * (127 if kind == "i8c" else 1)
            ).to(v.dtype)
    v[a] = best
    v[b] = best
    mask[a] = mask[b] = True
    nh = torch.tensor([12], dtype=torch.int32, device=dev)
    got = _counted(q, v, mask, hot, nh, 160)
    ref = ivf.ivf_scan_topk_plain(q, v, mask, hot, nh, 161)
    torch.cuda.synchronize()
    _held(kind, got, ref, mask, hot, 12, 160)
    assert got[1][0, :2].tolist() == sorted([a, b])
    assert bool(got[0][0, 0] == got[0][0, 1])


def test_ties_past_cap_over_out_of_order_tiles(dev):
    """More than TOPK_WIDE_CAP live rows of int8 postings, spread over
    tiles the hot table lists out of order, hold one vector: the k lowest
    IVF rows among them, in row order (the ties path over the steps
    ordered by tile)."""
    v, mask, inputs = _store(dev, "i8c", seed=6)
    hot = torch.tensor(HOT, dtype=torch.int32, device=dev)
    q = inputs(_queries(dev, 3, 256, 6))
    q[:] = q[0]
    best = (torch.where(q[0] >= 0, 1, -1) * 127).to(torch.int8)
    tied = torch.cat([torch.arange(t * BN, (t + 1) * BN, device=dev)
                      for t in HOT[:10]])  # 10,240 rows in ten tiles
    v[tied] = best
    mask[tied] = True
    nh = torch.tensor([12], dtype=torch.int32, device=dev)
    got = _counted(q, v, mask, hot, nh, 544)
    ref = ivf.ivf_scan_topk_plain(q, v, mask, hot, nh, 545)
    torch.cuda.synchronize()
    _held("i8c", got, ref, mask, hot, 12, 544)
    assert got[1][0].tolist() == sorted(tied.tolist())[:544]


@pytest.mark.parametrize("kind", ["f32", "bf16", "i8c"])
def test_misaligned_view_takes_the_cpasync_kind(dev, kind):
    """Postings 4 bytes off a 16-byte boundary: TMA cannot read them, and
    K7 takes the same kind fed by cp.async in 4-byte pieces (`rows_piece`),
    counted under its "_cpasync" key, not the template; the answer is the
    plain version's."""
    v, mask, inputs = _store(dev, kind)
    es = v.element_size()
    flat = torch.zeros(v.numel() + 16, dtype=v.dtype, device=dev)
    off = 4 // es if es < 4 else 1
    view = flat[off:off + v.numel()].view(v.shape)
    view.copy_(v)
    q = inputs(_queries(dev, 16, 256, 1))
    hot = torch.tensor(HOT, dtype=torch.int32, device=dev)
    nh = torch.tensor([7], dtype=torch.int32, device=dev)
    assert ivf.ivf_wide_ready(q, view, 544) and scan.rows_piece(view) == 4
    before = dict(scan.LAUNCHES)
    got = ivf.ivf_scan_topk(q, view, mask, hot, nh, 544)
    assert scan.LAUNCHES["ivf_scan_topk_wide"] == before["ivf_scan_topk_wide"]
    assert (scan.LAUNCHES["ivf_scan_topk_wide_cpasync"]
            == before["ivf_scan_topk_wide_cpasync"] + 1)
    ref = ivf.ivf_scan_topk_plain(q, view, mask, hot, nh, 545)
    torch.cuda.synchronize()
    _held(kind, got, ref, mask, hot, 7, 544)


def test_wide_on_second_card(dev):
    """The wide kind on tensors of cuda:1 while the current device is 0:
    launched on their own card, equal to the same call on cuda:0. Skips on
    a machine with one card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    torch.cuda.set_device(0)
    v, mask, inputs = _store(dev, "i8c", seed=8)
    q = inputs(_queries(dev, 64, 256, 8))
    hot = torch.tensor(HOT, dtype=torch.int32, device=dev)
    nh = torch.tensor([9], dtype=torch.int32, device=dev)
    out = {}
    for name in ("cuda:0", "cuda:1"):
        d = torch.device(name)
        got = _counted(q.to(d), v.to(d), mask.to(d), hot.to(d), nh.to(d), 544)
        assert torch.cuda.current_device() == 0
        torch.cuda.synchronize(d)
        out[name] = (got[0].cpu(), got[1].cpu())
    assert torch.equal(out["cuda:0"][0], out["cuda:1"][0])
    assert torch.equal(out["cuda:0"][1], out["cuda:1"][1])
