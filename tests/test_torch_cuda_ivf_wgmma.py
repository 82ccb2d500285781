"""K7's tensor-core scan (csrc/ivf_scan_wgmma.cu, Q > 16, k <= 128)
against its plain version, on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda_ivf_wgmma.py -q

Every kind (float32, bf16, column-scaled int8 postings) at Q 17 / 64 /
512 and k 1 / 14 / 128 over a hot table of 12 tiles (not in order) with
n_hot 0 / 1 / 5 / 12, ~20 % of rows masked and one tile's segment all
masked; a misaligned postings view that must take the template; ties
across a hot-tile boundary; and one shard of the mesh's clustered store
at its own shape (512 tiles of 1024 x 1024 float32, Q = 512, k_sel 14).
int8: scores and rows bit for bit (integer sums, ties to the lower row);
float32 and bf16: scores within 1e-5 (summation order: 3xTF32 and the
per-stage sums), the same id set wherever the plain version's k-th /
(k + 1)-th gap exceeds 1e-4, only live hot rows.
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


def _store(dev, kind, dim=1024, n_tiles=N_TILES, seed=0):
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
    assert scan.LAUNCHES["ivf_scan_topk_wgmma"] == \
        before["ivf_scan_topk_wgmma"] + 1
    assert scan.LAUNCHES["ivf_scan_topk"] == before["ivf_scan_topk"] + 1
    assert scan.LAUNCHES["ivf_scan_topk_sweep"] == \
        before["ivf_scan_topk_sweep"]
    return got


@pytest.mark.parametrize("kind", ["f32", "bf16", "i8c"])
@pytest.mark.parametrize("nq", [17, 64, 512])
@pytest.mark.parametrize("k", [1, 14, 128])
@pytest.mark.parametrize("n_hot", [0, 1, 5, 12])
def test_wgmma_against_plain(dev, kind, nq, k, n_hot):
    v, mask, inputs = _store(dev, kind)
    q = inputs(_queries(dev, nq, v.shape[1], nq + k))
    hot = torch.tensor(HOT, dtype=torch.int32, device=dev)
    nh = torch.tensor([n_hot], dtype=torch.int32, device=dev)
    assert ivf.ivf_wgmma_ready(q, v, k)
    got = _counted(q, v, mask, hot, nh, k)
    ref = ivf.ivf_scan_topk_plain(q, v, mask, hot, nh, k + 1)
    torch.cuda.synchronize()
    _held(kind, got, ref, mask, hot, n_hot, k)
    if n_hot == 0:
        assert bool(torch.isneginf(got[0]).all())


@pytest.mark.parametrize("kind", ["f32", "bf16", "i8c"])
def test_misaligned_view_takes_the_cpasync_kind(dev, kind):
    """Postings 4 bytes off a 16-byte boundary: TMA cannot read them, and
    K7 takes the same kind fed by cp.async in 4-byte pieces (`rows_piece`),
    counted under its "_cpasync" key, not the template; the answer is the
    plain version's."""
    v, mask, inputs = _store(dev, kind, dim=256)
    es = v.element_size()
    flat = torch.zeros(v.numel() + 16, dtype=v.dtype, device=dev)
    off = 4 // es if es < 4 else 1
    view = flat[off:off + v.numel()].view(v.shape)
    view.copy_(v)
    q = inputs(_queries(dev, 64, 256, 1))
    hot = torch.tensor(HOT, dtype=torch.int32, device=dev)
    nh = torch.tensor([7], dtype=torch.int32, device=dev)
    assert ivf.ivf_wgmma_ready(q, view, 14) and scan.rows_piece(view) == 4
    before = dict(scan.LAUNCHES)
    got = ivf.ivf_scan_topk(q, view, mask, hot, nh, 14)
    assert scan.LAUNCHES["ivf_scan_topk_wgmma"] == before["ivf_scan_topk_wgmma"]
    assert (scan.LAUNCHES["ivf_scan_topk_wgmma_cpasync"]
            == before["ivf_scan_topk_wgmma_cpasync"] + 1)
    ref = ivf.ivf_scan_topk_plain(q, view, mask, hot, nh, 15)
    torch.cuda.synchronize()
    _held(kind, got, ref, mask, hot, 7, 14)


@pytest.mark.parametrize("kind", ["f32", "bf16", "i8c"])
def test_ties_across_a_hot_tile_boundary(dev, kind):
    """The last row of step 0's tile and the first of step 1's (a lower
    tile id) hold the same vector, the best every query can reach: both
    rank first, the lower physical row ahead."""
    v, mask, inputs = _store(dev, kind, dim=256, seed=3)
    hot = torch.tensor(HOT, dtype=torch.int32, device=dev)
    a, b = HOT[0] * BN + BN - 1, HOT[1] * BN
    q = inputs(_queries(dev, 40, 256, 5))
    best = (torch.where(q[0] >= 0, 1, -1) * (127 if kind == "i8c" else 1)
            ).to(v.dtype)
    v[a] = best
    v[b] = best
    mask[a] = mask[b] = True
    nh = torch.tensor([12], dtype=torch.int32, device=dev)
    got = _counted(q, v, mask, hot, nh, 14)
    ref = ivf.ivf_scan_topk_plain(q, v, mask, hot, nh, 15)
    torch.cuda.synchronize()
    _held(kind, got, ref, mask, hot, 12, 14)
    assert got[1][0, :2].tolist() == sorted([a, b])
    assert bool(got[0][0, 0] == got[0][0, 1])


def test_mesh_shard_shape(dev):
    """One shard of the mesh's clustered IVF store at its own shape: 512
    tiles of 1024 x 1024 float32 postings, Q = 512, k_sel 14, 400 of 440
    hot steps live."""
    g = torch.Generator().manual_seed(7)
    cap, dim = 512 * BN, 1024
    v = torch.empty((cap, dim), dtype=torch.float32, device=dev)
    for s in range(0, cap, 65536):
        v[s:s + 65536] = torch.nn.functional.normalize(
            torch.randn(65536, dim, generator=g), dim=1).to(dev)
    mask = (torch.rand(cap, generator=g) > 0.05).to(dev)
    hot = torch.randperm(512, generator=g)[:440].sort().values.to(
        torch.int32).to(dev)
    nh = torch.tensor([400], dtype=torch.int32, device=dev)
    q = _queries(dev, 512, dim, 9)
    got = _counted(q, v, mask, hot, nh, 14)
    ref = ivf.ivf_scan_topk_plain(q, v, mask, hot, nh, 15)
    torch.cuda.synchronize()
    _held("f32", got, ref, mask, hot, 400, 14)
