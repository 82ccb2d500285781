"""K4's wide kind (csrc/topk_wide.cu, 128 < k <= 1024) against its plain
version, on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda_topk_wide.py -q

float32 and bf16 rows at Q 1 / 16 / 64 / 200 (a partial 64-query tile,
and more than one) and k 129 / 204 / 516 / 1024, cap off a multiple of
128, ~20 % masked plus two dead segments, a 30 % filter, masks that leave
one or a few rows, every row masked, a score shared by every row (the
ties path, rows in order), and query tiles smaller than the batch. Scores
within 1e-5 of the plain version (summation order), the same id set
wherever the k-th / (k + 1)-th gap exceeds 1e-4, only masked-in rows.
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


def _case(dev, kind, cap, dim, nq, seed):
    g = torch.Generator().manual_seed(seed)
    v = torch.nn.functional.normalize(torch.randn(cap, dim, generator=g), dim=1)
    q = torch.nn.functional.normalize(torch.randn(nq, dim, generator=g), dim=1)
    mask = torch.rand(cap, generator=g) > 0.2
    v = v.to(torch.bfloat16) if kind == "bf16" else v
    return q.to(dev), v.to(dev), mask.to(dev)


def _agrees(got, ref, mask, k):
    vals, idx = got
    fin = torch.isfinite(vals)
    assert torch.equal(fin, torch.isfinite(ref[0][:, :k]))
    if bool(fin.any()):
        err = float((vals[fin] - ref[0][:, :k][fin]).abs().max())
        assert err <= 1e-5, err
    assert bool(mask[idx[fin].long()].all())
    assert bool((idx[~fin] == 0).all())
    gap = (ref[0][:, k - 1] - ref[0][:, k]).cpu()
    for i in range(vals.shape[0]):
        if gap[i] > 1e-4 or torch.isneginf(ref[0][i, k]):
            assert set(idx[i][fin[i]].tolist()) == set(
                ref[1][i, :k][fin[i]].tolist()), i


def _wide(q, v, mask, k):
    before = dict(scan.LAUNCHES)
    got = scan.fused_topk(q, v, mask, k)
    assert scan.LAUNCHES["scan_topk_wide"] == before["scan_topk_wide"] + 1
    assert scan.LAUNCHES["scan_topk"] == before["scan_topk"] + 1
    return got


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("cap,dim", [(8320, 1024), (4200, 96)])
@pytest.mark.parametrize("k", [129, 204, 516, 1024])
@pytest.mark.parametrize("nq", [1, 16, 64, 200])
def test_wide_against_plain(dev, kind, cap, dim, k, nq):
    q, v, mask = _case(dev, kind, cap, dim, nq, seed=nq + k)
    mask[:128] = False
    mask[1024:1152] = False
    assert scan.topk_wide_ready(q, v, k)
    got = _wide(q, v, mask, k)
    ref = scan.scan_topk_plain(q, v, None, mask, k + 1)
    torch.cuda.synchronize()
    _agrees(got, ref, mask, k)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("k", [204, 1024])
def test_wide_filtered_and_sparse(dev, kind, k):
    """A 30 % filter, one live row, a few rows, none: slots past the live
    rows come out -inf / 0."""
    q, v, mask = _case(dev, kind, 8320, 1024, 64, seed=k)
    g = torch.Generator().manual_seed(1)
    cases = {"filter": mask & (torch.rand(8320, generator=g) < 0.3).to(dev)}
    for name, rows in {"one": [77], "few": [5, 900, 901, 5000, 8319],
                       "none": []}.items():
        keep = torch.zeros_like(mask)
        keep[rows] = True
        cases[name] = keep
    for name, keep in cases.items():
        got = _wide(q, v, keep, k)
        ref = scan.scan_topk_plain(q, v, None, keep, k + 1)
        torch.cuda.synchronize()
        _agrees(got, ref, keep, k)
        live = min(k, int(keep.sum()))
        assert bool(torch.isfinite(got[0][:, :live]).all()), name
        assert bool(torch.isneginf(got[0][:, live:]).all()), name


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_wide_ties_go_to_the_lower_row(dev, kind):
    """Every row the same vector: one score, so the best k are the k
    lowest live rows in order (the ties path: more than CAP equal keys)."""
    cap, k = 20_000, 300
    q, v, mask = _case(dev, kind, cap, 96, 3, seed=9)
    v[:] = v[0]
    got = _wide(q, v, mask, k)
    torch.cuda.synchronize()
    want = torch.nonzero(mask)[:k, 0].to(torch.int32)
    for i in range(3):
        assert torch.equal(got[1][i], want)
        assert bool((got[0][i] == got[0][i, 0]).all())


def test_wide_tiles_and_repeats(dev, monkeypatch):
    """Query tiles smaller than the batch (a tile of 16 over 200 queries)
    give the plain version's answer, and repeated launches agree."""
    q, v, mask = _case(dev, "f32", 8320, 1024, 200, seed=4)
    ref = scan.scan_topk_plain(q, v, None, mask, 517)
    monkeypatch.setattr(scan, "TOPK_WIDE_SLAB_BYTES", 16 * 4 * 8320)
    assert scan.topk_wide_tile(200, 8320) == 16
    first = _wide(q, v, mask, 516)
    torch.cuda.synchronize()
    _agrees(first, ref, mask, 516)
    for _ in range(4):
        got = scan.fused_topk(q, v, mask, 516)
        assert torch.equal(got[0], first[0]) and torch.equal(got[1], first[1])
