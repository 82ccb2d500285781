"""picovdb_tpu_torch's CUDA kernels against their plain versions, on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present (the CPU test runs), and runs on the card with

    python -m pytest tests/test_torch_cuda.py -q

Shapes are small; `chip_smoke.py` checks the same kernels at the main
path's shapes. Tolerances: keys and int8 scores are exact (integer sums);
float32 / bf16 scores within 1e-5 (summation order).
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


def test_unsupported_input_raises(dev):
    q, v, mask = _data(dev)
    with pytest.raises(ValueError):
        scan.segmax_scan(q, v, mask)  # the kernel takes bf16 only
    with pytest.raises(ValueError):
        scan.fused_topk(q.half(), v, mask, 10)


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
