"""The port's entry points and API-driving tools on a card.

Marked `cuda`: each test skips with a reason where no CUDA device is
present, and runs on the card with

    python -m pytest tests/test_torch_cuda_tools.py -q

`graft_entry.entry()` at its serving shapes launches K4's tensor-core scan
once a call and equals the same step over K4's plain version (scores
within 1e-5, ids equal outside a 1e-4 gap); `dryrun_multichip(4)` over
cuda:i % count launches each kernel shards x row-calls times; the tools
serve from the card by default.
"""

import numpy as np
import pytest
import torch

from picovdb_tpu_torch import graft_entry
from picovdb_tpu_torch.ops import scan
from picovdb_tpu_torch.tools import queries, upserts
from torch_port_setup import cap_torch_threads

cap_torch_threads()

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def test_entry_on_the_card_equals_its_plain_step(dev):
    fn, (q, v, m) = graft_entry.entry()
    assert v.shape == (102_400, 1024) and v.device.type == "cuda"
    before = scan.LAUNCHES["scan_topk_wgmma"]
    vals, idxs = fn(q, v, m)
    torch.cuda.synchronize()
    assert scan.LAUNCHES["scan_topk_wgmma"] == before + 1
    pv, pi = scan.scan_topk_plain(q, v, None, m, 15)
    rv, ri = scan.rescore_exact(q, v, pv[:, :14], pi[:, :14])
    assert float((vals - rv[:, :10]).abs().max()) <= 1e-5
    gap = (pv[:, 9] - pv[:, 10]).cpu().numpy()
    a, b = idxs.cpu().numpy(), ri[:, :10].cpu().numpy()
    for r in np.nonzero(gap > 1e-4)[0]:
        assert set(a[r]) == set(b[r]), r


def test_dryrun_multichip_launches_shards_times_calls(dev):
    before = dict(scan.LAUNCHES)
    out = graft_entry.dryrun_multichip(4)
    torch.cuda.synchronize()
    for key, n in out["calls"].items():
        assert scan.LAUNCHES[key] - before[key] == n, key


def test_tools_serve_from_the_card(dev, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    got = upserts.main(["--n", "2000", "--dim", "128"])
    assert got["inserted"] == 2000
    before = sum(scan.LAUNCHES.values())
    res = queries.main(["--n", "2000", "--dim", "128", "--queries", "5"])
    assert res["strategy"] and res["results"]
    assert sum(scan.LAUNCHES.values()) > before  # a kernel served them
