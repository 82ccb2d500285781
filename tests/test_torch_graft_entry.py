"""picovdb_tpu_torch.graft_entry against picovdb_tpu on the CPU.

`entry()`'s query step (K4 at k + 4, the exact rescore, the top k; K4's
plain version on the CPU) is held to picovdb_tpu's `exact_topk` on the
same inputs: scores within 1e-5, ids equal wherever the float64 k-th /
(k+1)-th gap exceeds 1e-4. `dryrun_multichip` runs on meshes of repeated
CPU devices, and its float answers (the plain route and the kernel route)
equal picovdb_tpu's `make_sharded_topk` on the virtual CPU mesh for the
same arrays. Without a card and without devices, both entry points raise.
The card's run is tests/test_torch_cuda_tools.py.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from picovdb_tpu.ops.exact import exact_topk as jax_exact_topk
from picovdb_tpu.parallel import make_mesh as jax_mesh
from picovdb_tpu.parallel.sharded_query import make_sharded_topk as jax_topk
from picovdb_tpu_torch import graft_entry
from torch_port_setup import cap_torch_threads

cap_torch_threads()

TOL_SCORE = 1e-5
TOL_GAP = 1e-4
CPU = torch.device("cpu")


def assert_topk(vals, idxs, want_vals, want_idxs, exact, k):
    """Scores within TOL_SCORE; ids equal where the exact (float64) k-th /
    (k+1)-th gap exceeds TOL_GAP."""
    np.testing.assert_allclose(vals, want_vals, rtol=0, atol=TOL_SCORE)
    ranked = -np.sort(-exact, axis=1)
    for r in range(vals.shape[0]):
        if ranked[r, k - 1] - ranked[r, k] > TOL_GAP:
            assert sorted(idxs[r].tolist()) == sorted(want_idxs[r].tolist()), r


def test_entry_step_equals_jax_exact_topk():
    k = 10
    fn, (q, v, m) = graft_entry.entry(device="cpu", num_q=16, cap=4096,
                                      dim=64, k=k)
    assert q.device.type == v.device.type == m.device.type == "cpu"
    np.testing.assert_allclose(torch.linalg.norm(v, dim=1).numpy(), 1.0,
                               atol=1e-6)
    vals, idxs = fn(q, v, m)
    assert vals.shape == idxs.shape == (16, k) and idxs.dtype == torch.int32
    qn, vn, mn = q.numpy(), v.numpy(), m.numpy()
    wv, wi = (np.asarray(a) for a in jax_exact_topk(qn, vn, mn, k))
    exact = qn.astype(np.float64) @ vn.astype(np.float64).T
    assert_topk(vals.numpy(), idxs.numpy(), wv, wi, exact, k)
    # descending, and the rows' own exact scores
    assert (np.diff(vals.numpy(), axis=1) <= 0).all()
    np.testing.assert_allclose(
        vals.numpy(), np.take_along_axis(exact, idxs.numpy().astype(np.int64),
                                         axis=1), rtol=0, atol=TOL_SCORE)


def test_entry_default_shapes_are_the_reference_serving_shapes(monkeypatch):
    """With no device the step goes to the card, and raises without one; the
    default widths are picovdb_tpu's entry's (checked on a small call)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    import inspect

    sig = inspect.signature(graft_entry.entry).parameters
    assert (sig["num_q"].default, sig["cap"].default, sig["dim"].default,
            sig["k"].default) == (256, 102_400, 1024, 10)


def test_dryrun_without_devices_or_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(4)
    with pytest.raises(RuntimeError, match="needs 4 devices"):
        graft_entry.dryrun_multichip(4, devices=[CPU] * 3)


@pytest.mark.parametrize("n", [4, 2])
def test_dryrun_multichip_on_cpu_devices(n):
    out = graft_entry.dryrun_multichip(n, devices=[CPU] * n)
    dp = 2 if n == 4 else 1
    assert (out["dp"], out["shards"]) == (dp, n // dp)
    assert out["vals"].shape == (8 * dp, 4)
    assert out["overlap_i8"] >= 0.9 and out["overlap_i4"] >= 0.9
    assert out["calls"] == {"scan_topk": n, "ivf_scan_topk": n // dp,
                            "scan_topk_i8": n, "scan_topk_i4": n}
    # the upsert landed: rows 0-7 are picovdb_tpu's dry run's update rows
    rng = np.random.default_rng(0)
    cap = 64 * (n // dp)
    base = rng.normal(size=(cap, 64)).astype(np.float32)
    rng.normal(size=(8 * dp, 64))
    upd = rng.normal(size=(8, 64)).astype(np.float32)
    np.testing.assert_array_equal(out["vectors"][:8], upd)
    np.testing.assert_array_equal(out["vectors"][8:], base[8:])


def _jax_sharded(out, n, use_pallas):
    devs = jax.devices()[:n]
    mesh = jax_mesh(devices=devs, dp=out["dp"])
    row = NamedSharding(mesh, P("shard", None))
    vec = NamedSharding(mesh, P("shard"))
    qsh = NamedSharding(mesh, P("dp", None) if out["dp"] > 1 else P())
    fn = jax_topk(mesh, "shard", 4, use_pallas=use_pallas,
                  interpret=use_pallas)
    vals, idxs = fn(jax.device_put(out["queries"], qsh),
                    jax.device_put(out["vectors"], row),
                    jax.device_put(out["active"], vec))
    return np.asarray(vals), np.asarray(idxs)


@pytest.mark.skipif(len(jax.devices()) < 4, reason="needs >= 4 JAX devices")
@pytest.mark.parametrize("n", [4, 2])
def test_dryrun_float_answers_equal_jax_sharded_topk(n):
    out = graft_entry.dryrun_multichip(n, devices=[CPU] * n)
    q = out["queries"].astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    exact = q @ out["vectors"].astype(np.float64).T
    for use_pallas in (False, True):
        wv, wi = _jax_sharded(out, n, use_pallas)
        for got in (("vals", "idxs"), ("pallas_vals", "pallas_idxs")):
            assert_topk(out[got[0]], out[got[1]], wv, wi, exact, 4)
