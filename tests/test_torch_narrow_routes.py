"""The routes that reach K3 and K4 over rows TMA cannot read, the port
against the JAX package on the CPU (JAX: Pallas interpret mode; the port:
its kernels' plain versions, the code the new kinds are held to on the
card).

* The route functions at dims 25, 100, 300, 1019 and 1020 on the same
  seeded inputs: `make_fused_topk_i8` (K3 over the int8 mirror, the Q = 1
  and Q <= 16 route `i8_fused_smallq`), `make_mixed_fused_topk` (K4 over
  the bf16 mirror: the filtered batch and top_k 32) and `make_fused_topk`
  at top_k 200 over the float32 rows (the wide kind and the exact retry).
* Both packages' engines (`PicoVectorDB(mixed_precision=True,
  int8_tier=True, use_pallas=True)`) on 100-, 300- and 1019-wide stores:
  a single `query` (`i8_fused_smallq`), a 16-query batch (the same
  route), a 64-query batch under an id filter
  (`mixed_fused_batch_filtered`), top_k 32 (`mixed_fused_batch`) and top_k
  200 (the wide kind). The routes are the same.

Tolerance: scores within TOL_SCORE = 1e-5 (float32 dot products of the
same rows summed in another order); ids equal wherever the float64 k-th /
(k + 1)-th gap of the rows the route ranks exceeds TOL_GAP = 1e-4.
"""

import numpy as np
import pytest
import torch

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads, cpu_kw

cap_torch_threads()

K_ID, K_METRICS = picovdb_tpu.K_ID, picovdb_tpu.K_METRICS
PACKAGES = {"jax": picovdb_tpu, "torch": picovdb_tpu_torch}
TOL_SCORE = 1e-5
TOL_GAP = 1e-4
CAP = 2048


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _gaps(rows, mask, q, k):
    qn = normalize_batch(q).astype(np.float64)
    s = qn @ rows[mask].astype(np.float64).T
    s = -np.sort(-s, axis=1)
    return s[:, k - 1] - s[:, k] if s.shape[1] > k else np.full(len(q), np.inf)


def _agree(jv, ji, tv, ti, gaps):
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_array_equal(np.isneginf(jv), np.isneginf(tv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=TOL_SCORE)
    for i in range(jv.shape[0]):
        if gaps[i] > TOL_GAP:
            assert set(ti[i][fin[i]].tolist()) == set(ji[i][fin[i]].tolist()), i


def _inputs(dim, nq, seed):
    rng = np.random.default_rng(seed)
    v = normalize_batch(rng.standard_normal((CAP, dim)).astype(np.float32))
    q = (v[rng.integers(0, CAP, nq)]
         + 0.3 * rng.standard_normal((nq, dim))).astype(np.float32)
    mask = rng.random(CAP) > 0.1
    return rng, v, q, mask


DIMS = [25, 100, 300, 1019, 1020]


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("nq", [1, 16])
def test_int8_small_batch_route(dim, nq):
    """`i8_fused_smallq`'s function: K3 over the int8 mirror at k_sel 14,
    the float32 rescore."""
    _, v, q, mask = _inputs(dim, nq, dim + nq)
    v8, vs = map(np.asarray, jps.quantize_rows_i8(v))
    jv, ji = jps.make_fused_topk_i8(10, interpret=True, tie_scale=0.0)(
        q, v8, vs, v, mask)
    tv, ti = tscan.make_fused_topk_i8(10, tie_scale=0.0)(
        _t(q), _t(v8), _t(vs), _t(v), _t(mask))
    _agree(jv, ji, tv, ti, _gaps(v, mask, q, 10))


@pytest.mark.parametrize("dim", DIMS)
@pytest.mark.parametrize("k,filt", [(10, True), (32, False)])
def test_bf16_batch_route(dim, k, filt):
    """`mixed_fused_batch[_filtered]`'s function: K4 over the bf16 mirror
    at Q = 64 (k_sel 14 under a 300-row filter, 36), the float32
    rescore."""
    rng, v, q, mask = _inputs(dim, 64, 3 * dim + k)
    if filt:
        keep = np.zeros(CAP, bool)
        keep[rng.choice(CAP, 300, replace=False)] = True
        mask &= keep
    vb = jps.jnp.asarray(v).astype(jps.jnp.bfloat16)
    jv, ji = jps.make_mixed_fused_topk(k, interpret=True, tie_scale=0.0)(
        q, vb, v, mask)
    tv, ti = tscan.make_mixed_fused_topk(k, tie_scale=0.0)(
        _t(q), _t(v).to(torch.bfloat16), _t(v), _t(mask))
    _agree(jv, ji, tv, ti, _gaps(v, mask, q, k))


@pytest.mark.parametrize("dim", DIMS)
def test_wide_route_over_float32_rows(dim):
    """`make_fused_topk` at top_k 200 (k_sel 204: K4's wide kind) over the
    float32 rows, as the exact retry and `pallas_fused` serve it."""
    _, v, q, mask = _inputs(dim, 8, 5 * dim)
    jv, ji = jps.make_fused_topk(200, interpret=True)(q, v, mask)
    tv, ti = tscan.make_fused_topk(200)(_t(q), _t(v), _t(mask))
    _agree(jv, ji, tv, ti, _gaps(v, mask, q, 200))


def _stores(tmp, dim, n=CAP):
    rng = np.random.default_rng(dim)
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    dbs = {}
    for name, pkg in PACKAGES.items():
        db = pkg.PicoVectorDB(embedding_dim=dim, storage_file=f"{tmp}/{name}",
                              mixed_precision=True, int8_tier=True,
                              use_pallas=True, **cpu_kw(pkg))
        db.upsert_columnar(vecs, ids=[f"d{i}" for i in range(n)])
        dbs[name] = db
    return dbs, normalize_batch(vecs), rng


def _query_both(dbs, q, **kw):
    out = {}
    for name, db in dbs.items():
        res = db.query(q, **kw)
        out[name] = res if q.ndim == 2 else [res]
        out[name + "_route"] = db.last_query_debug()["strategy"]
    assert out["jax_route"] == out["torch_route"], out
    return out


def _compare(out, gaps):
    for i, (hj, ht) in enumerate(zip(out["jax"], out["torch"])):
        assert len(hj) == len(ht), i
        np.testing.assert_allclose([h[K_METRICS] for h in ht],
                                   [h[K_METRICS] for h in hj],
                                   rtol=0, atol=TOL_SCORE)
        if gaps[i] > TOL_GAP:
            assert {h[K_ID] for h in hj} == {h[K_ID] for h in ht}, i


@pytest.mark.parametrize("dim", [100, 300, 1019])
def test_engine_routes_on_narrow_stores(tmp_path, dim):
    dbs, rows, rng = _stores(tmp_path, dim)
    q = (rows[rng.integers(0, CAP, 64)]
         + 0.3 * rng.standard_normal((64, dim))).astype(np.float32)
    live = np.ones(CAP, bool)
    for qq, kw, route in ((q[0], {"top_k": 10}, "i8_fused_smallq"),
                          (q[:16], {"top_k": 10}, "i8_fused_smallq"),
                          (q, {"top_k": 32}, "mixed_fused_batch"),
                          (q, {"top_k": 200}, "mixed_fused_batch")):
        out = _query_both(dbs, qq, **kw)
        assert out["torch_route"] == route
        _compare(out, _gaps(rows, live, np.atleast_2d(qq), kw["top_k"]))
    allow = rng.choice(CAP, 300, replace=False)
    keep = np.zeros(CAP, bool)
    keep[allow] = True
    out = _query_both(dbs, q, top_k=10, ids=[f"d{i}" for i in allow])
    assert out["torch_route"] == "mixed_fused_batch_filtered"
    assert all(int(h[K_ID][1:]) in set(allow.tolist())
               for r in out["torch"] for h in r)
    _compare(out, _gaps(rows, keep, q, 10))
