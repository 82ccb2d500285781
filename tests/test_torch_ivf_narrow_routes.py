"""The IVF routes over postings TMA cannot read (glove-25 / glove-100's
widths: 100- and 25-byte float32 / int8 rows, 200- and 50-byte bf16
rows), the port against the JAX package on the CPU (JAX: its Pallas
kernels in interpret mode; the port: the plain versions of K7 / K8, the
code their narrow sweep, tensor-core scan, wide kind and segment scan are
held to on the card).

* Both packages' engines with index="ivf" at dims 25 and 100, float32,
  bf16 (rescore="device") and a host-uploaded int8 store (the int8-only
  layout, the host rescore), through every lane the card's phase 7c
  drives: a single
  `query` (K7's narrow sweep; the int8 store's host-rescore band, K7's
  wide kind), a 64-query `query_columnar` in 32-query chunks (K8 on the
  float stores), a 64-query batch at top_k 64 (k_sel 68: the ladder, K7's
  tensor-core scan) and a 16-query batch at top_k 200 (k_sel 204, K7's
  wide kind). Routes (`last_strategy`) must be identical.
* K7 and K8 on one JAX-built layout handed to the port by
  `IVFIndex.from_numpy_state`: `probe_scan_local` and `probe_scan_segmax`
  at dims 25 and 100 over float32, bf16 and column-scaled int8 postings.

Tolerance: scores within TOL_SCORE = 1e-5 (float32 dot products of the
same rows summed in another order; the host rescore is the same NumPy
code in both); ids equal wherever the float64 k-th / (k + 1)-th gap of
the rows the route ranks exceeds TOL_GAP = 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental.pallas import tpu as pltpu

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu.ops import ivf as jivf
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import ivf as tivf
from picovdb_tpu_torch.ops import scan as tscan
from test_torch_ivf import _routes, assert_same, state_of
from torch_port_setup import cap_torch_threads, cpu_kw

cap_torch_threads()

K_ID, K_METRICS = picovdb_tpu.K_ID, picovdb_tpu.K_METRICS
PACKAGES = {"jax": picovdb_tpu, "torch": picovdb_tpu_torch}
TOL_SCORE = 1e-5
TOL_GAP = 1e-4
N = 3000


@pytest.fixture(autouse=True)
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def clustered(rng, n, dim, n_clusters=12, noise=0.35):
    """Unit-norm gaussian mixture (picovdb_tpu's IVF calibration shape)."""
    centres = normalize_batch(
        rng.normal(size=(n_clusters, dim)).astype(np.float32))
    lab = rng.integers(0, n_clusters, n)
    pts = centres[lab] + noise / np.sqrt(dim) * rng.normal(size=(n, dim))
    return normalize_batch(pts.astype(np.float32))


def _gaps(rows, q, k):
    qn = normalize_batch(np.atleast_2d(q)).astype(np.float64)
    s = qn @ rows.astype(np.float64).T
    s = -np.sort(-s, axis=1)
    return s[:, k - 1] - s[:, k]


def _both(dbs, method, q, **kw):
    out, routes = {}, {}
    for name, db in dbs.items():
        res = getattr(db, method)(q, **kw)
        if method == "query" and np.ndim(q) == 1:
            res = [res]
        if method == "query_columnar":
            ids, sc = res
            res = [[{K_ID: i, K_METRICS: s} for i, s in zip(r, srow)
                    if i is not None] for r, srow in zip(ids, sc)]
        out[name] = res
        routes[name] = db.last_query_debug()["strategy"]
    if not (method == "query_columnar" and routes["jax"] is None
            and routes["torch"] == "ivf_i8"):
        # (picovdb_tpu's query_columnar leaves `strategy` unset on the
        # host-rescore path; the answers are still compared)
        assert routes["jax"] == routes["torch"], routes
    return out["jax"], out["torch"], routes["torch"]


def _same(rj, rt, gaps):
    assert len(rj) == len(rt)
    for i, (hj, ht) in enumerate(zip(rj, rt)):
        assert len(hj) == len(ht), i
        np.testing.assert_allclose([h[K_METRICS] for h in ht],
                                   [h[K_METRICS] for h in hj],
                                   rtol=0, atol=TOL_SCORE)
        if gaps[i] > TOL_GAP:
            assert {h[K_ID] for h in hj} == {h[K_ID] for h in ht}, i


@pytest.mark.parametrize("dim", [25, 100])
@pytest.mark.parametrize("storage", ["float32", "bfloat16", "int8"])
def test_ivf_lanes_on_narrow_postings(tmp_path, monkeypatch, dim, storage):
    if storage == "int8":
        monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # int8 postings below 256
    rng = np.random.default_rng(dim + len(storage))
    vecs = clustered(rng, N, dim)
    # 12 lists over 4,096 postings rows span 2.67 segments each: the float
    # stores' 32-query chunks take the segmax route (k_sel 14), at the
    # depth of 8 keys a segment in both packages (picovdb_tpu sizes its
    # depth max(4, min(8, ceil(1.5 k_sel / span))) = 8 here, the port's is
    # always SEGMAX_DEPTH)
    # bf16 rescores on the device over its bf16 postings (as chip_smoke.py's
    # phase 7c serves it): the host rescore would widen every band by 128
    kw = {"rescore": "device"} if storage == "bfloat16" else {}
    dbs = {}
    for name, pkg in PACKAGES.items():
        db = pkg.PicoVectorDB(embedding_dim=dim, storage_file=f"{tmp_path}/{name}",
                              index="ivf", ivf_nlist=12, storage_dtype=storage,
                              **kw, **cpu_kw(pkg))
        db.upsert_columnar(vecs, ids=[f"d{i}" for i in range(N)])
        dbs[name] = db
    q = (vecs[rng.integers(0, N, 64)]
         + 0.02 * rng.normal(size=(64, dim))).astype(np.float32)
    # the rows each route ranks: bf16 postings rescore the bf16 rows
    rows = (np.asarray(jnp.asarray(vecs).astype(jnp.bfloat16)).astype(np.float32)
            if storage == "bfloat16" else vecs)
    want = "ivf_i8" if storage == "int8" else "ivf"
    for method, qq, kw in (("query", q[0], {"top_k": 10}),
                           ("query_columnar", q, {"top_k": 10,
                                                  "batch_size": 32}),
                           ("query", q, {"top_k": 64}),
                           ("query", q[:16], {"top_k": 200})):
        rj, rt, route = _both(dbs, method, qq, **kw)
        assert route == want, (method, kw, route)
        _same(rj, rt, _gaps(rows, qq, kw["top_k"]))
    op = {n: db.last_query_debug()["ann_operating_point"]
          for n, db in dbs.items()}
    assert op["jax"] == op["torch"]
    assert op["torch"]["layout"] == ("int8_only" if storage == "int8"
                                     else "classic")


def test_the_lanes_take_the_kinds_phase_7c_names():
    """Which K7 / K8 kind each lane's shape reaches on the card over such
    postings (CPU tensors at the postings' widths, 16-byte aligned):
    Q = 1 the narrow sweep, Q = 64 at k_sel 68 the tensor-core scan, k_sel
    144 / 204 / 334 the wide kind, K8 the segment scan; every one fed by the
    producer `rows_piece` names, none by TMA."""
    for dtype, dim, piece in ((np.float32, 25, 4), ("bfloat16", 100, 8),
                              ("bfloat16", 25, 2), (np.int8, 100, 4),
                              (np.int8, 25, 2)):
        import torch
        dt = {np.float32: torch.float32, np.int8: torch.int8}.get(
            dtype, torch.bfloat16)
        v = torch.zeros(2048, dim, dtype=dt)
        if v.data_ptr() % 16:
            pytest.skip("an unaligned CPU allocation")
        assert tscan.rows_piece(v) == piece
        for nq, k, kind in ((1, 14, "narrow"), (1, 16, "narrow"),
                            (64, 68, "wgmma"), (1, 144, "wide"),
                            (16, 204, "wide"), (64, 334, "wide")):
            q = torch.zeros(nq, dim, dtype=dt)
            got = ("narrow" if tivf.ivf_narrow_ready(q, v, k) else
                   "wgmma" if tivf.ivf_wgmma_ready(q, v, k) else
                   "wide" if tivf.ivf_wide_ready(q, v, k) else "template")
            assert not tivf.ivf_sweep_ready(q, v, k)
            assert got == kind, (dtype, dim, nq, k, got)


@pytest.fixture(scope="module")
def layouts():
    """JAX-built IVF layouts at dims 25 and 100 (16 clusters over 6,000
    clustered rows), classic and int8-only."""
    out = {}
    rng = np.random.default_rng(21)
    for dim in (25, 100):
        v = clustered(rng, 6000, dim, n_clusters=16)
        mask = np.ones(6000, bool)
        out[dim] = (jivf.IVFIndex.build(v, mask, nlist=16, dim=dim), v)
    return out


@pytest.mark.parametrize("dim", [25, 100])
@pytest.mark.parametrize("postings", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("style", ["ladder", "segmax"])
def test_k7_k8_on_one_jax_layout(layouts, monkeypatch, dim, postings, style):
    """`probe_scan_local` (K7) and `probe_scan_segmax` (K8) of both
    packages on one layout at the postings' narrow widths: float32, bf16,
    and the classic layout's column-scaled int8 selection mirror."""
    j0, v = layouts[dim]
    if postings == "int8":
        monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # the classic int8 mirror
    st = state_of(j0)
    j = jivf.IVFIndex(
        j0.centroids,
        j0.vectors.astype(jnp.bfloat16) if postings == "bfloat16" else j0.vectors,
        j0.slots, j0.row_cluster, j0.active, j0.cluster2tile, j0.nlist,
        j0.n_tiles, j0.dim, seg_starts=j0.seg_starts)
    st["vectors"] = np.asarray(j.vectors)
    st["vectors_i8c"] = (None if j.vectors_i8c is None
                         else np.asarray(j.vectors_i8c))
    st["cscale"] = None if j.cscale is None else np.asarray(j.cscale)
    if postings == "int8":
        assert st["vectors_i8c"] is not None and st["vectors_i8c"].shape[1] == dim
    t = tivf.IVFIndex.from_numpy_state(**st, device="cpu")
    rng = np.random.default_rng(dim)
    q = normalize_batch(v[rng.integers(0, len(v), 16)]
                        + 0.02 * rng.normal(size=(16, dim))).astype(np.float32)
    k = 10
    # int8: the TPU ladder ranks int32 scores with their low 10 bits
    # replaced by the lane, the port ranks them exactly; a band of k + 30
    # holds the true top-k on both sides
    k_sel = k + (30 if postings == "int8" else 4)
    jr, tr = _routes(j, t, q, k, k_sel, nprobe=16, style=style)
    rows = np.asarray(j.vectors).astype(np.float32)
    s = normalize_batch(q).astype(np.float64) @ rows.astype(np.float64).T
    s[:, ~np.asarray(j.active)] = -np.inf
    s = -np.sort(-s, axis=1)
    assert_same(*jr, *tr, s[:, k - 1] - s[:, k])
