"""picovdb_tpu_torch's opt-in selection tiers against picovdb_tpu on the CPU.

The column-scaled int8 mirror and its two kernels (K9 `fused_topk_i8c`,
K10 `segmax_scan_i8c`), `PICOVDB_SEGMAX_I8` on float32 stores and
`scan_mode="approx"`. The same seeded numpy inputs go through the JAX
function (its Pallas kernels in interpret mode) and the port's counterpart
(its kernels' plain PyTorch versions on CPU tensors). Tolerances, each
with its reason:

  * K10's keys are bit-identical: integer sums, the same packing;
  * K9 ranks the exact int32 sum, the TPU kernel (s & ~(L - 1)) | lane
    with L = its block width: the TPU scores must equal the port's floored
    to a multiple of L, exactly, since the top-k of the floored values is
    the floor of the top-k;
  * rescored scores agree within TOL_SCORE = 1e-5 (float32 dot products
    of the same rows, summed in different orders);
  * id sets agree wherever the float64 k-th/(k+1)-th gap exceeds the
    route's margin (TOL_GAP = 1e-4, or the int8 tier's noise margin
    `_tie_margin("i8")` where the two selections differ by design).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu.device import DeviceIndex as JaxIndex
from picovdb_tpu.ops import exact as jexact
from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch import probes
from picovdb_tpu_torch.device import DeviceIndex as TorchIndex
from picovdb_tpu_torch.ops import exact as texact
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads, cpu_kw

cap_torch_threads()

K_ID, K_METRICS, K_VECTOR = (picovdb_tpu.K_ID, picovdb_tpu.K_METRICS,
                             picovdb_tpu.K_VECTOR)
PACKAGES = {"jax": picovdb_tpu, "torch": picovdb_tpu_torch}
TOL_SCORE = 1e-5
TOL_GAP = 1e-4
CAP = 8192
OPT_IN_ENVS = ("PICOVDB_SEGMAX_I8", "PICOVDB_INT8C_TIER",
               "PICOVDB_SEGMAX_I8C", "PICOVDB_SMALLQ_I8C",
               "PICOVDB_MIXED_BUDGET_GB", "PICOVDB_TIE_MARGIN_SCALE")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for env in OPT_IN_ENVS:
        monkeypatch.delenv(env, raising=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _data(seed, cap=CAP, dim=128, nq=8, keep=0.8):
    rng = np.random.default_rng(seed)
    v = normalize_batch(rng.normal(size=(cap, dim)).astype(np.float32))
    q = normalize_batch(rng.normal(size=(nq, dim)).astype(np.float32))
    mask = rng.random(cap) < keep
    v8, cs = map(np.asarray, jps.quantize_cols_i8(jnp.asarray(v)))
    q8 = np.asarray(jps.fold_queries_i8(jnp.asarray(q), jnp.asarray(cs)))
    return v, q, mask, v8, cs, q8


def _gaps(v, mask, q, k):
    s = normalize_batch(q).astype(np.float64) @ v[mask].astype(np.float64).T
    s = -np.sort(-s, axis=1)
    return s[:, k - 1] - s[:, k]


def _same_topk(vals_j, idx_j, vals_t, idx_t, gaps, margin):
    vals_j, vals_t = np.asarray(vals_j), np.asarray(vals_t)
    np.testing.assert_array_equal(np.isneginf(vals_j), np.isneginf(vals_t))
    fin = np.isfinite(vals_j)
    np.testing.assert_allclose(vals_t[fin], vals_j[fin], rtol=0, atol=TOL_SCORE)
    for i in range(vals_j.shape[0]):
        if gaps[i] > margin:
            assert set(np.asarray(idx_j)[i]) == set(np.asarray(idx_t)[i]), i


# --------------------------------------------------------------------------
# Repairs: the mirror budget and stats()["mirrors"]
# --------------------------------------------------------------------------


@pytest.mark.parametrize("i8c_env", [None, "0"])
def test_mirror_budget_counts_the_i8c_byte(monkeypatch, i8c_env):
    """With the int8 tier on, the JAX package counts 8 B/element (f32 +
    bf16 + int8 rows + the column-scaled mirror, which its tier places
    even while both of its routes are off), 7 with PICOVDB_INT8C_TIER=0.
    A budget between the two must route both packages alike."""
    dim, n, nq, k = 16, 32_768, 32, 3
    monkeypatch.setenv("PICOVDB_MIXED_BUDGET_GB", repr(4.0e6 / 2**30))
    if i8c_env is not None:
        monkeypatch.setenv("PICOVDB_INT8C_TIER", i8c_env)
    rng = np.random.default_rng(3)
    v = normalize_batch(rng.normal(size=(n, dim)).astype(np.float32))
    q = v[:nq] + 0.05 * rng.normal(size=(nq, dim)).astype(np.float32)
    seen = {}
    for name, cls in (("jax", JaxIndex), ("torch", TorchIndex)):
        dev = cls(dim, int8_tier=True, mixed_precision=True, **cpu_kw(cls))
        dev.full_upload(v, np.ones(n, bool))
        vals, idx = dev.query(q, k)
        seen[name] = (dev.last_strategy, dev.vectors_lp is None,
                      dev.vectors_i8 is None, dev._i8c_budget_ok,
                      dev._mirror_budget()[1], np.asarray(idx))
    j, t = seen["jax"], seen["torch"]
    assert j[:5] == t[:5], (j[:5], t[:5])
    assert j[4] == (7 if i8c_env == "0" else 8)
    assert (t[0] == "xla_topk") == (i8c_env is None)
    np.testing.assert_array_equal(j[5], t[5])


def test_stats_mirror_keys_match(tmp_path):
    dbs = {}
    for name, pkg in PACKAGES.items():
        db = pkg.PicoVectorDB(embedding_dim=16, storage_file=str(tmp_path / name),
                              **cpu_kw(pkg))
        db.upsert([{K_ID: "a", K_VECTOR: np.ones(16, np.float32)}])
        db.query(np.ones(16, np.float32), top_k=1)
        dbs[name] = db.stats()["mirrors"]
    assert dbs["jax"] == dbs["torch"]
    assert set(dbs["torch"]) == {"bf16", "int8_rows", "int8_cols"}


# --------------------------------------------------------------------------
# K9 fused_topk_i8c and K10 segmax_scan_i8c against the TPU kernels
# --------------------------------------------------------------------------


def _int_oracle(q8, v8, mask, k):
    """Top-k by (int32 sum desc, row asc) over the live rows."""
    s = q8.astype(np.int64) @ v8.astype(np.int64).T
    out_v, out_i = [], []
    rows = np.nonzero(mask)[0]
    for i in range(s.shape[0]):
        order = np.lexsort((rows, -s[i, rows]))[:k]
        out_v.append(s[i, rows[order]])
        out_i.append(rows[order])
    return np.array(out_v), np.array(out_i)


@pytest.mark.parametrize("nq,k", [(1, 14), (5, 16), (16, 12), (3, 40)])
def test_k9_plain_matches_tpu_kernel(nq, k):
    v, q, mask, v8, cs, q8 = _data(9 + nq, nq=nq)
    vals, idx = tscan.fused_topk_i8c(_t(q8), _t(v8), _t(mask), k)
    vals, idx = vals.numpy(), idx.numpy()
    ov, oi = _int_oracle(q8, v8, mask, k)
    np.testing.assert_array_equal(idx, oi)  # exact sums, ties to the lower row
    np.testing.assert_array_equal(vals, ov.astype(np.float32))
    jv, ji = map(np.asarray, jps.fused_topk_i8c(
        jnp.asarray(q8), jnp.asarray(v8), jnp.asarray(mask), k, interpret=True))
    bn = jps._pick_bn(q8.shape[1], min(jps.DEFAULT_QT, nq), k, 1, CAP, 4096)
    unit = 1 << max(1, int(bn - 1).bit_length())
    np.testing.assert_array_equal(np.floor(vals / unit) * unit, jv)
    assert bool(mask[idx].all()) and bool(mask[ji].all())


def test_k9_underfilled_and_all_masked():
    v, q, _, v8, cs, q8 = _data(4, nq=2)
    mask = np.zeros(CAP, bool)
    mask[[5, 900, 4100]] = True
    vals, idx = tscan.fused_topk_i8c(_t(q8), _t(v8), _t(mask), 8)
    assert np.isneginf(vals.numpy()[:, 3:]).all() and (idx.numpy()[:, 3:] == 0).all()
    assert set(idx.numpy()[0, :3]) == {5, 900, 4100}
    jv, _ = jps.fused_topk_i8c(jnp.asarray(q8), jnp.asarray(v8),
                               jnp.asarray(mask), 8, interpret=True)
    np.testing.assert_array_equal(np.isneginf(np.asarray(jv)),
                                  np.isneginf(vals.numpy()))
    none = np.zeros(CAP, bool)
    vals, idx = tscan.fused_topk_i8c(_t(q8), _t(v8), _t(none), 8)
    assert np.isneginf(vals.numpy()).all() and not idx.numpy().any()
    fn = jps.make_fused_topk_i8c(8, interpret=True)
    tv, _ = tscan.make_fused_topk_i8c(8)(_t(q), _t(v8), _t(cs), _t(v), _t(none))
    jv, _ = fn(jnp.asarray(q), jnp.asarray(v8), jnp.asarray(cs),
               jnp.asarray(v), jnp.asarray(none))
    assert np.isneginf(tv.numpy()).all() and np.isneginf(np.asarray(jv)).all()


def test_k9_refuses_k_past_its_ladder():
    """K9 serves k_sel <= SCAN_KSEL_MAX and has no wider path: its routes
    keep k + 6 <= 16."""
    v, q, mask, v8, cs, q8 = _data(6, nq=2)
    with pytest.raises(ValueError, match="outside"):
        tscan.fused_topk_i8c(_t(q8), _t(v8), _t(mask), tscan.SCAN_KSEL_MAX + 1)
    assert "scan_topk_i8c" not in tscan.WIDE_K_FALLBACKS


def _tpu_slab_to_port(keys_t, ns, nq):
    """The TPU kernel's (n_tiles * 2 * ns, Q) slab (per tile ns first-best
    rows, then ns second-best) in the port's (Q, 2 * cap / 128) layout,
    column 2 * seg + r."""
    keys_t = np.asarray(keys_t)
    n_tiles = keys_t.shape[0] // (2 * ns)
    return keys_t.reshape(n_tiles, 2, ns, nq).transpose(3, 0, 2, 1).reshape(nq, -1)


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("dim,nq", [(16, 40), (128, 24), (96, 256)])
def test_k10_keys_bit_identical(stream, dim, nq):
    v, q, mask, v8, cs, q8 = _data(dim + nq, dim=dim, nq=nq)
    keys_t, ns = jps.segmax_scan_i8c(jnp.asarray(q8), jnp.asarray(v8),
                                     jnp.asarray(mask), interpret=True,
                                     stream=stream, raw_t=True)
    got = tscan.segmax_scan_i8c(_t(q8), _t(v8), _t(mask)).numpy()
    np.testing.assert_array_equal(got, _tpu_slab_to_port(keys_t, ns, nq))
    # the plain version is the same keys whichever order the TPU ran
    np.testing.assert_array_equal(
        got, tscan.segmax_scan_i8c_plain(_t(q8), _t(v8), _t(mask)).numpy())


def test_k10_refuses_what_the_kernel_cannot_key():
    q8 = torch.zeros((2, 140_000), dtype=torch.int8)
    v8 = torch.zeros((128, 140_000), dtype=torch.int8)
    with pytest.raises(ValueError, match="int32"):
        tscan.segmax_scan_i8c(q8, v8, torch.ones(128, dtype=torch.bool))
    with pytest.raises(ValueError, match="multiple"):
        tscan.segmax_scan_i8c(q8[:, :16], v8[:100, :16],
                              torch.ones(100, dtype=torch.bool))


@pytest.mark.parametrize("route,k", [("fused", 4), ("fused", 10),
                                     ("segmax", 10), ("segmax", 16)])
def test_i8c_routes_match(route, k):
    nq = 4 if route == "fused" else 48
    v, q, mask, v8, cs, q8 = _data(k + nq, nq=nq)
    q = q + 0.1  # not unit: both routes normalize on the device
    if route == "fused":
        jfn = jps.make_fused_topk_i8c(k, interpret=True, tie_scale=1.0)
        tfn = tscan.make_fused_topk_i8c(k, tie_scale=1.0)
    else:
        jfn = jps.make_segmax_topk_i8c(k, interpret=True, tie_scale=1.0)
        tfn = tscan.make_segmax_topk_i8c(k, tie_scale=1.0)
    jv, ji = jfn(jnp.asarray(q), jnp.asarray(v8), jnp.asarray(cs),
                 jnp.asarray(v), jnp.asarray(mask))
    tv, ti = tfn(_t(q), _t(v8), _t(cs), _t(v), _t(mask))
    margin = tscan._tie_margin("i8", q.shape[1], 1.0)
    _same_topk(jv, ji, tv.numpy(), ti.numpy(), _gaps(v, mask, q, k), margin)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("k", [1, 10, 40])
def test_approx_topk_matches(k, cd):
    """float32 products: the exact top-k as it is; bfloat16 products: the
    top-k_sel candidates rescored in float32."""
    v, q, mask, *_ = _data(k, nq=6)
    jv, ji = jexact.make_approx_topk(k, cd)(jnp.asarray(q), jnp.asarray(v),
                                            jnp.asarray(mask))
    tv, ti = texact.make_approx_topk(k, cd)(_t(q), _t(v), _t(mask))
    _same_topk(jv, ji, tv.numpy(), ti.numpy(), _gaps(v, mask, q, k), TOL_GAP)
    few = np.zeros(CAP, bool)
    few[:5] = True
    tv, _ = texact.make_approx_topk(8, cd)(_t(q), _t(v), _t(few))
    assert tv.shape == (6, 8) and np.isneginf(tv.numpy()[:, 5:]).all()


# --------------------------------------------------------------------------
# DeviceIndex: flags, the lazy mirror, grow
# --------------------------------------------------------------------------


@pytest.mark.parametrize("envs", [
    {},
    {"PICOVDB_SEGMAX_I8": "1"},
    {"PICOVDB_INT8C_TIER": "0", "PICOVDB_SEGMAX_I8C": "1"},
    {"PICOVDB_SEGMAX_I8C": "1", "PICOVDB_SMALLQ_I8C": "true"},
    {"PICOVDB_INT8C_TIER": "1", "PICOVDB_SMALLQ_I8C": "1"},
])
@pytest.mark.parametrize("int8_tier", [True, False])
def test_tier_flags_read_alike(monkeypatch, envs, int8_tier):
    for env, val in envs.items():
        monkeypatch.setenv(env, val)
    flags = ("segmax_i8", "i8c_tier", "segmax_i8c", "smallq_i8c")
    j = JaxIndex(16, int8_tier=int8_tier)
    t = TorchIndex(16, int8_tier=int8_tier, device="cpu")
    assert [getattr(j, f) for f in flags] == [getattr(t, f) for f in flags]


def test_grow_drops_the_i8c_mirror_and_regates(monkeypatch):
    """`grow` drops the column-scaled mirror and re-gates its budget at the
    new capacity, as picovdb_tpu does, so `ensure_i8c_mirror` cannot build
    an over-budget mirror later."""
    dim, n = 16, 8192
    # 8 B/element: 8192 rows fit (1 MiB), the grown capacity does not
    monkeypatch.setenv("PICOVDB_MIXED_BUDGET_GB", repr(1.2 * 2**20 / 2**30))
    v = normalize_batch(np.random.default_rng(0).normal(size=(n, dim))
                        .astype(np.float32))
    seen = {}
    for name, cls in (("jax", JaxIndex), ("torch", TorchIndex)):
        dev = cls(dim, int8_tier=True, mixed_precision=True, **cpu_kw(cls))
        dev.full_upload(v, np.ones(n, bool))
        assert dev.ensure_i8c_mirror() and dev.vectors_i8c is not None
        assert dev.grow(2 * n)
        seen[name] = (dev.cap, dev.vectors_i8c is None, dev._i8c_budget_ok,
                      dev.ensure_i8c_mirror())
    assert seen["jax"] == seen["torch"]
    assert seen["torch"][1:] == (True, False, False)


def test_scatter_drops_the_i8c_mirror_delete_keeps_it():
    dim, n = 16, 8192
    v = normalize_batch(np.random.default_rng(1).normal(size=(n, dim))
                        .astype(np.float32))
    dev = TorchIndex(dim, int8_tier=True, device="cpu")
    dev.full_upload(v, np.ones(n, bool))
    assert dev.ensure_i8c_mirror()
    dev.scatter(np.array([3]), None, np.array([False]))
    assert dev.vectors_i8c is not None  # delete-only: the mask is enough
    dev.scatter(np.array([4]), 3 * v[4:5], np.array([True]))
    assert dev.vectors_i8c is None and dev.ensure_i8c_mirror()
    np.testing.assert_array_equal(
        dev.cscale.numpy(),
        np.asarray(jps.quantize_cols_i8(jnp.asarray(dev.vectors.numpy()))[1]))


def test_quantized_store_has_no_i8c_tier(monkeypatch):
    monkeypatch.setenv("PICOVDB_INT8C_TIER", "1")
    monkeypatch.setenv("PICOVDB_SMALLQ_I8C", "1")
    routes = []
    for cls in (JaxIndex, TorchIndex):
        dev = cls(16, storage_dtype="int8", **cpu_kw(cls))
        dev.full_upload(np.eye(16, dtype=np.float32), np.ones(16, bool))
        assert not dev.ensure_i8c_mirror()
        dev.query(np.eye(16, dtype=np.float32)[:1], 3)
        routes.append(dev.last_strategy)
    assert routes == ["i8stor_fused_smallq"] * 2


# --------------------------------------------------------------------------
# Engine replays through both packages
# --------------------------------------------------------------------------

DIM = 32
N = 33_000  # padded capacity 40960 >= SEGMAX_MIN_CAP: the segmax tier routes


@pytest.fixture(autouse=True)
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


def _build(tmp, monkeypatch, envs, **kw):
    for env, val in envs.items():
        monkeypatch.setenv(env, val)
    rng = np.random.default_rng(11)
    vecs = rng.normal(size=(N, DIM)).astype(np.float32)
    dbs = {}
    for name, pkg in PACKAGES.items():
        db = pkg.PicoVectorDB(embedding_dim=DIM, storage_file=f"{tmp}/{name}",
                              int8_tier=True, **kw, **cpu_kw(pkg))
        db.upsert_columnar(vecs, ids=[f"d{i}" for i in range(N)],
                           metadata=[{"tag": i % 5} for i in range(N)])
        dbs[name] = db
    return dbs, vecs


def _replay(dbs, vecs, q, live=None, **kw):
    out = {}
    for name, db in dbs.items():
        res = db.query(q, **kw)
        out[name] = res if q.ndim == 2 else [res]
        out[name + "_route"] = db.last_query_debug()["strategy"]
    assert out["jax_route"] == out["torch_route"], out
    live = np.ones(N, bool) if live is None else live
    gaps = _gaps(vecs, live, np.atleast_2d(q), kw["top_k"])
    for i, (hj, ht) in enumerate(zip(out["jax"], out["torch"])):
        assert len(hj) == len(ht), i
        np.testing.assert_allclose([h[K_METRICS] for h in ht],
                                   [h[K_METRICS] for h in hj],
                                   rtol=0, atol=TOL_SCORE)
        if gaps[i] > TOL_GAP:
            assert {h[K_ID] for h in hj} == {h[K_ID] for h in ht}, i
    return out


I8C = {"PICOVDB_SEGMAX_I8C": "1", "PICOVDB_SMALLQ_I8C": "1"}


def test_engine_i8c_replay(tmp_path, monkeypatch):
    """i8c_fused_smallq (Q = 1), segmax_i8c[_stream] (batches), a delete,
    and the "big row" upsert of picovdb_tpu's own engine test: a row past
    every column maximum drops the mirror, the next dispatch requantizes
    it, and the row wins exactly."""
    dbs, vecs = _build(tmp_path, monkeypatch, I8C)
    rng = np.random.default_rng(5)
    q = vecs[rng.integers(0, N, 300)] + 0.3 * rng.normal(size=(300, DIM))
    q = q.astype(np.float32)
    assert _replay(dbs, vecs, q[0], top_k=5)["torch_route"] == "i8c_fused_smallq"
    assert _replay(dbs, vecs, q[:40], top_k=10)["torch_route"] == "segmax_i8c"
    assert _replay(dbs, vecs, q, top_k=8)["torch_route"] == "segmax_i8c_stream"
    assert _replay(dbs, vecs, q[:3], top_k=11)["torch_route"] == "i8_fused_smallq"
    for db in dbs.values():
        assert db.stats()["mirrors"]["int8_cols"]
        db.delete(["d55", "d56"])
    live = np.ones(N, bool)
    live[[55, 56]] = False
    got = _replay(dbs, vecs, vecs[55], live=live, top_k=3)
    assert got["torch_route"] == "i8c_fused_smallq"
    assert all(h[K_ID] not in ("d55", "d56") for h in got["torch"][0])
    big = np.full(DIM, 3.0, dtype=np.float32)
    for db in dbs.values():
        db.upsert([{K_ID: "big", K_VECTOR: big}])
    for qq in (big, np.stack([big] * 20)):
        for name, db in dbs.items():
            res = db.query(qq, top_k=1)
            res = res if qq.ndim == 2 else [res]
            assert all(r[0][K_ID] == "big" for r in res), name
            assert db.last_query_debug()["strategy"].startswith(
                ("i8c_fused_smallq", "segmax_i8c")), name
    assert dbs["torch"]._dev.vectors_i8c is not None
    np.testing.assert_array_equal(
        dbs["torch"]._dev.cscale.numpy(), np.asarray(dbs["jax"]._dev.cscale))


def test_engine_i8c_serial_loop(tmp_path, monkeypatch):
    """The serial Q = 1 lane over the column-scaled mirror: the port's
    slots are the float64 oracle's outside TOL_GAP and the ids of its
    per-call route; picovdb_tpu's agree with them, slots and scores, on
    every query its own lane answers exactly. Its ladder ranks (s & ~0xFFF)
    | lane, 4,096 units of a raw sum of at most 127 * 127 * 32 at this
    width, and no retry wraps the lane, so it may drop a true top-k row
    (this seed: one of 12). The JAX lane also marks crowding although no
    retry wraps it (ROADMAP queue 3); the port's does not, so the mark is
    off here for the comparison."""
    monkeypatch.setenv("PICOVDB_TIE_MARGIN_SCALE", "0")
    dbs, vecs = _build(tmp_path, monkeypatch, I8C)
    q = vecs[:12] + 0.2 * np.random.default_rng(2).normal(size=(12, DIM))
    q = q.astype(np.float32)
    out = {}
    for name, db in dbs.items():
        out[name] = db.query_serial_loop(q, top_k=5)
        assert db._dev.last_strategy == "i8c_fused_smallq_loop"
    s = normalize_batch(q).astype(np.float64) @ normalize_batch(vecs).T
    truth = np.argsort(-s, axis=1)[:, :5]
    gaps = _gaps(vecs, np.ones(N, bool), q, 5)
    exact_j = 0
    for i in range(12):
        if gaps[i] > TOL_GAP:
            assert set(out["torch"][1][i]) == set(truth[i]), i
        if set(out["jax"][1][i]) == set(truth[i]):
            exact_j += 1
            np.testing.assert_array_equal(out["jax"][1][i], out["torch"][1][i])
            np.testing.assert_allclose(out["torch"][0][i], out["jax"][0][i],
                                       rtol=0, atol=TOL_SCORE)
    assert exact_j >= 10
    per_call = [[h[K_ID] for h in dbs["torch"].query(x, top_k=5)] for x in q]
    slot_ids = [[dbs["torch"]._ids[s] for s in row] for row in out["torch"][1]]
    assert per_call == slot_ids


def test_engine_segmax_i8_replay(tmp_path, monkeypatch):
    dbs, vecs = _build(tmp_path, monkeypatch, {"PICOVDB_SEGMAX_I8": "1"})
    rng = np.random.default_rng(8)
    q = (vecs[rng.integers(0, N, 300)]
         + 0.3 * rng.normal(size=(300, DIM))).astype(np.float32)
    assert _replay(dbs, vecs, q[:64], top_k=10)["torch_route"] == "segmax_i8"
    assert _replay(dbs, vecs, q, top_k=4)["torch_route"] == "segmax_i8_stream"
    assert _replay(dbs, vecs, q[0], top_k=10)["torch_route"] == "i8_fused_smallq"
    for db in dbs.values():
        assert not db.stats()["mirrors"]["int8_cols"]


def test_engine_approx_replay(tmp_path, monkeypatch):
    dbs, vecs = _build(tmp_path, monkeypatch, {}, scan_mode="approx")
    rng = np.random.default_rng(4)
    q = (vecs[rng.integers(0, N, 64)]
         + 0.3 * rng.normal(size=(64, DIM))).astype(np.float32)
    assert _replay(dbs, vecs, q[0], top_k=10)["torch_route"] == "xla_approx"
    assert _replay(dbs, vecs, q, top_k=40)["torch_route"] == "xla_approx"
    got = _replay(dbs, vecs, q[:8], top_k=5, where={"tag": 2},
                  live=np.arange(N) % 5 == 2)
    assert got["torch_route"] == "xla_approx"
    assert all(h["tag"] == 2 for hits in got["torch"] for h in hits)


# --------------------------------------------------------------------------
# P1, the dot-floor probe
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bf16", "i8"])
def test_p1_plain_matches_float64(kind):
    """P1's plain version against a float64 oracle. The JAX probe's
    `dot_only` runs at one fixed shape (8192 x 102,400 x 1024) that Pallas
    interpret mode cannot run here, so the oracle is numpy's."""
    rng = np.random.default_rng(12)
    q = normalize_batch(rng.normal(size=(70, 96)).astype(np.float32))
    v = normalize_batch(rng.normal(size=(1024, 96)).astype(np.float32))
    if kind == "i8":
        q8, _ = tscan.quantize_rows_i8(_t(q))
        v8, _ = tscan.quantize_rows_i8(_t(v))
        got = probes.dot_rowmax(q8, v8).numpy()
        ref = (q8.numpy().astype(np.float64) @ v8.numpy().astype(np.float64).T)
        np.testing.assert_array_equal(got, ref.max(axis=1).astype(np.int32))
    else:
        qb, vb = _t(q).to(torch.bfloat16), _t(v).to(torch.bfloat16)
        got = probes.rowmax_value(probes.dot_rowmax(qb, vb)).numpy()
        ref = qb.double().numpy() @ vb.double().numpy().T
        np.testing.assert_allclose(got, ref.max(axis=1), rtol=0, atol=TOL_SCORE)


def test_probes_refuse_the_cpu():
    for probe in (probes.segmax_sweep, probes.i8c_stages):
        with pytest.raises(ValueError, match="CUDA"):
            probe("cpu")
