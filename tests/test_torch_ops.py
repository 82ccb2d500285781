"""picovdb_tpu_torch ops against picovdb_tpu on the CPU.

The same numpy inputs (seeded) go through the JAX function — its Pallas
kernels in interpret mode, as the JAX package's own tests run them — and
through the port's counterpart, whose wrappers run the kernels' plain
PyTorch versions for CPU tensors. Tolerances are stated per check:

  * id sets agree wherever the exact k-th/(k+1)-th score gap exceeds
    TOL_GAP: inside a smaller gap the two selections may legitimately
    differ (bf16 / packed-key rounding, summation order);
  * returned scores agree within TOL_SCORE: both are float32 dot products
    of the same rows, summed in different orders;
  * -inf (underfill / crowding) positions are identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picovdb_tpu.ops import exact as jexact
from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import exact as texact
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

TOL_SCORE = 1e-5
TOL_GAP = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _corpus(rng, cap, dim, zero_rows=()):
    v = normalize_batch(rng.normal(size=(cap, dim)).astype(np.float32))
    for r in zero_rows:
        v[r] = 0.0
    return v


def _oracle_sorted(q, v, mask):
    """Exact float64 scores over the masked rows, descending, per query."""
    qn = q.astype(np.float64)
    qn /= np.maximum(np.linalg.norm(qn, axis=1, keepdims=True), 1e-300)
    s = qn @ v.astype(np.float64).T
    s[:, ~mask] = -np.inf
    return -np.sort(-s, axis=1)


def assert_same_topk(jv, ji, tv, ti, oracle, k):
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = tv.numpy(), ti.numpy()
    assert jv.shape == tv.shape == (oracle.shape[0], k)
    np.testing.assert_array_equal(np.isneginf(jv), np.isneginf(tv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=TOL_SCORE)
    for i in range(jv.shape[0]):
        if not fin[i].all():
            continue
        gap = oracle[i, k - 1] - (oracle[i, k] if oracle.shape[1] > k else -np.inf)
        if gap > TOL_GAP:
            assert set(ji[i].tolist()) == set(ti[i].tolist()), i


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [16, 64])
def test_normalize_on_device(rng, dim):
    """Zero rows map to e0 exactly; rows whose squared norm sums exactly
    (small integers) normalize bit-identically; other rows within 2 float32
    ulps of 1.0 (XLA and PyTorch sum the squares in different orders)."""
    q = rng.normal(size=(64, dim)).astype(np.float32)
    q[3] = 0.0
    q[5] = 0.0
    q[5, 1], q[5, 2] = 3.0, 4.0  # norm 5, exact
    j = np.asarray(jexact.normalize_on_device(jnp.asarray(q)))
    t = texact.normalize_on_device(_t(q)).numpy()
    np.testing.assert_array_equal(t[3], np.eye(dim, dtype=np.float32)[0])
    np.testing.assert_array_equal(t[[3, 5]], j[[3, 5]])
    np.testing.assert_allclose(t, j, rtol=0, atol=2.4e-7)


def test_sortable_roundtrip_exact(rng):
    f = np.concatenate([
        rng.normal(size=500).astype(np.float32),
        np.array([0.0, -0.0, 1.0, -1.0, np.finfo(np.float32).min,
                  np.finfo(np.float32).max, np.inf, -np.inf], np.float32),
    ])
    bits = f.view(np.int32)
    j = np.asarray(jps._to_sortable(jnp.asarray(bits)))
    t = tscan._to_sortable(_t(bits)).numpy()
    np.testing.assert_array_equal(t, j)
    order = np.argsort(t, kind="stable")
    assert np.all(np.diff(f[order]) >= 0)  # integer order == float order
    np.testing.assert_array_equal(tscan._from_sortable(_t(t)).numpy(), bits)


def test_quantize_rows_i8_exact(rng):
    v = _corpus(rng, 300, 48, zero_rows=(7,))
    jq, js = map(np.asarray, jps.quantize_rows_i8(jnp.asarray(v)))
    tq, ts = tscan.quantize_rows_i8(_t(v))
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)


def test_rescore_exact(rng):
    v = _corpus(rng, 512, 32)
    q = normalize_batch(rng.normal(size=(8, 32)).astype(np.float32))
    idx = rng.integers(0, 512, size=(8, 12)).astype(np.int32)
    vals = rng.normal(size=(8, 12)).astype(np.float32)
    vals[2, 9:] = -np.inf
    jv, ji = map(np.asarray, jps.rescore_exact(q, v, vals, idx))
    tv, ti = tscan.rescore_exact(_t(q), _t(v), _t(vals), _t(idx))
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), ji)


@pytest.mark.parametrize("kind,dim", [("bf16", 64), ("i8", 1024), ("int4", 16)])
def test_tie_margin_and_mark_crowded(rng, kind, dim):
    assert tscan._tie_margin(kind, dim, 1.5) == jps._tie_margin(kind, dim, 1.5)
    k = 4
    full = -np.sort(-rng.normal(size=(32, 9)).astype(np.float32), axis=1)
    full[3, 8] = full[3, 3] - 1e-7  # crowded band
    full[4, 6:] = -np.inf  # exhausted band: never marked
    m = tscan._tie_margin(kind, dim, 1.0)
    j = np.asarray(jps._mark_crowded(jnp.asarray(full[:, :k]), jnp.asarray(full), k, m))
    t = tscan._mark_crowded(_t(full[:, :k]), _t(full), k, m).numpy()
    np.testing.assert_array_equal(t, j)
    assert np.isneginf(t[3, k - 1]) and np.isfinite(t[4, k - 1])


def test_exact_topk(rng):
    v = _corpus(rng, 1000, 24)
    q = normalize_batch(rng.normal(size=(5, 24)).astype(np.float32))
    mask = rng.random(1000) > 0.4
    jv, ji = map(np.asarray, jexact.exact_topk(q, v, mask, 7))
    tv, ti = texact.exact_topk(_t(q), _t(v), _t(mask), 7)
    np.testing.assert_array_equal(ti.numpy(), ji)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# K1 + K2: make_segmax_topk
# --------------------------------------------------------------------------

CAP, DIM = 8192, 32


def _segmax_case(rng, case):
    v = _corpus(rng, CAP, DIM)
    q = rng.normal(size=(16, DIM)).astype(np.float32)
    mask = rng.random(CAP) > 0.1
    k = 10
    if case == "all_masked":
        mask[:] = False
    elif case == "k_over_active":
        mask[:] = False
        mask[rng.choice(CAP, 6, replace=False)] = True
    elif case == "clustered":
        # 8 near-duplicate rows inside one 128-row segment, all else
        # masked: per-segment top-2 can surface only 2 -> -inf underfill
        mask[:] = False
        mask[384:392] = True
        v[384:392] = normalize_batch(v[384] + 0.01 * rng.normal(size=(8, DIM)))
        q = v[384:400] + 0.0
    return q.astype(np.float32), v, mask, k


@pytest.mark.parametrize("case", ["random", "all_masked", "k_over_active",
                                  "clustered"])
def test_segmax_topk_matches_jax(rng, case):
    q, v, mask, k = _segmax_case(rng, case)
    lp_j = jnp.asarray(v).astype(jnp.bfloat16)
    jfn = jps.make_segmax_topk(k, interpret=True)
    jv, ji = jfn(q, lp_j, v, mask)
    tv, ti = tscan.make_segmax_topk(k)(_t(q), _t(v).to(torch.bfloat16),
                                       _t(v), _t(mask))
    assert_same_topk(jv, ji, tv, ti, _oracle_sorted(q, v, mask), k)
    if case in ("all_masked", "k_over_active", "clustered"):
        assert np.isneginf(tv.numpy()).any()
    if case == "all_masked":
        assert np.isneginf(tv.numpy()).all()


def test_segmax_keys_decode(rng):
    """The plain K1 keys decode to the right rows and scores, and K2's
    columns point at the keys it returns."""
    v = _corpus(rng, 1024, 16)
    q = normalize_batch(rng.normal(size=(4, 16)).astype(np.float32))
    mask = rng.random(1024) > 0.5
    qt, vt = _t(q).to(torch.bfloat16), _t(v).to(torch.bfloat16)
    keys = tscan.segmax_scan(qt, vt, _t(mask))
    assert keys.shape == (4, 2 * 1024 // 128)
    tk, tc = tscan.topk_packed_keys(keys, 5)
    np.testing.assert_array_equal(torch.gather(keys, 1, tc.long()).numpy(),
                                  tk.numpy())
    rows = ((tc // 2) * 128 + (tk & 127)).numpy()
    assert mask[rows].all()
    scores = (qt.float() @ vt.float().T).numpy()
    dec = tscan._from_sortable(tk & ~127).view(torch.float32).numpy()
    np.testing.assert_allclose(dec, np.take_along_axis(scores, rows, 1),
                               rtol=2**-15, atol=0)


# --------------------------------------------------------------------------
# K3 make_fused_topk_i8, K4 make_fused_topk / make_mixed_fused_topk
# --------------------------------------------------------------------------


def _ladder_case(rng, filt, zero):
    v = _corpus(rng, CAP, DIM, zero_rows=(11, 4000) if zero else ())
    q = rng.normal(size=(8, DIM)).astype(np.float32)
    if zero:
        q[2] = 0.0  # zero query -> e0
    mask = rng.random(CAP) > 0.1
    if filt:
        mask &= rng.random(CAP) < 0.2
    return q, v, mask


LADDER_CASES = [(5, False, False), (10, True, False), (20, True, True),
                (12, False, True)]


@pytest.mark.parametrize("k,filt,zero", LADDER_CASES)
def test_fused_topk_i8_matches_jax(rng, k, filt, zero):
    q, v, mask = _ladder_case(rng, filt, zero)
    v8, vs = map(np.asarray, jps.quantize_rows_i8(jnp.asarray(v)))
    jv, ji = jps.make_fused_topk_i8(k, interpret=True)(q, v8, vs, v, mask)
    tv, ti = tscan.make_fused_topk_i8(k)(_t(q), _t(v8), _t(vs), _t(v), _t(mask))
    assert_same_topk(jv, ji, tv, ti, _oracle_sorted(q, v, mask), k)


@pytest.mark.parametrize("k,filt,zero", LADDER_CASES)
def test_mixed_fused_topk_matches_jax(rng, k, filt, zero):
    q, v, mask = _ladder_case(rng, filt, zero)
    lp_j = jnp.asarray(v).astype(jnp.bfloat16)
    jv, ji = jps.make_mixed_fused_topk(k, interpret=True)(q, lp_j, v, mask)
    tv, ti = tscan.make_mixed_fused_topk(k)(
        _t(q), _t(v).to(torch.bfloat16), _t(v), _t(mask))
    assert_same_topk(jv, ji, tv, ti, _oracle_sorted(q, v, mask), k)


@pytest.mark.parametrize("k,n_ids", [(10, 12), (10, 40), (32, 200)])
def test_mixed_fused_topk_sparse_filter_matches_jax(rng, k, n_ids):
    """An `ids`-style filter of a few rows: most 128-row segments hold no
    live row (the segments K4's tensor-core scan skips), and with n_ids
    below k + guard the selection runs out of live rows (-inf slots)."""
    v = _corpus(rng, CAP, DIM)
    q = rng.normal(size=(8, DIM)).astype(np.float32)
    # the ids fall in 12 of the 64 segments
    segs = rng.choice(CAP // tscan.SEG, 12, replace=False)
    rows = (segs[:, None] * tscan.SEG + np.arange(tscan.SEG)).ravel()
    mask = np.zeros(CAP, bool)
    mask[rng.choice(rows, n_ids, replace=False)] = True
    assert mask.reshape(-1, tscan.SEG).any(axis=1).sum() <= 12
    lp_j = jnp.asarray(v).astype(jnp.bfloat16)
    jv, ji = jps.make_mixed_fused_topk(k, interpret=True)(q, lp_j, v, mask)
    tv, ti = tscan.make_mixed_fused_topk(k)(
        _t(q), _t(v).to(torch.bfloat16), _t(v), _t(mask))
    assert_same_topk(jv, ji, tv, ti, _oracle_sorted(q, v, mask), k)
    assert mask[ti.numpy()[np.isfinite(tv.numpy())]].all()


@pytest.mark.parametrize("k,filt,zero", LADDER_CASES)
def test_fused_topk_f32_matches_jax(rng, k, filt, zero):
    q, v, mask = _ladder_case(rng, filt, zero)
    jv, ji = jps.make_fused_topk(k, interpret=True)(q, v, mask)
    tv, ti = tscan.make_fused_topk(k)(_t(q), _t(v), _t(mask))
    assert_same_topk(jv, ji, tv, ti, _oracle_sorted(q, v, mask), k)


def test_scan_topk_plain_chunks_merge(rng):
    """The plain K3/K4 (per-chunk partial top-k + merge) equals one dense
    top-k, including chunks smaller than k and underfill."""
    v = _corpus(rng, 1000, 16)
    q = normalize_batch(rng.normal(size=(3, 16)).astype(np.float32))
    mask = np.zeros(1000, bool)
    mask[rng.choice(1000, 40, replace=False)] = True
    tv, ti = tscan.scan_topk_plain(_t(q), _t(v), None, _t(mask), 50, chunk=128)
    dv, di = texact.exact_topk(_t(q), _t(v), _t(mask), 50)
    np.testing.assert_allclose(tv.numpy()[:, :40], dv.numpy()[:, :40],
                               rtol=0, atol=1e-6)
    assert np.isneginf(tv.numpy()[:, 40:]).all()
    assert (ti.numpy()[:, 40:] == 0).all()
    for i in range(3):
        assert set(ti.numpy()[i, :40]) == set(np.nonzero(mask)[0])


def test_wide_k_goes_exact_and_cpu_never_launches(rng):
    """k_sel past SCAN_KSEL_MAX takes the plain exact scan (its own
    counter); CPU tensors never touch a kernel launch counter."""
    tscan.reset_launch_counts()
    v = _corpus(rng, 2048, 16)
    q = normalize_batch(rng.normal(size=(2, 16)).astype(np.float32))
    mask = np.ones(2048, bool)
    vals, idx = tscan.fused_topk(_t(q), _t(v), _t(mask), tscan.SCAN_KSEL_MAX + 1)
    assert vals.shape == (2, tscan.SCAN_KSEL_MAX + 1)
    assert tscan.WIDE_K_FALLBACKS["scan_topk"] == 1
    tscan.make_fused_topk_i8(5)(_t(q), *tscan.quantize_rows_i8(_t(v)), _t(v),
                                _t(mask))
    tscan.make_segmax_topk(5)(_t(q), _t(v).to(torch.bfloat16), _t(v), _t(mask))
    assert all(n == 0 for n in tscan.LAUNCHES.values()), tscan.LAUNCHES
