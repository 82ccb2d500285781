"""picovdb_tpu_torch's quantized-storage ops against picovdb_tpu on the CPU.

The same seeded numpy inputs go through the JAX function (its Pallas
kernels in interpret mode) and the port's counterpart (its kernels' plain
PyTorch versions on CPU tensors). Tolerances, each with its reason:

  * quantization (`quantize_rows_i8` / `_i4`, `unpack_i4`) and K5's
    segment keys are bit-identical: integer arithmetic and the same
    float32 operations in the same order;
  * dequantized scores agree within TOL_SCORE = 1e-6: float32 dot
    products of the same rows, summed in different orders;
  * id sets agree wherever the float64 k-th/(k+1)-th gap exceeds TOL_GAP
    = 1e-4 (inside it either pick is a correct top-k);
  * K6 against the TPU ladder: the ladder reports each score through its
    packed key (low `lane_bits` of the float bits replaced), so the plain
    K6 scores are put through the same truncation before the 1e-6
    comparison, and id sets are compared where the k-th/(k+1)-th gap
    exceeds twice that truncation (2^-10 relative).
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

TOL_SCORE = 1e-6
TOL_GAP = 1e-4
CAP, DIM = 8192, 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _corpus(rng, cap=CAP, dim=DIM, zero_rows=()):
    v = normalize_batch(rng.normal(size=(cap, dim)).astype(np.float32))
    for r in zero_rows:
        v[r] = 0.0
    return v


def _dequant(kind, plane, scale):
    if kind == "int4":
        out = np.empty((plane.shape[0], 2 * plane.shape[1]), np.float32)
        tscan.unpack_i4_np_into(plane, out)
    else:
        out = plane.astype(np.float32)
    return out * scale[:, None]


def _quantized(rng, kind, zero_rows=()):
    v = _corpus(rng, zero_rows=zero_rows)
    quant = jps.quantize_rows_i4 if kind == "int4" else jps.quantize_rows_i8
    plane, scale = map(np.asarray, quant(jnp.asarray(v)))
    return v, plane, scale


def _oracle_sorted(q, rows, mask):
    qn = q.astype(np.float64)
    qn /= np.maximum(np.linalg.norm(qn, axis=1, keepdims=True), 1e-300)
    s = qn @ rows.astype(np.float64).T
    s[:, ~mask] = -np.inf
    return -np.sort(-s, axis=1)


def assert_same_topk(jv, ji, tv, ti, oracle, k, tol=TOL_SCORE):
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = np.asarray(tv), np.asarray(ti)
    assert jv.shape == tv.shape == (oracle.shape[0], k)
    np.testing.assert_array_equal(np.isneginf(jv), np.isneginf(tv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=tol)
    for i in range(jv.shape[0]):
        gap = oracle[i, k - 1] - (oracle[i, k] if oracle.shape[1] > k else -np.inf)
        if fin[i].all() and gap > TOL_GAP:
            assert set(ji[i].tolist()) == set(ti[i].tolist()), i


# --------------------------------------------------------------------------
# quantization helpers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [16, 64, 1024])
def test_quantize_rows_i4_bit_identical(rng, dim):
    v = _corpus(rng, 300, dim, zero_rows=(3,))
    v[5] *= 40.0  # a row far from unit norm
    jp, js = map(np.asarray, jps.quantize_rows_i4(jnp.asarray(v)))
    tp, ts = tscan.quantize_rows_i4(_t(v))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_array_equal(ts.numpy(), js)
    # unpack: torch, numpy-into and JAX agree, and invert the packing
    ju = np.asarray(jps.unpack_i4(jnp.asarray(jp)))
    np.testing.assert_array_equal(tscan.unpack_i4(tp).numpy(), ju)
    out = np.empty((300, dim), np.float32)
    tscan.unpack_i4_np_into(jp, out)
    np.testing.assert_array_equal(out, ju.astype(np.float32))
    assert np.abs(ju).max() <= 7


def test_quantize_rows_i8_from_jax_rows_bit_identical(rng):
    """int8 rows the JAX side quantized re-quantize identically here
    (the row scales travel between packages via from_numpy_state)."""
    v = _corpus(rng, 500, 48, zero_rows=(0, 9))
    jq, js = map(np.asarray, jps.quantize_rows_i8(jnp.asarray(v)))
    tq, ts = tscan.quantize_rows_i8(_t(v))
    np.testing.assert_array_equal(tq.numpy(), jq)
    np.testing.assert_array_equal(ts.numpy(), js)


# --------------------------------------------------------------------------
# K5 segmax_scan_i8
# --------------------------------------------------------------------------


@pytest.mark.parametrize("nq", [16, 256])
def test_segmax_scan_i8_keys_match_tpu_slab(rng, nq):
    """The plain K5 keys equal the TPU kernel's, bit for bit, once its
    transposed, bn-dependent slab is decoded through its own (tile, s)
    arithmetic (pallas_scan.py make_segmax_topk_i8)."""
    v, v8, vs = _quantized(rng, "int8", zero_rows=(40,))
    q = rng.normal(size=(nq, DIM)).astype(np.float32)
    q8 = np.asarray(jps.quantize_rows_i8(jnp.asarray(normalize_batch(q)))[0])
    mask = rng.random(CAP) > 0.2
    mask[128:256] = False  # a fully masked segment
    keys_t, ns = jps.segmax_scan_i8(q8, v8, vs, mask, interpret=True,
                                    raw_t=True)
    keys_t = np.asarray(keys_t)
    c = np.arange(keys_t.shape[0])
    tile, s = c // (2 * ns), c % (2 * ns)
    seg, r = tile * ns + s % ns, (s >= ns).astype(int)
    jkeys = np.empty((nq, keys_t.shape[0]), np.int32)
    jkeys[:, 2 * seg + r] = keys_t.T
    tkeys = tscan.segmax_scan_i8(_t(q8), _t(v8), _t(vs), _t(mask)).numpy()
    np.testing.assert_array_equal(tkeys, jkeys)
    assert (tkeys[:, 2:4] == tscan.KEY_MIN).all()


@pytest.mark.parametrize("nq,k,rescore_dequant", [
    (256, 10, True), (256, 16, False), (64, 5, True)])
def test_make_segmax_topk_i8_matches_jax(rng, nq, k, rescore_dequant):
    v, v8, vs = _quantized(rng, "int8")
    q = (v[rng.integers(0, CAP, nq)]
         + 0.2 * rng.normal(size=(nq, DIM))).astype(np.float32)
    mask = rng.random(CAP) > 0.1
    rv = v8 if rescore_dequant else v
    jv, ji = jps.make_segmax_topk_i8(
        k, interpret=True, rescore_dequant=rescore_dequant, tie_scale=0.0)(
            q, v8, vs, rv, mask)
    tv, ti = tscan.make_segmax_topk_i8(
        k, rescore_dequant=rescore_dequant, tie_scale=0.0)(
            _t(q), _t(v8), _t(vs), _t(rv), _t(mask))
    rows = _dequant("int8", v8, vs) if rescore_dequant else v
    assert_same_topk(jv, ji, tv, ti, _oracle_sorted(q, rows, mask), k)


# --------------------------------------------------------------------------
# K6 fused_topk_i4
# --------------------------------------------------------------------------


def _key_truncate(scores: np.ndarray, bn: int) -> np.ndarray:
    """A score as the TPU ladder reports it: the sortable float32 bits with
    the low lane_bits cleared, decoded back."""
    lane_bits = max(1, int(bn - 1).bit_length())
    key = tscan._to_sortable(_t(scores.astype(np.float32)).view(torch.int32))
    key = key & ~((1 << lane_bits) - 1)
    return tscan._from_sortable(key).view(torch.float32).numpy()


@pytest.mark.parametrize("nq,k,filt", [(1, 14, False), (8, 14, True),
                                       (16, 40, False)])
def test_fused_topk_i4_plain_matches_tpu_ladder(rng, nq, k, filt):
    v, v4, vs = _quantized(rng, "int4", zero_rows=(7,))
    q = rng.normal(size=(nq, DIM)).astype(np.float32)
    q8 = np.asarray(jps.quantize_rows_i8(jnp.asarray(normalize_batch(q)))[0])
    mask = rng.random(CAP) > 0.1
    if filt:
        mask &= rng.random(CAP) < 0.3
    jv, ji = map(np.asarray, jps.fused_topk_i4(q8, v4, vs, mask, k,
                                               interpret=True))
    tv, ti = tscan.fused_topk_i4(_t(q8), _t(v4), _t(vs), _t(mask), k)
    tv, ti = tv.numpy(), ti.numpy()
    assert np.isfinite(tv).all() and mask[ti].all()
    # the plain scores are the exact scaled int4 scores of their rows
    exact = tscan._i4_scores(_t(q8), _t(v4), _t(vs)).numpy()
    np.testing.assert_array_equal(np.take_along_axis(exact, ti.astype(int), 1),
                                  tv)
    bn = jps._pick_bn(DIM, nq, k, 1, CAP, 4096)
    np.testing.assert_allclose(_key_truncate(tv, bn), jv, rtol=0,
                               atol=TOL_SCORE)
    full = np.where(mask, exact, -np.inf)
    srt = -np.sort(-full, axis=1)
    for i in range(nq):
        if srt[i, k - 1] - srt[i, k] > 2.0 ** -10 * abs(srt[i, k - 1]):
            assert set(ji[i].tolist()) == set(ti[i].tolist()), i


@pytest.mark.parametrize("nq,k,filt", [(1, 10, False), (8, 10, True),
                                       (16, 30, False)])
def test_make_fused_topk_i4_matches_jax(rng, nq, k, filt):
    v, v4, vs = _quantized(rng, "int4")
    q = (v[rng.integers(0, CAP, nq)]
         + 0.2 * rng.normal(size=(nq, DIM))).astype(np.float32)
    mask = rng.random(CAP) > 0.1
    if filt:
        mask &= rng.random(CAP) < 0.3
    jv, ji = jps.make_fused_topk_i4(k, interpret=True)(q, v4, vs, mask)
    tv, ti = tscan.make_fused_topk_i4(k)(_t(q), _t(v4), _t(vs), _t(mask))
    assert_same_topk(jv, ji, tv, ti,
                     _oracle_sorted(q, _dequant("int4", v4, vs), mask), k)


def test_fused_topk_i4_wide_k_takes_the_plain_dense_scan(rng):
    v, v4, vs = _quantized(rng, "int4")
    q8, _ = tscan.quantize_rows_i8(_t(normalize_batch(v[:2])))
    mask = torch.ones(CAP, dtype=torch.bool)
    tscan.reset_launch_counts()
    vals, idx = tscan.fused_topk_i4(q8, _t(v4), _t(vs), mask,
                                    tscan.SCAN_KSEL_MAX + 1)
    assert vals.shape == (2, tscan.SCAN_KSEL_MAX + 1)
    assert tscan.WIDE_K_FALLBACKS["scan_topk_i4"] == 1
    ref, _ = tscan.fused_topk_i4(q8, _t(v4), _t(vs), mask, 50)
    np.testing.assert_array_equal(vals[:, :50].numpy(), ref.numpy())
    assert all(n == 0 for n in tscan.LAUNCHES.values())


# --------------------------------------------------------------------------
# int8 storage ladder, plain scans and dequantizing rescores
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k,filt", [(10, False), (30, True)])
def test_make_fused_topk_i8_dequant_matches_jax(rng, k, filt):
    v, v8, vs = _quantized(rng, "int8", zero_rows=(3,))
    q = rng.normal(size=(8, DIM)).astype(np.float32)
    mask = rng.random(CAP) > 0.1
    if filt:
        mask &= rng.random(CAP) < 0.2
    jv, ji = jps.make_fused_topk_i8(k, interpret=True, rescore_dequant=True,
                                    tie_scale=0.0)(q, v8, vs, v8, mask)
    tv, ti = tscan.make_fused_topk_i8(k, rescore_dequant=True, tie_scale=0.0)(
        _t(q), _t(v8), _t(vs), _t(v8), _t(mask))
    assert_same_topk(jv, ji, tv, ti,
                     _oracle_sorted(q, _dequant("int8", v8, vs), mask), k)


# random data; zero rows; all rows masked; k beyond the active count
EXACT_CASES = ["random", "zero_rows", "all_masked", "k_over_active"]


def _exact_case(rng, kind, case):
    v, plane, scale = _quantized(
        rng, kind, zero_rows=(5, 700) if case == "zero_rows" else ())
    q = rng.normal(size=(6, DIM)).astype(np.float32)
    if case == "zero_rows":
        q[1] = 0.0  # zero query -> e0
    mask = rng.random(CAP) > 0.3
    if case == "all_masked":
        mask[:] = False
    elif case == "k_over_active":
        mask[:] = False
        mask[rng.choice(CAP, 7, replace=False)] = True
    return q, plane, scale, mask


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("case", EXACT_CASES)
def test_exact_topk_quantized_element_by_element(rng, kind, case):
    """exact_topk_i8r / _i4r: the same ids in the same order, scores
    within 1e-6, -inf where fewer rows are live than k."""
    q, plane, scale, mask = _exact_case(rng, kind, case)
    k = 12
    jfn = jexact.exact_topk_i4r if kind == "int4" else jexact.exact_topk_i8r
    tfn = texact.exact_topk_i4r if kind == "int4" else texact.exact_topk_i8r
    qn = normalize_batch(q)
    jv, ji = map(np.asarray, jfn(jnp.asarray(qn), plane, scale, mask, k))
    tv, ti = tfn(_t(qn), _t(plane), _t(scale), _t(mask), k)
    tv, ti = tv.numpy(), ti.numpy()
    np.testing.assert_array_equal(np.isneginf(tv), np.isneginf(jv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=TOL_SCORE)
    np.testing.assert_array_equal(ti[fin], ji[fin])
    if case == "all_masked":
        assert not fin.any()
    if case == "k_over_active":
        assert fin.sum(axis=1).tolist() == [7] * 6


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_rescore_exact_quantized_element_by_element(rng, kind):
    _, plane, scale = _quantized(rng, kind, zero_rows=(2,))
    q = normalize_batch(rng.normal(size=(5, DIM)).astype(np.float32))
    idx = rng.integers(0, CAP, size=(5, 16)).astype(np.int32)
    idx[0, 3] = 2  # a zero row
    vals = rng.normal(size=(5, 16)).astype(np.float32)
    vals[4, 10:] = -np.inf
    jfn = jps.rescore_exact_i4r if kind == "int4" else jps.rescore_exact_i8r
    tfn = tscan.rescore_exact_i4r if kind == "int4" else tscan.rescore_exact_i8r
    jv, ji = map(np.asarray, jfn(q, plane, scale, vals, idx))
    tv, ti = tfn(_t(q), _t(plane), _t(scale), _t(vals), _t(idx))
    np.testing.assert_allclose(tv.numpy(), jv, rtol=0, atol=TOL_SCORE)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert np.isneginf(tv.numpy()[4, 10:]).all()
