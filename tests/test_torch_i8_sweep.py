"""K3's one-query sweep (csrc/sweep_topk.cu, the `Int8R` kind), checked on
the CPU.

* Which kernel a launch takes (`i8_sweep_ready`: Q <= SWEEP_Q_MAX,
  k <= 384, dim % 16 == 0, the query block within 64 KB, aligned bases)
  and what it is passed, recorded by a stand-in for `scan._launch` on CPU
  tensors that report themselves as CUDA tensors, with the counters.
* The plain version's int8 branch selects on the kernels' 64-bit (score,
  row) keys: ties go to the lower row at any chunking, exactly as a numpy
  oracle of float32(int32 sum) * scale ranks them; scales <= 0 and masked
  rows included.
* The plain version inside the int8 route still agrees with the JAX
  package's `make_fused_topk_i8` in Pallas interpret mode, at the host-
  rescore band (k_sel 142) too.
* On the CPU the wrapper runs the plain version: the new counter stays 0.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

TOL_SCORE = 1e-5
TOL_GAP = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# The ready rule and what the wrapper launches
# --------------------------------------------------------------------------


def _operands(dim, nq=1, offset=0, rows=512):
    q = torch.zeros(nq, dim, dtype=torch.int8)
    flat = torch.zeros(rows * dim + 16, dtype=torch.int8)
    return q, flat[offset:offset + rows * dim].view(rows, dim)


def test_i8_sweep_ready_rule():
    qmax = tscan.I8_SWEEP_Q_MAX
    for nq in sorted({1, 2, qmax}):
        q, v = _operands(96, nq)
        for k in (1, 14, 128, 142, tscan.I8_SWEEP_K_MAX):
            assert tscan.i8_sweep_ready(q, v, k)
        assert not tscan.i8_sweep_ready(q, v, tscan.I8_SWEEP_K_MAX + 1)
        assert not tscan.i8_sweep_ready(*_operands(104, nq), 14)  # 104 % 16
        assert not tscan.i8_sweep_ready(*_operands(96, nq, offset=1), 14)
    assert not tscan.i8_sweep_ready(*_operands(96, qmax + 1), 14)
    # the query block: sweep_tile(Q) x dim bytes within 64 KB
    widest = tscan.SWEEP_QBLOCK_BYTES // tscan.sweep_tile(qmax)
    assert tscan.i8_sweep_ready(*_operands(widest, qmax, rows=2), 14)
    assert not tscan.i8_sweep_ready(*_operands(2 * widest, qmax, rows=2), 14)
    assert tscan.i8_sweep_ready(*_operands(2 * widest, 1, rows=2), 14)


class _AsCuda(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, so a wrapper
    takes its kernel branch up to the (recorded) launch."""

    @property
    def is_cuda(self):
        return True


def _as_cuda(t):
    return torch.Tensor._make_subclass(_AsCuda, t)


@pytest.fixture
def recorded(monkeypatch):
    calls = []

    def launch(t, name, entry, *args):
        assert len(args) + 1 == len(_build._SIGNATURES[entry]), entry
        calls.append((entry, args))

    monkeypatch.setattr(tscan, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    return calls


@pytest.mark.parametrize("nq,k,dim,offset", [
    (1, 14, 96, 0), (1, 142, 1024, 0), (2, 384, 96, 0), (1, 385, 96, 0),
    (1, 14, 104, 0), (1, 14, 96, 1), (17, 14, 96, 0), (1, 128, 1024, 0),
    (4, 129, 96, 0), (1, 385, 104, 0)])
def test_k3_dispatch_by_i8_sweep_ready(recorded, nq, k, dim, offset):
    """K3 takes its wide kind where `i8_wide_ready` holds (asked first),
    else the sweep's row-scaled int8 kind where `i8_sweep_ready` holds,
    over `sweep_partition`'s ranges with a partial of k keys a CTA, the
    sweep's narrow kind where `i8_narrow_ready` holds (rows TMA cannot
    read: dim 104, a base 1 byte off, which the template (`pv_scan_topk`
    kind 2) served before), and the tensor-core scan's int8 kind where
    `i8_wgmma_ready` holds (Q past the sweeps' limit); the tensor-core
    kinds read any rows, by the producer `rows_piece` names; "scan_topk_i8"
    counts all, "scan_topk_i8_sweep" the sweep, "scan_topk_i8_narrow" the
    narrow kind."""
    q, v = _operands(dim, nq, offset, rows=4096)
    vs = torch.ones(4096)
    mask = torch.ones(4096, dtype=torch.bool)
    sweep = tscan.i8_sweep_ready(q, v, k)
    assert sweep == (nq <= tscan.I8_SWEEP_Q_MAX and k <= 384
                     and dim % 16 == 0 and offset == 0)
    narrow = tscan.i8_narrow_ready(q, v, k)
    assert narrow == (nq <= tscan.I8_SWEEP_Q_MAX and k <= 384 and not sweep)
    tc = tscan.i8_wgmma_ready(q, v, k)
    assert tc == (k <= 384 and not sweep and not narrow)
    wide = tscan.i8_wide_ready(q, v, k)
    assert wide == (k > tscan.I8_WIDE_K_MIN)  # 4096 rows: one tile holds
    before = dict(tscan.LAUNCHES)            # the batch
    vals, idx = tscan.fused_topk_i8(*map(_as_cuda, (q, v, vs, mask)), k)
    assert vals.shape == idx.shape == (nq, k)
    (entry, args), = recorded
    chunk, n = tscan.sweep_partition(4096, 132)
    if wide:
        assert entry == "pv_scan_topk_i8_wide"
        assert args[0] == tscan.rows_piece(v) and args[8:12] == (nq, 4096,
                                                                 dim, k)
    elif sweep:
        assert entry == "pv_sweep_topk_i8"
        assert args[7:] == (nq, 4096, dim, k, chunk)
    elif narrow:
        assert entry == "pv_sweep_topk_i8_narrow"
        assert args[:2] == (q.data_ptr(), v.data_ptr())
        assert args[7:] == (nq, 4096, dim, k, chunk)
    elif tc:
        assert entry == "pv_scan_topk_i8_wgmma"
        assert args[8:] == (nq, 4096, dim, k)
    else:
        assert entry == "pv_scan_topk" and args[0] == tscan._KIND_I8
    assert (tscan.LAUNCHES["scan_topk_i8_narrow"]
            == before["scan_topk_i8_narrow"] + (narrow and not wide))
    assert tscan.LAUNCHES["scan_topk_i8"] == before["scan_topk_i8"] + 1
    assert (tscan.LAUNCHES["scan_topk_i8_sweep"]
            == before["scan_topk_i8_sweep"] + (sweep and not wide))
    key = "scan_topk_i8_wide" + tscan._PIECE_KEY[tscan.rows_piece(v)]
    assert tscan.LAUNCHES[key] == before[key] + wide
    assert tscan.LAUNCH_SHAPES["scan_topk_i8"][nq, k] >= 1


# --------------------------------------------------------------------------
# The plain version: (score, row) keys, ties to the lower row
# --------------------------------------------------------------------------


def _oracle(q8, v8, vs, mask, k):
    """float32(int32 sum) * scale per row, ranked by (-score, row)."""
    s = (q8.astype(np.int64) @ v8.astype(np.int64).T).astype(np.float32)
    s = s * vs[None, :]
    vals = np.full((q8.shape[0], k), -np.inf, dtype=np.float32)
    idx = np.zeros((q8.shape[0], k), dtype=np.int32)
    for i in range(q8.shape[0]):
        rows = np.flatnonzero(mask)
        order = rows[np.lexsort((rows, -s[i, rows]))][:k]
        vals[i, :len(order)] = s[i, order]
        idx[i, :len(order)] = order
    return vals, idx


@pytest.mark.parametrize("chunk", [128, 4096])
@pytest.mark.parametrize("k", [14, 142])
def test_plain_int8_breaks_ties_to_the_lower_row(chunk, k):
    rng = np.random.default_rng(3)
    cap, dim = 1000, 32
    v8 = rng.integers(-127, 128, (cap, dim)).astype(np.int8)
    vs = rng.uniform(0.001, 0.01, cap).astype(np.float32)
    q8 = rng.integers(-127, 128, (4, dim)).astype(np.int8)
    # query 0's best row, copied across chunk boundaries with its scale:
    # equal scores on rows 5, 127, 128, 600 (and a masked copy at 300)
    best = np.where(q8[0] >= 0, 127, -127).astype(np.int8)
    for r in (5, 127, 128, 300, 600):
        v8[r], vs[r] = best, 0.01
    vs[700:720] = 0.0       # scale 0 and negative scales rank like any score
    vs[720:740] = -0.005
    mask = rng.random(cap) > 0.1
    mask[[5, 127, 128, 600]] = True
    mask[300] = False
    got_v, got_i = tscan.scan_topk_plain(_t(q8), _t(v8), _t(vs), _t(mask), k,
                                         chunk=chunk)
    ref_v, ref_i = _oracle(q8, v8, vs, mask, k)
    np.testing.assert_array_equal(got_v.numpy(), ref_v)
    np.testing.assert_array_equal(got_i.numpy(), ref_i)
    assert got_i[0, :4].tolist() == [5, 127, 128, 600]


def test_plain_int8_pads_when_few_rows_are_live():
    rng = np.random.default_rng(4)
    v8 = rng.integers(-127, 128, (300, 16)).astype(np.int8)
    vs = np.full(300, 0.01, dtype=np.float32)
    q8 = rng.integers(-127, 128, (2, 16)).astype(np.int8)
    mask = np.zeros(300, dtype=bool)
    mask[[7, 250]] = True
    vals, idx = tscan.scan_topk_plain(_t(q8), _t(v8), _t(vs), _t(mask), 142)
    assert bool(torch.isneginf(vals[:, 2:]).all())
    assert int(idx[:, 2:].abs().sum()) == 0
    assert sorted(idx[0, :2].tolist()) == [7, 250]


# --------------------------------------------------------------------------
# Against the JAX package
# --------------------------------------------------------------------------


def _oracle_sorted(q, v, mask):
    qn = q.astype(np.float64)
    qn /= np.maximum(np.linalg.norm(qn, axis=1, keepdims=True), 1e-300)
    s = qn @ v.astype(np.float64).T
    s[:, ~mask] = -np.inf
    return -np.sort(-s, axis=1)


@pytest.mark.parametrize("k,guard,filt,nq", [
    pytest.param(10, 4, False, 8, id="10-4-False"),
    pytest.param(10, 132, False, 8, id="10-132-False"),
    pytest.param(20, 132, True, 8, id="20-132-True"),
    pytest.param(10, 132, False, 17, id="10-132-False-17"),
    pytest.param(10, 132, True, 17, id="10-132-True-17"),
    pytest.param(10, 132, False, 64, id="10-132-False-64"),
    pytest.param(10, 132, True, 64, id="10-132-True-64")])
def test_int8_route_matches_jax(k, guard, filt, nq):
    """make_fused_topk_i8 with the dequantizing rescore (the int8 store's
    route) at k_sel = k + 4 and at the host-rescore band k + 128 + 4, at
    Q = 8 (the sweep's batches on the card) and Q = 17 / 64 (the
    tensor-core scan's), filtered and not: the port's plain selection and
    JAX's kernel in interpret mode return the same scores within
    TOL_SCORE and the same ids outside a TOL_GAP gap of the exact
    (dequantized) scores."""
    rng = np.random.default_rng(5)
    cap, dim = 2048, 64
    v = normalize_batch(rng.normal(size=(cap, dim)).astype(np.float32))
    v8, vs = map(np.asarray, jps.quantize_rows_i8(jnp.asarray(v)))
    q = rng.normal(size=(nq, dim)).astype(np.float32)
    mask = rng.random(cap) > 0.1
    if filt:
        mask &= rng.random(cap) < 0.3
    jv, ji = jps.make_fused_topk_i8(k, guard=guard, interpret=True,
                                    rescore_dequant=True, tie_scale=0.0)(
        q, v8, vs, v8, mask)
    tv, ti = tscan.make_fused_topk_i8(k, guard=guard, rescore_dequant=True,
                                      tie_scale=0.0)(
        _t(q), _t(v8), _t(vs), _t(v8), _t(mask))
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    np.testing.assert_array_equal(np.isneginf(jv), np.isneginf(tv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=TOL_SCORE)
    ex = _oracle_sorted(q, v8.astype(np.float32) * vs[:, None], mask)
    for i in range(q.shape[0]):
        if ex[i, k - 1] - ex[i, k] > TOL_GAP:
            assert set(ti[i].tolist()) == set(ji[i].tolist()), i


def test_counter_stays_zero_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    v8 = torch.randint(-127, 128, (512, 32), generator=g, dtype=torch.int8)
    q8 = torch.randint(-127, 128, (1, 32), generator=g, dtype=torch.int8)
    tscan.reset_launch_counts()
    tscan.fused_topk_i8(q8, v8, torch.ones(512), torch.ones(512, dtype=torch.bool),
                        142)
    assert tscan.LAUNCHES["scan_topk_i8"] == tscan.LAUNCHES["scan_topk_i8_sweep"] == 0
