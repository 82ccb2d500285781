"""K4's one-query sweep over rows of whole 16 bytes (csrc/sweep_topk.cu
`F32` / `Bf16F`, `topk_sweep_ready`), checked on the CPU.

* `topk_sweep_ready` at its edges: float32 queries over float32 or bf16
  rows only, Q <= TOPK_SWEEP_Q_MAX, k <= 128, rows of whole 16 bytes at
  16-byte aligned bases (and an aligned query), the query block
  (sweep_tile(Q) x dim float32) within SWEEP_QBLOCK_BYTES.
* The dispatch on CPU tensors posing as CUDA ones, recorded at
  `scan._launch` against `_build._SIGNATURES`: `pv_sweep_topk_f32` with
  the rows' kind (0 float32, 1 bf16) first, `sweep_partition`'s chunk and
  a partial of Q x ranges x k keys; "scan_topk_sweep" and "scan_topk"
  count it, LAUNCH_SHAPES splits it by (Q, k).
* The sweep emulated in numpy, lane by lane: `Bf16F`'s query block (each
  query's words deinterleaved, `query_word`), row word c meeting query
  words c and cpr + c, a lane's words c, c + 32, ... and the warp's xor
  shuffles, the (score, row) keys over `sweep_partition`'s ranges and the
  merge. Rows and queries of small integers make every float32 sum exact,
  so the emulated scores equal the plain version's bit for bit whatever
  the order, and its rows are the exact top-k with ties to the lower row.
* The port against picovdb_tpu (JAX `fused_topk` in Pallas interpret mode,
  its packed scores rescored) at Q = 1 ... 4 over float32 and bf16 rows
  at dims 25, 100 and 1024; and both packages' engines on the routes that
  reach K4 at small Q: `mixed_fused_smallq` (a store without the int8
  tier) and `pallas_fused` (`scan_mode="fused"`).
* The new counters stay 0 on the CPU.
"""

import types

import numpy as np
import pytest
import torch

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads, cpu_kw

cap_torch_threads()

jnp = jps.jnp
SEG = tscan.SEG
TOL_SCORE = 1e-5
TOL_GAP = 1e-4
K_ID, K_METRICS = picovdb_tpu.K_ID, picovdb_tpu.K_METRICS
PACKAGES = {"jax": picovdb_tpu, "torch": picovdb_tpu_torch}


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


def _view(shape, dtype, off_bytes):
    es = torch.empty(0, dtype=dtype).element_size()
    n = shape[0] * shape[1]
    flat = torch.zeros(n + 64 // es, dtype=dtype)
    start = (-flat.data_ptr() % 16 + off_bytes) // es
    v = flat[start:start + n].view(shape)
    assert v.data_ptr() % 16 == off_bytes % 16
    return v


# --------------------------------------------------------------------------
# The ready rule and the dispatch
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,per", [(torch.float32, 4),
                                       (torch.bfloat16, 8)])
def test_topk_sweep_ready_edges(dtype, per):
    lim = tscan.TOPK_SWEEP_Q_MAX
    v = _view((4 * SEG, 96), dtype, 0)
    q = _view((lim + 1, 96), torch.float32, 0)
    assert tscan.topk_sweep_ready(q[:lim], v, 14)
    assert tscan.topk_sweep_ready(q[:1], v, 128)
    assert not tscan.topk_sweep_ready(q[:1], v, 129)
    assert not tscan.topk_sweep_ready(q, v, 14)  # Q past the limit
    # rows off whole 16 bytes, a base off 16 bytes, a misaligned query
    odd = 96 + per // 2
    assert not tscan.topk_sweep_ready(_view((1, odd), torch.float32, 0),
                                      _view((4 * SEG, odd), dtype, 0), 14)
    assert tscan.topk_sweep_ready(_view((1, 96 + per), torch.float32, 0),
                                  _view((4 * SEG, 96 + per), dtype, 0), 14)
    es = v.element_size()
    assert not tscan.topk_sweep_ready(q[:1], _view((4 * SEG, 96), dtype, es),
                                      14)
    assert not tscan.topk_sweep_ready(_view((1, 96), torch.float32, 4), v, 14)
    # types: float32 queries over float32 / bf16 rows only
    assert not tscan.topk_sweep_ready(q[:1].to(torch.bfloat16), v, 14)
    assert not tscan.topk_sweep_ready(q[:1],
                                      _view((4 * SEG, 96), torch.int8, 0), 14)
    # the query block: sweep_tile(Q) x dim float32 within 64 KB
    w = _view((SEG, 4096), dtype, 0)
    q4 = _view((5, 4096), torch.float32, 0)
    assert tscan.topk_sweep_ready(q4[:1], w, 14)
    assert tscan.topk_sweep_ready(q4[:4], w, 14) == (lim >= 4)
    assert not tscan.topk_sweep_ready(q4, w, 14)  # a tile of 8: 128 KB
    wide = _view((SEG, 4096 + per), dtype, 0)
    q2 = _view((2, 4096 + per), torch.float32, 0)
    assert tscan.topk_sweep_ready(q2, wide, 14) == (lim >= 2)
    assert tscan.sweep_tile(2) * (4096 + per) * 4 <= tscan.SWEEP_QBLOCK_BYTES
    if lim >= 4:
        q3 = _view((3, 4096 + per), torch.float32, 0)
        assert not tscan.topk_sweep_ready(q3, wide, 14)
    # the tensor-core scan takes what the sweep does not, never both
    for qq, vv, k in ((q[:1], v, 14), (q, v, 14), (q4, w, 14),
                      (q[:1], v, 129)):
        assert not (tscan.topk_sweep_ready(qq, vv, k)
                    and tscan.topk_wgmma_ready(qq, vv, k))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dim", [96, 1024])
@pytest.mark.parametrize("k", [1, 14, 128])
def test_k4_dispatch_takes_the_sweep(recorded, dtype, dim, k):
    cap = 5 * SEG + 17
    mask = torch.ones(cap, dtype=torch.bool)
    v = _view((cap, dim), dtype, 0)
    sizes = []
    real_empty = torch.empty
    for nq in range(1, tscan.TOPK_SWEEP_Q_MAX + 2):
        q = _view((nq, dim), torch.float32, 0)
        sweep = nq <= tscan.TOPK_SWEEP_Q_MAX
        assert tscan.topk_sweep_ready(q, v, k) == sweep
        before = dict(tscan.LAUNCHES)
        recorded.clear()

        def empty(*shape, **kw):
            out = real_empty(*shape, **kw)
            if kw.get("dtype") == torch.int64:
                sizes.append(out.numel())
            return out

        tscan.torch.empty = empty
        try:
            vals, idx = tscan.fused_topk(*map(_as_cuda, (q, v, mask)), k)
        finally:
            tscan.torch.empty = real_empty
        assert vals.shape == idx.shape == (nq, k)
        (entry, args), = recorded
        grew = {n for n in tscan.LAUNCHES if tscan.LAUNCHES[n] > before[n]}
        if not sweep:
            assert entry == "pv_scan_topk_wgmma"
            assert grew == {"scan_topk", "scan_topk_wgmma"}
            continue
        assert entry == "pv_sweep_topk_f32"
        assert grew == {"scan_topk", "scan_topk_sweep"}
        chunk, n = tscan.sweep_partition(cap, 132)
        assert args[0] == (0 if dtype == torch.float32 else 1)
        assert args[1:3] == (q.data_ptr(), v.data_ptr())
        assert args[3] == mask.data_ptr()
        assert args[7:] == (nq, cap, dim, k, chunk)
        assert sizes[-1] == nq * n * k
        assert tscan.LAUNCH_SHAPES["scan_topk_sweep"][nq, k] >= 1


def test_new_counters_stay_zero_on_the_cpu():
    tscan.reset_launch_counts()
    g = torch.Generator().manual_seed(0)
    mask = torch.ones(700, dtype=torch.bool)
    for dim in (25, 96, 1019, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            v = torch.randn(700, dim, generator=g).to(dtype)
            for nq in (1, 4, 16):
                tscan.fused_topk(torch.randn(nq, dim, generator=g), v, mask, 14)
    assert all(n == 0 for n in tscan.LAUNCHES.values())
    assert tscan.LAUNCHES["scan_topk_sweep"] == 0
    assert tscan.LAUNCHES["scan_topk_narrow"] == 0


# --------------------------------------------------------------------------
# The sweep emulated
# --------------------------------------------------------------------------


def _float_order(s):
    """float32 scores -> uint64 whose order is the float order (row_key's
    high half)."""
    u = s.astype(np.float32).view(np.uint32).astype(np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def _bf16_words(rows):
    """bf16 rows (as float32 values exact in bf16) -> their 16-byte words
    as (cap, cpr, 4) uint32, element 2 i in the low half of word i."""
    bits = (rows.astype(np.float32).view(np.uint32) >> 16).astype(np.uint32)
    pairs = bits.reshape(rows.shape[0], -1, 2)
    return (pairs[..., 0] | (pairs[..., 1] << 16)).reshape(
        rows.shape[0], -1, 4)


def _bf_lo(w):
    return (w << 16).astype(np.uint32).view(np.float32)


def _bf_hi(w):
    return (w & 0xFFFF0000).astype(np.uint32).view(np.float32)


def _query_block(q, cpr):
    """Bf16F's query block: word j of query qq is the query's word
    query_word(j) = 2 (j % cpr) + j / cpr, so (Q, 2 cpr, 4) float32."""
    words = q.reshape(q.shape[0], 2 * cpr, 4)
    j = np.arange(2 * cpr)
    return words[:, 2 * (j % cpr) + j // cpr]


def _dot_bf16f(a, lo, hi, acc):
    """Bf16F::dot in float32: word a's 8 bf16 against lo's and hi's 4
    floats each, one fmaf at a time (exact here: small integers)."""
    prods = [(_bf_lo(a[0]), lo[0]), (_bf_hi(a[0]), lo[1]),
             (_bf_lo(a[1]), lo[2]), (_bf_hi(a[1]), lo[3]),
             (_bf_lo(a[2]), hi[0]), (_bf_hi(a[2]), hi[1]),
             (_bf_lo(a[3]), hi[2]), (_bf_hi(a[3]), hi[3])]
    for x, y in prods:
        acc = np.float32(acc + np.float32(x) * np.float32(y))
    return acc


def _emulate_bf16f_sums(rows, q):
    """Every (query, row) sum as the sweep forms it: lane l reads row words
    c = l, l + 64, ... and c + 32 (two words issued together), meets word
    c with the block's words c and cpr + c, and the warp sums the 32 lane
    sums by five xor shuffles."""
    cap, dim = rows.shape
    cpr = dim // 8
    rw = _bf16_words(rows)
    qs = _query_block(q, cpr)
    out = np.zeros((q.shape[0], cap), dtype=np.float32)
    for qq in range(q.shape[0]):
        for r in range(cap):
            lanes = np.zeros(32, dtype=np.float32)
            for lane in range(32):
                acc = np.float32(0)
                for c in range(lane, cpr, 64):
                    acc = _dot_bf16f(rw[r, c], qs[qq, c], qs[qq, cpr + c], acc)
                    if c + 32 < cpr:
                        acc = _dot_bf16f(rw[r, c + 32], qs[qq, c + 32],
                                         qs[qq, cpr + c + 32], acc)
                lanes[lane] = acc
            for o in (16, 8, 4, 2, 1):
                lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
            out[qq, r] = lanes[0]
    return out


def _select(sums, mask, k, cap, sms):
    """The sweep's selection: per CTA of `sweep_partition`'s ranges the k
    best (score, row) keys of its masked-in rows, then the merge; -inf / 0
    where empty."""
    chunk, n = tscan.sweep_partition(cap, sms)
    rows = np.arange(cap, dtype=np.uint64)
    keys = (_float_order(sums) << np.uint64(32)) | (np.uint64(0xFFFFFFFF)
                                                    - rows)[None, :]
    keys = np.where(mask[None, :], keys, np.uint64(0))
    cand = []
    for c in range(n):
        part = keys[:, c * chunk:min(cap, (c + 1) * chunk)]
        part = np.sort(part, axis=1)[:, ::-1][:, :k]
        cand.append(np.pad(part, ((0, 0), (0, k - part.shape[1]))))
    allk = np.sort(np.concatenate(cand, axis=1), axis=1)[:, ::-1][:, :k]
    empty = allk == 0
    hi = (allk >> np.uint64(32)).astype(np.uint64)
    u = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi & 0xFFFFFFFF)
    vals = u.astype(np.uint32).view(np.float32)
    vals = np.where(empty, -np.inf, vals).astype(np.float32)
    idx = np.where(empty, 0, np.uint64(0xFFFFFFFF) - (allk & np.uint64(
        0xFFFFFFFF))).astype(np.int64)
    return vals, idx


@pytest.mark.parametrize("cap,dim,nq,k", [(700, 64, 1, 14), (300, 512, 3, 36),
                                          (129, 8, 2, 128)])
def test_sweep_bf16f_emulated_equals_plain(cap, dim, nq, k):
    rng = np.random.default_rng(cap + dim)
    rows = rng.integers(-8, 9, (cap, dim)).astype(np.float32)  # exact bf16
    q = rng.integers(-8, 9, (nq, dim)).astype(np.float32)
    mask = rng.random(cap) > 0.2
    sums = _emulate_bf16f_sums(rows, q)
    np.testing.assert_array_equal(sums, (q.astype(np.int64)
                                         @ rows.astype(np.int64).T))
    vals, idx = _select(sums, mask, k, cap, sms=2)
    tv, ti = tscan.scan_topk_plain(torch.from_numpy(q),
                                   torch.from_numpy(rows).to(torch.bfloat16),
                                   None, torch.from_numpy(mask), k)
    np.testing.assert_array_equal(vals, tv.numpy())  # bit for bit
    exact = sums[:, mask]
    live = np.flatnonzero(mask)
    for i in range(nq):
        # the emulated rows: the exact top-k with ties to the lower row
        order = np.lexsort((live, -exact[i]))[:k]
        want = live[order]
        got = idx[i][np.isfinite(vals[i])]
        np.testing.assert_array_equal(got, want)
        # the plain version's rows: each carries its own exact score
        fin = np.isfinite(tv[i].numpy())
        np.testing.assert_array_equal(
            sums[i, ti[i].numpy()[fin]], tv[i].numpy()[fin])


# --------------------------------------------------------------------------
# The port against picovdb_tpu
# --------------------------------------------------------------------------


def _gaps(rows, mask, q, k):
    s = q.astype(np.float64) @ rows[mask].astype(np.float64).T
    s = -np.sort(-s, axis=1)
    return s[:, k - 1] - s[:, k] if s.shape[1] > k else np.full(len(q), np.inf)


@pytest.mark.parametrize("dim", [25, 100, 1024])
@pytest.mark.parametrize("nq", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_topk_matches_jax(dim, nq, dtype):
    rng = np.random.default_rng(dim + nq)
    v = normalize_batch(rng.standard_normal((2048, dim)).astype(np.float32))
    q = normalize_batch(rng.standard_normal((nq, dim)).astype(np.float32))
    mask = rng.random(2048) >= 0.1
    k = 14
    jrows = jnp.asarray(v).astype(getattr(jnp, dtype))
    rows = torch.from_numpy(v).to(getattr(torch, dtype))
    exact_rows = rows.float().numpy()  # the rows the kernels multiply
    jv, ji = jps.fused_topk(jnp.asarray(q), jrows, jnp.asarray(mask), k,
                            interpret=True)
    # the Pallas kernel's packed scores: rescore its picks
    jv, ji = map(np.asarray, jps.rescore_exact(q, exact_rows, jv, ji))
    tv, ti = tscan.fused_topk(torch.from_numpy(q), rows,
                              torch.from_numpy(mask), k)
    tv, ti = tv.numpy(), ti.numpy()
    assert np.array_equal(np.isfinite(tv), np.isfinite(jv))
    fin = np.isfinite(tv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=TOL_SCORE)
    gaps = _gaps(exact_rows, mask, q, k)
    for i in range(nq):
        assert mask[ti[i][fin[i]]].all()
        if gaps[i] > TOL_GAP:
            assert set(ti[i][fin[i]].tolist()) == set(ji[i][fin[i]].tolist())


def _stores(tmp, dim, **kw):
    rng = np.random.default_rng(dim)
    vecs = rng.standard_normal((2048, dim)).astype(np.float32)
    dbs = {}
    for name, pkg in PACKAGES.items():
        db = pkg.PicoVectorDB(embedding_dim=dim, storage_file=f"{tmp}/{name}",
                              use_pallas=True, **kw, **cpu_kw(pkg))
        db.upsert_columnar(vecs, ids=[f"d{i}" for i in range(len(vecs))])
        dbs[name] = db
    return dbs, normalize_batch(vecs), rng


@pytest.mark.parametrize("dim", [25, 100, 1024])
@pytest.mark.parametrize("route,kw", [
    ("mixed_fused_smallq", {"mixed_precision": True, "int8_tier": False}),
    ("pallas_fused", {"scan_mode": "fused"})])
def test_engine_small_q_routes(tmp_path, dim, route, kw):
    """A single `query` and a 4-query batch through both packages' stores
    on the routes that reach K4 at small Q: the same route, scores within
    1e-5, the same ids outside the gap."""
    dbs, rows, rng = _stores(tmp_path, dim, **kw)
    q = (rows[rng.integers(0, len(rows), 4)]
         + 0.3 * rng.standard_normal((4, dim))).astype(np.float32)
    live = np.ones(len(rows), bool)
    for qq in (q[0], q):
        out = {}
        for name, db in dbs.items():
            res = db.query(qq, top_k=10)
            out[name] = res if qq.ndim == 2 else [res]
            out[name + "_route"] = db.last_query_debug()["strategy"]
        assert out["jax_route"] == out["torch_route"] == route, out
        gaps = _gaps(rows, live, normalize_batch(np.atleast_2d(qq)), 10)
        for i, (hj, ht) in enumerate(zip(out["jax"], out["torch"])):
            assert len(hj) == len(ht) == 10, i
            np.testing.assert_allclose([h[K_METRICS] for h in ht],
                                       [h[K_METRICS] for h in hj],
                                       rtol=0, atol=TOL_SCORE)
            if gaps[i] > TOL_GAP:
                assert {h[K_ID] for h in hj} == {h[K_ID] for h in ht}, i
