"""K7's tensor-core scan (csrc/ivf_scan_wgmma.cu: Q > 16, k <= 128),
checked on the CPU.

* A numpy walk of the kernel's work as it runs it: the grid of
  `ivf_wgmma_partition` (query tiles of 64 fastest, segment shares of the
  hot table), each CTA's share of the live steps' segments computed from
  n_hot (`shares`), the row map (logical segment j is physical rows
  hot[j // 8] * 1024 + (j % 8) * 128 + [0, 128)), no copy of a segment
  with no live row, the per-query buffers of the kernel's BUF (64 / 128 /
  256 keys by k) that admit keys above tau, compact to the best k when
  full and re-admit, and the merge of the shares' partials. On scores
  exact in float32 (and int8's integer sums) it equals `ivf_scan_topk_plain`
  bit for bit in all three kinds at Q 17 / 64 / 200, k 1 / 14 / 32 / 128,
  n_hot 0 / 1 / grid_b, with query 0's two best rows tied across a hot
  tile boundary (the lower physical row first).
* `ivf_wgmma_ready` at its edges; which entry K7 takes (the sweep, then
  the tensor-core scan, then the template) and what it passes, recorded by
  a stand-in for `scan._launch` on CPU tensors posing as CUDA ones against
  `_build._SIGNATURES`; on the CPU the new counter stays 0.
* The port's probed route with K7 taken by the walk against the JAX
  package's `probe_scan_local` (its Pallas kernel in interpret mode) at Q =
  17 and 64 over float32 and int8 postings on one JAX-built layout:
  rescored scores within 1e-5, id sets equal wherever the float64 k / k+1
  gap exceeds 1e-4 (tolerances as tests/test_torch_ivf_sweep.py).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from picovdb_tpu.ops import ivf as jivf
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import ivf as tivf
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads

cap_torch_threads()

BN = tivf.IVF_BN
SEG = tscan.SEG
NS = BN // SEG
QTILE = tscan.TOPK_WGMMA_QTILE
TOL_SCORE = 1e-5
TOL_GAP = 1e-4
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i8c": torch.int8}
I64_MIN = np.iinfo(np.int64).min


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# The kernel's walk, emulated
# --------------------------------------------------------------------------


def _buf(k):
    """The kernel's buffer a query (csrc/ivf_scan_wgmma.cu's instantiations)."""
    return 64 if k <= 32 else 128 if k <= 64 else 256


def _admit(held, tau, keys, k, buf):
    """One query's admission of a segment's live keys in the kernel's
    order: keys above tau take a slot; a full buffer compacts to its best
    k (raising tau to the k-th once k are held) and the rest are tried
    again against the raised tau."""
    pend = keys[keys > tau]
    while pend.size:
        room = buf - held.size
        held = np.concatenate([held, pend[:room]])
        pend = pend[room:]
        if not pend.size:
            break
        held = np.sort(held)[::-1][:k]
        if held.size == k:
            tau = held[-1]
        pend = pend[pend > tau]
    return held, tau


def shares(n_hot, grid_b, ranges):
    """The segment ranges of the scan's CTAs as the kernel computes them
    on the device (csrc/scan_topk_wgmma.cuh `num_segments`): range r reads
    the logical segments [r S // ranges, (r + 1) S // ranges) of the S =
    min(n_hot, grid_b) * 8 live ones."""
    segs = max(0, min(n_hot, grid_b)) * NS
    return [(r * segs // ranges, (r + 1) * segs // ranges)
            for r in range(ranges)]


def walk(scores, mask, hot, n_hot, k, sms=132):
    """K7's tensor-core scan over (Q, cap) scores (float32 or int64 exact
    sums). Returns ((Q, k) float32 scores, (Q, k) int32 rows) as the merge
    decodes them, and the physical segments copied."""
    nq, cap = scores.shape
    grid_b = len(hot)
    q_tiles, ranges = tivf.ivf_wgmma_partition(nq, grid_b, BN, sms)
    share = shares(n_hot, grid_b, ranges)
    keys = tscan._sel_keys(torch.from_numpy(scores),
                           torch.arange(cap)).numpy()
    buf = _buf(k)
    copied, parts = set(), []
    for c in range(q_tiles * ranges):  # query tiles fastest
        qt, r = c % q_tiles, c // q_tiles
        qs = range(qt * QTILE, min(nq, (qt + 1) * QTILE))
        held = [np.zeros(0, np.int64) for _ in qs]
        tau = [I64_MIN] * len(qs)
        for j in range(*share[r]):
            r0 = int(hot[j // NS]) * BN + (j % NS) * SEG
            rows = np.arange(r0, r0 + SEG)
            if not mask[rows].any():
                continue  # no copy, no product
            copied.add(r0)
            live = rows[mask[rows]]
            for i, qi in enumerate(qs):
                held[i], tau[i] = _admit(held[i], tau[i], keys[qi, live], k,
                                         buf)
        part = np.full((nq, k), I64_MIN)  # compact, then the k best
        for i, qi in enumerate(qs):
            best = np.sort(held[i])[::-1][:k]
            part[qi, :best.size] = best
        parts.append(torch.from_numpy(part))
    vals, idx = tscan._merge_sel_keys(parts, k,
                                      int_scores=scores.dtype == np.int64)
    return vals.numpy(), idx.numpy(), copied


N_TILES, DIM = 6, 32
HOT = [4, 1, 5, 0, 2]  # not ascending: ties resolve by the physical row


def _exact_case(kind, nq, seed):
    """Rows and queries whose scores are exact in float32 in every kind:
    multiples of 1/16 in [-1, 1] (int8: integers), so every order of
    summation gives the same sums, and many rows tie; ~20 % masked and one
    segment of tile HOT[0] all masked."""
    rng = np.random.default_rng(seed)
    cap = N_TILES * BN
    if kind == "i8c":
        v = rng.integers(-127, 128, (cap, DIM)).astype(np.int8)
        q = rng.integers(-127, 128, (nq, DIM)).astype(np.int8)
    else:
        v = (rng.integers(-16, 17, (cap, DIM)) / 16).astype(np.float32)
        q = (rng.integers(-16, 17, (nq, DIM)) / 16).astype(np.float32)
    mask = rng.random(cap) < 0.8
    mask[HOT[0] * BN + 3 * SEG:HOT[0] * BN + 4 * SEG] = False
    return q, v, mask


def _best_row(q0, kind):
    if kind == "i8c":
        return np.where(q0 >= 0, 127, -127).astype(np.int8)
    return np.where(q0 >= 0, 1.0, -1.0).astype(np.float32)


def _exact_scores(q, v, kind):
    s = q.astype(np.int64) @ v.astype(np.int64).T if kind == "i8c" else (
        q.astype(np.float64) @ v.astype(np.float64).T)
    return s if kind == "i8c" else s.astype(np.float32)


@pytest.mark.parametrize("kind", list(DTYPES))
@pytest.mark.parametrize("nq", [17, 64, 200])
@pytest.mark.parametrize("k", [1, 14, 32, 128])
@pytest.mark.parametrize("n_hot", [0, 1, len(HOT)])
def test_walk_equals_the_plain_version(kind, nq, k, n_hot):
    q, v, mask = _exact_case(kind, nq, seed=nq + k + n_hot)
    # query 0's best two rows: the last row of step 0 (tile 4) and the
    # first of step 1 (tile 1), which ranks first
    phys = [HOT[0] * BN + BN - 1, HOT[1] * BN]
    v[phys] = _best_row(q[0], kind)
    mask[phys] = True
    vals, idx, copied = walk(_exact_scores(q, v, kind), mask, HOT, n_hot, k)
    dt = DTYPES[kind]
    ref = tivf.ivf_scan_topk_plain(
        _t(q).to(dt), _t(v).to(dt), _t(mask),
        torch.tensor(HOT, dtype=torch.int32),
        torch.tensor([n_hot], dtype=torch.int32), k)
    np.testing.assert_array_equal(vals, ref[0].numpy())
    np.testing.assert_array_equal(idx, ref[1].numpy())
    # only the live steps' segments with a live row were copied
    want = {t * BN + s * SEG for t in HOT[:n_hot] for s in range(NS)
            if mask[t * BN + s * SEG:t * BN + (s + 1) * SEG].any()}
    assert copied == want
    assert HOT[0] * BN + 3 * SEG not in copied
    if n_hot >= 2 and k >= 2:
        assert idx[0, :2].tolist() == sorted(phys)
    if n_hot == 0:
        assert np.isneginf(vals).all() and not idx.any()


def test_walk_overflows_and_compacts():
    """A batch whose every row beats the last: each query's buffer fills,
    compacts and re-admits many times over; still the exact top-k."""
    rng = np.random.default_rng(5)
    cap = N_TILES * BN
    scores = np.sort(rng.integers(-10_000, 10_000, (20, cap)), axis=1)
    mask = np.ones(cap, bool)
    vals, idx, _ = walk(scores.astype(np.int64), mask, HOT, len(HOT), 128,
                        sms=2)
    keys = tscan._sel_keys(torch.from_numpy(scores.astype(np.int64)),
                           torch.arange(cap))
    rows = torch.cat([torch.arange(t * BN, (t + 1) * BN) for t in HOT])
    top = torch.topk(keys[:, rows], 128, dim=1).values
    ref = tscan._merge_sel_keys([top], 128, int_scores=True)
    np.testing.assert_array_equal(vals, ref[0].numpy())
    np.testing.assert_array_equal(idx, ref[1].numpy())


@pytest.mark.parametrize("n_hot", [0, 1, 3, 40, 64, 99])
@pytest.mark.parametrize("nq,sms", [(17, 132), (512, 132), (2048, 132),
                                    (64, 1)])
def test_shares_cover_the_live_segments_once(n_hot, nq, sms):
    """The CTAs' shares tile [0, min(n_hot, grid_b) * 8) in order, within
    one segment of each other, none in a dead step; the grid is at most
    max(sms, q_tiles) CTAs and each (query tile, live segment) is walked
    once."""
    grid_b = 64
    q_tiles, ranges = tivf.ivf_wgmma_partition(nq, grid_b, BN, sms)
    assert q_tiles == -(-nq // QTILE)
    assert q_tiles * ranges <= max(sms, q_tiles)
    assert ranges <= grid_b * NS
    share = shares(n_hot, grid_b, ranges)
    live = min(n_hot, grid_b) * NS
    assert share[0][0] == 0 and share[-1][1] == live
    for (_, e0), (b1, _) in zip(share, share[1:]):
        assert e0 == b1
    sizes = [e - b for b, e in share]
    assert max(sizes) - min(sizes) <= 1


# --------------------------------------------------------------------------
# The ready rule and the dispatch
# --------------------------------------------------------------------------


def _operands(dim, dtype, offset=0, nq=64, rows=256):
    q = torch.zeros(nq, dim, dtype=dtype)
    flat = torch.zeros(rows * dim + 16, dtype=dtype)
    return q, flat[offset:offset + rows * dim].view(rows, dim)


# kind: (a width of whole 16-byte rows, one that is not)
RULE_CASES = {"f32": (1024, 98), "bf16": (1024, 100), "i8c": (1024, 104)}


@pytest.mark.parametrize("kind", list(RULE_CASES))
def test_ivf_wgmma_ready_edges(kind):
    """k <= 128 where neither one-query sweep takes the operands: every
    width and base past 16 queries (rows TMA cannot read by the producer
    `rows_piece` names), none at Q <= 16 where the sweep or its narrow
    kind holds them."""
    dt = DTYPES[kind]
    words, ragged = RULE_CASES[kind]
    for nq in (17, 64, 2048):
        q, v = _operands(words, dt, nq=nq)
        assert tivf.ivf_wgmma_ready(q, v, 1) and tivf.ivf_wgmma_ready(q, v, 128)
        assert not tivf.ivf_wgmma_ready(q, v, 129)
        assert tivf.ivf_wgmma_ready(*_operands(ragged, dt, nq=nq), 14)
        assert tivf.ivf_wgmma_ready(*_operands(words, dt, nq=nq,
                                               offset=1), 14)
        qq = torch.zeros(nq * words + 16, dtype=dt)[1:1 + nq * words]
        assert tivf.ivf_wgmma_ready(qq.view(nq, words), v, 14)
    for nq in (1, 16):
        assert not tivf.ivf_wgmma_ready(*_operands(words, dt, nq=nq), 14)
        assert not tivf.ivf_wgmma_ready(*_operands(ragged, dt, nq=nq), 14)
    assert tivf.ivf_wgmma_ready(*_operands(words, dt, nq=17), 14)


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
    """Stand-ins for `scan._launch` (records entry and arguments, checks
    the argument count against the library's signature table) and the SM
    count of a 132-SM card."""
    calls = []

    def launch(t, name, entry, *args):
        assert len(args) + 1 == len(_build._SIGNATURES[entry]), entry
        calls.append((entry, args))

    monkeypatch.setattr(tscan, "_launch", launch)
    monkeypatch.setattr(tivf, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    return calls


# (kind, Q, dim, k, offset, kernel): the sweep, then its narrow kind, then
# the tensor-core scan, then the wide kind (k > 128); rows TMA cannot read
# (a ragged width, a base off 16 bytes) take the same kinds
DISPATCH = [("f32", 16, 64, 14, 0, "sweep"), ("f32", 17, 64, 14, 0, "wgmma"),
            ("bf16", 64, 64, 32, 0, "wgmma"), ("i8c", 512, 64, 128, 0, "wgmma"),
            ("i8c", 2048, 1024, 14, 0, "wgmma"),
            ("f32", 64, 64, 544, 0, "wide"),
            ("bf16", 64, 100, 14, 0, "wgmma"),
            ("f32", 64, 64, 14, 1, "wgmma"),
            ("i8c", 16, 64, 544, 0, "wide"),
            ("bf16", 16, 100, 14, 0, "narrow"),
            ("f32", 1, 64, 14, 1, "narrow"),
            ("f32", 16, 1536, 14, 0, "wgmma")]


@pytest.mark.parametrize("kind,nq,dim,k,offset,kernel", DISPATCH)
def test_k7_dispatch_order(recorded, kind, nq, dim, k, offset, kernel):
    dt = DTYPES[kind]
    q = torch.zeros(nq, dim, dtype=dt)
    flat = torch.zeros(4 * BN * dim + 16, dtype=dt)
    v = flat[offset:offset + 4 * BN * dim].view(4 * BN, dim)
    mask = torch.ones(4 * BN, dtype=torch.bool)
    hot = torch.tensor([3, 1, 2], dtype=torch.int32)
    n_hot = torch.tensor([2], dtype=torch.int32)
    before = dict(tscan.LAUNCHES)
    vals, idx = tivf.ivf_scan_topk(*map(_as_cuda, (q, v, mask, hot, n_hot)), k)
    assert vals.shape == idx.shape == (nq, k)
    (entry, args), = recorded
    assert entry == {"sweep": "pv_ivf_sweep_topk",
                     "narrow": "pv_ivf_sweep_topk_narrow",
                     "wgmma": "pv_ivf_scan_topk_wgmma",
                     "wide": "pv_ivf_scan_topk_wide",
                     "template": "pv_ivf_scan_topk"}[kernel]
    piece = tscan.rows_piece(v)
    if kernel == "wgmma":
        assert args[:2] == (piece, tivf._KINDS[dt])
        # float32 queries pass their hi / lo planes, the others themselves
        # where their rows are whole 16 bytes (else padded copies)
        whole = dim * q.element_size() % 16 == 0
        assert (args[2] == q.data_ptr()) == (kind != "f32" and whole)
        assert args[3:7] == (v.data_ptr(), mask.data_ptr(), hot.data_ptr(),
                             n_hot.data_ptr())
        assert args[10:] == (nq, 4 * BN, dim, k, BN, 3)
    if kernel == "wide":
        assert args[0] == piece
    assert tscan.LAUNCHES["ivf_scan_topk"] == before["ivf_scan_topk"] + 1
    suffix = tscan._PIECE_KEY[piece]
    for key in ("sweep", "narrow", "wgmma" + suffix, "wide" + suffix):
        name = f"ivf_scan_topk_{key}"
        assert (tscan.LAUNCHES[name]
                == before[name] + (key.split("_")[0] == kernel)), name


def test_wgmma_launch_partials(recorded, monkeypatch):
    """The launcher sizes its partials Q x ranges x k at the grid's ranges,
    and splits float32 queries into their hi / lo planes, stacked."""
    made = []
    real = torch.empty

    def empty(*a, **kw):
        t = real(*a, **kw)
        made.append(tuple(t.shape))
        return t

    monkeypatch.setattr(torch, "empty", empty)
    q = torch.randn(200, 64)
    v = torch.zeros(8 * BN, 64)
    mask = torch.ones(8 * BN, dtype=torch.bool)
    hot = torch.arange(6, dtype=torch.int32)
    tivf.ivf_scan_topk(*map(_as_cuda, (q, v, mask, hot,
                                       torch.tensor([4], dtype=torch.int32))),
                       14)
    _, ranges = tivf.ivf_wgmma_partition(200, 6, BN, 132)
    assert ranges == 132 // 4
    assert (200 * ranges * 14,) in made
    hi, lo = tscan.split_tf32(q)
    assert torch.equal(hi + lo, q)


def test_counter_stays_zero_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    v8 = torch.randint(-127, 128, (2 * BN, 96), generator=g, dtype=torch.int8)
    mask = torch.ones(2 * BN, dtype=torch.bool)
    hot = torch.tensor([1, 0], dtype=torch.int32)
    tscan.reset_launch_counts()
    tivf.ivf_scan_topk(v8[:40], v8, mask, hot,
                       torch.tensor([2], dtype=torch.int32), 14)
    tivf.ivf_scan_topk(v8[:64].float(), v8.float(), mask, hot,
                       torch.tensor([1], dtype=torch.int32), 14)
    assert tscan.LAUNCHES["ivf_scan_topk"] == 0
    assert tscan.LAUNCHES["ivf_scan_topk_wgmma"] == 0


# --------------------------------------------------------------------------
# The probed route with the walk, against the JAX package's kernel
# --------------------------------------------------------------------------


def _clustered(rng, n, dim=DIM, n_clusters=24, noise=0.35):
    centres = normalize_batch(rng.normal(size=(n_clusters, dim)).astype(np.float32))
    lab = rng.integers(0, n_clusters, n)
    pts = centres[lab] + noise / np.sqrt(dim) * rng.normal(size=(n, dim))
    return normalize_batch(pts.astype(np.float32))


@pytest.fixture(scope="module")
def layout():
    """A JAX-built classic layout over 8000 clustered rows (8 live tiles of
    9), and 64 queries near them."""
    rng = np.random.default_rng(21)
    v = _clustered(rng, 8000)
    q = normalize_batch(v[rng.integers(0, 8000, 64)]
                        + 0.02 * rng.normal(size=(64, DIM))).astype(np.float32)
    return jivf.IVFIndex.build(v, np.ones(len(v), bool), nlist=16, dim=DIM), q


def _state(j):
    opt = lambda a: None if a is None else np.asarray(a)  # noqa: E731
    return dict(
        centroids=np.asarray(j.centroids), vectors=opt(j.vectors),
        slots=np.asarray(j.slots), row_cluster=np.asarray(j.row_cluster),
        active=np.asarray(j.active), cluster2tile=np.asarray(j.cluster2tile),
        seg_starts=np.asarray(j.seg_starts), nlist=j.nlist, n_tiles=j.n_tiles,
        dim=j.dim, vectors_i8c=opt(j.vectors_i8c), cscale=opt(j.cscale),
        slot2row=j._slot2row, n_used=j._n_used, n_build=j._n_build,
        host_blob=j._host_blob)


def _walked(qs, ps, mask, hot, n_hot, k, bn=BN):
    """ivf_scan_topk as the walk of the tensor-core scan computes it: the
    kernel's scores (float32 sums of the operands' products, int8's exact
    int32 sums) over the hot tiles, then the walk."""
    assert bn == BN and qs.shape[0] > tscan.SWEEP_Q_MAX
    if qs.dtype == torch.int8:
        sc = (qs.to(torch.int64) @ ps.to(torch.int64).T).numpy()
    else:
        sc = (qs.double() @ ps.double().T).float().numpy()
    vals, idx, _ = walk(sc, mask.numpy(), hot.numpy(), int(n_hot[0]), k)
    return torch.from_numpy(vals), torch.from_numpy(idx)


@pytest.mark.parametrize("postings", ["float32", "int8"])
@pytest.mark.parametrize("nq", [17, 64])
def test_walk_route_matches_jax(layout, monkeypatch, postings, nq):
    """The port's probed ladder route with K7 taken by the tensor-core
    scan's walk against `picovdb_tpu.ops.ivf.probe_scan_local` (its Pallas
    kernel in interpret mode) on one JAX-built layout, every cluster
    probed: rescored scores within 1e-5, id sets equal wherever the float64
    k/k+1 gap over the active postings exceeds 1e-4."""
    j0, q = layout
    q = q[:nq]
    if postings == "int8":
        monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # the classic int8 mirror
    j = jivf.IVFIndex(j0.centroids, j0.vectors, j0.slots, j0.row_cluster,
                      j0.active, j0.cluster2tile, j0.nlist, j0.n_tiles,
                      j0.dim, seg_starts=j0.seg_starts)
    st = _state(j0)
    st.update(vectors_i8c=None if j.vectors_i8c is None else np.asarray(j.vectors_i8c),
              cscale=None if j.cscale is None else np.asarray(j.cscale))
    t = tivf.IVFIndex.from_numpy_state(**st, device="cpu")
    assert (t.vectors_i8c is not None) == (postings == "int8")
    monkeypatch.setattr(tivf, "ivf_scan_topk", _walked)
    k = 10
    # int8: the TPU ladder ranks int32 sums with their low 10 bits replaced
    # by the lane, the port the exact sums: on these 64 queries a band of
    # k + 50 holds the true top-k on both sides (k + 30, as
    # tests/test_torch_ivf.py takes, misses it on a few of them with the
    # port's plain version too)
    k_sel = k + (50 if postings == "int8" else 4)
    kw = dict(k=k, k_sel=k_sel, nprobe=16, nlist=j.nlist, g_tiles=None)
    jv, js = jivf.probe_scan_local(
        jnp.asarray(q), j.centroids, j.vectors, j.slots, j.seg_starts,
        j.active, j.cluster2tile, interpret=True, compute_dtype=None,
        vectors_i8=j.vectors_i8c, cscale=j.cscale, **kw)
    tv, ts = tivf.probe_scan_local(
        _t(q), t.centroids, t.vectors, t.slots, t.seg_starts, t.active,
        t.cluster2tile, vectors_i8=t.vectors_i8c, cscale=t.cscale, **kw)
    jv, js, tv, ts = map(np.asarray, (jv, js, tv, ts))
    np.testing.assert_array_equal(np.isneginf(jv), np.isneginf(tv))
    fin = np.isfinite(jv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=TOL_SCORE)
    rows = np.asarray(j.vectors).astype(np.float64)
    s = normalize_batch(q).astype(np.float64) @ rows.T
    s[:, ~np.asarray(j.active)] = -np.inf
    s = -np.sort(-s, axis=1)
    for i in range(q.shape[0]):
        if s[i, k - 1] - s[i, k] > TOL_GAP:
            assert set(js[i][fin[i]]) == set(ts[i][fin[i]]), i
