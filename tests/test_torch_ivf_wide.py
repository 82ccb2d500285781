"""K7's wide kind (csrc/ivf_scan_wide.cu: 128 < k <= 1024), checked on
the CPU.

* The kernel's three steps emulated in numpy as they run: the step order
  (`ivf_rows_kernel`: each live step's rank by (tile id, step), the live
  tiles in ascending order, the logical mask gathered from them, zero in
  the dead steps' slots); pass A, K7's tensor-core scan over that rows map
  (the launcher's query tiles, `ivf_wgmma_partition`'s CTAs, each taking
  its share of the live steps' segments computed from n_hot, segments
  with no live row skipped) writing each row's key at its logical row
  (float_order of a float score, the sign-flipped int32 sum of int8
  postings); pass B, the radix select of K4's wide kind
  (tests/test_torch_topk_wide.py::pass_b) over the slab and the logical
  mask, decoded to the tile's IVF rows. On scores exact in float32 (and
  int8's integer sums) it equals `ivf_scan_topk_plain` bit for bit in all
  three kinds at k_sel 129 / 160 / 432 / 544 / 1024, Q 1 / 17 / 64,
  n_hot 0 / 1 / grid_b, with a hot table out of tile order and query 0's
  two best rows tied across it (the lower IVF row first), and with more
  tied int8 rows than the candidates' CAP over tiles listed out of order.
* `ivf_wide_ready` at its edges (k 128 / 129 / 384 / 385 / 1024 / 1025,
  widths, misaligned views, the slab budget), its scratch, the dispatch
  order (the sweep, the tensor-core scan, the wide kind, the template)
  recorded by a stand-in for `scan._launch` on CPU tensors posing as CUDA
  ones against `_build._SIGNATURES`; on the CPU the counter stays 0.
* The port's `probe_scan_local` (K7 on the CPU: its plain version, which
  the CUDA tests hold the kernel to) against the JAX package's (its
  Pallas kernel in interpret mode) at k_sel 160 and 544 over int8 and
  float32 postings of one JAX-built layout, Q 1 and 17: int8, the same
  slot ids bit for bit; both, rescored scores within 1e-5 (the rescore's
  float32 summation order) and float32's ids outside a 1e-5 gap.
* Both packages' engines on host-uploaded int8 and int4 stores of 3,000
  x 256 clustered rows, `index="ivf"`, `top_k=10`, the host rescore on:
  route ivf_i8, the same ids, and the port's K7 launches at (Q, k_sel)
  (1, 160) / (8, 160) for int8 and (1, 544) / (8, 544) for int4.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu.ops import ivf as jivf
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import ivf as tivf
from picovdb_tpu_torch.ops import scan as tscan
from test_torch_ivf_wgmma import _clustered, _state
from test_torch_topk_wide import decode, float_order, pass_b
from torch_port_setup import cap_torch_threads, cpu_kw

cap_torch_threads()

BN = tivf.IVF_BN
SEG = tscan.SEG
NS = BN // SEG
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i8c": torch.int8}
KS = [129, 160, 432, 544, 1024]
TOL_SCORE = 1e-5
TOL_GAP = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# --------------------------------------------------------------------------
# The kernel's steps, emulated
# --------------------------------------------------------------------------


def step_order(hot, n_hot, mask, bn=BN):
    """`ivf_rows_kernel`: the live tiles by (tile id, step) and the logical
    mask (grid_b x bn bytes; the dead steps' slots zero)."""
    grid_b = len(hot)
    live = max(0, min(n_hot, grid_b))
    order = sorted(range(live), key=lambda b: (hot[b], b))
    tiles = np.array([hot[b] for b in order], dtype=np.int64)
    lmask = np.zeros(grid_b * bn, bool)
    for r, t in enumerate(tiles):
        lmask[r * bn:(r + 1) * bn] = mask[t * bn:(t + 1) * bn]
    return tiles, lmask


def slab_key(scores):
    """The slab's key of a score: float_order, or the sign-flipped int32
    sum (int8 postings)."""
    if scores.dtype == np.int64:
        return (scores.astype(np.int32).view(np.uint32)
                ^ np.uint32(0x80000000))
    return float_order(scores)


def slab_keys(scores, mask, hot, n_hot, sms=132, bn=BN):
    """Pass A over the rows map: (Q, grid_b x bn) keys at logical rows,
    every row of a segment that holds a live row of the live steps."""
    nq = scores.shape[0]
    grid_b = len(hot)
    tiles, lmask = step_order(hot, n_hot, mask, bn)
    ld = grid_b * bn
    slab = np.zeros((nq, ld), np.uint32)
    written = np.zeros((nq, ld), bool)
    segs = len(tiles) * (bn // SEG)  # the live steps' segments
    q_tile = tscan.topk_wide_tile(nq, ld)
    for q0 in range(0, nq, q_tile):
        nt = min(q_tile, nq - q0)
        n = 32 if nt <= 32 else 64
        q_tiles, ranges = tscan.topk_wgmma_partition(nt, ld, sms, n)
        for c in range(q_tiles * ranges):
            qt, r = c % q_tiles, c // q_tiles
            qs = np.arange(q0 + qt * n, q0 + min(nt, (qt + 1) * n))
            for j in range(r * segs // ranges, (r + 1) * segs // ranges):
                r0 = int(tiles[j // (bn // SEG)]) * bn + (j % (bn // SEG)) * SEG
                rows = np.arange(r0, r0 + SEG)
                if not mask[rows].any():
                    continue  # no copy, no product
                cols = np.arange(j * SEG, (j + 1) * SEG)
                assert not written[qs[:, None], cols].any()
                slab[qs[:, None], cols] = slab_key(scores[qs][:, rows])
                written[qs[:, None], cols] = True
    seg_live = lmask.reshape(-1, SEG).any(1)
    assert (written == np.repeat(seg_live, SEG)[None, :]).all()
    return slab, tiles, lmask


def decode_rows(keys, tiles, int_scores, bn=BN):
    """finish_kernel's decode: the score (float32, or the int32 sum as
    float32) and logical row l -> tiles[l // bn] * bn + l % bn; -inf / 0
    where a key is empty."""
    vals, rows = decode(keys)
    if int_scores:
        hi = (keys >> np.uint64(32)).astype(np.uint32) ^ np.uint32(0x80000000)
        vals = np.where(keys == 0, -np.inf,
                        hi.view(np.int32).astype(np.float32)).astype(np.float32)
    ivf_rows = np.zeros(keys.shape, np.int64)
    full = keys != 0
    ivf_rows[full] = tiles[rows[full] // bn] * bn + rows[full] % bn
    return vals, ivf_rows.astype(np.int32)


def wide_emulated(scores, mask, hot, n_hot, k, stats=None):
    slab, tiles, lmask = slab_keys(scores, mask, hot, n_hot)
    int_scores = scores.dtype == np.int64
    out = [decode_rows(pass_b(slab[i], lmask, k, stats=stats), tiles,
                       int_scores) for i in range(scores.shape[0])]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


N_TILES, DIM = 6, 32
HOT = [4, 1, 5, 0, 2]  # not ascending: ties resolve by the IVF row


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
    if kind == "i8c":
        return q.astype(np.int64) @ v.astype(np.int64).T
    return (q.astype(np.float64) @ v.astype(np.float64).T).astype(np.float32)


def _plain(q, v, mask, hot, n_hot, k, kind):
    dt = DTYPES[kind]
    vals, idx = tivf.ivf_scan_topk_plain(
        _t(q).to(dt), _t(v).to(dt), _t(mask),
        torch.tensor(hot, dtype=torch.int32),
        torch.tensor([n_hot], dtype=torch.int32), k)
    return vals.numpy(), idx.numpy()


@pytest.mark.parametrize("kind", list(DTYPES))
@pytest.mark.parametrize("nq", [1, 17, 64])
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("n_hot", [0, 1, len(HOT)])
def test_wide_emulation_equals_plain(kind, nq, k, n_hot):
    q, v, mask = _exact_case(kind, nq, seed=nq + k + n_hot)
    # query 0's best two rows: the last row of step 0 (tile 4) and the
    # first of step 1 (tile 1), which ranks first
    phys = [HOT[0] * BN + BN - 1, HOT[1] * BN]
    v[phys] = _best_row(q[0], kind)
    mask[phys] = True
    vals, idx = wide_emulated(_exact_scores(q, v, kind), mask, HOT, n_hot, k)
    ref = _plain(q, v, mask, HOT, n_hot, k, kind)
    np.testing.assert_array_equal(vals, ref[0])
    np.testing.assert_array_equal(idx, ref[1])
    fin = np.isfinite(vals)
    assert (idx[~fin] == 0).all()
    live = np.zeros_like(mask)
    for t in HOT[:n_hot]:
        live[t * BN:(t + 1) * BN] = True
    assert (mask & live)[idx[fin]].all()
    if n_hot >= 2:
        assert idx[0, :2].tolist() == sorted(phys)
    if n_hot == 0:
        assert np.isneginf(vals).all() and not idx.any()


def test_wide_emulation_ties_past_cap_out_of_order():
    """More than CAP live int8 rows over tiles listed out of order share
    the best score: the k lowest IVF rows of them, in row order (the ties
    path walks the slab in the step order, which ascends with the IVF
    rows)."""
    rng = np.random.default_rng(6)
    n_tiles, k = 12, 544
    hot = [9, 3, 11, 0, 7, 10, 1, 5, 8, 2, 4, 6]
    cap = n_tiles * BN
    v = rng.integers(-127, 128, (cap, DIM)).astype(np.int8)
    q = rng.integers(-127, 128, (2, DIM)).astype(np.int8)
    q[1] = q[0]
    mask = rng.random(cap) < 0.8
    tied = np.concatenate([np.arange(t * BN, (t + 1) * BN) for t in hot[:10]])
    v[tied] = _best_row(q[0], "i8c")
    mask[tied] = True
    stats = {}
    vals, idx = wide_emulated(_exact_scores(q, v, "i8c"), mask, hot, 12, k,
                              stats=stats)
    assert stats["ties"], stats
    ref = _plain(q, v, mask, hot, 12, k, "i8c")
    np.testing.assert_array_equal(vals, ref[0])
    np.testing.assert_array_equal(idx, ref[1])
    assert idx[0].tolist() == sorted(tied.tolist())[:k]


def test_step_order_with_repeated_and_dead_steps():
    """Dead steps (b >= n_hot) repeat the last tile, as the probe pads its
    table: they take no slot; the live tiles come out ascending, and a
    tile listed twice (not from the probe) keeps both copies in step
    order, as the plain version scores it twice."""
    mask = np.ones(8 * BN, bool)
    tiles, lmask = step_order([5, 2, 7, 2, 2, 2], 4, mask)
    assert tiles.tolist() == [2, 2, 5, 7]
    assert lmask[:4 * BN].all() and not lmask[4 * BN:].any()
    tiles, lmask = step_order([3, 1], 0, mask)
    assert tiles.size == 0 and not lmask.any()


# --------------------------------------------------------------------------
# The ready rule, the scratch and the dispatch
# --------------------------------------------------------------------------


def _operands(dim, dtype, offset=0, nq=64, rows=256, qoffset=0):
    qf = torch.zeros(nq * dim + 16, dtype=dtype)
    flat = torch.zeros(rows * dim + 16, dtype=dtype)
    return (qf[qoffset:qoffset + nq * dim].view(nq, dim),
            flat[offset:offset + rows * dim].view(rows, dim))


# kind: (a width of whole 16-byte rows, one that is not)
RULE_CASES = {"f32": (1024, 98), "bf16": (1024, 100), "i8c": (1024, 104)}


@pytest.mark.parametrize("kind", list(RULE_CASES))
def test_ivf_wide_ready_edges(monkeypatch, kind):
    """128 < k <= SCAN_KSEL_MAX and one query's slab within
    TOPK_WIDE_SLAB_BYTES, at every width and base of both operands (rows
    TMA cannot read by the producer `rows_piece` names, the queries padded
    in the scratch); any Q."""
    dt = DTYPES[kind]
    words, ragged = RULE_CASES[kind]
    for nq in (1, 16, 17, 2048):
        q, v = _operands(words, dt, nq=nq)
        for k in (128, 129, 384, 385, 1024, 1025):
            assert tivf.ivf_wide_ready(q, v, k) == (128 < k <= 1024), k
        assert tivf.ivf_wide_ready(*_operands(ragged, dt, nq=nq), 544)
        assert tivf.ivf_wide_ready(*_operands(words, dt, nq=nq, offset=1), 544)
        assert tivf.ivf_wide_ready(*_operands(words, dt, nq=nq, qoffset=1),
                                   544)
        assert not tivf.ivf_wide_ready(*_operands(ragged, dt, nq=nq), 128)
    q, v = _operands(words, dt, rows=2 * BN)
    monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", 4 * 2 * BN)
    assert tivf.ivf_wide_ready(q, v, 544)
    monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", 4 * 2 * BN - 1)
    assert not tivf.ivf_wide_ready(q, v, 544)


@pytest.mark.parametrize("nq,kind,grid_b", [(1, 0, 40), (64, 0, 700),
                                            (128, 2, 2000), (4096, 1, 64)])
def test_scratch_layout(nq, kind, grid_b):
    """The query planes (float32: hi and lo; bf16 and int8: room for the
    queries as rows of whole 16 bytes), the sorted tiles, the logical
    mask, then one query tile's slab, histograms and candidates, each from
    a 256-byte boundary (csrc/ivf_scan_wide.cu's layout); the tile keeps
    the slab within its budget."""
    ld = grid_b * BN
    t = tscan.topk_wide_tile(nq, ld)
    assert t * ld * 4 <= tscan.TOPK_WIDE_SLAB_BYTES or t == 1
    up = lambda b: -(-b // 256) * 256  # noqa: E731
    es = {0: 4, 1: 2, 2: 1}[kind]
    for dim in (1024, 25, 100, 1019):
        qld = -(-dim * es // 16) * 16 // es
        want = ((up(nq * qld * 8) if kind == 0 else up(nq * qld * es))
                + up(grid_b * 4) + up(grid_b * BN) + up(t * ld * 4)
                + up(t * tscan.TOPK_WIDE_HIST * 4)
                + t * tscan.TOPK_WIDE_CAP * 8)
        assert tivf.ivf_wide_scratch(nq, dim, kind, grid_b, BN, t) == want


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
    monkeypatch.setattr(tivf, "_launch", launch)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(
                            multi_processor_count=132))
    return calls


# (kind, Q, dim, k, offset, kernel): the sweep, the tensor-core scan, the
# wide kind; rows TMA cannot read (a ragged width, a base off 16 bytes)
# take the same kinds, the template only a slab over its budget
DISPATCH = [("f32", 16, 64, 128, 0, "sweep"), ("i8c", 17, 64, 128, 0, "wgmma"),
            ("i8c", 1, 1024, 160, 0, "wide"), ("i8c", 64, 256, 160, 0, "wide"),
            ("i8c", 1, 256, 544, 0, "wide"), ("f32", 16, 64, 544, 0, "wide"),
            ("bf16", 128, 64, 1024, 0, "wide"),
            ("bf16", 64, 100, 544, 0, "wide"),
            ("f32", 1, 64, 160, 1, "wide"),
            ("i8c", 1, 25, 144, 3, "wide")]


@pytest.mark.parametrize("kind,nq,dim,k,offset,kernel", DISPATCH)
def test_k7_dispatch_with_the_wide_kind(recorded, kind, nq, dim, k, offset,
                                        kernel):
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
                     "wgmma": "pv_ivf_scan_topk_wgmma",
                     "wide": "pv_ivf_scan_topk_wide",
                     "template": "pv_ivf_scan_topk"}[kernel]
    piece = tscan.rows_piece(v)
    if kernel == "wide":
        q_tile = tscan.topk_wide_tile(nq, 3 * BN)
        assert args[:7] == (piece, tivf._KINDS[dt], q.data_ptr(), v.data_ptr(),
                            mask.data_ptr(), hot.data_ptr(), n_hot.data_ptr())
        assert args[10:] == (nq, 4 * BN, dim, k, BN, 3, q_tile,
                             tivf.ivf_wide_scratch(nq, dim, tivf._KINDS[dt],
                                                   3, BN, q_tile))
    assert tscan.LAUNCHES["ivf_scan_topk"] == before["ivf_scan_topk"] + 1
    suffix = tscan._PIECE_KEY[piece]
    for key in ("sweep", "wgmma" + suffix, "wide" + suffix):
        name = f"ivf_scan_topk_{key}"
        assert (tscan.LAUNCHES[name]
                == before[name] + (key.split("_")[0] == kernel)), name
    assert tscan.LAUNCH_SHAPES["ivf_scan_topk"][nq, k] >= 1


def test_counter_stays_zero_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    v8 = torch.randint(-127, 128, (2 * BN, 96), generator=g, dtype=torch.int8)
    mask = torch.ones(2 * BN, dtype=torch.bool)
    hot = torch.tensor([1, 0], dtype=torch.int32)
    tscan.reset_launch_counts()
    for nq, k in ((1, 160), (40, 544)):
        tivf.ivf_scan_topk(v8[:nq], v8, mask, hot,
                           torch.tensor([2], dtype=torch.int32), k)
    assert tscan.LAUNCHES["ivf_scan_topk"] == 0
    assert tscan.LAUNCHES["ivf_scan_topk_wide"] == 0


# --------------------------------------------------------------------------
# The probed route and the engines, against the JAX package
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def layout():
    """A JAX-built classic layout over 8000 clustered rows (8 live tiles of
    9), and 17 queries near them."""
    rng = np.random.default_rng(21)
    v = _clustered(rng, 8000)
    q = normalize_batch(v[rng.integers(0, 8000, 17)]
                        + 0.02 * rng.normal(size=(17, DIM))).astype(np.float32)
    return jivf.IVFIndex.build(v, np.ones(len(v), bool), nlist=16, dim=DIM), q


@pytest.mark.parametrize("postings", ["int8", "float32"])
@pytest.mark.parametrize("k_sel", [160, 544])
@pytest.mark.parametrize("nq", [1, 17])
def test_probe_scan_local_matches_jax(layout, monkeypatch, postings, k_sel,
                                      nq):
    """The port's probed route with K7 at k_sel 160 / 544 against
    `picovdb_tpu.ops.ivf.probe_scan_local` (its Pallas kernel in interpret
    mode) on one JAX-built layout, every cluster probed, top-10 rescored:
    int8 postings give the same slot ids bit for bit; scores within 1e-5
    (the rescores sum float32 products in different orders); float32
    postings the same id sets wherever the float64 k / k+1 gap over the
    active postings exceeds 1e-5."""
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
    seen = []
    real = tivf.ivf_scan_topk

    def spy(qs, ps, *a, **kw):
        seen.append((qs.shape[0], a[3], qs.dtype))
        return real(qs, ps, *a, **kw)

    monkeypatch.setattr(tivf, "ivf_scan_topk", spy)
    k = 10
    kw = dict(k=k, k_sel=k_sel, nprobe=16, nlist=j.nlist, g_tiles=None)
    jv, js = jivf.probe_scan_local(
        jnp.asarray(q), j.centroids, j.vectors, j.slots, j.seg_starts,
        j.active, j.cluster2tile, interpret=True, compute_dtype=None,
        vectors_i8=j.vectors_i8c, cscale=j.cscale, **kw)
    tv, ts = tivf.probe_scan_local(
        _t(q), t.centroids, t.vectors, t.slots, t.seg_starts, t.active,
        t.cluster2tile, vectors_i8=t.vectors_i8c, cscale=t.cscale, **kw)
    dt = torch.int8 if postings == "int8" else torch.float32
    assert seen == [(nq, k_sel, dt)]
    jv, js, tv, ts = map(np.asarray, (jv, js, tv, ts))
    assert np.isfinite(tv).all()
    np.testing.assert_allclose(tv, jv, rtol=0, atol=TOL_SCORE)
    if postings == "int8":
        np.testing.assert_array_equal(ts, js)
        return
    rows = np.asarray(j.vectors).astype(np.float64)
    s = normalize_batch(q).astype(np.float64) @ rows.T
    s[:, ~np.asarray(j.active)] = -np.inf
    s = -np.sort(-s, axis=1)
    for i in range(nq):
        if s[i, k - 1] - s[i, k] > TOL_GAP:
            assert set(js[i]) == set(ts[i]), i


@pytest.fixture
def interpret_mode():
    with pltpu.force_tpu_interpret_mode():
        yield


@pytest.mark.parametrize("storage,k_sel", [("int8", 160), ("int4", 544)])
def test_engine_host_rescored_ivf_matches_jax(tmp_path, interpret_mode,
                                              monkeypatch, storage, k_sel):
    """A host-uploaded int8 / int4 store of 3,000 x 256 clustered rows with
    index="ivf" in both packages, queried at top_k = 10 alone and in a
    batch of 8: route ivf_i8 (int8 postings at dim 256) with the host
    rescore, the same ids; the port's K7 launches at (1, k_sel) and (8,
    k_sel): 10 + 128 + 22 = 160 for int8, 10 + 4 x 128 + 22 = 544 for
    int4."""
    n, dim = 3000, 256
    rng = np.random.default_rng(9)
    vecs = _clustered(rng, n, dim=dim, n_clusters=16)
    q = (vecs[:8] + 0.02 * rng.normal(size=(8, dim))).astype(np.float32)
    ids = [f"d{i}" for i in range(n)]
    seen = []
    real = tivf.ivf_scan_topk

    def spy(qs, ps, *a, **kw):
        seen.append((qs.shape[0], a[3]))
        return real(qs, ps, *a, **kw)

    monkeypatch.setattr(tivf, "ivf_scan_topk", spy)
    got = {}
    for name, pkg in (("jax", picovdb_tpu), ("torch", picovdb_tpu_torch)):
        db = pkg.PicoVectorDB(embedding_dim=dim, storage_file=f"{tmp_path}/{name}",
                              index="ivf", ivf_nlist=16, storage_dtype=storage,
                              **cpu_kw(pkg))
        db.upsert_columnar(vecs, ids=ids)
        one = db.query(q[0], top_k=10)
        dbg = db.last_query_debug()
        assert dbg["strategy"] == "ivf_i8" and dbg["rescore"] == "host", dbg
        batch = db.query(q, top_k=10)
        dbg = db.last_query_debug()
        assert dbg["strategy"] == "ivf_i8" and dbg["rescore"] == "host", dbg
        got[name] = [[h["_id_"] for h in r] for r in [one] + batch]
    assert seen == [(1, k_sel), (8, k_sel)], seen
    qn = normalize_batch(np.concatenate([q[:1], q])).astype(np.float64)
    s = -np.sort(-(qn @ vecs.astype(np.float64).T), axis=1)
    assert (s[:, 9] - s[:, 10] > 0).all()  # no tie at the cut
    assert got["jax"] == got["torch"]
