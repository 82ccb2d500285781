"""K7's one-query sweep and K10's int8 mainloop, checked on the CPU.

* Which kernel a launch takes: K7's sweep rule (`ivf_sweep_ready`) for
  each element kind, and the entry points and arguments the wrappers pass
  (`segmax_scan_i8c` by `wgmma_i8_ready`, `ivf_scan_topk` by
  `ivf_sweep_ready`), recorded by a stand-in for `scan._launch` on CPU
  tensors that report themselves as CUDA tensors, with the counters.
* The sweep's shares (`ivf_sweep_partition`): the live hot rows once,
  balanced, no dead step.
* K7's plain version over the sweep's shares: against a numpy oracle on
  scores that are exact in float32 (so ties, across a share boundary and
  across a hot-tile boundary, go to the lower row in every kind), and,
  inside the probed route, against the JAX package's `probe_scan_local`
  in interpret mode on one JAX-built layout handed over by
  `IVFIndex.from_numpy_state` (tolerances as tests/test_torch_ivf.py).
* On the CPU the wrappers run the plain versions: the new counters stay 0.
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
TOL_SCORE = 1e-5
TOL_GAP = 1e-4
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "i8c": torch.int8}


def _t(a):
    return torch.from_numpy(np.array(a))


# --------------------------------------------------------------------------
# The dispatch rules and what the wrappers launch
# --------------------------------------------------------------------------


def _operands(dim, dtype, offset=0, nq=16, rows=256):
    """Contiguous (nq, dim) queries and a (rows, dim) view `offset`
    elements into a larger buffer."""
    q = torch.zeros(nq, dim, dtype=dtype)
    flat = torch.zeros(rows * dim + 16, dtype=dtype)
    return q, flat[offset:offset + rows * dim].view(rows, dim)


# kind: (a width of whole 16-byte words, one that is not, the widest row
# whose 16-query block fits SWEEP_QBLOCK_BYTES)
RULE_CASES = {"f32": (96, 98, 1024), "bf16": (96, 100, 2048),
              "i8c": (96, 104, 4096)}


@pytest.mark.parametrize("kind", list(RULE_CASES))
def test_ivf_sweep_ready_rule(kind):
    """The sweep takes Q <= 16 at k <= 128 over rows of whole 16-byte
    words with 16-byte aligned bases, while the query block (the tile
    sized to Q, times a row's bytes) fits 64 KB: f32 at Q = 16 up to dim
    1024, at Q = 1 up to 16,384."""
    dt = DTYPES[kind]
    words, ragged, widest = RULE_CASES[kind]
    for nq in (1, 8, 16):
        q, v = _operands(words, dt, nq=nq)
        assert tivf.ivf_sweep_ready(q, v, 1) and tivf.ivf_sweep_ready(q, v, 128)
        assert not tivf.ivf_sweep_ready(q, v, 129)
        assert not tivf.ivf_sweep_ready(*_operands(ragged, dt, nq=nq), 14)
        assert not tivf.ivf_sweep_ready(*_operands(words, dt, nq=nq, offset=1),
                                        14)
    assert not tivf.ivf_sweep_ready(*_operands(words, dt, nq=17), 14)
    assert tivf.ivf_sweep_ready(*_operands(widest, dt, nq=16, rows=4), 14)
    assert not tivf.ivf_sweep_ready(*_operands(2 * widest, dt, nq=16, rows=4),
                                    14)
    assert tivf.ivf_sweep_ready(*_operands(2 * widest, dt, nq=8, rows=4), 14)
    assert tscan.sweep_tile(16) * widest * q.element_size() == \
        tscan.SWEEP_QBLOCK_BYTES


def test_sweep_tile():
    assert [tscan.sweep_tile(n) for n in (1, 2, 3, 4, 5, 8, 9, 16)] == \
        [1, 2, 4, 4, 8, 8, 16, 16]


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


@pytest.mark.parametrize("dim,offset,wgmma", [(1024, 0, True), (96, 16, True),
                                              (40, 0, False),
                                              (96, 1, False)])
def test_k10_dispatch_by_wgmma_i8_ready(recorded, dim, offset, wgmma):
    """K10 takes the int8 mainloop fed by TMA where `wgmma_i8_ready` holds
    (dim % 16 == 0, aligned bases), else fed by cp.async (dim 40) or by
    the realigning producer (a base 1 byte off), never the mma.sync tile;
    "segmax_i8c" counts every launch, "segmax_i8c_wgmma" / "_cpasync" /
    "_realign" each producer's."""
    q, v = _operands(dim, torch.int8, offset=offset, rows=256)
    assert tscan.wgmma_i8_ready(q, v) == wgmma
    mask = torch.ones(256, dtype=torch.bool)
    before = dict(tscan.LAUNCHES)
    keys = tscan.segmax_scan_i8c(_as_cuda(q), _as_cuda(v), _as_cuda(mask))
    assert keys.shape == (16, 4)
    (entry, args), = recorded
    kind = "_wgmma" if wgmma else "_realign" if offset % 4 else "_cpasync"
    assert entry == "pv_segmax_scan_i8c" + kind
    assert args[4:] == (16, 256, dim)
    assert tscan.LAUNCHES["segmax_i8c"] == before["segmax_i8c"] + 1
    for k in ("_wgmma", "_cpasync", "_realign"):
        assert (tscan.LAUNCHES["segmax_i8c" + k]
                == before["segmax_i8c" + k] + (k == kind))


@pytest.mark.parametrize("kind,nq,k,sweep", [("f32", 1, 14, True),
                                             ("bf16", 16, 32, True),
                                             ("i8c", 8, 128, True),
                                             ("i8c", 16, 544, False),
                                             ("f32", 17, 14, False)])
def test_k7_dispatch_by_ivf_sweep_ready(recorded, kind, nq, k, sweep):
    """K7 takes the sweep where `ivf_sweep_ready` holds, with two CTAs per
    SM and scratch for their partials; the k_sel = 544 band takes the
    wide kind (`ivf_wide_ready`), and groups of 17 queries take the
    tensor-core scan (`ivf_wgmma_ready`). "ivf_scan_topk" counts every
    kernel, "ivf_scan_topk_sweep" the sweep alone."""
    dt = DTYPES[kind]
    q = torch.zeros(nq, 64, dtype=dt)
    v = torch.zeros(4 * BN, 64, dtype=dt)
    mask = torch.ones(4 * BN, dtype=torch.bool)
    hot = torch.tensor([3, 1, 2], dtype=torch.int32)
    n_hot = torch.tensor([2], dtype=torch.int32)
    assert tivf.ivf_sweep_ready(q, v, k) == sweep
    before = dict(tscan.LAUNCHES)
    vals, idx = tivf.ivf_scan_topk(*map(_as_cuda, (q, v, mask, hot, n_hot)), k)
    assert vals.shape == idx.shape == (nq, k)
    (entry, args), = recorded
    if sweep:
        assert entry == "pv_ivf_sweep_topk"
        assert args[0] == tivf._KINDS[dt]
        assert args[9:] == (nq, 4 * BN, 64, k, BN, 3, 264)
    elif tivf.ivf_wgmma_ready(q, v, k):
        assert entry == "pv_ivf_scan_topk_wgmma" and nq > tscan.SWEEP_Q_MAX
    else:
        assert tivf.ivf_wide_ready(q, v, k)
        assert entry == "pv_ivf_scan_topk_wide" and k > 128
    assert tscan.LAUNCHES["ivf_scan_topk"] == before["ivf_scan_topk"] + 1
    assert (tscan.LAUNCHES["ivf_scan_topk_sweep"]
            == before["ivf_scan_topk_sweep"] + sweep)


def test_new_counters_stay_zero_on_the_cpu():
    """On CPU tensors the wrappers run the plain versions and count
    nothing."""
    g = torch.Generator().manual_seed(0)
    q8 = torch.randint(-127, 128, (4, 96), generator=g, dtype=torch.int8)
    v8 = torch.randint(-127, 128, (2 * BN, 96), generator=g, dtype=torch.int8)
    mask = torch.ones(2 * BN, dtype=torch.bool)
    hot = torch.tensor([1, 0], dtype=torch.int32)
    tscan.reset_launch_counts()
    tscan.segmax_scan_i8c(q8, v8, mask)
    tivf.ivf_scan_topk(q8[:1], v8, mask, hot, torch.tensor([2], dtype=torch.int32), 14)
    tivf.ivf_scan_topk(q8.float(), v8.float(), mask, hot,
                       torch.tensor([1], dtype=torch.int32), 14)
    for key in ("segmax_i8c", "segmax_i8c_wgmma", "ivf_scan_topk",
                "ivf_scan_topk_sweep"):
        assert tscan.LAUNCHES[key] == 0, key


# --------------------------------------------------------------------------
# The sweep's shares
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_hot", [0, 1, 7, 40, 64])
@pytest.mark.parametrize("ctas", [1, 8, 264])
def test_ivf_sweep_partition(n_hot, ctas):
    """The shares tile [0, n_hot * bn) in order, each a whole number of
    IVF_SWEEP_SHARE rows, within one unit (below one 128-row segment) of
    each other, none past the live steps."""
    shares = tivf.ivf_sweep_partition(n_hot, BN, ctas)
    assert len(shares) == ctas
    unit = tivf.IVF_SWEEP_SHARE
    assert unit < tscan.SEG and BN % unit == 0
    assert shares[0][0] == 0 and shares[-1][1] == n_hot * BN
    for (b0, e0), (b1, _) in zip(shares, shares[1:]):
        assert e0 == b1
    sizes = [e - b for b, e in shares]
    assert all(s % unit == 0 and s >= 0 for s in sizes)
    assert max(sizes) - min(sizes) <= unit
    assert max(e for _, e in shares) <= n_hot * BN  # no dead step


# --------------------------------------------------------------------------
# K7's plain version over the shares, against a numpy oracle
# --------------------------------------------------------------------------

N_TILES, DIM = 6, 32
HOT = [4, 1, 5, 0, 2]  # not ascending: ties resolve by the physical row


def _exact_case(kind, seed):
    """Rows and queries whose scores are exact in float32 in every kind:
    multiples of 1/16 in [-1, 1] (int8: integers), so the plain version's
    sums equal the oracle's whatever their order, and many rows tie."""
    rng = np.random.default_rng(seed)
    cap = N_TILES * BN
    if kind == "i8c":
        v = rng.integers(-127, 128, (cap, DIM)).astype(np.int8)
        q = rng.integers(-127, 128, (3, DIM)).astype(np.int8)
    else:
        v = (rng.integers(-16, 17, (cap, DIM)) / 16).astype(np.float32)
        q = (rng.integers(-16, 17, (3, DIM)) / 16).astype(np.float32)
    mask = rng.random(cap) < 0.8
    return q, v, mask


def _best_row(q0, kind):
    """A row scoring query 0's largest reachable sum."""
    if kind == "i8c":
        return np.where(q0 >= 0, 127, -127).astype(np.int8)
    return np.where(q0 >= 0, 1.0, -1.0).astype(np.float32)


@pytest.mark.parametrize("kind", list(DTYPES))
@pytest.mark.parametrize("ctas", [1, 8, 264])
@pytest.mark.parametrize("n_hot", [0, 3])
def test_k7_plain_over_shares_matches_oracle(kind, ctas, n_hot):
    """Over the sweep's shares K7's plain version returns the oracle's
    (score desc, row asc) top-k of the live hot tiles' unmasked rows, the
    same as per tile. Query 0's two best rows tie across a share boundary
    (ctas 8: logical rows 383 / 384 of step 0) and across a hot-tile
    boundary (the last row of step 0, tile 4, and the first of step 1,
    tile 1, which ranks first)."""
    q, v, mask = _exact_case(kind, seed=ctas + n_hot)
    best = _best_row(q[0], kind)
    logical = [383, 384] if ctas == 8 else [BN - 1, BN]
    phys = [HOT[i // BN] * BN + i % BN for i in logical]
    if n_hot:
        v[phys] = best
        mask[phys] = True
    k = 40
    dt = DTYPES[kind]
    args = (_t(q).to(dt), _t(v).to(dt), _t(mask),
            torch.tensor(HOT, dtype=torch.int32),
            torch.tensor([n_hot], dtype=torch.int32), k)
    vals, idx = tivf.ivf_scan_topk_plain(*args, ctas=ctas)
    vals, idx = vals.numpy(), idx.numpy()
    rows = np.concatenate([np.arange(t * BN, (t + 1) * BN)
                           for t in HOT[:n_hot]] or [np.zeros(0, np.int64)])
    rows = rows[mask[rows]]
    s = q.astype(np.float64) @ v.astype(np.float64).T
    for i in range(q.shape[0]):
        order = np.lexsort((rows, -s[i, rows]))[:k]
        live = len(order)
        np.testing.assert_array_equal(idx[i, :live], rows[order])
        np.testing.assert_array_equal(vals[i, :live],
                                      s[i, rows[order]].astype(np.float32))
        assert np.isneginf(vals[i, live:]).all() and not idx[i, live:].any()
    if n_hot:
        assert idx[0, :2].tolist() == sorted(phys)
    per_tile = tivf.ivf_scan_topk_plain(*args)
    np.testing.assert_array_equal(per_tile[0].numpy(), vals)
    np.testing.assert_array_equal(per_tile[1].numpy(), idx)


# --------------------------------------------------------------------------
# ... and inside the probed route, against the JAX package's kernel
# --------------------------------------------------------------------------


def _clustered(rng, n, dim=DIM, n_clusters=24, noise=0.35):
    centres = normalize_batch(rng.normal(size=(n_clusters, dim)).astype(np.float32))
    lab = rng.integers(0, n_clusters, n)
    pts = centres[lab] + noise / np.sqrt(dim) * rng.normal(size=(n, dim))
    return normalize_batch(pts.astype(np.float32))


@pytest.fixture(scope="module")
def layout():
    """A JAX-built classic layout over 8000 clustered rows (8 live tiles of
    9), and 16 queries near them."""
    rng = np.random.default_rng(21)
    v = _clustered(rng, 8000)
    q = normalize_batch(v[rng.integers(0, 8000, 16)]
                        + 0.02 * rng.normal(size=(16, DIM))).astype(np.float32)
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


@pytest.mark.parametrize("postings", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("ctas", [8, 264])
def test_k7_plain_over_shares_route_matches_jax(layout, monkeypatch,
                                                 postings, ctas):
    """The port's probed ladder route with K7's plain version over the
    sweep's `ctas` shares against `picovdb_tpu.ops.ivf.probe_scan_local`
    (its Pallas kernel in interpret mode) on one JAX-built layout, every
    cluster probed: rescored scores within 1e-5, id sets equal wherever the
    float64 k/k+1 gap over the active postings exceeds 1e-4."""
    j0, q = layout
    if postings == "int8":
        monkeypatch.setenv("PICOVDB_IVF_I8", "1")  # the classic int8 mirror
    j = jivf.IVFIndex(
        j0.centroids,
        j0.vectors.astype(jnp.bfloat16) if postings == "bfloat16" else j0.vectors,
        j0.slots, j0.row_cluster, j0.active, j0.cluster2tile, j0.nlist,
        j0.n_tiles, j0.dim, seg_starts=j0.seg_starts)
    st = _state(j0)  # its host bookkeeping, j's postings
    st.update(vectors=np.asarray(j.vectors),
              vectors_i8c=None if j.vectors_i8c is None else np.asarray(j.vectors_i8c),
              cscale=None if j.cscale is None else np.asarray(j.cscale))
    t = tivf.IVFIndex.from_numpy_state(**st, device="cpu")
    assert (t.vectors_i8c is not None) == (postings == "int8")
    seen = []

    def over_shares(qs, ps, mask, hot, n_hot, k, bn=BN):
        seen.append(int(n_hot[0]))
        return tivf.ivf_scan_topk_plain(qs, ps, mask, hot, n_hot, k, bn,
                                        ctas=ctas)

    monkeypatch.setattr(tivf, "ivf_scan_topk", over_shares)
    k = 10
    # int8: the TPU ladder ranks int32 sums with their low 10 bits replaced
    # by the lane, the port the exact sums: a band of k + 30 holds the true
    # top-k on both sides (as tests/test_torch_ivf.py)
    k_sel = k + (30 if postings == "int8" else 4)
    kw = dict(k=k, k_sel=k_sel, nprobe=16, nlist=j.nlist, g_tiles=None)
    cd = jnp.bfloat16 if postings == "bfloat16" else None
    jv, js = jivf.probe_scan_local(
        jnp.asarray(q), j.centroids, j.vectors, j.slots, j.seg_starts,
        j.active, j.cluster2tile, interpret=True, compute_dtype=cd,
        vectors_i8=j.vectors_i8c, cscale=j.cscale, **kw)
    tv, ts = tivf.probe_scan_local(
        _t(q), t.centroids, t.vectors, t.slots, t.seg_starts, t.active,
        t.cluster2tile, vectors_i8=t.vectors_i8c, cscale=t.cscale, **kw)
    c2t = np.asarray(j.cluster2tile)
    assert seen == [int((c2t.sum(0) > 0).sum())]  # every non-empty tile
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
