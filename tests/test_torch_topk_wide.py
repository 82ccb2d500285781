"""K4's wide kind (csrc/topk_wide.cu: 128 < k <= 1024), checked on the CPU.

* Pass B emulated in numpy step by step as the kernels run it: the
  level-0 histogram of the 32-bit sortable score keys (bits 31-21), the
  bucket holding the k-th key, the refining levels (bits 20-10, then 9-0)
  over that bucket's keys only while the keys at or above it number more
  than CAP, the collection of those keys as 64-bit row keys, the sort, and
  where even the full key leaves more than CAP (one score shared by many
  rows) the equal keys taken in row order. It equals the exact top-k with
  ties to the lower row: equal scores, -0.0 against +0.0 (row_key ranks
  -0.0 below), all rows masked, k above the live rows, k = cap, k = 1024,
  and small CAPs that force each level and the ties path.
* `topk_wide_ready` at its edges and K4's dispatch recorded by a stand-in
  for `scan._launch` on CPU tensors posing as CUDA ones: k 128 takes the
  tensor-core scan, k 129 and 1024 the wide kind, k 1025 the plain exact
  scan (`WIDE_K_FALLBACKS`), dim % 4 != 0 and a misaligned base the
  template. The launcher's query tiles keep the slab within its budget
  (Q = 2048 over 2M rows).
* The port's `fused_topk` (its plain version on the CPU) against
  picovdb_tpu's in interpret mode on 8 x 2,048 x 64 rows, 10 % masked: at
  k 200 the Pallas kernel serves it (bn 512), at k 1000 its `exact_topk`
  fallback. Ids equal outside a 1e-4 gap, scores within 1e-5: at k 200
  against JAX's own `rescore_exact` of its picks, since the Pallas kernel's
  packed key truncates a score's low lane bits (its docstring: ~1e-4
  relative). The counters stay 0 on the CPU.
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

SEG = tscan.SEG
BINS = 2048
SHIFT = (21, 10, 0)
WIDTH = (11, 11, 10)
TOL_SCORE = 1e-5
TOL_GAP = 1e-4


# --------------------------------------------------------------------------
# Pass B, emulated
# --------------------------------------------------------------------------


def float_order(s):
    """float32 -> uint32 whose unsigned order is the float order
    (common.cuh `float_order`)."""
    u = np.asarray(s, np.float32).view(np.uint32)
    return np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))


def _row_keys(keys, rows):
    return (keys.astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - rows.astype(np.uint64))


def _find_digit(h, kk):
    """The kernel's `find_digit`: the digit holding the kk-th largest
    counted key (kk clamped to the count) and the keys above it."""
    kk = min(kk, int(h.sum()))
    if kk == 0:
        return -1, 0, 0
    c = 0
    for d in range(BINS - 1, -1, -1):
        if c + h[d] >= kk:
            return d, c, kk
        c += int(h[d])
    raise AssertionError("unreachable")


def _resolve(hists, k, cap_cand):
    """The kernel's `resolve` over the levels built so far: (level, prefix,
    above, bucket, kk, ready, ties)."""
    s = dict(level=-1, prefix=0, above=0, bucket=0, kk=0, ready=True,
             ties=False)
    kk = k
    for lvl, h in enumerate(hists):
        d, above, kk = _find_digit(h, kk)
        if d < 0:
            return s
        s["level"] = lvl
        s["prefix"] = d if lvl == 0 else (s["prefix"] << WIDTH[lvl]) | d
        s["above"] += above
        kk -= above
        s["kk"] = kk
        s["bucket"] = int(h[d])
        fits = s["above"] + s["bucket"] <= cap_cand
        s["ready"] = fits or lvl == 2
        s["ties"] = not fits and lvl == 2
        if s["ready"]:
            return s
    return s


def pass_b(keys, live, k, cap_cand=tscan.TOPK_WIDE_CAP, stats=None):
    """One query's pass B over its slab row `keys` (uint32, one a row) and
    `live` (the mask): the best k row keys, descending, 0 where empty."""
    rows = np.nonzero(live)[0]
    lk = keys[rows]
    hists = []
    for lvl in range(3):  # hist_kernel<0..2>: each returns if not needed
        if lvl and _resolve(hists, k, cap_cand)["ready"]:
            break
        inb = np.ones(lk.shape, bool)
        if lvl:
            inb = (lk >> np.uint32(SHIFT[lvl] + WIDTH[lvl])) == _resolve(
                hists, k, cap_cand)["prefix"]
        digit = (lk[inb] >> np.uint32(SHIFT[lvl])) & np.uint32(
            (1 << WIDTH[lvl]) - 1)
        hists.append(np.bincount(digit.astype(np.int64), minlength=BINS))
    s = _resolve(hists, k, cap_cand)
    if stats is not None:
        stats.update(levels=len(hists), ties=s["ties"])
    out = np.zeros(k, np.uint64)
    if s["level"] < 0:
        return out
    lo = (s["prefix"] + 1 if s["ties"]
          else s["prefix"] << SHIFT[s["level"]])
    pick = lk.astype(np.uint64) >= np.uint64(lo)  # collect_kernel
    cand = _row_keys(lk[pick], rows[pick])
    assert cand.size <= cap_cand
    cand = np.sort(cand)[::-1]  # finish_kernel's bitonic sort
    if s["ties"]:  # take_ties: the equal keys in row order
        eq = rows[lk == np.uint32(s["prefix"])][:s["kk"]]
        cand = np.concatenate([cand, _row_keys(
            np.full(eq.size, s["prefix"], np.uint32), eq)])
    n = min(k, cand.size)
    out[:n] = cand[:n]
    return out


def exact_row_keys(scores, live, k):
    rows = np.nonzero(live)[0]
    keys = np.sort(_row_keys(float_order(scores[rows]), rows))[::-1][:k]
    out = np.zeros(k, np.uint64)
    out[:keys.size] = keys
    return out


def decode(keys):
    """row_key_score / row_key_row: -inf and row 0 where a key is 0."""
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    f = np.where(hi & np.uint32(0x80000000), hi & np.uint32(0x7FFFFFFF),
                 ~hi).view(np.float32)
    rows = (np.uint64(0xFFFFFFFF) - (keys & np.uint64(0xFFFFFFFF)))
    empty = keys == 0
    return (np.where(empty, -np.inf, f).astype(np.float32),
            np.where(empty, 0, rows).astype(np.int64))


def _scores(rng, cap, case):
    s = (rng.standard_normal(cap) * 0.03).astype(np.float32)
    live = rng.random(cap) >= 0.1
    if case == "equal":
        s[rng.choice(cap, cap // 3, replace=False)] = np.float32(0.0625)
    elif case == "signed_zero":
        z = rng.choice(cap, 200, replace=False)
        s[z] = np.where(np.arange(200) % 2, np.float32(-0.0), np.float32(0.0))
        s[s > 0] = -s[s > 0]  # the zeros rank first
    elif case == "all_masked":
        live[:] = False
    elif case == "few_live":
        live[:] = False
        live[rng.choice(cap, 37, replace=False)] = True
    elif case == "one_score":
        s[:] = np.float32(0.25)
    return s, live


CASES = ["random", "equal", "signed_zero", "all_masked", "few_live",
         "one_score"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("k", [129, 204, 1000, 1024])
def test_pass_b_equals_exact_topk(case, k):
    rng = np.random.default_rng(k + len(case))
    cap = 20_000
    s, live = _scores(rng, cap, case)
    for cap_cand in (tscan.TOPK_WIDE_CAP, 1100, 1030):
        got = pass_b(float_order(s), live, k, cap_cand)
        np.testing.assert_array_equal(got, exact_row_keys(s, live, k))


@pytest.mark.parametrize("case", ["random", "equal", "few_live"])
def test_pass_b_at_k_equal_cap(case):
    """k = cap: every live row comes out, best first."""
    rng = np.random.default_rng(7)
    cap = 1000
    s, live = _scores(rng, cap, case)
    got = pass_b(float_order(s), live, cap)
    np.testing.assert_array_equal(got, exact_row_keys(s, live, cap))
    assert int((got != 0).sum()) == int(live.sum())


def test_pass_b_refines_each_level_and_takes_ties():
    """A CAP just above k forces level 1 on clustered scores, level 2
    where scores share their top 22 bits, and the ties path where more
    than CAP - k rows share the k-th score; all equal the exact top-k."""
    rng = np.random.default_rng(3)
    cap, k = 30_000, 300
    live = rng.random(cap) >= 0.1
    seen = {}
    base = np.float32(0.5)  # bits 0x3F000000: the low 21 bits clear

    def spread(bits):  # scores 0.5 plus up to 2^bits ulps
        return (np.uint32(0x3F000000) + rng.integers(
            0, 1 << bits, cap).astype(np.uint32)).view(np.float32)

    cases = {2: spread(20), 3: spread(10)}
    ties = np.full(cap, base, np.float32)
    ties[rng.choice(cap, 100, replace=False)] = np.float32(0.75)
    cases["ties"] = ties
    for name, s in cases.items():
        stats = {}
        got = pass_b(float_order(s), live, k, cap_cand=k + 50, stats=stats)
        np.testing.assert_array_equal(got, exact_row_keys(s, live, k))
        seen[name] = stats
    assert seen[2]["levels"] == 2 and not seen[2]["ties"]
    assert seen[3]["levels"] == 3 and not seen[3]["ties"]
    assert seen["ties"]["levels"] == 3 and seen["ties"]["ties"]
    # the tied rows come out lowest first, behind the live higher scores
    got = pass_b(float_order(ties), live, k, cap_cand=k + 50)
    _, rows = decode(got)
    tied = rows[int((live & (ties > base)).sum()):]
    assert np.all(np.diff(tied) > 0)
    assert tied[0] == np.nonzero(live & (ties == base))[0][0]


def test_pass_b_decodes_as_the_plain_version():
    """On scores without exact ties the emulation's decoded (vals, idx)
    equal `scan_topk_plain`'s over the same rows and mask."""
    rng = np.random.default_rng(11)
    v = normalize_batch(rng.standard_normal((4096, 32)).astype(np.float32))
    q = normalize_batch(rng.standard_normal((3, 32)).astype(np.float32))
    live = rng.random(4096) >= 0.1
    k = 516
    pv, pi = tscan.scan_topk_plain(torch.from_numpy(q), torch.from_numpy(v),
                                   None, torch.from_numpy(live), k)
    for i in range(3):
        sc = (q[i:i + 1] @ v.T)[0]
        vals, rows = decode(pass_b(float_order(sc), live, k))
        np.testing.assert_array_equal(rows, pi[i].numpy())
        np.testing.assert_allclose(vals, pv[i].numpy(), rtol=0, atol=1e-6)


# --------------------------------------------------------------------------
# Ready rule, dispatch and tiles
# --------------------------------------------------------------------------


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


def _rows(dtype, cap, dim, offset=0):
    flat = torch.zeros(cap * dim + 16, dtype=dtype)
    return flat[offset:offset + cap * dim].view(cap, dim)


@pytest.mark.parametrize("dtype,words,ragged,offset", [
    (torch.float32, 96, 98, 1), (torch.bfloat16, 96, 100, 2)])
def test_topk_wide_ready_edges(dtype, words, ragged, offset):
    """float32 / bf16 rows at any width and base (the rows by the
    producer `rows_piece` names), float32 queries, 128 < k <=
    SCAN_KSEL_MAX, one query's slab within the budget."""
    q = torch.zeros(64, words)
    v = _rows(dtype, 4 * SEG, words)
    assert not tscan.topk_wide_ready(q, v, 128)
    assert tscan.topk_wide_ready(q, v, 129)
    assert tscan.topk_wide_ready(q, v, tscan.SCAN_KSEL_MAX)
    assert not tscan.topk_wide_ready(q, v, tscan.SCAN_KSEL_MAX + 1)
    ragged_rows = _rows(dtype, 4 * SEG, ragged)
    assert tscan.topk_wide_ready(torch.zeros(64, ragged), ragged_rows, 200)
    assert tscan.rows_piece(ragged_rows) == 8
    off_rows = _rows(dtype, 4 * SEG, words, offset)
    assert tscan.topk_wide_ready(q, off_rows, 200)
    assert tscan.rows_piece(off_rows) == 4
    assert not tscan.topk_wide_ready(q.to(torch.bfloat16), v, 200)
    assert not tscan.topk_wide_ready(q, _rows(torch.int8, 4 * SEG, words), 200)


def test_topk_wide_ready_slab_budget(monkeypatch):
    """A slab past the budget no longer refuses the wide kind: the walk
    takes the rows in ranges instead."""
    q = torch.zeros(1, 8)
    v = torch.zeros(1000, 8)  # 1024 rows a slab row: 4 KiB
    assert tscan.topk_wide_ready(q, v, 200)
    assert tscan.wide_walk(1, 1000) == (1, 1024, 1)
    monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", 4095)
    assert tscan.topk_wide_ready(q, v, 200)
    assert tscan.wide_walk(1, 1000) == (1, 896, 2)


@pytest.mark.parametrize("dtype,dim,k,offset,entry", [
    (torch.float32, 96, 128, 0, "pv_scan_topk_wgmma"),
    (torch.float32, 96, 129, 0, "pv_scan_topk_wide"),
    (torch.bfloat16, 1024, 204, 0, "pv_scan_topk_wide"),
    (torch.float32, 96, 1024, 0, "pv_scan_topk_wide"),
    (torch.bfloat16, 96, 1024, 0, "pv_scan_topk_wide"),
    # rows TMA cannot read, which the template served before: the wide
    # kind, its rows by cp.async (their ids name the entry they took then)
    pytest.param(torch.float32, 98, 200, 0, "pv_scan_topk_wide",
                 id="dtype5-98-200-0-pv_scan_topk"),
    pytest.param(torch.bfloat16, 100, 1024, 0, "pv_scan_topk_wide",
                 id="dtype6-100-1024-0-pv_scan_topk"),
    pytest.param(torch.float32, 96, 516, 1, "pv_scan_topk_wide",
                 id="dtype7-96-516-1-pv_scan_topk"),
    pytest.param(torch.bfloat16, 96, 204, 2, "pv_scan_topk_wide",
                 id="dtype8-96-204-2-pv_scan_topk")])
def test_k4_dispatch_by_k(recorded, dtype, dim, k, offset, entry):
    """Which entry K4 takes, what it passes, and what it counts:
    "scan_topk" every launch, "scan_topk_wide" the wide kind's by TMA, with
    the rows' producer (`rows_piece`), the float32 queries, the query tile
    and the scratch's bytes (the planes at their width padded to whole 16
    bytes); rows TMA cannot read (a width off whole 16 bytes, a base off
    16 bytes) are counted by their producer's key
    ("scan_topk_wide_cpasync" / "_realign")."""
    cap = 4 * SEG + 64
    nq = 70
    q = torch.randn(nq, dim)
    v = _rows(dtype, cap, dim, offset)
    mask = torch.ones(cap, dtype=torch.bool)
    before = dict(tscan.LAUNCHES)
    vals, idx = tscan.fused_topk(*map(_as_cuda, (q, v, mask)), k)
    assert vals.shape == idx.shape == (nq, k)
    (got, args), = recorded
    assert got == entry
    wide = entry == "pv_scan_topk_wide"
    piece = tscan.rows_piece(v)
    suffix = tscan._PIECE_KEY[piece]
    assert tscan.LAUNCHES["scan_topk"] == before["scan_topk"] + 1
    for name, took in (("scan_topk_wide", wide),
                       ("scan_topk_wgmma", entry == "pv_scan_topk_wgmma")):
        assert tscan.LAUNCHES[name + suffix] == before[name + suffix] + took
    assert tscan.LAUNCH_SHAPES["scan_topk"][nq, k] >= 1
    kind = 0 if dtype == torch.float32 else 1
    assert args[:2] == (piece, kind)
    if wide:
        per = 4 if kind == 0 else 8  # plane elements of 16 bytes
        qld = -(-dim // per) * per
        rows = tscan.wide_walk(nq, cap)[1]  # one range: the whole plane
        assert rows >= cap
        assert args[8:] == (nq, cap, dim, k, nq, rows, tscan.topk_wide_scratch(
            nq, cap, qld, kind, nq))


def test_k4_past_ksel_max_takes_the_plain_scan(recorded):
    q, v = torch.randn(4, 96), torch.randn(4 * SEG, 96)
    mask = torch.ones(4 * SEG, dtype=torch.bool)
    before = tscan.WIDE_K_FALLBACKS["scan_topk"]
    vals, idx = tscan.fused_topk(*map(_as_cuda, (q, v, mask)),
                                 tscan.SCAN_KSEL_MAX + 1)
    assert vals.shape == (4, 4 * SEG) and not recorded
    assert tscan.WIDE_K_FALLBACKS["scan_topk"] == before + 1


def test_wide_launch_scratch_and_aligned_mask(recorded, monkeypatch):
    """The launcher's one scratch buffer holds the query planes and one
    tile's slab (q_tile x a range's rows), histograms and candidates, and
    the tile's partial of the ranges' keys, each from a 256-byte boundary;
    a mask view off 4 bytes is copied to an aligned one. Here the budget
    holds 16 queries' slab over the plane, so the walk takes ranges of 256
    rows that hold a tile of 64."""
    seen = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        seen.append(out)
        return out

    monkeypatch.setattr(tscan.torch, "empty", empty)
    monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", 16 * 4 * 1024)
    cap, nq, dim = 1000, 100, 32
    q, v = torch.randn(nq, dim), torch.randn(cap, dim)
    flat = torch.ones(cap + 1, dtype=torch.bool)
    mask = flat[1:]
    assert mask.data_ptr() % 4
    tscan.fused_topk(*map(_as_cuda, (q, v, mask)), 300)
    (entry, args), = recorded
    assert entry == "pv_scan_topk_wide"
    assert args[4] % 4 == 0 and args[4] != mask.data_ptr()
    q_tile, rows, nbytes = args[12], args[13], args[14]
    assert (q_tile, rows) == tscan.topk_wide_plan(nq, cap) == (64, 256)
    assert q_tile == tscan.topk_wide_tile(nq, rows)
    scratch, = (t for t in seen if t.data_ptr() == args[5])
    assert scratch.dtype == torch.uint8 and scratch.numel() == nbytes
    planes = nq * dim * 8  # hi and lo, float32
    assert nbytes == (-(-planes // 256) * 256 + 64 * 256 * 4
                      + -(-64 * tscan.TOPK_WIDE_HIST * 4 // 256) * 256
                      + 64 * tscan.TOPK_WIDE_CAP * 8 + 64 * 4 * 300 * 8)
    assert tscan.topk_wide_scratch(nq, cap, dim, 1, q_tile, rows, 300) == (
        nbytes - -(-planes // 256) * 256 + -(-nq * dim * 6 // 256) * 256)


@pytest.mark.parametrize("nq,cap,tile", [
    (2048, 2_000_000, 33), (64, 1_000_000, 64), (16, 131_072, 16),
    (65, 1_000_000, 65), (200, 131_072, 200), (2048, 131_072, 256),
    (1, 64_000_000, 1)])
def test_topk_wide_tile_keeps_the_slab_in_budget(nq, cap, tile):
    """Q = 2048 over 2M rows runs 33-query tiles (a 264 MB slab, not
    16 GB); Q <= 64 over 1M rows one tile (the corpus read once); a tile
    that covers the batch is not cut to whole 64-query tiles."""
    t = tscan.topk_wide_tile(nq, cap)
    assert t == tile
    ld = -(-cap // SEG) * SEG
    assert 4 * ld * t <= tscan.TOPK_WIDE_SLAB_BYTES
    assert t <= tscan.TOPK_WIDE_QTILE_MAX


def test_counters_stay_zero_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    q = torch.nn.functional.normalize(torch.randn(70, 64, generator=g), dim=1)
    v = torch.nn.functional.normalize(torch.randn(3 * SEG, 64, generator=g),
                                      dim=1)
    mask = torch.rand(3 * SEG, generator=g) > 0.5
    tscan.reset_launch_counts()
    for rows in (v, v.to(torch.bfloat16)):
        vals, idx = tscan.fused_topk(q, rows, mask, 200)
        ref = tscan.scan_topk_plain(q, rows, None, mask, 200)
        assert torch.equal(vals, ref[0]) and torch.equal(idx, ref[1])
    assert tscan.LAUNCHES["scan_topk_wide"] == tscan.LAUNCHES["scan_topk"] == 0


# --------------------------------------------------------------------------
# The port against picovdb_tpu
# --------------------------------------------------------------------------


@pytest.mark.parametrize("k", [200, 1000])
def test_fused_topk_matches_jax(k):
    rng = np.random.default_rng(k)
    v = normalize_batch(rng.standard_normal((2048, 64)).astype(np.float32))
    q = normalize_batch(rng.standard_normal((8, 64)).astype(np.float32))
    mask = rng.random(2048) >= 0.1
    jv, ji = map(np.asarray, jps.fused_topk(
        jnp.asarray(q), jnp.asarray(v), jnp.asarray(mask), k,
        interpret=True))
    if k <= 512:  # the Pallas kernel's packed scores: rescore its picks
        jv, ji = map(np.asarray, jps.rescore_exact(q, v, jv, ji))
    tv, ti = tscan.fused_topk(torch.from_numpy(q), torch.from_numpy(v),
                              torch.from_numpy(mask), k)
    tv, ti = tv.numpy(), ti.numpy()
    assert np.array_equal(np.isfinite(tv), np.isfinite(jv))
    fin = np.isfinite(tv)
    np.testing.assert_allclose(tv[fin], jv[fin], rtol=0, atol=TOL_SCORE)
    exact = np.sort((q.astype(np.float64) @ v[mask].T.astype(np.float64)),
                    axis=1)[:, ::-1]
    for i in range(q.shape[0]):
        assert mask[ti[i][fin[i]]].all()
        if k < exact.shape[1] and exact[i, k - 1] - exact[i, k] <= TOL_GAP:
            continue
        assert set(ti[i][fin[i]].tolist()) == set(ji[i][fin[i]].tolist()), i
