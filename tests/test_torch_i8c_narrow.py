"""K9 fused_topk_i8c's kinds at every width, base, Q and k, checked on the
CPU.

* The dispatch: CPU tensors posing as CUDA tensors reach the launch, which
  a stand-in for `scan._launch` records against `_build._SIGNATURES`. The
  ready rules, asked in the dispatch's order (`sweep_ready`,
  `i8c_narrow_ready`, `i8c_wgmma_ready`, `i8c_wide_ready`), give every
  (width 25 / 100 / 1019 / 1024 / 4112, base off 16 bytes by 0 / 1 / 4,
  Q 1 / 16 / 17 / 64, k 16 / 128 / 129 / 544) exactly one kind up to 64M
  rows: no call reaches the template (`pv_scan_topk` kind 4). Each launch
  takes its kind's entry with the arguments its signature names (the
  tensor-core kinds the rows' producer first, `rows_piece`), and adds one
  to its kind's counter (suffixed "_cpasync" / "_realign" by the
  producer) and to LAUNCH_SHAPES. Past 64M rows (one query's slab over
  TOPK_WIDE_SLAB_BYTES) k > 128 keeps the template.
* The narrow kind (`sweep_narrow_kernel<Int8C>` over flat ranges),
  emulated in numpy over a flat byte array standing for device memory
  (the rows at byte phases 0 / 1 / 4 / 8 / 13 of a 16-byte boundary,
  poison around them): the CTA's phase copies filled a byte at a time by
  the kernel's formula, each CTA's rows (`sweep_partition`) walked in the
  kernel's layouts (L lanes a row for rows of at most 16 words, row groups
  beyond), each row read as the aligned words that hold a byte of it. Every
  live row of the range is summed once, the sums are the exact int32 sums
  and the CTAs' partials merge to `fused_topk_i8c_plain`, bit for bit.
* Parity with picovdb_tpu at widths 100 and 25: the port's
  `fused_topk_i8c` (its plain version on CPU tensors) against JAX's in
  interpret mode, with the lane-bit floor of
  tests/test_torch_i8c.py::test_k9_plain_matches_tpu_kernel: the TPU
  kernel ranks (s & ~(L - 1)) | lane, so its scores equal the port's
  exact sums floored to a multiple of L, exactly; and both packages'
  engines on an `i8c_fused_smallq` store of width 100 (scores within
  1e-5, ids outside the 1e-4 gap).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import picovdb_tpu
import picovdb_tpu_torch
from picovdb_tpu.ops import pallas_scan as jps
from picovdb_tpu.utils import normalize_batch
from picovdb_tpu_torch.ops import _build
from picovdb_tpu_torch.ops import scan as tscan
from torch_port_setup import cap_torch_threads, cpu_kw

cap_torch_threads()

CAP = 4096
POISON = 0x7E  # device memory around the rows (int8 126)
TOL_SCORE = 1e-5
TOL_GAP = 1e-4


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


def _view(shape, off_bytes):
    n = shape[0] * shape[1]
    flat = torch.zeros(n + 64, dtype=torch.int8)
    v = flat[off_bytes:off_bytes + n].view(shape)
    assert v.data_ptr() % 16 == off_bytes % 16
    return v


# K9's kinds in the dispatch's order: (name, ready rule, entry, counter
# key; "+" appends the rows' producer's suffix)
K9_KINDS = [
    ("sweep", tscan.sweep_ready, "pv_sweep_topk_i8c", "scan_topk_i8c_sweep"),
    ("narrow", tscan.i8c_narrow_ready, "pv_sweep_topk_i8c_narrow",
     "scan_topk_i8c_narrow"),
    ("scan", tscan.i8c_wgmma_ready, "pv_scan_topk_i8c_wgmma",
     "scan_topk_i8c_wgmma+"),
    ("wide", tscan.i8c_wide_ready, "pv_scan_topk_i8c_wide",
     "scan_topk_i8c_wide+")]


@pytest.mark.parametrize("dim", [25, 100, 1019, 1024, 4112])
def test_k9_every_width_and_base_takes_one_kind(recorded, dim):
    seen = set()
    mask = torch.ones(CAP, dtype=torch.bool)
    for off in (0, 1, 4):
        v = _view((CAP, dim), off)
        for nq in (1, 16, 17, 64):
            q = _view((nq, dim), 0)
            for k in (16, 128, 129, 544):
                held = [kind for kind in K9_KINDS if kind[1](q, v, k)]
                assert len(held) == 1, (off, nq, k, [h[0] for h in held])
                name, _, entry, key = held[0]
                piece = tscan.rows_piece(v)
                if key.endswith("+"):
                    key = key[:-1] + tscan._PIECE_KEY[piece]
                before = dict(tscan.LAUNCHES)
                recorded.clear()
                tscan.fused_topk_i8c(*map(_as_cuda, (q, v, mask)), k)
                (got, args), = recorded
                assert got == entry, (name, got)
                assert tscan.LAUNCHES[key] == before[key] + 1, key
                assert (tscan.LAUNCHES["scan_topk_i8c"]
                        == before["scan_topk_i8c"] + 1)
                if name in ("scan", "wide"):
                    assert args[0] == piece in (0, 8, 4, 2)
                if name != "sweep":
                    assert tscan.LAUNCH_SHAPES[key][nq, k] >= 1
                seen.add(name)
    # k past 128 on the wide kind, the 64-query batch on the scan; the
    # 16-byte sweep only over rows of whole 16 bytes at aligned bases, the
    # narrow kind over the others where its phase copies fit
    assert {"wide", "scan"} <= seen
    assert ("sweep" in seen) == (dim % 16 == 0 and dim <= 4096)
    assert "narrow" in seen


def test_k9_template_only_past_the_slab_budget(recorded, monkeypatch):
    """One query's slab over the budget (a store past 64M rows, here
    shrunk): K9 at k > 128 keeps the template, `pv_scan_topk` kind 4, at
    narrow widths as at TMA's; k <= 128 keeps its kinds."""
    monkeypatch.setattr(tscan, "TOPK_WIDE_SLAB_BYTES", 4 * CAP - 1)
    mask = torch.ones(CAP, dtype=torch.bool)
    for dim in (25, 100, 1024):
        v = torch.zeros(CAP, dim, dtype=torch.int8)
        for nq, k, template in ((1, 16, False), (64, 128, False),
                                (1, 129, True), (64, 544, True)):
            q = torch.zeros(nq, dim, dtype=torch.int8)
            recorded.clear()
            tscan.fused_topk_i8c(*map(_as_cuda, (q, v, mask)), k)
            (entry, args), = recorded
            assert (entry == "pv_scan_topk") == template, (dim, nq, k, entry)
            if template:
                assert args[0] == tscan._KIND_I8C


def test_i8c_ready_rule_edges():
    """The limits: the 16-byte sweep up to I8C_SWEEP_Q_MAX, the narrow
    kind up to I8C_NARROW_Q_MAX (operands the 16-byte sweep cannot read,
    phase copies that fit), the scan every k <= 128 neither takes, the
    wide kind 128 < k <= SCAN_KSEL_MAX; K7 keeps SWEEP_Q_MAX."""
    assert tscan.SWEEP_Q_MAX == 16
    assert 1 <= tscan.I8C_SWEEP_Q_MAX <= 16
    assert 1 <= tscan.I8C_NARROW_Q_MAX <= 16
    v = _view((CAP, 1024), 0)
    lim = tscan.I8C_SWEEP_Q_MAX
    assert tscan.sweep_ready(_view((lim, 1024), 0), v, 128)
    assert not tscan.sweep_ready(_view((lim + 1, 1024), 0), v, 16)
    assert not tscan.sweep_ready(_view((1, 1024), 0), v, 129)
    assert tscan.i8c_wgmma_ready(_view((lim + 1, 1024), 0), v, 16)
    # dim 4112: whole 16-byte words past the sweep's 4096
    v4 = _view((CAP, 4112), 0)
    assert not tscan.sweep_ready(_view((1, 4112), 0), v4, 16)
    assert not tscan.i8c_narrow_ready(_view((1, 4112), 0), v4, 16)
    assert tscan.i8c_wgmma_ready(_view((1, 4112), 0), v4, 16)
    nlim = tscan.I8C_NARROW_Q_MAX
    for dim, off in ((100, 0), (25, 0), (1024, 4), (1019, 1)):
        vn = _view((CAP, dim), off)
        q = _view((nlim, dim), 0)
        fits = tscan.narrow_fits(q, vn, 16)
        assert tscan.i8c_narrow_ready(q, vn, 16) == fits, (dim, off)
        assert tscan.i8c_wgmma_ready(q, vn, 16) != fits
        q1 = _view((nlim + 1, dim), 0)
        assert not tscan.i8c_narrow_ready(q1, vn, 16)
        assert tscan.i8c_wgmma_ready(q1, vn, 16)
        assert not tscan.i8c_narrow_ready(_view((1, dim), 0), vn, 129)
        assert tscan.i8c_wide_ready(q, vn, 129)
        assert tscan.i8c_wide_ready(q, vn, tscan.SCAN_KSEL_MAX)
        assert not tscan.i8c_wide_ready(q, vn, 128)
    # the 64M-row edge: a slab of one query up to TOPK_WIDE_SLAB_BYTES
    top = tscan.TOPK_WIDE_SLAB_BYTES // 4
    q = torch.zeros(1, 100, dtype=torch.int8)
    assert tscan.i8c_wide_ready(q, torch.empty((top, 100), dtype=torch.int8,
                                               device="meta"), 544)
    assert not tscan.i8c_wide_ready(
        q, torch.empty((top + 1, 100), dtype=torch.int8, device="meta"), 544)


def test_k9_scan_and_wide_launch_arguments(recorded):
    """The scan's scratch holds the queries padded to whole 16 bytes, then
    Q x ranges x k partials (`i8_wgmma_partition` at its 64-query tile);
    the wide kind's one tile of `topk_wide_tile` queries' slab, histograms
    and candidates, then the padded queries; neither passes scales."""
    sizes = []
    real_empty = torch.empty

    def empty(*shape, **kw):
        out = real_empty(*shape, **kw)
        if kw.get("dtype") == torch.uint8:
            sizes.append(out.numel())
        return out

    mask = torch.ones(CAP, dtype=torch.bool)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tscan.torch, "empty", empty)
        for dim in (25, 100):
            v = _view((CAP, dim), 0)
            for nq, k in ((64, 16), (17, 128), (1, 160), (64, 544)):
                q = _view((nq, dim), 0)
                recorded.clear()
                sizes.clear()
                tscan.fused_topk_i8c(*map(_as_cuda, (q, v, mask)), k)
                (entry, args), = recorded
                qbytes = tscan._up256(nq * tscan._pad_to(dim, 16))
                if k <= 128:
                    assert entry == "pv_scan_topk_i8c_wgmma"
                    _, ranges = tscan.i8_wgmma_partition(nq, CAP, 132, k)
                    assert sizes == [qbytes + nq * ranges * k * 8]
                else:
                    assert entry == "pv_scan_topk_i8c_wide"
                    tile = tscan.topk_wide_tile(nq, CAP)
                    want = (tscan._up256(tscan.i4_wide_scratch(CAP, tile))
                            + nq * tscan._pad_to(dim, 16))
                    assert sizes == [want] and args[-2:] == (tile, want)
                assert args[1:4] == (q.data_ptr(), v.data_ptr(),
                                     mask.data_ptr())


# --------------------------------------------------------------------------
# The narrow kind's phase copies and reads, emulated
# --------------------------------------------------------------------------

SW_WARPS, WARP_ROWS, TR = 8, 16, 128


def _memory(v8, phase):
    """Device memory holding the rows at a 16-byte boundary plus `phase`,
    poison around them: (memory as uint8, base)."""
    base = 64 + phase
    mem = np.full(base + v8.size + 64, POISON, dtype=np.uint8)
    mem[base:base + v8.size] = v8.view(np.uint8).reshape(-1)
    return mem, base


def _phase_copies(q8, dim, lg, words, qt):
    """The query block as the kernel fills it, a byte a thread: byte b of
    copy (j, qq) is byte b - j g of query qq (zero outside the query, and
    for the tile's queries past Q)."""
    nq = q8.shape[0]
    phases, wb = 16 >> lg, words * 16
    qb = np.zeros(phases * qt * wb, dtype=np.int8)
    for i in range(qb.size):
        ch, b = divmod(i, wb)
        j, qq = divmod(ch, qt)
        src = b - (j << lg)
        if qq < nq and 0 <= src < dim:
            qb[i] = q8[qq, src]
    return qb.reshape(phases, qt, wb)


def _lanes(words):
    """Narrow::lanes: the power of two >= W (at least 2) up to 16 words."""
    if words > 16:
        return 0
    lanes = 2
    while lanes < words:
        lanes *= 2
    return lanes


def _row_sums(mem, base, copies, lg, words, row, dim):
    """Row `row`'s sums with every query: its words, the aligned 16-byte
    words that hold a byte of it, against the copy of its phase, lane c
    meeting word c of both (words at or past W meet nothing)."""
    b0 = base + row * dim
    ph = b0 & 15
    nw = (ph + dim + 15) >> 4
    assert nw <= words and ph % (1 << lg) == 0
    got = mem[16 * (b0 >> 4):16 * ((b0 >> 4) + nw)].view(np.int8)
    cp = copies[ph >> lg, :, :16 * nw]
    return cp.astype(np.int64) @ got.astype(np.int64)


def _emulate(mem, base, q8, dim, mask, k, sms):
    """sweep_narrow_kernel<Int8C> over sweep_partition's flat ranges: each
    CTA's tiles of 128 rows, a warp's 16 rows of a tile (the packed layout:
    L / 2 steps of 32 / L rows, L lanes a row; or row groups of RW rows),
    only live rows summed; each CTA's partial the k best (sum, lower row)
    keys; then the merge. Returns (vals, idx) and each row's visits."""
    nq = q8.shape[0]
    cap = mask.shape[0]
    qt = 1 << max(0, nq - 1).bit_length()
    lg = 4
    while lg > 0 and (dim | (base & 15)) & ((1 << lg) - 1):
        lg -= 1
    words = (16 - (1 << lg) + dim + 15) // 16
    assert 16 >> lg == tscan.narrow_phases(dim, base)
    copies = _phase_copies(q8, dim, lg, words, qt)
    lanes = _lanes(words)
    chunk, ctas = tscan.sweep_partition(cap, sms)
    visits = np.zeros(cap, dtype=np.int64)
    keys = []
    for c in range(ctas):
        rbeg, rend = c * chunk, min(cap, (c + 1) * chunk)
        part = []
        for t0 in range(rbeg, rend, TR):
            for warp in range(SW_WARPS):
                if lanes:  # the packed layout: G rows a step
                    group = 32 // lanes
                    rw0 = t0 + WARP_ROWS * warp
                    rows = [rw0 + s * group + gi
                            for s in range(WARP_ROWS // group)
                            for gi in range(group)]
                else:  # row groups of RW rows
                    rw = 2 if qt < 8 else 1
                    rows = [t0 + g * SW_WARPS * rw + warp * rw + r
                            for g in range(WARP_ROWS // rw)
                            for r in range(rw)]
                for row in rows:
                    if row >= rend or not mask[row]:
                        continue
                    visits[row] += 1
                    sums = _row_sums(mem, base, copies, lg, words, row, dim)
                    part += [(int(sums[qq]), row, qq) for qq in range(nq)]
        for qq in range(nq):  # the CTA's k best a query
            mine = sorted((p for p in part if p[2] == qq),
                          key=lambda p: (-p[0], p[1]))[:k]
            keys += mine
    vals = np.full((nq, k), -np.inf, dtype=np.float32)
    idx = np.zeros((nq, k), dtype=np.int32)
    for qq in range(nq):
        best = sorted((p for p in keys if p[2] == qq),
                      key=lambda p: (-p[0], p[1]))[:k]
        for j, (s, row, _) in enumerate(best):
            vals[qq, j], idx[qq, j] = s, row
    return vals, idx, visits


@pytest.mark.parametrize("dim", [25, 100, 1019])
@pytest.mark.parametrize("phase", [0, 1, 4, 8, 13])
def test_narrow_reads_rebuild_the_plain_selection(dim, phase):
    rng = np.random.default_rng(dim * 16 + phase)
    cap, nq, k = 700, 3, 16
    v8 = rng.integers(-127, 128, (cap, dim)).astype(np.int8)
    q8 = rng.integers(-127, 128, (nq, dim)).astype(np.int8)
    v8[500] = v8[100]  # equal rows: ties to the lower row
    v8[201] = 127 * np.sign(q8[0])  # q8 0's best: at a CTA boundary
    mask = rng.random(cap) > 0.15
    mask[100] = mask[500] = mask[201] = True
    mask[256:384] = False  # a tile with no live row
    mem, base = _memory(v8, phase)
    vals, idx, visits = _emulate(mem, base, q8, dim, mask, k, sms=2)
    np.testing.assert_array_equal(visits, mask.astype(np.int64))
    pv, pi = tscan.fused_topk_i8c_plain(torch.from_numpy(q8),
                                        torch.from_numpy(v8),
                                        torch.from_numpy(mask), k)
    np.testing.assert_array_equal(vals, pv.numpy())
    np.testing.assert_array_equal(idx, pi.numpy())
    assert idx[0, 0] == 201


def test_narrow_copies_and_block_bytes():
    """The phase copies' zeros and bytes at every phase (copy j: j g zero
    bytes, the query, zeros to W words) and `narrow_block_bytes`, the
    block the kernel's `Narrow` lays out; the padded tile's queries are
    zero."""
    q8 = np.arange(1, 26, dtype=np.int8)[None, :].repeat(3, 0)
    copies = _phase_copies(q8, 25, 0, 3, 4)
    assert copies.shape == (16, 4, 48)
    for j in range(16):
        assert not copies[j, :3, :j].any()
        np.testing.assert_array_equal(copies[j, :3, j:j + 25], q8)
        assert not copies[j, :3, j + 25:].any()
    assert not copies[:, 3].any()
    assert tscan.narrow_block_bytes(3, 25, 1) == 4 * 16 * 3 * 16
    assert tscan.narrow_block_bytes(16, 100, 0) == 16 * 4 * 7 * 16
    v = _view((64, 100), 0)
    # 16 queries at dim 100: 28 KB of copies and 32 KB of buffers
    assert tscan.narrow_fits(_view((16, 100), 0), v, 128)
    assert not tscan.narrow_fits(_view((16, 1019), 0), _view((64, 1019), 0),
                                 16)


def test_k9_counters_stay_zero_on_the_cpu():
    tscan.reset_launch_counts()
    mask = torch.ones(600, dtype=torch.bool)
    for dim in (25, 100):
        v8 = torch.randint(-127, 128, (600, dim), dtype=torch.int8)
        for nq, k in ((1, 16), (16, 16), (64, 16), (1, 160), (64, 544)):
            q8 = torch.randint(-127, 128, (nq, dim), dtype=torch.int8)
            tscan.fused_topk_i8c(q8, v8, mask, k)
    assert all(n == 0 for n in tscan.LAUNCHES.values())


# --------------------------------------------------------------------------
# Parity with picovdb_tpu
# --------------------------------------------------------------------------


def _data(seed, dim, nq, cap=CAP, keep=0.8):
    rng = np.random.default_rng(seed)
    v = normalize_batch(rng.normal(size=(cap, dim)).astype(np.float32))
    q = normalize_batch(rng.normal(size=(nq, dim)).astype(np.float32))
    mask = rng.random(cap) < keep
    v8, cs = map(np.asarray, jps.quantize_cols_i8(jnp.asarray(v)))
    q8 = np.asarray(jps.fold_queries_i8(jnp.asarray(q), jnp.asarray(cs)))
    return v, q, mask, v8, cs, q8


@pytest.mark.parametrize("dim", [100, 25])
@pytest.mark.parametrize("nq,k", [(1, 16), (17, 16), (4, 160)])
def test_fused_topk_i8c_matches_jax(dim, nq, k):
    """The port's exact int32 sums, ties to the lower row, against the TPU
    kernel's (s & ~(L - 1)) | lane ranking: its scores are the port's
    floored to a multiple of L, exactly."""
    v, q, mask, v8, cs, q8 = _data(dim + nq + k, dim, nq)
    t = torch.from_numpy
    vals, idx = tscan.fused_topk_i8c(t(q8), t(v8), t(mask), k)
    vals, idx = vals.numpy(), idx.numpy()
    s = q8.astype(np.int64) @ v8.astype(np.int64).T
    np.testing.assert_array_equal(
        vals, np.take_along_axis(s, idx.astype(np.int64), 1).astype(
            np.float32))
    jv, ji = map(np.asarray, jps.fused_topk_i8c(
        jnp.asarray(q8), jnp.asarray(v8), jnp.asarray(mask), k,
        interpret=True))
    bn = jps._pick_bn(dim, min(jps.DEFAULT_QT, nq), k, 1, CAP, 4096)
    unit = 1 << max(1, int(bn - 1).bit_length())
    np.testing.assert_array_equal(np.floor(vals / unit) * unit, jv)
    assert bool(mask[idx].all()) and bool(mask[ji].all())


def test_i8c_smallq_store_matches_jax_at_dim_100(tmp_path, monkeypatch):
    """An `i8c_fused_smallq` store of width 100 (PICOVDB_SMALLQ_I8C=1)
    served by both packages: singles and a 16-query batch route there in
    both, the serial loop to `i8c_fused_smallq_loop`. The port ranks the
    exact int32 sums, so its ids are the float64 oracle's wherever the
    k-th / (k+1)-th gap exceeds TOL_GAP; picovdb_tpu's ladder ranks the
    floored sums (s & ~(L - 1)) | lane and may drop a true top-k row past
    its guard, so on every answer it gets exactly right the two agree: the
    same ids, scores within TOL_SCORE (float32 rescores of the same rows,
    summed in other orders)."""
    monkeypatch.setenv("PICOVDB_SMALLQ_I8C", "1")
    monkeypatch.setenv("PICOVDB_TIE_MARGIN_SCALE", "0")
    dim, n, k = 100, 6000, 10
    rng = np.random.default_rng(26)
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    q = (vecs[rng.integers(0, n, 16)]
         + 0.3 * rng.normal(size=(16, dim))).astype(np.float32)
    s = normalize_batch(q).astype(np.float64) @ normalize_batch(vecs).T
    truth = np.argsort(-s, axis=1)[:, :k]
    srt = -np.sort(-s, axis=1)
    gaps = srt[:, k - 1] - srt[:, k]
    out = {}
    with pltpu.force_tpu_interpret_mode():
        for name, pkg in (("jax", picovdb_tpu), ("torch", picovdb_tpu_torch)):
            db = pkg.PicoVectorDB(embedding_dim=dim,
                                  storage_file=str(tmp_path / name),
                                  int8_tier=True, **cpu_kw(pkg))
            db.upsert_columnar(vecs, ids=[f"d{i}" for i in range(n)])
            hits = [db.query(q[i], top_k=k) for i in range(3)]
            assert db.last_query_debug()["strategy"] == "i8c_fused_smallq"
            hits += list(db.query(q, top_k=k))
            assert db.last_query_debug()["strategy"] == "i8c_fused_smallq"
            _, slots = db.query_serial_loop(q[:4], top_k=k)
            assert db._dev.last_strategy == "i8c_fused_smallq_loop"
            ids = [[int(h[picovdb_tpu.K_ID][1:]) for h in r] for r in hits]
            out[name] = (hits, ids + np.asarray(slots).tolist())
    which = list(range(3)) + list(range(16)) + list(range(4))
    exact_j = 0
    for i, qi in enumerate(which):
        jt, tt = set(out["jax"][1][i]), set(out["torch"][1][i])
        if gaps[qi] > TOL_GAP:
            assert tt == set(truth[qi]), i
        if jt == set(truth[qi]):
            exact_j += 1
            assert jt == tt, i
            if i < 19:
                np.testing.assert_allclose(
                    sorted(h[picovdb_tpu.K_METRICS]
                           for h in out["torch"][0][i]),
                    sorted(h[picovdb_tpu.K_METRICS] for h in out["jax"][0][i]),
                    rtol=0, atol=TOL_SCORE)
    assert exact_j >= len(which) // 2, exact_j
